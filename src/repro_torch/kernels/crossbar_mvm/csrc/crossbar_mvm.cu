// Crossbar dot-product kernel for Hopper (sm_90a): uint8 (M, K) x uint8
// (K, N) codes with int32 accumulation and the Eq. 7 zero-point correction
//   y = (acc - zp_w·Σx - zp_x·Σw + K·zp_x·zp_w) · scale      (f32 out)
//
// Replaces the Pallas TPU kernel `crossbar_mvm_pallas`
// (src/repro/kernels/crossbar_mvm/kernel.py), whose 128x128 output tiles
// took the full K per grid step into VMEM.
//
// Bound on an H100: operations at large M (2·M·N·K int8 operations against
// the data sheet's 1,979 TOP/s on the tensor cores), bytes at small M
// (the f32 output alone is 4·M·N bytes).  The design feeds the tensor
// cores the way Hopper wants to be fed:
//   * the product is `wgmma.mma_async ... m64n256k32.s32.u8.u8`: the
//     tensor cores take unsigned bytes directly, so the codes need no
//     -128 shift and the corrections stay the reference's;
//   * 8-bit wgmma reads both operands K-major from shared memory.  The
//     activations (M, K) are K-major already; the weights (K, N) are not,
//     so a prep kernel writes one transposed copy Wᵀ (N, Kp) per call into
//     scratch the wrapper allocates, and sums each column (Σw) on the way;
//     another sums each activation row (Σx).  Kp is K rounded up to 16
//     bytes, the row pitch TMA needs; a ragged K (or an activation tensor
//     that is not 16-byte aligned) also gets a zero-padded activation copy.
//     Zeros add nothing to acc, Σx or Σw;
//   * 128x256 output tiles per CTA of three warpgroups: one producer
//     thread keeps TMA loads of 128-byte K slices (128B-swizzled, the
//     layout the wgmma descriptors name) in flight through a 4-stage ring
//     of shared memory guarded by mbarriers, and two consumer warpgroups
//     each run wgmma on 64 rows x 256 columns into 128 int32 registers a
//     thread (setmaxnreg moves registers from the producer to them);
//   * TMA zero-fills the ragged M, N and K edges of every box.
// The epilogue evaluates Eq. 7 in the reference's order with
// round-to-nearest intrinsics (no fused multiply-add), so it matches the
// plain f32 version bit for bit.  255²·K stays below 2**31 up to
// K = 33,025, which the wrapper enforces.
#include "../../hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBM = 128;               // output rows per CTA
constexpr int kBN = 256;               // output columns per CTA
constexpr int kBK = 128;               // K bytes per stage (one swizzle row)
constexpr int kStages = 4;
constexpr int kConsumers = 2;          // warpgroups of 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kStageBytes = (kBM + kBN) * kBK;
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;

__device__ __forceinline__ void fence_operands(uint32_t (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64x256 int32, wgmma accumulator layout) += A (64x32 u8) · B (256x32
// u8)ᵀ, both read from shared memory through their descriptors.
__device__ __forceinline__ void wgmma_u8(uint32_t (&d)[128], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// Eq. 7 for one output, in the plain version's order of f32 roundings.
__device__ __forceinline__ float eq7(uint32_t acc, float zw_sx, float zx_sw,
                                     float kzz, float scale) {
  float y = __fsub_rn(__int2float_rn(static_cast<int>(acc)), zw_sx);
  y = __fsub_rn(y, zx_sw);
  y = __fadd_rn(y, kzz);
  return __fmul_rn(y, scale);
}

__global__ void __launch_bounds__(kThreads, 1)
crossbar_gemm_kernel(const __grid_constant__ CUtensorMap tma_x,
                     const __grid_constant__ CUtensorMap tma_w,
                     const int* __restrict__ sums, float* __restrict__ out,
                     int M, int N, int K, int nk, float zpx, float zpw,
                     float scale) {
  extern __shared__ uint8_t smem_raw[];
  // the 128B swizzle repeats every 1024 bytes: tiles start on that grid
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sa = base;                          // [stage][128 rows][128 B]
  uint8_t* sb = base + kStages * kBM * kBK;    // [stage][256 rows][128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + kStages * kBN * kBK);
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (tid == 0) {
      for (int it = 0; it < nk; ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], kStageBytes);
        tma_load_2d(sa + s * kBM * kBK, &tma_x, &full[s], it * kBK, m0);
        tma_load_2d(sb + s * kBN * kBK, &tma_w, &full[s], it * kBK, n0);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    const int c = wg - 1;
    uint32_t d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0;
    for (int it = 0; it < nk; ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      const uint32_t a = smem_u32(sa + s * kBM * kBK + c * 64 * kBK);
      const uint32_t b = smem_u32(sb + s * kBN * kBK);
      fence_operands(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        wgmma_u8(d, sw128_desc(a + 32 * kk, 16), sw128_desc(b + 32 * kk, 16));
      wgmma_commit();
      // keep this k-slice's products in flight; the previous slice's are
      // done, so its stage goes back to the producer
      wgmma_wait<1>();
      fence_operands(d);
      if (it > 0 && tid == 0) mbar_arrive(&empty[(it - 1) % kStages]);
    }
    wgmma_wait<0>();
    fence_operands(d);

    // epilogue: thread owns rows r0, r0 + 8 and column pairs 8j + 2(lane%4)
    const int warp = tid / 32, lane = tid % 32;
    const int r0 = m0 + c * 64 + warp * 16 + lane / 4, r1 = r0 + 8;
    const float kzz = __fmul_rn(__fmul_rn(static_cast<float>(K), zpx), zpw);
    const float zs0 = r0 < M ? __fmul_rn(zpw, __int2float_rn(sums[r0])) : 0.f;
    const float zs1 = r1 < M ? __fmul_rn(zpw, __int2float_rn(sums[r1])) : 0.f;
    const int* sw = sums + M;
    const bool pairs = (N & 1) == 0;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      if (col >= N) continue;
      const bool two = col + 1 < N;
      const float zw0 = __fmul_rn(zpx, __int2float_rn(sw[col]));
      const float zw1 = two ? __fmul_rn(zpx, __int2float_rn(sw[col + 1])) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = h ? r1 : r0;
        if (r >= M) continue;
        const float zs = h ? zs1 : zs0;
        const float y0 = eq7(d[4 * j + 2 * h], zs, zw0, kzz, scale);
        const float y1 = eq7(d[4 * j + 2 * h + 1], zs, zw1, kzz, scale);
        float* o = out + static_cast<size_t>(r) * N + col;
        if (pairs) {
          *reinterpret_cast<float2*>(o) = make_float2(y0, y1);
        } else {
          o[0] = y0;
          if (two) o[1] = y1;
        }
      }
    }
  }
}

// Σx per activation row, one warp a row; with `xp` also the zero-padded
// (M, Kp) copy TMA reads when K is ragged or x is not 16-byte aligned.
__global__ void __launch_bounds__(256)
x_rowsum_kernel(const uint8_t* __restrict__ x, int* __restrict__ sx,
                uint8_t* __restrict__ xp, int M, int K, int Kp) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m = blockIdx.x * 8 + warp;
  if (m >= M) return;
  const uint8_t* row = x + static_cast<size_t>(m) * K;
  uint32_t s = 0;
  if (xp == nullptr) {  // K % 16 == 0 and x 16-byte aligned
    const uint4* r4 = reinterpret_cast<const uint4*>(row);
    for (int i = lane; i < K / 16; i += 32) {
      const uint4 v = __ldg(r4 + i);
      s = __dp4a(v.x, 0x01010101u, s);
      s = __dp4a(v.y, 0x01010101u, s);
      s = __dp4a(v.z, 0x01010101u, s);
      s = __dp4a(v.w, 0x01010101u, s);
    }
  } else {
    uint8_t* prow = xp + static_cast<size_t>(m) * Kp;
    for (int k = lane; k < Kp; k += 32) {
      const uint8_t v = k < K ? row[k] : 0;
      prow[k] = v;
      s += v;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) sx[m] = static_cast<int>(s);
}

constexpr int kTile = 64;      // transpose tile: 64 k-rows x 64 columns
constexpr int kChunk = 512;    // k-rows one block walks

// Wᵀ (N, Kp) from W (K, N), zero past K, and Σw per column (added to
// sw, which the caller zeroed): each block walks 512 k-rows of a 64-column
// strip through a 64x64 shared-memory tile, 16 bytes per thread per load
// and per store.
__global__ void __launch_bounds__(256)
w_transpose_kernel(const uint8_t* __restrict__ w, uint8_t* __restrict__ wt,
                   int* __restrict__ sw, int K, int N, int Kp, int vec) {
  __shared__ uint32_t tile[kTile][kTile / 4 + 1];   // [k][column word]
  const int n0 = blockIdx.x * kTile, kc0 = blockIdx.y * kChunk;
  const int t = threadIdx.x;
  const int lr = t / 4, lseg = t % 4;   // load: k-row lr, columns 16·lseg..
  const int wn = t / 4, wseg = t % 4;   // store: column wn, k 16·wseg..
  const int kend = min(kc0 + kChunk, Kp);
  uint32_t colsum = 0;
  for (int k0 = kc0; k0 < kend; k0 += kTile) {
    const int k = k0 + lr, n = n0 + 16 * lseg;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (k < K) {
      const uint8_t* src = w + static_cast<size_t>(k) * N + n;
      if (vec && n + 16 <= N) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
        v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (n + 4 * q + e < N)
              v[q] |= static_cast<uint32_t>(src[4 * q + e]) << (8 * e);
      }
    }
    __syncthreads();   // the previous tile is consumed
#pragma unroll
    for (int q = 0; q < 4; ++q) tile[lr][4 * lseg + q] = v[q];
    __syncthreads();
    uint32_t o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const uint32_t src = tile[16 * wseg + 4 * q + b][wn / 4];
        word |= ((src >> (8 * (wn % 4))) & 0xffu) << (8 * b);
      }
      o[q] = word;
      colsum = __dp4a(word, 0x01010101u, colsum);
    }
    if (n0 + wn < N && k0 + 16 * wseg < Kp)
      *reinterpret_cast<uint4*>(wt + static_cast<size_t>(n0 + wn) * Kp + k0 +
                                16 * wseg) = make_uint4(o[0], o[1], o[2], o[3]);
  }
  colsum += __shfl_xor_sync(0xffffffffu, colsum, 1);
  colsum += __shfl_xor_sync(0xffffffffu, colsum, 2);
  if (wseg == 0 && n0 + wn < N) atomicAdd(sw + n0 + wn, static_cast<int>(colsum));
}

// Tensor map of a row-major (rows, Kp) uint8 matrix read in boxes of
// box_rows x 128 bytes with the 128B swizzle; returns a CUresult.
int encode_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int rows,
               int Kp, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(Kp),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(Kp)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return static_cast<int>(encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

}  // namespace

// x (M, K) and w (K, N) uint8 codes, out (M, N) f32, all contiguous;
// scratch from the caller: wt (N, Kp) uint8, sums (M + N) int32, and xp
// (M, Kp) uint8 when K % 16 != 0 or x is not 16-byte aligned (else null),
// Kp = K rounded up to a multiple of 16.  Returns 0 when every launch was
// accepted, a cudaError_t otherwise, or 100000 + the CUresult of a tensor
// map that could not be encoded.
extern "C" int crossbar_mvm_u8(const void* x, const void* w, void* out,
                               void* wt, void* xp, void* sums, int M, int K,
                               int N, float zpx, float zpw, float scale,
                               void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Kp = (K + 15) / 16 * 16;
  int* sx = static_cast<int*>(sums);
  int* sw = sx + M;
  cudaError_t err = cudaMemsetAsync(sw, 0, sizeof(int) * N, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  x_rowsum_kernel<<<(M + 7) / 8, 256, 0, st>>>(
      static_cast<const uint8_t*>(x), sx, static_cast<uint8_t*>(xp), M, K, Kp);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int vec = (N % 16 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  w_transpose_kernel<<<dim3((N + kTile - 1) / kTile, (Kp + kChunk - 1) / kChunk),
                       256, 0, st>>>(static_cast<const uint8_t*>(w),
                                     static_cast<uint8_t*>(wt), sw, K, N, Kp,
                                     vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const hopper::EncodeTiled encode = hopper::tensor_map_encoder(&err);
  if (encode == nullptr) return static_cast<int>(err);
  CUtensorMap map_x, map_w;
  int res = encode_map(encode, &map_x, xp ? xp : x, M, Kp, kBM);
  if (res != 0) return 100000 + res;
  res = encode_map(encode, &map_w, wt, N, Kp, kBN);
  if (res != 0) return 100000 + res;
  err = cudaFuncSetAttribute(crossbar_gemm_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  crossbar_gemm_kernel<<<grid, kThreads, kSmemBytes, st>>>(
      map_x, map_w, sx, static_cast<float*>(out), M, N, K,
      (Kp + kBK - 1) / kBK, zpx, zpw, scale);
  return static_cast<int>(cudaGetLastError());
}
