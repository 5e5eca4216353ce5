// Flash-attention forward (prefill) kernel for Hopper (sm_90a), bf16.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention/kernel.py): the FlashAttention-2
// forward with an online softmax in f32, causal or full, keys at or past
// the valid length masked.  Unlike the TPU kernel it is GQA-native (query
// head h reads KV head h / (H / Hkv); K/V are never repeated) and masks the
// ragged tail itself, so no sequence is padded to a block multiple.
//
// Bound on an H100.  A causal prefill of S tokens does about 2·S²·D·H
// flops over 4·S·D·H·2 bytes of bf16 in and out: S/4 flops per byte, 128
// at S = 512, under the card's ~295 flops/byte balance point — so the
// least time is set by bytes at 3.35 TB/s up to S of about 1200, and by
// the 989 TFLOP/s bf16 tensor-core rate past it.  A prefill this short is
// in practice set by how fast one CTA walks its keys, and with mma.sync
// every 16-row warp reads the whole key tile out of shared memory again.
// So both products run as warpgroup MMAs, which read a tile once per 64
// query rows, and the loads run on the TMA:
//   * one CTA of two warpgroups per 64-query tile of one (batch, head).
//     The warpgroups take alternate key tiles for the same 64 rows, so one
//     multiplies while the other runs its softmax or waits for its load;
//     their partial softmax states (max, sum, O) merge at the end;
//   * Q (64 x D) and three stages of K and V (64 keys x D each) sit in
//     shared memory as 64-column boxes, loaded by TMA with the 128B
//     swizzle (rows past the sequence zero-filled) and tracked by
//     mbarriers; a stage has one reader at a time, the warpgroup of its
//     tile, which releases it and refills it with the tile three ahead as
//     soon as it has multiplied it;
//   * S = Q·Kᵀ is `wgmma` m64n64k16 bf16 -> f32 with both operands read
//     from shared memory (K-major); O += P·V is `wgmma` m64n64k16 per 16
//     keys and 64-column block of O, with P from registers — the S
//     accumulator rounded to bf16, whose fragment layout is the A
//     operand's — and V read transposed (it is stored key-major);
//   * the online softmax runs on the accumulator fragments in the exp2
//     domain, row maxima reduced over the four threads of a row;
//   * causal CTAs stop at their diagonal tile, and the grid hands out the
//     heaviest (diagonal-most) query tiles first so the short ones fill
//     the tail.
// At D = 256 the O accumulator is 128 f32 registers a thread and the CTA
// takes 225 KB of dynamic shared memory (one CTA an SM); the launch raises
// the limit with cudaFuncSetAttribute.  D = 32 loads 64-column boxes too
// (the extra columns are discarded), which keeps one layout for every D.
#include <cuda_bf16.h>
#include <math.h>

#include "../../hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per stage
constexpr int kStages = 3;     // K/V tiles in flight (3 x 64 KB at D = 256)
constexpr int kThreads = 256;  // two warpgroups, alternate key tiles
constexpr int kBox = 64 * 64 * 2;   // one 64-row x 64-column bf16 box
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMaskedLse = -2.0e38f;   // the reference's NEG_INF

typedef __nv_bfloat16 bf16;

// 64-column boxes per row of Q, K or V
__host__ __device__ constexpr int boxes(int D) { return D < 64 ? 1 : D / 64; }

__host__ __device__ constexpr int smem_bytes(int D) {
  // Q, kStages x (K, V), alignment, barriers
  return (1 + 2 * kStages) * boxes(D) * kBox + 1024 + 8 * (1 + 2 * kStages);
}

__device__ __forceinline__ void fence_operands(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64x64 f32) = (scale_d ? d : 0) + A (64x16, smem) · B (64x16, smem)ᵀ
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64x64 f32) += A (64x16 bf16, registers) · B (16x64, smem, stored
// N-contiguous: transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       bf16* __restrict__ out, float* __restrict__ lse,
                       int B, int Sq, int Skv, int H, int Hkv, int causal,
                       float scale) {
  constexpr int NBX = boxes(D);
  constexpr int KS = D / 16;               // k-steps of Q·Kᵀ
  constexpr uint32_t kStageTx = 2 * NBX * kBox;
  extern __shared__ uint8_t smem_raw[];
  // the 128B swizzle repeats every 1024 bytes: boxes start on that grid
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = base;                               // [box][64][64]
  uint8_t* kv_s = base + NBX * kBox;                 // [stage][K|V][box]
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(base + (1 + 2 * kStages) * NBX * kBox);
  uint64_t* qbar = bars;                     // Q landed
  uint64_t* full = bars + 1;                 // [stage] its K and V landed
  uint64_t* empty = full + kStages;          // [stage] its tile was read

  // heaviest query tiles first: the tile index runs slowest, backwards
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / (H * B);
  const int rem = static_cast<int>(blockIdx.x) % (H * B);
  const int h = rem % H, b = rem / H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * kBQ;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, cq = lane % 4;
  const int kv_end = causal ? min(Skv, q0 + kBQ) : Skv;
  const int n_kt = (kv_end + kBK - 1) / kBK;

  auto load_kv = [&](int t) {
    const int st = t % kStages;
    uint8_t* dst = kv_s + st * 2 * NBX * kBox;
    mbar_expect_tx(&full[st], kStageTx);
#pragma unroll
    for (int x = 0; x < NBX; ++x) {
      tma_load_3d(dst + x * kBox, &map_k, &full[st], hk * D + 64 * x,
                  t * kBK, b);
      tma_load_3d(dst + (NBX + x) * kBox, &map_v, &full[st], hk * D + 64 * x,
                  t * kBK, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 1);
    }
    mbar_init_fence();
    mbar_expect_tx(qbar, NBX * kBox);
#pragma unroll
    for (int x = 0; x < NBX; ++x)
      tma_load_3d(q_s + x * kBox, &map_q, qbar, h * D + 64 * x, q0, b);
    for (int t = 0; t < min(n_kt, kStages); ++t) load_kv(t);
  }
  __syncthreads();

  float o[NBX][32];
#pragma unroll
  for (int x = 0; x < NBX; ++x)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[x][i] = 0.f;
  // running max (-inf until a row meets a key it may see) and this
  // thread's share of the denominator, for rows g and g + 8 of its warp
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  const float sl2 = scale * kLog2e;
  const int row_a = q0 + 16 * warp + g, row_b = row_a + 8;
  const uint32_t q_addr = smem_u32(q_s);
  mbar_wait(qbar, 0);

  // warpgroup wg takes key tiles wg, wg + 2, ...
  for (int t = wg; t < n_kt; t += 2) {
    const int j0 = t * kBK;
    const int st = t % kStages;
    const uint32_t k_addr = smem_u32(kv_s + st * 2 * NBX * kBox);
    const uint32_t v_addr = k_addr + NBX * kBox;
    // a stage's tiles alternate between the warpgroups: wait until the
    // previous tile of this stage was read, so that `full` cannot be two
    // phases behind this wait's parity
    if (t >= kStages) mbar_wait(&empty[st], (t / kStages - 1) & 1);
    mbar_wait(&full[st], (t / kStages) & 1);

    // S (64 rows x 64 keys) = Q · Kᵀ
    float s[32];
    fence_operands(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint32_t off = (ks / 4) * kBox + (ks % 4) * 32;
      wgmma_ss(s, sw128_desc(q_addr + off, 16), sw128_desc(k_addr + off, 16),
               ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);

    // mask where the tile reaches past the valid keys or the diagonal of
    // the warp's first row; s[4j + e] is row (e < 2 ? g : g + 8), key
    // 8j + 2cq + (e & 1)
    const bool edge = j0 + kBK > Skv || (causal && j0 + kBK - 1 > q0 + 16 * warp);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * sl2;
      if (edge) {
        const int key = j0 + 8 * (i / 4) + 2 * cq + (i & 1);
        const int row = (i & 2) ? row_b : row_a;
        if (key >= Skv || (causal && key > row)) x = -INFINITY;
      }
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      // a row that has seen no key yet keeps a zero reference point, so
      // exp2 of its masked scores is 0 rather than NaN
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m_r[r] - m_use[r]);
      m_r[r] = m_new;
      l_r[r] *= corr;
#pragma unroll
      for (int x = 0; x < NBX; ++x)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[x][4 * j + 2 * r] *= corr;
          o[x][4 * j + 2 * r + 1] *= corr;
        }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float pv = exp2f(s[i] - m_use[(i >> 1) & 1]);
      s[i] = pv;
      l_r[(i >> 1) & 1] += pv;
    }

    // O += P · V, P the S accumulator rounded to bf16: keys 16kk..16kk+15
    // are accumulator columns 2kk and 2kk + 1, the A fragment's layout
    uint32_t p[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
#pragma unroll
    for (int x = 0; x < NBX; ++x) fence_operands(o[x]);
    wgmma_fence();
#pragma unroll
    for (int x = 0; x < NBX; ++x)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(o[x], p[kk], sw128_desc(v_addr + x * kBox + kk * 2048, kBox));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int x = 0; x < NBX; ++x) fence_operands(o[x]);

    // every warp of this warpgroup is done with the stage, the tile's only
    // reader: release it and refill it with the tile kStages ahead
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    if (tid == 0) {
      mbar_arrive(&empty[st]);
      if (t + kStages < n_kt) load_kv(t + kStages);
    }
  }
  __syncthreads();   // both warpgroups are done with every stage

  // merge the two warpgroups' partial softmax states: the second hands
  // (m, l, O) over through the idle K/V stages, the first rescales, adds
  // and writes
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  float* xo = reinterpret_cast<float*>(kv_s);    // [NBX * 8][128 threads][4]
  float* xm = xo + NBX * 8 * 128 * 4;            // [128 threads][4]
  if (wg == 1) {
#pragma unroll
    for (int x = 0; x < NBX; ++x)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float4*>(xo + ((x * 8 + j) * 128 + tid) * 4) =
            make_float4(o[x][4 * j], o[x][4 * j + 1], o[x][4 * j + 2],
                        o[x][4 * j + 3]);
    *reinterpret_cast<float4*>(xm + tid * 4) =
        make_float4(m_r[0], m_r[1], l_r[0], l_r[1]);
  }
  __syncthreads();
  if (wg == 1) return;
  const float4 ml = *reinterpret_cast<const float4*>(xm + tid * 4);
  const float m_o[2] = {ml.x, ml.y}, l_o[2] = {ml.z, ml.w};
  float a_self[2], a_other[2], inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m = fmaxf(m_r[r], m_o[r]);
    const float mu = m == -INFINITY ? 0.f : m;
    a_self[r] = exp2f(m_r[r] - mu);
    a_other[r] = exp2f(m_o[r] - mu);
    const float l = l_r[r] * a_self[r] + l_o[r] * a_other[r];
    inv[r] = 1.f / fmaxf(l, 1e-30f);
    // the row's log-sum-exp in natural-log units, for the backward pass:
    // the merged statistics are in the log2 domain of scale·log2(e)
    const int row = r ? row_b : row_a;
    if (lse != nullptr && cq == 0 && row < Sq)
      lse[(static_cast<size_t>(b) * H + h) * Sq + row] =
          m == -INFINITY ? kMaskedLse : (mu + log2f(fmaxf(l, 1e-30f))) * kLn2;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row_b : row_a;
    if (row >= Sq) continue;
    bf16* og = out + ((static_cast<size_t>(b) * Sq + row) * H + h) * D;
#pragma unroll
    for (int x = 0; x < NBX; ++x)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * x + 8 * j + 2 * cq;
        const float4 y =
            *reinterpret_cast<const float4*>(xo + ((x * 8 + j) * 128 + tid) * 4);
        const float y0 = r ? y.z : y.x, y1 = r ? y.w : y.y;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(og + col) = __floats2bfloat162_rn(
              (o[x][4 * j + 2 * r] * a_self[r] + y0 * a_other[r]) * inv[r],
              (o[x][4 * j + 2 * r + 1] * a_self[r] + y1 * a_other[r]) * inv[r]);
      }
  }
}

// Tensor map of a (batch, rows, heads·D) bf16 tensor read in 64-row x
// 64-column boxes with the 128B swizzle; out-of-range rows (and columns)
// read as zeros.  Returns a CUresult.
int encode_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B,
               int rows, int width) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(width) * 2,
                                 static_cast<cuuint64_t>(width) * 2 * rows};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return static_cast<int>(encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int Sq, int Skv, int H, int Hkv, int causal, float scale,
           cudaStream_t stream) {
  cudaError_t err;
  const EncodeTiled encode = tensor_map_encoder(&err);
  if (encode == nullptr) return static_cast<int>(err);
  CUtensorMap mq, mk, mv;
  int res = encode_map(encode, &mq, q, B, Sq, H * D);
  if (res == 0) res = encode_map(encode, &mk, k, B, Skv, Hkv * D);
  if (res == 0) res = encode_map(encode, &mv, v, B, Skv, Hkv * D);
  if (res != 0) return 100000 + res;
  constexpr int bytes = smem_bytes(D);
  err = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long ctas = static_cast<long long>((Sq + kBQ - 1) / kBQ) * H * B;
  flash_attention_kernel<D><<<static_cast<unsigned>(ctas), kThreads, bytes,
                              stream>>>(mq, mk, mv, static_cast<bf16*>(out),
                                        lse, B, Sq, Skv, H, Hkv, causal,
                                        scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Sq, H, D), k/v (B, Skv, Hkv, D), out (B, Sq, H, D), all bf16,
// contiguous and 16-byte aligned, B, Sq, Skv >= 1; H % Hkv == 0.
// causal != 0 masks key j for query i when j > i.  A non-null `lse`
// (B, H, Sq) f32 receives each row's log-sum-exp of its scaled scores in
// natural-log units (the backward pass's statistic; -2e38 for a row that
// sees no key); null writes nothing more.  Returns 0 when the launch was
// accepted, a cudaError_t otherwise, or 100000 + the CUresult of a tensor
// map that could not be encoded.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, void* lse,
                                    int B, int Sq, int Skv, int H, int Hkv,
                                    int D, int causal, float scale,
                                    void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(q, k, v, out, static_cast<float*>(lse), B, Sq,
                          Skv, H, Hkv, causal, scale, s);
    case 64:
      return launch<64>(q, k, v, out, static_cast<float*>(lse), B, Sq,
                          Skv, H, Hkv, causal, scale, s);
    case 128:
      return launch<128>(q, k, v, out, static_cast<float*>(lse), B, Sq,
                          Skv, H, Hkv, causal, scale, s);
    case 256:
      return launch<256>(q, k, v, out, static_cast<float*>(lse), B, Sq,
                          Skv, H, Hkv, causal, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
