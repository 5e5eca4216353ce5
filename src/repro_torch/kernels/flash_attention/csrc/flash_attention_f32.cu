// Flash-attention forward (prefill) kernel for Hopper (sm_90a), f32, on the
// tensor cores in split TF32 ("3xTF32").
//
// The f32 half of the port of the Pallas TPU kernel
// `flash_attention_pallas` (src/repro/kernels/flash_attention/kernel.py),
// which takes bf16 and f32 alike; `flash_attention.cu` is the bf16 half.
// Same function: softmax(q·kᵀ·scale)·v with an online softmax, causal
// (key j masked for query i when j > i) or full, GQA-native (query head h
// reads KV head h / (H / Hkv)).
//
// Why split TF32: the reference holds f32 attention to 3e-4, and TF32, the
// tensor cores' only f32 input, keeps a 10-bit mantissa, so one TF32 pass
// is ~1.6e-3 off at S 512 D 256.  Each f32 operand x is split into
// hi = x rounded to TF32 (cvt.rna's rounding) and lo = x − hi, and a·b is
// taken as a_lo·b_hi + a_hi·b_lo + a_hi·b_hi with f32 sums (CUTLASS's
// OpMultiplyAddFastF32).  The dropped a_lo·b_lo and the TF32 part of lo
// leave ~2^-21 of each product, and the result is within ~4e-6 of
// full-f32 attention.  A single TF32 pass is never taken.
//
// Bound on an H100 (SXM data sheet, 700 W): operations.  A causal prefill
// of S tokens does about 2·S²·D·H flops over 4·S·D·H·4 bytes of f32 in and
// out, S/8 flops per byte.  On the CUDA cores (67 TFLOP/s f32) that is
// above the memory's rate past S ~ 160; as 3xTF32 on the tensor cores
// (495 TFLOP/s TF32, three passes: 165 TFLOP/s of f32 work) past S ~ 400.
// At B 1, S 512, H 16, D 256 causal: 0.0321 ms on the CUDA cores,
// 0.0130 ms as 3xTF32.  What the design does about it:
//   * `mma.sync.m16n8k8` TF32 for S = Q·Kᵀ and O = P·V (`wgmma` takes tf32
//     only with both operands K-major, and V, (key, D), is not for P·V).
//     A CTA of four warps takes 32 query rows of one (batch, head): two
//     row groups of 16, each split over two warps that take the two
//     16-key halves of every 32-key tile.  Each warp keeps its own online
//     softmax (m, l) and O (16 x D in f32 registers, 128 a thread at
//     D 256); the two halves merge once, through shared memory, at the
//     end, so no warp waits on another inside the key loop;
//   * raw f32 in shared memory, split as fragments load: Q and K
//     fragments through `ldmatrix` (a 16-byte row is four f32), V's as
//     single words; hi is rounded with two integer operations (ptxas
//     expands cvt.rna.tf32.f32 into five).  Rows are padded to D + 4
//     floats, which makes every fragment load free of bank conflicts;
//   * each of the three products runs as a pass over independent
//     accumulators (S: small terms and hi·hi apart, for two k steps at a
//     time; O: four n tiles at a time), so no product waits on the one
//     issued before it;
//   * P never leaves registers: S's accumulator layout is P's A fragment
//     once the keys of each k8 step are taken in the order 0, 2, 4, 6,
//     1, 3, 5, 7, and V's B fragment reads its rows in that order;
//   * K/V tiles of 32 keys through a double-buffered `cp.async` ring
//     (16-byte copies, keys past the causal limit zero-filled, not read);
//     the Q tile lands with the first;
//   * a causal CTA stops at its last row's diagonal, a warp skips a half
//     tile masked for all its rows, and the grid hands out the last
//     (longest) query tiles of every head first;
//   * every head dim that is a multiple of 8 is native (k8 and n8 steps);
//     32, 64, 128 and 256 get code with no bounds checks in the loops.
// What is left between this kernel and its bound: `mma.sync` issues TF32
// below the `wgmma` rate the bound assumes, three times per fragment, and
// at D 256 shared memory fits one CTA (four warps) on an SM.
// Semantics as the plain version's: scores (q·k)·scale, masked −1e30,
// output acc / max(l, 1e-30).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowGroups = 2;                 // 16-row groups per CTA
constexpr int kBlockRows = 16 * kRowGroups;   // query rows per CTA
constexpr int kThreads = 64 * kRowGroups;     // two key halves per group
constexpr int kKeys = 32;                     // keys per ring stage
constexpr int kGroup = 4;                     // n tiles per P·V pass
constexpr float kNegInf = -1.0e30f;           // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMaskedLse = -2.0e38f;        // the reference's NEG_INF

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  float* lse;  // (B, H, Sq) or null
  int B, Sq, Skv, H, Hkv, D, causal;
  float scale_log2;
};

// Shared memory: the raw Q tile, then two K/V stages; rows of D + 4 floats.
__host__ __device__ constexpr int smem_floats(int D) {
  return (kBlockRows + 2 * 2 * kKeys) * (D + 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `bytes` 0 fills the destination with zeros
// and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Four 8x4 f32 matrices (ldmatrix's 8x8 b16): lane l gets word l % 4 of
// row l / 4 of each; lane i gives the address of row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const float* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// x = hi + lo: hi is x rounded to TF32, to nearest with ties away from
// zero (add half of TF32's last place to the bits, clear the 13 below it:
// what cvt.rna.tf32.f32 gives for finite x, in two integer operations
// where ptxas expands cvt.rna into five), lo = x − hi exactly, of which
// the tensor core reads the TF32 part (the top 19 bits).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a (16x8, row) · b (8x8, col), TF32 in, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Reductions over the four lanes that share an accumulator row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// kN: D <= 32·kN, so a warp's O is 4·kN n-tiles of 8 columns; kFull:
// D == 32·kN, so the k and n loops need no bound of their own.
template <int kN, bool kFull>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_f32_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kNT = 4 * kN;
  const int D = p.D, rs = D + 4, n_kt = D / 8;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.Hkv);
  // blockIdx.y: query tile, last (longest) first
  const int r0 = ((int)gridDim.y - 1 - (int)blockIdx.y) * kBlockRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int rg = warp % kRowGroups, half = warp / kRowGroups;
  const int wrow0 = r0 + 16 * rg;  // this warp's first query row
  float* qs = smem;
  float* ring = smem + kBlockRows * rs;
  const int stage = 2 * kKeys * rs;
  int n_key = p.Skv;
  if (p.causal && r0 + kBlockRows < n_key) n_key = r0 + kBlockRows;
  const int n_tiles = (n_key + kKeys - 1) / kKeys;

  // the Q tile (rows past Sq zero-filled), then the first K/V tile
  {
    constexpr int kPer = kThreads / kBlockRows;  // threads per Q row
    const int r = tid / kPer, i = r0 + r;
    const float* src =
        p.q + (((size_t)b * p.Sq + (i < p.Sq ? i : 0)) * p.H + h) * D;
    for (int c = tid % kPer; c < D / 4; c += kPer)
      cp_async16(qs + r * rs + 4 * c, src + 4 * c, i < p.Sq ? 16 : 0);
  }
  auto issue_kv = [&](int t) {
    constexpr int kPer = kThreads / kKeys;  // threads per key row
    const int r = tid / kPer, key = t * kKeys + r;
    const bool live = key < n_key;
    const size_t off =
        (((size_t)b * p.Skv + (live ? key : 0)) * p.Hkv + kvh) * D;
    float* ks = ring + (t & 1) * stage;
    float* vs = ks + kKeys * rs;
    for (int c = tid % kPer; c < D / 4; c += kPer) {
      cp_async16(ks + r * rs + 4 * c, p.k + off + 4 * c, live ? 16 : 0);
      cp_async16(vs + r * rs + 4 * c, p.v + off + 4 * c, live ? 16 : 0);
    }
  };
  issue_kv(0);
  cp_async_commit();

  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // rows gid, gid + 8

  // lane offsets of the ldmatrix row addresses (A: Q, B: K)
  const int qa_off =
      (16 * rg + (lane & 7) + 8 * ((lane >> 3) & 1)) * rs + 4 * (lane >> 4);
  const int kb_off =
      (16 * half + (lane & 7) + 8 * (lane >> 4)) * rs + 4 * ((lane >> 3) & 1);

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) issue_kv(t + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and Q) landed for this thread
    __syncthreads();     // and for every thread
    const float* ks = ring + (t & 1) * stage;
    const float* vs = ks + kKeys * rs;
    const int key0 = t * kKeys + 16 * half;  // this warp's first key
    // warp-uniform: a half tile past the keys, or masked for all 16 rows
    if (key0 < n_key && !(p.causal && key0 > wrow0 + 15)) {
      // 1. S = Q·Kᵀ over this warp's 16 keys, two k steps at a time: the
      //    small terms and hi·hi of each step in accumulators of their own
      //    (eight independent chains), issued in three passes so that no
      //    product waits on the one before it
      float sb[2][2][4], ss[2][2][4];  // [k step parity][n tile][element]
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sb[u][j][e] = ss[u][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kNT; kk += 2) {
        if (kFull || kk < n_kt) {  // warp-uniform
          uint32_t ah[2][4], al[2][4], bh[2][2][2], bl[2][2][2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            uint32_t a[4] = {0u, 0u, 0u, 0u}, bk[4] = {0u, 0u, 0u, 0u};
            if (kFull || kk + u < n_kt) {  // an odd last step adds zeros
              ldmatrix_x4(a, qs + qa_off + 8 * (kk + u));
              ldmatrix_x4(bk, ks + kb_off + 8 * (kk + u));
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              split(__uint_as_float(a[e]), ah[u][e], al[u][e]);
              split(__uint_as_float(bk[e]), bh[u][e / 2][e % 2],
                    bl[u][e / 2][e % 2]);
            }
          }
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int j = 0; j < 2; ++j) mma_tf32(ss[u][j], al[u], bh[u][j]);
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int j = 0; j < 2; ++j) mma_tf32(sb[u][j], ah[u], bh[u][j]);
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int j = 0; j < 2; ++j) mma_tf32(ss[u][j], ah[u], bl[u][j]);
        }
      }
      // 2. scale into the log2 domain, mask, one online-softmax update
      float s[2][4], mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + 8 * j + 2 * tig + (e & 1);
          const int row = wrow0 + gid + 8 * (e >> 1);
          const bool masked = key >= p.Skv || (p.causal && key > row);
          const float dot = (sb[0][j][e] + sb[1][j][e]) +
                            (ss[0][j][e] + ss[1][j][e]);
          s[j][e] = masked ? kNegInf : dot * p.scale_log2;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        corr[r] = exp2f(m[r] - m_new);  // 0 on the warp's first tile
        m[r] = m_new;
        l[r] *= corr[r];  // a thread's own share of l; summed at the end
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2f(s[j][e] - m[e >> 1]);
          l[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        acc[j][0] *= corr[0];
        acc[j][1] *= corr[0];
        acc[j][2] *= corr[1];
        acc[j][3] *= corr[1];
      }
      // 3. O += P·V: k step kk takes keys 8kk + {0, 2, 4, 6, 1, 3, 5, 7},
      //    so S's accumulators are P's A fragment as they stand; n tiles
      //    in groups of kGroup, each product's pass over the group issued
      //    before the next, so that no product waits on the one before it
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t ah[4], al[4];
        split(s[kk][0], ah[0], al[0]);
        split(s[kk][2], ah[1], al[1]);
        split(s[kk][1], ah[2], al[2]);
        split(s[kk][3], ah[3], al[3]);
        const float* v0 = vs + (16 * half + 8 * kk + 2 * tig) * rs + gid;
#pragma unroll
        for (int j0 = 0; j0 < kNT; j0 += kGroup) {
          if (kFull || j0 < n_kt) {  // warp-uniform
            uint32_t bh[kGroup][2], bl[kGroup][2];
#pragma unroll
            for (int u = 0; u < kGroup; ++u) {
              const int j = kFull || j0 + u < n_kt ? j0 + u : j0;
              split(v0[8 * j], bh[u][0], bl[u][0]);
              split(v0[rs + 8 * j], bh[u][1], bl[u][1]);
            }
#pragma unroll
            for (int u = 0; u < kGroup; ++u)
              if (kFull || j0 + u < n_kt) mma_tf32(acc[j0 + u], al, bh[u]);
#pragma unroll
            for (int u = 0; u < kGroup; ++u)
              if (kFull || j0 + u < n_kt) mma_tf32(acc[j0 + u], ah, bl[u]);
#pragma unroll
            for (int u = 0; u < kGroup; ++u)
              if (kFull || j0 + u < n_kt) mma_tf32(acc[j0 + u], ah, bh[u]);
          }
        }
      }
    }
    __syncthreads();  // stage t & 1 is free for tile t + 2
  }
  cp_async_wait<0>();
  __syncthreads();

  // merge the two key halves: half 1 hands (m, l, O) over in lane order
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
  float* xch = smem + rg * (4 * n_kt + 4) * 32;  // Q and the ring are free
  if (half == 1) {
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      if (j < n_kt)
#pragma unroll
        for (int e = 0; e < 4; ++e) xch[(4 * j + e) * 32 + lane] = acc[j][e];
    xch[(4 * n_kt + 0) * 32 + lane] = m[0];
    xch[(4 * n_kt + 1) * 32 + lane] = m[1];
    xch[(4 * n_kt + 2) * 32 + lane] = l[0];
    xch[(4 * n_kt + 3) * 32 + lane] = l[1];
  }
  __syncthreads();
  if (half == 1) return;
  float w0[2], w1[2], inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = xch[(4 * n_kt + r) * 32 + lane];
    const float l1 = xch[(4 * n_kt + 2 + r) * 32 + lane];
    const float mx = fmaxf(m[r], m1);
    w0[r] = exp2f(m[r] - mx);
    w1[r] = exp2f(m1 - mx);
    const float lt = l[r] * w0[r] + l1 * w1[r];
    inv[r] = 1.f / fmaxf(lt, 1e-30f);
    // the row's log-sum-exp in natural-log units (m is in the log2
    // domain of scale·log2(e)), for the backward pass
    const int i = wrow0 + gid + 8 * r;
    if (p.lse != nullptr && tig == 0 && i < p.Sq)
      p.lse[((size_t)b * p.H + h) * p.Sq + i] =
          mx <= kNegInf ? kMaskedLse : (mx + log2f(fmaxf(lt, 1e-30f))) * kLn2;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = wrow0 + gid + 8 * r;
    if (i >= p.Sq) continue;
    float* orow = p.out + (((size_t)b * p.Sq + i) * p.H + h) * D + 2 * tig;
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      if (j < n_kt) {
        float2 o;
        o.x = (acc[j][2 * r] * w0[r] +
               xch[(4 * j + 2 * r) * 32 + lane] * w1[r]) * inv[r];
        o.y = (acc[j][2 * r + 1] * w0[r] +
               xch[(4 * j + 2 * r + 1) * 32 + lane] * w1[r]) * inv[r];
        *reinterpret_cast<float2*>(orow + 8 * j) = o;
      }
  }
}

template <int kN, bool kFull = false>
int launch(const Params& p, cudaStream_t stream) {
  auto kern = flash_attention_f32_kernel<kN, kFull>;
  const int bytes = smem_floats(p.D) * 4;
  static int smem_set = 0;  // per instance: the dynamic size allowed so far
  if (bytes > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = bytes;
  }
  const dim3 grid(p.B * p.H, (p.Sq + kBlockRows - 1) / kBlockRows);
  kern<<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Sq, H, D), k/v (B, Skv, Hkv, D), out (B, Sq, H, D), all f32,
// contiguous and 16-byte aligned; D a multiple of 8 in [8, 256] (no
// padding: any such width is native here), B, Sq, Skv >= 1, H % Hkv == 0.
// causal != 0 masks key j for query i when j > i.  A non-null `lse`
// (B, H, Sq) f32 receives each row's log-sum-exp of its scaled scores in
// natural-log units (-2e38 for a row that sees no key).  Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int B, int Sq, int Skv, int H, int Hkv,
                                   int D, int causal, float scale,
                                   void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || Hkv < 1 || H % Hkv != 0 || D % 8 != 0 ||
      D < 8 || D > 256 || (Sq + kBlockRows - 1) / kBlockRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.out = static_cast<float*>(out);
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.Sq = Sq;
  p.Skv = Skv;
  p.H = H;
  p.Hkv = Hkv;
  p.D = D;
  p.causal = causal;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {  // the widths of the bf16 kernel, with no bounds checks
    case 32: return launch<1, true>(p, s);
    case 64: return launch<2, true>(p, s);
    case 128: return launch<4, true>(p, s);
    case 256: return launch<8, true>(p, s);
  }
  switch ((D + 31) / 32) {
    case 1: return launch<1>(p, s);
    case 2: return launch<2>(p, s);
    case 3: return launch<3>(p, s);
    case 4: return launch<4>(p, s);
    case 5: return launch<5>(p, s);
    case 6: return launch<6>(p, s);
    case 7: return launch<7>(p, s);
    default: return launch<8>(p, s);
  }
}
