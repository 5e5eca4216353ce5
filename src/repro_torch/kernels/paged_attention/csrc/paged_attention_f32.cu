// Paged-attention decode kernel for Hopper (sm_90a), f32, on the CUDA cores.
//
// The f32 half of the port of the Pallas TPU kernel `paged_attention_pallas`
// (src/repro/kernels/paged_attention/kernel.py), which takes bf16 and f32
// alike; `paged_attention.cu` is the bf16 half.  Same function: one query
// token per batch row attends over that row's K/V, which live in a page
// pool (P, page, Hkv, D) addressed through a page table (B, T); query head
// h reads KV head h / G.
//
// Why no tensor cores: the reference holds f32 attention to 3e-4, and
// TF32, the tensor cores' only f32 input, keeps a 10-bit mantissa (~1e-3
// relative per product).  So every product is an f32 FMA.
//
// Bound on an H100 (SXM data sheet, 700 W): bytes.  Each (row, KV head)
// reads (pos + 1) K rows and (pos + 1) V rows of D f32 values once and
// does 4·G·D flops per token, G/2 flops per byte, far under the ~20 flops
// per byte at which the 67 TFLOP/s f32 rate, not the 3.35 TB/s memory,
// would be the limit.  The design is the simple one that is right, not
// yet the fast one:
//   * one warp per (row, query head).  Lane l holds elements l, l + 32, ...
//     of the query and of the output accumulator (kN = ceil(D / 32) each),
//     so a K or V row is read by the warp as coalesced 128-byte segments;
//     the G warps of one KV head read the same rows, which L1 and L2 serve
//     after the first;
//   * tokens in groups of 32 / kN: the group's K and V rows are loaded
//     into registers before any is used, so a warp waits one memory
//     latency per group rather than two per token;
//   * each score is reduced over the warp by shuffles, then one
//     online-softmax update per group (natural-exponent domain, expf);
//   * only tokens 0 .. min(pos, T·page − 1) are read: stale pages past a
//     row's position and the scratch page of an inactive row stay
//     untouched.
// Semantics as the plain version's: scores (q·k)·scale, n_tok =
// min(pos + 1, T·page), output acc / max(l, 1e-30).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // (row, query head) pairs per CTA

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const int* tables;
  const int* pos;
  float* out;
  int B, H, Hkv, G, D, page, T;
  float scale;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int kN>
__global__ void __launch_bounds__(kWarps * 32)
    paged_attention_f32_kernel(const Params p) {
  constexpr int kGroup = 32 / kN;  // tokens whose K and V rows are in flight
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);  // b·H + h
  if (w >= p.B * p.H) return;
  const int b = w / p.H;
  const int kvh = (w % p.H) / p.G;
  int n_tok = p.pos[b] + 1;
  if (n_tok > p.T * p.page) n_tok = p.T * p.page;

  float q[kN], acc[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int d = lane + 32 * i;
    q[i] = d < p.D ? p.q[(size_t)w * p.D + d] : 0.f;
    acc[i] = 0.f;
  }
  const int* table = p.tables + (size_t)b * p.T;
  const size_t token_stride = (size_t)p.Hkv * p.D;
  float m = -INFINITY, l = 0.f;
  for (int t0 = 0; t0 < n_tok; t0 += kGroup) {
    float kr[kGroup][kN], vr[kGroup][kN];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int t = t0 + j;
      const size_t row =
          t < n_tok ? ((size_t)table[t / p.page] * p.page + t % p.page) *
                              token_stride +
                          (size_t)kvh * p.D
                    : 0;
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const int d = lane + 32 * i;
        const bool live = t < n_tok && d < p.D;
        kr[j][i] = live ? __ldg(p.k + row + d) : 0.f;
        vr[j][i] = live ? __ldg(p.v + row + d) : 0.f;
      }
    }
    float s[kGroup];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kN; ++i) part = fmaf(q[i], kr[j][i], part);
      s[j] = t0 + j < n_tok ? warp_sum(part) * p.scale : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    const float corr = expf(m - mx);  // 0 on the first group (m = -inf)
    l *= corr;
#pragma unroll
    for (int i = 0; i < kN; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const float pj = expf(s[j] - mx);  // 0 past n_tok
      l += pj;
#pragma unroll
      for (int i = 0; i < kN; ++i) acc[i] = fmaf(pj, vr[j][i], acc[i]);
    }
    m = mx;
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int d = lane + 32 * i;
    if (d < p.D) p.out[(size_t)w * p.D + d] = acc[i] * inv;
  }
}

template <int kN>
int launch(const Params& p, cudaStream_t stream) {
  const int warps = p.B * p.H;
  paged_attention_f32_kernel<kN>
      <<<(warps + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Hkv*G, D), k/v pools (P, page, Hkv, D), out (B, Hkv*G, D), all f32
// and contiguous; tables (B, T) int32 physical page ids; pos (B,) int32.
// D a multiple of 8 in [8, 256], G in [1, 16] (the bf16 kernel's contract).
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int paged_attention_f32(const void* q, const void* k_pool,
                                   const void* v_pool, const void* tables,
                                   const void* pos, void* out, int B,
                                   int Hkv, int G, int D, int page, int T,
                                   float scale, void* stream) {
  if (D % 8 != 0 || D < 8 || D > 256 || G < 1 || G > 16 || B < 1 ||
      Hkv < 1 || page < 1 || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k_pool);
  p.v = static_cast<const float*>(v_pool);
  p.tables = static_cast<const int*>(tables);
  p.pos = static_cast<const int*>(pos);
  p.out = static_cast<float*>(out);
  p.B = B;
  p.H = Hkv * G;
  p.Hkv = Hkv;
  p.G = G;
  p.D = D;
  p.page = page;
  p.T = T;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
