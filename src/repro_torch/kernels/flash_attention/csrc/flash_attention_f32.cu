// Flash-attention forward (prefill) kernel for Hopper (sm_90a), f32, on the
// CUDA cores.
//
// The f32 half of the port of the Pallas TPU kernel
// `flash_attention_pallas` (src/repro/kernels/flash_attention/kernel.py),
// which takes bf16 and f32 alike; `flash_attention.cu` is the bf16 half.
// Same function: softmax(q·kᵀ·scale)·v with an online softmax, causal
// (key j masked for query i when j > i) or full, GQA-native (query head h
// reads KV head h / (H / Hkv)).
//
// Why no tensor cores: the reference holds f32 attention to 3e-4, and
// TF32, the tensor cores' only f32 input, keeps a 10-bit mantissa (~1e-3
// relative per product).  So every product is an f32 FMA.
//
// Bound on an H100 (SXM data sheet, 700 W): operations.  A causal
// prefill of S tokens does about 2·S²·D·H flops over 4·S·D·H·4 bytes of
// f32 in and out, S/8 flops per byte: past S ~ 160 that is above the ~20
// flops per byte at which the 67 TFLOP/s f32 rate, not the 3.35 TB/s
// memory, sets the least time.
// The design is the simple, tiled-by-the-cache one that is right, not yet
// the fast one:
//   * one warp per (batch, query row, head).  Lane l holds elements
//     l, l + 32, ... of the query row and of the output accumulator
//     (kN = ceil(D / 32) each); a K or V row is read as coalesced 128-byte
//     segments;
//   * the eight warps of a CTA take eight consecutive query rows of one
//     (batch, head), so they walk the same K/V rows together and L1 serves
//     all but the first read of each: the cache is the key tile;
//   * keys in groups of 32 / kN, their K and V rows loaded into registers
//     before any is used; each score reduced over the warp by shuffles,
//     one online-softmax update per group (expf);
//   * a causal row stops at its diagonal, and the grid hands out the last
//     (longest) query rows first so the short ones fill the tail.
// Output acc / max(l, 1e-30), as the plain version's softmax.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // consecutive query rows per CTA

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  int B, Sq, Skv, H, Hkv, D, causal;
  float scale;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int kN>
__global__ void __launch_bounds__(kWarps * 32)
    flash_attention_f32_kernel(const Params p) {
  constexpr int kGroup = 32 / kN;  // keys whose K and V rows are in flight
  const int lane = threadIdx.x & 31;
  // blockIdx.x: query tile, last rows first; blockIdx.y: b·H + h
  const int tiles = (p.Sq + kWarps - 1) / kWarps;
  const int i = (tiles - 1 - (int)blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (i >= p.Sq) return;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.Hkv);
  int n_key = p.Skv;
  if (p.causal && i + 1 < n_key) n_key = i + 1;

  const size_t qrow = (((size_t)b * p.Sq + i) * p.H + h) * p.D;
  float q[kN], acc[kN];
#pragma unroll
  for (int e = 0; e < kN; ++e) {
    const int d = lane + 32 * e;
    q[e] = d < p.D ? p.q[qrow + d] : 0.f;
    acc[e] = 0.f;
  }
  const size_t kv0 = ((size_t)b * p.Skv * p.Hkv + kvh) * p.D;
  const size_t key_stride = (size_t)p.Hkv * p.D;
  float m = -INFINITY, l = 0.f;
  for (int j0 = 0; j0 < n_key; j0 += kGroup) {
    float kr[kGroup][kN], vr[kGroup][kN];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const size_t row = kv0 + (size_t)(j0 + j) * key_stride;
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        const int d = lane + 32 * e;
        const bool live = j0 + j < n_key && d < p.D;
        kr[j][e] = live ? __ldg(p.k + row + d) : 0.f;
        vr[j][e] = live ? __ldg(p.v + row + d) : 0.f;
      }
    }
    float s[kGroup];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < kN; ++e) part = fmaf(q[e], kr[j][e], part);
      s[j] = j0 + j < n_key ? warp_sum(part) * p.scale : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    const float corr = expf(m - mx);  // 0 on the first group (m = -inf)
    l *= corr;
#pragma unroll
    for (int e = 0; e < kN; ++e) acc[e] *= corr;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const float pj = expf(s[j] - mx);  // 0 past n_key
      l += pj;
#pragma unroll
      for (int e = 0; e < kN; ++e) acc[e] = fmaf(pj, vr[j][e], acc[e]);
    }
    m = mx;
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int e = 0; e < kN; ++e) {
    const int d = lane + 32 * e;
    if (d < p.D) p.out[qrow + d] = acc[e] * inv;
  }
}

template <int kN>
int launch(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.Sq + kWarps - 1) / kWarps, p.B * p.H);
  flash_attention_f32_kernel<kN><<<grid, kWarps * 32, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Sq, H, D), k/v (B, Skv, Hkv, D), out (B, Sq, H, D), all f32 and
// contiguous; D a multiple of 8 in [8, 256] (no padding: any such width
// is native here), B, Sq, Skv >= 1, H % Hkv == 0.  causal != 0 masks key j
// for query i when j > i.  Returns the cudaError_t of the launch
// (0 = launched).
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, int B, int Sq,
                                   int Skv, int H, int Hkv, int D,
                                   int causal, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || Hkv < 1 || H % Hkv != 0 || D % 8 != 0 ||
      D < 8 || D > 256 || (long long)B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.out = static_cast<float*>(out);
  p.B = B;
  p.Sq = Sq;
  p.Skv = Skv;
  p.H = H;
  p.Hkv = Hkv;
  p.D = D;
  p.causal = causal;
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
