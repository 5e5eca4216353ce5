// Paged-attention decode kernel for Hopper (sm_90a), bf16.
//
// Replaces the Pallas TPU kernel `paged_attention_pallas`
// (src/repro/kernels/paged_attention/kernel.py): one query token per batch
// row attends over that row's K/V, which live in a page pool
// (P, page, Hkv, D) and are addressed through a page table (B, T).
//
// Bound on an H100: bytes.  Each (row, KV head) reads (pos + 1) K rows and
// (pos + 1) V rows of D bf16 values once and does 4·G·D flops per token —
// about G flops per byte, far below the ~295 flops/byte at which the card's
// bf16 tensor cores, not its 3.35 TB/s memory, would be the limit.  So the
// kernel's only job is to stream exactly the live K/V bytes at full rate:
//   * one CTA per (row, KV head); its G query heads share every K/V load
//     (GQA stays native — the pool is never expanded);
//   * the CTA walks only tokens 0..pos of its row (the TPU kernel's
//     `pos // page + 1` page bound, cut to the token), so stale pages past
//     pos and the scratch page 0 of inactive rows are never read for an
//     active row;
//   * its 8 warps split the live tokens; a warp reads a whole K or V row
//     per instruction (D/32 contiguous values per lane, 16-byte loads at
//     D = 256) and keeps 4 tokens' loads in flight for memory-level
//     parallelism;
//   * each warp keeps its own f32 online-softmax state (max, denominator,
//     D-wide accumulator split across lanes); the warps are merged once in
//     shared memory at the end.
// No tensor cores: at G <= 8 a decode token is a matrix-vector product.
// Splitting long rows across CTAs (flash-decoding) is left for later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;           // tokens each warp keeps in flight
constexpr float kNegInf = -1.0e30f;  // the Pallas kernel's mask value

typedef __nv_bfloat16 bf16;

// Load N contiguous bf16 values (aligned to N * 2 bytes) as f32.
template <int N>
__device__ __forceinline__ void load_row(const bf16* __restrict__ p,
                                         float (&o)[N]) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int c = 0; c < N / 8; ++c) {
      uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + c);
      const bf16* t = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int e = 0; e < 8; ++e) o[c * 8 + e] = __bfloat162float(t[e]);
    }
  } else if constexpr (N == 4) {
    uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const bf16* t = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = __bfloat162float(t[e]);
  } else if constexpr (N == 2) {
    unsigned int u = __ldg(reinterpret_cast<const unsigned int*>(p));
    const bf16* t = reinterpret_cast<const bf16*>(&u);
    o[0] = __bfloat162float(t[0]);
    o[1] = __bfloat162float(t[1]);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) o[e] = __bfloat162float(p[e]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// EPL = D / 32 values per lane; GB = compile-time bound on G (G <= GB).
template <int EPL, int GB>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const bf16* __restrict__ q,
                       const bf16* __restrict__ k_pool,
                       const bf16* __restrict__ v_pool,
                       const int* __restrict__ tables,
                       const int* __restrict__ pos, bf16* __restrict__ out,
                       int Hkv, int G, int page, int T, float scale) {
  constexpr int D = EPL * 32;
  const int b = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // live tokens 0..pos[b], clamped to what the table can address (an
  // inactive row may carry a stale position one past its last page)
  const int n_tok = min(pos[b] + 1, T * page);
  const int* table = tables + (size_t)b * T;
  const size_t tok_stride = (size_t)Hkv * D;

  float qv[GB][EPL];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (g < G) {
      load_row<EPL>(q + (((size_t)b * Hkv + h) * G + g) * D + lane * EPL,
                    qv[g]);
#pragma unroll
      for (int e = 0; e < EPL; ++e) qv[g][e] *= scale;
    }
  }

  float m[GB], l[GB], acc[GB][EPL];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  for (int base = warp * kUnroll; base < n_tok; base += kWarps * kUnroll) {
    float kr[kUnroll][EPL], vr[kUnroll][EPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u;
      if (t < n_tok) {
        const int phys = table[t / page];
        const size_t off = ((size_t)phys * page + t % page) * tok_stride
                           + (size_t)h * D + lane * EPL;
        load_row<EPL>(k_pool + off, kr[u]);
        load_row<EPL>(v_pool + off, vr[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u < n_tok) {  // warp-uniform
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          if (g < G) {
            float s = 0.f;
#pragma unroll
            for (int e = 0; e < EPL; ++e) s = fmaf(qv[g][e], kr[u][e], s);
            s = warp_sum(s);
            const float m_new = fmaxf(m[g], s);
            const float corr = expf(m[g] - m_new);
            const float p = expf(s - m_new);
            l[g] = l[g] * corr + p;
#pragma unroll
            for (int e = 0; e < EPL; ++e)
              acc[g][e] = fmaf(p, vr[u][e], acc[g][e] * corr);
            m[g] = m_new;
          }
        }
      }
    }
  }

  // merge the warps' partial softmax states, one query head at a time
  __shared__ float sm_m[kWarps][GB], sm_l[kWarps][GB];
  __shared__ float sm_acc[kWarps][D];
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (g < G) {  // block-uniform
      float m_tot = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) m_tot = fmaxf(m_tot, sm_m[w][g]);
      float l_tot = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        l_tot += sm_l[w][g] * expf(sm_m[w][g] - m_tot);
      const float w_self = expf(m[g] - m_tot);
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        sm_acc[warp][lane * EPL + e] = acc[g][e] * w_self;
      __syncthreads();
      bf16* o = out + (((size_t)b * Hkv + h) * G + g) * D;
      for (int d = threadIdx.x; d < D; d += kWarps * 32) {
        float a = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) a += sm_acc[w][d];
        o[d] = __float2bfloat16(a / fmaxf(l_tot, 1e-30f));
      }
      __syncthreads();
    }
  }
}

template <int EPL, int GB>
int launch(const void* q, const void* k, const void* v, const int* tables,
           const int* pos, void* out, int B, int Hkv, int G, int page, int T,
           float scale, cudaStream_t stream) {
  paged_attention_kernel<EPL, GB><<<dim3(B, Hkv), kWarps * 32, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), tables, pos, static_cast<bf16*>(out), Hkv,
      G, page, T, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int EPL>
int launch_g(const void* q, const void* k, const void* v, const int* tables,
             const int* pos, void* out, int B, int Hkv, int G, int page,
             int T, float scale, cudaStream_t stream) {
  if (G <= 1)
    return launch<EPL, 1>(q, k, v, tables, pos, out, B, Hkv, G, page, T,
                          scale, stream);
  if (G <= 2)
    return launch<EPL, 2>(q, k, v, tables, pos, out, B, Hkv, G, page, T,
                          scale, stream);
  if (G <= 4)
    return launch<EPL, 4>(q, k, v, tables, pos, out, B, Hkv, G, page, T,
                          scale, stream);
  if (G <= 8)
    return launch<EPL, 8>(q, k, v, tables, pos, out, B, Hkv, G, page, T,
                          scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B, Hkv*G, D), k/v pools (P, page, Hkv, D), tables (B, T) int32,
// pos (B,) int32, out (B, Hkv*G, D); all bf16 except the int32 arrays.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int paged_attention_bf16(const void* q, const void* k_pool,
                                    const void* v_pool, const void* tables,
                                    const void* pos, void* out, int B,
                                    int Hkv, int G, int D, int P, int page,
                                    int T, float scale, void* stream) {
  (void)P;
  const int* tb = static_cast<const int*>(tables);
  const int* ps = static_cast<const int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_g<1>(q, k_pool, v_pool, tb, ps, out, B, Hkv, G, page, T,
                         scale, s);
    case 64:
      return launch_g<2>(q, k_pool, v_pool, tb, ps, out, B, Hkv, G, page, T,
                         scale, s);
    case 128:
      return launch_g<4>(q, k_pool, v_pool, tb, ps, out, B, Hkv, G, page, T,
                         scale, s);
    case 256:
      return launch_g<8>(q, k_pool, v_pool, tb, ps, out, B, Hkv, G, page, T,
                         scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
