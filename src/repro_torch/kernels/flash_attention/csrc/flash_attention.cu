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
// least time is set by bytes at 3.35 TB/s (the ops would take less at the
// 989 TFLOP/s bf16 tensor-core rate) up to S of about 1200, and by
// operations past it.  This first version runs both products on the CUDA
// cores in f32 (no tensor cores yet), so in practice its ceiling is the
// f32 FMA rate (67 TFLOP/s) and the shared-memory reads that feed it; its
// design keeps those cores fed from shared memory:
//   * one CTA per 64-query tile of one (batch, head); the pre-scaled Q
//     tile sits in shared memory as f32 (row stride D + 8, which keeps the
//     64-bit reads of a half-warp on distinct banks);
//   * K and V stream through shared memory in 32-key tiles, each key tile
//     read from device memory once per CTA with 16-byte loads;
//   * four threads own one query row, each a quarter of the D dims (as
//     bf16 pairs); a row's scores are summed over the four with two
//     shuffles, and every thread of the row keeps the full 32 scores of
//     the tile in registers for its share of P·V;
//   * causal CTAs stop at their last query's diagonal tile.
// At D = 256 the CTA takes 100 KB of dynamic shared memory, above the
// 48 KB default, so the launch raises the limit with cudaFuncSetAttribute.
// wgmma, TMA and a tensor-core P·V are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 32;        // keys per shared-memory tile
constexpr int kThreads = 256;  // 4 threads per query row
constexpr float kNegInf = -1.0e30f;

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

template <int D>
constexpr int smem_bytes() {
  return kBQ * (D + 8) * 4 + 2 * kBK * D * 2;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       int Sq, int Skv, int H, int Hkv, int causal,
                       float scale) {
  constexpr int QS = D + 8;   // padded f32 row stride of the Q tile
  constexpr int NP = D / 8;   // dim pairs per thread: e*8 + part*2 + {0,1}
  constexpr int VEC = D / 8;  // 16-byte vectors per row
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  bf16* k_s = reinterpret_cast<bf16*>(q_s + kBQ * QS);
  bf16* v_s = k_s + kBK * D;

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, row = tid / 4, part = tid % 4;
  const int qi = q0 + row;

  for (int i = tid; i < kBQ * VEC; i += kThreads) {
    const int r = i / VEC, c = (i % VEC) * 8;
    float vals[8];
    if (q0 + r < Sq) {
      uint4 u = __ldg(reinterpret_cast<const uint4*>(
          q + (((size_t)b * Sq + q0 + r) * H + h) * D + c));
      const bf16* t = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int e = 0; e < 8; ++e) vals[e] = __bfloat162float(t[e]) * scale;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) vals[e] = 0.f;
    }
    float4* dst = reinterpret_cast<float4*>(q_s + r * QS + c);
    dst[0] = make_float4(vals[0], vals[1], vals[2], vals[3]);
    dst[1] = make_float4(vals[4], vals[5], vals[6], vals[7]);
  }

  const int kv_end = causal ? min(Skv, q0 + kBQ) : Skv;
  float m = kNegInf, l = 0.f;
  float acc[2 * NP];
#pragma unroll
  for (int e = 0; e < 2 * NP; ++e) acc[e] = 0.f;

  for (int j0 = 0; j0 < kv_end; j0 += kBK) {
    __syncthreads();  // Q tile written / previous K,V tile consumed
    for (int i = tid; i < kBK * VEC; i += kThreads) {
      const int r = i / VEC, c = (i % VEC) * 8;
      uint4 ku = make_uint4(0, 0, 0, 0), vu = make_uint4(0, 0, 0, 0);
      if (j0 + r < Skv) {
        const size_t off = (((size_t)b * Skv + j0 + r) * Hkv + hk) * D + c;
        ku = __ldg(reinterpret_cast<const uint4*>(k + off));
        vu = __ldg(reinterpret_cast<const uint4*>(v + off));
      }
      *reinterpret_cast<uint4*>(k_s + r * D + c) = ku;
      *reinterpret_cast<uint4*>(v_s + r * D + c) = vu;
    }
    __syncthreads();

    float s[kBK];
#pragma unroll
    for (int jj = 0; jj < kBK; ++jj) s[jj] = 0.f;
#pragma unroll
    for (int e = 0; e < NP; ++e) {
      const float2 qq =
          *reinterpret_cast<const float2*>(q_s + row * QS + e * 8 + part * 2);
#pragma unroll
      for (int jj = 0; jj < kBK; ++jj) {
        const float2 kk = __bfloat1622float2(
            *reinterpret_cast<const bf162*>(k_s + jj * D + e * 8 + part * 2));
        s[jj] = fmaf(qq.x, kk.x, s[jj]);
        s[jj] = fmaf(qq.y, kk.y, s[jj]);
      }
    }

    float m_tile = kNegInf;
#pragma unroll
    for (int jj = 0; jj < kBK; ++jj) {
      s[jj] += __shfl_xor_sync(0xffffffffu, s[jj], 1);
      s[jj] += __shfl_xor_sync(0xffffffffu, s[jj], 2);
      const int kj = j0 + jj;
      const bool ok = kj < Skv && (!causal || kj <= qi);
      s[jj] = ok ? s[jj] : kNegInf;
      m_tile = fmaxf(m_tile, s[jj]);
    }
    const float m_new = fmaxf(m, m_tile);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < kBK; ++jj) {
      const int kj = j0 + jj;
      const bool ok = kj < Skv && (!causal || kj <= qi);
      const float p = ok ? expf(s[jj] - m_new) : 0.f;
      psum += p;
      s[jj] = p;
    }
    l = l * corr + psum;
#pragma unroll
    for (int e = 0; e < NP; ++e) {
      float ax = acc[2 * e] * corr, ay = acc[2 * e + 1] * corr;
#pragma unroll
      for (int jj = 0; jj < kBK; ++jj) {
        const float2 vv = __bfloat1622float2(
            *reinterpret_cast<const bf162*>(v_s + jj * D + e * 8 + part * 2));
        ax = fmaf(s[jj], vv.x, ax);
        ay = fmaf(s[jj], vv.y, ay);
      }
      acc[2 * e] = ax;
      acc[2 * e + 1] = ay;
    }
    m = m_new;
  }

  if (qi < Sq) {
    const float denom = fmaxf(l, 1e-30f);
    bf16* o = out + (((size_t)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int e = 0; e < NP; ++e) {
      *reinterpret_cast<bf162*>(o + e * 8 + part * 2) =
          __floats2bfloat162_rn(acc[2 * e] / denom, acc[2 * e + 1] / denom);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int H, int Hkv, int causal, float scale,
           cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), Sq, Skv, H, Hkv,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Sq, H, D), k/v (B, Skv, Hkv, D), out (B, Sq, H, D), all bf16 and
// contiguous; H % Hkv == 0.  causal != 0 masks key j for query i when
// j > i.  Returns the cudaError_t of the launch (0 = launched).
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int B, int Sq,
                                    int Skv, int H, int Hkv, int D,
                                    int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(q, k, v, out, B, Sq, Skv, H, Hkv, causal, scale, s);
    case 64:
      return launch<64>(q, k, v, out, B, Sq, Skv, H, Hkv, causal, scale, s);
    case 128:
      return launch<128>(q, k, v, out, B, Sq, Skv, H, Hkv, causal, scale, s);
    case 256:
      return launch<256>(q, k, v, out, B, Sq, Skv, H, Hkv, causal, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
