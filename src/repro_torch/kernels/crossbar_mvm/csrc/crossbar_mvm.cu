// Crossbar dot-product kernel for Hopper (sm_90a): uint8 (M, K) x uint8
// (K, N) codes with int32 accumulation and the Eq. 7 zero-point correction
//   y = (acc - zp_w·Σx - zp_x·Σw + K·zp_x·zp_w) · scale      (f32 out)
//
// Replaces the Pallas TPU kernel `crossbar_mvm_pallas`
// (src/repro/kernels/crossbar_mvm/kernel.py), whose 128x128 output tiles
// took the full K per grid step into VMEM.
//
// Bound on an H100: operations at large M (2·M·N·K int8 operations against
// the data sheet's 1,979 TOP/s on the tensor cores), bytes at small M.  This first version
// runs on the CUDA cores, not the tensor cores: a 64x64 output tile per
// block of 256 threads, each thread 4x4 outputs; K is walked in 32-byte
// steps staged in shared memory (the weight tile transposed so that four
// consecutive k of one column form one 32-bit word), and every 4 products
// are one __dp4a on packed unsigned bytes.  Σx per row and Σw per column
// come from the same words, by __dp4a against 0x01010101.  Out-of-range
// rows, columns and k are staged as zeros.  The epilogue evaluates Eq. 7
// in the reference's order with round-to-nearest intrinsics (no fused
// multiply-add), so it matches the plain f32 version bit for bit.
// 255²·K stays below 2**31 up to K = 33,025, which the wrapper enforces.
// A tensor-core (wgmma) version needs signed int8: the -128 shift of both
// operands is then folded into the corrections.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;     // output rows and columns per block
constexpr int kStep = 32;     // k per shared-memory stage
constexpr int kPitch = kStep + 4;  // bytes per staged row: 9 words, no conflicts

__global__ void crossbar_mvm_kernel(const uint8_t* __restrict__ x,
                                    const uint8_t* __restrict__ w,
                                    float* __restrict__ out, int M, int K,
                                    int N, float zpx, float zpw,
                                    float scale) {
  __shared__ __align__(16) uint8_t xs[kTile * kPitch];  // [row][k]
  __shared__ __align__(16) uint8_t ws[kTile * kPitch];  // [col][k]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  uint32_t acc[4][4] = {};
  uint32_t sx[4] = {}, sw[4] = {};
  for (int k0 = 0; k0 < K; k0 += kStep) {
    for (int e = threadIdx.x; e < kTile * kStep; e += blockDim.x) {
      const int r = e / kStep, c = e % kStep;
      const int m = m0 + r, k = k0 + c;
      xs[r * kPitch + c] = (m < M && k < K) ? x[(long long)m * K + k] : 0;
    }
    for (int e = threadIdx.x; e < kTile * kStep; e += blockDim.x) {
      const int kk = e / kTile, c = e % kTile;
      const int k = k0 + kk, n = n0 + c;
      ws[c * kPitch + kk] = (k < K && n < N) ? w[(long long)k * N + n] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kStep / 4; ++q) {
      uint32_t a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = *reinterpret_cast<const uint32_t*>(
            &xs[(ty + 16 * i) * kPitch + 4 * q]);
        b[i] = *reinterpret_cast<const uint32_t*>(
            &ws[(tx + 16 * i) * kPitch + 4 * q]);
        sx[i] = __dp4a(a[i], 0x01010101u, sx[i]);
        sw[i] = __dp4a(b[i], 0x01010101u, sw[i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  const float kzz = __fmul_rn(__fmul_rn((float)K, zpx), zpw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const float sxf = __int2float_rn((int)sx[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      float y = __fsub_rn(__int2float_rn((int)acc[i][j]), __fmul_rn(zpw, sxf));
      y = __fsub_rn(y, __fmul_rn(zpx, __int2float_rn((int)sw[j])));
      y = __fadd_rn(y, kzz);
      out[(long long)m * N + n] = __fmul_rn(y, scale);
    }
  }
}

}  // namespace

extern "C" int crossbar_mvm_u8(const void* x, const void* w, void* out,
                               int M, int K, int N, float zpx, float zpw,
                               float scale, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  crossbar_mvm_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(w),
      static_cast<float*>(out), M, K, N, zpx, zpw, scale);
  return static_cast<int>(cudaGetLastError());
}
