// Delta-apply kernel for Hopper (sm_90a): out = (old + delta) mod 256 over
// a flat uint8 code vector.
//
// Replaces the Pallas TPU kernel `delta_apply_pallas`
// (src/repro/kernels/delta_apply/kernel.py): the device half of a §V-C
// weight install, which adds the streamed delta to the codes a slot holds.
//
// Bound on an H100: bytes.  Per byte it reads two and writes one and does
// one add, so the kernel only has to keep enough bytes in flight to stream
// 3 bytes per code at the card's memory rate.  What the design does:
//   * each thread loads kUnroll = 4 16-byte vectors of both inputs before
//     it stores any of them, so a thread has eight loads in flight rather
//     than the two of a loop whose store may alias its next loads.  A
//     thread writes only the bytes it read, so `out` may be `old` or
//     `delta` itself (an install turns the delta it received into the new
//     codes in place); the vectors of one unroll step are 256 threads
//     apart, so every warp access is one coalesced 512-byte run;
//   * the streaming hint on every access (`ld.global.cs` /
//     `st.global.cs`, evict first): the 830 MB stream of a layer passes
//     through the 50 MB L2 once and does not push anything else out;
//   * a grid sized to the work, one block per 4 x 256 vectors, no cap;
//   * the four 32-bit words of a vector add bytewise (SWAR, carries kept
//     out of the neighbouring byte); the n % 16 tail bytes go one per
//     thread of block 0.
// The pointers must be 16-byte aligned (the wrapper checks).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kBlockVecs = kThreads * kUnroll;

// Bytewise (a + b) mod 256 of four packed bytes.
__device__ __forceinline__ uint32_t add_bytes(uint32_t a, uint32_t b) {
  return ((a & 0x7f7f7f7fu) + (b & 0x7f7f7f7fu)) ^ ((a ^ b) & 0x80808080u);
}

__global__ void __launch_bounds__(kThreads)
delta_apply_vec(const uint4* old, const uint4* delta, uint4* out,
                long long n_vec, const uint8_t* old_b,
                const uint8_t* delta_b, uint8_t* out_b, long long n) {
  const long long base = (long long)blockIdx.x * kBlockVecs + threadIdx.x;
  uint4 a[kUnroll], d[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = base + u * kThreads;
    if (i < n_vec) {
      a[u] = __ldcs(old + i);
      d[u] = __ldcs(delta + i);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = base + u * kThreads;
    if (i < n_vec)
      __stcs(out + i,
             make_uint4(add_bytes(a[u].x, d[u].x), add_bytes(a[u].y, d[u].y),
                        add_bytes(a[u].z, d[u].z), add_bytes(a[u].w, d[u].w)));
  }
  const long long t = n_vec * 16 + threadIdx.x;
  if (blockIdx.x == 0 && t < n) {
    out_b[t] = (uint8_t)(old_b[t] + delta_b[t]);
  }
}

}  // namespace

extern "C" int delta_apply_u8(const void* old, const void* delta, void* out,
                              long long n, void* stream) {
  if (n <= 0) return 0;
  const long long n_vec = n / 16;  // whole 16-byte vectors; n % 16 left
  long long blocks = (n_vec + kBlockVecs - 1) / kBlockVecs;
  if (blocks < 1) blocks = 1;  // the tail alone still needs block 0
  const uint8_t* o = static_cast<const uint8_t*>(old);
  const uint8_t* d = static_cast<const uint8_t*>(delta);
  uint8_t* r = static_cast<uint8_t*>(out);
  delta_apply_vec<<<(unsigned)blocks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint4*>(o), reinterpret_cast<const uint4*>(d),
      reinterpret_cast<uint4*>(r), n_vec, o, d, r, n);
  return static_cast<int>(cudaGetLastError());
}
