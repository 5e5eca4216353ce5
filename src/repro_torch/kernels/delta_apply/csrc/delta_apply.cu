// Delta-apply kernel for Hopper (sm_90a): out = (old + delta) mod 256 over
// a flat uint8 code vector.
//
// Replaces the Pallas TPU kernel `delta_apply_pallas`
// (src/repro/kernels/delta_apply/kernel.py): the device half of a §V-C
// weight install, which adds the streamed delta to the codes a slot holds.
//
// Bound on an H100: bytes.  Per byte it reads two and writes one and does
// one add, so the kernel only has to stream 3 bytes per code at the card's
// memory rate.  Each thread moves 16 bytes per step with one vector load
// per input and one vector store (the four 32-bit words add bytewise,
// carries kept out of the neighbouring byte), in a grid-stride loop over
// the vector part; the n % 16 tail bytes go one per thread of block 0.
// The pointers must be 16-byte aligned (the wrapper checks).  `out` may be
// `old` or `delta`: the update is elementwise, so an install turns the
// delta it received into the new codes in place.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Bytewise (a + b) mod 256 of four packed bytes.
__device__ __forceinline__ uint32_t add_bytes(uint32_t a, uint32_t b) {
  return ((a & 0x7f7f7f7fu) + (b & 0x7f7f7f7fu)) ^ ((a ^ b) & 0x80808080u);
}

__global__ void delta_apply_vec(const uint4* old,
                                const uint4* delta,
                                uint4* out, long long n_vec,
                                const uint8_t* old_b, const uint8_t* delta_b,
                                uint8_t* out_b, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_vec; i += stride) {
    const uint4 a = old[i];
    const uint4 d = delta[i];
    uint4 r;
    r.x = add_bytes(a.x, d.x);
    r.y = add_bytes(a.y, d.y);
    r.z = add_bytes(a.z, d.z);
    r.w = add_bytes(a.w, d.w);
    out[i] = r;
  }
  const long long t = n_vec * 16 + threadIdx.x;
  if (blockIdx.x == 0 && t < n) {
    out_b[t] = (uint8_t)(old_b[t] + delta_b[t]);
  }
}

}  // namespace

extern "C" int delta_apply_u8(const void* old, const void* delta, void* out,
                              long long n, int n_sms, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const long long n_vec = n / 16;
  long long blocks = (n_vec + threads - 1) / threads;
  if (blocks > (long long)n_sms * 8) blocks = (long long)n_sms * 8;
  if (blocks < 1) blocks = 1;
  const uint8_t* o = static_cast<const uint8_t*>(old);
  const uint8_t* d = static_cast<const uint8_t*>(delta);
  uint8_t* r = static_cast<uint8_t*>(out);
  delta_apply_vec<<<(unsigned)blocks, threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint4*>(o), reinterpret_cast<const uint4*>(d),
      reinterpret_cast<uint4*>(r), n_vec, o, d, r, n);
  return static_cast<int>(cudaGetLastError());
}
