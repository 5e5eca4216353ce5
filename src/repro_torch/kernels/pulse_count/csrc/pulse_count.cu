// Pulse-count kernel for Hopper (sm_90a): ReRAM writing activity of an
// install, over two flat uint8 code vectors (resident, incoming).
//
// Replaces the Pallas TPU kernel `pulse_count_pallas`
// (src/repro/kernels/pulse_count/kernel.py): per 32 KiB block, the total
// programming pulses Σ|Δ level| over the four 2-bit cells of every code
// and the count of unchanged (skippable) cells, as int32 block partials
// that the caller sums.
//
// Bound on an H100: bytes.  It reads two bytes per code and writes eight
// bytes per 32 KiB block.  The arithmetic stays far below the memory time
// by working on 16 cells at once in a 32-bit word (SWAR):
//   * unchanged cells: a 2-bit field of a ^ b is zero; one popc per word;
//   * |Δ level|: the even and odd cells are spread into 4-bit lanes, where
//     4 + a - b lies in [1, 7] and never borrows from the next lane; bit 2
//     says whether a >= b, which picks t - 4 or 4 - t per lane; the lanes
//     are folded into bytes and summed by one __dp4a.
// A block of 256 threads covers 32 KiB (the Pallas block): 8 steps of one
// 16-byte vector load per input per thread.  Bytes past n are not counted
// (the Pallas kernel pads with equal zeros and subtracts 4·pad skips; here
// nothing is padded).  Warp shuffles, then one shared-memory pass, reduce
// each block to its two partials.  Unaligned pointers, and the ragged last
// 16 bytes, take a byte-at-a-time path.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSteps = 8;
constexpr long long kBlockBytes = (long long)kThreads * 16 * kSteps;  // 32 KiB

// |a - b| of the 2-bit values in the low two bits of each 4-bit lane.
__device__ __forceinline__ uint32_t absdiff_lanes(uint32_t a, uint32_t b) {
  const uint32_t t = (a | 0x44444444u) - b;     // 4 + a - b per lane
  const uint32_t ge = ((t >> 2) & 0x11111111u) * 0xFu;
  const uint32_t up = t & 0x33333333u;          // t - 4 where a >= b
  const uint32_t down = (~t & 0x33333333u) + 0x11111111u;  // 4 - t
  return (up & ge) | (down & ~ge);
}

__device__ __forceinline__ void count_word(uint32_t a, uint32_t b,
                                           uint32_t& pulses,
                                           uint32_t& same) {
  const uint32_t x = a ^ b;
  same += 16u - __popc((x | (x >> 1)) & 0x55555555u);
  const uint32_t d = absdiff_lanes(a & 0x33333333u, b & 0x33333333u) +
                     absdiff_lanes((a >> 2) & 0x33333333u,
                                   (b >> 2) & 0x33333333u);
  const uint32_t bytes = (d & 0x0F0F0F0Fu) + ((d >> 4) & 0x0F0F0F0Fu);
  pulses = __dp4a(bytes, 0x01010101u, pulses);
}

__device__ __forceinline__ void count_byte(uint8_t a, uint8_t b,
                                           uint32_t& pulses,
                                           uint32_t& same) {
  for (int c = 0; c < 4; ++c) {
    const int d = (int)((a >> (2 * c)) & 3) - (int)((b >> (2 * c)) & 3);
    pulses += (uint32_t)(d < 0 ? -d : d);
    same += d == 0;
  }
}

__global__ void pulse_count_kernel(const uint8_t* old, const uint8_t* nw,
                                   long long n, int aligned,
                                   int* pulses_out, int* same_out) {
  uint32_t pulses = 0, same = 0;
  const long long base = (long long)blockIdx.x * kBlockBytes;
  for (int s = 0; s < kSteps; ++s) {
    const long long off = base + ((long long)s * kThreads + threadIdx.x) * 16;
    if (off >= n) break;
    if (aligned && off + 16 <= n) {
      const uint4 a = *reinterpret_cast<const uint4*>(old + off);
      const uint4 b = *reinterpret_cast<const uint4*>(nw + off);
      count_word(a.x, b.x, pulses, same);
      count_word(a.y, b.y, pulses, same);
      count_word(a.z, b.z, pulses, same);
      count_word(a.w, b.w, pulses, same);
    } else {
      const long long end = off + 16 < n ? off + 16 : n;
      for (long long i = off; i < end; ++i) {
        count_byte(old[i], nw[i], pulses, same);
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    pulses += __shfl_down_sync(0xffffffffu, pulses, o);
    same += __shfl_down_sync(0xffffffffu, same, o);
  }
  __shared__ uint32_t warp_p[kThreads / 32], warp_s[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    warp_p[warp] = pulses;
    warp_s[warp] = same;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t p = 0, q = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      p += warp_p[w];
      q += warp_s[w];
    }
    // at most 12 pulses and 4 cells per byte: < 2**19 per block
    pulses_out[blockIdx.x] = (int)p;
    same_out[blockIdx.x] = (int)q;
  }
}

}  // namespace

extern "C" long long pulse_count_blocks(long long n) {
  return (n + kBlockBytes - 1) / kBlockBytes;
}

extern "C" int pulse_count_u8(const void* old, const void* nw, long long n,
                              int aligned, void* pulses, void* same,
                              void* stream) {
  const long long blocks = pulse_count_blocks(n);
  if (blocks <= 0) return 0;
  pulse_count_kernel<<<(unsigned)blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(old), static_cast<const uint8_t*>(nw), n,
      aligned, static_cast<int*>(pulses), static_cast<int*>(same));
  return static_cast<int>(cudaGetLastError());
}
