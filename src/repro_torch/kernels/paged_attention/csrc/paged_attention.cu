// Paged-attention decode kernel for Hopper (sm_90a), bf16, split-row.
//
// Replaces the Pallas TPU kernel `paged_attention_pallas`
// (src/repro/kernels/paged_attention/kernel.py): one query token per batch
// row attends over that row's K/V, which live in a page pool
// (P, page, Hkv, D) and are addressed through a page table (B, T).  The
// G query heads of one KV head share every K/V byte (GQA stays native).
//
// Bound on an H100: bytes.  Each (row, KV head) reads (pos + 1) K rows and
// (pos + 1) V rows of D bf16 values once and does 4·G·D flops per token,
// G flops per byte, far below the ~295 flops/byte at which the bf16 tensor
// cores, not the 3.35 TB/s memory, would be the limit.  So the kernel has
// to keep enough K/V bytes in flight on every SM, whatever the rows'
// lengths.  What the design does about it:
//   * Split every row.  The grid is (split, KV head, row); split s covers
//     tokens [s·chunk, (s+1)·chunk) of its row, `chunk` a whole number of
//     pages (and of 32-token tiles where the page size allows).
//     `paged_attention_plan` plans the split count on the host from the
//     table width T and the grid's other axes, aiming at kCtasPerSm CTAs
//     per SM, and sizes the merge's scratch; never from `pos`, which lives
//     on the device.  A CTA loads its row's position, its chunk's first
//     page ids and its Q rows together, and returns as soon as the
//     position shows its chunk starts past pos[b].
//   * Keep many bytes in flight.  With its chunk's page ids in shared
//     memory (read once, kPageWindow at a time, so a table of any width
//     fits), a CTA streams its tokens in tiles of 32 through a 2- to
//     5-stage `cp.async` ring (16-byte copies, eight threads per token
//     row, the next tiles' copies issued before the current tile is
//     computed).  Rows past min(pos, T·page − 1) are zero-filled, never
//     read: stale pages and the scratch page 0 of an inactive row stay
//     untouched.
//   * One online-softmax update per tile.  The tile's scores for all G
//     heads land in shared memory; 16 threads per head take its max and
//     sum and fold them into (m, l) once, in the log2 domain.
//   * Tensor cores at every G.  S = Q·Kᵀ and P·V are `mma.sync` m16n8k16
//     bf16 with `ldmatrix` operands: the G query heads, zero-padded to 16,
//     are the 16 rows (Q's fragments stay in registers for the chunk), and
//     D is zero-padded to a multiple of 16 in shared memory.  Each K/V
//     byte is read from shared memory once per tile, whatever G; P enters
//     the product in bf16, the sums stay f32.  (A CUDA-core route for
//     G <= 8 was slower at G 1, 4 and 8 on the card, so it was dropped.)
//   * Merge the splits exactly once, in the same launch.  A row held by
//     one split writes its output directly.  Otherwise each split writes
//     its unnormalised (m, l, acc) in f32 to scratch the wrapper allocates,
//     takes a ticket with an atomic add, and the row's last split merges
//     all of them: out = Σ acc_s·2^(m_s − M) / max(Σ l_s·2^(m_s − M),
//     1e-30) in bf16, in split order, then sets the ticket back to 0.
// Semantics as the Pallas kernel's and this kernel's first form: masked
// scores −1e30, n_tok = min(pos + 1, T·page) (a stale position one past
// the table is clamped), output acc / max(l, 1e-30).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;          // tokens per pipeline stage
constexpr int kRows = 16;          // query-head rows: G <= 16, one m16 tile
constexpr int kMaxSplit = 32;      // splits of one row
constexpr int kCtasPerSm = 4;      // the grid the split plan aims at
constexpr int kPageWindow = 256;   // page ids a CTA holds in shared memory
constexpr int kSS = kTile + 4;     // f32 score row stride
constexpr int kPS = kTile + 8;     // bf16 probability row stride
constexpr int kRingBudget = 72 * 1024;  // three CTAs fit on one SM
constexpr int kMaxStages = 5;
constexpr float kNegInf = -1.0e30f;  // the Pallas kernel's mask value
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const int* tables;
  const int* pos;
  bf16* out;
  float* part;              // (B·Hkv, n_split, G, D) f32 split partials
  float* part_ml;           // (B·Hkv, n_split, 2, kRows) f32: m, then l
  unsigned int* counters;   // (B·Hkv) tickets, 0 between calls
  int Hkv, G, D, page, T, n_split, chunk_pages, stages;
  float scale_log2;
};

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// Shared-memory layout, computed alike on the host (size) and the device
// (offsets).  The split's f32 acc (G x D) reuses the ring once the last
// tile has been consumed.
struct Layout {
  int rs, ring, s, p, c, m, l, w, pages, total;
  __host__ __device__ Layout(int D, int stages) {
    rs = align16(D) + 8;  // bf16 row stride: 16 B of padding per row
    int o = 0;
    ring = o;  o += stages * 2 * kTile * rs * 2;
    s = o;     o += 2 * kRows * kSS * 4;
    p = o;     o += kRows * kPS * 2;
    c = o;     o += kRows * 4;
    m = o;     o += kRows * 4;
    l = o;     o += kRows * 4;
    w = o;     o += kMaxSplit * kRows * 4;
    pages = o; o += kPageWindow * 4;
    total = o;
  }
};

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

// Returns once at most `n` (0..kMaxStages - 2) of this thread's copy
// groups are pending.
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else if (n == 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 3;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// c += a (16x16, row) · b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Reductions over the 16 lanes that share one query-head row.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copy the K and V rows of tokens [t0, t0 + kTile) of KV head h into one
// ring stage; rows at or past t_end are zero-filled without a read.
// s_pages holds the page ids of the row's pages from `window` on.  Eight
// threads share a token row: its address is computed once, and each
// thread copies every eighth 16-byte piece of it.
__device__ __forceinline__ void issue_tile(const Params& p,
                                           const int* s_pages,
                                           int window, int h, int t0,
                                           int t_end, bf16* ks, bf16* vs,
                                           int rs) {
  static_assert(kThreads == 8 * kTile, "eight threads per token row");
  const int r = threadIdx.x / 8, t = t0 + r;
  const bf16* kp = p.k;
  const bf16* vp = p.v;
  int bytes = 0, step = 0;
  if (t < t_end) {
    const int phys = s_pages[t / p.page - window];
    const size_t off =
        ((size_t)phys * p.page + t % p.page) * p.Hkv * p.D + (size_t)h * p.D;
    kp += off;
    vp += off;
    bytes = 16;
    step = 8;
  }
  for (int c = threadIdx.x % 8; c < p.D / 8; c += 8) {
    cp_async16(ks + r * rs + c * 8, kp + c * step, bytes);
    cp_async16(vs + r * rs + c * 8, vp + c * step, bytes);
  }
}

// kNT: n-tiles of 8 output columns per warp in P·V (D <= 64·kNT).
template <int kNT>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int pos_b = p.pos[b];  // issued first, waited for last
  const int chunk = p.chunk_pages * p.page;
  const int c0 = split * chunk;
  const int D = p.D, G = p.G, S = p.stages;
  const Layout L(D, S);
  const int rs = L.rs, dp = align16(D);
  const int stage_elems = 2 * kTile * rs;
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);
  // Q passes through the ring's last stage, which no copy fills before
  // the first tile's barrier, on its way into registers
  bf16* qs = ring + (S - 1) * stage_elems;
  float* sf = reinterpret_cast<float*>(smem + L.s);
  bf16* ps = reinterpret_cast<bf16*>(smem + L.p);
  float* cs = reinterpret_cast<float*>(smem + L.c);
  float* ms = reinterpret_cast<float*>(smem + L.m);
  float* ls = reinterpret_cast<float*>(smem + L.l);
  float* wt = reinterpret_cast<float*>(smem + L.w);
  int* s_pages = reinterpret_cast<int*>(smem + L.pages);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;

  // the G query rows (zero-padded to 16 rows of dp columns) and the
  // chunk's first kPageWindow page ids are loaded while the row's
  // position is on its way: the three loads are in flight together
  static_assert(kRows * 256 / 8 <= 2 * kThreads, "two Q pieces a thread");
  const bf16* qrow = p.q + (size_t)(b * p.Hkv + h) * G * D;
  uint4 qpiece[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = tid + j * kThreads, r = i / (dp / 8), c = i % (dp / 8);
    qpiece[j] = make_uint4(0, 0, 0, 0);
    if (r < G && c < D / 8)
      qpiece[j] = __ldg(reinterpret_cast<const uint4*>(qrow + r * D + c * 8));
  }
  const int first_page = c0 / p.page;
  const int n_pages = min(p.chunk_pages, p.T - first_page);
  const int* row_pages = p.tables + (size_t)b * p.T;
  int window = first_page;  // s_pages[i] is the id of page window + i
  for (int i = tid; i < min(n_pages, kPageWindow); i += kThreads)
    s_pages[i] = row_pages[first_page + i];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = tid + j * kThreads, r = i / (dp / 8), c = i % (dp / 8);
    if (r < kRows)
      *reinterpret_cast<uint4*>(qs + r * rs + c * 8) = qpiece[j];
  }
  const int n_tok = min(pos_b + 1, p.T * p.page);
  if (c0 >= n_tok) return;  // nothing of this row in the chunk
  const int n_active = (n_tok + chunk - 1) / chunk;
  const int t_end = min(c0 + chunk, n_tok);
  // zero the ring's padding columns [D, dp), which no copy writes
  if (dp != D)
    for (int i = tid; i < S * 2 * kTile; i += kThreads)
      *reinterpret_cast<uint4*>(ring + i * rs + D) = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const int n_tiles = (t_end - c0 + kTile - 1) / kTile;
  // the first S - 1 tiles span at most 4·kTile pages: all in the window
  static_assert((kMaxStages - 1) * kTile <= kPageWindow, "window");
  for (int s = 0; s < S - 1; ++s) {
    if (s < n_tiles)
      issue_tile(p, s_pages, window, h, c0 + s * kTile, t_end,
                 ring + s * stage_elems, ring + s * stage_elems + kTile * rs,
                 rs);
    cp_async_commit();
  }

  // Q·Kᵀ: warp w takes n-tile (w & 3) of the tile's 4 x 8 tokens and the
  // k steps kk = kp, kp + 2, ... (kp = w >> 2) of the dp / 16; its A
  // fragments of Q stay in registers for the whole chunk
  constexpr int kKSteps = 2 * kNT;  // >= dp / 16 / 2, rounded up
  const int nt_s = warp & 3, kp = warp >> 2;
  uint32_t qa[kKSteps][4];
#pragma unroll
  for (int j = 0; j < kKSteps; ++j) {
    const int kk = kp + 2 * j;
    if (kk < dp / 16)
      ldmatrix_x4(qa[j], qs + (lane & 15) * rs + kk * 16 + (lane >> 4) * 8);
  }
  // online state of row `row`, held alike by its 16 threads
  const int row = tid / 16, sub = tid % 16;
  float m_run = kNegInf, l_run = 0.f;
  // P·V: warp w owns output n-tiles w, w + 8, ... (< D / 8)
  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait(S - 2);  // this thread's copies of tile i have landed
    __syncthreads();       // everyone's have, and tile i - 1 is consumed
    {
      const int nx = i + S - 1;
      if (nx < n_tiles) {
        // slide the window to tile nx's first page when its last page is
        // past it; every earlier tile's copies have been issued (the
        // barrier above), so no thread still reads the old ids
        const int t_lo = c0 + nx * kTile;
        const int t_hi = min(t_lo + kTile, t_end) - 1;
        if (t_hi / p.page >= window + kPageWindow) {  // block-uniform
          window = t_lo / p.page;
          const int n = min(kPageWindow, first_page + n_pages - window);
          for (int j = tid; j < n; j += kThreads)
            s_pages[j] = row_pages[window + j];
          __syncthreads();
        }
        bf16* st = ring + (nx % S) * stage_elems;
        issue_tile(p, s_pages, window, h, t_lo, t_end, st, st + kTile * rs,
                   rs);
      }
      cp_async_commit();
    }
    const bf16* kt = ring + (i % S) * stage_elems;
    const bf16* vt = kt + kTile * rs;
    const int t0 = c0 + i * kTile;

    // 1. scores S = Q·Kᵀ of the tile, unscaled f32, as two partial sums
    {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kKSteps; ++j) {
        const int kk = kp + 2 * j;
        if (kk < dp / 16) {  // warp-uniform
          uint32_t bb[2];
          ldmatrix_x2(bb, kt + (nt_s * 8 + (lane & 7)) * rs + kk * 16 +
                              ((lane >> 3) & 1) * 8);
          mma_bf16(c, qa[j], bb);
        }
      }
      float* sp = sf + kp * kRows * kSS;
      const int col = nt_s * 8 + tig * 2;
      sp[gid * kSS + col] = c[0];
      sp[gid * kSS + col + 1] = c[1];
      sp[(gid + 8) * kSS + col] = c[2];
      sp[(gid + 8) * kSS + col + 1] = c[3];
    }
    __syncthreads();

    // 2. one online-softmax update per tile (rows past G are computed on
    //    zeros and dropped, so the row shuffles never diverge)
    {
      constexpr int kPer = kTile / 16;
      float sv[kPer];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int col = sub + 16 * j;
        float s = 0.f;
        if (row < G) {
          s = sf[row * kSS + col] + sf[(kRows + row) * kSS + col];
          s = (t0 + col < t_end) ? s * p.scale_log2 : kNegInf;
        }
        sv[j] = s;
        mx = fmaxf(mx, s);
      }
      const float m_new = fmaxf(m_run, row_max(mx));
      const float corr = exp2f(m_run - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float pr = row < G ? exp2f(sv[j] - m_new) : 0.f;
        sum += pr;
        ps[row * kPS + sub + 16 * j] = __float2bfloat16(pr);
      }
      l_run = l_run * corr + row_sum(sum);
      m_run = m_new;
      if (sub == 0) cs[row] = corr;
    }
    __syncthreads();

    // 3. acc = acc·corr + P·V
    const float c_lo = cs[gid], c_hi = cs[gid + 8];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      acc[j][0] *= c_lo;
      acc[j][1] *= c_lo;
      acc[j][2] *= c_hi;
      acc[j][3] *= c_hi;
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, ps + (lane & 15) * kPS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int nt = warp + kWarps * j;
        if (nt < D / 8) {  // warp-uniform
          uint32_t bb[2];
          ldmatrix_x2_trans(bb, vt + (kk * 16 + (lane & 15)) * rs + nt * 8);
          mma_bf16(acc[j], a, bb);
        }
      }
    }
  }
  cp_async_wait(0);
  __syncthreads();  // the ring is free: it takes this split's acc

  // this split's unnormalised acc (G x D f32) and its (m, l) per head
  float* op = reinterpret_cast<float*>(smem + L.ring);
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int nt = warp + kWarps * j;
    if (nt < D / 8) {
      const int col = nt * 8 + tig * 2;
      if (gid < G) {
        op[gid * D + col] = acc[j][0];
        op[gid * D + col + 1] = acc[j][1];
      }
      if (gid + 8 < G) {
        op[(gid + 8) * D + col] = acc[j][2];
        op[(gid + 8) * D + col + 1] = acc[j][3];
      }
    }
  }
  if (sub == 0 && row < G) {
    ms[row] = m_run;
    ls[row] = l_run;
  }
  __syncthreads();
  const int bh = b * p.Hkv + h;
  bf16* orow = p.out + (size_t)bh * G * D;
  if (n_active == 1) {  // the whole row in one chunk: no merge
    for (int i = tid; i < G * D; i += kThreads)
      orow[i] = __float2bfloat16(op[i] / fmaxf(ls[i / D], 1e-30f));
    return;
  }

  // hand this split's state over through device memory; the last of the
  // row's active splits to arrive merges them all
  float* part = p.part + ((size_t)bh * p.n_split + split) * G * D;
  float* part_ml = p.part_ml + ((size_t)bh * p.n_split + split) * 2 * kRows;
  for (int i = tid; i < G * D; i += kThreads) __stcg(part + i, op[i]);
  if (tid < G) {
    __stcg(part_ml + tid, ms[tid]);
    __stcg(part_ml + kRows + tid, ls[tid]);
  }
  __threadfence();  // this split's state is visible before its ticket
  __syncthreads();
  __shared__ int last;
  if (tid == 0)
    last = atomicAdd(p.counters + bh, 1u) == (unsigned)(n_active - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();  // every split's state is visible to this CTA
  const float* base_ml = p.part_ml + (size_t)bh * p.n_split * 2 * kRows;
  if (tid < G) {
    float mx = kNegInf;
    for (int r = 0; r < n_active; ++r)
      mx = fmaxf(mx, __ldcg(base_ml + r * 2 * kRows + tid));
    float lsum = 0.f;
    for (int r = 0; r < n_active; ++r)
      lsum += __ldcg(base_ml + r * 2 * kRows + kRows + tid) *
              exp2f(__ldcg(base_ml + r * 2 * kRows + tid) - mx);
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    for (int r = 0; r < n_active; ++r)
      wt[r * kRows + tid] =
          exp2f(__ldcg(base_ml + r * 2 * kRows + tid) - mx) * inv;
  }
  __syncthreads();
  const float* base = p.part + (size_t)bh * p.n_split * G * D;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    float o = 0.f;
    for (int r = 0; r < n_active; ++r)
      o = fmaf(__ldcg(base + (size_t)r * G * D + i), wt[r * kRows + g], o);
    orow[i] = __float2bfloat16(o);
  }
  if (tid == 0) p.counters[bh] = 0;  // ready for the next call
}

template <int kNT>
int launch(const Params& p, int B, cudaStream_t stream) {
  const Layout L(p.D, p.stages);
  auto kern = paged_attention_kernel<kNT>;
  static int smem_set = 0;  // per instance: the dynamic size allowed so far
  if (L.total > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = L.total;
  }
  kern<<<dim3(p.n_split, p.Hkv, B), kThreads, L.total, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The split of a call's rows over the grid, from the host's shapes only:
// a table of T pages of `page` tokens, `rows` (row, KV head) pairs of G
// query heads of D, on a card of n_sms SMs.  The largest power of two of
// splits that keeps the grid within kCtasPerSm·n_sms CTAs (at least 1, at
// most kMaxSplit), so that a table of a power-of-two width splits into
// equal chunks; each chunk a whole number of pages and, where the page
// size allows, of kTile-token tiles (a ragged last tile costs a whole
// one).  Writes plan[0..4]: splits, pages per split, and the f32 elements
// of part and of part_ml and the uint32 tickets that paged_attention_bf16
// then needs (all 0 for one split).  Returns a cudaError_t.
extern "C" int paged_attention_plan(int T, int page, int rows, int G, int D,
                                    int n_sms, long long* plan) {
  if (T < 1 || page < 1 || rows < 1 || G < 1 || D < 1 || n_sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int n = 1;
  while (2 * n <= kMaxSplit && 2 * n <= kCtasPerSm * n_sms / rows) n *= 2;
  int chunk = (T + n - 1) / n;
  if (kTile % page == 0) {
    const int step = kTile / page;
    chunk = (chunk + step - 1) / step * step;
  }
  if (chunk > T) chunk = T;
  n = (T + chunk - 1) / chunk;
  plan[0] = n;
  plan[1] = chunk;
  plan[2] = n > 1 ? (long long)rows * n * G * D : 0;
  plan[3] = n > 1 ? (long long)rows * n * 2 * kRows : 0;
  plan[4] = n > 1 ? rows : 0;
  return 0;
}

// q (B, Hkv*G, D), k/v pools (P, page, Hkv, D), tables (B, T) int32,
// pos (B,) int32, out (B, Hkv*G, D); all bf16 except the int32 arrays.
// D a multiple of 8 in [8, 256], G in [1, 16]; the row splits into n_split
// chunks of chunk_pages pages (n_split <= 32, n_split·chunk_pages >= T),
// as paged_attention_plan plans it.  With n_split > 1: the part and
// part_ml f32 scratch and the counters (uint32 tickets) of the plan's
// sizes, the counters zero on entry and left zero.  Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int paged_attention_bf16(const void* q, const void* k_pool,
                                    const void* v_pool, const void* tables,
                                    const void* pos, void* out, void* part,
                                    void* part_ml, void* counters, int B,
                                    int Hkv, int G, int D, int page, int T,
                                    int n_split, int chunk_pages,
                                    float scale, void* stream) {
  if (D % 8 != 0 || D < 8 || D > 256 || G < 1 || G > kRows || B < 1 ||
      Hkv < 1 || page < 1 || T < 1 || n_split < 1 || n_split > kMaxSplit ||
      chunk_pages < 1 || (long long)n_split * chunk_pages < T ||
      (n_split > 1 && (!part || !part_ml || !counters)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k_pool);
  p.v = static_cast<const bf16*>(v_pool);
  p.tables = static_cast<const int*>(tables);
  p.pos = static_cast<const int*>(pos);
  p.out = static_cast<bf16*>(out);
  p.part = static_cast<float*>(part);
  p.part_ml = static_cast<float*>(part_ml);
  p.counters = static_cast<unsigned int*>(counters);
  p.Hkv = Hkv;
  p.G = G;
  p.D = D;
  p.page = page;
  p.T = T;
  p.n_split = n_split;
  p.chunk_pages = chunk_pages;
  // as many stages as fit the ring's budget, 2 to kMaxStages
  const int stages = kRingBudget / (2 * kTile * (align16(D) + 8) * 2);
  p.stages = stages < 2 ? 2 : (stages > kMaxStages ? kMaxStages : stages);
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return launch<1>(p, B, s);
  if (D <= 128) return launch<2>(p, B, s);
  return launch<4>(p, B, s);
}
