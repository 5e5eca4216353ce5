// Paged-attention decode kernel for Hopper (sm_90a), f32, split-row, on the
// CUDA cores.
//
// The f32 half of the port of the Pallas TPU kernel `paged_attention_pallas`
// (src/repro/kernels/paged_attention/kernel.py), which takes bf16 and f32
// alike; `paged_attention.cu` is the bf16 half.  Same function: one query
// token per batch row attends over that row's K/V, which live in a page
// pool (P, page, Hkv, D) addressed through a page table (B, T); query head
// h reads KV head h / G.
//
// Bound on an H100 (SXM data sheet, 700 W): bytes.  Each (row, KV head)
// reads (pos + 1) K rows and (pos + 1) V rows of D f32 values once and
// does 4·G·D flops per token, G/2 flops per byte: at most 8 at G 16, under
// the ~20 flops per byte at which the 67 TFLOP/s f32 rate, not the
// 3.35 TB/s memory, would be the limit.  So every product stays a full
// f32 FMA on the CUDA cores (no TF32, no tensor core), and the design is
// the bf16 kernel's, which keeps enough bytes in flight on every SM:
//   * Split every row.  The grid is (split, KV head, row); split s covers
//     tokens [s·chunk, (s+1)·chunk) of its row.  `paged_attention_f32_plan`
//     plans the split count on the host from the table width and the
//     grid's other axes (its own tile and CTAs-per-SM target; the bf16
//     plan is the bf16 library's); a CTA returns as soon as its row's
//     position shows its chunk starts past pos[b].
//   * Keep many bytes in flight.  The chunk's page ids sit in shared
//     memory, kPageWindow at a time, the window sliding along a table of
//     any width; K/V tokens stream through a 2- to 5-stage `cp.async` ring
//     of kTile-token tiles (16-byte copies, the next tiles' copies issued
//     before the current tile is computed).  Rows past min(pos, T·page − 1)
//     are zero-filled, never read: stale pages and the scratch page 0 of
//     an inactive row stay untouched.
//   * Each K/V byte read from shared memory once per tile for all G query
//     heads.  Scores: a thread takes one token and one slice of D, reads
//     each 16-byte piece of its K row once and multiplies it into all G
//     query rows (broadcast reads); the slices' partial sums meet in
//     shared memory.  P·V: a thread owns 4 output columns of all G heads
//     for a group of the tile's tokens, reads each V piece once, and the
//     groups' sums meet in shared memory after the chunk.
//   * One online-softmax update per tile: 16 threads per head take its
//     max and sum and fold them into (m, l) once, in the log2 domain.
//   * Merge the splits exactly once, in the same launch, as the bf16
//     kernel does: one split writes its row directly; otherwise each writes
//     its unnormalised (m, l, acc) to scratch, takes an atomic ticket, and
//     the row's last split merges all of them in split order and sets the
//     ticket back to 0.
// Semantics as the plain version's: masked scores −1e30, n_tok =
// min(pos + 1, T·page), output acc / max(l, 1e-30).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;          // tokens per pipeline stage
constexpr int kRows = 16;          // query heads per KV head: G <= 16
constexpr int kSlices = kThreads / kTile;  // D slices of the score phase
constexpr int kMaxSplit = 32;      // splits of one row
constexpr int kCtasPerSm = 2;      // the grid the split plan aims at
constexpr int kPageWindow = 256;   // page ids a CTA holds in shared memory
constexpr int kRingBudget = 68 * 1024;
constexpr int kMaxStages = 5;
constexpr float kNegInf = -1.0e30f;  // the Pallas kernel's mask value
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const int* tables;
  const int* pos;
  float* out;
  float* part;              // (B·Hkv, n_split, G, D) split partials
  float* part_ml;           // (B·Hkv, n_split, 2, kRows): m, then l
  unsigned int* counters;   // (B·Hkv) tickets, 0 between calls
  int Hkv, G, D, page, T, n_split, chunk_pages, stages;
  float scale_log2;
};

// Token groups of the P·V phase: D / 4 threads (4 columns each) per group,
// a power of two of groups, at most one token each.
__host__ __device__ constexpr int token_groups(int D) {
  int n = kThreads / (D / 4);
  if (n > kTile) n = kTile;
  int g = 1;
  while (2 * g <= n) g *= 2;
  return g;
}

// Shared-memory layout, computed alike on the host (size) and the device
// (offsets).  After the last tile the ring holds the token groups' P·V
// sums (token_groups x G x D).
struct Layout {
  int rs, ring, q, s, p, c, m, l, w, pages, total;
  __host__ __device__ Layout(int D, int G, int stages) {
    rs = D + 4;  // f32 row stride: 16 B of padding per row
    int o = 0;
    const int ring_bytes = stages * 2 * kTile * rs * 4;
    const int sum_bytes = token_groups(D) * G * D * 4;
    ring = o;  o += ring_bytes > sum_bytes ? ring_bytes : sum_bytes;
    q = o;     o += kRows * D * 4;
    s = o;     o += kSlices * kRows * kTile * 4;
    p = o;     o += kRows * kTile * 4;
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

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& x) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

// Copy the K and V rows of tokens [t0, t0 + kTile) of KV head h into one
// ring stage; rows at or past t_end are zero-filled without a read.
// s_pages holds the page ids of the row's pages from `window` on.
// kThreads / kTile threads share a token row: its address is computed
// once, and each thread copies every such 16-byte piece of it.
__device__ __forceinline__ void issue_tile(const Params& p,
                                           const int* s_pages, int window,
                                           int h, int t0, int t_end,
                                           float* ks, float* vs, int rs) {
  constexpr int kPer = kThreads / kTile;
  const int r = threadIdx.x / kPer, t = t0 + r;
  const float* kp = p.k;
  const float* vp = p.v;
  int bytes = 0, step = 0;
  if (t < t_end) {
    const int phys = s_pages[t / p.page - window];
    const size_t off =
        ((size_t)phys * p.page + t % p.page) * p.Hkv * p.D + (size_t)h * p.D;
    kp += off;
    vp += off;
    bytes = 16;
    step = 4;
  }
  for (int c = threadIdx.x % kPer; c < p.D / 4; c += kPer) {
    cp_async16(ks + r * rs + c * 4, kp + c * step, bytes);
    cp_async16(vs + r * rs + c * 4, vp + c * step, bytes);
  }
}

// kG: query heads computed per KV head, G rounded up to a power of two
// (rows past G are zero queries whose outputs are dropped).
template <int kG>
__global__ void __launch_bounds__(kThreads)
paged_attention_f32_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int pos_b = p.pos[b];  // issued first, waited for last
  const int chunk = p.chunk_pages * p.page;
  const int c0 = split * chunk;
  const int D = p.D, G = p.G, S = p.stages;
  const Layout L(D, G, S);
  const int rs = L.rs;
  const int stage_elems = 2 * kTile * rs;
  float* ring = reinterpret_cast<float*>(smem + L.ring);
  float* qs = reinterpret_cast<float*>(smem + L.q);  // kG x D
  float* sp = reinterpret_cast<float*>(smem + L.s);  // kSlices x kRows x kTile
  float* ps = reinterpret_cast<float*>(smem + L.p);  // kRows x kTile
  float* cs = reinterpret_cast<float*>(smem + L.c);
  float* ms = reinterpret_cast<float*>(smem + L.m);
  float* ls = reinterpret_cast<float*>(smem + L.l);
  float* wt = reinterpret_cast<float*>(smem + L.w);
  int* s_pages = reinterpret_cast<int*>(smem + L.pages);
  const int tid = threadIdx.x;

  // the G query rows (zero rows up to kG) and the chunk's first
  // kPageWindow page ids are loaded while the row's position is on its
  // way: the three loads are in flight together
  constexpr int kQPieces = (kG * 256 / 4 + kThreads - 1) / kThreads;
  const float4* qrow =
      reinterpret_cast<const float4*>(p.q + (size_t)(b * p.Hkv + h) * G * D);
  float4 qpiece[kQPieces];
#pragma unroll
  for (int j = 0; j < kQPieces; ++j) {
    const int i = tid + j * kThreads;
    qpiece[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < G * D / 4) qpiece[j] = __ldg(qrow + i);
  }
  const int first_page = c0 / p.page;
  const int n_pages = min(p.chunk_pages, p.T - first_page);
  const int* row_pages = p.tables + (size_t)b * p.T;
  int window = first_page;  // s_pages[i] is the id of page window + i
  for (int i = tid; i < min(n_pages, kPageWindow); i += kThreads)
    s_pages[i] = row_pages[first_page + i];
#pragma unroll
  for (int j = 0; j < kQPieces; ++j) {
    const int i = tid + j * kThreads;
    if (i < kG * D / 4) reinterpret_cast<float4*>(qs)[i] = qpiece[j];
  }
  const int n_tok = min(pos_b + 1, p.T * p.page);
  if (c0 >= n_tok) return;  // nothing of this row in the chunk
  const int n_active = (n_tok + chunk - 1) / chunk;
  const int t_end = min(c0 + chunk, n_tok);
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

  // score phase: token st, D pieces ds, ds + kSlices, ...
  const int st = tid % kTile, ds = tid / kTile;
  // softmax phase: head row `row`, held alike by its 16 threads
  const int row = tid / 16, sub = tid % 16;
  float m_run = kNegInf, l_run = 0.f;
  // P·V phase: 4 columns (piece vc) of every head, tokens of group tg
  const int n_pc = D / 4, n_tg = token_groups(D), per_tg = kTile / n_tg;
  const int vc = tid % n_pc, tg = tid / n_pc;
  const bool pv = tid < n_tg * n_pc;
  float4 acc[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);

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
        float* stg = ring + (nx % S) * stage_elems;
        issue_tile(p, s_pages, window, h, t_lo, t_end, stg, stg + kTile * rs,
                   rs);
      }
      cp_async_commit();
    }
    const float* kt = ring + (i % S) * stage_elems;
    const float* vt = kt + kTile * rs;
    const int t0 = c0 + i * kTile;

    // 1. partial scores of token st over its D pieces, for every head
    {
      float s[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) s[g] = 0.f;
      const float4* kr = reinterpret_cast<const float4*>(kt + st * rs);
      for (int c = ds; c < n_pc; c += kSlices) {
        const float4 kv = kr[c];
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const float4 qv = reinterpret_cast<const float4*>(qs + g * D)[c];
          s[g] = fmaf(qv.x, kv.x, s[g]);
          s[g] = fmaf(qv.y, kv.y, s[g]);
          s[g] = fmaf(qv.z, kv.z, s[g]);
          s[g] = fmaf(qv.w, kv.w, s[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) sp[(ds * kRows + g) * kTile + st] = s[g];
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
#pragma unroll
          for (int d = 0; d < kSlices; ++d)
            s += sp[(d * kRows + row) * kTile + col];
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
        ps[row * kTile + sub + 16 * j] = pr;
      }
      l_run = l_run * corr + row_sum(sum);
      m_run = m_new;
      if (sub == 0) cs[row] = corr;
    }
    __syncthreads();

    // 3. acc = acc·corr + P·V over this thread's tokens
    if (pv) {
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float c = cs[g];
        acc[g].x *= c;
        acc[g].y *= c;
        acc[g].z *= c;
        acc[g].w *= c;
      }
      for (int j = 0; j < per_tg; ++j) {
        const int t = tg * per_tg + j;
        const float4 vv = reinterpret_cast<const float4*>(vt + t * rs)[vc];
#pragma unroll
        for (int g = 0; g < kG; ++g) fma4(acc[g], ps[g * kTile + t], vv);
      }
    }
  }
  cp_async_wait(0);
  __syncthreads();  // the ring is free: it takes the token groups' sums

  float* sums = ring;  // (n_tg, G, D)
  if (pv) {
#pragma unroll
    for (int g = 0; g < kG; ++g)
      if (g < G)
        reinterpret_cast<float4*>(sums + (tg * G + g) * D)[vc] = acc[g];
  }
  if (sub == 0 && row < G) {
    ms[row] = m_run;
    ls[row] = l_run;
  }
  __syncthreads();
  const int bh = b * p.Hkv + h;
  float* orow = p.out + (size_t)bh * G * D;
  if (n_active == 1) {  // the whole row in one chunk: no merge
    for (int i = tid; i < G * D; i += kThreads) {
      float o = 0.f;
      for (int r = 0; r < n_tg; ++r) o += sums[r * G * D + i];
      orow[i] = o / fmaxf(ls[i / D], 1e-30f);
    }
    return;
  }

  // hand this split's state over through device memory; the last of the
  // row's active splits to arrive merges them all
  float* part = p.part + ((size_t)bh * p.n_split + split) * G * D;
  float* part_ml = p.part_ml + ((size_t)bh * p.n_split + split) * 2 * kRows;
  for (int i = tid; i < G * D; i += kThreads) {
    float o = 0.f;
    for (int r = 0; r < n_tg; ++r) o += sums[r * G * D + i];
    __stcg(part + i, o);
  }
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
    orow[i] = o;
  }
  if (tid == 0) p.counters[bh] = 0;  // ready for the next call
}

template <int kG>
int launch(const Params& p, int B, cudaStream_t stream) {
  const Layout L(p.D, p.G, p.stages);
  auto kern = paged_attention_f32_kernel<kG>;
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

// The split of a call's rows over the grid, from the host's shapes only,
// as `paged_attention_plan` in the bf16 library plans it but with this
// kernel's tile and CTAs-per-SM target: the largest power of two of
// splits that keeps the grid within kCtasPerSm·n_sms CTAs (at least 1, at
// most kMaxSplit); each chunk a whole number of pages and, where the page
// size allows, of kTile-token tiles.  Writes plan[0..4]: splits, pages per
// split, and the f32 elements of part and of part_ml and the uint32
// tickets that paged_attention_f32 then needs (all 0 for one split).
// Returns a cudaError_t.
extern "C" int paged_attention_f32_plan(int T, int page, int rows, int G,
                                        int D, int n_sms, long long* plan) {
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
// pos (B,) int32, out (B, Hkv*G, D); all f32 except the int32 arrays, the
// f32 ones 16-byte aligned.  D a multiple of 8 in [8, 256], G in [1, 16];
// the row splits into n_split chunks of chunk_pages pages (n_split <= 32,
// n_split·chunk_pages >= T), as paged_attention_f32_plan plans it.  With
// n_split > 1: the part and part_ml f32 scratch and the counters (uint32
// tickets) of the plan's sizes, the counters zero on entry and left zero.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int paged_attention_f32(const void* q, const void* k_pool,
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
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k_pool);
  p.v = static_cast<const float*>(v_pool);
  p.tables = static_cast<const int*>(tables);
  p.pos = static_cast<const int*>(pos);
  p.out = static_cast<float*>(out);
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
  const int stages = kRingBudget / (2 * kTile * (D + 4) * 4);
  p.stages = stages < 2 ? 2 : (stages > kMaxStages ? kMaxStages : stages);
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G <= 1) return launch<1>(p, B, s);
  if (G <= 2) return launch<2>(p, B, s);
  if (G <= 4) return launch<4>(p, B, s);
  if (G <= 8) return launch<8>(p, B, s);
  return launch<16>(p, B, s);
}
