// K9: one-token GQA decode over a rank's head_dim slice of the cache.
//
// Where a mesh splits the KV cache on head_dim (the planner's choice when
// the kv heads do not divide the model axis and the rows may not split),
// each rank holds columns [r * DS, (r + 1) * DS) of every kv head, for
// every row.  The reference leaves this to XLA: QK^T contracts the split
// dim, so the score tensor is summed over the model ranks
// (src/repro/models/lm.py:697-713, through attention_decode and
// attention_decode_paged).  The fused decode kernels cannot run on a
// column slice (their softmax needs whole scores), so the step is two
// passes around one all-reduce of a compact score buffer:
//   * the buffer is (B, H, Wc), Wc = min(cap, window) with a window and
//     cap (the dense cache's rows, or the paged view's nb * bl) without:
//     it follows from the shapes and the window alone.  Slot b's live
//     rows are [lo, len), len = min(cache_len[b], cap), lo = len - window
//     (0 without a window); row lo + x goes to column x, and the columns
//     past the slot's live count len - lo hold 0.
//   * pass 1 (split_scores_kernel): fp32 partial scores of the rank's
//     columns, q_slice . k_slice^T scaled by the whole head_dim's D^-0.5,
//     into the compact buffer.
//   * between the passes the caller sums the buffer over the model group.
//   * pass 2 (split_context_kernel): an fp32 softmax of the summed live
//     scores and P . V_slice, the splits merged in the same launch.
//
// What bounds it on the H100: bytes and latency.  A row costs G * DS
// multiply-adds (64-320) against DS * 2 bytes of K or V: far below the
// tensor cores' rate, and the math stays on the CUDA cores.  At the served
// shapes a pass moves a few MB (~1.4 us at 3.35 TB/s) and a launch alone
// costs ~1.7 us, so what counts is the dependent trips to memory on a
// CTA's path, the bytes each SM has in flight, and that the grid is
// resident in one wave (scripts/k9_anatomy.py times each piece and stamps
// each step).  The design:
//   * the grids are (tiles or splits) x kv heads x slots, from the shapes
//     (never cache_len, so a tick can be captured in a graph).  A tile or
//     split past the slot's live count writes its zero columns (pass 1)
//     or an empty partial (pass 2) and loads nothing else.
//   * a row's DS columns are C = DS / 8 chunks of 16 bytes, and C lanes
//     take one row: a warp's load covers 32 / C whole row slices, every
//     sector it touches used in full.
//   * a paged CTA reads its table entries once, into shared memory,
//     before any row is addressed: the slot's whole row, loaded beside
//     cache_len (no trip of its own), where it has at most kTblWhole
//     entries; else the entries its rows touch, once cache_len is in.  A
//     row's block and offset are a shift and a mask where the block
//     length is a power of two.
//   * pass 1: one CTA a tile of kScoreTile compact columns; every K load
//     of a thread (C of 16 bytes) is issued before any is used, so the
//     tile's rows are in flight at once.  The row's lanes join their
//     chunks' G partial dots by shuffles, and the scores are stored
//     through shared memory, coalesced.
//   * pass 2: one CTA a split of the compact columns, kCtxRows rows a
//     load (4 * DS threads).  Its rows stream through a ring of two
//     register stages of kCtxLoads loads a thread (kCtxLoads * kCtxRows
//     rows): the next stage's V chunks and scores are in flight while
//     this one is taken.  Each score is read once from global memory, by
//     one lane of its row, and reaches the row's other lanes by shuffles;
//     the maxima and the exp(s - m) both read it from registers.  Each
//     warp runs an online softmax over its rows; the warps' (m, l, acc)
//     merge in warp order into the split's.  The splits of one (slot, kv
//     head) form a thread-block cluster of at most 8 CTAs (the host's
//     split rule, kernels/decode_attention.py context_split, takes two
//     stages a split where one wave of the grid holds them): one split
//     writes its output at once; with several, each stores its partial
//     into the shared memory of the cluster's rank 0 (distributed shared
//     memory: stores that need no reply), one cluster barrier later the
//     others exit and rank 0 merges the splits from its own shared memory
//     in split order (empty splits, m = -inf, absent; a slot with no live
//     row outputs 0).  One launch, no workspace, no atomics:
//     deterministic.
//   * a -1 table entry inside the live rows scores 0 and reads as a zero
//     V row (never dereferenced), as the fused paged kernel and its
//     oracle read it.
//
// Planted faults for the checks: drop_chunk >= 0 leaves that 16-byte
// column chunk out of every pass-1 dot product; swap_entry != 0 makes pass
// 2 read the V rows of table entries 0 and 1 each in the other's place.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;
using repro::bf16;

namespace {

constexpr int kScoreThreads = 128;  // pass 1
constexpr int kScoreTile = 128;     // compact columns a pass-1 CTA scores
constexpr int kCtxRows = 32;        // pass 2: rows a CTA loads at once
constexpr int kCtxLoads = 4;        // pass 2: V loads a thread a stage
constexpr int kSplitRows = 128;     // pass 2's split rows: a multiple of it
constexpr int kMaxCluster = 8;      // pass 2's splits of one (slot, kv head)
// a table row of at most this many entries is staged whole, read while
// cache_len is; a longer one only over the CTA's rows, once len is known
constexpr int kTblWhole = 256;

// Slot b's live rows [lo, lo + n) of its view of cap rows.
struct Live {
  int lo, n;
};

__device__ __forceinline__ Live live_rows(const int* cache_len, int b,
                                          int cap, int window) {
  const int len = max(0, min(cache_len[b], cap));
  const int lo = window > 0 ? max(0, len - window) : 0;
  return {lo, len - lo};
}

// log2(seq) where seq is a power of two, else -1 (host side).
int seq_shift(int seq) {
  return seq > 0 && (seq & (seq - 1)) == 0 ? __builtin_ctz(seq) : -1;
}

// Row j of a paged view: table column j / seq, row j % seq of its block;
// a shift and a mask where seq is a power of two (shift = seq_shift(seq)).
struct RowMap {
  int seq, shift;
  __device__ __forceinline__ int col(int j) const {
    return shift >= 0 ? j >> shift : j / seq;
  }
  __device__ __forceinline__ int row(int j) const {
    return shift >= 0 ? j & (seq - 1) : j % seq;
  }
};

// Table entries [e0, e0 + ne) of slot b into st.
template <int T>
__device__ __forceinline__ void stage_table(const int* __restrict__ tbl,
                                            int* st, int b, int nb, int e0,
                                            int ne) {
  for (int i = threadIdx.x; i < ne; i += T)
    st[i] = tbl[size_t(b) * nb + e0 + i];
}

// Entries a CTA stages for a span of n rows: the whole row of nb where
// that is short, else (n - 1) / seq + 2 (the most n rows can touch).
__host__ __device__ __forceinline__ int table_slots(int nb, int seq, int n) {
  return nb <= kTblWhole ? nb : (n - 1) / seq + 2;
}

// The first staged entry for rows [r0, r0 + n) (n > 0): 0 where the whole
// row was staged beside cache_len, else the span's, staged now.
template <int T>
__device__ __forceinline__ int stage_span(const int* __restrict__ tbl,
                                          int* st, int b, int nb,
                                          const RowMap& rm, int r0, int n) {
  if (nb <= kTblWhole) return 0;
  const int e0 = rm.col(r0);
  stage_table<T>(tbl, st, b, nb, e0, rm.col(r0 + n - 1) - e0 + 1);
  return e0;
}

// Element offset of row j's slice of kv head kvh (ok: the row is read; a
// -1 table entry is not).  Dense: (B, seq, K, DS); paged: (N, seq, K, DS)
// through the staged entries st from column e0.
template <int DS, bool PAGED>
__device__ __forceinline__ size_t row_offset(int b, int j, int kvh, int K,
                                             const RowMap& rm, const int* st,
                                             int e0, bool& ok) {
  size_t r;
  if (PAGED) {
    const int blk = st[rm.col(j) - e0];
    ok = blk >= 0;
    r = size_t(ok ? blk : 0) * rm.seq + rm.row(j);
  } else {
    ok = true;
    r = size_t(b) * rm.seq + j;
  }
  return (r * K + kvh) * DS;
}

// The cluster barrier in halves: arrive without waiting, and wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// q (B, H, DS); k (B, S, K, DS) dense or (N, seq, K, DS) pool; s (B, H, Wc).
// Grid ceil(Wc / kScoreTile) x K x B.
template <int G, int DS, bool PAGED>
__global__ void __launch_bounds__(kScoreThreads)
split_scores_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const int* __restrict__ tbl,
                    const int* __restrict__ cache_len, float* __restrict__ s,
                    int seq, int shift, int nb, int K, int Wc, int window,
                    float scale, int drop_chunk) {
  constexpr int T = kScoreThreads, TILE = kScoreTile;
  constexpr int C = DS / 8;           // lanes a row: one 16-byte chunk each
  constexpr int RS = T / C;           // rows one load of the CTA covers
  constexpr int L = TILE / RS;        // loads a thread
  static_assert(32 % C == 0 && TILE % RS == 0, "a row's lanes in one warp");
  __shared__ float ss[G * TILE];
  // table_slots(nb, seq, TILE) at most: kTblWhole, or TILE + 1 at seq 1
  __shared__ int stbl[kTblWhole > TILE + 1 ? kTblWhole : TILE + 1];
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int H = K * G;
  const int cap = PAGED ? nb * seq : seq;
  const int tid = threadIdx.x, c = tid % C;
  if (PAGED && nb <= kTblWhole) stage_table<T>(tbl, stbl, b, nb, 0, nb);
  // this lane's chunk of the G query slices, scaled; issued with cache_len
  float qf[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    repro::bf16x8_to_float(*reinterpret_cast<const uint4*>(
                               q + (size_t(b) * H + kvh * G + g) * DS + c * 8),
                           qf[g]);
#pragma unroll
    for (int e = 0; e < 8; ++e) qf[g][e] *= scale;
  }
  const Live lv = live_rows(cache_len, b, cap, window);
  const int x0 = blockIdx.x * TILE;
  const int nloc = min(TILE, lv.n - x0);         // live columns of the tile
  const int ncol = min(TILE, Wc - x0);           // columns of the tile
  float* sb = s + (size_t(b) * H + kvh * G) * Wc + x0;
  if (nloc <= 0) {                               // no live row: zeros
#pragma unroll
    for (int g = 0; g < G; ++g)
      for (int x = tid; x < ncol; x += T) sb[size_t(g) * Wc + x] = 0.f;
    return;
  }
  const RowMap rm{seq, shift};
  const int r0 = lv.lo + x0;                     // the tile's first row
  int e0 = 0;
  if (PAGED) {
    e0 = stage_span<T>(tbl, stbl, b, nb, rm, r0, nloc);
    __syncthreads();
  }
  // every K load of this thread before any is used
  uint4 kv[L];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int x = i * RS + tid / C;
    kv[i] = make_uint4(0u, 0u, 0u, 0u);
    if (x < nloc) {
      bool ok;
      const size_t off = row_offset<DS, PAGED>(b, r0 + x, kvh, K, rm, stbl,
                                               e0, ok);
      if (ok) kv[i] = *reinterpret_cast<const uint4*>(k + off + c * 8);
    }
  }
#pragma unroll
  for (int i = 0; i < L; ++i) {
    float kf[8];
    repro::bf16x8_to_float(kv[i], kf);
    float a[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      a[g] = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) a[g] = fmaf(qf[g][e], kf[e], a[g]);
      if (c == drop_chunk) a[g] = 0.f;
    }
    // the row's C lanes are adjacent: join their chunks
#pragma unroll
    for (int o = C / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int g = 0; g < G; ++g)
        a[g] += __shfl_xor_sync(0xffffffffu, a[g], o);
    }
    const int x = i * RS + tid / C;
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (g % C == c) ss[g * TILE + x] = a[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g)
    for (int x = tid; x < ncol; x += T)
      sb[size_t(g) * Wc + x] = x < nloc ? ss[g * TILE + x] : 0.f;
}

// s (B, H, Wc) summed scores; v (B, S, K, DS) or (N, seq, K, DS); out
// (B, H, DS) bf16.  Grid splits x K x B, clusters of (splits, 1, 1) where
// splits > 1: split p covers the compact columns [p * rows, (p + 1) *
// rows).  Dynamic shared memory: the cluster's partials (splits, G, DS +
// 2) -- m, l, acc; every split stores its own into rank 0's -- then the
// staged table entries.
template <int G, int DS, bool PAGED>
__global__ void __launch_bounds__(kCtxRows * DS / 8)
split_context_kernel(const float* __restrict__ s, const bf16* __restrict__ v,
                     const int* __restrict__ tbl,
                     const int* __restrict__ cache_len,
                     bf16* __restrict__ out, int seq, int shift, int nb,
                     int K, int Wc, int window, int rows, int swap_entry) {
  constexpr int C = DS / 8;            // lanes a row: one 16-byte chunk each
  constexpr int RS = kCtxRows;         // rows one load of the CTA covers
  constexpr int T = RS * C, W = T / 32;
  constexpr int L = kCtxLoads;         // V loads a thread a stage
  constexpr int TILE = L * RS;         // rows a register stage holds
  constexpr int GL = (G + C - 1) / C;  // scores a lane loads a row
  constexpr int P = DS + 2;            // a partial: m, l, acc[DS]
  static_assert(32 % C == 0, "a row's lanes lie in one warp");
  extern __shared__ __align__(16) float smem[];
  __shared__ float wpart[W * G * P];   // the warps' partials
  const int splits = gridDim.x, split = blockIdx.x;
  float* parts = smem;                 // (splits, G, P)
  int* stbl = reinterpret_cast<int*>(parts + splits * G * P);
  // several splits: every CTA of the cluster has started once this phase
  // completes, and only then may a split store into rank 0's memory
  if (splits > 1) cluster_arrive_relaxed();
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int H = K * G;
  const int cap = PAGED ? nb * seq : seq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c = tid % C;
  if (PAGED && nb <= kTblWhole) stage_table<T>(tbl, stbl, b, nb, 0, nb);
  const Live lv = live_rows(cache_len, b, cap, window);
  const int x0 = split * rows;
  const int nloc = max(0, min(rows, lv.n - x0));   // the split's live rows
  // each warp's online softmax over its rows: m, l, acc[G][8] (chunk c)
  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }
  if (nloc > 0) {
    const RowMap rm{seq, shift};
    const int r0 = lv.lo + x0;
    int e0 = 0;
    if (PAGED) {
      e0 = stage_span<T>(tbl, stbl, b, nb, rm, r0, nloc);
      __syncthreads();
    }
    const float* sb = s + (size_t(b) * H + kvh * G) * Wc + x0;
    // stage t: this thread's V chunks and its share of its rows' scores
    // (lane c of a row loads heads c, c + C, ...; masked rows -inf), every
    // load issued before any is used
    auto load = [&](int t, uint4 (&vr)[L], float (&sr)[L][GL]) {
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const int x = t * TILE + i * RS + tid / C;
        vr[i] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int k = 0; k < GL; ++k) sr[i][k] = -INFINITY;
        if (x < nloc) {
          const int j = r0 + x;
          bool ok;
          size_t off;
          if (PAGED && swap_entry && rm.col(j) < 2 && nb >= 2) {
            const int blk = tbl[size_t(b) * nb + (rm.col(j) ^ 1)];
            ok = blk >= 0;
            off = ((size_t(ok ? blk : 0) * seq + rm.row(j)) * K + kvh) * DS;
          } else {
            off = row_offset<DS, PAGED>(b, j, kvh, K, rm, stbl, e0, ok);
          }
          if (ok) vr[i] = *reinterpret_cast<const uint4*>(v + off + c * 8);
#pragma unroll
          for (int k = 0; k < GL; ++k)
            if (c + k * C < G) sr[i][k] = sb[size_t(c + k * C) * Wc + x];
        }
      }
    };
    // the warp's rows of a stage into its softmax: the scores shared among
    // a row's lanes, the stage's maxima across the warp, the old terms
    // rescaled, then exp(s - m) . v
    auto take = [&](const uint4 (&vr)[L], const float (&own)[L][GL]) {
      float sr[L][G];
#pragma unroll
      for (int i = 0; i < L; ++i)
#pragma unroll
        for (int g = 0; g < G; ++g)
          sr[i][g] = __shfl_sync(0xffffffffu, own[i][g / C],
                                 (lane & ~(C - 1)) | (g % C));
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mx = sr[0][g];
#pragma unroll
        for (int i = 1; i < L; ++i) mx = fmaxf(mx, sr[i][g]);
        const float mn = fmaxf(m[g], repro::warp_max(mx));
        if (mn == -INFINITY) continue;   // no live row in the warp yet
        const float f = repro::rescale(m[g], mn);
        l[g] *= f;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] *= f;
        m[g] = mn;
      }
#pragma unroll
      for (int i = 0; i < L; ++i) {
        float vf[8];
        repro::bf16x8_to_float(vr[i], vf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float p = repro::masked_exp(sr[i][g], m[g]);
          l[g] += p;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
        }
      }
    };
    // a ring of two register stages: the next stage's loads in flight
    // while this one is taken
    const int nst = (nloc + TILE - 1) / TILE;
    uint4 va[L], vb[L];
    float sa[L][GL], sbuf[L][GL];
    load(0, va, sa);
    for (int t = 0; t < nst; t += 2) {
      if (t + 1 < nst) load(t + 1, vb, sbuf);
      take(va, sa);
      if (t + 1 < nst) {
        if (t + 2 < nst) load(t + 2, va, sa);
        take(vb, sbuf);
      }
    }
  }
  // each warp's partial: acc over its lanes of one chunk by shuffles, l
  // over all lanes (each row counted by its C lanes)
#pragma unroll
  for (int o = C; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float lw = repro::warp_sum(l[g]) * (1.f / C);
    float* wp = wpart + (warp * G + g) * P;
    if (lane == 0) {
      wp[0] = m[g];
      wp[1] = lw;
    }
    if (lane < C) {
#pragma unroll
      for (int e = 0; e < 8; ++e) wp[2 + c * 8 + e] = acc[g][e];
    }
  }
  __syncthreads();
  // the warps merged in order: the split's partial
  float* part = parts;                 // rank 0's slot of this split
  if (splits > 1) {
    cluster_wait();
    part = cg::this_cluster().map_shared_rank(parts, 0) +
           size_t(split) * G * P;
  }
  for (int o = tid; o < G * DS; o += T) {
    const int g = o / DS, d = o % DS;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < W; ++w) mx = fmaxf(mx, wpart[(w * G + g) * P]);
    float a = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float* wp = wpart + (w * G + g) * P;
      const float f = repro::rescale(wp[0], mx);
      lsum = fmaf(f, wp[1], lsum);
      a = fmaf(f, wp[2 + d], a);
    }
    if (splits == 1) {                 // one split: the output at once
      out[(size_t(b) * H + kvh * G) * DS + o] =
          __float2bfloat16(lsum > 0.f ? a / lsum : 0.f);
    } else {
      part[g * P + 2 + d] = a;
      if (d == 0) {
        part[g * P] = mx;
        part[g * P + 1] = lsum;
      }
    }
  }
  if (splits == 1) return;
  cg::this_cluster().sync();           // every split's partial is in rank 0
  if (split != 0) return;
  // rank 0 merges the splits in split order, from its own shared memory
  for (int o = tid; o < G * DS; o += T) {
    const int g = o / DS, d = o % DS;
    float mx = -INFINITY;
    for (int p = 0; p < splits; ++p) mx = fmaxf(mx, parts[(p * G + g) * P]);
    float a = 0.f, lsum = 0.f;
    for (int p = 0; p < splits; ++p) {
      const float* pp = parts + (p * G + g) * P;
      const float f = repro::rescale(pp[0], mx);
      lsum = fmaf(f, pp[1], lsum);
      a = fmaf(f, pp[2 + d], a);
    }
    out[(size_t(b) * H + kvh * G + g) * DS + d] =
        __float2bfloat16(lsum > 0.f ? a / lsum : 0.f);
  }
}

template <int G, int DS, bool PAGED>
int launch_scores(const void* q, const void* k, const int* tbl,
                  const int* cache_len, void* s, int B, int K, int seq,
                  int nb, int Wc, int window, float scale, int drop_chunk,
                  cudaStream_t stream) {
  split_scores_kernel<G, DS, PAGED>
      <<<dim3((Wc + kScoreTile - 1) / kScoreTile, K, B), kScoreThreads, 0,
         stream>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   tbl, cache_len, static_cast<float*>(s), seq,
                   seq_shift(seq), nb, K, Wc, window, scale, drop_chunk);
  return int(cudaGetLastError());
}

template <int G, int DS, bool PAGED>
int launch_context(const void* s, const void* v, const int* tbl,
                   const int* cache_len, void* out, int B, int K, int seq,
                   int nb, int Wc, int window, int splits, int rows,
                   int swap_entry, cudaStream_t stream) {
  auto kern = split_context_kernel<G, DS, PAGED>;
  const int ntbl = PAGED ? table_slots(nb, seq, rows) : 0;
  const size_t smem = (size_t(splits) * G * (DS + 2) + ntbl) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, K, B);
  cfg.blockDim = dim3(kCtxRows * DS / 8);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const float*>(s),
                           static_cast<const bf16*>(v), tbl, cache_len,
                           static_cast<bf16*>(out), seq, seq_shift(seq), nb,
                           K, Wc, window, rows, swap_entry);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

// The (G, DS) instances: every (GQA group, head_dim / m) a served arch's
// head_dim-split plan reaches at m in {2, 4} (hymba-1.5b's padded 26 / 13
// heads at 64 / 2, its 28 / 7 at 64 / 4), hymba's unpadded group of 5 at
// both, and qwen3-8b's group of 4 at 128 / 2 (decode_attention.py
// SPLIT_INSTANCES).
#define REPRO_SPLIT_CASES(X) \
  X(2, 32) X(4, 16) X(5, 32) X(5, 16) X(4, 64)

// Wc as the contract fixes it: min(cap, window) with a window, else cap.
bool compact_ok(int B, int H, int K, int seq, int nb, bool paged, int Wc,
                int window) {
  if (B <= 0 || K <= 0 || H % K || seq <= 0 || (paged && nb <= 0) ||
      B > 65535 || K > 65535)
    return false;
  const long cap = paged ? long(nb) * seq : long(seq);
  return long(Wc) == (window > 0 && window < cap ? long(window) : cap);
}

template <bool PAGED>
int scores(const void* q, const void* k, const int* tbl, const int* cache_len,
           void* s, int B, int H, int K, int DS, int seq, int nb, int Wc,
           int window, float scale, int drop_chunk, void* stream) {
  if (!compact_ok(B, H, K, seq, nb, PAGED, Wc, window))
    return int(cudaErrorInvalidValue);
  const int G = H / K;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_SCORES_CASE(GG, DD)                                          \
  if (G == GG && DS == DD)                                                 \
    return launch_scores<GG, DD, PAGED>(q, k, tbl, cache_len, s, B, K, seq, \
                                        nb, Wc, window, scale, drop_chunk,  \
                                        st);
  REPRO_SPLIT_CASES(REPRO_SCORES_CASE)
#undef REPRO_SCORES_CASE
  return int(cudaErrorInvalidValue);
}

template <bool PAGED>
int context(const void* s, const void* v, const int* tbl,
            const int* cache_len, void* out, int B, int H, int K, int DS,
            int seq, int nb, int Wc, int window, int splits, int rows,
            int swap_entry, void* stream) {
  if (!compact_ok(B, H, K, seq, nb, PAGED, Wc, window) || splits <= 0 ||
      splits > kMaxCluster || rows <= 0 || rows % kSplitRows ||
      long(splits) * rows < Wc)
    return int(cudaErrorInvalidValue);
  const int G = H / K;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_CONTEXT_CASE(GG, DD)                                         \
  if (G == GG && DS == DD)                                                 \
    return launch_context<GG, DD, PAGED>(s, v, tbl, cache_len, out, B, K,   \
                                         seq, nb, Wc, window, splits, rows, \
                                         swap_entry, st);
  REPRO_SPLIT_CASES(REPRO_CONTEXT_CASE)
#undef REPRO_CONTEXT_CASE
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Pass 1.  q (B, H, DS) bf16: the rank's columns of every query head;
// k (B, S, K, DS) bf16 (dense, seq = S, tbl null) or (N, bl, K, DS)
// (paged, seq = bl, tbl (B, nb) int32 with -1 = none); cache_len (B,)
// int32; s (B, H, Wc) fp32, the compact layout of the header, every entry
// written.  scale: the whole head_dim's D^-0.5.  Returns a cudaError_t.
int decode_split_scores(const void* q, const void* k, const void* tbl,
                        const void* cache_len, void* s, int B, int H, int K,
                        int DS, int seq, int nb, int Wc, int window,
                        float scale, int drop_chunk, void* stream) {
  const int* t = static_cast<const int*>(tbl);
  const int* cl = static_cast<const int*>(cache_len);
  return t ? scores<true>(q, k, t, cl, s, B, H, K, DS, seq, nb, Wc, window,
                          scale, drop_chunk, stream)
           : scores<false>(q, k, t, cl, s, B, H, K, DS, seq, 0, Wc, window,
                           scale, drop_chunk, stream);
}

// Pass 2.  s (B, H, Wc) fp32, the compact scores summed over the model
// ranks; v as k above; out (B, H, DS) bf16.  Split p covers the compact
// columns [p * rows, (p + 1) * rows): 1 <= splits <= 8 (one cluster),
// rows a multiple of 128, splits * rows >= Wc.  One launch.
int decode_split_context(const void* s, const void* v, const void* tbl,
                         const void* cache_len, void* out, int B, int H,
                         int K, int DS, int seq, int nb, int Wc, int window,
                         int splits, int rows, int swap_entry, void* stream) {
  const int* t = static_cast<const int*>(tbl);
  const int* cl = static_cast<const int*>(cache_len);
  return t ? context<true>(s, v, t, cl, out, B, H, K, DS, seq, nb, Wc,
                           window, splits, rows, swap_entry, stream)
           : context<false>(s, v, t, cl, out, B, H, K, DS, seq, 0, Wc,
                            window, splits, rows, swap_entry, stream);
}

}  // extern "C"
