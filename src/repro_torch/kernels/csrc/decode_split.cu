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
// passes around one all-reduce:
//   * pass 1 (split_scores_kernel): fp32 partial scores of the rank's
//     columns, q_slice . k_slice^T scaled by the whole head_dim's
//     D^-0.5, into a (B, H, C) buffer, C the dense cache's rows or the
//     paged view's nb * bl.  One CTA per (slot x kv head, 128-row tile),
//     one row a thread: the row's DS columns in 16-byte loads against the
//     CTA's G scaled query slices in shared memory.  Rows past cache_len
//     or before the window, and rows of a -1 table entry, are never
//     loaded and score 0 (pass 2 masks them).
//   * between the passes the caller sums the buffer over the model group.
//   * pass 2 (split_context_kernel, then split_merge_kernel): the length
//     and window mask, an fp32 softmax of the summed scores and P . V_slice.
//     The grid is (slot x kv head) x splits of split_rows rows.  A CTA
//     finds its rows' maxima, then each thread takes one 16-byte chunk of
//     V (DS / 8 threads a row, 128 / (DS / 8) rows at once), accumulates
//     exp(s - m) . v over its rows, and the row groups are summed in
//     shared memory in a fixed order into the split's fp32 (m, l, acc).
//     The merge kernel weighs the splits in split order (empty splits,
//     m = -inf, are absent) and writes the bf16 context columns; a slot
//     with no live row gets zeros.  A -1 table entry inside the live rows
//     reads as a zero V row with score 0, as the fused paged kernel and
//     its oracle read it.
// The work is bytes (each live K and V slice row read once, the score
// buffer written once and read once); the math stays on the CUDA cores.
// Deterministic: no atomics.
//
// Planted faults for the checks: drop_chunk >= 0 leaves that 16-byte
// column chunk out of every pass-1 dot product; swap_entry != 0 makes pass
// 2 read the V rows of table entries 0 and 1 each in the other's place.

#include "common.cuh"

using repro::bf16;

namespace {

constexpr int kThreads = 128;
constexpr int kTileRows = kThreads;   // pass 1: one row a thread

// q (B, H, DS); k (B, S, K, DS) dense or (N, seq, K, DS) pool; s (B, H, C).
template <int G, int DS, bool PAGED>
__global__ void __launch_bounds__(kThreads)
split_scores_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const int* __restrict__ tbl,
                    const int* __restrict__ cache_len, float* __restrict__ s,
                    int seq, int nb, int K, int window, float scale,
                    int drop_chunk) {
  constexpr int C = DS / 8;           // 16-byte chunks of a row's slice
  __shared__ __align__(16) float qs[G * DS];
  const int bk = blockIdx.x, b = bk / K, kvh = bk % K;
  const int H = K * G;
  const int cap = PAGED ? nb * seq : seq;
  for (int i = threadIdx.x; i < G * DS; i += kThreads)
    qs[i] = __bfloat162float(q[(size_t(b) * H + kvh * G) * DS + i]) * scale;
  __syncthreads();
  const int len = min(cache_len[b], cap);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int j = blockIdx.y * kTileRows + threadIdx.x;
  if (j >= cap) return;
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;
  bool live = j >= lo && j < len;
  size_t off = 0;
  if (live) {
    if (PAGED) {
      const int blk = tbl[size_t(b) * nb + j / seq];
      live = blk >= 0;
      off = (size_t(live ? blk : 0) * seq + j % seq) * size_t(K) * DS;
    } else {
      off = (size_t(b) * seq + j) * size_t(K) * DS;
    }
    off += size_t(kvh) * DS;
  }
  if (live) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (c == drop_chunk) continue;
      float kf[8];
      repro::bf16x8_to_float(*reinterpret_cast<const uint4*>(k + off + c * 8),
                             kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float* qg = qs + g * DS + c * 8;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g] = fmaf(qg[e], kf[e], acc[g]);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
    s[(size_t(b) * H + kvh * G + g) * cap + j] = acc[g];
}

// s (B, H, C) summed scores; v (B, S, K, DS) or (N, seq, K, DS); ws
// (B * K, splits, G, DS + 2): each split's m, l, acc[DS].
template <int G, int DS, bool PAGED>
__global__ void __launch_bounds__(kThreads)
split_context_kernel(const float* __restrict__ s, const bf16* __restrict__ v,
                     const int* __restrict__ tbl,
                     const int* __restrict__ cache_len, float* __restrict__ ws,
                     int seq, int nb, int K, int window, int split_rows,
                     int swap_entry) {
  constexpr int C = DS / 8;            // threads a row: one chunk each
  constexpr int RP = kThreads / C;     // rows in flight
  constexpr int W = kThreads / 32;
  static_assert(kThreads % C == 0, "a row's chunks fill whole threads");
  __shared__ float sacc[RP * G * DS];
  __shared__ float sred[W * G];
  __shared__ float smax[G];
  const int bk = blockIdx.x, b = bk / K, kvh = bk % K;
  const int split = blockIdx.y, splits = gridDim.y;
  const int H = K * G;
  const int cap = PAGED ? nb * seq : seq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = min(cache_len[b], cap);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int r0 = max(split * split_rows, lo);
  const int r1 = min((split + 1) * split_rows, len);
  float* part = ws + (size_t(bk) * splits + split) * G * (DS + 2);
  if (r0 >= r1) {                      // an empty split: merges as absent
    if (tid < G) {
      part[tid * (DS + 2)] = -INFINITY;
      part[tid * (DS + 2) + 1] = 0.f;
    }
    return;
  }
  const float* sb = s + (size_t(b) * H + kvh * G) * cap;
  // the split's maxima
  float m[G];
#pragma unroll
  for (int g = 0; g < G; ++g) m[g] = -INFINITY;
  for (int j = r0 + tid; j < r1; j += kThreads)
#pragma unroll
    for (int g = 0; g < G; ++g) m[g] = fmaxf(m[g], sb[size_t(g) * cap + j]);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float w = repro::warp_max(m[g]);
    if (lane == 0) sred[warp * G + g] = w;
  }
  __syncthreads();
  if (tid < G) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < W; ++w) mx = fmaxf(mx, sred[w * G + tid]);
    smax[tid] = mx;
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) m[g] = smax[g];
  // P . V over the split's rows: row group rg, chunk c of each row
  const int rg = tid / C, c = tid % C;
  float acc[G][8], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }
  for (int j = r0 + rg; j < r1; j += RP) {
    size_t off;
    bool live = true;
    if (PAGED) {
      int e = j / seq;
      if (swap_entry && e < 2 && nb >= 2) e ^= 1;
      const int blk = tbl[size_t(b) * nb + e];
      live = blk >= 0;
      off = (size_t(live ? blk : 0) * seq + j % seq) * size_t(K) * DS;
    } else {
      off = (size_t(b) * seq + j) * size_t(K) * DS;
    }
    off += size_t(kvh) * DS + c * 8;
    float vf[8];
    if (live) {
      repro::bf16x8_to_float(*reinterpret_cast<const uint4*>(v + off), vf);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) vf[e] = 0.f;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float p = __expf(sb[size_t(g) * cap + j] - m[g]);
      l[g] += p;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
    }
  }
  // every chunk of a row sees the same p: chunk 0's l is the row group's
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      sacc[(rg * G + g) * DS + c * 8 + e] = acc[g][e];
  }
  __syncthreads();
  for (int o = tid; o < G * DS; o += kThreads) {
    const int g = o / DS, d = o % DS;
    float a = 0.f;
    for (int r = 0; r < RP; ++r) a += sacc[(r * G + g) * DS + d];
    part[g * (DS + 2) + 2 + d] = a;
  }
  __syncthreads();
  // the l sums, the row groups in order (chunk 0 of each)
  if (c == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) sacc[rg * G + g] = l[g];
  }
  __syncthreads();
  if (tid < G) {
    float lsum = 0.f;
    for (int r = 0; r < RP; ++r) lsum += sacc[r * G + tid];
    part[tid * (DS + 2)] = m[tid];
    part[tid * (DS + 2) + 1] = lsum;
  }
}

// ws as above; out (B, H, DS) bf16.
template <int G, int DS>
__global__ void __launch_bounds__(kThreads)
split_merge_kernel(const float* __restrict__ ws, bf16* __restrict__ out,
                   int K, int splits) {
  const int bk = blockIdx.x, b = bk / K, kvh = bk % K;
  const int H = K * G;
  const float* parts = ws + size_t(bk) * splits * G * (DS + 2);
  for (int o = threadIdx.x; o < G * DS; o += kThreads) {
    const int g = o / DS, d = o % DS;
    float mx = -INFINITY;
    for (int sp = 0; sp < splits; ++sp)
      mx = fmaxf(mx, parts[(size_t(sp) * G + g) * (DS + 2)]);
    float a = 0.f, lsum = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      const float* p = parts + (size_t(sp) * G + g) * (DS + 2);
      if (p[0] == -INFINITY) continue;
      const float f = __expf(p[0] - mx);
      lsum = fmaf(f, p[1], lsum);
      a = fmaf(f, p[2 + d], a);
    }
    out[(size_t(b) * H + kvh * G + g) * DS + d] =
        __float2bfloat16(lsum > 0.f ? a / lsum : 0.f);
  }
}

template <int G, int DS, bool PAGED>
int launch_scores(const void* q, const void* k, const int* tbl,
                  const int* cache_len, void* s, int B, int K, int seq,
                  int nb, int window, float scale, int drop_chunk,
                  cudaStream_t stream) {
  const int cap = PAGED ? nb * seq : seq;
  split_scores_kernel<G, DS, PAGED>
      <<<dim3(B * K, (cap + kTileRows - 1) / kTileRows), kThreads, 0,
         stream>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   tbl, cache_len, static_cast<float*>(s), seq, nb, K,
                   window, scale, drop_chunk);
  return int(cudaGetLastError());
}

template <int G, int DS, bool PAGED>
int launch_context(const void* s, const void* v, const int* tbl,
                   const int* cache_len, void* ws, void* out, int B, int K,
                   int seq, int nb, int window, int splits, int split_rows,
                   int swap_entry, cudaStream_t stream) {
  split_context_kernel<G, DS, PAGED><<<dim3(B * K, splits), kThreads, 0,
                                       stream>>>(
      static_cast<const float*>(s), static_cast<const bf16*>(v), tbl,
      cache_len, static_cast<float*>(ws), seq, nb, K, window, split_rows,
      swap_entry);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  split_merge_kernel<G, DS><<<B * K, kThreads, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<bf16*>(out), K, splits);
  return int(cudaGetLastError());
}

// The (G, DS) instances: every (GQA group, head_dim / m) a served arch's
// head_dim-split plan reaches at m in {2, 4} (hymba-1.5b's padded 26 / 13
// heads at 64 / 2, its 28 / 7 at 64 / 4), hymba's unpadded group of 5 at
// both, and qwen3-8b's group of 4 at 128 / 2 (decode_attention.py
// SPLIT_INSTANCES).
#define REPRO_SPLIT_CASES(X) \
  X(2, 32) X(4, 16) X(5, 32) X(5, 16) X(4, 64)

template <bool PAGED>
int scores(const void* q, const void* k, const int* tbl, const int* cache_len,
           void* s, int B, int H, int K, int DS, int seq, int nb, int window,
           float scale, int drop_chunk, void* stream) {
  if (B <= 0 || K <= 0 || H % K || seq <= 0 || (PAGED && nb <= 0))
    return int(cudaErrorInvalidValue);
  const int G = H / K;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_SCORES_CASE(GG, DD)                                         \
  if (G == GG && DS == DD)                                                \
    return launch_scores<GG, DD, PAGED>(q, k, tbl, cache_len, s, B, K, seq, \
                                        nb, window, scale, drop_chunk, st);
  REPRO_SPLIT_CASES(REPRO_SCORES_CASE)
#undef REPRO_SCORES_CASE
  return int(cudaErrorInvalidValue);
}

template <bool PAGED>
int context(const void* s, const void* v, const int* tbl,
            const int* cache_len, void* ws, void* out, int B, int H, int K,
            int DS, int seq, int nb, int window, int splits, int split_rows,
            int swap_entry, void* stream) {
  const long cap = PAGED ? long(nb) * seq : long(seq);
  if (B <= 0 || K <= 0 || H % K || seq <= 0 || (PAGED && nb <= 0) ||
      splits <= 0 || splits > 65535 || split_rows <= 0 ||
      long(splits) * split_rows < cap)
    return int(cudaErrorInvalidValue);
  const int G = H / K;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_CONTEXT_CASE(GG, DD)                                          \
  if (G == GG && DS == DD)                                                  \
    return launch_context<GG, DD, PAGED>(s, v, tbl, cache_len, ws, out, B,  \
                                         K, seq, nb, window, splits,         \
                                         split_rows, swap_entry, st);
  REPRO_SPLIT_CASES(REPRO_CONTEXT_CASE)
#undef REPRO_CONTEXT_CASE
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Pass 1.  q (B, H, DS) bf16: the rank's columns of every query head;
// k (B, S, K, DS) bf16 (dense, seq = S, tbl null) or (N, bl, K, DS)
// (paged, seq = bl, tbl (B, nb) int32 with -1 = none); cache_len (B,)
// int32; s (B, H, cap) fp32, cap = S or nb * bl, every entry written.
// scale: the whole head_dim's D^-0.5.  Returns a cudaError_t.
int decode_split_scores(const void* q, const void* k, const void* tbl,
                        const void* cache_len, void* s, int B, int H, int K,
                        int DS, int seq, int nb, int window, float scale,
                        int drop_chunk, void* stream) {
  const int* t = static_cast<const int*>(tbl);
  const int* cl = static_cast<const int*>(cache_len);
  return t ? scores<true>(q, k, t, cl, s, B, H, K, DS, seq, nb, window,
                          scale, drop_chunk, stream)
           : scores<false>(q, k, t, cl, s, B, H, K, DS, seq, 0, window,
                           scale, drop_chunk, stream);
}

// Pass 2.  s (B, H, cap) fp32, the scores summed over the model ranks;
// v as k above; ws: fp32 workspace of B * K * splits * G * (DS + 2)
// floats; out (B, H, DS) bf16.  Split p covers rows [p * split_rows,
// (p + 1) * split_rows); splits * split_rows >= cap.  Two launches.
int decode_split_context(const void* s, const void* v, const void* tbl,
                         const void* cache_len, void* ws, void* out, int B,
                         int H, int K, int DS, int seq, int nb, int window,
                         int splits, int split_rows, int swap_entry,
                         void* stream) {
  const int* t = static_cast<const int*>(tbl);
  const int* cl = static_cast<const int*>(cache_len);
  return t ? context<true>(s, v, t, cl, ws, out, B, H, K, DS, seq, nb,
                           window, splits, split_rows, swap_entry, stream)
           : context<false>(s, v, t, cl, ws, out, B, H, K, DS, seq, 0,
                            window, splits, split_rows, swap_entry, stream);
}

}  // extern "C"
