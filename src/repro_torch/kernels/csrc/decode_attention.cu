// One-token GQA decode attention over the session cache, paged or dense.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/decode_attention.py:
//   paged_decode_attention (body _paged_decode_kernel): the block table and
//     per-slot cache_len were scalar-prefetched and drove the k/v BlockSpec
//     index maps, one pool block per grid step;
//   decode_attention (body _decode_kernel): a dense (B, S, K, D) cache with
//     one scalar cache_len, streamed in block_kv-row banks.
//
// What bounds it on the H100: bytes.  A decode step reads every live K/V row
// once and does 2*G multiply-adds per element read (G = H/K query heads per
// kv head, 4 for qwen3-8b), far below the ~295 FLOP/byte the card needs
// before its arithmetic is the limit.  So the design keeps as many of the
// live bytes in flight on as many SMs as it can, and reads each once:
//   * split-KV: the grid is (slot x kv head) x splits.  Split s owns the
//     cache rows [s * split_rows, (s + 1) * split_rows); the host picks
//     splits and split_rows from B, K and the cache's capacity alone
//     (kernels/decode_attention.py decode_split), never from cache_len,
//     which lives on the device.  A split wholly past the slot's length or
//     before its window start writes an empty partial (m = -inf, l = 0).
//   * inside a CTA each of the 4 warps owns kRows = 16 consecutive rows of
//     every 64-row step and runs its own online softmax over them.  A lane
//     pair computes one row's G scores (each lane half the row's 16-byte
//     chunks against q, scaled, in shared memory; one shuffle joins the
//     halves), so a score costs no warp-wide reduction; then each lane
//     accumulates P.V for D / 32 head dims of all G query heads.  Each
//     warp fills its own ring of kStages shared-memory stages with
//     cp.async (16 bytes a lane; each row's table entry is read by one
//     lane and shared by shuffle; rows past the split and -1 table
//     entries are zero-filled with a source size of 0 and never
//     dereferenced, so a -1 block reads as zero rows, as the oracle
//     paged_gather_ref does).  K rows sit at a 16-byte padded pitch, so a
//     quarter warp's chunk reads hit distinct banks.  The ring is
//     warp-private: no CTA barrier in the row loop, only __syncwarp.
//   * the warps' partials merge in shared memory, and the split's fp32
//     partial (m, l, acc[G][D]) goes to a workspace.  The last CTA of a
//     (slot, kv head) to finish -- it learns that from an atomicAdd on a
//     per-(slot, kv head) counter after a __threadfence -- merges the
//     splits in split order (deterministic: the same bits whichever CTA is
//     last), writes the bf16 output and sets the counter back to 0.  So a
//     decode layer stays one launch, with no memset and no combine kernel.
//     The merge's weights are reduced by warps striding over the splits
//     and its loads are issued four at a time: a chain of dependent L2
//     loads there cost more than the whole row loop.  Empty partials
//     merge as absent; a slot with no live row outputs 0.
// fp32 softmax statistics and accumulation; the math stays on the CUDA
// cores (bytes bound it).  D is a template parameter, built at 128 and, for
// hymba-1.5b and granite-moe-1b-a400m, 64 (a row is 8 chunks of 16 bytes,
// a lane pair's 4 each, and each lane accumulates D / 32 = 2 dims of P.V);
// G is read only as a loop bound and an array size, built at 1, 2, 4, 5, 6,
// 7 and 8 (D = 128) and 2, 4 and 5 (D = 64).
//
// PARTIAL (the per-shard partial of a sharded decode, dist/flash_decode.py):
// the same kernel over one shard's rows, where the last CTA of a (slot, kv
// head) writes the merged fp32 (m, l, acc) -- unnormalised, acc[h][d] =
// sum_r exp(s_r - m) v_r -- for the ranks to combine, instead of the bf16
// output.  cache_len then holds each slot's global position pos, and a row
// is live where its global position lies in [pos + 1 - window, pos] (from 0
// without a window).  Dense: k/v are the shard's slice of the rows, whose
// first row is the global row kv_start.  Paged: k/v are the shard's sub-pool
// of n_local blocks, the first being the global block kv_start, read through
// the global table; a row of a block outside [kv_start, kv_start + n_local)
// or of a -1 entry is masked (not read as a zero row: that would add
// exp(0 - m) to l) and never loaded, and a warp whose rows of a step are all
// masked skips the step's arithmetic.  An empty partial is m = -inf, l = 0.

#include "common.cuh"

using repro::bf16;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;       // rows a warp stages per step: a lane pair each
// depth of each warp's cp.async ring: two stages at three CTAs an SM
// (70,656 bytes each at G = 4) ran faster on an H100 than three stages
// at two CTAs an SM
constexpr int kStages = 2;

template <int G, int D>
struct Smem {
  static constexpr int kKP = D + 8;    // K row pitch: 16 bytes of padding
  static constexpr int kStageElems = kRows * (kKP + D);   // K rows, V rows
  static constexpr size_t kRing =
      size_t(kWarps) * kStages * kStageElems * sizeof(bf16);
  // the warps' partials, merged after the row loop (reuses the ring)
  static constexpr size_t kMerge = size_t(kWarps) * G * (D + 2) * sizeof(float);
  static constexpr size_t kMain = kRing > kMerge ? kRing : kMerge;
  static constexpr size_t kBytes =
      kMain + size_t(G) * D * sizeof(float)             // scaled q
      + size_t(kWarps) * kRows * G * sizeof(float);     // each warp's p
};

// E bf16 values (E even, 4-byte aligned) to fp32.
template <int E>
__device__ __forceinline__ void load_row(const bf16* p, float (&f)[E]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
#pragma unroll
  for (int i = 0; i < E / 2; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// PAGED: k/v are (N, bl, K, D) pools and tbl (B, nb) maps the slot's
// dense-view position j to block tbl[b, j / bl], row j % bl (seq = bl).
// Dense: k/v are (B, S, K, D); seq is S.
// ws: (B * K, splits, G, 2) floats (m, l), then (B * K, splits, G, D)
// (acc).  counters: (B * K) ints, 0 between launches.  drop_split >= 0 is a
// planted fault for the checks: that split is left out of the merge.
// PARTIAL: pout is (B, H) m, then (B, H) l, then (B, H, D) acc, fp32;
// kv_start and n_local as in the header.
template <int G, int D, bool PAGED, bool PARTIAL>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const int* __restrict__ tbl,
              const int* __restrict__ cache_len, bf16* __restrict__ out,
              float* __restrict__ pout, float* __restrict__ ws,
              int* __restrict__ counters, int seq, int nb, int K, int window,
              int split_rows, float scale, int drop_split, int kv_start,
              int n_local) {
  constexpr int C = D / 8;      // 16-byte chunks per row
  constexpr int CH = C / 2;     // chunks of K each lane of a pair reads
  constexpr int E = D / 32;     // head dims per lane in P.V
  constexpr int kStep = kWarps * kRows;
  static_assert(kRows * 2 == 32 && CH % 2 == 0, "a lane pair per row");
  using L = Smem<G, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;
  float* qs = reinterpret_cast<float*>(smem + L::kMain);   // (G, D)
  float* ps_all = qs + G * D;                              // (warp, row, G)

  const int bk = blockIdx.x;                 // slot * K + kv head
  const int split = blockIdx.y, splits = gridDim.y;
  const int b = bk / K, kvh = bk % K;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int H = K * G;
  const size_t row_stride = size_t(K) * D;

  int len, lo;
  if constexpr (PARTIAL) {
    // rows are global dense-view positions (paged) or local rows whose
    // global position is kv_start + r (dense)
    const int p = cache_len[b];
    const int base = PAGED ? 0 : kv_start;
    len = min(max(p + 1 - base, 0), PAGED ? nb * seq : seq);
    lo = max(0, (window > 0 ? p + 1 - window : 0) - base);
  } else {
    len = min(cache_len[b], PAGED ? nb * seq : seq);
    lo = window > 0 ? max(0, len - window) : 0;
  }
  const int r0 = max(split * split_rows, lo);
  const int r1 = min((split + 1) * split_rows, len);

  float* ws_ml = ws;
  float* ws_acc = ws + size_t(gridDim.x) * splits * G * 2;
  const size_t part = size_t(bk) * splits + split;

  if (r0 < r1) {
    for (int i = tid; i < G * D; i += kThreads)
      qs[i] = __bfloat162float(q[(size_t(b) * H + kvh * G) * D + i]) * scale;
    float m[G], l[G], acc[G][E];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m[g] = -INFINITY;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
    }
    bf16* ring = reinterpret_cast<bf16*>(smem) +
                 size_t(warp) * kStages * L::kStageElems;
    float* ps = ps_all + warp * kRows * G;
    const int n_it = (r1 - r0 + kStep - 1) / kStep;

    // stage step `it` of this warp's rows into ring slot it % kStages:
    // lane r < kRows resolves row r's offset (its table entry) once and
    // the warp shares it; K rows land at a padded pitch.  Always commits
    // a group, so the wait count below stays exact.
    auto issue = [&](int it) {
      if (it < n_it) {
        bf16* st = ring + (it % kStages) * L::kStageElems;
        const int j = r0 + it * kStep + warp * kRows + lane % kRows;
        int live = j < r1;
        size_t off = 0;
        if (live) {
          if (PAGED) {
            int blk = tbl[size_t(b) * nb + j / seq];
            if constexpr (PARTIAL) {
              blk -= kv_start;
              live = blk >= 0 && blk < n_local;
            } else {
              live = blk >= 0;
            }
            off = (size_t(live ? blk : 0) * seq + j % seq) * row_stride;
          } else {
            off = (size_t(b) * seq + j) * row_stride;
          }
          off += size_t(kvh) * D;
        }
#pragma unroll 4
        for (int idx = lane; idx < kRows * 2 * C; idx += 32) {
          const int r = idx / (2 * C), t = (idx / C) % 2, c = idx % C;
          const size_t o = __shfl_sync(0xffffffffu, off, r);
          const int ok = __shfl_sync(0xffffffffu, live, r);
          bf16* dst = t ? st + kRows * L::kKP + r * D + c * 8
                        : st + r * L::kKP + c * 8;
          repro::cp_async16(dst, (t ? v : k) + o + c * 8, ok != 0);
        }
      }
      repro::cp_async_commit();
    };

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) issue(s);
    __syncthreads();             // qs written
    const int pr = lane / 2, half = lane % 2;
    for (int it = 0; it < n_it; ++it) {
      issue(it + kStages - 1);
      repro::cp_async_wait<kStages - 1>();
      __syncwarp();
      const bf16* st = ring + (it % kStages) * L::kStageElems;
      bool owned = true;     // PARTIAL, paged: the row's block is this shard's
      if constexpr (PARTIAL && PAGED) {
        const int j = r0 + it * kStep + warp * kRows + pr;
        if (j < r1) {
          const int blk = tbl[size_t(b) * nb + j / seq] - kv_start;
          owned = blk >= 0 && blk < n_local;
        }
        if (!__any_sync(0xffffffffu, j < r1 && owned)) {  // nothing live
          __syncwarp();
          continue;
        }
      }

      // scores: the lane pair of row pr splits its chunks; the halves walk
      // them in orders a quarter row apart, so that a quarter warp's
      // 16-byte reads hit eight distinct bank groups
      const bf16* kr = st + pr * L::kKP;
      float s[G];
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = 0.f;
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int c = half * CH + (i + half * (CH / 2)) % CH;
        float kf[8];
        repro::bf16x8_to_float(*reinterpret_cast<const uint4*>(kr + c * 8),
                               kf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 qa = *reinterpret_cast<const float4*>(qs + g * D + c * 8);
          const float4 qb =
              *reinterpret_cast<const float4*>(qs + g * D + c * 8 + 4);
          float d = s[g];
          d = fmaf(qa.x, kf[0], d);
          d = fmaf(qa.y, kf[1], d);
          d = fmaf(qa.z, kf[2], d);
          d = fmaf(qa.w, kf[3], d);
          d = fmaf(qb.x, kf[4], d);
          d = fmaf(qb.y, kf[5], d);
          d = fmaf(qb.z, kf[6], d);
          s[g] = fmaf(qb.w, kf[7], d);
        }
      }
      const bool ok = r0 + it * kStep + warp * kRows + pr < r1 && owned;

      // online softmax over the step's rows (each row is in two lanes)
      float a[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float sg = s[g] + __shfl_xor_sync(0xffffffffu, s[g], 1);
        sg = ok ? sg : -INFINITY;
        const float mx = fmaxf(m[g], repro::warp_max(sg));
        a[g] = repro::rescale(m[g], mx);
        const float p = repro::masked_exp(sg, mx);
        l[g] = l[g] * a[g] + repro::warp_sum(half ? 0.f : p);
        m[g] = mx;
        if (half == 0) ps[pr * G + g] = p;
      }
      __syncwarp();

      // P.V: each lane owns E head dims of every query head
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] *= a[g];
      const bf16* vr = st + kRows * L::kKP + lane * E;
#pragma unroll 4
      for (int r = 0; r < kRows; ++r) {
        float vf[E];
        load_row<E>(vr + r * D, vf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float p = ps[r * G + g];
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
        }
      }
      __syncwarp();              // every lane is done with this slot and ps
    }
    repro::cp_async_wait<0>();
    __syncthreads();             // every warp is done with the ring

    // ---- merge the warps' partials into the split's, in warp order
    float* sacc = reinterpret_cast<float*>(smem);     // (warp, G, D)
    float* sml = sacc + kWarps * G * D;                // (warp, G, 2)
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        sacc[(warp * G + g) * D + lane * E + e] = acc[g][e];
      if (lane == 0) {
        sml[(warp * G + g) * 2] = m[g];
        sml[(warp * G + g) * 2 + 1] = l[g];
      }
    }
    __syncthreads();
    for (int o = tid; o < G * D; o += kThreads) {
      const int g = o / D, d = o % D;
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sml[(w * G + g) * 2]);
      float a = 0.f, lsum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float mw = sml[(w * G + g) * 2];
        if (mw != -INFINITY) {
          const float f = __expf(mw - mx);
          a = fmaf(f, sacc[(w * G + g) * D + d], a);
          lsum = fmaf(f, sml[(w * G + g) * 2 + 1], lsum);
        }
      }
      ws_acc[(part * G + g) * D + d] = a;
      if (d == 0) {
        ws_ml[(part * G + g) * 2] = mx;
        ws_ml[(part * G + g) * 2 + 1] = lsum;
      }
    }
  } else if (tid < G) {          // an empty split: merges as absent
    ws_ml[(part * G + tid) * 2] = -INFINITY;
    ws_ml[(part * G + tid) * 2 + 1] = 0.f;
  }

  // ---- the last split of this (slot, kv head) to finish merges them all
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counters + bk, 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // weights exp(m_s - m) of the splits in shared memory (free again):
  // warp w reduces heads w, w + kWarps, ..., its lanes striding over the
  // splits, so no thread walks a chain of dependent loads
  const size_t first = size_t(bk) * splits;
  float* fw = reinterpret_cast<float*>(smem);         // (splits, G)
  float* linv = fw + splits * G;                       // (G)
  float* mfin = linv + G;                              // (G), PARTIAL
  float* lfin = mfin + G;                              // (G), PARTIAL
  for (int g = warp; g < G; g += kWarps) {
    float mx = -INFINITY;
    for (int s = lane; s < splits; s += 32)
      if (s != drop_split)
        mx = fmaxf(mx, __ldcg(ws_ml + ((first + s) * G + g) * 2));
    mx = repro::warp_max(mx);
    float lsum = 0.f;
    for (int s = lane; s < splits; s += 32) {
      const float ms = __ldcg(ws_ml + ((first + s) * G + g) * 2);
      const float f =
          s == drop_split || ms == -INFINITY ? 0.f : __expf(ms - mx);
      fw[s * G + g] = f;
      if (f != 0.f)
        lsum = fmaf(f, __ldcg(ws_ml + ((first + s) * G + g) * 2 + 1), lsum);
    }
    lsum = repro::warp_sum(lsum);
    if (lane == 0) {
      linv[g] = lsum > 0.f ? 1.f / lsum : 0.f;
      if constexpr (PARTIAL) {
        mfin[g] = mx;
        lfin[g] = lsum;
      }
    }
  }
  __syncthreads();
  // each output sums its splits in split order; four loads in flight
  for (int o = tid; o < G * D; o += kThreads) {
    const int g = o / D, d = o % D;
    const float* src = ws_acc + (first * G + g) * D + d;
    float a = 0.f;
    int s = 0;
    for (; s + 4 <= splits; s += 4) {
      float t[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) t[u] = __ldcg(src + size_t(s + u) * G * D);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float f = fw[(s + u) * G + g];
        if (f != 0.f) a = fmaf(f, t[u], a);
      }
    }
    for (; s < splits; ++s) {
      const float f = fw[s * G + g];
      if (f != 0.f) a = fmaf(f, __ldcg(src + size_t(s) * G * D), a);
    }
    const size_t h = size_t(b) * H + kvh * G + g;
    if constexpr (PARTIAL) {
      const size_t BH = size_t(gridDim.x) * G;
      pout[2 * BH + h * D + d] = a;
      if (d == 0) {
        pout[h] = mfin[g];
        pout[BH + h] = lfin[g];
      }
    } else {
      out[h * D + d] = __float2bfloat16(a * linv[g]);
    }
  }
  if (tid == 0) counters[bk] = 0;
}

template <int G, int D, bool PAGED, bool PARTIAL>
int launch(const void* q, const void* k, const void* v, const int* tbl,
           const int* cache_len, void* out, void* pout, void* ws,
           void* counters, int B, int seq, int nb, int K, int window,
           int splits, int split_rows, float scale, int drop_split,
           int kv_start, int n_local, cudaStream_t stream) {
  const size_t smem = Smem<G, D>::kBytes;
  // the merge keeps one weight per (split, head) in shared memory, and
  // three more values a head
  if ((size_t(splits) + 3) * G * sizeof(float) > Smem<G, D>::kMain)
    return int(cudaErrorInvalidValue);
  auto kern = decode_kernel<G, D, PAGED, PARTIAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kern<<<dim3(B * K, splits), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), tbl, cache_len, static_cast<bf16*>(out),
      static_cast<float*>(pout), static_cast<float*>(ws),
      static_cast<int*>(counters), seq, nb, K, window, split_rows, scale,
      drop_split, kv_start, n_local);
  return int(cudaGetLastError());
}

template <bool PAGED, bool PARTIAL>
int dispatch(const void* q, const void* k, const void* v, const int* tbl,
             const int* cache_len, void* out, void* pout, void* ws,
             void* counters, int B, int H, int K, int D, int seq, int nb,
             int window, int splits, int split_rows, float scale,
             int drop_split, int kv_start, int n_local, void* stream) {
  const long capacity = PAGED ? long(nb) * seq : long(seq);
  if (B <= 0 || K <= 0 || H % K || splits <= 0 || splits > 65535 ||
      split_rows <= 0 || long(splits) * split_rows < capacity)
    return int(cudaErrorInvalidValue);
  const int G = H / K;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_DECODE_CASE(GG, DD)                                           \
  if (G == GG && D == DD)                                                   \
    return launch<GG, DD, PAGED, PARTIAL>(                                  \
        q, k, v, tbl, cache_len, out, pout, ws, counters, B, seq, nb, K,    \
        window, splits, split_rows, scale, drop_split, kv_start, n_local, s);
  REPRO_DECODE_CASE(1, 128)
  REPRO_DECODE_CASE(2, 128)
  REPRO_DECODE_CASE(4, 128)
  REPRO_DECODE_CASE(7, 128)  // deepseek-coder-33b: 56 query heads over 8
  REPRO_DECODE_CASE(8, 128)
  REPRO_DECODE_CASE(5, 64)   // hymba-1.5b: 25 query heads of 64 over 5
  REPRO_DECODE_CASE(2, 64)   // granite-moe-1b-a400m: 16 heads of 64 over 8
  REPRO_DECODE_CASE(5, 128)  // llama4-maverick: 40 heads of 128 over 8
  // a 16-wide model axis pads llama4-maverick to 48 heads over 8 and
  // hymba-1.5b to 32 of 64 over 8; the sharded decode runs every head
  REPRO_DECODE_CASE(6, 128)
  REPRO_DECODE_CASE(4, 64)
#undef REPRO_DECODE_CASE
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q (B, H, D); k_pool/v_pool (N, bl, K, D); tbl (B, nb) int32, -1 = none;
// cache_len (B,) int32; out (B, H, D).  All bf16 unless stated.  ws: fp32
// workspace of B * K * splits * G * (D + 2) floats; counters: B * K int32,
// zero, left zero.  Split s covers rows [s * split_rows, (s + 1) *
// split_rows) of each slot's dense view; splits * split_rows >= nb * bl.
// drop_split: -1, or a planted fault (that split left out of the merge).
// Returns a cudaError_t (0 = launched).
int paged_decode_attention(const void* q, const void* k_pool,
                           const void* v_pool, const void* tbl,
                           const void* cache_len, void* out, void* ws,
                           void* counters, int B, int H, int K, int D, int bl,
                           int nb, int window, int splits, int split_rows,
                           float scale, int drop_split, void* stream) {
  if (bl <= 0 || nb <= 0) return int(cudaErrorInvalidValue);
  return dispatch<true, false>(
      q, k_pool, v_pool, static_cast<const int*>(tbl),
      static_cast<const int*>(cache_len), out, nullptr, ws, counters, B, H, K,
      D, bl, nb, window, splits, split_rows, scale, drop_split, 0, 0, stream);
}

// q (B, H, D); k/v (B, S, K, D); cache_len (B,) int32; out (B, H, D); ws,
// counters, splits, split_rows and drop_split as above, with S rows.
int decode_attention(const void* q, const void* k, const void* v,
                     const void* cache_len, void* out, void* ws,
                     void* counters, int B, int S, int H, int K, int D,
                     int window, int splits, int split_rows, float scale,
                     int drop_split, void* stream) {
  if (S <= 0) return int(cudaErrorInvalidValue);
  return dispatch<false, false>(
      q, k, v, nullptr, static_cast<const int*>(cache_len), out, nullptr, ws,
      counters, B, H, K, D, S, 0, window, splits, split_rows, scale,
      drop_split, 0, 0, stream);
}

// The per-shard partials.  pos (B,) int32: each slot's global position
// (its last live row).  pout: fp32 (B, H) m, (B, H) l, (B, H, D) acc.
// Dense: k/v (B, S, K, D) are the rows [kv_start, kv_start + S) of the
// cache.  Paged: k_pool/v_pool (n_local, bl, K, D) are the blocks
// [block_start, block_start + n_local) of the pool; tbl (B, nb) holds
// global block ids.  The rest as above.
int decode_partial(const void* q, const void* k, const void* v,
                   const void* pos, void* pout, void* ws, void* counters,
                   int B, int S, int H, int K, int D, int kv_start,
                   int window, int splits, int split_rows, float scale,
                   int drop_split, void* stream) {
  if (S <= 0) return int(cudaErrorInvalidValue);
  return dispatch<false, true>(
      q, k, v, nullptr, static_cast<const int*>(pos), nullptr, pout, ws,
      counters, B, H, K, D, S, 0, window, splits, split_rows, scale,
      drop_split, kv_start, 0, stream);
}

int paged_decode_partial(const void* q, const void* k_pool,
                         const void* v_pool, const void* tbl, const void* pos,
                         void* pout, void* ws, void* counters, int B, int H,
                         int K, int D, int bl, int nb, int n_local,
                         int block_start, int window, int splits,
                         int split_rows, float scale, int drop_split,
                         void* stream) {
  if (bl <= 0 || nb <= 0 || n_local <= 0) return int(cudaErrorInvalidValue);
  return dispatch<true, true>(
      q, k_pool, v_pool, static_cast<const int*>(tbl),
      static_cast<const int*>(pos), nullptr, pout, ws, counters, B, H, K, D,
      bl, nb, window, splits, split_rows, scale, drop_split, block_start,
      n_local, stream);
}

}  // extern "C"
