// GQA flash attention, forward, with causal and sliding-window masks.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/flash_attention.py:
//   flash_attention (body _flash_kernel) and its packed-causal grid
//   _flash_causal_packed (body _flash_kernel_packed), which paired q rows i
//   and n-1-i so a rectangular TPU grid skipped the blocks above the
//   diagonal.  Here a CTA's kv loop simply stops at the tile holding its
//   last query position (and starts at the first tile inside a window),
//   and the q tiles with the most kv tiles are launched first, so the last
//   wave is short: the same work, the same output.
//
// What bounds it on the H100: operations.  Prefill does 4*D multiply-adds
// per (query, key) pair against 2*D bytes per key read, far above the
// card's ~295 FLOP/byte balance, so both products run on wgmma (bf16 in,
// fp32 accumulate), fed by TMA (csrc/hopper.cuh):
//   * one CTA per (batch x kv head, q tile).  The tile's rows are
//     (position, head) pairs: BQ = rows/G whole positions times the G = H/K
//     query heads that share a kv head, so every K/V tile in shared memory
//     serves all G heads.  A 4-D TMA box (64 of D, G heads, BQ positions)
//     over q (B, S, H, D) lands in exactly that row order; D = 128 is two
//     64-wide, 128-byte-swizzled boxes, each on the rows-row stride so it
//     starts on a 1024-byte swizzle atom, and D = 64 is one box: a row of
//     64 bf16 is one 128-byte swizzle row;
//   * a group that divides no tile (G = 7: 18 positions = 126 of 128 rows;
//     G = 5: 25 positions = 125 of 128, 12 = 60 of 64; G = 3: 42 = 126 of
//     128, 21 = 63 of 64) leaves rows - BQ*G
//     pad rows at the bottom of the tile.  The Q barrier
//     expects the bytes the boxes deliver (BQ*G rows, not rows), the pad
//     rows are zeroed once before the first product (their scores stay in
//     their own rows, so they touch no real row) and the epilogue never
//     writes them: pad row r maps to position q0 + BQ, the next CTA's;
//   * one producer warpgroup, of which one thread issues every copy: Q
//     once, then K and V tiles into a ring of two stages, each on its own
//     "full" mbarrier, a stage refilled only after every consumer thread
//     has arrived on its "empty" mbarrier.  With two consumer warpgroups it
//     gives its registers to them (setmaxnreg 24 / 240);
//   * each consumer warpgroup owns 64 rows.  S = Q K^T is wgmma SS
//     m64n{block_kv}k16 (both operands K-major in shared memory), the fp32
//     scores in registers.  The online softmax runs in registers: a row
//     lives in a quad of lanes (two shfl_xor), its running max and sum in
//     registers, exp2 of scores pre-scaled by log2(e)/sqrt(D).  Masks
//     (causal, window, the S edge) are applied only on the tiles that
//     straddle a boundary; tiles wholly above the diagonal or outside the
//     window are never loaded;
//   * O += P V is wgmma RS m64n{D}k16: P rounded to bf16 in registers is
//     the A operand as it stands (the accumulator layout is the A fragment
//     layout), V (block_kv, D) the MN-major B in its transposed form.  O
//     stays in registers for the whole kv loop: S, P and O never touch
//     shared memory;
//   * ragged S: TMA zero-fills rows past S, keys past S are masked, and
//     query rows past S are never written (the Pallas kernel asserted
//     S % block == 0);
//   * a query block at an offset: q may hold Sq <= Skv rows, the last Sq
//     positions of the key stream (a prompt's tail prefilled over a resident
//     prefix).  Row i sits at absolute position q_off + i; the kv range,
//     the edge-tile test and the masks all compare absolute positions, so
//     Sq == Skv (q_off = 0) is the whole-prompt launch;
//   * the log-sum-exp for the backward (csrc/flash_attention_bwd.cu): with
//     a non-null lse pointer the epilogue also writes each row's
//     m + log(l) of the scaled scores, fp32 (B, H, Sq), natural log (+inf
//     for a row with no live key, so the backward's P is 0 there).  The
//     serve path passes null and does no extra work.
//   * head_dim 80 (hubert-xlarge): a row of 80 bf16 is 160 bytes, not a
//     whole number of 128-byte swizzle atoms.  The kernel pads it to two
//     atoms in shared memory: the tensor maps keep D = 80 as the tensor's
//     own innermost extent (a 160-byte row stride, a multiple of 16 as TMA
//     asks), the second 64-wide box starts at column 64 and TMA zero-fills
//     its columns 80..127 (the barrier is credited with the whole box).
//     The products then run at the padded width of 128, where the zero
//     columns add nothing to Q K^T and give zero columns of P V, and the
//     epilogue writes the 80 real columns.  1.6x the multiply-adds of an
//     exact fit, for one code path: the template's D is the row's width,
//     its padded width kD the products' (a 64 + 16 split with a 32-byte
//     swizzled box would do no extra work, later work if it is the limit);
//   * masks by positions (the POS instances, head_dim 128: qwen2-vl-72b,
//     whose M-RoPE temporal stream gives every patch of an image one id):
//     an int32 (B, Skv) positions operand, query row i at pos[q_off + i],
//     rows in any order.  A prep pass (csrc/positions.cuh) writes each Q
//     tile's and each key tile's [min, max] position; a CTA walks every key
//     tile and loads only those where a pair can be live, and masks element
//     by element (kpos <= qpos, qpos - kpos < window, the S edge by index)
//     only on a tile not every pair of which is live.  Positions 0..S-1
//     give the index path's tiles, masks and so its output, bitwise; the
//     index instances (POS false) are the code they were;
// Tiles (rows, block_kv) in {(64, 64), (64, 128), (128, 64), (128, 128)}
// (rows = 64 per consumer warpgroup), head_dim a template parameter
// instantiated at 64 (hymba-1.5b), 80 (hubert-xlarge, padded to 128) and
// 128; a tile holds at least one whole GQA group.  The wrapper admits G in
// {1, 2, 3, 4, 5, 7, 8, 16} and raises on anything else.  Shared memory at
// (128, 128): Q 32 KB + 2 stages x (K + V) 128 KB = 160 KB at D = 128 and
// at D = 80 (padded), half that at D = 64; one CTA an SM.
// Not done yet (later work): overlapping one tile's softmax with the next
// tile's S product (in a warpgroup or ping-pong across the two), a
// TMA-store epilogue, a persistent grid.

#include <chrono>

#include "common.cuh"
#include "hopper.cuh"
#include "positions.cuh"

using repro::bf16;
namespace sm90 = repro::sm90;

namespace {

constexpr int kStages = 2;

// head_dim padded to whole 128-byte swizzle atoms of bf16 (64 columns)
template <int D>
__host__ __device__ constexpr int padded_dim() {
  return (D + 63) / 64 * 64;
}

template <int D, int BKV, int NWG>
struct Smem {
  static constexpr int kRows = NWG * 64;
  static constexpr int kQ = kRows * D * 2;   // bytes of the Q tile
  static constexpr int kKV = BKV * D * 2;    // bytes of one K or V tile
  static constexpr int kStage = 2 * kKV;     // K then V
  static constexpr int kBars = (1 + 3 * kStages) * 8;
  // + 1024: the dynamic shared memory is re-aligned to a swizzle atom
  static constexpr size_t kBytes =
      size_t(kQ) + size_t(kStages) * kStage + kBars + 1024;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// qpos is the query's absolute position in the key stream (row + q_off)
__device__ __forceinline__ bool key_ok(int kpos, int qpos, int Skv,
                                       int causal, int window) {
  return kpos < Skv && (!causal || kpos <= qpos) &&
         (window <= 0 || qpos - kpos < window);
}

// POS: mask by positions (csrc/positions.cuh): pos (B, Skv) int32, query
// row i at pos[q_off + i]; ranges holds the [min, max] of each Q tile's
// positions (B, n_qt), then of each key tile's (B, n_kt).  A key tile no
// pair of which can be live is skipped, one every pair of which is live is
// not masked element by element.  Without POS both are null and unread.
template <int D, int BKV, int NWG, bool POS>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 bf16* __restrict__ out, float* __restrict__ lse,
                 const int* __restrict__ pos,
                 const int2* __restrict__ ranges, int Sq,
                 int Skv, int q_off, int H, int K, int causal, int window,
                 float scale_log2, int pad_fault) {
  constexpr int kD = padded_dim<D>();  // the products' width
  using L = Smem<kD, BKV, NWG>;
  constexpr int kRows = L::kRows;
  constexpr int kAtoms = kD / 64;  // 128-byte swizzle atoms along D
  static_assert(D % 8 == 0 && (kD == 64 || kD == 128),
                "head_dim is padded to one or two swizzle atoms");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = smem;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + L::kQ + kStages * L::kStage);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int G = H / K;
  const int BQ = kRows / G;       // whole query positions per CTA
  const int q_rows = BQ * G;      // rows the Q boxes deliver; the rest pad
  const int b = blockIdx.x / K, kvh = blockIdx.x % K;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest rows first
  // query row i sits at absolute position q_off + i of the key stream (the
  // wrapper passes q_off = Skv - Sq: the queries are its last Sq positions)
  const int p0 = q_off + q0;
  const int p_last = q_off + min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? p_last + 1 : Skv;
  const int kv_begin = window > 0 ? max(0, p0 - window + 1) : 0;
  const int t_begin = kv_begin / BKV;
  int n_tiles = (kv_end + BKV - 1) / BKV - t_begin;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  // POS: this tile's range of query positions and the key tiles' ranges;
  // the live key tiles, in order, replace [t_begin, t_begin + n_tiles)
  const int n_kt = (Skv + BKV - 1) / BKV;
  int2 q_rng = make_int2(0, 0);
  const int2* k_rng = nullptr;
  if constexpr (POS) {
    const int B = gridDim.x / K;
    q_rng = ranges[b * gridDim.y + q0 / BQ];
    k_rng = ranges + size_t(B) * gridDim.y + size_t(b) * n_kt;
    n_tiles = 0;
    for (int t = 0; t < n_kt; ++t)
      n_tiles += repro::range_live(q_rng, k_rng[t], causal, window);
  }

  // pad rows (q_rows..kRows-1 of each 64-wide Q atom) start zeroed: the
  // boxes never write them (a 128-byte swizzle permutes chunks within a
  // row, so a row's 128 bytes stay at r * 128)
  for (int i = threadIdx.x; i < (kRows - q_rows) * kAtoms * 8;
       i += blockDim.x) {
    const int a = i / ((kRows - q_rows) * 8), j = i % ((kRows - q_rows) * 8);
    reinterpret_cast<uint4*>(q_s + a * kRows * 128 + q_rows * 128)[j] =
        make_uint4(0, 0, 0, 0);
  }
  sm90::fence_proxy_async_shared();
  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&empty[s], NWG * 128);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == NWG) {
    // ---- producer: Q once, then the K/V ring
    if constexpr (NWG == 2) sm90::setmaxnreg_dec<24>();
    if (tid == 0) {
      // the bytes the boxes deliver: BQ*G rows of kD (a zero-filled
      // column is credited like a loaded one), not kRows
      sm90::mbar_expect_tx(q_full, q_rows * kD * 2);
#pragma unroll
      for (int a = 0; a < kAtoms; ++a)
        sm90::tma_load_4d(q_s + a * kRows * 128, &map_q, q_full, a * 64,
                          kvh * G, q0, b);
      int t_pos = -1;  // POS: the key tile of item i
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        int kv0;
        if constexpr (POS) {
          do ++t_pos;
          while (!repro::range_live(q_rng, k_rng[t_pos], causal, window));
          kv0 = t_pos * BKV;
        } else {
          kv0 = (t_begin + i) * BKV;
        }
        unsigned char* k_s = smem + L::kQ + s * L::kStage;
        unsigned char* v_s = k_s + L::kKV;
        sm90::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        sm90::mbar_expect_tx(&k_full[s], L::kKV);
#pragma unroll
        for (int a = 0; a < kAtoms; ++a)
          sm90::tma_load_4d(k_s + a * BKV * 128, &map_k, &k_full[s], a * 64,
                            kvh, kv0, b);
        sm90::mbar_expect_tx(&v_full[s], L::kKV);
#pragma unroll
        for (int a = 0; a < kAtoms; ++a)
          sm90::tma_load_4d(v_s + a * BKV * 128, &map_v, &v_full[s], a * 64,
                            kvh, kv0, b);
      }
    }
    return;
  }

  // ---- consumers: 64 rows each; this thread holds rows r and r + 8
  if constexpr (NWG == 2) sm90::setmaxnreg_inc<240>();
  const int warp = tid / 32, lane = tid % 32;
  const int r_lo = wg * 64 + warp * 16 + lane / 4, r_hi = r_lo + 8;
  // a pad row (r >= q_rows) takes the row index Sq, which the epilogue
  // skips: it would land on the next CTA's first position (no register
  // stays live through the kv loop for it)
  const int qrow_lo = r_lo < q_rows ? q0 + r_lo / G : Sq;
  const int qrow_hi = r_hi < q_rows ? q0 + r_hi / G : Sq;
  // POS: a real row's position from pos; a pad row's is never used
  const int* kp = POS ? pos + size_t(b) * Skv : nullptr;
  const int qpos_lo = POS ? (qrow_lo < Sq ? kp[q_off + qrow_lo] : 0)
                          : q_off + qrow_lo;
  const int qpos_hi = POS ? (qrow_hi < Sq ? kp[q_off + qrow_hi] : 0)
                          : q_off + qrow_hi;
  float o[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  const unsigned char* q_wg = q_s + wg * 64 * 128;
  sm90::mbar_wait(q_full, 0);

  int t_pos = -1;  // POS: the key tile of item i
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const uint32_t phase = (i / kStages) & 1;
    int kv0;
    bool pos_masked = false;  // POS: the tile is not wholly live
    if constexpr (POS) {
      do ++t_pos;
      while (!repro::range_live(q_rng, k_rng[t_pos], causal, window));
      kv0 = t_pos * BKV;
      pos_masked = kv0 + BKV > Skv ||
                   !repro::range_full(q_rng, k_rng[t_pos], causal, window);
    } else {
      kv0 = (t_begin + i) * BKV;
    }
    const unsigned char* k_s = smem + L::kQ + s * L::kStage;
    const unsigned char* v_s = k_s + L::kKV;

    // S = Q K^T, fp32 in registers
    float sc[BKV / 2];
    sm90::mbar_wait(&k_full[s], phase);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint64_t da = sm90::desc_sw128(
          q_wg + (kk / 4) * kRows * 128 + (kk % 4) * 32, 16, 1024);
      const uint64_t db = sm90::desc_sw128(
          k_s + (kk / 4) * BKV * 128 + (kk % 4) * 32, 16, 1024);
      sm90::wgmma_ss<BKV, 0>(sc, da, db, kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);

    // masks, only on a tile that straddles a boundary
    if (POS ? pos_masked
            : (kv0 + BKV > Skv || (causal && kv0 + BKV - 1 > p0) ||
               (window > 0 && p_last - kv0 >= window))) {
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kidx = kv0 + 8 * j + 2 * (lane % 4) + e;
          bool ok_lo, ok_hi;
          if constexpr (POS) {
            const int kpos = kidx < Skv ? kp[kidx] : 0;
            ok_lo = kidx < Skv && repro::pos_ok(kpos, qpos_lo, causal, window);
            ok_hi = kidx < Skv && repro::pos_ok(kpos, qpos_hi, causal, window);
          } else {
            ok_lo = key_ok(kidx, qpos_lo, Skv, causal, window);
            ok_hi = key_ok(kidx, qpos_hi, Skv, causal, window);
          }
          if (!ok_lo) sc[4 * j + e] = -INFINITY;
          if (!ok_hi) sc[4 * j + 2 + e] = -INFINITY;
        }
    }

    // online softmax: row max over the quad, rescale, exponentiate
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      mx_lo = fmaxf(mx_lo, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    const float new_lo = fmaxf(m_lo, quad_max(mx_lo) * scale_log2);
    const float new_hi = fmaxf(m_hi, quad_max(mx_hi) * scale_log2);
    // no live key yet: subtract 0, so exp2(-inf) = 0 and nothing is NaN
    const float base_lo = new_lo == -INFINITY ? 0.f : new_lo;
    const float base_hi = new_hi == -INFINITY ? 0.f : new_hi;
    const float alpha_lo = ex2(m_lo - base_lo);
    const float alpha_hi = ex2(m_hi - base_hi);
    m_lo = new_lo;
    m_hi = new_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], scale_log2, -base_lo));
        sc[4 * j + 2 + e] =
            ex2(fmaf(sc[4 * j + 2 + e], scale_log2, -base_hi));
        sum_lo += sc[4 * j + e];
        sum_hi += sc[4 * j + 2 + e];
      }
    l_lo = l_lo * alpha_lo + sum_lo;
    l_hi = l_hi * alpha_hi + sum_hi;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      o[4 * j] *= alpha_lo;
      o[4 * j + 1] *= alpha_lo;
      o[4 * j + 2] *= alpha_hi;
      o[4 * j + 3] *= alpha_hi;
    }
    // P in bf16 as the A operand: k16 slice kk is accumulator blocks 2 kk
    // (registers 8 kk .. + 3) and 2 kk + 1 (8 kk + 4 .. + 7)
    uint32_t pa[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = sm90::pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

    // O += P V
    sm90::mbar_wait(&v_full[s], phase);
    sm90::fence_regs(o);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint64_t db =
          sm90::desc_sw128(v_s + kk * 2048, BKV * 128, 1024);
      sm90::wgmma_rs<kD, 1>(o, pa[kk], db, 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
    sm90::mbar_arrive(&empty[s]);
  }

  // ---- epilogue: normalise, write query rows < Sq (never a pad row: its
  // qrow is Sq, unless pad_fault plants the fault the checks must catch:
  // pad rows written over the next CTA's first position, pad row i on its
  // head i, which that CTA then leaves to them, so what lands there does
  // not depend on which of the two CTAs writes last)
  const float lsum_lo = quad_sum(l_lo), lsum_hi = quad_sum(l_hi);
  const float inv_lo = lsum_lo > 0.f ? 1.f / lsum_lo : 0.f;
  const float inv_hi = lsum_hi > 0.f ? 1.f / lsum_hi : 0.f;
  const int b_row = b * Sq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? r_hi : r_lo;
    const int qrow = pad_fault && r >= q_rows ? q0 + BQ
                                              : (h ? qrow_hi : qrow_lo);
    const float inv = h ? inv_hi : inv_lo;
    if (qrow >= Sq || (pad_fault && q0 > 0 && r < kRows - q_rows)) continue;
    if (lse != nullptr && r < q_rows && lane % 4 == 0) {
      // m is in log2 units of the scaled score: lse = (m + log2 l) ln 2
      const float m = h ? m_hi : m_lo, l = h ? lsum_hi : lsum_lo;
      lse[(size_t(b) * H + kvh * G + r % G) * Sq + qrow] =
          l > 0.f ? (m + log2f(l)) * 0.6931471805599453f : INFINITY;
    }
    bf16* dst = out + (size_t(b_row + qrow) * H + kvh * G + r % G) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)  // the real columns only
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + 2 * (lane % 4)) =
          __floats2bfloat162_rn(o[4 * j + 2 * h] * inv,
                                o[4 * j + 2 * h + 1] * inv);
  }
}

// The three maps of a launch: q (B, Sq, H, D) in boxes of (64, G, rows/G,
// 1), k and v (B, Skv, K, D) in boxes of (64, 1, block_kv, 1).
int encode_maps(CUtensorMap* mq, CUtensorMap* mk, CUtensorMap* mv,
                const void* q, const void* k, const void* v, int B, int Sq,
                int Skv, int H, int K, int D, int rows, int block_kv) {
  const int G = H / K;
  const cuuint64_t dq[4] = {cuuint64_t(D), cuuint64_t(H), cuuint64_t(Sq),
                            cuuint64_t(B)};
  const cuuint64_t sq[3] = {cuuint64_t(D) * 2, cuuint64_t(H) * D * 2,
                            cuuint64_t(Sq) * H * D * 2};
  const cuuint32_t bq[4] = {64, cuuint32_t(G), cuuint32_t(rows / G), 1};
  int err = sm90::encode_bf16_sw128(mq, q, 4, dq, sq, bq);
  if (err) return err;
  const cuuint64_t dk[4] = {cuuint64_t(D), cuuint64_t(K), cuuint64_t(Skv),
                            cuuint64_t(B)};
  const cuuint64_t sk[3] = {cuuint64_t(D) * 2, cuuint64_t(K) * D * 2,
                            cuuint64_t(Skv) * K * D * 2};
  const cuuint32_t bk[4] = {64, 1, cuuint32_t(block_kv), 1};
  err = sm90::encode_bf16_sw128(mk, k, 4, dk, sk, bk);
  if (err) return err;
  return sm90::encode_bf16_sw128(mv, v, 4, dk, sk, bk);
}

template <int D, int BKV, int NWG, bool POS>
int launch(const void* q, const void* k, const void* v, void* out,
           void* lse, const void* pos, void* ranges, int B, int Sq, int Skv,
           int q_off, int H, int K, int causal, int window, float scale,
           int pad_fault, cudaStream_t stream) {
  constexpr int kRows = NWG * 64;
  CUtensorMap mq, mk, mv;
  int err = encode_maps(&mq, &mk, &mv, q, k, v, B, Sq, Skv, H, K, D, kRows,
                        BKV);
  if (err) return err;
  const size_t smem = Smem<padded_dim<D>(), BKV, NWG>::kBytes;
  auto kern = flash_fwd_kernel<D, BKV, NWG, POS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  const int BQ = kRows / (H / K);
  const int q_tiles = (Sq + BQ - 1) / BQ;
  if (q_tiles > 65535) return int(cudaErrorInvalidValue);
  if constexpr (POS) {
    // the Q tiles' ranges (from q_off), then the key tiles'
    const int* p = static_cast<const int*>(pos);
    int2* r = static_cast<int2*>(ranges);
    e = repro::launch_ranges(p, B, Skv, q_off, Sq, BQ, r, stream);
    if (e == cudaSuccess)
      e = repro::launch_ranges(p, B, Skv, 0, Skv, BKV,
                               r + size_t(B) * q_tiles, stream);
    if (e != cudaSuccess) return int(e);
  }
  const float kLog2e = 1.4426950408889634f;
  kern<<<dim3(B * K, q_tiles), (NWG + 1) * 128, smem, stream>>>(
      mq, mk, mv, static_cast<bf16*>(out), static_cast<float*>(lse),
      static_cast<const int*>(pos), static_cast<const int2*>(ranges), Sq,
      Skv, q_off, H, K, causal, window, scale * kLog2e, pad_fault);
  return int(cudaGetLastError());
}

bool takes(const void* q, const void* k, const void* v, const void* out,
           int Sq, int Skv, int q_off, int H, int K, int D, int rows) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(out);
  return (D == 64 || D == 80 || D == 128) && K > 0 && H % K == 0 && H / K <= rows &&
         Sq > 0 && Skv >= Sq && q_off >= 0 && q_off <= Skv - Sq &&
         ptrs % 16 == 0;
}

}  // namespace

extern "C" {

// q (B, Sq, H, D), k/v (B, Skv, K, D), out (B, Sq, H, D), all bf16,
// contiguous and 16-byte aligned, D in {64, 80, 128}, Sq <= Skv, G = H / K <=
// rows.  Query row i sits at absolute position q_off + i of the key stream (the wrapper passes Skv - Sq: the
// queries are the stream's last Sq positions; q_off = 0 with Sq == Skv is
// a whole prompt).  rows = query rows per CTA (64 or 128; it holds rows / G
// whole positions, and the rows past them are pad), block_kv =
// K/V rows per tile.  pad_fault: 0, or a planted fault for the checks (the
// pad rows written over the next CTA's first position, in place of that
// CTA's own rows there).  lse: null, or fp32 (B, H, Sq) for each row's
// log-sum-exp of the scaled scores (the backward's input).  pos: null (the
// mask by index), or int32 (B, Skv) positions to mask by (query row i at
// pos[q_off + i]; head_dim 128 only) with ranges, an int2 workspace of
// B * (ceil(Sq / (rows / G)) + ceil(Skv / block_kv)) entries, 8-byte
// aligned.  Returns 0 when launched, a cudaError_t, or a negative CUresult
// of the tensor-map encoder.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, void* lse, const void* pos, void* ranges,
                        int B, int Sq, int Skv, int q_off, int H, int K,
                        int D, int causal, int window, int rows,
                        int block_kv, float scale, int pad_fault,
                        void* stream) {
  if (!takes(q, k, v, out, Sq, Skv, q_off, H, K, D, rows) ||
      (pos != nullptr && (ranges == nullptr ||
                          reinterpret_cast<uintptr_t>(ranges) % 8 != 0)))
    return int(cudaErrorInvalidValue);
  // cuTensorMapEncodeTiled needs a current context, which a
  // thread that has made no runtime call yet (autograd's device thread,
  // recomputing a forward under remat) may not have
  const cudaError_t e = cudaFree(nullptr);
  if (e != cudaSuccess) return int(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_CASE(DD, ROWS, BKV)                                     \
  if (D == DD && rows == ROWS && block_kv == BKV && pos == nullptr)         \
    return launch<DD, BKV, ROWS / 64, false>(q, k, v, out, lse, pos, ranges, \
                                             B, Sq, Skv, q_off, H, K, causal, \
                                             window, scale, pad_fault, s);
// the positions variant, at head_dim 128 (qwen2-vl-72b's M-RoPE)
#define REPRO_FLASH_POS_CASE(DD, ROWS, BKV)                                 \
  if (D == DD && rows == ROWS && block_kv == BKV && pos != nullptr)         \
    return launch<DD, BKV, ROWS / 64, true>(q, k, v, out, lse, pos, ranges, \
                                            B, Sq, Skv, q_off, H, K, causal, \
                                            window, scale, pad_fault, s);
  REPRO_FLASH_POS_CASE(128, 64, 64)
  REPRO_FLASH_POS_CASE(128, 64, 128)
  REPRO_FLASH_POS_CASE(128, 128, 64)
  REPRO_FLASH_POS_CASE(128, 128, 128)
#undef REPRO_FLASH_POS_CASE
  REPRO_FLASH_CASE(128, 64, 64)
  REPRO_FLASH_CASE(128, 64, 128)
  REPRO_FLASH_CASE(128, 128, 64)
  REPRO_FLASH_CASE(128, 128, 128)
  REPRO_FLASH_CASE(64, 64, 64)    // hymba-1.5b: 25 / 5 heads of 64
  REPRO_FLASH_CASE(64, 64, 128)
  REPRO_FLASH_CASE(64, 128, 64)
  REPRO_FLASH_CASE(64, 128, 128)
  REPRO_FLASH_CASE(80, 64, 64)    // hubert-xlarge: 16 / 16 heads of 80
  REPRO_FLASH_CASE(80, 64, 128)
  REPRO_FLASH_CASE(80, 128, 64)
  REPRO_FLASH_CASE(80, 128, 128)
#undef REPRO_FLASH_CASE
  return int(cudaErrorInvalidValue);
}

// Host microseconds to encode the three tensor maps of one launch, the mean
// of `iters` encodings (no launch); negative on an encoder error.
double flash_attention_map_encode_us(const void* q, const void* k,
                                     const void* v, int B, int S, int H,
                                     int K, int D, int rows, int block_kv,
                                     int iters) {
  CUtensorMap mq, mk, mv;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i) {
    const int err =
        encode_maps(&mq, &mk, &mv, q, k, v, B, S, S, H, K, D, rows, block_kv);
    if (err) return double(err);
  }
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::micro>(t1 - t0).count() /
         (iters > 0 ? iters : 1);
}

}  // extern "C"
