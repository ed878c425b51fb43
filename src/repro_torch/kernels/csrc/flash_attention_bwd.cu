// GQA flash attention, backward (FlashAttention-2's arithmetic), with causal
// and sliding-window masks, on wgmma fed by TMA.
//
// Replaces no Pallas kernel: the JAX package trains through
// attention_chunked (src/repro/models/attention.py:74), the XLA mirror of
// its flash kernel, and differentiates it with jax.value_and_grad
// (src/repro/core/passes/lowering.py:353-387).  The port's training
// forward is the hand-written flash kernel (csrc/flash_attention.cu), so
// its gradient is a hand-written kernel too.
//
// From q, k, v, the forward's output o, its log-sum-exp lse (fp32
// (B, H, Sq), natural log of the scaled scores) and dO it computes, with
// P recomputed in fp32 from the scores and lse:
//   Delta = rowsum(dO o O)
//   dP = dO V^T,  dS = P o (dP - Delta)
//   dK = scale dS^T Q,  dV = P^T dO,  dQ = scale dS K
// dK and dV of a kv head sum the G query heads that share it.
//
// What bounds it on the H100: operations.  Five products of the scores'
// size (S, dP, dV, dK, dQ: 2.5x the forward's multiply-adds; S and dP are
// computed twice, once in each of the two main kernels, seven in all)
// against reads of q, k, v, o, dO: far above the card's ~295 FLOP/byte
// balance.  So every product is wgmma (bf16 in, fp32 accumulate) from tiles
// that TMA brings into shared memory (csrc/hopper.cuh), as in the forward.
// Three launches:
//   * prep: one warp a row computes Delta into (B, H, Sq) for the dQ kernel
//     and fills the dK/dV kernel's row table: for each (b, kv head, Q tile)
//     the 64 rows' log-sum-exp (times log2 e) and Delta in the tile's row
//     order, +inf and 0 on pad rows and rows past Sq, so the dK/dV kernel
//     fetches a tile's 512 bytes with one bulk copy beside the tile's TMA
//     boxes instead of gathering them;
//   * dK/dV: keys are wgmma's 64-row side.  A CTA is one producer warpgroup
//     (one thread issues every copy) and two consumer warpgroups that own
//     the same 64 keys: K and V stay in shared memory for the job, and Q /
//     dO tiles of 64 rows stream through a ring of four stages.  Rows are
//     (position, head) pairs, the forward's 4-D box (64 of D, G heads, 64/G
//     positions), so one tile serves all G heads of the kv head: the sum
//     over the group is the sum over the tile's rows.  Per Q tile
//       S^T = K Q^T, dP^T = V dO^T    wgmma SS m64n64k16 (both K-major),
//           two groups, so P^T's arithmetic overlaps the dP^T product,
//       P^T, dS^T in fp32 registers, from the row table in shared memory,
//       dV += P^T dO and dK += dS^T Q   wgmma RS m64n{D}k16: P^T and dS^T
//           rounded to bf16 are A fragments as they stand, dO and Q the
//           MN-major B (as the forward's V in P V);
//     dK and dV stay in fp32 registers for the whole job (64 + 64 a thread
//     at D = 128; setmaxnreg gives the consumers 240).  At D = 128 that
//     is tight: ptxas spills some registers and serialises the wgmma
//     (C7512); an order with S^T and dP^T never live together spilled
//     more and ran slower.  The descriptors are built where each wgmma
//     issues (opaque bases), or the compiler hoists one 64-bit descriptor
//     a k-step out of the loop.  The two warpgroups
//     take the job's Q tiles alternately, so each holds a partial sum;
//     at the end warpgroup 1 hands its partials through the K/V tiles'
//     shared memory (both are done with them) and warpgroup 0 adds them
//     to its own, in that fixed order, and writes: no atomics, the output
//     is bitwise the same on every call;
//   * causal balance: key tile j sees the queries from its own position on,
//     so its work falls linearly with j.  A causal CTA without a window
//     takes two jobs, key tiles c and n - 1 - c (the pairing of the TPU's
//     packed causal grid, src/repro/kernels/flash_attention.py:118-181):
//     every CTA does the same work, n/2 CTAs per (b, kv head), one wave
//     (128 CTAs at the train shape on 132 SMs).  A window or causal=False
//     takes one key tile a CTA;
//   * dQ: the forward's skeleton plus one product.  A CTA holds 128 query
//     rows (two consumer warpgroups of 64) with their Q and dO tiles, and
//     streams 64-key K and V tiles through a ring of two stages.  Per tile
//       S = Q K^T and dP = dO V^T        wgmma SS m64n64k16,
//       dS = P o (dP - Delta) in registers (P from the row's lse),
//       dQ += dS K                       wgmma RS m64n{D}k16, K MN-major;
//     dQ stays in registers across the kv loop; longest query tiles first.
// Masks are the forward's (key_ok: the S edge, causal bottom-right
// alignment at q_off, the window), applied only on tiles that straddle a
// boundary.  Ragged S: TMA zero-fills rows past S; a zero-filled query row
// has lse +inf in the tables (P = 0), a zero-filled key is masked in dQ
// and its dK/dV rows are never written.  Sq <= Skv with q_off = Skv - Sq.
// Group pad rows (G = 3, 5, 7: 63, 60 or 63 of 64 rows) are zeroed once in
// every ring stage and have lse +inf.  head_dim 64, 80 and 128; any G up to
// 64.
// head_dim 80 (hubert-xlarge) runs as the forward runs it
// (csrc/flash_attention.cu): the tensor maps keep the 160-byte rows, the
// box at column 64 comes back with columns 80..127 zero-filled by TMA, the
// products run at the padded 128 (zero columns add nothing to S or dP and
// give zero columns of dQ, dK and dV) and the epilogues write the 80 real
// columns.  causal=False (the encoder) takes one key tile a CTA: every key
// tile sees every query, so there is no work to balance by pairing.
// Masks by positions (the POS instances, head_dim 128, as the forward's):
// an int32 (B, Skv) positions operand, query row i at pos[q_off + i].  The
// prep launches of csrc/positions.cuh write the [min, max] position of each
// dK/dV Q tile (64 / G positions), each dQ Q tile (128 / G) and each key
// tile (64); a dK/dV job walks every Q tile and takes those where a pair
// with its keys can be live (the causal pairing of key tiles c and n-1-c
// stays: each job's Q tiles come from positions), the dQ loop every key
// tile likewise, and the element masks compare positions only on a pair of
// tiles not every pair of which is live.  Positions 0..S-1 give the index
// path's tiles and masks, so its output, bitwise.
// Planted faults for the checks: drop_tile skips each dK/dV job's first Q
// tile; group_fault gives every head but a group's first lse +inf in the
// dK/dV row table (only the first head summed into dK/dV).
// Not done yet (later work): overlapping one tile's element-wise step with
// the next tile's products, a persistent grid, folding Delta into a
// kernel's prologue.

#include "common.cuh"
#include "hopper.cuh"
#include "positions.cuh"

using repro::bf16;
namespace sm90 = repro::sm90;

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kKeys = 64;       // keys a dK/dV job; keys a step of the dQ loop
constexpr int kRowsKV = 64;     // Q-tile rows a step of the dK/dV loop
constexpr int kStagesKV = 4;    // Q / dO ring of the dK/dV kernel
constexpr int kRowsQ = 128;     // query rows a dQ CTA
constexpr int kStagesQ = 2;     // K / V ring of the dQ kernel
constexpr int kThreads = 384;   // producer + two consumer warpgroups

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// qpos is the query's absolute position in the key stream (row + q_off)
__device__ __forceinline__ bool key_ok(int kpos, int qpos, int Skv,
                                       int causal, int window) {
  return kpos < Skv && (!causal || kpos <= qpos) &&
         (window <= 0 || qpos - kpos < window);
}

// A tile's shared-memory address, opaque to the compiler: the loops take
// their tiles' bases through it each iteration, so each k-step's wgmma
// descriptor is built where the wgmma issues instead of hoisted out of the
// loop (one 64-bit descriptor a k-step, all held in registers).
__device__ __forceinline__ uint32_t opaque(const void* p) {
  uint32_t a = sm90::smem_u32(p);
  asm volatile("" : "+r"(a));
  return a;
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// The pad rows (q_rows..rows-1 of each 64-wide atom) of a tile the boxes
// never write: zeroed once, then left alone (a 128-byte swizzle permutes
// chunks within a row, so a row's 128 bytes stay at r * 128).
__device__ __forceinline__ void zero_pad_rows(unsigned char* tile, int rows,
                                              int q_rows, int atoms) {
  const int n = (rows - q_rows) * 8;  // 16-byte chunks of one atom's pad
  for (int i = threadIdx.x; i < n * atoms; i += blockDim.x)
    reinterpret_cast<uint4*>(tile + (i / n) * rows * 128 +
                             q_rows * 128)[i % n] = make_uint4(0, 0, 0, 0);
}

// ---- pass 1: Delta and the dK/dV row table -----------------------------
// One warp a slot of the table, (b, kv head, Q tile, row); a real row also
// writes its Delta into (B, H, Sq).
// head_dim padded to whole 128-byte swizzle atoms of bf16 (64 columns)
template <int D>
__host__ __device__ constexpr int padded_dim() {
  return (D + 63) / 64 * 64;
}

template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_prep(const bf16* __restrict__ o, const bf16* __restrict__ dout,
               const float* __restrict__ lse, float* __restrict__ delta,
               float* __restrict__ table, int B, int Sq, int H, int K,
               int n_t, int group_fault) {
  const long long slot = blockIdx.x * 8ll + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (slot >= (long long)B * K * n_t * kRowsKV) return;
  const int G = H / K, BQ = kRowsKV / G;
  const int r = int(slot % kRowsKV);
  const long long tile = slot / kRowsKV;  // ((b * K + kvh) * n_t + t)
  const int t = int(tile % n_t), bk = int(tile / n_t);
  const int b = bk / K, kvh = bk % K;
  const int qi = t * BQ + r / G, h = kvh * G + r % G;
  float* row = table + tile * 2 * kRowsKV;
  if (r >= BQ * G || qi >= Sq) {
    if (lane == 0) {
      row[r] = INFINITY;
      row[kRowsKV + r] = 0.f;
    }
    return;
  }
  const size_t at = ((size_t(b) * Sq + qi) * H + h) * D;
  float acc = 0.f;
#pragma unroll
  for (int j = lane * 2; j < D; j += 64) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(o + at + j));
    const float2 d = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(dout + at + j));
    acc += a.x * d.x + a.y * d.y;
  }
  acc = repro::warp_sum(acc);
  if (lane == 0) {
    const size_t lrow = (size_t(b) * H + h) * Sq + qi;
    delta[lrow] = acc;
    row[r] = group_fault && r % G ? INFINITY : lse[lrow] * kLog2e;
    row[kRowsKV + r] = acc;
  }
}

// ---- pass 2: dK, dV ------------------------------------------------------
template <int D>
struct KvSmem {
  static constexpr int kTile = 64 * D * 2;       // K, V, Q or dO: 64 rows
  static constexpr int kStage = 2 * kTile;       // Q then dO
  static constexpr int kTable = 2 * kRowsKV * 4;  // lse (log2) and Delta
  static constexpr int kBars = (2 + 2 * kStagesKV) * 8;
  // + 1024: the dynamic shared memory is re-aligned to a swizzle atom
  static constexpr size_t kBytes = size_t(2) * kTile +
                                   size_t(kStagesKV) * (kStage + kTable) +
                                   kBars + 1024;
};

// The Q tiles [t0, t1) (64/G positions each) whose queries see a key of
// key tile kt.
__device__ __forceinline__ void q_tiles(int kt, int Sq, int Skv, int q_off,
                                        int causal, int window, int BQ,
                                        int& t0, int& t1) {
  const int kv0 = kt * kKeys;
  const int kv_last = min(kv0 + kKeys, Skv) - 1;
  const int r0 = causal ? max(0, kv0 - q_off) : 0;
  const int r1 = window > 0 ? min(Sq, kv_last + window - q_off) : Sq;
  t0 = r0 / BQ;
  t1 = r1 > r0 ? (r1 + BQ - 1) / BQ : t0;
}

// POS: pos (B, Skv), q_rng (B, n_t) the Q tiles' ranges, k_rng (B, n_kt)
// the key tiles'; null and unread without POS
template <int D, bool POS>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv(const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v,
               const __grid_constant__ CUtensorMap map_do,
               const float* __restrict__ table, bf16* __restrict__ dk,
               bf16* __restrict__ dv, const int* __restrict__ pos,
               const int2* __restrict__ q_rng,
               const int2* __restrict__ k_rng, int Sq, int Skv, int q_off,
               int H, int K, int causal, int window, float scale, int paired,
               int drop_tile) {
  constexpr int kD = padded_dim<D>();  // the products' width
  using L = KvSmem<kD>;
  constexpr int kAtoms = kD / 64;  // 128-byte swizzle atoms along D
  static_assert(D % 8 == 0 && (kD == 64 || kD == 128),
                "head_dim is padded to one or two swizzle atoms");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* k_s = smem;
  unsigned char* v_s = smem + L::kTile;
  unsigned char* ring = smem + 2 * L::kTile;
  float* tables = reinterpret_cast<float*>(ring + kStagesKV * L::kStage);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(tables) + kStagesKV * L::kTable);
  uint64_t* kv_full = bars;
  uint64_t* kv_empty = bars + 1;
  uint64_t* full = bars + 2;
  uint64_t* empty = full + kStagesKV;

  const int G = H / K;
  const int BQ = kRowsKV / G;   // query positions a Q tile
  const int q_rows = BQ * G;    // rows the boxes deliver; the rest pad
  const int b = blockIdx.y / K, kvh = blockIdx.y % K;
  const int n_kt = (Skv + kKeys - 1) / kKeys;
  const int n_t = (Sq + BQ - 1) / BQ;
  const int c = blockIdx.x;
  const int n_jobs = paired && n_kt - 1 - c != c ? 2 : 1;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int* kp = POS ? pos + size_t(b) * Skv : nullptr;
  const int2* qr = POS ? q_rng + size_t(b) * n_t : nullptr;

  for (int s = 0; s < kStagesKV; ++s) {
    zero_pad_rows(ring + s * L::kStage, kRowsKV, q_rows, kAtoms);
    zero_pad_rows(ring + s * L::kStage + L::kTile, kRowsKV, q_rows, kAtoms);
  }
  sm90::fence_proxy_async_shared();
  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    sm90::mbar_init(kv_empty, 256);
    for (int s = 0; s < kStagesKV; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 128);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: per job K and V, then the job's Q / dO tiles
    sm90::setmaxnreg_dec<24>();
    if (tid == 0) {
      int item = 0;
      for (int j = 0; j < n_jobs; ++j) {
        const int kt = j == 0 ? c : n_kt - 1 - c;
        sm90::mbar_wait(kv_empty, (j & 1) ^ 1);
        sm90::mbar_expect_tx(kv_full, 2 * L::kTile);
#pragma unroll
        for (int a = 0; a < kAtoms; ++a) {
          sm90::tma_load_4d(k_s + a * kKeys * 128, &map_k, kv_full, a * 64,
                            kvh, kt * kKeys, b);
          sm90::tma_load_4d(v_s + a * kKeys * 128, &map_v, kv_full, a * 64,
                            kvh, kt * kKeys, b);
        }
        int t0 = 0, t1 = n_t;
        int2 kr = make_int2(0, 0);
        if constexpr (POS)
          kr = k_rng[size_t(b) * n_kt + kt];
        else
          q_tiles(kt, Sq, Skv, q_off, causal, window, BQ, t0, t1);
        for (int t = t0; t < t1; ++t) {
          if constexpr (POS)
            if (!repro::range_live(qr[t], kr, causal, window)) continue;
          const int s = item % kStagesKV;
          unsigned char* q_st = ring + s * L::kStage;
          sm90::mbar_wait(&empty[s], ((item / kStagesKV) & 1) ^ 1);
          // the bytes the boxes deliver (q_rows rows of kD, not 64: a
          // zero-filled column is credited like a loaded one) and the table
          sm90::mbar_expect_tx(&full[s], 2 * q_rows * kD * 2 + L::kTable);
#pragma unroll
          for (int a = 0; a < kAtoms; ++a) {
            sm90::tma_load_4d(q_st + a * kRowsKV * 128, &map_q, &full[s],
                              a * 64, kvh * G, t * BQ, b);
            sm90::tma_load_4d(q_st + L::kTile + a * kRowsKV * 128, &map_do,
                              &full[s], a * 64, kvh * G, t * BQ, b);
          }
          sm90::bulk_load(tables + s * 2 * kRowsKV,
                          table + (size_t(blockIdx.y) * n_t + t) * 2 * kRowsKV,
                          L::kTable, &full[s]);
          ++item;
        }
      }
    }
    return;
  }

  // ---- consumers: both own the job's 64 keys; this thread holds keys
  // key_lo and key_lo + 8 of the tile, and 16 of the Q tile's 64 rows
  sm90::setmaxnreg_inc<240>();
  const int warp = tid / 32, lane = tid % 32;
  const int key_lo = warp * 16 + lane / 4;
  const float scale_log2 = scale * kLog2e;
  const float inv_g = 1.f / G;
  float dk_acc[kD / 2], dv_acc[kD / 2];
  int item_base = 0;
  for (int j = 0; j < n_jobs; ++j) {
    const int kt = j == 0 ? c : n_kt - 1 - c;
    const int kv0 = kt * kKeys;
    int t0 = 0, t1 = 0, n_items;
    int2 kr = make_int2(0, 0);
    int kpos_lo = 0, kpos_hi = 0;  // POS: this thread's two keys
    if constexpr (POS) {
      kr = k_rng[size_t(b) * n_kt + kt];
      n_items = 0;
      for (int t = 0; t < n_t; ++t)
        n_items += repro::range_live(qr[t], kr, causal, window);
      if (kv0 + key_lo < Skv) kpos_lo = kp[kv0 + key_lo];
      if (kv0 + key_lo + 8 < Skv) kpos_hi = kp[kv0 + key_lo + 8];
    } else {
      q_tiles(kt, Sq, Skv, q_off, causal, window, BQ, t0, t1);
      n_items = t1 - t0;
    }
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    sm90::mbar_wait(kv_full, j & 1);

    int t_pos = -1, i_pos = -1;  // POS: the Q tile of item i
    for (int i = wg; i < n_items; i += 2) {
      const int item = item_base + i;
      const int s = item % kStagesKV;
      const unsigned char* q_st = ring + s * L::kStage;
      const unsigned char* do_st = q_st + L::kTile;
      const float* tab = tables + s * 2 * kRowsKV;
      sm90::mbar_wait(&full[s], (item / kStagesKV) & 1);
      if (drop_tile && i == 0) {  // planted fault
        sm90::mbar_arrive(&empty[s]);
        continue;
      }

      // S^T = K Q^T, then dP^T = V dO^T (its own group, so P^T's
      // arithmetic overlaps it): 64 keys x 64 rows, fp32
      const uint32_t k_a = opaque(k_s), v_a = opaque(v_s);
      const uint32_t q_a = opaque(q_st), do_a = opaque(do_st);
      float st[32], dpt[32];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const int off = (kk / 4) * 64 * 128 + (kk % 4) * 32;
        sm90::wgmma_ss<64, 0>(st, sm90::desc_sw128(k_a + off, 16, 1024),
                              sm90::desc_sw128(q_a + off, 16, 1024), kk > 0);
      }
      sm90::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const int off = (kk / 4) * 64 * 128 + (kk % 4) * 32;
        sm90::wgmma_ss<64, 0>(dpt, sm90::desc_sw128(v_a + off, 16, 1024),
                              sm90::desc_sw128(do_a + off, 16, 1024), kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      sm90::fence_regs(st);

      // P^T; column col is the tile's row, at position q0 + col / G
      int tq;
      if constexpr (POS) {
        while (i_pos < i)
          if (repro::range_live(qr[++t_pos], kr, causal, window)) ++i_pos;
        tq = t_pos;
      } else {
        tq = t0 + i;
      }
      const int q0 = tq * BQ;
      const bool edge =
          POS ? !repro::range_full(qr[tq], kr, causal, window)
              : ((causal && q_off + q0 < kv0 + kKeys - 1) ||
                 (window > 0 &&
                  q_off + min(q0 + BQ, Sq) - 1 - kv0 >= window));
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = 8 * jj + 2 * (lane % 4);
        const float2 ls = *reinterpret_cast<const float2*>(tab + col);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float l = e ? ls.y : ls.x;
          float p_lo = ex2(fmaf(st[4 * jj + e], scale_log2, -l));
          float p_hi = ex2(fmaf(st[4 * jj + 2 + e], scale_log2, -l));
          if (edge) {
            // (col + e) / G, exact for col < 64: (c + 1/2) / G is at least
            // 1 / (2 G) from an integer
            const int qi = q0 + __float2int_rz((col + e + 0.5f) * inv_g);
            if constexpr (POS) {
              // a row past Sq has lse +inf (P = 0) whatever its position
              const int qpos = qi < Sq ? kp[q_off + qi] : 0;
              if (!(kv0 + key_lo < Skv &&
                    repro::pos_ok(kpos_lo, qpos, causal, window)))
                p_lo = 0.f;
              if (!(kv0 + key_lo + 8 < Skv &&
                    repro::pos_ok(kpos_hi, qpos, causal, window)))
                p_hi = 0.f;
            } else {
              const int qpos = q_off + qi;
              if (!key_ok(kv0 + key_lo, qpos, Skv, causal, window))
                p_lo = 0.f;
              if (!key_ok(kv0 + key_lo + 8, qpos, Skv, causal, window))
                p_hi = 0.f;
            }
          }
          st[4 * jj + e] = p_lo;
          st[4 * jj + 2 + e] = p_hi;
        }
      }
      // dS^T = P^T o (dP^T - Delta)
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dpt);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = 8 * jj + 2 * (lane % 4);
        const float2 dl =
            *reinterpret_cast<const float2*>(tab + kRowsKV + col);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d = e ? dl.y : dl.x;
          dpt[4 * jj + e] = st[4 * jj + e] * (dpt[4 * jj + e] - d);
          dpt[4 * jj + 2 + e] =
              st[4 * jj + 2 + e] * (dpt[4 * jj + 2 + e] - d);
        }
      }
      // P^T and dS^T in bf16 as A operands: k16 slice kk (rows 16 kk ..)
      // is accumulator blocks 2 kk and 2 kk + 1
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kk][r] =
              sm90::pack_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
          da[kk][r] =
              sm90::pack_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
        }

      // dV += P^T dO and dK += dS^T Q: dO and Q are the MN-major B
      sm90::fence_regs(dv_acc);
      sm90::fence_regs(dk_acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_rs<kD, 1>(
            dv_acc, pa[kk],
            sm90::desc_sw128(do_a + kk * 2048, kRowsKV * 128, 1024), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_rs<kD, 1>(
            dk_acc, da[kk],
            sm90::desc_sw128(q_a + kk * 2048, kRowsKV * 128, 1024), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dv_acc);
      sm90::fence_regs(dk_acc);
      sm90::mbar_arrive(&empty[s]);
    }
    item_base += n_items;

    // warpgroup 1's partial sums to warpgroup 0 through the K/V tiles
    // (thread t of one holds the same elements as thread t of the other),
    // added in a fixed order: dV, then dK
    float* scratch = reinterpret_cast<float*>(k_s);
    sm90::named_bar_sync(1, 256);
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) scratch[i * 128 + tid] = dv_acc[i];
    }
    sm90::named_bar_sync(1, 256);
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) dv_acc[i] += scratch[i * 128 + tid];
    }
    sm90::named_bar_sync(1, 256);
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) scratch[i * 128 + tid] = dk_acc[i];
    }
    sm90::named_bar_sync(1, 256);
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) dk_acc[i] += scratch[i * 128 + tid];
    }
    // the K/V tiles are free for the next job's TMA once every consumer
    // thread is done with them
    sm90::fence_proxy_async_shared();
    sm90::mbar_arrive(kv_empty);

    // ---- epilogue (warpgroup 0): keys < Skv; dK takes the softmax scale
    if (wg == 0) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int key = kv0 + key_lo + 8 * half;
        if (key >= Skv) continue;
        const size_t at = (size_t(b) * Skv + key) * K * D + size_t(kvh) * D;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {  // the real columns only
          const int col = jj * 8 + 2 * (lane % 4);
          *reinterpret_cast<__nv_bfloat162*>(dk + at + col) =
              __floats2bfloat162_rn(dk_acc[4 * jj + 2 * half] * scale,
                                    dk_acc[4 * jj + 2 * half + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + at + col) =
              __floats2bfloat162_rn(dv_acc[4 * jj + 2 * half],
                                    dv_acc[4 * jj + 2 * half + 1]);
        }
      }
    }
  }
}

// ---- pass 3: dQ ----------------------------------------------------------
template <int D>
struct QSmem {
  static constexpr int kQ = kRowsQ * D * 2;   // Q or dO: 128 rows
  static constexpr int kKV = kKeys * D * 2;   // K or V: 64 keys
  static constexpr int kStage = 2 * kKV;      // K then V
  static constexpr int kBars = (1 + 3 * kStagesQ) * 8;
  static constexpr size_t kBytes =
      size_t(2) * kQ + size_t(kStagesQ) * kStage + kBars + 1024;
};

// POS: pos (B, Skv), q_rng (B, gridDim.y) the CTAs' Q tiles' ranges,
// k_rng (B, n_kt) the key tiles'; null and unread without POS
template <int D, bool POS>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq(const __grid_constant__ CUtensorMap map_q,
             const __grid_constant__ CUtensorMap map_k,
             const __grid_constant__ CUtensorMap map_v,
             const __grid_constant__ CUtensorMap map_do,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dq, const int* __restrict__ pos,
             const int2* __restrict__ q_rng,
             const int2* __restrict__ k_rng, int Sq, int Skv, int q_off,
             int H, int K, int causal, int window, float scale) {
  constexpr int kD = padded_dim<D>();  // the products' width
  using L = QSmem<kD>;
  constexpr int kAtoms = kD / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* q_s = smem;
  unsigned char* do_s = smem + L::kQ;
  unsigned char* ring = smem + 2 * L::kQ;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(ring + kStagesQ * L::kStage);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + kStagesQ;
  uint64_t* empty = v_full + kStagesQ;

  const int G = H / K;
  const int BQ = kRowsQ / G;      // whole query positions a CTA
  const int q_rows = BQ * G;
  const int b = blockIdx.x / K, kvh = blockIdx.x % K;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest rows first
  const int p0 = q_off + q0;
  const int p_last = q_off + min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? p_last + 1 : Skv;
  const int kv_begin = window > 0 ? max(0, p0 - window + 1) : 0;
  const int t_begin = kv_begin / kKeys;
  int n_tiles = (kv_end + kKeys - 1) / kKeys - t_begin;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  // POS: the live key tiles, in order, replace [t_begin, t_begin + n_tiles)
  const int n_kt = (Skv + kKeys - 1) / kKeys;
  int2 q_r = make_int2(0, 0);
  const int2* kr = nullptr;
  if constexpr (POS) {
    q_r = q_rng[b * gridDim.y + q0 / BQ];
    kr = k_rng + size_t(b) * n_kt;
    n_tiles = 0;
    for (int t = 0; t < n_kt; ++t)
      n_tiles += repro::range_live(q_r, kr[t], causal, window);
  }

  zero_pad_rows(q_s, kRowsQ, q_rows, kAtoms);
  zero_pad_rows(do_s, kRowsQ, q_rows, kAtoms);
  sm90::fence_proxy_async_shared();
  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kStagesQ; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&empty[s], 256);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: Q and dO once, then the K/V ring
    sm90::setmaxnreg_dec<24>();
    if (tid == 0) {
      sm90::mbar_expect_tx(q_full, 2 * q_rows * kD * 2);
#pragma unroll
      for (int a = 0; a < kAtoms; ++a) {
        sm90::tma_load_4d(q_s + a * kRowsQ * 128, &map_q, q_full, a * 64,
                          kvh * G, q0, b);
        sm90::tma_load_4d(do_s + a * kRowsQ * 128, &map_do, q_full, a * 64,
                          kvh * G, q0, b);
      }
      int t_pos = -1;  // POS: the key tile of item i
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStagesQ;
        int kv0;
        if constexpr (POS) {
          do ++t_pos;
          while (!repro::range_live(q_r, kr[t_pos], causal, window));
          kv0 = t_pos * kKeys;
        } else {
          kv0 = (t_begin + i) * kKeys;
        }
        unsigned char* k_st = ring + s * L::kStage;
        unsigned char* v_st = k_st + L::kKV;
        sm90::mbar_wait(&empty[s], ((i / kStagesQ) & 1) ^ 1);
        sm90::mbar_expect_tx(&k_full[s], L::kKV);
#pragma unroll
        for (int a = 0; a < kAtoms; ++a)
          sm90::tma_load_4d(k_st + a * kKeys * 128, &map_k, &k_full[s],
                            a * 64, kvh, kv0, b);
        sm90::mbar_expect_tx(&v_full[s], L::kKV);
#pragma unroll
        for (int a = 0; a < kAtoms; ++a)
          sm90::tma_load_4d(v_st + a * kKeys * 128, &map_v, &v_full[s],
                            a * 64, kvh, kv0, b);
      }
    }
    return;
  }

  // ---- consumers: 64 rows each; this thread holds rows r and r + 8
  sm90::setmaxnreg_inc<240>();
  const int warp = tid / 32, lane = tid % 32;
  const int r_lo = wg * 64 + warp * 16 + lane / 4, r_hi = r_lo + 8;
  // a pad row (r >= q_rows) takes the row index Sq, which the epilogue skips
  const int qrow_lo = r_lo < q_rows ? q0 + r_lo / G : Sq;
  const int qrow_hi = r_hi < q_rows ? q0 + r_hi / G : Sq;
  // POS: a real row's position from pos; a pad row's is never used
  const int* kp = POS ? pos + size_t(b) * Skv : nullptr;
  const int qpos_lo = POS ? (qrow_lo < Sq ? kp[q_off + qrow_lo] : 0)
                          : q_off + qrow_lo;
  const int qpos_hi = POS ? (qrow_hi < Sq ? kp[q_off + qrow_hi] : 0)
                          : q_off + qrow_hi;
  const size_t lrow_lo = (size_t(b) * H + kvh * G + r_lo % G) * Sq + qrow_lo;
  const size_t lrow_hi = (size_t(b) * H + kvh * G + r_hi % G) * Sq + qrow_hi;
  const float l_lo = qrow_lo < Sq ? lse[lrow_lo] * kLog2e : INFINITY;
  const float l_hi = qrow_hi < Sq ? lse[lrow_hi] * kLog2e : INFINITY;
  const float d_lo = qrow_lo < Sq ? delta[lrow_lo] : 0.f;
  const float d_hi = qrow_hi < Sq ? delta[lrow_hi] : 0.f;
  const float scale_log2 = scale * kLog2e;
  float acc[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;
  const int a_off = wg * 64 * 128;  // this warpgroup's rows of each atom
  sm90::mbar_wait(q_full, 0);

  int t_pos = -1;  // POS: the key tile of item i
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStagesQ;
    const uint32_t phase = (i / kStagesQ) & 1;
    int kv0;
    bool pos_edge = false;  // POS: the tile is not wholly live
    if constexpr (POS) {
      do ++t_pos;
      while (!repro::range_live(q_r, kr[t_pos], causal, window));
      kv0 = t_pos * kKeys;
      pos_edge = kv0 + kKeys > Skv ||
                 !repro::range_full(q_r, kr[t_pos], causal, window);
    } else {
      kv0 = (t_begin + i) * kKeys;
    }
    const unsigned char* k_st = ring + s * L::kStage;
    const unsigned char* v_st = k_st + L::kKV;

    // S = Q K^T, then dP = dO V^T (its own group, so P's arithmetic
    // overlaps it): 64 rows x 64 keys, fp32
    const uint32_t q_a = opaque(q_s) + a_off, do_a = opaque(do_s) + a_off;
    const uint32_t k_a = opaque(k_st), v_a = opaque(v_st);
    float sc[32], dp[32];
    sm90::mbar_wait(&k_full[s], phase);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      sm90::wgmma_ss<64, 0>(
          sc,
          sm90::desc_sw128(q_a + (kk / 4) * kRowsQ * 128 + (kk % 4) * 32, 16,
                           1024),
          sm90::desc_sw128(k_a + (kk / 4) * kKeys * 128 + (kk % 4) * 32, 16,
                           1024),
          kk > 0);
    sm90::wgmma_commit();
    sm90::mbar_wait(&v_full[s], phase);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      sm90::wgmma_ss<64, 0>(
          dp,
          sm90::desc_sw128(do_a + (kk / 4) * kRowsQ * 128 + (kk % 4) * 32, 16,
                           1024),
          sm90::desc_sw128(v_a + (kk / 4) * kKeys * 128 + (kk % 4) * 32, 16,
                           1024),
          kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    sm90::fence_regs(sc);

    // P, masks only on a tile that straddles a boundary
    const bool edge = POS ? pos_edge
                          : (kv0 + kKeys > Skv ||
                             (causal && kv0 + kKeys - 1 > p0) ||
                             (window > 0 && p_last - kv0 >= window));
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p_lo = ex2(fmaf(sc[4 * jj + e], scale_log2, -l_lo));
        float p_hi = ex2(fmaf(sc[4 * jj + 2 + e], scale_log2, -l_hi));
        if (edge) {
          const int kidx = kv0 + 8 * jj + 2 * (lane % 4) + e;
          if constexpr (POS) {
            const int kpos = kidx < Skv ? kp[kidx] : 0;
            if (!(kidx < Skv && repro::pos_ok(kpos, qpos_lo, causal, window)))
              p_lo = 0.f;
            if (!(kidx < Skv && repro::pos_ok(kpos, qpos_hi, causal, window)))
              p_hi = 0.f;
          } else {
            if (!key_ok(kidx, qpos_lo, Skv, causal, window)) p_lo = 0.f;
            if (!key_ok(kidx, qpos_hi, Skv, causal, window)) p_hi = 0.f;
          }
        }
        sc[4 * jj + e] = p_lo;
        sc[4 * jj + 2 + e] = p_hi;
      }
    // dS = P o (dP - Delta), in bf16 as the A operand
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dp);
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i0 = 8 * kk + 2 * r, hi = r % 2;  // registers 2,3 of a
        const float d = hi ? d_hi : d_lo;           // block: row r + 8
        da[kk][r] = sm90::pack_bf16(sc[i0] * (dp[i0] - d),
                                    sc[i0 + 1] * (dp[i0 + 1] - d));
      }

    // dQ += dS K: K (keys, D) is the MN-major B
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_rs<kD, 1>(
          acc, da[kk], sm90::desc_sw128(k_a + kk * 2048, kKeys * 128, 1024),
          1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    sm90::mbar_arrive(&empty[s]);
  }

  // ---- epilogue: rows < Sq (a pad row's qrow is Sq)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? r_hi : r_lo;
    const int qrow = h ? qrow_hi : qrow_lo;
    if (qrow >= Sq) continue;
    bf16* dst = dq + ((size_t(b) * Sq + qrow) * H + kvh * G + r % G) * D;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)  // the real columns only
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * jj + 2 * (lane % 4)) =
          __floats2bfloat162_rn(acc[4 * jj + 2 * h] * scale,
                                acc[4 * jj + 2 * h + 1] * scale);
  }
}

// A bf16 (B, S, N, D) tensor in boxes of (64 of D, n heads, rows/n
// positions, 1).
int encode_rows(CUtensorMap* map, const void* ptr, int B, int S, int N,
                int D, int n, int rows) {
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(N), cuuint64_t(S),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(D) * 2, cuuint64_t(N) * D * 2,
                                 cuuint64_t(S) * N * D * 2};
  const cuuint32_t box[4] = {64, cuuint32_t(n), cuuint32_t(rows / n), 1};
  return sm90::encode_bf16_sw128(map, ptr, 4, dims, strides, box);
}

template <typename Kern>
cudaError_t set_smem(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

template <int D, bool POS>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* delta, void* table,
           void* dq, void* dk, void* dv, const void* pos, void* ranges,
           int B, int Sq, int Skv, int q_off, int H, int K, int causal,
           int window, float scale, int drop_tile, int group_fault,
           cudaStream_t stream) {
  const int G = H / K;
  CUtensorMap mq64, mdo64, mq128, mdo128, mk, mv;
  int err = encode_rows(&mq64, q, B, Sq, H, D, G, kRowsKV);
  if (!err) err = encode_rows(&mdo64, dout, B, Sq, H, D, G, kRowsKV);
  if (!err) err = encode_rows(&mq128, q, B, Sq, H, D, G, kRowsQ);
  if (!err) err = encode_rows(&mdo128, dout, B, Sq, H, D, G, kRowsQ);
  if (!err) err = encode_rows(&mk, k, B, Skv, K, D, 1, kKeys);
  if (!err) err = encode_rows(&mv, v, B, Skv, K, D, 1, kKeys);
  if (err) return err;

  const int n_t = (Sq + kRowsKV / G - 1) / (kRowsKV / G);
  const long long slots = (long long)B * K * n_t * kRowsKV;
  flash_bwd_prep<D><<<unsigned((slots + 7) / 8), 256, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<float*>(table), B, Sq, H, K, n_t, group_fault);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);

  const int n_kt = (Skv + kKeys - 1) / kKeys;
  const int q_tiles = (Sq + kRowsQ / G - 1) / (kRowsQ / G);
  // POS: the ranges of the dK/dV Q tiles, the dQ Q tiles, the key tiles
  const int* p = static_cast<const int*>(pos);
  int2* r_kv = static_cast<int2*>(ranges);
  int2* r_q = POS ? r_kv + size_t(B) * n_t : nullptr;
  int2* r_k = POS ? r_q + size_t(B) * q_tiles : nullptr;
  if constexpr (POS) {
    e = repro::launch_ranges(p, B, Skv, q_off, Sq, kRowsKV / G, r_kv, stream);
    if (e == cudaSuccess)
      e = repro::launch_ranges(p, B, Skv, q_off, Sq, kRowsQ / G, r_q, stream);
    if (e == cudaSuccess)
      e = repro::launch_ranges(p, B, Skv, 0, Skv, kKeys, r_k, stream);
    if (e != cudaSuccess) return int(e);
  }
  const int paired = causal && window <= 0;
  auto k2 = flash_bwd_dkdv<D, POS>;
  constexpr size_t kv_smem = KvSmem<padded_dim<D>()>::kBytes;
  e = set_smem(k2, kv_smem);
  if (e != cudaSuccess) return int(e);
  k2<<<dim3(paired ? (n_kt + 1) / 2 : n_kt, B * K), kThreads, kv_smem,
       stream>>>(
      mq64, mk, mv, mdo64, static_cast<const float*>(table),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), p, r_kv, r_k, Sq, Skv,
      q_off, H, K, causal, window, scale, paired, drop_tile);
  e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);

  auto k3 = flash_bwd_dq<D, POS>;
  constexpr size_t q_smem = QSmem<padded_dim<D>()>::kBytes;
  e = set_smem(k3, q_smem);
  if (e != cudaSuccess) return int(e);
  k3<<<dim3(B * K, q_tiles), kThreads, q_smem, stream>>>(
      mq128, mk, mv, mdo128, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), p, r_q, r_k,
      Sq, Skv, q_off, H, K, causal, window, scale);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, o, dout, dq (B, Sq, H, D); k, v, dk, dv (B, Skv, K, D), all bf16,
// contiguous and 16-byte aligned, D in {64, 80, 128}, H % K == 0, G = H / K <=
// 64, Sq <= Skv, query row i at absolute position q_off + i.  lse (B, H,
// Sq) fp32 from the forward.  Workspaces, fp32: delta (B, H, Sq) and table
// (B, K, ceil(Sq / (64 / G)), 2, 64), 16-byte aligned.  pos: null (the mask
// by index) or int32 (B, Skv) positions to mask by (head_dim 128 only),
// with ranges, an int2 workspace of B * (ceil(Sq / (64 / G)) +
// ceil(Sq / (128 / G)) + ceil(Skv / 64)) entries, 8-byte aligned.  drop_tile /
// group_fault: 0, or a planted fault for the checks (each dK/dV job's first
// Q tile skipped; only a group's first head summed into dK/dV).  Three
// launches on `stream`; returns 0 when launched, a cudaError_t, or a
// negative CUresult of the tensor-map encoder.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const void* lse,
                        void* delta, void* table, void* dq, void* dk,
                        void* dv, const void* pos, void* ranges, int B,
                        int Sq, int Skv, int q_off, int H, int K, int D,
                        int causal, int window, float scale, int drop_tile,
                        int group_fault, void* stream) {
  const uintptr_t ptrs =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
      reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
      reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv) |
      reinterpret_cast<uintptr_t>(table);
  if (K <= 0 || H % K != 0 || H / K > kRowsKV || Sq <= 0 || Skv < Sq ||
      q_off < 0 || q_off > Skv - Sq || ptrs % 16 != 0 || B <= 0 ||
      B * K > 65535 ||
      (Sq + kRowsQ / (H / K) - 1) / (kRowsQ / (H / K)) > 65535 ||
      (pos != nullptr && (D != 128 || ranges == nullptr ||
                          reinterpret_cast<uintptr_t>(ranges) % 8 != 0)))
    return int(cudaErrorInvalidValue);
  // cuTensorMapEncodeTiled needs a current context, which a
  // thread that has made no runtime call yet (autograd's device thread,
  // when this backward is its first CUDA work) does not have
  cudaError_t e = cudaFree(nullptr);
  if (e != cudaSuccess) return int(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128 && pos != nullptr)  // the positions variant
    return launch<128, true>(q, k, v, o, dout, lse, delta, table, dq, dk, dv,
                             pos, ranges, B, Sq, Skv, q_off, H, K, causal,
                             window, scale, drop_tile, group_fault, s);
  if (D == 128)
    return launch<128, false>(q, k, v, o, dout, lse, delta, table, dq, dk,
                              dv, pos, ranges, B, Sq, Skv, q_off, H, K,
                              causal, window, scale, drop_tile, group_fault,
                              s);
  if (D == 64)
    return launch<64, false>(q, k, v, o, dout, lse, delta, table, dq, dk, dv,
                             pos, ranges, B, Sq, Skv, q_off, H, K, causal,
                             window, scale, drop_tile, group_fault, s);
  if (D == 80)  // hubert-xlarge, padded to 128 in shared memory
    return launch<80, false>(q, k, v, o, dout, lse, delta, table, dq, dk, dv,
                             pos, ranges, B, Sq, Skv, q_off, H, K, causal,
                             window, scale, drop_tile, group_fault, s);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
