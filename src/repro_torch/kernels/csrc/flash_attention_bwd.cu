// GQA flash attention, backward (FlashAttention-2), with causal and
// sliding-window masks.
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
//   Delta = rowsum(dO o O)                      (pass 1)
//   dP = dO V^T,  dS = P o (dP - Delta)
//   dK = scale dS^T Q,  dV = P^T dO             (pass 2, per kv tile)
//   dQ = scale dS K                             (pass 3, per q tile)
// dK and dV of a kv head sum the G query heads that share it.
//
// What bounds it on the H100: operations.  The backward is five products
// of the scores' size (S recomputed, dP, dV, dK, dQ: 2.5x the forward's
// multiply-adds; this design computes S and dP in both passes 2 and 3,
// seven in all) against reads of q, k, v, o, dO — far above the card's
// ~295 FLOP/byte balance.  This first design is simple and right, not
// fast:
//   * every product is mma.sync m16n8k16 (bf16 operands, fp32
//     accumulation) from operand tiles in shared memory, rows padded by
//     8 bf16 so every fragment read is conflict-free; P and dS are
//     rounded to bf16 as the A operand straight from the accumulator
//     registers (the m16n8 C layout of two n-blocks is the m16k16 A
//     layout), as the forward rounds P for P.V;
//   * pass 2: one CTA per (b, kv head, 64-key tile), four warps of 16
//     keys.  It loops over the G heads of its group and the q tiles that
//     can see its keys (causal: from the diagonal on; a window: up to
//     window - 1 positions past its last key), computing S^T = K Q^T and
//     dP^T = V dO^T with keys as rows, so P^T and dS^T are A operands in
//     place, and accumulates dK and dV for its 16 x D rows in fp32
//     registers: no atomics, the output is deterministic;
//   * pass 3: one CTA per (b, head, 64-query tile), four warps of 16
//     queries, looping over the kv tiles the queries see, dQ in fp32
//     registers;
//   * masks are the forward's (key_ok: the S edge, causal bottom-right
//     alignment at q_off, the window), applied on every element; rows
//     past Sq and keys past Skv load as zeros and are masked;
//   * no cp.async pipeline, no wgmma, no TMA yet: each tile is loaded
//     with 16-byte loads and a __syncthreads.  Overlapping the loads,
//     wgmma and a persistent grid are later work.
// Tiles: 64 keys x (32 queries at D = 128, 64 at D = 64) in pass 2,
// 64 queries x 64 keys in pass 3; head_dim 64 and 128.

#include "common.cuh"

using repro::bf16;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileK = 64;   // keys per pass-2 CTA, per pass-3 kv tile
constexpr int kTileQ3 = 64;  // queries per pass-3 CTA
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tiles {
  static constexpr int kLd = D + 8;  // padded row pitch, bf16
  static constexpr int kTileQ2 = D == 128 ? 32 : 64;  // pass-2 q tile
};

__device__ __forceinline__ bool key_ok(int kpos, int qpos, int Skv,
                                       int causal, int window) {
  return kpos < Skv && (!causal || kpos <= qpos) &&
         (window <= 0 || qpos - kpos < window);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return uint32_t(__bfloat16_as_ushort(lo)) |
         (uint32_t(__bfloat16_as_ushort(hi)) << 16);
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, fp32 accumulate.  Lane
// (g, t) = (lane / 4, lane % 4) holds A at rows g, g + 8 and columns 2t,
// 2t + 1, 2t + 8, 2t + 9; B at rows 2t, 2t + 1, 2t + 8, 2t + 9 of column
// g; C at rows g (c0, c1) and g + 8 (c2, c3), columns 2t, 2t + 1.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows r0.., columns k0.. of a row-major tile (k contiguous).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s,
                                       int ld, int r0, int k0, int lane) {
  const int g = lane / 4, t = lane % 4;
  const bf16* p = s + (r0 + g) * ld + k0 + 2 * t;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
}

// B fragment (k0.. x n0..) of a tile stored with n as rows and k
// contiguous: B = Y^T for a row-major Y (n, k).
__device__ __forceinline__ void load_b_nk(uint32_t& b0, uint32_t& b1,
                                          const bf16* s, int ld, int n0,
                                          int k0, int lane) {
  const int g = lane / 4, t = lane % 4;
  const bf16* p = s + (n0 + g) * ld + k0 + 2 * t;
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B fragment (k0.. x n0..) of a row-major tile Z (k, n): two 16-bit reads
// a register.
__device__ __forceinline__ void load_b_kn(uint32_t& b0, uint32_t& b1,
                                          const bf16* s, int ld, int k0,
                                          int n0, int lane) {
  const int g = lane / 4, t = lane % 4;
  const bf16* p = s + (k0 + 2 * t) * ld + n0 + g;
  b0 = pack_raw(p[0], p[ld]);
  b1 = pack_raw(p[8 * ld], p[9 * ld]);
}

// rows [r0, r0 + n) of a (rows, stride) bf16 matrix, D wide, into a padded
// shared tile; rows at or past `limit` are zeros.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          size_t stride, int r0, int n,
                                          int limit) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < n * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < limit)
      v = *reinterpret_cast<const uint4*>(src + size_t(r0 + r) * stride +
                                          c * 8);
    *reinterpret_cast<uint4*>(dst + r * Tiles<D>::kLd + c * 8) = v;
  }
}

// ---- pass 1: Delta = rowsum(dO o O), one warp a (b, q, h) row ----------
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                float* __restrict__ delta, int B, int Sq, int H) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;  // (b, q, h) row
  const int lane = threadIdx.x % 32;
  if (row >= B * Sq * H) return;
  const bf16* po = o + size_t(row) * D;
  const bf16* pd = dout + size_t(row) * D;
  float acc = 0.f;
#pragma unroll
  for (int j = lane * 2; j < D; j += 64) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(po + j));
    const float2 d = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(pd + j));
    acc += a.x * d.x + a.y * d.y;
  }
  acc = repro::warp_sum(acc);
  if (lane == 0) {
    const int h = row % H, q = (row / H) % Sq, b = row / (H * Sq);
    delta[(size_t(b) * H + h) * Sq + q] = acc;
  }
}

// ---- pass 2: dK, dV for one (b, kv head, 64-key tile) ------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, bf16* __restrict__ dk,
               bf16* __restrict__ dv, int Sq, int Skv, int q_off, int H,
               int K, int causal, int window, float scale, int drop_tile,
               int group_fault) {
  constexpr int kLd = Tiles<D>::kLd;
  constexpr int BQ = Tiles<D>::kTileQ2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kTileK * kLd;
  bf16* sQ = sV + kTileK * kLd;
  bf16* sO = sQ + BQ * kLd;  // dO
  float* sL = reinterpret_cast<float*>(sO + BQ * kLd);  // lse * log2(e)
  float* sD = sL + BQ;                                   // Delta

  const int G = H / K;
  const int b = blockIdx.y / K, kvh = blockIdx.y % K;
  const int kv0 = blockIdx.x * kTileK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g_ = lane / 4, t = lane % 4;
  const size_t kv_stride = size_t(K) * D, q_stride = size_t(H) * D;
  const bf16* kb = k + (size_t(b) * Skv * K + kvh) * D;
  const bf16* vb = v + (size_t(b) * Skv * K + kvh) * D;
  load_tile<D>(sK, kb, kv_stride, kv0, kTileK, Skv);
  load_tile<D>(sV, vb, kv_stride, kv0, kTileK, Skv);

  // the q rows that see a key of this tile
  const int kv_last = min(kv0 + kTileK, Skv) - 1;
  const int row_begin = causal ? max(0, kv0 - q_off) : 0;
  const int row_end =
      window > 0 ? min(Sq, kv_last + window - q_off) : Sq;
  const int t_begin = row_begin / BQ;
  const int t_end = row_end > row_begin ? (row_end + BQ - 1) / BQ : t_begin;
  const float scale_log2 = scale * kLog2e;

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  const int key_lo = kv0 + warp * 16 + g_, key_hi = key_lo + 8;
  for (int qt = t_begin; qt < t_end; ++qt) {
    if (drop_tile && qt == t_begin) continue;  // planted fault
    const int q0 = qt * BQ;
    for (int gi = 0; gi < G; ++gi) {
      if (group_fault && gi > 0) break;  // planted fault
      const int h = kvh * G + gi;
      __syncthreads();  // the previous tiles are consumed
      const size_t qoff = (size_t(b) * Sq * H + h) * D;
      load_tile<D>(sQ, q + qoff, q_stride, q0, BQ, Sq);
      load_tile<D>(sO, dout + qoff, q_stride, q0, BQ, Sq);
      for (int i = threadIdx.x; i < BQ; i += kThreads) {
        const bool in = q0 + i < Sq;
        const size_t at = (size_t(b) * H + h) * Sq + q0 + i;
        sL[i] = in ? lse[at] * kLog2e : INFINITY;
        sD[i] = in ? delta[at] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x BQ queries
      float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        load_a(ak, sK, kLd, warp * 16, kk * 16, lane);
        load_a(av, sV, kLd, warp * 16, kk * 16, lane);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          uint32_t b0, b1;
          load_b_nk(b0, b1, sQ, kLd, j * 8, kk * 16, lane);
          mma(s[j], ak, b0, b1);
          load_b_nk(b0, b1, sO, kLd, j * 8, kk * 16, lane);
          mma(dp[j], av, b0, b1);
        }
      }
      // P^T (fp32, recomputed) and dS^T = P^T o (dP^T - Delta)
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = j * 8 + 2 * t + (e & 1);
          const int key = e < 2 ? key_lo : key_hi;
          const bool ok = q0 + qi < Sq &&
                          key_ok(key, q_off + q0 + qi, Skv, causal, window);
          const float p =
              ok ? exp2f(fmaf(s[j][e], scale_log2, -sL[qi])) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - sD[qi]);
        }
      // dV += P^T dO and dK += dS^T Q, the k dimension over queries
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint32_t ap[4] = {pack(s[2 * kk][0], s[2 * kk][1]),
                                pack(s[2 * kk][2], s[2 * kk][3]),
                                pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const uint32_t ad[4] = {pack(dp[2 * kk][0], dp[2 * kk][1]),
                                pack(dp[2 * kk][2], dp[2 * kk][3]),
                                pack(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                                pack(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          uint32_t b0, b1;
          load_b_kn(b0, b1, sO, kLd, kk * 16, j * 8, lane);
          mma(acc_v[j], ap, b0, b1);
          load_b_kn(b0, b1, sQ, kLd, kk * 16, j * 8, lane);
          mma(acc_k[j], ad, b0, b1);
        }
      }
    }
  }

  // epilogue: keys < Skv; dK takes the softmax scale
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = half ? key_hi : key_lo;
    if (key >= Skv) continue;
    const size_t at = (size_t(b) * Skv + key) * K * D + size_t(kvh) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dk + at + col) =
          __floats2bfloat162_rn(acc_k[j][2 * half] * scale,
                                acc_k[j][2 * half + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + col) =
          __floats2bfloat162_rn(acc_v[j][2 * half], acc_v[j][2 * half + 1]);
    }
  }
}

// ---- pass 3: dQ for one (b, head, 64-query tile) -----------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dq, int Sq, int Skv, int q_off, int H, int K,
             int causal, int window, float scale) {
  constexpr int kLd = Tiles<D>::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sO = sQ + kTileQ3 * kLd;  // dO
  bf16* sK = sO + kTileQ3 * kLd;
  bf16* sV = sK + kTileK * kLd;

  const int G = H / K;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kvh = h / G;
  const int q0 = blockIdx.x * kTileQ3;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g_ = lane / 4, t = lane % 4;
  const size_t q_stride = size_t(H) * D, kv_stride = size_t(K) * D;
  const size_t qoff = (size_t(b) * Sq * H + h) * D;
  load_tile<D>(sQ, q + qoff, q_stride, q0, kTileQ3, Sq);
  load_tile<D>(sO, dout + qoff, q_stride, q0, kTileQ3, Sq);

  const int row_lo = q0 + warp * 16 + g_, row_hi = row_lo + 8;
  const float scale_log2 = scale * kLog2e;
  const size_t lrow = (size_t(b) * H + h) * Sq;
  const float l_lo = row_lo < Sq ? lse[lrow + row_lo] * kLog2e : INFINITY;
  const float l_hi = row_hi < Sq ? lse[lrow + row_hi] * kLog2e : INFINITY;
  const float d_lo = row_lo < Sq ? delta[lrow + row_lo] : 0.f;
  const float d_hi = row_hi < Sq ? delta[lrow + row_hi] : 0.f;

  // the keys these queries see
  const int p0 = q_off + q0;
  const int p_last = q_off + min(q0 + kTileQ3, Sq) - 1;
  const int kv_end = causal ? min(Skv, p_last + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, p0 - window + 1) : 0;

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const bf16* kb = k + (size_t(b) * Skv * K + kvh) * D;
  const bf16* vb = v + (size_t(b) * Skv * K + kvh) * D;
  for (int kv0 = (kv_begin / kTileK) * kTileK; kv0 < kv_end;
       kv0 += kTileK) {
    __syncthreads();  // the previous K/V tile is consumed
    load_tile<D>(sK, kb, kv_stride, kv0, kTileK, Skv);
    load_tile<D>(sV, vb, kv_stride, kv0, kTileK, Skv);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: this warp's 16 queries x 64 keys
    float s[kTileK / 8][4], dp[kTileK / 8][4];
#pragma unroll
    for (int j = 0; j < kTileK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ao[4];
      load_a(aq, sQ, kLd, warp * 16, kk * 16, lane);
      load_a(ao, sO, kLd, warp * 16, kk * 16, lane);
#pragma unroll
      for (int j = 0; j < kTileK / 8; ++j) {
        uint32_t b0, b1;
        load_b_nk(b0, b1, sK, kLd, j * 8, kk * 16, lane);
        mma(s[j], aq, b0, b1);
        load_b_nk(b0, b1, sV, kLd, j * 8, kk * 16, lane);
        mma(dp[j], ao, b0, b1);
      }
    }
    // dS = P o (dP - Delta), P recomputed in fp32
#pragma unroll
    for (int j = 0; j < kTileK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + j * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row_lo : row_hi;
        const bool ok =
            row < Sq && key_ok(key, q_off + row, Skv, causal, window);
        const float p = ok ? exp2f(fmaf(s[j][e], scale_log2,
                                        -(e < 2 ? l_lo : l_hi)))
                           : 0.f;
        s[j][e] = p * (dp[j][e] - (e < 2 ? d_lo : d_hi));
      }
    // dQ += dS K, the k dimension over keys
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk) {
      const uint32_t a[4] = {pack(s[2 * kk][0], s[2 * kk][1]),
                             pack(s[2 * kk][2], s[2 * kk][3]),
                             pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        uint32_t b0, b1;
        load_b_kn(b0, b1, sK, kLd, kk * 16, j * 8, lane);
        mma(acc[j], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row_hi : row_lo;
    if (row >= Sq) continue;
    bf16* dst = dq + qoff + size_t(row) * q_stride;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * half] * scale,
                                acc[j][2 * half + 1] * scale);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* delta, void* dq,
           void* dk, void* dv, int B, int Sq, int Skv, int q_off, int H,
           int K, int causal, int window, float scale, int drop_tile,
           int group_fault, cudaStream_t stream) {
  constexpr int kLd = Tiles<D>::kLd;
  constexpr int BQ = Tiles<D>::kTileQ2;
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* o_ = static_cast<const bf16*>(o);
  const bf16* d_ = static_cast<const bf16*>(dout);
  const float* l_ = static_cast<const float*>(lse);
  float* delta_ = static_cast<float*>(delta);

  const int rows = B * Sq * H;
  flash_bwd_delta<D><<<(rows + 7) / 8, 256, 0, stream>>>(o_, d_, delta_, B,
                                                         Sq, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);

  const size_t smem2 = size_t(2 * kTileK + 2 * BQ) * kLd * 2 + 2 * BQ * 4;
  auto k2 = flash_bwd_dkdv<D>;
  e = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(smem2));
  if (e != cudaSuccess) return int(e);
  k2<<<dim3((Skv + kTileK - 1) / kTileK, B * K), kThreads, smem2, stream>>>(
      q_, k_, v_, d_, l_, delta_, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Sq, Skv, q_off, H, K, causal, window, scale,
      drop_tile, group_fault);
  e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);

  const size_t smem3 = size_t(2 * kTileQ3 + 2 * kTileK) * kLd * 2;
  auto k3 = flash_bwd_dq<D>;
  e = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(smem3));
  if (e != cudaSuccess) return int(e);
  k3<<<dim3((Sq + kTileQ3 - 1) / kTileQ3, B * H), kThreads, smem3, stream>>>(
      q_, k_, v_, d_, l_, delta_, static_cast<bf16*>(dq), Sq, Skv, q_off, H,
      K, causal, window, scale);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, o, dout, dq (B, Sq, H, D); k, v, dk, dv (B, Skv, K, D), all bf16 and
// contiguous, D in {64, 128}, H % K == 0, Sq <= Skv, query row i at
// absolute position q_off + i.  lse (B, H, Sq) fp32 from the forward;
// delta (B, H, Sq) fp32 workspace.  drop_tile / group_fault: 0, or a
// planted fault for the checks (each kv tile's first q tile skipped in the
// dK/dV loop; only the group's first head summed into dK/dV).  Three
// launches on `stream`; returns 0 when launched, else a cudaError_t.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const void* lse,
                        void* delta, void* dq, void* dk, void* dv, int B,
                        int Sq, int Skv, int q_off, int H, int K, int D,
                        int causal, int window, float scale, int drop_tile,
                        int group_fault, void* stream) {
  const uintptr_t ptrs =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
      reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
      reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv);
  if (K <= 0 || H % K != 0 || Sq <= 0 || Skv < Sq || q_off < 0 ||
      q_off > Skv - Sq || ptrs % 16 != 0 || B <= 0 || B * K > 65535 ||
      B * H > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv,
                       q_off, H, K, causal, window, scale, drop_tile,
                       group_fault, s);
  if (D == 64)
    return launch<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv,
                      q_off, H, K, causal, window, scale, drop_tile,
                      group_fault, s);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
