// GQA flash attention, forward, with causal and sliding-window masks.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/flash_attention.py:
//   flash_attention (body _flash_kernel) and its packed-causal grid
//   _flash_causal_packed (body _flash_kernel_packed), which paired q rows i
//   and n-1-i so a rectangular TPU grid skipped the blocks above the
//   diagonal.  Here a CTA's kv loop simply stops at the tile holding its
//   last query position (and starts at the first tile inside a window):
//   the same work, the same output.
//
// What bounds it on the H100: operations.  Prefill does 4*D multiply-adds
// per (query, key) pair against 2*D bytes per key read, far above the
// card's ~295 FLOP/byte balance, so the products run on the tensor cores
// (bf16 in, fp32 accumulate, through the warp-level WMMA 16x16x16 API):
//   * one CTA per (q tile, batch x kv head).  The tile's M rows are
//     (position, head) pairs: M/G positions times the G = H/K query heads
//     that share a kv head, so every K/V tile staged in shared memory
//     serves all G heads (GQA reuse instead of re-reading per head);
//   * each warp owns 16 query rows: S = Q K^T for its rows, the masked
//     online softmax in fp32 (running max/sum per row), P rounded to bf16,
//     then O += P V into an fp32 accumulator kept in shared memory (the
//     WMMA fragment layout is opaque, so the per-row rescale of O happens
//     there, between a store and a load of the accumulator fragments);
//   * ragged S is masked (the Pallas kernel asserted S % block == 0):
//     rows past S load as zeros and are never written, keys past S score
//     -inf.
// Tiles (M rows, N kv rows) come from the plan; the kernel is built for
// (M, N) in {(64, 64), (64, 128), (128, 64)} and D = 128, and the wrapper
// raises on anything else.  Not done yet (later work): wgmma + TMA, a
// register-resident accumulator, warp specialisation.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
using repro::bf16;

namespace {

constexpr int kD = 128;
constexpr int kQP = kD + 8;  // bf16 pitch of Q, K, V rows (272 B)
constexpr int kOP = kD + 4;  // fp32 pitch of the O accumulator (528 B)

template <int M, int N>
struct Smem {
  static constexpr int SP = N + 4;  // fp32 pitch of scores
  static constexpr int PP = N + 8;  // bf16 pitch of probabilities
  static constexpr size_t q = size_t(M) * kQP * sizeof(bf16);
  static constexpr size_t kv = size_t(N) * kQP * sizeof(bf16);
  static constexpr size_t s = size_t(M) * SP * sizeof(float);
  static constexpr size_t p = size_t(M) * PP * sizeof(bf16);
  static constexpr size_t o = size_t(M) * kOP * sizeof(float);
  static constexpr size_t stats = size_t(2) * M * sizeof(float);
  static constexpr size_t total = q + 2 * kv + s + p + o + stats;
};

template <int M, int N>
__global__ void __launch_bounds__(M / 16 * 32)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int S,
                 int H, int K, int causal, int window, float scale) {
  using L = Smem<M, N>;
  constexpr int kThreads = M / 16 * 32;
  constexpr int SP = L::SP, PP = L::PP;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = reinterpret_cast<bf16*>(smem + L::q);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::q + L::kv);
  float* ss = reinterpret_cast<float*>(smem + L::q + 2 * L::kv);
  bf16* ps = reinterpret_cast<bf16*>(smem + L::q + 2 * L::kv + L::s);
  float* os = reinterpret_cast<float*>(smem + L::q + 2 * L::kv + L::s + L::p);
  float* row_m = reinterpret_cast<float*>(smem + L::q + 2 * L::kv + L::s +
                                          L::p + L::o);
  float* row_l = row_m + M;

  const int G = H / K;
  const int BQ = M / G;                 // query positions per tile
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / K, kvh = blockIdx.y % K;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // ---- stage Q (rows past S are zeros), clear O and the row statistics
  for (int idx = tid; idx < M * (kD / 8); idx += kThreads) {
    const int r = idx / (kD / 8), c = idx % (kD / 8);
    const int pos = q0 + r / G, h = kvh * G + r % G;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (pos < S)
      val = *reinterpret_cast<const uint4*>(
          q + ((size_t(b) * S + pos) * H + h) * kD + c * 8);
    *reinterpret_cast<uint4*>(qs + r * kQP + c * 8) = val;
  }
  for (int i = tid; i < M * kOP; i += kThreads) os[i] = 0.f;
  for (int i = tid; i < M; i += kThreads) {
    row_m[i] = -INFINITY;
    row_l[i] = 0.f;
  }

  const int q_last = min(q0 + BQ, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int r0 = warp * 16;  // this warp's first query row

  for (int t = kv_begin / N; t * N < kv_end; ++t) {
    __syncthreads();  // previous tile's K/V fully consumed (and Q staged)
    for (int idx = tid; idx < N * (kD / 8); idx += kThreads) {
      const int r = idx / (kD / 8), c = idx % (kD / 8);
      const int j = t * N + r;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (j < S) {
        const size_t off = ((size_t(b) * S + j) * K + kvh) * kD + c * 8;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(ks + r * kQP + c * 8) = kv;
      *reinterpret_cast<uint4*>(vs + r * kQP + c * 8) = vv;
    }
    __syncthreads();

    // ---- S = Q K^T for this warp's 16 rows (tensor cores)
    {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          qa[kD / 16];
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wmma::load_matrix_sync(qa[kk], qs + r0 * kQP + kk * 16, kQP);
#pragma unroll
      for (int n = 0; n < N / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> sc;
        wmma::fill_fragment(sc, 0.f);
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
          wmma::load_matrix_sync(kb, ks + n * 16 * kQP + kk * 16, kQP);
          wmma::mma_sync(sc, qa[kk], kb, sc);
        }
        wmma::store_matrix_sync(ss + r0 * SP + n * 16, sc, SP,
                                wmma::mem_row_major);
      }
    }
    __syncwarp();

    // ---- masked online softmax per row, then rescale the row of O
    for (int i = 0; i < 16; ++i) {
      const int r = r0 + i;
      const int qpos = q0 + r / G;
      float sv[N / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < N / 32; ++u) {
        const int col = lane + 32 * u;
        const int kpos = t * N + col;
        bool ok = qpos < S && kpos < S;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        sv[u] = ok ? ss[r * SP + col] * scale : -INFINITY;
        mx = fmaxf(mx, sv[u]);
      }
      mx = repro::warp_max(mx);
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < N / 32; ++u) {
        const bf16 p = __float2bfloat16(repro::masked_exp(sv[u], m_new));
        ps[r * PP + lane + 32 * u] = p;
        sum += __bfloat162float(p);
      }
      sum = repro::warp_sum(sum);
      const float alpha = repro::rescale(m_old, m_new);
#pragma unroll
      for (int d = lane; d < kD; d += 32) os[r * kOP + d] *= alpha;
      if (lane == 0) {
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncwarp();

    // ---- O += P V for this warp's rows (tensor cores)
#pragma unroll
    for (int dn = 0; dn < kD / 16; ++dn) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oc;
      wmma::load_matrix_sync(oc, os + r0 * kOP + dn * 16, kOP,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(pa, ps + r0 * PP + kk * 16, PP);
        wmma::load_matrix_sync(vb, vs + kk * 16 * kQP + dn * 16, kQP);
        wmma::mma_sync(oc, pa, vb, oc);
      }
      wmma::store_matrix_sync(os + r0 * kOP + dn * 16, oc, kOP,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();

  // ---- normalise and write this warp's rows (positions < S only)
  for (int i = 0; i < 16; ++i) {
    const int r = r0 + i;
    const int pos = q0 + r / G;
    if (pos >= S) continue;
    const int h = kvh * G + r % G;
    const float l = row_l[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    bf16* dst = out + ((size_t(b) * S + pos) * H + h) * kD;
#pragma unroll
    for (int d = lane; d < kD; d += 32)
      dst[d] = __float2bfloat16(os[r * kOP + d] * inv);
  }
}

template <int M, int N>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int K, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = Smem<M, N>::total;
  auto kern = flash_fwd_kernel<M, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int G = H / K;
  const int BQ = M / G;
  dim3 grid((S + BQ - 1) / BQ, B * K);
  kern<<<grid, M / 16 * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), S, H, K, causal,
      window, scale);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// q (B, S, H, D), k/v (B, S, K, D), out (B, S, H, D), all bf16 and
// contiguous.  rows = query rows per CTA (positions x G), block_kv = K/V
// rows per tile.  Returns a cudaError_t (0 = launched).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, int B, int S, int H, int K, int D,
                        int causal, int window, int rows, int block_kv,
                        float scale, void* stream) {
  if (D != kD || K <= 0 || H % K || rows % (H / K) || S <= 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 64 && block_kv == 64)
    return launch<64, 64>(q, k, v, out, B, S, H, K, causal, window, scale, s);
  if (rows == 64 && block_kv == 128)
    return launch<64, 128>(q, k, v, out, B, S, H, K, causal, window, scale, s);
  if (rows == 128 && block_kv == 64)
    return launch<128, 64>(q, k, v, out, B, S, H, K, causal, window, scale, s);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
