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
// before its arithmetic is the limit.  So the design reads each live row
// exactly once and keeps everything else on chip:
//   * one CTA per (slot, kv head); the G query heads of that kv head share
//     every K/V row the CTA stages into shared memory (16-byte loads,
//     neighbouring threads on neighbouring addresses, rows padded by 16
//     bytes so the per-row dot products are free of bank conflicts);
//   * the CTA reads its own block-table row (no scalar prefetch on a GPU)
//     and walks only the ceil(cache_len / tile) live tiles, starting at the
//     first tile inside a sliding window; rows past cache_len are never
//     loaded, and a -1 table entry is never dereferenced: its rows read as
//     zeros, exactly what the oracle paged_gather_ref gives;
//   * online softmax in fp32 (running max m, sum l, accumulator in
//     registers), bf16 output.
// A freed slot (token 0, pos 0, table row -1) therefore attends one zero row
// and writes zeros; the engine discards that output.
// Not done yet (later work): split-K across CTAs for long caches with few
// slots, cp.async/TMA double buffering.

#include "common.cuh"

using repro::bf16;

namespace {

constexpr int kD = 128;         // head_dim the kernel is built for
constexpr int kThreads = 256;
constexpr int kPitch = kD + 8;  // bf16 row pitch in shared memory (272 B)

template <int G, int TILE>
constexpr size_t smem_bytes() {
  return size_t(2) * TILE * kPitch * sizeof(bf16)    // K, V tiles
         + size_t(G) * kD * sizeof(float)            // scaled q
         + size_t(G) * TILE * sizeof(float)          // scores / probabilities
         + size_t(3) * G * sizeof(float);            // m, l, alpha
}

// PAGED: k/v are (N, bl, K, D) pools and tbl (B, nb) maps the slot's
// dense-view position j to block tbl[b, j / bl], row j % bl.
// Dense: k/v are (B, S, K, D); seq is S.
template <int G, int TILE, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const int* __restrict__ tbl,
              const int* __restrict__ cache_len, bf16* __restrict__ out,
              int seq, int nb, int K, int window, float scale) {
  constexpr int kOut = (G * kD + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + TILE * kPitch;
  float* qs = reinterpret_cast<float*>(vs + TILE * kPitch);
  float* ps = qs + G * kD;
  float* ms = ps + G * TILE;
  float* ls = ms + G;
  float* as = ls + G;

  const int b = blockIdx.x / K;
  const int kvh = blockIdx.x % K;
  const int tid = threadIdx.x;
  const int H = K * G;
  const size_t row_stride = size_t(K) * kD;

  int len = cache_len[b];
  len = min(len, PAGED ? nb * seq : seq);
  const int lo = window > 0 ? max(0, len - window) : 0;

  for (int i = tid; i < G * kD; i += kThreads)
    qs[i] = __bfloat162float(q[(size_t(b) * H + kvh * G) * kD + i]) * scale;
  if (tid < G) {
    ms[tid] = -INFINITY;
    ls[tid] = 0.f;
  }
  float acc[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) acc[i] = 0.f;
  __syncthreads();

  const int t_end = (len + TILE - 1) / TILE;
  for (int t = lo / TILE; t < t_end; ++t) {
    // ---- stage the tile's live K/V rows (16 bytes per thread per step)
#pragma unroll 4
    for (int idx = tid; idx < TILE * (kD / 8); idx += kThreads) {
      const int r = idx / (kD / 8), c = idx % (kD / 8);
      const int j = t * TILE + r;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (j < len) {
        size_t off = 0;
        bool live = true;
        if (PAGED) {
          const int blk = tbl[size_t(b) * nb + j / seq];
          live = blk >= 0;
          off = (size_t(blk) * seq + j % seq) * row_stride;
        } else {
          off = (size_t(b) * seq + j) * row_stride;
        }
        if (live) {
          off += size_t(kvh) * kD + c * 8;
          kv = *reinterpret_cast<const uint4*>(k + off);
          vv = *reinterpret_cast<const uint4*>(v + off);
        }
      }
      *reinterpret_cast<uint4*>(ks + r * kPitch + c * 8) = kv;
      *reinterpret_cast<uint4*>(vs + r * kPitch + c * 8) = vv;
    }
    __syncthreads();

    // ---- scores: one (head, row) pair per thread step
    for (int idx = tid; idx < G * TILE; idx += kThreads) {
      const int g = idx / TILE, r = idx % TILE;
      const int j = t * TILE + r;
      float s = -INFINITY;
      if (j < len && j >= lo) {
        const uint4* kr = reinterpret_cast<const uint4*>(ks + r * kPitch);
        const float* qg = qs + g * kD;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < kD / 8; ++c) {
          float f[8];
          repro::bf16x8_to_float(kr[c], f);
#pragma unroll
          for (int e = 0; e < 8; ++e) dot = fmaf(qg[c * 8 + e], f[e], dot);
        }
        s = dot;
      }
      ps[g * TILE + r] = s;
    }
    __syncthreads();

    // ---- online softmax statistics: one warp per query head
    const int warp = tid / 32, lane = tid % 32;
    for (int g = warp; g < G; g += kThreads / 32) {
      float mx = -INFINITY;
      for (int r = lane; r < TILE; r += 32) mx = fmaxf(mx, ps[g * TILE + r]);
      mx = repro::warp_max(mx);
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < TILE; r += 32) {
        const float p = repro::masked_exp(ps[g * TILE + r], m_new);
        ps[g * TILE + r] = p;
        sum += p;
      }
      sum = repro::warp_sum(sum);
      if (lane == 0) {
        const float a = repro::rescale(m_old, m_new);
        as[g] = a;
        ls[g] = ls[g] * a + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();

    // ---- accumulate P V: each thread owns kOut (head, dim) outputs
#pragma unroll
    for (int i = 0; i < kOut; ++i) {
      const int o = tid + i * kThreads;
      if (o < G * kD) {
        const int g = o / kD, d = o % kD;
        const float* pg = ps + g * TILE;
        float a = acc[i] * as[g];
#pragma unroll 8
        for (int r = 0; r < TILE; ++r)
          a = fmaf(pg[r], __bfloat162float(vs[r * kPitch + d]), a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kOut; ++i) {
    const int o = tid + i * kThreads;
    if (o < G * kD) {
      const int g = o / kD, d = o % kD;
      const float l = ls[g];
      out[(size_t(b) * H + kvh * G + g) * kD + d] =
          __float2bfloat16(l > 0.f ? acc[i] / l : 0.f);
    }
  }
}

template <int G, int TILE, bool PAGED>
int launch(const void* q, const void* k, const void* v, const int* tbl,
           const int* cache_len, void* out, int B, int seq, int nb, int K,
           int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<G, TILE>();
  auto kern = decode_kernel<G, TILE, PAGED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kern<<<B * K, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), tbl, cache_len, static_cast<bf16*>(out),
      seq, nb, K, window, scale);
  return int(cudaGetLastError());
}

template <bool PAGED>
int dispatch(const void* q, const void* k, const void* v, const int* tbl,
             const int* cache_len, void* out, int B, int H, int K, int D,
             int seq, int nb, int window, int tile, float scale,
             void* stream) {
  if (D != kD || K <= 0 || H % K) return int(cudaErrorInvalidValue);
  const int G = H / K;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_DECODE_CASE(GG, TT)                                              \
  if (G == GG && tile == TT)                                                   \
    return launch<GG, TT, PAGED>(q, k, v, tbl, cache_len, out, B, seq, nb, K, \
                                 window, scale, s);
#define REPRO_DECODE_TILES(GG) \
  REPRO_DECODE_CASE(GG, 64) REPRO_DECODE_CASE(GG, 128) REPRO_DECODE_CASE(GG, 256)
  REPRO_DECODE_TILES(1)
  REPRO_DECODE_TILES(2)
  REPRO_DECODE_TILES(4)
  REPRO_DECODE_TILES(8)
#undef REPRO_DECODE_TILES
#undef REPRO_DECODE_CASE
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q (B, H, D); k_pool/v_pool (N, bl, K, D); tbl (B, nb) int32, -1 = none;
// cache_len (B,) int32; out (B, H, D).  All bf16 unless stated.  tile is
// the rows staged per step, any of the built tiles whatever bl is (each
// staged row looks up its own block).  Returns a cudaError_t (0 = launched).
int paged_decode_attention(const void* q, const void* k_pool,
                           const void* v_pool, const void* tbl,
                           const void* cache_len, void* out, int B, int H,
                           int K, int D, int bl, int nb, int window, int tile,
                           float scale, void* stream) {
  if (bl <= 0) return int(cudaErrorInvalidValue);
  return dispatch<true>(q, k_pool, v_pool, static_cast<const int*>(tbl),
                        static_cast<const int*>(cache_len), out, B, H, K, D,
                        bl, nb, window, tile, scale, stream);
}

// q (B, H, D); k/v (B, S, K, D); cache_len (B,) int32; out (B, H, D).
int decode_attention(const void* q, const void* k, const void* v,
                     const void* cache_len, void* out, int B, int S, int H,
                     int K, int D, int window, int tile, float scale,
                     void* stream) {
  return dispatch<false>(q, k, v, nullptr, static_cast<const int*>(cache_len),
                         out, B, H, K, D, S, 0, window, tile, scale, stream);
}

}  // extern "C"
