// Mamba2 SSD chunked scan (state-space duality, arXiv:2405.21060 §6).
//
// Replaces the Pallas TPU kernel ssd_scan in src/repro/kernels/ssd_scan.py:83
// (body _ssd_kernel, pallas_call at :105).  There the grid was
// (batch*heads, seq/chunk) with the chunk axis sequential and the (P, N)
// running state in a VMEM scratch carried across grid steps; each step
// did the intra-chunk term as (chunk x chunk) MXU products.
//
// What it computes, per (batch, head) and over chunks of Q = chunk rows:
//   cs    = cumsum(dt * A)                                  (within the chunk)
//   y[q]  = sum_{k<=q} (C[q].B[k]) exp(cs[q]-cs[k]) dt[k] x[k]
//         + exp(cs[q]) C[q].state^T                         (carried in)
//   state = exp(cs[Q-1]) state + sum_k (x[k] dt[k] exp(cs[Q-1]-cs[k]))^T B[k]
// in fp32 on the CUDA cores.  Every decay is exp of a difference <= 0
// (A < 0, dt >= 0): never exp(cs[q]) * exp(-cs[k]), which overflows once cs
// reaches -88 (A down to -16 at dt ~ 0.13 gets there within one chunk).
//
// Supersets of the Pallas contract: any S (rows past S read as dt = 0,
// x = 0, which is exactly the reference's zero padding, and write
// nothing); B and C as (B, S, G, N), head h reading group h / (H / G), so
// the G = 1 model never materialises an 80x copy of them; an optional
// initial state in and the final state out, (B, H, P, N).
//
// What bounds it on the H100: operations.  Per (head, chunk) the chunked
// algorithm does Q(Q+1)(N + P) + 4QPN flops (the causal halves of C.B^T
// and of scores.x, then the carried-state term and the state update)
// against (2P + 1) Q * 4 bytes of its own x, dt and y (B and C are shared
// by a group's heads): ~160 flops a byte at Q = 256, P = 64, N = 128, far
// above the ~20 the card's fp32 CUDA-core rate needs.  So the
// design keeps every operand of the products in shared memory and the
// accumulators in registers:
//   * one CTA per (batch, heads_block heads), looping over its heads and,
//     inside, over the chunks; the (P, N) state (32 KB at full width) stays
//     in shared memory for the whole sequence (the VMEM scratch's role);
//   * a chunk's (Q, N) operands do not all fit shared memory at Q = 256
//     (128 KB each), so rows are staged in 64-row sub-tiles: for each query
//     tile, C is staged once, then every key tile <= it (B and x), the
//     64x64 masked, decayed scores go to shared memory and are multiplied
//     into the query tile's y accumulators (registers); the carried-state
//     term follows.  The key tiles of the chunk's last live query tile are
//     all of the chunk's live tiles, so the state update accumulates in
//     registers during that tile's key loop and loads nothing again;
//   * 256 threads as 16 x 16, each owning a 4 x 4 (or 4 x P/16) register
//     block; a thread's rows are strided by 16 so that the 16-byte
//     shared-memory reads of a quarter warp hit 32 distinct banks (rows are
//     padded by 4 floats);
//   * causal tiles above the diagonal are never computed, and query tiles
//     wholly past S are skipped.
// With B * H = 80 CTAs at batch 1, 52 of the 132 SMs idle; splitting P
// across CTAs would recompute the scores (the largest term) per slice, so
// that is left to a later PR, as are tensor cores (TF32 or bf16 wgmma
// would need an argument about tolerance).

#include "common.cuh"

namespace {

constexpr int kT = 64;           // rows per staged sub-tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kMaxChunk = 256;

template <int P, int N>
struct Layout {
  static constexpr int kNP = N + 4;     // row pitch of C, B and the state
  static constexpr int kSP = kT + 4;    // row pitch of the score tile
  static constexpr size_t kFloats = size_t(P) * kNP + 2 * size_t(kT) * kNP +
                                    size_t(kT) * P + size_t(kT) * kSP +
                                    2 * size_t(kMaxChunk);
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

// Stage rows [0, valid) of a (kT, W) tile whose rows lie `stride` floats
// apart in global memory into shared memory of row pitch `pitch`; rows at
// or past `valid` read as zeros.  16-byte loads, W % 4 == 0.
template <int W>
__device__ __forceinline__ void stage(float* dst, int pitch,
                                      const float* src, size_t stride,
                                      int valid) {
  constexpr int kV = W / 4;
  for (int i = threadIdx.x; i < kT * kV; i += kThreads) {
    const int r = i / kV, c = (i % kV) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) v = *reinterpret_cast<const float4*>(src + r * stride + c);
    *reinterpret_cast<float4*>(dst + r * pitch + c) = v;
  }
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ init,
                float* __restrict__ y, float* __restrict__ fin, int S, int H,
                int G, int chunk, int heads_block) {
  using L = Layout<P, N>;
  constexpr int NP = L::kNP, SP = L::kSP;
  constexpr int PJ = P / 16;       // y columns (and state rows) per thread
  constexpr int NJ = N / 16;       // state columns per thread
  extern __shared__ __align__(16) float smem[];
  float* st = smem;                // (P, NP) running state
  float* cs = st + P * NP;         // (kT, NP) C rows of the query tile
  float* bs = cs + kT * NP;        // (kT, NP) B rows of the key tile
  float* xs = bs + kT * NP;        // (kT, P) x rows of the key tile
  float* ss = xs + kT * P;         // (kT, SP) masked, decayed scores
  float* cum = ss + kT * SP;       // (chunk) cumsum of dt * A
  float* dts = cum + kMaxChunk;    // (chunk) dt

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int per = chunk / 32;      // cumsum entries per lane of warp 0
  const size_t xrow = size_t(H) * P, brow = size_t(G) * N;

  for (int hb = 0; hb < heads_block; ++hb) {
    const int bh = blockIdx.x * heads_block + hb;
    const int b = bh / H, h = bh % H, g = h / (H / G);
    const float a = A[h];
    const float* xb = x + size_t(b) * S * xrow + size_t(h) * P;
    float* yb = y + size_t(b) * S * xrow + size_t(h) * P;
    const float* dtb = dt + size_t(b) * S * H + h;
    const float* bb = Bm + size_t(b) * S * brow + size_t(g) * N;
    const float* cb = Cm + size_t(b) * S * brow + size_t(g) * N;

    __syncthreads();               // the previous head is done with st
    for (int i = tid; i < P * N; i += kThreads)
      st[(i / N) * NP + i % N] = init ? init[size_t(bh) * P * N + i] : 0.f;

    for (int c0 = 0; c0 < S; c0 += chunk) {
      const int rows = min(chunk, S - c0);
      const int ntiles = (rows + kT - 1) / kT;
      __syncthreads();             // st written; cum/dts free
      if (tid < 32) {              // dt and its inclusive cumsum, warp 0
        float v[kMaxChunk / 32];
        float run = 0.f;
#pragma unroll
        for (int e = 0; e < kMaxChunk / 32; ++e) {
          if (e < per) {
            const int r = tid * per + e;
            const float d = r < rows ? dtb[size_t(c0 + r) * H] : 0.f;
            dts[r] = d;
            run += d * a;
            v[e] = run;
          }
        }
        float tot = run;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float t = __shfl_up_sync(0xffffffffu, tot, o);
          if (tid >= o) tot += t;
        }
        const float before = tot - run;
#pragma unroll
        for (int e = 0; e < kMaxChunk / 32; ++e)
          if (e < per) cum[tid * per + e] = v[e] + before;
      }
      __syncthreads();
      const float cum_last = cum[chunk - 1];

      float sacc[PJ][NJ];          // state update (last live query tile)
#pragma unroll
      for (int i = 0; i < PJ; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) sacc[i][j] = 0.f;

      for (int qi = 0; qi < ntiles; ++qi) {
        const bool last = qi == ntiles - 1;
        __syncthreads();           // cs free (previous tile's carried term)
        stage<N>(cs, NP, cb + size_t(c0 + qi * kT) * brow, brow,
                 rows - qi * kT);
        float yacc[4][PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) yacc[i][j] = 0.f;

        for (int kj = 0; kj <= qi; ++kj) {
          __syncthreads();         // bs, xs, ss free
          const size_t r0 = size_t(c0 + kj * kT);
          stage<N>(bs, NP, bb + r0 * brow, brow, rows - kj * kT);
          stage<P>(xs, P, xb + r0 * xrow, xrow, rows - kj * kT);
          __syncthreads();

          // scores C.B^T of the 64 x 64 tile pair, 4 x 4 per thread
          float sc[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
          for (int n = 0; n < N; n += 4) {
            float4 cv[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              cv[i] = *reinterpret_cast<const float4*>(cs + (ty + 16 * i) * NP + n);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              bv[j] = *reinterpret_cast<const float4*>(bs + (tx + 16 * j) * NP + n);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) sc[i][j] = dot4(cv[i], bv[j], sc[i][j]);
          }
          // causal mask, decay exp(cs[q] - cs[k]) (<= 0 exponent), dt[k]
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int q = qi * kT + ty + 16 * i;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int k = kj * kT + tx + 16 * j;
              ss[(ty + 16 * i) * SP + tx + 16 * j] =
                  k <= q ? sc[i][j] * expf(cum[q] - cum[k]) * dts[k] : 0.f;
            }
          }
          __syncthreads();

          // y += scores . x
#pragma unroll 2
          for (int k = 0; k < kT; k += 4) {
            float4 sv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              sv[i] = *reinterpret_cast<const float4*>(ss + (ty + 16 * i) * SP + k);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              float xv[PJ];
#pragma unroll
              for (int j = 0; j < PJ; ++j) xv[j] = xs[(k + kk) * P + tx + 16 * j];
#pragma unroll
              for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < PJ; ++j)
                  yacc[i][j] = fmaf(lane(sv[i], kk), xv[j], yacc[i][j]);
            }
          }

          if (last) {
            // state += (x dt exp(cs[Q-1] - cs))^T B over this key tile
#pragma unroll 4
            for (int k = 0; k < kT; ++k) {
              const int kr = kj * kT + k;
              const float w = dts[kr] * expf(cum_last - cum[kr]);
              float xv[PJ], bv[NJ];
#pragma unroll
              for (int i = 0; i < PJ; ++i) xv[i] = xs[k * P + ty + 16 * i] * w;
#pragma unroll
              for (int j = 0; j < NJ; ++j) bv[j] = bs[k * NP + tx + 16 * j];
#pragma unroll
              for (int i = 0; i < PJ; ++i)
#pragma unroll
                for (int j = 0; j < NJ; ++j)
                  sacc[i][j] = fmaf(xv[i], bv[j], sacc[i][j]);
            }
          }
        }

        // carried-in state: y += exp(cs[q]) C[q] . state^T
        float cst[4][PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) cst[i][j] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; n += 4) {
          float4 cv[4], sv[PJ];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            cv[i] = *reinterpret_cast<const float4*>(cs + (ty + 16 * i) * NP + n);
#pragma unroll
          for (int j = 0; j < PJ; ++j)
            sv[j] = *reinterpret_cast<const float4*>(st + (tx + 16 * j) * NP + n);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < PJ; ++j) cst[i][j] = dot4(cv[i], sv[j], cst[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = qi * kT + ty + 16 * i;
          if (q < rows) {
            const float d = expf(cum[q]);
#pragma unroll
            for (int j = 0; j < PJ; ++j)
              yb[size_t(c0 + q) * xrow + tx + 16 * j] =
                  fmaf(d, cst[i][j], yacc[i][j]);
          }
        }
      }

      __syncthreads();             // every read of the old state is done
      const float decay = expf(cum_last);
#pragma unroll
      for (int i = 0; i < PJ; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float& s = st[(ty + 16 * i) * NP + tx + 16 * j];
          s = fmaf(s, decay, sacc[i][j]);
        }
    }

    __syncthreads();
    for (int i = tid; i < P * N; i += kThreads)
      fin[size_t(bh) * P * N + i] = st[(i / N) * NP + i % N];
  }
}

template <int P, int N>
int launch(const float* x, const float* dt, const float* A, const float* Bm,
           const float* Cm, const float* init, float* y, float* fin, int Bt,
           int S, int H, int G, int chunk, int heads_block,
           cudaStream_t stream) {
  const size_t smem = Layout<P, N>::kBytes;
  auto kern = ssd_scan_kernel<P, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kern<<<Bt * H / heads_block, kThreads, smem, stream>>>(
      x, dt, A, Bm, Cm, init, y, fin, S, H, G, chunk, heads_block);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (B, S, H, P); dt (B, S, H); A (H,); Bm, Cm (B, S, G, N); init
// (B, H, P, N) or null for a zero state; y (B, S, H, P); fin (B, H, P, N).
// All fp32, contiguous, 16-byte aligned.  chunk in {64, 128, 256};
// heads_block divides H; G divides H.  Returns a cudaError_t (0 =
// launched).
int ssd_scan(const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, const void* init, void* y, void* fin, int B,
             int S, int H, int P, int G, int N, int chunk, int heads_block,
             void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G || heads_block <= 0 ||
      H % heads_block || chunk % kT || chunk > kMaxChunk)
    return int(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* df = static_cast<const float*>(dt);
  const auto* af = static_cast<const float*>(A);
  const auto* bf = static_cast<const float*>(Bm);
  const auto* cf = static_cast<const float*>(Cm);
  const auto* inf = static_cast<const float*>(init);
  auto* yf = static_cast<float*>(y);
  auto* ff = static_cast<float*>(fin);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_SSD_CASE(PP, NN)                                             \
  if (P == PP && N == NN)                                                  \
    return launch<PP, NN>(xf, df, af, bf, cf, inf, yf, ff, B, S, H, G,     \
                          chunk, heads_block, s);
  REPRO_SSD_CASE(64, 128)          // mamba2-2.7b
  REPRO_SSD_CASE(32, 16)           // mamba2, reduced
  REPRO_SSD_CASE(64, 16)           // hymba-1.5b
#undef REPRO_SSD_CASE
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
