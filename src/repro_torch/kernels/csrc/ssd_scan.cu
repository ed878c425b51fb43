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
// from fp32 inputs, decays and workspaces, every product summed in fp64
// on the tensor cores (ssd_common.cuh).  Every decay is exp of a
// difference <= 0 (A < 0, dt >= 0): never exp(cs[q]) * exp(-cs[k]), which
// overflows once cs reaches -88 (A down to -16 at dt ~ 0.13 gets there
// within one chunk).
//
// Supersets of the Pallas contract: any S (rows past S read as dt = 0,
// x = 0, which is exactly the reference's zero padding, and write
// nothing, so the final state is the state after the last live row); B and
// C as (B, S, G, N), head h reading group h / (H / G), so the G = 1 model
// never materialises an 80x copy of them; an optional initial state in and
// the final state out, (B, H, P, N).
//
// What bounds it on the H100: operations.  Per (head, chunk) the chunked
// algorithm does Q(Q+1)(N + P) + 4QPN flops (the causal halves of C.B^T
// and of scores.x, then the carried-state term and the state update)
// against (2P + 1) Q * 4 bytes of its own x, dt and y (B and C are shared
// by a group's heads): ~160 flops a byte at Q = 256, P = 64, N = 128, far
// above the ~20 that the card's fp64 tensor-core rate (the same 67
// TFLOP/s as its fp32 CUDA cores) needs.
//
// The design runs the chunks of one (batch, head) on different SMs, in the
// three passes of the SSD formulation, each its own kernel on the stream:
//   1. chunk state, grid B * H * nc: the chunk's cumsum and its local end
//      state sum_k (x dt exp(cs[Q-1] - cs))^T B, to the fp32 chunk states
//      (B, nc, H, N, P) (transposed, so that pass 3 reads it as it reads
//      x; the caller keeps them for the backward), and its total decay
//      log cs[Q-1] to (B, H, nc).  The chunk's raw causal score tiles
//      C.B^T depend on the group, not the head, so the group's heads
//      share them out and each is computed once, in fp64, to (B, G, nc,
//      pairs, 64, 64);
//   2. state passing, one thread per (batch, head, p, n), serial over the
//      nc chunks only: overwrites each chunk's local state with the state
//      carried into it, and writes the final state;
//   3. chunk scan, grid B * H * nc * (Q / 64), one CTA per 64-row query
//      tile (the tiles with the most key tiles launch first): this head's
//      causal mask and decay applied to each raw score tile, the
//      intra-chunk term scores.x, then the carried-in term C.state^T.
//      Both products run on the tensor cores in fp64 (mma.sync m8n8k4).
//      An fp32 accumulation on the tensor cores (TF32, or 3xTF32's
//      three split products) keeps the largest term's exponent: on an
//      H100 it erred 2.6e-3 of a row whose terms cancel, against an
//      fp64 reference and the 1e-3 row tolerance, where the fp32 plain
//      version erred 8.2e-4 and fp64 products 1.1e-4.
// Operand tiles are staged by cp.async, double-buffered (the next key
// tile's B and x, or scores and x, or the carried state, load while this
// one is used), with row pitches that make every fragment read
// conflict-free (C, and B where it is read transposed, padded by 4
// floats; x, the state, and B where it is read row-wise, by 8); passes 1
// and 3 each fit two CTAs an SM.  Every product, pass 1's state sum
// included, runs in fp64.  Causal tiles above the diagonal are
// never computed, and query tiles wholly past S exit at once.
// heads_block (the plan's heads per CTA on the TPU grid) is still taken
// and validated, but the grid no longer uses it: every CTA owns one
// (batch, head, chunk).

#include "ssd_common.cuh"

namespace {

using namespace repro::ssd;

template <int P, int N>
struct Layout {
  static constexpr int kNP = N + 4;     // row pitch of C and B
  static constexpr int kXP = P + 8;     // row pitch of x and the state
  static constexpr int kSP = kT + 4;    // row pitch of a score tile (pass 3)
  static constexpr int kNB = N + 8;     // row pitch of B in pass 1's sum
  static constexpr int kKey = kT * kNB + kT * kXP;  // pass 1: one B + x stage
  // pass 3: one stage holds a score tile and an x tile, or the state
  static constexpr int kScanStage =
      kT * kSP + kT * kXP > N * kXP ? kT * kSP + kT * kXP : N * kXP;
  // pass 1: two B/x stages (then a C and a B tile for the scores), cum, dt
  static constexpr size_t kStateBytes =
      (2 * size_t(kKey) + 2 * kMaxChunk) * sizeof(float);
  // pass 3: C, two stages, cum and dt
  static constexpr size_t kScanBytes =
      (size_t(kT) * kNP + 2 * size_t(kScanStage) + 2 * kMaxChunk) *
      sizeof(float);
};

// The (query tile, key tile) pairs of a chunk's causal score tiles:
// pair (qi, kj), kj <= qi, is number qi (qi + 1) / 2 + kj.
__host__ __device__ __forceinline__ int n_pairs(int chunk) {
  return (chunk / kT) * (chunk / kT + 1) / 2;
}

// Pass 1: the local end state of chunk c of (b, h), and its decay log.
template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_state(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, float* __restrict__ states,
                float* __restrict__ cs_last, float* __restrict__ scores,
                int S, int H, int G, int chunk, int nc) {
  using L = Layout<P, N>;
  constexpr int NP = L::kNP, NB = L::kNB, XP = L::kXP;
  extern __shared__ __align__(16) float smem[];
  float* cum = smem + 2 * L::kKey;
  float* dts = cum + kMaxChunk;

  const int c = blockIdx.x % nc;
  const int bh = blockIdx.x / nc;
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int tid = threadIdx.x;
  const int c0 = c * chunk;
  const int rows = min(chunk, S - c0);
  const int ntiles = (rows + kT - 1) / kT;
  const size_t xrow = size_t(H) * P, brow = size_t(G) * N;
  const float* xb = x + (size_t(b) * S + c0) * xrow + size_t(h) * P;
  const float* bb = Bm + (size_t(b) * S + c0) * brow + size_t(g) * N;

  auto issue = [&](int kj) {
    float* bs = smem + (kj & 1) * L::kKey;
    stage_async<N>(bs, NB, bb + size_t(kj) * kT * brow, brow,
                   rows - kj * kT);
    stage_async<P>(bs + kT * NB, XP, xb + size_t(kj) * kT * xrow, xrow,
                   rows - kj * kT);
    repro::cp_async_commit();
  };
  issue(0);
  chunk_cumsum(cum, dts, dt + (size_t(b) * S + c0) * H + h, H, A[h], chunk,
               rows);
  __syncthreads();
  const float cum_last = cum[chunk - 1];
  // each row's weight dt exp(cs[Q-1] - cs), once for the chunk
  for (int r = tid; r < chunk; r += kThreads)
    dts[r] *= expf(cum_last - cum[r]);
  __syncthreads();

  // state (P, N) = (x w)^T B over the chunk's rows, in fp64: warp w owns
  // the 16 state rows of m-tile w % MT and NTW n-tiles of 8 columns
  constexpr int MT = P / 16, NTT = N / 8, WPM = 8 / MT;
  constexpr int NTW = NTT / WPM > 0 ? NTT / WPM : 1;
  const int warp = tid / 32, lane = tid % 32;
  const int lg = lane / 4, lt = lane % 4;
  const int mt = warp % MT, nt0 = warp / MT * NTW;
  double sacc[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[j][e] = 0.0;

  for (int kj = 0; kj < ntiles; ++kj) {
    if (kj + 1 < ntiles) {
      issue(kj + 1);
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();
    const float* bs = smem + (kj & 1) * L::kKey;
    float* xs = smem + (kj & 1) * L::kKey + kT * NB;
    for (int i = tid; i < kT * P; i += kThreads)
      xs[(i / P) * XP + i % P] *= dts[kj * kT + i / P];
    __syncthreads();
    if (nt0 < NTT)
      warp_mma<NTW, false, true>(sacc, xs + mt * 16, XP, bs + nt0 * 8, NB,
                                 kT);
    __syncthreads();             // this stage is free for the next issue
  }

  // the state is stored transposed, (N, P): the chunk scan reads it as it
  // reads x
  float* out = states + ((size_t(b) * nc + c) * H + h) * P * N;
  if (nt0 < NTT) {
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[((nt0 + j) * 8 + 2 * lt + e % 2) * P + mt * 16 + lg +
            8 * (e / 2)] = float(sacc[j][e]);
  }
  if (tid == 0) cs_last[size_t(bh) * nc + c] = cum_last;

  // The raw score tiles C.B^T of this chunk depend on its group only, not
  // the head: the group's heads share them out, each CTA computing pairs
  // r, r + H / G, ... (r its head's rank in the group), in fp64.
  const int heads = H / G;
  const int m0 = 16 * (warp % 4), n0 = 32 * (warp / 4);
  const float* cb = Cm + (size_t(b) * S + c0) * brow + size_t(g) * N;
  float* sc_out = scores + ((size_t(b) * G + g) * nc + c) * n_pairs(chunk) *
                               kT * kT;
  for (int pi = h % heads; pi < n_pairs(chunk); pi += heads) {
    int qi = 0;
    while ((qi + 1) * (qi + 2) / 2 <= pi) ++qi;
    const int kj = pi - qi * (qi + 1) / 2;
    __syncthreads();             // the stages are free
    stage_async<N>(smem, NP, cb + size_t(qi) * kT * brow, brow,
                   rows - qi * kT);
    stage_async<N>(smem + kT * NP, NP, bb + size_t(kj) * kT * brow, brow,
                   rows - kj * kT);
    repro::cp_async_commit();
    repro::cp_async_wait<0>();
    __syncthreads();
    double sc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.0;
    warp_mma<4, true>(sc, smem + m0 * NP, NP, smem + (kT + n0) * NP, NP, N);
    float* o = sc_out + size_t(pi) * kT * kT;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(o + (m0 + lg + 8 * hf) * kT + n0 + 8 * j +
                                   2 * lt) =
            make_float2(float(sc[j][2 * hf]), float(sc[j][2 * hf + 1]));
  }
}

// Pass 2: one thread per (b, h, n, p) element walks the chunks in order,
// replacing each chunk's local state with the state carried into it.
// states are (N, P); init and fin are (P, N).  Loads run
// kBatch chunks ahead of the dependent chain.  no_carry is a planted fault
// for the checks: each chunk after the first starts from a zero state.
constexpr int kBatch = 8;

__global__ void __launch_bounds__(kThreads)
ssd_state_pass(float* __restrict__ states, const float* __restrict__ cs_last,
               const float* __restrict__ init, float* __restrict__ fin,
               int Bt, int H, int P, int N, int nc, int no_carry) {
  const size_t PN = size_t(P) * N;
  const size_t e = size_t(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= size_t(Bt) * H * PN) return;
  const size_t bh = e / PN, np = e % PN;
  const size_t b = bh / H, h = bh % H;
  const size_t pn = (np % P) * N + np / P;         // (p, n) in init / fin
  float s = init ? init[bh * PN + pn] : 0.f;
  for (int c0 = 0; c0 < nc; c0 += kBatch) {
    float local[kBatch], decay[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (c0 + i < nc) {
        local[i] = states[((b * nc + c0 + i) * H + h) * PN + np];
        decay[i] = expf(cs_last[bh * nc + c0 + i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (c0 + i < nc) {
        if (no_carry && c0 + i > 0) s = 0.f;
        states[((b * nc + c0 + i) * H + h) * PN + np] = s;
        s = fmaf(s, decay[i], local[i]);
      }
    }
  }
  fin[bh * PN + pn] = s;
}

// Pass 3: y of query tile qi of chunk c of (b, h), its products in
// fp64 on the tensor cores.  Each key tile's raw scores come from pass 1;
// the CTA applies this head's causal mask and decay to them in shared
// memory.  Warp w owns rows m0 = 16 (w % 4) of the tile and columns
// P/2 (w / 4) of y.
template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_scan(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Cm,
               const float* __restrict__ states,
               const float* __restrict__ scores, float* __restrict__ y,
               int S, int H, int G, int chunk, int nc) {
  using L = Layout<P, N>;
  constexpr int NP = L::kNP, XP = L::kXP, SP = L::kSP;
  constexpr int YT = P / 16;       // y column tiles of 8 per warp
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;                // (kT, NP) C rows of the query tile
  float* stg = cs + kT * NP;       // two stages: scores (kT, SP) + x (kT,
                                   // XP), or the carried state (N, XP)
  float* cum = stg + 2 * L::kScanStage;   // (chunk) cumsum of dt * A
  float* dts = cum + kMaxChunk;           // (chunk) dt

  const int n_bhc = gridDim.x / (chunk / kT);
  const int qi = chunk / kT - 1 - blockIdx.x / n_bhc;   // longest first
  const int bhc = blockIdx.x % n_bhc;
  const int c = bhc % nc, bh = bhc / nc;
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int c0 = c * chunk;
  const int rows = min(chunk, S - c0);
  if (qi * kT >= rows) return;     // a query tile wholly past S
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int lg = lane / 4, lt = lane % 4;
  const int m0 = 16 * (warp % 4), p0 = P / 2 * (warp / 4);
  const size_t xrow = size_t(H) * P, brow = size_t(G) * N;
  const float* xb = x + (size_t(b) * S + c0) * xrow + size_t(h) * P;
  const float* cb = Cm + (size_t(b) * S + c0) * brow + size_t(g) * N;
  const float* sc_in = scores + (((size_t(b) * G + g) * nc + c) *
                                     n_pairs(chunk) + qi * (qi + 1) / 2) *
                                    kT * kT;

  auto issue = [&](int kj) {
    float* st = stg + (kj & 1) * L::kScanStage;
    stage_async<kT>(st, SP, sc_in + size_t(kj) * kT * kT, kT, kT);
    stage_async<P>(st + kT * SP, XP, xb + size_t(kj) * kT * xrow, xrow,
                   rows - kj * kT);
  };
  stage_async<N>(cs, NP, cb + size_t(qi) * kT * brow, brow, rows - qi * kT);
  issue(0);
  repro::cp_async_commit();
  chunk_cumsum(cum, dts, dt + (size_t(b) * S + c0) * H + h, H, A[h], chunk,
               rows);

  double yacc[YT][4];
#pragma unroll
  for (int j = 0; j < YT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) yacc[j][e] = 0.0;

  for (int kj = 0; kj <= qi; ++kj) {
    if (kj < qi) {
      issue(kj + 1);
    } else {                     // the carried-in state, stored (N, P)
      stage_async<P, N>(stg + ((kj + 1) & 1) * L::kScanStage, XP,
                        states + ((size_t(b) * nc + c) * H + h) * P * N, P,
                        N);
    }
    repro::cp_async_commit();
    repro::cp_async_wait<1>();
    __syncthreads();
    float* ss = stg + (kj & 1) * L::kScanStage;
    // this head's causal mask, decay exp(cs[q] - cs[k]) (<= 0 exponent)
    // and dt[k], applied to the raw scores in place
    for (int i = tid; i < kT * kT; i += kThreads) {
      const int r = i / kT, col = i % kT;
      const int q = qi * kT + r, k = kj * kT + col;
      float& v = ss[r * SP + col];
      v = k <= q ? v * expf(cum[q] - cum[k]) * dts[k] : 0.f;
    }
    __syncthreads();
    warp_mma<YT, false>(yacc, ss + m0 * SP, SP, ss + kT * SP + p0, XP, kT);
    __syncthreads();             // this stage is free
  }
  repro::cp_async_wait<0>();
  __syncthreads();

  // carried-in state: y += exp(cs[q]) C[q] . state^T
  double cst[YT][4];
#pragma unroll
  for (int j = 0; j < YT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) cst[j][e] = 0.0;
  warp_mma<YT, false>(cst, cs + m0 * NP, NP,
                      stg + ((qi + 1) & 1) * L::kScanStage + p0, XP, N);
  float* yb = y + (size_t(b) * S + c0) * xrow + size_t(h) * P;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int q = qi * kT + m0 + lg + 8 * hf;
    if (q < rows) {
      const double d = expf(cum[q]);
#pragma unroll
      for (int j = 0; j < YT; ++j)
        *reinterpret_cast<float2*>(yb + size_t(q) * xrow + p0 + 8 * j +
                                   2 * lt) =
            make_float2(float(fma(d, cst[j][2 * hf], yacc[j][2 * hf])),
                        float(fma(d, cst[j][2 * hf + 1], yacc[j][2 * hf + 1])));
    }
  }
}

template <int P, int N>
int launch(const float* x, const float* dt, const float* A, const float* Bm,
           const float* Cm, const float* init, float* y, float* fin,
           float* states, float* ws, int Bt, int S, int H, int G, int chunk,
           int no_carry, cudaStream_t stream) {
  using L = Layout<P, N>;
  const int nc = (S + chunk - 1) / chunk;
  float* cs_last = ws;                                // (B, H, nc)
  // (B, G, nc, pairs, 64, 64), 16-byte aligned for cp.async
  float* scores = cs_last + ((size_t(Bt) * H * nc + 3) & ~size_t(3));
  cudaError_t err = allow_smem(ssd_chunk_state<P, N>, L::kStateBytes);
  if (err == cudaSuccess) err = allow_smem(ssd_chunk_scan<P, N>, L::kScanBytes);
  if (err != cudaSuccess) return int(err);
  ssd_chunk_state<P, N><<<Bt * H * nc, kThreads, L::kStateBytes, stream>>>(
      x, dt, A, Bm, Cm, states, cs_last, scores, S, H, G, chunk, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const size_t elems = size_t(Bt) * H * P * N;
  ssd_state_pass<<<unsigned((elems + kThreads - 1) / kThreads), kThreads, 0,
                   stream>>>(states, cs_last, init, fin, Bt, H, P, N, nc,
                             no_carry);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  ssd_chunk_scan<P, N><<<Bt * H * nc * (chunk / kT), kThreads, L::kScanBytes,
                         stream>>>(x, dt, A, Cm, states, scores, y, S, H, G,
                                   chunk, nc);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (B, S, H, P); dt (B, S, H); A (H,); Bm, Cm (B, S, G, N); init
// (B, H, P, N) or null for a zero state; y (B, S, H, P); fin (B, H, P, N);
// states (B, nc, H, N, P), nc = ceil(S / chunk): the state carried into
// each chunk, transposed (the backward reads them); ws: fp32 workspace,
// B * H * nc decay logs rounded up to a multiple of 4, then B * G * nc *
// T (T + 1) / 2 score tiles of 64 x 64, T = chunk / 64.  All fp32,
// contiguous, 16-byte aligned.  chunk in {64, 128, 256}; heads_block
// divides H (validated, not used by the grid); G divides H.  no_carry:
// 0, or a planted fault (no state passed between chunks).  Three
// launches on `stream`.  Returns a cudaError_t (0 = launched).
int ssd_scan(const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, const void* init, void* y, void* fin,
             void* states, void* ws, int B, int S, int H, int P, int G,
             int N, int chunk, int heads_block, int no_carry,
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
  auto* sf = static_cast<float*>(states);
  auto* wf = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_SSD_CASE(PP, NN)                                              \
  if (P == PP && N == NN)                                                   \
    return launch<PP, NN>(xf, df, af, bf, cf, inf, yf, ff, sf, wf, B, S, H, \
                          G, chunk, no_carry, s);
  REPRO_SSD_CASE(64, 128)          // mamba2-2.7b
  REPRO_SSD_CASE(32, 16)           // mamba2, reduced
  REPRO_SSD_CASE(64, 16)           // hymba-1.5b
#undef REPRO_SSD_CASE
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
