// Mamba2 SSD chunked scan, backward (state-space duality, arXiv:2405.21060
// §6, run in reverse).
//
// The TPU repository has no backward kernel for the SSD scan: its training
// path differentiates the jnp mirror ssd_chunked (src/repro/models/ssm.py:53)
// with XLA.  This is the gradient of the forward kernel ssd_scan.cu (which
// replaces the Pallas ssd_scan, src/repro/kernels/ssd_scan.py:83).
//
// Per (batch, head) and chunk, with cs = cumsum(dt A) inside the chunk,
// xdt = x dt, S_in the state carried into the chunk and S_out the state
// it carries out, the forward is
//   y[q]  = sum_{k<=q} (C[q].B[k]) exp(cs[q]-cs[k]) xdt[k] + exp(cs[q]) S_in C[q]
//   S_out = exp(cs[Q-1]) S_in + sum_k exp(cs[Q-1]-cs[k]) xdt[k] (x) B[k]
// and, given dy and the final state's gradient dS_fin, the backward is
//   dS_in  = exp(cs[Q-1]) dS_out + sum_q exp(cs[q]) dy[q] (x) C[q]
//            (dS_out of the last chunk = dS_fin; dS_in of chunk 0 = the
//            initial state's gradient)
//   dxdt[k] = sum_{q>=k} (C[q].B[k]) exp(cs[q]-cs[k]) dy[q]
//             + exp(cs[Q-1]-cs[k]) dS_out B[k]
//   dB[k]  = sum_{q>=k} exp(cs[q]-cs[k]) (dy[q].xdt[k]) C[q]
//             + exp(cs[Q-1]-cs[k]) dS_out^T xdt[k]
//   dC[q]  = sum_{k<=q} exp(cs[q]-cs[k]) (dy[q].xdt[k]) B[k]
//             + exp(cs[q]) S_in^T dy[q]
//   dcs[t] = dy[t].y[t] - xdt[t].dxdt[t]  (+ <dS_out, S_out> at t = Q-1)
//   d(dt A)[t] = sum_{q>=t} dcs[q];  ddt = A d(dt A) + x.dxdt;
//   dA = sum over batch and sequence of dt d(dt A);  dx = dxdt dt.
// dcs collects every place cs appears: the q side of the decays gives
// dy.y (y being the scan's output before the D skip), the k side
// -xdt.dxdt, and the chunk's total decay <dS_out, S_out>.  B and C are
// shared by a group's heads, so dB and dC sum over them.  As in the
// forward, every decay is exp of a difference <= 0 and every product is
// summed in fp64 on the tensor cores (ssd_common.cuh).
//
// What bounds it on the H100: operations, as the forward.  Per (head,
// chunk) the gradient needs Q(Q+1)(3N + 2P) + 8QPN flops (the causal
// halves of C.B^T and of dy.xdt^T, whose one decayed tile gives dB over
// the queries and dC over the keys, and the three products that apply
// them; four state products) against 4 (3P + 2) Q bytes of its own x, y,
// dy, dx, dt and ddt: ~250 flops a byte at Q = 256, P = 64, N = 128.
// This kernel forms dy.xdt^T a second time on the query side (pass 4),
// Q(Q+1)P flops more than the bound counts.
//
// The design: six launches on the stream, none with atomics (a resumed
// run stays bitwise equal), every reduction in a fixed order.
//   1. chunk dstate, grid B * H * nc: the chunk's cumsum, its decay log
//      cs[Q-1] to (B, H, nc), and its local sum_q exp(cs[q]) dy[q] (x) C[q]
//      to the workspace's (B, nc, H, N, P);
//   2. state passing backward, one thread per (batch, head, n, p), serial
//      over the chunks from the last: replaces each chunk's local term with
//      the chunk's dS_out, and writes the initial state's gradient.  This is
//      the twin of the forward's pass 2; no_carry plants a fault (no
//      gradient passes between chunks);
//   3. key side, grid B * H * nc * (Q / 64), one CTA per 64 key rows: the
//      state terms of dxdt and dB first, then for each query tile q >= k
//      the raw tiles C.B^T and dy.xdt^T (fp64), masked and decayed in fp32
//      in shared memory, and their products with dy and C.  Writes dx, the
//      head's dB rows, and the rows' dy.y - xdt.dxdt and x.dxdt (fp64);
//      skip_tile plants a fault (the diagonal query tile is left out);
//   4. query side, grid B * H * nc * (Q / 64), one CTA per 64 query rows:
//      the carried-in state's term of dC, then for each key tile k <= q
//      dy.xdt^T, masked and decayed, times B.  Writes the head's dC rows;
//   5. dt, grid B * H * nc: <dS_out, S_out> (S_out the next chunk's
//      incoming state, or the final state), the reverse cumsum of dcs in
//      fp64, ddt, and the chunk's share of dA;
//   6. reduce: dB and dC summed over the group's heads and dA over batch
//      and chunks, in fp64, in a fixed order.
// The chunk states S_in come from the forward (its pass 2 writes them; the
// autograd function keeps them: B * nc * H * P * N floats a call, 21 MB for
// a mamba2-2.7b layer at S = 2048), so nothing of the forward is
// recomputed.  A simple kernel: one staged tile at a time (no double
// buffering), one CTA per tile of rows.

#include "ssd_common.cuh"

namespace {

using namespace repro::ssd;

// Row pitches: a tile read as the A operand or as B^T (rows of K) takes
// width + 4, one read as B (K down the rows) width + 8, so that the
// fragment reads of warp_mma are conflict-free; a tile read both ways
// keeps width + 4 (two-way conflicts on the other reads).
template <int P, int N>
struct Bwd {
  static constexpr int kNA = N + 4;
  static constexpr int kNB = N + 8;
  static constexpr int kPA = P + 4;
  static constexpr int kPB = P + 8;
  static constexpr int kSP = kT + 4;
  // pass 1: dy (kT, P + 8) read transposed, C (kT, N + 8), cum, dt
  static constexpr size_t kDstateBytes =
      (size_t(kT) * kPB + size_t(kT) * kNB + 2 * kMaxChunk) * sizeof(float);
  // pass 3: B, xdt (key rows), C, dy (query rows), two weighted 64 x 64
  // tiles, cum, dt; dS_out (N, P + 8) first, where C and dy go later
  static constexpr int kKeyFloats = kT * kNA + kT * kPA + kT * kNA +
                                    kT * kPA + 2 * kT * kSP + 2 * kMaxChunk;
  static_assert(N * kPB <= kT * kNA + kT * kPA, "dS_out fits C + dy");
  static constexpr size_t kKeyBytes = size_t(kKeyFloats) * sizeof(float);
  // pass 4: dy (query rows), xdt, B (key rows), the weighted tile, cum,
  // dt; S_in (N, P + 4) first, where xdt and B go later
  static constexpr int kQueryFloats =
      kT * kPA + kT * kPA + kT * kNB + kT * kSP + 2 * kMaxChunk;
  static_assert(N * kPA <= kT * kPA + kT * kNB, "S_in fits xdt + B");
  static constexpr size_t kQueryBytes = size_t(kQueryFloats) * sizeof(float);
};

__device__ __forceinline__ double warp_sum_d(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Scale the rows of a warp's accumulator tile (warp_mma's layout): its
// row g by f0, its row g + 8 by f1.
template <int NT>
__device__ __forceinline__ void scale_rows(double (&acc)[NT][4], float f0,
                                           float f1) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    acc[j][0] *= f0;
    acc[j][1] *= f0;
    acc[j][2] *= f1;
    acc[j][3] *= f1;
  }
}

// A warp's 16 x 32 slice of a 64 x 64 raw tile, masked to k <= q and
// decayed by exp(cs[q] - cs[k]) in fp32, to shared memory (pitch kSP).
// `rows_are_q`: the tile's rows are queries (pass 4) or keys (pass 3).
__device__ __forceinline__ void store_weighted(float* dst, const double (&t)[4][4],
                                               const float* cum, int m0,
                                               int s0, int row0, int col0,
                                               bool rows_are_q) {
  const int lane = threadIdx.x % 32, lg = lane / 4, lt = lane % 4;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = m0 + lg + 8 * (e / 2), col = s0 + 8 * j + 2 * lt + e % 2;
      const int q = rows_are_q ? row0 + r : col0 + col;
      const int k = rows_are_q ? col0 + col : row0 + r;
      const float w = k <= q ? expf(cum[q] - cum[k]) : 0.f;
      dst[r * (kT + 4) + col] = float(t[j][e] * double(w));
    }
}

// Pass 1: the chunk's decay log and its local sum_q exp(cs[q]) dy[q] (x) C[q],
// stored (N, P) as the forward stores its states.
template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dstate(const float* __restrict__ dy, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Cm,
               float* __restrict__ dstates, float* __restrict__ cs_last,
               int S, int H, int G, int chunk, int nc) {
  using L = Bwd<P, N>;
  constexpr int DP = L::kPB, CP = L::kNB;
  extern __shared__ __align__(16) float smem[];
  float* ds = smem;                // (kT, DP) dy rows, times exp(cs)
  float* ct = ds + kT * DP;        // (kT, CP) C rows
  float* cum = ct + kT * CP;
  float* dts = cum + kMaxChunk;

  const int c = blockIdx.x % nc, bh = blockIdx.x / nc;
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int tid = threadIdx.x, c0 = c * chunk;
  const int rows = min(chunk, S - c0);
  const size_t xrow = size_t(H) * P, brow = size_t(G) * N;
  const float* dyb = dy + (size_t(b) * S + c0) * xrow + size_t(h) * P;
  const float* cb = Cm + (size_t(b) * S + c0) * brow + size_t(g) * N;
  chunk_cumsum(cum, dts, dt + (size_t(b) * S + c0) * H + h, H, A[h], chunk,
               rows);
  __syncthreads();
  if (tid == 0) cs_last[size_t(bh) * nc + c] = cum[chunk - 1];

  // warp w owns the 16 rows (of P) of m-tile w % MT and NTW n-tiles of 8
  constexpr int MT = P / 16, NTT = N / 8, WPM = 8 / MT;
  constexpr int NTW = NTT / WPM > 0 ? NTT / WPM : 1;
  const int warp = tid / 32, lane = tid % 32, lg = lane / 4, lt = lane % 4;
  const int mt = warp % MT, nt0 = warp / MT * NTW;
  double acc[NTW][4] = {};
  for (int qi = 0; qi * kT < rows; ++qi) {
    __syncthreads();             // the last tile's reads are done
    stage_async<P>(ds, DP, dyb + size_t(qi) * kT * xrow, xrow,
                   rows - qi * kT);
    stage_async<N>(ct, CP, cb + size_t(qi) * kT * brow, brow, rows - qi * kT);
    repro::cp_async_commit();
    repro::cp_async_wait<0>();
    __syncthreads();
    for (int i = tid; i < kT * P; i += kThreads)
      ds[(i / P) * DP + i % P] *= expf(cum[qi * kT + i / P]);
    __syncthreads();
    if (nt0 < NTT)
      warp_mma<NTW, false, true>(acc, ds + mt * 16, DP, ct + nt0 * 8, CP, kT);
  }
  float* out = dstates + ((size_t(b) * nc + c) * H + h) * P * N;
  if (nt0 < NTT) {
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[((nt0 + j) * 8 + 2 * lt + e % 2) * P + mt * 16 + lg +
            8 * (e / 2)] = float(acc[j][e]);
  }
}

// Pass 2: one thread per (b, h, n, p) walks the chunks from the last,
// replacing each chunk's local term with the gradient of the state it
// carries out.  dstates are (N, P); dfin and dinit (P, N), either null.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_state_pass(float* __restrict__ dstates,
                   const float* __restrict__ cs_last,
                   const float* __restrict__ dfin, float* __restrict__ dinit,
                   int Bt, int H, int P, int N, int nc, int no_carry) {
  const size_t PN = size_t(P) * N;
  const size_t e = size_t(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= size_t(Bt) * H * PN) return;
  const size_t bh = e / PN, np = e % PN;
  const size_t b = bh / H, h = bh % H;
  const size_t pn = (np % P) * N + np / P;
  float g = dfin ? dfin[bh * PN + pn] : 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    float* at = dstates + ((b * nc + c) * H + h) * PN + np;
    const float local = *at;
    if (no_carry && c < nc - 1) g = 0.f;
    *at = g;
    g = fmaf(g, expf(cs_last[bh * nc + c]), local);
  }
  if (dinit) dinit[bh * PN + pn] = g;
}

// Pass 3: the 64 key rows kj of chunk c of (b, h): dxdt (to dx), the
// head's dB rows, and the rows' terms of dcs (r = dy.y - xdt.dxdt) and of
// ddt (u = x.dxdt), fp64, to (B, H, S).  Warp w owns rows m0 = 16 (w % 4)
// and the half w / 4 of each product's columns.
template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_key(const float* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ A, const float* __restrict__ Bm,
            const float* __restrict__ Cm, const float* __restrict__ y,
            const float* __restrict__ dy, const float* __restrict__ dstates,
            float* __restrict__ dx, float* __restrict__ dBh,
            double* __restrict__ r_out, double* __restrict__ u_out, int S,
            int H, int G, int chunk, int nc, int skip_tile) {
  using L = Bwd<P, N>;
  constexpr int NA = L::kNA, PA = L::kPA, PB = L::kPB, SP = L::kSP;
  constexpr int NTX = P / 16, NTB = N / 16;   // n-tiles of dxdt, dB a warp
  extern __shared__ __align__(16) float smem[];
  float* bk = smem;                // (kT, NA) B of the key rows
  float* xk = bk + kT * NA;        // (kT, PA) xdt of the key rows
  float* cq = xk + kT * PA;        // (kT, NA) C of a query tile
  float* dq = cq + kT * NA;        // (kT, PA) dy of a query tile
  float* sw = dq + kT * PA;        // (kT, SP) weighted C.B^T, rows k
  float* dw = sw + kT * SP;        // (kT, SP) weighted dy.xdt^T, rows k
  float* cum = dw + kT * SP;
  float* dts = cum + kMaxChunk;
  float* ds = cq;                  // (N, PB) dS_out, before the query tiles

  const int nt = chunk / kT, n_bhc = gridDim.x / nt;
  const int kj = blockIdx.x / n_bhc;         // key tile 0 has most to do
  const int bhc = blockIdx.x % n_bhc, c = bhc % nc, bh = bhc / nc;
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int c0 = c * chunk, rows = min(chunk, S - c0);
  if (kj * kT >= rows) return;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int lg = lane / 4, lt = lane % 4;
  const int m0 = 16 * (warp % 4), half = warp / 4;
  const int p0 = P / 2 * half, n0 = N / 2 * half, s0 = 32 * half;
  const size_t xrow = size_t(H) * P, brow = size_t(G) * N;
  const size_t xoff = (size_t(b) * S + c0) * xrow + size_t(h) * P;
  const float* bb = Bm + (size_t(b) * S + c0) * brow + size_t(g) * N;
  const float* cb = Cm + (size_t(b) * S + c0) * brow + size_t(g) * N;
  const int k0 = kj * kT;

  stage_async<N>(bk, NA, bb + size_t(k0) * brow, brow, rows - k0);
  stage_async<P>(xk, PA, x + xoff + size_t(k0) * xrow, xrow, rows - k0);
  stage_async<P, N>(ds, PB, dstates + ((size_t(b) * nc + c) * H + h) * P * N,
                    P, N);
  repro::cp_async_commit();
  chunk_cumsum(cum, dts, dt + (size_t(b) * S + c0) * H + h, H, A[h], chunk,
               rows);
  repro::cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < kT * P; i += kThreads)
    xk[(i / P) * PA + i % P] *= dts[k0 + i / P];
  __syncthreads();

  // the state terms: B dS_out^T and xdt dS_out, each row decayed by
  // exp(cs[Q-1] - cs[k])
  double dxa[NTX][4] = {}, dba[NTB][4] = {};
  warp_mma<NTX, false>(dxa, bk + m0 * NA, NA, ds + p0, PB, N);
  warp_mma<NTB, true>(dba, xk + m0 * PA, PA, ds + n0 * PB, PB, P);
  {
    const float last = cum[chunk - 1];
    const float f0 = expf(last - cum[k0 + m0 + lg]);
    const float f1 = expf(last - cum[k0 + m0 + lg + 8]);
    scale_rows(dxa, f0, f1);
    scale_rows(dba, f0, f1);
  }
  __syncthreads();               // C and dy overwrite dS_out

  for (int qi = kj; qi * kT < rows; ++qi) {
    if (skip_tile && qi == kj) continue;
    const int q0 = qi * kT;
    stage_async<N>(cq, NA, cb + size_t(q0) * brow, brow, rows - q0);
    stage_async<P>(dq, PA, dy + xoff + size_t(q0) * xrow, xrow, rows - q0);
    repro::cp_async_commit();
    repro::cp_async_wait<0>();
    __syncthreads();
    {
      double sc[4][4] = {}, dd[4][4] = {};
      warp_mma<4, true>(sc, bk + m0 * NA, NA, cq + s0 * NA, NA, N);
      warp_mma<4, true>(dd, xk + m0 * PA, PA, dq + s0 * PA, PA, P);
      store_weighted(sw, sc, cum, m0, s0, k0, q0, false);
      store_weighted(dw, dd, cum, m0, s0, k0, q0, false);
    }
    __syncthreads();
    warp_mma<NTX, false>(dxa, sw + m0 * SP, SP, dq + p0, PA, kT);
    warp_mma<NTB, false>(dba, dw + m0 * SP, SP, cq + n0, NA, kT);
    __syncthreads();             // the stages are free
  }

  // this head's dB rows
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int k = k0 + m0 + lg + 8 * hf;
    if (k < rows) {
#pragma unroll
      for (int j = 0; j < NTB; ++j)
        *reinterpret_cast<float2*>(
            dBh + ((size_t(b) * S + c0 + k) * H + h) * N + n0 + 8 * j +
            2 * lt) = make_float2(float(dba[j][2 * hf]),
                                  float(dba[j][2 * hf + 1]));
    }
  }
  // dxdt through shared memory (sw is free), then dx and the row terms
  float* gx = sw;
#pragma unroll
  for (int j = 0; j < NTX; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      gx[(m0 + lg + 8 * (e / 2)) * SP + p0 + 8 * j + 2 * lt + e % 2] =
          float(dxa[j][e]);
  __syncthreads();
  for (int r = warp; r < kT && k0 + r < rows; r += kThreads / 32) {
    const int t = k0 + r;
    const size_t at = xoff + size_t(t) * xrow;
    double u = 0.0, v = 0.0;
    for (int p = lane; p < P; p += 32) {
      const float gp = gx[r * SP + p];
      dx[at + p] = gp * dts[t];
      u += double(x[at + p]) * gp;
      v += double(dy[at + p]) * y[at + p];
    }
    u = warp_sum_d(u);
    v = warp_sum_d(v);
    if (lane == 0) {
      const size_t o = size_t(bh) * S + c0 + t;
      u_out[o] = u;
      r_out[o] = v - double(dts[t]) * u;
    }
  }
}

// Pass 4: the 64 query rows qi of chunk c of (b, h): the head's dC rows.
template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_query(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const float* __restrict__ Bm,
              const float* __restrict__ dy, const float* __restrict__ states,
              float* __restrict__ dCh, int S, int H, int G, int chunk,
              int nc) {
  using L = Bwd<P, N>;
  constexpr int PA = L::kPA, NB = L::kNB, SP = L::kSP;
  constexpr int NTB = N / 16;     // n-tiles of dC a warp
  extern __shared__ __align__(16) float smem[];
  float* dq = smem;                // (kT, PA) dy of the query rows
  float* xk = dq + kT * PA;        // (kT, PA) xdt of a key tile
  float* bk = xk + kT * PA;        // (kT, NB) B of a key tile
  float* dw = bk + kT * NB;        // (kT, SP) weighted dy.xdt^T, rows q
  float* cum = dw + kT * SP;
  float* dts = cum + kMaxChunk;
  float* sin = xk;                 // (N, PA) S_in, before the key tiles

  const int nt = chunk / kT, n_bhc = gridDim.x / nt;
  const int qi = nt - 1 - blockIdx.x / n_bhc;   // longest first
  const int bhc = blockIdx.x % n_bhc, c = bhc % nc, bh = bhc / nc;
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int c0 = c * chunk, rows = min(chunk, S - c0);
  const int q0 = qi * kT;
  if (q0 >= rows) return;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int lg = lane / 4, lt = lane % 4;
  const int m0 = 16 * (warp % 4), half = warp / 4;
  const int n0 = N / 2 * half, s0 = 32 * half;
  const size_t xrow = size_t(H) * P, brow = size_t(G) * N;
  const size_t xoff = (size_t(b) * S + c0) * xrow + size_t(h) * P;
  const float* bb = Bm + (size_t(b) * S + c0) * brow + size_t(g) * N;

  stage_async<P>(dq, PA, dy + xoff + size_t(q0) * xrow, xrow, rows - q0);
  stage_async<P, N>(sin, PA, states + ((size_t(b) * nc + c) * H + h) * P * N,
                    P, N);
  repro::cp_async_commit();
  chunk_cumsum(cum, dts, dt + (size_t(b) * S + c0) * H + h, H, A[h], chunk,
               rows);
  repro::cp_async_wait<0>();
  __syncthreads();

  // the carried-in state's term: exp(cs[q]) S_in^T dy[q]
  double dca[NTB][4] = {};
  warp_mma<NTB, true>(dca, dq + m0 * PA, PA, sin + n0 * PA, PA, P);
  scale_rows(dca, expf(cum[q0 + m0 + lg]), expf(cum[q0 + m0 + lg + 8]));
  __syncthreads();               // xdt and B overwrite S_in

  for (int kj = 0; kj <= qi; ++kj) {
    const int k0 = kj * kT;
    stage_async<P>(xk, PA, x + xoff + size_t(k0) * xrow, xrow, rows - k0);
    stage_async<N>(bk, NB, bb + size_t(k0) * brow, brow, rows - k0);
    repro::cp_async_commit();
    repro::cp_async_wait<0>();
    __syncthreads();
    for (int i = tid; i < kT * P; i += kThreads)
      xk[(i / P) * PA + i % P] *= dts[k0 + i / P];
    __syncthreads();
    {
      double dd[4][4] = {};
      warp_mma<4, true>(dd, dq + m0 * PA, PA, xk + s0 * PA, PA, P);
      store_weighted(dw, dd, cum, m0, s0, q0, k0, true);
    }
    __syncthreads();
    warp_mma<NTB, false>(dca, dw + m0 * SP, SP, bk + n0, NB, kT);
    __syncthreads();             // the stages are free
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int q = q0 + m0 + lg + 8 * hf;
    if (q < rows) {
#pragma unroll
      for (int j = 0; j < NTB; ++j)
        *reinterpret_cast<float2*>(
            dCh + ((size_t(b) * S + c0 + q) * H + h) * N + n0 + 8 * j +
            2 * lt) = make_float2(float(dca[j][2 * hf]),
                                  float(dca[j][2 * hf + 1]));
    }
  }
}

// Pass 5: chunk c of (b, h): <dS_out, S_out>, the reverse cumsum of dcs
// to d(dt A), ddt, and the chunk's share of dA (fp64).  S_out is the next
// chunk's incoming state (N, P) or, for the last chunk, fin (P, N).
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dt(const float* __restrict__ dt, const float* __restrict__ A,
           const float* __restrict__ states, const float* __restrict__ fin,
           const float* __restrict__ dstates, const double* __restrict__ r_in,
           const double* __restrict__ u_in, float* __restrict__ ddt,
           double* __restrict__ dA_part, int S, int H, int P, int N,
           int chunk, int nc) {
  __shared__ double red[kThreads / 32];
  const int c = blockIdx.x % nc, bh = blockIdx.x / nc;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = c * chunk, rows = min(chunk, S - c0);
  const size_t PN = size_t(P) * N;
  const float* dso = dstates + ((size_t(b) * nc + c) * H + h) * PN;
  const bool last = c + 1 == nc;
  const float* so = last ? fin + size_t(bh) * PN
                         : states + ((size_t(b) * nc + c + 1) * H + h) * PN;
  double e = 0.0;
  for (size_t i = tid; i < PN; i += kThreads)   // i = n P + p
    e += double(dso[i]) * (last ? so[(i % P) * N + i / P] : so[i]);
  e = warp_sum_d(e);
  if (lane == 0) red[warp] = e;
  __syncthreads();
  if (warp) return;
  e = lane < kThreads / 32 ? red[lane] : 0.0;
  e = warp_sum_d(e);

  // warp 0: lane l owns rows [l per, (l + 1) per); suffix sums in fp64
  const int per = chunk / 32;
  const size_t o = size_t(bh) * S + c0;
  double suf[kMaxChunk / 32];
  double run = 0.0;
#pragma unroll
  for (int i = kMaxChunk / 32 - 1; i >= 0; --i) {
    if (i < per) {
      const int t = lane * per + i;
      run += t < rows ? r_in[o + t] : 0.0;
      suf[i] = run;
    }
  }
  double after = run;            // then: the sum over later lanes
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const double v = __shfl_down_sync(0xffffffffu, after, s);
    if (lane + s < 32) after += v;
  }
  after -= run;
  const float a = A[h];
  double part = 0.0;
#pragma unroll
  for (int i = 0; i < kMaxChunk / 32; ++i) {
    const int t = lane * per + i;
    if (i < per && t < rows) {
      const double da = suf[i] + after + e;
      const size_t row = size_t(b) * S + c0 + t;
      ddt[row * H + h] = float(double(a) * da + u_in[o + t]);
      part += double(dt[row * H + h]) * da;
    }
  }
  part = warp_sum_d(part);
  if (lane == 0) dA_part[size_t(bh) * nc + c] = part;
}

// Pass 6: dB and dC, (B, S, G, N), summed over the group's heads from
// (B, S, H, N); dA (H,) over batch and chunks; fp64, in order.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce(const float* __restrict__ dBh, const float* __restrict__ dCh,
               const double* __restrict__ dA_part, float* __restrict__ dB,
               float* __restrict__ dC, float* __restrict__ dA, int Bt, int S,
               int H, int G, int N, int nc) {
  const size_t per = size_t(Bt) * S * G * N;
  const size_t e = size_t(blockIdx.x) * kThreads + threadIdx.x;
  if (e < 2 * per) {
    const float* src = e < per ? dBh : dCh;
    float* dst = e < per ? dB : dC;
    const size_t i = e % per;
    const size_t bs = i / (size_t(G) * N), g = i / N % G, n = i % N;
    const int rep = H / G;
    double s = 0.0;
    for (int k = 0; k < rep; ++k)
      s += src[(bs * H + g * rep + k) * N + n];
    dst[i] = float(s);
  } else if (e < 2 * per + H) {
    const int h = int(e - 2 * per);
    double s = 0.0;
    for (int b = 0; b < Bt; ++b)
      for (int c = 0; c < nc; ++c) s += dA_part[(size_t(b) * H + h) * nc + c];
    dA[h] = float(s);
  }
}

size_t align4(size_t n) { return (n + 3) & ~size_t(3); }

template <int P, int N>
int launch(const float* x, const float* dt, const float* A, const float* Bm,
           const float* Cm, const float* y, const float* states,
           const float* fin, const float* dy, const float* dfin, float* dx,
           float* ddt, float* dA, float* dB, float* dC, float* dinit,
           float* ws, int Bt, int S, int H, int G, int chunk, int no_carry,
           int skip_tile, cudaStream_t stream) {
  using L = Bwd<P, N>;
  const int nc = (S + chunk - 1) / chunk;
  const size_t BHS = size_t(Bt) * H * S;
  // fp64 rows first, then fp32 (every part a multiple of 16 bytes)
  double* r = reinterpret_cast<double*>(ws);      // (B, H, S)
  double* u = r + align4(BHS);                    // (B, H, S)
  double* part = u + align4(BHS);                 // (B, H, nc)
  float* dstates = reinterpret_cast<float*>(part + align4(size_t(Bt) * H * nc));
  float* cs_last = dstates + size_t(Bt) * nc * H * P * N;   // (B, H, nc)
  float* dBh = cs_last + align4(size_t(Bt) * H * nc);       // (B, S, H, N)
  float* dCh = dBh + size_t(Bt) * S * H * N;                // (B, S, H, N)
  cudaError_t err = allow_smem(ssd_bwd_dstate<P, N>, L::kDstateBytes);
  if (err == cudaSuccess) err = allow_smem(ssd_bwd_key<P, N>, L::kKeyBytes);
  if (err == cudaSuccess)
    err = allow_smem(ssd_bwd_query<P, N>, L::kQueryBytes);
  if (err != cudaSuccess) return int(err);
  const unsigned bhc = unsigned(Bt * H * nc), tiles = unsigned(chunk / kT);
  ssd_bwd_dstate<P, N><<<bhc, kThreads, L::kDstateBytes, stream>>>(
      dy, dt, A, Cm, dstates, cs_last, S, H, G, chunk, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const size_t elems = size_t(Bt) * H * P * N;
  ssd_bwd_state_pass<<<unsigned((elems + kThreads - 1) / kThreads), kThreads,
                       0, stream>>>(dstates, cs_last, dfin, dinit, Bt, H, P,
                                    N, nc, no_carry);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  ssd_bwd_key<P, N><<<bhc * tiles, kThreads, L::kKeyBytes, stream>>>(
      x, dt, A, Bm, Cm, y, dy, dstates, dx, dBh, r, u, S, H, G, chunk, nc,
      skip_tile);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  ssd_bwd_query<P, N><<<bhc * tiles, kThreads, L::kQueryBytes, stream>>>(
      x, dt, A, Bm, dy, states, dCh, S, H, G, chunk, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  ssd_bwd_dt<<<bhc, kThreads, 0, stream>>>(dt, A, states, fin, dstates, r, u,
                                           ddt, part, S, H, P, N, chunk, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const size_t red = 2 * size_t(Bt) * S * G * N + H;
  ssd_bwd_reduce<<<unsigned((red + kThreads - 1) / kThreads), kThreads, 0,
                   stream>>>(dBh, dCh, part, dB, dC, dA, Bt, S, H, G, N, nc);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// The forward's inputs x (B, S, H, P), dt (B, S, H), A (H,), Bm, Cm
// (B, S, G, N); its outputs y (B, S, H, P) (the scan's, before any D
// skip), the chunk states (B, nc, H, N, P) its pass 2 wrote and fin
// (B, H, P, N); the gradients dy (B, S, H, P) and dfin (B, H, P, N) or
// null (no gradient of the final state).  Writes dx, ddt, dA (H,), dB,
// dC, and dinit (B, H, P, N) unless null.  ws: the fp32 workspace of
// ssd_scan.bwd_workspace_floats (nc = ceil(S / chunk)): 2 B H S + B H nc
// doubles (each part rounded up to 16 bytes), then B nc H N P + B H nc
// (rounded) + 2 B S H N floats.  All fp32, contiguous, 16-byte aligned;
// chunk in {64, 128, 256}; G divides H; no_carry, skip_tile: 0, or
// planted faults (no gradient passed between chunks; the diagonal query
// tile left out of the key side).  Six launches on
// `stream`.  Returns
// a cudaError_t (0 = launched).
int ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, const void* y, const void* states,
                 const void* fin, const void* dy, const void* dfin, void* dx,
                 void* ddt, void* dA, void* dB, void* dC, void* dinit,
                 void* ws, int B, int S, int H, int P, int G, int N,
                 int chunk, int no_carry, int skip_tile, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G || chunk % kT ||
      chunk <= 0 || chunk > kMaxChunk)
    return int(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_SSD_BWD_CASE(PP, NN)                                          \
  if (P == PP && N == NN)                                                   \
    return launch<PP, NN>(f(x), f(dt), f(A), f(Bm), f(Cm), f(y), f(states), \
                          f(fin), f(dy), f(dfin), w(dx), w(ddt), w(dA),     \
                          w(dB), w(dC), w(dinit), w(ws), B, S, H, G, chunk, \
                          no_carry, skip_tile, s);
  REPRO_SSD_BWD_CASE(64, 128)      // mamba2-2.7b
  REPRO_SSD_BWD_CASE(32, 16)       // mamba2, reduced
  REPRO_SSD_BWD_CASE(64, 16)       // hymba-1.5b
#undef REPRO_SSD_BWD_CASE
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
