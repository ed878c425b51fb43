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
// summed in fp64 on the tensor cores.
//
// What bounds it on the H100: operations.  Per (head, chunk) the gradient
// needs Q(Q+1)(3N + 2P) + 8QPN flops (the causal halves of C.B^T and of
// dy.xdt^T, whose one decayed tile gives dB over the keys and dC over the
// queries, and the three products that apply them; four state products)
// against 4 (3P + 2) Q bytes of its own x, y, dy, dx, dt and ddt: ~250
// flops a byte at Q = 256, P = 64, N = 128.  This kernel does
// 4096 T(T+1)(3N + 2P) + 8QPN (T = Q / 64 tiles; the diagonal tile
// pairs are computed whole): 1.16x the bound's count at mamba2's widths.
//
// The card's fp64 tensor-core rate (67 TFLOP/s) is reached only by
// mma.sync.m16n8k4.f64: measured on an H100 (scripts/dmma_mix.py), a
// stream of m8n8k4 (the shape ssd_common.cuh issues, two per 16 x 8
// tile) runs at 50% of it and m16n8k4 at 95%, and two operand fetches a
// product (a 32-bit shared load and a conversion to fp64, or a 64-bit
// load) keep it above 85%.  So every product here is m16n8k4 on fp32
// tiles widened at each fragment read (mma_tile), or on fp64 tiles where
// they come out of the tensor cores.
//
// What it costs against the bound (chip_smoke.py --only ssd_bwd on an
// H100): the pair pass takes most of the call and runs its products at
// about half the fp64 rate; one CTA an SM leaves the copies a key needs
// before its first products, and the syncs between a tile pair's two
// halves, with nothing to overlap them.
//
// The design: five launches on the stream, none with atomics (two calls
// and a resumed run are bitwise equal), every reduction in a fixed order.
//   1. chunk dstate, grid B * H * nc: the chunk's cumsum, its decay log
//      cs[Q-1] to (B, H, nc), and its local sum_q exp(cs[q]) dy[q] (x) C[q]
//      to the workspace's (B, nc, H, N, P);
//   2. state passing backward, one thread per (batch, head, n, p), serial
//      over the chunks from the last: replaces each chunk's local term with
//      the chunk's dS_out, and writes the initial state's gradient.  This is
//      the twin of the forward's pass 2; no_carry plants a fault (no
//      gradient passes between chunks);
//   3. pairs, grid B * H * nc * ceil(T / 2), one CTA of 16 warps (one a
//      SM: 225 KB of shared memory at N = 128) for key tiles j and
//      T - 1 - j, so that every CTA takes T + 1 (key, query) tile pairs
//      (T = 4 at chunk 256).  For each tile pair it forms the raw tiles
//      C.B^T and dy.xdt^T once, in one loop, weighs both by the same
//      exp(cs[q] - cs[k]) (one expf an element), keeps them in fp64 in
//      shared memory, and applies them on both sides: dxdt and dB of the
//      key rows accumulate in registers over the key's query tiles (from
//      the dS_out state terms), dC of the query rows goes to a slot of
//      its own for (this CTA, query tile) (the CTA's second key tile adds
//      to the slot its first wrote; the carried-in state's term
//      exp(cs[q]) S_in^T dy[q] of query tiles j and T - 1 - j opens it).
//      The query tiles stream through two cp.async stages: the next
//      tile's copy runs under this tile's products; the copies a key
//      needs first (S_in and dy, or the key tile and dS_out) wait alone,
//      the rest land under the first products.  Writes dxdt (to dx), the
//      head's dB rows and the dC slots; skip_tile plants a fault (the
//      diagonal query tile is left out of the key side);
//   4. dt, grid B * H * nc: each row's r = dy.y - xdt.dxdt and u = x.dxdt
//      (fp64) from the dxdt pass 3 left in dx, which becomes dx = dxdt dt;
//      <dS_out, S_out> (S_out the next chunk's incoming state, or the
//      final state), the reverse cumsum of dcs in fp64, ddt, and the
//      chunk's share of dA;
//   5. reduce: dB summed over the group's heads, dC over the heads and
//      the slots of its query tile, dA over batch and chunks, in fp64, in
//      a fixed order.
// The chunk states S_in come from the forward (its pass 2 writes them; the
// autograd function keeps them: B * nc * H * P * N floats a call, 21 MB for
// a mamba2-2.7b layer at S = 2048), so nothing of the forward is
// recomputed.

#include "ssd_common.cuh"

namespace {

using namespace repro::ssd;

constexpr int kPairThreads = 512;     // pass 3: 16 warps
constexpr int kSP = kT + 4;           // pitch (doubles) of a weighted tile

// One fp64 product on the tensor cores: d (16 x 8) += a (16 x 4) b (4 x 8);
// lane (g, t) holds a at (g, t) and (g + 8, t), b at (t, g), d at rows g
// and g + 8, columns 2t and 2t + 1 (the layout of two m8n8k4 tiles).
__device__ __forceinline__ void mma16(double (&d)[4], double a0, double a1,
                                      double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// One warp: acc[j] (16 rows x 8 columns, j < NT) += A . B over K (a
// multiple of 4), in fp64, with warp_mma's operands and layout: A
// row-major (rows, K) at `a` (pitch ap, the warp's first row), or with AT
// the (K, rows) transpose of that; B row-major (K, n) at `b` (pitch bp,
// the warp's first column), or with BT the (n, K) transpose of that.
// Either operand fp32 (widened at the fragment read) or fp64.
template <int NT, bool BT, bool AT, typename TA, typename TB>
__device__ __forceinline__ void mma_step(double (&acc)[NT][4], const TA* a,
                                         int ap, const TB* b, int bp, int g,
                                         int k) {
  const double a0 = AT ? a[k * ap + g] : a[g * ap + k];
  const double a1 = AT ? a[k * ap + g + 8] : a[(g + 8) * ap + k];
#pragma unroll
  for (int j = 0; j < NT; ++j)
    mma16(acc[j], a0, a1, BT ? b[(8 * j + g) * bp + k]
                             : b[k * bp + 8 * j + g]);
}

template <int NT, bool BT, bool AT = false, typename TA, typename TB>
__device__ __forceinline__ void mma_tile(double (&acc)[NT][4], const TA* a,
                                         int ap, const TB* b, int bp,
                                         int K) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll 2
  for (int k = t; k < K; k += 4)
    mma_step<NT, BT, AT>(acc, a, ap, b, bp, g, k);
}

// Two warp products over the same K in one loop (mma_tile's forms each),
// so that twice the independent accumulators are in flight.
template <int N1, bool BT1, bool AT1, int N2, bool BT2, bool AT2,
          typename TA1, typename TB1, typename TA2, typename TB2>
__device__ __forceinline__ void mma_dual(double (&acc1)[N1][4],
                                         const TA1* a1, int ap1,
                                         const TB1* b1, int bp1,
                                         double (&acc2)[N2][4],
                                         const TA2* a2, int ap2,
                                         const TB2* b2, int bp2, int K) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll 2
  for (int k = t; k < K; k += 4) {
    mma_step<N1, BT1, AT1>(acc1, a1, ap1, b1, bp1, g, k);
    mma_step<N2, BT2, AT2>(acc2, a2, ap2, b2, bp2, g, k);
  }
}

template <int P, int N>
struct Bwd {
  static constexpr int kNA = N + 4;   // fp32 tile pitches: every A-form and
  static constexpr int kPA = P + 4;   // B^T-form fragment read conflict-free
  static constexpr int kNB = N + 8;
  static constexpr int kPB = P + 8;
  // pass 1: dy (kT, P + 8) read transposed, C (kT, N + 8), cum, dt
  static constexpr size_t kDstateBytes =
      (size_t(kT) * kPB + size_t(kT) * kNB + 2 * kMaxChunk) * sizeof(float);
  // pass 3: the key tile (B, xdt), two stages of a query tile (C, dy),
  // the weighted C.B^T and dy.xdt^T (fp64), cum, dt; S_in and dS_out,
  // (N, P + 4) each, in the weighted tiles' room before the tile pairs
  static constexpr int kTileFloats = kT * kNA + kT * kPA;
  static constexpr int kPairFloats =
      3 * kTileFloats + 2 * 2 * kT * kSP + 2 * kMaxChunk;
  static_assert(N * kPA <= 2 * kT * kSP, "S_in, dS_out fit the weighted");
  static constexpr size_t kPairBytes = size_t(kPairFloats) * sizeof(float);
  // pass 3's warp (m, c): rows 16 m; columns of each product in quarters
  // c.  dxdt: P / 32 n-tiles of 8.  dB and dC: N / 32 n-tiles each, or at
  // N = 16 one n-tile of dB (c < 2) or of dC (c >= 2)
  static constexpr int kNX = P / 32;
  static constexpr int kNBC = N >= 32 ? N / 32 : 1;
  static_assert(P % 32 == 0 && (N % 32 == 0 || N == 16), "pass 3 widths");
};

// The dC slots of a chunk: pair p (key tiles p and T - 1 - p) writes one
// for each query tile qi >= p, at p T - p (p - 1) / 2 + qi - p.
__host__ __device__ __forceinline__ int slot_of(int p, int qi, int T) {
  return p * T - p * (p - 1) / 2 + qi - p;
}
__host__ __device__ __forceinline__ int n_slots(int T) {
  return slot_of((T + 1) / 2, (T + 1) / 2, T);
}

__device__ __forceinline__ double warp_sum_d(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Scale the rows of a warp's accumulator tile (mma_tile's layout): its
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

// Rows [r0, r0 + 16) of a warp's accumulator tile (columns 8 j + c0) to
// `dst` (row pitch `pitch`) as fp32 for rows below `valid`.
template <int NT>
__device__ __forceinline__ void store_rows(float* dst, size_t pitch,
                                           const double (&acc)[NT][4],
                                           int r0, int c0, int valid) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + g + 8 * hf;
    if (r >= valid) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<float2*>(dst + r * pitch + c0 + 8 * j + 2 * t) =
          make_float2(float(acc[j][2 * hf]), float(acc[j][2 * hf + 1]));
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
      mma_tile<NTW, false, true>(acc, ds + mt * 16, DP, ct + nt0 * 8, CP, kT);
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
  constexpr int kBatch = 8;      // loads in flight before the serial walk
  for (int c1 = nc - 1; c1 >= 0; c1 -= kBatch) {
    float local[kBatch], decay[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int c = c1 - i;
      if (c >= 0) {
        local[i] = dstates[((b * nc + c) * H + h) * PN + np];
        decay[i] = cs_last[bh * nc + c];
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int c = c1 - i;
      if (c >= 0) {
        if (no_carry && c < nc - 1) g = 0.f;
        dstates[((b * nc + c) * H + h) * PN + np] = g;
        g = fmaf(g, expf(decay[i]), local[i]);
      }
    }
  }
  if (dinit) dinit[bh * PN + pn] = g;
}


// Pass 3: key tiles j = p and T - 1 - j of chunk c of (b, h), with every
// query tile at or after each.  Writes dxdt (to dx; pass 4 scales it),
// the head's dB rows and the CTA's dC slots (B, nc, H, slots, kT, N).
template <int P, int N>
__global__ void __launch_bounds__(kPairThreads, 1)
ssd_bwd_pair(const float* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ A, const float* __restrict__ Bm,
             const float* __restrict__ Cm, const float* __restrict__ dy,
             const float* __restrict__ states,
             const float* __restrict__ dstates, float* __restrict__ dx,
             float* __restrict__ dBh, float* __restrict__ dCs, int S, int H,
             int G, int chunk, int nc, int skip_tile) {
  using L = Bwd<P, N>;
  constexpr int NA = L::kNA, PA = L::kPA, NX = L::kNX, NBC = L::kNBC;
  constexpr int NTH = kPairThreads;
  extern __shared__ __align__(16) float smem[];
  float* bk = smem;                          // (kT, NA) B of the key rows
  float* xk = bk + kT * NA;                  // (kT, PA) xdt of the key rows
  float* ring = xk + kT * PA;                // two (C, dy) query stages
  double* sw = reinterpret_cast<double*>(ring + 2 * L::kTileFloats);
  double* dw = sw + kT * kSP;                // (kT, kSP) weighted, rows k
  float* cum = reinterpret_cast<float*>(dw + kT * kSP);
  float* dts = cum + kMaxChunk;
  float* sin = reinterpret_cast<float*>(sw); // (N, PA) S_in, dS_out
  float* dso = sin + N * PA;                 //   before the tile pairs
  auto cq = [&](int st) { return ring + st * L::kTileFloats; };
  auto dq = [&](int st) { return ring + st * L::kTileFloats + kT * NA; };

  const int T = chunk / kT, npair = (T + 1) / 2, nsl = n_slots(T);
  const int p = blockIdx.x % npair, bhc = blockIdx.x / npair;
  const int c = bhc % nc, bh = bhc / nc;
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int c0 = c * chunk, rows = min(chunk, S - c0);
  const int ntv = (rows + kT - 1) / kT;      // query / key tiles with rows
  const int j1 = p, j2 = T - 1 - p;
  if (j1 >= ntv) return;
  const bool two = j2 != j1 && j2 < ntv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int lg = lane / 4;
  const int m0 = 16 * (warp % 4), qc = warp / 4;
  const int px0 = 8 * NX * qc;               // the warp's dxdt columns
  const bool has_b = N >= 32 || qc < 2, has_c = N >= 32 || qc >= 2;
  const int nb0 = 8 * (N >= 32 ? NBC * qc : qc);        // dB columns
  const int nc0 = 8 * (N >= 32 ? NBC * qc : qc - 2);    // dC columns
  const size_t xrow = size_t(H) * P, brow = size_t(G) * N;
  const size_t xoff = (size_t(b) * S + c0) * xrow + size_t(h) * P;
  const float* bb = Bm + (size_t(b) * S + c0) * brow + size_t(g) * N;
  const float* cb = Cm + (size_t(b) * S + c0) * brow + size_t(g) * N;
  const size_t PN = size_t(P) * N, bhcs = (size_t(b) * nc + c) * H + h;
  float* slots = dCs + bhcs * nsl * kT * N;
  auto slot = [&](int qi) {
    return slots + size_t(slot_of(p, qi, T)) * kT * N;
  };
  auto stage_query = [&](int st, int qi) {
    stage_async<N, kT, NTH>(cq(st), NA, cb + size_t(qi) * kT * brow, brow,
                            rows - qi * kT);
    stage_async<P, kT, NTH>(dq(st), PA, dy + xoff + size_t(qi) * kT * xrow,
                            xrow, rows - qi * kT);
  };

  for (int kk = 0; kk < (two ? 2 : 1); ++kk) {
    const int kj = kk ? j2 : j1, k0 = kj * kT;
    // two groups of copies: first what the first products need (before
    // the first key S_in and the dy rows of query tiles j1 and j2, else
    // the key tile and dS_out), then the rest, which lands under them
    if (kk == 0) {
      // warp 0's cumsum first: its dt loads queue behind no copy
      chunk_cumsum(cum, dts, dt + (size_t(b) * S + c0) * H + h, H, A[h],
                   chunk, rows);
      stage_async<P, N, NTH>(sin, PA, states + bhcs * PN, P, N);
      stage_async<P, kT, NTH>(dq(0), PA,
                              dy + xoff + size_t(j1) * kT * xrow, xrow,
                              rows - j1 * kT);
      if (two)
        stage_async<P, kT, NTH>(dq(1), PA,
                                dy + xoff + size_t(j2) * kT * xrow, xrow,
                                rows - j2 * kT);
      repro::cp_async_commit();
    }
    stage_async<N, kT, NTH>(bk, NA, bb + size_t(k0) * brow, brow,
                            rows - k0);
    stage_async<P, kT, NTH>(xk, PA, x + xoff + size_t(k0) * xrow, xrow,
                            rows - k0);
    stage_async<P, N, NTH>(dso, PA, dstates + bhcs * PN, P, N);
    repro::cp_async_commit();
    if (kk == 0) {
      stage_async<N, kT, NTH>(cq(0), NA, cb + size_t(k0) * brow, brow,
                              rows - k0);
      repro::cp_async_commit();
      repro::cp_async_wait<2>();
      __syncthreads();
      if (has_c) {
        // the carried-in state's term of dC, exp(cs[q]) S_in^T dy[q],
        // opens the slots of query tiles j1 and j2
        for (int s = 0; s < (two ? 2 : 1); ++s) {
          const int q0 = (s ? j2 : j1) * kT;
          double acc[NBC][4] = {};
          mma_tile<NBC, true>(acc, dq(s) + m0 * PA, PA, sin + nc0 * PA, PA,
                              P);
          scale_rows(acc, expf(cum[q0 + m0 + lg]),
                     expf(cum[q0 + m0 + lg + 8]));
          store_rows(slot(q0 / kT), N, acc, m0, nc0, kT);
        }
      }
      repro::cp_async_wait<1>();
    } else {
      stage_query(0, kj);
      repro::cp_async_commit();
      repro::cp_async_wait<1>();
    }
    __syncthreads();
    for (int i = tid; i < kT * P; i += NTH)
      xk[(i / P) * PA + i % P] *= dts[k0 + i / P];
    __syncthreads();

    // the state terms: B dS_out^T and xdt dS_out, each row decayed by
    // exp(cs[Q-1] - cs[k])
    double dxa[NX][4] = {}, dba[NBC][4] = {};
    mma_tile<NX, false>(dxa, bk + m0 * NA, NA, dso + px0, PA, N);
    if (has_b)
      mma_tile<NBC, true>(dba, xk + m0 * PA, PA, dso + nb0 * PA, PA, P);
    {
      const float last = cum[chunk - 1];
      const float f0 = expf(last - cum[k0 + m0 + lg]);
      const float f1 = expf(last - cum[k0 + m0 + lg + 8]);
      scale_rows(dxa, f0, f1);
      scale_rows(dba, f0, f1);
    }

    const int nq = ntv - kj;
    for (int i = 0; i < nq; ++i) {
      const int qi = kj + i, q0 = qi * kT, st = i & 1;
      __syncthreads();           // tile pair i - 1 is done with its stage
      if (i + 1 < nq) stage_query(st ^ 1, qi + 1);
      repro::cp_async_commit();
      repro::cp_async_wait<1>();
      __syncthreads();
      const float* cqs = cq(st);
      const float* dqs = dq(st);
      {
        // warp (m, qc): rows 16 m (keys), columns 16 qc (queries) of the
        // raw C.B^T and dy.xdt^T in one loop, both weighed by one
        // exp(cs[q] - cs[k])
        constexpr int KSD = N < P ? N : P;
        double sa[2][4] = {}, da[2][4] = {};
        const float* ba = bk + m0 * NA;
        const float* xa = xk + m0 * PA;
        const float* cbt = cqs + 16 * qc * NA;
        const float* dbt = dqs + 16 * qc * PA;
        mma_dual<2, true, false, 2, true, false>(sa, ba, NA, cbt, NA, da, xa,
                                                 PA, dbt, PA, KSD);
        if constexpr (N > KSD)
          mma_tile<2, true>(sa, ba + KSD, NA, cbt + KSD, NA, N - KSD);
        if constexpr (P > KSD)
          mma_tile<2, true>(da, xa + KSD, PA, dbt + KSD, PA, P - KSD);
        const int t = lane % 4;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = m0 + lg + 8 * hf;
          const float ck = cum[k0 + r];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = 16 * qc + 8 * j + 2 * t;
            const double w0 = k0 + r <= q0 + col
                                  ? double(expf(cum[q0 + col] - ck)) : 0.0;
            const double w1 = k0 + r <= q0 + col + 1
                                  ? double(expf(cum[q0 + col + 1] - ck))
                                  : 0.0;
            *reinterpret_cast<double2*>(sw + r * kSP + col) =
                make_double2(sa[j][2 * hf] * w0, sa[j][2 * hf + 1] * w1);
            *reinterpret_cast<double2*>(dw + r * kSP + col) =
                make_double2(da[j][2 * hf] * w0, da[j][2 * hf + 1] * w1);
          }
        }
      }
      __syncthreads();
      // the key side (dxdt, dB), unless skip_tile drops the diagonal
      // tile, and the query side (dC) from the same weighted tiles
      const bool keys = !(skip_tile && qi == kj);
      const bool add = kk == 1 || qi == j1 || (two && qi == j2);
      // an open slot's rows load under the dxdt products
      float2 was[NBC][2];
#pragma unroll
      for (int j = 0; j < NBC; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          was[j][hf] = has_c && add
                           ? *reinterpret_cast<const float2*>(
                                 slot(qi) + (m0 + lg + 8 * hf) * N + nc0 +
                                 8 * j + 2 * (lane % 4))
                           : make_float2(0.f, 0.f);
      if (keys)
        mma_tile<NX, false>(dxa, sw + m0 * kSP, kSP, dqs + px0, PA, kT);
      double acc[NBC][4];
#pragma unroll
      for (int j = 0; j < NBC; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          acc[j][2 * hf] = was[j][hf].x;
          acc[j][2 * hf + 1] = was[j][hf].y;
        }
      if (N >= 32 && keys)
        mma_dual<NBC, false, false, NBC, false, true>(
            dba, dw + m0 * kSP, kSP, cqs + nb0, NA, acc, dw + m0, kSP,
            bk + nc0, NA, kT);
      else if (has_b && keys)
        mma_tile<NBC, false>(dba, dw + m0 * kSP, kSP, cqs + nb0, NA, kT);
      else if (has_c)
        mma_tile<NBC, false, true>(acc, dw + m0, kSP, bk + nc0, NA, kT);
      if (has_c) store_rows(slot(qi), N, acc, m0, nc0, kT);
    }

    // this head's dB rows
    if (has_b)
      store_rows(dBh + ((size_t(b) * S + c0 + k0) * H + h) * N,
                 size_t(H) * N, dba, m0, nb0, rows - k0);
    // and its dxdt rows, which pass 4 turns into dx and the rows' terms
    store_rows(dx + xoff + size_t(k0) * xrow, xrow, dxa, m0, px0, rows - k0);
    __syncthreads();             // the key tile, stages and S_in's room
  }
}

// Pass 4: chunk c of (b, h): the rows' terms of dcs (r = dy.y - xdt.dxdt)
// and of ddt (u = x.dxdt) from the dxdt rows pass 3 left in dx (P <= 64),
// which become dx = dxdt dt; <dS_out, S_out>; the reverse cumsum of dcs to
// d(dt A), ddt, and the chunk's share of dA (fp64).  S_out is the next
// chunk's incoming state (N, P) or, for the last chunk, fin (P, N).
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dt(const float* __restrict__ x, const float* __restrict__ y,
           const float* __restrict__ dy, float* __restrict__ dx,
           const float* __restrict__ dt, const float* __restrict__ A,
           const float* __restrict__ states, const float* __restrict__ fin,
           const float* __restrict__ dstates, float* __restrict__ ddt,
           double* __restrict__ dA_part, int S, int H, int P, int N,
           int chunk, int nc) {
  __shared__ double red[kThreads / 32];
  __shared__ double rs[kMaxChunk], us[kMaxChunk];
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
  // warp w: rows w, w + 8, ..., kR of them loaded at once (P <= 64)
  constexpr int kW = kThreads / 32, kR = 4;
  for (int t0 = warp; t0 < rows; t0 += kR * kW) {
    float xv[kR][2], gv[kR][2], dyv[kR][2], yv[kR][2], dv[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int t = t0 + i * kW;
      const size_t row = size_t(b) * S + c0 + t, at = (row * H + h) * P;
      dv[i] = t < rows ? dt[row * H + h] : 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = lane + 32 * e;
        const bool in = t < rows && q < P;
        xv[i][e] = in ? x[at + q] : 0.f;
        gv[i][e] = in ? dx[at + q] : 0.f;
        dyv[i][e] = in ? dy[at + q] : 0.f;
        yv[i][e] = in ? y[at + q] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int t = t0 + i * kW;
      const size_t row = size_t(b) * S + c0 + t, at = (row * H + h) * P;
      double u = 0.0, v = 0.0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        u += double(xv[i][e]) * gv[i][e];
        v += double(dyv[i][e]) * yv[i][e];
        if (t < rows && lane + 32 * e < P)
          dx[at + lane + 32 * e] = gv[i][e] * dv[i];
      }
      u = warp_sum_d(u);
      v = warp_sum_d(v);
      if (lane == 0 && t < rows) {
        us[t] = u;
        rs[t] = v - double(dv[i]) * u;
      }
    }
  }
  __syncthreads();
  if (warp) return;
  e = lane < kThreads / 32 ? red[lane] : 0.0;
  e = warp_sum_d(e);

  // warp 0: lane l owns rows [l per, (l + 1) per); suffix sums in fp64
  const int per = chunk / 32;
  double suf[kMaxChunk / 32];
  double run = 0.0;
#pragma unroll
  for (int i = kMaxChunk / 32 - 1; i >= 0; --i) {
    if (i < per) {
      const int t = lane * per + i;
      run += t < rows ? rs[t] : 0.0;
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
      ddt[row * H + h] = float(double(a) * da + us[t]);
      part += double(dt[row * H + h]) * da;
    }
  }
  part = warp_sum_d(part);
  if (lane == 0) dA_part[size_t(bh) * nc + c] = part;
}

// Pass 5: dB (B, S, G, N) summed over the group's heads from (B, S, H, N);
// dC, for a row of query tile qi, over the slots of pairs 0..min(qi,
// pairs - 1) and in each over the group's heads; dA (H,) over batch and
// chunks; fp64, in order.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce(const float* __restrict__ dBh, const float* __restrict__ dCs,
               const double* __restrict__ dA_part, float* __restrict__ dB,
               float* __restrict__ dC, float* __restrict__ dA, int Bt, int S,
               int H, int G, int N, int chunk, int nc) {
  const size_t per = size_t(Bt) * S * G * N;
  const size_t e = size_t(blockIdx.x) * kThreads + threadIdx.x;
  const int rep = H / G;
  if (e < per) {
    const size_t bs = e / (size_t(G) * N), g = e / N % G, n = e % N;
    double s = 0.0;
#pragma unroll 8
    for (int k = 0; k < rep; ++k)
      s += dBh[(bs * H + g * rep + k) * N + n];
    dB[e] = float(s);
  } else if (e < 2 * per) {
    const size_t i = e - per;
    const size_t bs = i / (size_t(G) * N), g = i / N % G, n = i % N;
    const int b = int(bs / S), t = int(bs % S), c = t / chunk;
    const int qi = t % chunk / kT, r = t % kT, T = chunk / kT;
    const int last = min(qi, (T + 1) / 2 - 1), nsl = n_slots(T);
    const size_t head = size_t(nsl) * kT * N;
    const float* sl = dCs + ((size_t(b) * nc + c) * H + g * rep) * head +
                      size_t(r) * N + n;
    double s = 0.0;
    for (int p = 0; p <= last; ++p) {
      const float* at = sl + size_t(slot_of(p, qi, T)) * kT * N;
#pragma unroll 8
      for (int k = 0; k < rep; ++k) s += at[k * head];
    }
    dC[i] = float(s);
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
  const int nc = (S + chunk - 1) / chunk, T = chunk / kT;
  // fp64 first, then fp32 (every part a multiple of 16 bytes)
  double* part = reinterpret_cast<double*>(ws);   // (B, H, nc)
  float* dstates = reinterpret_cast<float*>(part + align4(size_t(Bt) * H * nc));
  float* cs_last = dstates + size_t(Bt) * nc * H * P * N;   // (B, H, nc)
  float* dBh = cs_last + align4(size_t(Bt) * H * nc);       // (B, S, H, N)
  float* dCs = dBh + size_t(Bt) * S * H * N;   // (B, nc, H, slots, kT, N)
  cudaError_t err = allow_smem(ssd_bwd_dstate<P, N>, L::kDstateBytes);
  if (err == cudaSuccess)
    err = allow_smem(ssd_bwd_pair<P, N>, L::kPairBytes);
  if (err != cudaSuccess) return int(err);
  const unsigned bhc = unsigned(Bt * H * nc);
  ssd_bwd_dstate<P, N><<<bhc, kThreads, L::kDstateBytes, stream>>>(
      dy, dt, A, Cm, dstates, cs_last, S, H, G, chunk, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const size_t elems = size_t(Bt) * H * P * N;
  ssd_bwd_state_pass<<<unsigned((elems + kThreads - 1) / kThreads), kThreads,
                       0, stream>>>(dstates, cs_last, dfin, dinit, Bt, H, P,
                                    N, nc, no_carry);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  ssd_bwd_pair<P, N><<<bhc * unsigned((T + 1) / 2), kPairThreads,
                       L::kPairBytes, stream>>>(
      x, dt, A, Bm, Cm, dy, states, dstates, dx, dBh, dCs, S, H, G, chunk,
      nc, skip_tile);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  ssd_bwd_dt<<<bhc, kThreads, 0, stream>>>(x, y, dy, dx, dt, A, states, fin,
                                           dstates, ddt, part, S, H, P, N,
                                           chunk, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const size_t red = 2 * size_t(Bt) * S * G * N + H;
  ssd_bwd_reduce<<<unsigned((red + kThreads - 1) / kThreads), kThreads, 0,
                   stream>>>(dBh, dCs, part, dB, dC, dA, Bt, S, H, G, N,
                             chunk, nc);
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
// ssd_scan.bwd_workspace_floats (nc = ceil(S / chunk), T = chunk / 64,
// slots = n_slots(T): 1, 2, 7 at T = 1, 2, 4): B H nc doubles (rounded
// up to 16 bytes), then B nc H N P + B H nc (rounded) + B S H N + B nc H
// slots 64 N floats.  All fp32, contiguous, 16-byte
// aligned; chunk in {64, 128, 256}; G divides H; no_carry, skip_tile: 0,
// or planted faults (no gradient passed between chunks; the diagonal
// query tile left out of the key side).  Five launches on `stream`.
// Returns a cudaError_t (0 = launched).
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
