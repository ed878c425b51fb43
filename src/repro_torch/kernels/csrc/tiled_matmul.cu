// Plan-driven tiled matmul: C (M, N) = A (M, K) @ B (K, N), summed in fp32,
// written in the input dtype (bf16 or fp32).
//
// Replaces the Pallas TPU kernel in src/repro/kernels/tiled_matmul.py:
//   tiled_matmul (body _mm_kernel, pallas_call at :54), "the direct
//   embodiment of the local-partitioning pass": (bm, bk, bn) come from the
//   plan's tiled_matmul BlockPlan and the kernel just uses them.  The Pallas
//   grid (M/bm, N/bn, K/bk) ran K innermost and in order, carrying an fp32
//   accumulator in VMEM scratch from one K step to the next.  A GPU grid
//   runs in no order, so here one CTA owns one (bm, bn) output tile and
//   loops over K itself; its accumulator stays in registers for the whole
//   loop (the paper's one accumulator bank shared by every K bank).
//
// What bounds it on the H100: operations for prefill-sized M (2 K flops per
// output against 2 (M + N) bytes per K step of operands, far above the
// card's ~295 FLOP/byte balance), bytes for a decode tick's M = 8, which
// streams all of B once.
//
// bf16: wgmma fed by TMA (csrc/hopper.cuh), warp-specialised.
//   * A CTA is one producer warpgroup and bm / 64 consumer warpgroups.  One
//     thread of the producer issues every copy: a TMA load of the A (bm,
//     bk) and B (bk, bn) tiles of each K step into a ring of kStages
//     stages, completing on the stage's "full" mbarrier.  The producer
//     gives its registers to the consumers (setmaxnreg) when there are two.
//   * Each consumer warpgroup owns 64 rows of the output tile and runs
//     wgmma m64n{bn}k16 on the stage in place, its fp32 accumulator in
//     registers.  It keeps one K step of wgmma in flight and releases the
//     stage before it on the stage's "empty" mbarrier, so up to kStages - 1
//     copies overlap the products.
//   * Operands stay as they are in memory under the 128-byte swizzle: A
//     (M, K) row-major is K-major; B (K, N) row-major is MN-major and goes
//     in through wgmma's transposed-B form with an MN-major descriptor (no
//     transpose in memory).
//   * Any M, K, N: TMA zero-fills the tile past each edge, and the epilogue
//     writes only rows < M and columns < N.  TMA needs the row pitch of A
//     and B, 2 K and 2 N bytes, to be a multiple of 16, and 16-byte
//     aligned base pointers: the wrapper checks both.
//   * CTAs walk the output in groups of kGroupM tile rows, so the tiles in
//     flight share their A rows and B panels in L2.
//   Tiles (bm, bk, bn): (128, 64, 128), the H100 plan's, 32 KB a stage, 4
//   stages = 128 KB of the pass's 174,336-byte budget; (64, 128, 64) and
//   (64, 64, 64), the tiles of the JAX package's own tiled_matmul tests,
//   kept so the kernel runs every tile that reference exercises.  At M <=
//   64 (a decode tick's logits: bytes-bound, all of B streamed once) the
//   128-row tile runs as a 64-row one with a 7-stage ring (24 KB a stage,
//   168 KB), so more of B is in flight; the grid is the same.
// fp32: 3xTF32 on wgmma fed by TMA.  The H100's CUDA cores give 67 TFLOP/s
//   in fp32; its tensor cores 495 in TF32 (dense), whose 10-bit mantissa
//   keeps about three decimal digits: one TF32 product misses the fp32
//   one by ~2^-11 of each term, and a K = 5120 row then errs ~1e-4 of its
//   size, ten times the reference's fp32 tolerance of 1e-5.  3xTF32
//   splits each operand x = hi + lo, hi = x rounded to TF32 (cvt.rna,
//   formed explicitly: the tensor core reads a raw fp32 word by dropping
//   its low 13 bits) and lo = x - hi (exact in fp32, then cut to TF32),
//   and sums hi.hi + hi.lo + lo.hi: each term's error falls to ~2^-22
//   (the lo.lo term and lo's cut), the size of fp32's own rounding.  A
//   TPU's matrix unit has no fp32 multiplier either: XLA forms an fp32
//   product from several bf16 passes.  The tensor cores sum with the
//   largest term's exponent and cut the bits below, so a long sum there
//   drifts toward zero: each K step's products (bk deep) sum on the tensor
//   cores from zero, and the step's sum joins the accumulator on the CUDA
//   cores (one fp32 add, round to nearest), as the Pallas kernel adds each
//   K step's dot to its VMEM accumulator.
//   * TF32 wgmma reads its shared-memory operand K-major only (the
//     transpose immediates exist for 16-bit types).  A (M, K) row-major is
//     K-major; B (K, N) row-major is not.  So a CTA computes its tile
//     transposed, C^T = B^T A^T: wgmma's A operand is B^T from registers
//     (each consumer thread loads its fragment from the TMA tile and
//     splits it), and its B operand is A's tile as TMA lays it down.
//   * A CTA is one producer warpgroup and bn / 64 consumer warpgroups (64
//     of the tile's columns each, m64n{bm}k8).  The producer's first
//     thread issues the TMA loads of each 32-deep sub-stage (A (bm, 32):
//     one 128-byte swizzle row of fp32 a row; B (32, bn): bn / 32 boxes)
//     into a ring of kStages; its other three warps split A's tile into
//     hi (in place) and lo parts and release the sub-stage to the
//     consumers on a second mbarrier.  A bk step is bk / 32 sub-stages,
//     so the ring fits the pass's 174,336-byte budget at every tile:
//     (128, 64, 128) is 48 KB a sub-stage, 3 in the ring.
//   * K splits: the tile's K runs in `splits` CTAs (the wrapper picks the
//     count from the card's SM count so the last wave of CTAs is not left
//     mostly empty); split 0 writes C, the others a workspace, and a
//     second launch adds them to C in split order.  No atomics: a
//     repeated call is bitwise equal.
//   What bounds it: the tensor cores' three TF32 products (3 x 2 MKN at
//   495 TFLOP/s) for prefill-sized M, the bytes for a decode tick's M.
// Every element offset is computed in 64 bits (qwen3-8b's unembedding is
// 622 M elements, 2.5 GB in fp32).  The wrapper raises on any other tile.
// Not done yet (later work): a persistent grid, a TMA-store epilogue.

#include <chrono>

#include "common.cuh"
#include "hopper.cuh"

using repro::bf16;
namespace sm90 = repro::sm90;

namespace {

constexpr int kGroupM = 8;

// The (m0, n0) of CTA `pid`: groups of kGroupM tile rows, column-major
// inside a group.
__device__ __forceinline__ void tile_origin(int pid, int M, int N, int BM,
                                            int BN, int& m0, int& n0) {
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int per_group = kGroupM * tiles_n;
  const int first_m = (pid / per_group) * kGroupM;
  const int group_m = min(tiles_m - first_m, kGroupM);
  m0 = (first_m + (pid % per_group) % group_m) * BM;
  n0 = ((pid % per_group) / group_m) * BN;
}

// ---------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------

constexpr int kStages = 4;
// A 128-row tile at M <= 64 (a decode tick's logits) runs as a 64-row tile:
// one consumer warpgroup, and the shared memory the second one's A rows
// would take buys a deeper B ring for a product that is bytes-bound.
constexpr int kSmallMStages = 7;

template <int BM, int BK, int BN, int STAGES>
struct Ring {
  static constexpr int kA = BM * BK * 2;      // bytes of one A tile
  static constexpr int kStage = kA + BK * BN * 2;
  static constexpr int kBars = 2 * STAGES * 8;
  // + 1024: the dynamic shared memory is re-aligned to a swizzle atom
  static constexpr size_t kBytes = size_t(STAGES) * kStage + kBars + 1024;
};

template <int BM, int BK, int BN, int STAGES>
__global__ void __launch_bounds__((BM / 64 + 1) * 128, 1)
mm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b,
                bf16* __restrict__ C, int M, int K, int N) {
  using R = Ring<BM, BK, BN, STAGES>;
  constexpr int kWG = BM / 64;  // consumer warpgroups
  static_assert(BK % 64 == 0 && BN % 64 == 0 && BM % 64 == 0, "tile");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * R::kStage);
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  int m0, n0;
  tile_origin(blockIdx.x, M, N, BM, BN, m0, n0);
  const int nk = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kWG * 128);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == kWG) {
    // ---- producer: one thread keeps the ring full
    if constexpr (kWG == 2) sm90::setmaxnreg_dec<40>();
    if (tid == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        sm90::mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        sm90::mbar_expect_tx(&full[s], R::kStage);
        unsigned char* a = smem + s * R::kStage;
        unsigned char* b = a + R::kA;
#pragma unroll
        for (int i = 0; i < BK / 64; ++i)
          sm90::tma_load_2d(a + i * BM * 128, &map_a, &full[s],
                            kt * BK + i * 64, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          sm90::tma_load_2d(b + j * BK * 128, &map_b, &full[s], n0 + j * 64,
                            kt * BK);
      }
    }
  } else {
    // ---- consumers: 64 rows each, accumulator in registers
    if constexpr (kWG == 2) sm90::setmaxnreg_inc<232>();
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      sm90::mbar_wait(&full[s], (kt / STAGES) & 1);
      const unsigned char* a = smem + s * R::kStage + wg * 64 * 128;
      const unsigned char* b = smem + s * R::kStage + R::kA;
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = sm90::desc_sw128(
            a + (kk / 4) * BM * 128 + (kk % 4) * 32, 16, 1024);
        const uint64_t db = sm90::desc_sw128(b + kk * 2048, BK * 128, 1024);
        sm90::wgmma_ss<BN, 1>(acc, da, db, 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // the step before this one is done
      sm90::fence_regs(acc);
      if (kt > 0) sm90::mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);

    // ---- epilogue: rows < M, columns < N (N % 8 == 0: pairs are whole)
    const int warp = tid / 32, lane = tid % 32;
    const int row = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      if (r >= M) continue;
      bf16* dst = C + size_t(r) * N;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (lane % 4);
        if (col < N)
          *reinterpret_cast<__nv_bfloat162*>(dst + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                    acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// The two operand maps of a (bm, bk, bn) launch.  K == 0 leaves them
// unencoded: the kernel then loads nothing and writes zeros.
int encode_maps(CUtensorMap* ma, CUtensorMap* mb, const void* a,
                const void* b, int M, int K, int N, int bm, int bk) {
  if (K == 0) return 0;
  const cuuint64_t da[2] = {cuuint64_t(K), cuuint64_t(M)};
  const cuuint64_t sa[1] = {cuuint64_t(K) * 2};
  const cuuint32_t ba[2] = {64, cuuint32_t(bm)};
  int err = sm90::encode_bf16_sw128(ma, a, 2, da, sa, ba);
  if (err) return err;
  const cuuint64_t db[2] = {cuuint64_t(N), cuuint64_t(K)};
  const cuuint64_t sb[1] = {cuuint64_t(N) * 2};
  const cuuint32_t bb[2] = {64, cuuint32_t(bk)};
  return sm90::encode_bf16_sw128(mb, b, 2, db, sb, bb);
}

template <int BM, int BK, int BN, int STAGES = kStages>
int launch_wgmma(const void* a, const void* b, void* c, int M, int K, int N,
                 cudaStream_t stream) {
  CUtensorMap ma = {}, mb = {};
  int err = encode_maps(&ma, &mb, a, b, M, K, N, BM, BK);
  if (err) return err;
  const size_t smem = Ring<BM, BK, BN, STAGES>::kBytes;
  auto kern = mm_wgmma_kernel<BM, BK, BN, STAGES>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  const long long ctas =
      (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (ctas > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  kern<<<dim3(unsigned(ctas)), (BM / 64 + 1) * 128, smem, stream>>>(
      ma, mb, static_cast<bf16*>(c), M, K, N);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------
// fp32: 3xTF32 on wgmma fed by TMA
// ---------------------------------------------------------------------

// K rows of one fp32 sub-stage: one 128-byte swizzle row of fp32.
constexpr int kDepth = 32;

template <int BM, int BN, int STAGES>
struct Fp32Ring {
  static constexpr int kA = BM * kDepth * 4;  // bytes of one A box
  static constexpr int kB = kDepth * BN * 4;  // BN / 32 B boxes of 32 x 32
  // A (its hi parts written over it), A's lo parts, B
  static constexpr int kStage = 2 * kA + kB;
  static constexpr int kBars = 3 * STAGES * 8;
  static constexpr size_t kBytes = size_t(STAGES) * kStage + kBars + 1024;
};

// The B fragment of one k8 step: this thread's (row, k) of the RS operand
// are B's (k, column) (the tile runs transposed), read two adjacent columns
// at a time.  Column c of a 32-column box sits in 16-byte chunk c / 4 of
// its 128-byte row, XOR-ed with the row mod 8.
__device__ __forceinline__ void load_b_frag(const unsigned char* box, int c,
                                            int t, int kk, uint32_t (&hi)[4],
                                            uint32_t (&lo)[4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = 8 * kk + t + 4 * h;  // k mod 8 == t + 4 h
    const float2 v = *reinterpret_cast<const float2*>(
        box + k * 128 + (((c >> 2) ^ (t + 4 * h)) << 4) + (c & 3) * 4);
    sm90::tf32_split(v.x, hi[2 * h], lo[2 * h]);
    sm90::tf32_split(v.y, hi[2 * h + 1], lo[2 * h + 1]);
  }
}

// One CTA computes one (BM, BN) output tile over one split's share of K,
// as C^T = B^T A^T: wgmma's 64-row A operand is 64 columns of B, in
// registers (TF32 has no transposed shared-memory form, and a register
// operand has no major-ness), and its N = BM operand is A's tile as TMA
// lays it down, K-major.  Warp w's rows 16 w + g and 16 w + g + 8 (g =
// lane / 4) of a warpgroup's 64 are B's columns 16 w + 2 g and + 1, so a
// thread reads both with one 8-byte load and stores both with one.
template <int BM, int BK, int BN, int STAGES>
__global__ void __launch_bounds__((BN / 64 + 1) * 128, 1)
mm_tf32x3_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 float* __restrict__ C, float* __restrict__ ws, int M, int K,
                 int N, int splits) {
  using R = Fp32Ring<BM, BN, STAGES>;
  constexpr int kWG = BN / 64;        // consumer warpgroups
  constexpr int kSub = BK / kDepth;   // sub-stages of one K step
  constexpr int kTransform = 96;      // producer warps 1-3
  static_assert(BK % kDepth == 0 && BN % 64 == 0 && (BM == 64 || BM == 128),
                "tile");
  extern __shared__ unsigned char smem_raw[];
  // aligned by an offset, so the compiler still sees shared memory (LDS
  // and STS, not generic loads) in the transform and the fragment loads
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * R::kStage);
  uint64_t* ready = full + STAGES;
  uint64_t* empty = ready + STAGES;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int split = blockIdx.x / tiles;
  int m0, n0;
  tile_origin(blockIdx.x % tiles, M, N, BM, BN, m0, n0);
  // this split's sub-stages of K: [first, first + n)
  const int total = (K + kDepth - 1) / kDepth;
  const int first = int((long long)total * split / splits);
  const int n = int((long long)total * (split + 1) / splits) - first;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&ready[s], kTransform);
      sm90::mbar_init(&empty[s], kWG * 128);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == kWG) {
    if constexpr (kWG == 2) sm90::setmaxnreg_dec<40>();
    if (tid == 0) {
      // ---- producer: one thread keeps the ring full
      for (int it = 0; it < n; ++it) {
        const int s = it % STAGES;
        sm90::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        sm90::mbar_expect_tx(&full[s], R::kA + R::kB);
        unsigned char* st = smem + s * R::kStage;
        const int k = (first + it) * kDepth;
        sm90::tma_load_2d(st, &map_a, &full[s], k, m0);
#pragma unroll
        for (int j = 0; j < BN / 32; ++j)
          sm90::tma_load_2d(st + 2 * R::kA + j * 4096, &map_b, &full[s],
                            n0 + 32 * j, k);
      }
    } else if (tid >= 32) {
      // ---- transform: A's tile into hi (in place) and lo parts, 16 bytes
      // at a time; the swizzle moves whole 16-byte chunks, so lo keeps it
      for (int it = 0; it < n; ++it) {
        const int s = it % STAGES;
        sm90::mbar_wait(&full[s], (it / STAGES) & 1);
        float4* a = reinterpret_cast<float4*>(smem + s * R::kStage);
        uint4* lo = reinterpret_cast<uint4*>(smem + s * R::kStage + R::kA);
#pragma unroll 4
        for (int c = tid - 32; c < R::kA / 16; c += kTransform) {
          const float4 x = a[c];
          uint4 h, l;
          sm90::tf32_split(x.x, h.x, l.x);
          sm90::tf32_split(x.y, h.y, l.y);
          sm90::tf32_split(x.z, h.z, l.z);
          sm90::tf32_split(x.w, h.w, l.w);
          reinterpret_cast<uint4*>(a)[c] = h;
          lo[c] = l;
        }
        sm90::fence_proxy_async_shared();  // wgmma reads them next
        sm90::mbar_arrive(&ready[s]);
      }
    }
  } else {
    // ---- consumers: 64 of the tile's columns each, all BM rows
    if constexpr (kWG == 2) sm90::setmaxnreg_inc<232>();
    float acc[BM / 2], part[BM / 2];
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[i] = part[i] = 0.f;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int col = wg * 64 + 16 * warp + 2 * g;  // this thread's columns
    for (int it = 0; it < n; ++it) {
      const int s = it % STAGES;
      sm90::mbar_wait(&full[s], (it / STAGES) & 1);
      sm90::mbar_wait(&ready[s], (it / STAGES) & 1);
      const unsigned char* st = smem + s * R::kStage;
      const unsigned char* box = st + 2 * R::kA + (col / 32) * 4096;
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        load_b_frag(box, col % 32, t, kk, hi[kk], lo[kk]);
      sm90::fence_regs(part);
      sm90::wgmma_fence();
      // a K step's products sum on the tensor cores from 0 (scale_d 0);
      // the small terms first
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da_hi = sm90::desc_sw128(st + kk * 32, 16, 1024);
        const uint64_t da_lo =
            sm90::desc_sw128(st + R::kA + kk * 32, 16, 1024);
        sm90::wgmma_tf32_rs<BM>(part, hi[kk], da_lo,
                                kk > 0 || it % kSub != 0);
        sm90::wgmma_tf32_rs<BM>(part, lo[kk], da_hi, 1);
        sm90::wgmma_tf32_rs<BM>(part, hi[kk], da_hi, 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(part);
      sm90::mbar_arrive(&empty[s]);
      // each K step's sum joins the accumulator on the CUDA cores
      // (round to nearest), so no tensor-core sum runs longer than bk
      if (it % kSub == kSub - 1 || it == n - 1) {
#pragma unroll
        for (int i = 0; i < BM / 2; ++i) acc[i] += part[i];
      }
    }

    // ---- epilogue: register 4 j + 2 h + e holds row 8 j + 2 t + e,
    // column col + h; rows < M, columns < N (N % 4 == 0: pairs are whole)
    float* out = split == 0 ? C : ws + size_t(split - 1) * M * N;
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = m0 + 8 * j + 2 * t + e, c = n0 + col;
        if (r < M && c < N)
          *reinterpret_cast<float2*>(out + size_t(r) * N + c) =
              make_float2(acc[4 * j + e], acc[4 * j + 2 + e]);
      }
    }
  }
}

// C += the other splits' partial tiles, in split order (a fixed order: a
// repeated call is bitwise equal).  n4 float4s of C; ws holds `parts`
// (M, N) partials one after another, mn4 float4s each.
__global__ void mm_split_reduce(float4* __restrict__ C,
                                const float4* __restrict__ ws, size_t n4,
                                size_t mn4, int parts) {
  for (size_t i = blockIdx.x * size_t(blockDim.x) + threadIdx.x; i < n4;
       i += size_t(gridDim.x) * blockDim.x) {
    float4 c = C[i];
    for (int p = 0; p < parts; ++p) {
      const float4 w = ws[p * mn4 + i];
      c.x += w.x;
      c.y += w.y;
      c.z += w.z;
      c.w += w.w;
    }
    C[i] = c;
  }
}

template <int BM, int BK, int BN, int STAGES>
int launch_tf32x3(const void* a, const void* b, void* c, void* ws, int M,
                  int K, int N, int splits, cudaStream_t stream) {
  CUtensorMap ma = {}, mb = {};
  if (K > 0) {  // K == 0: no map; the kernel loads nothing, writes zeros
    const cuuint64_t da[2] = {cuuint64_t(K), cuuint64_t(M)};
    const cuuint64_t sa[1] = {cuuint64_t(K) * 4};
    const cuuint32_t ba[2] = {kDepth, cuuint32_t(BM)};
    int err = sm90::encode_sw128(&ma, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a, 2,
                                 da, sa, ba);
    if (err) return err;
    const cuuint64_t db[2] = {cuuint64_t(N), cuuint64_t(K)};
    const cuuint64_t sb[1] = {cuuint64_t(N) * 4};
    const cuuint32_t bb[2] = {32, kDepth};
    err = sm90::encode_sw128(&mb, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, b, 2, db,
                             sb, bb);
    if (err) return err;
  }
  const size_t smem = Fp32Ring<BM, BN, STAGES>::kBytes;
  auto kern = mm_tf32x3_kernel<BM, BK, BN, STAGES>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  const long long ctas =
      (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN) * splits;
  if (ctas > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  kern<<<dim3(unsigned(ctas)), (BN / 64 + 1) * 128, smem, stream>>>(
      ma, mb, static_cast<float*>(c), static_cast<float*>(ws), M, K, N,
      splits);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return int(e);
  const size_t mn4 = size_t(M) * N / 4;
  mm_split_reduce<<<1024, 256, 0, stream>>>(
      static_cast<float4*>(c), static_cast<const float4*>(ws), mn4, mn4,
      splits - 1);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// a (M, K), b (K, N), out (M, N), contiguous and 16-byte aligned, all bf16
// (fp32 == 0) or all fp32 (fp32 == 1); K and N multiples of 16 bytes of
// elements.  (bm, bk, bn) is the plan's tile.  fp32 splits K over `splits`
// CTAs a tile (1 to 8); splits > 1 takes ws, (splits - 1) M N floats.
// Returns 0 when launched, a cudaError_t, or a negative CUresult of the
// tensor-map encoder.
int tiled_matmul(const void* a, const void* b, void* out, void* ws, int M,
                 int K, int N, int bm, int bk, int bn, int fp32, int splits,
                 void* stream) {
  const int vec = fp32 ? 4 : 8;
  if (M <= 0 || N <= 0 || K < 0 || K % vec || N % vec)
    return int(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16)
    return int(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32) {
    if (splits < 1 || splits > 8 || (splits > 1 && ws == nullptr))
      return int(cudaErrorInvalidValue);
    if (bm == 128 && bk == 64 && bn == 128)
      return launch_tf32x3<128, 64, 128, 3>(a, b, out, ws, M, K, N, splits,
                                            s);
    if (bm == 64 && bk == 128 && bn == 64)
      return launch_tf32x3<64, 128, 64, 4>(a, b, out, ws, M, K, N, splits, s);
    if (bm == 64 && bk == 64 && bn == 64)
      return launch_tf32x3<64, 64, 64, 4>(a, b, out, ws, M, K, N, splits, s);
    return int(cudaErrorInvalidValue);
  }
  if (splits != 1) return int(cudaErrorInvalidValue);
  if (bm == 128 && bk == 64 && bn == 128)
    return M <= 64 ? launch_wgmma<64, 64, 128, kSmallMStages>(a, b, out, M,
                                                              K, N, s)
                   : launch_wgmma<128, 64, 128>(a, b, out, M, K, N, s);
  if (bm == 64 && bk == 128 && bn == 64)
    return launch_wgmma<64, 128, 64>(a, b, out, M, K, N, s);
  if (bm == 64 && bk == 64 && bn == 64)
    return launch_wgmma<64, 64, 64>(a, b, out, M, K, N, s);
  return int(cudaErrorInvalidValue);
}

// Host microseconds to encode the two tensor maps of one bf16 launch, the
// mean of `iters` encodings (no launch); negative on an encoder error.
double tiled_matmul_map_encode_us(const void* a, const void* b, int M, int K,
                                  int N, int bm, int bk, int iters) {
  CUtensorMap ma, mb;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i) {
    const int err = encode_maps(&ma, &mb, a, b, M, K, N, bm, bk);
    if (err) return double(err);
  }
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::micro>(t1 - t0).count() /
         (iters > 0 ? iters : 1);
}

}  // extern "C"
