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
// fp32: FMAs on the CUDA cores, each thread an 8-column by TM-row block, fed
//   by two cp.async stages (16 B a thread) with rows padded by 16 bytes.
//   No TF32: the reference's fp32 tolerance is 1e-5 and TF32 keeps about
//   three decimal digits.  Rows and columns past the edge are zero-filled
//   on load (cp.async with a source size of 0) and never written.
// Every element offset is computed in 64 bits (qwen3-8b's unembedding is
// 622 M elements, 2.5 GB in fp32).  The wrapper raises on any other tile.
// Not done yet (later work): a persistent grid, a TMA-store epilogue,
// split-K for small M, fewer registers for the fp32 path (217 a thread).

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
// fp32: FMAs fed by cp.async
// ---------------------------------------------------------------------

constexpr int kFp32Stages = 2;

template <int BM, int BK, int BN, typename T>
struct Layout {
  static constexpr int kVec = 16 / int(sizeof(T));  // elements per cp.async
  static constexpr int AP = BK + kVec;              // padded pitch, A tile
  static constexpr int BP = BN + kVec;              // padded pitch, B tile
  static constexpr int kA = BM * AP;                // elements, one A stage
  static constexpr int kStage = kA + BK * BP;       // elements, one stage
  static constexpr size_t kBytes = size_t(kFp32Stages) * kStage * sizeof(T);
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; a false predicate writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage the A (BM, BK) and B (BK, BN) tiles at (m0, k0) and (k0, n0).
template <int BM, int BK, int BN, int THREADS, typename T>
__device__ __forceinline__ void load_stage(T* sa, const T* __restrict__ A,
                                           const T* __restrict__ B, int M,
                                           int K, int N, int m0, int n0,
                                           int k0, int tid) {
  using L = Layout<BM, BK, BN, T>;
  constexpr int V = L::kVec;
  constexpr int kARow = BK / V, kBRow = BN / V;  // 16-byte chunks per row
  static_assert((BM * kARow) % THREADS == 0 && (BK * kBRow) % THREADS == 0,
                "tile chunks must split evenly over the threads");
  T* sb = sa + L::kA;
#pragma unroll
  for (int i = 0; i < BM * kARow / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / kARow, col = (c % kARow) * V;
    const int gm = m0 + r, gk = k0 + col;
    const bool ok = gm < M && gk < K;
    cp_async16(sa + r * L::AP + col, ok ? A + (size_t(gm) * K + gk) : A, ok);
  }
#pragma unroll
  for (int i = 0; i < BK * kBRow / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / kBRow, col = (c % kBRow) * V;
    const int gk = k0 + r, gn = n0 + col;
    const bool ok = gk < K && gn < N;
    cp_async16(sb + r * L::BP + col, ok ? B + (size_t(gk) * N + gn) : B, ok);
  }
}

// fp32 on the CUDA cores.  Thread (tx, ty) owns rows ty + i * TY and the
// columns tx * 4 + {0..3} and BN / 2 + tx * 4 + {0..3} of the tile.
template <int BM, int BK, int BN, int THREADS>
struct FmaTile {
  using L = Layout<BM, BK, BN, float>;
  static constexpr int TX = BN / 8, TY = THREADS / TX, TM = BM / TY;
  static_assert(TX * TY == THREADS && TM * TY == BM, "thread tile");
  float acc[TM][8];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  __device__ __forceinline__ void compute(const float* sa, int tid) {
    const float* sb = sa + L::kA;
    const int tx = tid % TX, ty = tid / TX;
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = sa[(ty + i * TY) * L::AP + k];
      const float4 b0 =
          *reinterpret_cast<const float4*>(sb + k * L::BP + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(sb + k * L::BP + BN / 2 + tx * 4);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  __device__ __forceinline__ void store(float* __restrict__ C, int M, int N,
                                        int m0, int n0, int tid) const {
    const int tx = tid % TX, ty = tid / TX;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = m0 + ty + i * TY;
      if (row >= M) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = n0 + h * (BN / 2) + tx * 4;
        if (col < N)  // N % 4 == 0: the four columns are all inside
          *reinterpret_cast<float4*>(C + size_t(row) * N + col) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                          acc[i][4 * h + 2], acc[i][4 * h + 3]);
      }
    }
  }
};

template <int BM, int BK, int BN, int THREADS>
__global__ void __launch_bounds__(THREADS)
mm_fp32_kernel(const float* __restrict__ A, const float* __restrict__ B,
               float* __restrict__ C, int M, int K, int N) {
  using L = Layout<BM, BK, BN, float>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int tid = threadIdx.x;
  int m0, n0;
  tile_origin(blockIdx.x, M, N, BM, BN, m0, n0);
  const int nk = (K + BK - 1) / BK;

  FmaTile<BM, BK, BN, THREADS> tile;
  tile.zero();
  if (nk > 0)
    load_stage<BM, BK, BN, THREADS>(smem, A, B, M, K, N, m0, n0, 0, tid);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk)  // fill the other bank while this one is read
      load_stage<BM, BK, BN, THREADS>(smem + ((kt + 1) & 1) * L::kStage, A,
                                      B, M, K, N, m0, n0, (kt + 1) * BK, tid);
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: bank kt & 1 is in
    __syncthreads();
    tile.compute(smem + (kt & 1) * L::kStage, tid);
    __syncthreads();  // bank kt & 1 is refilled at step kt + 1
  }
  tile.store(C, M, N, m0, n0, tid);
}

template <int BM, int BK, int BN, int WM, int WN>
int launch_fp32(const void* a, const void* b, void* c, int M, int K, int N,
                cudaStream_t stream) {
  constexpr int kThreads = (BM / WM) * (BN / WN) * 32;
  const size_t smem = Layout<BM, BK, BN, float>::kBytes;
  auto kern = mm_fp32_kernel<BM, BK, BN, kThreads>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const long long ctas =
      (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (ctas > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  kern<<<dim3(unsigned(ctas)), kThreads, smem, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(c), M, K, N);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// a (M, K), b (K, N), out (M, N), contiguous and 16-byte aligned, all bf16
// (fp32 == 0) or all fp32 (fp32 == 1); K and N multiples of 16 bytes of
// elements.  (bm, bk, bn) is the plan's tile.  Returns 0 when launched, a
// cudaError_t, or a negative CUresult of the tensor-map encoder.
int tiled_matmul(const void* a, const void* b, void* out, int M, int K,
                 int N, int bm, int bk, int bn, int fp32, void* stream) {
  const int vec = fp32 ? 4 : 8;
  if (M <= 0 || N <= 0 || K < 0 || K % vec || N % vec)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32) {
    if (bm == 128 && bk == 64 && bn == 128)
      return launch_fp32<128, 64, 128, 64, 32>(a, b, out, M, K, N, s);
    if (bm == 64 && bk == 128 && bn == 64)
      return launch_fp32<64, 128, 64, 32, 32>(a, b, out, M, K, N, s);
    if (bm == 64 && bk == 64 && bn == 64)
      return launch_fp32<64, 64, 64, 32, 32>(a, b, out, M, K, N, s);
    return int(cudaErrorInvalidValue);
  }
  if ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16)
    return int(cudaErrorMisalignedAddress);
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
