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
// streams all of B once.  The design:
//   * operand tiles go to shared memory in two stages with cp.async (16 B a
//     thread): one bank fills while the other is read, the paper's 2-bank
//     private local memory.  Rows are padded by 16 bytes, so the ldmatrix
//     and float reads below meet no bank conflicts;
//   * bf16: tensor cores through mma.sync m16n8k16 (bf16 in, fp32
//     accumulate), fragments loaded with ldmatrix (B with .trans, as it is
//     stored K-major).  Each warp owns a WM x WN block of the tile;
//   * fp32: FMAs on the CUDA cores, each thread an 8-column by TM-row
//     block.  No TF32: the reference's fp32 tolerance is 1e-5 and TF32
//     keeps about three decimal digits;
//   * any M, K, N: rows and columns past the edge are zero-filled on load
//     (cp.async with a source size of 0) and never written.  K and N must
//     be multiples of 16 bytes of elements (the wrapper checks), so a
//     16-byte copy is wholly inside or wholly outside the matrix;
//   * every element offset is computed in 64 bits (qwen3-8b's unembedding
//     is 622 M elements, 2.5 GB in fp32);
//   * CTAs walk the output in groups of kGroupM tile rows, so the tiles in
//     flight share their A rows and B panels in L2.
// Tiles (bm, bk, bn) in {(128, 64, 128), (64, 128, 64), (64, 64, 64)}; the
// wrapper raises on anything else.  Not done yet (later work): wgmma, TMA,
// a deeper pipeline, warp specialisation, split-K for small M.

#include <type_traits>

#include "common.cuh"

using repro::bf16;

namespace {

constexpr int kStages = 2;
constexpr int kGroupM = 8;

template <int BM, int BK, int BN, typename T>
struct Layout {
  static constexpr int kVec = 16 / int(sizeof(T));  // elements per cp.async
  static constexpr int AP = BK + kVec;              // padded pitch, A tile
  static constexpr int BP = BN + kVec;              // padded pitch, B tile
  static constexpr int kA = BM * AP;                // elements, one A stage
  static constexpr int kStage = kA + BK * BP;       // elements, one stage
  static constexpr size_t kBytes = size_t(kStages) * kStage * sizeof(T);
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

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// bf16 on the tensor cores.  Warp w owns rows wm0..wm0+WM and columns
// wn0..wn0+WN of the tile: MT x NT mma tiles of 16 x 8.
template <int BM, int BK, int BN, int WM, int WN>
struct MmaTile {
  using L = Layout<BM, BK, BN, bf16>;
  static constexpr int kWarpsN = BN / WN;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static_assert(WM % 16 == 0 && WN % 16 == 0 && BK % 16 == 0, "mma shape");
  float acc[MT][NT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  __device__ __forceinline__ void compute(const bf16* sa, int tid) {
    const bf16* sb = sa + L::kA;
    const int warp = tid >> 5, lane = tid & 31;
    const int wm0 = (warp / kWarpsN) * WM, wn0 = (warp % kWarpsN) * WN;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MT][4], bfr[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldsm_x4(af[i], sa + (wm0 + i * 16 + (lane & 15)) * L::AP + kk +
                           (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        // matrices: (k 0-7, n), (k 8-15, n), (k 0-7, n+8), (k 8-15, n+8)
        uint32_t r[4];
        ldsm_x4_trans(r, sb + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  L::BP + wn0 + j * 8 + (lane >> 4) * 8);
        bfr[j][0] = r[0];
        bfr[j][1] = r[1];
        bfr[j + 1][0] = r[2];
        bfr[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
    }
  }

  __device__ __forceinline__ void store(bf16* __restrict__ C, int M, int N,
                                        int m0, int n0, int tid) const {
    const int warp = tid >> 5, lane = tid & 31;
    const int wm0 = (warp / kWarpsN) * WM, wn0 = (warp % kWarpsN) * WN;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm0 + i * 16 + (lane >> 2) + h * 8;
        if (row >= M) continue;
        bf16* dst = C + size_t(row) * N;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = n0 + wn0 + j * 8 + (lane & 3) * 2;
          if (col < N)  // N % 8 == 0, so col + 1 < N too
            *reinterpret_cast<__nv_bfloat162*>(dst + col) =
                __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
      }
  }
};

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

template <int BM, int BK, int BN, int THREADS, typename T, typename Tile>
__global__ void __launch_bounds__(THREADS)
mm_kernel(const T* __restrict__ A, const T* __restrict__ B,
          T* __restrict__ C, int M, int K, int N) {
  using L = Layout<BM, BK, BN, T>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;

  // output tile of this CTA: groups of kGroupM tile rows, column-major
  // inside a group
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int per_group = kGroupM * tiles_n;
  const int pid = blockIdx.x;
  const int first_m = (pid / per_group) * kGroupM;
  const int group_m = min(tiles_m - first_m, kGroupM);
  const int m0 = (first_m + (pid % per_group) % group_m) * BM;
  const int n0 = ((pid % per_group) / group_m) * BN;
  const int nk = (K + BK - 1) / BK;

  Tile tile;
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

template <int BM, int BK, int BN, int WM, int WN, typename T>
int launch(const void* a, const void* b, void* c, int M, int K, int N,
           cudaStream_t stream) {
  constexpr int kThreads = (BM / WM) * (BN / WN) * 32;
  using Tile =
      typename std::conditional<std::is_same<T, float>::value,
                                FmaTile<BM, BK, BN, kThreads>,
                                MmaTile<BM, BK, BN, WM, WN>>::type;
  const size_t smem = Layout<BM, BK, BN, T>::kBytes;
  auto kern = mm_kernel<BM, BK, BN, kThreads, T, Tile>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const long long ctas =
      (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (ctas > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  kern<<<dim3(unsigned(ctas)), kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      M, K, N);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(const void* a, const void* b, void* c, int M, int K, int N,
             int bm, int bk, int bn, cudaStream_t s) {
  if (bm == 128 && bk == 64 && bn == 128)
    return launch<128, 64, 128, 64, 32, T>(a, b, c, M, K, N, s);
  if (bm == 64 && bk == 128 && bn == 64)
    return launch<64, 128, 64, 32, 32, T>(a, b, c, M, K, N, s);
  if (bm == 64 && bk == 64 && bn == 64)
    return launch<64, 64, 64, 32, 32, T>(a, b, c, M, K, N, s);
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// a (M, K), b (K, N), out (M, N), contiguous, all bf16 (fp32 == 0) or all
// fp32 (fp32 == 1); K and N multiples of 16 bytes of elements.  (bm, bk,
// bn) is the plan's tile.  Returns a cudaError_t (0 = launched).
int tiled_matmul(const void* a, const void* b, void* out, int M, int K,
                 int N, int bm, int bk, int bn, int fp32, void* stream) {
  const int vec = fp32 ? 4 : 8;
  if (M <= 0 || N <= 0 || K < 0 || K % vec || N % vec)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fp32 ? dispatch<float>(a, b, out, M, K, N, bm, bk, bn, s)
              : dispatch<bf16>(a, b, out, M, K, N, bm, bk, bn, s);
}

}  // extern "C"
