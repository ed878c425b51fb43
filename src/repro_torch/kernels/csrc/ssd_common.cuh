// Helpers shared by the SSD scan's forward (ssd_scan.cu) and backward
// (ssd_scan_bwd.cu): tile staging by cp.async, fp64 products on the
// tensor cores, and a chunk's cumsum of dt * A.
#pragma once

#include "common.cuh"

namespace repro::ssd {

constexpr int kT = 64;           // rows per staged sub-tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kMaxChunk = 256;

// Start copying rows [0, valid) of a (ROWS, W) tile whose rows lie
// `stride` floats apart in global memory into shared memory of row pitch
// `pitch`, with a CTA of NTH threads; rows at or past `valid` are
// zero-filled (never read).  W % 4 == 0.
template <int W, int ROWS = kT, int NTH = kThreads>
__device__ __forceinline__ void stage_async(float* dst, int pitch,
                                            const float* src, size_t stride,
                                            int valid) {
  constexpr int kV = W / 4;
  for (int i = threadIdx.x; i < ROWS * kV; i += NTH) {
    const int r = i / kV, c = (i % kV) * 4;
    const bool ok = r < valid;
    repro::cp_async16(dst + r * pitch + c, ok ? src + r * stride + c : src,
                      ok);
  }
}

// ---------------------------------------------------------------------
// fp64 on the tensor cores: mma.sync m8n8k4 (DMMA) on fp64 operands, each
// widened exactly from its fp32 value, so every product is exact and the
// sum rounds in fp64.  A row whose terms cancel to ~1e-4 of their size
// thus keeps its digits, where the tensor cores' fp32 accumulation
// (TF32 or 3xTF32 products) keeps those of the largest term only.  Lane
// (g, t) = (lane / 4, lane % 4) holds A (8 x 4) at (g, t), B (4 x 8) at
// (t, g), and C (8 x 8) at (g, 2t), (g, 2t + 1).  A warp's 16 x 8 output
// tile is two of them: acc[0..1] at row g, acc[2..3] at row g + 8.
// ---------------------------------------------------------------------

__device__ __forceinline__ void mma_f64(double& d0, double& d1, double a,
                                        double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

// One warp: acc[j] (16 rows x 8 columns, j < NT) += A . B over K (a
// multiple of 4), in fp64.  A is row-major (rows, K) at `a` (pitch ap,
// the warp's first row), or with AT the (K, rows) transpose of that; B is
// row-major (K, n) at `b` (pitch bp, the warp's first column), or with BT
// the (n, K) transpose of that.
template <int NT, bool BT, bool AT = false>
__device__ __forceinline__ void warp_mma(double (&acc)[NT][4], const float* a,
                                         int ap, const float* b, int bp,
                                         int K) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  auto at = [&](int i, int k) { return AT ? a[k * ap + i] : a[i * ap + k]; };
#pragma unroll 4
  for (int k = t; k < K; k += 4) {
    const double a0 = at(g, k), a1 = at(g + 8, k);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const double bv = BT ? b[(8 * j + g) * bp + k] : b[k * bp + 8 * j + g];
      mma_f64(acc[j][0], acc[j][1], a0, bv);
      mma_f64(acc[j][2], acc[j][3], a1, bv);
    }
  }
}

// dt of the chunk's rows and its inclusive cumsum of dt * a, by warp 0;
// rows at or past `rows` read dt = 0, so cum stays at the last live row.
__device__ __forceinline__ void chunk_cumsum(float* cum, float* dts,
                                             const float* dtb, size_t dstride,
                                             float a, int chunk, int rows) {
  const int tid = threadIdx.x;
  if (tid >= 32) return;
  const int per = chunk / 32;
  float v[kMaxChunk / 32];
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < kMaxChunk / 32; ++e) {
    if (e < per) {
      const int r = tid * per + e;
      const float d = r < rows ? dtb[size_t(r) * dstride] : 0.f;
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

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

}  // namespace repro::ssd
