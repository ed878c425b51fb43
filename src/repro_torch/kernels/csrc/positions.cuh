// Masks by positions (the flash forward and backward's `POS` variant).
//
// The reference masks attention by each row's position, not its index
// (src/repro/models/attention.py:41-55 `_mask`): under M-RoPE the
// temporal stream, where every patch of an image shares one id.  A row's
// position need not rise with the row, so a tile of rows has a *range*
// of positions, and a (query tile, key tile) pair is
//   dead  when no pair in it can be live (never loaded),
//   full  when every pair in it is live (no per-element mask),
// judged from each tile's [min, max] position, which a small prep pass
// (`pos_tile_ranges`) writes into a workspace before the main launches.
// The masks compare positions: causal kpos <= qpos, the window
// qpos - kpos < window; the sequence edge stays by index.
#pragma once

#include <climits>

#include <cuda_runtime.h>

namespace repro {

// For each (b, t): the [min, max] of pos[b, start + t * tile ..
// start + min((t + 1) * tile, len) - 1] into out[b * n_tiles + t]
// (pos is (B, stride) int32; a tile is never empty).
__global__ void __launch_bounds__(256)
pos_tile_ranges(const int* __restrict__ pos, int B, int stride, int start,
                int len, int tile, int n_tiles, int2* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * n_tiles) return;
  const int b = i / n_tiles, t = i % n_tiles;
  const int* p = pos + size_t(b) * stride + start;
  const int hi = min((t + 1) * tile, len);
  int mn = INT_MAX, mx = INT_MIN;
  for (int j = t * tile; j < hi; ++j) {
    mn = min(mn, p[j]);
    mx = max(mx, p[j]);
  }
  out[i] = make_int2(mn, mx);
}

// One table of ranges: `n` tiles of `tile` rows from row `start` on.
inline cudaError_t launch_ranges(const int* pos, int B, int stride,
                                 int start, int len, int tile, int2* out,
                                 cudaStream_t stream) {
  const int n = (len + tile - 1) / tile;
  pos_tile_ranges<<<(B * n + 255) / 256, 256, 0, stream>>>(
      pos, B, stride, start, len, tile, n, out);
  return cudaGetLastError();
}

// The masks on one (query, key) pair of positions.
__device__ __forceinline__ bool pos_ok(int kpos, int qpos, int causal,
                                       int window) {
  return (!causal || kpos <= qpos) && (window <= 0 || qpos - kpos < window);
}

// Can any pair of a query tile's range q and a key tile's range k be
// live?  (Each mask on its own: conservative for causal and window
// together, which only costs a tile that the element masks then empty.)
__device__ __forceinline__ bool range_live(int2 q, int2 k, int causal,
                                           int window) {
  return (!causal || k.x <= q.y) && (window <= 0 || q.x - k.y < window);
}

// Is every pair of q and k live?
__device__ __forceinline__ bool range_full(int2 q, int2 k, int causal,
                                           int window) {
  return (!causal || k.y <= q.x) && (window <= 0 || q.y - k.x < window);
}

}  // namespace repro
