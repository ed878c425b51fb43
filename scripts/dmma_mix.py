"""Measure the fp64 tensor-core rate of ``mma.sync`` on the card, alone and
beside the instructions that feed it.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 scripts/dmma_mix.py

Builds one small CUDA source with ``nvcc`` into ``build/dmma_mix/`` and
times, with CUDA events, a loop of independent fp64 products a warp
(``m8n8k4``, the shape ``ssd_common.cuh`` issues in pairs, and
``m16n8k4``, the pair in one instruction), alone and with ``r`` operand
fetches for every 8 products: conversions fp32 -> fp64
(``cvt.f64.f32``), 64-bit shared loads, or 32-bit shared loads each
converted.  Checks the ``m16n8k4`` fragment layout against ``A @ B``.
Prints one line per variant (TFLOP/s, against the 67 TFLOP/s of the data
sheet) and a JSON line with all of them and the card's name and power
limit.  The SSD backward's design (``ssd_scan_bwd.cu``) reads it.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "dmma_mix"
ITERS = 4096                    # loop trips a warp; 8 products a trip

SOURCE = r"""
#include <cuda_runtime.h>
// Eight independent accumulators a warp, a loop of 8 products a trip:
// m8n8k4 (SHAPE 0) or m16n8k4 (1); beside every 8 products R operand
// fetches of kind MODE: 0 none, 1 cvt.f64.f32, 2 LDS.64, 3 LDS.32 and
// cvt.f64.f32.
template <int SHAPE, int MODE, int R>
__global__ void __launch_bounds__(512) mix(double* out, int iters) {
  __shared__ double sd[1024];
  __shared__ float sf[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) {
    sd[i] = 1.0 + i * 1e-9;
    sf[i] = 1.0f + i * 1e-7f;
  }
  __syncthreads();
  const int lane = threadIdx.x % 32;
  double acc[8][4] = {};
  double a[8], b[8], c[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) a[j] = b[j] = c[j] = 1e-3 * (lane + j);
  float f = lane * 1e-3f;
  for (int it = 0; it < iters; ++it) {
    const int base = (it * 36 + lane) & 255;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (8 * r + j < R) {
          double& dst = r ? c[j] : a[j];
          if (MODE == 1) {
            asm volatile("cvt.f64.f32 %0, %1;" : "=d"(dst) : "f"(f));
            f += 1e-7f;
          } else if (MODE == 2) {
            dst = sd[base + 64 * j + 32 * r];
          } else if (MODE == 3) {
            dst = double(sf[base + 64 * j + 32 * r]);
          }
        }
      }
      if (SHAPE == 1)
        asm volatile(
            "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
            "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
            : "+d"(acc[j][0]), "+d"(acc[j][1]), "+d"(acc[j][2]),
              "+d"(acc[j][3]) : "d"(a[j]), "d"(c[j]), "d"(b[j]));
      else
        asm volatile(
            "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
            "{%0, %1}, {%2}, {%3}, {%0, %1};"
            : "+d"(acc[j][0]), "+d"(acc[j][1]) : "d"(a[j]), "d"(b[j]));
    }
  }
  double s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  if (s == 12345.0) out[threadIdx.x] = s;
}

// One warp: D (16 x 8) = A (16 x 4) B (4 x 8), all row-major fp64, by
// one m16n8k4, lane (g, t) holding A at (g, t) and (g + 8, t), B at
// (t, g), and D at rows g, g + 8 and columns 2t, 2t + 1: the layout the
// SSD backward assumes.
__global__ void layout(const double* A, const double* B, double* D) {
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  double d[4] = {};
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
               "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
               : "d"(A[g * 4 + t]), "d"(A[(g + 8) * 4 + t]),
                 "d"(B[t * 8 + g]));
  D[g * 8 + 2 * t] = d[0];
  D[g * 8 + 2 * t + 1] = d[1];
  D[(g + 8) * 8 + 2 * t] = d[2];
  D[(g + 8) * 8 + 2 * t + 1] = d[3];
}

extern "C" int check(const void* A, const void* B, void* D) {
  layout<<<1, 32>>>(static_cast<const double*>(A),
                    static_cast<const double*>(B), static_cast<double*>(D));
  return int(cudaDeviceSynchronize());
}

extern "C" int run(int shape, int mode, int r, int ctas, int threads,
                   int iters, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  double* o = static_cast<double*>(out);
#define CASE(S, M, RR)                                  \
  if (shape == S && mode == M && r == RR)               \
    mix<S, M, RR><<<ctas, threads, 0, st>>>(o, iters);
  CASE(0, 0, 0) CASE(0, 1, 8) CASE(0, 2, 8) CASE(0, 3, 8)
  CASE(1, 0, 0) CASE(1, 1, 8) CASE(1, 1, 16) CASE(1, 2, 8) CASE(1, 2, 16)
  CASE(1, 3, 8) CASE(1, 3, 16)
#undef CASE
  return int(cudaGetLastError());
}
"""

#: (label, shape, mode, fetches per 8 products)
VARIANTS = [(f"{shp}{', ' + kind + f', {r} per 8' if r else ' alone'}",
             si, mode, r)
            for si, shp, rs in ((0, "m8n8k4", (8,)), (1, "m16n8k4", (8, 16)))
            for mode, kind in ((0, ""), (1, "cvt.f64.f32"), (2, "LDS.64"),
                               (3, "LDS.32 + cvt"))
            for r in ((0,) if mode == 0 else rs)]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("dmma_mix: no CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "mix.cu").write_text(SOURCE)
    lib_path = OUT / "libmix.so"
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib_path),
                    str(OUT / "mix.cu")], check=True)
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "--dump-sass",
                           str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    lib = ctypes.CDLL(str(lib_path))
    lib.run.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
    out = torch.zeros(512, dtype=torch.float64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res = {}
    for warps in (8, 16):
        for name, shape, mode, r in VARIANTS:
            ctas = sms * (2 if warps == 8 else 1) * 4

            def go():
                err = lib.run(shape, mode, r, ctas, 32 * warps, ITERS,
                              out.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"dmma_mix: launch failed ({err})")
            go()
            torch.cuda.synchronize()
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            for _ in range(3):
                go()
            e.record()
            torch.cuda.synchronize()
            ms = s.elapsed_time(e) / 3
            flops = ctas * warps * ITERS * 8 * 512 * (1 + shape)
            tf = flops / ms / 1e9
            res[f"{warps} warps, {name}"] = tf
            print(f"dmma_mix {warps} warps a CTA, {name}: {tf:.2f} TFLOP/s "
                  f"({tf / 67 * 100:.1f}% of 67) [{card}]", flush=True)
    lib.check.argtypes = [ctypes.c_void_p] * 3
    A = torch.randn(16, 4, dtype=torch.float64, device="cuda")
    B = torch.randn(4, 8, dtype=torch.float64, device="cuda")
    D = torch.zeros(16, 8, dtype=torch.float64, device="cuda")
    if lib.check(A.data_ptr(), B.data_ptr(), D.data_ptr()):
        raise RuntimeError("dmma_mix: the layout check failed to run")
    res["layout m16n8k4 max err"] = float((D - A @ B).abs().max())
    print(f"dmma_mix layout m16n8k4: max |D - A B| = "
          f"{res['layout m16n8k4 max err']:.3e}")
    counts = {k: sass.count(k) for k in ("DMMA", "F2F.F64.F32", "LDS.64",
                                         "LDS ")}
    print(json.dumps({"card": card, "tflops": res, "sass": counts}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
