"""The fp32 tiled matmul against variants of its own design, on one card.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 scripts/mm_fp32_variants.py

Copies ``csrc/tiled_matmul.cu`` into ``build/mm_fp32_variants/`` as it
is and patched at fixed anchors (each must occur once) into:

* ``pairs``: the B fragment loaded in the 16-bit types' A layout
  (registers k = 2 t, 2 t + 1) instead of the TF32 one (k = t, t + 4),
  which must fail the check: the control that the layout is the card's;
* ``whole_k``: each split's whole K summed on the tensor cores, with no
  K step's sum added to the fp32 accumulator on the CUDA cores;
* ``prefetch``: the next sub-stage's B fragments read while this one's
  products run (16 more registers a consumer thread).

It builds all of them with ``nvcc`` at once and prints each one's
``ptxas`` registers and spills, its worst error against an fp64 product
(the worst row's rms-relative error or max |error| / max |fp64|, the
larger) over every tile, ragged shapes and each K split count, then
times those within the 1e-5 tolerance at mamba2-2.7b's fp32 ``y @
out_proj`` shapes, (1000 | 2048, 5120, 2560) on the (128, 64, 128) tile,
at each split count, in five turns with ``torch.matmul`` (TF32 off),
and prints one JSON line with the medians, the rounds and the card's
name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
OUT = ROOT / "build" / "mm_fp32_variants"
TOL = 1e-5
TURNS = 5

_LOAD = '''    const int k = 8 * kk + t + 4 * h;  // k mod 8 == t + 4 h
    const float2 v = *reinterpret_cast<const float2*>(
        box + k * 128 + (((c >> 2) ^ (t + 4 * h)) << 4) + (c & 3) * 4);
    sm90::tf32_split(v.x, hi[2 * h], lo[2 * h]);
    sm90::tf32_split(v.y, hi[2 * h + 1], lo[2 * h + 1]);'''
_FETCH = '''      const unsigned char* box = st + 2 * R::kA + (col / 32) * 4096;
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        load_b_frag(box, col % 32, t, kk, hi[kk], lo[kk]);
'''

#: variant -> ((anchor, replacement), ...)
PATCHES = {
    "pairs": ((_LOAD, '''    const int k = 8 * kk + 2 * t + h;
    const float2 v = *reinterpret_cast<const float2*>(
        box + k * 128 + (((c >> 2) ^ (2 * t + h)) << 4) + (c & 3) * 4);
    sm90::tf32_split(v.x, hi[h], lo[h]);
    sm90::tf32_split(v.y, hi[2 + h], lo[2 + h]);'''),),
    "whole_k": (
        ("if (it % kSub == kSub - 1 || it == n - 1) {", "if (it == n - 1) {"),
        ("kk > 0 || it % kSub != 0", "kk > 0 || it != 0")),
    "prefetch": (
        ('''    for (int it = 0; it < n; ++it) {
      const int s = it % STAGES;
      sm90::mbar_wait(&full[s], (it / STAGES) & 1);
      sm90::mbar_wait(&ready[s], (it / STAGES) & 1);
      const unsigned char* st = smem + s * R::kStage;
''' + _FETCH, '''    float2 raw[4][2];
    auto fetch = [&](int it) {
      const int s = it % STAGES;
      sm90::mbar_wait(&full[s], (it / STAGES) & 1);
      sm90::mbar_wait(&ready[s], (it / STAGES) & 1);
      const unsigned char* box =
          smem + s * R::kStage + 2 * R::kA + (col / 32) * 4096;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = 8 * kk + t + 4 * h, c = col % 32;
          raw[kk][h] = *reinterpret_cast<const float2*>(
              box + k * 128 + (((c >> 2) ^ (t + 4 * h)) << 4) + (c & 3) * 4);
        }
    };
    if (n > 0) fetch(0);
    for (int it = 0; it < n; ++it) {
      const int s = it % STAGES;
      const unsigned char* st = smem + s * R::kStage;
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sm90::tf32_split(raw[kk][h].x, hi[kk][2 * h], lo[kk][2 * h]);
          sm90::tf32_split(raw[kk][h].y, hi[kk][2 * h + 1],
                           lo[kk][2 * h + 1]);
        }
'''),
        ('''      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();''', '''      sm90::wgmma_commit();
      if (it + 1 < n) fetch(it + 1);
      sm90::wgmma_wait<0>();''')),
}


def patched(src: str, patches) -> str:
    for anchor, text in patches:
        if src.count(anchor) != 1:
            raise SystemExit(f"mm_fp32_variants: anchor found "
                             f"{src.count(anchor)} times: {anchor[:60]!r}")
        src = src.replace(anchor, text)
    return src


def sources():
    from repro_torch.kernels import build
    src = (build.CSRC / "tiled_matmul.cu").read_text()
    return {"committed": src, **{name: patched(src, p)
                                 for name, p in PATCHES.items()}}


def main() -> int:
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import tiled_matmul as mm
    if not torch.cuda.is_available():
        print("mm_fp32_variants: needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources().items():
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(OUT / f"lib{name}.so"), str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, result = {}, {"card": card, "variants": {}}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"nvcc failed for {name}:\n{log}", file=sys.stderr)
            return 1
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        fn = lib.tiled_matmul
        fn.argtypes = build._SIGNATURES["tiled_matmul"]["tiled_matmul"]
        fn.restype = ctypes.c_int
        libs[name] = fn
        ptxas = [e for e in build.ptxas_entries(log) if "tf32" in e[0]]
        result["variants"][name] = {"ptxas": ptxas}
        for kernel, regs, spills in ptxas:
            print(f"ptxas {name}: {kernel}: {regs} registers at entry, "
                  f"{spills} bytes of spills [{card}]", flush=True)
    dev = torch.device("cuda", 0)

    def run(fn, a, b, tiles, splits):
        M, K = a.shape
        N = b.shape[1]
        out = torch.empty((M, N), device=dev)
        ws = torch.empty((splits - 1) * M * N, device=dev)
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                 ws.data_ptr() if splits > 1 else None, M, K, N, *tiles, 1,
                 splits, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: {build.describe_error(err)}")
        return out

    def rel(got, want):
        e = got.double() - want
        rows = e.pow(2).mean(1).sqrt() / want.pow(2).mean(1).sqrt()
        return max(float(rows.max()), float(e.abs().max() / want.abs().max()))

    g = torch.Generator(dev).manual_seed(0)
    cases = []
    for M, K, N in ((300, 584, 1000), (130, 8, 136), (1000, 5120, 256),
                    (37, 4100, 72)):
        a = torch.randn((M, K), generator=g, device=dev)
        b = torch.randn((K, N), generator=g, device=dev)
        cases.append((a, b, a.double() @ b.double()))
    for name, fn in libs.items():
        worst = max(rel(run(fn, a, b, t, s), w) for a, b, w in cases
                    for t in mm.KERNEL_TILES
                    for s in range(1, mm.MAX_SPLITS + 1))
        result["variants"][name]["fp64_rel_err"] = worst
        print(f"check {name}: worst against fp64 {worst:.3e} (tol {TOL}) "
              f"[{card}]", flush=True)

    def time_ms(fn, iters=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    timed = [n for n in libs if result["variants"][n]["fp64_rel_err"] <= TOL]
    t = mm.DEFAULT_TILES
    for M, K, N in ((1000, 5120, 2560), (2048, 5120, 2560)):
        a = torch.randn((M, K), generator=g, device=dev)
        b = torch.randn((K, N), generator=g, device=dev)
        fns = {f"{n} splits={s}": (lambda f=libs[n], s=s: run(f, a, b, t, s))
               for n in timed for s in range(1, mm.MAX_SPLITS + 1)}
        fns["torch.matmul"] = lambda: torch.matmul(a, b)
        rounds = {k: [] for k in fns}
        for _ in range(TURNS):
            for k, fn in fns.items():
                rounds[k].append(time_ms(fn))
        med = {k: sorted(r)[TURNS // 2] for k, r in rounds.items()}
        for k in fns:
            print(f"timing ({M}, {K}, {N}) {k}: {med[k]:.4f} ms (turns "
                  + ", ".join(f"{x:.4f}" for x in rounds[k]) + f") [{card}]",
                  flush=True)
        result[f"{M}x{K}x{N}"] = {"ms": med, "turns_ms": rounds}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
