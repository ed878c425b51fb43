"""Where the SSD backward's pair pass spends its time, CTA by CTA.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 scripts/ssd_bwd_stamps.py

Copies ``csrc/ssd_scan_bwd.cu`` into ``build/ssd_bwd_stamps/`` with a
``clock64()`` stamp after each step of ``ssd_bwd_pair`` (thread 0 of
each CTA: the start, each key's copies, its state terms, each tile pair's
copies, weighted tiles and products, the key's end), builds it with
``nvcc``, runs one backward call at mamba2-2.7b's and hymba-1.5b's
shapes (B=1, S=2048, P=64, chunk 256; the library's own launch), and
prints, for the CTAs of each pair of key tiles (chunk 256: tiles 0 and
3, 1 and 2), the mean cycles a CTA and up to each stamp from the one
before, by the stamp's label, then one JSON line with them and the card's
name and power limit.  The stamps cost a few instructions a step; the
kernel it times is the committed one, unchanged otherwise.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "ssd_bwd_stamps"
MAX_CTAS, MAX_STAMPS = 8192, 40

#: (label, text in ssd_bwd_pair, where the stamp goes: before or after it)
STAMPS = (
    ("start", "  if (j1 >= ntv) return;\n", "after"),
    ("S_in copies",
     "      repro::cp_async_wait<2>();\n      __syncthreads();\n", "after"),
    ("key copies",
     "      repro::cp_async_wait<1>();\n    }\n    __syncthreads();\n",
     "after"),
    ("state terms", "      scale_rows(dba, f0, f1);\n    }\n", "after"),
    ("pair copies",
     "      repro::cp_async_wait<1>();\n      __syncthreads();\n", "after"),
    ("weighted tiles",
     "      // the key side (dxdt, dB), unless skip_tile drops", "before"),
    ("pair products",
     "      if (has_c) store_rows(slot(qi), N, acc, m0, nc0, kT);\n",
     "after"),
    ("key end", "    __syncthreads();             // the key tile, stages",
     "before"),
)


def instrument(src: str) -> str:
    """The source with a stamp at each of :data:`STAMPS` (each anchor
    must occur once) and an entry point that reads them back."""
    head = ("__device__ unsigned long long "
            f"g_stamp[{MAX_CTAS}][{MAX_STAMPS}];"
            f"\n__device__ int g_tag[{MAX_CTAS}][{MAX_STAMPS}];"
            f"\n__device__ int g_count[{MAX_CTAS}];\n"
            "#define STAMP(tag) do { if (threadIdx.x == 0 && blockIdx.x < "
            f"{MAX_CTAS} && n_stamp < {MAX_STAMPS}) {{ g_tag[blockIdx.x]"
            "[n_stamp] = tag; g_stamp[blockIdx.x][n_stamp++] = clock64(); }"
            " } while (0)\n")
    include = '#include "ssd_common.cuh"'
    if src.count(include) != 1:
        raise SystemExit("ssd_bwd_stamps: no single include of ssd_common")
    out = src.replace(include, head + include)
    for tag, (label, text, where) in enumerate(STAMPS):
        if out.count(text) != 1:
            raise SystemExit(f"ssd_bwd_stamps: the anchor for {label!r} "
                             f"occurs {out.count(text)} times in the source")
        stamp = f"STAMP({tag});\n" if tag else \
            "int n_stamp = 0;\nSTAMP(0);\n"
        out = out.replace(text, text + stamp if where == "after"
                          else stamp + text)
    end = "  }\n}\n\n// Pass 4:"
    if out.count(end) != 1:
        raise SystemExit("ssd_bwd_stamps: no single end of ssd_bwd_pair")
    out = out.replace(end, "  }\n  if (threadIdx.x == 0 && blockIdx.x < "
                      f"{MAX_CTAS}) g_count[blockIdx.x] = n_stamp;\n}}\n\n"
                      "// Pass 4:")
    return out.replace('extern "C" {', 'extern "C" {\nint read_stamps(void* '
                       "s, void* t, void* n) { cudaMemcpyFromSymbol(s, "
                       "g_stamp, sizeof(g_stamp)); cudaMemcpyFromSymbol(t, "
                       "g_tag, sizeof(g_tag)); return int(cudaMemcpyFromSymbol("
                       "n, g_count, sizeof(g_count))); }\n", 1)


def main() -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("ssd_bwd_stamps: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ssd_scan as ssd
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "stamps.cu").write_text(
        instrument((CSRC / "ssd_scan_bwd.cu").read_text()))
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-I", str(CSRC), "-o",
                    str(OUT / "libstamps.so"), str(OUT / "stamps.cu")],
                   check=True)
    lib = ctypes.CDLL(str(OUT / "libstamps.so"))
    lib.ssd_scan_bwd.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    lib.read_stamps.argtypes = [ctypes.c_void_p] * 3
    dev = torch.device("cuda", 0)
    g = torch.Generator(dev).manual_seed(0)
    result = {"card": card}
    for name, H, N in (("mamba2-2.7b", 80, 128), ("hymba-1.5b", 50, 16)):
        B, S, P, G, chunk = 1, 2048, 64, 1, 256
        ins = (F.silu(torch.randn(B, S, H, P, generator=g, device=dev)),
               F.softplus(torch.randn(B, S, H, generator=g, device=dev)
                          - 2.0),
               -torch.linspace(1.0, 16.0, H, device=dev),
               F.silu(torch.randn(B, S, G, N, generator=g, device=dev)),
               F.silu(torch.randn(B, S, G, N, generator=g, device=dev)))
        dy = torch.randn(B, S, H, P, generator=g, device=dev)
        y, fin, states = ssd.ssd_scan(*ins, chunk=chunk, return_states=True)
        outs = [torch.empty_like(t) for t in (ins[0], ins[1], ins[2],
                                              ins[3], ins[4])]
        ws = torch.empty(ssd.bwd_workspace_floats(B, S, H, P, N, G, chunk),
                         device=dev)
        ptr = ([t.data_ptr() for t in (*ins, y, states, fin, dy)] + [None]
               + [t.data_ptr() for t in outs] + [None, ws.data_ptr()])
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(2):
            err = lib.ssd_scan_bwd(*ptr, B, S, H, P, G, N, chunk, 0, 0,
                                   stream)
            if err:
                raise SystemExit(f"ssd_bwd_stamps: launch failed ({err})")
        torch.cuda.synchronize()
        stamps = np.zeros((MAX_CTAS, MAX_STAMPS), dtype=np.uint64)
        tags = np.zeros((MAX_CTAS, MAX_STAMPS), dtype=np.int32)
        counts = np.zeros(MAX_CTAS, dtype=np.int32)
        lib.read_stamps(stamps.ctypes.data, tags.ctypes.data,
                        counts.ctypes.data)
        ctas = B * H * (-(-S // chunk)) * 2
        for p in (0, 1):
            rows = [i for i in range(ctas) if i % 2 == p]
            n = int(counts[rows[0]])
            d = np.diff(stamps[rows, :n].astype(np.int64), axis=1).mean(0)
            steps = [(STAMPS[t][0], float(x))
                     for t, x in zip(tags[rows[0], 1:n], d)]
            total = float(d.sum())
            result[f"{name} pair {p}"] = {"cycles_per_cta": total,
                                          "steps": steps}
            print(f"ssd_bwd_stamps {name} key tiles {p} and {3 - p}: "
                  f"{total:.0f} cycles a CTA; to each stamp "
                  + ", ".join(f"{lab} {x:.0f}" for lab, x in steps)
                  + f" [{card}]", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
