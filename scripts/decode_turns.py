#!/usr/bin/env python3
"""The decode kernels' non-partial launches timed on one card, for
comparing two trees in turns.

Loads ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
builds its decode library, and times the paged and the dense decode
kernel at qwen3-8b's widths (32 / 8 heads of 128, B = 8, lengths 1-2048,
a pool of 256-row blocks), at deepseek-coder-33b's G = 7, qwen2-vl's
G = 8 and hymba's (5, 64) through a 1024 window, each as the device time
of a CUDA graph of 20 launches, median of five, and the registers and
spill bytes ``ptxas`` gave each instance; it prints one JSON line with
the card's ``nvidia-smi`` name and power limit.  To compare trees, run it in
alternating processes (parent, change, change, parent) in one call on
the card, the parent unpacked with ``git archive``.

Run:  python3 scripts/decode_turns.py [--src build/parent/src]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CASES = (("qwen3", 32, 8, 128, 0), ("g7", 56, 8, 128, 0),
         ("g8", 64, 8, 128, 0), ("hymba", 25, 5, 64, 1024))


def graph_ms(torch, fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path,
                    default=Path(__file__).resolve().parents[1] / "src")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("decode_turns: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src))
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as dec
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    build.library("decode_attention")
    ptxas = build.ptxas_entries(build.PTXAS_LOG.get("decode_attention", ""))
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    B, S, bl = 8, 2048, 256
    out = {"src": str(args.src), "card": card,
           "ptxas": [[k, r, sp] for k, r, sp in ptxas]}
    for label, H, K, D, W in CASES:
        def rnd(*s):
            return torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
        q, k, v = rnd(B, H, D), rnd(B, S, K, D), rnd(B, S, K, D)
        kp, vp = rnd(B * S // bl, bl, K, D), rnd(B * S // bl, bl, K, D)
        lens = torch.randint(1, S + 1, (B,), generator=g, device=dev,
                             dtype=torch.int32)
        tbl = torch.randperm(B * S // bl, generator=g, device=dev).reshape(
            B, S // bl).to(torch.int32)
        rounds = {"paged": [], "dense": []}
        for _ in range(5):
            rounds["paged"].append(graph_ms(torch, lambda: (
                dec.paged_decode_attention(q, kp, vp, tbl, cache_len=lens,
                                           window=W))))
            rounds["dense"].append(graph_ms(torch, lambda: (
                dec.decode_attention(q, k, v, cache_len=lens, window=W))))
        out[label] = {n: sorted(r)[2] for n, r in rounds.items()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
