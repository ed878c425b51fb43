"""Where K9's two launches spend their time, at hymba-1.5b's and qwen3-8b's shapes.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 scripts/k9_anatomy.py [--out build/k9_anatomy.json]

Copies ``csrc/decode_split.cu`` into ``build/k9_anatomy/<version>/``,
built for K9's (2, 32) and (4, 64) instances only, as committed and with one piece
taken out (patched at fixed anchors: keep them when editing the kernel),
and times each pass of each version, dense and paged, as CUDA-graph
device time (``chip_smoke.graph_ms``) in turns on one card, beside one
trivial graph-captured launch (a one-element add: the fixed cost of a
launch), at ``chip_smoke.py``'s K9 shapes of :data:`SHAPES` (B=8,
S=2048, 64 blocks of 256; hymba's 26 / 13 heads, rank 0's 32 of 64
columns, window 1024, every version; qwen3-8b's 32 / 8, 64 of 128
columns, no window, the committed kernel's splits).  The versions:

* ``kernel``: as committed (its passes held against the plain passes at
  ``chip_smoke.TOL["decode_split"]`` first), pass 2 at the split rule's
  ``(splits, rows)`` and at each split count of :data:`SPLITS`;
* ``no_reads``: neither pass loads a K or V row;
* ``no_table``: neither pass reads the block table (a paged row's block
  is its table column: valid blocks of the pool, the wrong ones);
* ``no_scores``: pass 2 reads no score (every row scores 0);
* ``empty``: each launch returns at once (the same grids and cluster);
* ``score_tile256``: pass 1 with tiles of 256 columns;
  ``score_256x256``: and 256 threads a CTA;
* ``loads8``: pass 2 with 8 V loads a thread a stage (256-row stages);
* ``stamps``: ``%globaltimer`` stamps (thread 0 of each CTA) after each
  step of both passes, read back after one launch at the split rule's
  splits (not timed).

Only the committed version's outputs are checked.  Prints a line a
version and pass, then one JSON line, with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "k9_anatomy"

#: (anchor in decode_split.cu, replacement[, times it occurs]); once
#: where no count is given
ONE_CASE = ("  X(2, 32) X(4, 16) X(5, 32) X(5, 16) X(4, 64)",
            "  X(2, 32) X(4, 64)")
NO_READS = (
    ("      if (ok) kv[i] = *reinterpret_cast<const uint4*>(k + off + c * 8);",
     "      (void)off;"),
    ("          if (ok) vr[i] = *reinterpret_cast<const uint4*>(v + off + c "
     "* 8);", "          (void)off;"))
NO_TABLE = (
    ("  if (PAGED && nb <= kTblWhole) stage_table<T>(tbl, stbl, b, nb, 0, "
     "nb);\n", "", 2),
    ("  if (nb <= kTblWhole) return 0;\n", "  if (nb > 0) return 0;\n"),
    ("    const int blk = st[rm.col(j) - e0];",
     "    const int blk = rm.col(j);"))
NO_SCORES = (("            if (c + k * C < G) sr[i][k] = sb[size_t(c + k * C) "
              "* Wc + x];", "            sr[i][k] = 0.f;"),)
EMPTY = (
    ("  __shared__ float ss[G * TILE];\n",
     "  if (blockIdx.x < 1u << 30) return;\n  __shared__ float ss[G * TILE];\n"),
    ("  __shared__ float wpart[W * G * P];   // the warps' partials\n",
     "  if (blockIdx.x < 1u << 30) return;\n"
     "  __shared__ float wpart[W * G * P];\n"))
SCORE_TILE_256 = (("constexpr int kScoreTile = 128;", "constexpr int kScoreTile = 256;"),)
SCORE_256 = SCORE_TILE_256 + (
    ("constexpr int kScoreThreads = 128;", "constexpr int kScoreThreads = 256;"),)
#: ``%globaltimer`` stamps (ns) by thread 0 of each CTA: pass 1 into
#: ``g_s1``, pass 2 into ``g_s2``; (label, anchor, "before" or "after")
MAX_CTAS = 8192
STAMP_HEAD = f"""
__device__ long long g_s1[{MAX_CTAS}][8];
__device__ long long g_s2[{MAX_CTAS}][8];
#define K9_STAMP(arr, i) do {{ if (threadIdx.x == 0) {{ long long t_;     \\
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                \\
    const unsigned c_ = blockIdx.x + gridDim.x * (blockIdx.y +             \\
                        gridDim.y * blockIdx.z);                           \\
    if (c_ < {MAX_CTAS}) arr[c_][i] = t_; }} }} while (0)
"""
STAMP_TAIL = f"""
extern "C" int k9_clear_stamps() {{
  void* p;
  cudaError_t e = cudaGetSymbolAddress(&p, g_s1);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(g_s1));
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&p, g_s2);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(g_s2));
  return int(e);
}}
extern "C" int k9_read_stamps(void* s1, void* s2) {{
  cudaError_t e = cudaMemcpyFromSymbol(s1, g_s1, sizeof(g_s1));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(s2, g_s2, sizeof(g_s2));
  return int(e);
}}
"""
STAMPS1 = (
    ("start", "  const int tid = threadIdx.x, c = tid % C;\n", "after"),
    ("cache_len in", "  const int r0 = lv.lo + x0;                     // the "
     "tile's first row\n", "after"),
    ("rows scored", "  __syncthreads();\n#pragma unroll\n  for (int g = 0; g "
     "< G; ++g)\n    for (int x = tid; x < ncol; x += T)\n      sb[", "before"),
    ("stored", "      sb[size_t(g) * Wc + x] = x < nloc ? ss[g * TILE + x] : "
     "0.f;\n", "after"))
STAMPS2 = (
    ("start", "  if (splits > 1) cluster_arrive_relaxed();\n", "after"),
    ("cache_len in", "    const RowMap rm{seq, shift};\n    const int r0 = "
     "lv.lo + x0;\n    int e0 = 0;", "before"),
    ("stages taken", "        take(vb, sbuf);\n      }\n    }\n", "after"),
    ("warp partials", "  // the warps merged in order: the split's partial\n",
     "before"),
    ("split partial", "  if (splits == 1) return;\n", "before"),
    ("end", "  cg::this_cluster().sync();           // every split's partial "
     "is in rank 0\n", "after"))
LOADS_8 = (("constexpr int kCtxLoads = 4;", "constexpr int kCtxLoads = 8;"),)
VERSIONS = {"kernel": (), "no_reads": NO_READS, "no_table": NO_TABLE,
            "no_scores": NO_SCORES, "empty": EMPTY,
            "score_tile256": SCORE_TILE_256, "score_256x256": SCORE_256,
            "loads8": LOADS_8, "stamps": "stamps"}
#: the shapes: (label, query heads, kv heads, head_dim, ranks m, window,
#: every version timed or the committed kernel's splits only)
SHAPES = (("hymba12", 26, 13, 64, 2, 1024, True),
          ("qwen3m2", 32, 8, 128, 2, 0, False))
#: pass 2's split counts timed beside the split rule's (rows: the fewest
#: whole tiles that cover the columns)
SPLITS = (2, 4, 8)


def stamped(src: str) -> str:
    """The source with :data:`STAMPS1` / :data:`STAMPS2` in place and the
    read-back entry points."""
    include = '#include "common.cuh"\n'
    out = src.replace(include, include + STAMP_HEAD) + STAMP_TAIL
    for arr, stamps in (("g_s1", STAMPS1), ("g_s2", STAMPS2)):
        labels = list(dict.fromkeys(label for label, _, _ in stamps))
        for label, text, where in stamps:
            if out.count(text) != 1:
                raise SystemExit(f"k9_anatomy: the anchor for {label!r} "
                                 f"occurs {out.count(text)} times")
            st = f"K9_STAMP({arr}, {labels.index(label)});\n"
            if where == "after":
                out = out.replace(text, text + st)
            elif where == "before":
                out = out.replace(text, st + text)
            else:                   # after the first line of the anchor
                first, rest = text.split("\n", 1)
                out = out.replace(text, first + "\n" + st + rest)
    return out


def patched(src: str, patches) -> str:
    if patches == "stamps":
        src, patches = stamped(src), ()
    for old, new, *times in (ONE_CASE, *patches):
        if src.count(old) != (times[0] if times else 1):
            raise SystemExit(f"k9_anatomy: the anchor {old[:50]!r} occurs "
                             f"{src.count(old)} times in decode_split.cu")
        src = src.replace(old, new)
    return src


def build_all():
    """One library a version, all nvcc runs at once."""
    from repro_torch.kernels import build
    src = (CSRC / "decode_split.cu").read_text()
    procs = {}
    for name, patches in VERSIONS.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "decode_split.cu").write_text(patched(src, patches))
        lib = d / "libdecode_split.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(CSRC), "-o",
               str(lib), str(d / "decode_split.cu")]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k9_anatomy: nvcc failed for {name}:\n{log}")
        if name == "kernel":
            for kernel, regs, spills in build.ptxas_entries(log):
                print(f"ptxas decode_split: {kernel}: {regs} registers at "
                      f"entry, {spills} bytes of spills", flush=True)
        libs[name] = ctypes.CDLL(str(lib))
        for fn, argtypes in build._SIGNATURES["decode_split"].items():
            getattr(libs[name], fn).argtypes = argtypes
            getattr(libs[name], fn).restype = ctypes.c_int
    return libs


def stamp_summary(torch, arr, labels, n):
    """Per stamp, over the CTAs that reached it: the mean ns from the
    CTA's own start, and the first start and the last stamp from the
    launch's first start."""
    a = arr[:n].double()
    t0 = a[:, 0].min()
    out = {"ctas": n, "start_spread_ns": float(a[:, 0].max() - t0)}
    for i, label in enumerate(labels[1:], 1):
        hit = a[:, i] > 0
        if bool(hit.any()):
            out[label] = {"mean_ns": float((a[hit, i] - a[hit, 0]).mean()),
                          "last_ns": float(a[hit, i].max() - t0),
                          "ctas": int(hit.sum())}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("k9_anatomy: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import decode_attention as dec
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cs.CARD = card
    dev = torch.device("cuda", 0)
    libs = build_all()
    libs["stamps"].k9_read_stamps.argtypes = [ctypes.c_void_p] * 2
    B, S, bl, N = cs.SPLIT_B, cs.SPLIT_S, cs.SPLIT_BL, cs.SPLIT_N
    nb = S // bl
    g = torch.Generator(dev).manual_seed(cs.SEED + 9)
    one = torch.zeros(1, device=dev)
    s1 = torch.zeros((MAX_CTAS, 8), dtype=torch.int64)
    s2 = torch.zeros((MAX_CTAS, 8), dtype=torch.int64)
    labels1 = list(dict.fromkeys(lb for lb, _, _ in STAMPS1))
    labels2 = list(dict.fromkeys(lb for lb, _, _ in STAMPS2))
    res = {"card": card, "shapes": {}}

    def stream():
        # the capturing stream while a graph is captured
        return torch.cuda.current_stream(dev).cuda_stream

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    for label, Hq, Kv, Dh, m, W, every in SHAPES:
        DS = Dh // m
        q = rnd(B, Hq, DS)
        k, v = rnd(B, S, Kv, DS), rnd(B, S, Kv, DS)
        kp, vp = rnd(N, bl, Kv, DS), rnd(N, bl, Kv, DS)
        lens = torch.randint(1, S + 1, (B,), generator=g, device=dev,
                             dtype=torch.int32)
        lens[0], lens[1] = 1, S
        tbl = torch.randperm(N, generator=g, device=dev).reshape(B, nb).to(
            torch.int32)
        used = torch.arange(nb, device=dev)[None] * bl < lens[:, None]
        tbl = torch.where(used, tbl, -1).contiguous()
        cols = dec.split_cols(S, W)
        rule = dec.context_split(B, Kv, DS, cols)
        tiles = -(-cols // dec.SPLIT_TILE)
        sweep = {n: (-(-cols // (dec.SPLIT_TILE * -(-tiles // n))),
                     dec.SPLIT_TILE * -(-tiles // n)) for n in SPLITS}
        out_shape = res["shapes"][label] = {
            "shape": f"B={B} S={S} ({N} blocks of {bl}) H={Hq} K={Kv} "
                     f"DS={DS} window {W}", "split_rule": rule, "ms": {},
            "stamps": {}}
        for paged in (False, True):
            kk, vv, tb = (kp, vp, tbl) if paged else (k, v, None)
            seq = bl if paged else S
            tptr = tb.data_ptr() if paged else None
            nbp = nb if paged else 0
            s = torch.empty((B, Hq, cols), dtype=torch.float32, device=dev)
            out = torch.empty((B, Hq, DS), dtype=torch.bfloat16, device=dev)

            def scores(lib):
                err = lib.decode_split_scores(
                    q.data_ptr(), kk.data_ptr(), tptr, lens.data_ptr(),
                    s.data_ptr(), B, Hq, Kv, DS, seq, nbp, cols, W,
                    float(Dh ** -0.5), -1, stream())
                assert err == 0, err

            def context(lib, split=rule):
                err = lib.decode_split_context(
                    s.data_ptr(), vv.data_ptr(), tptr, lens.data_ptr(),
                    out.data_ptr(), B, Hq, Kv, DS, seq, nbp, cols, W,
                    *split, 0, stream())
                assert err == 0, err
            kw = dict(cache_len=lens, window=W)
            scores(libs["kernel"])
            want = dec.decode_split_scores_plain(q, kk, tb,
                                                 scale=Dh ** -0.5, **kw)
            _, rel = cs.row_err(torch, s, want)
            cs.check(rel <= cs.TOL["decode_split"],
                     f"k9_anatomy: {label} pass 1 {rel}")
            for split in (rule, *sweep.values()):
                context(libs["kernel"], split)
                _, rel = cs.row_err(torch, out,
                                    dec.decode_split_context_plain(
                                        s, vv, tb, **kw))
                cs.check(rel <= cs.TOL["decode_split"],
                         f"k9_anatomy: {label} pass 2 at {split}: {rel}")
            fns = {"launch": functools.partial(one.add_, 1.0)}
            for name, lib in libs.items():
                if name == "stamps" or (name != "kernel" and not every):
                    continue
                fns[f"{name}/scores"] = functools.partial(scores, lib)
                fns[f"{name}/context"] = functools.partial(context, lib)
            for split in dict.fromkeys(sweep.values()):
                fns[f"kernel/context {split}"] = functools.partial(
                    context, libs["kernel"], split)
            med, _ = cs.in_turns(torch, fns, cs.graph_ms)
            key = "paged" if paged else "dense"
            out_shape["ms"][key] = med
            for name, ms in med.items():
                print(f"k9 anatomy {label} {key} {name}: {ms:.4f} ms in "
                      f"turns of {cs.TURNS} [{card}]", flush=True)
            # one launch of each pass with stamps, at the rule's split
            lib = libs["stamps"]
            for _ in range(3):
                assert lib.k9_clear_stamps() == 0
                scores(lib)
                context(lib)
                torch.cuda.synchronize()
            assert lib.k9_read_stamps(s1.data_ptr(), s2.data_ptr()) == 0
            st = out_shape["stamps"][key] = {
                "scores": stamp_summary(
                    torch, s1, labels1, -(-cols // 128) * Kv * B),
                "context": stamp_summary(torch, s2, labels2,
                                         rule[0] * Kv * B)}
            print(f"k9 stamps {label} {key} {rule}: {json.dumps(st)}",
                  flush=True)
    line = json.dumps({"k9_anatomy": res})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
