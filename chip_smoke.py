#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA card.

Drives the port's main path — ``specialize(target="h100-sxm")`` ->
``ServeEngine.from_plan`` -> bucketed prefill -> paged-KV decode ->
tokens — for full-width, full-depth qwen3-8b (random weights from a
seed), and holds each of the path's hand-written kernels against its
plain PyTorch version on the card.

Phases (any failure exits non-zero before the last line):

1. device: ``nvidia-smi`` name and power limit, the kernels' build
   (``nvcc`` for ``sm_90a``, one process per source, all at once);
2. kernels: each kernel against its plain version at the main path's
   attention widths (32 q heads, 8 kv heads, head_dim 128, bf16), then
   its time, the plain version's, one library call's (a yardstick the
   port never calls) and the bound (bytes at 3.35 TB/s or operations at
   989 TFLOP/s, whichever is larger);
3. serve, paged: the plan's paged pool, 16 requests;
4. serve, dense: the same weights under a dense-residency plan;
5. checks: a full-width consistency check (decode-step logits against
   the flash prefill of the same tokens, under both decode kernels)
   and a small model on the card against the same model on the CPU;
6. one ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

PEAK_BF16 = 989e12          # H100 SXM data sheet, dense bf16 tensor core
HBM_BW = 3.35e12            # H100 SXM data sheet, bytes/s
# worst row's rms |kernel - plain| / rms |plain|, a few times the error
# measured on an H100 (flash 4.1e-3: it rounds P to bf16 for its MMAs;
# decode 6.7e-4 paged, 2.8e-4 dense: fp32 P); see row_err
TOL = {"flash_attention": 1e-2, "paged_decode_attention": 3e-3,
       "decode_attention": 3e-3}
LOGIT_TOL = 2e-2            # small model: max |card - cpu| / max |cpu| logits
FULL_TOL = 0.1              # rms-relative logits, 36 layers (see below)
H, K, D = 32, 8, 128        # qwen3-8b attention widths
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


# ---------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------

def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches, by CUDA
    events after ``warmup`` untimed runs."""
    for _ in range(warmup):
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


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = flops / PEAK_BF16 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def row_err(torch, got, want):
    """``max |got - want|`` and the worst row's rms-relative error, a row
    being one head's ``D`` outputs for one query (one slot in decode).

    Held per row because the outputs' scale varies by ~100x with the
    number of live keys (a one-key row is a raw V row, |.| ~ 3; a
    2048-key row ~ 0.04): one global scale would let a long row's fault
    hide under a short row's magnitude.  The kernels round P to bf16
    before P.V (the decode kernels keep P in fp32) and all round the
    output to bf16, as the plain versions do: at most a few parts in
    1e3 of a row, where a dropped or misread tile of a long row is tens
    of parts in 100 (the phase's planted faults show it)."""
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), "kernel output is not finite")
    e = (got - want).reshape(-1, got.shape[-1])
    w = want.reshape(-1, want.shape[-1])
    rel = e.pow(2).mean(1).sqrt() / w.pow(2).mean(1).sqrt().clamp_min(1e-6)
    return float(e.abs().max()), float(rel.max())


def control(kernel, fault, torch, got, want):
    """A planted fault must fail the check that the kernel passes."""
    _, rel = row_err(torch, got, want)
    tol = TOL[kernel]
    log(f"control {kernel} {fault}: worst row rel={rel:.3e} (must exceed "
        f"tol {tol})")
    check(rel > tol, f"control {kernel} {fault} passed the check "
          f"({rel} <= {tol})")
    return rel


# ---------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------

def kernel_phase(torch, dev):
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    g = torch.Generator(dev).manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    res = {}

    # ---- flash attention: ragged S in 128..2048, causal (prefill) ----
    worst = worst_rel = 0.0
    for S in (128, 700, 1536, 2048):
        q, k, v = rnd(1, S, H, D), rnd(1, S, K, D), rnd(1, S, K, D)
        want = fa.flash_attention_plain(q, k, v, causal=True)
        err, rel = row_err(torch, fa.flash_attention(q, k, v, causal=True),
                           want)
        tol = TOL["flash_attention"]
        log(f"kernel flash_attention S={S}: max_abs_err={err:.3e} "
            f"worst row rel={rel:.3e} (tol {tol})")
        check(rel <= tol, f"flash_attention S={S} row rel err {rel} > {tol}")
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
    # planted fault: the longest rows miss their first kv tile (64 keys)
    ctl = control("flash_attention", "drops one kv tile", torch,
                  fa.flash_attention(q, k, v, causal=True, window=S - 64),
                  want)
    B, S = 2, 1024                  # timed: a bucket of two 1024-token prompts
    q, k, v = rnd(B, S, H, D), rnd(B, S, K, D), rnd(B, S, K, D)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True))
    plain = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v,
                                                            causal=True),
                    iters=5)
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    pairs = B * S * (S + 1) / 2
    b_ms, b_by = bound(2 * (2 * B * S * H * D + 2 * B * S * K * D),
                       4 * D * H * pairs)
    res["flash_attention"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:221",
        max_abs_err=worst, row_rel_err=worst_rel, control_row_rel_err=ctl,
        tolerance=TOL["flash_attention"], ms=ms, plain_ms=plain,
        library_ms=lib, bound_ms=b_ms, bound_by=b_by,
        shape=f"B={B} S={S} H={H} K={K} D={D} causal bf16",
        library_call="F.scaled_dot_product_attention(is_causal, enable_gqa)")

    # ---- decode: 8 slots, mixed cache lengths 1..2048 ----
    lens_list = [1, 64, 300, 777, 1024, 1500, 1999, 2048]
    Bd, max_len, bl = len(lens_list), 2048, 256
    lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
    nb = max_len // bl
    need = [-(-n // bl) for n in lens_list]
    N = nb * Bd
    perm = torch.randperm(N, generator=g, device=dev).int()
    tbl = torch.full((Bd, nb), -1, dtype=torch.int32, device=dev)
    at = 0
    for b, n in enumerate(need):          # -1 tails past each slot's blocks
        tbl[b, :n] = perm[at:at + n]
        at += n
    qd = rnd(Bd, H, D)
    kp, vp = rnd(N, bl, K, D), rnd(N, bl, K, D)
    kd, vd = rnd(Bd, max_len, K, D), rnd(Bd, max_len, K, D)
    live = sum(lens_list)
    dec_flops = 4 * D * H * live
    qkv_io = 2 * (2 * Bd * H * D) + 4 * Bd        # q, out, cache_len
    kv_bytes = 2 * 2 * live * K * D

    # the planted faults: the longest slot one tile short, and one of its
    # full blocks swapped for another slot's
    short = lens.clone()
    short[-1] -= bl
    swapped = tbl.clone()
    swapped[-1, 0] = tbl[-2, 0]

    # paged
    want = dec.paged_decode_attention_plain(qd, kp, vp, tbl, cache_len=lens)
    err, rel = row_err(
        torch, dec.paged_decode_attention(qd, kp, vp, tbl, cache_len=lens),
        want)
    tol = TOL["paged_decode_attention"]
    log(f"kernel paged_decode_attention bl={bl} lens={lens_list}: "
        f"max_abs_err={err:.3e} worst row rel={rel:.3e} (tol {tol})")
    check(rel <= tol, f"paged_decode_attention row rel err {rel} > {tol}")
    ctl = min(control("paged_decode_attention", "one tile short", torch,
                      dec.paged_decode_attention(qd, kp, vp, tbl,
                                                 cache_len=short), want),
              control("paged_decode_attention", "one table entry swapped",
                      torch, dec.paged_decode_attention(
                          qd, kp, vp, swapped, cache_len=lens), want))
    # a freed slot (table row -1, length 1) reads zero rows: zeros out
    free_tbl = tbl.clone()
    free_tbl[0] = -1
    out = dec.paged_decode_attention(qd, kp, vp, free_tbl, cache_len=lens)
    check(float(out[0].float().abs().max()) == 0.0,
          "paged_decode_attention: freed slot output is not zero")
    ms = time_ms(torch, lambda: dec.paged_decode_attention(
        qd, kp, vp, tbl, cache_len=lens))
    plain = time_ms(torch, lambda: dec.paged_decode_attention_plain(
        qd, kp, vp, tbl, cache_len=lens), iters=5)
    b_ms, b_by = bound(qkv_io + kv_bytes + 4 * sum(need), dec_flops)
    res["paged_decode_attention"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:130",
        max_abs_err=err, row_rel_err=rel, control_row_rel_err=ctl,
        tolerance=tol, ms=ms, plain_ms=plain, library_ms=None,
        bound_ms=b_ms, bound_by=b_by,
        shape=f"B={Bd} bl={bl} H={H} K={K} D={D} lens={lens_list} bf16",
        library_call="none takes a block table")

    # dense
    mask = (torch.arange(max_len, device=dev)[None, :]
            < lens[:, None])[:, None, None, :]
    want = dec.decode_attention_plain(qd, kd, vd, cache_len=lens)
    err, rel = row_err(
        torch, dec.decode_attention(qd, kd, vd, cache_len=lens), want)
    tol = TOL["decode_attention"]
    log(f"kernel decode_attention S={max_len} lens={lens_list}: "
        f"max_abs_err={err:.3e} worst row rel={rel:.3e} (tol {tol})")
    check(rel <= tol, f"decode_attention row rel err {rel} > {tol}")
    ctl = control("decode_attention", "one tile short", torch,
                  dec.decode_attention(qd, kd, vd, cache_len=short), want)
    ms = time_ms(torch, lambda: dec.decode_attention(qd, kd, vd,
                                                     cache_len=lens))
    plain = time_ms(torch, lambda: dec.decode_attention_plain(
        qd, kd, vd, cache_len=lens), iters=5)
    q4, k4, v4 = qd[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2)
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask, enable_gqa=True))
    b_ms, b_by = bound(qkv_io + kv_bytes, dec_flops)
    res["decode_attention"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:194",
        max_abs_err=err, row_rel_err=rel, control_row_rel_err=ctl,
        tolerance=tol, ms=ms, plain_ms=plain,
        library_ms=lib, bound_ms=b_ms, bound_by=b_by,
        shape=f"B={Bd} S={max_len} H={H} K={K} D={D} lens={lens_list} bf16",
        library_call="F.scaled_dot_product_attention(attn_mask, enable_gqa)")
    for name, r in res.items():
        log(f"timing {name}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}) at {r['shape']}")
    ops.reset_launch_counts()       # comparison launches do not count
    return res


# ---------------------------------------------------------------------
# phases 3-4: serving
# ---------------------------------------------------------------------

def serve_phase(torch, dev, name, arch, plan, params, n_requests,
                new_tokens):
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.serve.engine import ServeEngine

    est = plan.estimates
    log(f"serve[{name}] plan {plan.content_hash()[:16]} target={plan.target} "
        f"kv_residency={est.get('kv_residency')} "
        f"kv_block_len={est.get('kv_block_len')} "
        f"kv_n_blocks={est.get('kv_n_blocks')} "
        f"kv_admission={est.get('kv_admission')} "
        f"kv_prefill_mode={est.get('kv_prefill_mode')} "
        f"decode tile={dict(plan.partitions['decode_attention'].blocks)}")
    eng = ServeEngine.from_plan(plan, params, arch=arch,
                                kv_prefix_reuse="off", kv_host_blocks=0,
                                seed=SEED)
    rng = np.random.default_rng(SEED)
    vocab = eng.arch.vocab_size
    prompts = [rng.integers(0, vocab, (int(rng.integers(1, 25)) * 64,))
               for _ in range(n_requests)]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        eng.submit(p, max_new_tokens=new_tokens,
                   temperature=0.0 if i % 2 == 0 else 0.8)
    done = eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    toks = sum(len(r.out_tokens) for r in done)
    ttft = np.array([(r.t_first - r.t_submit) * 1e3 for r in done])
    check(len(done) == n_requests, f"serve[{name}]: {len(done)} of "
          f"{n_requests} requests finished")
    for r in done:
        check(len(r.out_tokens) == new_tokens
              and all(0 <= t < vocab for t in r.out_tokens),
              f"serve[{name}]: request {r.rid} tokens {r.out_tokens}")
    st = eng.block_stats()
    check(st["free"] == st["total"] and st["in_use"] == 0,
          f"serve[{name}]: blocks not all returned: {st}")
    log(f"serve[{name}] requests={len(done)} tokens={toks} "
        f"wall_s={wall:.3f} tok_per_s={toks / wall:.1f} "
        f"ttft_ms_p50={np.percentile(ttft, 50):.1f} "
        f"ttft_ms_p95={np.percentile(ttft, 95):.1f} "
        f"prompt_lens={[len(p) for p in prompts]} "
        f"prefill_calls={eng.prefill_calls} "
        f"prefill_batches={list(eng.prefill_batches)} ticks={eng.tick}")
    log(f"serve[{name}] block_stats={st} launches={counts} "
        f"decode_path={eng.decode_path}")
    for r in done[:2]:
        log(f"serve[{name}]   rid={r.rid} prompt={len(r.prompt)} "
            f"t={r.temperature} -> {r.out_tokens[:8]}...")
    del eng
    torch.cuda.empty_cache()
    return counts, {"requests": len(done), "tokens": toks, "wall_s": wall,
                    "tok_per_s": toks / wall,
                    "ttft_ms_p50": float(np.percentile(ttft, 50)),
                    "ttft_ms_p95": float(np.percentile(ttft, 95))}


# ---------------------------------------------------------------------
# phase 5: outputs against references
# ---------------------------------------------------------------------

def _rms_rel(torch, got, want) -> float:
    return float((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())


def consistency_check(torch, dev, arch, params, cfg, bl):
    """Full width: the logits of one decode step after a prefill of
    ``P`` tokens against the flash prefill's last-token logits over the
    same ``P + 1`` tokens — once through the dense decode kernel and
    once through the paged one (the prefill cache laid out as pool
    blocks, in reverse order, behind a table).

    Through 36 bf16 layers the model amplifies the kernels' rounding:
    the flash prefill against itself under another tile (only the order
    of its own fp32 sums and where P rounds to bf16 change) already
    differs by ~5e-2 rms of the logits, and a wrong input token by more
    than 1.  So the check is rms-relative, at :data:`FULL_TOL`, with
    that noise floor printed beside it and a wrong-token control that
    must fail it; top-1 tokens must agree.  The kernels' own tolerance
    is held row by row in the kernel phase, and :data:`LOGIT_TOL` by
    :func:`small_model_check`.
    """
    from repro_torch.models import lm

    g = torch.Generator(dev).manual_seed(SEED + 1)
    P, max_len = 300, 2 * bl
    toks = torch.randint(0, arch.vocab_size, (2, P + 1), generator=g,
                         device=dev, dtype=torch.int32)
    V = arch.vocab_size
    want = lm.prefill(arch, params, {"tokens": toks}, cfg)[0][:, :V].float()
    retiled = dataclasses.replace(cfg, flash_tiles=(16, 128))
    other = lm.prefill(arch, params, {"tokens": toks}, retiled)[0]
    floor = _rms_rel(torch, other[:, :V].float(), want)
    for residency in ("dense", "paged"):
        results = {}
        for name, last in (("right", toks[:, P:]),
                           ("wrong", (toks[:, P:] + 1) % V)):
            _, cache = lm.prefill(arch, params, {"tokens": toks[:, :P]}, cfg,
                                  max_len=max_len)
            if residency == "paged":
                nb = max_len // bl

                def pool(t):
                    return t.reshape(t.shape[0], 2 * nb, bl,
                                     *t.shape[3:]).flip(1).contiguous()

                cache = {"pos": cache["pos"], "k": pool(cache["k"]),
                         "v": pool(cache["v"]),
                         "block_tbl": (2 * nb - 1 - torch.arange(
                             2 * nb, device=dev, dtype=torch.int32)
                         ).reshape(2, nb).contiguous()}
            got, _ = lm.decode_step(arch, params, cache, {"tokens": last},
                                    cfg)
            check(tuple(got.shape) == (2, params["embed"].shape[0])
                  and bool(torch.isfinite(got).all()),
                f"consistency[{residency}]: logits {tuple(got.shape)} "
                "not finite or misshapen")
            results[name] = got[:, :V].float()
        rms = _rms_rel(torch, results["right"], want)
        control = _rms_rel(torch, results["wrong"], want)
        top1 = bool((results["right"].argmax(-1) == want.argmax(-1)).all())
        log(f"check full-width decode[{residency}] vs flash prefill logits: "
            f"rms_rel={rms:.3e} (tol {FULL_TOL}; flash re-tiled against "
            f"itself {floor:.3e}; wrong-token control {control:.3e}) "
            f"top1_agree={top1} scale={float(want.abs().max()):.3f}")
        check(rms <= FULL_TOL and top1,
              f"consistency[{residency}] rms_rel {rms} > {FULL_TOL} "
              f"or top-1 differs")
        check(control > FULL_TOL, f"consistency[{residency}]: the "
              f"wrong-token control passed ({control})")


def small_model_check(torch, dev):
    """A small qwen3 (2 layers, d_model 128, head_dim 128) through the
    kernels on the card against the plain versions on the CPU."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core import specialize
    from repro_torch.core.passes.lowering import build_run_cfg
    from repro_torch.models import lm

    arch = dataclasses.replace(get_arch("qwen3-8b").reduced(), head_dim=128)
    for residency in ("paged", "dense"):
        plan = specialize(arch, ShapeConfig("small", "decode", 512, 4),
                          mesh_shape=(1, 1), kv_residency=residency,
                          cache=False)
        cfg = build_run_cfg(plan, arch)
        cpu = torch.device("cpu")
        params = lm.init_params(arch, torch.Generator().manual_seed(SEED),
                                *plan.padded_sizes())
        toks = torch.randint(0, arch.vocab_size, (4, 100),
                             generator=torch.Generator().manual_seed(SEED),
                             dtype=torch.int32)
        outs = {}
        for d in (cpu, dev):
            p = _to(torch, params, d)
            logits, cache = lm.prefill(arch, p, {"tokens": toks.to(d)}, cfg,
                                       max_len=512)
            steps = [logits.float().cpu()]
            if residency == "paged":
                bl = int(plan.estimates["kv_block_len"])
                nb = 512 // bl
                cache = {"pos": cache["pos"],
                         "k": cache["k"].reshape(arch.n_layers, 4 * nb, bl,
                                                 *cache["k"].shape[3:]),
                         "v": cache["v"].reshape(arch.n_layers, 4 * nb, bl,
                                                 *cache["v"].shape[3:]),
                         "block_tbl": torch.arange(
                             4 * nb, dtype=torch.int32, device=d
                         ).reshape(4, nb)}
            for i in range(4):
                nxt = toks[:, i:i + 1].to(d)
                logits, cache = lm.decode_step(arch, p, cache,
                                               {"tokens": nxt}, cfg)
                steps.append(logits.float().cpu())
            outs[d.type] = torch.stack(steps)
        rel = float((outs["cuda"] - outs["cpu"]).abs().max()
                    / outs["cpu"].abs().max())
        log(f"check small model ({residency}) card vs cpu logits: "
            f"rel={rel:.3e} (tol {LOGIT_TOL})")
        check(rel <= LOGIT_TOL,
              f"small model {residency}: rel {rel} > {LOGIT_TOL}")


def _to(torch, tree, dev):
    if isinstance(tree, dict):
        return {k: _to(torch, v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ---------------------------------------------------------------------

def main() -> int:
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: no port package at {SRC / 'repro_torch'}; run "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test runs only on an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 1: device and build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"device {torch.cuda.get_device_name(0)} count "
        f"{torch.cuda.device_count()} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    from repro_torch.kernels import build, ops
    t0 = time.perf_counter()
    build.build_all()
    log(f"build: {len(build.SOURCES)} sources with nvcc for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in build.PTXAS_LOG.items():
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill", text))
        log(f"ptxas {name}: {len(regs)} kernels, registers <= {max(regs)}, "
            f"{spills} bytes of spill stores and loads")

    # ---- phase 2: kernels ----
    kern = kernel_phase(torch, dev)

    # ---- phases 3-4: serve ----
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core import specialize
    from repro_torch.core.passes.lowering import build_run_cfg
    from repro_torch.models import lm

    arch = get_arch("qwen3-8b")
    shape = ShapeConfig("serve_h100", "decode", 2048, 8)
    plan = specialize(arch, shape, mesh_shape=(1, 1), target="h100-sxm")
    check(plan.estimates.get("kv_residency") == "paged",
          f"the h100 plan is not paged: {plan.estimates.get('kv_residency')}")
    t0 = time.perf_counter()
    params = lm.init_params(arch, torch.Generator(dev).manual_seed(SEED),
                            *plan.padded_sizes())
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"weights: qwen3-8b layers={arch.n_layers} d_model={arch.d_model} "
        f"heads={arch.n_heads}/{arch.n_kv_heads} d_ff={arch.d_ff} "
        f"vocab={arch.vocab_size} params={n_params} random (seed {SEED}) "
        f"in {time.perf_counter() - t0:.1f} s")
    paged_counts, paged = serve_phase(torch, dev, "paged", arch, plan,
                                      params, n_requests=16, new_tokens=32)
    check(paged_counts["flash_attention"] > 0
          and paged_counts["paged_decode_attention"] > 0,
          f"paged serve did not launch its kernels: {paged_counts}")
    dplan = specialize(arch, shape, mesh_shape=(1, 1), target="h100-sxm",
                       kv_residency="dense")
    check(dplan.estimates.get("kv_residency") == "dense",
          "the dense plan is not dense")
    dense_counts, dense = serve_phase(torch, dev, "dense", arch, dplan,
                                      params, n_requests=8, new_tokens=16)
    check(dense_counts["flash_attention"] > 0
          and dense_counts["decode_attention"] > 0,
          f"dense serve did not launch its kernels: {dense_counts}")

    # ---- phase 5: outputs against references ----
    consistency_check(torch, dev, arch, params, build_run_cfg(plan, arch),
                      int(plan.estimates["kv_block_len"]))
    del params
    torch.cuda.empty_cache()
    small_model_check(torch, dev)
    ops.reset_launch_counts()

    # ---- phase 6: results ----
    launches = {k: paged_counts[k] + dense_counts[k] for k in paged_counts}
    kernels = []
    for name, r in kern.items():
        kernels.append({"name": name, **{k: r[k] for k in (
            "route", "source", "replaces")}, "launches": launches[name],
            **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms",
                                 "row_rel_err", "tolerance",
                                 "control_row_rel_err", "shape",
                                 "library_call")}})
    log(json.dumps({"serve": {"paged": paged, "dense": dense,
                              "launches": {"paged": paged_counts,
                                           "dense": dense_counts}}}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
