"""Serving launcher: batched requests through the port's ServeEngine.

Two modes, as in the JAX package's launcher, on one card:

* kwargs mode (default) — an engine from a hand :class:`RunCfg`, the
  quick local smoke path;
* plan mode (``--from-plan``) — run the specialization flow for a
  decode shape on the ``h100-sxm`` target, build the engine with
  :meth:`ServeEngine.from_plan`, and serve through the KV residency the
  plan chose.

The model is the arch's reduced config, with its published head_dim
(the kernels are built for 128), unless ``--full`` asks for its
published widths and depth; weights are random, from ``--seed``.
Entry points run on ``cuda``; ``--device cpu`` runs the kernels' plain
versions.  ``--profile`` traces the run with ``torch.profiler`` and
prints the device time by kernel and by group.

Run:  PYTHONPATH=src python -m repro_torch.launch.serve --from-plan
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--full", action="store_true",
                    help="the arch's published widths and depth (default: "
                         "its reduced config)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--from-plan", action="store_true",
                    help="specialize a decode plan and serve via "
                         "ServeEngine.from_plan")
    ap.add_argument("--profile", action="store_true",
                    help="trace the serving run with torch.profiler and "
                         "print device time by kernel and the busy share")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.core.pipeline import specialize
    from repro_torch.models.lm import RunCfg, init_params
    from repro_torch.serve.engine import ServeEngine

    arch = get_arch(args.arch)
    if not args.full:
        arch = dataclasses.replace(arch.reduced(), head_dim=arch.head_dim)
    gen = torch.Generator(args.device).manual_seed(args.seed)
    if args.from_plan:
        shape = ShapeConfig("serve", "decode", args.max_len, args.max_batch)
        plan = specialize(arch, shape, mesh_shape=(1, 1), target="h100-sxm")
        params = init_params(arch, gen, *plan.padded_sizes())
        engine = ServeEngine.from_plan(plan, params, arch=arch,
                                       seed=args.seed, kv_prefix_reuse="off",
                                       kv_host_blocks=0,
                                       kv_admission="reserve")
        print(f"plan {plan.content_hash()[:12]} target={plan.target} "
              f"kv_residency={engine.kv_residency} "
              f"block_len={engine.block_len} n_blocks={engine.n_blocks} "
              f"-> decode_path={engine.decode_path}")
    else:
        params = init_params(arch, gen)
        engine = ServeEngine(arch, params, RunCfg(),
                             max_batch=args.max_batch, max_len=args.max_len,
                             seed=args.seed)

    if engine.device.type == "cuda":
        from repro_torch.kernels import build
        build.build_all()               # compile before the timed run
    rng = np.random.default_rng(args.seed)
    prof = _profiler(engine.device) if args.profile else None
    t0 = time.time()
    if prof is not None:
        prof.__enter__()
    for _ in range(args.requests):
        plen = int(rng.integers(8, args.max_len - args.new_tokens - 1))
        engine.submit(rng.integers(0, arch.vocab_size, (plen,)),
                      max_new_tokens=args.new_tokens)
    done = engine.run_until_idle()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    dt = time.time() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
        _report(prof, dt)
    toks = sum(len(r.out_tokens) for r in done)
    print(f"served {len(done)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s) on {engine.device}")
    for r in done[:3]:
        print(f"  rid={r.rid} ttft={(r.t_first - r.t_submit) * 1e3:.0f}ms "
              f"total={(r.t_done - r.t_submit) * 1e3:.0f}ms "
              f"tokens={r.out_tokens[:8]}...")
    print(f"telemetry {engine.telemetry()}")


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


#: kernel-name fragments of each group in the device-time breakdown
_GROUPS = (("attention (port kernels)", ("flash_fwd_kernel",
                                         "decode_kernel")),
           ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "splitK")),
           ("copy", ("Memcpy", "Memset")))


def _report(prof, wall_s: float) -> None:
    """Device time by kernel (top 12) and by group, and the share of the
    run's wall time the device was busy: the device-side events' time
    summed over the run (eager launches on one stream do not overlap).
    The profiler's own host cost stretches the wall time it sees, so
    that share is a floor."""
    cuda = torch.autograd.DeviceType.CUDA
    rows = [e for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in rows)
    print(f"profile: device busy {busy_us / 1e3:.1f} ms of {wall_s * 1e3:.1f}"
          f" ms wall ({100 * busy_us / 1e6 / wall_s:.1f}%), "
          f"{sum(e.count for e in rows)} device ops")
    groups = {name: 0.0 for name, _ in _GROUPS}
    groups["other"] = 0.0
    for e in rows:
        name = next((g for g, keys in _GROUPS
                     if any(k in e.key for k in keys)), "other")
        groups[name] += e.self_device_time_total
    for name, us in groups.items():
        print(f"profile group {name}: {us / 1e3:.1f} ms "
              f"({100 * us / max(busy_us, 1):.1f}% of device time)")
    for e in rows[:12]:
        print(f"profile kernel {e.self_device_time_total / 1e3:9.2f} ms "
              f"x{e.count:6d}  {e.key[:100]}")


if __name__ == "__main__":
    main()
