"""Serving launcher: batched requests through the port's ServeEngine.

Two modes, as in the JAX package's launcher, on one card:

* kwargs mode (default) — an engine from a hand :class:`RunCfg`, the
  quick local smoke path;
* plan mode (``--from-plan``) — run the specialization flow for a
  decode shape on the ``h100-sxm`` target, build the engine with
  :meth:`ServeEngine.from_plan`, and serve through the KV residency the
  plan chose, its admission, its prefix reuse and its host spill tier as
  frozen (the plan's host pool is allocated, untouched, in host memory:
  at the full-width qwen3-8b decode 2048 x 8 plan, 512 blocks of 37.7
  MB).  Full-width deepseek-coder-33b's plan at the same shape picks
  grant admission over an 8-block pool (its 66.7 GB of bf16 weights
  leave room for one 2048-token sequence), so its run walks the grant →
  migrate → preempt ladder, parking victims with their KV in the 64
  host blocks.  Full-width hymba-1.5b's plan is paged too: its flash and
  decode kernels run at head_dim 64 and a GQA group of 5, its SSD scan in
  every layer, and each slot's SSM state rides beside its blocks.
  granite-moe-1b-a400m's plan picks its MoE path by the sequence length
  (``dense_einsum`` at 2048, ``gshard_einsum`` at 1024).  Full-width
  llama4-maverick-400b-a17b (~800 GB of weights) is refused before any
  weight is built: one card cannot hold it; ``--n-layers 2`` serves one
  [dense, MoE] super-block of it at full width (37.4 GB).  qwen2-vl-72b
  (~145 GB) likewise: ``--n-layers 16`` serves 16 of its 80 layers at
  full width (33.1 GB), from token ids (its M-RoPE streams each row's
  position), as the JAX package's engine takes them.  The encoder
  hubert-xlarge has no decode step and is refused before any plan or
  weight;
* mesh mode (``--mesh DxM``, implies ``--from-plan``) — one process a
  rank under ``torchrun --nproc-per-node D*M`` (NCCL on the cards, one
  card a rank; ``--device cpu`` runs the ranks on the CPU over gloo):
  the plan is specialized for the ``(D, M)`` ``(data, model)`` mesh,
  every rank builds the whole weights from ``--seed`` and keeps its
  pieces (:meth:`ServeEngine.from_plan` with the ``DeviceMesh``), and
  every rank serves the same requests; rank 0 reports.  ``check_fits``
  then measures one rank's share of the weights, and a model one card
  cannot hold is refused with the mesh it needs.  The plan is served as
  frozen there too: its host spill tier (a piece a rank: the rank's kv
  heads, or, where the pool splits by blocks, a whole copy), grant
  admission with migration between the data shards' sub-pools, and with
  ``--disagg N`` a prefill fleet of N workers owned by rank 0, which
  gathers the whole weights for them from the ranks' pieces (refused
  before any worker spawns where they do not fit its device beside its
  pieces) and broadcasts the fleet's events to every rank each tick;
* disaggregated prefill (``--disagg N``, implies ``--from-plan``) —
  the same plan with ``kv_prefill_mode=disagg`` forced: prefill runs on
  N spawned worker processes behind the engine
  (:mod:`repro_torch.serve.disagg`; the weights cross to them by CUDA
  IPC, no second copy), chunk by chunk into the pool, with the fleet's
  supervision counters in the telemetry printed at the end.  The
  full-width qwen3-8b plan at ``--max-len 4096 --max-batch 8`` records
  ``disagg`` on its own.

The model is the arch's reduced config, with its published head_dim and
GQA group (the attention kernels are instantiated for those), unless
``--full`` asks for its published widths and depth; weights are random,
from ``--seed``.  ``--arch`` takes the dense decoders (qwen3-8b,
deepseek-7b, deepseek-coder-33b, minitron-8b with its squared-ReLU FFN),
``mamba2-2.7b``, the hybrid ``hymba-1.5b`` and the MoE decoders
``granite-moe-1b-a400m`` and (reduced) ``llama4-maverick-400b-a17b``,
and ``qwen2-vl-72b``.
Entry points run on ``cuda``; ``--device cpu`` runs the kernels' plain
versions.  ``--profile`` traces the run with ``torch.profiler`` and
prints the device time by kernel and by group.

Run:  PYTHONPATH=src python -m repro_torch.launch.serve --from-plan
      PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
          --from-plan --full --max-len 2048 --max-batch 8
      PYTHONPATH=src python -m repro_torch.launch.serve \
          --arch deepseek-coder-33b --from-plan --full --max-len 2048 \
          --max-batch 8
      PYTHONPATH=src python -m repro_torch.launch.serve \
          --arch hymba-1.5b --from-plan --full --max-len 2048 --max-batch 8
      PYTHONPATH=src python -m repro_torch.launch.serve \
          --arch minitron-8b --from-plan --full --max-len 2048 --max-batch 8
      PYTHONPATH=src python -m repro_torch.launch.serve \
          --arch granite-moe-1b-a400m --from-plan --full --max-len 2048 \
          --max-batch 8
      PYTHONPATH=src python -m repro_torch.launch.serve \
          --arch llama4-maverick-400b-a17b --from-plan --full --n-layers 2 \
          --max-len 2048 --max-batch 8
      PYTHONPATH=src python -m repro_torch.launch.serve \
          --arch qwen2-vl-72b --from-plan --full --n-layers 16 \
          --max-len 2048 --max-batch 8
      PYTHONPATH=src python -m repro_torch.launch.serve --full \
          --max-len 4096 --max-batch 8 --disagg 1
      PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
          -m repro_torch.launch.serve --mesh 1x2 --device cpu
      PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
          -m repro_torch.launch.serve --mesh 2x1 --disagg 1 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time
from typing import Optional

import numpy as np
import torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--full", action="store_true",
                    help="the arch's published widths and depth (default: "
                         "its reduced config)")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="cut the depth to the first N layers (a whole "
                         "number of super-blocks), widths as chosen")
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
    ap.add_argument("--disagg", type=int, default=0, metavar="N",
                    help="run prefill on N supervised worker processes "
                         "(disaggregated prefill; implies --from-plan and "
                         "forces kv_prefill_mode=disagg)")
    ap.add_argument("--mesh", default="",
                    help='"DxM": serve on a (data, model) mesh of D*M ranks '
                         "(run under torchrun --nproc-per-node D*M); "
                         "implies --from-plan")
    args = ap.parse_args(argv)
    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import init_mesh
        mesh, args.device = init_mesh(args.mesh, args.device)
        if torch.distributed.get_rank():
            sys.stdout = open(os.devnull, "w")     # rank 0 reports

    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.core.pipeline import specialize
    from repro_torch.models import lm
    from repro_torch.models.lm import RunCfg, check_on_device
    from repro_torch.serve.engine import ServeEngine

    arch = get_arch(args.arch)
    lm.check_serves(arch)              # before any plan or weight
    if not args.full:
        small = arch.reduced()
        group = arch.n_heads // arch.n_kv_heads if arch.n_kv_heads else 1
        # M-RoPE's sections cover the published head_dim / 2, and the
        # encoder's flash path is held at its published 80
        keep = arch.mrope_sections is not None or arch.is_encoder
        arch = dataclasses.replace(
            small, head_dim=arch.hd if keep else arch.head_dim,
            n_heads=small.n_kv_heads * group,
            mrope_sections=arch.mrope_sections)
    if args.n_layers:
        print(f"cut: {arch.name} n_layers {arch.n_layers} -> {args.n_layers}")
        arch = dataclasses.replace(arch, n_layers=args.n_layers)
    if args.from_plan or args.disagg or mesh is not None:
        shape = ShapeConfig("serve", "decode", args.max_len, args.max_batch)
        mesh_shape = tuple(mesh.shape) if mesh is not None else (1, 1)
        plan = specialize(arch, shape, mesh_axes=("data", "model"),
                          mesh_shape=mesh_shape, target="h100-sxm")
        # refuse, before any weight, a kernel instance a rank would
        # launch that the card's kernels do not take
        from repro_torch.serve.sharded import cache_split
        check_on_device(arch, args.device, lm.kernel_instances(
            arch, "decode", plan, cache_split=cache_split(plan, arch)))
        check_fits(arch, plan.padded_sizes(), args.device, plan=plan)
        gen = torch.Generator(args.device).manual_seed(args.seed)
        pieces = None
        if mesh is not None:
            # each rank builds only its pieces of the weights
            from repro_torch.serve.sharded import param_pieces
            pieces = param_pieces(mesh, plan, arch)
        params = lm.init_params(arch, gen, *plan.padded_sizes(),
                                pieces=pieces)
        engine = ServeEngine.from_plan(
            plan, params, arch=arch, seed=args.seed, mesh=mesh,
            kv_prefill_mode="disagg" if args.disagg else None,
            disagg_workers=args.disagg)
        del params
        print(f"plan {plan.content_hash()[:12]} target={plan.target} "
              f"mesh={mesh_shape} "
              f"kv_residency={engine.kv_residency} "
              f"kv_admission={engine.kv_admission} "
              f"block_len={engine.block_len} n_blocks={engine.n_blocks} "
              f"kv_prefix_reuse={engine.kv_prefix_reuse} "
              f"kv_host_blocks={engine.host_blocks} "
              f"kv_prefetch={engine.kv_prefetch} "
              f"prefill_mode={engine.prefill_mode} "
              + (f"fleet_weight_bytes={engine.fleet_weight_bytes} "
                 if mesh is not None and args.disagg else "")
              + f"-> decode_path={engine.decode_path}")
    else:
        check_on_device(arch, args.device)
        check_fits(arch, (), args.device)
        gen = torch.Generator(args.device).manual_seed(args.seed)
        params = lm.init_params(arch, gen)
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
    try:
        for _ in range(args.requests):
            plen = int(rng.integers(8, args.max_len - args.new_tokens - 1))
            engine.submit(rng.integers(0, arch.vocab_size, (plen,)),
                          max_new_tokens=args.new_tokens)
        # disagg ticks mostly wait while the workers prefill out of
        # process: a far larger budget than inline's deadlock watchdog
        done = engine.run_until_idle(60000 if args.disagg else 1000)
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)
    finally:
        engine.shutdown()
    dt = time.time() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
        _report(prof, dt)
    toks = sum(len(r.out_tokens) for r in done)
    ttft = np.array([(r.t_first - r.t_submit) * 1e3 for r in done])
    print(f"served {len(done)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s, ttft p50 {np.percentile(ttft, 50):.0f} "
          f"ms p95 {np.percentile(ttft, 95):.0f} ms, {engine.tick} ticks, "
          f"{engine.prefill_calls} prefill calls) on {engine.device}")
    for r in done[:3]:
        print(f"  rid={r.rid} ttft={(r.t_first - r.t_submit) * 1e3:.0f}ms "
              f"total={(r.t_done - r.t_submit) * 1e3:.0f}ms "
              f"tokens={r.out_tokens[:8]}...")
    print(f"telemetry {engine.telemetry()}")
    print(f"pressure {engine.pressure_stats()}")
    if mesh is not None:
        torch.distributed.destroy_process_group()


def check_fits(arch, padded_sizes, device, plan=None,
               free: Optional[int] = None) -> None:
    """Raise, before any weight is built, for a model whose weights
    (``lm.leaf_specs`` at the plan's padded sizes) exceed the free
    memory of ``device``: the card's (``torch.cuda.mem_get_info``) or
    the host's available RAM, or ``free`` bytes where given (the dry
    run's target HBM).  With a ``plan`` for a mesh, one rank's
    share: each leaf's bytes over the ranks its spec splits it across
    (``lowering.param_pspecs``), what the rank builds
    (``serve.sharded.param_pieces``) and the engine keeps.  The refusal
    names the smallest model axis whose share would fit."""
    from repro_torch.models import lm
    leaves = list(_spec_leaves(lm.leaf_specs(arch, *padded_sizes)))
    split = [1] * len(leaves)
    if plan is not None and any(int(n) > 1 for n in plan.mesh_shape):
        from repro_torch.core.passes.lowering import param_pspecs
        sizes = dict(zip(plan.mesh_axes, (int(n) for n in plan.mesh_shape)))
        specs = list(_spec_leaves(param_pspecs(plan, arch, sizes),
                                  leaf=lambda x: isinstance(x, tuple)))
        split = [math.prod(sizes[a] for e in sp if e is not None
                           for a in ((e,) if isinstance(e, str) else e))
                 for sp in specs]
    whole = sum(math.prod(s.shape) * s.dtype.itemsize for s in leaves)
    need = sum(math.prod(s.shape) * s.dtype.itemsize // n
               for s, n in zip(leaves, split))
    device = torch.device(device)
    if free is not None:
        where = "the target"
    elif device.type == "cuda":
        free, where = torch.cuda.mem_get_info(device)[0], "the card"
    else:
        free = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
        where = "the host"
    if need > free:
        m = 2
        while whole / m > 0.9 * free and m < 4096:
            m *= 2
        raise NotImplementedError(
            f"{arch.name}: {need} weight bytes a rank (bf16 matrices, fp32 "
            f"norms and routers) at {arch.n_layers} layers, {free} bytes "
            f"free on {where}: one device cannot hold it; split over about "
            f"{m} cards on the model axis (ROADMAP item 10: torchrun "
            f"--nproc-per-node {m} -m repro_torch.launch.serve --mesh "
            f"1x{m}), or --n-layers cuts the depth")


def _spec_leaves(specs, leaf=lambda x: not isinstance(x, dict)):
    if leaf(specs):
        yield specs
    else:
        for v in specs.values():
            yield from _spec_leaves(v, leaf)


def _profiler(device):
    """Device events only on the card: the report reads nothing else, and
    the host-op events of a 64-layer eager run (mamba2-2.7b) kept the
    profiler's teardown busy for more than four minutes."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA if device.type == "cuda"
                               else ProfilerActivity.CPU])


#: kernel-name fragments of each group in the device-time breakdown
_GROUPS = (("port kernels (attention, SSD scan)",
            ("flash_fwd_kernel", "flash_bwd_", "decode_kernel",
             "ssd_chunk_state", "ssd_state_pass", "ssd_chunk_scan",
             "ssd_bwd_")),
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
    for e in rows:                  # every port kernel, in the top 12 or not
        if any(k in e.key for k in _GROUPS[0][1]):
            print(f"profile port kernel {e.self_device_time_total / 1e3:9.2f}"
                  f" ms x{e.count:6d}  {e.key[:100]}")


if __name__ == "__main__":
    main()
