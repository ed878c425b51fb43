"""Training launcher: ``python -m repro_torch.launch.train --arch qwen3-8b``

The port of ``repro/launch/train.py``: specialize (the paper's
compilation passes, on the ``h100-sxm`` target) → lower → train with
checkpointing, on one card or, under ``torchrun``, on a ``(data,
model)`` mesh: ``--mesh DxM`` names it, ``--model-parallel M`` takes
the ``(world // M, M)`` mesh as the reference's launcher does (one
process a rank; NCCL with a card a rank, gloo with ``--device cpu``;
rank 0 reports).  Prints the plan's decisions, each step's
loss, grad norm, lr and time, the tokens a second, and the card's peak
allocated memory beside the plan's estimate of the step's peak (its
``step_peak_bytes``: state, gradients, saved activations, transients),
with their ratio.

``--arch`` takes every family: dense GQA decoders (qwen3-8b), MoE
(granite-moe-1b-a400m, its router's aux loss in the loss), SSM
(mamba2-2.7b) and hybrid (hymba-1.5b), the SSD scan through its forward
and backward kernels, the vlm qwen2-vl-72b (patch embeddings and M-RoPE
positions from the synthetic source; ``--n-layers`` cuts it to a depth
one card holds) and the encoder hubert-xlarge (frames, an audio mask in
the loss, non-causal attention at head_dim 80).  The model is the
arch's reduced config, with its published head_dim and GQA group (the
attention kernels are instantiated for those; qwen2-vl's M-RoPE
sections too), unless ``--full`` asks for its
published widths and depth; ``--n-layers`` cuts the depth.  Weights are
random, from ``--seed``.  Entry points run on ``cuda``; ``--device
cpu`` runs the kernels' plain versions.  ``--profile`` traces the
steps after the first with ``torch.profiler`` and prints the device
time by kernel and by group (the serve launcher's report).

Run:  PYTHONPATH=src python -m repro_torch.launch.train
      PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
          --full --seq-len 2048 --batch 1 --steps 6
      PYTHONPATH=src torchrun --nproc-per-node 2 -m \
          repro_torch.launch.train --mesh 2x1 --device cpu
      (--arch granite-moe-1b-a400m | mamba2-2.7b | hymba-1.5b |
       hubert-xlarge likewise; qwen2-vl-72b with --n-layers 6)
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import torch


#: the plan's train-step memory estimates (bytes) :func:`plan_memory`
#: reads, by the name it gives them
STEP_ESTIMATES = {"peak": "step_peak_bytes", "grads": "step_grad_bytes",
                  "saved": "step_saved_bytes",
                  "transient": "step_transient_bytes",
                  "budget": "step_budget_bytes"}


def plan_memory(plan) -> dict:
    """The plan's memory estimates for a train step, in bytes: its
    persistent state (parameters, moments, master copy:
    ``persistent_bytes_per_dev``) and, on a CUDA target, the eager
    step's peak and its parts (:data:`STEP_ESTIMATES`; ``None`` where the
    plan has none) and whether it fits."""
    est = plan.estimates
    out = {"state": float(est["persistent_bytes_per_dev"])}
    for name, key in STEP_ESTIMATES.items():
        out[name] = float(est[key]) if key in est else None
    out["fits"] = bool(est.get("step_fits", 1))
    return out


def memory_line(plan, peak: float) -> str:
    """The card's measured peak beside the plan's estimate of it."""
    est = plan_memory(plan)
    gib = 2 ** 30
    line = (f"memory: peak allocated {peak / gib:.2f} GiB; the plan's "
            f"state {est['state'] / gib:.2f} GiB")
    if est["peak"] is not None:
        line += (f", step peak estimate {est['peak'] / gib:.2f} GiB "
                 f"(gradients {est['grads'] / gib:.2f}, saved activations "
                 f"{est['saved'] / gib:.2f}, largest transient "
                 f"{est['transient'] / gib:.2f}; budget "
                 f"{est['budget'] / gib:.2f}) = {est['peak'] / peak:.4f} x "
                 "the measured peak")
    return line


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--shape", default="cli",
                    help="the shape config's name (recorded in the plan "
                         "and the checkpoints)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="the reduced config (the default, as the "
                         "reference's launcher has it; --full overrides)")
    ap.add_argument("--full", action="store_true",
                    help="the arch's published widths and depth")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="cut the depth to the first N layers")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="train on the (world // M, M) (data, model) mesh "
                         "of torchrun's ranks")
    ap.add_argument("--mesh", default="",
                    help='"DxM": train on a (data, model) mesh of D*M ranks '
                         "(run under torchrun --nproc-per-node D*M)")
    ap.add_argument("--ckpt-dir", default="build/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="trace the steps after the first with "
                         "torch.profiler and print device time by kernel")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.core.pipeline import specialize
    from repro_torch.models.lm import check_on_device, kernel_instances
    from repro_torch.train.trainer import Trainer, TrainerConfig

    mesh = None
    spec = args.mesh or (f"x{args.model_parallel}"
                         if args.model_parallel != 1 else "")
    if spec:
        from repro_torch.launch.mesh import init_mesh
        mesh, args.device = init_mesh(spec, args.device)
        if torch.distributed.get_rank():
            sys.stdout = open(os.devnull, "w")     # rank 0 reports
    arch = get_arch(args.arch)
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
    shape = ShapeConfig(args.shape, "train", args.seq_len, args.batch)
    plan = specialize(arch, shape, mesh_axes=("data", "model"),
                      mesh_shape=(tuple(mesh.shape) if mesh is not None
                                  else (1, 1)), target="h100-sxm")
    # the kernel instances a rank's step launches, before any weight
    check_on_device(arch, args.device, kernel_instances(arch, "train", plan))
    print(f"plan {plan.content_hash()[:12]} target={plan.target} "
          f"mesh={tuple(mesh.shape) if mesh is not None else (1, 1)} "
          f"strategy={plan.estimates.get('strategy')} "
          f"grad_compress={plan.comm.compresses_gradients} "
          f"moments={plan.opt['moment_dtype']} "
          f"master_weights={plan.opt['master_weights']} "
          f"remat={plan.comm.remat_policy} "
          f"microbatches={plan.comm.microbatches}")
    print("plan decisions:")
    for entry in plan.log:
        print("  ", " | ".join(entry))
    trainer = Trainer(plan, mesh, TrainerConfig(
        n_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, log_every=1, seed=args.seed),
        arch=arch, shape=shape, device=args.device)
    cuda = trainer.device.type == "cuda"
    if cuda:
        from repro_torch.kernels import build
        build.build_all()               # compile before the timed steps
        torch.cuda.reset_peak_memory_stats(trainer.device)
    t0 = time.perf_counter()
    state, metrics = trainer.fit(n_steps=1 if args.profile else None)
    if args.profile:                    # the first step warms up, untraced
        from repro_torch.launch.serve import _profiler, _report
        prof = _profiler(trainer.device)
        t1 = time.perf_counter()
        with prof:
            state, metrics = trainer.fit(state, start_step=1)
        _report(prof, time.perf_counter() - t1)
    wall = time.perf_counter() - t0
    steady = trainer.history[1:] or trainer.history
    step_s = sum(h["dt_s"] for h in steady) / len(steady)
    print(f"trained {len(trainer.history)} steps in {wall:.2f} s: "
          f"{shape.tokens / step_s:.1f} tokens/s over steps "
          f"{steady[0]['step']}..{steady[-1]['step']} "
          f"({step_s * 1e3:.1f} ms a step) on {trainer.device}")
    if cuda:
        print(memory_line(plan,
                          torch.cuda.max_memory_allocated(trainer.device)))
    print("final:", {k: float(v) for k, v in metrics.items()})
    if mesh is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
