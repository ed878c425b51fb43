"""Lowering: the paper's "HLS" phase.

The port of ``repro/core/passes/lowering.py``: :func:`build_run_cfg`
(plan -> :class:`RunCfg`, the knobs the model and serving code read,
with the serving mesh where there is one), :func:`param_pspecs` (the
plan's axis rules over the parameter tree),
:func:`wire_compression` (the gradient-compression predicate the
communication pass records its verdict through) and
:func:`lower_train_step`, the train step the plan asks for — forward,
backward, microbatch accumulation, AdamW — on one card, eagerly (no
jit: :class:`LoweredStep` carries the step function as it is).  The
JAX package's sharded train steps, donation and the int8 gradient wire
wait for ROADMAP item 10b; a plan that compresses gradients is
refused.
Torch is imported where a step is built, not at import.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.configs.base import ArchConfig, ShapeConfig


def build_run_cfg(plan, arch: ArchConfig, mesh=None):
    """The model-side knobs of a plan: the padded kv-head count, the
    attention and SSD-scan tiles of its ``BlockPlan``s (``chunk`` and
    ``heads_block``, as ``src/repro/core/passes/lowering.py:74,91``
    reads the chunk), the MoE path (``moe_impl``, default
    ``gshard_einsum``, as ``src/repro/core/passes/lowering.py:75,93``)
    the kernel mode (``plan.use_pallas``:
    ``auto``/``on`` run the port's kernels on the card; ``off`` makes the
    card path raise), the remat policy (``comm.remat_policy``) and the
    padded vocab (``src/repro/core/passes/lowering.py:71-101``).  With a
    ``mesh`` (a ``DeviceMesh``) the config carries it, the plan's data
    axes and its decode decisions (``decode_impl``,
    ``combine_topology``), and the padded head and vocab counts the
    ranks' pieces are measured against."""
    from repro_torch.kernels.ssd_scan import DEFAULT_CHUNK
    from repro_torch.models.lm import RunCfg
    fa = plan.partitions.get("flash_attention")
    dec = plan.partitions.get("decode_attention")
    ssd = plan.partitions.get("ssd_scan")
    moe_impl = plan.estimates.get("moe_impl", "gshard_einsum")
    est = plan.estimates
    return RunCfg(
        kv_heads_padded=int(plan.estimates.get("kv_heads_padded", 0)),
        flash_tiles=((int(fa.blocks["block_q"]), int(fa.blocks["block_kv"]))
                     if fa else None),
        decode_block_kv=int(dec.blocks["block_kv"]) if dec else None,
        ssd_chunk=int(ssd.blocks["chunk"]) if ssd else DEFAULT_CHUNK,
        ssd_heads_block=int(ssd.blocks["heads_block"]) if ssd else 1,
        moe_impl=moe_impl if isinstance(moe_impl, str) else "gshard_einsum",
        kernels=str(plan.use_pallas),
        remat=plan.comm.remat_policy,
        mesh=mesh,
        data_axes=tuple(a for a in plan.mesh_axes if a != "model"),
        model_axis="model",
        decode_impl=str(est.get("decode_impl") or "xla"),
        combine_topology=(str(est["combine_topology"])
                          if est.get("combine_topology") else None),
        heads_padded=int(est.get("heads_padded", 0)),
        vocab_padded=int(est.get("vocab_padded", 0)),
    )


def param_pspecs(plan, arch: ArchConfig, sizes, shapes: Any = None) -> Any:
    """The plan's axis rules resolved over the parameter tree
    (``src/repro/core/passes/lowering.py:180-196``): one
    :class:`repro_torch.dist.sharding.P` a leaf.  ``shapes`` defaults to
    the plan-padded shapes; pass the tree actually placed (tensors, or
    shapes) to resolve against what will be placed."""
    from repro_torch.dist.sharding import resolve_pspec
    from repro_torch.models import lm
    padded = plan.padded_sizes()
    axes = lm.param_axes(arch, *padded)
    if shapes is None:
        shapes = lm.param_shapes(arch, *padded)

    def walk(ax, sh):
        if isinstance(ax, dict):
            return {k: walk(ax[k], sh[k]) for k in ax}
        return resolve_pspec(plan.axis_rules, tuple(getattr(sh, "shape", sh)),
                             ax, sizes)

    return walk(axes, shapes)


def wire_compression(plan, mesh=None,
                     arch: Optional[ArchConfig] = None) -> int:
    """Data-parallel degree of the *lowered* compressed reduction, or 0
    (the JAX package's predicate, on the plan's own mesh dims).

    Gates: the plan asked for full-DP compression; not an FSDP
    strategy; a data degree in ``(1, 256]`` that divides the global
    batch with ``dp * microbatches`` granularity; not shard_map MoE.
    """
    if mesh is not None:
        raise NotImplementedError(
            "wire_compression on a live mesh: the port trains on one card; "
            "the compressed reduction on a mesh waits for ROADMAP item 10b")
    comm = plan.comm
    if not comm.compress_grads:
        return 0
    if str(plan.estimates.get("strategy", "")).startswith("fsdp"):
        return 0
    sizes = dict(zip(plan.mesh_axes, plan.mesh_shape))
    ba = plan.axis_rules.get("batch")
    axes = (ba,) if isinstance(ba, str) else tuple(ba or ())
    dp = 1
    for a in axes:
        dp *= sizes.get(a, 1)
    if dp <= 1 or dp > 256:
        return 0
    nmicro = max(comm.microbatches, 1)
    if int(plan.global_batch) % (dp * nmicro):
        return 0
    if arch is not None and arch.is_moe and \
            str(plan.estimates.get("moe_impl", "")) == "shard_map_alltoall":
        return 0
    return dp


@dataclasses.dataclass
class LoweredStep:
    """A lowered train step: ``fn(state, batch) -> (state, metrics)``, run
    as it is (the port has no jit), and the plan it came from."""

    fn: Callable
    plan: Any


def lower_train_step(plan, arch: ArchConfig, shape: ShapeConfig,
                     mesh=None, opt_cfg=None) -> LoweredStep:
    """The plan's train step on one card
    (``src/repro/core/passes/lowering.py:213-425``): the loss and its
    gradients, accumulated over ``comm.microbatches`` microbatches (each
    taking every ``microbatches``-th row of the batch, the reference's
    interleaved split, each input sliced on its batch dim from
    :func:`repro_torch.models.frontends.batch_dims`: M-RoPE's ``(3, B,
    S)`` positions on dim 1; the gradients summed in fp32 and averaged: the
    bf16 gradients of one microbatch beside the fp32 sum, which the
    planner's step-peak estimate counts), then
    :func:`repro_torch.optim.adamw.apply_updates` in place.  The state is
    ``{"params": ..., "opt": ...}``; float parameters must require grad.

    Raises :class:`NotImplementedError` for a mesh, and for a plan that
    compresses gradients (the int8 + error-feedback reduction, on the
    wire or modelled: ROADMAP item 10b), before any weight exists."""
    import torch

    from repro_torch.models import frontends, lm
    from repro_torch.optim import adamw

    if mesh is not None:
        raise NotImplementedError(
            "lower_train_step: the port trains on one card; a mesh "
            "(FSDP / data parallelism) waits for ROADMAP item 10b")
    if plan.comm.compresses_gradients or wire_compression(plan, None, arch):
        raise NotImplementedError(
            "lower_train_step: the plan compresses gradients (int8 + error "
            "feedback); the compressed reduction in the train step waits "
            "for ROADMAP item 10b")
    lm.check_supported(arch)
    cfg = build_run_cfg(plan, arch)
    opt_cfg = opt_cfg or adamw.OptConfig.from_plan(plan)
    nmicro = max(plan.comm.microbatches, 1)
    bdims = frontends.batch_dims(arch, shape)

    def grads_of(params, batch):
        leaves = list(adamw.leaves(params))
        loss, metrics = lm.train_loss(arch, params, batch, cfg)
        # a leaf the loss does not reach (the embedding table of a model
        # fed ``embeds``) gets zeros, as jax.grad gives it
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), metrics, grads

    def train_step(state, batch):
        params = state["params"]
        if nmicro > 1:
            gsum, lsum = None, 0.0
            for j in range(nmicro):
                mb = {k: _rows(v, bdims.get(k, 0), j, nmicro)
                      for k, v in batch.items()}
                loss, _, grads = grads_of(params, mb)
                # the fp32 sum takes each microbatch's gradients as they
                # are (no fp32 copy of a whole microbatch's set)
                gsum = [g.float() for g in grads] if gsum is None else [
                    a.add_(b) for a, b in zip(gsum, grads)]
                del grads
                lsum = lsum + loss
            flat = [g.div_(nmicro) for g in gsum]
            loss = lsum / nmicro
            metrics = {"ce_loss": loss,
                       "aux_loss": torch.zeros((), device=loss.device),
                       "tokens": torch.tensor(float(shape.tokens),
                                              device=loss.device)}
        else:
            loss, metrics, flat = grads_of(params, batch)
            metrics = {k: v.detach() for k, v in metrics.items()}
        it = iter(flat)
        grads = _like(params, it)
        params, opt, opt_metrics = adamw.apply_updates(
            params, grads, state["opt"], opt_cfg)
        metrics = {**metrics, **opt_metrics, "loss": loss}
        return {"params": params, "opt": opt}, metrics

    return LoweredStep(fn=train_step, plan=plan)


def _rows(t, dim: int, j: int, n: int):
    """Every ``n``-th row of ``t`` along its batch dim ``dim``, from
    ``j``."""
    return t[(slice(None),) * dim + (slice(j, None, n),)]


def _like(tree, it):
    """``tree``'s structure filled from ``it`` in sorted-key order."""
    if isinstance(tree, dict):
        return {k: _like(tree[k], it) for k in sorted(tree)}
    return next(it)
