"""Lowering: the paper's "HLS" phase.

The port of ``repro/core/passes/lowering.py``: :func:`build_run_cfg`
(plan -> :class:`RunCfg`, the knobs the model and serving code read,
with the serving mesh where there is one), :func:`param_pspecs` (the
plan's axis rules over the parameter tree),
:func:`wire_compression` (the gradient-compression predicate the
communication pass records its verdict through) and
:func:`lower_train_step`, the train step the plan asks for — forward,
backward, microbatch accumulation, the gradients' reduction (the int8
+ error-feedback wire where the plan lowers it), AdamW — on one card
or on each rank of a ``(data, model)`` mesh, eagerly (no jit:
:class:`LoweredStep` carries the step function as it is).
Torch is imported where a step is built, not at import.
"""

from __future__ import annotations

import dataclasses
import math
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
    ``combine_topology``), and the padded head, SSM head and vocab
    counts the ranks' pieces are measured against (the layout pass pads
    SSM heads to a multiple of the model axis where it splits them,
    ``src/repro/core/passes/layout.py:104-111``)."""
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
        ssm_heads_padded=int(est.get("ssm_heads_padded", 0)),
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
    (the JAX package's predicate): on ``mesh``'s sizes (a
    ``DeviceMesh`` or a mapping), else the plan's own mesh dims.

    Gates: the plan asked for full-DP compression; not an FSDP
    strategy; a data degree in ``(1, 256]`` that divides the global
    batch with ``dp * microbatches`` granularity; not shard_map MoE.
    """
    comm = plan.comm
    if not comm.compress_grads:
        return 0
    if str(plan.estimates.get("strategy", "")).startswith("fsdp"):
        return 0
    if mesh is not None:
        from repro_torch.dist.sharding import mesh_sizes
        sizes = mesh_sizes(mesh)
    else:
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
    as it is (the port has no jit), and the plan it came from.  On a
    mesh, ``layout`` is the rank's :class:`repro_torch.dist.fsdp
    .MeshLayout` and ``wire_dp`` the data degree of the compressed wire
    (0: none); ``ef`` whether the optimizer state carries error-feedback
    residuals (one bf16 leaf a parameter piece: under the wire the
    rank's row of the reference's stacked ``(dp, ...)`` leaf); ``cfg``
    the :class:`repro_torch.models.lm.RunCfg` its loss runs under."""

    fn: Callable
    plan: Any
    layout: Any = None
    wire_dp: int = 0
    ef: bool = False
    cfg: Any = None


def mesh_refusals(plan, arch: ArchConfig, mesh, layout=None,
                  wire_dp: int = 0) -> None:
    """Raise :class:`NotImplementedError`, with the reference's reason,
    for the compressed wire over leaves FSDP splits over the data axes
    (its stacked EF spec ``P(dp, *pspec)`` would name a data axis twice,
    ``src/repro/core/passes/lowering.py:246-252``): the reference cannot
    lower such a plan either.  Returns the mesh's
    :class:`repro_torch.dist.fsdp.MeshLayout`."""
    from repro_torch.dist.fsdp import MeshLayout
    layout = layout or MeshLayout(plan, arch, mesh)
    if wire_dp:
        dp = set(layout.batch_axes)
        for pl in layout.leaf_places():
            if pl.gather is not None and dp & set(pl.split_axes):
                raise NotImplementedError(
                    f"the compressed gradient wire over a leaf FSDP splits "
                    f"over {sorted(dp)} ({pl.spec}): the reference's stacked "
                    f"error-feedback spec P(dp, *pspec) names that axis "
                    "twice, so it cannot lower this plan either")
    return layout


def lower_train_step(plan, arch: ArchConfig, shape: ShapeConfig,
                     mesh=None, opt_cfg=None) -> LoweredStep:
    """The plan's train step (``src/repro/core/passes/lowering.py
    :213-425``): the loss and its gradients, accumulated over
    ``comm.microbatches`` microbatches (each taking every
    ``microbatches``-th row of the batch, the reference's interleaved
    split, each input sliced on its batch dim from
    :func:`repro_torch.models.frontends.batch_dims`: M-RoPE's ``(3, B,
    S)`` positions on dim 1; the gradients summed in fp32 and averaged:
    the bf16 gradients of one microbatch beside the fp32 sum, which the
    planner's step-peak estimate counts), then
    :func:`repro_torch.optim.adamw.apply_updates` in place.  The state is
    ``{"params": ..., "opt": ...}``; float parameters must require grad.
    A plan that compresses gradients without lowering the wire runs
    ``ef_compress`` on each reduced gradient with one bf16 residual a
    leaf (``opt["ef"]``), on one card too.

    On a ``mesh`` every rank runs this step on the global batch it is
    handed: it takes its contiguous rows (:class:`repro_torch.dist.fsdp
    .MeshLayout`), its pieces of the parameters run the model's mesh
    code, and:

    * without the wire, the loss is the whole batch's token mean (each
      rank's share), FSDP leaves' gradients are reduce-scattered in the
      backward, the others summed over the batch axes in fp32;
    * with the wire (``wire_compression > 0``), each data rank's slice
      is differentiated alone (its own mean, as the reference's vmapped
      slices are); each leaf's ``g + e`` is averaged by
      :func:`repro_torch.dist.collectives.compressed_psum` over the data
      group (one MAX of the block amax, one SUM of int32 codes) and the
      rank's residual is its new EF leaf; the loss is the slices' mean.

    Raises :class:`NotImplementedError` for what :func:`mesh_refusals`
    names, before any weight exists."""
    import torch

    from repro_torch.dist.collectives import axes_groups, sum_over_
    from repro_torch.models import frontends, lm
    from repro_torch.optim import adamw

    lm.check_supported(arch)
    opt_cfg = opt_cfg or adamw.OptConfig.from_plan(plan)
    nmicro = max(plan.comm.microbatches, 1)
    bdims = frontends.batch_dims(arch, shape)
    compress = plan.comm.compresses_gradients
    layout, wire_dp, pieces, places = None, 0, None, None
    if mesh is None:
        cfg = build_run_cfg(plan, arch)
    else:
        wire_dp = wire_compression(plan, mesh, arch)
        layout = mesh_refusals(plan, arch, mesh, None, wire_dp)
        cfg = dataclasses.replace(
            build_run_cfg(plan, arch, mesh),
            kv_split=_train_kv_split(arch, layout),
            fsdp=layout.gathers if layout.fsdp else None,
            batch_axes=() if wire_dp else layout.batch_axes)
        places = layout.leaf_places()
        pieces = [adamw.Piece(tuple(axes_groups(mesh, pl.split_axes)),
                              pl.piece) for pl in places]
        reduce = [axes_groups(mesh, pl.reduce_axes) for pl in places]
        dgroups = axes_groups(mesh, layout.batch_axes)

    def grads_of(params, batch):
        leaves = list(adamw.leaves(params))
        loss, metrics = lm.train_loss(arch, params, batch, cfg)
        # a leaf the loss does not reach (the embedding table of a model
        # fed ``embeds``) gets zeros, as jax.grad gives it
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        # the whole batch's loss (``ce_loss`` is the whole batch's mean
        # where the loss is summed over ``cfg.batch_axes``)
        report = metrics["ce_loss"] + lm.AUX_LOSS_WEIGHT * metrics["aux_loss"]
        if wire_dp:
            # the slices' mean, each rank's share summed: a share is the
            # off step's (its sum over the whole count) bit for bit where
            # the slices count equal tokens and dp is a power of two
            report = sum_over_((report.float() / wire_dp).reshape(1),
                               dgroups)[0]
        return report, metrics, grads

    def local(batch):
        if layout is None:
            return batch
        return {k: layout.batch_rows(v, bdims.get(k, 0))
                for k, v in batch.items()}

    def train_step(state, batch):
        params = state["params"]
        batch = local(batch)
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
        opt = dict(state["opt"])
        ef = opt.pop("ef", None)
        if wire_dp:
            flat, new_ef = _wire(flat, adamw.leaves(ef), dgroups, layout,
                                 places)
            metrics = {"ce_loss": loss,
                       "aux_loss": torch.zeros((), device=loss.device),
                       "tokens": torch.tensor(float(shape.tokens),
                                              device=loss.device)}
        else:
            if layout is not None:
                flat = [sum_over_(g.contiguous(), grp)
                        for g, grp in zip(flat, reduce)]
            if compress:
                flat, new_ef = _ef_compress(flat, adamw.leaves(ef), layout,
                                            places)
        grads = _like(params, iter(flat))
        params, opt, opt_metrics = adamw.apply_updates(
            params, grads, opt, opt_cfg, pieces)
        if compress:
            opt["ef"] = _like(ef, iter(new_ef))
        metrics = {**metrics, **opt_metrics, "loss": loss}
        return {"params": params, "opt": opt}, metrics

    return LoweredStep(fn=train_step, plan=plan, layout=layout,
                       wire_dp=wire_dp, ef=compress, cfg=cfg)


def _train_kv_split(arch: ArchConfig, layout) -> str:
    """``"heads"`` where a rank's query heads and kv heads are both cut
    at whole heads over ``model`` (each rank attends with its own: the
    kv heads stay unjoined), else ``"none"``."""
    blocks = layout.places["blocks"]
    attn = (blocks.get("dense", blocks)).get("attn")
    if attn is None:
        return "none"
    sizes, hd = layout.sizes, arch.hd

    def heads_cut(pl):
        m = sizes.get("model", 1)
        return ("model" in pl.split_axes and pl.gather is None
                and (pl.whole[-1] // m) % hd == 0)
    return "heads" if heads_cut(attn["wq"]) and heads_cut(attn["wk"]) \
        else "none"


def _row_chunks(t, elems: int):
    """``t`` as ``(rows, last dim)`` (a scalar as one element), cut into
    runs of whole rows of at most ``elems`` elements (at least a row)."""
    flat = t.reshape(1) if t.dim() == 0 else t.reshape(-1, t.shape[-1])
    step = max(elems // flat.shape[-1], 1)
    return [flat[i:i + step] for i in range(0, flat.shape[0], step)]


def _codes_span_pieces(layout, place, rows: bool) -> bool:
    """Whether a piece's int8 blocks are not its whole leaf's.  The
    blocks are 128 consecutive elements of the flattened leaf
    (``ef_compress``), or of each row of its last dim (the wire,
    ``rows``).  A piece is a set of runs of consecutive whole-leaf
    elements, each from its innermost split dim to the end, starting at
    a multiple of the run: the blocks agree where the run (for rows, the
    piece's last dim where that dim is split) is a multiple of one."""
    from repro_torch.dist.collectives import BLOCK
    if layout is None or not place.split_axes:
        return False
    shape = layout.piece_shape(place)
    split = [d for d, n in enumerate(shape) if n != place.whole[d]]
    if rows:
        return split[-1] == len(shape) - 1 and shape[-1] % BLOCK != 0
    return math.prod(shape[split[-1]:]) % BLOCK != 0


def _on_whole_blocks(fn, g, e, layout, place, rows: bool):
    """``fn(g, e)`` (in place) with the whole leaf's int8 blocks: on the
    pieces where their blocks are the whole leaf's, else on the whole
    leaf gathered from the pieces, each rank then keeping its piece."""
    if not _codes_span_pieces(layout, place, rows):
        fn(g, e)
        return
    from repro_torch.dist.fsdp import whole
    from repro_torch.dist.sharding import local_shard
    gw, ew = (whole(t, place.spec, layout.mesh) for t in (g, e))
    fn(gw, ew)
    g.copy_(local_shard(gw, layout.mesh, place.spec))
    e.copy_(local_shard(ew, layout.mesh, place.spec))


def _wire(grads, efs, groups, layout=None, places=None):
    """The compressed reduction of a rank's per-slice gradients, in
    place: per leaf ``g + e`` in fp32 (a scalar leaf as one element,
    the reference's ``(dp,) -> (dp, 1)``), its mean over the data group
    (``groups``: every data axis of the wire, one linearised group) by
    shared-scale int8 codes written over ``g``, and the rank's residual over its bf16 EF leaf ``e``
    (``src/repro/core/passes/lowering.py:327-341``).  Whole rows at a
    time (the codes' blocks run along the last dim, so a run of rows
    gives the whole leaf's codes), at most ``adamw.CHUNK`` elements; a
    leaf whose model pieces cut those blocks is coded whole."""
    from repro_torch.dist import collectives
    from repro_torch.optim.adamw import CHUNK
    groups = list(groups)

    def code(g, e):
        for gc, ec in zip(_row_chunks(g, CHUNK), _row_chunks(e, CHUNK)):
            mean, err = collectives.compressed_psum(
                gc.float() + ec.float(), groups)
            gc.copy_(mean)
            ec.copy_(err)

    grads, efs = [g.contiguous() for g in grads], list(efs)
    for k, (g, e) in enumerate(zip(grads, efs)):
        _on_whole_blocks(code, g, e, layout,
                         places[k] if places else None, rows=True)
    return grads, efs


def _ef_compress(grads, efs, layout=None, places=None):
    """The post-reduce error feedback in place, ``adamw.CHUNK`` elements
    at a time (a multiple of the codes' 128-element blocks of the
    flattened leaf, so the chunks give the whole leaf's codes); on a
    mesh, a leaf whose pieces cut those blocks is coded whole."""
    from repro_torch.dist.collectives import ef_compress
    from repro_torch.optim.adamw import CHUNK

    def code(g, e):
        gf, ef = g.view(-1), e.view(-1)
        for i in range(0, gf.numel(), CHUNK):
            gh, eh = ef_compress(gf[i:i + CHUNK], ef[i:i + CHUNK])
            gf[i:i + CHUNK].copy_(gh)
            ef[i:i + CHUNK].copy_(eh)

    grads, efs = [g.contiguous() for g in grads], list(efs)
    for k, (g, e) in enumerate(zip(grads, efs)):
        _on_whole_blocks(code, g, e, layout,
                         places[k] if places else None, rows=False)
    return grads, efs


def _rows(t, dim: int, j: int, n: int):
    """Every ``n``-th row of ``t`` along its batch dim ``dim``, from
    ``j``."""
    return t[(slice(None),) * dim + (slice(j, None, n),)]


def _like(tree, it):
    """``tree``'s structure filled from ``it`` in sorted-key order."""
    if isinstance(tree, dict):
        return {k: _like(tree[k], it) for k in sorted(tree)}
    return next(it)
