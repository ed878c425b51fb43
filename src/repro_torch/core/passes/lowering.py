"""Lowering: the plan's knobs the model and serving code consume.

The JAX package's lowering pass (``repro/core/passes/lowering.py``)
also builds sharded train and decode steps; the port's single-card
serving slice needs only :func:`build_run_cfg` (plan -> :class:`RunCfg`)
and :func:`wire_compression`, the gradient-compression predicate the
communication pass records its verdict through.  Neither imports
torch: ``RunCfg`` is a plain dataclass, imported where it is built.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ArchConfig


def build_run_cfg(plan, arch: ArchConfig):
    """The model-side knobs of a plan: the padded kv-head count, the
    attention and SSD-scan tiles of its ``BlockPlan``s (``chunk`` and
    ``heads_block``, as ``src/repro/core/passes/lowering.py:74,91``
    reads the chunk), the MoE path (``moe_impl``, default
    ``gshard_einsum``, as ``src/repro/core/passes/lowering.py:75,93``)
    and the kernel mode (``plan.use_pallas``:
    ``auto``/``on`` run the port's kernels on the card; ``off`` makes the
    card path raise)."""
    from repro_torch.kernels.ssd_scan import DEFAULT_CHUNK
    from repro_torch.models.lm import RunCfg
    fa = plan.partitions.get("flash_attention")
    dec = plan.partitions.get("decode_attention")
    ssd = plan.partitions.get("ssd_scan")
    moe_impl = plan.estimates.get("moe_impl", "gshard_einsum")
    return RunCfg(
        kv_heads_padded=int(plan.estimates.get("kv_heads_padded", 0)),
        flash_tiles=((int(fa.blocks["block_q"]), int(fa.blocks["block_kv"]))
                     if fa else None),
        decode_block_kv=int(dec.blocks["block_kv"]) if dec else None,
        ssd_chunk=int(ssd.blocks["chunk"]) if ssd else DEFAULT_CHUNK,
        ssd_heads_block=int(ssd.blocks["heads_block"]) if ssd else 1,
        moe_impl=moe_impl if isinstance(moe_impl, str) else "gshard_einsum",
        kernels=str(plan.use_pallas),
    )


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
            "wire_compression on a live mesh: the port has no mesh yet")
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
