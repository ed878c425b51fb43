"""Sharding resolution: logical axis rules -> PartitionSpecs -> placements.

The port of ``repro/dist/sharding.py``.  It applies the plan's axis rules
to runtime pytrees (params, caches) whose shapes may differ from the IR
(padded heads or vocab, reduced configs), with the data-organization
pass's two rules:

1. divisibility repair: an assignment that does not divide the dim is
   dropped (the tensor stays replicated on that dim);
2. uniqueness: a mesh axis shards at most one dim of a tensor (the first
   dim wins).

A spec is a :class:`P`, a tuple with one entry per tensor dim (``None``,
a mesh axis name, or a tuple of names), so it compares to the JAX
package's ``PartitionSpec`` entry for entry.  :func:`tree_shardings`
turns specs into DTensor placements on a
:class:`torch.distributed.device_mesh.DeviceMesh`, and :func:`local_shard`
cuts the rank's piece of a whole tensor with the same layout.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple


class P(tuple):
    """A PartitionSpec: one entry per tensor dim."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def mesh_sizes(mesh: Any) -> Dict[str, int]:
    """``{axis_name: size}`` for a Mapping, a ``DeviceMesh``
    (``mesh_dim_names`` and ``shape``), or a MeshModel-like object
    (``axes`` or ``axis_names`` and a ``shape`` tuple)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    shape = getattr(mesh, "shape", None)
    if isinstance(shape, Mapping):
        return dict(shape)
    axes = (getattr(mesh, "mesh_dim_names", None)
            or getattr(mesh, "axes", None)
            or getattr(mesh, "axis_names", None))
    if axes is None or shape is None:
        raise TypeError(
            f"mesh_sizes: unsupported mesh-like object "
            f"{type(mesh).__name__!r}: expected a Mapping {{axis: size}}, "
            "a DeviceMesh (`.mesh_dim_names` and `.shape`), or a "
            "MeshModel-like object with `.axes`/`.axis_names` and a "
            f"`.shape` tuple (got axes={axes!r}, shape={shape!r})")
    axes, shape = tuple(axes), tuple(shape)
    if len(axes) != len(shape):
        raise TypeError(
            f"mesh_sizes: {type(mesh).__name__!r} has {len(axes)} axis "
            f"names {axes} but a {len(shape)}-entry shape {shape}")
    return dict(zip(axes, shape))


def _names(assign: Any) -> Tuple[str, ...]:
    if assign is None:
        return ()
    if isinstance(assign, str):
        return (assign,)
    return tuple(assign)


def resolve_pspec(rules: Mapping[str, Any], shape: Sequence[int],
                  axes: Sequence[Optional[str]],
                  sizes: Mapping[str, int]) -> P:
    """One tensor's spec through the plan's axis rules.

    ``rules`` maps a logical axis to a mesh assignment (a name, a tuple
    of names, or None); ``axes`` names each dim of ``shape`` (None: never
    sharded); ``sizes`` is the mesh's ``{axis: size}``.  Divisibility
    repair and uniqueness as the data-organization pass applies them."""
    entries = []
    for dim, ax in zip(shape, axes):
        assign = rules.get(ax) if ax is not None else None
        names = tuple(n for n in _names(assign) if n in sizes)
        if not names:
            entries.append(None)
            continue
        factor = math.prod(sizes[n] for n in names)
        entries.append(names if factor and dim % factor == 0 else None)
    seen: set = set()
    out = []
    for e in entries:
        if e is None:
            out.append(None)
            continue
        keep = tuple(n for n in e if n not in seen)
        seen.update(keep)
        out.append(keep[0] if len(keep) == 1 else (keep or None))
    return P(*out)


def placements(mesh: Any, spec: Sequence[Any]) -> List[Any]:
    """One DTensor placement per mesh dim for ``spec``: ``Shard(d)`` on
    every mesh dim named in entry ``d``, ``Replicate()`` elsewhere.  A
    dim over several mesh dims shards data-major (mesh order), as the
    JAX package lays it out; an entry naming them in another order
    raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out: List[Any] = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = _names(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def tree_shardings(mesh: Any, pspecs: Any) -> Any:
    """Map a tree of specs to lists of DTensor placements on ``mesh``."""
    if isinstance(pspecs, P):
        return placements(mesh, pspecs)
    if isinstance(pspecs, Mapping):
        return {k: tree_shardings(mesh, v) for k, v in pspecs.items()}
    return type(pspecs)(tree_shardings(mesh, v) for v in pspecs)


def shard_index(mesh: Any, entry: Any) -> Tuple[int, int]:
    """``(index, count)`` of this rank's piece along a dim whose spec
    entry is ``entry``: the rank's coordinates over the entry's mesh
    axes, linearized data-major."""
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    idx, count = 0, 1
    for a in _names(entry):
        i = names.index(a)
        idx = idx * mesh.shape[i] + coord[i]
        count *= mesh.shape[i]
    return idx, count


def local_shard(t: Any, mesh: Any, spec: Sequence[Any]) -> Any:
    """This rank's piece of the whole tensor ``t`` under ``spec``, as a
    contiguous tensor of its own (no collective: every rank holds ``t``)."""
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        i, n = shard_index(mesh, entry)
        w = t.shape[d] // n
        t = t.narrow(d, i * w, w)
    return t.contiguous()


#: runtime cache tree -> logical axes (matches core.describe's decls)
CACHE_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    "pos": ("batch",),                  # per-slot (B,) decode offsets
    "k": ("layers", "batch", "seq_kv", "kv_heads", "head_dim"),
    "v": ("layers", "batch", "seq_kv", "kv_heads", "head_dim"),
    "ssm": ("layers", "batch", "ssm_heads", None, None),
    "conv": ("layers", "batch", None, "ssm_inner"),
}

#: paged residency: k/v are block pools (the pool dim is the unit of
#: placement) and the block table rides the batch dim
PAGED_CACHE_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    "pos": ("batch",),
    "k": ("layers", "kv_blocks", None, "kv_heads", "head_dim"),
    "v": ("layers", "kv_blocks", None, "kv_heads", "head_dim"),
    "block_tbl": ("batch", None),
    "ssm": ("layers", "batch", "ssm_heads", None, None),
    "conv": ("layers", "batch", None, "ssm_inner"),
}


def cache_pspecs(plan, arch, cache_shapes: Mapping[str, Any],
                 sizes: Mapping[str, int]) -> Dict[str, P]:
    """Specs of the session-cache tree (``cache_shapes``: anything with a
    ``.shape`` per key).

    Starts from the plan's axis rules, overlays the data-organization
    pass's placement of ``cache.*`` (the seq-vs-heads spill for the
    sharded flash decode), then repairs divisibility against the runtime
    shapes.  The SSM state's heads keep the rule where the placement
    dropped them: the placement was repaired against the arch's heads,
    the state holds the padded heads the mixer splits (hymba-1.5b's 50
    padded to 64 on a 16-wide model axis).  A paged cache (it has
    ``block_tbl``) resolves through
    :data:`PAGED_CACHE_AXES`, the IR's seq spill landing on the pool
    dim; where :func:`repro_torch.dist.flash_decode.pool_sharding_kind`
    says ``"2d"``, the pool shards data-major over ``(data..., model)``."""
    from repro_torch.dist.flash_decode import pool_sharding_kind
    paged = "block_tbl" in cache_shapes
    axes_map = PAGED_CACHE_AXES if paged else CACHE_AXES
    pool_2d = None
    if paged and "k" in cache_shapes:
        dnames = tuple(a for a in plan.mesh_axes
                       if a != "model" and a in sizes)
        n_blocks = cache_shapes["k"].shape[1]
        batch = cache_shapes["block_tbl"].shape[0]
        if pool_sharding_kind(dict(sizes), n_blocks, batch,
                              data_axes=dnames) == "2d":
            pool_2d = dnames + (("model",) if "model" in sizes else ())
    out: Dict[str, P] = {}
    for key, sds in cache_shapes.items():
        axes = axes_map.get(key, tuple(None for _ in sds.shape))
        rules = dict(plan.axis_rules)
        rules.setdefault("kv_blocks", None)
        placed = plan.placements.get(f"cache.{key}")
        if placed is not None and placed.spec:
            ir_axes = CACHE_AXES.get(key, axes)   # placements follow the IR
            for ax, assign in zip(ir_axes, placed.spec):
                if ax == "seq_kv" and paged:
                    ax = "kv_blocks"
                if ax == "ssm_heads" and assign is None:
                    # the IR declares the arch's SSM heads; the runtime
                    # state holds the layout pass's padded heads, split
                    # as the mixer's weights split: the rule decides,
                    # repaired against that shape below
                    continue
                if ax is not None:
                    rules[ax] = assign
        if pool_2d is not None and key in ("k", "v"):
            rules["kv_blocks"] = pool_2d
        out[key] = resolve_pspec(rules, tuple(sds.shape), axes, sizes)
    return out
