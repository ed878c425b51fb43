"""Training on a ``(data, model)`` DeviceMesh: where each leaf's pieces
lie, and the FSDP gather.

The JAX package lets GSPMD partition its train step from the plan's
placements (``src/repro/core/passes/lowering.py:213-421``); the port
runs explicit per-rank code.  :class:`MeshLayout` reads the placements
``lowering.param_pspecs`` resolves for a mesh and tells every part of
the step what the rank holds and what its gradients owe:

* a dim on the logical axis ``embed`` (or ``flat_params``) split over
  mesh axes is an FSDP (ZeRO-3) split: the plan's FSDP spill
  (``embed`` over ``data``, ``data_organization.py:459-491``) and the
  ``fsdp_dp`` strategies (``embed`` over ``data`` and ``model``).  The
  model gathers such a leaf where it uses it, one layer at a time
  (:func:`gather_layer`, inside the layer loop and so inside its remat
  region), and the gather's backward reduce-scatters the layer's
  gradient in fp32 and rounds it once to the leaf's dtype;
* any other split (heads, ``ff``, vocab, experts, the mamba2 mixer's
  ``ssm_inner`` / ``ssm_heads`` over ``model``) is tensor parallel: the
  model code runs on the piece (:mod:`repro_torch.models.tp`,
  :mod:`repro_torch.models.ssm`);
* a gradient is summed over the batch axes the leaf is not split on
  (:attr:`MeshLayout.reduce_groups`): replicated leaves over ``data``
  after the backward (:func:`repro_torch.core.passes.lowering
  .lower_train_step`), FSDP leaves inside the gather's backward.

Several mesh axes act together one axis at a time, data-major, so the
step needs only the mesh's own groups.  Gloo carries every collective
used here for CUDA tensors too (``reduce_scatter_tensor``, fp32 and
bf16 sums, fp32 and int32 MAX: ``scripts/gloo_cuda_probe.py`` on an
H100 with torch 2.11), so two ranks on one card run the same code.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.dist.collectives import all_gather, axes_groups, sum_over_
from repro_torch.optim.adamw import leaves, tree_map

#: logical axes whose split is an FSDP split (gathered at use)
FSDP_AXES = ("embed", "flat_params")

def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class LeafGather(NamedTuple):
    """The FSDP split of one leaf: the whole leaf's ``dim`` is cut over
    ``groups`` (``(group, size)`` a mesh axis, data-major); the
    gradient's reduce-scatter sums ``rep`` copies of each batch slice
    (mesh axes of the split the batch does not use), so it is divided by
    ``rep``, and is summed over ``extra`` (batch axes the split does not
    use) too."""

    dim: int
    groups: Tuple
    rep: int
    extra: Tuple


def _reduce_scatter0(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """The sum over ``group`` of ``t`` (contiguous), this rank's ``1 /
    n`` of dim 0."""
    w = t.shape[0] // n
    out = torch.empty((w, *t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, t, group=group)
    return out


def whole(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """A leaf's piece gathered whole over every mesh axis of its
    ``spec`` (no gradient)."""
    for d, e in enumerate(spec):
        if _names(e):
            t = all_gather(t, d, axes_groups(mesh, _names(e)))
    return t


def reduce_scatter(t: torch.Tensor, dim: int, groups) -> torch.Tensor:
    """The fp32 sum of ``t`` over ``groups`` (data-major), this rank's
    piece of ``dim``: the outermost axis first, so rank ``(d, m)`` ends
    with piece ``d * M + m``."""
    x = t.float().movedim(dim, 0).contiguous()
    for g, n in groups:
        x = _reduce_scatter0(x, g, n)
    return x.movedim(0, dim).contiguous()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, piece, dim, lg):
        ctx.dim, ctx.lg, ctx.dtype = dim, lg, piece.dtype
        return all_gather(piece, dim, lg.groups)

    @staticmethod
    def backward(ctx, g):
        lg = ctx.lg
        x = reduce_scatter(g, ctx.dim, lg.groups)
        if lg.rep > 1:
            x = x / lg.rep
        sum_over_(x, lg.extra)
        return x.to(ctx.dtype), None, None


def gather_leaf(t: torch.Tensor, lg: Optional[LeafGather],
                layer: bool = False) -> torch.Tensor:
    """The leaf ``t`` whole on its FSDP dim (``t`` itself where ``lg``
    is ``None``); ``layer``: ``t`` is one layer of a stacked leaf (its
    dims one fewer)."""
    if lg is None:
        return t
    return _Gather.apply(t, lg.dim - (1 if layer else 0), lg)


def gather_tree(tree, gathers, layer: bool = False):
    """``tree`` with every leaf that ``gathers`` names gathered."""
    if gathers is None:
        return tree
    if isinstance(tree, dict):
        return {k: gather_tree(v, gathers.get(k), layer)
                for k, v in tree.items()}
    return gather_leaf(tree, gathers, layer)


def gather_top(params: Dict[str, Any], gathers) -> Dict[str, Any]:
    """``params`` with its leaves outside ``blocks`` (the embedding, the
    final norm, the head) gathered; the stacks are left to
    :func:`gather_layer`."""
    if gathers is None:
        return params
    return {k: (v if k == "blocks" else gather_tree(v, gathers.get(k)))
            for k, v in params.items()}


def gather_layer(grp: Dict[str, Any], gathers) -> Dict[str, Any]:
    """One step of the layer loop's leaves (views of the stacks)
    gathered whole on their FSDP dims."""
    if gathers is None:
        return grp
    return gather_tree(grp, gathers.get("blocks"), layer=True)


class LeafPlace(NamedTuple):
    """One parameter leaf on this rank: its spec, its whole shape, the
    mesh axes its pieces are cut over (``split_axes``: a global norm
    sums its squares there), the axes its gradient is summed over after
    the backward (``reduce_axes``; empty for an FSDP leaf, whose gather
    does it), this rank's piece index among the pieces (``-1`` for a
    whole leaf) and its FSDP gather (or ``None``)."""

    spec: Tuple
    whole: Tuple[int, ...]
    split_axes: Tuple[str, ...]
    reduce_axes: Tuple[str, ...]
    piece: int
    gather: Optional[LeafGather]


def batch_axes(plan, sizes) -> Tuple[str, ...]:
    """The mesh axes the plan's ``batch`` rule splits the batch over
    (size > 1), in the mesh's order."""
    ba = plan.axis_rules.get("batch")
    names = _names(ba)
    return tuple(a for a in sizes if a in names and sizes[a] > 1)


class MeshLayout:
    """Where a plan puts each parameter leaf on ``mesh``, from this
    rank's side (see the module's text).  ``specs`` / ``whole`` /
    ``places`` are trees of the parameter tree's shape; ``gathers`` the
    tree :class:`repro_torch.models.lm.RunCfg` carries (``fsdp``);
    ``batch_axes`` the axes the global batch is split over, this rank
    holding slice ``batch_index`` of ``batch_count``."""

    def __init__(self, plan, arch, mesh):
        from repro_torch.core.passes.lowering import param_pspecs
        from repro_torch.dist.sharding import mesh_sizes, shard_index
        from repro_torch.models import lm
        self.mesh = mesh
        sizes = mesh_sizes(mesh)
        self.sizes = sizes
        padded = plan.padded_sizes()
        self.whole = lm.param_shapes(arch, *padded)
        axes = lm.param_axes(arch, *padded)
        self.specs = param_pspecs(plan, arch, sizes, shapes=self.whole)
        self.batch_axes = batch_axes(plan, sizes)
        self.batch_index, self.batch_count = shard_index(
            mesh, self.batch_axes) if self.batch_axes else (0, 1)

        def place(spec, whole, ax):
            split = tuple(a for e in spec for a in _names(e)
                          if sizes.get(a, 1) > 1)
            piece = shard_index(mesh, split)[0] if split else -1
            lg = None
            for d, (e, name) in enumerate(zip(spec, ax)):
                live = tuple(a for a in _names(e) if sizes.get(a, 1) > 1)
                if name in FSDP_AXES and live:
                    rep = math.prod(sizes[a] for a in live
                                    if a not in self.batch_axes)
                    extra = tuple(a for a in self.batch_axes
                                  if a not in live)
                    lg = LeafGather(d, tuple(axes_groups(mesh, live)), rep,
                                    tuple(axes_groups(mesh, extra)))
                    break
            reduce = () if lg is not None else tuple(
                a for a in self.batch_axes if a not in split)
            return LeafPlace(tuple(spec), tuple(whole), split, reduce, piece,
                             lg)

        self.places = tree_map(place, self.specs, self.whole, axes)
        self.gathers = tree_map(lambda p: p.gather, self.places)
        self.fsdp = any(p.gather is not None for p in leaves(self.places))

    def leaf_places(self) -> List[LeafPlace]:
        """Every leaf's place in the reference's flatten order."""
        return list(leaves(self.places))

    def piece_shape(self, place: LeafPlace) -> Tuple[int, ...]:
        out = []
        for n, e in zip(place.whole, place.spec):
            k = math.prod(self.sizes.get(a, 1) for a in _names(e))
            out.append(n // k)
        return tuple(out)

    def batch_rows(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's contiguous rows of the global batch ``t`` along
        its batch dim ``dim``."""
        if self.batch_count == 1:
            return t
        n = t.shape[dim] // self.batch_count
        return t.narrow(dim, self.batch_index * n, n)
