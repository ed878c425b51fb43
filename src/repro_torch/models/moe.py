"""Mixture-of-Experts layer: capacity-based (GShard-style) routing.

The port of ``repro/models/moe.py``'s single-device paths, chosen by the
communication pass and carried by ``RunCfg.moe_impl``:

* ``gshard_einsum`` — top-k routing into per-expert capacity slots
  (tokens past capacity are dropped), the experts run on their slots
  only, and a combine puts the gated outputs back;
* ``dense_einsum`` — every expert runs on every token and the top-k
  router weights combine them (no capacity, no drops).

* ``shard_map_alltoall`` — :func:`moe_shard_map`: tokens split over
  the mesh's ``(data, model)`` ranks, experts over ``model``, and two
  ``all_to_all_single`` calls on the model group move the capacity
  slots to the experts' ranks and back.

On a mesh whose placement splits the expert stacks over ``model``, the
two single-device paths run on the rank's own experts
(``local_experts``) and the caller sums their partial outputs over the
model group; ``copy_in`` (:func:`repro_torch.models.tp.copy_in`) marks
where the tokens and the routing weights, the same on every rank,
enter that split work, so their gradients are summed.  ``stats`` sums
the aux loss's statistics over the data ranks of a training step whose
loss is the whole batch's mean (:func:`_aux`).

The products are the JAX package's einsums, left to cuBLAS as it left
them to XLA: the bf16 ones (tokens into slots, the expert FFN) are
``torch.bmm`` over the expert dim, reading the ``(E, d, 2 ff)`` and
``(E, ff, d)`` stacks as stored.  The two fp32 products (router
logits, the gshard combine) run in fp64 and round once to fp32: fp32
operands would let cuBLAS take TF32 whenever the process allows it,
and routing decisions must not depend on that flag.  The dense path's
combine is an fp32 multiply and sum over experts (no product to
lower).  ``y`` is formed in fp32 and cast to bf16 once, as in the
reference.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

#: the single-device paths; ``shard_map_alltoall`` needs a mesh
IMPLS = ("gshard_einsum", "dense_einsum")


class MoEParams(NamedTuple):
    router: torch.Tensor            # (d, E) fp32
    wi: torch.Tensor                # (E, d, 2*ff)  gate||up
    wo: torch.Tensor                # (E, ff, d)
    shared_wi: Optional[torch.Tensor] = None   # (d, 2*ff*n_shared)
    shared_wo: Optional[torch.Tensor] = None   # (ff*n_shared, d)


def _capacity(tokens_per_group: int, n_experts: int, top_k: int,
              capacity_factor: float) -> int:
    c = int(tokens_per_group * top_k * capacity_factor / n_experts)
    return max(4, -(-c // 4) * 4)          # multiple of 4, at least 4


def _fp32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of fp32 values at fp32 precision or better: summed in
    fp64 and rounded once, so no TF32 setting lowers it."""
    return torch.matmul(a.double(), b.double()).float()


def _router_probs(x: torch.Tensor, router_w: torch.Tensor) -> torch.Tensor:
    return torch.softmax(_fp32_product(x.float(), router_w.float()), dim=-1)


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def _aux(probs: torch.Tensor, dims, stats=_identity,
         groups=1.0) -> torch.Tensor:
    """Switch load-balance loss terms: ``E * sum(f_e * p_e)`` with the
    top-1 token fractions and mean probabilities over ``dims``, over
    ``groups``.  ``stats`` sums a statistic over the ranks whose tokens
    count too (the gradient passed through; by default this rank's
    alone): the sums and counts are summed before the product.  The
    fractions carry no gradient, so they take every divisor: autograd
    keeps one ``(.., E)`` factor, as for ``f.mean() * p.mean()``."""
    E = probs.shape[-1]
    top1 = F.one_hot(probs.argmax(-1), E).float()
    dims = (dims,) if isinstance(dims, int) else tuple(dims)
    n = stats(torch.tensor(float(math.prod(probs.shape[d] for d in dims)),
                           device=probs.device))
    f = stats(top1.sum(dims)) / (n.square() * groups)
    return E * (f * stats(probs.sum(dims))).sum(-1)


def route(x: torch.Tensor, router_w: torch.Tensor, top_k: int,
          capacity: int, stats=_identity
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing of ``x`` ``(G, T, d)`` (G groups of T tokens) with
    per-group capacity (``src/repro/models/moe.py:44``).

    The k choices are taken one at a time by ``argmax`` over the
    remaining probabilities (the first maximum on a tie); a token's slot
    in its expert is the expert's fill plus the running count along T,
    so earlier tokens of a group win capacity, and a choice whose slot
    is past ``capacity`` is dropped.  Returns ``(dispatch (G, T, E, C)``
    in x's dtype, ``combine (G, T, E, C)`` fp32, ``aux)``, ``aux`` the
    groups' mean of each group's load-balance terms, over the groups of
    every rank ``stats`` sums over (:func:`_aux`)."""
    G, T, _ = x.shape
    E = router_w.shape[-1]
    probs = _router_probs(x, router_w)                      # (G,T,E)
    aux = stats(_aux(probs, 1, groups=stats(
        torch.tensor(float(G), device=x.device))).sum())
    remaining = probs
    dispatch = torch.zeros((G, T, E, capacity), dtype=x.dtype,
                           device=x.device)
    combine = torch.zeros((G, T, E, capacity), dtype=torch.float32,
                          device=x.device)
    fill = torch.zeros((G, E), dtype=torch.int64, device=x.device)
    for _ in range(top_k):
        idx = remaining.argmax(-1)                           # (G,T)
        gate = remaining.gather(-1, idx[..., None])[..., 0]
        oh = F.one_hot(idx, E)                               # (G,T,E) int64
        remaining = remaining * (1.0 - oh.float())
        pos = fill[:, None, :] + oh.cumsum(1) - oh           # slot per token
        fill = fill + oh.sum(1)
        within = (pos < capacity) & (oh > 0)
        slot = torch.where(within, pos, torch.zeros_like(pos))
        one_hot_slot = F.one_hot(slot, capacity).float() * within[..., None]
        dispatch = dispatch + one_hot_slot.to(x.dtype)
        combine = combine + one_hot_slot * gate[..., None, None]
    return dispatch, combine, aux


def _swiglu(h: torch.Tensor, dtype) -> torch.Tensor:
    gate, up = h.chunk(2, dim=-1)
    return F.silu(gate.float()).to(dtype) * up


def _shared(x: torch.Tensor, p: MoEParams, y: torch.Tensor) -> torch.Tensor:
    """Add the shared expert's FFN of ``x`` to ``y`` (none without one)."""
    if p.shared_wi is None:
        return y
    return y + _swiglu(x @ p.shared_wi, x.dtype) @ p.shared_wo


def moe_dense_einsum(x: torch.Tensor, p: MoEParams, *, top_k: int,
                     capacity_factor: float = 0.0, local_experts: int = 0,
                     partial: bool = False, copy_in=None,
                     stats=_identity
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every expert on every token of ``x`` ``(B, S, d)``, combined by
    the top-k router weights (``src/repro/models/moe.py:86``).  The
    gates follow the reference's threshold rule, ``probs >=
    top_k(probs)[..., -1:]``, which admits more than k experts on a
    tie.  ``capacity_factor`` is unused (signature parity).
    ``local_experts`` = e0: ``p.wi`` / ``p.wo`` hold the experts from e0
    on (a rank's piece), and ``partial`` returns their fp32 share of
    ``y`` unrounded, for the caller to sum over ranks.  Returns ``(y
    (B, S, d), aux)``."""
    B, S, d = x.shape
    probs = _router_probs(x, p.router)                      # (B,S,E)
    aux = _aux(probs, (0, 1), stats)
    thresh = probs.topk(top_k, dim=-1).values[..., -1:]
    gates = torch.where(probs >= thresh, probs, torch.zeros_like(probs))
    xe = x
    if copy_in is not None:
        gates, xe = copy_in(gates), copy_in(x)
    gates = gates[..., local_experts:local_experts + p.wi.shape[0]]
    xt = xe.reshape(1, B * S, d)
    h = _swiglu(torch.matmul(xt, p.wi), x.dtype)            # (E,T,ff)
    out = torch.bmm(h, p.wo)                                # (E,T,d)
    g = gates.reshape(B * S, -1).t()[..., None]             # (E,T,1)
    y = (out.float() * g).sum(0).reshape(B, S, d)
    if partial:
        return y, aux
    return _shared(x, p, y.to(x.dtype)), aux


def moe_gshard_einsum(x: torch.Tensor, p: MoEParams, *, top_k: int,
                      capacity_factor: float, local_experts: int = 0,
                      partial: bool = False, copy_in=None,
                      stats=_identity
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity dispatch with one batch row of ``x`` ``(B, S, d)`` as
    the routing group, ``C = _capacity(S, E, top_k, capacity_factor)``
    (``src/repro/models/moe.py:130``; at decode S = 1, so C = 4).
    ``local_experts`` and ``partial`` as in :func:`moe_dense_einsum`
    (routing is over all ``E`` experts either way).  Returns ``(y (B,
    S, d), aux)``."""
    B, S, d = x.shape
    C = _capacity(S, p.router.shape[-1], top_k, capacity_factor)
    dispatch, combine, aux = route(x, p.router, top_k, C,
                                   stats=stats)             # (B,S,E,C)
    E = p.wi.shape[0]
    if copy_in is not None:
        combine, x = copy_in(combine), copy_in(x)
    dispatch = dispatch[:, :, local_experts:local_experts + E].contiguous()
    combine = combine[:, :, local_experts:local_experts + E].contiguous()
    # tokens into their slots: (B, E*C, d), then the experts' view
    slots = torch.bmm(dispatch.reshape(B, S, E * C).transpose(1, 2), x)
    expert_in = slots.reshape(B, E, C, d).transpose(0, 1).reshape(
        E, B * C, d)
    h = _swiglu(torch.bmm(expert_in, p.wi), x.dtype)        # (E,B*C,ff)
    expert_out = torch.bmm(h, p.wo)                         # (E,B*C,d)
    back = expert_out.reshape(E, B, C, d).transpose(0, 1).reshape(
        B, E * C, d)
    y = _fp32_product(combine.reshape(B, S, E * C), back.float())
    if partial:
        return y, aux
    return _shared(x, p, y.to(x.dtype)), aux


def moe_shard_map(x: torch.Tensor, p: MoEParams, *, top_k: int,
                  capacity_factor: float, mesh,
                  data_axes: Tuple[str, ...] = ("data",),
                  model_axis: str = "model"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism with explicit all-to-alls
    (``src/repro/models/moe.py:157-228``), run on every rank with what
    the reference's ``shard_map`` hands it: ``x`` ``(B_l, S_l, d)`` the
    rank's tokens (the batch split over the data axes and, where it
    divides, the sequence over ``model_axis``), ``p.router`` whole,
    ``p.wi`` / ``p.wo`` the rank's ``E / tp`` experts, the shared
    expert's matrices (if any) whole.

    The rank routes its tokens over all ``E`` experts into capacity
    slots (``C`` from its own token count), one ``all_to_all_single``
    sends each peer the slots of its experts, the experts run, and a
    second sends the outputs home for the combine.  Returns ``(y (B_l,
    S_l, d), aux)``, ``aux`` averaged over every rank of the mesh.
    The exchanges and the aux loss's mean are differentiable (the
    all-to-alls are their own adjoints; the mean's gradient passes
    through, every rank using it alike)."""
    import torch.distributed as dist

    from repro_torch.models import tp as tp_mod
    E = p.router.shape[-1]
    group = mesh.get_group(model_axis)
    tp = dist.get_world_size(group)
    E_l = E // tp
    if p.wi.shape[0] != E_l:
        raise ValueError(f"moe_shard_map: wi holds {p.wi.shape[0]} experts; "
                         f"this rank's piece of {E} over {tp} is {E_l}")
    Bl, Sl, d = x.shape
    toks = x.reshape(1, Bl * Sl, d)
    C = _capacity(Bl * Sl, E, top_k, capacity_factor)
    dispatch, combine, aux = route(toks, p.router, top_k, C)
    send = torch.einsum("gtec,gtd->ecd", dispatch.float(),
                        toks.float()).to(x.dtype)            # (E, C, d)
    recv = tp_mod.all_to_all(send, group)    # (tp, E_l, C, d), by source
    expert_in = recv.reshape(tp, E_l, C, d).transpose(0, 1).reshape(
        E_l, tp * C, d)
    h = _swiglu(torch.bmm(expert_in, p.wi), x.dtype)
    out = torch.bmm(h, p.wo)                                 # (E_l,tp*C,d)
    out = out.reshape(E_l, tp, C, d).transpose(0, 1)
    back = tp_mod.all_to_all(out, group)   # (tp, E_l, C, d), by owner
    back = back.reshape(E * C, d)
    y = _fp32_product(combine.reshape(1, Bl * Sl, E * C),
                      back.float())[0].reshape(Bl, Sl, d).to(x.dtype)
    aux = tp_mod.sum_over(aux.reshape(1),
                          tp_mod.axes_groups(mesh, mesh.mesh_dim_names))
    return _shared(x, p, y), aux[0] / mesh.size()


def moe_forward(impl: str, x: torch.Tensor, p: MoEParams, *, top_k: int,
                capacity_factor: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plan's single-device MoE path by name.  ``shard_map_alltoall``
    raises: it runs on a mesh (:func:`moe_shard_map`, which the model
    code calls there)."""
    if impl == "dense_einsum":
        return moe_dense_einsum(x, p, top_k=top_k)
    if impl == "gshard_einsum":
        return moe_gshard_einsum(x, p, top_k=top_k,
                                 capacity_factor=capacity_factor)
    if impl == "shard_map_alltoall":
        raise NotImplementedError(
            "moe_impl='shard_map_alltoall' shards experts over a mesh "
            "(ROADMAP item 10): serve it on one with "
            "ServeEngine.from_plan(mesh=...), or specialize for one card, "
            "where the plan picks gshard_einsum or dense_einsum")
    raise ValueError(f"moe_impl={impl!r} is not one of {IMPLS}")
