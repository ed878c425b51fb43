"""AdamW with the plan's "technology" knobs (``repro/optim/adamw.py``).

The data-organization pass may decide, under memory pressure, to keep
Adam's moments in bf16 and to drop the fp32 master copy; without a
master copy the bf16 parameters are updated with *stochastic rounding*,
so the update's bias stays zero.  Both decisions arrive through
``plan.opt`` (:meth:`OptConfig.from_plan`).

The arithmetic is the JAX package's, op for op in fp32, with two
differences of form:

* the update is **in place**: parameters, moments and the master copy
  are overwritten, where the JAX function returned new arrays (a
  full-width model's state would not fit twice on one card);
* each leaf is updated in chunks of at most :data:`CHUNK` elements, so
  the fp32 temporaries stay bounded (qwen3-8b's ``embed`` and
  ``lm_head`` are 622 M elements each, a stacked FFN leaf at 24 layers
  2.4 G: four fp32 temporaries of a whole leaf would take 10-40 GB).
  The arithmetic is elementwise, so chunks give the same numbers.

Stochastic rounding draws its 16 random bits a element from an explicit
``torch.Generator`` on the parameter's device, seeded from (step, leaf
index) as the reference folds ``PRNGKey(0x5AD3)`` with the step and then
the leaf index; leaves go in the reference's flatten order (dict keys
sorted).  The bits differ from JAX's (another generator); the rounding
rule is the same: an fp32 value moves to one of its two bf16 neighbours,
up with probability equal to its truncated fraction.

On a mesh each rank updates its pieces (``pieces``: each leaf's
:class:`Piece`).  The gradient norm is the whole tree's: each leaf's
sum of squares is summed over the mesh axes that cut it, a replicated
leaf counted once.  A piece of a split leaf draws its rounding bits
from (step, leaf, piece index); a leaf replicated over the data ranks
draws the same bits on each of them, so replicas never drift apart.
"""

from __future__ import annotations

import dataclasses
import math
from typing import (Any, Dict, Iterator, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch.kernels.fake import is_fake

#: elements of a leaf updated at a time (64 MB a fp32 temporary)
CHUNK = 1 << 24
_SR_KEY = 0x5AD3


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moment_dtype: str = "float32"     # plan.opt["moment_dtype"]
    master_weights: bool = True       # plan.opt["master_weights"]

    @classmethod
    def from_plan(cls, plan, **kw) -> "OptConfig":
        return cls(moment_dtype=plan.opt["moment_dtype"],
                   master_weights=plan.opt["master_weights"], **kw)


def lr_schedule(cfg: OptConfig, step) -> np.float32:
    """Linear warmup then cosine decay to 10% of peak, in fp32 as the
    reference computes it."""
    f32 = np.float32
    step = f32(step)
    warm = step / f32(max(cfg.warmup_steps, 1))
    denom = f32(max(cfg.total_steps - cfg.warmup_steps, 1))
    frac = np.clip((step - f32(cfg.warmup_steps)) / denom, f32(0), f32(1))
    cos = f32(0.1) + f32(0.45) * (f32(1) + np.cos(f32(math.pi) * frac))
    return f32(cfg.peak_lr) * (warm if step < cfg.warmup_steps else cos)


def leaves(tree) -> Iterator[torch.Tensor]:
    """The leaves of a nested dict in the reference's flatten order (keys
    sorted at every level)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    else:
        yield tree


def tree_map(fn, *trees):
    """The first tree's structure, ``fn`` of the leaves the trees hold at
    each of its leaves."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def init_opt_state(params, cfg: OptConfig) -> Dict[str, Any]:
    """Zero moments in the plan's dtype, the step (an int32 scalar) and,
    with master weights, an fp32 copy of the parameters, each on its
    parameter's device."""
    mdt = getattr(torch, cfg.moment_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=mdt, device=p.device)

    state: Dict[str, Any] = {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32),
    }
    if cfg.master_weights:
        state["master"] = tree_map(lambda p: p.detach().float().clone(),
                                   params)
    return state


class Piece(NamedTuple):
    """One leaf on a rank of a mesh: ``groups``, the ``(group, size)``
    of each mesh axis that cuts it (empty: the rank holds it whole), and
    the rank's piece index among its pieces (``-1``: whole)."""

    groups: Tuple
    index: int


def _chunks(t: torch.Tensor) -> List[torch.Tensor]:
    flat = t.view(-1)
    return [flat[i:i + CHUNK] for i in range(0, flat.numel(), CHUNK)]


def global_norm(tree, pieces: Optional[Sequence[Piece]] = None
                ) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (a 0-d tensor on
    the leaves' device).  With ``pieces`` the leaves are pieces: the
    sums of the leaves cut over the same axes are summed over those
    axes (one all-reduce a set of axes), then all are added."""
    if pieces is None:
        total = None
        for leaf in leaves(tree):
            for c in _chunks(leaf.detach()):
                s = c.float().square().sum()
                total = s if total is None else total + s
        return total.sqrt()
    from repro_torch.dist.collectives import sum_over_
    sums: Dict[Tuple, torch.Tensor] = {}
    for leaf, pc in zip(leaves(tree), pieces):
        for c in _chunks(leaf.detach()):
            s = c.float().square().sum()
            key = tuple(pc.groups)
            sums[key] = s if key not in sums else sums[key] + s
    total = None
    for key, s in sums.items():
        s = sum_over_(s, key)
        total = s if total is None else total + s
    return total.sqrt()


def _stochastic_round_bf16(x: torch.Tensor,
                           generator: torch.Generator) -> torch.Tensor:
    """fp32 -> bf16, up with probability proportional to the truncated
    bits: 16 random bits added below the bf16 mantissa, then truncated
    (the reference's ``_stochastic_round_bf16``; int32 arithmetic wraps
    as its uint32 does)."""
    bits = x.float().contiguous().view(torch.int32)
    rnd = torch.randint(0, 1 << 16, bits.shape, generator=generator,
                        dtype=torch.int32, device=x.device)
    rounded = (bits + rnd) & -65536            # & 0xFFFF0000
    return rounded.view(torch.float32).to(torch.bfloat16)


def _sr_seed(step: int, index: int, piece: int = -1) -> int:
    """The generator seed of leaf ``index`` at ``step`` (of its piece
    ``piece`` where the leaf is cut)."""
    seed = (_SR_KEY * 1_000_003 + step) * 1_000_003 + index
    if piece >= 0:
        seed = seed * 1_000_003 + piece
    return seed % (1 << 63)


@torch.no_grad()
def apply_updates(params, grads, state: Dict[str, Any], cfg: OptConfig,
                  pieces: Optional[Sequence[Piece]] = None
                  ) -> Tuple[Any, Dict[str, Any], Dict[str, Any]]:
    """One AdamW step, **in place** on ``params`` and ``state``.  Returns
    ``(params, state, metrics)`` with metrics ``grad_norm`` (a 0-d
    tensor) and ``lr``.  ``pieces`` (one :class:`Piece` a leaf, in
    :func:`leaves` order) when the leaves are a rank's pieces on a
    mesh: the norm is the whole tree's and rounding draws by piece."""
    step = int(state["step"]) + 1
    lr = float(lr_schedule(cfg, step))
    b1, b2 = cfg.betas
    f32 = np.float32
    bc1 = float(f32(1) - f32(b1) ** f32(step))
    bc2 = float(f32(1) - f32(b2) ** f32(step))

    gnorm = global_norm(grads, pieces)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip > 0 else 1.0)
    mdt = getattr(torch, cfg.moment_dtype)
    master = state.get("master", params)
    for i, (p, g, m, v, w) in enumerate(zip(
            leaves(params), leaves(grads), leaves(state["m"]),
            leaves(state["v"]), leaves(master))):
        gen = None
        rounds = not cfg.master_weights and p.dtype == torch.bfloat16
        if rounds and not is_fake(p):   # a fake leaf (the dry run): no seed
            gen = torch.Generator(p.device).manual_seed(_sr_seed(
                step, i, pieces[i].index if pieces is not None else -1))
        for pc, gc, mc, vc, wc in zip(_chunks(p), _chunks(g), _chunks(m),
                                      _chunks(v), _chunks(w)):
            g32 = gc.float() * scale
            m32 = b1 * mc.float() + (1 - b1) * g32
            v32 = b2 * vc.float() + (1 - b2) * g32.square()
            upd = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
            w32 = wc.float()
            if p.dim() >= 2:    # decoupled decay on everything matrix-like
                upd = upd + cfg.weight_decay * w32
            w32 = w32 - lr * upd
            if cfg.master_weights:
                wc.copy_(w32)
                pc.copy_(w32)
            elif rounds:
                pc.copy_(_stochastic_round_bf16(w32, gen))
            else:
                pc.copy_(w32)
            mc.copy_(m32.to(mdt))
            vc.copy_(v32.to(mdt))
    state = dict(state, step=torch.tensor(step, dtype=torch.int32))
    return params, state, {"grad_norm": gnorm, "lr": lr}
