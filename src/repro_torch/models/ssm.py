"""Mamba2 (SSD — state-space duality) layer, the port of
``src/repro/models/ssm.py``.

The sequence is processed in chunks (arXiv:2405.21060 §6): intra-chunk
terms are batched products, inter-chunk terms a short recurrence over
chunk states.  Here the whole scan is one call of
:func:`repro_torch.kernels.ops.ssd_scan`: the hand-written SSD kernel on
the card, its plain chunked version on the CPU.  The chunk length (and
the heads one CTA walks) come from the plan's ``ssd_scan`` BlockPlan.

Decode is the O(1) recurrent update ``S <- exp(dt A) S + dt B (x) x``
in plain PyTorch (the JAX package has no kernel for it either).

Numerics follow the JAX functions: projections in bf16, the conv in
bf16 (prefill tap by tap, decode as one reduction over the window), the
scan and the gated norm in fp32.  The fp32 ``y`` meets the bf16
``out_proj`` as JAX's promotion does: both in fp32, then cast to the
residual's dtype (torch refuses mixed-dtype products).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import tp
from repro_torch.models.common import rms_norm


class SSMParams(NamedTuple):
    in_proj: torch.Tensor    # (d, 2*di + 2*g*n + h)  -> z, xBC, dt
    conv_w: torch.Tensor     # (k, di + 2*g*n) depthwise causal conv
    conv_b: torch.Tensor     # (di + 2*g*n,)
    A_log: torch.Tensor      # (h,) fp32: A = -exp(A_log)
    D: torch.Tensor          # (h,) fp32 skip
    dt_bias: torch.Tensor    # (h,) fp32
    norm: torch.Tensor       # (di,) gated RMSNorm scale
    out_proj: torch.Tensor   # (di, d)


class SSMDims(NamedTuple):
    d_model: int
    d_inner: int
    n_heads: int
    head_dim: int
    state: int
    n_groups: int
    conv_k: int


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None, *,
                heads_block: Optional[int] = None, mode: str = "auto"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x ``(B, S, H, P)``, dt ``(B, S, H)`` post-softplus, A ``(H,)``,
    Bm/Cm ``(B, S, G, N)``, fp32.  Returns ``(y (B, S, H, P),
    final_state (B, H, P, N))``."""
    c = torch.Tensor.contiguous
    return ops.ssd_scan(c(x), c(dt), c(A), c(Bm), c(Cm), chunk=chunk,
                        heads_block=heads_block, initial_state=initial_state,
                        mode=mode)


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over ``(B, S, C)`` with kernel ``(k, C)``,
    summed tap by tap in ``x``'s dtype."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    return y + b


class _Cut(NamedTuple):
    """Where this rank's share of the mixer lies (one card: all of it).
    ``h0``/``hl``: the first of its heads and their count;
    ``c0``/``cl``: the conv channels its ``conv_w`` piece holds; the
    ``*_split`` flags say which leaves are cut over the model ranks."""

    h0: int
    hl: int
    c0: int
    cl: int
    in_split: bool
    conv_split: bool
    heads_split: bool


def _cut(p: SSMParams, dims: SSMDims, c) -> _Cut:
    """The rank's share of a mixer whose whole sizes are ``dims``, read
    off the pieces ``p`` holds (``in_proj``'s columns, ``conv_w``'s
    channels and ``A_log``'s heads are each split or whole, by the
    plan's divisibility rule; ``norm`` and ``out_proj`` follow the
    heads)."""
    di, G, N, H = dims.d_inner, dims.n_groups, dims.state, dims.n_heads
    C = di + 2 * G * N
    in_split = tp.split(2 * di + 2 * G * N + H, p.in_proj.shape[-1], c)
    conv_split = tp.split(C, p.conv_w.shape[-1], c)
    h0, hl = tp.head_range(H, p.A_log.shape[-1], c)
    if p.norm.shape[-1] != hl * dims.head_dim \
            or p.out_proj.shape[-2] != hl * dims.head_dim:
        raise ValueError(
            f"SSM pieces: {hl} heads of {H} but norm {tuple(p.norm.shape)} "
            f"and out_proj {tuple(p.out_proj.shape)}")
    cl = p.conv_w.shape[-1]
    return _Cut(h0, hl, c.mrank * cl if conv_split else 0, cl, in_split,
                conv_split, hl != H)


def _regroup_in(t: torch.Tensor, c) -> torch.Tensor:
    """Where the whole ``in_proj`` product or the whole conv output,
    the same on every model rank, is cut into the rank's heads (and
    every rank's ``B`` / ``C``): the cuts' gradients are summed over
    the ranks (:func:`repro_torch.models.tp.copy_in`)."""
    return tp.copy_in(t, c)


def _norm_sum(t: torch.Tensor, c) -> torch.Tensor:
    """The gated norm's sum of squares over the whole ``d_inner``: each
    rank's heads' sum, all-reduced forward, and, since every rank then
    scales its own heads by it, all-reduced backward too
    (:func:`repro_torch.models.tp.shared_sum`)."""
    return tp.shared_sum(t, c)


def _in_proj(x: torch.Tensor, p: SSMParams, dims: SSMDims, k: _Cut, c):
    """``(z, xbc_raw, dt)`` of the rank's share from ``x``: ``z`` and
    ``dt`` of its heads, ``xbc_raw`` the pre-conv ``x B C`` rows of the
    channels its ``conv_w`` piece holds.  A column-split ``in_proj``'s
    product is gathered whole first (its pieces do not fall on head
    boundaries)."""
    di, G, N = dims.d_inner, dims.n_groups, dims.state
    P, C = dims.head_dim, di + 2 * G * N
    if k.in_split:
        x = tp.copy_in(x, c)
    zx = x @ p.in_proj
    if k.in_split:
        zx = tp.gather_model(zx, -1, c)
    zc = _regroup_in(zx, c) if k.heads_split or k.conv_split else zx
    zh = zc if k.heads_split else zx
    z = zh[..., k.h0 * P:(k.h0 + k.hl) * P]
    dt = zh[..., di + C + k.h0:di + C + k.h0 + k.hl]
    raw = (zc if k.conv_split else zx)[..., di + k.c0:di + k.c0 + k.cl]
    return z, raw, dt


def _regroup_conv(xbc: torch.Tensor, dims: SSMDims, k: _Cut, c):
    """The conv output of the rank's channels gathered whole (where
    ``conv_w`` is split), then cut as the scan wants it: ``x`` of the
    rank's heads and ``B`` / ``C`` of the groups they read, SiLU'd in
    fp32."""
    di, G, N, H, P = (dims.d_inner, dims.n_groups, dims.state,
                      dims.n_heads, dims.head_dim)
    if k.conv_split:
        xbc = tp.gather_model(xbc, -1, c)
    if not k.heads_split:
        return torch.split(F.silu(xbc.float()), [di, G * N, G * N], dim=-1)
    xbc = _regroup_in(xbc, c)
    xs = F.silu(xbc[..., k.h0 * P:(k.h0 + k.hl) * P].float())
    Bm = F.silu(xbc[..., di:di + G * N].float())
    Cm = F.silu(xbc[..., di + G * N:di + 2 * G * N].float())
    if G > 1:
        def groups(t):
            # the groups the rank's heads read, as kv heads for query heads
            g = t.unflatten(-1, (G, N)).flatten(0, -3)[:, None]
            g = tp.kv_for_heads(g, k.h0, k.hl, H // G)
            return g.reshape(*t.shape[:-1], -1)
        Bm, Cm = groups(Bm), groups(Cm)
    return xs, Bm, Cm


def _gated_out(y: torch.Tensor, z: torch.Tensor, p: SSMParams,
               dtype: torch.dtype, dims: SSMDims, k: _Cut, c
               ) -> torch.Tensor:
    """``rms_norm(y * silu(z)) @ out_proj`` with fp32 ``y`` (the norm's
    default eps, as in the JAX mixer), cast to the residual's dtype.
    On a mesh whose ranks hold heads of their own, the norm's mean runs
    over every rank's heads (:func:`_norm_sum`) and the ranks' partial
    products are summed in fp32, rounded once."""
    g = y * F.silu(z.float()).to(y.dtype)
    if not k.heads_split:
        return (rms_norm(g, p.norm) @ p.out_proj.float()).to(dtype)
    var = _norm_sum(g.square().sum(-1, keepdim=True), c) / dims.d_inner
    g = g * torch.rsqrt(var + 1e-6) * (1.0 + p.norm.float())
    return tp.reduce_sum(g @ p.out_proj.float(), c).to(dtype)


def mixer(x: torch.Tensor, p: SSMParams, dims: SSMDims, chunk: int,
          *, heads_block: Optional[int] = None, mode: str = "auto", c=None):
    """The full-sequence mixer: ``(out, final_state, xbc_raw)``, the
    pre-conv ``xBC`` rows being what the decode conv window needs.

    ``dims`` are the whole mixer's.  On a mesh (``c``, a
    :class:`repro_torch.models.tp.MeshCtx`) ``p`` holds the rank's
    pieces: the scan runs the rank's heads, ``final_state`` is theirs
    and ``xbc_raw`` the channels of the rank's ``conv_w`` piece."""
    B, S, _ = x.shape
    k = _cut(p, dims, c)
    z, xbc_raw, dt = _in_proj(x, p, dims, k, c)
    xs, Bm, Cm = _regroup_conv(causal_conv(xbc_raw, p.conv_w, p.conv_b),
                               dims, k, c)
    xs = xs.reshape(B, S, k.hl, dims.head_dim)
    dt = F.softplus(dt.float() + p.dt_bias)                   # (B,S,Hl)
    A = -torch.exp(p.A_log)
    y, final = ssd_chunked(xs, dt, A, Bm.reshape(B, S, -1, dims.state),
                           Cm.reshape(B, S, -1, dims.state), chunk=chunk,
                           heads_block=heads_block, mode=mode)
    y = (y + xs * p.D[None, None, :, None]).reshape(B, S, -1)
    return _gated_out(y, z, p, x.dtype, dims, k, c), final, xbc_raw


def ssm_forward(x: torch.Tensor, p: SSMParams, dims: SSMDims,
                chunk: int, *, heads_block: Optional[int] = None,
                mode: str = "auto", c=None) -> torch.Tensor:
    """Full-sequence (prefill) mamba2 mixer over ``(B, S, d)``."""
    return mixer(x, p, dims, chunk, heads_block=heads_block, mode=mode,
                 c=c)[0]


def ssm_decode_step(x: torch.Tensor, p: SSMParams, dims: SSMDims,
                    ssm_state: torch.Tensor, conv_state: torch.Tensor,
                    c=None) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """O(1) recurrent decode of ``(B, 1, d)``.  Returns ``(y,
    ssm_state', conv_state')`` as new tensors.  On a mesh (``c``) the
    states are the rank's pieces: its heads' ``ssm_state`` and the
    channels of its ``conv_w`` piece of the window."""
    B = x.shape[0]
    k = _cut(p, dims, c)
    z, xbc, dt = _in_proj(x[:, 0], p, dims, k, c)
    # roll the conv window, then one fp32 reduction over it
    conv_state = torch.cat([conv_state[:, 1:],
                            xbc[:, None].to(conv_state.dtype)], dim=1)
    xbc = (conv_state.float() * p.conv_w.float()).sum(1).to(xbc.dtype) \
        + p.conv_b
    xs, Bm, Cm = _regroup_conv(xbc, dims, k, c)
    H, G, N = k.hl, Bm.shape[-1] // dims.state, dims.state
    xs = xs.reshape(B, H, dims.head_dim)
    Bm = Bm.reshape(B, G, N).repeat_interleave(H // G, dim=1)   # (B,H,N)
    Cm = Cm.reshape(B, G, N).repeat_interleave(H // G, dim=1)
    dt = F.softplus(dt.float() + p.dt_bias)                   # (B,H)
    A = -torch.exp(p.A_log)
    decay = torch.exp(dt * A)[..., None, None]                # (B,H,1,1)
    upd = torch.einsum("bh,bhn,bhp->bhpn", dt, Bm, xs)
    ssm_state = ssm_state * decay + upd
    y = torch.einsum("bhpn,bhn->bhp", ssm_state, Cm)
    y = (y + xs * p.D[None, :, None]).reshape(B, -1)
    return (_gated_out(y, z, p, x.dtype, dims, k, c)[:, None], ssm_state,
            conv_state)
