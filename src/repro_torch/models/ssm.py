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


def _split(zxbcdt: torch.Tensor, dims: SSMDims):
    di, G, N = dims.d_inner, dims.n_groups, dims.state
    return torch.split(zxbcdt, [di, di + 2 * G * N, dims.n_heads], dim=-1)


def _gated_out(y: torch.Tensor, z: torch.Tensor, p: SSMParams,
               dtype: torch.dtype) -> torch.Tensor:
    """``rms_norm(y * silu(z)) @ out_proj`` with fp32 ``y`` (the norm's
    default eps, as in the JAX mixer), cast to the residual's dtype."""
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p.norm)
    return (y @ p.out_proj.float()).to(dtype)


def mixer(x: torch.Tensor, p: SSMParams, dims: SSMDims, chunk: int,
          *, heads_block: Optional[int] = None, mode: str = "auto"):
    """The full-sequence mixer: ``(out, final_state, xbc_raw)``, the
    pre-conv ``xBC`` rows being what the decode conv window needs."""
    B, S, _ = x.shape
    di, H, Pd, N, G = (dims.d_inner, dims.n_heads, dims.head_dim,
                       dims.state, dims.n_groups)
    z, xbc_raw, dt = _split(x @ p.in_proj, dims)
    xbc = F.silu(causal_conv(xbc_raw, p.conv_w, p.conv_b).float())
    xs, Bm, Cm = torch.split(xbc, [di, G * N, G * N], dim=-1)
    xs = xs.reshape(B, S, H, Pd)
    dt = F.softplus(dt.float() + p.dt_bias)                   # (B,S,H)
    A = -torch.exp(p.A_log)
    y, final = ssd_chunked(xs, dt, A, Bm.reshape(B, S, G, N),
                           Cm.reshape(B, S, G, N), chunk=chunk,
                           heads_block=heads_block, mode=mode)
    y = (y + xs * p.D[None, None, :, None]).reshape(B, S, di)
    return _gated_out(y, z, p, x.dtype), final, xbc_raw


def ssm_forward(x: torch.Tensor, p: SSMParams, dims: SSMDims,
                chunk: int, *, heads_block: Optional[int] = None,
                mode: str = "auto") -> torch.Tensor:
    """Full-sequence (prefill) mamba2 mixer over ``(B, S, d)``."""
    return mixer(x, p, dims, chunk, heads_block=heads_block, mode=mode)[0]


def ssm_decode_step(x: torch.Tensor, p: SSMParams, dims: SSMDims,
                    ssm_state: torch.Tensor, conv_state: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """O(1) recurrent decode of ``(B, 1, d)``.  Returns ``(y,
    ssm_state', conv_state')`` as new tensors."""
    B = x.shape[0]
    di, H, Pd, N, G = (dims.d_inner, dims.n_heads, dims.head_dim,
                       dims.state, dims.n_groups)
    z, xbc, dt = _split(x[:, 0] @ p.in_proj, dims)
    # roll the conv window, then one fp32 reduction over it
    conv_state = torch.cat([conv_state[:, 1:],
                            xbc[:, None].to(conv_state.dtype)], dim=1)
    xbc = (conv_state.float() * p.conv_w.float()).sum(1).to(xbc.dtype) \
        + p.conv_b
    xbc = F.silu(xbc.float())
    xs, Bm, Cm = torch.split(xbc, [di, G * N, G * N], dim=-1)
    xs = xs.reshape(B, H, Pd)
    Bm = Bm.reshape(B, G, N).repeat_interleave(H // G, dim=1)   # (B,H,N)
    Cm = Cm.reshape(B, G, N).repeat_interleave(H // G, dim=1)
    dt = F.softplus(dt.float() + p.dt_bias)                   # (B,H)
    A = -torch.exp(p.A_log)
    decay = torch.exp(dt * A)[..., None, None]                # (B,H,1,1)
    upd = torch.einsum("bh,bhn,bhp->bhpn", dt, Bm, xs)
    ssm_state = ssm_state * decay + upd
    y = torch.einsum("bhpn,bhn->bhp", ssm_state, Cm)
    y = (y + xs * p.D[None, :, None]).reshape(B, di)
    return _gated_out(y, z, p, x.dtype)[:, None], ssm_state, conv_state
