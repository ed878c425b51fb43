"""Mamba2 SSD chunked scan: the Hopper kernel and its plain version.

Replaces the Pallas TPU kernel ``ssd_scan`` in
``src/repro/kernels/ssd_scan.py:83`` (body ``_ssd_kernel``).  The CUDA
source, ``csrc/ssd_scan.cu``, says in its header what bounds it on the
card (operations) and how the design answers that.

Contract (a superset of the Pallas one): x ``(B, S, H, P)``, dt ``(B,
S, H)`` (post-softplus), A ``(H,)`` (negative), Bm and Cm ``(B, S, G,
N)`` with head h reading group ``h // (H // G)`` (``G = H`` is the
Pallas "groups pre-broadcast" contract), all fp32; any S (no ``S %
chunk`` requirement); an optional initial state; returns ``(y (B, S,
H, P), final_state (B, H, P, N))`` in fp32.

Tiles: the plan's ``ssd_scan`` BlockPlan gives ``chunk`` (rows per
chunk, one of :data:`KERNEL_CHUNKS`) and ``heads_block`` (the TPU grid's
heads per step: still validated as a divisor of H, but the CUDA grid
gives every (batch, head, chunk) its own CTAs and does not use it); with
no plan, :data:`DEFAULT_CHUNK`.  The kernel is built for the
``(head_dim, state)`` pairs of :data:`KERNEL_WIDTHS`.  Anything else
raises.  One call launches the three passes of ``csrc/ssd_scan.cu``
(chunk states, state passing, chunk scan) through an fp32 workspace of
:func:`workspace_floats` floats, and writes the state carried into each
chunk to a tensor of its own (``return_states`` hands it to the caller).

Backward: the Pallas kernel has none (the JAX package differentiates
its jnp mirror ``ssd_chunked`` with XLA).  ``csrc/ssd_scan_bwd.cu`` is
the chunked backward (five launches: each chunk's term of the incoming
state's gradient, the state gradients passed back over the chunks, the
intra-chunk products of each pair of key tiles, whose one decayed tile
gives both the key side and the query side, dt and dA, the sums over a
group's heads; its header has the formulas and the bound), and
:func:`ssd_scan_bwd_plain` the same passes in plain PyTorch.
:class:`SSDScan` is the gradient route: its forward keeps the inputs,
``y``, the final state and the chunk states, and its backward runs
:func:`ssd_scan_bwd` on CUDA tensors or :func:`ssd_scan_bwd_plain` on
the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

KERNEL_CHUNKS = (64, 128, 256)
DEFAULT_CHUNK = 256
#: (head_dim P, state N): mamba2-2.7b, mamba2 reduced, hymba-1.5b
KERNEL_WIDTHS = ((64, 128), (32, 16), (64, 16))

#: launches of the CUDA kernels in this process, forward and backward
#: (reset by the caller)
launches = 0
bwd_launches = 0


def segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment sum: ``out[..., i, j] = sum_{k=j+1..i} x[..., k]``
    for ``j <= i``, ``-inf`` above the diagonal."""
    T = x.shape[-1]
    cs = x.cumsum(-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    return out.masked_fill(~mask, float("-inf"))


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, *,
                   chunk: int = DEFAULT_CHUNK,
                   initial_state: Optional[torch.Tensor] = None,
                   return_states: bool = False):
    """The kernel's function in plain PyTorch: the chunked SSD form of
    ``src/repro/models/ssm.py:53`` (``ssd_chunked``), written the same
    way — zero padding to whole chunks, intra-chunk products, per-chunk
    end states and the short recurrence over chunks.  Returns ``(y,
    final_state)``, and with ``return_states`` the state carried into
    each chunk ``(B, nc, H, P, N)`` (``nc = ceil(S / min(chunk, S))``),
    which :func:`ssd_scan_bwd_plain` takes."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        # dt = 0 padding is exact: decay exp(0) = 1, no input contribution
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    nc = (S + pad) // chunk
    xc = x.reshape(Bsz, nc, chunk, H, P)
    dtc = dt.reshape(Bsz, nc, chunk, H)
    Bh = Bm.reshape(Bsz, nc, chunk, G, N).repeat_interleave(rep, dim=3)
    Ch = Cm.reshape(Bsz, nc, chunk, G, N).repeat_interleave(rep, dim=3)

    dA = (dtc * A).movedim(-1, 2)                            # (B,nc,H,Q)
    dA_cs = dA.cumsum(-1)
    # 1. intra-chunk
    L = torch.exp(segsum(dA))                                # (B,nc,H,Q,Q)
    xdt = xc * dtc[..., None]                                # (B,nc,Q,H,P)
    scores = torch.einsum("bcqhn,bckhn->bchqk", Ch, Bh)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores * L, xdt)
    # 2. per-chunk end states
    decay_states = torch.exp(dA_cs[..., -1:] - dA_cs)        # (B,nc,H,Q)
    states = torch.einsum("bckhn,bchk,bckhp->bchpn", Bh, decay_states, xdt)
    # 3. the recurrence over chunks, emitting each chunk's incoming state
    chunk_decay = torch.exp(dA_cs[..., -1])                  # (B,nc,H)
    s = (torch.zeros((Bsz, H, P, N), dtype=x.dtype, device=x.device)
         if initial_state is None else initial_state)
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, 1)                       # (B,nc,H,P,N)
    # 4. the carried-in state's contribution to each position
    y_off = torch.einsum("bcqhn,bchpn,bchq->bcqhp", Ch, prev_states,
                         torch.exp(dA_cs))
    y = (y_diag + y_off).reshape(Bsz, nc * chunk, H, P)
    if return_states:
        return y[:, :S], s, prev_states
    return y[:, :S], s


def _pad_rows(t: torch.Tensor, pad: int) -> torch.Tensor:
    """``t`` ``(B, S, ...)`` with ``pad`` zero rows after its last."""
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) if pad else t


def ssd_scan_bwd_plain(x, dt, A, Bm, Cm, y, states, final_state, dy,
                       dfinal=None, *, chunk: int = DEFAULT_CHUNK,
                       initial_grad: bool = False):
    """The backward kernel's function in plain PyTorch, its passes
    written out (``csrc/ssd_scan_bwd.cu``'s header has the formulas):
    each chunk's term of its incoming state's gradient, the state
    gradients passed back over the chunks from ``dfinal`` (zero when
    ``None``), the intra-chunk and state terms of dxdt, dB and dC, then
    dcs, its reverse cumsum to d(dt A), ddt and dA.  Not autograd of
    :func:`ssd_scan_plain`: that is the oracle it is tested against.

    Takes the forward's inputs, its ``y`` and final state, the chunk
    states ``(B, nc, H, P, N)`` of ``ssd_scan_plain(...,
    return_states=True)`` at the same ``chunk``, and the gradients of
    ``y`` and of the final state.  Returns ``(dx, ddt, dA, dB, dC,
    dinit)``, ``dinit`` the initial state's gradient with
    ``initial_grad``, else ``None``."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    chunk = min(chunk, S)
    pad = (-S) % chunk
    x, y, dy, dt, Bm, Cm = (_pad_rows(t, pad) for t in (x, y, dy, dt, Bm,
                                                          Cm))
    nc = (S + pad) // chunk
    xc, yc, dyc = (t.reshape(Bsz, nc, chunk, H, P) for t in (x, y, dy))
    dtc = dt.reshape(Bsz, nc, chunk, H)
    Bh = Bm.reshape(Bsz, nc, chunk, G, N).repeat_interleave(rep, dim=3)
    Ch = Cm.reshape(Bsz, nc, chunk, G, N).repeat_interleave(rep, dim=3)
    a = (dtc * A).movedim(-1, 2)                             # (B,nc,H,Q)
    cs = a.cumsum(-1)
    # 1. each chunk's local term of its incoming state's gradient
    local = torch.einsum("bcqhp,bchq,bcqhn->bchpn", dyc, torch.exp(cs), Ch)
    # 2. the gradient of each chunk's outgoing state, from the last back
    g = torch.zeros_like(final_state) if dfinal is None else dfinal
    d_out = [None] * nc
    for c in reversed(range(nc)):
        d_out[c] = g
        g = g * torch.exp(cs[:, c, :, -1])[..., None, None] + local[:, c]
    d_out = torch.stack(d_out, 1)                            # (B,nc,H,P,N)
    # 3. intra-chunk and state terms
    W = torch.exp(segsum(a))                                 # (B,nc,H,Q,Q)
    xdt = xc * dtc[..., None]
    sw = torch.einsum("bcqhn,bckhn->bchqk", Ch, Bh) * W
    dw = torch.einsum("bcqhp,bckhp->bchqk", dyc, xdt) * W
    decay = torch.exp(cs[..., -1:] - cs)                     # (B,nc,H,Q)
    dxdt = (torch.einsum("bchqk,bcqhp->bckhp", sw, dyc)
            + torch.einsum("bchk,bckhn,bchpn->bckhp", decay, Bh, d_out))
    dBh = (torch.einsum("bchqk,bcqhn->bckhn", dw, Ch)
           + torch.einsum("bchk,bckhp,bchpn->bckhn", decay, xdt, d_out))
    dCh = (torch.einsum("bchqk,bckhn->bcqhn", dw, Bh)
           + torch.einsum("bchq,bcqhp,bchpn->bcqhn", torch.exp(cs), dyc,
                          states))
    # 4. dcs (dy.y - xdt.dxdt, and <dS_out, S_out> on the chunk's last
    # row), its reverse cumsum d(dt A), ddt and dA
    u = (xc * dxdt).sum(-1)                                  # (B,nc,Q,H)
    r = (dyc * yc).sum(-1) - dtc * u
    s_out = torch.cat([states[:, 1:], final_state[:, None]], 1)
    e = (d_out * s_out).sum((-2, -1))                        # (B,nc,H)
    da = r.flip(2).cumsum(2).flip(2) + e[:, :, None]
    ddt = (A * da + u).reshape(Bsz, nc * chunk, H)[:, :S]
    dA = (dtc * da).sum((0, 1, 2))
    dx = (dxdt * dtc[..., None]).reshape(Bsz, nc * chunk, H, P)[:, :S]

    def by_group(t):
        return t.reshape(Bsz, nc * chunk, G, rep, N).sum(3)[:, :S]

    return (dx, ddt, dA, by_group(dBh), by_group(dCh),
            g if initial_grad else None)


def kernel_tiles(chunk: Optional[int], heads_block: Optional[int],
                 H: int) -> Tuple[int, int]:
    """The kernel's ``(chunk, heads_block)``: the plan's values or the
    documented defaults.  Raises on a value the kernel cannot run —
    never substitutes another."""
    q = DEFAULT_CHUNK if chunk is None else int(chunk)
    hb = 1 if heads_block is None else int(heads_block)
    if q not in KERNEL_CHUNKS:
        raise ValueError(f"ssd_scan: chunk={q} is not one of the kernel's "
                         f"chunks {KERNEL_CHUNKS}")
    if hb < 1 or H % hb:
        raise ValueError(f"ssd_scan: heads_block={hb} does not divide the "
                         f"{H} heads")
    return q, hb


def cuda_chunk(P: int, N: int) -> Optional[int]:
    """The chunk the CUDA kernel runs at widths ``(P, N)``, ``None``
    where it is not built for them: the largest of :data:`KERNEL_CHUNKS`,
    since no pass's shared memory grows with the chunk
    (:func:`smem_bytes`) and a longer chunk leaves fewer states to pass.
    The plan's tile (``LocalPartitioningPass._ssd_cuda``) and the eager
    step-peak estimate (``CommunicationPass._remat_by_step_peak``) both
    read it."""
    return max(KERNEL_CHUNKS) if (P, N) in KERNEL_WIDTHS else None


def smem_bytes(P: int, N: int) -> int:
    """Shared memory of the larger of the kernel's two tiled passes
    (``csrc`` ``Layout<P, N>``): the chunk states (two cp.async stages of
    B and x, cumsum, dt) or the chunk scan (C, two stages of a score tile
    and x or of the carried state, cumsum, dt)."""
    state = 2 * (64 * (N + 8) + 64 * (P + 8)) + 2 * 256
    stage = max(64 * 68 + 64 * (P + 8), N * (P + 8))
    scan = 64 * (N + 4) + 2 * stage + 2 * 256
    return 4 * max(state, scan)


def _align4(n: int) -> int:
    return -(-n // 4) * 4


def workspace_floats(B: int, S: int, H: int, P: int, N: int, G: int,
                     chunk: int) -> int:
    """fp32 workspace of one call (``csrc`` ``ssd_scan``): each chunk's
    decay log ``(B, H, nc)``, padded to 16 bytes; each group's raw causal
    score tiles ``(B, G, nc, T (T + 1) / 2, 64, 64)``; ``nc = ceil(S /
    chunk)``, ``T = chunk / 64``.  (The chunk states ``(B, nc, H, N,
    P)`` are a tensor of their own.)"""
    nc = -(-S // chunk)
    T = chunk // 64
    return _align4(B * H * nc) + B * G * nc * T * (T + 1) // 2 * 64 * 64


def bwd_slots(chunk: int) -> int:
    """dC slots of one (batch, chunk, head) in the backward (``csrc``
    ``n_slots``): pair p of the ``ceil(T / 2)`` (key tiles p and T - 1 -
    p, ``T = chunk / 64``) writes one for each query tile at or after p:
    1, 2 and 7 at chunk 64, 128 and 256."""
    T = chunk // 64
    pairs = (T + 1) // 2
    return pairs * T - pairs * (pairs - 1) // 2


def bwd_workspace_floats(B: int, S: int, H: int, P: int, N: int, G: int,
                         chunk: int) -> int:
    """fp32 workspace of one backward call (``csrc`` ``ssd_scan_bwd``):
    each chunk's share of dA ``(B, H, nc)`` in fp64; then fp32 state
    gradients ``(B, nc, H, N, P)``, decay logs ``(B, H, nc)``, each
    head's dB rows ``(B, S, H, N)`` and each head's dC slots ``(B, nc, H,
    slots, 64, N)`` (:func:`bwd_slots`: at chunk 256, 7 tiles of 64 rows
    for a chunk's 4, so 1.75 x a head's dC rows); every part rounded up
    to 16 bytes."""
    nc = -(-S // chunk)
    return (2 * _align4(B * H * nc) + B * nc * H * N * P
            + _align4(B * H * nc) + B * S * H * N
            + B * nc * H * bwd_slots(chunk) * 64 * N)


def grid_ctas(B: int, S: int, H: int, P: int, N: int, chunk: int
              ) -> Tuple[int, int, int]:
    """CTAs of the three launches: chunk states, state passing, chunk
    scan (one CTA per 64-row query tile of each chunk)."""
    nc = -(-S // chunk)
    return B * H * nc, -(-B * H * P * N // 256), B * H * nc * (chunk // 64)


def _check(fn: str, given, want, device) -> None:
    """Raise unless every tensor of ``given`` lies on ``device``, is
    float32, contiguous, 16-byte aligned and of its ``want`` shape."""
    for name, t in given.items():
        if t.device != device:
            raise ValueError(f"{fn}: {name} on {t.device}, x on {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: {name} is {t.dtype}; the kernel "
                            "takes float32")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{fn}: {name} is {tuple(t.shape)}, "
                             f"expected {want[name]}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} is not contiguous and "
                             "16-byte aligned")


def _shapes(x: torch.Tensor, Bm: torch.Tensor, chunk: int):
    """The kernels' tensor shapes by name, for x ``(B, S, H, P)`` and B
    ``(B, S, G, N)``, chunk states at ``chunk``; raises on widths the
    kernels are not built for."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (P, N) not in KERNEL_WIDTHS or H % G or S == 0:
        raise ValueError(f"ssd_scan: kernel takes (head_dim, state) in "
                         f"{KERNEL_WIDTHS} and groups dividing the heads, "
                         f"got P={P} N={N} H={H} G={G} S={S}")
    rows, bc, state = (Bsz, S, H, P), (Bsz, S, G, N), (Bsz, H, P, N)
    return {"x": rows, "dt": (Bsz, S, H), "A": (H,), "Bm": bc, "Cm": bc,
            "y": rows, "dy": rows, "initial_state": state,
            "final_state": state, "dfinal": state,
            "states": (Bsz, -(-S // chunk), H, N, P)}


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *,
             chunk: Optional[int] = None, heads_block: Optional[int] = None,
             initial_state: Optional[torch.Tensor] = None,
             no_carry: bool = False, return_states: bool = False):
    """Launch the SSD scan kernel on CUDA tensors (raises on any other
    device or on inputs the kernel does not take).  Returns ``(y,
    final_state)``, and with ``return_states`` the state carried into
    each chunk, ``(B, nc, H, N, P)`` (transposed: the backward kernel's
    layout).  ``no_carry`` plants a fault for the checks: no state passes
    between chunks."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: the kernel runs on CUDA tensors, got "
                         f"{x.device} (kernels.ops routes CPU tensors to the "
                         "plain version)")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    q, hb = kernel_tiles(chunk, heads_block, H)
    want = _shapes(x, Bm, q)
    given = {"x": x, "dt": dt, "A": A, "Bm": Bm, "Cm": Cm}
    if initial_state is not None:
        given["initial_state"] = initial_state
    _check("ssd_scan", given, want, x.device)
    y = torch.empty_like(x)
    fin = torch.empty(want["final_state"], dtype=torch.float32,
                      device=x.device)
    states = torch.empty(want["states"], dtype=torch.float32,
                         device=x.device)
    ws = torch.empty(workspace_floats(Bsz, S, H, P, N, G, q),
                     dtype=torch.float32, device=x.device)
    err = build.library("ssd_scan").ssd_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(),
        initial_state.data_ptr() if initial_state is not None else None,
        y.data_ptr(), fin.data_ptr(), states.data_ptr(), ws.data_ptr(), Bsz,
        S, H, P, G, N, q, hb, int(no_carry),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan: launch failed with cudaError {err}")
    launches += 1
    return (y, fin, states) if return_states else (y, fin)


def ssd_scan_bwd(x, dt, A, Bm, Cm, y, states, final_state, dy, dfinal=None,
                 *, chunk: Optional[int] = None, initial_grad: bool = False,
                 no_carry: bool = False, skip_tile: bool = False):
    """Launch the SSD scan's backward kernel on CUDA tensors (raises on
    any other device or on inputs it does not take): the gradients of
    :func:`ssd_scan_bwd_plain`, from the forward kernel's ``y``, final
    state and chunk states (``ssd_scan(..., return_states=True)`` at the
    same ``chunk``).  ``no_carry`` and ``skip_tile`` plant faults for the
    checks: no gradient passes between chunks; the key side leaves out
    its diagonal query tile."""
    global bwd_launches
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_bwd: the kernel runs on CUDA tensors, "
                         f"got {x.device} (the CPU takes ssd_scan_bwd_plain)")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    q, _ = kernel_tiles(chunk, None, H)
    want = _shapes(x, Bm, q)
    given = {"x": x, "dt": dt, "A": A, "Bm": Bm, "Cm": Cm, "y": y,
             "states": states, "final_state": final_state, "dy": dy}
    if dfinal is not None:
        given["dfinal"] = dfinal
    _check("ssd_scan_bwd", given, want, x.device)
    dx, ddt, dB, dC = (torch.empty_like(t) for t in (x, dt, Bm, Cm))
    dA = torch.empty_like(A)
    dinit = torch.empty_like(final_state) if initial_grad else None
    ws = torch.empty(bwd_workspace_floats(Bsz, S, H, P, N, G, q),
                     dtype=torch.float32, device=x.device)
    ptr = [t.data_ptr() if t is not None else None for t in (
        x, dt, A, Bm, Cm, y, states, final_state, dy, dfinal, dx, ddt, dA,
        dB, dC, dinit, ws)]
    err = build.library("ssd_scan_bwd").ssd_scan_bwd(
        *ptr, Bsz, S, H, P, G, N, q, int(no_carry), int(skip_tile),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan_bwd: launch failed with cudaError "
                           f"{err}")
    bwd_launches += 1
    return dx, ddt, dA, dB, dC, dinit


class SSDScan(torch.autograd.Function):
    """The SSD scan with its gradient: the kernels on CUDA tensors
    (forward and backward), the plain versions on the CPU, never one for
    the other.  The forward keeps x, dt, A, B, C, ``y``, the final state
    and the state carried into each chunk (``B nc H P N`` floats); the
    backward takes the gradients of ``y`` and of the final state (either
    may be ``None``) and returns those of x, dt, A, B, C and the initial
    state."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, initial_state,
                chunk: Optional[int], heads_block: Optional[int]):
        chunk = DEFAULT_CHUNK if chunk is None else chunk
        if x.device.type == "cuda":
            y, fin, states = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk,
                                      heads_block=heads_block,
                                      initial_state=initial_state,
                                      return_states=True)
        else:
            y, fin, states = ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk,
                                            initial_state=initial_state,
                                            return_states=True)
        ctx.save_for_backward(x, dt, A, Bm, Cm, y, states, fin)
        ctx.chunk, ctx.initial = chunk, initial_state is not None
        ctx.set_materialize_grads(False)
        return y, fin

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, Bm, Cm, y, states, fin = ctx.saved_tensors
        bwd = (ssd_scan_bwd if x.device.type == "cuda"
               else ssd_scan_bwd_plain)
        dy = torch.zeros_like(y) if dy is None else dy.contiguous()
        grads = bwd(x, dt, A, Bm, Cm, y, states, fin, dy,
                    None if dfinal is None else dfinal.contiguous(),
                    chunk=ctx.chunk, initial_grad=ctx.initial)
        return (*grads, None, None)
