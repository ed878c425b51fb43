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
:func:`workspace_floats` floats.
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

#: launches of the CUDA kernel in this process (reset by the caller)
launches = 0


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
                   initial_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: the chunked SSD form of
    ``src/repro/models/ssm.py:53`` (``ssd_chunked``), written the same
    way — zero padding to whole chunks, intra-chunk products, per-chunk
    end states and the short recurrence over chunks.  Returns ``(y,
    final_state)``."""
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
    return y[:, :S], s


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


def smem_bytes(P: int, N: int) -> int:
    """Shared memory of the larger of the kernel's two tiled passes
    (``csrc`` ``Layout<P, N>``): the chunk states (two cp.async stages of
    B and x, cumsum, dt) or the chunk scan (C, two stages of a score tile
    and x or of the carried state, cumsum, dt)."""
    state = 2 * (64 * (N + 8) + 64 * (P + 8)) + 2 * 256
    stage = max(64 * 68 + 64 * (P + 8), N * (P + 8))
    scan = 64 * (N + 4) + 2 * stage + 2 * 256
    return 4 * max(state, scan)


def workspace_floats(B: int, S: int, H: int, P: int, N: int, G: int,
                     chunk: int) -> int:
    """fp32 workspace of one call (``csrc`` ``ssd_scan``): each chunk's
    state, transposed, ``(B, nc, H, N, P)``; its decay log ``(B, H,
    nc)``, padded to 16 bytes; each group's raw causal score tiles ``(B,
    G, nc, T (T + 1) / 2, 64, 64)``; ``nc = ceil(S / chunk)``, ``T =
    chunk / 64``."""
    nc = -(-S // chunk)
    T = chunk // 64
    return (B * nc * H * P * N + -(-B * H * nc // 4) * 4
            + B * G * nc * T * (T + 1) // 2 * 64 * 64)


def grid_ctas(B: int, S: int, H: int, P: int, N: int, chunk: int
              ) -> Tuple[int, int, int]:
    """CTAs of the three launches: chunk states, state passing, chunk
    scan (one CTA per 64-row query tile of each chunk)."""
    nc = -(-S // chunk)
    return B * H * nc, -(-B * H * P * N // 256), B * H * nc * (chunk // 64)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *,
             chunk: Optional[int] = None, heads_block: Optional[int] = None,
             initial_state: Optional[torch.Tensor] = None,
             no_carry: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the SSD scan kernel on CUDA tensors (raises on any other
    device or on inputs the kernel does not take).  ``no_carry`` plants
    a fault for the checks: no state passes between chunks."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: the kernel runs on CUDA tensors, got "
                         f"{x.device} (kernels.ops routes CPU tensors to the "
                         "plain version)")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    q, hb = kernel_tiles(chunk, heads_block, H)
    want = {"x": (Bsz, S, H, P), "dt": (Bsz, S, H), "A": (H,),
            "Bm": (Bsz, S, G, N), "Cm": (Bsz, S, G, N),
            "initial_state": (Bsz, H, P, N)}
    given = {"x": x, "dt": dt, "A": A, "Bm": Bm, "Cm": Cm}
    if initial_state is not None:
        given["initial_state"] = initial_state
    for name, t in given.items():
        if t.device != x.device:
            raise ValueError(f"ssd_scan: {name} on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan: {name} is {t.dtype}; the kernel "
                            "takes float32")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"ssd_scan: {name} is {tuple(t.shape)}, "
                             f"expected {want[name]}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"ssd_scan: {name} is not contiguous and "
                             "16-byte aligned")
    if (P, N) not in KERNEL_WIDTHS or H % G or S == 0:
        raise ValueError(f"ssd_scan: kernel takes (head_dim, state) in "
                         f"{KERNEL_WIDTHS} and groups dividing the heads, "
                         f"got P={P} N={N} H={H} G={G} S={S}")
    y = torch.empty_like(x)
    fin = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ws = torch.empty(workspace_floats(Bsz, S, H, P, N, G, q),
                     dtype=torch.float32, device=x.device)
    err = build.library("ssd_scan").ssd_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(),
        initial_state.data_ptr() if initial_state is not None else None,
        y.data_ptr(), fin.data_ptr(), ws.data_ptr(), Bsz, S, H, P, G, N, q,
        hb, int(no_carry), torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan: launch failed with cudaError {err}")
    launches += 1
    return y, fin
