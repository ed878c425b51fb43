"""Flash attention (forward): the Hopper kernel and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``, body ``_flash_kernel``, and the packed-causal grid
``_flash_causal_packed``).  The CUDA source is
``csrc/flash_attention.cu``; its header says what bounds it on the card
and how the design answers that.

Contract (a superset of the Pallas one): q ``(B, Sq, H, D)``, k/v
``(B, Skv, K, D)`` with ``Sq <= Skv``, GQA with ``H % K == 0``, causal
and sliding-window masks, any lengths (the ragged edge is masked; Pallas
asserted ``S % block == 0``).  The queries are the key stream's last
``Sq`` positions: query row ``i`` sits at absolute position ``Skv - Sq +
i`` (bottom-right-aligned causal), so ``Sq == Skv`` is a whole prompt
and ``Sq < Skv`` a prompt's tail prefilled over a resident prefix (the
JAX package's ``attention_tail``).  Output has q's dtype.
:func:`flash_attention` launches the kernel on CUDA tensors and raises
on any other device;
:mod:`repro_torch.kernels.ops` sends a CPU tensor to
:func:`flash_attention_plain` (one masked softmax in fp32, no tiles).

Tiles: the kernel's CTA holds ``rows`` = 64 or 128 query rows, 64 to
each consumer warpgroup: ``block_q = rows // G`` whole positions times
the ``G = H/K`` heads sharing a kv head, and streams ``block_kv`` K/V
rows a tile through a TMA ring of :data:`STAGES` stages.  A group that
divides no tile leaves pad rows (G = 7: 18 positions = 126 of 128 rows)
that the kernel never writes (G = 5: 25 positions = 125 of 128 rows).
It is built for ``(rows, block_kv)`` in :data:`KERNEL_TILES`, the head
dims in :data:`HEAD_DIMS` and the groups in :data:`GROUPS`;
:func:`kernel_tiles` raises on any other plan tile or group.  A plan without a ``flash_attention``
BlockPlan (decode shapes have none) gets :data:`DEFAULT_ROWS` x
:data:`DEFAULT_BLOCK_KV`, 164,920 B of shared memory at head_dim 128
(83,000 B at 64), one CTA to an SM.
TMA reads q, k and v in place, so each must start on a 16-byte boundary.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

#: (query rows, kv rows) the CUDA kernel is instantiated for: one or two
#: 64-row consumer warpgroups, 64- or 128-row K/V tiles
KERNEL_TILES = ((64, 64), (64, 128), (128, 64), (128, 128))
DEFAULT_ROWS = 128
DEFAULT_BLOCK_KV = 128
#: head dims the kernel is instantiated at: one 128-byte swizzle row of
#: bf16 (hymba-1.5b's 64) or two (128)
HEAD_DIMS = (64, 128)
#: GQA groups (query heads per kv head) the kernel is checked at: the
#: powers of two, hymba-1.5b's 5 and deepseek-coder-33b's 7
GROUPS = (1, 2, 4, 5, 7, 8, 16)
#: K/V stages of the TMA ring in shared memory
STAGES = 2

#: launches of the CUDA kernel in this process (reset by the caller), and
#: how many of them ran a query block at an offset (``Sq < Skv``)
launches = 0
tail_launches = 0


def smem_bytes(rows: int, block_kv: int, head_dim: int = 128) -> int:
    """Dynamic shared memory one CTA asks for (``csrc`` ``Smem::kBytes``):
    the Q tile, :data:`STAGES` K and V tiles, the ring's mbarriers and
    1 KB to align the tiles to the 128-byte swizzle's 1024-byte atom.
    S, P and the O accumulator live in registers."""
    bars = (1 + 3 * STAGES) * 8
    return (rows * head_dim * 2 + STAGES * 2 * block_kv * head_dim * 2
            + bars + 1024)


def kernel_tiles(G: int, block_q: Optional[int] = None,
                 block_kv: Optional[int] = None) -> Tuple[int, int]:
    """``(rows, block_kv)`` for a GQA group of ``G`` heads: the CTA's
    rows whose ``rows // G`` whole positions are the plan's ``block_q``,
    or the documented default.  Raises on a group or a tile the kernel
    cannot run — never substitutes another."""
    if G not in GROUPS:
        raise ValueError(
            f"flash_attention: GQA group G = {G} is not one the kernel is "
            f"checked at {GROUPS}")
    if block_q is None and block_kv is None:
        return DEFAULT_ROWS, DEFAULT_BLOCK_KV
    if block_q is None or block_kv is None:
        raise ValueError("flash_attention: give both block_q and block_kv")
    rows = next((r for r, bkv in KERNEL_TILES
                 if r // G == block_q and bkv == block_kv), None)
    if rows is None:
        raise ValueError(
            f"flash_attention: tile block_q={block_q} positions x G={G}, "
            f"block_kv={block_kv} is not one the kernel is built for "
            f"{KERNEL_TILES} (block_q = rows // G)")
    return rows, block_kv


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """The kernel's function in plain PyTorch: one masked softmax over
    all key positions in fp32, the same superset contract (any lengths,
    queries the last ``Sq`` of ``Skv`` positions).  Runs on any device."""
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if Sq > Skv:
        raise ValueError(f"flash_attention: {Sq} queries over {Skv} keys; "
                         "the queries are the key stream's last positions")
    qpos = torch.arange(Skv - Sq, Skv, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= (qpos - kpos) < window
    s = torch.einsum("bqkgd,bskd->bkgqs",
                     q.reshape(B, Sq, K, H // K, D).float(),
                     k.float()) * (D ** -0.5)
    p = torch.softmax(torch.where(ok, s, float("-inf")), dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention: {name} is {t.dtype}; the "
                            "kernel takes bfloat16")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not contiguous "
                             "and 16-byte aligned (TMA reads it in place)")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    if k.shape[0] != B or k.shape[1] < Sq or k.shape[3] != D:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)} (Sq <= Skv)")
    if D not in HEAD_DIMS or H % k.shape[2]:
        raise ValueError(f"flash_attention: kernel takes head_dim in "
                         f"{HEAD_DIMS} and H % K == 0, got D={D} H={H} "
                         f"K={k.shape[2]}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_q: Optional[int] = None,
                    block_kv: Optional[int] = None,
                    ignore_offset: bool = False,
                    pad_fault: bool = False) -> torch.Tensor:
    """Launch the GQA flash kernel on CUDA tensors (raises on any other
    device or on inputs the kernel does not take).  ``ignore_offset``
    and ``pad_fault`` plant faults for the checks (tests and
    ``chip_smoke.py`` only): a tail's queries taken as positions
    ``0..Sq-1``; a tile's pad rows written over the next CTA's first
    position, in place of that CTA's own rows there (so the fault shows
    whichever CTA writes last)."""
    global launches, tail_launches
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: the kernel runs on CUDA tensors, "
                         f"got {q.device} (kernels.ops routes CPU tensors to "
                         "the plain version)")
    _check(q, k, v)
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    rows, bkv = kernel_tiles(H // K, block_q, block_kv)
    out = torch.empty_like(q)
    err = build.library("flash_attention").flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Skv, 0 if ignore_offset else Skv - Sq, H, K, D, int(causal),
        int(window), rows, bkv, float(D ** -0.5), int(pad_fault),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd: launch failed with "
                           f"{build.describe_error(err)}")
    launches += 1
    tail_launches += Sq < Skv
    return out
