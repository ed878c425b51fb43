"""Kernel entry points the model and serving code call.

The JAX package chose between a Pallas kernel and its jnp oracle by
backend and the plan's ``use_pallas`` mode.  Here the tensor's device
decides: a CPU tensor goes to the kernel's plain PyTorch version, a CUDA
tensor to the hand-written kernel, or the call raises.  There is no
unkernelled path on the card, so the plan's ``use_pallas="off"`` raises
for a CUDA tensor.  Tiles come from the plan's ``BlockPlan``s (through
:class:`repro_torch.models.lm.RunCfg`); each kernel module documents its
default for a plan that has none and raises on a tile it cannot run.
A fake tensor (the dry run's, :mod:`repro_torch.kernels.fake`) takes a
third route, whatever its device: outputs of the kernel's shapes and
dtypes and the call's work recorded, never a plain version and never a
launch.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import fake as _fake
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import tiled_matmul as _mm

MODES = ("auto", "on", "off")


def _use_kernel(name: str, t: torch.Tensor, mode: str) -> bool:
    """The one routing decision: ``False`` for a CPU tensor (the plain
    version), ``True`` for a CUDA tensor (the kernel) and for a fake
    tensor (the entry's fake path, which the caller takes where
    :func:`_fake.is_fake` holds); raises on a bad mode, on ``"off"`` for
    a CUDA or fake tensor and on any other device."""
    if mode not in MODES:
        raise ValueError(f"{name}: kernel mode {mode!r} not in {MODES}")
    if _fake.is_fake(t):
        if mode == "off":
            raise RuntimeError(f"{name}: the plan says use_pallas='off', but "
                               "the port has no unkernelled path")
        return True
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {t.device}")
    if mode == "off":
        raise RuntimeError(
            f"{name}: the plan says use_pallas='off', but the port has no "
            "unkernelled path for a CUDA tensor")
    return True


def _refuse_grad(name: str, *tensors) -> None:
    """Raise where autograd would record a call of a kernel that has no
    backward: grad mode on and a tensor input that requires grad.
    The kernel writes its CUDA output through ctypes, so that output
    carries no ``grad_fn`` and a loss through it would train nothing
    upstream, silently; the plain version would differentiate, so both
    devices raise alike.  Serving calls these with grad mode on but with
    parameters that do not require grad, and is unaffected."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward (serving and the "
            "plan-driven matmul path need none), so its output would carry "
            "no gradient; call it under torch.no_grad() or with inputs that "
            "do not require grad")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    tiles: Optional[Tuple[int, int]] = None,
                    mode: str = "auto",
                    positions: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """q ``(B, Sq, H, D)``, k/v ``(B, Skv, K, D)`` with ``Sq <= Skv``:
    the queries are the key stream's last ``Sq`` rows (``Sq ==
    Skv``: a whole prompt; ``Sq < Skv``: a tail over a resident prefix).
    ``tiles`` is the plan's ``(block_q, block_kv)`` (the plain version has
    no tiles).  ``positions`` ``(B, Skv)`` masks by those positions
    instead of the row index (the kernels' positions variant on a CUDA
    tensor).  Where autograd records (grad mode on and q, k or v
    requiring grad: the training path) the call goes through
    :class:`repro_torch.kernels.flash_attention.FlashAttention`: the
    forward and backward kernels on a CUDA tensor, the plain forward and
    plain backward on a CPU one; otherwise (serving, under
    ``torch.no_grad``) the forward alone, as before."""
    kernel = _use_kernel("flash_attention", q, mode)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _fa.FlashAttention.apply(q, k, v, causal, window, tiles,
                                        positions)
    if not kernel:
        return _fa.flash_attention_plain(q, k, v, causal=causal,
                                         window=window, positions=positions)
    if _fake.is_fake(q):
        return _fa.flash_attention_fake(q, k, v, causal=causal,
                                        window=window, positions=positions)
    bq, bkv = tiles if tiles is not None else (None, None)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               block_q=bq, block_kv=bkv, positions=positions)


def decode_attention(q, k, v, *, cache_len, window: int = 0,
                     block_kv: Optional[int] = None,
                     mode: str = "auto") -> torch.Tensor:
    """q ``(B, H, D)`` against a dense ``(B, S, K, D)`` cache.  Raises
    under autograd (:func:`_refuse_grad`)."""
    _refuse_grad("decode_attention", q, k, v)
    if not _use_kernel("decode_attention", q, mode):
        return _dec.decode_attention_plain(q, k, v, cache_len=cache_len,
                                           window=window)
    if _fake.is_fake(q):
        return _dec.decode_fake(q, k, cache_len=cache_len, window=window)
    return _dec.decode_attention(q, k, v, cache_len=cache_len, window=window,
                                 block_kv=block_kv)


def paged_decode_attention(q, k_pool, v_pool, block_tbl, *, cache_len,
                           window: int = 0, block_kv: Optional[int] = None,
                           mode: str = "auto") -> torch.Tensor:
    """q ``(B, H, D)`` against ``(N, bl, K, D)`` pools via the table.
    Raises under autograd (:func:`_refuse_grad`)."""
    _refuse_grad("paged_decode_attention", q, k_pool, v_pool)
    if not _use_kernel("paged_decode_attention", q, mode):
        return _dec.paged_decode_attention_plain(
            q, k_pool, v_pool, block_tbl, cache_len=cache_len, window=window)
    if _fake.is_fake(q):
        return _dec.decode_fake(q, k_pool, block_tbl, cache_len=cache_len,
                                window=window)
    return _dec.paged_decode_attention(q, k_pool, v_pool, block_tbl,
                                       cache_len=cache_len, window=window,
                                       block_kv=block_kv)


def decode_partial(q, k, v, *, kv_start: int, pos, window: int = 0,
                   block_kv: Optional[int] = None, mode: str = "auto"):
    """The per-shard partial ``(m, l, acc)`` of q ``(B, H, D)`` over a
    dense ``(B, Sl, K, D)`` slice whose first row is the global row
    ``kv_start``, at per-slot global positions ``pos``: K8 on a CUDA
    tensor, the plain version on a CPU one.  Raises under autograd."""
    _refuse_grad("decode_partial", q, k, v)
    if not _use_kernel("decode_partial", q, mode):
        return _dec.decode_partial_plain(q, k, v, kv_start=kv_start, pos=pos,
                                         window=window)
    if _fake.is_fake(q):
        return _dec.partial_fake(q, k)
    return _dec.decode_partial(q, k, v, kv_start=kv_start, pos=pos,
                               window=window, block_kv=block_kv)


def paged_decode_partial(q, k_pool, v_pool, block_tbl, *, block_start: int,
                         pos, window: int = 0,
                         block_kv: Optional[int] = None, mode: str = "auto"):
    """The per-shard partial over the blocks of a ``(Nl, bl, K, D)``
    sub-pool whose first block is the global block ``block_start``,
    through the global table: K8 on a CUDA tensor, the plain version on
    a CPU one.  Raises under autograd."""
    _refuse_grad("paged_decode_partial", q, k_pool, v_pool)
    if not _use_kernel("paged_decode_partial", q, mode):
        return _dec.paged_decode_partial_plain(
            q, k_pool, v_pool, block_tbl, block_start=block_start, pos=pos,
            window=window)
    if _fake.is_fake(q):
        return _dec.partial_fake(q, k_pool, block_tbl)
    return _dec.paged_decode_partial(q, k_pool, v_pool, block_tbl,
                                     block_start=block_start, pos=pos,
                                     window=window, block_kv=block_kv)


def decode_split_scores(q, k, block_tbl=None, *, cache_len, scale: float,
                        window: int = 0, mode: str = "auto") -> torch.Tensor:
    """K9's pass 1: the fp32 partial scores of q ``(B, H, DS)``, a
    rank's columns of every query head, against its columns of a dense
    ``(B, S, K, DS)`` cache or a ``(N, bl, K, DS)`` pool through
    ``block_tbl``, scaled by ``scale`` (the whole head_dim's), in the
    compact layout ``(B, H, Wc)``: column ``x`` of a slot is its live row
    ``lo + x``, 0 past its live count
    (:func:`repro_torch.kernels.decode_attention.split_cols`).  The
    kernel on a CUDA tensor, the plain version on a CPU one.  Raises
    under autograd (:func:`_refuse_grad`)."""
    _refuse_grad("decode_split_scores", q, k)
    if not _use_kernel("decode_split_scores", q, mode):
        return _dec.decode_split_scores_plain(
            q, k, block_tbl, cache_len=cache_len, window=window,
            scale=scale)
    if _fake.is_fake(q):
        return _dec.split_scores_fake(q, k, block_tbl, cache_len=cache_len,
                                      window=window)
    return _dec.decode_split_scores(q, k, block_tbl, cache_len=cache_len,
                                    window=window, scale=scale)


def decode_split_context(s, v, block_tbl=None, *, cache_len,
                         window: int = 0, mode: str = "auto"
                         ) -> torch.Tensor:
    """K9's pass 2: the fp32 softmax of the compact scores ``(B, H,
    Wc)`` summed over the model ranks, masked to each slot's live count,
    against the rank's V columns of the same rows: the context's ``(B,
    H, DS)`` columns.  The kernel on a CUDA tensor (one launch), the
    plain version on a CPU one.  Raises under autograd."""
    _refuse_grad("decode_split_context", s, v)
    if not _use_kernel("decode_split_context", s, mode):
        return _dec.decode_split_context_plain(
            s, v, block_tbl, cache_len=cache_len, window=window)
    if _fake.is_fake(s):
        return _dec.split_context_fake(s, v, block_tbl, cache_len=cache_len,
                                       window=window)
    return _dec.decode_split_context(s, v, block_tbl, cache_len=cache_len,
                                     window=window)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: Optional[int] = None,
             heads_block: Optional[int] = None, initial_state=None,
             mode: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD scan over x ``(B, S, H, P)`` with B/C ``(B, S, G,
    N)``: ``(y, final_state)``.  ``chunk``/``heads_block`` are the
    plan's ``ssd_scan`` BlockPlan (the plain version takes the chunk
    only: heads are one batched product there).  Where autograd records
    (grad mode on and an input requiring grad: the training path) the
    call goes through :class:`repro_torch.kernels.ssd_scan.SSDScan`: the
    forward and backward kernels on a CUDA tensor, the plain forward and
    plain backward on a CPU one; otherwise (serving) the forward
    alone."""
    kernel = _use_kernel("ssd_scan", x, mode)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, Bm, Cm, initial_state)):
        return _ssd.SSDScan.apply(x, dt, A, Bm, Cm, initial_state, chunk,
                                  heads_block)
    if not kernel:
        return _ssd.ssd_scan_plain(
            x, dt, A, Bm, Cm, chunk=chunk or _ssd.DEFAULT_CHUNK,
            initial_state=initial_state)
    if _fake.is_fake(x):
        return _ssd.ssd_scan_fake(x, Bm, chunk or _ssd.DEFAULT_CHUNK)
    return _ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk,
                         heads_block=heads_block,
                         initial_state=initial_state)


def matmul_tiles(plan) -> Optional[Tuple[int, int, int]]:
    """The ``(bm, bk, bn)`` of a plan's ``tiled_matmul`` BlockPlan, or
    ``None`` (the kernel's documented default) for a plan without one."""
    bp = plan.partitions.get("tiled_matmul")
    if bp is None:
        return None
    return bp.blocks["bm"], bp.blocks["bk"], bp.blocks["bn"]


def matmul(a, b, *, tiles: Optional[Tuple[int, int, int]] = None,
           mode: str = "auto") -> torch.Tensor:
    """a ``(M, K)`` @ b ``(K, N)`` summed in fp32, in a's dtype, on the
    plan's ``(bm, bk, bn)`` (:func:`matmul_tiles`).  The tile is checked
    on either device, so a plan the kernel cannot run fails on the CPU
    too; the plain version has no tiles.  Raises under autograd
    (:func:`_refuse_grad`)."""
    _refuse_grad("tiled_matmul", a, b)
    _mm.kernel_tiles(tiles)
    if not _use_kernel("tiled_matmul", a, mode):
        return _mm.tiled_matmul_plain(a, b)
    if _fake.is_fake(a):
        return _mm.tiled_matmul_fake(a, b)
    return _mm.tiled_matmul(a, b, tiles=tiles)


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel."""
    return {"flash_attention": _fa.launches,
            "flash_attention_bwd": _fa.bwd_launches,
            "flash_attention_positions": _fa.pos_launches,
            "flash_attention_bwd_positions": _fa.pos_bwd_launches,
            "paged_decode_attention": _dec.paged_launches,
            "decode_attention": _dec.dense_launches,
            "decode_partial": _dec.partial_launches,
            "paged_decode_partial": _dec.paged_partial_launches,
            "decode_split_scores": _dec.split_scores_launches,
            "decode_split_context": _dec.split_context_launches,
            "ssd_scan": _ssd.launches,
            "ssd_scan_bwd": _ssd.bwd_launches,
            "tiled_matmul": _mm.launches}


def reset_launch_counts() -> None:
    _fa.launches = 0
    _fa.tail_launches = 0
    _fa.bwd_launches = 0
    _fa.pos_launches = 0
    _fa.pos_bwd_launches = 0
    _dec.paged_launches = 0
    _dec.dense_launches = 0
    _dec.partial_launches = 0
    _dec.paged_partial_launches = 0
    _dec.split_scores_launches = 0
    _dec.split_context_launches = 0
    _ssd.launches = 0
    _ssd.bwd_launches = 0
    _mm.launches = 0
