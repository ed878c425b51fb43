"""Kernel entry points the model and serving code call.

The JAX package chose between a Pallas kernel and its jnp oracle by
backend and the plan's ``use_pallas`` mode.  Here the tensor's device
decides: a CPU tensor goes to the kernel's plain PyTorch version, a CUDA
tensor to the hand-written kernel, or the call raises.  There is no
unkernelled path on the card, so the plan's ``use_pallas="off"`` raises
for a CUDA tensor.  Tiles come from the plan's ``BlockPlan``s (through
:class:`repro_torch.models.lm.RunCfg`); each kernel module documents its
default for a plan that has none and raises on a tile it cannot run.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa

MODES = ("auto", "on", "off")


def _use_kernel(name: str, t: torch.Tensor, mode: str) -> bool:
    """The one routing decision: ``False`` for a CPU tensor (the plain
    version), ``True`` for a CUDA tensor (the kernel); raises on a bad
    mode, on ``"off"`` for a CUDA tensor and on any other device."""
    if mode not in MODES:
        raise ValueError(f"{name}: kernel mode {mode!r} not in {MODES}")
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {t.device}")
    if mode == "off":
        raise RuntimeError(
            f"{name}: the plan says use_pallas='off', but the port has no "
            "unkernelled path for a CUDA tensor")
    return True


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    tiles: Optional[Tuple[int, int]] = None,
                    mode: str = "auto") -> torch.Tensor:
    """q ``(B, S, H, D)``, k/v ``(B, S, K, D)``; ``tiles`` is the plan's
    ``(block_q, block_kv)`` (the plain version has no tiles)."""
    if not _use_kernel("flash_attention", q, mode):
        return _fa.flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
    bq, bkv = tiles if tiles is not None else (None, None)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               block_q=bq, block_kv=bkv)


def decode_attention(q, k, v, *, cache_len, window: int = 0,
                     block_kv: Optional[int] = None,
                     mode: str = "auto") -> torch.Tensor:
    """q ``(B, H, D)`` against a dense ``(B, S, K, D)`` cache."""
    if not _use_kernel("decode_attention", q, mode):
        return _dec.decode_attention_plain(q, k, v, cache_len=cache_len,
                                           window=window)
    return _dec.decode_attention(q, k, v, cache_len=cache_len, window=window,
                                 block_kv=block_kv)


def paged_decode_attention(q, k_pool, v_pool, block_tbl, *, cache_len,
                           window: int = 0, block_kv: Optional[int] = None,
                           mode: str = "auto") -> torch.Tensor:
    """q ``(B, H, D)`` against ``(N, bl, K, D)`` pools via the table."""
    if not _use_kernel("paged_decode_attention", q, mode):
        return _dec.paged_decode_attention_plain(
            q, k_pool, v_pool, block_tbl, cache_len=cache_len, window=window)
    return _dec.paged_decode_attention(q, k_pool, v_pool, block_tbl,
                                       cache_len=cache_len, window=window,
                                       block_kv=block_kv)


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel."""
    return {"flash_attention": _fa.launches,
            "paged_decode_attention": _dec.paged_launches,
            "decode_attention": _dec.dense_launches}


def reset_launch_counts() -> None:
    _fa.launches = 0
    _dec.paged_launches = 0
    _dec.dense_launches = 0
