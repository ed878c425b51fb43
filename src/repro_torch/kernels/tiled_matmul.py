"""Plan-driven tiled matmul: the Hopper kernel and its plain version.

Replaces the Pallas TPU kernel ``tiled_matmul`` in
``src/repro/kernels/tiled_matmul.py:38`` (body ``_mm_kernel``), the
direct embodiment of the local-partitioning pass: ``(bm, bk, bn)`` come
from the plan's ``tiled_matmul`` BlockPlan and the kernel just uses
them.  The CUDA source, ``csrc/tiled_matmul.cu``, says in its header
what bounds it on the card and how the design answers that.

Contract (a superset of the Pallas one): a ``(M, K)`` @ b ``(K, N)``,
both contiguous, 16-byte aligned and of one dtype, bf16 or fp32; the
product is summed in fp32 and written in the input dtype.  Any M, K and
N (the Pallas kernel asserted that the clamped tiles divide them): the
ragged edges are zero-filled on load and never written.  bf16 loads its
tiles with TMA and fp32 with 16-byte ``cp.async`` rows; both need ``K``
and ``N`` to be multiples of 16 bytes' worth of elements (8 in bf16, 4
in fp32) and raise otherwise.

Tiles: the kernel is built for the ``(bm, bk, bn)`` of
:data:`KERNEL_TILES`; :func:`kernel_tiles` raises on any other and
never substitutes one.  A plan without a ``tiled_matmul`` BlockPlan
gets :data:`DEFAULT_TILES`.  bf16 runs ``wgmma`` on a ring of
:data:`STAGES` TMA stages; fp32 runs FMAs on :data:`FP32_STAGES`
``cp.async`` stages.  No model path calls this kernel: the model's
projections stay ``torch.matmul``, as the JAX model left them to XLA.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build

#: (bm, bk, bn) the CUDA kernel is instantiated for: the H100 plan's
#: tile and default, and the tiles of the JAX package's own
#: ``test_tiled_matmul`` cases
KERNEL_TILES = ((128, 64, 128), (64, 128, 64), (64, 64, 64))
DEFAULT_TILES = (128, 64, 128)
#: bf16 operand stages of the TMA ring in shared memory
STAGES = 4
#: the ring's stages when a 128-row tile meets M <= 64 (a decode tick):
#: the kernel runs it as a 64-row tile on a deeper ring
SMALL_M_STAGES = 7
#: fp32 operand stages (cp.async, the paper's 2-bank PLM)
FP32_STAGES = 2
DTYPES = (torch.bfloat16, torch.float32)

#: launches of the CUDA kernel in this process (reset by the caller)
launches = 0


def smem_bytes(bm: int, bk: int, bn: int, dtype=torch.bfloat16) -> int:
    """The most dynamic shared memory one CTA asks for at a tile.  bf16
    (``csrc`` ``Ring::kBytes``): :data:`STAGES` A ``(bm, bk)`` and B
    ``(bk, bn)`` tiles, their mbarriers and 1 KB to align the tiles to
    the 128-byte swizzle's 1024-byte atom; a 128-row tile at M <= 64
    runs :data:`SMALL_M_STAGES` stages of a 64-row A tile instead, and
    the larger of the two counts.  fp32 (``csrc`` ``Layout::kBytes``):
    :data:`FP32_STAGES` copies of the two tiles, each row padded by 16
    bytes.  The fp32 accumulator is in registers on both paths."""
    if dtype == torch.bfloat16:
        def ring(rows, stages):
            return stages * (rows * bk + bk * bn) * 2 + 2 * stages * 8
        small = ring(64, SMALL_M_STAGES) if bm == 128 else 0
        return max(ring(bm, STAGES), small) + 1024
    e = dtype.itemsize
    pad = 16 // e
    return FP32_STAGES * (bm * (bk + pad) + bk * (bn + pad)) * e


def kernel_tiles(tiles: Optional[Sequence[int]]) -> Tuple[int, int, int]:
    """The kernel's ``(bm, bk, bn)``: the plan's tile or the documented
    default.  Raises on a tile the kernel is not built for — never
    substitutes another."""
    if tiles is None:
        return DEFAULT_TILES
    t = tuple(int(x) for x in tiles)
    if t not in KERNEL_TILES:
        raise ValueError(f"tiled_matmul: tile (bm, bk, bn)={t} is not one "
                         f"the kernel is built for {KERNEL_TILES}")
    return t


def tiled_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the product in fp32, cast
    back to ``a``'s dtype (``repro/kernels/ref.py`` ``tiled_matmul_ref``).
    Runs on any device; set ``torch.backends.cuda.matmul.allow_tf32``
    off on the card to keep it fp32."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"tiled_matmul: shapes a {tuple(a.shape)} b "
                         f"{tuple(b.shape)} are not (M, K) and (K, N)")
    for name, t in (("a", a), ("b", b)):
        if t.device != a.device:
            raise ValueError(f"tiled_matmul: {name} on {t.device}, a on "
                             f"{a.device}")
        if t.dtype not in DTYPES or t.dtype != a.dtype:
            raise TypeError(f"tiled_matmul: a is {a.dtype}, b is {b.dtype}; "
                            "the kernel takes both bfloat16 or both float32")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"tiled_matmul: {name} is not contiguous and "
                             "16-byte aligned")
    vec = 16 // a.element_size()
    K, N = b.shape
    if K % vec or N % vec:
        raise ValueError(f"tiled_matmul: the kernel copies 16-byte rows, so "
                         f"K and N must be multiples of {vec} in {a.dtype}; "
                         f"got K={K} N={N}")


def tiled_matmul(a: torch.Tensor, b: torch.Tensor, *,
                 tiles: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Launch the tiled matmul kernel on CUDA tensors (raises on any
    other device or on inputs the kernel does not take)."""
    global launches
    if a.device.type != "cuda":
        raise ValueError(f"tiled_matmul: the kernel runs on CUDA tensors, got "
                         f"{a.device} (kernels.ops routes CPU tensors to the "
                         "plain version)")
    _check(a, b)
    bm, bk, bn = kernel_tiles(tiles)
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if M == 0 or N == 0:
        return out
    err = build.library("tiled_matmul").tiled_matmul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), M, K, N, bm, bk, bn,
        int(a.dtype == torch.float32),
        torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"tiled_matmul: launch failed with "
                           f"{build.describe_error(err)}")
    launches += 1
    return out
