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
ragged edges are zero-filled on load and never written.  Both dtypes
load their tiles with TMA, whose row pitch must be a multiple of 16
bytes: ``K`` and ``N`` are multiples of 8 in bf16 and of 4 in fp32,
and the wrapper raises otherwise.

Tiles: the kernel is built for the ``(bm, bk, bn)`` of
:data:`KERNEL_TILES`; :func:`kernel_tiles` raises on any other and
never substitutes one.  A plan without a ``tiled_matmul`` BlockPlan
gets :data:`DEFAULT_TILES`.  bf16 runs ``wgmma`` on a ring of
:data:`STAGES` TMA stages.  fp32 runs 3xTF32 products on ``wgmma``
(each operand split into a TF32 high and low part, three products) on a
ring of :data:`FP32_STAGES` TMA sub-stages, each :data:`FP32_DEPTH`
deep, with K split over :func:`fp32_splits` CTAs a tile.  No model path
calls this kernel: the model's projections stay ``torch.matmul``, as
the JAX model left them to XLA.
"""

from __future__ import annotations

import functools
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
#: K rows of one fp32 sub-stage: one 128-byte swizzle row of fp32 (a
#: plan's K step bk is bk / FP32_DEPTH sub-stages)
FP32_DEPTH = 32
#: fp32 sub-stages in the ring, by tile (``csrc`` ``launch_tf32x3``)
FP32_STAGES = {(128, 64, 128): 3, (64, 128, 64): 4, (64, 64, 64): 4}
#: the most CTAs one fp32 tile's K is split over
MAX_SPLITS = 4
#: :func:`fp32_splits`' model: a CTA's sub-stages of pipeline fill and
#: epilogue, and the share of the tensor cores' rate a CTA keeps (fitted
#: to the kernel's times at each split count on an H100 SXM, 700 W, at
#: (1000 | 2048, 5120, 2560): ``chip_smoke.py --only matmul_fp32``)
SPLIT_FILL = 2
SPLIT_EFFICIENCY = 0.7
DTYPES = (torch.bfloat16, torch.float32)

#: launches of the CUDA kernel in this process (reset by the caller)
launches = 0


def smem_bytes(bm: int, bk: int, bn: int, dtype=torch.bfloat16) -> int:
    """The most dynamic shared memory one CTA asks for at a tile.  bf16
    (``csrc`` ``Ring::kBytes``): :data:`STAGES` A ``(bm, bk)`` and B
    ``(bk, bn)`` tiles, their mbarriers and 1 KB to align the tiles to
    the 128-byte swizzle's 1024-byte atom; a 128-row tile at M <= 64
    runs :data:`SMALL_M_STAGES` stages of a 64-row A tile instead, and
    the larger of the two counts.  fp32 (``csrc`` ``Fp32Ring::kBytes``):
    :data:`FP32_STAGES` sub-stages of an A ``(bm, FP32_DEPTH)`` tile, its
    TF32 low parts and a B ``(FP32_DEPTH, bn)`` tile, three mbarriers
    each and the 1 KB.  The fp32 accumulator is in registers on both
    paths."""
    if dtype == torch.bfloat16:
        def ring(rows, stages):
            return stages * (rows * bk + bk * bn) * 2 + 2 * stages * 8
        small = ring(64, SMALL_M_STAGES) if bm == 128 else 0
        return max(ring(bm, STAGES), small) + 1024
    stages = FP32_STAGES[(bm, bk, bn)]
    return stages * ((2 * bm + bn) * FP32_DEPTH * 4 + 3 * 8) + 1024


def fp32_splits(M: int, K: int, N: int, tiles: Sequence[int],
                sms: int) -> int:
    """How many CTAs the fp32 kernel splits one tile's K over on a card
    with ``sms`` SMs: the count (up to :data:`MAX_SPLITS`) that
    minimises the CTA waves times a CTA's sub-stages (plus
    :data:`SPLIT_FILL` for its pipeline fill and epilogue), plus the
    split partials' bytes and the launch that sums them.  One CTA of the
    128-row tile fills an SM (registers, shared memory); two of a 64-row
    tile fit."""
    bm, _, bn = tiles
    subs = -(-K // FP32_DEPTH)
    ctas = -(-M // bm) * -(-N // bn)
    sms *= 1 if bm == 128 else 2
    # one sub-stage of one CTA, s: three TF32 products at the tensor
    # cores' per-SM share of 495 TFLOP/s, at SPLIT_EFFICIENCY of it
    sub_s = 6 * bm * bn * FP32_DEPTH / (495e12 / 132 * SPLIT_EFFICIENCY)

    def cost(s):
        waves = -(-ctas * s // sms)
        partials = 2 * s * M * N * 4 / 3.35e12 + 4e-6 if s > 1 else 0.0
        return waves * (-(-subs // s) + SPLIT_FILL) * sub_s + partials

    return min(range(1, min(MAX_SPLITS, max(subs, 1)) + 1), key=cost)


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


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def tiled_matmul(a: torch.Tensor, b: torch.Tensor, *,
                 tiles: Optional[Sequence[int]] = None,
                 splits: Optional[int] = None) -> torch.Tensor:
    """Launch the tiled matmul kernel on CUDA tensors (raises on any
    other device or on inputs the kernel does not take).  fp32 splits
    each tile's K over ``splits`` CTAs, by default :func:`fp32_splits`'
    count for the shape and the card (a count is passed to test or time
    one); bf16 takes only 1."""
    global launches
    if a.device.type != "cuda":
        raise ValueError(f"tiled_matmul: the kernel runs on CUDA tensors, got "
                         f"{a.device} (kernels.ops routes CPU tensors to the "
                         "plain version)")
    _check(a, b)
    bm, bk, bn = kernel_tiles(tiles)
    M, K = a.shape
    N = b.shape[1]
    fp32 = a.dtype == torch.float32
    if splits is None:
        splits = (fp32_splits(M, K, N, (bm, bk, bn),
                              _sm_count(a.device.index or 0)) if fp32 else 1)
    if not 1 <= splits <= (MAX_SPLITS if fp32 else 1):
        raise ValueError(f"tiled_matmul: splits={splits} in {a.dtype}")
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if M == 0 or N == 0:
        return out
    ws = (torch.empty((splits - 1) * M * N, dtype=torch.float32,
                      device=a.device) if splits > 1 else None)
    err = build.library("tiled_matmul").tiled_matmul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), M, K, N, bm, bk, bn,
        int(fp32), splits, torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"tiled_matmul: launch failed with "
                           f"{build.describe_error(err)}")
    launches += 1
    return out
