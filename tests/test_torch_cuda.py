"""The port's CUDA kernels on the card, against their plain versions.

Every test here but the planted-fault check of the comparison itself
needs an NVIDIA card and skips without one (the kernels have no CPU
mode).  The file imports no JAX, so it also runs where only the port is
installed:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Inputs are bf16, at qwen3-8b's attention widths (32 query heads, 8 kv
heads, head_dim 128) unless a test sweeps the GQA group.  Tolerance:
the worst row's rms |kernel - plain| / rms |plain|, a row being one
head's head_dim outputs for one query, <= 1e-2 for flash and 3e-3 for
decode.  Rows, because the outputs' scale falls ~100x from a one-key
row to a 2048-key row, and one global scale would hide a long row's
fault.  The flash kernel rounds the softmax probabilities to bf16 before
the P·V product (the decode kernels and the plain versions keep them in
fp32) and all round the output to bf16: a few parts in 1e3 of a row at
most, where a dropped or misread tile of a long row is tens of parts in
100 (:func:`test_row_check_rejects_planted_faults`).  Logits of the
small model on the card against the CPU: 2e-2 of their largest
magnitude.

The SSD scan kernel (fp32 in and out) is held the same way: a row is
one (batch, position, head)'s head_dim outputs, and the final state is
held per head, as its (head_dim, state) block; worst rms-relative error
<= 1e-3 for both (the kernel and the plain version sum in other orders,
in fp32).  Its planted faults (the carry into the second chunk dropped;
the final state one chunk short; the kernel's state-passing launch
passing no state) must fail that check by 10x.  The decode kernels'
split-KV merge is held at split edges, for repeatability (bitwise-equal
repeated launches, counters back at zero), and against a planted split
dropped from the merge.

The flash backward (dq, dk, dv) is held per gradient row at 2e-2,
rms-relative, each row measured against at least 5% of its tensor's rms
(the first query's dq is exactly 0, so its own scale is two fp32 sums'
noise); its planted faults (a q tile dropped from the dK/dV loop, one
head of the group summed) must fail that check by 5x, and repeated
launches are bitwise equal (no atomics).  One train step of the small
model on the card is held against the CPU: loss, grad norm and every
leaf's gradient within 2e-2.

The SSD scan's backward (dx, ddt, dA, dB, dC and the initial state's
gradient) is held per gradient row against the plain backward in fp64 at
the forward's 1e-3, floored as the flash backward's rows are; its planted
faults (the key side's diagonal query tile left out; no
gradient passed between chunks) must fail that check by 5x, repeated
launches are bitwise equal, and one train step of reduced mamba2, hymba
and granite on the card is held against the CPU (loss and grad norm
within 2e-2, one forward and one backward launch a layer).

The tiled matmul (bf16 products on the tensor cores; fp32 as 3xTF32
products there) is held per output row, rms-relative, at the JAX tests'
tolerances: 2e-2 in bf16 (both sides sum exact bf16 products in fp32 and
round once to bf16) and 1e-5 in fp32 (the split products miss fp32's by
~2^-22 of each term, and the sums run in another order).  fp32 is also
held against an fp64 product, at every tile and at mamba2's out_proj
shape, where ``torch.matmul`` with TF32 on must fail the same check, and
a repeated call is bitwise equal.  Its planted faults (the last K tile
dropped; two N tiles swapped) must fail that check by 5x.
"""

import dataclasses
import time

import pytest
import torch

import repro_torch.kernels.decode_attention as tdec
import repro_torch.kernels.flash_attention as tfa
import repro_torch.kernels.ssd_scan as tssd
import repro_torch.kernels.tiled_matmul as tmm
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.core import specialize
from repro_torch.core.passes.lowering import build_run_cfg
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import lm
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.prefix_cache import chain_hashes

FLASH_TOL = 1e-2            # worst row, rms-relative (see above)
DECODE_TOL = 3e-3
LOGIT_TOL = 2e-2
SSD_TOL = 1e-3              # worst row / head, rms-relative, fp32
MM_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}    # worst output row
H, K, D = 32, 8, 128


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in fp32
    return torch.device("cuda")


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst row's rms-relative error (a row: one head, one query)."""
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    e = (got - want).reshape(-1, got.shape[-1])
    w = want.reshape(-1, want.shape[-1])
    return float((e.pow(2).mean(1).sqrt()
                  / w.pow(2).mean(1).sqrt().clamp_min(1e-6)).max())


def _rnd(gen, *shape):
    return torch.randn(shape, generator=gen, device=gen.device).to(
        torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [64, 130, 1000, 2048])
@pytest.mark.parametrize("window", [0, 300])
@pytest.mark.parametrize("tiles", [None, (16, 64), (16, 128), (32, 64)])
def test_flash_kernel_matches_plain(dev, S, window, tiles):
    g = torch.Generator(dev).manual_seed(S + window)
    q, k, v = _rnd(g, 2, S, H, D), _rnd(g, 2, S, K, D), _rnd(g, 2, S, K, D)
    bq, bkv = tiles or (None, None)
    got = tfa.flash_attention(q, k, v, causal=True, window=window,
                              block_q=bq, block_kv=bkv)
    want = tfa.flash_attention_plain(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert _rel_err(got, want) < FLASH_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("heads,kv", [(8, 8), (8, 4), (16, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_gqa_groups(dev, heads, kv, causal):
    g = torch.Generator(dev).manual_seed(heads * kv)
    S = 200
    q, k, v = (_rnd(g, 1, S, heads, D), _rnd(g, 1, S, kv, D),
               _rnd(g, 1, S, kv, D))
    got = tfa.flash_attention(q, k, v, causal=causal)
    want = tfa.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _rel_err(got, want) < FLASH_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", [65, 1000, 2048])
@pytest.mark.parametrize("rows,block_kv", tfa.KERNEL_TILES)
def test_flash_kernel_at_head_dim_80(dev, causal, S, rows, block_kv):
    """hubert-xlarge's head_dim 80 (16 / 16 heads; rows padded to 128
    columns in shared memory, 80 written back) at every tile, non-causal
    and causal, ragged S; a head's columns past 80 would show as a wrong
    row."""
    g = torch.Generator(dev).manual_seed(S + rows + block_kv + causal)
    q, k, v = (_rnd(g, 1, S, 16, 80), _rnd(g, 1, S, 16, 80),
               _rnd(g, 1, S, 16, 80))
    got = tfa.flash_attention(q, k, v, causal=causal, block_q=rows,
                              block_kv=block_kv)
    want = tfa.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert _rel_err(got, want) < FLASH_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("rows,block_kv", tfa.KERNEL_TILES)
def test_flash_kernel_every_tile_at_every_gqa_group(dev, G, rows, block_kv):
    """Each tile the kernel is built for at G = 1, 2, 4 and 8 query heads
    per kv head (rows = block_q * G), ragged S."""
    g = torch.Generator(dev).manual_seed(G * rows + block_kv)
    S, kv = 300, 2
    q, k, v = (_rnd(g, 2, S, G * kv, D), _rnd(g, 2, S, kv, D),
               _rnd(g, 2, S, kv, D))
    got = tfa.flash_attention(q, k, v, causal=True, block_q=rows // G,
                              block_kv=block_kv)
    want = tfa.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert _rel_err(got, want) < FLASH_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 63, 65, 1000, 2048])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_ragged_lengths(dev, S, causal):
    """Batch 3 at lengths around and past the 64- and 128-row tiles: rows
    past S are zero-filled on load and never written."""
    g = torch.Generator(dev).manual_seed(S + causal)
    q, k, v = _rnd(g, 3, S, H, D), _rnd(g, 3, S, K, D), _rnd(g, 3, S, K, D)
    got = tfa.flash_attention(q, k, v, causal=causal)
    want = tfa.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert _rel_err(got, want) < FLASH_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("window", [1, 37, 100, 129, 700])
@pytest.mark.parametrize("tiles", [None, (16, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_window_starting_mid_tile(dev, window, tiles, causal):
    """Windows whose first key falls inside a kv tile, so the first tile a
    CTA loads is masked at its front and the tiles before it are never
    loaded."""
    g = torch.Generator(dev).manual_seed(window)
    S = 1000
    q, k, v = _rnd(g, 2, S, H, D), _rnd(g, 2, S, K, D), _rnd(g, 2, S, K, D)
    bq, bkv = tiles or (None, None)
    got = tfa.flash_attention(q, k, v, causal=causal, window=window,
                              block_q=bq, block_kv=bkv)
    want = tfa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert _rel_err(got, want) < FLASH_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("M,T", [(1024, 256), (1024, 1000), (64, 1),
                                 (300, 77), (2048, 129)])
@pytest.mark.parametrize("window", [0, 300])
@pytest.mark.parametrize("tiles", [None, (16, 64), (32, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_query_block_at_an_offset(dev, M, T, window, tiles,
                                               causal):
    """A tail of T queries at absolute positions M..M+T-1 over M + T keys
    (prefix-reuse prefill): against the plain version of the same call,
    and against the tail rows of the full-length launch, row by row.
    Ragged T, so the q tiles and kv tiles straddle the offset."""
    g = torch.Generator(dev).manual_seed(M + T + window)
    q = _rnd(g, 2, M + T, H, D)
    k, v = _rnd(g, 2, M + T, K, D), _rnd(g, 2, M + T, K, D)
    tail = q[:, M:].contiguous()
    bq, bkv = tiles or (None, None)
    kw = dict(causal=causal, window=window, block_q=bq, block_kv=bkv)
    got = tfa.flash_attention(tail, k, v, **kw)
    full = tfa.flash_attention(q, k, v, **kw)
    want = tfa.flash_attention_plain(tail, k, v, causal=causal,
                                     window=window)
    torch.cuda.synchronize()
    assert got.shape == tail.shape
    assert _rel_err(got, want) < FLASH_TOL
    assert _rel_err(got, full[:, M:]) < FLASH_TOL


# ---------------------------------------------------------------------
# GQA groups of 7 (deepseek-coder-33b: 56 query heads over 8 kv heads)
# ---------------------------------------------------------------------

H7, K7 = 56, 8


def _boundary_rows(S: int, rows: int, G: int) -> torch.Tensor:
    """The query positions at the start of every CTA but the first
    (``q0 + BQ`` of the one before it, where a pad row would land)."""
    return torch.tensor(list(range(rows // G, S, rows // G)),
                        dtype=torch.long)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 18, 19, 300, 1024])
@pytest.mark.parametrize("tiles", [None, (9, 64), (9, 128), (18, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_group_7_matches_plain(dev, S, tiles, causal):
    """G = 7 holds 18 positions in a 128-row tile (9 in 64), two or one
    rows of pad: every row against the plain version, and the rows of
    each CTA's first position (where a pad row written by the CTA before
    would land) on their own."""
    g = torch.Generator(dev).manual_seed(S)
    q, k, v = _rnd(g, 2, S, H7, D), _rnd(g, 2, S, K7, D), _rnd(g, 2, S, K7, D)
    bq, bkv = tiles or (None, None)
    rows, _ = tfa.kernel_tiles(7, bq, bkv)
    got = tfa.flash_attention(q, k, v, causal=causal, block_q=bq,
                              block_kv=bkv)
    want = tfa.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _rel_err(got, want) < FLASH_TOL
    edge = _boundary_rows(S, rows, 7).to(dev)
    if edge.numel():
        assert _rel_err(got[:, edge], want[:, edge]) < FLASH_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("M,T", [(1024, 256), (64, 1), (100, 37)])
def test_flash_kernel_group_7_at_an_offset(dev, M, T):
    """A tail at G = 7 over a resident prefix: against the plain version,
    the full launch's tail rows, and the planted fault (the offset
    ignored) failing the same check."""
    g = torch.Generator(dev).manual_seed(M + T)
    q = _rnd(g, 2, M + T, H7, D)
    k, v = _rnd(g, 2, M + T, K7, D), _rnd(g, 2, M + T, K7, D)
    tail = q[:, M:].contiguous()
    got = tfa.flash_attention(tail, k, v)
    full = tfa.flash_attention(q, k, v)
    want = tfa.flash_attention_plain(tail, k, v)
    bad = tfa.flash_attention(tail, k, v, ignore_offset=True)
    torch.cuda.synchronize()
    assert _rel_err(got, want) < FLASH_TOL
    assert _rel_err(got, full[:, M:]) < FLASH_TOL
    assert _rel_err(bad, want) > 5 * FLASH_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [64, 256])
@pytest.mark.parametrize("window", [0, 100])
def test_decode_kernels_group_7_match_plain(dev, tile, window):
    """Paged and dense decode at G = 7 (the ``decode_kernel<7, 128, *>``
    instances) against their plain versions, beside a planted split
    dropped from the merge that must fail the same check."""
    g = torch.Generator(dev).manual_seed(tile + window)
    bl, B, max_len = 256, 8, 2048
    lens = torch.tensor([1, 64, 300, 777, 1024, 1500, 1999, 2048],
                        dtype=torch.int32, device=dev)
    nb = max_len // bl
    perm = torch.randperm(B * nb, generator=g, device=dev).int()
    tbl = perm.reshape(B, nb).contiguous()
    q = _rnd(g, B, H7, D)
    kp, vp = _rnd(g, B * nb, bl, K7, D), _rnd(g, B * nb, bl, K7, D)
    kd, vd = tref.paged_gather_ref(kp, tbl), tref.paged_gather_ref(vp, tbl)
    kw = dict(cache_len=lens, window=window)
    paged = tdec.paged_decode_attention(q, kp, vp, tbl, block_kv=tile, **kw)
    dense = tdec.decode_attention(q, kd.contiguous(), vd.contiguous(),
                                  block_kv=tile, **kw)
    want = tdec.decode_attention_plain(q, kd, vd, **kw)
    bad = tdec.paged_decode_attention(q, kp, vp, tbl, block_kv=tile,
                                      drop_split=0, **kw)
    torch.cuda.synchronize()
    assert _rel_err(paged, want) < DECODE_TOL
    assert _rel_err(dense, want) < DECODE_TOL
    if window == 0:                    # split 0 holds live rows of every slot
        assert _rel_err(bad, want) > 5 * DECODE_TOL


# ---------------------------------------------------------------------
# hymba-1.5b: GQA groups of 5 at head_dim 64 (25 query heads over 5)
# ---------------------------------------------------------------------

H5, K5, D64 = 25, 5, 64


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 25, 26, 300, 2048])
@pytest.mark.parametrize("tiles", [None, (12, 64), (12, 128), (25, 64)])
@pytest.mark.parametrize("window", [0, 1024])
def test_flash_kernel_group_5_head_dim_64_matches_plain(dev, S, tiles,
                                                        window):
    """``flash_fwd_kernel<64, *, *>`` at G = 5: 25 positions in a 128-row
    tile (12 in 64), three or four rows of pad, causal, whole and with
    hymba's 1024 window: every row against the plain version, the rows
    of each CTA's first position on their own, and the planted faults
    (pad rows written over those positions; the window ignored) failing
    the same check."""
    g = torch.Generator(dev).manual_seed(S + window)
    q = _rnd(g, 2, S, H5, D64)
    k, v = _rnd(g, 2, S, K5, D64), _rnd(g, 2, S, K5, D64)
    bq, bkv = tiles or (None, None)
    rows, _ = tfa.kernel_tiles(5, bq, bkv)
    kw = dict(causal=True, block_q=bq, block_kv=bkv)
    got = tfa.flash_attention(q, k, v, window=window, **kw)
    pad = tfa.flash_attention(q, k, v, window=window, pad_fault=True, **kw)
    want = tfa.flash_attention_plain(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert _rel_err(got, want) < FLASH_TOL
    edge = _boundary_rows(S, rows, 5).to(dev)
    if edge.numel():
        assert _rel_err(got[:, edge], want[:, edge]) < FLASH_TOL
    if edge.numel():
        # the fault's pad rows alone write their heads of each boundary
        # position, so every boundary shows it, whichever CTA runs last
        assert _rel_err(pad[:, edge], want[:, edge]) > 5 * FLASH_TOL
        rest = torch.ones(S, dtype=torch.bool, device=dev)
        rest[edge] = False
        assert _rel_err(pad[:, rest], want[:, rest]) < FLASH_TOL
    if S >= 300 and not window:      # the longest rows' first tile dropped
        dropped = tfa.flash_attention(q, k, v, window=S - 64, **kw)
        assert _rel_err(dropped, want) > 5 * FLASH_TOL
    if window and S > window + rows:
        ignored = tfa.flash_attention(q, k, v, window=0, **kw)
        assert _rel_err(ignored, want) > 5 * FLASH_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("M,T", [(1024, 256), (64, 1), (100, 37),
                                 (1500, 600)])
@pytest.mark.parametrize("window", [0, 1024])
def test_flash_kernel_group_5_at_an_offset(dev, M, T, window):
    """A hymba tail over a resident prefix at G = 5, head_dim 64, whole
    and windowed: against the plain version and the full launch's tail
    rows, with the offset ignored failing the same check."""
    g = torch.Generator(dev).manual_seed(M + T + window)
    q = _rnd(g, 2, M + T, H5, D64)
    k, v = _rnd(g, 2, M + T, K5, D64), _rnd(g, 2, M + T, K5, D64)
    tail = q[:, M:].contiguous()
    got = tfa.flash_attention(tail, k, v, window=window)
    full = tfa.flash_attention(q, k, v, window=window)
    want = tfa.flash_attention_plain(tail, k, v, window=window)
    bad = tfa.flash_attention(tail, k, v, window=window, ignore_offset=True)
    torch.cuda.synchronize()
    assert _rel_err(got, want) < FLASH_TOL
    assert _rel_err(got, full[:, M:]) < FLASH_TOL
    assert _rel_err(bad, want) > 5 * FLASH_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [64, 256])
@pytest.mark.parametrize("window", [0, 1024])
def test_decode_kernels_group_5_head_dim_64_match_plain(dev, tile, window):
    """Paged and dense decode at (G = 5, D = 64), the
    ``decode_kernel<5, 64, *>`` instances, over lengths on both sides of
    hymba's 1024 window, against their plain versions, beside a split
    dropped from the merge and the window ignored, which must fail the
    same check."""
    g = torch.Generator(dev).manual_seed(tile + window + 5)
    bl, B, max_len = 256, 8, 2048
    lens = torch.tensor([1, 64, 300, 1023, 1024, 1025, 1999, 2048],
                        dtype=torch.int32, device=dev)
    nb = max_len // bl
    perm = torch.randperm(B * nb, generator=g, device=dev).int()
    tbl = perm.reshape(B, nb).contiguous()
    q = _rnd(g, B, H5, D64)
    kp, vp = _rnd(g, B * nb, bl, K5, D64), _rnd(g, B * nb, bl, K5, D64)
    kd, vd = tref.paged_gather_ref(kp, tbl), tref.paged_gather_ref(vp, tbl)
    kw = dict(cache_len=lens, window=window)
    paged = tdec.paged_decode_attention(q, kp, vp, tbl, block_kv=tile, **kw)
    dense = tdec.decode_attention(q, kd.contiguous(), vd.contiguous(),
                                  block_kv=tile, **kw)
    want = tdec.decode_attention_plain(q, kd, vd, **kw)
    bad = tdec.paged_decode_attention(q, kp, vp, tbl, block_kv=tile,
                                      drop_split=0, **kw)
    torch.cuda.synchronize()
    assert _rel_err(paged, want) < DECODE_TOL
    assert _rel_err(dense, want) < DECODE_TOL
    if window == 0:                    # split 0 holds live rows of every slot
        assert _rel_err(bad, want) > 5 * DECODE_TOL
    else:
        ignored = tdec.paged_decode_attention(q, kp, vp, tbl, block_kv=tile,
                                              cache_len=lens)
        assert _rel_err(ignored, want) > 5 * DECODE_TOL


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts 2 bytes past a
    16-byte boundary."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    view = buf[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


@pytest.mark.cuda
def test_wrappers_refuse_a_view_that_is_not_16_byte_aligned(dev):
    """TMA reads the operands in place: both wrappers raise on a
    contiguous view whose data is not 16-byte aligned, and launch
    nothing."""
    g = torch.Generator(dev).manual_seed(3)
    q, k = _rnd(g, 1, 64, H, D), _rnd(g, 1, 64, K, D)
    a, b = _mm_inputs(g, 64, 64, 64, torch.bfloat16)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.flash_attention(_misaligned(q), k, k)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.flash_attention(q, k, _misaligned(k))
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.matmul(_misaligned(a), b)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.matmul(a, _misaligned(b))
    assert sum(ops.launch_counts().values()) == 0


def _paged_case(g, bl, B=6, max_len=2048):
    """A pool, tables with -1 tails and one freed slot (row -1, length
    1), per-slot lengths from 1 to ``max_len``."""
    nb = -(-max_len // bl)
    lens = torch.tensor([1, 7, 300, 1000, max_len, 1], dtype=torch.int32,
                        device=g.device)[:B]
    need = [-(-int(n) // bl) for n in lens]
    need[-1] = 0                                       # the freed slot
    N = sum(need) + 3
    perm = torch.randperm(N, generator=g, device=g.device).int()
    tbl = torch.full((B, nb), -1, dtype=torch.int32, device=g.device)
    at = 0
    for b, n in enumerate(need):
        tbl[b, :n] = perm[at:at + n]
        at += n
    q = _rnd(g, B, H, D)
    return q, _rnd(g, N, bl, K, D), _rnd(g, N, bl, K, D), tbl, lens


@pytest.mark.cuda
@pytest.mark.parametrize("bl", [16, 256, 512])
@pytest.mark.parametrize("tile", [64, 128, 256])
@pytest.mark.parametrize("window", [0, 100])
def test_paged_kernel_matches_plain(dev, bl, tile, window):
    g = torch.Generator(dev).manual_seed(bl + tile + window)
    q, kp, vp, tbl, lens = _paged_case(g, bl)
    got = tdec.paged_decode_attention(q, kp, vp, tbl, cache_len=lens,
                                      window=window, block_kv=tile)
    want = tdec.paged_decode_attention_plain(q, kp, vp, tbl, cache_len=lens,
                                             window=window)
    torch.cuda.synchronize()
    assert _rel_err(got, want) < DECODE_TOL
    assert float(got[-1].float().abs().max()) == 0.0   # freed slot: zeros


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [64, 128, 256])
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("kv", [8, 4, 32])              # G = 4, 8, 1
def test_dense_kernel_matches_plain(dev, tile, window, kv):
    g = torch.Generator(dev).manual_seed(tile + window + kv)
    B, S = 5, 2048
    lens = torch.tensor([1, 64, 513, 1999, 2048], dtype=torch.int32,
                        device=dev)
    q, k, v = _rnd(g, B, H, D), _rnd(g, B, S, kv, D), _rnd(g, B, S, kv, D)
    got = tdec.decode_attention(q, k, v, cache_len=lens, window=window,
                                block_kv=tile)
    want = tdec.decode_attention_plain(q, k, v, cache_len=lens,
                                       window=window)
    torch.cuda.synchronize()
    assert _rel_err(got, want) < DECODE_TOL


EDGES = {"len 1, one tile and one past": ([1, 256, 257, 2048], 0),
         "window starting mid-split": ([2048, 1000, 300, 700], 389),
         "-1 entries inside a split": ([2048, 1500, 600, 64], 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("bl", [16, 512])
@pytest.mark.parametrize("case", list(EDGES))
def test_decode_kernels_at_split_edges(dev, bl, case):
    """Both kernels where splits begin and end (tile 256: 256-row
    splits at 4 slots x 8 kv heads): a one-row slot, a slot of exactly
    one split and one a row past it, a window whose start falls inside a
    split, and unassigned blocks inside a slot's live rows (zero rows),
    at the smallest and largest pool block lengths."""
    g = torch.Generator(dev).manual_seed(bl + len(case))
    lens_list, window = EDGES[case]
    B, cap = len(lens_list), 2048
    assert tdec.decode_split(B, K, cap, 256) == (8, 256)
    nb = cap // bl
    tbl = torch.randperm(B * nb, generator=g, device=dev).int().reshape(B, nb)
    if case.startswith("-1"):
        tbl[0, 1] = -1
        tbl[1, nb // 3] = -1
    lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
    q, kp, vp = _rnd(g, B, H, D), _rnd(g, B * nb, bl, K, D), \
        _rnd(g, B * nb, bl, K, D)
    got = tdec.paged_decode_attention(q, kp, vp, tbl, cache_len=lens,
                                      window=window)
    want = tdec.paged_decode_attention_plain(q, kp, vp, tbl, cache_len=lens,
                                             window=window)
    kd, vd = tref.paged_gather_ref(kp, tbl), tref.paged_gather_ref(vp, tbl)
    dense = tdec.decode_attention(q, kd, vd, cache_len=lens, window=window)
    torch.cuda.synchronize()
    assert _rel_err(got, want) < DECODE_TOL
    assert _rel_err(dense, want) < DECODE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [True, False])
def test_decode_back_to_back_launches_are_bitwise_equal(dev, paged):
    """The in-launch merge runs in split order and every launch leaves
    its arrival counters at zero, so repeated launches give the same
    bits (a counter left behind would merge too early, or never)."""
    g = torch.Generator(dev).manual_seed(3)
    q, kp, vp, tbl, lens = _paged_case(g, 256)
    kd, vd = tref.paged_gather_ref(kp, tbl), tref.paged_gather_ref(vp, tbl)

    def run():
        if paged:
            return tdec.paged_decode_attention(q, kp, vp, tbl, cache_len=lens)
        return tdec.decode_attention(q, kd, vd, cache_len=lens)

    outs = [run() for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    assert int(tdec._COUNTERS[q.device].abs().sum()) == 0


@pytest.mark.cuda
def test_wrappers_count_launches_and_refuse_what_the_kernels_do_not_take(dev):
    g = torch.Generator(dev).manual_seed(0)
    ops.reset_launch_counts()
    q, k = _rnd(g, 1, 64, H, D), _rnd(g, 1, 64, K, D)
    ops.flash_attention(q, k, k)
    qd = _rnd(g, 2, H, D)
    kd = _rnd(g, 2, 256, K, D)
    lens = torch.tensor([3, 256], dtype=torch.int32, device=dev)
    ops.decode_attention(qd, kd, kd, cache_len=lens)
    tbl = torch.tensor([[0], [1]], dtype=torch.int32, device=dev)
    ops.paged_decode_attention(qd, kd, kd, tbl, cache_len=lens)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"flash_attention": 1,
                                   "flash_attention_bwd": 0,
                                   "flash_attention_positions": 0,
                                   "flash_attention_bwd_positions": 0,
                                   "paged_decode_attention": 1,
                                   "decode_attention": 1,
                                   "decode_partial": 0,
                                   "paged_decode_partial": 0,
                                   "decode_split_scores": 0,
                                   "decode_split_context": 0, "ssd_scan": 0,
                                   "ssd_scan_bwd": 0, "tiled_matmul": 0}
    with pytest.raises(RuntimeError, match="use_pallas='off'"):
        ops.flash_attention(q, k, k, mode="off")
    with pytest.raises(TypeError, match="bfloat16"):
        ops.flash_attention(q.float(), k.float(), k.float())
    with pytest.raises(ValueError, match="not one of the kernel's tiles"):
        ops.decode_attention(qd, kd, kd, cache_len=lens, block_kv=32)
    with pytest.raises(ValueError, match="not one the kernel is built for"):
        ops.flash_attention(q, k, k, tiles=(128, 128))
    with pytest.raises(ValueError, match="head_dim"):
        tdec.decode_attention(qd[..., :64].contiguous(),
                              kd[..., :64].contiguous(),
                              kd[..., :64].contiguous(), cache_len=lens)
    assert sum(ops.launch_counts().values()) == 3


def _faulted(fault: str, d: torch.device):
    """``(got, want)``: ``ops`` on a planted fault against the plain
    version of the right input.  On the CPU both sides are plain."""
    g = torch.Generator(d).manual_seed(7)
    if fault == "flash tail offset ignored":
        M, T = (256, 100) if d.type == "cpu" else (1024, 1000)
        q = _rnd(g, 2, T, H, D)
        k, v = _rnd(g, 2, M + T, K, D), _rnd(g, 2, M + T, K, D)
        want = tfa.flash_attention_plain(q, k, v)
        if d.type == "cpu":          # queries taken as positions 0..T-1
            return tfa.flash_attention_plain(q, k[:, :T], v[:, :T]), want
        return tfa.flash_attention(q, k, v, ignore_offset=True), want
    if fault == "flash drops one kv tile":
        S = 512 if d.type == "cpu" else 2048
        q, k, v = _rnd(g, 1, S, H, D), _rnd(g, 1, S, K, D), _rnd(g, 1, S, K, D)
        return (ops.flash_attention(q, k, v, window=S - 64),
                tfa.flash_attention_plain(q, k, v))
    q, kp, vp, tbl, lens = _paged_case(g, 256)
    want = tdec.paged_decode_attention_plain(q, kp, vp, tbl, cache_len=lens)
    if fault == "decode split dropped from the merge":
        if d.type == "cpu":          # the plain mirror of the split merge
            _, rows = tdec.decode_split(q.shape[0], K, tbl.shape[1] * 256,
                                        tdec.DEFAULT_BLOCK_KV)
            return tdec.decode_attention_splits(
                q, tref.paged_gather_ref(kp, tbl),
                tref.paged_gather_ref(vp, tbl), cache_len=lens,
                split_rows=rows, drop_split=0), want
        return tdec.paged_decode_attention(q, kp, vp, tbl, cache_len=lens,
                                           drop_split=0), want
    if fault == "paged one table entry swapped":
        bad = tbl.clone()
        bad[4, 0] = tbl[3, 0]
        return (ops.paged_decode_attention(q, kp, vp, bad, cache_len=lens),
                want)
    short = lens.clone()
    short[4] -= 256
    return ops.paged_decode_attention(q, kp, vp, tbl, cache_len=short), want


@pytest.mark.parametrize("fault", ["flash drops one kv tile",
                                   "flash tail offset ignored",
                                   "paged one tile short",
                                   "paged one table entry swapped",
                                   "decode split dropped from the merge"])
@pytest.mark.parametrize("where", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_row_check_rejects_planted_faults(where, fault):
    """The comparison the kernels pass must fail a kernel that drops or
    misreads one tile of the longest row (on the CPU the plain version
    plays the faulty kernel)."""
    if where == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    got, want = _faulted(fault, torch.device(where))
    assert _rel_err(got, want) > 5 * FLASH_TOL


def _card_arch(name: str = "qwen3-8b"):
    """qwen3-8b reduced in depth and width, with its published head_dim
    (the kernels are built for 128); or hymba-1.5b at 3 layers (global,
    windowed, global), 5 / 1 heads of 64 and a 16-token window."""
    if name == "hymba-1.5b":
        return dataclasses.replace(
            get_arch(name), n_layers=3, d_model=128, n_heads=5,
            n_kv_heads=1, head_dim=64, d_ff=256, vocab_size=512, window=16,
            ssm_head_dim=32)
    return dataclasses.replace(get_arch(name).reduced(), head_dim=128)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qwen3-8b", "hymba-1.5b"])
@pytest.mark.parametrize("residency", ["paged", "dense"])
def test_model_on_card_matches_cpu(dev, residency, name):
    """Prefill and four decode steps through the kernels on the card
    against the plain versions on the CPU, same weights: logits within
    2e-2 of the CPU logits' scale (hymba: 100-token prompts past its
    window, its SSM rows beside the paged cache)."""
    arch = _card_arch(name)
    plan = specialize(arch, ShapeConfig("t", "decode", 512, 4),
                      mesh_shape=(1, 1), kv_residency=residency, cache=False)
    cfg = build_run_cfg(plan, arch)
    params_cpu = lm.init_params(arch, torch.Generator().manual_seed(0),
                                *plan.padded_sizes())
    params_gpu = _to(params_cpu, dev)
    toks = torch.randint(0, arch.vocab_size, (4, 100),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    for name, params, d in (("cpu", params_cpu, torch.device("cpu")),
                            ("gpu", params_gpu, dev)):
        ops.reset_launch_counts()
        logits, dense = lm.prefill(arch, params, {"tokens": toks.to(d)}, cfg,
                                   max_len=512)
        steps = [logits]
        cache = dense
        if residency == "paged":
            bl = int(plan.estimates["kv_block_len"])
            cache = lm.init_paged_cache(
                arch, 4, 512, bl, 4 * (512 // bl), device=d,
                **lm.cache_heads(arch, params["blocks"]))
            nb = 512 // bl
            cache["block_tbl"].copy_(torch.arange(4 * nb, device=d,
                                                  dtype=torch.int32
                                                  ).reshape(4, nb))
            for key in ("k", "v", "ssm", "conv"):
                if key in dense:
                    cache[key].copy_(dense[key].reshape(cache[key].shape))
            cache["pos"] = dense["pos"]
        for _ in range(4):
            nxt = steps[-1].float().argmax(-1).to(torch.int32)[:, None]
            if name == "gpu":
                nxt = out["cpu_tokens"][len(steps) - 1]
            logits, cache = lm.decode_step(arch, params, cache,
                                           {"tokens": nxt.to(d)}, cfg)
            steps.append(logits)
            out.setdefault(f"{name}_tokens", []).append(nxt.cpu())
        out[name] = [s.float().cpu() for s in steps]
        if d.type == "cuda":
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            assert counts["flash_attention"] == arch.n_layers
            kernel = ("paged_decode_attention" if residency == "paged"
                      else "decode_attention")
            assert counts[kernel] == 4 * arch.n_layers
            assert counts["ssd_scan"] == arch.n_layers * arch.has_ssm
    for c, gpu in zip(out["cpu"], out["gpu"]):
        assert float((gpu - c).abs().max() / c.abs().max()) < LOGIT_TOL


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ---------------------------------------------------------------------
# prefix reuse and the host tier on the card (chip_smoke.py's
# shared-prefix phase at reduced width)
# ---------------------------------------------------------------------

class _FirstLogits(ServeEngine):
    """Keeps the logits each request's first token was sampled from."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.first, self.rows, self._rids = {}, {}, []

    def _admit_group(self, group, *args):
        # a resumed request's prefill draws no sample
        self._rids = [r.rid for r in group if not r.out_tokens]
        super()._admit_group(group, *args)

    def _ensure_writable(self):
        super()._ensure_writable()
        self._rids = [self.active[s].rid for s in sorted(self.active)]

    def _sample(self, logits, temperatures):
        for rid, row in zip(self._rids, logits.float().cpu()):
            self.first.setdefault(rid, row)
            self.rows.setdefault(rid, []).append(row)
        return super()._sample(logits, temperatures)


@pytest.mark.cuda
def test_shared_prefix_and_spill_promote_on_card(dev):
    """A 64-token system prompt (4 blocks of 16) behind 6 of 8 greedy
    requests, one a ride, on the card with prefix reuse and 16 host
    blocks against a control with both off: fewer prefill calls, a ride,
    the flash kernel launched at an offset, every hit's first-token
    logits within 2e-2 of the control's scale.  Then every cold block
    spills and a resubmitted shared request promotes the system prompt's
    first block back, bitwise; both tiers end whole."""
    arch = _card_arch()
    params = _to(lm.init_params(arch, torch.Generator().manual_seed(0)), dev)
    rng = torch.Generator().manual_seed(5)
    system = torch.randint(0, arch.vocab_size, (64,), generator=rng)

    def tokens(n):
        return torch.randint(0, arch.vocab_size, (n,), generator=rng)

    prompts = [torch.cat([system, tokens(n)]) for n in (20, 37, 16, 50)]
    prompts += [torch.cat([system, tokens(1)]), tokens(40), tokens(23),
                torch.cat([system, tokens(9)])]
    prompts = [p.numpy().astype("int32") for p in prompts]
    runs = {}
    for reuse in (False, True):
        over = ({"kv_prefix_reuse": "on", "kv_host_blocks": 16} if reuse
                else {"kv_prefix_reuse": "off"})
        eng = _FirstLogits(arch, params, lm.RunCfg(), max_batch=4,
                           max_len=256, kv_residency="paged",
                           kv_block_len=16, **over)
        ops.reset_launch_counts()
        eng.submit(prompts[0], max_new_tokens=8)
        for p in prompts[1:]:
            eng.step()
            eng.submit(p, max_new_tokens=8)
        eng.run_until_idle()
        torch.cuda.synchronize()
        runs[reuse] = (eng, tfa.tail_launches)
    (ctl, ctl_tail), (eng, tail) = runs[False], runs[True]
    ps = eng.pressure_stats()
    assert eng.prefill_calls < ctl.prefill_calls
    assert ps["prefix_rides"] >= 1 and ps["prefix_hits"] >= 5, ps
    assert tail > 0 and ctl_tail == 0
    for rid in (1, 2, 3, 4, 7):
        want = ctl.first[rid]
        err = float((eng.first[rid] - want).abs().max() / want.abs().max())
        assert err < LOGIT_TOL, (rid, err)
    # spill every cold block; a hit promotes the system prompt back
    b0 = eng._prefix.match(chain_hashes(prompts[0], 16))[0]
    snap = {k: eng.cache[k][:, b0].cpu() for k in ("k", "v")}
    assert eng.spill_cached() >= 4
    rid = eng.submit(prompts[1], max_new_tokens=3)
    eng.step()
    torch.cuda.synchronize()
    r = next(x for x in eng.active.values() if x.rid == rid)
    for k in ("k", "v"):
        assert torch.equal(eng.cache[k][:, r.blocks[0]].cpu(), snap[k])
    assert eng.pressure_stats()["promotes"] >= 4
    eng.run_until_idle()
    eng.drop_block_cache()
    st = eng.block_stats()
    assert st["free"] == st["total"] and st["host_free"] == st["host_total"]


@pytest.mark.cuda
def test_grant_engine_on_card_matches_cpu(dev):
    """A grant engine at G = 7 (14 query heads over 2 kv heads of 128,
    two layers) on the card against the same engine on the CPU: 4
    requests into a 10-block pool of 16 rows with 16 host blocks, one
    forced preemption at the third tick and the natural ones after it.
    The ladder's counters are equal (they read block counts only), the
    victims park with state and resume by promote from rows staged
    through the pinned buffer on a side stream, the card launches the
    flash and paged decode kernels at G = 7, and greedy tokens are the
    CPU's wherever the CPU's top-2 margin exceeds 2e-2 of its largest
    logit, first-token logits within 2e-2."""
    from repro_torch.serve.engine import PreemptionPolicy

    arch = dataclasses.replace(get_arch("deepseek-coder-33b").reduced(),
                               n_heads=14, n_kv_heads=2, head_dim=128)
    params = lm.init_params(arch, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(11)
    prompts = [torch.randint(0, arch.vocab_size, (n,), generator=gen)
               .numpy().astype("int32") for n in (40, 57, 33, 70)]
    runs = {}
    for d in (torch.device("cpu"), dev):
        eng = _FirstLogits(arch, _to(params, d), lm.RunCfg(), max_batch=4,
                           max_len=128, kv_residency="paged",
                           kv_block_len=16, kv_n_blocks=12,
                           kv_admission="grant", kv_host_blocks=16,
                           preemption=PreemptionPolicy(max_preemptions=8,
                                                       backoff_base_ticks=2))
        ops.reset_launch_counts()
        for p in prompts:
            eng.submit(p, max_new_tokens=24)
        for t in range(400):
            if not (eng.pending or eng.active or eng.preempted):
                break
            if t == 3:
                eng.preempt(max(eng.active.values(),
                                key=lambda r: len(r.out_tokens)).rid)
            eng.step()
        if d.type == "cuda":
            torch.cuda.synchronize()
        runs[d.type] = (eng, ops.launch_counts())
    (cpu, _), (card, counts) = runs["cpu"], runs["cuda"]
    pc, pg = cpu.pressure_stats(), card.pressure_stats()
    for k in ("preemptions", "grant_denials", "spills", "promotes", "shed",
              "parks_with_state", "resumes_by_promote", "prefetch_staged",
              "prefetch_consumed"):
        assert pg[k] == pc[k], (k, pg[k], pc[k])
    assert pg["parks_with_state"] >= 1 and pg["prefetch_consumed"] >= 1
    assert pg["shed"] == 0 and len(card.finished) == 4
    assert counts["flash_attention"] == arch.n_layers * card.prefill_calls
    assert counts["paged_decode_attention"] > 0
    want = {r.rid: r.out_tokens for r in cpu.finished}
    got = {r.rid: r.out_tokens for r in card.finished}
    for rid, w in want.items():
        f = cpu.first[rid]
        assert float((card.first[rid] - f).abs().max()
                     / f.abs().max()) < LOGIT_TOL
        for i, (a, b) in enumerate(zip(got[rid], w)):
            if a != b:
                row = cpu.rows[rid][i]
                top = row.topk(2).values
                assert float((top[0] - top[1]) / row.abs().max()) \
                    <= LOGIT_TOL, (rid, i)
                break
    card.drop_block_cache()
    st = card.block_stats()
    assert st["free"] == st["total"] and st["host_free"] == st["host_total"]


def test_device_check_names_the_group_and_k2():
    """deepseek-coder-33b (G = 7), qwen3-8b, mamba2, minitron-8b,
    hymba-1.5b (G = 5 at head_dim 64), granite-moe-1b-a400m (G = 2 at
    64), llama4-maverick (G = 5 at 128), qwen2-vl-72b (G = 8 at 128) and
    hubert-xlarge (G = 1 at head_dim 80, flash only: an encoder has no
    decode step) are admitted for a CUDA device; a (group, head_dim)
    pair no kernel instance takes — G = 3 at head_dim 128 (the decode
    kernels only: flash takes G = 3, a rank's piece of llama4-maverick's
    padded group), G = 3 at 64, head_dim 80 beside a decode step,
    head_dim 96 — is refused before any weight is built, on any machine,
    naming the kernels."""
    for name in ("deepseek-coder-33b", "qwen3-8b", "mamba2-2.7b",
                 "minitron-8b", "hymba-1.5b", "granite-moe-1b-a400m",
                 "llama4-maverick-400b-a17b", "qwen2-vl-72b",
                 "hubert-xlarge"):
        lm.check_on_device(get_arch(name), "cuda")
    qwen = get_arch("qwen3-8b")
    with pytest.raises(NotImplementedError,
                       match=r"head_dim 128.*decode_attention at "
                             r"\(G, head_dim\) = \(3, 128\)") as refused:
        lm.check_on_device(dataclasses.replace(qwen, n_heads=24), "cuda")
    assert "flash_attention at" not in str(refused.value)
    with pytest.raises(NotImplementedError,
                       match=r"head_dim 64.*decode_attention"):
        lm.check_on_device(dataclasses.replace(qwen, n_heads=24,
                                               head_dim=64), "cuda")
    with pytest.raises(NotImplementedError,
                       match=r"head_dim 80.*decode_attention"):
        lm.check_on_device(dataclasses.replace(qwen, head_dim=80), "cuda")
    hubert = get_arch("hubert-xlarge")
    with pytest.raises(NotImplementedError,
                       match=r"head_dim 96.*flash_attention"):
        lm.check_on_device(dataclasses.replace(hubert, head_dim=96), "cuda")


# ---------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------

def ssd_inputs(gen, B, S, H, P, G, N):
    """Model-like fp32 inputs: x and B/C through SiLU, dt a softplus
    around softplus(-2) (the model's dt_bias), A = -linspace(1, 16, H)."""
    dev = gen.device

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = torch.nn.functional.silu(rnd(B, S, H, P))
    dt = torch.nn.functional.softplus(rnd(B, S, H) - 2.0)
    A = -torch.linspace(1.0, 16.0, H, device=dev)
    Bm = torch.nn.functional.silu(rnd(B, S, G, N))
    Cm = torch.nn.functional.silu(rnd(B, S, G, N))
    return x, dt, A, Bm, Cm


def ssd_err(y, fin, y_want, fin_want):
    """Worst row of y and worst head of the final state, rms-relative."""
    return (_rel_err(y, y_want),
            _rel_err(fin.flatten(-2), fin_want.flatten(-2)))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 7, 300, 1000, 2048])
@pytest.mark.parametrize("chunk", [64, 256])
@pytest.mark.parametrize("P,N,H,G", [(64, 128, 80, 1), (64, 128, 8, 8),
                                     (32, 16, 8, 1), (64, 16, 25, 1)])
def test_ssd_kernel_matches_plain(dev, S, chunk, P, N, H, G):
    g = torch.Generator(dev).manual_seed(S + chunk + P + N + H + G)
    ins = ssd_inputs(g, 2, S, H, P, G, N)
    y, fin = tssd.ssd_scan(*ins, chunk=chunk)
    y_want, fin_want = tssd.ssd_scan_plain(*ins, chunk=chunk)
    torch.cuda.synchronize()
    assert max(ssd_err(y, fin, y_want, fin_want)) < SSD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("heads_block", [1, 2, 8])
def test_ssd_kernel_heads_block_and_initial_state(dev, heads_block):
    g = torch.Generator(dev).manual_seed(heads_block)
    ins = ssd_inputs(g, 2, 500, 8, 32, 1, 16)
    s0 = torch.randn((2, 8, 32, 16), generator=g, device=dev)
    y, fin = tssd.ssd_scan(*ins, chunk=128, heads_block=heads_block,
                           initial_state=s0)
    y_want, fin_want = tssd.ssd_scan_plain(*ins, chunk=128,
                                           initial_state=s0)
    torch.cuda.synchronize()
    assert max(ssd_err(y, fin, y_want, fin_want)) < SSD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("S,chunk", [(50, 64), (100, 256), (700, 256),
                                     (1000, 128), (321, 64)])
@pytest.mark.parametrize("G", [1, 2, 8])
def test_ssd_kernel_chunk_edges_initial_state_and_groups(dev, S, chunk, G):
    """The chunk-parallel passes at S below one chunk and at S not a
    multiple of the chunk (a ragged last chunk, whose state must stop at
    the last live row), from an initial state, with grouped B/C, at
    mamba2-2.7b's (P, N) = (64, 128)."""
    g = torch.Generator(dev).manual_seed(S + chunk + G)
    ins = ssd_inputs(g, 2, S, 8, 64, G, 128)
    s0 = torch.randn((2, 8, 64, 128), generator=g, device=dev)
    y, fin = tssd.ssd_scan(*ins, chunk=chunk, initial_state=s0)
    y_want, fin_want = tssd.ssd_scan_plain(*ins, chunk=chunk,
                                           initial_state=s0)
    torch.cuda.synchronize()
    assert max(ssd_err(y, fin, y_want, fin_want)) < SSD_TOL


@pytest.mark.cuda
def test_ssd_wrapper_refuses_what_the_kernel_does_not_take(dev):
    g = torch.Generator(dev).manual_seed(0)
    x, dt, A, Bm, Cm = ssd_inputs(g, 1, 64, 8, 32, 1, 16)
    ops.reset_launch_counts()
    ops.ssd_scan(x, dt, A, Bm, Cm, chunk=256)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_scan"] == 1
    with pytest.raises(ValueError, match="not one of the kernel's chunks"):
        ops.ssd_scan(x, dt, A, Bm, Cm, chunk=96)
    with pytest.raises(ValueError, match="does not divide"):
        ops.ssd_scan(x, dt, A, Bm, Cm, heads_block=3)
    with pytest.raises(TypeError, match="float32"):
        ops.ssd_scan(x.bfloat16(), dt, A, Bm, Cm)
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A,
                     Bm, Cm)
    with pytest.raises(ValueError, match="head_dim, state"):
        ops.ssd_scan(x[..., :16].contiguous(), dt, A, Bm, Cm)
    with pytest.raises(RuntimeError, match="use_pallas='off'"):
        ops.ssd_scan(x, dt, A, Bm, Cm, mode="off")
    assert ops.launch_counts()["ssd_scan"] == 1


def ssd_faulted(fault: str, d: torch.device, chunk: int = 256):
    """``(got, want)`` for a planted SSD fault, each a tensor whose last
    dim is a row: y rows for the dropped carry, per-head final states
    for the short state.  On the CPU the plain version plays the faulty
    kernel."""
    g = torch.Generator(d).manual_seed(11)
    S, H = 2 * chunk, 16 if d.type == "cpu" else 80
    ins = ssd_inputs(g, 1, S, H, 64, 1, 128 if d.type == "cuda" else 32)
    y_want, fin_want = tssd.ssd_scan_plain(*ins, chunk=chunk)
    if fault == "carry into the second chunk dropped":
        tail = [t[:, chunk:].contiguous() if t.dim() > 1 else t for t in ins]
        y, _ = ops.ssd_scan(*tail, chunk=chunk)
        return y, y_want[:, chunk:]
    if fault == "state not passed between chunks":
        if d.type == "cuda":
            return tssd.ssd_scan(*ins, chunk=chunk, no_carry=True)[0], y_want
        # on the CPU: each chunk scanned alone, from a zero state
        parts = [[t[:, c:c + chunk].contiguous() if t.dim() > 1 else t
                  for t in ins] for c in range(0, S, chunk)]
        return torch.cat([tssd.ssd_scan_plain(*p, chunk=chunk)[0]
                          for p in parts], 1), y_want
    head = [t[:, :S - chunk].contiguous() if t.dim() > 1 else t for t in ins]
    _, fin = ops.ssd_scan(*head, chunk=chunk)
    return fin.flatten(-2), fin_want.flatten(-2)


@pytest.mark.parametrize("fault", ["carry into the second chunk dropped",
                                   "final state one chunk short",
                                   "state not passed between chunks"])
@pytest.mark.parametrize("where", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_ssd_check_rejects_planted_faults(where, fault):
    if where == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    got, want = ssd_faulted(fault, torch.device(where),
                            chunk=64 if where == "cpu" else 256)
    assert _rel_err(got, want) > 10 * SSD_TOL


def _card_ssm_arch():
    return get_arch("mamba2-2.7b").reduced()


@pytest.mark.cuda
def test_ssm_model_on_card_matches_cpu(dev):
    """Reduced mamba2: prefill (ragged, 100 tokens) and four decode
    steps through the SSD kernel on the card against the plain version
    on the CPU, same weights and tokens: logits within 2e-2 of the CPU
    logits' scale; one kernel launch per layer per prefill."""
    arch = _card_ssm_arch()
    plan = specialize(arch, ShapeConfig("t", "decode", 512, 4),
                      mesh_shape=(1, 1), cache=False)
    cfg = build_run_cfg(plan, arch)
    params_cpu = lm.init_params(arch, torch.Generator().manual_seed(0),
                                *plan.padded_sizes())
    toks = torch.randint(0, arch.vocab_size, (4, 105),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    for d in (torch.device("cpu"), dev):
        params = _to(params_cpu, d)
        ops.reset_launch_counts()
        logits, cache = lm.prefill(arch, params,
                                   {"tokens": toks[:, :100].to(d)}, cfg)
        steps = [logits.float().cpu()]
        for i in range(100, 104):
            logits, cache = lm.decode_step(arch, params, cache,
                                           {"tokens": toks[:, i:i + 1].to(d)},
                                           cfg)
            steps.append(logits.float().cpu())
        out[d.type] = torch.stack(steps)
        if d.type == "cuda":
            torch.cuda.synchronize()
            assert ops.launch_counts()["ssd_scan"] == arch.n_layers
    cpu, gpu = out["cpu"], out["cuda"]
    assert float((gpu - cpu).abs().max() / cpu.abs().max()) < LOGIT_TOL


# ---------------------------------------------------------------------
# the plan-driven tiled matmul
# ---------------------------------------------------------------------

def _mm_inputs(gen, M, K, N, dtype):
    return (torch.randn((M, K), generator=gen, device=gen.device).to(dtype),
            torch.randn((K, N), generator=gen, device=gen.device).to(dtype))


def _h100_tiles():
    plan = specialize(get_arch("qwen3-8b"),
                      ShapeConfig("serve_h100", "decode", 2048, 8),
                      mesh_shape=(1, 1), target="h100-sxm", cache=False)
    return ops.matmul_tiles(plan)


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", tmm.KERNEL_TILES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N", [(256, 512, 384), (300, 584, 1000)])
def test_matmul_kernel_matches_plain(dev, tiles, dtype, M, K, N):
    g = torch.Generator(dev).manual_seed(M + K)
    a, b = _mm_inputs(g, M, K, N, dtype)
    got = ops.matmul(a, b, tiles=tiles)
    assert got.dtype == dtype and tuple(got.shape) == (M, N)
    assert _rel_err(got, tmm.tiled_matmul_plain(a, b)) < MM_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N", [(8, 4096, 2048), (1000, 256, 10576),
                                   (1, 64, 8), (130, 8, 136), (4, 0, 64)])
def test_matmul_kernel_ragged_shapes(dev, dtype, M, K, N):
    """A decode tick's M = 8, a ragged prefill bucket, mamba2's in_proj
    width, one row, and an empty K, on the H100 plan's tile."""
    g = torch.Generator(dev).manual_seed(M + N)
    a, b = _mm_inputs(g, M, K, N, dtype)
    got = ops.matmul(a, b, tiles=_h100_tiles())
    want = tmm.tiled_matmul_plain(a, b)
    if K == 0:
        assert torch.equal(got, want)
    else:
        assert _rel_err(got, want) < MM_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", tmm.KERNEL_TILES)
@pytest.mark.parametrize("M", [1, 8, 1000])
def test_matmul_kernel_at_mamba2_in_proj_width(dev, tiles, M):
    """N = 10576 (mamba2-2.7b's in_proj, not a multiple of any bn) at one
    row, a decode tick's 8 rows and a ragged 1000-token prefill."""
    g = torch.Generator(dev).manual_seed(M)
    a, b = _mm_inputs(g, M, 2560, 10576, torch.bfloat16)
    got = ops.matmul(a, b, tiles=tiles)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (M, 10576)
    assert _rel_err(got, tmm.tiled_matmul_plain(a, b)) < \
        MM_TOL[torch.bfloat16]


def _rel_err64(got: torch.Tensor, want: torch.Tensor) -> float:
    """The larger of the worst row's rms-relative error and max |error| /
    max |want|, in fp64."""
    e = got.double() - want.double()
    w = want.double()
    return max(float((e.pow(2).mean(1).sqrt()
                      / w.pow(2).mean(1).sqrt().clamp_min(1e-30)).max()),
               float(e.abs().max() / w.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", tmm.KERNEL_TILES)
@pytest.mark.parametrize("M,K,N", [(1, 64, 8), (130, 8, 136), (4, 0, 64),
                                   (300, 584, 1000), (37, 4100, 72)])
def test_matmul_fp32_every_tile_against_fp64(dev, tiles, M, K, N):
    """fp32 (3xTF32) at each tile on ragged shapes: one row, K = 8, an
    empty K (zeros), K not a multiple of the 32-deep sub-stage; against
    the fp32 plain version and an fp64 product at 1e-5, at every K split
    count."""
    g = torch.Generator(dev).manual_seed(M * 3 + K)
    a, b = _mm_inputs(g, M, K, N, torch.float32)
    for splits in range(1, tmm.MAX_SPLITS + 1):
        got = tmm.tiled_matmul(a, b, tiles=tiles, splits=splits)
        if K == 0:
            assert torch.equal(got, torch.zeros_like(got))
            continue
        assert _rel_err(got, tmm.tiled_matmul_plain(a, b)) < \
            MM_TOL[torch.float32]
        assert _rel_err64(got, a.double() @ b.double()) < \
            MM_TOL[torch.float32]


@pytest.mark.cuda
def test_matmul_fp32_out_proj_shape_fp64_repeat_and_tf32_control(dev):
    """mamba2's fp32 y @ out_proj on a 1000-token prefill, on the H100
    plan's tile: within 1e-5 of fp64, bitwise equal when repeated; the
    same check fails ``torch.matmul`` with TF32 on."""
    g = torch.Generator(dev).manual_seed(5120)
    a, b = _mm_inputs(g, 1000, 5120, 2560, torch.float32)
    want = a.double() @ b.double()
    got = ops.matmul(a, b, tiles=_h100_tiles())
    assert _rel_err64(got, want) < MM_TOL[torch.float32]
    assert torch.equal(got, ops.matmul(a, b, tiles=_h100_tiles()))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert _rel_err64(tf32, want) > 5 * MM_TOL[torch.float32]


@pytest.mark.cuda
def test_matmul_wrapper_counts_launches_and_refuses_what_it_does_not_take(dev):
    g = torch.Generator(dev).manual_seed(0)
    ops.reset_launch_counts()
    a, b = _mm_inputs(g, 64, 64, 64, torch.bfloat16)
    ops.matmul(a, b)
    torch.cuda.synchronize()
    assert ops.launch_counts()["tiled_matmul"] == 1
    with pytest.raises(RuntimeError, match="use_pallas='off'"):
        ops.matmul(a, b, mode="off")
    with pytest.raises(TypeError, match="both bfloat16 or both float32"):
        ops.matmul(a, b.float())
    with pytest.raises(TypeError, match="both bfloat16 or both float32"):
        ops.matmul(a.half(), b.half())
    with pytest.raises(ValueError, match="not contiguous"):
        ops.matmul(a, b.t())
    with pytest.raises(ValueError, match="multiples of 8"):
        ops.matmul(a[:, :60].contiguous(), b[:60].contiguous())
    with pytest.raises(ValueError, match="not one the kernel is built for"):
        ops.matmul(a, b, tiles=(128, 128, 128))
    with pytest.raises(ValueError, match="splits=2"):
        tmm.tiled_matmul(a, b, splits=2)
    with pytest.raises(ValueError, match="splits=0"):
        tmm.tiled_matmul(a.float(), b.float(), splits=0)
    assert ops.launch_counts()["tiled_matmul"] == 1


def mm_faulted(fault: str, d: torch.device):
    """``(got, want)`` for a planted matmul fault, on the H100 plan's
    tile: the kernel run without the last K tile, or on B with its first
    two N tiles swapped, against the plain product of the right inputs.
    On the CPU the plain version plays the faulty kernel."""
    g = torch.Generator(d).manual_seed(13)
    M, K, N = (64, 512, 1024) if d.type == "cpu" else (1000, 2560, 10576)
    a, b = _mm_inputs(g, M, K, N, torch.bfloat16)
    tiles = tmm.DEFAULT_TILES
    bk, bn = tiles[1], tiles[2]
    want = tmm.tiled_matmul_plain(a, b)
    if fault == "last K tile dropped":
        return ops.matmul(a[:, :K - bk].contiguous(), b[:K - bk].contiguous(),
                          tiles=tiles), want
    idx = torch.arange(N, device=d)
    idx[:2 * bn] = idx[:2 * bn].roll(bn)
    return ops.matmul(a, b[:, idx].contiguous(), tiles=tiles), want


@pytest.mark.parametrize("fault", ["last K tile dropped", "two N tiles swapped"])
@pytest.mark.parametrize("where", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_matmul_check_rejects_planted_faults(where, fault):
    if where == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    got, want = mm_faulted(fault, torch.device(where))
    assert _rel_err(got, want) > 5 * MM_TOL[torch.bfloat16]


# ---------------------------------------------------------------------
# the MoE slice: decode at (G = 2, head_dim 64) for granite-moe-1b-a400m
# and (G = 5, head_dim 128) for llama4-maverick; the MoE layer on the card
# ---------------------------------------------------------------------

MOE_PAIRS = {"granite": (16, 8, 64), "llama4": (40, 8, 128)}
#: the decode pairs held below: the MoE archs' and qwen2-vl-72b's (G = 8
#: at 128, ``decode_kernel<8, 128, *>``)
DECODE_PAIRS = {**MOE_PAIRS, "qwen2vl": (64, 8, 128)}


@pytest.mark.cuda
@pytest.mark.parametrize("pair", sorted(DECODE_PAIRS))
@pytest.mark.parametrize("tile", [64, 256])
def test_decode_kernels_at_the_moe_pairs_match_plain(dev, pair, tile):
    """Paged and dense decode at granite's 16 / 8 heads of 64 and
    llama4's 40 / 8 heads of 128 (the ``decode_kernel<2, 64, *>`` and
    ``<5, 128, *>`` instances) against their plain versions, beside a
    split dropped from the merge and a swapped table entry, which must
    fail the same check; and at qwen2-vl's 64 / 8 heads of 128."""
    Hq, Kv, Dh = DECODE_PAIRS[pair]
    g = torch.Generator(dev).manual_seed(tile + Dh)
    bl, B, max_len = 256, 8, 2048
    lens = torch.tensor([1, 64, 300, 777, 1024, 1500, 1999, 2048],
                        dtype=torch.int32, device=dev)
    nb = max_len // bl
    tbl = torch.randperm(B * nb, generator=g, device=dev).int().reshape(
        B, nb).contiguous()
    q = _rnd(g, B, Hq, Dh)
    kp, vp = _rnd(g, B * nb, bl, Kv, Dh), _rnd(g, B * nb, bl, Kv, Dh)
    kd, vd = tref.paged_gather_ref(kp, tbl), tref.paged_gather_ref(vp, tbl)
    kw = dict(cache_len=lens)
    paged = tdec.paged_decode_attention(q, kp, vp, tbl, block_kv=tile, **kw)
    dense = tdec.decode_attention(q, kd.contiguous(), vd.contiguous(),
                                  block_kv=tile, **kw)
    want = tdec.decode_attention_plain(q, kd, vd, **kw)
    swapped = tbl.clone()
    swapped[-1, 0] = tbl[-2, 0]
    faults = [tdec.paged_decode_attention(q, kp, vp, tbl, block_kv=tile,
                                          drop_split=0, **kw),
              tdec.decode_attention(q, kd.contiguous(), vd.contiguous(),
                                    block_kv=tile, drop_split=0, **kw),
              tdec.paged_decode_attention(q, kp, vp, swapped, block_kv=tile,
                                          **kw)]
    torch.cuda.synchronize()
    assert _rel_err(paged, want) < DECODE_TOL
    assert _rel_err(dense, want) < DECODE_TOL
    for bad in faults:
        assert _rel_err(bad, want) > 5 * DECODE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("pair", sorted(MOE_PAIRS))
@pytest.mark.parametrize("S", [1, 64, 300, 1024])
def test_flash_kernel_at_the_moe_pairs_matches_plain(dev, pair, S):
    """Causal flash at granite's (2, 64) and llama4's (5, 128), whole
    (64 and 25 positions in a 128-row tile), against the plain version,
    the rows of each CTA's first position on their own, with the planted
    faults failing the same check: at G = 5 the pad rows written over
    those positions (G = 2 fills its tile and has no pad row), at both
    the longest rows' first kv tile dropped."""
    Hq, Kv, Dh = MOE_PAIRS[pair]
    G = Hq // Kv
    g = torch.Generator(dev).manual_seed(S + Dh)
    q = _rnd(g, 2, S, Hq, Dh)
    k, v = _rnd(g, 2, S, Kv, Dh), _rnd(g, 2, S, Kv, Dh)
    rows, _ = tfa.kernel_tiles(G)
    got = tfa.flash_attention(q, k, v, causal=True)
    pad = tfa.flash_attention(q, k, v, causal=True, pad_fault=True)
    want = tfa.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert _rel_err(got, want) < FLASH_TOL
    edge = _boundary_rows(S, rows, G).to(dev)
    if edge.numel():
        assert _rel_err(got[:, edge], want[:, edge]) < FLASH_TOL
    if edge.numel() and rows % G:    # G = 5: three pad rows a CTA
        assert _rel_err(pad[:, edge], want[:, edge]) > 5 * FLASH_TOL
    if S >= 300:
        dropped = tfa.flash_attention(q, k, v, causal=True, window=S - 64)
        assert _rel_err(dropped, want) > 5 * FLASH_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("pair", sorted(MOE_PAIRS))
@pytest.mark.parametrize("M,T", [(1024, 256), (64, 1), (100, 37)])
def test_flash_kernel_at_the_moe_pairs_at_an_offset(dev, pair, M, T):
    """A tail over a resident prefix at both MoE pairs: against the
    plain version and the full launch's tail rows, with the offset
    ignored failing the same check."""
    Hq, Kv, Dh = MOE_PAIRS[pair]
    g = torch.Generator(dev).manual_seed(M + T + Dh)
    q = _rnd(g, 2, M + T, Hq, Dh)
    k, v = _rnd(g, 2, M + T, Kv, Dh), _rnd(g, 2, M + T, Kv, Dh)
    tail = q[:, M:].contiguous()
    got = tfa.flash_attention(tail, k, v)
    full = tfa.flash_attention(q, k, v)
    want = tfa.flash_attention_plain(tail, k, v)
    bad = tfa.flash_attention(tail, k, v, ignore_offset=True)
    torch.cuda.synchronize()
    assert _rel_err(got, want) < FLASH_TOL
    assert _rel_err(got, full[:, M:]) < FLASH_TOL
    assert _rel_err(bad, want) > 5 * FLASH_TOL


def _moe_card_arch(name: str):
    """The reduced MoE arch at a pair the card's kernels take: granite
    (8 experts top-2, one MoE FFN a layer) with its head_dim 64 and G =
    2; llama4 (two [dense, MoE] super-blocks, 8 experts top-1, a shared
    expert) with its head_dim 128 and G = 5."""
    arch = get_arch(name).reduced()
    if name.startswith("llama4"):
        return dataclasses.replace(arch, n_heads=10, n_kv_heads=2,
                                   head_dim=128)
    return dataclasses.replace(arch, head_dim=64)


def _top_gap(x, router, k) -> float:
    """The smallest gap between consecutive ones of each token's top
    ``k + 1`` router probabilities (fp32 on the CPU): a routing decision
    is defined only where it is not within 1e-6."""
    probs = torch.softmax(x.double() @ router.double(), -1).float()
    top = probs.topk(min(k + 1, probs.shape[-1]), -1).values
    return float((top[..., :-1] - top[..., 1:]).min())


@pytest.mark.cuda
@pytest.mark.parametrize("name,impl", [
    ("granite-moe-1b-a400m", "gshard_einsum"),
    ("granite-moe-1b-a400m", "dense_einsum"),
    ("llama4-maverick-400b-a17b", "gshard_einsum")])
def test_moe_model_on_card_matches_cpu(dev, name, impl, monkeypatch):
    """Prefill and four paged decode steps of a reduced MoE model through
    the kernels on the card against the plain versions on the CPU, same
    weights: logits within 2e-2 of the CPU logits' scale; and every
    ``route`` call's inputs from the CPU run routed again on the card:
    ``dispatch`` (the integer slots) identical wherever no top
    probability is within 1e-6 of the next."""
    from repro_torch.models import moe

    arch = _moe_card_arch(name)
    plan = specialize(arch, ShapeConfig("t", "decode", 512, 4),
                      mesh_shape=(1, 1), cache=False)
    cfg = dataclasses.replace(build_run_cfg(plan, arch), moe_impl=impl)
    params_cpu = lm.init_params(arch, torch.Generator().manual_seed(0),
                                *plan.padded_sizes())
    calls = []
    route = moe.route

    def recording(x, router_w, top_k, capacity, **kw):
        if x.device.type == "cpu":
            calls.append((x, router_w, top_k, capacity))
        return route(x, router_w, top_k, capacity, **kw)

    monkeypatch.setattr(moe, "route", recording)
    toks = torch.randint(0, arch.vocab_size, (4, 100),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    for d in (torch.device("cpu"), dev):
        params = _to(params_cpu, d)
        ops.reset_launch_counts()
        logits, cache = lm.prefill(arch, params, {"tokens": toks.to(d)}, cfg,
                                   max_len=512)
        bl = int(plan.estimates["kv_block_len"])
        nb = 512 // bl
        cache = dict(cache, k=cache["k"].reshape(arch.n_layers, 4 * nb, bl,
                                                 *cache["k"].shape[3:]),
                     v=cache["v"].reshape(arch.n_layers, 4 * nb, bl,
                                          *cache["v"].shape[3:]),
                     block_tbl=torch.arange(4 * nb, dtype=torch.int32,
                                            device=d).reshape(4, nb))
        steps = [logits.float().cpu()]
        for i in range(4):
            logits, cache = lm.decode_step(
                arch, params, cache, {"tokens": toks[:, i:i + 1].to(d)}, cfg)
            steps.append(logits.float().cpu())
        out[d.type] = steps
        if d.type == "cuda":
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            assert counts["flash_attention"] == arch.n_layers
            assert counts["paged_decode_attention"] == 4 * arch.n_layers
    for c, gpu in zip(out["cpu"], out["cuda"]):
        assert float((gpu - c).abs().max() / c.abs().max()) < LOGIT_TOL
    assert bool(calls) == (impl == "gshard_einsum")
    compared = 0
    for x, router_w, top_k, capacity in calls:
        if _top_gap(x, router_w, top_k) <= 1e-6:
            continue
        want = route(x, router_w, top_k, capacity)[0]
        got = route(x.to(dev), router_w.to(dev), top_k, capacity)[0]
        assert torch.equal(got.cpu(), want)
        compared += 1
    assert compared >= len(calls) // 2


# ---------------------------------------------------------------------
# the flash backward and training
# ---------------------------------------------------------------------

BWD_TOL = 2e-2              # worst gradient row, rms-relative, floored:
GRAD_FLOOR = 0.05           # a row is measured against at least this share
                            # of its tensor's rms (the first query's dq is 0)


def _grad_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    e = (got - want).reshape(-1, got.shape[-1])
    w = want.reshape(-1, want.shape[-1])
    floor = GRAD_FLOOR * float(w.pow(2).mean().sqrt())
    return float((e.pow(2).mean(1).sqrt()
                  / w.pow(2).mean(1).sqrt().clamp_min(floor)).max())


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def _bwd_case(dev, seed, B, S, Hq, Kv, Dh, causal, window):
    g = torch.Generator(dev).manual_seed(seed)
    q, k, v = _rnd(g, B, S, Hq, Dh), _rnd(g, B, S, Kv, Dh), \
        _rnd(g, B, S, Kv, Dh)
    do = _rnd(g, B, S, Hq, Dh)
    o, lse = tfa.flash_attention(q, k, v, causal=causal, window=window,
                                 return_lse=True)
    return q, k, v, o, lse, do


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Hq,Kv,Dh,causal,window", [
    (1, 2048, H, K, D, True, 0),           # the train shape
    (2, 1000, H, K, D, True, 0),           # ragged S
    (1, 700, H, K, D, False, 0),
    (1, 1100, 25, 5, 64, True, 1024),      # hymba: G = 5 at 64, a window
    (2, 333, 56, 8, 128, True, 100),       # G = 7
    (1, 130, 8, 8, 64, True, 0),           # G = 1
    (1, 2048, 16, 8, 64, True, 0),         # granite: G = 2 at 64
    (1, 777, 40, 8, 128, True, 0),         # G = 5 at 128; S ragged in
                                           # every tile (64 keys, 12 / 25 q)
    (1, 2048, 64, 8, 128, True, 0),        # qwen2-vl: G = 8 at 128
    (1, 2048, 16, 16, 80, False, 0),       # hubert: head_dim 80, non-causal
    (2, 333, 8, 4, 80, True, 0),           # head_dim 80 causal, ragged
])
def test_flash_bwd_kernel_matches_plain(dev, B, S, Hq, Kv, Dh, causal,
                                        window):
    q, k, v, o, lse, do = _bwd_case(dev, S + Hq, B, S, Hq, Kv, Dh, causal,
                                    window)
    _, lse_plain = tfa.flash_attention_plain(q, k, v, causal=causal,
                                             window=window, return_lse=True)
    assert float((lse - lse_plain).abs().max()) < 1e-3
    want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         window=window)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                  window=window)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _grad_rel_err(a, b) <= BWD_TOL
    again = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                    window=window)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["drop_tile", "group_fault"])
def test_flash_bwd_check_rejects_planted_faults(dev, fault):
    q, k, v, o, lse, do = _bwd_case(dev, 3, 1, 1024, H, K, D, True, 0)
    want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    bad = tfa.flash_attention_bwd(q, k, v, o, lse, do, **{fault: True})
    assert min(_grad_rel_err(a, b) for a, b in zip(bad[1:], want[1:])) \
        > 5 * BWD_TOL


@pytest.mark.cuda
def test_flash_autograd_counts_and_refuses_plain_on_card(dev):
    q, k, v, _, _, do = _bwd_case(dev, 5, 1, 256, H, K, D, True, 0)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.reset_launch_counts()
    out = ops.flash_attention(*leaves)
    torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 1
    assert counts["flash_attention_bwd"] == 1
    with pytest.raises(RuntimeError, match="use_pallas='off'"):
        ops.flash_attention(*leaves, mode="off")


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(dev, tmp_path):
    """One train step of the small qwen3 (head_dim 128) through the
    kernels on the card against the plain versions on the CPU, from the
    same init and batch: loss, grad norm and every leaf's gradient
    within 2e-2, one flash forward and one backward call a layer."""
    from repro_torch.optim import adamw
    from repro_torch.train import Trainer, TrainerConfig
    arch = _card_arch()
    shape = ShapeConfig("t", "train", 256, 2)
    plan = specialize(arch, shape, mesh_shape=(1, 1), cache=False)
    runs = {}
    init = None
    for d in (torch.device("cpu"), dev):
        tr = Trainer(plan, None, TrainerConfig(
            n_steps=1, ckpt_every=0, ckpt_dir=str(tmp_path / d.type)),
            arch=arch, shape=shape, device=d)
        if init is None:
            init = tr.init_state(0)
        ops.reset_launch_counts()
        state, _ = tr.fit(_clone(init))     # fit updates in place
        runs[d.type] = (tr.history[0], state, ops.launch_counts())
    (hc, sc, _), (hg, sg, counts) = runs["cpu"], runs["cuda"]
    assert counts["flash_attention"] == arch.n_layers
    assert counts["flash_attention_bwd"] == arch.n_layers
    for key in ("loss", "grad_norm"):
        assert abs(hg[key] - hc[key]) <= 2e-2 * abs(hc[key])
    # the first moment after one step is (1 - b1) g: the gradients, leaf
    # by leaf (the parameters after Adam's first step are lr * g / |g|,
    # whose sign flips where g is near 0, so they are no measure)
    for a, b in zip(adamw.leaves(sg["opt"]["m"]), adamw.leaves(sc["opt"]["m"])):
        a, b = a.float().cpu(), b.float()
        assert float((a - b).abs().max()) <= 2e-2 * float(b.abs().max())


def _ssd_bwd_case(dev, seed, B, S, H, P, N, G, chunk, ends):
    """The forward kernel's y, final state and chunk states on seeded
    inputs, with gradients of y and (``ends``) of the final state and an
    initial state."""
    g = torch.Generator(dev).manual_seed(seed)
    ins = ssd_inputs(g, B, S, H, P, G, N)
    s0 = torch.randn((B, H, P, N), generator=g, device=dev) if ends else None
    dy = torch.randn((B, S, H, P), generator=g, device=dev)
    dfin = torch.randn((B, H, P, N), generator=g, device=dev) if ends \
        else None
    y, fin, states = tssd.ssd_scan(*ins, chunk=chunk, initial_state=s0,
                                   return_states=True)
    return ins, s0, dy, dfin, y, fin, states


def _ssd_bwd_want(ins, s0, dy, dfin, chunk):
    """The plain backward in fp64 on the fp64 forward."""
    def f64(t):
        return None if t is None else t.double()
    y, fin, states = tssd.ssd_scan_plain(*map(f64, ins), chunk=chunk,
                                         initial_state=f64(s0),
                                         return_states=True)
    return tssd.ssd_scan_bwd_plain(*map(f64, ins), y, states, fin, f64(dy),
                                   f64(dfin), chunk=chunk,
                                   initial_grad=s0 is not None)


def _ssd_grad_err(got, want) -> float:
    """The worst row of any gradient (dA as one row), floored as the
    flash backward's rows are."""
    return max(_grad_rel_err(a.reshape(-1, a.shape[-1]) if a.dim() > 1
                             else a[None], b.reshape(-1, b.shape[-1])
                             if b.dim() > 1 else b[None])
               for a, b in zip(got, want) if b is not None)


@pytest.mark.cuda
@pytest.mark.parametrize("S,chunk", [(2048, 256), (1000, 128), (321, 64),
                                     (50, 64), (898, 256), (193, 128)])
@pytest.mark.parametrize("P,N,H,G,ends", [(64, 128, 8, 1, False),
                                          (32, 16, 8, 2, True),
                                          (64, 16, 10, 1, True)])
def test_ssd_bwd_kernel_matches_plain(dev, S, chunk, P, N, H, G, ends):
    """Every gradient of the SSD backward kernel (x, dt, A, B, C and, with
    an initial state, its gradient; from a gradient of the final state
    or none) against the plain backward in fp64, row by row at the
    forward's 1e-3: ragged S, one chunk or many, grouped B/C, each
    (head_dim, state) the kernel is built for, and last chunks where a
    CTA's second key tile is partial or empty (898 at chunk 256: tile 2
    holds 2 rows, tile 3 none; 193 at 128: tile 1 holds one row);
    repeated launches are bitwise equal (no atomics)."""
    ins, s0, dy, dfin, y, fin, states = _ssd_bwd_case(
        dev, S + chunk + P + N, 2, S, H, P, N, G, chunk, ends)
    want = _ssd_bwd_want(ins, s0, dy, dfin, chunk)
    got = tssd.ssd_scan_bwd(*ins, y, states, fin, dy, dfin, chunk=chunk,
                            initial_grad=ends)
    again = tssd.ssd_scan_bwd(*ins, y, states, fin, dy, dfin, chunk=chunk,
                              initial_grad=ends)
    torch.cuda.synchronize()
    assert (got[-1] is not None) == ends
    assert _ssd_grad_err(got, want) <= SSD_TOL
    assert all(a is None and b is None or torch.equal(a, b)
               for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("H,N", [(8, 128), (10, 16)])
@pytest.mark.parametrize("fault", ["skip_tile", "no_carry"])
def test_ssd_bwd_check_rejects_planted_faults(dev, fault, H, N):
    """Each planted fault fails the row check at mamba2's and hymba's
    (head_dim, state)."""
    ins, s0, dy, dfin, y, fin, states = _ssd_bwd_case(
        dev, 7, 1, 1024, H, 64, N, 1, 256, False)
    want = _ssd_bwd_want(ins, s0, dy, dfin, 256)
    bad = tssd.ssd_scan_bwd(*ins, y, states, fin, dy, chunk=256,
                            **{fault: True})
    assert _ssd_grad_err(bad, want) > 5 * SSD_TOL


@pytest.mark.cuda
def test_ssd_autograd_counts_and_matches_the_plain_pair(dev):
    """``ops.ssd_scan`` under autograd on the card: one forward and one
    backward launch, the gradients those of the plain backward."""
    g = torch.Generator(dev).manual_seed(9)
    ins = ssd_inputs(g, 1, 600, 8, 32, 1, 16)
    dy = torch.randn((1, 600, 8, 32), generator=g, device=dev)
    leaves = [t.clone().requires_grad_() for t in ins]
    ops.reset_launch_counts()
    y, _ = ops.ssd_scan(*leaves, chunk=256)
    got = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["ssd_scan"] == 1 and counts["ssd_scan_bwd"] == 1
    assert _ssd_grad_err(got, _ssd_bwd_want(ins, None, dy, None, 256)) \
        <= SSD_TOL
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        tssd.ssd_scan_bwd(*(t.cpu() for t in ins), y.cpu(), y.cpu(),
                          y.cpu(), dy.cpu(), chunk=256)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mamba2-2.7b", "hymba-1.5b",
                                  "granite-moe-1b-a400m"])
def test_family_train_step_on_card_matches_cpu(dev, tmp_path, name):
    """One train step of the reduced ``name`` through the kernels on the
    card (the SSD scan's and flash's forward and backward) against the
    plain versions on the CPU, from the same init and batch: loss and
    grad norm within 2e-2, one forward and one backward launch a layer
    of each kernel its layers run."""
    from repro_torch.train import Trainer, TrainerConfig
    arch = get_arch(name).reduced()
    if arch.has_attention:
        arch = dataclasses.replace(arch, head_dim=64)
    shape = ShapeConfig("t", "train", 512, 2)
    plan = specialize(arch, shape, mesh_shape=(1, 1), cache=False)
    runs = {}
    init = None
    for d in (torch.device("cpu"), dev):
        tr = Trainer(plan, None, TrainerConfig(
            n_steps=1, ckpt_every=0, ckpt_dir=str(tmp_path / d.type)),
            arch=arch, shape=shape, device=d)
        if init is None:
            init = tr.init_state(0)
        ops.reset_launch_counts()
        tr.fit(_clone(init))
        runs[d.type] = (tr.history[0], ops.launch_counts())
    (hc, _), (hg, counts) = runs["cpu"], runs["cuda"]
    L_attn = arch.n_layers if arch.has_attention else 0
    L_ssm = arch.n_layers if arch.has_ssm else 0
    assert counts["flash_attention"] == counts["flash_attention_bwd"] == \
        L_attn
    assert counts["ssd_scan"] == counts["ssd_scan_bwd"] == L_ssm
    for key in ("loss", "grad_norm"):
        assert abs(hg[key] - hc[key]) <= 2e-2 * abs(hc[key])


# ---------------------------------------------------------------------
# masks by positions (the flash kernels' positions variant)
# ---------------------------------------------------------------------

def _vl_positions(dev, B, S, image=(64, 200)):
    """Temporal positions laid out as Qwen2-VL's ``get_rope_index`` lays
    out a prompt with one image: text, ``image[1]`` patches sharing one
    id from row ``image[0]``, text resuming past the grid's extent."""
    start, n = image
    pos = torch.arange(S, dtype=torch.int32)
    pos[start:start + n] = start
    pos[start + n:] = start + 16 + torch.arange(S - start - n,
                                                dtype=torch.int32)
    return pos.expand(B, S).contiguous().to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Sq,Hq,Kv,window", [
    (2, 512, 512, 64, 8, 0),       # qwen2-vl's heads: G = 8
    (1, 700, 700, H, K, 0),        # ragged, G = 4
    (2, 600, 450, H, K, 0),        # a tail at an offset, from inside
                                   # the image
    (1, 512, 512, H, K, 100),      # with a window
])
def test_flash_positions_match_plain_and_the_index_fault_fails(
        dev, B, S, Sq, Hq, Kv, window):
    g = torch.Generator(dev).manual_seed(S + Sq)
    q, k, v = _rnd(g, B, Sq, Hq, D), _rnd(g, B, S, Kv, D), _rnd(g, B, S, Kv, D)
    pos = _vl_positions(dev, B, S)
    want = tfa.flash_attention_plain(q, k, v, window=window, positions=pos)
    got = tfa.flash_attention(q, k, v, window=window, positions=pos)
    assert _rel_err(got, want) <= FLASH_TOL
    bad = tfa.flash_attention(q, k, v, window=window, positions=pos,
                              ignore_positions=True)
    assert _rel_err(bad, want) > 10 * FLASH_TOL
    rows = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    assert torch.equal(tfa.flash_attention(q, k, v, window=window,
                                           positions=rows),
                       tfa.flash_attention(q, k, v, window=window))
    # rows in any order: a permutation of the positions
    perm = torch.randperm(S, generator=g, device=dev).to(torch.int32)
    perm = perm.expand(B, S).contiguous()
    assert _rel_err(
        tfa.flash_attention(q, k, v, window=window, positions=perm),
        tfa.flash_attention_plain(q, k, v, window=window,
                                  positions=perm)) <= FLASH_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Hq,Kv", [(1, 1024, 64, 8), (2, 333, H, K)])
def test_flash_bwd_positions_match_plain_and_the_index_fault_fails(
        dev, B, S, Hq, Kv):
    g = torch.Generator(dev).manual_seed(S)
    q, k, v, do = (_rnd(g, B, S, Hq, D), _rnd(g, B, S, Kv, D),
                   _rnd(g, B, S, Kv, D), _rnd(g, B, S, Hq, D))
    pos = _vl_positions(dev, B, S)
    o, lse = tfa.flash_attention(q, k, v, positions=pos, return_lse=True)
    want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, positions=pos)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, positions=pos)
    for a, b in zip(got, want):
        assert _grad_rel_err(a, b) <= BWD_TOL
    bad = tfa.flash_attention_bwd(q, k, v, o, lse, do, positions=pos,
                                  ignore_positions=True)
    assert max(_grad_rel_err(a, b) for a, b in zip(bad, want)) > 5 * BWD_TOL
    rows = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    oi, li = tfa.flash_attention(q, k, v, return_lse=True)
    assert all(torch.equal(a, b) for a, b in zip(
        tfa.flash_attention_bwd(q, k, v, oi, li, do, positions=rows),
        tfa.flash_attention_bwd(q, k, v, oi, li, do)))
    ops.reset_launch_counts()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves, positions=pos)
    torch.autograd.grad(out, leaves, do)
    counts = ops.launch_counts()
    assert counts["flash_attention_positions"] == 1
    assert counts["flash_attention_bwd_positions"] == 1


# ---------------------------------------------------------------------
# disaggregated prefill on the card
# ---------------------------------------------------------------------

@pytest.mark.cuda
def test_disagg_fleet_kill_resumes_bitwise(dev):
    """A one-worker fleet on reduced qwen3-8b (the weights mapped by
    CUDA IPC): a run whose worker is SIGKILLed after a journaled chunk
    resumes from the journal and gives the un-killed run's tokens and
    prompt rows bitwise; every worker is reaped."""
    import numpy as np

    full = get_arch("qwen3-8b")     # reduced, at the kernels' head_dim
    arch = dataclasses.replace(full.reduced(), head_dim=full.hd)
    plan = specialize(arch, ShapeConfig("serve_disagg_t", "decode", 256, 2),
                      mesh_shape=(1, 1))
    params = lm.init_params(arch, torch.Generator(dev).manual_seed(0),
                            *plan.padded_sizes())
    bl = int(plan.estimates["kv_block_len"])
    p = (np.arange(5 * bl + 3, dtype=np.int32) * 7 + 3) % arch.vocab_size
    opts = dict(heartbeat_s=0.2, backoff_base_s=0.05, backoff_cap_s=0.2,
                chunk_delay_s=0.2, hello_timeout_s=300.0)

    def run(kill):
        eng = ServeEngine.from_plan(plan, params, arch=arch,
                                    kv_prefill_mode="disagg",
                                    disagg_workers=1, disagg_opts=opts)
        rows = {}
        try:
            rid = eng.submit(p, max_new_tokens=6)
            killed, t0 = False, time.time()
            while (eng.pending or eng.active or eng._disagg) \
                    and time.time() - t0 < 300:
                eng.step()
                fl = eng._disagg.get(rid)
                if kill and not killed and fl is not None \
                        and 1 <= fl.acked < fl.nb_feed:
                    killed = eng._fleet.kill_worker(rid=rid)
                r = next((a for a in eng.active.values() if a.rid == rid),
                         None)
                if r is not None and not rows:
                    ids = torch.as_tensor(r.blocks, device=dev)
                    rows = {n: lm.gather_blocks(eng.cache[n], ids)
                            .flatten(1, 2)[:, :len(p)].clone()
                            for n in ("k", "v")}
            assert killed == kill
            [r] = eng.finished
            return list(r.out_tokens), rows, eng.pressure_stats()
        finally:
            eng.shutdown()

    want, want_rows, _ = run(False)
    got, got_rows, stats = run(True)
    assert got == want
    assert all(torch.equal(got_rows[n], want_rows[n]) for n in ("k", "v"))
    assert stats["disagg_resumes"] >= 1


# ---------------------------------------------------------------------
# K8: the decode kernels' per-shard partial (PARTIAL mode)
# ---------------------------------------------------------------------

def _partial_rows(got, want):
    """K8 against the plain partial: the live (slot, head) pattern
    exactly (the kernel's empty partial is ``m = -inf, l = 0``, the
    plain one's ``NEG_INF`` with ``l`` its row count), and ``m`` and
    ``acc / l`` where live.  The triples are compared only where a row
    is live; the combined context is compared for every slot."""
    m, l, acc = got
    pm, pl, pa = want
    live = pm > -1e29
    assert torch.equal(live, m > float("-inf"))
    if not bool(live.any()):
        return 0.0
    assert float((m - pm)[live].abs().max()) < 1e-3
    ctx = (acc / l[..., None])[live]
    pctx = (pa / pl[..., None])[live]
    return float(((ctx - pctx).pow(2).mean(-1).sqrt()
                  / pctx.pow(2).mean(-1).sqrt().clamp_min(1e-6)).max())


def _fold(parts):
    ms = torch.stack([p[0] for p in parts])
    mg = ms.amax(0)
    c = torch.where(ms == float("-inf"), 0.0, torch.exp(ms - mg))
    lg = sum(p[1] * w for p, w in zip(parts, c))
    ag = sum(p[2] * w[..., None] for p, w in zip(parts, c))
    return ag / lg.clamp_min(1e-30)[..., None]


@pytest.mark.cuda
@pytest.mark.parametrize("G,Dh", tdec.INSTANCES)
@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("window", [0, 300])
def test_decode_partial_matches_plain_and_folds_to_the_kernel(dev, G, Dh, n,
                                                              window):
    g = torch.Generator(dev).manual_seed(G * 100 + n)
    B, Kv, S = 4, 2, 1024
    q = _rnd(g, B, G * Kv, Dh)
    k, v = _rnd(g, B, S, Kv, Dh), _rnd(g, B, S, Kv, Dh)
    pos = torch.tensor([0, 127, 700, S - 1], dtype=torch.int32, device=dev)
    Sl = S // n
    parts = []
    for i in range(n):
        ks = k[:, i * Sl:(i + 1) * Sl].contiguous()
        vs = v[:, i * Sl:(i + 1) * Sl].contiguous()
        got = tdec.decode_partial(q, ks, vs, kv_start=i * Sl, pos=pos,
                                  window=window)
        want = tdec.decode_partial_plain(q, ks, vs, kv_start=i * Sl,
                                         pos=pos, window=window)
        assert _partial_rows(got, want) < 3e-3
        parts.append(got)
    whole = tdec.decode_attention(q, k, v, cache_len=pos + 1, window=window)
    assert _rel_err(_fold(parts).to(torch.bfloat16), whole) < 3e-3
    # planted: a shard out of the fold
    assert _rel_err(_fold(parts[1:]).to(torch.bfloat16), whole) > 3e-2


@pytest.mark.cuda
@pytest.mark.parametrize("G,Dh", [(4, 128), (7, 128), (5, 64)])
@pytest.mark.parametrize("n", [2, 4])
def test_paged_decode_partial_matches_plain_and_folds_to_the_kernel(dev, G,
                                                                    Dh, n):
    g = torch.Generator(dev).manual_seed(G * 10 + n)
    B, Kv, bl, N = 4, 2, 64, 32
    nb = 8
    q = _rnd(g, B, G * Kv, Dh)
    kp, vp = _rnd(g, N, bl, Kv, Dh), _rnd(g, N, bl, Kv, Dh)
    tbl = torch.randperm(N, generator=g, device=dev)[:B * nb].reshape(
        B, nb).to(torch.int32)
    tbl[0, 2:] = -1
    pos = torch.tensor([100, 511, 300, 0], dtype=torch.int32, device=dev)
    Nl = N // n
    parts = []
    for i in range(n):
        ks, vs = kp[i * Nl:(i + 1) * Nl], vp[i * Nl:(i + 1) * Nl]
        got = tdec.paged_decode_partial(q, ks, vs, tbl, block_start=i * Nl,
                                        pos=pos)
        want = tdec.paged_decode_partial_plain(q, ks, vs, tbl,
                                               block_start=i * Nl, pos=pos)
        assert _partial_rows(got, want) < 3e-3
        parts.append(got)
    whole = tdec.paged_decode_attention(q, kp, vp, tbl, cache_len=pos + 1)
    assert _rel_err(_fold(parts).to(torch.bfloat16), whole) < 3e-3
    # planted: shard 0 reads one block past its sub-pool as its own
    wide = [tdec.paged_decode_partial(q, kp[:Nl + 1], vp[:Nl + 1], tbl,
                                      block_start=0, pos=pos)] + parts[1:]
    assert _rel_err(_fold(wide).to(torch.bfloat16), whole) > 3e-2


@pytest.mark.cuda
def test_partial_wrappers_count_launches(dev):
    g = torch.Generator(dev).manual_seed(0)
    q, k = _rnd(g, 2, H, D), _rnd(g, 2, 256, K, D)
    pos = torch.tensor([3, 255], dtype=torch.int32, device=dev)
    tbl = torch.tensor([[0], [1]], dtype=torch.int32, device=dev)
    ops.reset_launch_counts()
    ops.decode_partial(q, k, k, kv_start=0, pos=pos)
    ops.paged_decode_partial(q, k, k, tbl, block_start=0, pos=pos)
    torch.cuda.synchronize()
    c = ops.launch_counts()
    assert c["decode_partial"] == 1 and c["paged_decode_partial"] == 1
    assert sum(c.values()) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("G,DS,m", list(
    (g, ds, 64 // ds) for g, ds in tdec.SPLIT_INSTANCES if ds < 64)
    + [(4, 64, 2)])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("window", [0, 1024, 4096])
def test_split_decode_passes_match_plain(dev, G, DS, m, paged, window):
    """K9 (``csrc/decode_split.cu``) at every built ``(G, head_dim / m)``,
    without a window, with hymba's and with one wider than the cache:
    each rank's pass 1 over its columns against the plain pass 1 (the
    compact ``(B, H, Wc)`` buffer, per (slot, head) row of scores), the
    scores summed, each rank's pass 2 against the plain pass 2, and the
    ranks' columns joined against the unsharded plain decode; a column
    chunk dropped from rank 0's pass 1 and (paged) rank 0's table
    entries 0 and 1 swapped must fail the joined check by 5x."""
    Dh = DS * m
    Kv = 4
    g = torch.Generator(dev).manual_seed(G * 100 + DS + window)
    bl, B, S = 256, 8, 2048
    nb = S // bl
    lens = torch.tensor([1, 64, 300, 1023, 1024, 1025, 1999, 2048],
                        dtype=torch.int32, device=dev)
    tbl = torch.randperm(B * nb, generator=g, device=dev).int().reshape(
        B, nb).contiguous()
    q = _rnd(g, B, G * Kv, Dh)
    kp, vp = _rnd(g, B * nb, bl, Kv, Dh), _rnd(g, B * nb, bl, Kv, Dh)
    kd, vd = tref.paged_gather_ref(kp, tbl), tref.paged_gather_ref(vp, tbl)
    kk, vv, tb = (kp, vp, tbl) if paged else (kd.contiguous(),
                                               vd.contiguous(), None)
    kw = dict(cache_len=lens, window=window)
    cols = [slice(r * DS, (r + 1) * DS) for r in range(m)]
    qs = [q[..., c].contiguous() for c in cols]
    ks = [kk[..., c].contiguous() for c in cols]
    vs = [vv[..., c].contiguous() for c in cols]
    scale = Dh ** -0.5
    sc = []
    for r in range(m):
        s = tdec.decode_split_scores(qs[r], ks[r], tb, scale=scale, **kw)
        want = tdec.decode_split_scores_plain(qs[r], ks[r], tb, scale=scale,
                                              **kw)
        assert s.shape == (B, G * Kv, tdec.split_cols(S, window))
        assert _rel_err(s, want) < DECODE_TOL
        sc.append(s)
    s = torch.stack(sc).sum(0)
    ctx = []
    for r in range(m):
        c = tdec.decode_split_context(s, vs[r], tb, **kw)
        assert _rel_err(c, tdec.decode_split_context_plain(
            s, vs[r], tb, **kw)) < DECODE_TOL
        ctx.append(c)
    want = tdec.decode_attention_plain(q, kd, vd, **kw)
    assert _rel_err(torch.cat(ctx, -1), want) < DECODE_TOL
    bad = tdec.decode_split_scores(qs[0], ks[0], tb, scale=scale,
                                   drop_chunk=0, **kw)
    sbad = s - sc[0] + bad
    assert _rel_err(torch.cat([tdec.decode_split_context(sbad, vs[r], tb,
                                                         **kw)
                               for r in range(m)], -1), want) \
        > 5 * DECODE_TOL
    if paged:
        swapped = tdec.decode_split_context(s, vs[0], tb, swap_entry=True,
                                            **kw)
        assert _rel_err(torch.cat([swapped] + ctx[1:], -1), want) \
            > 5 * DECODE_TOL
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("bl", [4, 24])
@pytest.mark.parametrize("window", [0, 1024])
def test_split_decode_block_lengths(dev, bl, window):
    """K9 over pools of other block lengths than the plan's powers of two
    from 16: 4-row blocks (384 table columns, past the 256 a CTA stages
    whole, so each CTA stages its own rows' entries) and 24-row blocks (a
    length no shift divides), with -1 entries past each slot's rows,
    both passes against the plain ones and the ranks' columns against
    the unsharded plain decode."""
    G, DS, m, Kv, B, S = 2, 32, 2, 4, 8, 1536
    nb = S // bl
    g = torch.Generator(dev).manual_seed(bl * 10 + window)
    lens = torch.tensor([1, 5, 300, 777, 1024, 1025, 1400, 1536],
                        dtype=torch.int32, device=dev)
    tbl = torch.randperm(B * nb, generator=g, device=dev).int().reshape(
        B, nb)
    used = torch.arange(nb, device=dev)[None] * bl < lens[:, None]
    tbl = torch.where(used, tbl, -1).contiguous()
    q = _rnd(g, B, G * Kv, DS * m)
    kp, vp = (_rnd(g, B * nb, bl, Kv, DS * m) for _ in range(2))
    kw = dict(cache_len=lens, window=window)
    scale = (DS * m) ** -0.5
    cols = [slice(r * DS, (r + 1) * DS) for r in range(m)]
    sc, ctx = [], []
    for c in cols:
        qc, kc = q[..., c].contiguous(), kp[..., c].contiguous()
        s = tdec.decode_split_scores(qc, kc, tbl, scale=scale, **kw)
        assert _rel_err(s, tdec.decode_split_scores_plain(
            qc, kc, tbl, scale=scale, **kw)) < DECODE_TOL
        sc.append(s)
    s = torch.stack(sc).sum(0)
    for c in cols:
        vc = vp[..., c].contiguous()
        out = tdec.decode_split_context(s, vc, tbl, **kw)
        assert _rel_err(out, tdec.decode_split_context_plain(
            s, vc, tbl, **kw)) < DECODE_TOL
        ctx.append(out)
    want = tdec.paged_decode_attention_plain(q, kp, vp, tbl, **kw)
    assert _rel_err(torch.cat(ctx, -1), want) < DECODE_TOL
    torch.cuda.synchronize()
