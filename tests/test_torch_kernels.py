"""Kernel oracles: the port's plain versions against the JAX package.

Each kernel's plain PyTorch version (the function its CUDA kernel
computes, and what a CPU tensor runs) is held against the JAX oracle in
``repro/kernels/ref.py`` and against the Pallas kernel in interpret
mode, on the same inputs made with numpy from a seed.  Tolerances are
those of ``tests/test_kernels.py``: 1e-5 in fp32 and 2e-2 in bf16,
relative to the reference's largest magnitude (bf16 rounds at other
places in the two frameworks; fp32 differs only in summation order).

The CUDA kernels themselves run only on the card:
``tests/test_torch_cuda.py`` compares them with these plain versions
there and skips elsewhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.kernels.decode_attention as tdec
import repro_torch.kernels.flash_attention as tfa
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.decode_attention import \
    paged_decode_attention as pallas_paged
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import lm as tlm

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rel_err(a, b) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-6))


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _pair(rng, shape, dtype):
    """The same fp32 draw as a JAX array and a torch tensor of ``dtype``
    (both round to nearest even)."""
    x = rng.standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


# ---------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------

FLASH_SHAPES = [(1, 64, 4, 4, 32),     # MHA (G=1)
                (2, 96, 4, 2, 32),     # GQA 2:1
                (1, 128, 8, 2, 32),    # GQA 4:1
                (2, 77, 8, 2, 32)]     # ragged S (Pallas cannot run it)


@pytest.mark.parametrize("B,S,H,K,D", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 16)])
def test_flash_plain_matches_jax(B, S, H, K, D, dtype, causal, window):
    rng = np.random.default_rng(S * 7 + H)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, s, dtype) for s in
                                    [(B, S, H, D), (B, S, K, D), (B, S, K, D)])
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    got = tfa.flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    assert _rel_err(_np(got), want) < TOL[dtype]
    oracle = tref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    assert _rel_err(_np(oracle), want) < TOL[dtype]
    if S % 32 == 0:
        pal = pallas_flash(jq, jk, jv, causal=causal, window=window,
                           block_q=32, block_kv=32, interpret=True)
        assert _rel_err(_np(got), pal) < TOL[dtype]


@pytest.mark.parametrize("block_kv", [16, 64, 128])
def test_flash_plain_block_invariance(block_kv):
    """A CPU tensor takes the plain version whatever the plan's tiles
    (they are the kernel's): ``ops`` with tiles equals the oracle."""
    rng = np.random.default_rng(1)
    (_, q), (_, k), (_, v) = (_pair(rng, s, "float32") for s in
                              [(1, 100, 4, 32), (1, 100, 2, 32),
                               (1, 100, 2, 32)])
    want = tref.flash_attention_ref(q, k, v)
    got = ops.flash_attention(q, k, v, tiles=(block_kv, block_kv))
    assert _rel_err(_np(got), _np(want)) < 1e-5


def test_flash_kernel_tiles_raise_instead_of_substituting():
    assert tfa.kernel_tiles(4) == (tfa.DEFAULT_ROWS, tfa.DEFAULT_BLOCK_KV)
    assert (tfa.DEFAULT_ROWS, tfa.DEFAULT_BLOCK_KV) in tfa.KERNEL_TILES
    assert tfa.kernel_tiles(4, 16, 64) == (64, 64)
    assert tfa.kernel_tiles(4, 16, 128) == (64, 128)
    assert tfa.kernel_tiles(4, 32, 64) == (128, 64)
    assert tfa.kernel_tiles(4, 32, 128) == (128, 128)  # h100 prefill plan
    assert tfa.kernel_tiles(8, 16, 128) == (128, 128)
    assert tfa.kernel_tiles(1, 64, 64) == (64, 64)
    # G = 7 (deepseek-coder-33b): 18 positions in 128 rows, 9 in 64
    assert tfa.kernel_tiles(7) == (128, 128)
    assert tfa.kernel_tiles(7, 18, 128) == (128, 128)
    assert tfa.kernel_tiles(7, 9, 64) == (64, 64)
    with pytest.raises(ValueError, match="not one the kernel is built for"):
        tfa.kernel_tiles(7, 16, 128)
    with pytest.raises(ValueError, match="not one the kernel is built for"):
        tfa.kernel_tiles(4, 128, 128)         # 512 rows: the tpu-v5e tile
    with pytest.raises(ValueError, match="not one the kernel is built for"):
        tfa.kernel_tiles(4, 32, 256)
    # G = 5 (hymba-1.5b): 25 positions in 128 rows, 12 in 64
    assert tfa.kernel_tiles(5) == (128, 128)
    assert tfa.kernel_tiles(5, 25, 128) == (128, 128)
    assert tfa.kernel_tiles(5, 12, 64) == (64, 64)
    with pytest.raises(ValueError, match="not one the kernel is built for"):
        tfa.kernel_tiles(5, 32, 128)
    # G = 3 (a rank of llama4-maverick's 16-wide model axis): 42
    # positions in 128 rows, 21 in 64
    assert tfa.kernel_tiles(3) == (128, 128)
    assert tfa.kernel_tiles(3, 42, 128) == (128, 128)
    assert tfa.kernel_tiles(3, 21, 64) == (64, 64)
    with pytest.raises(ValueError, match="GQA group G = 6"):
        tfa.kernel_tiles(6)
    for rows, bkv in tfa.KERNEL_TILES:
        for d in tfa.HEAD_DIMS:
            assert tfa.smem_bytes(rows, bkv, d) <= 232_448
    # Q plus two stages of K and V, their mbarriers, 1 KB of alignment
    assert tfa.smem_bytes(128, 128) == 128 * 256 + 2 * 2 * 128 * 256 + 7 * 8 \
        + 1024
    assert tfa.smem_bytes(128, 128, 64) == 128 * 128 + 2 * 2 * 128 * 128 \
        + 7 * 8 + 1024


# ---------------------------------------------------------------------
# decode attention: dense and paged
# ---------------------------------------------------------------------

@pytest.mark.parametrize("K", [8, 4, 2])               # G = 1, 2, 4
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 8])
def test_decode_plain_matches_jax(K, dtype, window):
    B, S, H, D = 3, 64, 8, 32
    rng = np.random.default_rng(K + window)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, s, dtype) for s in
                                    [(B, H, D), (B, S, K, D), (B, S, K, D)])
    lens = np.array([64, 17, 1], np.int32)
    want = jref.decode_attention_ref(jq, jk, jv, cache_len=jnp.asarray(lens),
                                     window=window)
    got = tdec.decode_attention_plain(tq, tk, tv,
                                      cache_len=torch.from_numpy(lens),
                                      window=window)
    assert _rel_err(_np(got), want) < TOL[dtype]
    oracle = tref.decode_attention_ref(tq, tk, tv,
                                       cache_len=torch.from_numpy(lens),
                                       window=window)
    assert _rel_err(_np(oracle), want) < TOL[dtype]
    # the Pallas kernel takes one shared length: compare at 40
    pal = pallas_decode(jq, jk, jv, cache_len=40, window=window, block_kv=16,
                        interpret=True)
    got40 = tdec.decode_attention_plain(tq, tk, tv, cache_len=40,
                                        window=window)
    assert _rel_err(_np(got40), pal) < TOL[dtype]


def _paged_case(rng, dtype, K, bl=8, N=12, nb=5):
    """A pool, a table with -1 tails and one freed slot (row -1, len 1),
    and per-slot lengths inside each slot's assigned blocks."""
    B, H, D = 4, 8, 32
    perm = rng.permutation(N).astype(np.int32)
    tbl = np.full((B, nb), -1, np.int32)
    tbl[0, :5] = perm[:5]                 # full table
    tbl[1, :2] = perm[5:7]                # -1 tail
    tbl[2, :3] = perm[7:10]
    lens = np.array([40, 11, 17, 1], np.int32)   # slot 3 is freed
    q = _pair(rng, (B, H, D), dtype)
    kp = _pair(rng, (N, bl, K, D), dtype)
    vp = _pair(rng, (N, bl, K, D), dtype)
    return q, kp, vp, tbl, lens


@pytest.mark.parametrize("K", [8, 4, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 6])
def test_paged_plain_matches_jax(K, dtype, window):
    rng = np.random.default_rng(10 + K)
    (jq, tq), (jk, tk), (jv, tv), tbl, lens = _paged_case(rng, dtype, K)
    want = jref.paged_decode_attention_ref(
        jq, jk, jv, jnp.asarray(tbl), cache_len=jnp.asarray(lens),
        window=window)
    got = tdec.paged_decode_attention_plain(
        tq, tk, tv, torch.from_numpy(tbl), cache_len=torch.from_numpy(lens),
        window=window)
    # every slot, the freed one included: -1 blocks read as zero rows
    assert _rel_err(_np(got), want) < TOL[dtype]
    assert np.abs(_np(got)[3]).max() == 0.0
    oracle = tref.paged_decode_attention_ref(
        tq, tk, tv, torch.from_numpy(tbl), cache_len=torch.from_numpy(lens),
        window=window)
    assert _rel_err(_np(oracle), want) < TOL[dtype]
    pal = pallas_paged(jq, jk, jv, jnp.asarray(tbl),
                       cache_len=jnp.asarray(lens), window=window,
                       interpret=True)
    live = [0, 1, 2]
    assert _rel_err(_np(got)[live], np.asarray(pal, np.float32)[live]) \
        < TOL[dtype]


def test_decode_tile_contract():
    assert tdec.kernel_tile("x", None) == tdec.DEFAULT_BLOCK_KV
    for t in tdec.KERNEL_TILES:
        assert tdec.kernel_tile("x", t) == t
    for t in (16, 96, 512):
        with pytest.raises(ValueError, match="not one of the kernel's tiles"):
            tdec.kernel_tile("x", t)
    for g, d in tdec.INSTANCES:
        assert tdec.smem_bytes(g, max(tdec.KERNEL_TILES), d) <= 232_448
    assert tdec.takes_group(5, 64) and tdec.takes_group(5, 128)
    assert tdec.takes_group(2, 64) and not tdec.takes_group(3, 128)
    assert tdec.takes_group(4, 128) and tdec.takes_group(4, 64)
    assert tdec.takes_group(6, 128) and not tdec.takes_group(6, 64)


@pytest.mark.parametrize("B,K,capacity", [(8, 8, 2048), (1, 8, 2048),
                                          (1, 1, 64), (3, 4, 1000),
                                          (8, 8, 32768), (64, 8, 2048),
                                          (1, 1, 1 << 17)])
@pytest.mark.parametrize("tile", tdec.KERNEL_TILES)
def test_decode_split_covers_every_live_tile_once(B, K, capacity, tile):
    """Splits are whole tiles, never less than one, and every tile of the
    capacity lies in exactly one split."""
    splits, rows = tdec.decode_split(B, K, capacity, tile)
    assert rows % tile == 0 and rows >= tile
    assert splits <= tdec.MAX_SPLITS
    assert (splits - 1) * rows < capacity <= splits * rows
    owner = [t * tile // rows for t in range(-(-capacity // tile))]
    covered = [sum(1 for o in owner if o == s) for s in range(splits)]
    assert sum(covered) == len(owner) and all(c >= 1 for c in covered)
    assert owner == sorted(owner)


@pytest.mark.parametrize("tile", tdec.KERNEL_TILES)
def test_decode_split_fills_the_card_at_the_timed_shape(tile):
    """B = 8 slots x K = 8 kv heads over a 2048-row cache: at least two
    CTAs per SM of the H100, in one launch."""
    splits, _ = tdec.decode_split(8, 8, 2048, tile)
    assert 8 * 8 * splits >= 2 * 132 == tdec.SPLIT_CTAS


def test_decode_split_reads_no_cache_len():
    """The rule sees shapes only, so the grid is the same for every
    cache_len (which lives on the device) and costs no host sync."""
    import inspect
    assert list(inspect.signature(tdec.decode_split).parameters) == \
        ["B", "K", "capacity", "tile"]
    assert len({tdec.decode_split(8, 8, 2048, 256) for _ in range(3)}) == 1


@pytest.mark.parametrize("K", [8, 4, 2, 1])            # G = 1, 2, 4, 8
@pytest.mark.parametrize("window", [0, 5, 23])
@pytest.mark.parametrize("split_rows", [1, 7, 16, 64])
def test_split_merge_mirror_matches_plain_and_jax(K, window, split_rows):
    """The kernels' split-and-merge arithmetic (plain mirror) against the
    one-softmax plain version and the JAX oracle, fp32 at 1e-5: random
    lengths, a slot with no live row (zeros out), splits wholly past a
    slot's length or before its window start (empty partials)."""
    B, S, H, D = 5, 64, 8, 32
    rng = np.random.default_rng(K * 100 + window * 10 + split_rows)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, s, "float32") for s in
                                    [(B, H, D), (B, S, K, D), (B, S, K, D)])
    lens = np.array([0, 1, *rng.integers(2, S, 2), S], np.int32)
    cl = torch.from_numpy(lens)
    got = tdec.decode_attention_splits(tq, tk, tv, cache_len=cl,
                                       split_rows=split_rows, window=window)
    plain = tdec.decode_attention_plain(tq, tk, tv, cache_len=cl,
                                        window=window)
    assert _rel_err(_np(got), _np(plain)) < TOL["float32"]
    assert np.abs(_np(got)[0]).max() == 0.0
    want = jref.decode_attention_ref(jq, jk, jv, cache_len=jnp.asarray(lens),
                                     window=window)
    assert _rel_err(_np(got)[1:], np.asarray(want)[1:]) < TOL["float32"]


@pytest.mark.parametrize("K", [8, 2])
@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("split_rows", [3, 8, 24])
def test_split_merge_mirror_matches_paged_plain_and_jax(K, window,
                                                        split_rows):
    """The mirror over a paged cache's gathered view, -1 blocks and the
    freed slot included, against the paged plain version and the JAX
    paged oracle (live slots), fp32 at 1e-5."""
    rng = np.random.default_rng(30 + K + window + split_rows)
    (jq, tq), (jk, tk), (jv, tv), tbl, lens = _paged_case(rng, "float32", K)
    ttbl, cl = torch.from_numpy(tbl), torch.from_numpy(lens)
    got = tdec.decode_attention_splits(
        tq, tref.paged_gather_ref(tk, ttbl), tref.paged_gather_ref(tv, ttbl),
        cache_len=cl, split_rows=split_rows, window=window)
    plain = tdec.paged_decode_attention_plain(tq, tk, tv, ttbl, cache_len=cl,
                                              window=window)
    assert _rel_err(_np(got), _np(plain)) < TOL["float32"]
    want = jref.paged_decode_attention_ref(
        jq, jk, jv, jnp.asarray(tbl), cache_len=jnp.asarray(lens),
        window=window)
    assert _rel_err(_np(got), np.asarray(want)) < TOL["float32"]


def test_split_merge_mirror_dropped_split_is_caught():
    """The planted fault the card checks plant (one split left out of
    the merge) moves the longest slot far past the tolerance."""
    rng = np.random.default_rng(5)
    (_, tq), (_, tk), (_, tv) = (_pair(rng, s, "float32") for s in
                                 [(2, 8, 32), (2, 64, 2, 32), (2, 64, 2, 32)])
    cl = torch.tensor([64, 40], dtype=torch.int32)
    good = tdec.decode_attention_splits(tq, tk, tv, cache_len=cl,
                                        split_rows=16)
    bad = tdec.decode_attention_splits(tq, tk, tv, cache_len=cl,
                                       split_rows=16, drop_split=0)
    assert _rel_err(_np(bad), _np(good)) > 0.1


@pytest.mark.parametrize("block_kv", [8, 16, 64])
def test_paged_plain_tile_is_independent_of_block_len(block_kv):
    """On a CPU tensor ``ops`` ignores the kernel's tile, whatever the
    pool's block length (here 8): the gathered-view oracle's result."""
    rng = np.random.default_rng(20 + block_kv)
    (_, tq), (_, tk), (_, tv), tbl, lens = _paged_case(rng, "float32", 2)
    want = tref.paged_decode_attention_ref(
        tq, tk, tv, torch.from_numpy(tbl), cache_len=torch.from_numpy(lens))
    got = ops.paged_decode_attention(
        tq, tk, tv, torch.from_numpy(tbl), cache_len=torch.from_numpy(lens),
        block_kv=block_kv)
    assert _rel_err(_np(got), _np(want)) < 1e-5


# ---------------------------------------------------------------------
# cache appends
# ---------------------------------------------------------------------

def test_append_kv_matches_decode_append_ref():
    rng = np.random.default_rng(3)
    (jc, tc), (jn, tn) = (_pair(rng, s, "bfloat16") for s in
                          [(3, 16, 2, 32), (3, 1, 2, 32)])
    pos = np.array([0, 7, 15], np.int32)
    want = jref.decode_append_ref(jc, jn, jnp.asarray(pos))
    got = tlm.append_kv(tc.clone(), tn, torch.from_numpy(pos))
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))
    oracle = tref.decode_append_ref(tc, tn, torch.from_numpy(pos))
    np.testing.assert_array_equal(_np(oracle), np.asarray(want, np.float32))


def test_append_kv_paged_matches_paged_append_ref():
    rng = np.random.default_rng(4)
    (jp, tp), (jn, tn) = (_pair(rng, s, "bfloat16") for s in
                          [(6, 4, 2, 32), (4, 1, 2, 32)])
    tbl = np.array([[2, 0, -1], [5, -1, -1], [-1, -1, -1], [1, 3, 4]],
                   np.int32)
    pos = np.array([5, 3, 0, 9], np.int32)     # slot 2 is freed: dropped
    want = jref.paged_append_ref(jp, jn, jnp.asarray(pos), jnp.asarray(tbl))
    got = tlm.append_kv_paged(tp.clone(), tn, torch.from_numpy(pos),
                              torch.from_numpy(tbl))
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))
    oracle = tref.paged_append_ref(tp, tn, torch.from_numpy(pos),
                                   torch.from_numpy(tbl))
    np.testing.assert_array_equal(_np(oracle), np.asarray(want, np.float32))


def test_paged_gather_ref_matches_jax():
    rng = np.random.default_rng(5)
    jp, tp = _pair(rng, (6, 4, 2, 8), "float32")
    tbl = np.array([[2, -1], [-1, 5]], np.int32)
    want = jref.paged_gather_ref(jp, jnp.asarray(tbl))
    got = tref.paged_gather_ref(tp, torch.from_numpy(tbl))
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


# ---------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------

def test_ops_on_cpu_tensors_launch_no_kernel():
    ops.reset_launch_counts()
    rng = np.random.default_rng(6)
    _, q = _pair(rng, (1, 40, 4, 128), "bfloat16")
    _, k = _pair(rng, (1, 40, 2, 128), "bfloat16")
    out = ops.flash_attention(q, k, k, causal=True, mode="on")
    assert out.shape == q.shape
    _, qd = _pair(rng, (2, 4, 128), "bfloat16")
    _, kd = _pair(rng, (2, 64, 2, 128), "bfloat16")
    ops.decode_attention(qd, kd, kd, cache_len=torch.tensor([64, 3]),
                         mode="off")
    _, pool = _pair(rng, (4, 64, 2, 128), "bfloat16")
    tbl = torch.tensor([[0, -1], [3, 1]], dtype=torch.int32)
    ops.paged_decode_attention(qd, pool, pool, tbl,
                               cache_len=torch.tensor([5, 70]))
    assert ops.launch_counts() == {"flash_attention": 0,
                                   "flash_attention_bwd": 0,
                                   "flash_attention_positions": 0,
                                   "flash_attention_bwd_positions": 0,
                                   "paged_decode_attention": 0,
                                   "decode_attention": 0,
                                   "decode_partial": 0,
                                   "paged_decode_partial": 0,
                                   "decode_split_scores": 0,
                                   "decode_split_context": 0, "ssd_scan": 0,
                                   "ssd_scan_bwd": 0, "tiled_matmul": 0}
    with pytest.raises(ValueError, match="kernel mode"):
        ops.flash_attention(q, k, k, mode="maybe")
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        tfa.flash_attention(q, k, k)          # the wrapper never falls back
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        tdec.decode_attention(qd, kd, kd, cache_len=torch.tensor([64, 3]))
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        tdec.paged_decode_attention(qd, pool, pool, tbl,
                                    cache_len=torch.tensor([5, 70]))


# ---------------------------------------------------------------------
# K9: decode over a head_dim-split cache, pass by pass
# ---------------------------------------------------------------------

def _split_passes(q, k, v, tbl, lens, window, m):
    """The head_dim-split decode of ``m`` ranks in one process: each
    rank's pass-1 scores over its columns, summed (the all-reduce), then
    each rank's pass-2 columns, joined."""
    D = q.shape[-1]
    n = D // m
    cols = [slice(r * n, (r + 1) * n) for r in range(m)]
    s = sum(tdec.decode_split_scores_plain(
        q[..., c].contiguous(), k[..., c].contiguous(), tbl, cache_len=lens,
        window=window, scale=D ** -0.5) for c in cols)
    return torch.cat([tdec.decode_split_context_plain(
        s, v[..., c].contiguous(), tbl, cache_len=lens, window=window)
        for c in cols], -1)


@pytest.mark.parametrize("G,m", [(5, 2), (4, 2), (5, 4), (4, 4)])
@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("paged", [False, True])
def test_split_passes_match_jax_decode(G, m, window, paged):
    """K9's plain passes across ``m`` column slices (G = 5: hymba's
    group; 4: qwen3-8b's; windowed and global) against the reference's
    ``attention_decode`` / ``attention_decode_paged``, the XLA path the
    reference runs on a head_dim-split cache (it contracts QK^T over the
    split dim and sums the scores): bf16 at 2e-2; fp32 at 1e-5."""
    from repro.models.attention import (attention_decode,
                                        attention_decode_paged)
    rng = np.random.default_rng(11 + G + m + window)
    B, K, D, S = 3, 2, 64, 64
    H = G * K
    lens_np = np.array([64, 9, 40], np.int32)
    for dtype in ("bfloat16", "float32"):
        jq, tq = _pair(rng, (B, 1, H, D), dtype)
        if paged:
            bl, N = 16, 16
            jk, tk = _pair(rng, (N, bl, K, D), dtype)
            jv, tv = _pair(rng, (N, bl, K, D), dtype)
            tbl_np = rng.permutation(N)[:B * 4].reshape(B, 4).astype(np.int32)
            tbl_np[1, 1:] = -1               # 9 rows: one block
            want = attention_decode_paged(
                jq, jk, jv, jnp.asarray(tbl_np),
                cache_len=jnp.asarray(lens_np), window=window)
            tbl = torch.from_numpy(tbl_np)
        else:
            jk, tk = _pair(rng, (B, S, K, D), dtype)
            jv, tv = _pair(rng, (B, S, K, D), dtype)
            want = attention_decode(jq, jk, jv,
                                    cache_len=jnp.asarray(lens_np),
                                    window=window)
            tbl = None
        got = _split_passes(tq[:, 0], tk, tv, tbl, torch.from_numpy(lens_np),
                            window, m)
        err = _rel_err(_np(got), np.asarray(want[:, 0], np.float32))
        assert err <= TOL[dtype], (dtype, err)
        # one rank's slice is the whole head_dim's (m = 1): the fused
        # decode's plain version
        fused = (tdec.paged_decode_attention_plain(tq[:, 0], tk, tv, tbl,
                                                   cache_len=lens_np,
                                                   window=window)
                 if paged else tdec.decode_attention_plain(
                     tq[:, 0], tk, tv, cache_len=lens_np, window=window))
        one = _split_passes(tq[:, 0], tk, tv, tbl, torch.from_numpy(lens_np),
                            window, 1)
        assert _rel_err(_np(one), _np(fused)) <= TOL[dtype]


def test_split_scores_are_zero_outside_the_live_rows():
    """Pass 1 writes the compact layout: slot 0 (20 rows, window 8) has
    its rows 12-19 in columns 0-7, slot 1 (5 rows) its rows 0-4 in
    columns 0-4, and every other column is 0; a dropped column is a
    different score."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 32, 2, 16)).astype(
        np.float32))
    lens = torch.tensor([20, 5], dtype=torch.int32)
    s = tdec.decode_split_scores_plain(q, k, cache_len=lens, window=8,
                                       scale=0.125)
    assert s.shape == (2, 4, 8)
    full = torch.einsum("bkgd,bskd->bkgs", q.reshape(2, 2, 2, 16) * 0.125,
                        k).reshape(2, 4, 32)
    assert torch.allclose(s[0], full[0, :, 12:20])
    assert torch.allclose(s[1, :, :5], full[1, :, :5])
    assert (s[1, :, 5:] == 0).all() and (s[:, :, :5] != 0).all()
    k2 = k.clone()
    k2[..., :8] = 0
    s2 = tdec.decode_split_scores_plain(q, k2, cache_len=lens, window=8,
                                        scale=0.125)
    assert not torch.allclose(s, s2)


def _full_context(q, k, v, tbl, lens, window):
    """The head_dim-split decode over the full ``(B, H, cap)`` score
    buffer (the layout before the compact one): every row scored, the
    rows outside each slot's live range masked, one fp32 softmax."""
    kv, vv = (tdec._view(t, tbl).float() for t in (k, v))
    B, H, D = q.shape
    C, K = kv.shape[1], kv.shape[2]
    s = torch.einsum("bkgd,bckd->bkgc",
                     q.reshape(B, K, H // K, D).float() * D ** -0.5, kv)
    cl = lens.long().clamp(max=C)[:, None]
    row = torch.arange(C)[None, :]
    live = (row < cl) & ((row >= cl - window) if window > 0 else True)
    s = torch.where(live[:, None, None, :], s, float("-inf"))
    p = torch.softmax(s, -1)
    o = torch.einsum("bkgc,bckd->bkgd", p, vv)
    return o.reshape(B, H, D)


@pytest.mark.parametrize("window", [0, 24, 100])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("m", [2, 4])
def test_compact_split_passes_equal_the_full_buffer(window, paged, m):
    """The compact plain passes, summed over ``m`` column slices, give
    the context of the full ``(B, H, cap)`` computation (fp32, 1e-5):
    windows 0, 24 and 100 (wider than the 64-row cache), slots of 1, 9
    (shorter than the window), 40 and 64 rows; the buffer has
    ``min(cap, window)`` columns, ``cap`` without a window."""
    rng = np.random.default_rng(17 + window + m)
    B, K, G, D, S = 4, 2, 4, 32, 64
    lens = torch.tensor([1, 9, 40, 64], dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal((B, G * K, D)).astype(
        np.float32))
    if paged:
        bl, N = 16, 20
        shape = (N, bl, K, D)
        tbl_np = rng.permutation(N)[:B * 4].reshape(B, 4).astype(np.int32)
        tbl_np[0, 1:] = -1
        tbl = torch.from_numpy(tbl_np)
    else:
        shape, tbl = (B, S, K, D), None
    k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for _ in range(2))
    got = _split_passes(q, k, v, tbl, lens, window, m)
    want = _full_context(q, k, v, tbl, lens, window)
    assert _rel_err(_np(got), _np(want)) <= TOL["float32"]
    s = tdec.decode_split_scores_plain(q[..., :D // m].contiguous(),
                                       k[..., :D // m].contiguous(), tbl,
                                       cache_len=lens, window=window,
                                       scale=D ** -0.5)
    assert s.shape == (B, G * K, min(S, window) if window else S)


@pytest.mark.parametrize("window,rows", [(0, 8), (0, None), (24, 8),
                                         (24, 16), (100, 16)])
@pytest.mark.parametrize("paged", [False, True])
def test_split_context_merge_mirror(window, rows, paged):
    """The plain mirror of pass 2's split and merge (partials of each
    split's live compact columns, merged in split order, empty splits
    absent) equals the one-softmax plain pass 2 (fp32, 1e-5), whatever
    the split size; leaving a split out (the planted fault) does not."""
    rng = np.random.default_rng(29 + window + (rows or 0))
    B, K, G, DS, S = 4, 2, 5, 16, 64
    lens = torch.tensor([1, 9, 40, 64], dtype=torch.int32)
    if paged:
        bl, N = 16, 20
        shape = (N, bl, K, DS)
        tbl_np = rng.permutation(N)[:B * 4].reshape(B, 4).astype(np.int32)
        tbl_np[2, 1] = -1                     # a -1 entry among live rows
        tbl = torch.from_numpy(tbl_np)
    else:
        shape, tbl = (B, S, K, DS), None
    v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    cols = min(S, window) if window else S
    s = torch.from_numpy(rng.standard_normal((B, G * K, cols)).astype(
        np.float32))
    kw = dict(cache_len=lens, window=window)
    want = tdec.decode_split_context_plain(s, v, tbl, **kw)
    got = tdec.decode_split_context_splits(s, v, tbl, rows=rows, **kw)
    assert _rel_err(_np(got), _np(want)) <= TOL["float32"]
    assert tdec.context_split(B, K, DS, cols)[0] <= tdec.SPLIT_CLUSTER
    if rows is not None and cols > rows:
        bad = tdec.decode_split_context_splits(s, v, tbl, rows=rows,
                                               drop_split=0, **kw)
        assert _rel_err(_np(bad), _np(want)) > 100 * TOL["float32"]


def test_context_split_rule():
    """Pass 2's splits: two tiles of 128 columns a split where one wave
    of the grid (CTAs of 4 * DS threads, 512 threads an SM) and a cluster
    of at most 8 splits a (slot, kv head) allow, more tiles a split
    beyond that, covering every column: hymba's window of 1024 over 8 x
    13 gives 4 splits of 256, g5m2's 2048 rows over 8 x 5 8 of 256,
    qwen3-8b's 2048 over 8 x 8 at 64 columns 4 of 512."""
    assert tdec.context_split(8, 13, 32, 1024) == (4, 256)
    assert tdec.context_split(8, 5, 32, 2048) == (8, 256)
    assert tdec.context_split(8, 8, 64, 2048) == (4, 512)
    assert tdec.context_split(8, 13, 32, 24) == (1, 128)
    assert tdec.context_split(1, 4, 64, 32768) == (8, 4096)
    assert tdec.context_split(64, 8, 64, 2048) == (1, 2048)
    for B, K in ((1, 1), (8, 13), (64, 8)):
        for DS in (16, 32, 64):
            for cols in (1, 127, 129, 1000, 1025, 5000, 32768):
                splits, rows = tdec.context_split(B, K, DS, cols)
                assert rows % tdec.SPLIT_TILE == 0
                assert 1 <= splits <= tdec.SPLIT_CLUSTER
                assert splits * rows >= cols > (splits - 1) * rows
    assert tdec.split_cols(2048, 1024) == 1024
    assert tdec.split_cols(64, 100) == 64 and tdec.split_cols(64, 0) == 64
