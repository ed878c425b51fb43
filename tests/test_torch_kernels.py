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
    assert tfa.kernel_tiles(4, 16, 128) == (64, 128)
    assert tfa.kernel_tiles(4, 32, 64) == (128, 64)
    with pytest.raises(ValueError, match="not one the kernel is built for"):
        tfa.kernel_tiles(4, 128, 128)         # the h100 prefill-shape plan
    with pytest.raises(ValueError, match="whole GQA groups"):
        tfa.kernel_tiles(3)
    for rows, bkv in tfa.KERNEL_TILES:
        assert tfa.smem_bytes(rows, bkv) <= 232_448


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
    for g in (1, 2, 4, 8):
        assert tdec.smem_bytes(g, max(tdec.KERNEL_TILES)) <= 232_448


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
                                   "paged_decode_attention": 0,
                                   "decode_attention": 0}
    with pytest.raises(ValueError, match="kernel mode"):
        ops.flash_attention(q, k, k, mode="maybe")
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        tfa.flash_attention(q, k, k)          # the wrapper never falls back
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        tdec.decode_attention(qd, kd, kd, cache_len=torch.tensor([64, 3]))
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        tdec.paged_decode_attention(qd, pool, pool, tbl,
                                    cache_len=torch.tensor([5, 70]))
