"""The plan-driven tiled matmul: the port's entry point against JAX.

``repro_torch.kernels.ops.matmul`` on CPU tensors runs the kernel's
plain version; here it is held against the JAX package's Pallas kernel
in interpret mode and its oracle ``ref.tiled_matmul_ref``, on the same
inputs made with numpy from a seed (bf16 carried across as raw 16-bit
words, as ``models/convert.py`` does).  Tolerances are
``tests/test_kernels.py``'s: its ``_rel_err`` (max error over max
magnitude) below 1e-5 in fp32 and 2e-2 in bf16.

The port's contract is a superset of the Pallas one (any M, K and N:
the Pallas kernel asserted that its clamped tiles divide them), so the
ragged shapes a plan-driven caller meets — a decode tick's M = 8, a
prefill bucket's M = 1000, mamba2's ``in_proj`` width N = 10576 — are
held against ``jnp.dot``.  The CUDA kernel itself runs only on the
card (``tests/test_torch_cuda.py``).

The fp32 kernel forms its products as 3xTF32 on the tensor cores; a
plain mirror of that arithmetic here (:func:`_mm_3xtf32`, tests only)
is held against the Pallas kernel, ``ref.tiled_matmul_ref`` and an fp64
product at 1e-5, and the hi-only product (1xTF32) is shown to miss it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.kernels.tiled_matmul as tmm
from repro.kernels import ref as jref
from repro.kernels.tiled_matmul import tiled_matmul as pallas_mm
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.core import planstore, specialize
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.launch import plan as plan_cli
from repro_torch.models.convert import tensor_from_numpy

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
SMEM_BUDGET = int(0.75 * 232_448)      # the pass's share of one block's


def _rel_err(a, b) -> float:
    """``tests/test_kernels.py``'s measure."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-6))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _inputs(seed: int, M: int, K: int, N: int, dtype: str):
    """``(a, b)`` as JAX arrays and as torch tensors with the same bits."""
    rng = np.random.default_rng(seed)
    ja = jnp.asarray(rng.standard_normal((M, K)).astype(np.float32),
                     JAX_DTYPES[dtype])
    jb = jnp.asarray(rng.standard_normal((K, N)).astype(np.float32),
                     JAX_DTYPES[dtype])
    return (ja, jb), (tensor_from_numpy(np.asarray(ja), "cpu"),
                      tensor_from_numpy(np.asarray(jb), "cpu"))


def _from_bits(u: torch.Tensor) -> torch.Tensor:
    """fp32 values from their bits, held as int64 in [0, 2^32)."""
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32).view(
        torch.float32)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: x to a 10-bit mantissa, to nearest with ties
    away from zero (half of the 13 dropped bits added to the magnitude,
    then the field cleared; the sign bit is untouched)."""
    return _from_bits(((_bits(x) + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF)


def _tf32_cut(x: torch.Tensor) -> torch.Tensor:
    """x's low 13 bits cleared: the TF32 value the tensor core reads."""
    return _from_bits(_bits(x) & 0xFFFFE000)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The fp32 kernel's arithmetic in plain PyTorch: each operand split
    x = hi + lo (hi rounded to TF32, lo = x - hi cut to TF32), then
    hi.lo + lo.hi + hi.hi, each product of TF32 values exact in fp32."""
    a_hi, b_hi = _tf32_rna(a), _tf32_rna(b)
    a_lo, b_lo = _tf32_cut(a - a_hi), _tf32_cut(b - b_hi)
    return (a_hi @ b_lo + a_lo @ b_hi) + a_hi @ b_hi


def _h100_plan():
    return specialize(get_arch("qwen3-8b"),
                      ShapeConfig("serve_h100", "decode", 2048, 8),
                      mesh_shape=(1, 1), target="h100-sxm", cache=False)


# the three cases of the JAX package's test_tiled_matmul
CASES = [(128, 256, 128, 64, 128, 64),
         (256, 128, 512, 128, 64, 128),
         (64, 64, 64, 64, 64, 64)]


@pytest.mark.parametrize("M,K,N,bm,bk,bn", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_matches_pallas_and_ref(M, K, N, bm, bk, bn, dtype):
    (ja, jb), (ta, tb) = _inputs(M + 3 * N, M, K, N, dtype)
    want = jref.tiled_matmul_ref(ja, jb)
    pal = pallas_mm(ja, jb, bm=bm, bk=bk, bn=bn, interpret=True)
    got = ops.matmul(ta, tb, tiles=(bm, bk, bn))
    assert got.dtype == ta.dtype and tuple(got.shape) == (M, N)
    assert _rel_err(_np(got), want) < TOL[dtype]
    assert _rel_err(_np(got), pal) < TOL[dtype]
    assert _rel_err(_np(tref.tiled_matmul_ref(ta, tb)), want) < TOL[dtype]
    assert _rel_err(_np(tmm.tiled_matmul_plain(ta, tb)), want) < TOL[dtype]


# a decode tick (M = 8), a ragged prefill bucket (M = 1000) and mamba2's
# in_proj width (N = 10576, not a multiple of 128), at a small K
RAGGED = [(8, 64, 256), (1000, 64, 200), (24, 32, 10576)]


@pytest.mark.parametrize("M,K,N", RAGGED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_ragged_shapes_match_jnp_dot(M, K, N, dtype):
    (ja, jb), (ta, tb) = _inputs(M * 7 + N, M, K, N, dtype)
    want = jnp.dot(ja.astype(jnp.float32),
                   jb.astype(jnp.float32)).astype(JAX_DTYPES[dtype])
    got = ops.matmul(ta, tb, tiles=ops.matmul_tiles(_h100_plan()))
    assert got.dtype == ta.dtype and tuple(got.shape) == (M, N)
    assert _rel_err(_np(got), want) < TOL[dtype]


def test_tf32_split_rounds_as_the_kernel_does():
    """hi: nearest, ties away from zero; hi + lo == x exactly; lo at most
    2^-11 of x, itself a TF32 value once cut."""
    one_ulp = 2.0 ** -23
    x = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11),
                      1 + 2.0 ** -11 - one_ulp, 1 + 3 * 2.0 ** -11, 3.0, 0.0],
                     dtype=torch.float32)
    want = torch.tensor([1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0,
                         1 + 4 * 2.0 ** -11, 3.0, 0.0], dtype=torch.float32)
    assert torch.equal(_tf32_rna(x), want)
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(
        100_000).astype(np.float32))
    hi = _tf32_rna(r)
    assert bool((_bits(hi) & 0x1FFF == 0).all())
    lo = r - hi
    assert torch.equal(hi.double() + lo.double(), r.double())
    assert bool((lo.abs() <= 2.0 ** -11 * r.abs()).all())
    assert torch.equal(_tf32_cut(_tf32_cut(lo)), _tf32_cut(lo))


@pytest.mark.parametrize("M,K,N,bm,bk,bn", CASES + [(300, 5120, 256, 300,
                                                       1024, 256)])
def test_3xtf32_mirror_matches_pallas_and_ref(M, K, N, bm, bk, bn):
    """The kernel's fp32 arithmetic at the JAX test's tolerance, against
    the Pallas kernel (interpret) and its oracle, at the JAX test's
    shapes and at mamba2's out_proj K = 5120 cut to 300 x 256."""
    (ja, jb), (ta, tb) = _inputs(M + 5 * N, M, K, N, "float32")
    got = _np(_mm_3xtf32(ta, tb))
    assert _rel_err(got, jref.tiled_matmul_ref(ja, jb)) < TOL["float32"]
    assert _rel_err(got, pallas_mm(ja, jb, bm=bm, bk=bk, bn=bn,
                                   interpret=True)) < TOL["float32"]


@pytest.mark.parametrize("M,K,N", [(300, 5120, 256), (37, 1000, 72)])
def test_3xtf32_mirror_matches_fp64_where_1xtf32_does_not(M, K, N):
    """Against an fp64 product: 3xTF32 within 1e-5 (max error over max
    magnitude, and the worst row's rms), the hi-only product (1xTF32)
    past it."""
    (_, _), (ta, tb) = _inputs(M * 11 + N, M, K, N, "float32")
    want = (ta.double() @ tb.double()).numpy()
    got = _mm_3xtf32(ta, tb).double().numpy()
    assert _rel_err(got, want) < TOL["float32"]
    row = np.sqrt(((got - want) ** 2).mean(1) / (want ** 2).mean(1))
    assert row.max() < TOL["float32"]
    one = (_tf32_rna(ta) @ _tf32_rna(tb)).numpy()
    assert _rel_err(one, want) > 3 * TOL["float32"]


def test_kernel_tiles_cover_the_plan_the_default_and_the_jax_cases():
    assert tmm.kernel_tiles(None) == tmm.DEFAULT_TILES
    assert tmm.DEFAULT_TILES in tmm.KERNEL_TILES
    assert ops.matmul_tiles(_h100_plan()) in tmm.KERNEL_TILES
    for case in CASES:
        assert tmm.kernel_tiles(case[3:]) == case[3:]


@pytest.mark.parametrize("tiles", [(128, 128, 128), (256, 64, 128),
                                   (128, 512, 128), (8, 64, 128)])
def test_kernel_tiles_refuse_a_tile_the_kernel_lacks(tiles):
    with pytest.raises(ValueError, match="not one the kernel is built for"):
        tmm.kernel_tiles(tiles)
    # the entry point checks the plan's tile on the CPU as well
    a, b = torch.ones(8, 16), torch.ones(16, 8)
    with pytest.raises(ValueError, match="not one the kernel is built for"):
        ops.matmul(a, b, tiles=tiles)


def test_smem_bytes_matches_the_plan_and_the_kernel_layout():
    plan = _h100_plan()
    bp = plan.partitions["tiled_matmul"]
    tiles = (bp.blocks["bm"], bp.blocks["bk"], bp.blocks["bn"])
    assert bp.vmem_bytes == tmm.smem_bytes(*tiles) <= SMEM_BUDGET
    assert bp.n_buffers == tmm.STAGES
    # the plan records the bf16 ring only: its tile and hash are the
    # parent's, whatever the fp32 layout
    assert tiles == (128, 64, 128) and bp.vmem_bytes == 173_168
    assert plan.content_hash()[:16] == "8b3a96c18fd2bf9d"
    # bf16: four TMA stages of A (bm, bk) and B (bk, bn), their
    # mbarriers and 1 KB of alignment, or, for the 128-row tile, the
    # seven stages of a 64-row A tile it runs at M <= 64, the larger;
    # fp32: 32-deep TMA sub-stages of A (bm, 32), its TF32 low parts and
    # B (32, bn), three mbarriers each, and the 1 KB
    assert tmm.smem_bytes(128, 64, 128) == \
        7 * (64 * 64 + 64 * 128) * 2 + 2 * 7 * 8 + 1024
    assert tmm.smem_bytes(64, 64, 64) == \
        4 * (64 * 64 + 64 * 64) * 2 + 2 * 4 * 8 + 1024
    assert tmm.smem_bytes(128, 64, 128, torch.float32) == \
        3 * ((2 * 128 * 32 + 32 * 128) * 4 + 3 * 8) + 1024
    assert tmm.smem_bytes(64, 64, 64, torch.float32) == \
        4 * ((2 * 64 * 32 + 32 * 64) * 4 + 3 * 8) + 1024
    for t in tmm.KERNEL_TILES:
        # the fp32 ring fits the pass's budget too, so the plan's choice
        # of tile (made on the bf16 ring) holds for fp32
        assert tmm.smem_bytes(*t, torch.float32) <= SMEM_BUDGET, t
        for dt in tmm.DTYPES:
            assert tmm.smem_bytes(*t, dt) <= 232_448, (t, dt)


@pytest.mark.parametrize("M,K,N,sms,want", [
    (1000, 5120, 2560, 132, None), (2048, 5120, 2560, 132, None),
    (4, 0, 64, 132, 1), (1, 64, 8, 132, 1), (8192, 4096, 8192, 132, 1)])
def test_fp32_splits_fill_the_last_wave(M, K, N, sms, want):
    """K splits only where the tiles leave the last wave of CTAs short,
    never past MAX_SPLITS or the sub-stages K has."""
    t = tmm.DEFAULT_TILES
    s = tmm.fp32_splits(M, K, N, t, sms)
    assert 1 <= s <= min(tmm.MAX_SPLITS, max(1, -(-K // tmm.FP32_DEPTH)))
    if want is not None:
        assert s == want
    else:
        ctas = -(-M // t[0]) * -(-N // t[2])
        assert s > 1 and ctas % sms != 0


def test_cpu_tensors_run_the_plain_version_and_launch_nothing():
    ops.reset_launch_counts()
    (_, _), (ta, tb) = _inputs(1, 16, 32, 24, "bfloat16")
    for mode in ops.MODES:
        out = ops.matmul(ta, tb, mode=mode)
        assert torch.equal(out, tmm.tiled_matmul_plain(ta, tb))
    assert ops.launch_counts()["tiled_matmul"] == 0
    with pytest.raises(ValueError, match="kernel mode"):
        ops.matmul(ta, tb, mode="sometimes")
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        tmm.tiled_matmul(ta, tb)


def test_plan_driven_path_end_to_end(tmp_path, capsys):
    """specialize(h100-sxm) -> the plan store -> ``plan show --log`` by
    hash prefix -> ``ops.matmul`` on the reloaded plan's tiles, held
    against the Pallas kernel run on the same tiles."""
    d = tmp_path / "plans"
    plan = specialize(get_arch("qwen3-8b"),
                      ShapeConfig("serve_h100", "decode", 2048, 8),
                      mesh_shape=(1, 1), target="h100-sxm", plan_dir=d)
    h = plan.content_hash()
    assert plan_cli.main(["--plan-dir", str(d), "show", h[:10], "--log"]) == 0
    out = capsys.readouterr().out
    bm, bk, bn = ops.matmul_tiles(plan)
    assert f"[local_partitioning] tiled_matmul: {bm}x{bk}x{bn}" in out
    assert "accumulator in registers" in out
    reloaded = planstore.PlanStore(d).load(h)
    assert reloaded.content_hash() == h
    tiles = ops.matmul_tiles(reloaded)
    (ja, jb), (ta, tb) = _inputs(5, 256, 128, 256, "bfloat16")
    pal = pallas_mm(ja, jb, bm=tiles[0], bk=tiles[1], bn=tiles[2],
                    interpret=True)
    assert _rel_err(_np(ops.matmul(ta, tb, tiles=tiles)), pal) < TOL["bfloat16"]
