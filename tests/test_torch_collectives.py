"""``repro_torch.dist.collectives`` against the JAX package.

In-process: ``quantize_int8``, ``dequantize_int8`` and ``ef_compress``
bitwise on the codes (both round half to even) and their scales and
residuals at fp32 rounding; ``compressed_slice_sum`` at 1e-6.  In a gloo
world of 4 CPU ranks (started once for the file): ``compressed_psum``
over the world against ``compressed_slice_sum`` of the stacked inputs,
and the error-feedback telescoping identity ``mean + mean_i(err_i) ==
mean_i(x_i)``.  The reference's own multi-shard cell fails under jax
0.9, so the anchor is ``compressed_slice_sum``, not it.
"""

import datetime
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import collectives as rcol
from repro_torch.dist import collectives as tcol

SHAPES = ((7,), (128,), (3, 200), (2, 5, 129))


def _x(seed, shape, scale=1.0):
    r = np.random.default_rng(seed)
    x = (r.standard_normal(shape) * scale).astype(np.float32)
    # exact halves of a code step land on the rounding rule
    x.reshape(-1)[::17] = 0.5 * (np.arange(x.size)[::17] % 5)
    return x


@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_roundtrip_matches_the_reference(shape):
    x = _x(0, shape)
    rq, rs, rp = rcol.quantize_int8(jnp.asarray(x))
    tq, ts, tp = tcol.quantize_int8(torch.from_numpy(x))
    assert tp == rp
    assert np.array_equal(tq.numpy(), np.asarray(rq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(rs), rtol=1e-7)
    rd = rcol.dequantize_int8(rq, rs, rp, shape)
    td = tcol.dequantize_int8(tq, ts, tp, shape)
    np.testing.assert_allclose(td.numpy(), np.asarray(rd), rtol=1e-6,
                               atol=1e-7)
    # the block bound: half a code step
    amax = np.abs(np.pad(x.reshape(-1), (0, tp)).reshape(-1, 128)).max(1)
    err = np.abs(np.pad((td.numpy() - x).reshape(-1), (0, tp))
                 ).reshape(-1, 128).max(1)
    assert (err <= amax / 254 * (1 + 1e-5) + 1e-12).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_ef_compress_matches_the_reference(shape):
    g = _x(1, shape)
    err0 = _x(2, shape, 1e-3)
    for err in (None, err0):
        rg, re = rcol.ef_compress(jnp.asarray(g), None if err is None
                                  else jnp.asarray(err))
        tg, te = tcol.ef_compress(torch.from_numpy(g), None if err is None
                                  else torch.from_numpy(err))
        np.testing.assert_allclose(tg.numpy(), np.asarray(rg), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(te.numpy(), np.asarray(re), rtol=1e-5,
                                   atol=1e-7)
        # what was delivered plus the residual is what came in
        acc = g if err is None else g + err
        np.testing.assert_allclose(tg.numpy() + te.numpy(), acc, atol=1e-6)
    st = tcol.ef_state({"a": torch.zeros(3, 4), "b": {"c": torch.ones(5)}},
                       replicas=2)
    assert st["a"].shape == (2, 3, 4) and st["b"]["c"].dtype == torch.bfloat16


@pytest.mark.parametrize("shape", ((4, 7), (4, 3, 300), (8, 128)))
def test_compressed_slice_sum_matches_the_reference(shape):
    x = _x(3, shape)
    rm, re = rcol.compressed_slice_sum(jnp.asarray(x))
    tm, te = tcol.compressed_slice_sum(torch.from_numpy(x))
    np.testing.assert_allclose(tm.numpy(), np.asarray(rm), atol=1e-6)
    np.testing.assert_allclose(te.numpy(), np.asarray(re), atol=1e-6)
    np.testing.assert_allclose(tm.numpy() + te.numpy().mean(0), x.mean(0),
                               atol=1e-6)


def _world(rank, world, tmp):
    import torch.distributed as dist
    torch.set_num_threads(1)          # the ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    out = {}
    for i, shape in enumerate(((16,), (3, 200), (2, 2, 129))):
        x = torch.from_numpy(_x(10 + rank, shape, 1.0 + rank))
        out[i] = tcol.compressed_psum(x, None)
    torch.save(out, os.path.join(tmp, f"r{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def psum(tmp_path_factory):
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("collectives")
    mp.start_processes(_world, args=(4, str(tmp)), nprocs=4,
                       start_method="spawn")
    return [torch.load(tmp / f"r{r}.pt") for r in range(4)]


@pytest.mark.parametrize("i,shape", enumerate(((16,), (3, 200),
                                               (2, 2, 129))))
def test_compressed_psum_over_four_ranks(psum, i, shape):
    xs = np.stack([_x(10 + r, shape, 1.0 + r) for r in range(4)])
    want_mean, want_err = tcol.compressed_slice_sum(torch.from_numpy(xs))
    rmean, _ = rcol.compressed_slice_sum(jnp.asarray(xs))
    for r in range(4):
        y, err = psum[r][i]
        # every rank holds the same mean: the shared-scale code sum
        np.testing.assert_allclose(y.numpy(), want_mean.numpy(), atol=1e-6)
        np.testing.assert_allclose(y.numpy(), np.asarray(rmean), atol=1e-6)
        np.testing.assert_allclose(err.numpy(), want_err[r].numpy(),
                                   atol=1e-6)
    errs = np.stack([psum[r][i][1].numpy() for r in range(4)])
    np.testing.assert_allclose(psum[0][i][0].numpy() + errs.mean(0),
                               xs.mean(0), atol=1e-5)
