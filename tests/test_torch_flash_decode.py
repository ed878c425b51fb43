"""The sharded flash decode (``repro_torch.dist.flash_decode``) against
the JAX package on gloo worlds.

One world of 8 CPU ranks runs, once for the file, every case of the
reference's passing mesh cells (``test_flash_decode_sharded_matches_oracle``,
``test_flash_decode_paged_pool_sharded_matches_oracle``,
``test_flash_decode_paged_2d_matches_oracle``,
``test_flash_decode_paged_2d_aliased_tables``,
``test_combine_topology_matrix_ring_bidir_vs_flat``) on a (1, 4) and a
(2, 4) ``(data, model)`` mesh, under the ``flat``, ``ring`` and
``bidir`` combines: dense caches at scalar and per-slot ``pos``, windows
0 and 16; paged pools 1-D and 2-D, and 2-D with aliased tables.  Each
rank saves its rows of the context and its pieces of the appended
caches.  Beside it, one JAX subprocess with 8 host devices runs the
reference's ``flash_decode`` / ``flash_decode_paged`` (its flat
combine; its own matrix holds ring and bidir to it) and the
``kernels/ref.py`` oracles on the same inputs (numpy, from a seed) and
writes them as ``.npz``.

The bars: the oracles at 1e-5 (fp32), ``ring`` bitwise equal to
``bidir`` and ``flat`` within 1e-6 of them, the reference's outputs at
1e-5, the appended caches equal.  On the CPU the per-rank partial is the
plain twin of the reference's ``_partial_attend`` (``NEG_INF`` and all),
held against it in-process; the decode kernels' ``PARTIAL`` mode is held
against that twin on the card (``tests/test_torch_cuda.py``).
"""

import datetime
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

SRC = str(Path(__file__).resolve().parents[1] / "src")
TOPOS = ("flat", "ring", "bidir")
MESHES = ("1x4", "2x4")
B, S, H, K, D = 4, 64, 8, 4, 16
BL, N = 8, 16
DENSE = {"scalar10": (10, 0), "scalar40w16": (40, 16), "scalar63": (63, 0),
         "slots": ([10, 40, 63, 0], 0), "slots_w16": ([5, 17, 33, 60], 16)}
TBL_1D = [[0, 9, 3, -1], [14, 2, -1, -1], [5, 7, 11, 13]]
TBL_2D = [[0, 5, 3, -1], [7, 2, -1, -1], [8, 15, 11, 13], [9, 14, -1, -1]]
TBL_ALIAS = [[0, 5, 2, -1], [0, 5, 6, -1], [8, 15, 11, 13], [8, 15, 12, -1]]
PAGED = {"1d": (TBL_1D, [16, 8, 31], 0), "1d_w8": (TBL_1D, [20, 14, 27], 8),
         "2d": (TBL_2D, [16, 8, 31, 10], 0),
         "2d_w8": (TBL_2D, [20, 14, 27, 4], 8),
         "2d_w6": (TBL_2D, [0, 15, 24, 9], 6),
         "alias": (TBL_ALIAS, [17, 20, 27, 16], 0),
         "alias_w8": (TBL_ALIAS, [17, 20, 27, 16], 8)}


def _inputs():
    r = np.random.default_rng(0)
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"q": f(B, 1, H, D), "kn": f(B, 1, K, D), "vn": f(B, 1, K, D),
            "kc": f(B, S, K, D), "vc": f(B, S, K, D),
            "kp": f(N, BL, K, D), "vp": f(N, BL, K, D)}


REFERENCE = """
import os, sys, numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, {src!r})
from repro.dist.flash_decode import flash_decode, flash_decode_paged
from repro.kernels import ref
inp = dict(np.load({inp!r}))
out = {{}}
for name, shape in (("1x4", (1, 4)), ("2x4", (2, 4))):
    n = shape[0] * shape[1]
    mesh = jax.make_mesh(shape, ("data", "model"), devices=jax.devices()[:n])
    q, kn, vn = (jnp.asarray(inp[k]) for k in ("q", "kn", "vn"))
    for case, (pos, win) in {dense!r}.items():
        p = jnp.asarray(pos, jnp.int32)
        pp = jnp.broadcast_to(p, ({B},)) if p.ndim == 0 else p
        kr = ref.decode_append_ref(jnp.asarray(inp["kc"]), kn, pp)
        vr = ref.decode_append_ref(jnp.asarray(inp["vc"]), vn, pp)
        out[f"dense/{{case}}/oracle"] = np.asarray(ref.decode_attention_ref(
            q[:, 0], kr, vr, cache_len=pp + 1, window=win))
        out[f"dense/{{case}}/kc"] = np.asarray(kr)
        ctx, kc, vc = jax.jit(lambda *a: flash_decode(
            *a, mesh=mesh, combine="flat"))(q, kn, vn, inp["kc"], inp["vc"],
                                            p, win)
        out[f"{{name}}/dense/{{case}}"] = np.asarray(ctx[:, 0])
    for case, (tbl, pos, win) in {paged!r}.items():
        tb = jnp.asarray(tbl, jnp.int32)
        b = tb.shape[0]
        p = jnp.asarray(pos, jnp.int32)
        kr = ref.paged_append_ref(jnp.asarray(inp["kp"]), kn[:b], p, tb)
        vr = ref.paged_append_ref(jnp.asarray(inp["vp"]), vn[:b], p, tb)
        out[f"paged/{{case}}/oracle"] = np.asarray(
            ref.paged_decode_attention_ref(q[:b, 0], kr, vr, tb,
                                           cache_len=p + 1, window=win))
        out[f"paged/{{case}}/kp"] = np.asarray(kr)
        out[f"paged/{{case}}/vp"] = np.asarray(vr)
        ctx, kp, vp = jax.jit(lambda *a: flash_decode_paged(
            *a, mesh=mesh, combine="flat"))(q[:b], kn[:b], vn[:b], inp["kp"],
                                            inp["vp"], tb, p, win)
        out[f"{{name}}/paged/{{case}}"] = np.asarray(ctx[:, 0])
np.savez({out!r}, **out)
"""


def _world(rank: int, world: int, tmp: str) -> None:
    """One rank of the gloo world: every case on both meshes."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    from repro_torch.dist import flash_decode as fd
    from repro_torch.dist.sharding import shard_index
    torch.set_num_threads(1)          # the ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    rows3 = DeviceMesh("cpu", torch.arange(8).reshape(2, 1, 4),
                       mesh_dim_names=("rep", "data", "model"))
    meshes = {"1x4": rows3["data", "model"],
              "2x4": init_device_mesh("cpu", (2, 4),
                                      mesh_dim_names=("data", "model"))}
    inp = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    out = {}
    for name, mesh in meshes.items():
        dsz = mesh.size(0)
        m = mesh.get_local_rank("model")
        for case, (pos, win) in DENSE.items():
            bd, bn = (mesh.get_local_rank("data"), B // dsz) \
                if dsz > 1 else (0, B)
            rows = slice(bd * bn, (bd + 1) * bn)
            sl = slice(m * (S // 4), (m + 1) * (S // 4))
            p = torch.as_tensor(pos, dtype=torch.int32).expand(B)[rows]
            for t in TOPOS:
                kc = inp["kc"][rows, sl].clone()
                vc = inp["vc"][rows, sl].clone()
                ctx, kc, vc = fd.flash_decode(
                    inp["q"][rows], inp["kn"][rows], inp["vn"][rows], kc, vc,
                    p, win, mesh=mesh, combine=t, seq_len=S, batch=B)
                out[f"{name}/dense/{case}/{t}"] = (ctx[:, 0], kc, rows, sl)
        for case, (tbl, pos, win) in PAGED.items():
            b = len(tbl)
            kind = fd.pool_sharding_kind(mesh, N, b)
            if kind == "2d":
                i, n = shard_index(mesh, ("data", "model"))
                rows = slice(mesh.get_local_rank("data") * (b // dsz),
                             (mesh.get_local_rank("data") + 1) * (b // dsz))
            else:
                i, n = m, 4
                rows = slice(0, b)
            blocks = slice(i * (N // n), (i + 1) * (N // n))
            tb = torch.as_tensor(tbl, dtype=torch.int32)[rows]
            p = torch.as_tensor(pos, dtype=torch.int32)[rows]
            for t in TOPOS:
                kp, vp = inp["kp"][blocks].clone(), inp["vp"][blocks].clone()
                ctx, kp, vp = fd.flash_decode_paged(
                    inp["q"][:b][rows], inp["kn"][:b][rows],
                    inp["vn"][:b][rows], kp, vp, tb, p, win, mesh=mesh,
                    combine=t, n_blocks=N, batch=b)
                out[f"{name}/paged/{case}/{t}"] = (ctx[:, 0], kp, vp, rows,
                                                   blocks, kind)
    torch.save(out, os.path.join(tmp, f"r{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's 8 ranks and the JAX subprocess, run side by side."""
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("flash_decode")
    np.savez(tmp / "inputs.npz", **_inputs())
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=SRC)
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE.format(
            src=SRC, inp=str(tmp / "inputs.npz"), out=str(tmp / "ref.npz"),
            dense=DENSE, paged=PAGED, B=B))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        mp.start_processes(_world, args=(8, str(tmp)), nprocs=8,
                           start_method="spawn")
        _, err = ref.communicate(timeout=300)
    finally:
        ref.kill()
    assert ref.returncode == 0, err[-3000:]
    ranks = [torch.load(tmp / f"r{r}.pt", weights_only=False)
             for r in range(8)]
    return ranks, dict(np.load(tmp / "ref.npz"))


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", list(DENSE))
def test_flash_decode_dense_matches_oracle_and_reference(runs, mesh, case):
    ranks, ref = runs
    oracle, kc_want = ref[f"dense/{case}/oracle"], ref[f"dense/{case}/kc"]
    for r in ranks:
        outs = {t: r[f"{mesh}/dense/{case}/{t}"] for t in TOPOS}
        ctx = {t: o[0].numpy() for t, o in outs.items()}
        rows, sl = outs["flat"][2], outs["flat"][3]
        assert np.array_equal(ctx["ring"], ctx["bidir"])
        assert _err(ctx["ring"], ctx["flat"]) < 1e-6
        for t in TOPOS:
            assert _err(ctx[t], oracle[rows]) < 1e-5, (t, _err(ctx[t],
                                                              oracle[rows]))
            assert _err(ctx[t], ref[f"{mesh}/dense/{case}"][rows]) < 1e-5
            assert np.array_equal(outs[t][1].numpy(), kc_want[rows, sl])


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", list(PAGED))
def test_flash_decode_paged_matches_oracle_and_reference(runs, mesh, case):
    ranks, ref = runs
    oracle = ref[f"paged/{case}/oracle"]
    kinds = set()
    for r in ranks:
        outs = {t: r[f"{mesh}/paged/{case}/{t}"] for t in TOPOS}
        ctx = {t: o[0].numpy() for t, o in outs.items()}
        _, _, _, rows, blocks, kind = outs["flat"]
        kinds.add(kind)
        assert np.array_equal(ctx["ring"], ctx["bidir"])
        assert _err(ctx["ring"], ctx["flat"]) < 1e-6
        for t in TOPOS:
            assert _err(ctx[t], oracle[rows]) < 1e-5
            assert _err(ctx[t], ref[f"{mesh}/paged/{case}"][rows]) < 1e-5
            assert np.array_equal(outs[t][1].numpy(),
                                  ref[f"paged/{case}/kp"][blocks])
            assert np.array_equal(outs[t][2].numpy(),
                                  ref[f"paged/{case}/vp"][blocks])
    want = "2d" if mesh == "2x4" and not case.startswith("1d") else "1d"
    assert kinds == {want}


@pytest.mark.parametrize("window", [0, 8])
def test_plain_partials_match_the_reference(window):
    """The CPU route of the per-rank partial is the reference's
    ``_partial_attend`` / ``_partial_attend_paged``, ``(m, l, acc)``
    term for term (fully masked shards too: ``NEG_INF``, ``l`` = the
    row count), on a slice that starts mid-cache and on a sub-pool
    whose table is compacted (fewer local blocks than table columns)."""
    import jax.numpy as jnp

    from repro.dist import flash_decode as rfd
    from repro_torch.dist import flash_decode as tfd
    inp = _inputs()
    pos = np.asarray([10, 40, 63, 20], np.int32)
    q, kc, vc = inp["q"], inp["kc"][:, 16:32], inp["vc"][:, 16:32]
    want = rfd._partial_attend(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), 16 + jnp.arange(16),
                               jnp.asarray(pos), jnp.int32(window))
    got = tfd._partial_attend(torch.from_numpy(q), torch.from_numpy(kc),
                              torch.from_numpy(vc), 16, torch.from_numpy(pos),
                              window)
    for g, w in zip(got, want):
        assert _err(g.numpy().reshape(np.shape(w)), w) < 1e-5
    tbl = np.asarray(TBL_2D, np.int32)
    ppos = np.asarray([16, 8, 31, 10], np.int32)
    for start, nl in ((0, 2), (8, 2), (4, 4), (0, 16)):
        kp, vp = inp["kp"][start:start + nl], inp["vp"][start:start + nl]
        want = rfd._partial_attend_paged(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(tbl), jnp.asarray(ppos), jnp.int32(window), start)
        got = tfd._partial_attend_paged(
            torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(tbl), torch.from_numpy(ppos), window, start)
        for g, w in zip(got, want):
            assert _err(g.numpy().reshape(np.shape(w)), w) < 1e-5, (start, nl)


def test_predicates_match_the_reference():
    from repro.dist import flash_decode as rfd
    from repro_torch.dist import flash_decode as tfd
    for sizes in ({"data": 1, "model": 8}, {"data": 2, "model": 4},
                  {"data": 4, "model": 2}, {"data": 8, "model": 1}):
        for n, b in ((16, 4), (16, 3), (8, 4), (12, 2), (0, 4)):
            assert tfd.pool_sharding_kind(sizes, n, b) == \
                rfd.pool_sharding_kind(sizes, n, b)
            assert tfd.uses_pool_sharding(sizes, n) == \
                rfd.uses_pool_sharding(sizes, n)
            assert tfd.uses_seq_sharding(sizes, n) == \
                rfd.uses_seq_sharding(sizes, n)
        for over in (None, "ring", "bidir", "flat"):
            assert tfd.combine_topology(sizes, override=over) == \
                rfd.combine_topology(sizes, override=over)
    with pytest.raises(ValueError):
        tfd.combine_topology({"model": 8}, override="hypercube")


def test_whole_tensors_where_pieces_are_due_raise():
    """A dispatch that wants the rank's piece refuses a whole cache."""
    from repro_torch.dist import flash_decode as tfd
    inp = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    with pytest.raises(ValueError, match="piece"):
        tfd.flash_decode(inp["q"], inp["kn"], inp["vn"], inp["kc"],
                         inp["vc"], 3, mesh={"data": 1, "model": 4})
