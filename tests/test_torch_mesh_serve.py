"""``ServeEngine.from_plan(mesh=...)`` on gloo meshes of CPU ranks.

One world of 8 ranks (started once for the file) serves reduced
qwen3-8b through every placement the plans give it:

* ``n_kv_heads = 1`` on a (1, 8) mesh, dense and paged: the plan picks
  ``shard_map_flash`` (one kv head cannot split 8 ways), the cache's seq
  dim (the pool dim) lands split over the model ranks, and a mixed batch
  is token-identical to sequential single-request runs through the same
  path (the twins of the reference's
  ``test_serve_from_plan_shard_map_flash_end_to_end`` and
  ``test_serve_from_plan_paged_pool_sharded``); the tokens equal the JAX
  engine's on the same weights and plan wherever the reference's top-2
  logit margin exceeds 2e-2 of its largest logit.  A JAX subprocess runs
  that engine beside the world, on one device: under jax 0.9 the
  reference engine on a mesh fails its own cells (the
  embedding gather on a model-split table has no unambiguous output
  sharding), so its one-device path is the anchor;
* a head-sharded (1, 2) plan, and (2, 2) plans (paged: the pool split
  2-D over ``(data, model)``; dense: heads over model, slots over data),
  and reduced granite-moe on a (1, 2) plan (experts split over model):
  tokens equal the JAX engine's (one device, the same plan, weights and
  mixed batch) under the same margin rule, and the port's unsharded
  engine's under the port's own margins; every leaf split over
  ``model`` holds ``1 / msize`` of its elements on each rank, and a 2-D
  pool's piece ``N / (dsize * msize)`` blocks;
* every cell's engine built from the pieces ``lm.init_params(pieces=
  param_pieces(...))`` draws on each rank holds exactly the pieces it
  cuts from the whole weights;
* ``moe_shard_map`` at (2, 4) against
  ``moe_gshard_einsum`` (the reference's bulk bar, > 0.9 of outputs
  within 1e-3) and exactly against a plain per-shard routing computed in
  one process;
* reduced mamba2-2.7b at (1, 2) and (2, 2) (the mixer split over
  ``model``: its heads, conv channels and ``in_proj`` columns; at (2, 2)
  the state pieces hold a data shard's slots, and a ``preempt(rid)`` is
  resumed into another shard's slot), reduced hymba-1.5b at (2, 2)
  (attention heads and SSM heads split; dense, and paged with the pool
  split 2-D) and a reduced hybrid of 6 query
  / 3 kv heads at head_dim 32 with a window, whose (1, 2) plan puts the
  paged cache on rows as full-width hymba's does (its 13 padded kv heads
  do not split two ways): tokens against the JAX engine's on one device
  and the port's unsharded engine's, as the cells above;
* several data axes: reduced qwen3-8b on ``(pod, data, model)`` meshes
  (2, 2, 2) (paged, its pool split 2-D over the linearised ``(pod,
  data)`` shard and ``model``; dense) and reduced hymba-1.5b on (2, 2,
  1), tokens as the cells above;
* a cache split on head_dim: a 10 / 5-head hybrid whose (1, 2) plan on
  the XLA decode splits the cache's head_dim (K9's plain passes decode
  each rank's columns), dense and paged, tokens as the cells above;
* ``elastic_mesh`` over the world (a ``DeviceMesh`` of the survivors, and
  both typed errors), what stays refused (a K9 instance that is not
  built, on CUDA), and the plan's host tier and a prefill fleet built on
  a (1, 2) mesh.

Every rank runs the same engine loop; each rank's tokens are saved and
must agree.
"""

import dataclasses
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
MARGIN_TOL = 2e-2
PROMPTS = [(5, 1), (11, 3), (8, 7), (11, 5), (5, 2)]


def _prompts(vocab, n):
    return [(np.arange(L, dtype=np.int32) * m) % vocab for L, m in PROMPTS[:n]]


def _arch(name="qwen3-8b", kv=0):
    """The reduced arch; ``kv`` its kv heads, or ``(query, kv)`` heads."""
    from repro_torch.configs import get_arch
    a = get_arch(name).reduced()
    if isinstance(kv, tuple):
        return dataclasses.replace(a, n_heads=kv[0], n_kv_heads=kv[1])
    return dataclasses.replace(a, n_kv_heads=kv) if kv else a


def _axes(mesh):
    """A mesh shape's axes: ``(data, model)``, or the production
    mesh's ``(pod, data, model)`` for three dims."""
    return ("pod", "data", "model") if len(mesh) == 3 else ("data", "model")


def _plan(arch, mesh, seq, batch, **kw):
    from repro_torch.configs import ShapeConfig
    from repro_torch.core.pipeline import specialize
    return specialize(arch, ShapeConfig("serve_mesh_t", "decode", seq, batch),
                      mesh_axes=_axes(mesh), mesh_shape=mesh,
                      cache=False, **kw)


def _params(arch, plan):
    from repro_torch.models import lm
    return lm.init_params(arch, torch.Generator().manual_seed(0),
                          *plan.padded_sizes())


#: (name, arch kwargs, mesh, seq, batch, plan kwargs, prompts)
CELLS = {
    "flash_dense": (("qwen3-8b", 1), (1, 8), 32, 2,
                    {"kv_residency": "dense"}, 3),
    "flash_paged": (("qwen3-8b", 1), (1, 8), 64, 4, {}, 5),
    "tp_1x2": (("qwen3-8b", 0), (1, 2), 64, 4, {}, 3),
    "tp_2x2": (("qwen3-8b", 0), (2, 2), 64, 4, {}, 4),
    "tp_2x2_dense": (("qwen3-8b", 0), (2, 2), 64, 4,
                     {"kv_residency": "dense"}, 4),
    "moe_1x2": (("granite-moe-1b-a400m", 0), (1, 2), 64, 4, {}, 3),
    "ssm_1x2": (("mamba2-2.7b", 0), (1, 2), 64, 4, {}, 4),
    "ssm_2x2": (("mamba2-2.7b", 0), (2, 2), 64, 4, {}, 4),
    "hybrid_2x2": (("hymba-1.5b", 0), (2, 2), 64, 4,
                   {"kv_residency": "dense"}, 4),
    "hybrid_2x2_paged": (("hymba-1.5b", 0), (2, 2), 64, 4, {}, 4),
    "hybrid_rows": (("hymba-1.5b", (6, 3)), (1, 2), 64, 4, {}, 4),
    "pod_222": (("qwen3-8b", 0), (2, 2, 2), 64, 8, {}, 5),
    "pod_222_dense": (("qwen3-8b", 0), (2, 2, 2), 64, 8,
                      {"kv_residency": "dense"}, 5),
    "pod_221_hybrid": (("hymba-1.5b", 0), (2, 2, 1), 64, 8, {}, 5),
    "hd_dense": (("hymba-1.5b", (10, 5)), (1, 2), 64, 4,
                 {"kv_residency": "dense", "decode_impl": "xla"}, 4),
    "hd_paged": (("hymba-1.5b", (10, 5)), (1, 2), 64, 4,
                 {"decode_impl": "xla"}, 4),
}

#: cells whose run preempts a request and resumes it
PREEMPT = ("ssm_2x2",)


def _mesh(cell_mesh):
    """The ``(data, model)`` (or ``(pod, data, model)``) mesh of
    ``cell_mesh`` this rank belongs to: the world of 8 cut into ``8 /
    (d * m)`` replicas."""
    from torch.distributed.device_mesh import DeviceMesh
    n = int(np.prod(cell_mesh))
    grid = torch.arange(8).reshape(8 // n, *cell_mesh)
    names = _axes(cell_mesh)
    return DeviceMesh("cpu", grid, mesh_dim_names=("rep",) + names)[names]


def _run(eng, prompts, n=5, stagger=False, preempt=False):
    eng.submit(prompts[0], max_new_tokens=n)
    if stagger:
        eng.step()
    for p in prompts[1:]:
        eng.submit(p, max_new_tokens=n)
    if preempt:
        # the first request, parked after its second token and resumed
        # by a re-prefill into the lowest free slot
        eng.step()
        eng.preempt(min(r.rid for r in eng.active.values()))
    done = eng.run_until_idle(max_ticks=64)
    assert len(done) == len(prompts)
    return {r.prompt.tobytes(): list(r.out_tokens) for r in done}


def _leaf_fractions(eng):
    """``(leaf, local numel * ranks it is split over, whole numel,
    ranks)`` of every parameter and cache leaf: the rank's piece
    against the whole shape ``eng.pieces`` records."""
    out = []
    sizes = dict(zip(eng.cfg.mesh.mesh_dim_names, eng.cfg.mesh.shape))
    pc = eng.pieces
    for which, tree, specs, shapes in (
            ("params", eng.params, pc.param_specs, pc.param_shapes),
            ("cache", eng.cache, pc.cache_specs, pc.cache_shapes)):

        def walk(t, s, w, path):
            if isinstance(t, dict):
                for k in t:
                    walk(t[k], s[k], w[k], f"{path}/{k}")
                return
            n = 1
            for e in s:
                for a in ((e,) if isinstance(e, str) else (e or ())):
                    n *= sizes[a]
            assert tuple(t.shape) == pc.piece_shape(w, s), path
            out.append((path, t.numel() * n, int(np.prod(w)), n))
        walk(tree, specs, shapes, which)
    return out


def _same_pieces(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_pieces(a[k], b[k])
                                            for k in a)
    return torch.equal(a, b)


def _serve_world(rank, world, tmp):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import lm
    from repro_torch.runtime import fault
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.sharded import param_pieces
    torch.set_num_threads(1)          # 8 ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=180))
    res = {}
    for cell, ((name, kv), mesh, seq, batch, kw, n) in CELLS.items():
        arch = _arch(name, kv)
        plan = _plan(arch, mesh, seq, batch, **kw)
        params = torch.load(os.path.join(tmp, f"{cell}.pt"))
        m = _mesh(mesh)
        eng = ServeEngine.from_plan(plan, params, arch=arch, mesh=m)
        prompts = _prompts(arch.vocab_size, n)
        r = {"path": eng.decode_path, "split": eng.cfg.kv_split,
             "combine": eng.combine_topology,
             "cache": {k: tuple(v.shape) for k, v in eng.cache.items()},
             "groups": eng.pool_groups, "n_blocks": eng.n_blocks,
             "tokens": _run(eng, prompts, stagger=True,
                            preempt=cell in PREEMPT),
             "fractions": _leaf_fractions(eng),
             "preemptions": eng.preemptions}
        if eng.kv_residency == "paged":
            st = eng.block_stats()
            r["pool_whole"] = st["free"] == st["total"]
        # the rank's pieces drawn directly, as the launcher builds them
        mine = lm.init_params(arch, torch.Generator().manual_seed(0),
                              *plan.padded_sizes(),
                              pieces=param_pieces(m, plan, arch))
        r["pieces_equal"] = _same_pieces(
            ServeEngine.from_plan(plan, mine, arch=arch, mesh=m).params,
            eng.params)
        if cell.startswith("flash"):
            # sequential single-request runs through the same path (the
            # dense one at max_batch=1; the pool keeps its size, as a
            # smaller engine would clamp it below the 8-way split)
            seqs = {}
            for p in prompts[:3]:
                e2 = ServeEngine.from_plan(
                    plan, params, arch=arch, mesh=m,
                    **({"max_batch": 1} if kw else {}))
                seqs.update(_run(e2, [p]))
                r["seq_path"] = e2.decode_path
            r["sequential"] = seqs
        res[cell] = r
    # moe_shard_map at (2, 4)
    m24 = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    moe = torch.load(os.path.join(tmp, "moe.pt"))
    from repro_torch.models.moe import MoEParams, moe_shard_map
    d, mr = m24.get_local_rank("data"), m24.get_local_rank("model")
    x = moe["x"][d * 2:(d + 1) * 2, mr * 8:(mr + 1) * 8]
    p = MoEParams(moe["router"], moe["wi"][mr * 2:(mr + 1) * 2],
                  moe["wo"][mr * 2:(mr + 1) * 2])
    y, aux = moe_shard_map(x, p, top_k=2, capacity_factor=4.0, mesh=m24)
    res["moe_shard_map"] = (y, aux, (d, mr))
    # elastic re-mesh over the survivors, and its typed errors
    em = fault.elastic_mesh(7, 2)
    res["elastic"] = (tuple(em.shape), tuple(em.mesh_dim_names),
                      em.mesh.tolist(), em.get_coordinate())
    for n, mp_ in ((1, 2), (16, 2)):
        try:
            fault.elastic_mesh(n, mp_)
        except RuntimeError as e:
            res[f"elastic_{n}"] = str(e)
    # what a mesh serves since the host tier and disagg came to it: the
    # plan's host tier (clamped as on one card) and a prefill fleet
    arch = _arch()
    plan = _plan(arch, (1, 2), 64, 4)
    params = _params(arch, plan)
    est = plan.estimates
    eng = ServeEngine.from_plan(plan, params, arch=arch, mesh=_mesh((1, 2)))
    cap = 4 * -(-64 // int(est["kv_block_len"]))
    res["host_tier"] = (eng.host_blocks,
                        min(int(est["kv_host_blocks"]), 8 * cap),
                        eng._host is not None)
    eng = ServeEngine.from_plan(plan, params, arch=arch, mesh=_mesh((1, 2)),
                                kv_prefill_mode="disagg", disagg_workers=1)
    try:
        res["disagg_mode"] = eng.prefill_mode
    finally:
        eng.shutdown()
    # a cache split on its head_dim
    dplan = _plan(arch, (1, 2), 64, 4, kv_residency="dense")
    hd = {k: dataclasses.replace(dplan.placements[k],
                                 spec=(None, None, None, None, "model"))
          for k in ("cache.k", "cache.v")}
    dplan = dataclasses.replace(dplan, placements={**dplan.placements, **hd})
    eng = ServeEngine.from_plan(dplan, _params(arch, dplan), arch=arch,
                                mesh=_mesh((1, 2)))
    res["head_dim"] = (eng.cfg.kv_split, eng.decode_path,
                       tuple(eng.cache["k"].shape),
                       _run(eng, _prompts(arch.vocab_size, 3)))
    torch.save(res, os.path.join(tmp, f"r{rank}.pt"))
    dist.destroy_process_group()


REFERENCE = """
import dataclasses, sys, numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, {src!r})
from repro.configs import ShapeConfig, get_arch
from repro.core.pipeline import specialize
from repro.serve.engine import ServeEngine
out = {{}}
last = [None]


class Tokens(list):
    # a request's tokens, each beside the top-2 margin of its logits
    def __init__(self, margins):
        super().__init__()
        self.margins = margins

    def append(self, tok):
        super().append(tok)
        self.margins.append(last[0])


for cell, (name, kv, mesh, seq, batch, kw, n) in {cells!r}.items():
    arch = get_arch(name).reduced()
    if isinstance(kv, tuple):
        arch = dataclasses.replace(arch, n_heads=kv[0], n_kv_heads=kv[1])
    elif kv:
        arch = dataclasses.replace(arch, n_kv_heads=kv)
    plan = specialize(arch, ShapeConfig("serve_mesh_t", "decode", seq, batch),
                      mesh_axes=("pod", "data", "model") if len(mesh) == 3
                      else ("data", "model"), mesh_shape=mesh,
                      cache=False, **kw)
    flash = cell.startswith("flash")
    if flash:
        assert plan.estimates.get("decode_impl") == "shard_map_flash"
    params = {{}}
    dtypes = np.load({tmp!r} + f"/{{cell}}_dtypes.npz")
    for k, v in np.load({tmp!r} + f"/{{cell}}.npz").items():
        d = params
        parts = k.split("/")
        for p in parts[:-1]:
            d = d.setdefault(p, {{}})
        d[parts[-1]] = jnp.asarray(v).astype(jnp.dtype(str(dtypes[k])))
    # flash cells: one slot, the requests one after another; the others:
    # the port's mixed batch, the first request a tick ahead
    eng = ServeEngine.from_plan(plan, params, arch=arch,
                                **({{"max_batch": 1}} if flash else {{}}))
    sample = eng._sample

    def record(logits, temperature, key, sample=sample, arch=arch):
        lf = np.asarray(logits[:arch.vocab_size], np.float32)
        top = np.sort(lf)[-2:]
        last[0] = float((top[1] - top[0]) / np.abs(lf).max())
        return sample(logits, temperature, key)
    eng._sample = record
    prompts = [(np.arange(L, dtype=np.int32) * m) % arch.vocab_size
               for L, m in {prompts!r}[:n]]
    margins = [[] for _ in prompts]
    for i, p in enumerate(prompts):
        eng.submit(p, max_new_tokens=5)
        eng.pending[-1].out_tokens = Tokens(margins[i])
        if i == 0 and not flash:
            eng.step()
    done = sorted(eng.run_until_idle(max_ticks=256), key=lambda r: r.rid)
    assert len(done) == n
    for i, r in enumerate(done):
        assert len(margins[i]) == 5
        out[f"{{cell}}/{{i}}/tokens"] = np.asarray(r.out_tokens)
        out[f"{{cell}}/{{i}}/margins"] = np.asarray(margins[i])
np.savez({tmp!r} + "/ref.npz", **out)
"""


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else k))
        return out
    return {path: tree}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Parameters made once here (the port's initializer, a seed), the
    8-rank world and the JAX subprocess run side by side."""
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("mesh_serve")
    models = {}
    for cell, ((name, kv), mesh, seq, batch, kw, n) in CELLS.items():
        arch = _arch(name, kv)
        plan = _plan(arch, mesh, seq, batch, **kw)
        params = _params(arch, plan)
        torch.save(params, tmp / f"{cell}.pt")
        models[cell] = (arch, plan, params)
        flat = _flat(params)
        np.savez(tmp / f"{cell}.npz", **{
            k: v.float().numpy() for k, v in flat.items()})
        np.savez(tmp / f"{cell}_dtypes.npz", **{
            k: np.asarray(str(v.dtype).split(".")[-1])
            for k, v in flat.items()})
    g = torch.Generator().manual_seed(1)
    E, d, ff = 8, 16, 32
    moe = {"x": torch.randn(4, 32, d, generator=g).to(torch.bfloat16),
           "router": torch.randn(d, E, generator=g) * 0.5,
           "wi": (torch.randn(E, d, 2 * ff, generator=g) * 0.1).to(
               torch.bfloat16),
           "wo": (torch.randn(E, ff, d, generator=g) * 0.1).to(
               torch.bfloat16)}
    torch.save(moe, tmp / "moe.pt")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=SRC)
    cells = {c: (*v[0], *v[1:]) for c, v in CELLS.items()}
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE.format(
            src=SRC, tmp=str(tmp), cells=cells, prompts=PROMPTS))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        mp.start_processes(_serve_world, args=(8, str(tmp)), nprocs=8,
                           start_method="spawn")
        _, err = ref.communicate(timeout=400)
    finally:
        ref.kill()
    assert ref.returncode == 0, err[-3000:]
    ranks = [torch.load(tmp / f"r{r}.pt", weights_only=False)
             for r in range(8)]
    return ranks, dict(np.load(tmp / "ref.npz")), models, moe


def _margin(arch, params, prompt, out, i) -> float:
    """The port's unsharded top-2 logit margin after ``out[:i]``."""
    from repro_torch.models import lm
    toks = np.concatenate([prompt, np.asarray(out[:i], np.int32)])
    logits, _ = lm.prefill(arch, params, {"tokens": torch.from_numpy(
        toks[None])}, lm.RunCfg())
    lf = logits[0, :arch.vocab_size].float().numpy()
    top = np.sort(lf)[-2:]
    return float((top[1] - top[0]) / np.abs(lf).max())


def _agree(got, want, margin) -> int:
    """``got`` equals ``want`` up to the first step whose margin is
    within the tolerance (then the continuations may part); returns the
    tokens compared."""
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            m = margin(i)
            assert m <= MARGIN_TOL, (i, a, b, m)
            return i
    return len(got)


def _same_on_every_rank(ranks, cell):
    """Every rank decoded the same tokens through the same path, with
    pieces of the same local shapes, and drew the same pieces the
    engine cuts from the whole weights."""
    for r in ranks:
        assert r[cell]["pieces_equal"]
    for r in ranks[1:]:
        for key in ("tokens", "path", "cache", "fractions"):
            assert r[cell][key] == ranks[0][cell][key], key


def _agree_with_reference(ref, cell, tokens, prompts) -> int:
    """The tokens against the JAX engine's on the same weights and plan,
    under the margin rule with the reference's margins; returns the
    tokens compared."""
    compared = 0
    for i, p in enumerate(prompts):
        want = list(ref[f"{cell}/{i}/tokens"])
        margins = ref[f"{cell}/{i}/margins"]
        compared += _agree(tokens[p.tobytes()], want,
                           lambda j: float(margins[j]))
    return compared


@pytest.mark.parametrize("cell", ["flash_dense", "flash_paged"])
def test_shard_map_flash_serves_and_matches_sequential(world, cell):
    ranks, ref, models, _ = world
    arch, plan, params = models[cell]
    r0 = ranks[0][cell]
    assert plan.estimates["decode_impl"] == "shard_map_flash"
    assert r0["path"] == "shard_map_flash" and r0["split"] == "rows"
    assert r0["seq_path"] == "shard_map_flash"
    assert r0["combine"] == "flat"
    L, hd = arch.n_layers, arch.hd
    if cell == "flash_dense":
        assert r0["cache"]["k"] == (L, 2, 32 // 8, 1, hd)
    else:
        assert plan.estimates["kv_n_blocks"] % 8 == 0
        assert r0["cache"]["k"] == (L, r0["n_blocks"] // 8,
                                    plan.estimates["kv_block_len"], 1, hd)
        assert r0["cache"]["block_tbl"][0] == 4     # whole on every rank
        assert r0["pool_whole"]
    _same_on_every_rank(ranks, cell)
    for p, toks in r0["sequential"].items():
        assert r0["tokens"][p] == toks
    # the JAX engine on the same weights, under the margin rule
    prompts = _prompts(arch.vocab_size, CELLS[cell][5])
    assert _agree_with_reference(ref, cell, r0["tokens"],
                                 prompts) >= 5 * len(prompts) // 2


@pytest.mark.parametrize("cell", ["tp_1x2", "tp_2x2", "tp_2x2_dense",
                                  "moe_1x2", "ssm_1x2", "ssm_2x2",
                                  "hybrid_2x2", "hybrid_2x2_paged",
                                  "hybrid_rows", "pod_222", "pod_222_dense",
                                  "pod_221_hybrid", "hd_dense", "hd_paged"])
def test_tensor_parallel_engine_matches_the_unsharded_one(world, cell):
    from repro_torch.serve.engine import ServeEngine
    ranks, ref, models, _ = world
    arch, plan, params = models[cell]
    (name, kv), mesh, seq, batch, kw, n = CELLS[cell]
    r0 = ranks[0][cell]
    # several data axes act as one data group of their product
    dsize, msize = int(np.prod(mesh[:-1])), mesh[-1]
    _same_on_every_rank(ranks, cell)
    if cell in ("tp_2x2", "hybrid_2x2_paged", "pod_222", "pod_221_hybrid"):
        # the pool splits 2-D: one sub-pool a data shard
        assert r0["path"] == "shard_map_flash_paged_2d"
        assert r0["groups"] == dsize
        assert r0["cache"]["k"][1] == r0["n_blocks"] // (dsize * msize)
    elif cell.startswith("ssm"):
        assert r0["path"] == "ssm_recurrence:cpu"
    elif cell.startswith("hd_"):
        # 5 kv heads do not split two ways and the plan's decode is the
        # XLA one: the cache splits on head_dim, K9's passes decode it
        assert plan.placements["cache.k"].spec[4] == "model"
        assert r0["split"] == "head_dim" and r0["path"] == "decode_split:plain"
        assert r0["cache"]["k"][-1] == arch.hd // msize
        assert r0["cache"]["k"][-2] == 5
    elif cell == "hybrid_rows":
        # 3 kv heads do not split two ways: the pool splits by blocks
        assert r0["path"] == "shard_map_flash" and r0["split"] == "rows"
        assert r0["cache"]["k"][1] == r0["n_blocks"] // msize
        assert r0["cache"]["k"][3] == 3
    else:
        assert r0["split"] == "heads"
        assert r0["path"].split(":")[0] in ("paged_decode_attention",
                                            "decode_attention")
    if cell in ("tp_2x2_dense", "pod_222_dense"):
        assert r0["cache"]["k"][1] == batch // dsize
    if arch.has_ssm:
        # the SSM state on the rank's heads, the conv window on its
        # channels, the slots of its data shard
        H, P, N = arch.ssm_heads, arch.ssm_head_dim, arch.ssm_state
        C = H * P + 2 * arch.ssm_n_groups * N
        assert r0["cache"]["ssm"] == (arch.n_layers, batch // dsize,
                                      H // msize, P, N)
        assert r0["cache"]["conv"] == (arch.n_layers, batch // dsize,
                                       arch.ssm_conv, C // msize)
    assert r0["preemptions"] == (1 if cell in CELLS and cell in PREEMPT
                                 else 0)
    split = 0
    for path, local_times_n, whole, n_split in r0["fractions"]:
        assert local_times_n == whole, path
        split += n_split > 1
    assert split >= 8 or msize == 1
    # the JAX engine on the same weights, plan and mixed batch
    prompts = _prompts(arch.vocab_size, n)
    assert _agree_with_reference(ref, cell, r0["tokens"],
                                 prompts) >= 5 * n // 2
    # the port's unsharded engine, under the port's own margins
    one = _plan(arch, (1, 1), seq, batch, **kw)
    assert one.padded_sizes() == plan.padded_sizes()
    eng = ServeEngine.from_plan(one, params, arch=arch, max_batch=batch)
    want = _run(eng, prompts, stagger=True)
    assert eng.decode_path.split(":")[0] != r0["path"].split(":")[0] \
        or not arch.has_attention or r0["split"] == "heads"
    compared = 0
    for p, toks in want.items():
        prompt = np.frombuffer(p, np.int32)
        compared += _agree(r0["tokens"][p], toks, lambda i: _margin(
            arch, params, prompt, toks, i))
    assert compared >= 5 * n // 2


def test_moe_shard_map_matches_gshard_and_per_shard_routing(world):
    from repro_torch.models.moe import MoEParams, moe_gshard_einsum
    ranks, _, _, moe = world
    p = MoEParams(moe["router"], moe["wi"], moe["wo"])
    y_all, _ = moe_gshard_einsum(moe["x"], p, top_k=2, capacity_factor=4.0)
    y = torch.zeros_like(moe["x"])
    auxes = set()
    for r in ranks:
        yl, aux, (d, m) = r["moe_shard_map"]
        rows, cols = slice(d * 2, (d + 1) * 2), slice(m * 8, (m + 1) * 8)
        y[rows, cols] = yl
        auxes.add(float(aux))
        # the plain routing of this shard's 16 tokens as one group
        xs = moe["x"][rows, cols].reshape(1, 16, -1)
        want, _ = moe_gshard_einsum(xs, p, top_k=2, capacity_factor=4.0)
        assert torch.equal(yl, want.reshape(yl.shape))
    close = ((y.float() - y_all.float()).abs() < 1e-3).float().mean()
    assert float(close) > 0.9, float(close)
    assert len(auxes) == 1


def test_elastic_mesh_is_a_device_mesh_of_the_survivors(world):
    ranks, _, _, _ = world
    for rank, r in enumerate(ranks):
        shape, names, grid, coord = r["elastic"]
        assert shape == (3, 2) and names == ("data", "model")
        assert grid == [[0, 1], [2, 3], [4, 5]]
        want = None if rank >= 6 else (rank // 2, rank % 2)
        assert (None if coord is None else tuple(coord)) == want
        assert "cannot host" in r["elastic_1"]
        assert "visible" in r["elastic_16"]


def test_what_a_mesh_does_not_serve_names_item_10b(world):
    """What stays refused on a mesh: a head_dim split whose K9 instance
    ``(G, head_dim / m)`` is not built, on CUDA, before any weight
    (``lm.check_on_device``, naming K9; the plain passes serve it on the
    CPU).  Several data axes serve (the ``pod_*`` cells above), a cache
    split on its head_dim serves (a (1, 2) plan whose cache placement is
    set to head_dim: K9's plain passes, the tokens of the unsharded
    engine), and the host tier and a prefill fleet build: the plan's
    clamped host tier is kept (allocated as the rank's piece), and a
    fleet of one worker turns the prefill mode to ``disagg`` (SSM and
    hybrid archs serve: the cells above; ``tests/test_torch_mesh_tier.py``
    serves the tier and the fleet)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.sharded import cache_split
    ranks, _, _, _ = world
    for r in ranks:
        got, want, allocated = r["host_tier"]
        assert got == want > 0 and allocated
        assert r["disagg_mode"] == "disagg"
    arch = _arch()
    split, path, kshape, tokens = ranks[0]["head_dim"]
    assert split == "head_dim" and path == "decode_split:plain"
    assert kshape[-1] == arch.hd // 2
    for r in ranks[1:2]:
        assert r["head_dim"][3] == tokens
    plan = _plan(arch, (1, 1), 64, 4, kv_residency="dense")
    params = _params(arch, plan)
    eng = ServeEngine.from_plan(plan, params, arch=arch)
    want = _run(eng, _prompts(arch.vocab_size, 3))
    for p, toks in want.items():
        prompt = np.frombuffer(p, np.int32)
        _agree(tokens[p], toks, lambda i: _margin(arch, params, prompt,
                                                  toks, i))
    # full-width hymba-1.5b: its (1, 2) plan on the XLA decode splits the
    # cache's head_dim two ways (26 / 13 padded heads: K9 at (2, 32),
    # built); an 8-way split would need (2, 8), which is not
    hymba = get_arch("hymba-1.5b")
    hplan = _plan(hymba, (1, 2), 2048, 8, decode_impl="xla")
    split = cache_split(hplan, hymba)
    assert split[:2] == ("head_dim", 2)

    def ways(m):
        return lm.kernel_instances(hymba, "decode", hplan,
                                   cache_split=("head_dim", m, split[2]))
    lm.check_on_device(hymba, "cuda", instances=ways(2))
    with pytest.raises(NotImplementedError,
                       match=r"K9 decode_split at \(G, head_dim / m\) = "
                       r"\(2, 8\)"):
        lm.check_on_device(hymba, "cuda", instances=ways(8))
    assert lm.check_on_device(hymba, "cpu", instances=ways(8)) is None


def test_launcher_serves_on_a_mesh_under_torchrun():
    """``launch.serve --mesh 1x2`` under ``torchrun --standalone`` (its
    own free port) on the CPU over gloo: rank 0 reports the mesh plan
    and every request served."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
         "--mesh", "1x2", "--device", "cpu", "--requests", "3",
         "--new-tokens", "4", "--max-len", "64", "--max-batch", "4"],
        capture_output=True, text=True, env=env, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "mesh=(1, 2)" in out.stdout
    assert out.stdout.count("served 3 requests, 12 tokens") == 1


def test_check_fits_measures_a_rank_and_names_the_mesh(monkeypatch):
    """One rank's share of full-width qwen2-vl-72b on a (1, 8) plan is
    an eighth of its split leaves, and fits the card; one card cannot
    hold the whole (145 GB), and the refusal names the model axis whose
    share would fit in 0.9 of it (four ranks)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve as tserve
    arch = get_arch("qwen2-vl-72b")
    plan = _plan(arch, (1, 8), 2048, 8)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (80 * 10 ** 9, 80 * 10 ** 9))
    tserve.check_fits(arch, plan.padded_sizes(), "cuda", plan=plan)
    one = _plan(arch, (1, 1), 2048, 8)
    with pytest.raises(NotImplementedError, match=r"bytes a rank.*on the "
                       r"card.*ROADMAP item 10.*--mesh 1x4"):
        tserve.check_fits(arch, one.padded_sizes(), "cuda", plan=one)
