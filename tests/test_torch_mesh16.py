"""The reference's 16x16 cells whose heads the layout pass pads, cut to a
gloo world of 4 CPU ranks (the pass's rule at TP = 4), each rank held
against one rank on the same padded weights.

* F7, a hybrid whose SSM and attention heads both pad: 6 SSM heads
  padded to 8 (as hymba-1.5b's 50 to 64 on 16 ranks) and 6 / 2
  attention heads padded to 8 / 2, its kv heads whole on every rank, so
  the paged pool (or the dense cache's rows) split over ``model`` and
  K8 decodes every head (G = 4) while flash runs the rank's 2 heads of
  one group.  The plan's placement of the SSM state was repaired
  against the arch's 6 heads (not split), while the mixer splits the
  padded 8: the decode stopped at the state's update.  Now the state
  holds the rank's 2 heads; paged and dense, the tokens equal the
  one-rank engine's under the mesh tests' margin rule.
* llama4-maverick's pattern on a dense arch: 10 / 2 heads padded to 12
  / 2, G = 6 globally and 3 a rank (3 heads inside one group, over one
  kv head): prefill and decode through the engine against one rank,
  flash seen at G = 3 and K8 at G = 6; the loss and every gradient
  piece of a tensor-parallel train step against one rank's.
* the flash plain version at G = 3 against the JAX reference's
  ``ref.flash_attention_ref``.
"""

import dataclasses
import datetime
import os
from pathlib import Path

import numpy as np
import pytest
import torch

SRC = str(Path(__file__).resolve().parents[1] / "src")
MARGIN_TOL = 2e-2       # tests/test_torch_mesh_serve.py's margin rule
BF16_TOL = 2e-2
PROMPTS = [(5, 1), (11, 3), (8, 7)]
WORLD = 4


def _hybrid():
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch("hymba-1.5b").reduced(), d_model=96,
                               n_heads=6, n_kv_heads=2)


def _g3():
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch("qwen3-8b").reduced(), n_heads=10,
                               n_kv_heads=2)


#: cell -> (arch, plan keywords)
CELLS = {"hybrid_paged": (_hybrid, {}),
         "hybrid_dense": (_hybrid, {"kv_residency": "dense"}),
         "g3_paged": (_g3, {})}


def _plan(arch, **kw):
    from repro_torch.configs import ShapeConfig
    from repro_torch.core.pipeline import specialize
    return specialize(arch, ShapeConfig("mesh16_t", "decode", 64, 4),
                      mesh_axes=("data", "model"), mesh_shape=(1, WORLD),
                      cache=False, **kw)


def _params(arch, plan, pieces=None):
    from repro_torch.models import lm
    return lm.init_params(arch, torch.Generator().manual_seed(0),
                          *plan.padded_sizes(), pieces=pieces)


def _prompts(vocab):
    return [(np.arange(L, dtype=np.int32) * m) % vocab for L, m in PROMPTS]


def _run(eng, prompts):
    eng.submit(prompts[0], max_new_tokens=5)
    eng.step()
    for p in prompts[1:]:
        eng.submit(p, max_new_tokens=5)
    done = eng.run_until_idle(max_ticks=64)
    assert len(done) == len(prompts)
    return {r.prompt.tobytes(): list(r.out_tokens) for r in done}


def _batch(vocab):
    g = np.random.default_rng(3)
    toks = g.integers(0, vocab, size=(2, 33), dtype=np.int64)
    return {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)),
            "targets": torch.from_numpy(toks[:, 1:].astype(np.int32))}


def _trainable(tree):
    if isinstance(tree, dict):
        return {k: _trainable(v) for k, v in tree.items()}
    return tree.float().requires_grad_(True) if tree.is_floating_point() \
        else tree


def _grads(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_grads(v, f"{path}/{k}" if path else k))
        return out
    return {path: tree.grad.detach().clone()} if tree.grad is not None \
        else {}


def _loss_and_grads(arch, params, cfg):
    from repro_torch.models import lm
    params = _trainable(params)
    loss, _ = lm.train_loss(arch, params, _batch(arch.vocab_size), cfg)
    loss.backward()
    return float(loss.detach()), _grads(params)


class _Groups:
    """The GQA groups the plain kernels were called at, by entry."""

    def __init__(self):
        from repro_torch.kernels import decode_attention as dec
        from repro_torch.kernels import flash_attention as fa
        self.seen = {}
        self.mods = [(fa, "flash_attention_plain"),
                     (dec, "decode_partial_plain"),
                     (dec, "paged_decode_partial_plain")]
        self.orig = [getattr(m, n) for m, n in self.mods]
        for (m, n), f in zip(self.mods, self.orig):
            setattr(m, n, self._wrap(n, f))

    def _wrap(self, name, f):
        def call(q, k, *a, **kw):
            H = q.shape[-2]
            self.seen.setdefault(name, set()).add(H // k.shape[2])
            return f(q, k, *a, **kw)
        return call

    def close(self):
        for (m, n), f in zip(self.mods, self.orig):
            setattr(m, n, f)


def _world(rank, world, tmp):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.passes.lowering import build_run_cfg
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.sharded import param_pieces
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    mesh = init_device_mesh("cpu", (1, world),
                            mesh_dim_names=("data", "model"))
    res = {}
    for cell, (make, kw) in CELLS.items():
        arch = make()
        plan = _plan(arch, **kw)
        groups = _Groups()
        try:
            eng = ServeEngine.from_plan(plan, _params(arch, plan), arch=arch,
                                        mesh=mesh)
            res[cell] = {"tokens": _run(eng, _prompts(arch.vocab_size)),
                         "path": eng.decode_path, "split": eng.cfg.kv_split,
                         "cache": {k: tuple(v.shape)
                                   for k, v in eng.cache.items()}}
        except Exception as e:      # noqa: BLE001 - every rank records it
            res[cell] = {"error": f"{type(e).__name__}: {e}"}
        finally:
            groups.close()
        res[cell]["groups"] = groups.seen
    # a tensor-parallel train step's loss and gradient pieces at G = 3
    arch = _g3()
    plan = _plan(arch)
    pieces = param_pieces(mesh, plan, arch)
    groups = _Groups()
    try:
        loss, grads = _loss_and_grads(
            arch, _params(arch, plan, pieces), build_run_cfg(plan, arch,
                                                             mesh))
    finally:
        groups.close()
    res["train"] = {"loss": loss, "grads": grads, "pieces": pieces,
                    "groups": groups.seen}
    torch.save(res, os.path.join(tmp, f"r{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("mesh16")
    mp.start_processes(_world, args=(WORLD, str(tmp)), nprocs=WORLD,
                       start_method="spawn")
    return [torch.load(tmp / f"r{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _one_rank(arch, plan):
    """The engine of one rank on the whole padded weights, with the
    plan's residency and geometry."""
    from repro_torch.core.passes.lowering import build_run_cfg
    from repro_torch.serve.engine import ServeEngine
    est = plan.estimates
    cfg = build_run_cfg(plan, arch)
    params = _params(arch, plan)
    eng = ServeEngine(arch, params, cfg, max_batch=4, max_len=64,
                      kv_heads=cfg.kv_heads_padded,
                      kv_residency=str(est.get("kv_residency", "dense")),
                      kv_block_len=int(est.get("kv_block_len", 0)),
                      kv_n_blocks=int(est.get("kv_n_blocks", 0)))
    return eng, params, cfg


def _margin(arch, params, cfg, prompt, out, i) -> float:
    from repro_torch.models import lm
    toks = np.concatenate([prompt, np.asarray(out[:i], np.int32)])
    logits, _ = lm.prefill(arch, params, {"tokens": torch.from_numpy(
        toks[None])}, cfg)
    lf = logits[0, :arch.vocab_size].float().numpy()
    top = np.sort(lf)[-2:]
    return float((top[1] - top[0]) / np.abs(lf).max())


@pytest.mark.parametrize("cell", list(CELLS))
def test_padded_cells_serve_on_four_ranks_as_one_rank(world, cell):
    make, kw = CELLS[cell]
    arch = make()
    plan = _plan(arch, **kw)
    Hp, Kp = plan.padded_sizes()[1], plan.padded_sizes()[3]
    r0 = world[0][cell]
    assert "error" not in r0, r0["error"]
    for r in world[1:]:
        assert r[cell]["tokens"] == r0["tokens"]
    # the kv heads stay whole on every rank: the pool (the dense cache's
    # rows) split over model, K8 over every head at G = Hp / Kp, flash
    # at the rank's piece of one group
    assert Kp % WORLD and r0["split"] == "rows"
    assert r0["path"].startswith("shard_map_flash")
    G = Hp // Kp
    partial = ("paged_decode_partial_plain" if "paged" in cell
               else "decode_partial_plain")
    assert r0["groups"] == {"flash_attention_plain": {Hp // WORLD},
                            partial: {G}}
    from repro_torch.models import lm
    from repro_torch.serve.sharded import cache_split
    inst = lm.kernel_instances(arch, "decode", plan,
                               cache_split=cache_split(plan, arch))
    assert [(i.kernel, i.group) for i in inst] == [
        ("flash_attention", Hp // WORLD), (partial[:-6], G)]
    if arch.has_ssm:
        # 6 SSM heads padded to 8, the rank's 2 of them in its state
        assert plan.estimates["ssm_heads_padded"] == 8 != arch.ssm_heads
        assert r0["cache"]["ssm"][2] == 8 // WORLD
    else:
        assert (Hp, Kp) == (12, 2) and Hp // WORLD == 3 and G == 6
    eng, params, cfg = _one_rank(arch, plan)
    prompts = _prompts(arch.vocab_size)
    want = _run(eng, prompts)
    compared = 0
    for p, toks in want.items():
        prompt = np.frombuffer(p, np.int32)
        got = r0["tokens"][p]
        for i, (a, b) in enumerate(zip(got, toks)):
            if a != b:
                assert _margin(arch, params, cfg, prompt, toks, i) \
                    <= MARGIN_TOL, (i, a, b)
                break
            compared += 1
    assert compared >= 5 * len(prompts) // 2


def test_a_train_step_at_group_3_matches_one_rank(world):
    from repro_torch.core.passes.lowering import build_run_cfg
    arch = _g3()
    plan = _plan(arch)
    loss, grads = _loss_and_grads(arch, _params(arch, plan),
                                  build_run_cfg(plan, arch))
    assert world[0]["train"]["groups"] == {"flash_attention_plain": {3}}
    held = 0
    for r in world:
        t = r["train"]
        assert abs(t["loss"] - loss) <= 1e-3 * abs(loss)
        for path, g in t["grads"].items():
            piece = t["pieces"]
            for k in path.split("/"):
                piece = piece[k]
            start, shape = piece
            want = grads[path]
            for d, (s0, n) in enumerate(zip(start, shape)):
                want = want.narrow(d, s0, n)
            err = float((g - want).norm() / want.norm().clamp_min(1e-12))
            assert err <= BF16_TOL, (path, err)
            held += 1
    assert held >= 8 * WORLD


def test_flash_at_group_3_matches_the_reference():
    import jax.numpy as jnp

    from repro.kernels.ref import flash_attention_ref
    from repro_torch.kernels.flash_attention import flash_attention_plain
    g = np.random.default_rng(7)
    q, k, v = (g.standard_normal(s).astype(np.float32)
               for s in ((2, 96, 3, 128), (2, 96, 1, 128), (2, 96, 1, 128)))
    for window in (0, 40):
        got = flash_attention_plain(
            *(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)),
            window=window).float().numpy()
        want = np.asarray(flash_attention_ref(
            *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)),
            window=window), np.float32)
        rel = np.sqrt(((got - want) ** 2).mean() / (want ** 2).mean())
        assert rel <= BF16_TOL, (window, rel)
