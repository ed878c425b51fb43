"""MoE slice: granite-moe-1b-a400m and llama4-maverick's [dense, MoE]
super-block, the port against the JAX package.

``route``, both single-device MoE paths (``gshard_einsum``: capacity
dispatch with one batch row as the routing group; ``dense_einsum``:
every expert on every token under the threshold gate rule) and the
shared expert, on the same numpy-seeded inputs; then reduced granite (2
layers, 8 experts top-2) and reduced llama4 (4 layers: two [dense, MoE]
super-blocks, 8 experts top-1, one shared expert), whose JAX
``init_params`` are carried across by ``repro_torch.models.convert``:
prefill (logits and KV rows), tail prefill over a pooled prefix, and
dense and paged decode steps; both engines from ``h100-sxm`` plans;
and the plans themselves.  The port runs its kernels' plain versions
(CPU tensors), the JAX package its XLA paths.

Tolerances (those of ``tests/test_kernels.py``): 1e-5 in fp32 and 2e-2
in bf16, relative to the reference's largest magnitude.  ``route``'s
dispatch is held exactly, on draws whose top router probabilities are
nowhere within 1e-6 of each other (a decision there is the arithmetic's
to make).  Greedy tokens must be identical wherever the reference's
top-2 logit margin exceeds 2e-2 of its largest logit (the margin rule);
engine counters and block accounting must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeConfig as RShape
from repro.configs import get_arch as rget_arch
from repro.core import specialize as rspecialize
from repro.models import lm as rlm
from repro.models import moe as rmoe
from repro.models.lm import RunCfg as RRunCfg
from repro.serve.engine import ServeEngine as RServeEngine
from repro_torch.configs import ShapeConfig as TShape
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core import specialize as tspecialize
from repro_torch.core.passes.lowering import build_run_cfg
from repro_torch.launch import serve as tserve
from repro_torch.models import common as tcommon
from repro_torch.models import convert
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models.lm import RunCfg as TRunCfg
from repro_torch.serve.engine import ServeEngine as TServeEngine

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
MARGIN_TOL = 2e-2
IMPLS = ("gshard_einsum", "dense_einsum")
GRANITE, LLAMA4 = "granite-moe-1b-a400m", "llama4-maverick-400b-a17b"
B, S, MAX_LEN, BL = 2, 40, 64, 16


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _both(x: np.ndarray, dtype: str):
    """The same fp32 values as a JAX array and a torch tensor of
    ``dtype``."""
    if dtype == "bfloat16":
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(
            torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def _min_gap(x: np.ndarray, router: np.ndarray, k: int) -> float:
    """Smallest gap between consecutive ones of each token's top ``k +
    1`` router probabilities (in fp64)."""
    z = x.astype(np.float64) @ router.astype(np.float64)
    p = np.exp(z - z.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    top = -np.sort(-p, -1)[..., :k + 1]
    return float((top[..., :-1] - top[..., 1:]).min())


# ---------------------------------------------------------------------
# route and the two paths
# ---------------------------------------------------------------------

# (G, T, E, k, C, bias): bias > 0 pushes most tokens to expert 0, so its
# slots fill and later tokens' choices are dropped
ROUTE_CASES = [(2, 16, 4, 1, 4, 0.0), (2, 24, 8, 2, 4, 4.0),
               (1, 32, 8, 3, 8, 2.0), (3, 8, 16, 4, 4, 0.0)]


def _route_inputs(G, T, E, k, bias, seed=0, d=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((G, T, d)).astype(np.float32)
    router = (0.3 * rng.standard_normal((d, E))).astype(np.float32)
    x[..., 0] = 1.0                 # a feature every token carries ...
    router[0, 0] += bias            # ... that favours expert 0
    # the bf16 tokens route() sees
    x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    assert _min_gap(x, router, k) > 1e-6
    return x, router


@pytest.mark.parametrize("G,T,E,k,C,bias", ROUTE_CASES)
def test_route_matches_jax_with_capacity_drops(G, T, E, k, C, bias):
    x, router = _route_inputs(G, T, E, k, bias)
    jx, tx = _both(x, "bfloat16")
    rd, rc, raux = rmoe.route(jx, jnp.asarray(router), k, C)
    td, tc, taux = tmoe.route(tx, torch.from_numpy(router), k, C)
    assert td.dtype == torch.bfloat16 and tc.dtype == torch.float32
    assert tuple(td.shape) == (G, T, E, C)
    np.testing.assert_array_equal(_np(td), np.asarray(rd, np.float32))
    assert _rel(_np(tc), rc) < TOL["float32"]
    assert abs(float(taux) - float(raux)) <= TOL["float32"] * abs(float(raux))
    kept = float(td.float().sum())
    if bias >= 4.0:                 # expert 0 overflows: choices dropped
        assert kept < G * T * k
    # every kept choice sits in one slot of one expert, in token order
    assert float(td.float().sum((-1, -2)).max()) <= k


def _moe_params(rng, d, E, ff, shared: bool, router_scale=0.3):
    def w(*shape, scale=0.1):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    leaves = {"router": w(d, E, scale=router_scale), "wi": w(E, d, 2 * ff),
              "wo": w(E, ff, d)}
    if shared:
        leaves.update(shared_wi=w(d, 2 * ff), shared_wo=w(ff, d))
    # bf16 for the matrices, fp32 for the router, as ``_moe_specs``
    jp = {k: jnp.asarray(v, jnp.float32 if k == "router" else jnp.bfloat16)
          for k, v in leaves.items()}
    tp = {k: convert.tensor_from_numpy(np.asarray(v), "cpu")
          for k, v in jp.items()}
    return rmoe.MoEParams(**jp), tmoe.MoEParams(**tp)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("impl", IMPLS)
def test_moe_paths_match_jax(impl, shared):
    """Both paths, top-2 of 8 experts, with and without the shared
    expert: ``y`` in bf16, the aux loss in fp32."""
    rng = np.random.default_rng(11)
    d, E, ff, k = 64, 8, 32, 2
    rp, tp = _moe_params(rng, d, E, ff, shared)
    x = rng.standard_normal((3, 12, d)).astype(np.float32)
    jx, tx = _both(x, "bfloat16")
    rfn = getattr(rmoe, "moe_" + impl)
    ry, raux = rfn(jx, rp, top_k=k, capacity_factor=1.25)
    ty, taux = tmoe.moe_forward(impl, tx, tp, top_k=k, capacity_factor=1.25)
    assert ty.dtype == torch.bfloat16 and tuple(ty.shape) == ry.shape
    assert _rel(_np(ty), ry) < TOL["bfloat16"]
    assert abs(float(taux) - float(raux)) <= TOL["float32"] * abs(float(raux))


def test_dense_einsum_threshold_admits_every_tied_expert():
    """A zero router ties every expert at 1/E: the threshold rule gates
    all E (the output is the mean of all experts' outputs), where k
    indices from a top-k would gate only k."""
    rng = np.random.default_rng(12)
    d, E, ff, k = 64, 8, 32, 2
    rp, tp = _moe_params(rng, d, E, ff, shared=False, router_scale=0.0)
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    jx, tx = _both(x, "bfloat16")
    ry, _ = rmoe.moe_dense_einsum(jx, rp, top_k=k)
    ty, _ = tmoe.moe_dense_einsum(tx, tp, top_k=k)
    assert _rel(_np(ty), ry) < TOL["bfloat16"]
    # every expert's output, by hand
    h = torch.einsum("bsd,edf->bsef", tx.float(), tp.wi.float())
    g, u = h.chunk(2, -1)
    outs = torch.einsum("bsef,efd->bsed",
                        torch.nn.functional.silu(g) * u, tp.wo.float())
    assert _rel(_np(ty), outs.mean(2).numpy()) < TOL["bfloat16"]
    first_k = outs[:, :, :k].sum(2) / E
    assert _rel(first_k.numpy(), _np(ty)) > 10 * TOL["bfloat16"]


def test_moe_impls_the_port_lacks_raise():
    rng = np.random.default_rng(13)
    _, tp = _moe_params(rng, 16, 4, 8, shared=False)
    x = torch.zeros((1, 2, 16), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
        tmoe.moe_forward("shard_map_alltoall", x, tp, top_k=1,
                         capacity_factor=1.25)
    with pytest.raises(ValueError, match="not one of"):
        tmoe.moe_forward("megablocks", x, tp, top_k=1, capacity_factor=1.25)
    assert tmoe._capacity(1, 32, 8, 1.25) == 4      # decode: S = 1
    assert tmoe._capacity(64, 32, 8, 1.25) == \
        rmoe._capacity(64, 32, 8, 1.25) == 20


# ---------------------------------------------------------------------
# the reduced models
# ---------------------------------------------------------------------

_MODELS: dict = {}


def _model(name):
    """(reference arch, port arch, reference params, port params)."""
    if name not in _MODELS:
        rarch, tarch = rget_arch(name).reduced(), tget_arch(name).reduced()
        rparams = rlm.init_params(rarch, jax.random.PRNGKey(0))
        tparams = convert.params_from_numpy(
            tarch, jax.tree.map(np.asarray, rparams), device="cpu")
        _MODELS[name] = (rarch, tarch, rparams, tparams)
    return _MODELS[name]


MODEL_CASES = [(GRANITE, "gshard_einsum"), (GRANITE, "dense_einsum"),
               (LLAMA4, "gshard_einsum")]


def _cfgs(impl):
    return RRunCfg(block_q=16, moe_impl=impl), TRunCfg(moe_impl=impl)


def test_reduced_archs_and_their_trees():
    """Reduced granite has an MoE FFN in every layer; reduced llama4 two
    [dense, MoE] super-blocks, the shared expert in the MoE half.  The
    carried trees have the reference's keys and shapes, and layer
    ``2j + 1`` of llama4 reads super-block ``j``'s MoE half."""
    _, garch, _, gparams = _model(GRANITE)
    assert garch.n_layers == 2 and set(gparams["blocks"]) == {
        "pre_norm", "attn", "mlp_norm", "moe"}
    assert tuple(gparams["blocks"]["moe"]["wi"].shape) == (
        2, garch.n_experts, garch.d_model, 2 * garch.moe_d_ff)
    rarch, larch, rparams, lparams = _model(LLAMA4)
    assert larch.n_layers == 4 and larch.moe_interleave == 2
    blocks = lparams["blocks"]
    assert set(blocks) == {"dense", "moe"}
    assert "mlp" in blocks["dense"] and "moe" in blocks["moe"]
    assert set(blocks["moe"]["moe"]) == {"router", "wi", "wo", "shared_wi",
                                         "shared_wo"}
    layer3 = tlm.layer_params(blocks, 3)
    assert "moe" in layer3 and torch.equal(
        layer3["moe"]["router"], blocks["moe"]["moe"]["router"][1])
    assert "mlp" in tlm.layer_params(blocks, 2)
    assert tlm.cache_heads(larch, blocks) == {"kv_heads": larch.n_kv_heads}
    for tree, specs in ((lparams, tlm.leaf_specs(larch)),):
        flat = jax.tree_util.tree_flatten_with_path(rparams)[0]
        for path, leaf in flat:
            t, s = tree, specs
            for key in path:
                t, s = t[key.key], s[key.key]
            assert tuple(t.shape) == np.shape(leaf) == s.shape
            if s.dtype == torch.bfloat16:
                np.testing.assert_array_equal(
                    t.view(torch.int16).numpy(),
                    np.asarray(leaf).view(np.int16))


def _tokens(vocab, seed=0, n=S):
    return np.random.default_rng(seed).integers(0, vocab, (B, n)).astype(
        np.int32)


@pytest.mark.parametrize("name,impl", MODEL_CASES)
def test_prefill_logits_and_kv_rows_match(name, impl):
    rarch, tarch, rparams, tparams = _model(name)
    rcfg, tcfg = _cfgs(impl)
    toks = _tokens(rarch.vocab_size)
    rl, rc = rlm.prefill(rarch, rparams, {"tokens": jnp.asarray(toks)}, rcfg,
                         max_len=MAX_LEN)
    tl, tc = tlm.prefill(tarch, tparams, {"tokens": torch.from_numpy(toks)},
                         tcfg, max_len=MAX_LEN)
    assert tl.dtype == torch.bfloat16 and tuple(tl.shape) == rl.shape
    assert _rel(_np(tl), rl) < TOL["bfloat16"]
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == rc[key].shape
        for layer in range(rarch.n_layers):
            assert _rel(_np(tc[key][layer]), rc[key][layer]) \
                < TOL["bfloat16"], (key, layer)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(rc["pos"]))


@pytest.mark.parametrize("name,impl", MODEL_CASES)
def test_prefill_tail_matches_jax(name, impl):
    """The tail after a 32-row prefix held in pool blocks (in reverse
    order behind a table), against the reference's ``prefill_tail`` on
    the same prefix rows; under ``gshard_einsum`` both route only the
    tail as its group."""
    rarch, tarch, rparams, tparams = _model(name)
    rcfg, tcfg = _cfgs(impl)
    M, T = 32, 12
    toks = _tokens(rarch.vocab_size, seed=2, n=M + T)
    _, rc = rlm.prefill(rarch, rparams, {"tokens": jnp.asarray(toks[:, :M])},
                        rcfg)
    pk, pv = rc["k"], rc["v"]
    rl, rk, rv = rlm.prefill_tail(rarch, rparams,
                                  {"tokens": jnp.asarray(toks[:, M:])},
                                  rcfg, pk, pv)
    L, nbm = pk.shape[0], M // BL
    pools = {}
    for key, rows in (("k", pk), ("v", pv)):
        rows = convert.tensor_from_numpy(np.asarray(rows), "cpu")
        pools[key] = rows.reshape(L, B * nbm, BL, *rows.shape[3:]).flip(1)
    tbl = (B * nbm - 1 - torch.arange(B * nbm)).reshape(B, nbm)
    tl, tk, tv = tlm.prefill_tail(tarch, tparams,
                                  {"tokens": torch.from_numpy(toks[:, M:])},
                                  tcfg, pools["k"], pools["v"], tbl)
    assert tuple(tl.shape) == rl.shape and tuple(tk.shape) == rk.shape
    assert _rel(_np(tl), rl) < TOL["bfloat16"]
    for got, want in ((tk, rk), (tv, rv)):
        for layer in range(L):
            assert _rel(_np(got[layer]), want[layer]) < TOL["bfloat16"]


def _paged(cache_np, nb_pool):
    """A dense prefill cache as a paged one: slot b owns blocks
    ``perm[b*nb:(b+1)*nb]`` of a pool with spare blocks."""
    L, Bc, T, Kh, hd = cache_np["k"].shape
    nb = T // BL
    perm = np.random.default_rng(7).permutation(nb_pool)[:Bc * nb]
    tbl = perm.reshape(Bc, nb).astype(np.int32)
    out = dict(cache_np, block_tbl=tbl)
    for key in ("k", "v"):
        pool = np.zeros((L, nb_pool, BL, Kh, hd), np.float32)
        rows = cache_np[key].reshape(L, Bc, nb, BL, Kh, hd)
        for b in range(Bc):
            pool[:, tbl[b]] = rows[:, b]
        out[key] = pool
    return out


@pytest.mark.parametrize("residency", ["dense", "paged"])
@pytest.mark.parametrize("name,impl", MODEL_CASES)
def test_decode_steps_match(name, impl, residency):
    """Three decode steps from the same prefilled cache, fed the same
    reference-greedy tokens: logits agree at every step (each a routing
    group of one token under ``gshard_einsum``: C = 4, no drop)."""
    rarch, tarch, rparams, tparams = _model(name)
    rcfg, tcfg = _cfgs(impl)
    toks = _tokens(rarch.vocab_size, seed=1)
    _, rc = rlm.prefill(rarch, rparams, {"tokens": jnp.asarray(toks)}, rcfg,
                        max_len=MAX_LEN)
    cache_np = {k: np.asarray(v, np.float32) for k, v in rc.items()}
    cache_np["pos"] = np.asarray(rc["pos"])
    if residency == "paged":
        cache_np = _paged(cache_np, nb_pool=2 * B * MAX_LEN // BL)

    def jx(k, v):
        return jnp.asarray(v, jnp.bfloat16) if k in ("k", "v") \
            else jnp.asarray(v)

    def th(k, v):
        t = torch.from_numpy(np.array(v))
        return t.to(torch.bfloat16) if k in ("k", "v") else t

    rcache = {k: jx(k, v) for k, v in cache_np.items()}
    tcache = {k: th(k, v) for k, v in cache_np.items()}
    tok = toks[:, -1:]
    for _ in range(3):
        rl, rcache = rlm.decode_step(rarch, rparams, rcache,
                                     {"tokens": jnp.asarray(tok)}, rcfg)
        tl, tcache = tlm.decode_step(tarch, tparams, tcache,
                                     {"tokens": torch.from_numpy(tok.copy())},
                                     tcfg)
        assert _rel(_np(tl), rl) < TOL["bfloat16"]
        tok = np.asarray(jnp.argmax(rl.astype(jnp.float32), -1),
                         np.int32)[:, None]


def test_model_refuses_an_moe_impl_it_lacks():
    _, tarch, _, tparams = _model(GRANITE)
    toks = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
        tlm.prefill(tarch, tparams, toks,
                    TRunCfg(moe_impl="shard_map_alltoall"))


# ---------------------------------------------------------------------
# engines from h100-sxm plans
# ---------------------------------------------------------------------

def _granite_geometry():
    """granite's expert geometry (32 experts top-8 of 512, head_dim 64,
    G = 2) at 2 layers, d_model 128 and a 512-token vocab: its plans
    pick ``dense_einsum`` at 2048 and ``gshard_einsum`` at 1024, as the
    full arch's do."""
    return {get: dataclasses.replace(
        get(GRANITE), n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        head_dim=64, vocab_size=512) for get in (rget_arch, tget_arch)}


def _llama4_block():
    """llama4 cut to one [dense, MoE] super-block at reduced widths."""
    return {get: dataclasses.replace(get(LLAMA4).reduced(), n_layers=2)
            for get in (rget_arch, tget_arch)}


_ENGINE_MODELS: dict = {}


def _engine_model(which):
    if which not in _ENGINE_MODELS:
        archs = _granite_geometry() if which == "granite" \
            else _llama4_block()
        rarch, tarch = archs[rget_arch], archs[tget_arch]
        rparams = rlm.init_params(rarch, jax.random.PRNGKey(1))
        tparams = convert.params_from_numpy(
            tarch, jax.tree.map(np.asarray, rparams), device="cpu")
        _ENGINE_MODELS[which] = (rarch, tarch, rparams, tparams)
    return _ENGINE_MODELS[which]


def _plan_engines(which, seq_len, max_len):
    """The port's ``h100-sxm`` decode plan at ``seq_len`` x 4 served by
    ``from_plan(plan, params)`` (limits lowered to ``max_len``), and the
    JAX engine built with the plan's decisions and ``moe_impl``."""
    rarch, tarch, rparams, tparams = _engine_model(which)
    plan = tspecialize(tarch, TShape("serve", "decode", seq_len, 4),
                       mesh_shape=(1, 1), target="h100-sxm", cache=False)
    est = plan.estimates
    teng = TServeEngine.from_plan(plan, tparams, arch=tarch, max_len=max_len)
    reng = RServeEngine(
        rarch, rparams, RRunCfg(block_q=16, moe_impl=str(est["moe_impl"])),
        max_batch=4, max_len=max_len,
        kv_residency=str(est["kv_residency"]),
        kv_block_len=int(est["kv_block_len"]),
        kv_n_blocks=int(est["kv_n_blocks"]),
        kv_admission=str(est["kv_admission"]),
        kv_host_blocks=int(est["kv_host_blocks"]),
        kv_prefix_reuse=str(est["kv_prefix_reuse"]),
        kv_prefetch=str(est["kv_prefetch"]))
    return plan, reng, teng


def _margin(reng, prompt, out, i) -> float:
    toks = np.concatenate([prompt, np.asarray(out[:i], np.int32)])
    logits, _ = rlm.prefill(reng.arch, reng.params,
                            {"tokens": jnp.asarray(toks[None])}, reng.cfg)
    lf = np.asarray(logits[0, :reng.arch.vocab_size], np.float32)
    top = np.sort(lf)[-2:]
    return float((top[1] - top[0]) / np.abs(lf).max())


KEYS = ("preemptions", "migrations", "grant_denials", "shed", "parked",
        "spills", "promotes", "prefix_hits", "prefix_hit_tokens",
        "prefix_rides", "cow_copies")


def _assert_like(reng, teng, min_tokens):
    rps, tps = reng.pressure_stats(), teng.pressure_stats()
    for k in KEYS:
        assert tps[k] == rps[k], (k, tps[k], rps[k])
    assert teng.prefill_calls == reng.prefill_calls
    assert list(teng.prefill_batches) == list(reng.prefill_batches)
    assert teng.block_stats() == reng.block_stats()
    got = {r.rid: r for r in teng.finished}
    compared = 0
    for w in reng.finished:
        g = got[w.rid]
        assert len(g.out_tokens) == len(w.out_tokens)
        for i, (a, b) in enumerate(zip(g.out_tokens, w.out_tokens)):
            if a != b:
                m = _margin(reng, np.asarray(w.prompt), w.out_tokens, i)
                assert m <= MARGIN_TOL, (w.rid, i, a, b, m)
                break
            compared += 1
    assert compared >= min_tokens


ENGINE_CASES = [("granite", 2048, "dense_einsum"),
                ("granite", 1024, "gshard_einsum"),
                ("llama4", 512, "gshard_einsum")]


@pytest.mark.parametrize("which,seq_len,impl", ENGINE_CASES)
def test_engine_from_the_h100_plan_matches_jax(which, seq_len, impl):
    """``from_plan(plan, params)`` on the plan's own MoE path, paged,
    prefix reuse on: two prompts behind a shared one-block prefix (a
    tail prefill, routed by its own tail under ``gshard_einsum``) and
    two of their own; tokens, counters and pools as the JAX engine's."""
    plan, reng, teng = _plan_engines(which, seq_len, max_len=512)
    assert teng.cfg.moe_impl == plan.estimates["moe_impl"] == impl
    assert plan.estimates["kv_residency"] == "paged"
    assert teng.kv_prefix_reuse
    bl = teng.block_len
    vocab = teng.arch.vocab_size
    rng = np.random.default_rng(21)
    system = rng.integers(0, vocab, bl).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(0, vocab, 9)
                               .astype(np.int32)]),
               np.concatenate([system, rng.integers(0, vocab, 5)
                               .astype(np.int32)]),
               rng.integers(0, vocab, 13).astype(np.int32),
               rng.integers(0, vocab, 30).astype(np.int32)]
    for eng in (reng, teng):
        eng.submit(prompts[0], max_new_tokens=5)
        eng.step()
        for p in prompts[1:]:
            eng.submit(p, max_new_tokens=5)
        eng.run_until_idle(max_ticks=64)
    assert teng.pressure_stats()["prefix_hits"] >= 1
    _assert_like(reng, teng, min_tokens=10)
    teng.drop_block_cache()
    st = teng.block_stats()
    assert st["free"] == st["total"] and st["host_free"] == st["host_total"]


# ---------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------

@pytest.mark.parametrize("seq_len", [512, 1024, 2048])
@pytest.mark.parametrize("name", [GRANITE, LLAMA4])
def test_h100_moe_impl_is_the_jax_packages(name, seq_len):
    """The communication pass's choice on ``h100-sxm`` equals the JAX
    package's, the lowered ``RunCfg`` carries it, and the decode plan
    now holds a decode tile at the arch's (G, head_dim)."""
    shape = ("s", "decode", seq_len, 8)
    rplan = rspecialize(rget_arch(name), RShape(*shape), mesh_shape=(1, 1))
    tarch = tget_arch(name)
    tplan = tspecialize(tarch, TShape(*shape), mesh_shape=(1, 1),
                        target="h100-sxm", cache=False)
    impl = rplan.estimates["moe_impl"]
    assert tplan.estimates["moe_impl"] == impl
    assert build_run_cfg(tplan, tarch).moe_impl == impl
    assert impl == ("dense_einsum" if (name, seq_len) == (GRANITE, 2048)
                    else "gshard_einsum")
    dec = tplan.partitions["decode_attention"]
    assert dict(dec.blocks) == {"block_kv": min(256, seq_len // 8),
                                "head_dim": tarch.hd}


@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("name", [GRANITE, LLAMA4])
def test_tpu_v5e_moe_plans_hash_as_the_jax_packages(name, kind):
    shape = ("s", kind, 2048, 8)
    rplan = rspecialize(rget_arch(name), RShape(*shape), mesh_shape=(1, 1))
    tplan = tspecialize(tget_arch(name), TShape(*shape), mesh_shape=(1, 1),
                        target="tpu-v5e", cache=False)
    assert tplan.content_hash() == rplan.content_hash()


# the parent's h100-sxm plans at 2048 x 8 of the six archs served before
# the MoE slice: content hash prefixes, which the new decode instances
# leave as they were
SERVED_H100 = {
    "qwen3-8b": ("2ca1ad027c737728", "231de874015dc3de"),
    "deepseek-7b": ("b43d1e9c14ad9017", "a48ee34f9cadde51"),
    "deepseek-coder-33b": ("155dc37ab09a0ed3", "579a03790b8693f3"),
    "mamba2-2.7b": ("47f25c4ac4e84938", "cdc59b59788748a6"),
    "hymba-1.5b": ("bf903858aab31b5e", "306de2217cfc84b6"),
    "minitron-8b": ("51584680a69d1a5a", "473a3a54330bece0"),
}


@pytest.mark.parametrize("name", sorted(SERVED_H100))
def test_served_archs_h100_plans_are_unchanged(name):
    for kind, want in zip(("decode", "prefill"), SERVED_H100[name]):
        plan = tspecialize(tget_arch(name), TShape("s", kind, 2048, 8),
                           mesh_shape=(1, 1), target="h100-sxm", cache=False)
        assert plan.content_hash()[:16] == want, (name, kind)


# ---------------------------------------------------------------------
# initialization and the launcher
# ---------------------------------------------------------------------

def _draw_along_dim0(t, scale, gen, bound):
    """The slicing :func:`truncated_normal_` had before it bounded the
    staging buffer over leading dims: dim 0 only."""
    rows = t.shape[0] if t.dim() else 1
    per_row = max(1, t.numel() // max(rows, 1))
    step = max(1, bound // per_row)
    flat = t.view(rows, -1) if t.dim() else t.view(1, 1)
    for i in range(0, rows, step):
        buf = torch.empty(flat[i:i + step].shape, dtype=torch.float32)
        torch.nn.init.trunc_normal_(buf, mean=0.0, std=scale, a=-2 * scale,
                                    b=2 * scale, generator=gen)
        flat[i:i + step].copy_(buf)
    return t


@pytest.mark.parametrize("shape,bound", [((3, 10, 7), 1 << 26),
                                         ((40, 6), 16), ((5,), 2),
                                         ((2, 16, 3), 64)])
def test_truncated_normal_draws_as_before_where_dim0_rows_fit(shape, bound,
                                                              monkeypatch):
    monkeypatch.setattr(tcommon, "STAGING", bound)
    got = tcommon.truncated_normal_(torch.zeros(shape, dtype=torch.bfloat16),
                                    0.02, torch.Generator().manual_seed(3))
    want = _draw_along_dim0(torch.zeros(shape, dtype=torch.bfloat16), 0.02,
                            torch.Generator().manual_seed(3), bound)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_truncated_normal_bounds_the_staging_buffer_of_an_expert_stack(
        monkeypatch):
    """An ``(1, E, d, 2 ff)`` stack (llama4's ``wi`` is one such slice
    of 10.7 G elements) is drawn in buffers of at most the bound, over
    its flattened leading dims, and still draws the distribution."""
    sizes = []
    draw = torch.nn.init.trunc_normal_

    def recording(buf, **kw):
        sizes.append(buf.numel())
        return draw(buf, **kw)

    monkeypatch.setattr(tcommon, "STAGING", 64)
    monkeypatch.setattr(torch.nn.init, "trunc_normal_", recording)
    t = tcommon.truncated_normal_(torch.zeros((1, 4, 8, 16)), 0.02,
                                  torch.Generator().manual_seed(4))
    assert max(sizes) <= 64 and sum(sizes) == t.numel()
    assert float(t.abs().max()) <= 0.04 and float(t.std()) > 0.005
    assert len(torch.unique(t)) == t.numel()      # no slice drawn twice


@pytest.mark.parametrize("name,cut", [(GRANITE, []),
                                      (LLAMA4, ["--n-layers", "2"])])
def test_launcher_serves_reduced_moe_archs_on_the_cpu(name, cut, capsys):
    tserve.main(["--arch", name, "--device", "cpu", "--from-plan",
                 "--requests", "2", "--new-tokens", "3", "--max-len", "64",
                 "--max-batch", "2", *cut])
    out = capsys.readouterr().out
    assert "served 2 requests, 6 tokens" in out
    if cut:
        assert "n_layers 4 -> 2" in out


def test_launcher_refuses_full_llama4_before_any_weight(monkeypatch):
    """Full-width llama4 (~800 GB of bf16 weights) is refused before a
    weight is built, naming the bytes against the card's free memory and
    the multi-GPU item."""
    built = []
    monkeypatch.setattr(tlm, "init_params",
                        lambda *a, **k: built.append(1))
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (80 * 10 ** 9, 80 * 10 ** 9))
    with pytest.raises(NotImplementedError,
                       match=r"weight bytes.*80000000000 bytes free "
                             r"on the card.*ROADMAP item 10"):
        tserve.main(["--arch", LLAMA4, "--full", "--device", "cuda",
                     "--from-plan", "--max-len", "2048", "--max-batch",
                     "8"])
    assert not built
