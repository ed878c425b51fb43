"""Hybrid hymba-1.5b and squared-ReLU minitron-8b: the port against the
JAX package.

Reduced hymba: 3 layers (layers 0 and 2 attend globally, layer 1 through
a 16-token sliding window, so the prompts here cross it), d_model 128,
5 query heads over 1 kv head of 64 (hymba's GQA group of 5 and its
head_dim), 8 SSM heads of 32 with state 16, beside the attention in
every layer.  Reduced minitron: 2 layers, d_model 128, 4 / 2 heads of
32, one (d, ff) FFN matrix under a squared ReLU.  The JAX package's
``init_params`` are carried across by ``repro_torch.models.convert``;
the port runs its kernels' plain versions (CPU tensors), the JAX
package its XLA mirrors, its ``ref.py`` oracles and its Pallas kernels
in interpret mode.

Tolerances (those of ``tests/test_kernels.py``): 1e-5 in fp32 and 2e-2
in bf16, relative to the reference's largest magnitude, for kernel
outputs, logits, KV rows, SSM states and conv windows.  Greedy tokens
must be identical wherever the reference's top-2 logit margin exceeds
2e-2 of its largest logit (the margin rule); past a step inside that
margin a request is not compared further.  Engine counters (prefill
calls, prefix hits, rides, preemptions, spills) and block accounting
must be equal: they read block counts only.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.kernels.decode_attention as tdec
import repro_torch.kernels.flash_attention as tfa
from repro.configs import ShapeConfig as RShape
from repro.configs import get_arch as rget_arch
from repro.core import specialize as rspecialize
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.decode_attention import \
    paged_decode_attention as pallas_paged
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import lm as rlm
from repro.models.lm import RunCfg as RRunCfg
from repro.serve.engine import ServeEngine as RServeEngine
from repro_torch.configs import ShapeConfig as TShape
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core import specialize as tspecialize
from repro_torch.models import convert
from repro_torch.models import lm as tlm
from repro_torch.models.lm import RunCfg as TRunCfg
from repro_torch.serve.engine import ServeEngine as TServeEngine

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MARGIN_TOL = 2e-2
RCFG = RRunCfg(block_q=16, ssd_chunk=16)
TCFG = TRunCfg(ssd_chunk=16)
WINDOW = 16
B, S, MAX_LEN, BL = 2, 40, 64, 16


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _pair(rng, shape, dtype):
    """The same fp32 draw as a JAX array and a torch tensor of ``dtype``."""
    x = rng.standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _hymba(get):
    """hymba-1.5b at 3 layers: global, windowed, global."""
    return dataclasses.replace(
        get("hymba-1.5b"), n_layers=3, d_model=128, n_heads=5, n_kv_heads=1,
        head_dim=64, d_ff=256, vocab_size=512, window=WINDOW, ssm_state=16,
        ssm_head_dim=32)


def _minitron(get):
    return get("minitron-8b").reduced()


_MODELS: dict = {}


def _model(name):
    """(reference arch, port arch, reference params, port params)."""
    if name not in _MODELS:
        make = _hymba if name == "hymba" else _minitron
        rarch, tarch = make(rget_arch), make(tget_arch)
        rparams = rlm.init_params(rarch, jax.random.PRNGKey(0))
        tparams = convert.params_from_numpy(
            tarch, jax.tree.map(np.asarray, rparams), device="cpu")
        _MODELS[name] = (rarch, tarch, rparams, tparams)
    return _MODELS[name]


def _tokens(vocab, seed=0):
    return np.random.default_rng(seed).integers(
        0, vocab, (B, S)).astype(np.int32)


def test_reduced_hymba_keeps_hymbas_head_geometry_and_crosses_its_window():
    rarch, tarch, _, _ = _model("hymba")
    assert tarch.n_heads // tarch.n_kv_heads == 5 and tarch.hd == 64
    assert tlm._window_schedule(tarch) == [0, WINDOW, 0]
    assert list(np.asarray(rlm._window_schedule(rarch))) == [0, WINDOW, 0]
    assert tarch.has_attention and tarch.has_ssm and S > WINDOW
    tlm.check_supported(tarch)
    tlm.check_supported(_model("minitron")[1])


# ---------------------------------------------------------------------
# the attention kernels' plain versions at (G = 5, head_dim 64)
# ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, WINDOW),
                                           (False, 0)])
def test_flash_plain_at_group_5_head_dim_64_matches_jax(dtype, causal,
                                                        window):
    rng = np.random.default_rng(5 + window)
    Bq, Sq, H, K, D = 2, 96, 10, 2, 64
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, s, dtype) for s in
                                    [(Bq, Sq, H, D), (Bq, Sq, K, D),
                                     (Bq, Sq, K, D)])
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    got = tfa.flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    assert _rel(_np(got), want) < TOL[dtype]
    pal = pallas_flash(jq, jk, jv, causal=causal, window=window, block_q=32,
                       block_kv=32, interpret=True)
    assert _rel(_np(got), pal) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, WINDOW])
def test_flash_plain_tail_at_group_5_matches_the_full_prompt(dtype, window):
    """A tail's queries over a resident prefix (the prefix-reuse prefill)
    at G = 5 and head_dim 64: the last rows of the JAX oracle's whole
    prompt, windowed and not."""
    rng = np.random.default_rng(50 + window)
    M, T, H, K, D = 48, 20, 5, 1, 64
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, s, dtype) for s in
                                    [(1, M + T, H, D), (1, M + T, K, D),
                                     (1, M + T, K, D)])
    want = jref.flash_attention_ref(jq, jk, jv, causal=True, window=window)
    got = tfa.flash_attention_plain(tq[:, M:], tk, tv, causal=True,
                                    window=window)
    assert _rel(_np(got), np.asarray(want, np.float32)[:, M:]) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 8])
def test_decode_plain_at_group_5_head_dim_64_matches_jax(dtype, window):
    """Dense decode at G = 5, head_dim 64, per-slot lengths on both sides
    of the window."""
    rng = np.random.default_rng(15 + window)
    Bd, Sd, H, K, D = 3, 64, 10, 2, 64
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, s, dtype) for s in
                                    [(Bd, H, D), (Bd, Sd, K, D),
                                     (Bd, Sd, K, D)])
    lens = np.array([64, 7, 1], np.int32)
    want = jref.decode_attention_ref(jq, jk, jv, cache_len=jnp.asarray(lens),
                                     window=window)
    got = tdec.decode_attention_plain(tq, tk, tv,
                                      cache_len=torch.from_numpy(lens),
                                      window=window)
    assert _rel(_np(got), want) < TOL[dtype]
    pal = pallas_decode(jq, jk, jv, cache_len=40, window=window, block_kv=16,
                        interpret=True)
    got40 = tdec.decode_attention_plain(tq, tk, tv, cache_len=40,
                                        window=window)
    assert _rel(_np(got40), pal) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 6])
def test_paged_plain_at_group_5_head_dim_64_matches_jax(dtype, window):
    """Paged decode at G = 5, head_dim 64: a full table, a -1 tail and a
    freed slot (row -1, length 1, zeros out)."""
    rng = np.random.default_rng(25 + window)
    Bd, H, K, D, bl, N, nb = 4, 5, 1, 64, 8, 12, 5
    perm = rng.permutation(N).astype(np.int32)
    tbl = np.full((Bd, nb), -1, np.int32)
    tbl[0, :5] = perm[:5]
    tbl[1, :2] = perm[5:7]
    tbl[2, :3] = perm[7:10]
    lens = np.array([40, 11, 17, 1], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, s, dtype) for s in
                                    [(Bd, H, D), (N, bl, K, D),
                                     (N, bl, K, D)])
    want = jref.paged_decode_attention_ref(
        jq, jk, jv, jnp.asarray(tbl), cache_len=jnp.asarray(lens),
        window=window)
    got = tdec.paged_decode_attention_plain(
        tq, tk, tv, torch.from_numpy(tbl), cache_len=torch.from_numpy(lens),
        window=window)
    assert _rel(_np(got), want) < TOL[dtype]
    assert np.abs(_np(got)[3]).max() == 0.0
    pal = pallas_paged(jq, jk, jv, jnp.asarray(tbl),
                       cache_len=jnp.asarray(lens), window=window,
                       interpret=True)
    live = [0, 1, 2]
    assert _rel(_np(got)[live], np.asarray(pal, np.float32)[live]) \
        < TOL[dtype]


# ---------------------------------------------------------------------
# minitron: the squared-ReLU FFN and its one-matrix wi
# ---------------------------------------------------------------------

def test_convert_carries_the_one_matrix_wi_bit_for_bit():
    rarch, tarch, rparams, tparams = _model("minitron")
    L, d, ff = tarch.n_layers, tarch.d_model, tarch.d_ff
    assert not tarch.gated_mlp
    assert tuple(tparams["blocks"]["mlp"]["wi"].shape) == (L, d, ff)
    assert tlm.leaf_specs(tarch)["blocks"]["mlp"]["wi"].shape == (L, d, ff)
    flat = jax.tree_util.tree_flatten_with_path(rparams)[0]
    for path, leaf in flat:
        t = tparams
        for k in path:
            t = t[k.key]
        want = np.asarray(leaf)
        assert tuple(t.shape) == want.shape
        if want.dtype.name == "bfloat16":
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy(), want.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), want)
    # a gated (d, 2 ff) wi is refused, naming the leaf
    tree = jax.tree.map(np.asarray, rparams)
    tree["blocks"]["mlp"]["wi"] = np.concatenate(
        [tree["blocks"]["mlp"]["wi"]] * 2, axis=-1)
    with pytest.raises(ValueError, match="mlp/wi"):
        convert.params_from_numpy(tarch, tree, device="cpu")


def test_squared_relu_ffn_matches_jax():
    rarch, tarch, rparams, tparams = _model("minitron")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 9, tarch.d_model)).astype(np.float32)
    for i in range(tarch.n_layers):
        rgrp = jax.tree.map(lambda a: a[i], rparams["blocks"])
        want, _ = rlm._ffn_fwd(rarch, RCFG, rgrp,
                               jnp.asarray(x, jnp.bfloat16))
        got, _ = tlm._ffn_fwd(tarch, tlm.layer_params(tparams["blocks"], i),
                              torch.from_numpy(x).to(torch.bfloat16))
        assert got.dtype == torch.bfloat16
        assert _rel(_np(got), want) < TOL["bfloat16"]


def _prefill(name, tokens, max_len=MAX_LEN):
    rarch, tarch, rparams, tparams = _model(name)
    rl, rc = rlm.prefill(rarch, rparams, {"tokens": jnp.asarray(tokens)},
                         RCFG, max_len=max_len)
    tl, tc = tlm.prefill(tarch, tparams, {"tokens": torch.from_numpy(tokens)},
                         TCFG, max_len=max_len)
    return rl, rc, tl, tc


@pytest.mark.parametrize("name", ["minitron", "hymba"])
def test_prefill_logits_kv_rows_and_states_match(name):
    """Logits, every layer's K/V rows and, for hymba, every layer's SSM
    state and conv tail."""
    tokens = _tokens(_model(name)[0].vocab_size)
    rl, rc, tl, tc = _prefill(name, tokens)
    assert sorted(tc) == sorted(rc)
    assert tl.dtype == torch.bfloat16 and tuple(tl.shape) == rl.shape
    assert _rel(_np(tl), rl) < TOL["bfloat16"]
    for key in sorted(set(tc) - {"pos"}):
        want = np.asarray(rc[key], np.float32)
        got = _np(tc[key])
        assert got.shape == want.shape, key
        for layer in range(want.shape[0]):
            assert _rel(got[layer], want[layer]) < TOL["bfloat16"], \
                (key, layer)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(rc["pos"]))


def _paged(cache_np, nb_pool):
    """A dense prefill cache as a paged one: slot b owns blocks
    ``perm[b*nb:(b+1)*nb]`` of a pool with spare blocks; SSM/conv rows
    stay dense per slot."""
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


@pytest.mark.parametrize("name", ["minitron", "hymba"])
@pytest.mark.parametrize("residency", ["dense", "paged"])
def test_decode_steps_match(name, residency):
    """Six decode steps from the same prefilled cache (40 rows, past the
    16-token window), fed the same reference-greedy tokens: logits agree
    at every step, and hymba's SSM state and conv window at the end."""
    rarch, tarch, rparams, tparams = _model(name)
    tokens = _tokens(rarch.vocab_size, seed=1)
    _, rc, _, _ = _prefill(name, tokens)
    cache_np = {k: np.asarray(v, np.float32) for k, v in rc.items()}
    cache_np["pos"] = np.asarray(rc["pos"])
    if residency == "paged":
        cache_np = _paged(cache_np, nb_pool=2 * B * MAX_LEN // BL)
    bf = ("k", "v", "conv")

    def jx(k, v):
        return jnp.asarray(v, jnp.bfloat16) if k in bf else jnp.asarray(v)

    def th(k, v):
        t = torch.from_numpy(np.array(v))
        return t.to(torch.bfloat16) if k in bf else t

    rcache = {k: jx(k, v) for k, v in cache_np.items()}
    tcache = {k: th(k, v) for k, v in cache_np.items()}
    tok = tokens[:, -1:]
    for _ in range(6):
        rl, rcache = rlm.decode_step(rarch, rparams, rcache,
                                     {"tokens": jnp.asarray(tok)}, RCFG)
        tl, tcache = tlm.decode_step(tarch, tparams, tcache,
                                     {"tokens": torch.from_numpy(tok.copy())},
                                     TCFG)
        assert _rel(_np(tl), rl) < TOL["bfloat16"]
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(rcache["pos"]))
        tok = np.asarray(jnp.argmax(rl.astype(jnp.float32), -1),
                         np.int32)[:, None]
    for key in ("ssm", "conv"):
        if key in rcache:
            assert _rel(_np(tcache[key]), np.asarray(rcache[key],
                                                     np.float32)) \
                < TOL["bfloat16"]


def test_paged_cache_carries_dense_ssm_rows_beside_the_pools():
    _, tarch, _, tparams = _model("hymba")
    heads = tlm.cache_heads(tarch, tparams["blocks"])
    cache = tlm.init_paged_cache(tarch, 3, 64, BL, 8, device="cpu", **heads)
    L, H = tarch.n_layers, heads["ssm_heads"]
    assert tuple(cache["k"].shape) == (L, 8, BL, 1, 64)
    assert tuple(cache["ssm"].shape) == (L, 3, H, tarch.ssm_head_dim,
                                         tarch.ssm_state)
    assert cache["ssm"].dtype == torch.float32
    assert tuple(cache["conv"].shape) == (
        L, 3, tarch.ssm_conv,
        H * tarch.ssm_head_dim + 2 * tarch.ssm_n_groups * tarch.ssm_state)
    assert cache["conv"].dtype == torch.bfloat16
    _, march, _, _ = _model("minitron")
    assert "ssm" not in tlm.init_paged_cache(march, 3, 64, BL, 8,
                                             device="cpu")


# ---------------------------------------------------------------------
# engines: the port's against the JAX package's
# ---------------------------------------------------------------------

def _margin(name, prompt, out, i) -> float:
    rarch, _, rparams, _ = _model(name)
    toks = np.concatenate([prompt, np.asarray(out[:i], np.int32)])
    logits, _ = rlm.prefill(rarch, rparams,
                            {"tokens": jnp.asarray(toks[None])}, RCFG)
    lf = np.asarray(logits[0, :rarch.vocab_size], np.float32)
    top = np.sort(lf)[-2:]
    return float((top[1] - top[0]) / np.abs(lf).max())


def _same_tokens(name, reng, teng) -> int:
    """Greedy tokens equal under the margin rule, request by request
    (keyed by rid: both engines number submissions alike)."""
    got = {r.rid: r for r in teng.finished}
    compared = 0
    for w in reng.finished:
        g = got[w.rid]
        assert len(g.out_tokens) == len(w.out_tokens)
        for i, (a, b) in enumerate(zip(g.out_tokens, w.out_tokens)):
            if a != b:
                m = _margin(name, np.asarray(w.prompt), w.out_tokens, i)
                assert m <= MARGIN_TOL, (w.rid, i, a, b, m)
                break
            compared += 1
    return compared


KEYS = ("preemptions", "migrations", "grant_denials", "shed", "parked",
        "spills", "promotes", "prefix_hits", "prefix_hit_tokens",
        "prefix_rides", "cow_copies")


def _assert_like(name, reng, teng, min_tokens):
    rps, tps = reng.pressure_stats(), teng.pressure_stats()
    for k in KEYS:
        assert tps[k] == rps[k], (k, tps[k], rps[k])
    assert teng.prefill_calls == reng.prefill_calls
    assert list(teng.prefill_batches) == list(reng.prefill_batches)
    assert teng.block_stats() == reng.block_stats()
    assert len(teng.finished) == len(reng.finished)
    assert _same_tokens(name, reng, teng) >= min_tokens


def _plan_engines(name, shape=("serve", "decode", 256, 4)):
    """The port's ``h100-sxm`` plan for the reduced arch, served by
    ``from_plan(plan, params)`` with no keyword, and the JAX engine
    built with the plan's decisions."""
    rarch, tarch, rparams, tparams = _model(name)
    plan = tspecialize(tarch, TShape(*shape), mesh_shape=(1, 1),
                       target="h100-sxm", cache=False)
    est = plan.estimates
    teng = TServeEngine.from_plan(plan, tparams, arch=tarch)
    reng = RServeEngine(
        rarch, rparams, RCFG, max_batch=shape[3], max_len=shape[2],
        kv_residency=str(est["kv_residency"]),
        kv_block_len=int(est["kv_block_len"]),
        kv_n_blocks=int(est["kv_n_blocks"]),
        kv_admission=str(est["kv_admission"]),
        kv_host_blocks=int(est["kv_host_blocks"]),
        kv_prefix_reuse=str(est["kv_prefix_reuse"]),
        kv_prefetch=str(est["kv_prefetch"]))
    return plan, reng, teng


def test_hymba_plan_as_frozen_aliases_blocks_but_never_skips_compute():
    """The reduced hymba's ``h100-sxm`` plan (paged, prefix reuse on, a
    host tier) from ``from_plan(plan, params)``: three prompts share a
    two-block prefix and one is that prefix plus one token.  The trie
    aliases the shared blocks (hits, as in the JAX engine), but every
    request is prefilled whole — the SSM state needs every token — and
    nothing rides; tokens, counters and pools as the JAX engine's."""
    plan, reng, teng = _plan_engines("hymba")
    est = plan.estimates
    assert est["kv_residency"] == "paged" and est["kv_prefix_reuse"] == "on"
    assert teng.kv_prefix_reuse and not teng._skip_prefix
    bl = teng.block_len
    vocab = teng.arch.vocab_size
    rng = np.random.default_rng(4)
    system = rng.integers(0, vocab, 2 * bl).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(0, vocab, n)
                               .astype(np.int32)]) for n in (5, 1, 9)]
    prompts.append(rng.integers(0, vocab, 11).astype(np.int32))
    for eng in (reng, teng):
        eng.submit(prompts[0], max_new_tokens=6)
        eng.run_until_idle(max_ticks=64)
        for p in prompts[1:]:
            eng.submit(p, max_new_tokens=6)
        eng.run_until_idle(max_ticks=64)
    ps = teng.pressure_stats()
    assert ps["prefix_hits"] >= 2 and ps["prefix_rides"] == 0
    assert sum(teng.prefill_batches) == len(prompts)   # every feed prefilled
    _assert_like("hymba", reng, teng, min_tokens=12)
    for eng in (reng, teng):
        eng.drop_block_cache()
    st = teng.block_stats()
    assert st["free"] == st["total"] and st["host_free"] == st["host_total"]


def test_minitron_plan_as_frozen_matches_jax():
    """The reduced minitron's ``h100-sxm`` plan from ``from_plan(plan,
    params)``: prompts of mixed lengths, two behind a shared prefix (a
    tail prefill and a ride), tokens, counters and pools as the JAX
    engine's."""
    plan, reng, teng = _plan_engines("minitron")
    assert plan.estimates["kv_residency"] == "paged"
    bl = teng.block_len
    vocab = teng.arch.vocab_size
    rng = np.random.default_rng(6)
    system = rng.integers(0, vocab, bl).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(0, vocab, 7)
                               .astype(np.int32)]),
               np.concatenate([system, rng.integers(0, vocab, 1)
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
    _assert_like("minitron", reng, teng, min_tokens=12)


def test_hymba_park_with_state_carries_blocks_and_ssm_rows():
    """A paged hymba engine with a host tier: a forced victim parks its
    KV blocks in the host pool and its SSM/conv rows as host copies, and
    resumes by promote with no prefill call, its tokens exactly those of
    the unparked run; counters and pools as the JAX engine's."""
    rarch, tarch, rparams, tparams = _model("hymba")
    prompts = [np.arange(5, dtype=np.int32), np.arange(11, dtype=np.int32) * 3,
               np.arange(8, dtype=np.int32) * 7 + 2]
    kw = dict(max_batch=3, max_len=32, kv_residency="paged", kv_block_len=8,
              kv_n_blocks=9, kv_admission="grant", kv_host_blocks=16)
    runs = {}
    for park in (False, True):
        engines = (RServeEngine(rarch, rparams, RCFG, **kw),
                   TServeEngine(tarch, tparams, TCFG, **kw))
        for eng in engines:
            for p in prompts:
                eng.submit(p, max_new_tokens=6)
            for _ in range(3):
                eng.step()
            calls = eng.prefill_calls
            if park:
                victim = max(eng.active.values(),
                             key=lambda r: (len(r.out_tokens), -r.rid))
                eng.preempt(victim.rid)
                (parked,) = eng.preempted
                st = parked.parked_state
                assert st["kv_host"] and "ssm" in st and "conv" in st
            eng.run_until_idle(max_ticks=200)
            assert eng.prefill_calls == calls, "the resume re-prefilled"
        runs[park] = engines
    reng, teng = runs[True]
    _assert_like("hymba", reng, teng, min_tokens=12)
    assert {r.rid: r.out_tokens for r in teng.finished} == \
        {r.rid: r.out_tokens for r in runs[False][1].finished}
    ps = teng.pressure_stats()
    assert ps["parks_with_state"] == ps["resumes_by_promote"] == 1


# ---------------------------------------------------------------------
# full-size plans
# ---------------------------------------------------------------------

def test_full_size_hymba_and_minitron_plans_keep_the_reference_hashes():
    """On ``tpu-v5e`` the port's plans for both full-size archs hash as
    the JAX package's."""
    for name in ("hymba-1.5b", "minitron-8b"):
        for kind in ("decode", "prefill"):
            shape = ("s", kind, 2048, 8)
            rplan = rspecialize(rget_arch(name), RShape(*shape),
                                mesh_shape=(1, 1))
            tplan = tspecialize(tget_arch(name), TShape(*shape),
                                mesh_shape=(1, 1), target="tpu-v5e",
                                cache=False)
            assert tplan.content_hash() == rplan.content_hash(), (name, kind)
