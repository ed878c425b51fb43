"""Prefix KV reuse and the host spill tier: the port against the JAX package.

Each test runs a JAX function and its port counterpart on the same seeded
numpy inputs (and, for the model and the engine, the reference's own
parameters carried across by ``repro_torch.models.convert``), on the CPU:
the port through its kernels' plain versions.

Tolerances are the reference tests': 1e-5 in fp32 and 2e-2 of the
reference's largest magnitude in bf16 (the two packages round bf16 at
other places).  Greedy tokens must be identical wherever the
reference's top-2 logit margin exceeds 2e-2 of its logits' largest
magnitude (the rule of ``tests/test_torch_serve.py``); past a step
inside that margin a request is not compared further.  Engine counters
(prefill calls, prefix hits, rides, CoW copies, spills, promotes) and
both tiers' block accounting must be equal.
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
from repro.models import attention as rattn
from repro.models import lm as rlm
from repro.models.lm import RunCfg as RRunCfg
from repro.serve.engine import ServeEngine as RServeEngine
from repro.serve.prefix_cache import PrefixCache as RPrefix
from repro.serve.prefix_cache import chain_hashes as rchain
from repro_torch.configs import ShapeConfig as TShape
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core import specialize as tspecialize
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import serve as tserve
from repro_torch.models import convert
from repro_torch.models import lm as tlm
from repro_torch.models.lm import RunCfg as TRunCfg
from repro_torch.serve.engine import ServeEngine as TServeEngine
from repro_torch.serve.prefix_cache import PrefixCache as TPrefix
from repro_torch.serve.prefix_cache import chain_hashes as tchain

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
MARGIN_TOL = 2e-2
RCFG = RRunCfg(block_q=16, ssd_chunk=16)
TCFG = TRunCfg()
PAGED = dict(max_batch=4, max_len=32, kv_residency="paged",
             kv_block_len=16)
#: ``pressure_stats()`` keys the port adds to the reference's
PORT_PRESSURE_KEYS = ("parks_with_state", "resumes", "resumes_by_promote",
                      "prefetch_staged", "prefetch_consumed")


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


# ---------------------------------------------------------------------
# chain hashes and the trie
# ---------------------------------------------------------------------

@pytest.mark.parametrize("block_len", [0, 1, 16, 256])
@pytest.mark.parametrize("n", [0, 15, 16, 33, 1025])
def test_chain_hashes_are_byte_identical(block_len, n):
    toks = np.random.default_rng(n + block_len).integers(
        0, 151936, n).astype(np.int32)
    assert tchain(toks, block_len) == rchain(toks, block_len)
    assert tchain(list(toks), block_len) == rchain(toks, block_len)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_cache_matches_reference_op_for_op(seed):
    """One seeded stream of insert / match / evict / rekey on both
    tries: the same matches, tiers and stats after every operation."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 50, 64).astype(np.int32) for _ in range(6)]
    for p in prompts[3:]:                     # shared prefixes
        p[:32] = prompts[0][:32]
    rp, tp = RPrefix(1), TPrefix(1)
    next_id = 0
    resident = []
    for _ in range(400):
        op = int(rng.integers(0, 5))
        p = prompts[int(rng.integers(0, len(prompts)))]
        hashes = rchain(p, 8)
        if op == 0:
            n = int(rng.integers(1, len(hashes) + 1))
            blocks = list(range(next_id, next_id + n))
            next_id += n
            tier = "hbm" if rng.random() < 0.8 else "host"
            rp.insert(hashes[:n], blocks, tier=tier)
            tp.insert(hashes[:n], blocks, tier=tier)
            resident.extend(blocks)
        elif op == 1:
            assert tp.match(hashes) == rp.match(hashes)
        elif op == 2 and resident:
            k = int(rng.integers(1, 4))
            gone = [resident.pop(int(rng.integers(0, len(resident))))
                    for _ in range(min(k, len(resident)))]
            rp.evict(gone)
            tp.evict(gone)
        elif op == 3 and resident:
            i = int(rng.integers(0, len(resident)))
            pairs = [(resident[i], next_id)]
            resident[i] = next_id
            next_id += 1
            tier = "host" if rng.random() < 0.5 else "hbm"
            rp.rekey(pairs, tier)
            tp.rekey(pairs, tier)
        else:
            b = int(rng.integers(0, max(next_id, 1)))
            assert tp.has_block(b) == rp.has_block(b)
            if rp.has_block(b):
                assert tp.tier_of(b) == rp.tier_of(b)
        tp.hits += op == 1
        rp.hits += op == 1
        assert len(tp) == len(rp)
        assert tp.stats() == rp.stats()


# ---------------------------------------------------------------------
# flash attention at a query offset
# ---------------------------------------------------------------------

def _tail_inputs(dtype, M, T, H=4, K=2, D=32, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, M + T, H, D)).astype(np.float32)
    k = rng.standard_normal((2, M + T, K, D)).astype(np.float32)
    v = rng.standard_normal((2, M + T, K, D)).astype(np.float32)
    jt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jx = [jnp.asarray(a, jt) for a in (q, k, v)]
    tx = [torch.from_numpy(a).to(tt) for a in (q, k, v)]
    return jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,T", [(16, 8), (32, 17), (48, 1), (5, 30)])
@pytest.mark.parametrize("window", [0, 20])
def test_flash_plain_at_an_offset_matches_attention_tail(dtype, M, T,
                                                         window):
    """``flash_attention_plain`` with T queries over M + T keys against
    the JAX package's ``attention_tail``, and against the tail rows of
    the full-length call (queries at positions M..M+T-1)."""
    (jq, jk, jv), (tq, tk, tv) = _tail_inputs(dtype, M, T)
    B = jq.shape[0]
    qpos = jnp.broadcast_to(M + jnp.arange(T, dtype=jnp.int32), (B, T))
    kpos = jnp.broadcast_to(jnp.arange(M + T, dtype=jnp.int32), (B, M + T))
    want = rattn.attention_tail(jq[:, M:], jk, jv, q_positions=qpos,
                                k_positions=kpos, causal=True,
                                window=window, block_q=16)
    got = tfa.flash_attention_plain(tq[:, M:].contiguous(), tk, tv,
                                    causal=True, window=window)
    full = tfa.flash_attention_plain(tq, tk, tv, causal=True, window=window)
    assert tuple(got.shape) == want.shape
    assert _rel(got.float().numpy(), want) < TOL[dtype]
    assert _rel(got.float().numpy(), full[:, M:].float().numpy()) \
        < TOL[dtype]


def test_flash_plain_refuses_more_queries_than_keys():
    _, (q, k, v) = _tail_inputs("float32", 4, 4)
    with pytest.raises(ValueError, match="last positions"):
        tfa.flash_attention_plain(q, k[:, :5], v[:, :5])


# ---------------------------------------------------------------------
# prefill_tail and the host pool
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen():
    rarch = rget_arch("qwen3-8b").reduced()
    tarch = tget_arch("qwen3-8b").reduced()
    rparams = rlm.init_params(rarch, jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(
        tarch, jax.tree.map(np.asarray, rparams), device="cpu")
    return rarch, tarch, rparams, tparams


@pytest.mark.parametrize("M,T", [(16, 7), (32, 16), (16, 1)])
def test_prefill_tail_matches_reference(qwen, M, T):
    """Logits and tail K/V of the port's ``prefill_tail`` (prefix rows
    read from a pool through a block table) against JAX's (prefix rows
    as an ``(L, B, M, K, hd)`` stack), from the same prefix rows."""
    rarch, tarch, rparams, tparams = qwen
    bl = 16
    toks = np.random.default_rng(M + T).integers(
        0, rarch.vocab_size, (2, M + T)).astype(np.int32)
    _, rc = rlm.prefill(rarch, rparams, {"tokens": jnp.asarray(toks[:, :M])},
                        RCFG)
    pk, pv = rc["k"][:, :, :M], rc["v"][:, :, :M]
    rl, rk, rv = rlm.prefill_tail(rarch, rparams,
                                  {"tokens": jnp.asarray(toks[:, M:])},
                                  RCFG, pk, pv)
    # the same rows as a pool: batch row b owns blocks in reverse order
    L, B = pk.shape[:2]
    nbm = M // bl
    pools = {}
    for key, rows in (("k", pk), ("v", pv)):
        rows = convert.tensor_from_numpy(np.asarray(rows), "cpu")
        pools[key] = rows.reshape(L, B * nbm, bl, *rows.shape[3:]).flip(1)
    tbl = (B * nbm - 1 - torch.arange(B * nbm)).reshape(B, nbm)
    tl, tk, tv = tlm.prefill_tail(tarch, tparams,
                                  {"tokens": torch.from_numpy(toks[:, M:])},
                                  TCFG, pools["k"], pools["v"], tbl)
    assert tuple(tl.shape) == rl.shape and tuple(tk.shape) == rk.shape
    assert _rel(tl.float().numpy(), rl) < TOL["bfloat16"]
    for got, want in ((tk, rk), (tv, rv)):
        for layer in range(want.shape[0]):
            for pos in range(T):
                assert _rel(got[layer, :, pos].float().numpy(),
                            want[layer, :, pos]) < TOL["bfloat16"]


def test_prefill_tail_refuses_an_ssm_arch():
    arch = tget_arch("mamba2-2.7b").reduced()
    params = tlm.init_params(arch, torch.Generator().manual_seed(0))
    pool = torch.zeros((arch.n_layers, 1, 16, 1, 1))
    toks = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    with pytest.raises(ValueError, match="SSM state"):
        tlm.prefill_tail(arch, params, toks, TCFG, pool, pool,
                         torch.zeros((1, 1)))
    rarch = rget_arch("mamba2-2.7b").reduced()
    with pytest.raises(ValueError, match="SSM state"):
        rlm.prefill_tail(rarch, {}, {"tokens": jnp.zeros((1, 4), jnp.int32)},
                         RCFG, jnp.zeros((2, 1, 16, 1, 1)),
                         jnp.zeros((2, 1, 16, 1, 1)))


def test_host_pool_round_trip_is_bitwise(qwen):
    """gather → host pool → scatter back into another pool's ids gives
    the same bits, in the device pool's dtype, and the host pool has the
    JAX package's shape."""
    _, tarch, _, _ = qwen
    host = tlm.init_host_pool(tarch, 6, 16)
    rhost = rlm.init_host_pool(rget_arch("qwen3-8b").reduced(), 6, 16)
    assert tuple(host["k"].shape) == rhost["k"].shape
    assert host["k"].dtype == torch.bfloat16 and host["k"].device.type == "cpu"
    g = torch.Generator().manual_seed(0)
    pool = torch.randn((tarch.n_layers, 8, 16, 2, 32),
                       generator=g).to(torch.bfloat16)
    ids = torch.tensor([5, 1, 6])
    host["k"][:, [0, 3, 4]] = tlm.gather_blocks(pool, ids)
    other = torch.zeros_like(pool)
    tlm.scatter_blocks(other, torch.tensor([2, 7, 0]), host["k"][:, [0, 3, 4]])
    assert torch.equal(other[:, [2, 7, 0]], pool[:, ids])
    assert not other[:, [1, 3, 4, 5, 6]].any()


# ---------------------------------------------------------------------
# the engine scenarios of tests/test_serve_mixed.py, on both packages
# ---------------------------------------------------------------------

def _margin(rarch, rparams, prompt, out, i) -> float:
    toks = np.concatenate([prompt, np.asarray(out[:i], np.int32)])
    logits, _ = rlm.prefill(rarch, rparams,
                            {"tokens": jnp.asarray(toks[None])}, RCFG)
    lf = np.asarray(logits[0, :rarch.vocab_size], np.float32)
    top = np.sort(lf)[-2:]
    return float((top[1] - top[0]) / np.abs(lf).max())


def _same_tokens(qwen, prompts, got, want) -> int:
    """Tokens equal wherever the reference's margin allows; returns how
    many were held equal."""
    rarch, _, rparams, _ = qwen
    compared = 0
    for rid, w in want.items():
        g = got[rid]
        assert len(g) == len(w)
        for i, (a, b) in enumerate(zip(g, w)):
            if a != b:
                m = _margin(rarch, rparams, prompts[rid], w, i)
                assert m <= MARGIN_TOL, (rid, i, a, b, m)
                break
            compared += 1
    return compared


def _counters(eng) -> dict:
    ps = eng.pressure_stats()
    return {k: ps[k] for k in ("prefix_hits", "prefix_hit_tokens",
                               "prefix_rides", "cow_copies", "spills",
                               "promotes", "shared_blocks", "prefix_trie",
                               "cached_blocks")}


def _engines(qwen, **kw):
    rarch, tarch, rparams, tparams = qwen
    return (RServeEngine(rarch, rparams, RCFG, **PAGED, **kw),
            TServeEngine(tarch, tparams, TCFG, **PAGED, **kw))


def _shared_prefix_prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(0, vocab, 16).astype(np.int32)
    p1 = np.concatenate([sys_p, rng.integers(0, vocab, 1).astype(np.int32)])
    p2 = np.concatenate([sys_p, rng.integers(0, vocab, 1).astype(np.int32)])
    return p1, p2


def _assert_like(qwen, reng, teng, prompts, want, got):
    assert _same_tokens(qwen, prompts, got, want) >= len(want) * 3
    assert teng.prefill_calls == reng.prefill_calls
    assert list(teng.prefill_batches) == list(reng.prefill_batches)
    assert _counters(teng) == _counters(reng)
    assert teng.block_stats() == reng.block_stats()
    rps, tps = reng.pressure_stats(), teng.pressure_stats()
    # every reference key, and the port's ladder outcomes beside them
    assert sorted(tps) == sorted([*rps, *PORT_PRESSURE_KEYS])
    for k in ("preemptions", "migrations", "grant_denials", "shed", "parked",
              "overloaded", "degraded", "prefill_mode", "disagg_inflight"):
        assert tps[k] == rps[k], k


@pytest.mark.parametrize("reuse", ["on", "off"])
def test_staggered_shared_prefix_run_matches_reference(qwen, reuse):
    """``test_serve_mixed.py``'s staggered shared-prefix run: p1 first,
    p2 (a divergent sharer) once p1 is resident, then a p1 repeat.
    Tokens, prefill calls, counters and pools as the JAX engine's."""
    p1, p2 = _shared_prefix_prompts(qwen[0].vocab_size)
    prompts = {0: p1, 1: p2, 2: p1}
    outs = []
    engines = _engines(qwen, kv_prefix_reuse=reuse)
    for eng in engines:
        eng.submit(p1, max_new_tokens=6)
        eng.step()
        eng.step()
        eng.submit(p2, max_new_tokens=6)
        eng.step()
        eng.submit(p1.copy(), max_new_tokens=6)
        done = eng.run_until_idle(max_ticks=64)
        assert len(done) == 3
        outs.append({r.rid: r.out_tokens for r in done})
    reng, teng = engines
    _assert_like(qwen, reng, teng, prompts, *outs)
    st = teng.block_stats()
    assert st["free"] == st["total"] and st["shared"] == 0
    ps = teng.pressure_stats()
    if reuse == "on":
        # p2 and the repeat both match the whole feed but its last
        # token: both ride, and only p1 is prefilled
        assert ps["prefix_hits"] == ps["prefix_rides"] == 2, ps
        assert teng.prefill_calls == 1
    else:
        assert ps["prefix_hits"] == 0 and teng.prefill_calls == 3


def test_forced_cow_divergence_matches_reference(qwen):
    """A sharer appears on a slot's partial append block mid-write: the
    CoW barrier copies before the append, tokens as the JAX engine's and
    as the untampered run's, no leak."""
    rarch = qwen[0]
    p = np.random.default_rng(3).integers(
        0, rarch.vocab_size, 20).astype(np.int32)
    runs = {}
    for tamper in (False, True):
        outs = []
        engines = _engines(qwen, kv_prefix_reuse="on")
        for eng in engines:
            eng.submit(p, max_new_tokens=8)
            eng.step()
            phantom = []
            if tamper:
                r = next(iter(eng.active.values()))
                blk = r.blocks[int(eng.slot_len[r.slot]) // eng.block_len]
                eng._alloc.retain([blk])
                phantom.append(blk)
            out = eng.run_until_idle(max_ticks=64)
            if phantom:
                eng._release_blocks(phantom)
            outs.append({r.rid: r.out_tokens for r in out})
        runs[tamper] = (engines, outs)
    (reng, teng), (want, got) = runs[True]
    _assert_like(qwen, reng, teng, {0: p}, want, got)
    assert teng.cow_copies == reng.cow_copies >= 1
    assert got == runs[False][1][1]
    st = teng.block_stats()
    assert st["free"] == st["total"]


@pytest.mark.parametrize("spill", [False, True])
def test_hit_after_spill_promotes_like_reference(qwen, spill):
    """p1 finishes and its prefix block stays engine-cached; spilled to
    the host tier (or not), p2's hit on it is a hit served by a promote.
    Tokens, counters and both tiers' accounting as the JAX engine's."""
    p1, p2 = _shared_prefix_prompts(qwen[0].vocab_size, seed=11)
    outs = []
    engines = _engines(qwen, kv_prefix_reuse="on", kv_host_blocks=8)
    for eng in engines:
        eng.submit(p1, max_new_tokens=6)
        eng.run_until_idle(max_ticks=64)
        assert eng.block_stats()["cached"] >= 1
        if spill:
            assert eng.spill_cached() >= 1
            assert eng.block_stats()["host_in_use"] >= 1
            assert eng._prefix.stats()["host_blocks"] >= 1
        eng.submit(p2, max_new_tokens=6)
        eng.run_until_idle(max_ticks=64)
        outs.append({r.rid: r.out_tokens for r in eng.finished})
    reng, teng = engines
    _assert_like(qwen, reng, teng, {0: p1, 1: p2}, *outs)
    ps = teng.pressure_stats()
    assert ps["prefix_hits"] >= 1
    assert ps["promotes"] == (1 if spill else 0), ps
    for eng in engines:
        eng.drop_block_cache()
    assert teng.block_stats() == reng.block_stats()
    st = teng.block_stats()
    assert st["free"] == st["total"]
    assert st["host_free"] == st["host_total"] == 8
    assert st["prefix_trie"] == 0


def test_spill_promote_round_trip_in_the_engine_is_bitwise(qwen):
    """A cached block's rows, spilled to the host pool and promoted back
    by a prefix hit, are the same bits in their new pool block."""
    p1, p2 = _shared_prefix_prompts(qwen[0].vocab_size, seed=5)
    _, teng = _engines(qwen, kv_prefix_reuse="on", kv_host_blocks=8)
    teng.submit(p1, max_new_tokens=6)
    teng.run_until_idle(max_ticks=64)
    (blk,) = list(teng._cached)
    snap = {k: teng.cache[k][:, blk].clone() for k in ("k", "v")}
    assert teng.spill_cached() == 1
    teng.submit(p2, max_new_tokens=2)
    teng.step()                                   # admission promotes
    (r,) = teng.active.values()
    for k in ("k", "v"):
        assert torch.equal(teng.cache[k][:, r.blocks[0]], snap[k])
    assert teng.pressure_stats()["promotes"] == 1
    teng.run_until_idle(max_ticks=16)
    assert teng.tier_ms["spill"] > 0 and teng.tier_ms["promote"] > 0


# ---------------------------------------------------------------------
# examples/serve_batch.py's flow, on both packages, the plan as frozen
# ---------------------------------------------------------------------

def test_serve_batch_flow_runs_the_plan_as_frozen(qwen):
    """The reduced qwen3-8b plan at decode 128 x 4 (target tpu-v5e,
    where the two packages' plan hashes agree) through ``from_plan(plan,
    params, arch=arch)`` with no overrides: both engines take the plan's
    prefix and host decisions, and greedy requests sharing a system
    prompt decode alike, with prefix hits and a ride."""
    rarch, tarch, _, _ = qwen
    shape = ("serve_demo", "decode", 128, 4)
    rplan = rspecialize(rarch, RShape(*shape), mesh_shape=(1, 1))
    tplan = tspecialize(tarch, TShape(*shape), mesh_shape=(1, 1),
                        target="tpu-v5e")
    assert tplan.content_hash() == rplan.content_hash()
    assert tplan.estimates["kv_prefix_reuse"] == "on"
    assert int(tplan.estimates["kv_host_blocks"]) > 0
    rparams = rlm.init_params(rarch, jax.random.PRNGKey(0),
                              *rplan.padded_sizes())
    tparams = convert.params_from_numpy(
        tarch, jax.tree.map(np.asarray, rparams), device="cpu")
    reng = RServeEngine.from_plan(rplan, rparams, arch=rarch)
    teng = TServeEngine.from_plan(tplan, tparams, arch=tarch)
    assert teng.kv_prefix_reuse and reng.kv_prefix_reuse
    assert teng.host_blocks == reng.host_blocks > 0
    assert teng.kv_prefetch == reng.kv_prefetch
    rng = np.random.default_rng(0)
    bl = teng.block_len
    sys_p = rng.integers(0, 512, bl).astype(np.int32)
    prompts = {}
    for i in range(6):
        tail = rng.integers(0, 512, (1 + 2 * i,)).astype(np.int32)
        prompts[i] = np.concatenate([sys_p, tail])
    prompts[6] = prompts[0].copy()                # rides
    outs = []
    for eng in (reng, teng):
        for i in range(len(prompts)):
            eng.submit(prompts[i], max_new_tokens=8, temperature=0.0)
            eng.step()
        done = eng.run_until_idle()
        outs.append({r.rid: r.out_tokens for r in done})
    _assert_like((rarch, tarch, rparams, tparams), reng, teng, prompts,
                 *outs)
    ps = teng.pressure_stats()
    assert ps["prefix_hits"] >= 5 and ps["prefix_rides"] >= 1, ps
    for eng in (reng, teng):
        eng.drop_block_cache()
    st = teng.block_stats()
    assert st == reng.block_stats()
    assert st["free"] == st["total"] and st["host_free"] == st["host_total"]


# ---------------------------------------------------------------------
# F1: archs the CUDA kernels cannot take are refused before any weights
# ---------------------------------------------------------------------

def test_device_check_refuses_group_7_on_cuda_before_any_weights():
    """The F1 check, now that the kernels take G = 7, hymba-1.5b's (G =
    5, head_dim 64), granite's (2, 64) and llama4's (5, 128), and flash
    at G = 3 with the decode pairs (4, 64) and (6, 128) that the 16-wide
    model axis needs: deepseek-coder-33b and hymba-1.5b are admitted on
    CUDA, and what the kernels still refuse — the decode at G = 3, and
    G = 6 at head_dim 64 (flash and decode) — is refused before any
    weights load, naming the kernels and the instances, by the device
    check; the launcher refuses an arch the port does not
    serve (hubert-xlarge: an encoder has no decode step) before any plan
    or weight too (on a CPU-only torch a CUDA generator would raise
    RuntimeError, not NotImplementedError)."""
    coder = tget_arch("deepseek-coder-33b")
    assert coder.n_heads // coder.n_kv_heads == 7
    tlm.check_on_device(coder, "cuda")
    tlm.check_on_device(coder, torch.device("cuda", 0))
    tlm.check_on_device(tget_arch("hymba-1.5b"), "cuda")
    three = dataclasses.replace(coder, n_heads=24, head_dim=128)
    with pytest.raises(NotImplementedError,
                       match=r"head_dim 128.*decode_attention at "
                       r"\(G, head_dim\) = \(3, 128\)") as e:
        tlm.check_on_device(three, "cuda")
    assert "flash_attention" not in str(e.value)
    tlm.check_on_device(dataclasses.replace(coder, n_heads=32, head_dim=64),
                        "cuda")
    six = dataclasses.replace(coder, n_heads=48, head_dim=64)
    with pytest.raises(NotImplementedError,
                       match=r"flash_attention at \(G, head_dim\) = "
                       r"\(6, 64\).*decode_attention"):
        tlm.check_on_device(six, torch.device("cuda", 0))
    with pytest.raises(NotImplementedError,
                       match=r"hubert-xlarge.*no decode step"):
        tserve.main(["--arch", "hubert-xlarge", "--full", "--device",
                     "cuda", "--from-plan"])


@pytest.mark.parametrize("name", ["qwen3-8b", "mamba2-2.7b", "hymba-1.5b",
                                  "minitron-8b"])
def test_device_check_admits_what_the_kernels_take(name):
    tlm.check_on_device(tget_arch(name), "cuda")
    tlm.check_on_device(tget_arch(name), "cpu")


def test_device_check_admits_group_7_on_the_cpu():
    coder = tget_arch("deepseek-coder-33b")
    tlm.check_on_device(coder, "cpu")
    small = dataclasses.replace(coder.reduced(), n_heads=14, n_kv_heads=2)
    assert small.n_heads // small.n_kv_heads == 7
    params = tlm.init_params(small, torch.Generator().manual_seed(0))
    eng = TServeEngine(small, params, TCFG, max_batch=2, max_len=32)
    eng.submit(np.arange(5, dtype=np.int32), max_new_tokens=3)
    assert len(eng.run_until_idle()[0].out_tokens) == 3
