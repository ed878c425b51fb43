"""Grant admission, the preemption ladder and park-with-state: the port
against the JAX package.

Each scenario of ``tests/test_preemption.py`` (and the tiered park of
``tests/test_serve_mixed.py``) runs on both engines in one process, on
the same prompts and the reference's own parameters
(``repro_torch.models.convert``), for reduced qwen3-8b, reduced
mamba2-2.7b, reduced hymba-1.5b (the reference's hybrid cell: paged KV
with dense SSM/conv rows per slot) and a reduced deepseek-coder-33b at
14 query heads over 2 kv heads (its GQA group of 7).  The port runs its kernels' plain versions
(CPU tensors).

Tolerances: greedy tokens must be identical wherever the reference's
top-2 logit margin exceeds 2e-2 of its logits' largest magnitude (the
bf16 rule of ``tests/test_torch_serve.py``); past a step inside that
margin a request is not compared further.  Every ladder counter
(preemptions, migrations, grant denials, parked, shed, spills,
promotes), prefill call and both tiers' block accounting must be equal:
the ladder's decisions read only block counts, never token values.  A
park with state must resume with the port's own uninterrupted tokens
exactly (its KV rows go to the host and come back bit for bit), and
staged prefetch rows must equal the host pool's bit for bit.

Plan tests at the end: the H100 partitioning branches record flash and
decode tiles at G = 7, the ``tpu-v5e`` plans keep the reference's
hashes, and the qwen3-8b / mamba2-2.7b H100 plans keep their tiles.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeConfig as RShape
from repro.configs import get_arch as rget_arch
from repro.core import specialize as rspecialize
from repro.models import lm as rlm
from repro.models.lm import RunCfg as RRunCfg
from repro.serve.engine import OverloadError as ROverloadError
from repro.serve.engine import PreemptionPolicy as RPolicy
from repro.serve.engine import Request as RRequest
from repro.serve.engine import ServeEngine as RServeEngine
from repro_torch.configs import ShapeConfig as TShape
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core import specialize as tspecialize
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import convert
from repro_torch.models.lm import RunCfg as TRunCfg
from repro_torch.runtime.fault import RestartPolicy
from repro_torch.serve.engine import OverloadError
from repro_torch.serve.engine import PreemptionPolicy as TPolicy
from repro_torch.serve.engine import Request as TRequest
from repro_torch.serve.engine import ServeEngine as TServeEngine

MARGIN_TOL = 2e-2
RCFG = RRunCfg(block_q=16, ssd_chunk=16)
TCFG = TRunCfg()
ARCHS = ["qwen3-8b", "mamba2-2.7b", "hymba-1.5b", "coder-g7"]
ATTN = ["qwen3-8b", "coder-g7"]
LADDER = ("preemptions", "migrations", "grant_denials", "shed", "parked",
          "spills", "promotes", "prefix_hits", "prefix_rides", "cow_copies",
          "overloaded")


def _arch(pkg_get, name):
    if name == "coder-g7":
        a = pkg_get("deepseek-coder-33b").reduced()
        return dataclasses.replace(a, n_heads=14, n_kv_heads=2)
    return pkg_get(name).reduced()


_MODELS: dict = {}


def _model(name):
    """(reference arch, port arch, reference params, port params)."""
    if name not in _MODELS:
        rarch, tarch = _arch(rget_arch, name), _arch(tget_arch, name)
        rparams = rlm.init_params(rarch, jax.random.PRNGKey(0))
        tparams = convert.params_from_numpy(
            tarch, jax.tree.map(np.asarray, rparams), device="cpu")
        _MODELS[name] = (rarch, tarch, rparams, tparams)
    return _MODELS[name]


def _engines(name, rpol=None, **kw):
    """The same engine on both packages; ``rpol`` is a
    :class:`PreemptionPolicy` keyword dict."""
    rarch, tarch, rparams, tparams = _model(name)
    rk = dict(kw, preemption=RPolicy(**rpol)) if rpol else dict(kw)
    tk = dict(kw, preemption=TPolicy(**rpol)) if rpol else dict(kw)
    return (RServeEngine(rarch, rparams, RCFG, **rk),
            TServeEngine(tarch, tparams, TCFG, **tk))


def _prompts(vocab):
    return [np.arange(5, dtype=np.int32) % vocab,
            (np.arange(11, dtype=np.int32) * 3) % vocab,
            (np.arange(8, dtype=np.int32) * 7 + 2) % vocab]


def _margin(name, prompt, out, i) -> float:
    rarch, _, rparams, _ = _model(name)
    toks = np.concatenate([prompt, np.asarray(out[:i], np.int32)])
    logits, _ = rlm.prefill(rarch, rparams,
                            {"tokens": jnp.asarray(toks[None])}, RCFG)
    lf = np.asarray(logits[0, :rarch.vocab_size], np.float32)
    top = np.sort(lf)[-2:]
    return float((top[1] - top[0]) / np.abs(lf).max())


def _same_tokens(name, prompts, got, want) -> int:
    """Tokens equal wherever the reference's margin allows (keyed by
    prompt bytes); returns how many were held equal."""
    compared = 0
    for key, w in want.items():
        g = got[key]
        assert len(g) == len(w)
        for i, (a, b) in enumerate(zip(g, w)):
            if a != b:
                m = _margin(name, prompts[key], w, i)
                assert m <= MARGIN_TOL, (key, i, a, b, m)
                break
            compared += 1
    return compared


def _by_prompt(done):
    return {r.prompt.tobytes(): list(r.out_tokens) for r in done}


def _assert_like(name, reng, teng, prompts, min_tokens):
    """Counters, prefill calls and pools equal; tokens equal under the
    margin rule."""
    rps, tps = reng.pressure_stats(), teng.pressure_stats()
    for k in LADDER:
        assert tps[k] == rps[k], (k, tps[k], rps[k])
    assert teng.prefill_calls == reng.prefill_calls
    assert list(teng.prefill_batches) == list(reng.prefill_batches)
    assert teng.block_stats() == reng.block_stats()
    assert len(teng.finished) == len(reng.finished)
    got, want = _by_prompt(teng.finished), _by_prompt(reng.finished)
    assert sorted(got) == sorted(want)
    by_key = {p.tobytes(): p for p in prompts}
    assert _same_tokens(name, by_key, got, want) >= min_tokens


def _drive(eng, prompts, new, force_ticks=(), max_ticks=400):
    """Submit everything, tick, and at ``force_ticks`` evict the active
    request with the most output (the hardest resume)."""
    for p in prompts:
        eng.submit(p, max_new_tokens=new)
    forced = ticks = 0
    while (eng.pending or eng.active or eng.preempted) and ticks < max_ticks:
        if eng.active and ticks in force_ticks:
            victim = max(eng.active.values(),
                         key=lambda r: (len(r.out_tokens), -r.rid))
            eng.preempt(victim.rid)
            forced += 1
        eng.step()
        ticks += 1
    return forced


def _oracle(name, prompts, new):
    """The port's own uninterrupted runs, one request at a time."""
    _, tarch, _, tparams = _model(name)
    out = {}
    for p in prompts:
        eng = TServeEngine(tarch, tparams, TCFG, max_batch=1, max_len=32)
        eng.submit(p, max_new_tokens=new)
        out[p.tobytes()] = eng.run_until_idle(max_ticks=64)[0].out_tokens
    return out


# ---------------- eviction + re-prefill, every arch -------------------

@pytest.mark.parametrize("name", ARCHS)
def test_preemption_token_identity_per_arch(name):
    """Two forced evictions (and re-prefills of prompt + generated) per
    arch: paged grant engines for attention archs, the dense SSM slot
    evicted through the hook.  Tokens, counters and pools as the
    reference's, tokens as the port's uninterrupted runs (margin rule),
    and the pool drains whole."""
    rarch = _model(name)[0]
    prompts = _prompts(rarch.vocab_size)
    kw = {}
    if rarch.has_attention:
        kw = dict(kv_residency="paged", kv_block_len=8, kv_n_blocks=4,
                  kv_admission="grant")
    engines = _engines(name, dict(max_preemptions=16, backoff_base_ticks=1),
                       max_batch=2, max_len=32, **kw)
    forced = [_drive(eng, prompts, 6, force_ticks=(2, 9)) for eng in engines]
    reng, teng = engines
    assert forced[0] == forced[1] >= 1
    assert teng.preemptions >= forced[1]
    assert not (teng.pending or teng.active or teng.preempted)
    assert not teng.shed, [r.error for r in teng.shed]
    _assert_like(name, reng, teng, prompts, min_tokens=12)
    by_key = {p.tobytes(): p for p in prompts}
    assert _same_tokens(name, by_key, _by_prompt(teng.finished),
                        _oracle(name, prompts, 6)) >= 12
    st = teng.block_stats()
    assert st["free"] == st["total"], "blocks leaked"
    assert all(not r.blocks for r in teng.finished)


@pytest.mark.parametrize("name", ATTN)
def test_natural_exhaustion_preempts_and_recovers(name):
    """3 blocks of 8 rows: the 11-token prompt alone peaks at 3 blocks,
    so two concurrent requests collide mid-decode and the engine
    preempts on its own, with the reference's counts."""
    prompts = _prompts(_model(name)[0].vocab_size)
    engines = _engines(name, dict(max_preemptions=8, backoff_base_ticks=1),
                       max_batch=2, max_len=32, kv_residency="paged",
                       kv_block_len=8, kv_n_blocks=3, kv_admission="grant")
    for eng in engines:
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
        assert len(eng.run_until_idle(max_ticks=400)) == 3
    reng, teng = engines
    assert teng.preemptions >= 1 and teng.grant_denials >= 1
    _assert_like(name, reng, teng, prompts, min_tokens=12)
    assert teng.block_stats()["free"] == 3


def test_preempted_request_state_is_host_side():
    """A stateless park holds no slot and no blocks, keeps its tokens,
    waits out its backoff, and its feed is prompt + generated[:-1]."""
    engines = _engines("qwen3-8b", dict(backoff_base_ticks=8), max_batch=1,
                       max_len=32, kv_residency="paged", kv_block_len=8,
                       kv_admission="grant")
    prompt = _prompts(512)[0]
    for eng in engines:
        rid = eng.submit(prompt, max_new_tokens=8)
        for _ in range(3):
            eng.step()
        so_far = list(eng.active[0].out_tokens)
        eng.preempt(rid)
        (parked,) = eng.preempted
        r = parked.request
        assert r.rid == rid and r.slot == -1 and not r.blocks
        assert r.out_tokens == so_far and parked.parked_state is None
        assert parked.not_before_tick == eng.tick + 8
        assert len(r.feed_tokens) == len(prompt) + len(so_far) - 1
        assert eng.block_stats()["free"] == eng.block_stats()["total"]
    reng, teng = engines
    assert teng.pressure_stats()["parked"] == reng.pressure_stats()["parked"]


# ---------------- park with state -------------------------------------

@pytest.mark.parametrize("name,residency", [("qwen3-8b", "paged"),
                                            ("coder-g7", "paged"),
                                            ("hymba-1.5b", "paged"),
                                            ("hymba-1.5b", "dense"),
                                            ("qwen3-8b", "dense"),
                                            ("mamba2-2.7b", "dense")])
def test_tiered_park_resumes_without_reprefill(name, residency):
    """With a host tier, a forced victim parks with state (paged: its
    blocks spill to the host pool; dense: its stripe and SSM/conv rows
    are copied to the host) and resumes with no prefill call: tokens
    exactly the port's own unparked run, counters and pools as the
    reference's, no leak in either tier.  A hybrid parks both: its
    blocks (or stripe) and its SSM/conv rows."""
    prompts = _prompts(_model(name)[0].vocab_size)
    kw = dict(kv_residency="paged", kv_block_len=8, kv_n_blocks=9,
              kv_admission="grant") if residency == "paged" else {}
    runs = {}
    for park in (False, True):
        engines = _engines(name, dict(max_preemptions=8,
                                      backoff_base_ticks=1),
                           max_batch=3, max_len=32, kv_host_blocks=16, **kw)
        for eng in engines:
            for p in prompts:
                eng.submit(p, max_new_tokens=6)
            for _ in range(3):
                eng.step()           # all three admitted, mid-decode
            calls = eng.prefill_calls
            if park:
                victim = max(eng.active.values(),
                             key=lambda r: (len(r.out_tokens), -r.rid))
                eng.preempt(victim.rid)
                (parked,) = eng.preempted
                assert parked.parked_state is not None
                if eng.arch.has_ssm:
                    assert "ssm" in parked.parked_state
                    assert "conv" in parked.parked_state
                if eng.kv_residency == "paged":
                    assert parked.parked_state["kv_host"]
                    assert all(b >= eng.n_blocks
                               for b in parked.request.blocks)
            eng.run_until_idle(max_ticks=200)
            assert eng.prefill_calls == calls, "the resume re-prefilled"
        runs[park] = engines
    reng, teng = runs[True]
    _assert_like(name, reng, teng, prompts, min_tokens=12)
    assert _by_prompt(teng.finished) == _by_prompt(runs[False][1].finished)
    ps = teng.pressure_stats()
    assert ps["preemptions"] == ps["parks_with_state"] == ps["resumes"] == 1
    if residency == "paged":
        assert ps["resumes_by_promote"] == 1
        assert ps["promotes"] >= ps["spills"] >= 1
        for eng in (reng, teng):
            eng.drop_block_cache()
        st = teng.block_stats()
        assert st == reng.block_stats()
        assert st["free"] == st["total"] and st["host_free"] == st["host_total"]


def test_staged_prefetch_rows_equal_host_rows():
    """A park with state whose backoff ends next tick is staged one tick
    ahead: its rows, gathered from the host pool through the staging
    buffer, equal the host pool's bit for bit; the resume consumes them,
    and ``kv_prefetch="off"`` stages nothing."""
    for prefetch in ("on", "off"):
        _, teng = _engines("qwen3-8b", dict(backoff_base_ticks=2),
                           max_batch=3, max_len=32, kv_residency="paged",
                           kv_block_len=8, kv_n_blocks=9, kv_admission="grant",
                           kv_host_blocks=16, kv_prefetch=prefetch)
        for p in _prompts(512):
            teng.submit(p, max_new_tokens=6)
        for _ in range(3):
            teng.step()
        victim = max(teng.active.values(), key=lambda r: len(r.out_tokens))
        teng.preempt(victim.rid)
        host = list(teng.preempted[0].parked_state["kv_host"])
        teng.step()                  # resume at tick + 2: staged this tick
        staged = teng._staged.get(victim.rid)
        if prefetch == "off":
            assert staged is None and teng.prefetch_staged == 0
        else:
            ids, k_rows, v_rows, event = staged
            assert ids == tuple(host) and event is None
            idx = [h - teng.n_blocks for h in host]
            assert torch.equal(k_rows, teng._host["k"][:, idx])
            assert torch.equal(v_rows, teng._host["v"][:, idx])
        teng.run_until_idle(max_ticks=64)
        ps = teng.pressure_stats()
        want = 1 if prefetch == "on" else 0
        assert ps["prefetch_staged"] == ps["prefetch_consumed"] == want
        assert ps["resumes_by_promote"] == 1 and not teng._staged


# ---------------- migration --------------------------------------------

@pytest.mark.parametrize("name", ATTN)
def test_migration_rebalances_to_idle_sub_pool(name):
    """2 sub-pools of 3 blocks; both same-length prompts land in sub-pool
    0 and cross a block boundary on their first tick: one slot migrates
    (blocks, table row, state) to the idle sub-pool instead of evicting
    anyone, and every slot holds only its own sub-pool's blocks on every
    tick."""
    vocab = _model(name)[0].vocab_size
    p1 = (np.arange(8, dtype=np.int32) * 7 + 2) % vocab
    p2 = (np.arange(8, dtype=np.int32) * 3 + 1) % vocab
    engines = _engines(name, dict(max_preemptions=8), max_batch=4,
                       max_len=32, kv_residency="paged", kv_block_len=8,
                       kv_n_blocks=6, kv_admission="grant", kv_pool_groups=2)
    for eng in engines:
        eng.submit(p1, max_new_tokens=9)
        eng.submit(p2, max_new_tokens=9)
        while eng.pending or eng.active or eng.preempted:
            eng.step()
            for slot, r in eng.active.items():
                g = eng._slot_group(slot)
                assert all(eng._alloc.group_of(b) == g for b in r.blocks)
            assert eng.tick < 200, "stuck"
    reng, teng = engines
    assert teng.migrations >= 1 and teng.preemptions == 0
    _assert_like(name, reng, teng, [p1, p2], min_tokens=10)
    assert teng.block_stats()["free"] == 6


def test_kv_pool_groups_validation():
    _, _, _, tparams = _model("qwen3-8b")
    tarch = _model("qwen3-8b")[1]
    with pytest.raises(ValueError, match="kv_pool_groups"):
        TServeEngine(tarch, tparams, TCFG, max_batch=3, max_len=32,
                     kv_residency="paged", kv_block_len=8, kv_n_blocks=6,
                     kv_pool_groups=2)
    with pytest.raises(ValueError, match="kv_admission"):
        TServeEngine(tarch, tparams, TCFG, max_batch=2, max_len=32,
                     kv_admission="lazy")


# ---------------- overload and deadlines ------------------------------

def test_overload_sheds_with_typed_error():
    """Demand past the pool's thrash point trips the preemption-rate
    threshold at the same submission as the reference: ``submit``
    raises :class:`OverloadError`, doomed requests are shed holding
    nothing, and the engine drains instead of hanging."""
    p5 = np.arange(5, dtype=np.int32)
    pol = dict(max_preemptions=2, backoff_base_ticks=1, shed_window_ticks=8,
               shed_rate=0.25)
    engines = _engines("qwen3-8b", pol, max_batch=4, max_len=32,
                       kv_residency="paged", kv_block_len=8, kv_n_blocks=3,
                       kv_admission="grant")
    tripped = []
    for eng, err in zip(engines, (ROverloadError, OverloadError)):
        with pytest.raises(err, match="shedding load"):
            for i in range(60):
                eng.submit(p5, max_new_tokens=12)
                eng.step()
        tripped.append(i)
        assert eng.overloaded()
        eng.run_until_idle(max_ticks=600)
    assert tripped[0] == tripped[1]
    reng, teng = engines
    assert teng.shed and teng.finished
    for r in teng.shed:
        assert r.error and not r.blocks and not r.done
    assert [r.rid for r in teng.shed] == [r.rid for r in reng.shed]
    _assert_like("qwen3-8b", reng, teng, [p5], min_tokens=0)
    assert teng.block_stats()["free"] == teng.block_stats()["total"]


def test_deadline_sheds_pending_and_spares_victims():
    """A request already past its deadline is shed while pending, the
    other one served, as in the reference; victim choice spares
    deadline'd requests and evicts the latest deadline first."""
    p = _prompts(512)[0]
    engines = _engines("qwen3-8b", None, max_batch=1, max_len=32)
    for eng in engines:
        late = eng.submit(p, max_new_tokens=4, deadline_s=-1.0)
        ok = eng.submit(p, max_new_tokens=4)
        eng.run_until_idle(max_ticks=32)
        assert [r.rid for r in eng.shed] == [late]
        assert "deadline" in eng.shed[0].error
        assert [r.rid for r in eng.finished] == [ok]
    now = time.time()
    for Req, Pol in ((RRequest, RPolicy), (TRequest, TPolicy)):
        a = Req(0, p, out_tokens=[1, 2, 3], deadline=now + 5)
        b = Req(1, p, out_tokens=[1, 2])
        c = Req(2, p, out_tokens=[1, 2, 3, 4])
        d = Req(3, p, out_tokens=[1, 2, 3], deadline=now + 50)
        pol = Pol()
        assert pol.pick_victim([a, b, c], now).rid == 1
        assert pol.pick_victim([a, c], now).rid == 2
        assert pol.pick_victim([a, d], now).rid == 3
    # the backoff budget is the reference's RestartPolicy, in ticks
    rp = TPolicy(max_preemptions=3, backoff_base_ticks=1,
                 backoff_cap_ticks=2).restart_policy()
    assert isinstance(rp, RestartPolicy)
    assert [rp.next_delay() for _ in range(3)] == [1.0, 2.0, 2.0]
    with pytest.raises(RuntimeError, match="budget exhausted"):
        rp.next_delay()


def test_reserve_never_walks_the_ladder():
    """Reserve admission takes the full budget up front: no grants, no
    preemptions, serialization on exhaustion, as in the reference."""
    prompts = _prompts(512)
    engines = _engines("qwen3-8b", None, max_batch=2, max_len=32,
                       kv_residency="paged", kv_block_len=16)
    for eng in engines:
        assert eng.kv_admission == "reserve"
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
        assert len(eng.run_until_idle(max_ticks=64)) == 3
    reng, teng = engines
    assert teng.preemptions == teng.migrations == teng.grant_denials == 0
    assert not teng.shed and not teng.preempted
    _assert_like("qwen3-8b", reng, teng, prompts, min_tokens=12)


# ---------------- copy-on-write under pressure -------------------------

def test_cow_under_pressure_preempts_instead_of_raising():
    """A sharer appears on a slot's append block when the pool has no
    free block and no cold one: the barrier preempts a victim (the one
    holding the fewest shared blocks) where the port used to raise, and
    every request still finishes, as in the reference."""
    vocab = _model("qwen3-8b")[0].vocab_size
    rng = np.random.default_rng(9)
    a = rng.integers(0, vocab, 12).astype(np.int32)
    b = rng.integers(0, vocab, 12).astype(np.int32)
    engines = _engines("qwen3-8b", dict(max_preemptions=8,
                                        backoff_base_ticks=1),
                       max_batch=2, max_len=32, kv_residency="paged",
                       kv_block_len=8, kv_n_blocks=4, kv_admission="grant",
                       kv_prefix_reuse="on")
    for eng in engines:
        eng.submit(a, max_new_tokens=6)
        eng.submit(b, max_new_tokens=6)
        eng.step()                      # both admitted: 2 + 2 blocks
        assert eng.block_stats()["free"] == 0
        r = min(eng.active.values(), key=lambda x: x.rid)
        blk = r.blocks[int(eng.slot_len[r.slot]) // eng.block_len]
        eng._alloc.retain([blk])        # a phantom sharer
        eng.step()
        assert eng.preemptions >= 1
        eng._release_blocks([blk])
        eng.run_until_idle(max_ticks=200)
        assert len(eng.finished) == 2
    reng, teng = engines
    _assert_like("qwen3-8b", reng, teng, [a, b], min_tokens=4)
    st = teng.block_stats()
    assert st["free"] == st["total"]


# ---------------- the plan as frozen: grant ---------------------------

def _coder_like():
    """deepseek-coder-33b's attention widths (56 / 8 heads of 128) in
    two layers at d_model 256, for serving its full-size H100 plan on
    the CPU."""
    kw = dict(n_layers=2, d_model=256, d_ff=512)
    return (dataclasses.replace(rget_arch("deepseek-coder-33b"), **kw),
            dataclasses.replace(tget_arch("deepseek-coder-33b"), **kw))


def test_from_plan_serves_a_grant_plan():
    """The port's full-size deepseek-coder-33b plan at decode 2048 x 8 on
    ``h100-sxm`` picks grant admission over 8 blocks of 256 rows, 64
    host blocks, prefix reuse and prefetch on; ``from_plan(plan,
    params)`` serves it with no override.  Four ~500-token prompts take
    all 8 blocks at admission and cross into a third block together, so
    the engine preempts; victims park with state, resume by promote
    with no prefill call, and the tokens, counters and pools equal the
    reference engine built with the plan's decisions."""
    plan = tspecialize(tget_arch("deepseek-coder-33b"),
                       TShape("serve_h100", "decode", 2048, 8),
                       mesh_shape=(1, 1), target="h100-sxm", cache=False)
    est = plan.estimates
    assert est["kv_admission"] == "grant" and est["kv_n_blocks"] == 8
    assert est["kv_block_len"] == 256 and est["kv_host_blocks"] == 64
    assert est["kv_prefix_reuse"] == "on" and est["kv_prefetch"] == "on"
    rarch, tarch = _coder_like()
    rparams = rlm.init_params(rarch, jax.random.PRNGKey(0),
                              *plan.padded_sizes())
    tparams = convert.params_from_numpy(
        tarch, jax.tree.map(np.asarray, rparams), device="cpu")
    teng = TServeEngine.from_plan(plan, tparams, arch=tarch)
    reng = RServeEngine(rarch, rparams, RCFG, max_batch=8, max_len=2048,
                        kv_residency="paged", kv_block_len=256,
                        kv_n_blocks=8, kv_admission="grant",
                        kv_host_blocks=64, kv_prefix_reuse="on",
                        kv_prefetch="on")
    assert teng.kv_admission == "grant" and teng.n_blocks == 8
    assert teng.host_blocks == 64 and teng.kv_prefetch
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tarch.vocab_size, 500 + i).astype(np.int32)
               for i in range(4)]
    for eng in (reng, teng):
        for p in prompts:
            eng.submit(p, max_new_tokens=20)
        assert len(eng.run_until_idle(max_ticks=400)) == 4
    ps = teng.pressure_stats()
    assert ps["preemptions"] >= 1 and ps["parks_with_state"] >= 1
    assert ps["resumes_by_promote"] >= 1 and ps["prefetch_consumed"] >= 1
    assert ps["shed"] == 0 and teng.prefill_calls == 4
    rps = reng.pressure_stats()
    for k in LADDER:
        assert ps[k] == rps[k], (k, ps[k], rps[k])
    assert teng.prefill_calls == reng.prefill_calls
    assert teng.block_stats() == reng.block_stats()
    got, want = _by_prompt(teng.finished), _by_prompt(reng.finished)
    for key, w in want.items():      # first tokens: margin rule inline
        g = got[key]
        assert len(g) == len(w) == 20
        for i, (x, y) in enumerate(zip(g, w)):
            if x != y:
                toks = np.concatenate([np.frombuffer(key, np.int32),
                                       np.asarray(w[:i], np.int32)])
                lf = np.asarray(rlm.prefill(
                    rarch, rparams, {"tokens": jnp.asarray(toks[None])},
                    RCFG)[0][0, :rarch.vocab_size], np.float32)
                top = np.sort(lf)[-2:]
                assert (top[1] - top[0]) / np.abs(lf).max() <= MARGIN_TOL
                break


# ---------------- the plans at G = 7 ----------------------------------

def test_h100_plans_record_group_7_tiles():
    """deepseek-coder-33b on ``h100-sxm``: the decode plan records the
    split-KV decode tile and the prefill plan the flash tile of 18
    positions (126 of 128 rows), both tiles the kernels take at G = 7."""
    arch = tget_arch("deepseek-coder-33b")
    G = arch.n_heads // arch.n_kv_heads
    assert G == 7
    dplan = tspecialize(arch, TShape("d", "decode", 2048, 8),
                        mesh_shape=(1, 1), target="h100-sxm", cache=False)
    dec = dplan.partitions["decode_attention"]
    assert dict(dec.blocks) == {"block_kv": 256, "head_dim": 128}
    assert dec.vmem_bytes == tdec.smem_bytes(7, 256)
    assert tdec.takes_group(G, arch.hd)
    pplan = tspecialize(arch, TShape("p", "prefill", 2048, 8),
                        mesh_shape=(1, 1), target="h100-sxm", cache=False)
    fl = pplan.partitions["flash_attention"]
    assert dict(fl.blocks) == {"block_q": 18, "block_kv": 128,
                               "head_dim": 128}
    assert tfa.kernel_tiles(G, 18, 128) == (128, 128)
    assert "128 query rows hold 18 positions x G=7" in fl.grid_note


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_tpu_plans_keep_their_hashes_at_group_7(kind):
    """The ``tpu-v5e`` branches are untouched: the port's plan for
    deepseek-coder-33b hashes as the reference's."""
    shape = ("s", kind, 2048, 8)
    rplan = rspecialize(rget_arch("deepseek-coder-33b"), RShape(*shape),
                        mesh_shape=(1, 1))
    tplan = tspecialize(tget_arch("deepseek-coder-33b"), TShape(*shape),
                        mesh_shape=(1, 1), target="tpu-v5e", cache=False)
    assert tplan.content_hash() == rplan.content_hash()


@pytest.mark.parametrize("name,kind,want", [
    ("qwen3-8b", "decode", {"decode_attention": {"block_kv": 256,
                                                 "head_dim": 128},
                            "tiled_matmul": {"bm": 128, "bk": 64,
                                             "bn": 128}}),
    ("qwen3-8b", "prefill", {"flash_attention": {"block_q": 32,
                                                 "block_kv": 128,
                                                 "head_dim": 128},
                             "tiled_matmul": {"bm": 128, "bk": 64,
                                              "bn": 128}}),
    ("mamba2-2.7b", "decode", None)])
def test_h100_plans_of_the_served_models_keep_their_tiles(name, kind, want):
    """The qwen3-8b and mamba2-2.7b H100 plans record the tiles they
    recorded before G = 7 was taken."""
    plan = tspecialize(tget_arch(name), TShape("s", kind, 2048, 8),
                       mesh_shape=(1, 1), target="h100-sxm", cache=False)
    tiles = {k: dict(v.blocks) for k, v in plan.partitions.items()}
    if want is None:
        assert tiles["ssd_scan"]["chunk"] == 256
        assert tiles["ssd_scan"]["heads_block"] == 1
        assert "decode_attention" not in tiles
        return
    assert tiles == want
