"""Disaggregated prefill on the port against the JAX package: chunked
prefill, the plan-hash handshake, the worker-kill journal resume, the
degraded fallback, every scenario of ``tests/test_disagg.py``.

On the CPU, with reduced qwen3-8b's parameters carried across from the
reference by ``repro_torch.models.convert``, the port through its
kernels' plain versions.  Workers are spawned processes (a handful of
seconds each to import torch); every wait has its own deadline and
every fleet is shut down in a ``finally``, so a hung worker fails its
test instead of holding the run.

Greedy tokens against the JAX engine follow the margin rule of
``tests/test_torch_serve.py``: equal wherever the reference's top-2
logit margin exceeds 2e-2 of its logits' largest magnitude.  Against the
port's own inline engine they are equal, full stop: the chunked
prefill is bitwise the dense one on the CPU.
"""

import json
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
from repro.serve.engine import ServeEngine as RServeEngine
from repro_torch.configs import ShapeConfig as TShape
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core import specialize as tspecialize
from repro_torch.models import convert
from repro_torch.models import lm as tlm
from repro_torch.models.lm import RunCfg as TRunCfg
from repro_torch.serve.disagg import PlanHandshakeError, PrefillFleet
from repro_torch.serve.engine import ServeEngine as TServeEngine

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
MARGIN_TOL = 2e-2
RCFG = RRunCfg(block_q=16, ssd_chunk=16)
TCFG = TRunCfg()
#: the reference test's chaos options, and a deadline for every wait
OPTS = {"heartbeat_s": 0.2, "backoff_base_s": 0.05, "backoff_cap_s": 0.2,
        "chunk_delay_s": 0.05, "hello_timeout_s": 120.0}
WAIT_S = 240.0


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


@pytest.fixture(scope="module")
def setup():
    """Reduced qwen3-8b, its 64 x 2 decode plan on both packages (paged,
    inline), the reference's parameters and the port's copy of them."""
    rarch = rget_arch("qwen3-8b").reduced()
    tarch = tget_arch("qwen3-8b").reduced()
    rplan = rspecialize(rarch, RShape("serve_disagg_t", "decode", 64, 2),
                        mesh_axes=("data", "model"), mesh_shape=(1, 1))
    tplan = tspecialize(tarch, TShape("serve_disagg_t", "decode", 64, 2),
                        mesh_shape=(1, 1))
    assert tplan.estimates.get("kv_residency") == "paged"
    rparams = rlm.init_params(rarch, jax.random.PRNGKey(0),
                              *rplan.padded_sizes())
    tparams = convert.params_from_numpy(
        tarch, jax.tree.map(np.asarray, rparams), device="cpu")
    return rarch, tarch, rplan, tplan, rparams, tparams


def _margin(rarch, rparams, prompt, out, i) -> float:
    toks = np.concatenate([prompt, np.asarray(out[:i], np.int32)])
    logits, _ = rlm.prefill(rarch, rparams,
                            {"tokens": jnp.asarray(toks[None])}, RCFG)
    lf = np.asarray(logits[0, :rarch.vocab_size], np.float32)
    top = np.sort(lf)[-2:]
    return float((top[1] - top[0]) / np.abs(lf).max())


def _like_reference(setup, prompt, got, want) -> None:
    """``got`` equals the JAX engine's ``want`` wherever its margin
    allows (and is as long)."""
    rarch, _, _, _, rparams, _ = setup
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            m = _margin(rarch, rparams, prompt, want, i)
            assert m <= MARGIN_TOL, (i, a, b, m)
            return


def _reference_tokens(setup, prompt, n):
    rarch, _, rplan, _, rparams, _ = setup
    ref = RServeEngine.from_plan(rplan, rparams, arch=rarch, max_batch=1)
    ref.submit(prompt, max_new_tokens=n)
    return list(ref.run_until_idle(256)[0].out_tokens)


def _inline_tokens(setup, prompt, n):
    _, tarch, _, tplan, _, tparams = setup
    eng = TServeEngine.from_plan(tplan, tparams, arch=tarch, max_batch=1)
    eng.submit(prompt, max_new_tokens=n)
    return list(eng.run_until_idle(256)[0].out_tokens)


# ---------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------

@pytest.mark.parametrize("plen", [17, 48, 49])
def test_chunked_prefill_bitwise_identical_to_dense(setup, plen):
    """Chunked == dense, bitwise, on the port (block-aligned and ragged
    prompts); and against the JAX package's ``prefill_chunked`` at the
    bf16 tolerance."""
    rarch, tarch, _, _, rparams, tparams = setup
    bl = 16
    p = (np.arange(plen, dtype=np.int32) * 7 + 3) % rarch.vocab_size
    lg_full, cache = tlm.prefill(tarch, tparams,
                                 {"tokens": torch.from_numpy(p[None])},
                                 TCFG, max_len=64)
    chunks = []
    lg_c, ks, vs = tlm.prefill_chunked(
        tarch, tparams, p, bl, TCFG, kv_heads=cache["k"].shape[3],
        on_chunk=lambda i, k, v: chunks.append((i, k.shape[1])))
    k_c, v_c = torch.cat(ks, 1), torch.cat(vs, 1)
    assert [i for i, _ in chunks] == list(range(-(-plen // bl)))
    assert sum(t for _, t in chunks) == plen
    assert torch.equal(cache["k"][:, 0, :plen], k_c)
    assert torch.equal(cache["v"][:, 0, :plen], v_c)
    assert torch.equal(lg_full[0], lg_c)
    rl, rks, rvs = rlm.prefill_chunked(rarch, rparams, p, bl, RCFG,
                                       kv_heads=cache["k"].shape[3])
    V = rarch.vocab_size
    assert _rel(lg_c[:V].float().numpy(), np.asarray(rl[:V],
                                                     np.float32)) \
        <= TOL["bfloat16"]
    for got, want in ((k_c, rks), (v_c, rvs)):
        want = np.concatenate([np.asarray(w, np.float32) for w in want], 1)
        assert _rel(got.float().numpy(), want) <= TOL["bfloat16"]


def test_chunked_prefill_resumes_from_a_prefix_bitwise(setup):
    """The journal's contract: prefilling the rest of a prompt over the
    rows of its first chunks gives the remaining chunks' rows and the
    logits bitwise as the uninterrupted run does."""
    _, tarch, _, _, _, tparams = setup
    p = (np.arange(49, dtype=np.int32) * 11 + 5) % tarch.vocab_size
    lg, ks, vs = tlm.prefill_chunked(tarch, tparams, p, 16, TCFG)
    seen = []
    lg2, ks2, vs2 = tlm.prefill_chunked(
        tarch, tparams, p[32:], 16, TCFG, prefix_k=torch.cat(ks[:2], 1),
        prefix_v=torch.cat(vs[:2], 1),
        on_chunk=lambda i, k, v: seen.append(i))
    assert seen == [2, 3]
    assert torch.equal(lg, lg2)
    for a, b in zip(ks[2:] + vs[2:], ks2 + vs2):
        assert torch.equal(a, b)


def test_chunked_prefill_rejects_bad_inputs(setup):
    _, tarch, _, _, _, tparams = setup
    tok = np.arange(8, dtype=np.int32)
    with pytest.raises(ValueError, match="chunk must be"):
        tlm.prefill_chunked(tarch, tparams, tok, 0, TCFG)
    with pytest.raises(ValueError, match="at least one"):
        tlm.prefill_chunked(tarch, tparams, np.zeros((0,), np.int32), 16,
                            TCFG)
    _, ks, vs = tlm.prefill_chunked(tarch, tparams, tok, 4, TCFG)
    with pytest.raises(ValueError, match="not block-aligned"):
        tlm.prefill_chunked(tarch, tparams, tok, 16, TCFG,
                            prefix_k=torch.cat(ks, 1),
                            prefix_v=torch.cat(vs, 1))
    ssm = tget_arch("mamba2-2.7b").reduced()
    with pytest.raises(ValueError, match="pure-attention"):
        tlm.prefill_chunked(ssm, tlm.init_params(
            ssm, torch.Generator().manual_seed(0)), tok, 16, TCFG)


# ---------------------------------------------------------------------
# the fleet and the engine
# ---------------------------------------------------------------------

def test_handshake_rejects_mismatched_plan_hash(setup):
    """A worker whose rebuilt plan hashes differently is refused before
    any weight or KV crosses: typed, and the worker is reaped."""
    _, tarch, _, tplan, _, tparams = setup
    fleet = None
    try:
        with pytest.raises(PlanHandshakeError, match="content hash"):
            fleet = PrefillFleet(tplan, tarch, tparams, 1, block_len=16,
                                 _expect_hash="0" * 64, **OPTS)
    finally:
        if fleet is not None:
            fleet.shutdown()


class _Pending:
    """A copy out of a ring slot still queued on the card."""

    def __init__(self):
        self.done = False

    def query(self):
        return self.done


def test_ring_slots_go_back_oldest_first(setup):
    """The worker fills ring slots in turn, so the engine hands them back
    in turn: a chunk of a cancelled request, arriving while an older
    slot's copy out is still queued, frees nothing until that copy is
    done; then both slots go back.  No worker is spawned: the fleet's
    bookkeeping is driven with the messages a worker sends."""
    import threading

    from repro_torch.serve.disagg import RING_SLOTS
    _, tarch, _, tplan, _, tparams = setup
    fleet = PrefillFleet(tplan, tarch, tparams, 1, block_len=16,
                         start=False, **OPTS)
    slot = fleet._slots[0]
    slot.wid, slot.free = 7, threading.Semaphore(0)
    fleet._assign[1] = slot             # rid 1 is live, rid 2 cancelled
    events = []
    # a chunk of rid 1 on the CPU: copied out at once, its slot back
    fleet._handle(slot, ("chunk", 7, 1, 0, 0, 16, 0.0), events)
    assert [e[:3] for e in events] == [("chunk", 1, 0)]
    assert slot.free.acquire(blocking=False) and slot.copying == []
    # slots 1..3 taken for rid 1, their copies out queued (as CUDA
    # events on the card); then rid 2's chunk fills slot 0: the ring full
    pending = [_Pending() for _ in range(RING_SLOTS - 1)]
    slot.copying.extend(pending)
    fleet._handle(slot, ("chunk", 7, 2, 0, 0, 16, 0.0), events)
    assert len(events) == 1                     # nothing copied for rid 2
    assert not slot.free.acquire(blocking=False), \
        "a slot went back before the older slots' copies were done"
    pending[1].done = True                      # a younger copy finishing
    fleet._give_back(slot)
    assert not slot.free.acquire(blocking=False)
    pending[0].done = True
    fleet._give_back(slot)
    # slots 1 and 2 back; 3 still queued holds back the cancelled one
    assert [slot.free.acquire(blocking=False) for _ in range(3)] == \
        [True, True, False]
    pending[2].done = True
    fleet._give_back(slot)
    assert [slot.free.acquire(blocking=False) for _ in range(3)] == \
        [True, True, False]
    assert slot.copying == []


def _drive(eng, rid, kill_when, deadline_s=WAIT_S):
    """Step ``eng`` until idle, SIGKILLing ``rid``'s worker once
    ``kill_when(flight)`` holds; returns whether it was killed."""
    killed = False
    deadline = time.time() + deadline_s
    while (eng.pending or eng.active or eng._disagg) \
            and time.time() < deadline:
        eng.step()
        fl = eng._disagg.get(rid)
        if not killed and fl is not None and kill_when(fl):
            killed = eng._fleet.kill_worker(rid=rid)
    assert not (eng.pending or eng.active or eng._disagg), \
        f"not idle after {deadline_s} s"
    return killed


def test_kill_mid_prefill_resumes_from_journal(setup):
    """SIGKILL the worker with a prefill part-journaled: the engine
    re-dispatches from the last whole block and finishes with the port's
    inline tokens, and the JAX engine's where the margin allows, with
    the pool whole."""
    rarch, tarch, _, tplan, _, tparams = setup
    p = (np.arange(49, dtype=np.int32) * 7 + 3) % rarch.vocab_size
    want = _reference_tokens(setup, p, 6)
    inline = _inline_tokens(setup, p, 6)
    eng = None
    try:
        eng = TServeEngine.from_plan(
            tplan, tparams, arch=tarch, seed=0, kv_prefill_mode="disagg",
            disagg_workers=1, disagg_opts=dict(OPTS))
        assert eng.prefill_mode == "disagg"
        rid = eng.submit(p, max_new_tokens=6)
        assert _drive(eng, rid, lambda fl: 1 <= fl.acked < fl.nb_feed), \
            "the kill window never opened mid-prefill"
        [r] = [q for q in eng.finished if q.rid == rid]
        assert list(r.out_tokens) == inline, "token divergence after kill"
        _like_reference(setup, p, list(r.out_tokens), want)
        tel = eng.telemetry()
        json.dumps(tel)                 # the snapshot serializes whole
        assert tel["prefill"]["disagg"]["fleet"]["deaths"] >= 1
        assert tel["prefill"]["disagg"]["resumes"] >= 1
        assert eng.pressure_stats()["disagg_resumes"] >= 1
        st = eng.block_stats()
        assert st["in_use"] == st["cached"], f"blocks leaked: {st}"
    finally:
        if eng is not None:
            eng.shutdown()


def test_restart_budget_exhaustion_degrades_to_inline(setup):
    """Kill the only worker under ``max_restarts=0``: the fleet retires,
    the engine turns to a typed DegradedMode, and the orphaned request
    finishes in-process with the inline tokens — never a crash."""
    rarch, tarch, _, tplan, _, tparams = setup
    p = (np.arange(33, dtype=np.int32) * 11 + 5) % rarch.vocab_size
    want = _reference_tokens(setup, p, 6)
    inline = _inline_tokens(setup, p, 6)
    eng = None
    try:
        eng = TServeEngine.from_plan(
            tplan, tparams, arch=tarch, seed=0, kv_prefill_mode="disagg",
            disagg_workers=1, disagg_opts=dict(OPTS, max_restarts=0))
        rid = eng.submit(p, max_new_tokens=6)
        assert _drive(eng, rid, lambda fl: fl.acked >= 1)
        [r] = [q for q in eng.finished if q.rid == rid]
        assert list(r.out_tokens) == inline, "token divergence in fallback"
        _like_reference(setup, p, list(r.out_tokens), want)
        assert eng.prefill_mode == "degraded"
        assert eng.degraded is not None and eng.degraded.worker_deaths >= 1
        press = eng.pressure_stats()
        assert press["degraded"]["reason"].startswith("all 1 prefill worker")
        assert press["prefill_mode"] == "degraded"
        st = eng.block_stats()
        assert st["in_use"] == st["cached"], f"blocks leaked: {st}"
    finally:
        if eng is not None:
            eng.shutdown()


def test_from_plan_inline_without_workers(setup):
    """disagg with zero workers keeps the inline path (the fallback the
    pass itself takes for SSM archs)."""
    _, tarch, _, tplan, _, tparams = setup
    eng = TServeEngine.from_plan(tplan, tparams, arch=tarch,
                                 kv_prefill_mode="disagg")
    assert eng.prefill_mode == "inline"
    p = (np.arange(17, dtype=np.int32) * 3 + 1) % tarch.vocab_size
    eng.submit(p, max_new_tokens=4)
    [r] = eng.run_until_idle(256)
    assert len(r.out_tokens) == 4
    json.dumps(eng.telemetry())        # the fleet=None branch serializes
    # an SSM engine has no block pool (its state is dense by nature)
    ssm = tget_arch("mamba2-2.7b").reduced()
    with pytest.raises(ValueError, match="no block pool"):
        TServeEngine(ssm, tlm.init_params(
            ssm, torch.Generator().manual_seed(0)), TCFG, max_batch=2,
            max_len=32, kv_residency="paged").attach_fleet(object())


def test_plan_records_prefill_mode(setup):
    """The data-organization pass records the interference verdict: the
    reduced test plan stays inline, full-width qwen3-8b at 32k and its
    h100-sxm plan at 4096 x 8 turn disagg (chunk 512), as in the JAX
    package."""
    _, _, rplan, tplan, _, _ = setup
    est = tplan.estimates
    assert est.get("kv_prefill_mode") == "inline"
    assert est.get("kv_prefill_chunk", 0) >= 1
    full = tspecialize("qwen3-8b", "decode_32k", mesh_shape=(1, 1))
    assert full.estimates.get("kv_prefill_mode") == "disagg"
    assert full.estimates.get("kv_prefill_stall_ticks", 0.0) > 8.0
    h100 = tspecialize(tget_arch("qwen3-8b"),
                       TShape("serve_h100_4k", "decode", 4096, 8),
                       mesh_shape=(1, 1), target="h100-sxm")
    assert h100.estimates.get("kv_prefill_mode") == "disagg"
    assert h100.estimates.get("kv_prefill_chunk") == 512
    assert rplan.estimates.get("kv_prefill_mode") == "inline"
