"""The paged plan as frozen on a mesh: the host spill tier, migration
between the data shards' sub-pools, and disaggregated prefill into a
sharded pool, on gloo worlds of CPU ranks.

One world of 4 spawned ranks (``file://`` rendezvous, one thread a
rank) runs two meshes side by side: ranks 0-1 a ``(1, 2)`` mesh (the kv
heads split over ``model``, the host tier a rank's own heads) and ranks
2-3 a ``(2, 1)`` mesh (the pool split 2-D over ``(data, model)``: one
sub-pool a data shard, each rank a whole copy of the host tier).  The
model is reduced qwen3-8b, with the reference's parameters carried
across by ``repro_torch.models.convert``.

* **Host tier**, both meshes: a stream that parks a request with state
  (its blocks spilled, staged one tick ahead, promoted back), then
  spills every cold cached block and admits two prompts whose prefix
  hits the spilled blocks.  The JAX package's one-device engine runs the
  same stream in a ``JAX_PLATFORMS=cpu`` subprocess beside the world,
  with the same geometry and ``kv_pool_groups`` set to the data degree:
  tokens equal wherever its top-2 logit margin exceeds 2e-2 of its
  largest logit, every counter of ``tests/test_torch_preempt.py``'s
  ``LADDER`` equal, the spills, promotes and staged / consumed prefetches
  equal and above 0.
* **Migration** at ``(2, 1)``: the grant scenario of
  ``test_torch_preempt.py``'s migration test (2 sub-pools of 3 blocks):
  a slot moves to the other data shard's sub-pool, counters as the
  reference's, tokens under the margin rule, every slot's blocks in its
  own sub-pool and the block tables equal on every rank on every tick.
* **Disaggregated prefill**, both meshes, one worker owned by the mesh's
  first rank on the whole weights it gathers: a worker SIGKILLed with
  its prefill part-journaled resumes on every rank in the same tick,
  and the tokens equal the inline mesh engine's exactly;
  ``max_restarts=0`` puts every rank into ``DegradedMode`` in the same
  tick; the fleet's telemetry is the same on every rank.
* **Deadlines**, both meshes, with each rank's wall clock running at its
  own rate: a request whose deadline passes while it waits is shed in
  the same tick on every rank, because every rank reads the mesh's first
  rank's clock.
* **Planted faults**, each of which the same checks must catch: a spill
  that keeps only the rank's own blocks' rows (a promote into another
  data shard's sub-pool then writes rows it never had), a migration that
  moves the table row but not the rows, a chunk applied on the first
  rank only, deadlines read on each rank's own clock.
"""

import dataclasses
import datetime
import importlib.util
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

SRC = str(Path(__file__).resolve().parents[1] / "src")
MARGIN_TOL = 2e-2
LADDER = ("preemptions", "migrations", "grant_denials", "shed", "parked",
          "spills", "promotes", "prefix_hits", "prefix_rides", "cow_copies",
          "overloaded")
#: the cells: ranks 0-1 on (1, 2), ranks 2-3 on (2, 1)
CELLS = ((1, 2), (2, 1))
#: the tier scenario's geometry: 8-row blocks, 12 of them (6 a sub-pool
#: at (2, 1)), grant admission, 16 host blocks (explicit overrides of the
#: plan's estimates, as the reference's tests give them)
TIER = {"kv_residency": "paged", "kv_block_len": 8, "kv_n_blocks": 12,
        "kv_admission": "grant", "kv_host_blocks": 16,
        "kv_prefix_reuse": "on", "kv_prefetch": "on"}
#: ``test_torch_preempt.py``'s migration geometry: 2 sub-pools of 3
MIGRATE = {"kv_residency": "paged", "kv_block_len": 8, "kv_n_blocks": 6,
           "kv_admission": "grant", "kv_host_blocks": 0,
           "kv_prefix_reuse": "on", "kv_prefetch": "on"}
LIMITS = {"max_batch": 4, "max_len": 32}
TIER_POLICY = {"max_preemptions": 8, "backoff_base_ticks": 2}
MIGRATE_POLICY = {"max_preemptions": 8}
#: the disagg runs' chaos options (``tests/test_torch_disagg.py``'s)
OPTS = {"heartbeat_s": 0.2, "backoff_base_s": 0.05, "backoff_cap_s": 0.2,
        "chunk_delay_s": 0.05, "hello_timeout_s": 120.0}
WAIT_S = 120.0


def _prompts(vocab=512):
    """The tier stream's prompts: A, B, C first; D and E share A's first
    two blocks (16 tokens)."""
    s16 = (np.arange(16, dtype=np.int32) * 5 + 3) % vocab
    return {"A": np.concatenate([s16, [7]]).astype(np.int32),
            "B": (np.arange(13, dtype=np.int32) * 3) % vocab,
            "C": (np.arange(8, dtype=np.int32) * 7 + 2) % vocab,
            "D": np.concatenate([s16, [11, 13, 17, 19]]).astype(np.int32),
            "E": np.concatenate([s16, [23, 29, 31]]).astype(np.int32)}


def _migrate_prompts(vocab=512):
    return [(np.arange(8, dtype=np.int32) * 7 + 2) % vocab,
            (np.arange(8, dtype=np.int32) * 3 + 1) % vocab]


def _disagg_prompts(vocab=512):
    return {"kill": (np.arange(49, dtype=np.int32) * 7 + 3) % vocab,
            "degrade": (np.arange(33, dtype=np.int32) * 11 + 5) % vocab}


def tier_stream(eng, log=None):
    """The tier scenario on either package's engine: A, B, C admitted and
    decoded three ticks, the request with the most output parked with
    state (its blocks spilled; with the backoff of 2 ticks its rows are
    staged the tick before its resume, which promotes them), everything
    run out, every cold cached block spilled, then D and E admitted on a
    hit after spill.  ``log(eng)`` runs after every tick."""
    def run():
        ticks = 0
        while eng.pending or eng.active or eng.preempted:
            eng.step()
            ticks += 1
            if log is not None:
                log(eng)
            assert ticks < 200, "stuck"
    p = _prompts(eng.arch.vocab_size)
    for k in "ABC":
        eng.submit(p[k], max_new_tokens=6)
    for _ in range(3):
        eng.step()
        if log is not None:
            log(eng)
    victim = max(eng.active.values(),
                 key=lambda r: (len(r.out_tokens), -r.rid))
    eng.preempt(victim.rid)
    run()
    spilled = eng.spill_cached()
    for k in "DE":
        eng.submit(p[k], max_new_tokens=6)
    run()
    return spilled


class _Clock:
    """A rank's stand-in for the engine module's ``time``: its wall clock
    moves ``rate`` seconds at every read, so ranks with different rates
    read different times at the same point of a tick, as ranks that
    reach it at different instants do."""

    def __init__(self, rate):
        self.rate, self.now = rate, 1000.0
        self.perf_counter, self.sleep = time.perf_counter, time.sleep

    def time(self):
        self.now += self.rate
        return self.now


def deadline_stream(eng, short_s, log=None):
    """A, B, C and D fill the batch; E waits with a deadline of
    ``short_s`` seconds and C's prompt again with a distant one.
    ``log(eng)`` runs after every tick."""
    p = _prompts(eng.arch.vocab_size)
    for k in "ABCD":
        eng.submit(p[k], max_new_tokens=6)
    eng.submit(p["E"], max_new_tokens=6, deadline_s=short_s)
    eng.submit(p["C"], max_new_tokens=6, deadline_s=1e9)
    ticks = 0
    while eng.pending or eng.active or eng.preempted:
        eng.step()
        ticks += 1
        if log is not None:
            log(eng)
        assert ticks < 200, "stuck"


def _deadline_runs(plan, params, mesh, arch, rate):
    """:func:`deadline_stream` with the engine module's clock moving at
    ``rate``: as written, and with the planted fault (each rank's own
    clock read for the deadlines; no deadline passes, so the ranks act
    alike and only the clocks they read differ)."""
    from repro_torch.serve import engine as E
    keep_time, keep_now = E.time, E.ServeEngine._now
    out = {}
    try:
        for what in ("mesh_clock", "own_clock"):
            E.time = _Clock(rate)
            if what == "own_clock":
                E.ServeEngine._now = lambda eng: E.time.time()
            eng = _engine(plan, params, mesh, arch, TIER_POLICY)
            clocks = []
            deadline_stream(eng, 3.0 if what == "mesh_clock" else 1e9,
                            lambda e: clocks.append(e._now()))
            out[what] = {"clocks": clocks,
                         "shed": [(r.rid, r.error) for r in eng.shed],
                         "tokens": {r.rid: list(r.out_tokens)
                                    for r in eng.finished}}
    finally:
        E.time, E.ServeEngine._now = keep_time, keep_now
    return out


def dense_park_stream(eng, park):
    """A dense engine with the tier on: A, B (12 tokens) and C (5) in
    slots 0-2, three ticks, then (``park``) A parked with state (its
    stripe's rows copied to the host); D and E take slots 3 and 0 the
    next tick while C finishes, so A resumes into slot 2 (the other data
    shard's at (2, 1)).  Returns the tokens by prompt and the slots A
    held."""
    p = _prompts(eng.arch.vocab_size)
    rid = eng.submit(p["A"], max_new_tokens=6)
    eng.submit(p["B"], max_new_tokens=12)
    eng.submit(p["C"], max_new_tokens=5)
    for _ in range(3):
        eng.step()
    slots = [r.slot for r in eng.active.values() if r.rid == rid]
    if park:
        eng.preempt(rid)
    for k in "DE":
        eng.submit(p[k], max_new_tokens=6)
    while eng.pending or eng.active or eng.preempted:
        eng.step()
        slots += [r.slot for r in eng.active.values()
                  if r.rid == rid and r.slot != slots[-1]]
        assert eng.tick < 200, "stuck"
    return ({r.prompt.tobytes(): list(r.out_tokens) for r in eng.finished},
            slots)


def migrate_stream(eng, log=None):
    """Both same-length prompts land in sub-pool 0 and cross a block
    boundary on their first tick: one slot migrates."""
    for p in _migrate_prompts(eng.arch.vocab_size):
        eng.submit(p, max_new_tokens=9)
    while eng.pending or eng.active or eng.preempted:
        eng.step()
        if log is not None:
            log(eng)
        assert eng.tick < 200, "stuck"


# ---------------------------------------------------------------------
# the port's world
# ---------------------------------------------------------------------

def _arch():
    from repro_torch.configs import get_arch
    return get_arch("qwen3-8b").reduced()


def _plan(arch, mesh, seq=32, batch=4, **est):
    """The ``(data, model)`` decode plan of ``mesh``, its estimates
    overridden by ``est``."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.core.pipeline import specialize
    plan = specialize(arch, ShapeConfig("serve_mesh_tier_t", "decode", seq,
                                        batch),
                      mesh_axes=("data", "model"), mesh_shape=mesh,
                      cache=False)
    return dataclasses.replace(plan, estimates={**plan.estimates, **est})


def _meshes():
    """Both cells' meshes over the world of 4 (every rank builds both:
    a mesh's groups are made by every rank); rank r serves the cell of
    its half."""
    from torch.distributed.device_mesh import DeviceMesh
    out = {}
    for d, m in CELLS:
        grid = torch.arange(4).reshape(4 // (d * m), d, m)
        out[(d, m)] = DeviceMesh("cpu", grid, mesh_dim_names=(
            "rep", "data", "model"))["data", "model"]
    return out


class _Recorder:
    """What a run leaves to compare: tokens by prompt, counters, the
    first tick each disagg counter moved, the block tables."""

    def __init__(self):
        self.tables = []
        self.groups_ok = True
        self.resume_tick = None

    def __call__(self, eng):
        self.tables.append(eng.cache["block_tbl"].tolist())
        if eng.pool_groups > 1:
            for slot, r in eng.active.items():
                g = eng._slot_group(slot)
                if any(eng._alloc.group_of(b) != g for b in r.blocks
                       if b < eng.n_blocks):
                    self.groups_ok = False
        if self.resume_tick is None and eng.disagg_resumes:
            self.resume_tick = eng.tick


def _summary(eng, rec=None):
    ps = eng.pressure_stats()
    out = {"tokens": {r.prompt.tobytes(): list(r.out_tokens)
                      for r in eng.finished},
           "pressure": ps, "prefill_calls": eng.prefill_calls,
           "shed": [r.error for r in eng.shed],
           "host_blocks": eng.host_blocks, "groups": eng.pool_groups,
           "n_blocks": eng.n_blocks, "split": eng.cfg.kv_split,
           "host_shape": (tuple(eng._host["k"].shape)
                          if eng._host is not None else None),
           "pool_shape": tuple(eng.cache["k"].shape)}
    if rec is not None:
        out.update(tables=rec.tables, groups_ok=rec.groups_ok,
                   resume_tick=rec.resume_tick)
    return out


def _engine(plan, params, mesh, arch, policy, **kw):
    from repro_torch.serve.engine import PreemptionPolicy, ServeEngine
    return ServeEngine.from_plan(plan, params, arch=arch, mesh=mesh,
                                 preemption=PreemptionPolicy(**policy),
                                 **LIMITS, **kw)


class _Fault:
    """A planted fault, switched on for the block of a ``with``."""

    def __init__(self, which):
        self.which = which

    def __enter__(self):
        from repro_torch.serve import engine as E
        from repro_torch.serve import sharded as S
        self.saved = []
        keep = {n: getattr(E.ServeEngine, n) for n in (
            "_spill_rows", "_write_blocks", "_try_migrate", "_on_chunk")}
        read = S.MeshPieces.read_blocks

        def patch(cls, name, fn):
            self.saved.append((cls, name, getattr(cls, name)))
            setattr(cls, name, fn)

        if self.which == "promote_own_rows":
            # the spill keeps only the rows this rank's piece holds: the
            # gather from the owner left out
            def local(pc, t, ids):
                kv, pc.kv_split = pc.kv_split, "none"
                try:
                    ids = np.asarray(ids, np.int64)
                    loc = ids - pc.start
                    mine = (loc >= 0) & (loc < t.shape[1])
                    idx = torch.as_tensor(np.where(mine, loc, 0))
                    return t[:, idx] * torch.as_tensor(mine).view(
                        1, -1, 1, 1, 1).to(t.dtype)
                finally:
                    pc.kv_split = kv

            def spill(eng, pairs):
                patch(S.MeshPieces, "read_blocks", local)
                try:
                    keep["_spill_rows"](eng, pairs)
                finally:
                    setattr(S.MeshPieces, "read_blocks", read)
                    self.saved.pop()
            patch(E.ServeEngine, "_spill_rows", spill)
        elif self.which in ("migrate_table_only", "chunk_on_root_only"):
            where = ("_try_migrate" if self.which == "migrate_table_only"
                     else "_on_chunk")

            def inside(eng, *a):
                eng._planted = (self.which == "migrate_table_only"
                                or not eng.pieces.is_root)
                try:
                    return keep[where](eng, *a)
                finally:
                    eng._planted = False

            def write(eng, key, ids, rows):
                if getattr(eng, "_planted", False):
                    return
                keep["_write_blocks"](eng, key, ids, rows)
            patch(E.ServeEngine, where, inside)
            patch(E.ServeEngine, "_write_blocks", write)
        return self

    def __exit__(self, *exc):
        for cls, name, fn in reversed(self.saved):
            setattr(cls, name, fn)


def _drive_disagg(eng, rid, kill_when, rec):
    """Step until idle, SIGKILLing ``rid``'s worker once
    ``kill_when(flight)`` holds (every rank asks at the same tick: the
    journal is the same on every rank)."""
    import time
    killed = False
    deadline = time.time() + WAIT_S
    while eng.pending or eng.active or eng._disagg:
        assert time.time() < deadline, f"not idle after {WAIT_S} s"
        eng.step()
        rec(eng)
        fl = eng._disagg.get(rid)
        if not killed and fl is not None and kill_when(fl):
            killed = eng._fleet.kill_worker(rid=rid)
    return killed


def _disagg_runs(arch, mesh, cell, params, out, fault_too):
    """Inline, then the kill run, the degraded run and (``fault_too``)
    the kill-free run with chunks applied on the first rank only."""
    plan = _plan(arch, cell, seq=64, batch=4, kv_n_blocks=16)
    dp = _disagg_prompts(arch.vocab_size)
    from repro_torch.serve.engine import ServeEngine

    def build(**kw):
        return ServeEngine.from_plan(plan, params, arch=arch, mesh=mesh,
                                     seed=0, **kw)
    inline = {}
    for k, p in dp.items():
        eng = build()
        eng.submit(p, max_new_tokens=6)
        inline[k] = list(eng.run_until_idle(256)[0].out_tokens)
    out["inline"] = inline
    for what, opts, when in (
            ("kill", dict(OPTS), lambda fl: 1 <= fl.acked < fl.nb_feed),
            ("degrade", dict(OPTS, max_restarts=0),
             lambda fl: fl.acked >= 1)):
        eng = build(kv_prefill_mode="disagg", disagg_workers=1,
                    disagg_opts=opts)
        rec = _Recorder()
        try:
            mode = eng.prefill_mode
            rid = eng.submit(dp[what], max_new_tokens=6)
            killed = _drive_disagg(eng, rid, when, rec)
            tel = eng.telemetry()
            json.dumps(tel)
            out[what] = {
                "mode": mode, "killed": killed,
                "tokens": list(eng.finished[0].out_tokens),
                "resume_tick": rec.resume_tick,
                "degraded": (eng.degraded.to_json()
                             if eng.degraded is not None else None),
                "prefill_mode": eng.prefill_mode,
                "disagg": tel["prefill"]["disagg"],
                "pressure": {k: v for k, v in eng.pressure_stats().items()
                             if k.startswith(("disagg", "prefill",
                                              "degraded"))},
                "blocks": eng.block_stats(),
                "fleet_weight_bytes": eng.fleet_weight_bytes}
        finally:
            eng.shutdown()
    if fault_too:
        eng = build(kv_prefill_mode="disagg", disagg_workers=1,
                    disagg_opts=dict(OPTS, chunk_delay_s=0.0))
        try:
            with _Fault("chunk_on_root_only"):
                eng.submit(dp["kill"], max_new_tokens=6)
                _drive_disagg(eng, -1, lambda fl: False, _Recorder())
            out["fault_chunk"] = list(eng.finished[0].out_tokens)
        finally:
            eng.shutdown()


def _tier_world(rank, world, tmp):
    import torch.distributed as dist
    torch.set_num_threads(1)          # 4 ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    meshes = _meshes()
    cell = CELLS[rank // 2]
    mesh = meshes[cell]
    arch = _arch()
    params = torch.load(os.path.join(tmp, "params.pt"))
    res = {"cell": cell}
    try:
        plan = _plan(arch, cell, **TIER)
        eng = _engine(plan, params, mesh, arch, TIER_POLICY)
        rec = _Recorder()
        spilled = tier_stream(eng, rec)
        res["tier"] = dict(_summary(eng, rec), spilled=spilled)
        if cell == (2, 1):
            eng = _engine(plan, params, mesh, arch, TIER_POLICY)
            with _Fault("promote_own_rows"):
                tier_stream(eng)
            res["fault_promote"] = _summary(eng)
            plan = _plan(arch, cell, **MIGRATE)
            eng = _engine(plan, params, mesh, arch, MIGRATE_POLICY)
            rec = _Recorder()
            migrate_stream(eng, rec)
            res["migrate"] = _summary(eng, rec)
            eng = _engine(plan, params, mesh, arch, MIGRATE_POLICY)
            with _Fault("migrate_table_only"):
                migrate_stream(eng)
            res["fault_migrate"] = _summary(eng)
        dplan = _plan(arch, cell, kv_residency="dense")
        runs = []
        for park in (False, True):
            eng = _engine(dplan, params, mesh, arch, TIER_POLICY,
                          kv_host_blocks=16)
            runs.append((dense_park_stream(eng, park),
                         eng.pressure_stats()["parks_with_state"],
                         eng.prefill_calls, eng.kv_residency))
        res["dense_park"] = runs
        res["dense_slots_a_rank"] = eng.pieces.bn
        res["disagg"] = {}
        _disagg_runs(arch, mesh, cell, params, res["disagg"],
                     fault_too=cell == (1, 2))
        res["deadline"] = _deadline_runs(_plan(arch, cell, **TIER), params,
                                         mesh, arch, 1.0 + 6.0 * (rank % 2))
    except Exception:
        import traceback
        res["error"] = traceback.format_exc()[-4000:]
    torch.save(res, os.path.join(tmp, f"r{rank}.pt"))
    dist.destroy_process_group()


# ---------------------------------------------------------------------
# the JAX package's one-device engine, in a subprocess
# ---------------------------------------------------------------------

REFERENCE = """
import importlib.util, sys, numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, {src!r})
jax.config.update("jax_threefry_partitionable", True)
spec = importlib.util.spec_from_file_location("tier_test", {test!r})
T = importlib.util.module_from_spec(spec)
spec.loader.exec_module(T)
from repro.configs import get_arch
from repro.models.lm import RunCfg
from repro.serve.engine import PreemptionPolicy, ServeEngine
arch = get_arch("qwen3-8b").reduced()
params = {{}}
dtypes = np.load({tmp!r} + "/params_dtypes.npz")
for k, v in np.load({tmp!r} + "/params.npz").items():
    d = params
    parts = k.split("/")
    for p in parts[:-1]:
        d = d.setdefault(p, {{}})
    d[parts[-1]] = jnp.asarray(v).astype(jnp.dtype(str(dtypes[k])))
last = [None]


class Tokens(list):
    # a request's tokens, each beside the top-2 margin of its logits
    def __init__(self, margins):
        super().__init__()
        self.margins = margins

    def append(self, tok):
        super().append(tok)
        self.margins.append(last[0])


def engine(geom, groups, policy):
    kw = dict(geom)
    eng = ServeEngine(arch, params, RunCfg(block_q=16, ssd_chunk=16),
                      max_batch=T.LIMITS["max_batch"],
                      max_len=T.LIMITS["max_len"],
                      kv_pool_groups=groups if groups > 1 else 0,
                      preemption=PreemptionPolicy(**policy), **kw)
    sample = eng._sample

    def record(logits, temperature, key):
        lf = np.asarray(logits[:arch.vocab_size], np.float32)
        top = np.sort(lf)[-2:]
        last[0] = float((top[1] - top[0]) / np.abs(lf).max())
        return sample(logits, temperature, key)
    eng._sample = record
    submit = eng.submit
    eng.margins = {{}}

    def sub(prompt, **kw):
        rid = submit(prompt, **kw)
        m = eng.margins[np.asarray(prompt, np.int32).tobytes()] = []
        eng.pending[-1].out_tokens = Tokens(m)
        return rid
    eng.submit = sub
    # the port's prefetch counters, counted on the reference's staging
    eng.staged = eng.consumed = 0
    stage, promote = eng._stage_prefetch, eng._promote_rows

    def staging():
        before = dict(eng._staged)
        stage()
        eng.staged += sum(1 for k, v in eng._staged.items()
                          if k not in before or before[k][0] != v[0])

    def promoting(pairs, k_rows=None, v_rows=None):
        eng.consumed += k_rows is not None
        promote(pairs, k_rows, v_rows)
    eng._stage_prefetch, eng._promote_rows = staging, promoting
    return eng


def summary(eng):
    return {{"tokens": {{r.prompt.tobytes(): list(r.out_tokens)
                        for r in eng.finished}},
            "margins": eng.margins, "pressure": eng.pressure_stats(),
            "prefill_calls": eng.prefill_calls,
            "prefetch": (eng.staged, eng.consumed)}}


out = {{}}
for d, m in T.CELLS:
    eng = engine(T.TIER, d, T.TIER_POLICY)
    T.tier_stream(eng)
    out[f"tier{{d}}{{m}}"] = summary(eng)
eng = engine(T.MIGRATE, 2, T.MIGRATE_POLICY)
T.migrate_stream(eng)
out["migrate"] = summary(eng)
import pickle
with open({tmp!r} + "/ref.pkl", "wb") as f:
    pickle.dump(out, f)
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
    """The reference's parameters (made here with JAX, one seed), the
    port's copy of them, then the 4-rank world and the JAX subprocess
    side by side."""
    import pickle

    import jax
    import torch.multiprocessing as mp

    from repro.configs import get_arch as rget_arch
    from repro.models import lm as rlm
    from repro_torch.models import convert
    tmp = tmp_path_factory.mktemp("mesh_tier")
    arch = _arch()
    plan = _plan(arch, (1, 2))
    rarch = rget_arch("qwen3-8b").reduced()
    rparams = jax.tree.map(np.asarray, rlm.init_params(
        rarch, jax.random.PRNGKey(0), *plan.padded_sizes()))
    flat = _flat(rparams)
    np.savez(tmp / "params.npz", **{k: np.asarray(v, np.float32)
                                    for k, v in flat.items()})
    np.savez(tmp / "params_dtypes.npz", **{
        k: np.asarray(str(v.dtype)) for k, v in flat.items()})
    params = convert.params_from_numpy(arch, rparams, device="cpu")
    torch.save(params, tmp / "params.pt")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=SRC,
               OMP_NUM_THREADS="1")
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE.format(
            src=SRC, tmp=str(tmp), test=__file__))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        mp.start_processes(_tier_world, args=(4, str(tmp)), nprocs=4,
                           start_method="spawn")
        _, err = ref.communicate(timeout=300)
    finally:
        ref.kill()
    assert ref.returncode == 0, err[-3000:]
    ranks = [torch.load(tmp / f"r{r}.pt", weights_only=False)
             for r in range(4)]
    for r, res in enumerate(ranks):
        assert "error" not in res, f"rank {r}: {res['error']}"
    with open(tmp / "ref.pkl", "rb") as f:
        ref_out = pickle.load(f)
    return ranks, ref_out, params


def _margin_ok(ref, got):
    """``got`` tokens (by prompt) against the reference's under the
    margin rule; returns the tokens held equal."""
    compared = 0
    assert sorted(got) == sorted(ref["tokens"])
    for key, want in ref["tokens"].items():
        g = got[key]
        assert len(g) == len(want)
        for i, (a, b) in enumerate(zip(g, want)):
            if a != b:
                m = ref["margins"][key][i]
                assert m <= MARGIN_TOL, (i, a, b, m)
                break
            compared += 1
    return compared


def _counters_like(ref, got):
    for k in LADDER:
        assert got["pressure"][k] == ref["pressure"][k], (
            k, got["pressure"][k], ref["pressure"][k])
    assert got["prefill_calls"] == ref["prefill_calls"]
    assert (got["pressure"]["prefetch_staged"],
            got["pressure"]["prefetch_consumed"]) == ref["prefetch"]


def _cell_ranks(ranks, cell):
    return [r for r in ranks if r["cell"] == cell]


@pytest.mark.parametrize("cell", CELLS)
def test_host_tier_on_a_mesh_matches_the_reference(world, cell):
    """Spills, a park with state, a staged prefetch and a hit after
    spill on a mesh: the reference's one-device engine's counters and
    tokens (margin rule), the same on every rank; the rank's piece of
    the tier holds its kv heads where they split, every head where the
    pool splits by blocks."""
    ranks, ref, _ = world
    mine = _cell_ranks(ranks, cell)
    want = ref[f"tier{cell[0]}{cell[1]}"]
    got = mine[0]["tier"]
    _counters_like(want, got)
    ps = got["pressure"]
    assert ps["spills"] > 0 and ps["promotes"] > 0
    assert ps["prefetch_staged"] > 0 and ps["prefetch_consumed"] > 0
    assert ps["parks_with_state"] >= 1 and ps["resumes_by_promote"] >= 1
    assert ps["prefix_hits"] >= 1 and got["spilled"] > 0
    assert not got["shed"]
    assert _margin_ok(want, got["tokens"]) >= 15
    for other in mine[1:]:
        assert other["tier"]["tokens"] == got["tokens"]
        assert other["tier"]["tables"] == got["tables"]
        assert other["tier"]["pressure"] == got["pressure"]
    d, m = cell
    assert got["groups"] == d and got["host_blocks"] == TIER[
        "kv_host_blocks"]
    L, H, bl, K, hd = got["host_shape"]
    assert (H, bl) == (TIER["kv_host_blocks"], TIER["kv_block_len"])
    if cell == (1, 2):
        assert got["split"] == "heads" and K == got["pool_shape"][3] == 1
    else:
        assert got["split"] == "rows" and K == got["pool_shape"][3] == 2
        assert got["pool_shape"][1] == got["n_blocks"] // d


def test_promote_of_own_rows_only_is_caught(world):
    """The planted fault: a spill on a block-split pool that keeps only
    the rows the rank owns.  A promote into the other data shard's
    sub-pool then writes rows that rank never had, and the tokens leave
    the reference's past the margin rule."""
    ranks, ref, _ = world
    got = _cell_ranks(ranks, (2, 1))[0]["fault_promote"]
    want = ref["tier21"]
    with pytest.raises(AssertionError):
        _margin_ok(want, got["tokens"])


@pytest.mark.parametrize("cell", CELLS)
def test_dense_park_on_a_mesh_resumes_bitwise(world, cell):
    """A dense engine on a mesh parks a victim with state: its stripe's
    rows are read from the ranks that hold its slot and rows and written
    back into the lowest free slot (another data shard's at (2, 1));
    the tokens equal the unparked run's exactly, with no second prefill
    call."""
    ranks, _, _ = world
    for r in _cell_ranks(ranks, cell):
        ((plain, _), _, calls0, mode), ((parked, slots), parks, calls1,
                                        _) = r["dense_park"]
        assert mode == "dense" and parks == 1
        assert calls1 == calls0
        assert parked == plain
        assert slots == [0, 2]
        # 2 slots a data shard at (2, 1): slots 0 and 2 on other ranks
        assert r["dense_slots_a_rank"] == 4 // cell[0]


def test_migration_between_data_shards(world):
    """``test_torch_preempt.py``'s migration scenario at (2, 1): a slot
    moves to the other data shard's sub-pool (no preemption), the
    reference's counters and tokens, every slot's blocks in its own
    sub-pool, the block tables the same on every rank every tick."""
    ranks, ref, _ = world
    mine = _cell_ranks(ranks, (2, 1))
    got, want = mine[0]["migrate"], ref["migrate"]
    assert got["pressure"]["migrations"] >= 1
    assert got["pressure"]["preemptions"] == 0
    _counters_like(want, got)
    assert _margin_ok(want, got["tokens"]) >= 10
    assert got["groups_ok"] and got["groups"] == 2
    for other in mine[1:]:
        assert other["migrate"]["tables"] == got["tables"]
        assert other["migrate"]["tokens"] == got["tokens"]


def test_migration_without_its_rows_is_caught(world):
    """The planted fault: the table row moves and the rows do not; the
    moved slot's tokens leave the reference's past the margin rule."""
    ranks, ref, _ = world
    got = _cell_ranks(ranks, (2, 1))[0]["fault_migrate"]
    assert got["pressure"]["migrations"] >= 1
    with pytest.raises(AssertionError):
        _margin_ok(ref["migrate"], got["tokens"])


@pytest.mark.parametrize("cell", CELLS)
def test_disagg_on_a_mesh_resumes_and_degrades_in_step(world, cell):
    """One worker owned by the mesh's first rank, on the whole weights it
    gathered: a SIGKILL mid-prefill resumes from the journal in the same
    tick on every rank with the inline mesh engine's tokens exactly;
    ``max_restarts=0`` degrades every rank in the same tick; the
    telemetry is the same on every rank."""
    ranks, _, params = world
    mine = [r["disagg"] for r in _cell_ranks(ranks, cell)]
    root = mine[0]
    whole = sum(t.numel() * t.element_size() for t in
                (v for v in _flat(params).values()))
    assert root["kill"]["fleet_weight_bytes"] == whole
    for d in mine:
        assert d["kill"]["mode"] == "disagg"
        assert d["kill"]["killed"]
        assert d["kill"]["tokens"] == d["inline"]["kill"]
        assert d["kill"]["disagg"]["resumes"] >= 1
        assert d["kill"]["disagg"]["fleet"]["deaths"] >= 1
        st = d["kill"]["blocks"]
        assert st["in_use"] == st["cached"], st
        assert d["degrade"]["prefill_mode"] == "degraded"
        assert d["degrade"]["degraded"]["reason"].startswith(
            "all 1 prefill worker")
        assert d["degrade"]["tokens"] == d["inline"]["degrade"]
    for d in mine[1:]:
        assert d["inline"] == root["inline"]
        assert d["kill"]["resume_tick"] == root["kill"]["resume_tick"]
        assert d["degrade"]["degraded"] == root["degrade"]["degraded"]
        for what in ("kill", "degrade"):
            assert d[what]["disagg"] == root[what]["disagg"]
            assert d[what]["pressure"] == root[what]["pressure"]
        assert d["kill"]["fleet_weight_bytes"] == 0


def test_chunk_on_the_first_rank_only_is_caught(world):
    """The planted fault: the worker's chunks land in the first rank's
    heads only; the tokens leave the inline mesh engine's."""
    ranks, _, _ = world
    d = _cell_ranks(ranks, (1, 2))[0]["disagg"]
    assert d["fault_chunk"] != d["inline"]["kill"]


def _same_clock_on_every_rank(runs):
    for r in runs[1:]:
        assert r["clocks"] == runs[0]["clocks"]


@pytest.mark.parametrize("cell", CELLS)
def test_deadlines_on_a_mesh_read_the_first_ranks_clock(world, cell):
    """Each rank's clock runs at its own rate: every rank still reads the
    same time in every tick (the first rank's), sheds the waiting request
    whose deadline passed in the same tick, and serves the rest alike."""
    ranks, _, _ = world
    runs = [r["deadline"]["mesh_clock"] for r in _cell_ranks(ranks, cell)]
    _same_clock_on_every_rank(runs)
    root = runs[0]
    assert [rid for rid, _ in root["shed"]] == [4]
    assert "deadline missed while pending" in root["shed"][0][1]
    assert sorted(root["tokens"]) == [0, 1, 2, 3, 5]
    for r in runs[1:]:
        assert r["shed"] == root["shed"] and r["tokens"] == root["tokens"]


def test_deadlines_on_each_ranks_own_clock_are_caught(world):
    """The planted fault: each rank reads its own clock for the
    deadlines; the clocks the ranks read part in the first tick."""
    ranks, _, _ = world
    for cell in CELLS:
        runs = [r["deadline"]["own_clock"]
                for r in _cell_ranks(ranks, cell)]
        with pytest.raises(AssertionError):
            _same_clock_on_every_rank(runs)


def test_fleet_fit_check_names_the_bytes(monkeypatch):
    """The first rank refuses a fleet whose whole weights do not fit its
    device beside its pieces, before any worker spawns, naming the
    bytes; a fleet that fits passes."""
    from repro_torch.serve import disagg
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (10 ** 9, 80 * 10 ** 9))
    msg = disagg.fleet_fit_error(16 * 10 ** 9, 8 * 10 ** 9, "cuda:0")
    assert "16000000000 bytes" in msg and "8000000000 bytes" in msg
    assert "1000000000 bytes are free on cuda:0" in msg
    assert disagg.fleet_fit_error(10 ** 8, 10 ** 8, "cuda:0") == ""


def test_launcher_serves_disagg_on_a_mesh_under_torchrun():
    """``launch.serve --mesh 2x1 --disagg 1`` under ``torchrun
    --standalone`` on the CPU over gloo: the plan's host tier kept, one
    worker owned by rank 0 on the whole weights, every request
    served."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
         "--mesh", "2x1", "--disagg", "1", "--device", "cpu",
         "--requests", "3", "--new-tokens", "4", "--max-len", "64",
         "--max-batch", "4"],
        capture_output=True, text=True, env=env, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "mesh=(2, 1)" in out.stdout and "prefill_mode=disagg" in out.stdout
    assert "kv_host_blocks=64" in out.stdout
    assert "fleet_weight_bytes=" in out.stdout
    assert out.stdout.count("served 3 requests, 12 tokens") == 1
