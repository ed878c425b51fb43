"""Serve smoke of the PyTorch port: from_plan → staggered submits → idle.

The port's twin of ``scripts/serve_smoke.py``, mode for mode, with the
same seeds, the same request schedules (numpy and Python ``random``)
and the same assertions:

* default — forces ``kv_residency="dense"`` on a plan whose GQA
  kv_heads cannot split a model axis of 2 (the data-organization pass
  spills the cache's seq dim and picks ``shard_map_flash``); under
  ``torchrun --nproc-per-node 2`` the engine runs on that (1, 2) mesh
  and decodes through the sharded flash decode, alone on one device
  through the one-card path of the same residency on its (1, 1) plan;
* ``--paged`` — the block pool the pass chooses, bucketed batched
  admission, every block back in the pool at idle;
* ``--chaos [--seed N]`` — random mid-decode grant denials and simulated
  slow ticks on grant admission: **zero token divergence** from each
  request's uninterrupted single-request oracle, **zero leaked
  blocks**, at least one preemption and one flagged straggler tick;
* ``--prefix [--seed N]`` — 80% of the requests share a system prompt:
  reuse on against reuse off, **zero divergence**, a **>= 2x** cut in
  prefill calls and in freshly pinned blocks, **zero leaked refcounts**;
* ``--spill [--seed N]`` — the host tier behind the pool under forced
  evictions: more resident KV than the pool holds, more live sessions
  than slots, zero divergence, spills and promotes, both tiers whole;
* ``--disagg [--seed N]`` — prefill on spawned worker processes, one
  SIGKILLed mid-prefill: journal resume token-identical to the inline
  oracles; then a zero restart budget degrades to inline prefill,
  token-identical again; zero leaked blocks.

Every mode ends with one ``ServeEngine.telemetry()`` JSON line.  The
model is reduced qwen3-8b with random weights from seed 0; on a CUDA
device at its published head_dim and GQA group (the widths the card's
kernels are built for), on the CPU as the JAX package's smoke reduces
it.  ``--device`` defaults to ``cuda``; ``--device cpu`` runs the
kernels' plain versions.  A CUDA run of ``--disagg`` needs the caching
allocator's classic segments (the default): the workers map the weights
through CUDA IPC.

Run:  PYTHONPATH=src python scripts/torch_serve_smoke.py [--chaos] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import ShapeConfig, get_arch, reduced_on  # noqa: E402
from repro_torch.core.pipeline import specialize  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve.engine import PreemptionPolicy, ServeEngine  # noqa: E402


def smoke_arch(device: str):
    """Reduced qwen3-8b (on the card at its published head_dim and GQA
    group)."""
    return reduced_on(get_arch("qwen3-8b"), device)


def params_of(arch, plan, device):
    gen = torch.Generator(device).manual_seed(0)
    return lm.init_params(arch, gen, *plan.padded_sizes())


def report(label: str, eng: ServeEngine, note: str) -> None:
    """One telemetry JSON line + a human OK line, every mode the same."""
    print("telemetry:", json.dumps(eng.telemetry(), sort_keys=True))
    print(f"serve {label} OK: {note}")


def chaos(seed: int, device: str) -> int:
    """Fault-injection soak: plan-driven grant-mode engine vs chaos."""
    arch = smoke_arch(device)
    # 64-deep cache -> block_len 16, up to 4 blocks/seq: generations
    # below cross 1-3 block boundaries each, so the grant path (and the
    # injected denials) really fire
    shape = ShapeConfig("serve_chaos", "decode", 64, 2)
    plan = specialize(arch, shape, mesh_axes=("data", "model"),
                      mesh_shape=(1, 1))
    assert plan.estimates.get("kv_residency") == "paged"
    params = params_of(arch, plan, device)

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, arch.vocab_size, (plen,)).astype(np.int32)
               for plen in (5, 11, 8, 11, 5, 8, 14, 5)]
    new_tokens = [20, 25, 30, 16, 35, 22, 18, 27]

    # uninterrupted single-request oracles through the same plan
    want = []
    for p, mnt in zip(prompts, new_tokens):
        ref = ServeEngine.from_plan(plan, params, arch=arch, max_batch=1)
        ref.submit(p, max_new_tokens=mnt)
        want.append(ref.run_until_idle(max_ticks=128)[0].out_tokens)

    # the soak engine: grant admission (the documented ops hatch),
    # generous retry budget so chaos delays rather than sheds
    eng = ServeEngine.from_plan(
        plan, params, arch=arch, kv_admission="grant",
        preemption=PreemptionPolicy(max_preemptions=64,
                                    backoff_base_ticks=1,
                                    backoff_cap_ticks=4))
    chaos_rng = random.Random(seed)
    eng.grant_fault = lambda: chaos_rng.random() < 0.3
    inner = eng._sample

    def slow_sample(logits, temperatures):
        # simulated straggler tick: the engine's StepTimer (EWMA over
        # tick times, runtime/straggler.py) must flag these
        if eng.tick_timer.n >= 8 and chaos_rng.random() < 0.2:
            time.sleep(0.05)
        return inner(logits, temperatures)

    eng._sample = slow_sample
    for p, mnt in zip(prompts, new_tokens):
        eng.submit(p, max_new_tokens=mnt)
    done = eng.run_until_idle(max_ticks=2000)
    del eng._sample                    # the wrapper closes over the engine

    assert not eng.shed, \
        f"chaos shed {len(eng.shed)}: {[r.error for r in eng.shed]}"
    assert len(done) == len(prompts), (len(done), len(prompts))
    got = {r.prompt.tobytes(): r.out_tokens for r in done}
    for i, (p, w) in enumerate(zip(prompts, want)):
        assert got[p.tobytes()] == w, (
            f"TOKEN DIVERGENCE on request {i}: {got[p.tobytes()]} != {w}")
    eng.drop_block_cache()
    stats = eng.block_stats()
    assert stats["free"] == stats["total"] > 0, f"blocks leaked: {stats}"
    press = eng.pressure_stats()
    assert press["preemptions"] >= 1, \
        f"30% denial rate never forced an eviction: {press}"
    assert press["straggler_ticks"] >= 1, \
        f"injected slow ticks never flagged: {press}"
    report("chaos", eng,
           f"(seed {seed}) {len(done)} requests token-identical under "
           f"{press['grant_denials']} denials, "
           f"{press['preemptions']} preemptions, "
           f"{press['straggler_ticks']} straggler ticks; "
           f"pool whole at {stats['total']} blocks")
    return 0


def prefix(seed: int, device: str) -> int:
    """Session traffic for cross-request prefix KV reuse: 10 staggered
    requests, 8 of them opening with the same 48-token system prompt
    plus one distinct token (admission aliases 3 blocks and rides); the
    identical schedule replays with reuse off as the private-block
    oracle."""
    arch = smoke_arch(device)
    shape = ShapeConfig("serve_prefix", "decode", 64, 4)
    plan = specialize(arch, shape, mesh_axes=("data", "model"),
                      mesh_shape=(1, 1))
    assert plan.estimates.get("kv_residency") == "paged"
    assert plan.estimates.get("kv_prefix_reuse") == "on"
    params = params_of(arch, plan, device)

    rng = np.random.default_rng(seed)
    bl = plan.estimates["kv_block_len"]
    sys_prompt = rng.integers(0, arch.vocab_size, 3 * bl).astype(np.int32)
    prompts = [np.concatenate([sys_prompt, [t]]).astype(np.int32)
               for t in rng.integers(0, arch.vocab_size, 8)]
    # 20% private traffic: same length, unrelated content
    prompts += [rng.integers(0, arch.vocab_size,
                             (3 * bl + 1,)).astype(np.int32)
                for _ in range(2)]

    def run(reuse):
        eng = ServeEngine.from_plan(plan, params, arch=arch,
                                    kv_prefix_reuse=reuse)
        assert eng.kv_residency == "paged" and eng.block_len == bl
        # count every block freshly pinned from the pool (admission
        # budgets + grants): aliased blocks don't pass through here
        fresh = [0]
        alloc = eng._alloc
        orig_alloc, orig_one = alloc.allocate, alloc.allocate_one

        def counting_alloc(need, group=0):
            got = orig_alloc(need, group)
            if got:
                fresh[0] += len(got)
            return got

        def counting_one(group=0):
            b = orig_one(group)
            if b is not None:
                fresh[0] += 1
            return b

        alloc.allocate, alloc.allocate_one = counting_alloc, counting_one
        eng.submit(prompts[0], max_new_tokens=6)
        eng.step()               # session opener registers the prefix
        arrivals = list(prompts[1:])
        peak_shared = ticks = 0
        while (arrivals or eng.pending or eng.active
               or eng.preempted) and ticks < 400:
            if arrivals:
                eng.submit(arrivals.pop(0), max_new_tokens=6)
            eng.step()
            peak_shared = max(peak_shared,
                              eng.pressure_stats()["shared_blocks"])
            ticks += 1
        done = eng.finished
        assert len(done) == len(prompts) and not eng.shed, (
            len(done), len(eng.shed))
        # finished sessions' blocks survive drain as trie-retained cold
        # cache; drop it so the leak check tests conservation
        eng.drop_block_cache()
        stats = eng.block_stats()
        assert stats["free"] == stats["total"], f"blocks leaked: {stats}"
        assert stats["shared"] == 0 and stats["prefix_trie"] == 0, (
            f"refcounts leaked past drain: {stats}")
        return ({r.rid: r.out_tokens for r in done}, eng.prefill_calls,
                fresh[0], peak_shared, eng.pressure_stats(),
                eng.telemetry())

    got, calls_on, fresh_on, peak_shared, press, tel = run("on")
    want, calls_off, fresh_off, _, _, _ = run("off")
    assert got == want, "TOKEN DIVERGENCE vs the private-block oracle"
    assert calls_off >= 2 * calls_on, (
        f"prefix reuse must halve prefill calls at 80% overlap: "
        f"{calls_on} on vs {calls_off} off")
    assert fresh_off >= 2 * fresh_on, (
        f"prefix reuse must halve freshly pinned blocks: "
        f"{fresh_on} on vs {fresh_off} off")
    assert press["prefix_rides"] >= 1 and peak_shared >= 1, press
    print("telemetry:", json.dumps(tel, sort_keys=True))
    print(f"serve prefix OK: (seed {seed}) {len(prompts)} requests "
          f"token-identical to private-block oracles; prefill calls "
          f"{calls_off} -> {calls_on}, fresh blocks {fresh_off} -> "
          f"{fresh_on}, peak {peak_shared} shared blocks; refcounts "
          "conserved, pool whole at idle")
    return 0


def spill(seed: int, device: str) -> int:
    """Multi-tier residency soak: the plan's host tier behind a small
    pool, three sessions a slot and forced mid-decode evictions park
    victims' KV host-side and resume them by promotion."""
    arch = smoke_arch(device)
    shape = ShapeConfig("serve_spill", "decode", 64, 2)
    plan = specialize(arch, shape, mesh_axes=("data", "model"),
                      mesh_shape=(1, 1))
    est = plan.estimates
    assert est.get("kv_residency") == "paged"
    assert est.get("kv_tier_split") == "hbm+host", est.get("kv_tier_split")
    assert est.get("kv_host_blocks", 0) > 0, est
    params = params_of(arch, plan, device)

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, arch.vocab_size, (plen,)).astype(np.int32)
               for plen in (5, 11, 8, 14, 6, 12, 9, 13)]
    new_tokens = [30, 24, 36, 28, 32, 22, 34, 26]

    want = []
    for p, mnt in zip(prompts, new_tokens):
        ref = ServeEngine.from_plan(plan, params, arch=arch, max_batch=1)
        ref.submit(p, max_new_tokens=mnt)
        want.append(ref.run_until_idle(max_ticks=256)[0].out_tokens)

    eng = ServeEngine.from_plan(
        plan, params, arch=arch, kv_admission="grant",
        preemption=PreemptionPolicy(max_preemptions=64,
                                    backoff_base_ticks=2,
                                    backoff_cap_ticks=4))
    assert eng.kv_tiering and eng.host_blocks > 0, "plan tiering lost"
    hbm_total = eng.block_stats()["total"]
    for p, mnt in zip(prompts, new_tokens):
        eng.submit(p, max_new_tokens=mnt)

    churn = random.Random(seed)
    forced = peak_sessions = peak_resident = ticks = 0
    while (eng.pending or eng.active or eng.preempted) and ticks < 1000:
        # evict whoever is deepest into decode: the hardest state to
        # round-trip through the host tier (longest retained KV)
        deep = [r for r in eng.active.values() if len(r.out_tokens) >= 12]
        if deep and forced < 10 and churn.random() < 0.45:
            victim = max(deep, key=lambda r: len(r.out_tokens))
            eng.preempt(victim.rid)
            forced += 1
        eng.step()
        st = eng.block_stats()
        parked = sum(1 for q in eng.preempted
                     if q.parked_state is not None)
        peak_sessions = max(peak_sessions, len(eng.active) + parked)
        peak_resident = max(peak_resident,
                            st["in_use"] + st["host_in_use"])
        ticks += 1

    done = eng.finished
    assert not eng.shed, \
        f"spill churn shed {len(eng.shed)}: {[r.error for r in eng.shed]}"
    assert len(done) == len(prompts), (len(done), len(prompts))
    got = {r.prompt.tobytes(): r.out_tokens for r in done}
    for i, (p, w) in enumerate(zip(prompts, want)):
        assert got[p.tobytes()] == w, (
            f"TOKEN DIVERGENCE on request {i}: {got[p.tobytes()]} != {w}")
    for r in done:
        assert not r.blocks, f"finished rid {r.rid} still holds blocks"
    press = eng.pressure_stats()
    assert forced >= 1 and press["preemptions"] >= forced
    assert press["spills"] >= 1 and press["promotes"] >= 1, press
    assert peak_sessions > eng.max_batch, (
        f"host tier never carried extra sessions: peak {peak_sessions} "
        f"<= {eng.max_batch} slots")
    assert peak_resident > hbm_total, (
        f"resident KV never exceeded the HBM pool: peak {peak_resident} "
        f"<= {hbm_total} blocks: the host tier bought no capacity")
    eng.drop_block_cache()
    st = eng.block_stats()
    assert st["free"] == st["total"], f"HBM blocks leaked: {st}"
    assert st["host_free"] == st["host_total"], f"host blocks leaked: {st}"
    report("spill", eng,
           f"(seed {seed}) {len(done)} requests token-identical under "
           f"{forced} forced evictions ({press['spills']} spills, "
           f"{press['promotes']} promotes); peak {peak_sessions} live "
           f"sessions on {eng.max_batch} slots, peak {peak_resident} "
           f"resident blocks vs {hbm_total} HBM; both tiers whole")
    return 0


def disagg(seed: int, device: str) -> int:
    """Disaggregated-prefill chaos soak: prompts of several blocks stream
    their chunks home from worker processes; a seeded SIGKILL lands on a
    flight's worker once its journal holds an acked chunk and another is
    outstanding, and the engine re-dispatches from the journal.  A
    second engine with ``max_restarts=0`` is killed the same way and
    degrades to inline prefill under a typed ``DegradedMode``."""
    arch = smoke_arch(device)
    shape = ShapeConfig("serve_disagg", "decode", 64, 2)
    plan = specialize(arch, shape, mesh_axes=("data", "model"),
                      mesh_shape=(1, 1))
    assert plan.estimates.get("kv_residency") == "paged"
    assert plan.estimates.get("kv_prefill_mode") in ("inline", "disagg")
    params = params_of(arch, plan, device)

    rng = np.random.default_rng(seed)
    # plens 1 mod block_len: multi-block feeds, every chunk block-shaped
    plens = (17, 33, 49)
    prompts = [rng.integers(0, arch.vocab_size, (plen,)).astype(np.int32)
               for plen in plens]

    want = []
    for p in prompts:
        ref = ServeEngine.from_plan(plan, params, arch=arch, max_batch=1)
        ref.submit(p, max_new_tokens=6)
        want.append(list(ref.run_until_idle(max_ticks=256)[0].out_tokens))

    opts = {"heartbeat_s": 0.2, "backoff_base_s": 0.05,
            "backoff_cap_s": 0.2, "chunk_delay_s": 0.05}

    def drive(eng, rids, kill_rid, budget_s=420.0):
        """Step until drained, SIGKILLing ``kill_rid``'s worker the
        moment its flight is mid-prefill (journal non-empty, chunks
        outstanding).  Returns True when the kill landed."""
        killed = False
        deadline = time.time() + budget_s
        while (eng.pending or eng.active or eng.preempted
               or eng._disagg) and time.time() < deadline:
            eng.step()
            fl = eng._disagg.get(kill_rid)
            if not killed and fl is not None \
                    and 1 <= fl.acked < fl.nb_feed:
                killed = eng._fleet.kill_worker(rid=kill_rid)
        assert not (eng.pending or eng.active or eng._disagg), \
            "disagg drive timed out with work still live"
        return killed

    # ---- phase 1: kill mid-prefill, journal resume -------------------
    eng = ServeEngine.from_plan(
        plan, params, arch=arch, seed=0, kv_prefill_mode="disagg",
        disagg_workers=2, disagg_opts=dict(opts))
    try:
        assert eng.prefill_mode == "disagg", eng.prefill_mode
        rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        kill_rid = rids[int(rng.integers(0, len(rids)))]
        killed = drive(eng, rids, kill_rid)
        assert killed, "the mid-prefill kill window never opened"
        got = {r.rid: list(r.out_tokens) for r in eng.finished}
        for rid, w in zip(rids, want):
            assert got[rid] == w, (
                f"TOKEN DIVERGENCE on rid {rid} after worker kill: "
                f"{got[rid]} != {w}")
        tel = eng.telemetry()
        json.dumps(tel)                 # the snapshot must serialize whole
        fleet = tel["prefill"]["disagg"]["fleet"]
        assert fleet["deaths"] >= 1 and fleet["restarts"] >= 1, fleet
        assert tel["prefill"]["disagg"]["resumes"] >= 1, tel["prefill"]
        st = eng.block_stats()
        assert st["in_use"] == st["cached"], f"blocks leaked: {st}"
        assert eng.degraded is None and not eng.shed
        deaths = fleet["deaths"]
        resumes = tel["prefill"]["disagg"]["resumes"]
    finally:
        eng.shutdown()

    # ---- phase 2: restart budget 0 -> degrade to inline --------------
    eng2 = ServeEngine.from_plan(
        plan, params, arch=arch, seed=0, kv_prefill_mode="disagg",
        disagg_workers=1, disagg_opts=dict(opts, max_restarts=0))
    try:
        rids2 = [eng2.submit(p, max_new_tokens=6) for p in prompts]
        killed2 = drive(eng2, rids2, rids2[0])
        assert killed2, "the degraded-phase kill window never opened"
        got2 = {r.rid: list(r.out_tokens) for r in eng2.finished}
        for rid, w in zip(rids2, want):
            assert got2[rid] == w, (
                f"TOKEN DIVERGENCE on rid {rid} in degraded fallback: "
                f"{got2[rid]} != {w}")
        assert eng2.prefill_mode == "degraded", eng2.prefill_mode
        assert eng2.degraded is not None \
            and eng2.degraded.worker_deaths >= 1, eng2.degraded
        st2 = eng2.block_stats()
        assert st2["in_use"] == st2["cached"], f"blocks leaked: {st2}"
        report("disagg", eng2,
               f"(seed {seed}) {len(rids) + len(rids2)} requests "
               f"token-identical across "
               f"{deaths + eng2.degraded.worker_deaths} worker kill(s): "
               f"{resumes} journal resume(s), then degrade-to-inline "
               f"({eng2.degraded.reason}); pool whole")
    finally:
        eng2.shutdown()
    return 0


def default(paged: bool, device: str) -> int:
    """The plan-driven serve smoke: a staggered mix of prompt lengths,
    more requests than slots, every request finishing with its token
    count, through the plan's decode implementation."""
    import torch.distributed as dist
    # kv_heads=1 on a (model=2) plan mesh -> seq spill -> shard_map_flash
    arch = dataclasses.replace(smoke_arch(device), n_kv_heads=1)
    shape = ShapeConfig("serve_smoke", "decode", 32, 2)
    options = {} if paged else {"kv_residency": "dense"}
    plan = specialize(arch, shape, mesh_axes=("data", "model"),
                      mesh_shape=(1, 2), **options)
    impl = plan.estimates.get("decode_impl", "xla")
    assert impl == "shard_map_flash", f"plan chose {impl!r}"
    kvres = plan.estimates.get("kv_residency", "dense")
    assert kvres == ("paged" if paged else "dense"), kvres

    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = None
    if world > 1:
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(model=world, device_type=torch.device(
            device).type)
        plan = specialize(arch, shape, mesh_axes=("data", "model"),
                          mesh_shape=(1, world), **options)
    else:
        # one device: the same residency on its (1, 1) plan
        plan = specialize(arch, shape, mesh_axes=("data", "model"),
                          mesh_shape=(1, 1), kv_residency=kvres)
    gen = torch.Generator(device).manual_seed(0)
    pieces = None
    if mesh is not None:
        from repro_torch.serve.sharded import param_pieces
        pieces = param_pieces(mesh, plan, arch)
    params = lm.init_params(arch, gen, *plan.padded_sizes(), pieces=pieces)
    eng = ServeEngine.from_plan(plan, params, arch=arch, mesh=mesh)
    assert eng.kv_residency == kvres, (eng.kv_residency, kvres)
    # no silent fallback: on a mesh the ticks go through the sharded
    # flash decode, on one device through the residency's decode kernel
    if mesh is not None:
        assert eng.decode_path.startswith("shard_map_flash"), eng.decode_path
    else:
        assert eng.decode_path.startswith(
            "paged" if paged else "decode_attention"), eng.decode_path

    rng = np.random.default_rng(0)
    want_counts = []
    # staggered lengths; the leading same-length pair lands in one
    # bucketed prefill (both slots are free at t=0)
    for plen, mnt in ((11, 4), (11, 5), (5, 6), (8, 5), (14, 3)):
        eng.submit(rng.integers(0, arch.vocab_size, (plen,)).astype(np.int32),
                   max_new_tokens=mnt)
        want_counts.append(mnt)
    done = eng.run_until_idle(max_ticks=64)
    assert len(done) == len(want_counts), (len(done), len(want_counts))
    got = sorted(len(r.out_tokens) for r in done)
    assert got == sorted(want_counts), (got, want_counts)
    extra = ""
    if paged:
        eng.drop_block_cache()
        stats = eng.block_stats()
        assert stats["total"] > 0 and stats["free"] == stats["total"], \
            f"blocks leaked: {stats}"
        assert max(eng.prefill_batches) > 1, (
            "bucketed admission never batched a prefill: "
            f"{eng.prefill_batches}")
        extra = (f", paged pool {stats['total']}x{eng.block_len} rows "
                 "reclaimed")
    if mesh is None or dist.get_rank() == 0:
        report("smoke", eng,
               f"{len(done)} requests, {sum(got)} tokens via "
               f"{eng.decode_path} (plan {plan.content_hash()[:12]}){extra}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--paged", action="store_true",
                    help="exercise the paged block-pool residency path")
    ap.add_argument("--chaos", action="store_true",
                    help="seeded grant denials + slow ticks: zero token "
                         "divergence, zero leaked blocks")
    ap.add_argument("--prefix", action="store_true",
                    help="80%%-shared system prompt: >= 2x fewer prefill "
                         "calls and pinned blocks than reuse off, zero "
                         "divergence, zero leaked refcounts")
    ap.add_argument("--spill", action="store_true",
                    help="host-tier spill + promote under forced "
                         "evictions: more resident KV than the pool, zero "
                         "divergence, zero leaks in either tier")
    ap.add_argument("--disagg", action="store_true",
                    help="worker SIGKILLs mid-prefill: journal resume and "
                         "degraded fallback token-identical, zero leaks")
    ap.add_argument("--seed", type=int, default=0,
                    help="traffic seed (chaos denials / prefix sessions / "
                         "spill churn / disagg kills)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("torch_serve_smoke: no card visible; pass "
                         "--device cpu")
    if "RANK" in os.environ:            # under torchrun: the default mode's mesh
        import torch.distributed as dist
        dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
    if args.chaos:
        return chaos(args.seed, args.device)
    if args.prefix:
        return prefix(args.seed, args.device)
    if args.spill:
        return spill(args.seed, args.device)
    if args.disagg:
        return disagg(args.seed, args.device)
    return default(args.paged, args.device)


if __name__ == "__main__":
    sys.exit(main())
