"""Fault tolerance on the port against the JAX package: the heartbeat
monitor, the restart budget, the elastic grid's typed errors and the
step guard's recovery and bit-exact replay (``tests/test_runtime_dist.py``'s
scenarios), then the guard around the port's trainer: a failure at step
3 restored through the checkpointer and replayed to the state of a run
that never failed, bit for bit.  On the CPU.
"""

import numpy as np
import pytest
import torch

from repro.runtime import fault as rfault
from repro_torch.configs import ShapeConfig as TShape
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core import specialize as tspecialize
from repro_torch.data import SyntheticSource, to_device
from repro_torch.optim import adamw
from repro_torch.runtime import fault as tfault
from repro_torch.runtime import (HealthMonitor, RestartPolicy, StepGuard,
                                 elastic_mesh)
from repro_torch.train import Trainer, TrainerConfig


def test_health_monitor():
    hm = HealthMonitor(timeout_s=10)
    hm.beat(0, t=100.0)
    hm.beat(1, t=105.0)
    assert hm.dead_hosts(now=109.0) == []
    assert hm.dead_hosts(now=112.0) == [0]
    assert not hm.healthy(now=130.0)


def test_health_monitor_expect_flags_dead_on_arrival():
    """A worker that dies between spawn and its first heartbeat shows up
    dead: ``expect`` starts the deadline clock."""
    hm = HealthMonitor(timeout_s=10)
    hm.expect([7], t=100.0)
    assert hm.dead_hosts(now=105.0) == []      # still in its grace window
    assert hm.dead_hosts(now=111.0) == [7]     # never beat: dead on arrival
    hm.beat(7, t=112.0)
    assert hm.dead_hosts(now=120.0) == []      # a late first beat clears it
    hm.expect([7], t=200.0)                    # respawn: stale beat dropped
    assert hm.dead_hosts(now=205.0) == []
    assert hm.dead_hosts(now=211.0) == [7]
    hm.forget(7)
    assert hm.dead_hosts(now=500.0) == []      # retired on purpose


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_health_monitor_matches_reference_op_for_op(seed):
    """One seeded stream of expect / beat / forget / dead_hosts on both
    monitors: the same dead hosts after every operation."""
    rng = np.random.default_rng(seed)
    r, t = rfault.HealthMonitor(timeout_s=5.0), HealthMonitor(timeout_s=5.0)
    now = 0.0
    for _ in range(300):
        now += float(rng.uniform(0, 2))
        host = int(rng.integers(0, 6))
        op = int(rng.integers(0, 4))
        for m in (r, t):
            if op == 0:
                m.expect([host], t=now)
            elif op == 1:
                m.beat(host, t=now)
            elif op == 2:
                m.forget(host)
        assert t.dead_hosts(now) == r.dead_hosts(now)
        assert t.healthy(now) == r.healthy(now)


def test_restart_policy_backoff_and_budget():
    rp = RestartPolicy(max_restarts=3, backoff_base_s=1.0, backoff_cap_s=10)
    assert [rp.next_delay() for _ in range(3)] == [1.0, 2.0, 4.0]
    with pytest.raises(RuntimeError):
        rp.next_delay()


def test_restart_policy_zero_budget_and_cap():
    """max_restarts=0 refuses the first restart (the degrade-now
    config); the series clamps at the cap."""
    with pytest.raises(RuntimeError, match="restart budget exhausted"):
        RestartPolicy(max_restarts=0).next_delay()
    rp = RestartPolicy(max_restarts=6, backoff_base_s=1.0, backoff_cap_s=3.0)
    assert [rp.next_delay() for _ in range(6)] == [1.0, 2.0, 3.0, 3.0,
                                                  3.0, 3.0]


def test_elastic_mesh_preserves_model_axis():
    m = elastic_mesh(1, model_parallel=1)
    assert m.devices.shape == (1, 1)
    assert m.shape == {"data": 1, "model": 1}
    assert m.devices[0, 0] == tfault.visible_devices()[0]
    with pytest.raises(RuntimeError):
        elastic_mesh(0, model_parallel=2)


def test_elastic_mesh_typed_errors_name_the_shortfall():
    """Both failure modes are typed with the reference's messages: too
    few survivors for one model group, and a survivor count above what
    this process can see."""
    for mesh in (elastic_mesh, rfault.elastic_mesh):
        with pytest.raises(RuntimeError, match="cannot host"):
            mesh(1, model_parallel=2)
        # claims 16 survivors but only one CPU device is visible here
        with pytest.raises(RuntimeError, match="visible"):
            mesh(16, model_parallel=2)


def test_step_guard_recovers_from_failure():
    """A failure injected mid-run: the guard restores and completes."""
    saves = {}

    def make_step(mesh):
        def step(state, batch):
            new = {"x": state["x"] + batch}
            saves[int(new["x"])] = new
            return new, {"x": new["x"]}
        return step

    def restore(mesh):
        best = max(saves)
        return saves[best], int(best)

    calls = {"n": 0}

    def injector(step):
        if step == 3 and calls["n"] == 0:
            calls["n"] += 1
            raise RuntimeError("simulated device failure")

    guard = StepGuard(make_step, restore, model_parallel=1)
    state, step, _ = guard.run({"x": torch.tensor(0)},
                               batches=lambda s: torch.tensor(1),
                               n_steps=6, fail_injector=injector)
    assert step == 6
    assert int(state["x"]) == 6
    assert len(guard.events) == 1


@pytest.mark.parametrize("error", ["runtime", "oom"])
def test_step_guard_replay_is_deterministic(error):
    """The replay after a restore is bit-exact: the batch stream is a
    pure function of the step index, so a run that failed (a plain
    RuntimeError, or torch's out-of-memory error, which is one) ends in
    the state of one that never failed."""
    exc = {"runtime": RuntimeError("simulated failure"),
           "oom": torch.OutOfMemoryError("simulated out of memory")}[error]

    def run(inject):
        ckpt = [None, 0]
        calls = {"n": 0}
        box = [{"x": torch.tensor(0.5)}]

        def make_step(mesh):
            def step(state, batch):
                new = {"x": torch.tanh(state["x"] * 0.9 + batch)}
                box[0] = new
                return new, {}
            return step

        def restore(mesh):
            return ckpt[0], ckpt[1]

        def injector(step):
            if step == 2 and ckpt[0] is None:
                ckpt[0], ckpt[1] = dict(box[0]), step
            if inject and step == 4 and calls["n"] == 0:
                calls["n"] += 1
                raise exc

        guard = StepGuard(make_step, restore, model_parallel=1)
        state, step, _ = guard.run(
            box[0], lambda s: torch.tensor(np.sin(s + 1), dtype=torch.float32),
            n_steps=6, fail_injector=injector)
        assert step == 6
        assert len(guard.events) == (1 if inject else 0)
        return state["x"]

    assert torch.equal(run(inject=True), run(inject=False))


def test_step_guard_gives_up_past_its_budget():
    """With its restart budget spent, the guard lets the error out."""
    guard = StepGuard(lambda mesh: lambda s, b: (s, {}),
                      lambda mesh: ({}, 0),
                      policy=RestartPolicy(max_restarts=1))

    def always(step):
        raise RuntimeError("still broken")

    with pytest.raises(RuntimeError, match="restart budget exhausted"):
        guard.run({}, lambda s: None, n_steps=2, fail_injector=always)
    assert len(guard.events) == 1


def guarded_run(trainer, fail_injector=None):
    """The trainer's step under a :class:`StepGuard`, as
    ``tests/test_runtime_dist.py`` wires the guard: batches drawn from
    the synthetic source by step (so a replay sees the same batches),
    the starting state and every ``ckpt_every`` steps saved through the
    trainer's checkpointer, and a failure restored through
    ``trainer.resume()``.  Returns ``(state, step, guard, history)``,
    ``history`` the ``(step, loss)`` of every step run."""
    source = SyntheticSource(trainer.arch, trainer.shape,
                             seed=trainer.cfg.seed)
    put = to_device(trainer.device)
    every, history, at = trainer.cfg.ckpt_every, [], {}

    def batches(step):
        at["step"] = step
        return put(source.batch_at(step))

    def make_step(mesh):
        def step_fn(state, batch):
            state, metrics = trainer.step_fn(state, batch)
            history.append((at["step"], float(metrics["loss"])))
            if (at["step"] + 1) % every == 0:
                trainer.ckpt.save(at["step"] + 1, state, blocking=True)
            return state, metrics
        return step_fn

    state = trainer.init_state(trainer.cfg.seed)
    trainer.ckpt.save(0, state, blocking=True)
    guard = StepGuard(make_step, lambda mesh: trainer.resume())
    state, step, _ = guard.run(state, batches, trainer.cfg.n_steps,
                               fail_injector=fail_injector)
    return state, step, guard, history


def test_trainer_under_the_guard_replays_bitwise(tmp_path):
    """The port's trainer under the guard: a RuntimeError at step 3
    restores the step-2 checkpoint through the checkpointer and replays;
    the final state (parameters, moments, master copy) and the losses
    of every step are bitwise those of a run that never failed."""
    arch = tget_arch("qwen3-8b").reduced()
    shape = TShape("quickstart", "train", 64, 2)
    plan = tspecialize(arch, shape, mesh_shape=(1, 1), target="tpu-v5e")

    def trainer(sub):
        cfg = TrainerConfig(n_steps=5, ckpt_every=2, log_every=100,
                            ckpt_dir=str(tmp_path / sub))
        return Trainer(plan, None, cfg,
                       adamw.OptConfig.from_plan(plan, total_steps=10),
                       arch=arch, shape=shape, device="cpu")

    want, step, guard, calm = guarded_run(trainer("calm"))
    assert step == 5 and not guard.events
    fired = []

    def injector(step):
        if step == 3 and not fired:
            fired.append(step)
            raise RuntimeError("simulated device failure at step 3")

    hit = trainer("hit")
    got, step, guard, history = guarded_run(hit, injector)
    assert step == 5 and len(guard.events) == 1
    assert guard.events[0]["step"] == 3
    # steps 0-2, then 2-4 again after the restore of step 2
    assert [s for s, _ in history] == [0, 1, 2, 2, 3, 4]
    assert [x for _, x in history[3:]] == [x for _, x in calm[2:]]
    for a, b in zip(adamw.leaves(got), adamw.leaves(want)):
        assert torch.equal(a.detach(), b.detach())
    assert hit.ckpt.latest_step() == 4
