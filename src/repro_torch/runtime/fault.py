"""Fault tolerance: failure detection, restart policy, elastic re-mesh.

The port of ``repro/runtime/fault.py`` (pure Python beside PyTorch; no
JAX):

* :class:`HealthMonitor`   — heartbeat table + deadline detection.
* :class:`RestartPolicy`   — exponential backoff, max-restarts budget
  (the serving engine's :class:`repro_torch.serve.engine
  .PreemptionPolicy` measures its backoff in engine ticks through it).
* :func:`elastic_mesh`     — the largest ``(data, model)``
  ``DeviceMesh`` the surviving ranks of the process group hold, the
  model axis kept (in one process without a process group, the grid of
  this process's devices).
* :class:`StepGuard`       — wraps the train step: on a device error it
  restores the last checkpoint and replays the data stream (the
  pipeline is seeded per step, so the replay is bit-exact).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class HealthMonitor:
    """Heartbeat bookkeeping (transport-agnostic: callers feed beats).

    Hosts are *registered* with :meth:`expect` before they are trusted
    to beat: a worker that dies between spawn and its first heartbeat
    never enters ``beats``, and a monitor that only scanned ``beats``
    would report it healthy forever.  ``expect`` starts the deadline
    clock at registration, so a dead-on-arrival host shows up in
    :meth:`dead_hosts` after the same ``timeout_s`` as one that beat
    once and went silent.
    """

    timeout_s: float = 60.0
    beats: Dict[int, float] = dataclasses.field(default_factory=dict)
    expected: Dict[int, float] = dataclasses.field(default_factory=dict)

    def expect(self, host_ids, t: Optional[float] = None) -> None:
        """Register hosts that *should* beat; resets their deadline clock
        (re-registering a respawned host id restarts its grace window)."""
        now = t if t is not None else time.time()
        for h in host_ids:
            self.expected[h] = now
            self.beats.pop(h, None)

    def forget(self, host_id: int) -> None:
        """Deregister a host (retired or shut down on purpose)."""
        self.expected.pop(host_id, None)
        self.beats.pop(host_id, None)

    def beat(self, host_id: int, t: Optional[float] = None) -> None:
        self.beats[host_id] = t if t is not None else time.time()

    def dead_hosts(self, now: Optional[float] = None) -> List[int]:
        now = now if now is not None else time.time()
        dead = {h for h, t in self.beats.items() if now - t > self.timeout_s}
        # dead on arrival: expected, never beat, grace window elapsed
        dead |= {h for h, t0 in self.expected.items()
                 if h not in self.beats and now - t0 > self.timeout_s}
        return sorted(dead)

    def healthy(self, now: Optional[float] = None) -> bool:
        return not self.dead_hosts(now)


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 100
    backoff_base_s: float = 5.0
    backoff_cap_s: float = 300.0
    restarts: int = 0

    def next_delay(self) -> float:
        """The next backoff, doubling from ``backoff_base_s`` up to
        ``backoff_cap_s``; raises :class:`RuntimeError` once
        ``max_restarts`` delays have been handed out."""
        if self.restarts >= self.max_restarts:
            raise RuntimeError(
                f"restart budget exhausted ({self.max_restarts})")
        d = min(self.backoff_base_s * (2 ** min(self.restarts, 10)),
                self.backoff_cap_s)
        self.restarts += 1
        return d


@dataclasses.dataclass(frozen=True)
class DeviceGrid:
    """A ``(data, model)`` grid of devices: ``devices`` an object array
    of ``torch.device`` of that shape, ``axis_names`` its axes."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def visible_devices() -> List[torch.device]:
    """The devices this process sees: every CUDA card, else the CPU."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def elastic_mesh(n_devices: int, model_parallel: int,
                 axis_names: Tuple[str, ...] = ("data", "model")):
    """Largest ``(data', model)`` mesh on the ``n_devices`` survivors.

    The model axis is kept (the memory plan's sharding of the weights
    holds only at that width); whole model groups that lost a member are
    dropped, so data parallelism absorbs the failure.  Under an
    initialized process group the survivors are its first ranks and the
    result is a :class:`torch.distributed.device_mesh.DeviceMesh` over
    the first ``data' * model`` of them (every rank calls this: a rank
    left out holds a mesh it is no member of).  Without one, it is the
    :class:`DeviceGrid` of this process's devices.  Typed errors as the
    reference's: too few survivors for one model group, and more
    survivors than there are ranks (devices) to see."""
    import torch.distributed as dist
    data = n_devices // model_parallel
    if data < 1:
        raise RuntimeError(
            f"{n_devices} devices cannot host model_parallel="
            f"{model_parallel}")
    usable = data * model_parallel
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if world < usable:
            raise RuntimeError(
                f"only {world} rank(s) visible; need {usable} "
                f"(data={data} x model_parallel={model_parallel}) — "
                f"shrink n_devices to what actually survived")
        from torch.distributed.device_mesh import DeviceMesh
        kind = "cuda" if torch.cuda.is_available() else "cpu"
        return DeviceMesh(kind, torch.arange(usable).reshape(
            data, model_parallel), mesh_dim_names=tuple(axis_names))
    devices = visible_devices()[:usable]
    if len(devices) < usable:
        raise RuntimeError(
            f"only {len(devices)} device(s) visible; need {usable} "
            f"(data={data} x model_parallel={model_parallel}) — "
            f"shrink n_devices to what actually survived")
    grid = np.empty(usable, dtype=object)
    grid[:] = devices
    return DeviceGrid(grid.reshape(data, model_parallel), tuple(axis_names))


class StepGuard:
    """Run steps; on a device failure restore and replay.

    ``make_step(mesh) -> step_fn`` builds the step for a (possibly
    smaller) grid, ``step_fn(state, batch) -> (state, metrics)``;
    ``restore(mesh) -> (state, step)`` reloads the latest checkpoint
    (:class:`repro_torch.ckpt.checkpointer.Checkpointer`) for it.

    What it catches is the reference's: a :class:`RuntimeError`, which
    covers ``torch.OutOfMemoryError`` and the CUDA errors PyTorch raises.
    An out-of-memory error leaves the CUDA context usable, so a restore
    and replay in this process is a recovery.  A *sticky* CUDA error (an
    illegal address, a kernel trap) poisons the context: every later
    CUDA call in the process fails, the restore included, whose error
    then leaves :meth:`run` — such a failure is recovered only by a new
    process, which is the job launcher's to start, not the guard's.
    """

    def __init__(self, make_step: Callable, restore: Callable,
                 policy: Optional[RestartPolicy] = None,
                 model_parallel: int = 1):
        self.make_step = make_step
        self.restore = restore
        self.policy = policy or RestartPolicy()
        self.model_parallel = model_parallel
        self.events: List[Dict] = []

    def run(self, state, batches, n_steps: int, start_step: int = 0,
            fail_injector: Optional[Callable[[int], None]] = None):
        """Drive ``n_steps``; tests inject failures via
        ``fail_injector(step)``.  Returns ``(state, step, metrics)``."""
        mesh = elastic_mesh(len(visible_devices()), self.model_parallel)
        step_fn = self.make_step(mesh)
        step = start_step
        metrics = None
        while step < n_steps:
            try:
                if fail_injector is not None:
                    fail_injector(step)
                batch = batches(step)
                state, metrics = step_fn(state, batch)
                step += 1
            except RuntimeError as e:
                delay = self.policy.next_delay()
                self.events.append({"step": step, "error": str(e)[:200],
                                    "backoff_s": delay})
                # (in production: sleep(delay); wait for a healthy quorum)
                mesh = elastic_mesh(len(visible_devices()),
                                    self.model_parallel)
                step_fn = self.make_step(mesh)
                state, step = self.restore(mesh)
        return state, step, metrics
