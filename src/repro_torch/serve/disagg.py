"""Disaggregated prefill: a supervised worker fleet behind the engine.

The port of ``repro/serve/disagg.py``.  When the plan's interference
model says an inline prefill would steal too many decode ticks
(``kv_prefill_mode: disagg``), prefill moves out of the engine's
process:

* :func:`_worker_main` — the prefill worker.  Spawned, never forked (a
  CUDA context does not survive a fork), it imports ``repro_torch``
  only, rebuilds the :class:`~repro_torch.core.plan.FrozenPlan` from the
  JSON the engine holds and proves it at handshake: its first message
  home is the recomputed plan content hash, and a mismatch is a typed
  :class:`PlanHandshakeError` on the orchestrator side, before any
  weight or KV byte crosses.  Then it takes the weights (on the card by
  CUDA IPC handle, :func:`export_tensors`: no second copy of the model)
  and prefills prompts chunk by chunk through
  :func:`repro_torch.models.lm.prefill_chunked` (on the card the flash
  kernel at a query offset), sending each ``block_len`` chunk home as
  soon as it exists, with a heartbeat after it.

* :class:`PrefillFleet` — the host-side supervisor: dispatch to the
  least-loaded live worker, heartbeats into
  :class:`repro_torch.runtime.fault.HealthMonitor` (workers are
  ``expect()``-registered at spawn, so a dead-on-arrival worker is seen),
  death found by the liveness probe, by the closed pipe and by the
  heartbeat deadline, respawn under a per-slot
  :class:`~repro_torch.runtime.fault.RestartPolicy`, retirement of a slot
  whose budget is spent, and :class:`DegradedMode` once every slot has
  retired (the engine then prefills in-process again: degraded, never
  crashed).

The KV-chunk transport is a **ring the engine owns**: :data:`RING_SLOTS`
chunk-sized slots a worker, allocated by the fleet beside the engine's
pool (on the card in device memory, mapped into the worker by CUDA IPC;
on the CPU in shared memory).  The worker copies a chunk's rows into a
free slot, waits for the copy to finish, and only then sends a small
message down a pipe of its own (one per worker incarnation, written
synchronously); the engine copies the slot out and hands the slot back
(a semaphore a worker incarnation).  So a chunk announced before a
SIGKILL is still whole in the engine's memory the moment after, and the
engine reads and scatters it as any other; a chunk the kill cut short
was never announced.  Nothing of the worker's own memory is referenced
after its death.  (Host copies pickled down the pipe, the reference's
``np.asarray``, moved a 75.5 MB full-width chunk in 0.86 s.)

On a mesh the fleet lives in the mesh's first rank (its workers run the
whole model, as the reference's do, on the whole weights that rank
gathers from the ranks' pieces), and every rank sees it through a
:class:`MeshFleet`: the first rank polls and dispatches, and broadcasts
what came of it (the events with their chunk slabs and logits, each
dispatch's result, the degraded record, the fleet's telemetry), so every
rank applies the same events in the same tick.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import queue as _queue
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.runtime.fault import HealthMonitor, RestartPolicy


#: threads a worker's plain versions use on the CPU (the engine's process
#: keeps the rest)
CPU_WORKER_THREADS = 2
#: chunks a worker may have announced and the engine not yet copied out:
#: slots of its ring (at full-width qwen3-8b, 75.5 MB each)
RING_SLOTS = 4

_DTYPES = {torch.bfloat16: ("<i2", torch.int16), torch.float32: ("<f4", None),
           torch.int32: ("<i4", None), torch.float16: ("<f2", None)}


class _CudaIPC:
    """``libcuda``'s legacy IPC calls through ctypes (no PyTorch
    headers, no build)."""

    class Handle(ctypes.Structure):
        _fields_ = [("reserved", ctypes.c_ubyte * 64)]

    def __init__(self):
        lib = ctypes.CDLL("libcuda.so.1")
        ptr_p = ctypes.POINTER(ctypes.c_uint64)
        self.fns = {}
        for name, argtypes in (
                ("cuMemGetAddressRange",
                 [ptr_p, ctypes.POINTER(ctypes.c_size_t), ctypes.c_uint64]),
                ("cuIpcGetMemHandle",
                 [ctypes.POINTER(self.Handle), ctypes.c_uint64]),
                ("cuIpcOpenMemHandle", [ptr_p, self.Handle, ctypes.c_uint])):
            fn = getattr(lib, name + "_v2", None) or getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            self.fns[name] = fn

    def _call(self, name: str, *args) -> None:
        err = self.fns[name](*args)
        if err:
            raise RuntimeError(f"CUDA IPC: {name} returned CUresult {err}")

    def export(self, ptr: int) -> Tuple[int, int, bytes]:
        """``(base, size, handle)`` of the allocation holding ``ptr``."""
        base, size = ctypes.c_uint64(), ctypes.c_size_t()
        self._call("cuMemGetAddressRange", ctypes.byref(base),
                   ctypes.byref(size), ptr)
        h = self.Handle()
        self._call("cuIpcGetMemHandle", ctypes.byref(h), base)
        return base.value, size.value, bytes(h)

    def open(self, handle: bytes) -> int:
        h = self.Handle.from_buffer_copy(handle)
        ptr = ctypes.c_uint64()
        # CU_IPC_MEM_LAZY_ENABLE_PEER_ACCESS
        self._call("cuIpcOpenMemHandle", ctypes.byref(ptr), h, 1)
        return ptr.value


class _DeviceArray:
    """A view of device memory by ``__cuda_array_interface__``, which
    ``torch.as_tensor`` takes without a copy (and keeps alive)."""

    def __init__(self, ptr: int, shape, typestr: str):
        self.__cuda_array_interface__ = {
            "shape": tuple(shape), "typestr": typestr, "data": (ptr, False),
            "strides": None, "version": 3}


def export_tensors(params) -> Dict[str, Any]:
    """A tree of the engine's tensors (the weights, the chunk ring) as a
    worker takes them.  CPU tensors cross as they are
    (``torch.multiprocessing`` puts them in shared memory).  CUDA
    tensors cross as ``cuIpcGetMemHandle`` handles of the allocations that
    hold them and each leaf's offset and shape: the worker maps the
    engine's memory, no copy is made, and a worker killed mid-prefill
    leaves the engine's memory as it was (PyTorch's own CUDA tensor
    sharing keeps a tensor's memory alive in the sending process for as
    long as a consumer might hold it, for good when the consumer dies by
    a signal: 16 GB of weights that a later free would not return)."""
    leaves = []

    def walk(tree, path):
        if isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k], path + (k,))
        else:
            leaves.append((path, tree))

    walk(params, ())
    if all(t.device.type == "cpu" for _, t in leaves):
        return {"kind": "tensors", "tree": params}
    ipc = _CudaIPC()
    segments: Dict[int, Tuple[bytes, int]] = {}
    specs = []
    for path, t in leaves:
        if t.device.type != "cuda" or not t.is_contiguous() \
                or t.dtype not in _DTYPES:
            raise ValueError(f"export_tensors: {'/'.join(path)} is "
                             f"{t.dtype} on {t.device}; contiguous CUDA "
                             f"tensors of {list(_DTYPES)} cross by IPC")
        base, size, handle = ipc.export(t.data_ptr())
        segments.setdefault(base, (handle, size))
        specs.append((path, base, t.data_ptr() - base, tuple(t.shape),
                      str(t.dtype)))
    return {"kind": "cuda_ipc", "device": leaves[0][1].device.index or 0,
            "segments": segments, "specs": specs}


def import_tensors(exported: Dict[str, Any]):
    """The worker's side of :func:`export_tensors`: the tree, on the
    engine's card, mapped from its memory."""
    if exported["kind"] == "tensors":
        return exported["tree"]
    device = torch.device("cuda", exported["device"])
    torch.cuda.set_device(device)
    torch.empty(1, device=device)          # a current context to map into
    ipc = _CudaIPC()
    mapped = {base: ipc.open(handle)
              for base, (handle, _) in exported["segments"].items()}
    tree: Dict[str, Any] = {}
    by_name = {str(d): d for d in _DTYPES}
    for path, base, off, shape, dname in exported["specs"]:
        dtype = by_name[dname]
        typestr, carrier = _DTYPES[dtype]
        t = torch.as_tensor(_DeviceArray(mapped[base] + off, shape, typestr),
                            device=device)
        if carrier is not None:
            t = t.view(dtype)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return tree


class PlanHandshakeError(RuntimeError):
    """A prefill worker's recomputed FrozenPlan content hash does not
    match the engine's: the two sides would build different cache
    geometry, so no KV block may cross."""


@dataclasses.dataclass(frozen=True)
class DegradedMode:
    """Typed degraded state: the fleet is gone and prefill runs
    in-process again.  Surfaced through ``pressure_stats()`` /
    ``telemetry()`` so operators see *that* and *why* the engine
    degraded."""

    reason: str
    worker_deaths: int
    restarts: int
    at_tick: int = -1              # stamped by the engine when observed

    def to_json(self) -> Dict[str, Any]:
        return {"reason": self.reason,
                "worker_deaths": int(self.worker_deaths),
                "restarts": int(self.restarts),
                "at_tick": int(self.at_tick)}


def to_wire(t: torch.Tensor) -> Tuple[str, np.ndarray]:
    """A tensor as ``(dtype name, host array)`` that pickles by value (a
    bf16 tensor as its 16-bit words: numpy has no bf16).  A torch tensor
    on the pipe would cross by file descriptor, which needs its sender
    alive when it is read: a worker may be dead by then."""
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return "bfloat16", t.view(torch.int16).numpy()
    return str(t.dtype).replace("torch.", ""), t.numpy()


def from_wire(w: Tuple[str, np.ndarray]) -> torch.Tensor:
    """The host tensor of :func:`to_wire`'s pair."""
    name, a = w
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.view(torch.bfloat16) if name == "bfloat16" else t


def _worker_main(wid: int, ring_index: int, inq, conn, free,
                 payload: Dict[str, Any]) -> None:
    """Prefill worker entry point (spawn target).

    Protocol (worker -> orchestrator, through ``conn``, its own pipe):
      ``("hello", wid, plan_hash)``          handshake, first message
      ``("ready", wid)``                     weights taken
      ``("fatal", wid, msg)``                weights refused (no retry)
      ``("beat", wid, t)``                   heartbeat (idle and per chunk)
      ``("chunk", wid, rid, idx, slot, t, ms)`` one pool-block-shaped slab
                                             of ``t`` rows, whole in slot
                                             ``slot`` of the worker's ring
      ``("done", wid, rid, logits, counts)`` last-token logits, and the
                                             worker's kernel launches
                                             so far (``ops.launch_counts``)
      ``("error", wid, rid, msg)``           the prefill raised

    Instructions (orchestrator -> worker, through ``inq``):
      ``("params", shared)``                 first, after the hello: the
                                             weights and the ring
                                             (:func:`export_tensors`)
      ``("prefill", rid, tokens, prefix_k, prefix_v)``
      ``("stop",)``
    ``prefix_*`` are host tensors in shared memory (a resume's journaled
    rows), ``logits`` a :func:`to_wire` pair; ``ms`` the host
    milliseconds the worker spent putting the chunk in its slot.  A slot
    is taken from the semaphore ``free`` (heartbeating while none is
    free) and handed back by the orchestrator once it has copied the
    slot out.
    """
    from repro_torch.core.passes.lowering import build_run_cfg
    from repro_torch.core.plan import FrozenPlan
    from repro_torch.kernels import ops
    from repro_torch.models import lm

    plan = FrozenPlan.from_json(payload["plan_json"])
    got = plan.content_hash()
    conn.send(("hello", wid, got))
    if got != payload["plan_hash"]:
        return                      # the orchestrator raises; we leave
    try:
        msg = inq.get()
        if msg[0] == "stop":
            return
        shared = import_tensors(msg[1])
        params, ring = shared["params"], shared["ring"][ring_index]
        device = params["embed"].device
    except Exception as e:          # noqa: BLE001 — reported, not retried
        conn.send(("fatal", wid, f"{type(e).__name__}: {e}"))
        return
    if device.type == "cpu":
        torch.set_num_threads(CPU_WORKER_THREADS)
    arch = payload["arch"]
    cfg = build_run_cfg(plan, arch)
    bl, kvh = payload["block_len"], payload["kv_heads"]
    hb, delay = payload["heartbeat_s"], payload["chunk_delay_s"]
    sent = [0]                      # chunks announced: the next slot
    conn.send(("ready", wid))
    while True:
        try:
            msg = inq.get(timeout=hb)
        except _queue.Empty:
            conn.send(("beat", wid, time.time()))
            continue
        if msg[0] == "stop":
            return
        _, rid, tokens, pk, pv = msg

        def on_chunk(idx, kc, vc, _rid=rid):
            if delay:
                time.sleep(delay)   # chaos knob: widen the kill window
            while not free.acquire(timeout=hb):
                conn.send(("beat", wid, time.time()))
            t0 = time.perf_counter()
            slot, t = sent[0] % RING_SLOTS, kc.shape[1]
            ring[slot, 0, :, :t].copy_(kc)
            ring[slot, 1, :, :t].copy_(vc)
            if ring.is_cuda:        # whole before it is announced
                torch.cuda.synchronize(ring.device)
            sent[0] += 1
            conn.send(("chunk", wid, _rid, idx, slot, t,
                       (time.perf_counter() - t0) * 1e3))
            conn.send(("beat", wid, time.time()))

        try:
            with torch.no_grad():
                logits, _, _ = lm.prefill_chunked(
                    arch, params, torch.from_numpy(tokens), bl, cfg,
                    kv_heads=kvh, prefix_k=pk, prefix_v=pv,
                    on_chunk=on_chunk)
            conn.send(("done", wid, rid, to_wire(logits),
                       ops.launch_counts()))
        except Exception as e:      # noqa: BLE001 — typed event, no crash
            conn.send(("error", wid, rid, f"{type(e).__name__}: {e}"))


class _Copied:
    """A ring slot with nothing left to copy out (a copy on the CPU, or a
    cancelled request's chunk): done as soon as the slots before it."""

    @staticmethod
    def query() -> bool:
        return True


_COPIED = _Copied()


@dataclasses.dataclass
class _WorkerSlot:
    """One supervised worker position: a chain of process incarnations
    under a restart budget.  Worker ids are unique per incarnation, and
    each incarnation has its own pipe, so a late message from a killed
    predecessor can never impersonate its replacement."""

    idx: int
    policy: RestartPolicy
    proc: Any = None
    inq: Any = None
    conn: Any = None               # this incarnation's pipe home
    free: Any = None               # this incarnation's ring semaphore
    # one entry a ring slot taken, oldest first: a CUDA event after which
    # the engine's copy out is done, or _COPIED; a slot goes back only
    # once every older one has (the worker fills them in turn)
    copying: List[Any] = dataclasses.field(default_factory=list)
    wid: int = -1
    incarnation: int = 0
    ready: bool = False            # hello verified, weights sent
    closed: bool = False           # the pipe hit end-of-file
    retired: bool = False          # restart budget exhausted
    retire_reason: str = ""
    respawn_at: float = 0.0
    spawned_at: float = 0.0
    inflight: List[int] = dataclasses.field(default_factory=list)


class PrefillFleet:
    """Supervisor for N prefill worker processes (see the module
    docstring).  Transport-complete but policy-free: what to do about an
    orphaned request (the chunk journal, the resume boundary, degraded
    fallback) is the engine's call, driven by the events :meth:`poll`
    returns."""

    def __init__(self, plan, arch, params, n_workers: int = 1, *,
                 block_len: int, kv_heads: int = 0,
                 heartbeat_s: float = 2.0,
                 heartbeat_timeout_s: float = 60.0,
                 max_restarts: int = 4,
                 backoff_base_s: float = 0.25,
                 backoff_cap_s: float = 5.0,
                 chunk_delay_s: float = 0.0,
                 hello_timeout_s: float = 300.0,
                 start: bool = True,
                 _expect_hash: Optional[str] = None):
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        import torch.multiprocessing as mp
        # a CUDA context does not survive a fork: spawn re-imports
        self._ctx = mp.get_context("spawn")
        self.n_workers = n_workers
        self.expected_hash = _expect_hash or plan.content_hash()
        from repro_torch.models.lm import cache_heads
        kv_heads = kv_heads or cache_heads(arch, params["blocks"])["kv_heads"]
        device = params["embed"].device
        # the chunk ring: RING_SLOTS (k, v) slabs a worker, engine-owned
        self._ring = torch.empty(
            (n_workers, RING_SLOTS, 2, arch.n_layers, block_len, kv_heads,
             arch.hd), dtype=torch.bfloat16, device=device)
        if device.type == "cpu":
            self._ring.share_memory_()
        self._shared = export_tensors({"params": params, "ring": self._ring})
        self._params = params       # mapped by the workers: kept alive
        self._payload = {
            "plan_json": plan.to_json(),
            "plan_hash": self.expected_hash,
            "arch": arch,
            "block_len": int(block_len),
            "kv_heads": int(kv_heads),
            "heartbeat_s": float(heartbeat_s),
            "chunk_delay_s": float(chunk_delay_s),
        }
        self.monitor = HealthMonitor(timeout_s=heartbeat_timeout_s)
        self._hello_timeout_s = hello_timeout_s
        self._slots = [
            _WorkerSlot(idx=i, policy=RestartPolicy(
                max_restarts=max_restarts,
                backoff_base_s=backoff_base_s,
                backoff_cap_s=backoff_cap_s))
            for i in range(n_workers)]
        self._assign: Dict[int, _WorkerSlot] = {}      # rid -> slot
        self.dispatches = 0
        self.deaths = 0
        self.restarts = 0
        self.errors = 0
        self.chunks = 0
        self.chunk_host_ms = 0.0       # the workers' copies out, summed
        self.recv_ms = 0.0             # this side's reads of the pipes
        self.spawn_to_ready_s: List[float] = []
        # each incarnation's kernel launches, as its last "done" said
        self._worker_counts: Dict[int, Dict[str, int]] = {}
        self.degraded: Optional[DegradedMode] = None
        self._started = False
        if start:
            self.start()

    # ------------------------------------------------------------------
    def _spawn(self, slot: _WorkerSlot) -> None:
        slot.incarnation += 1
        slot.wid = slot.idx + self.n_workers * slot.incarnation
        slot.inq = self._ctx.Queue()
        # never block interpreter exit on a queue a dead worker left
        slot.inq.cancel_join_thread()
        rx, tx = self._ctx.Pipe(duplex=False)
        slot.conn, slot.ready, slot.closed = rx, False, False
        if self._ring.is_cuda:      # the last copies out of its ring done
            torch.cuda.synchronize(self._ring.device)
        slot.free, slot.copying = self._ctx.Semaphore(RING_SLOTS), []
        slot.proc = self._ctx.Process(
            target=_worker_main,
            args=(slot.wid, slot.idx, slot.inq, tx, slot.free,
                  self._payload), daemon=True)
        slot.spawned_at = time.time()
        slot.proc.start()
        tx.close()                  # the worker holds the only write end
        self.monitor.expect([slot.wid])

    def start(self) -> None:
        """Spawn every slot and block until each live worker's hello
        verifies the plan hash (mismatch: :class:`PlanHandshakeError`)
        and it has taken the weights (refused: :class:`RuntimeError`,
        loudly — CUDA IPC refused on this machine is not retried).  A
        worker that dies before that is left to the restart path."""
        if self._started:
            return
        self._started = True
        for slot in self._slots:
            self._spawn(slot)
        deadline = time.time() + self._hello_timeout_s
        try:
            while time.time() < deadline:
                if all(s.ready or s.proc is None or not s.proc.is_alive()
                       for s in self._slots):
                    return
                self._drain([])
                time.sleep(0.01)
        except BaseException:
            self.shutdown()
            raise
        self.shutdown()
        raise TimeoutError(
            f"prefill fleet: no hello and weights from every worker within "
            f"{self._hello_timeout_s} s")

    # ------------------------------------------------------------------
    def _live(self) -> List[_WorkerSlot]:
        return [s for s in self._slots
                if not s.retired and s.proc is not None and not s.closed
                and s.proc.is_alive()]

    def dispatch(self, rid: int, tokens, prefix_k=None,
                 prefix_v=None) -> bool:
        """Send one prompt (the feed past any journaled prefix; prefix
        rows ``(L, M, K, hd)`` tensors, which cross as host copies in
        shared memory) to the least-loaded live worker that has its
        weights.  ``False`` when none is (all between death
        and respawn, or retired): the caller retries next poll or
        degrades."""
        live = [s for s in self._live() if s.ready]
        if not live:
            return False
        slot = min(live, key=lambda s: (len(s.inflight), s.idx))
        slot.inq.put(("prefill", rid, np.asarray(tokens, np.int32),
                      *(None if t is None
                        else t.to("cpu", copy=True).share_memory_()
                        for t in (prefix_k, prefix_v))))
        slot.inflight.append(rid)
        self._assign[rid] = slot
        self.dispatches += 1
        return True

    def cancel(self, rid: int) -> None:
        """Forget a request (shed or aborted engine-side).  The worker
        may still burn compute on it; its late events are dropped here."""
        slot = self._assign.pop(rid, None)
        if slot is not None and rid in slot.inflight:
            slot.inflight.remove(rid)

    def kill_worker(self, idx: Optional[int] = None,
                    rid: Optional[int] = None) -> bool:
        """Chaos hook: SIGKILL a live worker — by slot index, by the
        request it is running (``rid``), or any live one."""
        slot = None
        if rid is not None:
            slot = self._assign.get(rid)
        elif idx is not None:
            slot = self._slots[idx]
        else:
            live = self._live()
            slot = live[0] if live else None
        if slot is None or slot.proc is None or not slot.proc.is_alive():
            return False
        slot.proc.kill()
        slot.proc.join(timeout=30)
        return True

    # ------------------------------------------------------------------
    def _handle(self, slot: _WorkerSlot, msg, events: List[Tuple]) -> None:
        kind, wid = msg[0], msg[1]
        if wid != slot.wid:
            return                  # not this incarnation's: drop
        self.monitor.beat(wid)
        if kind == "hello":
            got = msg[2]
            if got != self.expected_hash:
                self.shutdown()
                raise PlanHandshakeError(
                    f"worker {wid} rebuilt the plan with content hash "
                    f"{got[:12]}… but the engine expects "
                    f"{self.expected_hash[:12]}… — mismatched cache "
                    "geometry; refusing to exchange KV blocks")
            slot.inq.put(("params", self._shared))
        elif kind == "ready":
            slot.ready = True
            self.spawn_to_ready_s.append(time.time() - slot.spawned_at)
        elif kind == "fatal":
            self.shutdown()
            raise RuntimeError(
                f"prefill worker {wid} could not take the engine's weights "
                f"({msg[2]}); on the card they cross by CUDA IPC, which "
                "this machine refused — no fallback is taken")
        elif kind == "chunk":
            _, _, rid, idx, ring_slot, t, ms = msg
            self.chunk_host_ms += ms
            # the worker takes slots in turn, so they go back in turn: a
            # cancelled rid's slot waits behind the copies queued before it
            if rid not in self._assign:     # cancelled: nothing to copy
                slot.copying.append(_COPIED)
                self._give_back(slot)
                return
            rows = self._ring[slot.idx, ring_slot, :, :, :t].clone()
            if rows.is_cuda:        # the slot goes back once copied out
                done = torch.cuda.Event()
                done.record()
                slot.copying.append(done)
            else:
                slot.copying.append(_COPIED)
            self._give_back(slot)
            self.chunks += 1
            events.append(("chunk", rid, idx, rows[0], rows[1]))
        elif kind == "done":
            _, _, rid, logits, counts = msg
            self._worker_counts[wid] = counts
            if rid in self._assign:
                self.cancel(rid)
                events.append(("done", rid, from_wire(logits)))
        elif kind == "error":
            _, _, rid, err = msg
            self.errors += 1
            if rid in self._assign:
                self.cancel(rid)
                events.append(("error", rid, err))
        # "beat" needs nothing beyond the monitor feed above

    @staticmethod
    def _give_back(slot: _WorkerSlot) -> None:
        """Hand the worker the ring slots whose copies out are done,
        oldest first, stopping at the first still queued."""
        while slot.copying and slot.copying[0].query():
            slot.copying.pop(0)
            slot.free.release()

    def _drain(self, events: List[Tuple]) -> None:
        """Read every whole message waiting on the live pipes; a pipe at
        end-of-file (its worker gone, maybe mid-message) is marked
        closed."""
        for slot in self._slots:
            if slot.proc is None or slot.closed:
                continue
            self._give_back(slot)
            t0 = time.perf_counter()
            try:
                while slot.conn.poll():
                    self._handle(slot, slot.conn.recv(), events)
            except (EOFError, OSError):
                slot.closed = True
            self.recv_ms += (time.perf_counter() - t0) * 1e3

    def poll(self) -> List[Tuple]:
        """Drain worker messages and supervise the fleet.  Returns
        engine-facing events: ``("chunk", rid, idx, k, v)`` (host
        tensors ``(L, t, K, hd)``), ``("done", rid, logits)``,
        ``("error", rid, msg)``, and ``("dead", rid)`` for every request
        a worker death orphaned.  Also respawns due slots and raises the
        degraded flag when the whole fleet has retired."""
        events: List[Tuple] = []
        self._drain(events)
        now = time.time()
        hung = set(self.monitor.dead_hosts(now))
        for slot in self._slots:
            if slot.retired or slot.proc is None:
                continue
            if slot.proc.is_alive() and not slot.closed \
                    and slot.wid not in hung:
                continue
            # death: liveness probe, closed pipe or heartbeat deadline
            self.deaths += 1
            if slot.proc.is_alive():
                slot.proc.kill()    # hung-alive: put it out of its misery
            slot.proc.join(timeout=30)
            self._close(slot)
            for rid in slot.inflight:
                self._assign.pop(rid, None)
                events.append(("dead", rid))
            slot.inflight = []
            try:
                slot.respawn_at = now + slot.policy.next_delay()
            except RuntimeError as e:   # budget exhausted: retire
                slot.retired = True
                slot.retire_reason = str(e)
        for slot in self._slots:
            if slot.proc is None and not slot.retired \
                    and now >= slot.respawn_at:
                self._spawn(slot)
                self.restarts += 1
        if self.degraded is None and all(s.retired for s in self._slots):
            self.degraded = DegradedMode(
                reason=(f"all {self.n_workers} prefill worker slot(s) "
                        "exhausted their restart budget "
                        f"({self._slots[0].policy.max_restarts} each)"),
                worker_deaths=self.deaths,
                restarts=self.restarts)
        return events

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """JSON-serializable fleet snapshot (a telemetry building
        block): the reference's keys, then the chunks received, the
        workers' host milliseconds putting them in the ring and this
        side's reading the pipes and copying the slots out, each
        incarnation's seconds from spawn to weights taken, and the
        workers' kernel launches."""
        return {"workers": self.n_workers,
                "live": len(self._live()),
                "retired": sum(1 for s in self._slots if s.retired),
                "dispatches": self.dispatches,
                "deaths": self.deaths,
                "restarts": self.restarts,
                "errors": self.errors,
                "inflight": len(self._assign),
                "degraded": (self.degraded.to_json()
                             if self.degraded is not None else None),
                "chunks": self.chunks,
                "chunk_host_ms": self.chunk_host_ms,
                "recv_ms": self.recv_ms,
                "spawn_to_ready_s": list(self.spawn_to_ready_s),
                "worker_launches": self.worker_launches()}

    def worker_launches(self) -> Dict[str, int]:
        """Kernel launches the workers reported (each incarnation's
        count at its last finished prompt), summed."""
        out: Dict[str, int] = {}
        for counts in self._worker_counts.values():
            for k, n in counts.items():
                out[k] = out.get(k, 0) + n
        return out

    def _close(self, slot: _WorkerSlot) -> None:
        self.monitor.forget(slot.wid)
        for q in (slot.conn, slot.inq):
            if q is not None:
                q.close()
        slot.proc, slot.conn, slot.inq = None, None, None

    def shutdown(self) -> None:
        """Stop every worker (a graceful stop, then SIGKILL for
        stragglers) and reap it.  Idempotent."""
        for slot in self._slots:
            if slot.proc is None:
                continue
            try:
                slot.inq.put(("stop",))
            except Exception:       # noqa: BLE001 — the queue may be gone
                pass
        for slot in self._slots:
            if slot.proc is None:
                continue
            slot.proc.join(timeout=5)
            if slot.proc.is_alive():
                slot.proc.kill()
                slot.proc.join(timeout=5)
            self._close(slot)
        self._assign.clear()


# ---------------------------------------------------------------------
# the fleet on a mesh
# ---------------------------------------------------------------------

def fleet_fit_error(whole: int, held: int, device) -> str:
    """Why the mesh's first rank cannot hold the fleet's whole weights,
    ``whole`` bytes, beside its own pieces (``held`` bytes, already
    allocated), or ``""`` when they fit the free memory of ``device``
    (the card's, ``torch.cuda.mem_get_info``, or the host's available
    RAM)."""
    device = torch.device(device)
    if device.type == "cuda":
        free, where = torch.cuda.mem_get_info(device)[0], f"{device}"
    else:
        free = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
        where = "the host"
    if whole <= free:
        return ""
    return (f"disaggregated prefill on a mesh: the prefill workers map the "
            f"whole weights, {whole} bytes, which the mesh's first rank "
            f"gathers beside its own pieces ({held} bytes); {free} bytes "
            f"are free on {where}: serve this mesh's prefill inline (no "
            "workers)")


#: tag of a tensor's place in a broadcast event record
_TENSOR = "__tensor__"


class MeshFleet:
    """A :class:`PrefillFleet` as every rank of a mesh sees it.  The
    fleet lives in the mesh's first rank (``fleet`` there, ``None``
    elsewhere); every rank calls :meth:`poll`, :meth:`dispatch` and
    :meth:`kill_worker` at the same point of the same tick, the first
    rank does the work, and broadcasts what came of it
    (:meth:`repro_torch.serve.sharded.MeshPieces.bcast_object` for the
    records, :meth:`~repro_torch.serve.sharded.MeshPieces.bcast` for the
    chunk slabs and logits, on ``device``), so every rank returns the
    same.  The slabs and logits cross as the fleet gives them, host
    tensors, where the default group's backend carries host tensors
    (gloo), and through ``device`` where it does not (NCCL alone).
    :attr:`degraded` and :meth:`stats` are the first rank's, as of the
    last broadcast.  :meth:`cancel` and :meth:`shutdown` act on the first
    rank only (nothing comes back)."""

    def __init__(self, pieces, fleet: Optional[PrefillFleet], device):
        self.pieces, self.fleet = pieces, fleet
        self.device = (torch.device(device)
                       if torch.distributed.get_backend() == "nccl"
                       else torch.device("cpu"))
        self.degraded: Optional[DegradedMode] = None
        # this rank's host ms in the broadcasts: of the records (waiting
        # for the first rank's poll included) and of the tensors
        self.record_ms = self.slab_ms = 0.0
        self._stats = pieces.bcast_object(
            fleet.stats() if pieces.is_root else None)

    def _share(self, payload):
        """The first rank's ``payload`` on every rank, with the fleet's
        degraded record and telemetry refreshed."""
        root = self.pieces.is_root
        t0 = time.perf_counter()
        got = self.pieces.bcast_object(
            (payload, self.fleet.degraded, self.fleet.stats())
            if root else None)
        self.record_ms += (time.perf_counter() - t0) * 1e3
        out, self.degraded, self._stats = got
        return out

    def poll(self) -> List[Tuple]:
        """The first rank's :meth:`PrefillFleet.poll` events on every
        rank, tensors included."""
        tensors: List[torch.Tensor] = []
        meta = None
        if self.pieces.is_root:
            meta = []
            for ev in self.fleet.poll():
                rec = []
                for x in ev:
                    if isinstance(x, torch.Tensor):
                        rec.append((_TENSOR, tuple(x.shape), str(x.dtype)))
                        tensors.append(x.to(self.device).contiguous())
                    else:
                        rec.append(x)
                meta.append(tuple(rec))
        meta = self._share(meta)
        by_name = {str(d): d for d in _DTYPES}
        out, it = [], iter(tensors)
        t0 = time.perf_counter()
        for rec in meta:
            ev = []
            for x in rec:
                if isinstance(x, tuple) and x and x[0] == _TENSOR:
                    t = next(it) if self.pieces.is_root else torch.empty(
                        x[1], dtype=by_name[x[2]], device=self.device)
                    ev.append(self.pieces.bcast(t))
                else:
                    ev.append(x)
            out.append(tuple(ev))
        self.slab_ms += (time.perf_counter() - t0) * 1e3
        return out

    def dispatch(self, rid: int, tokens, prefix_k=None,
                 prefix_v=None) -> bool:
        ok = (self.fleet.dispatch(rid, tokens, prefix_k=prefix_k,
                                  prefix_v=prefix_v)
              if self.pieces.is_root else None)
        return bool(self._share(ok))

    def kill_worker(self, idx: Optional[int] = None,
                    rid: Optional[int] = None) -> bool:
        done = (self.fleet.kill_worker(idx=idx, rid=rid)
                if self.pieces.is_root else None)
        return bool(self._share(done))

    def cancel(self, rid: int) -> None:
        if self.fleet is not None:
            self.fleet.cancel(rid)

    def shutdown(self) -> None:
        if self.fleet is not None:
            self.fleet.shutdown()

    def stats(self) -> Dict[str, Any]:
        return dict(self._stats)
