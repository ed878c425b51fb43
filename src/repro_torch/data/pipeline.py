"""Host data pipeline with prefetch (the template's ``prefetch.host``).

The port of ``repro/data/pipeline.py``.  A background thread keeps
``prefetch_depth`` batches ahead (the depth the communication pass
chose).  :class:`SyntheticSource` is the reference's deterministic token
stream, seeded per (seed, step, host) with the same numpy calls, so its
batches are bit-identical to the reference's and a restart reproduces
them exactly.  :func:`to_device` moves a batch to the card through
pinned host memory, with asynchronous copies, from the prefetch thread.
On a mesh every rank draws the global batch from the seed and its train
step cuts the rank's contiguous rows
(:meth:`repro_torch.dist.fsdp.MeshLayout.batch_rows`), so every mesh
trains on the data one card sees.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.frontends import input_specs


class SyntheticSource:
    """Deterministic per-(host, step) synthetic batches (numpy)."""

    def __init__(self, arch: ArchConfig, shape: ShapeConfig,
                 host_id: int = 0, n_hosts: int = 1, seed: int = 0):
        self.arch, self.shape = arch, shape
        self.host_id, self.n_hosts = host_id, n_hosts
        self.seed = seed
        if shape.global_batch % n_hosts:
            raise ValueError(f"global batch {shape.global_batch} does not "
                             f"split over {n_hosts} hosts")
        self.host_batch = shape.global_batch // n_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The host's batch of ``step``: the inputs
        :func:`repro_torch.models.frontends.input_specs` names for this
        host's rows, drawn in that order (embeddings fp32, the audio
        mask fp32, ids int32; positions the default ``0..S-1`` in each
        of M-RoPE's three streams)."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.host_id)
        shape = dataclasses.replace(self.shape, global_batch=self.host_batch)
        out: Dict[str, np.ndarray] = {}
        for name, spec in input_specs(self.arch, shape).items():
            if name == "embeds":
                out[name] = rng.standard_normal(spec.shape, dtype=np.float32)
            elif name == "positions":
                out[name] = np.broadcast_to(
                    np.arange(spec.shape[-1], dtype=np.int32),
                    spec.shape).copy()
            elif name == "mask":
                out[name] = (rng.random(spec.shape) < 0.5).astype(np.float32)
            else:                              # tokens, targets
                out[name] = rng.integers(0, self.arch.vocab_size,
                                         spec.shape, dtype=np.int32)
        return out


def to_device(device) -> Callable[[Dict[str, np.ndarray]],
                                  Dict[str, torch.Tensor]]:
    """A ``device_put`` for :class:`PrefetchPipeline`: each array as a
    tensor on ``device``; on a card, staged in pinned memory and copied
    asynchronously on the current stream (the caching host allocator
    keeps the pinned block until its copy has run)."""
    device = torch.device(device)

    def put(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        out = {}
        for k, a in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(a))
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            else:
                t = t.to(device)
            out[k] = t
        return out

    return put


class PrefetchPipeline:
    """Background-thread prefetcher; depth comes from the memory plan.
    Yields ``(step, batch)`` in step order from ``start_step``."""

    def __init__(self, source: SyntheticSource, prefetch_depth: int = 2,
                 start_step: int = 0, device_put: Optional[Callable] = None):
        self.source = source
        self.depth = max(prefetch_depth, 1)
        self._q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self._step = start_step
        self._stop = threading.Event()
        self._put = device_put or (lambda x: x)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        step = self._step
        while not self._stop.is_set():
            item = (step, self._put(self.source.batch_at(step)))
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.5)
                    step += 1
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        return self._q.get()

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
