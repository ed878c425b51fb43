"""Fault-tolerant checkpointing: async, atomic, in the reference's format.

The port of ``repro/ckpt/checkpointer.py``, bit for bit on disk, so a
checkpoint written by either package restores in the other:

    <dir>/step_00000123.tmp/   — in-flight writes
        shard_<host>.npz       — this host's leaves, flat "a/b/c" keys
        manifest.json          — keys with shapes and dtypes, meta, time
    <dir>/step_00000123/       — atomically renamed when complete
    <dir>/LATEST               — the newest complete step

npz cannot hold bf16: a bf16 leaf is written as its raw 16-bit words
(``uint16``) and the manifest names it ``"bfloat16"``; restore
reinterprets the words.  No bf16 numpy dtype is needed on either side.

Guarantees: a crash mid-write never corrupts the latest checkpoint (tmp
+ rename); a save snapshots the state to host memory synchronously
(training may then overwrite it in place) and writes on a background
thread, the next save joining the previous one; :meth:`restore` puts
every leaf on the device it is asked for, or hands each to a caller
that keeps a piece of it.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any]) -> Any:
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _to_host(t) -> np.ndarray:
    """A leaf as a numpy array; bf16 as its raw words (``uint16``)."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_host(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    a = np.array(a, order="C")          # a writable copy torch may own
    if dtype == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


class Checkpointer:
    def __init__(self, directory: str | Path, host_id: int = 0,
                 n_hosts: int = 1, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.host_id, self.n_hosts = host_id, n_hosts
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def save(self, step: int, state: Any, meta: Optional[Dict] = None,
             blocking: bool = False) -> None:
        """Async save: the state is copied to host memory now, written on
        a background thread."""
        host, bf16 = {}, set()
        for k, v in _flatten(state).items():
            if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:
                bf16.add(k)
            host[k] = _to_host(v)
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(step, host, bf16, meta or {}),
            daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        """Join the writer; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step, host, bf16, meta) -> None:
        try:
            self._write_step(step, host, bf16, meta)
        except BaseException as e:        # surfaced by wait()
            self._error = e

    def _write_step(self, step: int, host: Dict[str, np.ndarray],
                    bf16, meta: Dict) -> None:
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        tmp.mkdir(parents=True, exist_ok=True)
        np.savez(tmp / f"shard_{self.host_id}.npz", **host)
        manifest = {
            "step": step,
            "n_hosts": self.n_hosts,
            "keys": {k: {"shape": list(v.shape),
                         "dtype": "bfloat16" if k in bf16 else str(v.dtype)}
                     for k, v in host.items()},
            "meta": meta,
            "time": time.time(),
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        # barrier point in multi-host: host 0 renames once all shards exist
        if self.host_id == 0:
            deadline = time.time() + 300
            while len(list(tmp.glob("shard_*.npz"))) < self.n_hosts:
                if time.time() > deadline:
                    raise TimeoutError("checkpoint shards missing")
                time.sleep(0.05)
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)
            (self.dir / "LATEST").write_text(str(step))
            self._gc()

    def _gc(self) -> None:
        steps = sorted(int(p.name.split("_")[1]) for p in self.dir.glob(
            "step_*") if not p.name.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ------------------------------------------------------------------
    def manifest(self, step: int) -> Dict[str, Any]:
        """The manifest of one complete checkpoint (empty dict if absent)."""
        f = self.dir / f"step_{step:08d}" / "manifest.json"
        try:
            return json.loads(f.read_text())
        except (OSError, ValueError):
            return {}

    def plan_hash(self, step: Optional[int] = None) -> str:
        """The plan content hash stamped on a checkpoint ("" if unstamped):
        a restart resolves it against the plan store (``<ckpt_dir>/plans``)
        and skips the specialization flow."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return ""
        return str(self.manifest(step).get("meta", {}).get("plan_hash", ""))

    def latest_step(self) -> Optional[int]:
        f = self.dir / "LATEST"
        if not f.exists():
            return None
        step = int(f.read_text().strip())
        if not (self.dir / f"step_{step:08d}" / "manifest.json").exists():
            return None
        return step

    def restore(self, step: Optional[int] = None, device="cpu",
                take: Optional[Callable] = None):
        """``(state, manifest)`` of a checkpoint (the latest by default),
        every leaf a tensor on ``device``.  ``take(key, leaf)``, where
        given, is applied to each leaf as it is read (``key`` its flat
        ``a/b/c`` name) and its result is kept in its place (``None``
        drops the leaf), so one whole leaf at a time is held."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        keys = manifest["keys"]
        flat: Dict[str, Any] = {}
        with np.load(d / f"shard_{self.host_id}.npz") as z:
            for k in z.files:
                t = _from_host(z[k], keys.get(k, {}).get("dtype", ""),
                               device)
                if take is not None:
                    t = take(k, t)
                if t is not None:
                    flat[k] = t
        return _unflatten(flat), manifest

    def validate(self, step: int) -> bool:
        d = self.dir / f"step_{step:08d}"
        try:
            manifest = json.loads((d / "manifest.json").read_text())
            with np.load(d / f"shard_{self.host_id}.npz") as z:
                return set(z.files) == set(manifest["keys"])
        except Exception:
            return False
