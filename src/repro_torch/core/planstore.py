"""PlanStore — two-tier cache of frozen plan artifacts.

Tier 1 is an in-memory dict of :class:`~repro_torch.core.plan.FrozenPlan`
views keyed by the *request* hash (arch × shape × mesh × target ×
passes × options).  Hits return the cached object itself — the artifact
is immutable, so no deepcopy is needed and a warm ``specialize()`` is
O(1).

Tier 2 is a content-addressed on-disk store::

    <plan_dir>/
        <content_hash>.json     # {"schema": N, "content_hash": h, "plan": {...}}
        by_key/<request_hash>   # text file holding the content hash

``plan_dir`` defaults to ``$REPRO_PLAN_DIR`` or ``~/.cache/repro_torch/plans``
and can be overridden per call (e.g. a directory next to checkpoints so
the plan ships with the model).  Entries are written atomically
(tmp + ``os.replace``); reads tolerate truncated/corrupt/stale files by
treating them as misses (the flow simply recompiles).  The payload's
hash is re-verified on load, so a plan reloaded in a second process is
guaranteed bit-identical to what the first process compiled.

The content-addressed tier is size-capped: entries accumulate across
schema bumps and flow-fingerprint changes (every one is a fresh content
hash), so each write triggers a lazy :meth:`PlanStore.gc` once the
entry count passes ``max_disk_entries`` (``$REPRO_PLAN_MAX_ENTRIES``,
default 256).  GC drops stale-schema entries first, then the
least-recently-used current ones (disk hits touch mtime); ``by_key``
refs go with their entry, dangling refs are dropped, refs to live
entries are LRU-capped at 4x the entry cap (fingerprint churn mints
new request hashes for identical content), and
``stats()["disk_size"]`` reflects the evictions.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import tempfile
from pathlib import Path
from typing import Any, Dict, Optional

from repro_torch.core.plan import (FrozenPlan, MemoryPlan, PLAN_SCHEMA_VERSION,
                             canonical_json)


def default_plan_dir() -> Path:
    env = os.environ.get("REPRO_PLAN_DIR", "")
    if env:
        return Path(env).expanduser()
    return Path.home() / ".cache" / "repro_torch" / "plans"


class PlanStore:
    def __init__(self, plan_dir: Optional[str | Path] = None,
                 persist: bool = True,
                 max_disk_entries: Optional[int] = None):
        self.plan_dir = Path(plan_dir) if plan_dir else default_plan_dir()
        self.persist = persist
        if max_disk_entries is None:
            env = os.environ.get("REPRO_PLAN_MAX_ENTRIES", "")
            max_disk_entries = int(env) if env else 256
        self.max_disk_entries = max_disk_entries or None   # 0 -> uncapped
        self._mem: Dict[str, FrozenPlan] = {}
        self._stats = {"hits": 0, "disk_hits": 0, "misses": 0,
                       "corrupt": 0, "evictions": 0, "gc_evictions": 0,
                       "puts": 0}

    # -- tier-1 + tier-2 lookup ---------------------------------------
    def get(self, key_hash: str) -> Optional[FrozenPlan]:
        """Frozen view for a request key, or None (caller compiles)."""
        plan = self._mem.get(key_hash)
        if plan is not None:
            self._stats["hits"] += 1
            return plan
        plan = self._load_by_key(key_hash)
        if plan is not None:
            self._stats["disk_hits"] += 1
            self._mem[key_hash] = plan
            return plan
        self._stats["misses"] += 1
        return None

    def put(self, key_hash: str, plan: FrozenPlan) -> str:
        """Insert a freshly-compiled plan; returns its content hash."""
        if not isinstance(plan, FrozenPlan):
            plan = plan.freeze()
        self._mem[key_hash] = plan
        self._stats["puts"] += 1
        h = plan.content_hash()
        if self.persist:
            try:
                self._write_entry(plan, h)
                self._write_text(self.plan_dir / "by_key" / key_hash, h)
                self._maybe_gc()
            except OSError:
                pass                    # cache dir unwritable -> memory-only
        return h

    # -- content-addressed access (checkpoint warm starts) ------------
    def save(self, plan: FrozenPlan) -> str:
        """Persist by content hash only (no request key)."""
        if not isinstance(plan, FrozenPlan):
            plan = plan.freeze()
        h = plan.content_hash()
        if self.persist:
            try:
                self._write_entry(plan, h)
                self._maybe_gc()
            except OSError:
                pass
        return h

    def load(self, content_hash: str) -> Optional[FrozenPlan]:
        """Reload a persisted plan by its content hash (verified)."""
        return self._read_entry(self.plan_dir / f"{content_hash}.json",
                                expect_hash=content_hash)

    # -- maintenance ---------------------------------------------------
    def stats(self) -> Dict[str, int]:
        disk = disk_bytes = 0
        if self.plan_dir.is_dir():
            for f in self.plan_dir.glob("*.json"):
                disk += 1
                try:
                    disk_bytes += f.stat().st_size
                except OSError:
                    pass
        return {**self._stats, "size": len(self._mem), "disk_size": disk,
                "disk_bytes": disk_bytes}

    def gc(self, max_entries: Optional[int] = None) -> int:
        """Shrink the content-addressed tier; returns entries removed.

        Stale-schema entries (accumulated across schema bumps) go first;
        then the oldest-mtime current entries beyond ``max_entries``
        (defaults to the store's cap).  An evicted entry takes its
        ``by_key`` refs with it, so the next request is a clean miss
        that recompiles and re-persists.
        """
        if not self.plan_dir.is_dir():
            return 0
        cap = self.max_disk_entries if max_entries is None else max_entries
        removed, live = 0, []
        dropped: set = set()
        for f in self.plan_dir.glob("*.json"):
            if self._entry_schema(f) != PLAN_SCHEMA_VERSION:
                removed += self._unlink(f)
                dropped.add(f.stem)
            else:
                live.append(f)

        def mtime(f):
            try:
                return f.stat().st_mtime
            except OSError:
                return 0.0

        if cap and len(live) > cap:
            live.sort(key=lambda f: (mtime(f), f.name))
            for f in live[:len(live) - cap]:
                removed += self._unlink(f)
                dropped.add(f.stem)
        # by_key hygiene, one pass: refs of just-dropped or missing
        # entries go, then the survivors are LRU-trimmed to 4x the entry
        # cap (reads touch mtime) — refs are tiny but unbounded, since
        # every flow-fingerprint change mints a fresh request hash that
        # can point at a still-live content entry.
        by_key = self.plan_dir / "by_key"
        if by_key.is_dir():
            refs = []
            for ref in by_key.iterdir():
                try:
                    h = ref.read_text().strip()
                except OSError:
                    continue
                if (not h or h in dropped
                        or not (self.plan_dir / f"{h}.json").exists()):
                    self._unlink(ref)
                else:
                    refs.append(ref)
            if cap and len(refs) > 4 * cap:
                refs.sort(key=lambda f: (mtime(f), f.name))
                for ref in refs[:len(refs) - 4 * cap]:
                    self._unlink(ref)
        self._stats["gc_evictions"] += removed
        return removed

    @staticmethod
    def _entry_schema(f: Path) -> Optional[int]:
        """The entry's schema stamp, from the file's head only.

        Entries are written with ``schema`` as the first field, so a
        64-byte read answers the (hot: every over-cap put) GC question
        without parsing multi-KB plan payloads; foreign layouts fall
        back to a full parse.
        """
        try:
            with f.open() as fh:
                head = fh.read(64)
        except OSError:
            return None
        m = re.search(r'"schema":\s*(-?\d+)', head)
        if m:
            return int(m.group(1))
        try:
            entry = json.loads(f.read_text())
        except (OSError, ValueError):
            return None
        # non-dict payloads (stray arrays/strings) are corrupt -> stale
        return entry.get("schema") if isinstance(entry, dict) else None

    def _maybe_gc(self) -> None:
        if not self.max_disk_entries or not self.plan_dir.is_dir():
            return
        n = sum(1 for _ in self.plan_dir.glob("*.json"))
        if n > self.max_disk_entries:
            self.gc()
            return
        # ref churn without entry churn (fingerprint changes remapping to
        # identical content) must also trigger the trim
        by_key = self.plan_dir / "by_key"
        if by_key.is_dir():
            nrefs = sum(1 for _ in by_key.iterdir())
            if nrefs > 4 * self.max_disk_entries:
                self.gc()

    @staticmethod
    def _unlink(path: Path) -> int:
        try:
            path.unlink(missing_ok=True)
            return 1
        except OSError:
            return 0

    def clear(self, disk: bool = False) -> None:
        """Drop the memory tier (and optionally the on-disk entries)."""
        self._mem.clear()
        self._stats.update(hits=0, disk_hits=0, misses=0, corrupt=0,
                           evictions=0, gc_evictions=0, puts=0)
        if disk and self.plan_dir.is_dir():
            for f in self.plan_dir.glob("*.json"):
                f.unlink(missing_ok=True)
            by_key = self.plan_dir / "by_key"
            if by_key.is_dir():
                for f in by_key.iterdir():
                    f.unlink(missing_ok=True)

    def evict(self, key_hash: str) -> bool:
        """Remove one request key from both tiers.

        The content file is deleted only when no *other* request key
        still references it — content-addressed entries can be shared
        (identical plans reached via different specialize args, or
        pinned by a checkpoint's ``plan_hash``).
        """
        found = self._mem.pop(key_hash, None) is not None
        ref = self.plan_dir / "by_key" / key_hash
        if ref.exists():
            try:
                h = ref.read_text().strip()
                ref.unlink(missing_ok=True)
                by_key = self.plan_dir / "by_key"
                still_referenced = any(
                    f.read_text().strip() == h for f in by_key.iterdir())
                if h and not still_referenced:
                    (self.plan_dir / f"{h}.json").unlink(missing_ok=True)
                found = True
            except OSError:
                pass
        if found:
            self._stats["evictions"] += 1
        return found

    # -- disk plumbing -------------------------------------------------
    def _write_entry(self, plan: FrozenPlan, content_hash: str) -> None:
        # always (re)write: the atomic replace makes this self-healing —
        # a corrupt entry under this hash is repaired by the recompile
        # that its own read-failure triggered
        entry = {"schema": PLAN_SCHEMA_VERSION, "content_hash": content_hash,
                 "plan": plan.to_dict()}
        self._write_text(self.plan_dir / f"{content_hash}.json",
                         json.dumps(entry, indent=1, default=str))

    def _write_text(self, path: Path, text: str) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(text)
            os.replace(tmp, path)       # atomic: readers never see partials
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def _load_by_key(self, key_hash: str) -> Optional[FrozenPlan]:
        ref = self.plan_dir / "by_key" / key_hash
        try:
            h = ref.read_text().strip()
        except OSError:
            return None
        if not h:
            self._stats["corrupt"] += 1
            return None
        plan = self._read_entry(self.plan_dir / f"{h}.json", expect_hash=h)
        if plan is not None:
            try:
                os.utime(ref)           # LRU touch for the by_key trim
            except OSError:
                pass
        return plan

    def _check_entry(self, path: Path, expect_hash: Optional[str] = None):
        """``(status, entry, hash)`` for one on-disk entry — THE entry
        verification recipe (``_read_entry`` loads through it and the
        ``plan verify`` CLI reports through it, so the two can never
        diverge).  ``status``: ``"ok"`` | ``"stale-schema"`` |
        ``"corrupt"`` | ``"missing"`` (unreadable file).  The hash is
        computed over the parsed payload directly: the stored dict IS
        the canonical ``to_dict()`` form (freeze/from_dict are
        lossless), so this equals ``FrozenPlan.content_hash()`` at half
        the cost."""
        try:
            entry = json.loads(path.read_text())
        except OSError:
            return "missing", None, None
        except ValueError:
            return "corrupt", None, None
        if not isinstance(entry, dict) or "plan" not in entry:
            return "corrupt", entry, None
        if entry.get("schema") != PLAN_SCHEMA_VERSION:
            return "stale-schema", entry, None
        try:
            h = hashlib.sha256(
                canonical_json(entry["plan"]).encode()).hexdigest()
        except Exception:
            return "corrupt", entry, None
        if entry.get("content_hash") != h or \
                (expect_hash is not None and h != expect_hash):
            return "corrupt", entry, h
        return "ok", entry, h

    def verify_entry(self, path: Path) -> str:
        """One entry's health for inspection tools: ``"ok"`` |
        ``"stale-schema"`` | ``"corrupt"`` (an entry whose filename
        does not match its content hash, or an unreadable file, is
        corrupt — it can never be loaded under its own name)."""
        status, _, h = self._check_entry(path)
        if status == "missing" or (status == "ok" and h != path.stem):
            return "corrupt"
        return status

    def _read_entry(self, path: Path,
                    expect_hash: Optional[str] = None) -> Optional[FrozenPlan]:
        """Parse + verify one on-disk entry; any defect -> miss."""
        status, entry, h = self._check_entry(path, expect_hash)
        if status == "missing":
            return None
        if status != "ok":
            self._stats["corrupt"] += 1
            return None
        try:
            plan = MemoryPlan.from_dict(entry["plan"]).freeze()
            object.__setattr__(plan, "_content_hash", h)
            try:
                os.utime(path)          # LRU touch: gc evicts oldest-mtime
            except OSError:
                pass
            return plan
        except Exception:
            # payload fields the current plan schema cannot rebuild —
            # tolerate and recompile rather than crash the caller
            self._stats["corrupt"] += 1
            return None


# ---------------------------------------------------------------------
# per-directory store registry (the default store follows REPRO_PLAN_DIR,
# so tests can point specialize() at a tmpdir via the environment)
# ---------------------------------------------------------------------

_STORES: Dict[Path, PlanStore] = {}


def get_store(plan_dir: Optional[str | Path] = None) -> PlanStore:
    path = Path(plan_dir) if plan_dir else default_plan_dir()
    store = _STORES.get(path)
    if store is None:
        store = _STORES[path] = PlanStore(path)
    return store


def all_stores() -> tuple:
    """Every store this process has created (default + plan_dir= ones)."""
    return tuple(_STORES.values())


def request_key(*parts: Any) -> str:
    """Deterministic request hash from reprs of the specialize() args."""
    blob = canonical_json({"schema": PLAN_SCHEMA_VERSION,
                           "parts": [repr(p) for p in parts]})
    return hashlib.sha256(blob.encode()).hexdigest()
