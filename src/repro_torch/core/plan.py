"""MemoryPlan — the specialized template instance the flow produces.

Paper §4: each phase progressively refines the template; the *result* of
the whole flow is a fully-parameterized memory architecture plus a
rewritten IR.  Two classes split the lifecycle:

* :class:`MemoryPlan` — the build-time **builder** the passes mutate
  (``record()``, ``placement()``, dict/list containers);
* :class:`FrozenPlan` — the immutable **artifact** ``specialize()``
  returns and every consumer (lowering, trainer, serve engine,
  checkpointer) reads.  Frozen dataclasses, tuple-ified containers,
  ``MappingProxyType`` dicts; hashable via a stable
  :meth:`FrozenPlan.content_hash` over the canonical JSON.

Both hold:

* per-tensor :class:`Placement` (residency + mesh sharding + layout),
* a :class:`CommPlan` (collective schedule, prefetch, compression),
* per-kernel :class:`BlockPlan` (Pallas BlockSpec tiles = PLM banks),
* the refined :class:`~repro_torch.core.template.MemoryTemplate` summary,
* a decision log (pass → decision → reason) for ablation/inspection.

The frozen plan is JSON-serializable: it is the artifact a deployment
ships next to the model config (persisted content-addressed by
:mod:`repro_torch.core.planstore`), and the lowering pass consumes *only* the
plan (the model code never sees the passes — the paper's "accelerator is
mostly unaware of the data organization").
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from types import MappingProxyType
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.ir import MemorySpace


AxisAssign = Tuple[Optional[Any], ...]  # per-dim: mesh axis name, tuple, or None

#: bumped whenever the serialized plan layout changes incompatibly; the
#: plan store refuses (and recompiles past) entries from another schema.
PLAN_SCHEMA_VERSION = 1


# =====================================================================
# canonicalization helpers (shared by to_json / content_hash / freeze)
# =====================================================================

def _plain(obj: Any) -> Any:
    """Recursively convert to plain JSON-able types (dict/list/scalars)."""
    if isinstance(obj, (MappingProxyType, dict)):
        return {str(k): _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    return obj


def _deep_freeze(obj: Any) -> Any:
    """dicts -> MappingProxyType, lists -> tuples, recursively."""
    if isinstance(obj, (MappingProxyType, dict)):
        return MappingProxyType({k: _deep_freeze(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return tuple(_deep_freeze(v) for v in obj)
    return obj


def _deep_thaw(obj: Any) -> Any:
    """Inverse of :func:`_deep_freeze` (tuples stay tuples only where the
    mutable schema expects them; containers become dict/list)."""
    if isinstance(obj, (MappingProxyType, dict)):
        return {k: _deep_thaw(v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return [_deep_thaw(v) for v in obj]
    return obj


def canonical_json(d: Dict[str, Any]) -> str:
    """Deterministic encoding: sorted keys, compact separators."""
    return json.dumps(_plain(d), sort_keys=True, separators=(",", ":"),
                      default=str)


def _sharding_spec(axis_rules: Mapping[str, Any],
                   logical_axes: Sequence[Optional[str]]) -> AxisAssign:
    out = []
    used: set = set()
    for ax in logical_axes:
        assign = axis_rules.get(ax) if ax is not None else None
        if assign is None:
            out.append(None)
            continue
        names = (assign,) if isinstance(assign, str) else tuple(assign)
        names = tuple(n for n in names if n not in used)
        used.update(names)
        if not names:
            out.append(None)
        elif len(names) == 1:
            out.append(names[0])
        else:
            out.append(names)
    return tuple(out)


def _padded_sizes(estimates: Mapping[str, Any]) -> Tuple[int, int, int, int]:
    return (int(estimates.get("vocab_padded", 0)),
            int(estimates.get("heads_padded", 0)),
            int(estimates.get("ssm_heads_padded", 0)),
            int(estimates.get("kv_heads_padded", 0)))


def diff_decision_logs(old: Sequence[Tuple[str, str, str, str]],
                       new: Sequence[Tuple[str, str, str, str]]) -> List[str]:
    """Human-readable diff of two decision logs, keyed by (pass, subject).

    Used when a restarted job recompiles and the fresh plan's hash does
    not match the one stored with the checkpoint: the diff says *which
    decisions moved*, not just that something did.
    """
    def index(log):
        d: Dict[Tuple[str, str], List[Tuple[str, str]]] = {}
        for p, subj, dec, why in log:
            d.setdefault((p, subj), []).append((dec, why))
        return d

    a, b = index(old), index(new)
    lines: List[str] = []
    for key in sorted(set(a) | set(b)):
        pa, pb = a.get(key), b.get(key)
        if pa == pb:
            continue
        p, subj = key
        if pa is None:
            lines.append(f"+ {p}/{subj}: {pb[-1][0]}")
        elif pb is None:
            lines.append(f"- {p}/{subj}: {pa[-1][0]}")
        else:
            lines.append(f"~ {p}/{subj}: {pa[-1][0]} -> {pb[-1][0]}")
    return lines


# =====================================================================
# mutable build-time pieces (what the passes refine)
# =====================================================================

@dataclasses.dataclass
class Placement:
    """Where one logical tensor lives (data-organization + layout output)."""

    residency: str = MemorySpace.HBM.value
    # one entry per tensor dim: None | "data" | "model" | ("pod","data") ...
    spec: AxisAssign = ()
    dtype: Optional[str] = None          # layout pass may override (bf16/f32)
    pad_to: Optional[Tuple[int, ...]] = None  # MXU-alignment padding
    layout: Dict[str, Any] = dataclasses.field(default_factory=dict)
    decided_by: List[str] = dataclasses.field(default_factory=list)

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class CommPlan:
    """Communication-phase output (prefetcher + channel configuration)."""

    grad_schedule: str = "reduce_scatter"     # or "all_reduce"
    compress_pod_grads: bool = False          # int8+error-feedback on DCN axis
    compress_grads: bool = False              # int8+EF on the full DP reduction
    compress_lowered: bool = False            # codes (not f32) cross the wire
    compress_bits: int = 8
    combine_topology: str = "flat"            # decode softmax combine: flat|ring|bidir
    microbatches: int = 1                     # grad-accum for comm overlap
    prefetch_depth: int = 2                   # host input pipeline depth
    overlap_collectives: bool = True          # async collective scheduling
    remat_policy: str = "none"                # none|dots|full
    donate_state: bool = True                 # buffer sharing (disjoint lifetimes)
    notes: List[str] = dataclasses.field(default_factory=list)

    @property
    def compresses_gradients(self) -> bool:
        """Any EF-compressed gradient path on (lowering adds an EF state)."""
        return self.compress_pod_grads or self.compress_grads


@dataclasses.dataclass
class BlockPlan:
    """Local-partitioning output for one kernel (multi-bank PLM config)."""

    kernel: str                                # "flash_attention" | ...
    blocks: Dict[str, int] = dataclasses.field(default_factory=dict)
    n_buffers: int = 2                         # banking degree
    vmem_bytes: int = 0                        # modeled working set
    grid_note: str = ""


# =====================================================================
# frozen artifact pieces (what consumers read)
# =====================================================================

@dataclasses.dataclass(frozen=True)
class FrozenPlacement:
    residency: str
    spec: AxisAssign
    dtype: Optional[str]
    pad_to: Optional[Tuple[int, ...]]
    layout: Mapping[str, Any]
    decided_by: Tuple[str, ...]

    __hash__ = None  # type: ignore[assignment]  # hash the plan, not pieces

    def to_json(self) -> Dict[str, Any]:
        return _plain(self)


@dataclasses.dataclass(frozen=True)
class FrozenCommPlan:
    grad_schedule: str
    compress_pod_grads: bool
    compress_grads: bool
    compress_lowered: bool
    compress_bits: int
    combine_topology: str
    microbatches: int
    prefetch_depth: int
    overlap_collectives: bool
    remat_policy: str
    donate_state: bool
    notes: Tuple[str, ...]

    __hash__ = None  # type: ignore[assignment]

    @property
    def compresses_gradients(self) -> bool:
        return self.compress_pod_grads or self.compress_grads


@dataclasses.dataclass(frozen=True)
class FrozenBlockPlan:
    kernel: str
    blocks: Mapping[str, int]
    n_buffers: int
    vmem_bytes: int
    grid_note: str

    __hash__ = None  # type: ignore[assignment]


@dataclasses.dataclass(frozen=True)
class FrozenPlan:
    """The immutable, hashable, shippable plan artifact.

    Returned by ``specialize()`` and shared structurally between all
    consumers — cache hits hand out *the same object* (no deepcopy), so
    mutation raises instead of silently poisoning the cache.
    """

    arch: str
    shape: str
    mesh_axes: Tuple[str, ...]
    mesh_shape: Tuple[int, ...]
    target: str
    shape_kind: str
    seq_len: int
    global_batch: int
    axis_rules: Mapping[str, Any]
    placements: Mapping[str, FrozenPlacement]
    comm: FrozenCommPlan
    partitions: Mapping[str, FrozenBlockPlan]
    template_summary: Mapping[str, Any]
    use_pallas: str
    estimates: Mapping[str, Any]
    opt: Mapping[str, Any]
    log: Tuple[Tuple[str, str, str, str], ...]

    # ------------------------------------------------------------------
    def sharding_spec(self, logical_axes: Sequence[Optional[str]]) -> AxisAssign:
        """Resolve logical axes through the plan's axis rules."""
        return _sharding_spec(self.axis_rules, logical_axes)

    def padded_sizes(self) -> Tuple[int, int, int, int]:
        """(vocab, heads, ssm_heads, kv_heads) the layout pass padded to
        (0 = unpadded) — the sizes ``init_params``/``init_cache`` need to
        materialize state matching this plan."""
        return _padded_sizes(self.estimates)

    # ------------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return _plain(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str)

    def content_hash(self) -> str:
        """sha256 over the canonical JSON — stable across processes,
        across ``to_json``/``from_json`` round-trips, and independent of
        dict insertion order."""
        cached = self.__dict__.get("_content_hash")
        if cached is None:
            cached = hashlib.sha256(
                canonical_json(self.to_dict()).encode()).hexdigest()
            object.__setattr__(self, "_content_hash", cached)
        return cached

    def __hash__(self) -> int:
        return hash(self.content_hash())

    def thaw(self) -> "MemoryPlan":
        """A fresh mutable builder with this plan's contents (the escape
        hatch for callers that genuinely need to edit a plan)."""
        return MemoryPlan.from_dict(self.to_dict())

    @classmethod
    def from_json(cls, s: str) -> "FrozenPlan":
        return MemoryPlan.from_json(s).freeze()


# =====================================================================
# the builder
# =====================================================================

@dataclasses.dataclass
class MemoryPlan:
    """Build-time mutable plan the pass pipeline refines; ``freeze()``
    yields the :class:`FrozenPlan` artifact consumers receive."""

    arch: str
    shape: str
    mesh_axes: Tuple[str, ...]
    mesh_shape: Tuple[int, ...]
    target: str = "tpu-v5e"

    # the workload dims the plan was specialized for — carried in the
    # artifact so consumers (serve engine KV sizing, batching limits)
    # never need the shape registry at deploy time
    shape_kind: str = ""
    seq_len: int = 0
    global_batch: int = 0

    # logical-axis -> mesh-axis rules (data organization output)
    axis_rules: Dict[str, Any] = dataclasses.field(default_factory=dict)
    placements: Dict[str, Placement] = dataclasses.field(default_factory=dict)
    comm: CommPlan = dataclasses.field(default_factory=CommPlan)
    partitions: Dict[str, BlockPlan] = dataclasses.field(default_factory=dict)
    template_summary: Dict[str, Any] = dataclasses.field(default_factory=dict)
    use_pallas: str = "auto"                   # auto|on|off
    estimates: Dict[str, float] = dataclasses.field(default_factory=dict)
    # optimizer-state "technology" decisions (data-organization ladder)
    opt: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"moment_dtype": "float32", "master_weights": True})

    # decision log: (pass, subject, decision, reason)
    log: List[Tuple[str, str, str, str]] = dataclasses.field(default_factory=list)

    # ------------------------------------------------------------------
    def record(self, pass_name: str, subject: str, decision: str, reason: str) -> None:
        self.log.append((pass_name, subject, decision, reason))

    def placement(self, name: str) -> Placement:
        if name not in self.placements:
            self.placements[name] = Placement()
        return self.placements[name]

    def sharding_spec(self, logical_axes: Sequence[Optional[str]]) -> AxisAssign:
        """Resolve logical axes through the plan's axis rules."""
        return _sharding_spec(self.axis_rules, logical_axes)

    def padded_sizes(self) -> Tuple[int, int, int, int]:
        """See :meth:`FrozenPlan.padded_sizes`."""
        return _padded_sizes(self.estimates)

    # ------------------------------------------------------------------
    def freeze(self) -> FrozenPlan:
        """The immutable artifact view (tuples + MappingProxyType).

        Field lists are derived from the builder dataclasses, so a field
        added to Placement/CommPlan/BlockPlan/MemoryPlan fails loudly
        here (its frozen counterpart lacks it) instead of silently
        vanishing from the artifact and its content hash.
        """
        def freeze_as(frozen_cls, obj):
            return frozen_cls(**{
                f.name: _deep_freeze(getattr(obj, f.name))
                for f in dataclasses.fields(obj)})

        kw = {f.name: _deep_freeze(getattr(self, f.name))
              for f in dataclasses.fields(self)}
        kw["placements"] = MappingProxyType({
            k: freeze_as(FrozenPlacement, p)
            for k, p in self.placements.items()})
        kw["comm"] = freeze_as(FrozenCommPlan, self.comm)
        kw["partitions"] = MappingProxyType({
            k: freeze_as(FrozenBlockPlan, b)
            for k, b in self.partitions.items()})
        kw["mesh_shape"] = tuple(int(x) for x in self.mesh_shape)
        kw["seq_len"] = int(self.seq_len)
        kw["global_batch"] = int(self.global_batch)
        return FrozenPlan(**kw)

    # ------------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return _plain(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str)

    def content_hash(self) -> str:
        """Same hash the frozen artifact reports (freeze is canonicalizing)."""
        return self.freeze().content_hash()

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MemoryPlan":
        d = dict(_deep_thaw(d))
        d["placements"] = {
            k: Placement(**{**v,
                            "spec": _untuple(v["spec"]),
                            "pad_to": (None if v.get("pad_to") is None
                                       else tuple(v["pad_to"]))})
            for k, v in d["placements"].items()
        }
        d["comm"] = CommPlan(**d["comm"])
        d["partitions"] = {k: BlockPlan(**v) for k, v in d["partitions"].items()}
        d["mesh_axes"] = tuple(d["mesh_axes"])
        d["mesh_shape"] = tuple(d["mesh_shape"])
        # axis-rule assignments serialize as JSON arrays; the live form
        # is tuples (equality + hashing depend on it)
        d["axis_rules"] = {k: _untuple_one(v) for k, v in d["axis_rules"].items()}
        d["log"] = [tuple(x) for x in d["log"]]
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "MemoryPlan":
        return cls.from_dict(json.loads(s))


def _untuple_one(v: Any) -> Any:
    return tuple(v) if isinstance(v, (list, tuple)) else v


def _untuple(spec: Any) -> AxisAssign:
    out = []
    for s in spec:
        if isinstance(s, (list, tuple)):
            out.append(tuple(s))
        else:
            out.append(s)
    return tuple(out)
