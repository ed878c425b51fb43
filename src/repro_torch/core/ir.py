"""Memory IR — the multi-level intermediate representation of §4.

The paper's flow operates on an IR that carries *data-related* information
(access patterns, lifetimes, sizes) alongside the computation, so that the
memory architecture can be refined before the accelerator logic is
generated.  This module is that IR, re-targeted to TPU workloads:

* :class:`TensorDecl` — one logical tensor (parameter, activation, KV
  cache, optimizer state, ...) with its *domain-specific annotations*
  (access pattern, reuse, lifetime, logical axes).
* :class:`OpDecl`     — one coarse op (matmul / attention / scan / moe
  dispatch) with FLOP and byte estimates, used by the cost model.
* :class:`ProgramIR`  — the program-level container the passes rewrite.

The IR is deliberately *coarse*: one entry per logically-distinct tensor
class (e.g. "all 80 stacked q_proj weights" is one TensorDecl with a
``layers`` leading dim), which is what the placement decisions operate on.
The lowering pass maps decisions back onto the concrete pytree by matching
``role`` + ``logical_axes``.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np


class MemorySpace(enum.Enum):
    """Where bytes physically live — the template's storage sites."""

    HBM = "hbm"            # on-chip (per-accelerator) DRAM: the default
    VMEM = "vmem"          # kernel working set (PLM analogue)
    SMEM = "smem"          # scalars / prefetch indices
    HOST = "host"          # host DRAM (off-chip analogue)
    REMOTE = "remote"      # other pods / storage (NVM analogue)


class AccessPattern(enum.Enum):
    SEQUENTIAL = "sequential"    # streaming, unit stride (DMA friendly)
    STRIDED = "strided"          # regular but non-unit stride (layout pass fixes)
    RANDOM = "random"            # gather/scatter (latency-insensitive path)
    BROADCAST = "broadcast"      # read by all compute units (weights)
    REDUCTION = "reduction"      # written via accumulation (grads)


class Reuse(enum.Enum):
    NONE = "none"        # touched once per step (activations in a stream)
    LOW = "low"          # a few touches (residual streams)
    HIGH = "high"        # many touches (weights, KV cache during decode)


class Lifetime(enum.Enum):
    EPHEMERAL = "ephemeral"      # intra-step (activations) — remat candidates
    STEP = "step"                # lives across one step (grads, inputs)
    PERSISTENT = "persistent"    # lives across steps (params, opt state)
    SESSION = "session"          # lives across requests (KV cache)


class Role(enum.Enum):
    PARAM = "param"
    EXPERT_PARAM = "expert_param"    # MoE expert weights (EP-shardable)
    OPT_STATE = "opt_state"
    GRAD = "grad"
    ACTIVATION = "activation"
    INPUT = "input"
    OUTPUT = "output"
    KV_CACHE = "kv_cache"
    SSM_STATE = "ssm_state"
    ROUTING = "routing"              # MoE router tensors


@dataclasses.dataclass
class TensorDecl:
    """One logical tensor + its domain-specific annotations (paper §1, §4)."""

    name: str
    shape: Tuple[int, ...]
    dtype: str                       # numpy dtype name, e.g. "bfloat16"
    role: Role
    logical_axes: Tuple[Optional[str], ...]  # one label per dim, None = unsharded
    access: AccessPattern = AccessPattern.SEQUENTIAL
    reuse: Reuse = Reuse.NONE
    lifetime: Lifetime = Lifetime.EPHEMERAL
    annotations: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if len(self.logical_axes) != len(self.shape):
            raise ValueError(
                f"{self.name}: logical_axes {self.logical_axes} rank "
                f"!= shape {self.shape} rank"
            )

    @property
    def dtype_bytes(self) -> int:
        if self.dtype == "bfloat16":
            return 2
        return np.dtype(self.dtype).itemsize

    @property
    def nbytes(self) -> int:
        return int(math.prod(self.shape)) * self.dtype_bytes

    @property
    def size(self) -> int:
        return int(math.prod(self.shape))


class OpKind(enum.Enum):
    MATMUL = "matmul"
    ATTENTION = "attention"
    ATTENTION_DECODE = "attention_decode"
    SSD_SCAN = "ssd_scan"
    MOE_DISPATCH = "moe_dispatch"
    EMBED = "embed"
    ELEMENTWISE = "elementwise"
    NORM = "norm"


@dataclasses.dataclass
class OpDecl:
    """A coarse compute op: enough structure for cost/partitioning passes."""

    name: str
    kind: OpKind
    operands: Tuple[str, ...]        # TensorDecl names read
    results: Tuple[str, ...]         # TensorDecl names written
    flops: float                     # forward FLOPs, whole-program (all layers)
    bytes_accessed: float            # min HBM traffic (compulsory)
    dims: Dict[str, int] = dataclasses.field(default_factory=dict)
    annotations: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.bytes_accessed, 1.0)


@dataclasses.dataclass
class ProgramIR:
    """The program the passes rewrite.

    ``phase`` records how far down the multi-level flow this IR instance
    has been refined (paper Figure 1: each pass moves the IR to a lower
    abstraction level).
    """

    name: str
    tensors: Dict[str, TensorDecl] = dataclasses.field(default_factory=dict)
    ops: List[OpDecl] = dataclasses.field(default_factory=list)
    phase: str = "source"
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # --- construction -----------------------------------------------------
    def declare(self, t: TensorDecl) -> TensorDecl:
        if t.name in self.tensors:
            raise ValueError(f"duplicate tensor decl {t.name!r}")
        self.tensors[t.name] = t
        return t

    def add_op(self, op: OpDecl) -> OpDecl:
        for ref in op.operands + op.results:
            if ref not in self.tensors:
                raise ValueError(f"op {op.name}: unknown tensor {ref!r}")
        self.ops.append(op)
        return op

    # --- queries ----------------------------------------------------------
    def by_role(self, *roles: Role) -> List[TensorDecl]:
        want = set(roles)
        return [t for t in self.tensors.values() if t.role in want]

    def total_bytes(self, *roles: Role) -> int:
        return sum(t.nbytes for t in self.by_role(*roles))

    def total_flops(self) -> float:
        return sum(op.flops for op in self.ops)

    def validate(self) -> None:
        for op in self.ops:
            for ref in op.operands + op.results:
                assert ref in self.tensors, (op.name, ref)
        for t in self.tensors.values():
            assert all(d > 0 for d in t.shape), (t.name, t.shape)
