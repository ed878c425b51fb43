"""Pass framework for the multi-level specialization flow (paper §4).

Each pass refines the :class:`~repro_torch.core.plan.MemoryPlan` (and the
template components it configures) at one abstraction level, in the
paper's order:

  data_organization → layout → communication → local_partitioning → lowering

Passes are independent and ablatable: :class:`PassPipeline` can run any
prefix/subset, which is how ``benchmarks/bench_passes.py`` reproduces the
paper's flexibility-vs-specialization trade-off.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.costmodel import MeshModel
from repro_torch.core.ir import ProgramIR
from repro_torch.core.plan import MemoryPlan
from repro_torch.core.template import MemoryTemplate


@dataclasses.dataclass
class PassContext:
    """Everything a pass may read/write."""

    arch: ArchConfig
    shape: ShapeConfig
    ir: ProgramIR
    mesh: MeshModel
    template: MemoryTemplate
    plan: MemoryPlan
    options: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def target(self):
        return self.template.target

    @property
    def training(self) -> bool:
        return bool(self.ir.meta.get("training", self.shape.kind == "train"))


class Pass:
    name: str = "pass"

    def run(self, ctx: PassContext) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def record(self, ctx: PassContext, subject: str, decision: str, reason: str) -> None:
        ctx.plan.record(self.name, subject, decision, reason)


from repro_torch.core.passes.data_organization import DataOrganizationPass  # noqa: E402
from repro_torch.core.passes.layout import LayoutPass  # noqa: E402
from repro_torch.core.passes.communication import CommunicationPass  # noqa: E402
from repro_torch.core.passes.partitioning import LocalPartitioningPass  # noqa: E402

DEFAULT_PASSES = (
    DataOrganizationPass,
    LayoutPass,
    CommunicationPass,
    LocalPartitioningPass,
)

__all__ = [
    "Pass",
    "PassContext",
    "DEFAULT_PASSES",
    "DataOrganizationPass",
    "LayoutPass",
    "CommunicationPass",
    "LocalPartitioningPass",
]
