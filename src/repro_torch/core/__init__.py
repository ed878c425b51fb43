"""Core library: the paper's contribution.

* Memory IR + domain-specific annotations (``ir``, ``annotations``)
* The domain-specific memory template (``template``)
* The multi-level specialization flow (``pipeline`` + ``passes``)
* The resulting specialized-template artifact (``plan``)
"""

from repro_torch.core.ir import (
    AccessPattern,
    Lifetime,
    MemorySpace,
    OpDecl,
    OpKind,
    ProgramIR,
    Reuse,
    Role,
    TensorDecl,
)
from repro_torch.core.pipeline import (PassPipeline, clear_plan_cache,
                                 plan_cache_stats, specialize)
from repro_torch.core.plan import (PLAN_SCHEMA_VERSION, BlockPlan, CommPlan,
                             FrozenBlockPlan, FrozenCommPlan, FrozenPlacement,
                             FrozenPlan, MemoryPlan, Placement,
                             diff_decision_logs)
from repro_torch.core.planstore import PlanStore, default_plan_dir, get_store
from repro_torch.core.template import Component, ComponentKind, MemoryTemplate

__all__ = [
    "AccessPattern", "Lifetime", "MemorySpace", "OpDecl", "OpKind",
    "ProgramIR", "Reuse", "Role", "TensorDecl", "PassPipeline", "specialize",
    "clear_plan_cache", "plan_cache_stats",
    "BlockPlan", "CommPlan", "MemoryPlan", "Placement", "Component",
    "ComponentKind", "MemoryTemplate",
    "FrozenPlan", "FrozenPlacement", "FrozenCommPlan", "FrozenBlockPlan",
    "PLAN_SCHEMA_VERSION", "diff_decision_logs",
    "PlanStore", "default_plan_dir", "get_store",
]
