"""The domain-specific memory template (paper §3).

A reusable graph of memory primitives that the compilation flow
*specializes* per application: components can be parameterized or removed
("if the data resides entirely on-chip, the prefetcher can be removed; if
there is only a single memory, the multi-channel controller can be
simplified").

On TPU the primitives map to (see DESIGN.md §2):

==================  =====================================================
paper component     TPU analogue parameterized by the passes
==================  =====================================================
PLM (multi-bank)    Pallas VMEM tiles: block shapes × n buffers
cache               KV-cache (serving) with residency management
DMA engine          pallas_call HBM→VMEM pipeline / async collectives
prefetcher          pipeline lookahead + host data-pipeline prefetch depth
multi-channel ctrl  mesh axes: ICI ("data","model") + DCN ("pod") channels
special functions   layout transforms fused by the layout pass
==================  =====================================================
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional

from repro_torch.hw.tpu import TpuTarget, get_target


class ComponentKind(enum.Enum):
    PLM = "plm"
    CACHE = "cache"
    DMA = "dma"
    PREFETCHER = "prefetcher"
    CHANNEL = "channel"
    SPECIAL = "special"


@dataclasses.dataclass
class Component:
    """One template component; passes set ``params`` or ``enabled=False``."""

    name: str
    kind: ComponentKind
    enabled: bool = True
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # Which pass last touched it — the provenance trail the paper's
    # progressive-refinement story needs.
    refined_by: List[str] = dataclasses.field(default_factory=list)

    def refine(self, pass_name: str, **params: Any) -> None:
        self.params.update(params)
        self.refined_by.append(pass_name)

    def remove(self, pass_name: str, reason: str) -> None:
        self.enabled = False
        self.params["removed_reason"] = reason
        self.refined_by.append(pass_name)


@dataclasses.dataclass
class MemoryTemplate:
    """The generic (un-specialized) template: paper Figure 1, lower half."""

    target: TpuTarget
    components: Dict[str, Component] = dataclasses.field(default_factory=dict)

    @classmethod
    def default(cls, target: str | TpuTarget = "tpu-v5e") -> "MemoryTemplate":
        tgt = target if isinstance(target, TpuTarget) else get_target(target)
        t = cls(target=tgt)
        add = lambda n, k: t.components.__setitem__(n, Component(n, k))
        add("plm.attention", ComponentKind.PLM)       # attention VMEM tiles
        add("plm.matmul", ComponentKind.PLM)          # matmul VMEM tiles
        add("plm.scan", ComponentKind.PLM)            # SSD scan VMEM tiles
        add("cache.kv", ComponentKind.CACHE)          # serving KV cache
        add("dma.hbm", ComponentKind.DMA)             # HBM<->VMEM pipeline
        add("prefetch.grid", ComponentKind.PREFETCHER)  # pallas lookahead
        add("prefetch.host", ComponentKind.PREFETCHER)  # input pipeline depth
        add("channel.ici", ComponentKind.CHANNEL)     # intra-pod collectives
        add("channel.dcn", ComponentKind.CHANNEL)     # pod axis collectives
        add("special.layout", ComponentKind.SPECIAL)  # fused transposes/padding
        add("special.compress", ComponentKind.SPECIAL)  # grad compression
        return t

    def __getitem__(self, name: str) -> Component:
        return self.components[name]

    def enabled(self) -> List[str]:
        return sorted(n for n, c in self.components.items() if c.enabled)

    def summary(self) -> Dict[str, Any]:
        return {
            "target": self.target.name,
            "components": {
                n: {
                    "kind": c.kind.value,
                    "enabled": c.enabled,
                    "params": c.params,
                    "refined_by": c.refined_by,
                }
                for n, c in sorted(self.components.items())
            },
        }
