"""Three-term roofline of one step from the dry run's operation counts.

The port of ``repro/analysis/roofline.py``:

    compute term    = FLOPs       / peak_FLOP/s
    memory term     = HBM bytes   / HBM_bw
    collective term = coll bytes  / link_bw   (DCN bytes / dcn_bw)

All quantities are per device: the counts are rank 0's eager step
(:mod:`repro_torch.analysis.op_stats`), the twin of the reference's SPMD
per-device program.  The fields, ``model_flops_per_step`` and the term,
bottleneck and ``mfu`` formulas are the reference's; ``analyze`` takes
``op_stats``' dict instead of HLO text, and its times are modelled from
the target's data-sheet values, not measured.  ``xla_flops_raw`` and
``xla_bytes_raw`` (XLA's own uncorrected cost analysis) have no
counterpart here and stay 0.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.hw.tpu import TpuTarget, get_target

#: what ``notes`` says of the raw XLA columns
NO_XLA = ("xla_flops_raw / xla_bytes_raw: no compiler cost analysis in the "
          "port (0)")


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    kind: str                     # train | decode | prefill | forward
    # per-device quantities
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    collective_bytes_dcn: float
    collective_by_kind: Dict[str, float]
    # raw cost_analysis (the reference's cross-check column; 0 here)
    xla_flops_raw: float
    xla_bytes_raw: float
    # terms (seconds)
    compute_s: float
    memory_s: float
    collective_s: float
    # model-level
    model_flops: float            # 6*N*D (dense) / 6*N_active*D per device
    useful_ratio: float           # model_flops / hlo_flops
    bottleneck: str
    step_time_s: float            # max of terms (perfect overlap)
    mfu: float                    # model_flops / (step_time * peak)
    memory_per_device_bytes: float
    notes: str = ""

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def model_flops_per_step(arch: ArchConfig, shape: ShapeConfig) -> float:
    """6·N·D with N = active params (MoE) and D = tokens this step.

    Training counts fwd+bwd (6ND); inference counts forward only (2ND).
    """
    n = arch.active_param_count()
    toks = shape.tokens
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * toks


def analyze(*, arch: ArchConfig, shape: ShapeConfig, kind: str,
            stats: Dict[str, Any], n_devices: int,
            memory_bytes: float = 0.0, mesh_desc: str = "",
            target: str | TpuTarget = "h100-sxm",
            notes: str = "") -> RooflineReport:
    """The roofline of ``stats`` (:meth:`op_stats.OpStats.result`);
    ``memory_bytes`` is the step's peak of live bytes a device."""
    tgt = target if isinstance(target, TpuTarget) else get_target(target)
    flops = stats["flops"]
    hbm = stats["hbm_bytes"]
    coll = stats["collective_bytes"]
    coll_dcn = stats["collective_bytes_dcn"]

    compute_s = flops / tgt.peak_bf16_flops
    memory_s = hbm / tgt.hbm_bw
    # DCN-crossing bytes ride the slow channel
    collective_s = (coll - coll_dcn) / tgt.ici_link_bw + coll_dcn / tgt.dcn_bw

    mf = model_flops_per_step(arch, shape) / n_devices
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    step = max(compute_s, memory_s, collective_s)
    mfu = mf / (step * tgt.peak_bf16_flops) if step > 0 else 0.0

    return RooflineReport(
        arch=arch.name, shape=shape.name, mesh=mesh_desc, kind=kind,
        hlo_flops=flops, hlo_bytes=hbm, collective_bytes=coll,
        collective_bytes_dcn=coll_dcn,
        collective_by_kind=dict(stats["collective_by_kind"]),
        xla_flops_raw=0.0, xla_bytes_raw=0.0,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        model_flops=mf, useful_ratio=mf / flops if flops else 0.0,
        bottleneck=bottleneck, step_time_s=step, mfu=mfu,
        memory_per_device_bytes=float(memory_bytes),
        notes="; ".join(n for n in (NO_XLA, notes) if n))
