"""Markdown tables of the port's dry run, from results/dryrun_torch/*.json.

The port of ``repro/analysis/report.py``: the same tables over the
port's cells.  Every number in them is modelled from the cell's
target's data-sheet values (``h100-sxm`` unless the cell names
another), not measured on a card.  The fit column holds the step's
peak of live bytes a device against the target's HBM (80 GB on
``h100-sxm``); a cell with no target field is held to 16 GiB, as the
reference holds it.

Run:  PYTHONPATH=src python -m repro_torch.analysis.report
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

from repro_torch.hw.tpu import get_target

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

ARCH_ORDER = [
    "hubert-xlarge", "qwen2-vl-72b", "mamba2-2.7b", "granite-moe-1b-a400m",
    "llama4-maverick-400b-a17b", "qwen3-8b", "deepseek-7b",
    "deepseek-coder-33b", "minitron-8b", "hymba-1.5b",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
#: the fit bar of a cell that names no target (the reference's)
DEFAULT_FIT = 16 * 2**30
MODELLED = ("modelled from the target's data-sheet values (h100-sxm unless "
            "the cell names another), not measured on a card")


def load(mesh: str, tag: str = "", results: Optional[Path] = None):
    results = results or RESULTS
    out = {}
    sfx = f"@{tag}" if tag else ""
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            f = results / f"{a}@{s}@{mesh}{sfx}.json"
            if f.exists():
                out[(a, s)] = json.loads(f.read_text())
    return out


def fmt_bytes(b):
    return f"{b/2**30:.2f}"


def _peak(d) -> float:
    return d["memory_analysis"]["peak_estimate_per_device"]


def _seconds(d) -> float:
    return d["trace_s"] if "trace_s" in d else d["compile_s"]


def _fit(d) -> str:
    mem = _peak(d)
    if "target" not in d:
        return "yes" if mem <= DEFAULT_FIT else f"NO ({mem/2**30:.0f}G)"
    cap = get_target(d["target"]).hbm_bytes
    return "yes" if mem <= cap else f"NO ({mem/2**30:.0f}G)"


def dryrun_table(mesh: str, results: Optional[Path] = None) -> str:
    data = load(mesh, results=results)
    # the port's cells carry trace seconds, the reference's compile seconds
    secs = "trace s" if any("trace_s" in d for d in data.values()) \
        else "compile s"
    lines = [
        f"| arch | shape | kind | {secs} | bytes/dev GiB | HLO PFLOPs/dev "
        f"| coll GB/dev | dominant collectives |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for (a, s), d in data.items():
        if not d.get("runnable", True):
            lines.append(f"| {a} | {s} | — | — | — | — | — | "
                         f"skipped: {d['skip_reason']} |")
            continue
        if "roofline" not in d:
            lines.append(f"| {a} | {s} | — | — | — | — | — | "
                         f"failed: {d.get('error', '')[:80]} |")
            continue
        r = d["roofline"]
        kinds = sorted(r["collective_by_kind"].items(),
                       key=lambda kv: -kv[1])[:2]
        kstr = ", ".join(f"{k} {v/1e9:.1f}GB" for k, v in kinds)
        lines.append(
            f"| {a} | {s} | {d['kind']} | {_seconds(d):.1f} "
            f"| {fmt_bytes(_peak(d))} "
            f"| {r['hlo_flops']/1e15:.3f} "
            f"| {r['collective_bytes']/1e9:.1f} | {kstr} |")
    return "\n".join(lines)


def roofline_table(mesh: str = "16x16", tag: str = "",
                   results: Optional[Path] = None) -> str:
    data = load(mesh, tag, results)
    fit = "≤ target HBM" if any("target" in d for d in data.values()) \
        else "≤16 GiB"
    lines = [
        "| arch | shape | compute s | memory s | collective s | bottleneck "
        f"| model TFLOP/dev | useful | MFU (max-term) | fit ({fit})* |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for (a, s), d in data.items():
        if not d.get("runnable", True) or "roofline" not in d:
            lines.append(f"| {a} | {s} | — | — | — | skipped | — | — | — | — |")
            continue
        r = d["roofline"]
        lines.append(
            f"| {a} | {s} | {r['compute_s']:.4f} | {r['memory_s']:.4f} "
            f"| {r['collective_s']:.4f} | **{r['bottleneck']}** "
            f"| {r['model_flops']/1e12:.2f} | {r['useful_ratio']:.2f} "
            f"| {r['mfu']:.3f} | {_fit(d)} |")
    return "\n".join(lines)


def compare_table(mesh: str = "16x16", results: Optional[Path] = None) -> str:
    """Baseline (the cells tagged ``base``) vs the untagged cells."""
    base = load(mesh, "base", results)
    final = load(mesh, results=results)
    lines = [
        "| arch | shape | base bottleneck | base MFU | final bottleneck "
        "| final MFU | step time: base -> final |",
        "|---|---|---|---|---|---|---|",
    ]
    for key in final:
        if key not in base:
            continue
        b, f = base[key], final[key]
        if not f.get("runnable", True) or "roofline" not in f \
                or "roofline" not in b:
            continue
        rb, rf = b["roofline"], f["roofline"]
        lines.append(
            f"| {key[0]} | {key[1]} | {rb['bottleneck']} | {rb['mfu']:.3f} "
            f"| {rf['bottleneck']} | {rf['mfu']:.3f} "
            f"| {rb['step_time_s']*1e3:.1f} -> {rf['step_time_s']*1e3:.1f} ms |")
    return "\n".join(lines)


def main() -> None:
    print(f"## Dry-run 16x16 (256 ranks; {MODELLED})\n")
    print(dryrun_table("16x16"))
    print(f"\n## Dry-run 2x16x16 (512 ranks; {MODELLED})\n")
    print(dryrun_table("2x16x16"))
    print(f"\n## Roofline (16x16; {MODELLED})\n")
    print(roofline_table("16x16"))
    print(f"\n## Baseline vs final planner ({MODELLED})\n")
    print(compare_table("16x16"))


if __name__ == "__main__":
    main()
