"""Dry run: every (arch x shape x mesh) cell's step traced on fake tensors.

The port of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each cell's step for 256 or 512 placeholder XLA devices and
reads the compiled per-device HLO; the port has no compiler, so it runs
rank 0's eager step on fake tensors (``FakeTensorMode``: shapes and
dtypes, no storage) in one process whose process group is fake
(``torch.distributed``'s ``fake`` backend over ``FakeStore``, a world of
the mesh's size: every collective returns at once).  Nothing is
allocated, built or launched.  The parameters are the rank's pieces at
``lm.param_shapes``' sizes, uninitialised: nothing is drawn.
:class:`repro_torch.analysis.op_stats.OpStats` counts the step and
:func:`repro_torch.analysis.roofline.analyze` models its time on the
plan's target (``h100-sxm`` unless ``--overrides`` names another).

Run it as its own process (it initializes a fake process group).  Per
cell it writes ``results/dryrun_torch/<arch>@<shape>@<mesh>[@tag].json``
with the reference's keys where the quantity is the same: the plan's
hash, log, estimates and optimizer decisions; ``memory_analysis`` (the
step's peak of live bytes a device, the arguments' bytes); the
roofline; ``kind``; and ``trace_s`` (the fake step's seconds: there is
no ``compile_s``), beside the port's own: ``kernels`` (calls, flops and
bytes by kernel entry), ``collective_calls``, ``notes``.  A cell the
port refuses (``lm.check_serves``, ``lm.check_on_device`` at the
target's card, ``launch.serve.check_fits`` against the target's HBM, or
a refusal raised while lowering or tracing) is written ``runnable:
false`` with the port's reason, as the reference writes
``applicable``'s skips.

The fake tensors are on ``cuda`` where torch is built with CUDA; a
CPU-only torch cannot index a fake CUDA tensor (its Python bindings take
a CUDA device guard that such a build lacks), so there they are on the
CPU.  Either way every kernel entry takes its fake path
(:mod:`repro_torch.kernels.fake`), never a plain version, and the
refusals are the card's.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-done]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
from pathlib import Path
from typing import Optional, Sequence, Tuple

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

#: decode calls on fake tensors cannot read their lengths
DECODE_NOTE = ("the decode kernels' cache lengths are fake: each decode call "
               "counts its slots' whole capacity (a dense stripe's rows, a "
               "paged slot's table of blocks)")
#: the h100-sxm target has one link rate
NVLINK_NOTE = ("a model axis of 16 spans two 8-card NVLink nodes; the target "
               "has one link rate (NVLink, 450 GB/s), so the collective term "
               "is optimistic")


def fake_device() -> str:
    """The fake tensors' device: ``cuda`` where torch is built with it."""
    import torch
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def fake_world(n: int) -> None:
    """A fake process group of ``n`` ranks in this process, this rank 0
    (replacing a fake group of another size); raises :class:`SystemExit`
    where torch has no ``FakeStore``."""
    import torch.distributed as dist
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise SystemExit(
            f"dryrun: this torch has no FakeStore (torch.testing._internal"
            f".distributed.fake_pg: {e}); the dry run needs its fake process "
            "group") from e
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("dryrun: a real process group is initialized; "
                               "run the dry run in its own process")
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), world_size=n, rank=0)


def fake_mesh(shape: Sequence[int], names: Sequence[str]):
    """A ``DeviceMesh`` of the fake world (:func:`fake_world`): the
    launcher's ``make_production_mesh`` refuses a CUDA mesh with no
    card, which stays so for every real mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    fake_world(math.prod(shape))
    return init_device_mesh(fake_device(), tuple(shape),
                            mesh_dim_names=tuple(names))


def refusal(plan, arch, shape, target) -> str:
    """The port's reason for refusing the cell on its target's card, or
    ``""``."""
    from repro_torch.launch.serve import check_fits
    from repro_torch.models import lm
    from repro_torch.serve.sharded import head_dim_ways
    try:
        if shape.kind == "decode":
            lm.check_serves(arch)
        _, heads, _, kv_heads = plan.padded_sizes()
        fa = plan.partitions.get("flash_attention")
        lm.check_on_device(
            arch, "cuda", heads=heads, kv_heads=kv_heads,
            flash_tiles=((int(fa.blocks["block_q"]),
                          int(fa.blocks["block_kv"])) if fa else None),
            head_dim_ways=(head_dim_ways(plan, arch)
                           if shape.kind == "decode" else 0))
        if shape.kind != "train":
            check_fits(arch, plan.padded_sizes(), "cuda", plan,
                       free=target.hbm_bytes)
    except NotImplementedError as e:
        return str(e)
    return ""


def trace(step, device: str):
    """Run ``step`` once on fake tensors under ``OpStats``: ``(stats,
    argument bytes, seconds)``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis.op_stats import OpStats
    t0 = time.time()
    with FakeTensorMode(), OpStats() as st:
        args = step.make_args(device)
        arg_bytes = st.live
        out = step.fn(*args)
        del out, args
    return st.result(), arg_bytes, time.time() - t0


def run_cell(arch_name: str, shape_name: str, multi_pod: bool = False,
             overrides: Optional[dict] = None, tag: str = "", *,
             mesh_shape: Optional[Tuple[int, ...]] = None, arch=None,
             shape=None) -> dict:
    """One cell: specialize, refuse or lower, trace, model.  ``mesh_shape``
    (default 16x16, or 2x16x16 with ``multi_pod``) and ad hoc ``arch`` /
    ``shape`` configs let a caller dry-run the plans a card runs."""
    from repro_torch.analysis import roofline
    from repro_torch.configs import applicable, get_arch, get_shape
    from repro_torch.core.passes.lowering import lower_step
    from repro_torch.core.pipeline import specialize
    from repro_torch.hw.tpu import get_target

    arch = arch if arch is not None else get_arch(arch_name)
    shape = shape if shape is not None else get_shape(shape_name)
    mesh_shape = tuple(mesh_shape or ((2, 16, 16) if multi_pod else (16, 16)))
    axes = ("pod", "data", "model") if len(mesh_shape) == 3 \
        else ("data", "model")
    mesh_desc = "x".join(map(str, mesh_shape))
    ok, why = applicable(arch, shape)
    out = {"arch": arch_name, "shape": shape_name, "mesh": mesh_desc,
           "runnable": ok, "skip_reason": why, "timestamp": time.time()}
    if not ok:
        return out
    opts = dict(overrides or {})
    target = get_target(opts.pop("target", "h100-sxm"))
    plan = specialize(arch, shape, mesh_axes=axes, mesh_shape=mesh_shape,
                      target=target.name, **opts)
    out.update(target=target.name, plan_hash=plan.content_hash(),
               fake_device=fake_device())
    why = refusal(plan, arch, shape, target)
    if why:
        out.update(runnable=False, skip_reason=f"port: {why}")
        return out
    mesh = None
    if math.prod(mesh_shape) > 1:
        mesh = fake_mesh(mesh_shape, axes)
    try:
        step = lower_step(plan, mesh, arch=arch, shape=shape)
        stats, arg_bytes, trace_s = trace(step, fake_device())
    except NotImplementedError as e:
        out.update(runnable=False, skip_reason=f"port: {e}")
        return out
    notes = []
    if step.kind == "decode" and any(stats["kernels"].get(k) for k in (
            "decode_attention", "paged_decode_attention", "decode_partial",
            "paged_decode_partial", "decode_split_scores",
            "decode_split_context")):
        notes.append(DECODE_NOTE)
    if dict(zip(axes, mesh_shape)).get("model", 1) > 8:
        notes.append(NVLINK_NOTE)
    peak = stats["peak_live_bytes"]
    rep = roofline.analyze(
        arch=arch, shape=shape, kind=step.kind, stats=stats,
        n_devices=math.prod(mesh_shape), memory_bytes=peak,
        mesh_desc=mesh_desc, target=target, notes="; ".join(notes))
    out.update(
        kind=step.kind,
        trace_s=round(trace_s, 2),
        memory_analysis={"argument_size": arg_bytes,
                         "peak_estimate_per_device": peak},
        roofline=rep.to_json(),
        kernels=stats["kernels"],
        collective_calls=stats["collective_calls"],
        n_ops=stats["n_computations"],
        notes=rep.notes,
        plan_log=[list(e) for e in plan.log],
        plan_estimates=dict(plan.estimates),
        plan_opt=dict(plan.opt),
    )
    return out


def cell_path(arch: str, shape: str, mesh_desc: str, tag: str = "") -> Path:
    sfx = f"@{tag}" if tag else ""
    return RESULTS / f"{arch}@{shape}@{mesh_desc}{sfx}.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--overrides", default="",
                    help="JSON dict forwarded to specialize() (a 'target' "
                         "key picks the target; default h100-sxm)")
    args = ap.parse_args(argv)

    from repro_torch.configs import all_cells

    RESULTS.mkdir(parents=True, exist_ok=True)
    overrides = json.loads(args.overrides) if args.overrides else None
    mesh_desc = "2x16x16" if args.multi_pod else "16x16"
    if args.all:
        cells = [(a, s) for a, s, _, _ in all_cells()]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    failures = 0
    for a, s in cells:
        path = cell_path(a, s, mesh_desc, args.tag)
        if args.skip_done and path.exists():
            print(f"[skip] {a}@{s}@{mesh_desc}")
            continue
        print(f"[cell] {a}@{s}@{mesh_desc} ...", flush=True)
        try:
            out = run_cell(a, s, args.multi_pod, overrides, args.tag)
        except Exception as e:  # noqa: BLE001 - record and continue
            out = {"arch": a, "shape": s, "mesh": mesh_desc,
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
            failures += 1
            print(f"  FAILED: {e}", flush=True)
        path.write_text(json.dumps(out, indent=2, default=str))
        if "roofline" in out:
            r = out["roofline"]
            print(f"  ok kind={out['kind']} trace={out['trace_s']}s "
                  f"bottleneck={r['bottleneck']} "
                  f"step={r['step_time_s']*1e3:.1f}ms mfu={r['mfu']:.3f} "
                  f"mem/dev={out['memory_analysis']['peak_estimate_per_device']/2**30:.2f}GiB",
                  flush=True)
        elif out.get("skip_reason"):
            print(f"  skipped: {out['skip_reason']}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
