"""``repro_torch plan`` CLI: inspect/diff stored FrozenPlan artifacts by hash.

The content-addressed plan store (:mod:`repro_torch.core.planstore`) is the
deployment artifact shelf — this is the shelf's inspection tool::

    python -m repro_torch.launch.plan list [--plan-dir DIR]
    python -m repro_torch.launch.plan show <hash-prefix> [--log]
    python -m repro_torch.launch.plan diff <hash-prefix> <hash-prefix>
    python -m repro_torch.launch.plan verify
    python -m repro_torch.launch.plan gc [--max-entries N]

``list`` tabulates every entry (hash, arch, shape, workload dims, key
decisions); ``show`` prints one artifact's summary + decision log (``--log``
names the kernel tiles each pass chose, e.g. the ``tiled_matmul`` tile
that ``kernels.ops.matmul`` runs); ``diff`` compares two artifacts
decision-by-decision (:func:`repro_torch.core.plan.diff_decision_logs`).
It prints what the JAX package's CLI (``src/repro/launch/plan.py``)
prints.  ``verify`` re-hashes every stored artifact and reports corrupt
/ stale-schema entries and dangling ``by_key`` refs (exit 1 when any
defect is found); ``gc`` runs the store's eviction manually
(stale-schema first, then LRU past the cap).  Hashes may be abbreviated to any unique prefix.
Loads are hash-verified by the store; corrupt entries are reported,
not silently skipped.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from repro_torch.core import planstore
from repro_torch.core.plan import FrozenPlan, diff_decision_logs


def _entries(plan_dir: Path) -> List[Path]:
    return sorted(plan_dir.glob("*.json"))


def _resolve(plan_dir: Path, prefix: str) -> Path:
    hits = [f for f in _entries(plan_dir) if f.stem.startswith(prefix)]
    if not hits:
        raise SystemExit(f"no stored plan matches {prefix!r} "
                         f"in {plan_dir}")
    if len(hits) > 1:
        names = ", ".join(f.stem[:16] for f in hits)
        raise SystemExit(f"ambiguous prefix {prefix!r}: {names}")
    return hits[0]


def _load(store: planstore.PlanStore, path: Path) -> FrozenPlan:
    plan = store.load(path.stem)
    if plan is None:
        raise SystemExit(f"{path.name}: corrupt or hash-mismatched entry")
    return plan


_DECISION_KEYS = ("strategy", "decode_impl", "kv_residency", "kv_block_len",
                  "kv_n_blocks", "kv_admission", "kv_preempt_headroom",
                  "kv_prefix_reuse", "kv_prefix_hit_headroom",
                  "kv_tier_split", "kv_host_blocks", "kv_prefetch",
                  "kv_prefill_mode", "kv_prefill_chunk",
                  "moe_impl", "grad_compress", "grad_compress_lowered",
                  "combine_topology")


def _decisions(plan: FrozenPlan) -> dict:
    """Decision summary, schema-tolerant across artifact generations.

    Plans stored before the multi-tier refactor never recorded a
    ``kv_tier_split`` — their paged pools *were* single-tier, so render
    them as ``hbm-only`` instead of dropping the field (or raising on a
    reader that assumes it exists).  Likewise plans from before the
    disaggregated-prefill split never recorded a ``kv_prefill_mode`` —
    their prefills all ran in-process, so render ``inline``.  Plans from
    before the combine-topology split ran every shard_map decode combine
    as flat psums — render ``flat``; compressed plans from before the
    wire lowering only modeled the cut post-reduce — render
    ``post-reduce``."""
    dec = {k: plan.estimates[k] for k in _DECISION_KEYS
           if k in plan.estimates}
    if dec.get("kv_residency") == "paged":
        if "kv_tier_split" not in dec:
            dec["kv_tier_split"] = "hbm-only"
        if "kv_prefill_mode" not in dec:
            dec["kv_prefill_mode"] = "inline"
    if str(dec.get("decode_impl", "")).startswith("shard_map") \
            and "combine_topology" not in dec:
        dec["combine_topology"] = "flat"
    if dec.get("grad_compress") and "grad_compress_lowered" not in dec:
        dec["grad_compress_lowered"] = "post-reduce"
    return dec


def _dims(p: FrozenPlan) -> str:
    return (f"{p.shape_kind or '?'} seq={p.seq_len} batch={p.global_batch} "
            f"mesh={'x'.join(str(s) for s in p.mesh_shape)}")


def cmd_list(plan_dir: Path, store: planstore.PlanStore) -> int:
    entries = _entries(plan_dir)
    if not entries:
        print(f"no stored plans in {plan_dir}")
        return 0
    print(f"{len(entries)} plan(s) in {plan_dir}")
    print(f"{'hash':<14} {'arch':<28} {'shape':<14} {'dims':<36} decisions")
    for f in entries:
        plan = store.load(f.stem)
        if plan is None:
            print(f"{f.stem[:12]:<14} <corrupt or stale-schema entry>")
            continue
        dec = ";".join(f"{k}={v}" for k, v in _decisions(plan).items())
        print(f"{plan.content_hash()[:12]:<14} {plan.arch:<28} "
              f"{plan.shape:<14} {_dims(plan):<36} {dec}")
    return 0


def cmd_show(plan_dir: Path, store: planstore.PlanStore, prefix: str,
             show_log: bool) -> int:
    plan = _load(store, _resolve(plan_dir, prefix))
    print(f"plan {plan.content_hash()}")
    print(f"  arch={plan.arch} shape={plan.shape} target={plan.target}")
    print(f"  workload: {_dims(plan)}")
    print(f"  use_pallas={plan.use_pallas} "
          f"comm={plan.comm.grad_schedule}"
          f"{'+int8_ef' if plan.comm.compresses_gradients else ''} "
          f"remat={plan.comm.remat_policy}")
    dec = _decisions(plan)
    if dec:
        print("  decisions: " + json.dumps(dec, default=str))
    print(f"  placements={len(plan.placements)} "
          f"partitions={sorted(plan.partitions)} "
          f"log_entries={len(plan.log)}")
    if show_log:
        for pass_name, subj, decision, why in plan.log:
            print(f"  [{pass_name}] {subj}: {decision}  ({why})")
    return 0


def cmd_diff(plan_dir: Path, store: planstore.PlanStore,
             a_prefix: str, b_prefix: str) -> int:
    a = _load(store, _resolve(plan_dir, a_prefix))
    b = _load(store, _resolve(plan_dir, b_prefix))
    if a.content_hash() == b.content_hash():
        print(f"identical: {a.content_hash()[:12]}")
        return 0
    print(f"--- {a.content_hash()[:12]} ({a.arch}@{a.shape}, {_dims(a)})")
    print(f"+++ {b.content_hash()[:12]} ({b.arch}@{b.shape}, {_dims(b)})")
    lines = diff_decision_logs(a.log, b.log)
    for line in lines:
        print(line)
    if not lines:
        print("(decision logs identical — dims/estimates differ)")
    return 1


def cmd_verify(plan_dir: Path, store: planstore.PlanStore) -> int:
    """Re-hash every stored artifact; report anything unservable.

    The health check is :meth:`planstore.PlanStore.verify_entry` — the
    same recipe ``_read_entry`` loads through, so this report can never
    diverge from what the store actually accepts."""
    entries = _entries(plan_dir)
    bad = 0
    for f in entries:
        status = store.verify_entry(f)
        if status != "ok":
            bad += 1
            print(f"{f.stem[:16]:<18} {status}")
    dangling = 0
    by_key = plan_dir / "by_key"
    if by_key.is_dir():
        for ref in sorted(by_key.iterdir()):
            try:
                h = ref.read_text().strip()
            except OSError:
                h = ""
            if not h or not (plan_dir / f"{h}.json").exists():
                dangling += 1
                print(f"by_key/{ref.name[:16]:<10} dangling ref "
                      f"-> {h[:12] or '<empty>'}")
    print(f"{len(entries)} entr{'y' if len(entries) == 1 else 'ies'} "
          f"verified: {len(entries) - bad} ok, {bad} bad, "
          f"{dangling} dangling ref(s)")
    return 1 if bad or dangling else 0


def cmd_gc(store: planstore.PlanStore,
           max_entries: Optional[int]) -> int:
    """Manual eviction: stale-schema entries first, then LRU past the
    cap (the same policy lazy GC applies on over-cap puts)."""
    removed = store.gc(max_entries)
    stats = store.stats()
    print(f"gc removed {removed} entr{'y' if removed == 1 else 'ies'}; "
          f"{stats['disk_size']} left "
          f"({stats['disk_bytes'] / 2**20:.2f} MiB)")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.plan",
        description="inspect/diff stored plan artifacts by content hash")
    ap.add_argument("--plan-dir", default="",
                    help="store directory (default $REPRO_PLAN_DIR or "
                         "~/.cache/repro_torch/plans)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="tabulate stored artifacts")
    p_show = sub.add_parser("show", help="one artifact's summary")
    p_show.add_argument("hash", help="content hash (unique prefix ok)")
    p_show.add_argument("--log", action="store_true",
                        help="also print the full decision log")
    p_diff = sub.add_parser("diff", help="decision-log diff of two artifacts")
    p_diff.add_argument("hash_a")
    p_diff.add_argument("hash_b")
    sub.add_parser("verify",
                   help="re-hash every artifact, report corrupt/stale")
    p_gc = sub.add_parser("gc", help="manual eviction (stale-first, LRU)")
    p_gc.add_argument("--max-entries", type=int, default=None,
                      help="entry cap to shrink to (default: store cap)")
    args = ap.parse_args(argv)

    store = planstore.get_store(args.plan_dir or None)
    plan_dir = store.plan_dir
    if args.cmd == "list":
        return cmd_list(plan_dir, store)
    if args.cmd == "show":
        return cmd_show(plan_dir, store, args.hash, args.log)
    if args.cmd == "verify":
        return cmd_verify(plan_dir, store)
    if args.cmd == "gc":
        return cmd_gc(store, args.max_entries)
    return cmd_diff(plan_dir, store, args.hash_a, args.hash_b)


if __name__ == "__main__":
    sys.exit(main())
