"""How the flow specializes the SAME template differently per workload,
in the PyTorch port: the plan of four contrasting workloads, what each
pass decided and why.

The port's twin of ``examples/specialize_report.py``.  The plans are
the ``h100-sxm`` target's (``--target tpu-v5e`` prints the reference's
cases as it prints them).  Nothing runs on a device.

Run:  PYTHONPATH=src python examples/torch_specialize_report.py [--target tpu-v5e]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.pipeline import specialize  # noqa: E402

CASES = [
    ("qwen3-8b", "train_4k", ("data", "model"), (16, 16)),
    ("llama4-maverick-400b-a17b", "train_4k", ("pod", "data", "model"),
     (2, 16, 16)),
    ("qwen2-vl-72b", "decode_32k", ("data", "model"), (16, 16)),
    ("mamba2-2.7b", "long_500k", ("data", "model"), (16, 16)),
]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--target", default="h100-sxm")
    args = ap.parse_args(argv)
    for arch, shape, axes, mesh in CASES:
        plan = specialize(arch, shape, mesh_axes=axes, mesh_shape=mesh,
                          target=args.target)
        print(f"\n{'='*72}\n{arch} @ {shape} on {'x'.join(map(str, mesh))} "
              f"({args.target})")
        print(f"{'='*72}")
        for pass_name, subject, decision, reason in plan.log:
            print(f"  [{pass_name:18s}] {subject:16s} -> {decision}")
            print(f"       {reason}")
        on = [n for n, c in plan.template_summary["components"].items()
              if c["enabled"]]
        off = [n for n, c in plan.template_summary["components"].items()
               if not c["enabled"]]
        print(f"  components kept:    {', '.join(on)}")
        print(f"  components removed: {', '.join(off) or '(none)'}")


if __name__ == "__main__":
    main()
