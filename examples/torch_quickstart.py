"""Quickstart of the PyTorch port: the paper's flow in a few lines.

1. Pick an architecture + workload shape.
2. Run the multi-level specialization flow -> the frozen plan (the
   specialized memory-template instance, with the full decision log).
3. Lower ("HLS") the plan to a train step and run it.

The port's twin of ``examples/quickstart.py``: reduced qwen3-8b (on a
CUDA device at its published head_dim and GQA group, the widths the
card's kernels are built for), 128 tokens x 4, ten steps on the
``h100-sxm`` plan.  ``--device`` defaults to ``cuda``.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import ShapeConfig, get_arch, reduced_on  # noqa: E402
from repro_torch.core.pipeline import specialize  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # 1. workload: a reduced qwen3 so it runs in seconds
    arch = reduced_on(get_arch("qwen3-8b"), args.device)
    shape = ShapeConfig("quickstart", "train", seq_len=128, global_batch=4)

    # 2. the paper's contribution: specialize the memory template
    plan = specialize(arch, shape, mesh_axes=("data", "model"),
                      mesh_shape=(1, 1), target="h100-sxm")
    print("=== specialized memory plan (decision log) ===")
    for pass_name, subject, decision, reason in plan.log:
        print(f"  [{pass_name}] {subject}: {decision}\n      -> {reason}")

    print("\n=== template components after specialization ===")
    for name, comp in sorted(plan.template_summary["components"].items()):
        state = "ON " if comp["enabled"] else "OFF"
        print(f"  {state} {name:18s} {comp['params']}")

    # 3. lower + train a few steps
    trainer = Trainer(plan, None,
                      TrainerConfig(n_steps=10, ckpt_every=0, log_every=2,
                                    ckpt_dir=str(ROOT / "build" /
                                                 "quickstart")),
                      opt_cfg=OptConfig(total_steps=10), arch=arch,
                      shape=shape, device=args.device)
    state, metrics = trainer.fit()
    print(f"\nfinal loss: {float(metrics['loss']):.4f}")


if __name__ == "__main__":
    main()
