"""End-to-end driver of the PyTorch port: train a ~100M-param dense LM.

The port's twin of ``examples/train_tiny_lm.py``, through the real
pipeline: the specialization flow (``h100-sxm``) -> the lowered train
step (microbatches and remat per plan) -> the prefetching data pipeline
-> checkpoints.  8 layers x d512 x ff2048, 8 / 4 heads of 64 (a GQA
group of 2, which the card's kernels are built for), a 32k vocab,
256 tokens x 8 a step.  ``--device`` defaults to ``cuda``.  The last
line says the first and last losses.

Run:  PYTHONPATH=src python examples/torch_train_tiny_lm.py [--steps 300] [--device cpu]
"""

import argparse
import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import ShapeConfig, get_arch  # noqa: E402
from repro_torch.core.pipeline import specialize  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=str(ROOT / "build" / "tiny_lm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # ~100M params: 8 layers x d512 x ff2048, 32k vocab (qwen3 family)
    arch = dataclasses.replace(
        get_arch("qwen3-8b"),
        n_layers=8, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
        d_ff=2048, vocab_size=32768)
    print(f"params: {arch.param_count()/1e6:.1f}M")
    shape = ShapeConfig("tiny", "train", seq_len=256, global_batch=8)
    plan = specialize(arch, shape, mesh_axes=("data", "model"),
                      mesh_shape=(1, 1), target="h100-sxm")
    trainer = Trainer(
        plan, None,
        TrainerConfig(n_steps=args.steps, ckpt_every=100,
                      ckpt_dir=args.ckpt_dir, log_every=20),
        opt_cfg=OptConfig(peak_lr=1e-3, warmup_steps=50,
                          total_steps=args.steps),
        arch=arch, shape=shape, device=args.device)
    t0 = time.time()
    state, metrics = trainer.fit()
    dt = time.time() - t0
    tokens = args.steps * shape.tokens
    print(f"\n{args.steps} steps, {tokens/1e6:.1f}M tokens in {dt:.0f}s "
          f"({tokens/dt/1e3:.1f}k tok/s) - final loss "
          f"{float(metrics['loss']):.4f} "
          f"(first {trainer.history[0]['loss']:.4f})")


if __name__ == "__main__":
    main()
