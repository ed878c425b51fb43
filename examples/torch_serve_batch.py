"""Serve a small model with batched requests on the PyTorch port
(continuous batching).

The port's twin of ``examples/serve_batch.py``: the engine is built
from the frozen plan artifact the specialization flow produced
(``h100-sxm``), the same artifact a deployment reloads from the
content-addressed plan store.  Reduced qwen3-8b with random weights
from seed 0 (on a CUDA device at its published head_dim and GQA group,
the widths the card's kernels are built for).  ``--device`` defaults to
``cuda``.

Run:  PYTHONPATH=src python examples/torch_serve_batch.py [--device cpu]
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import ShapeConfig, get_arch, reduced_on  # noqa: E402
from repro_torch.core import specialize  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    arch = reduced_on(get_arch("qwen3-8b"), args.device)
    plan = specialize(arch, ShapeConfig("serve_demo", "decode", 128, 4),
                      mesh_axes=("data", "model"), mesh_shape=(1, 1),
                      target="h100-sxm")
    print(f"plan {plan.content_hash()[:12]} "
          f"(decode_impl={plan.estimates.get('decode_impl', 'xla')})")
    gen = torch.Generator(args.device).manual_seed(0)
    params = init_params(arch, gen, *plan.padded_sizes())
    engine = ServeEngine.from_plan(plan, params, arch=arch)

    rng = np.random.default_rng(0)
    t0 = time.time()
    for i in range(10):
        plen = int(rng.integers(8, 64))
        engine.submit(rng.integers(0, arch.vocab_size, (plen,)),
                      max_new_tokens=12,
                      temperature=0.0 if i % 2 == 0 else 0.8)
    done = engine.run_until_idle()
    dt = time.time() - t0
    toks = sum(len(r.out_tokens) for r in done)
    print(f"served {len(done)} requests / {toks} tokens in {dt:.1f}s "
          f"via {engine.decode_path}")
    ttfts = [(r.t_first - r.t_submit) * 1e3 for r in done]
    print(f"ttft p50={np.percentile(ttfts, 50):.0f}ms "
          f"p95={np.percentile(ttfts, 95):.0f}ms")
    for r in done[:4]:
        print(f"  rid={r.rid:2d} prompt={len(r.prompt):3d} tok "
              f"-> {r.out_tokens}")


if __name__ == "__main__":
    main()
