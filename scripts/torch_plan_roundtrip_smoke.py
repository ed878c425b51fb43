"""Plan-artifact round trip of the PyTorch port: specialize -> persist ->
reload by hash in a fresh process -> ``ServeEngine.from_plan`` decodes a
token.

The port's twin of ``scripts/plan_roundtrip_smoke.py``: if a field stops
surviving the disk round trip (hash drift across processes) or the
engine can no longer be built from a reloaded artifact, this fails.  The
model is reduced qwen3-8b with random weights from seed 0 (on a CUDA
device at its published head_dim and GQA group, the widths the card's
kernels are built for); the plan is ``h100-sxm``'s.  ``--device``
defaults to ``cuda``.

Run:  PYTHONPATH=src python scripts/torch_plan_roundtrip_smoke.py [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def smoke_arch(device: str):
    """Reduced qwen3-8b (on the card at its published head_dim and GQA
    group)."""
    from repro_torch.configs import get_arch, reduced_on
    return reduced_on(get_arch("qwen3-8b"), device)


def phase1(plan_dir: str, device: str) -> str:
    """Specialize and persist the plan; return its content hash."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import specialize
    shape = ShapeConfig("smoke_dec", "decode", 48, 2)
    plan = specialize(smoke_arch(device), shape,
                      mesh_axes=("data", "model"), mesh_shape=(1, 1),
                      plan_dir=plan_dir)
    return plan.content_hash()


def phase2(plan_dir: str, expect_hash: str, device: str) -> None:
    """Fresh process: reload by hash, build the engine, decode a token."""
    import numpy as np
    import torch

    from repro_torch.core import get_store
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine

    store = get_store(plan_dir)
    plan = store.load(expect_hash)
    assert plan is not None, f"plan {expect_hash} not reloadable"
    assert plan.content_hash() == expect_hash, "hash drift across processes"

    arch = smoke_arch(device)
    gen = torch.Generator(device).manual_seed(0)
    params = init_params(arch, gen, *plan.padded_sizes())
    eng = ServeEngine.from_plan(plan, params, arch=arch)
    assert eng.max_len == 48 and eng.max_batch == 2, \
        (eng.max_len, eng.max_batch)    # batching limits came from the plan
    eng.submit(np.arange(8, dtype=np.int32) % arch.vocab_size,
               max_new_tokens=1)
    done = eng.run_until_idle(max_ticks=4)
    assert done and len(done[0].out_tokens) >= 1, "engine produced no token"
    print(f"plan round-trip smoke OK: {expect_hash[:12]} "
          f"-> {len(done)} request(s), token {done[0].out_tokens[0]} "
          f"({eng.decode_path})")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--phase2", default="",
                    help="(internal) the hash to reload in this process")
    args = ap.parse_args(argv)
    import torch
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("torch_plan_roundtrip_smoke: no card visible; "
                         "pass --device cpu")
    if args.phase2:
        phase2(os.environ["REPRO_PLAN_DIR"], args.phase2, args.device)
        return
    with tempfile.TemporaryDirectory(prefix="repro_torch_plan_") as plan_dir:
        h = phase1(plan_dir, args.device)
        env = {**os.environ, "REPRO_PLAN_DIR": plan_dir,
               "PYTHONPATH": str(ROOT / "src")}
        subprocess.run([sys.executable, __file__, "--device", args.device,
                        "--phase2", h], check=True, env=env, timeout=300)


if __name__ == "__main__":
    main()
