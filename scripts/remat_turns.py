"""Time full-width qwen3-8b's train step under two remat policies, in turns.

Run from the repository root on a machine with an NVIDIA card:

    python3 scripts/remat_turns.py

Specializes the ``h100-sxm`` plan for all 36 layers at
``ShapeConfig("train_2k", "train", 2048, 1)``, makes one state from seed
0, and lowers one ``Trainer`` per policy of :data:`POLICIES` (from a
copy of the plan with that ``comm.remat_policy``).  Each of
:data:`ROUNDS` rounds takes the policies in turns, forwards then
backwards (a, b, b, a), each turn :data:`STEPS` steps on the same state,
and prints the turn's median step time over its steps after the first
and the peak allocated memory, then one JSON line with the plan's remat
decision and the card's name and power limit.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
POLICIES = ("full", "dots_saveable")
ROUNDS = 3
STEPS = 4


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("remat_turns: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core import specialize
    from repro_torch.train import Trainer, TrainerConfig

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    arch = get_arch("qwen3-8b")
    shape = ShapeConfig("train_2k", "train", 2048, 1)
    plan = specialize(arch, shape, mesh_shape=(1, 1), target="h100-sxm",
                      cache=False)
    decision = [e for e in plan.log if e[:2] == ("communication", "remat")]
    trainers = {}
    for policy in POLICIES:
        forced = dataclasses.replace(plan, comm=dataclasses.replace(
            plan.comm, remat_policy=policy))
        trainers[policy] = Trainer(forced, None, TrainerConfig(
            ckpt_every=0, log_every=10 ** 9,
            ckpt_dir=str(ROOT / "build" / "ckpt_remat_turns")),
            arch=arch, shape=shape, device=dev)
    state = trainers[POLICIES[0]].init_state(0)
    turns = {p: [] for p in POLICIES}
    step = 0
    for _ in range(ROUNDS):
        for policy in POLICIES + POLICIES[::-1]:
            tr = trainers[policy]
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            tr.history.clear()
            state, _ = tr.fit(state, n_steps=step + STEPS, start_step=step)
            step += STEPS
            dts = sorted(h["dt_s"] * 1e3 for h in tr.history[1:])
            peak = torch.cuda.max_memory_allocated()
            turns[policy].append({"ms": dts[len(dts) // 2], "peak": peak})
            print(f"remat_turns {policy}: median step {dts[len(dts) // 2]:.1f}"
                  f" ms (steps {dts}), peak {peak / 2**30:.2f} GiB at "
                  f"{arch.n_layers} layers [{card}]", flush=True)
    print(json.dumps({"card": card, "n_layers": arch.n_layers,
                      "plan_remat": plan.comm.remat_policy,
                      "decision": decision, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
