#!/usr/bin/env python3
"""Which collectives gloo carries for CUDA tensors, two ranks on one card.

The port's mesh code runs its collectives through ``torch.distributed``
on whatever backend the process group has.  On a machine with one card,
NCCL refuses two ranks on the same device, so the only backend two
ranks on ``cuda:0`` can share is gloo, and PyTorch documents gloo's CUDA
support for ``all_reduce`` and ``broadcast`` only.  This script spawns
two ranks on ``cuda:0`` over gloo (a ``file://`` rendezvous in a
temporary directory), runs each collective the port uses on CUDA
tensors, checks the values, and prints one JSON object: for each
operation ``"ok"`` or the error it raised.  It also records whether a
``DeviceMesh("cuda", ...)`` builds on that group, and whether NCCL
accepts the two ranks.  The training step's collectives are probed
too: ``reduce_scatter_tensor`` (FSDP's gradient, else run as an
all-reduce and a slice), ``all_reduce`` of fp32 and bf16 (gradients,
partial products), of fp32 by MAX (the block amax, the logits' row
max) and of int32 by SUM and MAX (the compressed wire's codes: gloo
has no int16 reduction, ``all_reduce_int16`` records its refusal), and
``all_gather`` of bf16 and int32 (the FSDP gather, the fallbacks).

Run:  python3 scripts/gloo_cuda_probe.py [--out FILE]
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import tempfile

#: in the order they run: ``batch_isend_irecv`` last, since its failure
#: on CUDA tensors closes the ranks' connection for every later one
OPS = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
       "all_to_all_single", "device_mesh", "reduce_scatter_tensor",
       "all_reduce_bf16", "all_reduce_fp32_max", "all_reduce_int32_sum",
       "all_reduce_int32_max", "all_reduce_int16", "all_gather_bf16",
       "all_gather_int32", "batch_isend_irecv")


def _try(fn) -> str:
    try:
        return "ok" if fn() else "wrong value"
    except Exception as e:                     # the probe's finding
        return f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


def _rank(rank: int, world: int, tmp: str, backend: str) -> None:
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    out = {}
    try:
        dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=60))
    except Exception as e:
        out["init"] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
        _save(tmp, rank, out)
        return
    out["init"] = "ok"
    peer = 1 - rank

    def all_reduce():
        x = torch.full((4,), float(rank + 1), device=dev)
        dist.all_reduce(x)
        return bool((x == 3).all())

    def broadcast():
        x = torch.full((4,), float(rank), device=dev)
        dist.broadcast(x, src=1)
        return bool((x == 1).all())

    def all_gather():
        parts = [torch.empty(3, device=dev) for _ in range(world)]
        dist.all_gather(parts, torch.full((3,), float(rank), device=dev))
        return all(bool((p == i).all()) for i, p in enumerate(parts))

    def all_gather_into_tensor():
        o = torch.empty(3 * world, device=dev)
        dist.all_gather_into_tensor(o, torch.full((3,), float(rank),
                                                  device=dev))
        return bool((o.view(world, 3)[:, 0] ==
                     torch.arange(world, device=dev)).all())

    def all_to_all_single():
        x = torch.arange(world, device=dev, dtype=torch.float32) + 10 * rank
        o = torch.empty_like(x)
        dist.all_to_all_single(o, x)
        return bool((o == torch.arange(world, device=dev) * 10 + rank).all())

    def batch_isend_irecv():
        x = torch.full((5,), float(rank), device=dev)
        got = torch.empty_like(x)
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer),
                                       dist.P2POp(dist.irecv, got, peer)])
        for r in reqs:
            r.wait()
        return bool((got == peer).all())

    def device_mesh():
        from torch.distributed.device_mesh import init_device_mesh
        m = init_device_mesh("cuda", (1, world),
                             mesh_dim_names=("data", "model"))
        x = torch.full((2,), float(rank + 1), device=dev)
        dist.all_reduce(x, group=m.get_group("model"))
        return bool((x == 3).all())

    def reduce_scatter_tensor():
        x = torch.arange(2 * world, device=dev, dtype=torch.float32) * \
            (rank + 1)
        o = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(o, x)
        want = torch.arange(2 * world, device=dev,
                            dtype=torch.float32)[2 * rank:2 * rank + 2] * 3
        return bool((o == want).all())

    def reduced(dtype, op, want):
        x = torch.full((4,), rank + 1, device=dev, dtype=dtype)
        dist.all_reduce(x, op=op)
        return bool((x == want).all())

    def gathered(dtype):
        parts = [torch.empty(3, device=dev, dtype=dtype)
                 for _ in range(world)]
        dist.all_gather(parts, torch.full((3,), rank, device=dev,
                                          dtype=dtype))
        return all(bool((p == i).all()) for i, p in enumerate(parts))

    R = dist.ReduceOp
    fns = dict(all_reduce=all_reduce, broadcast=broadcast,
               all_gather=all_gather,
               all_gather_into_tensor=all_gather_into_tensor,
               all_to_all_single=all_to_all_single,
               batch_isend_irecv=batch_isend_irecv, device_mesh=device_mesh,
               reduce_scatter_tensor=reduce_scatter_tensor,
               all_reduce_bf16=lambda: reduced(torch.bfloat16, R.SUM, 3),
               all_reduce_fp32_max=lambda: reduced(torch.float32, R.MAX, 2),
               all_reduce_int32_sum=lambda: reduced(torch.int32, R.SUM, 3),
               all_reduce_int32_max=lambda: reduced(torch.int32, R.MAX, 2),
               all_reduce_int16=lambda: reduced(torch.int16, R.SUM, 3),
               all_gather_bf16=lambda: gathered(torch.bfloat16),
               all_gather_int32=lambda: gathered(torch.int32))
    for name in OPS:
        out[name] = _try(fns[name])
        if backend == "nccl":
            break
    torch.cuda.synchronize()
    _save(tmp, rank, out)
    dist.destroy_process_group()


def _save(tmp: str, rank: int, out: dict) -> None:
    with open(os.path.join(tmp, f"r{rank}.json"), "w") as f:
        json.dump(out, f)


def probe(backend: str) -> dict:
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank, args=(r, 2, tmp, backend))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=180)
            if p.is_alive():
                p.kill()
        res = {}
        for r in range(2):
            path = os.path.join(tmp, f"r{r}.json")
            res[f"rank{r}"] = (json.load(open(path)) if os.path.exists(path)
                               else {"exit": procs[r].exitcode})
    return res


def carried(result: dict) -> dict:
    """``{op: True/False}``: an op counts as carried when both ranks
    report ``ok``."""
    g = result["gloo"]
    return {op: all(g[f"rank{r}"].get(op) == "ok" for r in range(2))
            for op in OPS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    result = {"torch": torch.__version__, "gloo": probe("gloo"),
              "nccl_two_ranks_one_card": probe("nccl")}
    result["carried"] = carried(result)
    text = json.dumps(result)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
