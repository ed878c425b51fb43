#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA card.

Drives the port's main paths — ``specialize(target="h100-sxm")`` ->
``ServeEngine.from_plan`` -> bucketed prefill -> decode -> tokens — for
full-width, full-depth qwen3-8b (paged-KV decode), mamba2-2.7b (SSD
prefill, recurrent decode), deepseek-coder-33b (a GQA group of 7, grant
admission and the preemption ladder), hymba-1.5b (attention at head_dim
64 and a GQA group of 5, global and through a 1024-token window, beside
an SSD mixer in every layer), minitron-8b (a squared-ReLU FFN),
granite-moe-1b-a400m (32 experts top-8 in every layer, both MoE paths,
attention at head_dim 64 and a GQA group of 2) and llama4-maverick's
[dense, MoE] super-block at full width (128 experts top-1 beside a
shared expert, a GQA group of 5 at head_dim 128) and qwen2-vl-72b at
full width cut to 16 layers (M-RoPE, a GQA group of 8), random weights
from a seed, and holds each of the paths' hand-written
kernels against its plain PyTorch version on the card.  It also drives
the training path — ``specialize(target="h100-sxm")`` ->
``lower_train_step`` -> ``Trainer.fit`` — for full-width qwen3-8b,
granite-moe-1b-a400m (its router's aux loss in the loss), mamba2-2.7b,
hymba-1.5b, qwen2-vl-72b (patch embeddings and M-RoPE positions) and
hubert-xlarge (a non-causal encoder at head_dim 80, frames and an audio
mask), each at the depth and remat its ``h100-sxm`` train plan admits
(every layer when the plan's step-peak estimate fits the card), through
the flash and SSD-scan forward and backward kernels.

Phases (any failure exits non-zero before the last line):

1. device: ``nvidia-smi`` name and power limit, the kernels' build
   (``nvcc`` for ``sm_90a``, one process per source, all at once), each
   kernel's registers and spills from ``ptxas -v``, and the count of ``HGMMA``
   (wgmma) and ``UTMALDG`` (TMA load) instructions in each library's SASS
   (``cuobjdump --dump-sass``): the flash, flash backward and matmul
   libraries must have both;
2. kernels: each kernel against its plain version at its path's widths
   (attention: 32 q heads, 8 kv heads, head_dim 128, bf16; SSD scan: 80
   heads of 64, state 128, one group, chunk 256, fp32; tiled matmul:
   every tile it is built for, bf16 and fp32, ragged shapes; fp32 also
   against fp64, at mamba2's out_proj shapes with a TF32 control and a
   bitwise repeat), with planted
   faults that must fail the same check, then its time, the plain
   version's, one library call's where one exists (a yardstick the port
   never calls) and the bound (bytes at 3.35 TB/s or operations at the
   data-sheet rate of the kernel's arithmetic, whichever is larger).
   Flash is timed at the four 2048-token prefill buckets (B=1 S=2048 to
   B=8 S=256) and, like the matmul phase, in turns with its library call
   (five rounds, medians), with the host time to encode its tensor maps;
   paged and dense decode in turns with masked SDPA, and the SSD scan in
   turns, each with its grid (CTAs, launches per call);
   Flash is also held with a query block at an offset (a prompt's tail
   over a resident prefix), beside its planted fault (the offset
   ignored), and timed beside the full-length launch of the same rows.
   Flash (whole and at an offset) and decode (paged and dense) are held
   and timed again at deepseek-coder-33b's 56 / 8 heads (G = 7), with
   each flash CTA's boundary rows checked on their own, and at hymba's
   25 / 5 heads of 64 (G = 5), whole, through its 1024 window and at an
   offset, beside planted faults (a dropped tile, pad rows written over
   the next CTA's first position, the window or the offset ignored, a
   swapped table entry, a dropped split); the SSD scan again at hymba's
   50 heads of 64, state 16, and at both widths against an fp64 plain
   version on ten draws; flash (whole and at an offset) and decode
   (paged and dense) again at granite's 16 / 8 heads of 64 and llama4's
   40 / 8 heads of 128, on a generator of their own, beside the same
   planted faults (G = 2 fills its flash tile: no pad row to plant);
   flash and decode at qwen2-vl's 64 / 8 heads of 128 (G = 8, its own
   generator), flash ``causal=False`` at hubert's 16 heads of 80 (the
   kernel pads the rows to 128 columns) and at 32 / 8 heads of 128, B=1
   S=2048, beside a planted fault that drops the upper triangle;
   the flash backward (dq, dk, dv) at the train shape (B=1 S=2048,
   32 / 8 heads of 128, causal), at B=2 S=1024, at hymba's 25 / 5
   heads of 64 through a 1024 window, at granite's 16 / 8 heads of
   64, at qwen2-vl's 64 / 8 of 128 and at hubert's 16 / 16 of 80
   non-causal, row by row against the plain backward beside two planted
   faults (a Q tile dropped from each dK/dV job; one head of the group
   summed, or at G = 1 the upper triangle dropped),
   timed in turns with SDPA's
   backward, with the forward kernel's time with and without the
   log-sum-exp it writes for the backward; the SSD scan's backward at
   mamba2's and hymba's widths (S = 2048, chunk 256) and a reduced width
   with initial and final state gradients, every gradient row against
   the plain backward in fp64 beside two planted faults (a skipped tile,
   no carry between chunks), timed in turns with torch autograd of the
   plain forward, with each of its six passes' device time;
   the flash forward and backward masked by positions (their positions
   variant, at qwen2-vl's 64 / 8 heads of 128, prompts laid out as
   ``get_rope_index`` lays them out: an image's patches share one
   temporal id), row by row against the plain versions with the
   positions (whole, a tail at an offset, permuted positions) beside the
   planted fault that masks by row index, positions equal to the index
   bitwise the index path, timed in turns with SDPA given the boolean
   mask and with the index path, bounds over the live pairs;
2b. K8, the decode kernels' per-shard partial (``PARTIAL`` mode, what
   each rank of a mesh computes over its rows in the sharded flash
   decode): at qwen3-8b's 32 / 8 heads of 128, deepseek-coder-33b's
   G = 7 and hymba's 25 / 5 of 64 through its 1024 window, B = 8, a
   dense cache of 2048 rows and a pool of 64 blocks of 256 with lengths
   1-2048, split into 2, 4 and 8 shards: every shard's ``(m, l, acc)``
   against the plain partial (the live pattern exactly, ``acc / l``
   row by row), the shards folded as the flat and the ring combines
   fold them against the unsharded kernel, beside three planted faults
   (a shard left out, the slice's start off by one block, an unowned
   block counted as owned), each shard timed in turns with the
   unsharded kernel beside the bytes of its live rows;
3. qwen3-8b serve, paged: the plan as frozen (paged pool, prefix reuse,
   512 host blocks), 16 requests; both tiers whole after the engine's
   block cache is dropped;
4. qwen3-8b serve, dense: the same weights under a dense-residency plan;
5. qwen3-8b shared prefixes: 16 requests, 12 behind one 1,024-token
   system prompt, on the plan as frozen and on a control with prefix
   reuse and the host tier off: fewer prefill calls, rides, the tail
   path's logits and tokens against the control's, then a spill of
   every cold block and a hit that promotes the system prompt back
   bitwise;
6. qwen3-8b checks: a full-width consistency check (decode-step logits
   against the flash prefill of the same tokens, under both decode
   kernels); then, on the same weights, disaggregated prefill (6b):
   the unmodified decode 4096 x 8 plan (``kv_prefill_mode: disagg``,
   chunk 512) with one spawned prefill worker (the weights mapped by
   CUDA IPC), the handshake refusing a wrong plan hash, 8 requests of
   1,500-4,000 prompt tokens against an inline control (tokens by the
   margin rule, the journaled K/V rows rms-relative beside their noise
   floor and a wrong-token control, TTFT and tok/s), the worker
   SIGKILLed mid-prompt and the run resumed from the journal bitwise the
   un-killed run, and ``max_restarts=0`` degrading to inline prefill;
   then a small model on the card against the CPU;
7. mamba2-2.7b serve (qwen's weights freed first): 16 requests, 64
   SSD-scan launches per prefill call;
8. mamba2-2.7b checks: the full-depth consistency check (prefill + one
   recurrent decode step against the kernel's prefill of the same
   tokens), a park with state (``preempt(rid)`` mid-decode: no prefill
   call on resume, tokens identical to the untouched run) and a small
   mamba2 on the card against the CPU;
9. deepseek-coder-33b (every earlier weight freed): the grant plan as
   frozen (8 pool blocks, 64 host blocks) serves 12 requests through the
   grant -> migrate -> preempt ladder, parks with state and resumes by
   promote, against a reserve control on the same weights; then its
   full-depth consistency check at G = 7;
10. hymba-1.5b (every earlier weight freed): ``from_plan(plan, params)``
   with no keyword serves 16 requests whose prompts cross the window (32
   flash, 32 SSD-scan launches a prefill call, 32 paged-decode launches
   a tick); 4 requests behind one 1,024-token prompt alias its blocks
   but are prefilled whole (no ride, no tail prefill), their aliased K/V
   rows and first decode step held against a reuse-off control; a park
   with state (blocks and SSM rows) resumes to the untouched run's
   tokens; the full-depth consistency check past the window;
11. minitron-8b (hymba's weights freed): the paged phase's 16 requests
   from ``from_plan(plan, params)``, then its full-depth consistency
   check;
12. granite-moe-1b-a400m (minitron's weights freed): the decode 2048 x 8
   plan (``dense_einsum``) serves 16 requests (24 flash launches a
   prefill call, 24 paged-decode launches a tick), 4 requests behind one
   1,024-token prompt against reuse off, the full-depth consistency
   check; the 1024 x 8 plan (``gshard_einsum``) on the same weights
   serves 16 requests with each prefill call's routing drops printed
   (counted here from ``moe.route``'s output), and a prefill batch is
   held under ``gshard_einsum`` against ``dense_einsum`` on its rows
   with no drop;
13. llama4-maverick-400b-a17b cut to one super-block (the only cut,
   37.4 GB of weights, granite's freed): its 2048 x 8 plan
   (``gshard_einsum``, the shared expert) serves 8 requests (2 flash, 2
   paged-decode launches a call / tick), drops printed, then the
   consistency check;
14. reduced granite (both paths) and reduced llama4 on the card against
   the CPU: logits, and ``route`` re-run on the card on the CPU's inputs
   with identical slots;
15. the plan-driven matmul path: the serve phases' ``h100-sxm`` plans
   stored, reloaded by hash prefix and shown with the plan-store CLI
   (``launch.plan show --log``), then ``kernels.ops.matmul`` on each
   plan's tiles at five full-width GEMM shapes of the two models, each
   held against the plain version row by row beside two planted faults,
   and timed beside its bound, the plain version and ``torch.matmul``.
   No serving path launches this kernel: the models' projections stay
   ``torch.matmul``;
16. training (every earlier weight freed): full-width qwen3-8b at the
   largest depth up to 36 layers whose unmodified ``h100-sxm`` plan for a
   2048 x 1 train shape says the eager step fits (bf16 moments, no master
   copy: stochastic rounding; the remat the plan picks from its step-peak
   estimate) through ``Trainer.fit`` for 6 steps: the last layer's
   gradients and the step-0 loss through the kernels against
   ``flash_attention_plain`` under autograd, both under the plan's remat
   (noise floor, wrong-target and ``drop_tile`` controls), L forward
   flash calls a step (2 L under remat, which runs each layer's forward
   again in the backward) and L backward calls,
   every loss and grad norm finite, every bf16 parameter element of the
   last step on one of the two bf16 neighbours of its fp32 update, the
   measured peak memory at or under the plan's step-peak estimate and
   the estimate at most 15% above it;
17. a small qwen3 (head_dim 128, master weights) trained 4 steps on the
   card against the CPU (losses, grad norms, step-0 gradients), then
   saved at step 2 and resumed by a fresh trainer: steps 3-4 and the
   final state bitwise equal to the uninterrupted run; then the same
   small model's step under ``StepGuard`` (:func:`guarded_run`): a
   RuntimeError injected at step 3, the step-2 checkpoint restored and
   replayed, the final state bitwise the never-failed run's;
18. training granite-moe-1b-a400m (``dense_einsum``, no remat),
   mamba2-2.7b (remat ``full``: 2 SSD-scan forwards and 1 backward a
   layer a step) and hymba-1.5b (flash and SSD scan in every layer), each
   at full width and depth from its unmodified 2048 x 1 plan, every
   earlier weight freed first: phase 16's checks (the gradient check's
   controls: the flash backward's dropped tile, the SSD backward's
   skipped tile), launches a step as the plan's remat implies, the
   measured peak within [1, 1.15] of the estimate;
19. reduced mamba2 trained 4 steps of 1024 x 2 on the card against the
   CPU and resumed, as phase 17;
20. qwen2-vl-72b at full width cut to 16 of 80 layers (33.1 GB, every
   earlier weight freed): its decode 2048 x 8 plan serves 16 token
   requests (16 flash launches a prefill call, 16 paged-decode launches
   a tick), the full-depth consistency check, and the M-RoPE check (a
   prefill of patch embeddings with a patch grid in the height and width
   streams, the kernels against the plain attention, beside a control
   with the three streams collapsed that must differ; and again with
   repeated temporal ids, through the positions variant in every layer,
   beside the positions-ignored control);
21. qwen2-vl-72b trained at full width at the largest depth its
   unmodified 2048 x 1 train plan admits, on the synthetic source's
   patch embeddings and positions: phase 16's checks; the gradient
   check again on a batch with two images' repeated temporal ids (the
   positions variant forward and backward, its controls); after the
   fit, one more step of the trainer's step function on such a batch,
   whose launches of the positions variant are the kernels line's;
22. hubert-xlarge trained at full width and depth (48 layers) from its
   own plan on frames, targets and the audio mask: phase 16's checks,
   48 non-causal flash forwards at head_dim 80 a step (96 under remat)
   and 48 backwards;
23. a small qwen2-vl (published head_dim and M-RoPE sections) and a
   small hubert (head_dim 80) trained on the card against the CPU and
   resumed, as phase 17;
24. two ranks on the one card over gloo (``torch.multiprocessing``
   spawn; NCCL refuses two ranks on one card): the sharded flash decode
   (``flash_decode`` and ``flash_decode_paged``, flat combine) at
   qwen3-8b's widths with K8 on each rank against the unsharded kernel,
   then full-width qwen3-8b served by ``ServeEngine.from_plan(mesh=)``
   on its (1, 2) tensor-parallel plan, each rank holding half the
   weights, 8 requests against the one-rank engine under the margin
   rule (what gloo carries for CUDA tensors is
   ``scripts/gloo_cuda_probe.py``'s finding, :data:`GLOO_CUDA`: the ring
   combine's neighbour sends are not carried, and wait for a machine
   with more than one card);
24b. two ranks training on the one card over gloo, each held to 0.46
   of it (:func:`mesh_train_phase`): full-width qwen3-8b at the largest
   depth whose per-rank step-peak estimates fit 0.44 of the card, 2048 x
   2, through ``Trainer(plan, mesh).fit``: the (1, 2) tensor-parallel
   plan, then the (2, 1) plan with the int8 + EF gradient wire and the
   same plan without it, each against a one-rank run of the same plan
   (losses, grad norms, the last layer's gradients with a wrong-target
   control and ``copy_in`` without its backward all-reduce, the on / off
   step-0 losses bitwise, the wire's identity on one leaf, the replicas'
   checksums, each rank's peak against its estimate, one flash forward
   and backward a layer a step on every rank);
24c. SSM and hybrid archs on two ranks of the one card over gloo
   (:func:`ssm_mesh_phase`): (a) full-width, full-depth mamba2-2.7b
   served from its (1, 2) ``h100-sxm`` decode plan (the mixer's heads,
   conv channels and ``in_proj`` columns split over ``model``), each
   rank holding about half the weights, ``ssd_scan`` launched once a
   layer a prefill call on each rank's 40 heads; (b) full-width,
   full-depth hymba-1.5b from its (1, 2) plan (heads 26 / 13 padded,
   the paged pool split over ``model``): the engine's
   ``shard_map_flash`` path with K8 (``paged_decode_partial``) counted
   inside the engine; both against the one-rank engine drawn at the
   plan's padded sizes under the full-depth margin rule; (c) hymba
   trained on its (1, 2) ``megatron_tp`` plan at the largest depth
   whose per-rank estimate fits 0.44 of the card: losses, grad norms,
   each rank's peak against its estimate, the SSD forward and backward
   launches; at two layers, the last layer's SSM gradients against one
   rank with three planted controls (the regroup's ``copy_in``
   dropped, the gated norm's backward all-reduce dropped, a wrong
   target); (d)
   mamba2 trained on its (1, 2) ``fsdp_dp`` plan at the depth that fits,
   losses against one rank;
24d. the paged plan as frozen on two ranks of the one card over gloo
   (:func:`mesh_tier_phase`): (a) full-width, full-depth qwen3-8b's
   (2, 1) grant plan with its host tier (each rank a whole copy), its
   pool cut to 8 blocks, a burst that walks spill, promote, a park with
   a staged prefetch and the migrate rung between the data shards'
   sub-pools, K8 in every decode tick, against the one-rank engine with
   ``kv_pool_groups=2`` (every counter equal, tokens by the full-depth
   margin rule); (b) the (1, 2) 4096 x 8 plan that writes ``disagg``
   (4 prompts of 1,024-1,600 tokens): one prefill worker owned by rank
   0 on the whole weights it gathers from the ranks' pieces, SIGKILLed
   mid-flight and resumed on both ranks in the same tick, its chunks
   broadcast to both ranks as host tensors, tokens against the inline
   mesh engine's by the margin rule;
24g. the tools (:func:`tools_phase`): the dry run
   (``repro_torch.launch.dryrun``: fake tensors, nothing launched) of
   phase 3's qwen3-8b 2048 x 8 paged decode plan, one tick, and of phase
   16's 2048 x 1 train step, each kernel entry's count held to the
   launches those phases counted a tick and a step, its peak of live
   bytes and modelled step time printed beside the measured ones; and,
   in processes of their own started first, the plan round trip
   (``scripts/torch_plan_roundtrip_smoke.py``), the serve smoke's
   ``--chaos`` and ``--disagg`` modes (``scripts/torch_serve_smoke.py``)
   and ``examples/torch_train_tiny_lm.py --steps 100`` (every loss
   finite, the last within 0.25 of log(vocab): its random targets admit
   no fall below that);
25. one ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

Every line with a measured number carries the card's ``nvidia-smi``
name and power limit.

Run from the repository root:  python3 chip_smoke.py

``--only flash_bwd`` (``flash_pos``, ``ssd_bwd``, ``matmul_fp32``,
``mesh``, ``mesh_train``, ``ssm_mesh``, ``mesh_tier``) runs the flash
backward's (the positions variant's, the SSD scan backward's, the fp32
tiled matmul's, phases 2b and 24's, phase 24b's, phase 24c's, phase
24d's) check and timings alone
(:func:`flash_bwd_check`, :func:`flash_pos_check`, :func:`ssd_bwd_check`,
:func:`matmul_fp32_check`) and prints its result as one JSON line;
``--only head_dim`` runs K9's checks and timings (phase 2c) and phase
24f, ``--only k9`` phase 2c alone, ``--only tools`` phase 24g alone (its
dry runs held to the counts the plans imply).
``--src DIR`` takes ``repro_torch`` from another ``src`` directory, such
as a parent commit's unpacked with ``git archive``: run two trees in
alternating processes (parent, change, change, parent) to compare them
on one card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
PLAN_DIR = ROOT / "build" / "plans"     # the plan store of this run

PEAK_BF16 = 989e12          # H100 SXM data sheet, dense bf16 tensor core
PEAK_FP32 = 67e12           # H100 SXM data sheet, fp32 on the CUDA cores
PEAK_TF32 = 495e12          # H100 SXM data sheet, dense TF32 tensor core
HBM_BW = 3.35e12            # H100 SXM data sheet, bytes/s
# worst row's rms |kernel - plain| / rms |plain|, a few times the error
# measured on an H100 (flash 4.1e-3: it rounds P to bf16 for its MMAs;
# decode 6.7e-4 paged, 2.8e-4 dense: fp32 P); see row_err.  The SSD scan
# is fp32 on both sides, but for the sums: fp64 in the kernel.
TOL = {"flash_attention": 1e-2, "paged_decode_attention": 3e-3,
       "decode_attention": 3e-3, "ssd_scan": 1e-3,
       "flash_attention_bwd": 2e-2, "ssd_scan_bwd": 1e-3}
# The flash backward's rows (dq, dk, dv) erred at most 5.15e-3 on an H100
# (it rounds P and dS to bf16 for its products); a gradient row that
# vanishes (the first query's dq) is measured against GRAD_FLOOR x its
# tensor's rms (grad_row_err)
GRAD_FLOOR = 0.05
# The SSD scan's rows are also held at TOL against an fp64 plain version,
# on the checked draws and on SSD_DRAWS more: the fp32 plain version errs
# up to ~1e-3 of a row whose terms cancel, so it alone cannot tell a
# kernel at fp32's accuracy from one that is worse.
SSD_DRAWS = 8
# tiled matmul, worst output row rms-relative and max/max: the JAX
# tests' tolerances (bf16: both sides sum exact bf16 products in fp32
# and round once; fp32: the kernel's 3xTF32 products miss fp32's by
# ~2^-22 of a term and its sums run in another order; one TF32 product,
# ~2^-11 of a term, fails it: the TF32-on control)
MM_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
# mamba2-2.7b's fp32 y @ out_proj on a 1000-token prefill (the matmul
# phase's) and on a 2048-token prefill or training forward
MM_FP32_SHAPES = ((1000, 5120, 2560), (2048, 5120, 2560))
# SASS the fp32 matmul's kernels are counted by (tensor-core products, TMA
# loads, CUDA-core fp32 FMAs and adds, shared-memory loads and stores)
MM_SASS_OPS = ("HGMMA", "UTMALDG", "FFMA", "FADD", "LDS", "STS")
LOGIT_TOL = 2e-2            # small model: max |card - cpu| / max |cpu| logits
FULL_TOL = 0.1              # rms-relative logits, full depth (see below)
H, K, D = 32, 8, 128        # qwen3-8b attention widths
H7, K7 = 56, 8              # deepseek-coder-33b: a GQA group of 7
H5, K5, D64 = 25, 5, 64     # hymba-1.5b: a GQA group of 5 at head_dim 64
W5 = 1024                   # hymba-1.5b's sliding window
# (query heads, kv heads, head_dim) of the MoE archs: granite-moe-1b-a400m
# (G = 2 at 64) and llama4-maverick-400b-a17b (G = 5 at 128)
MOE_PAIRS = {"granite": (16, 8, 64), "llama4": (40, 8, 128)}
# (query heads, kv heads, head_dim) of the frontends' archs: qwen2-vl-72b
# (G = 8 at 128) and hubert-xlarge (G = 1 at 80, non-causal)
VLM_PAIR, ENC_PAIR = (64, 8, 128), (16, 16, 80)
QWEN2VL, HUBERT = "qwen2-vl-72b", "hubert-xlarge"
QWEN2VL_SERVE_LAYERS = 16   # 16 x 1.756 GB + 4.98 GB: ~33.1 GB of bf16
GRANITE, LLAMA4 = "granite-moe-1b-a400m", "llama4-maverick-400b-a17b"
SSD_H, SSD_P, SSD_N, SSD_G = 80, 64, 128, 1   # mamba2-2.7b SSD widths
HSSD_H, HSSD_N = 50, 16     # hymba-1.5b SSD widths (P = 64, one group)
# training: full-width qwen3-8b at the depth its plan admits, steps;
# then the MoE, SSM and hybrid archs likewise
TRAIN_STEPS = 6
TRAIN_FAMILIES = ("granite-moe-1b-a400m", "mamba2-2.7b", "hymba-1.5b")
# the plan's step-peak estimate against the card's measured peak: never
# below it, at most this factor above it
STEP_PEAK_OVER = 1.15
# small model, card vs CPU, each bound ten times its worst reading on
# an H100 at 700 W: |loss difference| a step (losses ~6.27; read
# 3.0e-5) and the grad norm's relative difference a step (read 1.75e-4;
# the drop_tile backward moves it by 7.6e-2)
SMALL_TRAIN_TOL = 3e-4
SMALL_GRAD_NORM_TOL = 2e-3
# the train phases' last-layer gradients, kernels against the plain
# versions, rms-relative per tensor, by arch: about three times the
# floor measured on an H100 at 700 W, the kernels against themselves
# under another tile: qwen3-8b 6.2e-2 (the q / k norm scales, sums over
# 2048 x 32 rows that cancel), granite 1.15e-2 outside its MoE FFN
# (attn/wq), mamba2 7.7e-2 and hymba 1.10e-1 (ssm/dt_bias), qwen2-vl
# 4.5e-2 (attn/wq; its bound is 2.7 times that floor: the dropped-tile
# backward moves attn/wv by 0.162, a Q tile being 8 positions at G = 8)
# and hubert 1.0e-2 (attn/wk);
# the wrong-target control sits at 1.18-1.46, at least four times above
# each bound.  An MoE layer's FFN leaves (its norm, router and experts)
# are not held: their gradients pass a routing decision, which bf16 noise
# flips on near-ties (the floor: 9.0e-2 on granite's moe/wo), and the
# router's is mostly the aux loss's, which no control can move (the
# wrong target moves it by 2.0e-2); tests/test_torch_train_families.py
# holds them against the reference in fp32
TRAIN_GRAD_TOL = {"qwen3-8b": 0.2, GRANITE: 0.05, "mamba2-2.7b": 0.2,
                  "hymba-1.5b": 0.3, "qwen2-vl-72b": 0.12,
                  "hubert-xlarge": 0.03}
SEED = 0
CARD = ""                   # nvidia-smi name, power limit (set in main)
SRC_IN_USE = SRC            # the src directory whose repro_torch runs
# prefill buckets of 2048 prompt tokens (the serve phases' power-of-two
# buckets), flash timed at each beside SDPA
FLASH_BUCKETS = ((1, 2048), (2, 1024), (4, 512), (8, 256))
TURNS = 5                   # rounds of kernel / library taken in turns
# the kernels built on wgmma fed by TMA: phase 1 finds both in their SASS
HOPPER_SOURCES = ("flash_attention", "flash_attention_bwd", "tiled_matmul")


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


# ---------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------

def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches, by CUDA
    events after ``warmup`` untimed runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of ``fn()`` with no host gaps between launches:
    ``iters`` calls captured in one CUDA graph, the replay timed by CUDA
    events.  For kernels shorter than their wrapper's host time, where
    ``time_ms`` measures the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sass_by_kernel(sass: str, ops=("DMMA", "F2F.F64.F32")):
    """The count of each of ``ops`` (SASS mnemonics, any suffix) in each
    kernel of a ``cuobjdump --dump-sass`` listing, by kernel name with
    its template arguments."""
    from repro_torch.kernels import build
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(build._demangle(m.group(1)),
                                 dict.fromkeys(ops, 0))
        elif cur is not None:
            for op in ops:
                cur[op] += len(re.findall(r"\b" + re.escape(op) + r"\b",
                                          line))
    return out


def host_us(torch, fn, iters: int = 200) -> float:
    """Host time of one call of ``fn`` (the enqueue, not the device),
    mean of ``iters`` calls after a synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return t


def device_ms_by_kernel(torch, fn, calls: int = 5):
    """Device time of each kernel ``fn`` launches, per call, from
    ``torch.profiler`` (device events only)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return {e.key: e.self_device_time_total / 1e3 / calls
            for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0}


def in_turns(torch, fns, timer=None):
    """Time each of ``fns`` (a dict of name -> callable) in turns,
    :data:`TURNS` rounds of one ``timer`` (default ``time_ms``) each (a,
    b, a, b, ...), so that a card whose clocks or neighbours drift during
    the run moves both alike.  Returns the medians and the rounds, by
    name."""
    timer = timer or time_ms
    rounds = {name: [] for name in fns}
    for _ in range(TURNS):
        for name, fn in fns.items():
            rounds[name].append(timer(torch, fn))
    med = {name: sorted(r)[len(r) // 2] for name, r in rounds.items()}
    return med, rounds


def fmt(ms_list) -> str:
    return "[" + ", ".join(f"{t:.4f}" for t in ms_list) + "]"


def bound(nbytes: float, flops: float, peak: float = PEAK_BF16):
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def work_bound(work, peak: float = PEAK_BF16):
    """:func:`bound` of a kernel module's ``work()``, ``(flops, bytes)``:
    the one count of a call's work the kernel phase's bounds and the
    dry run (``repro_torch.launch.dryrun``) share."""
    flops, nbytes = work
    return bound(nbytes, flops, peak)


def row_err(torch, got, want):
    """``max |got - want|`` and the worst row's rms-relative error, a row
    being one head's ``D`` outputs for one query (one slot in decode).

    Held per row because the outputs' scale varies by ~100x with the
    number of live keys (a one-key row is a raw V row, |.| ~ 3; a
    2048-key row ~ 0.04): one global scale would let a long row's fault
    hide under a short row's magnitude.  The kernels round P to bf16
    before P.V (the decode kernels keep P in fp32) and all round the
    output to bf16, as the plain versions do: at most a few parts in
    1e3 of a row, where a dropped or misread tile of a long row is tens
    of parts in 100 (the phase's planted faults show it)."""
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), "kernel output is not finite")
    e = (got - want).reshape(-1, got.shape[-1])
    w = want.reshape(-1, want.shape[-1])
    rel = e.pow(2).mean(1).sqrt() / w.pow(2).mean(1).sqrt().clamp_min(1e-6)
    return float(e.abs().max()), float(rel.max())


def control(kernel, fault, torch, got, want, factor: float = 1.0):
    """A planted fault must fail the check that the kernel passes, by
    ``factor`` times its tolerance."""
    _, rel = row_err(torch, got, want)
    tol = TOL[kernel]
    log(f"control {kernel} {fault}: worst row rel={rel:.3e} (must exceed "
        f"{factor:g} x tol {tol}) [{CARD}]")
    check(rel > factor * tol, f"control {kernel} {fault} passed the check "
          f"({rel} <= {factor:g} x {tol})")
    return rel


# ---------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------

def kernel_phase(torch, dev):
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    g = torch.Generator(dev).manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    res = {}

    # ---- flash attention: ragged S in 128..2048, causal (prefill) ----
    worst = worst_rel = 0.0
    for S in (128, 700, 1536, 2048):
        q, k, v = rnd(1, S, H, D), rnd(1, S, K, D), rnd(1, S, K, D)
        want = fa.flash_attention_plain(q, k, v, causal=True)
        err, rel = row_err(torch, fa.flash_attention(q, k, v, causal=True),
                           want)
        tol = TOL["flash_attention"]
        log(f"kernel flash_attention S={S}: max_abs_err={err:.3e} "
            f"worst row rel={rel:.3e} (tol {tol}) [{CARD}]")
        check(rel <= tol, f"flash_attention S={S} row rel err {rel} > {tol}")
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
    # planted fault: the longest rows miss their first kv tile (64 keys)
    ctl = control("flash_attention", "drops one kv tile", torch,
                  fa.flash_attention(q, k, v, causal=True, window=S - 64),
                  want)
    # timed: the 2048-token serve buckets, the kernel and SDPA in turns,
    # each held row by row first
    per = []
    for B, S in FLASH_BUCKETS:
        q, k, v = rnd(B, S, H, D), rnd(B, S, K, D), rnd(B, S, K, D)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        err, rel = row_err(torch, fa.flash_attention(q, k, v, causal=True),
                           fa.flash_attention_plain(q, k, v, causal=True))
        tol = TOL["flash_attention"]
        check(rel <= tol, f"flash_attention B={B} S={S} row rel err {rel} "
              f"> {tol}")
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
        med, rounds = in_turns(torch, {
            "kernel": lambda: fa.flash_attention(q, k, v, causal=True),
            "library": lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)})
        b_ms, b_by = work_bound(fa.work(B, S, S, H, K, D))
        log(f"timing flash_attention B={B} S={S}: kernel {med['kernel']:.4f} "
            f"ms, SDPA {med['library']:.4f} ms (medians of {TURNS} turns: "
            f"kernel {fmt(rounds['kernel'])}, SDPA {fmt(rounds['library'])}"
            f"), bound {b_ms:.4f} ms ({b_by}), worst row rel={rel:.3e} "
            f"[{CARD}]")
        per.append(dict(B=B, S=S, ms=med["kernel"], library_ms=med["library"],
                        kernel_turns_ms=rounds["kernel"],
                        library_turns_ms=rounds["library"], bound_ms=b_ms,
                        bound_by=b_by, row_rel_err=rel))
    B, S = 2, 1024                  # the headline: two 1024-token prompts
    q, k, v = rnd(B, S, H, D), rnd(B, S, K, D), rnd(B, S, K, D)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    head = next(p for p in per if (p["B"], p["S"]) == (B, S))
    by_tile = {}
    for rows, bkv in fa.KERNEL_TILES:   # every tile, in turns with SDPA
        bq = rows // (H // K)
        _, rel = row_err(torch, fa.flash_attention(
            q, k, v, causal=True, block_q=bq, block_kv=bkv),
            fa.flash_attention_plain(q, k, v, causal=True))
        check(rel <= TOL["flash_attention"], f"flash_attention tile "
              f"{(rows, bkv)} row rel err {rel}")
        med, _ = in_turns(torch, {
            "kernel": lambda: fa.flash_attention(q, k, v, causal=True,
                                                 block_q=bq, block_kv=bkv),
            "library": lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)})
        by_tile[f"{rows}x{bkv}"] = med
        log(f"timing flash_attention B={B} S={S} tile {rows} rows x {bkv} "
            f"kv: kernel {med['kernel']:.4f} ms, SDPA {med['library']:.4f} "
            f"ms (medians of {TURNS} turns), worst row rel={rel:.3e} "
            f"[{CARD}]")
    plain = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v,
                                                            causal=True),
                    iters=5)
    offset = flash_offset_check(torch, F, fa, rnd)
    worst = max(worst, offset["max_abs_err"])
    worst_rel = max(worst_rel, offset["row_rel_err"])
    rows, bkv = fa.kernel_tiles(H // K)
    enc = build.library("flash_attention").flash_attention_map_encode_us(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), B, S, H, K, D, rows, bkv,
        1000)
    check(enc > 0, f"flash_attention: tensor-map encoder failed ({enc})")
    log(f"host flash_attention: {enc:.3f} us per launch to encode its 3 "
        f"tensor maps (mean of 1000) [{CARD}]")
    res["flash_attention"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:221",
        max_abs_err=worst, row_rel_err=worst_rel, control_row_rel_err=ctl,
        tolerance=TOL["flash_attention"], ms=head["ms"], plain_ms=plain,
        library_ms=head["library_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], map_encode_us=enc, tiles_ms=by_tile,
        offset=offset,
        shape=f"B={B} S={S} H={H} K={K} D={D} causal bf16, tile {rows} "
              f"rows x {bkv} kv; kernel and library: medians of {TURNS} "
              "turns", shapes=per,
        library_call="F.scaled_dot_product_attention(is_causal, enable_gqa)")

    # ---- decode: 8 slots, mixed cache lengths 1..2048 ----
    lens_list = [1, 64, 300, 777, 1024, 1500, 1999, 2048]
    Bd, max_len, bl = len(lens_list), 2048, 256
    lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
    nb = max_len // bl
    need = [-(-n // bl) for n in lens_list]
    N = nb * Bd
    perm = torch.randperm(N, generator=g, device=dev).int()
    tbl = torch.full((Bd, nb), -1, dtype=torch.int32, device=dev)
    at = 0
    for b, n in enumerate(need):          # -1 tails past each slot's blocks
        tbl[b, :n] = perm[at:at + n]
        at += n
    qd = rnd(Bd, H, D)
    kp, vp = rnd(N, bl, K, D), rnd(N, bl, K, D)
    kd, vd = rnd(Bd, max_len, K, D), rnd(Bd, max_len, K, D)

    # the planted faults: the longest slot one tile short, and one of its
    # full blocks swapped for another slot's
    short = lens.clone()
    short[-1] -= bl
    swapped = tbl.clone()
    swapped[-1, 0] = tbl[-2, 0]

    # paged
    want = dec.paged_decode_attention_plain(qd, kp, vp, tbl, cache_len=lens)
    err, rel = row_err(
        torch, dec.paged_decode_attention(qd, kp, vp, tbl, cache_len=lens),
        want)
    tol = TOL["paged_decode_attention"]
    log(f"kernel paged_decode_attention bl={bl} lens={lens_list}: "
        f"max_abs_err={err:.3e} worst row rel={rel:.3e} (tol {tol}) "
        f"[{CARD}]")
    check(rel <= tol, f"paged_decode_attention row rel err {rel} > {tol}")
    ctl = min(control("paged_decode_attention", "one tile short", torch,
                      dec.paged_decode_attention(qd, kp, vp, tbl,
                                                 cache_len=short), want),
              control("paged_decode_attention", "one table entry swapped",
                      torch, dec.paged_decode_attention(
                          qd, kp, vp, swapped, cache_len=lens), want),
              control("paged_decode_attention",
                      "split 0 dropped from the merge", torch,
                      dec.paged_decode_attention(qd, kp, vp, tbl,
                                                 cache_len=lens,
                                                 drop_split=0), want))
    # a freed slot (table row -1, length 1) reads zero rows: zeros out
    free_tbl = tbl.clone()
    free_tbl[0] = -1
    out = dec.paged_decode_attention(qd, kp, vp, free_tbl, cache_len=lens)
    check(float(out[0].float().abs().max()) == 0.0,
          "paged_decode_attention: freed slot output is not zero")
    plain = time_ms(torch, lambda: dec.paged_decode_attention_plain(
        qd, kp, vp, tbl, cache_len=lens), iters=5)
    b_ms, b_by = work_bound(dec.work(Bd, H, K, D, lens_list, block_len=bl))
    res["paged_decode_attention"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:130",
        max_abs_err=err, row_rel_err=rel, control_row_rel_err=ctl,
        tolerance=tol, plain_ms=plain, library_ms=None,
        bound_ms=b_ms, bound_by=b_by,
        shape=f"B={Bd} bl={bl} H={H} K={K} D={D} lens={lens_list} bf16",
        library_call="none takes a block table")

    # dense
    mask = (torch.arange(max_len, device=dev)[None, :]
            < lens[:, None])[:, None, None, :]
    want = dec.decode_attention_plain(qd, kd, vd, cache_len=lens)
    err, rel = row_err(
        torch, dec.decode_attention(qd, kd, vd, cache_len=lens), want)
    tol = TOL["decode_attention"]
    log(f"kernel decode_attention S={max_len} lens={lens_list}: "
        f"max_abs_err={err:.3e} worst row rel={rel:.3e} (tol {tol}) "
        f"[{CARD}]")
    check(rel <= tol, f"decode_attention row rel err {rel} > {tol}")
    ctl = min(control("decode_attention", "one tile short", torch,
                      dec.decode_attention(qd, kd, vd, cache_len=short),
                      want),
              control("decode_attention", "split 0 dropped from the merge",
                      torch, dec.decode_attention(qd, kd, vd, cache_len=lens,
                                                  drop_split=0), want))
    plain = time_ms(torch, lambda: dec.decode_attention_plain(
        qd, kd, vd, cache_len=lens), iters=5)
    # the counters of the in-launch merge are left at zero: repeated
    # launches give the same bits
    outs = [f() for f in (lambda: dec.decode_attention(qd, kd, vd,
                                                       cache_len=lens),) * 3
            + (lambda: dec.paged_decode_attention(qd, kp, vp, tbl,
                                                  cache_len=lens),) * 3]
    torch.cuda.synchronize()
    check(all(torch.equal(outs[0], o) for o in outs[1:3])
          and all(torch.equal(outs[3], o) for o in outs[4:])
          and int(dec._COUNTERS[qd.device].abs().sum()) == 0,
          "decode: back-to-back launches differ or left a counter set")
    splits, rows = dec.decode_split(Bd, K, max_len, dec.DEFAULT_BLOCK_KV)
    live_ctas = K * sum(-(-n // rows) for n in lens_list)
    log(f"grid decode_kernel (paged and dense): {Bd} slots x {K} kv heads x "
        f"{splits} splits of {rows} rows = {Bd * K * splits} CTAs "
        f"({live_ctas} with live rows), 1 launch per call; back-to-back "
        f"launches bitwise equal, counters back at 0 [{CARD}]")
    q4, k4, v4 = qd[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2)
    fns = {
        "paged": lambda: dec.paged_decode_attention(qd, kp, vp, tbl,
                                                    cache_len=lens),
        "dense": lambda: dec.decode_attention(qd, kd, vd, cache_len=lens),
        "library": lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask, enable_gqa=True)}
    # device time (CUDA graph of 20 launches: the kernels are shorter than
    # their wrappers' host time) and eager time (back-to-back launches)
    med, rounds = in_turns(torch, fns, timer=graph_ms)
    eager, _ = in_turns(torch, fns)
    host = {name: host_us(torch, fn) for name, fn in fns.items()}
    log(f"timing decode B={Bd} S={max_len} lens={lens_list}, device (CUDA "
        f"graph): paged {med['paged']:.4f} ms, dense {med['dense']:.4f} ms, "
        f"SDPA (masked) {med['library']:.4f} ms (medians of {TURNS} turns: "
        f"paged {fmt(rounds['paged'])}, dense {fmt(rounds['dense'])}, SDPA "
        f"{fmt(rounds['library'])}); eager back-to-back: paged "
        f"{eager['paged']:.4f}, dense {eager['dense']:.4f}, SDPA "
        f"{eager['library']:.4f} ms; host per call: paged "
        f"{host['paged']:.1f}, dense {host['dense']:.1f}, SDPA "
        f"{host['library']:.1f} us [{CARD}]")
    ms, lib = med["dense"], med["library"]
    grid = dict(splits=splits, split_rows=rows, ctas=Bd * K * splits,
                live_ctas=live_ctas, launches_per_call=1)
    res["paged_decode_attention"].update(
        ms=med["paged"], turns_ms=rounds["paged"], grid=grid,
        eager_ms=eager["paged"], host_us=host["paged"],
        timing="device time: CUDA graph of 20 launches, medians of 5 turns")
    b_ms, b_by = work_bound(dec.work(Bd, H, K, D, lens_list))
    res["decode_attention"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:194",
        max_abs_err=err, row_rel_err=rel, control_row_rel_err=ctl,
        tolerance=tol, ms=ms, plain_ms=plain, turns_ms=rounds["dense"],
        library_turns_ms=rounds["library"], grid=grid,
        eager_ms=eager["dense"], host_us=host["dense"],
        library_eager_ms=eager["library"],
        timing="device time: CUDA graph of 20 launches, medians of 5 turns",
        library_ms=lib, bound_ms=b_ms, bound_by=b_by,
        shape=f"B={Bd} S={max_len} H={H} K={K} D={D} lens={lens_list} bf16; "
              f"kernel and library: medians of {TURNS} turns",
        library_call="F.scaled_dot_product_attention(attn_mask, enable_gqa)")
    for name, r in g7_kernel_check(torch, F, fa, dec, rnd, dev, g).items():
        res[name]["g7"] = r
    for name, r in gqa_kernel_check(torch, F, fa, dec, rnd, dev, g).items():
        res[name]["g5"] = r
    res["ssd_scan"] = ssd_kernel_check(torch, dev, g)
    res["ssd_scan"]["hymba"] = ssd_kernel_check(
        torch, dev, g, H=HSSD_H, N=HSSD_N, name=" hymba")
    mm = {"kernel_check_row_rel_err": matmul_kernel_check(torch, dev, g),
          "fp32": matmul_fp32_check(torch, dev)}
    # the MoE archs' pairs, on a generator of their own: the draws above
    # stay as they were
    gm = torch.Generator(dev).manual_seed(SEED + 19)

    def rnd_moe(*shape):
        return torch.randn(shape, generator=gm, device=dev).to(torch.bfloat16)

    for key, (hq, kv, dh) in MOE_PAIRS.items():
        for name, r in gqa_kernel_check(torch, F, fa, dec, rnd_moe, dev, gm,
                                        Hq=hq, Kv=kv, Dh=dh, W=0).items():
            res[name][key] = r
    for name, rows in frontend_kernel_check(torch, F, fa, dec, dev).items():
        res[name].update(rows)
    res["flash_attention_bwd"] = flash_bwd_check(torch, F, fa, dev)
    pos = flash_pos_check(torch, F, fa, dev)
    for name, src, replaces in (
            ("flash_attention", "flash_attention.cu",
             "src/repro/models/attention.py:41"),
            ("flash_attention_bwd", "flash_attention_bwd.cu",
             "src/repro/models/attention.py:74")):
        res[f"{name}_positions"] = dict(
            pos[name], route="cuda",
            source=f"src/repro_torch/kernels/csrc/{src}", replaces=replaces,
            tolerance=TOL[name],
            launched_by="a step of qwen2-vl-72b's trainer (Trainer"
                        ".step_fn, after its fit) on a batch with two "
                        "images' repeated temporal ids")
    res["ssd_scan_bwd"] = ssd_bwd_check(torch, dev)
    for name, r in res.items():
        log(f"timing {name}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}) at {r['shape']} "
            f"[{CARD}]")
    ops.reset_launch_counts()       # comparison launches do not count
    return res, mm


def flash_offset_check(torch, F, fa, rnd):
    """Flash with a query block at an offset (prefix-reuse prefill): B=2,
    M=1024 resident prefix rows, tails of T=256 and T=1000 (ragged
    against the tiles), causal.  Each tail is held row by row against
    the plain version; the planted fault (the offset ignored: queries
    taken as positions 0..T-1) must fail the same check.  Timed in turns
    beside the Sq == Skv launch of the same M + T rows and SDPA with the
    same bottom-right causal mask; whether the tail rows of the full
    launch equal the offset launch bit for bit is printed, not held."""
    B, M = 2, 1024
    out = {"shapes": []}
    worst = worst_rel = 0.0
    for T in (256, 1000):
        S = M + T
        qf, k, v = rnd(B, S, H, D), rnd(B, S, K, D), rnd(B, S, K, D)
        q = qf[:, M:].contiguous()
        want = fa.flash_attention_plain(q, k, v, causal=True)
        got = fa.flash_attention(q, k, v, causal=True)
        err, rel = row_err(torch, got, want)
        tol = TOL["flash_attention"]
        log(f"kernel flash_attention offset B={B} M={M} T={T}: "
            f"max_abs_err={err:.3e} worst row rel={rel:.3e} (tol {tol}) "
            f"[{CARD}]")
        check(rel <= tol, f"flash_attention offset M={M} T={T} row rel "
              f"err {rel} > {tol}")
        ctl = control("flash_attention", f"offset ignored (M={M} T={T})",
                      torch, fa.flash_attention(q, k, v, causal=True,
                                                ignore_offset=True), want)
        full = fa.flash_attention(qf, k, v, causal=True)
        bitwise = bool(torch.equal(full[:, M:], got))
        qpos = torch.arange(M, S, device=q.device)[:, None]
        mask = torch.arange(S, device=q.device)[None, :] <= qpos
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        qft = qf.transpose(1, 2)
        med, rounds = in_turns(torch, {
            "offset": lambda: fa.flash_attention(q, k, v, causal=True),
            "full": lambda: fa.flash_attention(qf, k, v, causal=True),
            "library": lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True),
            "library_full": lambda: F.scaled_dot_product_attention(
                qft, kt, vt, is_causal=True, enable_gqa=True)})
        b_ms, b_by = work_bound(fa.work(B, T, S, H, K, D))
        plain = time_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, causal=True), iters=5)
        log(f"timing flash_attention offset B={B} M={M} T={T}: kernel "
            f"{med['offset']:.4f} ms, the Sq == Skv launch of the same "
            f"{S} rows {med['full']:.4f} ms, SDPA (bottom-right mask) "
            f"{med['library']:.4f} ms, SDPA full causal "
            f"{med['library_full']:.4f} ms (medians of {TURNS} turns: "
            f"kernel {fmt(rounds['offset'])}, full {fmt(rounds['full'])}), "
            f"plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}); tail rows "
            f"of the full launch bitwise equal to the offset launch: "
            f"{bitwise} [{CARD}]")
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
        out["shapes"].append(dict(
            B=B, M=M, T=T, ms=med["offset"], full_ms=med["full"],
            library_ms=med["library"], library_full_ms=med["library_full"],
            plain_ms=plain, bound_ms=b_ms, bound_by=b_by, row_rel_err=rel,
            control_row_rel_err=ctl, tail_rows_bitwise=bitwise,
            kernel_turns_ms=rounds["offset"], full_turns_ms=rounds["full"]))
    out.update(max_abs_err=worst, row_rel_err=worst_rel)
    return out


def g7_kernel_check(torch, F, fa, dec, rnd, dev, g):
    """The attention kernels at deepseek-coder-33b's widths: 56 query
    heads over 8 kv heads of 128 (G = 7, a group that divides no tile:
    18 positions fill 126 of the flash CTA's 128 rows).  Flash at B=2
    S=1024 causal and at a query offset (M=1024, T=256); decode, paged
    and dense, at 8 slots of 1 to 2048 rows.  Each is held row by row
    against its plain version at :data:`TOL`, with the rows of every
    flash CTA's first position (``q0 + BQ``, where a pad row written by
    the CTA before would land) held on their own; beside each a planted
    fault must fail the same check.  Each is timed in turns with SDPA
    (``enable_gqa``; the bottom-right boolean mask at the offset; the
    masked dense call for decode, as device time of a CUDA graph), with
    its bound."""
    out = {}
    B, S = 2, 1024
    q, k, v = rnd(B, S, H7, D), rnd(B, S, K7, D), rnd(B, S, K7, D)
    rows, bkv = fa.kernel_tiles(H7 // K7)
    bq = rows // (H7 // K7)
    edge = torch.arange(bq, S, bq, device=dev)
    want = fa.flash_attention_plain(q, k, v, causal=True)
    got = fa.flash_attention(q, k, v, causal=True)
    err, rel = row_err(torch, got, want)
    _, rel_edge = row_err(torch, got[:, edge], want[:, edge])
    tol = TOL["flash_attention"]
    log(f"kernel flash_attention G=7 B={B} S={S} tile {rows} rows = {bq} "
        f"positions x 7 + {rows - bq * 7} pad: max_abs_err={err:.3e} worst "
        f"row rel={rel:.3e}, worst row at the {edge.numel()} CTA-boundary "
        f"positions rel={rel_edge:.3e} (tol {tol}) [{CARD}]")
    check(rel <= tol and rel_edge <= tol,
          f"flash_attention G=7 row rel err {rel} / {rel_edge} > {tol}")
    ctl = control("flash_attention", "G=7 drops one kv tile", torch,
                  fa.flash_attention(q, k, v, causal=True, window=S - 64),
                  want)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    med, rounds = in_turns(torch, {
        "kernel": lambda: fa.flash_attention(q, k, v, causal=True),
        "library": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)})
    b_ms, b_by = work_bound(fa.work(B, S, S, H7, K7, D))
    plain = time_ms(torch, lambda: fa.flash_attention_plain(
        q, k, v, causal=True), iters=5)
    log(f"timing flash_attention G=7 B={B} S={S}: kernel {med['kernel']:.4f}"
        f" ms, SDPA {med['library']:.4f} ms (medians of {TURNS} turns: "
        f"kernel {fmt(rounds['kernel'])}, SDPA {fmt(rounds['library'])}), "
        f"plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}) [{CARD}]")
    out["flash_attention"] = dict(
        shape=f"B={B} S={S} H={H7} K={K7} D={D} causal bf16, tile {rows} "
              f"rows ({bq} positions x 7)", ms=med["kernel"],
        library_ms=med["library"], plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, max_abs_err=err, row_rel_err=rel,
        boundary_row_rel_err=rel_edge, control_row_rel_err=ctl,
        kernel_turns_ms=rounds["kernel"], library_turns_ms=rounds["library"])

    # ---- at a query offset: a 256-token tail over 1024 resident rows
    M, T = 1024, 256
    qf, k, v = rnd(B, M + T, H7, D), rnd(B, M + T, K7, D), rnd(B, M + T, K7, D)
    q = qf[:, M:].contiguous()
    want = fa.flash_attention_plain(q, k, v, causal=True)
    got = fa.flash_attention(q, k, v, causal=True)
    err, rel = row_err(torch, got, want)
    edge = torch.arange(bq, T, bq, device=dev)
    _, rel_edge = row_err(torch, got[:, edge], want[:, edge])
    log(f"kernel flash_attention G=7 offset B={B} M={M} T={T}: "
        f"max_abs_err={err:.3e} worst row rel={rel:.3e}, CTA-boundary "
        f"positions rel={rel_edge:.3e} (tol {tol}) [{CARD}]")
    check(rel <= tol and rel_edge <= tol,
          f"flash_attention G=7 offset row rel err {rel} / {rel_edge}")
    ctl_off = control("flash_attention", f"G=7 offset ignored (M={M} T={T})",
                      torch, fa.flash_attention(q, k, v, causal=True,
                                                ignore_offset=True), want)
    qpos = torch.arange(M, M + T, device=dev)[:, None]
    mask = torch.arange(M + T, device=dev)[None, :] <= qpos
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    med, rounds = in_turns(torch, {
        "kernel": lambda: fa.flash_attention(q, k, v, causal=True),
        "library": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)})
    b_ms, b_by = work_bound(fa.work(B, T, M + T, H7, K7, D))
    plain = time_ms(torch, lambda: fa.flash_attention_plain(
        q, k, v, causal=True), iters=5)
    log(f"timing flash_attention G=7 offset B={B} M={M} T={T}: kernel "
        f"{med['kernel']:.4f} ms, SDPA (bottom-right mask) "
        f"{med['library']:.4f} ms (medians of {TURNS} turns: kernel "
        f"{fmt(rounds['kernel'])}), plain {plain:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}) [{CARD}]")
    out["flash_attention"]["offset"] = dict(
        M=M, T=T, ms=med["kernel"], library_ms=med["library"],
        plain_ms=plain, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
        row_rel_err=rel, boundary_row_rel_err=rel_edge,
        control_row_rel_err=ctl_off)

    # ---- decode, paged and dense: 8 slots, 1..2048 rows
    lens_list = [1, 64, 300, 777, 1024, 1500, 1999, 2048]
    Bd, max_len, bl = len(lens_list), 2048, 256
    lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
    nb = max_len // bl
    need = [-(-n // bl) for n in lens_list]
    perm = torch.randperm(nb * Bd, generator=g, device=dev).int()
    tbl = torch.full((Bd, nb), -1, dtype=torch.int32, device=dev)
    at = 0
    for b, n in enumerate(need):
        tbl[b, :n] = perm[at:at + n]
        at += n
    qd = rnd(Bd, H7, D)
    kp, vp = rnd(nb * Bd, bl, K7, D), rnd(nb * Bd, bl, K7, D)
    kd, vd = rnd(Bd, max_len, K7, D), rnd(Bd, max_len, K7, D)
    short = lens.clone()
    short[-1] -= bl
    swapped = tbl.clone()
    swapped[-1, 0] = tbl[-2, 0]
    dtol = TOL["paged_decode_attention"]
    want = dec.paged_decode_attention_plain(qd, kp, vp, tbl, cache_len=lens)
    err, rel = row_err(torch, dec.paged_decode_attention(
        qd, kp, vp, tbl, cache_len=lens), want)
    log(f"kernel paged_decode_attention G=7 bl={bl} lens={lens_list}: "
        f"max_abs_err={err:.3e} worst row rel={rel:.3e} (tol {dtol}) "
        f"[{CARD}]")
    check(rel <= dtol, f"paged_decode_attention G=7 row rel err {rel}")
    ctl_p = min(
        control("paged_decode_attention", "G=7 one tile short", torch,
                dec.paged_decode_attention(qd, kp, vp, tbl, cache_len=short),
                want),
        control("paged_decode_attention", "G=7 one table entry swapped",
                torch, dec.paged_decode_attention(qd, kp, vp, swapped,
                                                  cache_len=lens), want),
        control("paged_decode_attention", "G=7 split 0 dropped", torch,
                dec.paged_decode_attention(qd, kp, vp, tbl, cache_len=lens,
                                           drop_split=0), want))
    plain_p = time_ms(torch, lambda: dec.paged_decode_attention_plain(
        qd, kp, vp, tbl, cache_len=lens), iters=5)
    wantd = dec.decode_attention_plain(qd, kd, vd, cache_len=lens)
    errd, reld = row_err(torch, dec.decode_attention(qd, kd, vd,
                                                     cache_len=lens), wantd)
    log(f"kernel decode_attention G=7 S={max_len} lens={lens_list}: "
        f"max_abs_err={errd:.3e} worst row rel={reld:.3e} (tol "
        f"{TOL['decode_attention']}) [{CARD}]")
    check(reld <= TOL["decode_attention"],
          f"decode_attention G=7 row rel err {reld}")
    ctl_d = min(
        control("decode_attention", "G=7 one tile short", torch,
                dec.decode_attention(qd, kd, vd, cache_len=short), wantd),
        control("decode_attention", "G=7 split 0 dropped", torch,
                dec.decode_attention(qd, kd, vd, cache_len=lens,
                                     drop_split=0), wantd))
    plain_d = time_ms(torch, lambda: dec.decode_attention_plain(
        qd, kd, vd, cache_len=lens), iters=5)
    mask = (torch.arange(max_len, device=dev)[None, :]
            < lens[:, None])[:, None, None, :]
    q4, k4, v4 = qd[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2)
    med, rounds = in_turns(torch, {
        "paged": lambda: dec.paged_decode_attention(qd, kp, vp, tbl,
                                                    cache_len=lens),
        "dense": lambda: dec.decode_attention(qd, kd, vd, cache_len=lens),
        "library": lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask, enable_gqa=True)}, timer=graph_ms)
    bp_ms, bp_by = work_bound(dec.work(Bd, H7, K7, D, lens_list,
                                       block_len=bl))
    bd_ms, bd_by = work_bound(dec.work(Bd, H7, K7, D, lens_list))
    log(f"timing decode G=7 B={Bd} S={max_len} lens={lens_list}, device "
        f"(CUDA graph): paged {med['paged']:.4f} ms, dense "
        f"{med['dense']:.4f} ms, SDPA (masked) {med['library']:.4f} ms "
        f"(medians of {TURNS} turns: paged {fmt(rounds['paged'])}, dense "
        f"{fmt(rounds['dense'])}); plain paged {plain_p:.4f} ms, dense "
        f"{plain_d:.4f} ms; bound paged {bp_ms:.4f} ms ({bp_by}), dense "
        f"{bd_ms:.4f} ms ({bd_by}) [{CARD}]")
    shape = f"B={Bd} H={H7} K={K7} D={D} lens={lens_list} bf16"
    out["paged_decode_attention"] = dict(
        shape=f"bl={bl} {shape}", ms=med["paged"], library_ms=None,
        plain_ms=plain_p, bound_ms=bp_ms, bound_by=bp_by, max_abs_err=err,
        row_rel_err=rel, control_row_rel_err=ctl_p,
        turns_ms=rounds["paged"])
    out["decode_attention"] = dict(
        shape=f"S={max_len} {shape}", ms=med["dense"],
        library_ms=med["library"], plain_ms=plain_d, bound_ms=bd_ms,
        bound_by=bd_by, max_abs_err=errd, row_rel_err=reld,
        control_row_rel_err=ctl_d, turns_ms=rounds["dense"],
        library_turns_ms=rounds["library"])
    return out


def gqa_kernel_check(torch, F, fa, dec, rnd, dev, g, Hq=H5, Kv=K5, Dh=D64,
                     W=W5):
    """The attention kernels at ``Hq`` query heads over ``Kv`` kv heads
    of ``Dh``, global and, with a window ``W`` > 0, through it: by
    default hymba-1.5b's 25 / 5 heads of 64 (G = 5: 25 positions fill
    125 of the flash CTA's 128 rows) and its 1024-token window; granite's
    16 / 8 of 64 and llama4's 40 / 8 of 128 with no window.  Flash at
    B=2 S=1024 causal, at B=1 S=2048 with the window, and at a query
    offset (M=1024, T=256); decode, paged and dense, at 8 slots of 1 to
    2048 rows with the window and without.  Each is held row by row
    against its plain version at :data:`TOL`, the rows of every flash
    CTA's first position (``q0 + BQ``) among them and on their own;
    beside each, planted faults must fail the same check: a dropped kv
    tile, the pad rows written over those first positions (where the
    tile has pad rows: G = 2 fills it), the window ignored, the offset
    ignored, one table entry swapped, a split dropped from the merge.  Each is timed in turns with SDPA (``enable_gqa``; a boolean
    window mask; the bottom-right mask at the offset; the masked dense
    call for decode, as device time of a CUDA graph), beside its
    bound."""
    out = {}
    tol = TOL["flash_attention"]
    G = Hq // Kv
    rows, bkv = fa.kernel_tiles(G)
    bq = rows // G

    def flash_case(label, B, S, window, M=0):
        """One flash shape: checked (whole, boundary rows), its faults,
        timed against SDPA; ``M`` > 0 puts the queries at an offset."""
        qf = rnd(B, M + S, Hq, Dh)
        k, v = rnd(B, M + S, Kv, Dh), rnd(B, M + S, Kv, Dh)
        q = qf[:, M:].contiguous()
        want = fa.flash_attention_plain(q, k, v, causal=True, window=window)
        got = fa.flash_attention(q, k, v, causal=True, window=window)
        err, rel = row_err(torch, got, want)
        edge = torch.arange(bq, S, bq, device=dev)
        _, rel_edge = row_err(torch, got[:, edge], want[:, edge])
        log(f"kernel flash_attention G={G} D={Dh} {label}: tile {rows} rows "
            f"= {bq} positions x {G} + {rows - bq * G} pad: max_abs_err="
            f"{err:.3e} worst row rel={rel:.3e}, worst row at the "
            f"{edge.numel()} CTA-boundary positions rel={rel_edge:.3e} "
            f"(tol {tol}) [{CARD}]")
        check(rel <= tol and rel_edge <= tol,
              f"flash_attention G={G} {label} row rel err {rel} / {rel_edge}")
        faults, flipped = {}, None
        npad = rows - bq * G
        if npad:
            pad = fa.flash_attention(q, k, v, causal=True, window=window,
                                     pad_fault=True)
            # the rows the fault's pad rows cover: heads 0..npad-1 of
            # every boundary position, each written by them alone
            e = (pad[:, edge, :npad].float() - want[:, edge, :npad].float())
            w = want[:, edge, :npad].float()
            flipped = [int((e.pow(2).mean(-1).sqrt()
                            > tol * w.pow(2).mean(-1).sqrt()).sum()),
                       e[..., 0].numel()]
            log(f"control flash_attention G={G} {label} pad fault: "
                f"{flipped[0]} of the {flipped[1]} boundary rows it covers "
                f"beyond tol {tol} [{CARD}]")
            faults["pad rows over the next CTA's first position"] = pad
        if M:
            faults["offset ignored"] = fa.flash_attention(
                q, k, v, causal=True, window=window, ignore_offset=True)
        elif window:
            faults["window ignored"] = fa.flash_attention(q, k, v,
                                                          causal=True)
        else:
            faults["drops one kv tile"] = fa.flash_attention(
                q, k, v, causal=True, window=S - 64)
        ctl = min(control("flash_attention", f"G={G} {label} {f}", torch, bad,
                          want) for f, bad in faults.items())
        Sk = M + S
        qpos = torch.arange(M, Sk, device=dev)[:, None]
        kpos = torch.arange(Sk, device=dev)[None, :]
        mask = kpos <= qpos
        if window:
            mask &= qpos - kpos < window
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        # SDPA's own causal path where the mask is plain causal, else the
        # boolean mask
        lib = dict(is_causal=True) if not (M or window) else \
            dict(attn_mask=mask)
        med, rounds = in_turns(torch, {
            "kernel": lambda: fa.flash_attention(q, k, v, causal=True,
                                                 window=window),
            "library": lambda: F.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True, **lib)})
        b_ms, b_by = work_bound(fa.work(B, S, Sk, Hq, Kv, Dh,
                                        window=window))
        plain = time_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, causal=True, window=window), iters=5)
        log(f"timing flash_attention G={G} D={Dh} {label}: kernel "
            f"{med['kernel']:.4f} ms, SDPA ({'/'.join(lib)}) "
            f"{med['library']:.4f} ms (medians of {TURNS} turns: kernel "
            f"{fmt(rounds['kernel'])}, SDPA {fmt(rounds['library'])}), plain "
            f"{plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}) [{CARD}]")
        return dict(
            shape=f"B={B} M={M} S={S} H={Hq} K={Kv} D={Dh} causal, window "
                  f"{window}, bf16, tile {rows} rows ({bq} positions x {G})",
            ms=med["kernel"], library_ms=med["library"], plain_ms=plain,
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err, row_rel_err=rel,
            boundary_row_rel_err=rel_edge, control_row_rel_err=ctl,
            pad_fault_rows_flipped=flipped,
            kernel_turns_ms=rounds["kernel"],
            library_turns_ms=rounds["library"])

    out["flash_attention"] = flash_case("B=2 S=1024", 2, 1024, 0)
    if W:
        out["flash_attention"]["window"] = flash_case(
            f"B=1 S=2048 window {W}", 1, 2048, W)
    out["flash_attention"]["offset"] = flash_case(
        f"offset B=2 M=1024 T=256 window {W}", 2, 256, W, M=1024)

    # ---- decode, paged and dense: 8 slots, 1..2048 rows
    lens_list = [1, 64, 300, 777, 1024, 1500, 1999, 2048]
    Bd, max_len, bl = len(lens_list), 2048, 256
    lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
    nb = max_len // bl
    need = [-(-n // bl) for n in lens_list]
    perm = torch.randperm(nb * Bd, generator=g, device=dev).int()
    tbl = torch.full((Bd, nb), -1, dtype=torch.int32, device=dev)
    at = 0
    for b, n in enumerate(need):
        tbl[b, :n] = perm[at:at + n]
        at += n
    qd = rnd(Bd, Hq, Dh)
    kp, vp = rnd(nb * Bd, bl, Kv, Dh), rnd(nb * Bd, bl, Kv, Dh)
    kd, vd = rnd(Bd, max_len, Kv, Dh), rnd(Bd, max_len, Kv, Dh)
    swapped = tbl.clone()
    swapped[-1, -1] = tbl[-2, -1]
    dtol = TOL["paged_decode_attention"]
    kpos = torch.arange(max_len, device=dev)[None, :]
    q4, k4, v4 = qd[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2)
    for window in ((W, 0) if W else (0,)):
        kw = dict(cache_len=lens, window=window)
        want = dec.paged_decode_attention_plain(qd, kp, vp, tbl, **kw)
        err, rel = row_err(torch, dec.paged_decode_attention(
            qd, kp, vp, tbl, **kw), want)
        wantd = dec.decode_attention_plain(qd, kd, vd, **kw)
        errd, reld = row_err(torch, dec.decode_attention(qd, kd, vd, **kw),
                             wantd)
        log(f"kernel decode G={G} D={Dh} window {window} lens={lens_list}: "
            f"paged max_abs_err={err:.3e} worst row rel={rel:.3e}, dense "
            f"max_abs_err={errd:.3e} worst row rel={reld:.3e} (tol {dtol}) "
            f"[{CARD}]")
        check(rel <= dtol and reld <= TOL["decode_attention"],
              f"decode G={G} window {window} row rel err {rel} / {reld}")
        # split 0 holds live rows only without a window; the window drops
        # the early rows of the long slots
        faults = {"one table entry swapped": dec.paged_decode_attention(
            qd, kp, vp, swapped, **kw)}
        if window:
            faults["window ignored"] = dec.paged_decode_attention(
                qd, kp, vp, tbl, cache_len=lens)
            dfaults = {"window ignored": dec.decode_attention(
                qd, kd, vd, cache_len=lens)}
        else:
            faults["split 0 dropped"] = dec.paged_decode_attention(
                qd, kp, vp, tbl, drop_split=0, **kw)
            dfaults = {"split 0 dropped": dec.decode_attention(
                qd, kd, vd, drop_split=0, **kw)}
        ctl_p = min(control("paged_decode_attention",
                            f"G={G} window {window} {f}", torch, bad, want)
                    for f, bad in faults.items())
        ctl_d = min(control("decode_attention", f"G={G} window {window} {f}",
                            torch, bad, wantd) for f, bad in dfaults.items())
        mask = kpos < lens[:, None]
        if window:
            mask &= kpos >= lens[:, None] - window
        mask = mask[:, None, None, :]
        med, rounds = in_turns(torch, {
            "paged": lambda: dec.paged_decode_attention(qd, kp, vp, tbl, **kw),
            "dense": lambda: dec.decode_attention(qd, kd, vd, **kw),
            "library": lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, enable_gqa=True)},
            timer=graph_ms)
        plain_p = time_ms(torch, lambda: dec.paged_decode_attention_plain(
            qd, kp, vp, tbl, **kw), iters=5)
        plain_d = time_ms(torch, lambda: dec.decode_attention_plain(
            qd, kd, vd, **kw), iters=5)
        bp_ms, bp_by = work_bound(dec.work(Bd, Hq, Kv, Dh, lens_list,
                                           window=window, block_len=bl))
        bd_ms, bd_by = work_bound(dec.work(Bd, Hq, Kv, Dh, lens_list,
                                           window=window))
        log(f"timing decode G={G} D={Dh} window {window} B={Bd} S={max_len}, "
            f"device (CUDA graph): paged {med['paged']:.4f} ms, dense "
            f"{med['dense']:.4f} ms, SDPA (masked) {med['library']:.4f} ms "
            f"(medians of {TURNS} turns: paged {fmt(rounds['paged'])}, dense "
            f"{fmt(rounds['dense'])}); plain paged {plain_p:.4f} ms, dense "
            f"{plain_d:.4f} ms; bound paged {bp_ms:.4f} ms ({bp_by}), dense "
            f"{bd_ms:.4f} ms ({bd_by}) [{CARD}]")
        shape = (f"B={Bd} H={Hq} K={Kv} D={Dh} lens={lens_list} window "
                 f"{window} bf16")
        rp = dict(shape=f"bl={bl} {shape}", ms=med["paged"], library_ms=None,
                  plain_ms=plain_p, bound_ms=bp_ms, bound_by=bp_by,
                  max_abs_err=err, row_rel_err=rel, control_row_rel_err=ctl_p,
                  turns_ms=rounds["paged"])
        rd = dict(shape=f"S={max_len} {shape}", ms=med["dense"],
                  library_ms=med["library"], plain_ms=plain_d,
                  bound_ms=bd_ms, bound_by=bd_by, max_abs_err=errd,
                  row_rel_err=reld, control_row_rel_err=ctl_d,
                  turns_ms=rounds["dense"],
                  library_turns_ms=rounds["library"])
        if window or not W:     # the headline: hymba's 29 of 32 layers
            out["paged_decode_attention"], out["decode_attention"] = rp, rd
        else:
            out["paged_decode_attention"]["global"] = rp
            out["decode_attention"]["global"] = rd
    return out


def noncausal_flash_case(torch, F, fa, rnd, B, S, Hq, Kv, Dh):
    """Flash with ``causal=False`` (the encoder's attention) at ``Hq`` /
    ``Kv`` heads of ``Dh``: held row by row against the plain version,
    beside two planted faults that must fail the same check (the upper
    triangle dropped: the kernel run causal; the first kv tile dropped
    from the last rows: a window of S - 64), then timed in turns with
    SDPA (no mask, ``enable_gqa``) beside its bound (every (query, key)
    pair; head_dim 80 counted at 80, though the kernel pads it to
    128)."""
    tol = TOL["flash_attention"]
    q, k, v = rnd(B, S, Hq, Dh), rnd(B, S, Kv, Dh), rnd(B, S, Kv, Dh)
    want = fa.flash_attention_plain(q, k, v, causal=False)
    got = fa.flash_attention(q, k, v, causal=False)
    err, rel = row_err(torch, got, want)
    G = Hq // Kv
    label = f"G={G} D={Dh} B={B} S={S} non-causal"
    log(f"kernel flash_attention {label}: max_abs_err={err:.3e} worst row "
        f"rel={rel:.3e} (tol {tol}) [{CARD}]")
    check(rel <= tol, f"flash_attention {label} row rel err {rel}")
    ctl = min(control("flash_attention", f"{label} upper triangle dropped",
                      torch, fa.flash_attention(q, k, v, causal=True), want),
              control("flash_attention", f"{label} drops one kv tile", torch,
                      fa.flash_attention(q, k, v, causal=False,
                                         window=S - 64), want))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    med, rounds = in_turns(torch, {
        "kernel": lambda: fa.flash_attention(q, k, v, causal=False),
        "library": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True)})
    plain = time_ms(torch, lambda: fa.flash_attention_plain(
        q, k, v, causal=False), iters=5)
    b_ms, b_by = work_bound(fa.work(B, S, S, Hq, Kv, Dh, causal=False))
    log(f"timing flash_attention {label}: kernel {med['kernel']:.4f} ms, "
        f"SDPA {med['library']:.4f} ms (medians of {TURNS} turns: kernel "
        f"{fmt(rounds['kernel'])}, SDPA {fmt(rounds['library'])}), plain "
        f"{plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}) [{CARD}]")
    return dict(shape=f"B={B} S={S} H={Hq} K={Kv} D={Dh} non-causal bf16, "
                      f"tile {fa.kernel_tiles(G)}",
                ms=med["kernel"], library_ms=med["library"], plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                row_rel_err=rel, control_row_rel_err=ctl,
                kernel_turns_ms=rounds["kernel"],
                library_turns_ms=rounds["library"])


def frontend_kernel_check(torch, F, fa, dec, dev):
    """The attention kernels at the frontends' widths, on a generator of
    their own (the draws of the earlier checks stay as they were):
    qwen2-vl-72b's 64 / 8 heads of 128 (G = 8 fills the flash tile: 16
    positions x 8, no pad row) through :func:`gqa_kernel_check` (flash
    whole and at a query offset, paged and dense decode, their planted
    faults and SDPA timings), then ``causal=False`` at hubert-xlarge's 16
    / 16 heads of 80 and at qwen3-8b's 32 / 8 heads of 128, B=1 S=2048
    (:func:`noncausal_flash_case`).  Returns rows by kernel name, each
    keyed ``qwen2vl`` / ``hubert`` / ``noncausal128``."""
    gf = torch.Generator(dev).manual_seed(SEED + 25)

    def rnd(*shape):
        return torch.randn(shape, generator=gf, device=dev).to(torch.bfloat16)

    hq, kv, dh = VLM_PAIR
    out = {name: {"qwen2vl": r} for name, r in gqa_kernel_check(
        torch, F, fa, dec, rnd, dev, gf, Hq=hq, Kv=kv, Dh=dh, W=0).items()}
    out["flash_attention"]["hubert"] = noncausal_flash_case(
        torch, F, fa, rnd, 1, 2048, *ENC_PAIR)
    out["flash_attention"]["noncausal128"] = noncausal_flash_case(
        torch, F, fa, rnd, 1, 2048, H, K, D)
    return out


def matmul_kernel_check(torch, dev, g):
    """The tiled matmul at every tile it is built for, bf16 and fp32, on
    a ragged shape (300, 584, 1000) and a decode tick's (8, 4096, 2048),
    against the plain version, row by row (a row: one output row).
    Returns the worst row error by dtype."""
    from repro_torch.kernels import tiled_matmul as mm

    worst = {}
    for tiles in mm.KERNEL_TILES:
        for dt in mm.DTYPES:
            name = str(dt).split(".")[-1]
            for M, K, N in ((300, 584, 1000), (8, 4096, 2048)):
                a = torch.randn((M, K), generator=g, device=dev).to(dt)
                b = torch.randn((K, N), generator=g, device=dev).to(dt)
                err, rel = row_err(torch, mm.tiled_matmul(a, b, tiles=tiles),
                                   mm.tiled_matmul_plain(a, b))
                tol = MM_TOL[name]
                log(f"kernel tiled_matmul tiles={tiles} {name} M={M} K={K} "
                    f"N={N}: max_abs_err={err:.3e} worst row rel={rel:.3e} "
                    f"(tol {tol}) [{CARD}]")
                check(rel <= tol, f"tiled_matmul {tiles} {name} ({M}, {K}, "
                      f"{N}) row rel err {rel} > {tol}")
                worst[name] = max(worst.get(name, 0.0), rel)
    return worst


def mm_fp32_bound(M, K, N):
    """``(bound ms, by, FFMA ms)`` of an fp32 (M, K) @ (K, N): the larger
    of its bytes at 3.35 TB/s and the kernel's three TF32 products (3 x
    2 MKN) at :data:`PEAK_TF32`, and beside it the 2 MKN at the CUDA
    cores' :data:`PEAK_FP32` (the FFMA design's bound)."""
    from repro_torch.kernels import tiled_matmul as mm
    b_ms, by = work_bound(mm.work(M, K, N, 4), PEAK_TF32)
    return b_ms, by, 2 * M * K * N / PEAK_FP32 * 1e3


def rows64(torch, got, want):
    """The worst row's rms-relative error and max |error| / max |want|,
    in fp64."""
    got, want = got.double(), want.double()
    check(bool(torch.isfinite(got).all()), "kernel output is not finite")
    e = got - want
    rel = e.pow(2).mean(1).sqrt() / want.pow(2).mean(1).sqrt().clamp_min(
        1e-30)
    return float(rel.max()), float(e.abs().max() / want.abs().max())


def matmul_fp32_check(torch, dev):
    """The fp32 tiled matmul on its own generator: every tile at ragged
    shapes (one row, K = 8, K = 0) against the fp32 plain version and an
    fp64 product (the worst row and max/max at 1e-5); at
    :data:`MM_FP32_SHAPES` the same against fp64 beside ``torch.matmul``'s
    own fp32 error, a control (``torch.matmul`` with TF32 on, which the
    check must fail), a repeated call bitwise equal; then each shape timed
    in turns with ``torch.matmul`` (TF32 off), beside its bound and the
    FFMA bound.  Only ``tiled_matmul(a, b, tiles=...)`` is called, so
    ``--src`` can run a parent tree; a tree whose wrapper takes
    ``splits`` also times each split count."""
    import inspect

    from repro_torch.kernels import tiled_matmul as mm

    g = torch.Generator(dev).manual_seed(SEED + 23)
    tol = MM_TOL["float32"]

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def held(label, got, a, b):
        r32 = rows64(torch, got, mm.tiled_matmul_plain(a, b))
        r64 = rows64(torch, got, a.double() @ b.double())
        log(f"kernel tiled_matmul fp32 {label}: worst row rel / max/max "
            f"{r32[0]:.3e} / {r32[1]:.3e} against fp32, {r64[0]:.3e} / "
            f"{r64[1]:.3e} against fp64 (tol {tol}) [{CARD}]")
        check(max(*r32, *r64) <= tol, f"tiled_matmul fp32 {label}: "
              f"{r32} against fp32, {r64} against fp64 > {tol}")
        return max(r64)

    out = {"ragged_fp64_rel_err": 0.0, "shapes": []}
    for tiles in mm.KERNEL_TILES:
        for M, K, N in ((1, 64, 8), (130, 8, 136), (300, 584, 1000),
                        (4, 0, 64)):
            a, b = rnd(M, K), rnd(K, N)
            got = mm.tiled_matmul(a, b, tiles=tiles)
            if K == 0:
                check(bool((got == 0).all()) and got.shape == (M, N),
                      f"tiled_matmul fp32 {tiles} K=0 is not zeros")
                continue
            out["ragged_fp64_rel_err"] = max(out["ragged_fp64_rel_err"], held(
                f"tiles={tiles} ({M}, {K}, {N})", got, a, b))
    t = mm.DEFAULT_TILES
    split_param = "splits" in inspect.signature(mm.tiled_matmul).parameters
    for M, K, N in MM_FP32_SHAPES:
        a, b = rnd(M, K), rnd(K, N)
        got = mm.tiled_matmul(a, b, tiles=t)
        err64 = held(f"tiles={t} ({M}, {K}, {N})", got, a, b)
        want64 = a.double() @ b.double()
        lib64 = rows64(torch, torch.matmul(a, b), want64)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = rows64(torch, torch.matmul(a, b), want64)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        log(f"control tiled_matmul fp32 ({M}, {K}, {N}): torch.matmul with "
            f"TF32 on errs {tf32[0]:.3e} / {tf32[1]:.3e} against fp64 (must "
            f"exceed tol {tol}); TF32 off {lib64[0]:.3e} / {lib64[1]:.3e} "
            f"[{CARD}]")
        check(max(tf32) > tol, f"the TF32-on control passed the fp32 check "
              f"({tf32} <= {tol})")
        again = mm.tiled_matmul(a, b, tiles=t)
        check(torch.equal(got, again), f"tiled_matmul fp32 ({M}, {K}, {N}): "
              "a repeated call is not bitwise equal")
        del got, again, want64
        fns = {"kernel": lambda: mm.tiled_matmul(a, b, tiles=t),
               "library": lambda: torch.matmul(a, b)}
        if split_param:
            for s in range(1, mm.MAX_SPLITS + 1):
                fns[f"splits={s}"] = (
                    lambda s=s: mm.tiled_matmul(a, b, tiles=t, splits=s))
        med, rounds = in_turns(torch, fns)
        plain = time_ms(torch, lambda: mm.tiled_matmul_plain(a, b), iters=5)
        b_ms, b_by, ffma_ms = mm_fp32_bound(M, K, N)
        splits = (mm.fp32_splits(M, K, N, t, torch.cuda.get_device_properties(
            dev).multi_processor_count) if split_param else None)
        log(f"timing tiled_matmul fp32 ({M}, {K}, {N}) tiles={t} splits="
            f"{splits}: kernel {med['kernel']:.4f} ms, torch.matmul "
            f"{med['library']:.4f} ms, plain {plain:.4f} ms (medians of "
            f"{TURNS} turns: " + ", ".join(
                f"{n} {fmt(r)}" for n, r in rounds.items()) + f"), bound "
            f"{b_ms:.4f} ms ({b_by}; operations: 3 TF32 products at 495 "
            f"TFLOP/s), FFMA bound {ffma_ms:.4f} ms (67 TFLOP/s) [{CARD}]")
        out["shapes"].append(dict(
            M=M, K=K, N=N, tiles=list(t), splits=splits, ms=med["kernel"],
            library_ms=med["library"], plain_ms=plain, bound_ms=b_ms,
            bound_by=b_by, ffma_bound_ms=ffma_ms, turns_ms=rounds,
            fp64_rel_err=err64, library_fp64_rel_err=max(lib64),
            tf32_control_rel_err=max(tf32)))
    return out


def ssd_kernel_check(torch, dev, g, H=SSD_H, P=SSD_P, N=SSD_N, G=SSD_G,
                     name=""):
    """The SSD scan at mamba2-2.7b's widths (batch 1, 80 heads of 64,
    state 128, one group, the plan's chunk 256) or, given ``H, P, N,
    G``, another model's (hymba-1.5b: 50 heads of 64, state 16; ``name``
    tags its lines): S = 2048 and a ragged S = 1000, against the plain
    version in fp32 and in fp64, and on :data:`SSD_DRAWS` more draws at
    S = 2048 against the fp64 one.  A row is one (batch, position,
    head)'s P outputs; the final state is held per head, as its (P, N)
    block.  Two planted faults
    must fail that check by 10x:
    the carry into the second chunk dropped (the kernel run on the
    positions from the second chunk on, against the plain rows there),
    and the final state one chunk short."""
    import torch.nn.functional as F

    from repro_torch.kernels import ssd_scan as ssd

    chunk, tol = 256, TOL["ssd_scan"]

    def inputs(S, gen=g):
        x = F.silu(torch.randn((1, S, H, P), generator=gen, device=dev))
        dt = F.softplus(torch.randn((1, S, H), generator=gen, device=dev)
                        - 2.0)
        A = -torch.linspace(1.0, 16.0, H, device=dev)
        Bm = F.silu(torch.randn((1, S, G, N), generator=gen, device=dev))
        Cm = F.silu(torch.randn((1, S, G, N), generator=gen, device=dev))
        return x, dt, A, Bm, Cm

    def fp64_rows(ins, y, y_want):
        """The worst row of the kernel and of the fp32 plain version,
        each against the plain version run in fp64."""
        y64, _ = ssd.ssd_scan_plain(*(t.double() for t in ins), chunk=chunk)
        return row_err(torch, y, y64)[1], row_err(torch, y_want, y64)[1]

    worst = worst_rel = worst_state = worst64 = 0.0
    for S in (2048, 1000):
        ins = inputs(S)
        y, fin = ssd.ssd_scan(*ins, chunk=chunk, heads_block=1)
        y_want, fin_want = ssd.ssd_scan_plain(*ins, chunk=chunk)
        err, rel = row_err(torch, y, y_want)
        _, srel = row_err(torch, fin.flatten(-2), fin_want.flatten(-2))
        rel64, plain64 = fp64_rows(ins, y, y_want)
        log(f"kernel ssd_scan{name} S={S}: max_abs_err={err:.3e} worst row "
            f"rel={rel:.3e}, against fp64 {rel64:.3e} (the fp32 plain "
            f"version against fp64 {plain64:.3e}) final state worst head "
            f"rel={srel:.3e} (tol {tol}) [{CARD}]")
        check(rel <= tol and rel64 <= tol and srel <= tol,
              f"ssd_scan{name} S={S} row rel err {rel} (fp64 {rel64}) / "
              f"state {srel} > {tol}")
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
        worst_state, worst64 = max(worst_state, srel), max(worst64, rel64)
    # more draws, each against fp64, from a generator of their own (the
    # draws of the checks after this one stay as they were)
    gd = torch.Generator(dev).manual_seed(SEED + 100)
    draws = []
    for _ in range(SSD_DRAWS):
        ins = inputs(2048, gd)
        y, _ = ssd.ssd_scan(*ins, chunk=chunk)
        draws.append(fp64_rows(ins, y, ssd.ssd_scan_plain(*ins,
                                                          chunk=chunk)[0]))
    log(f"kernel ssd_scan{name} S=2048, {SSD_DRAWS} more draws, worst row "
        f"against fp64: kernel {[f'{d[0]:.3e}' for d in draws]}, fp32 "
        f"plain version {[f'{d[1]:.3e}' for d in draws]} (tol {tol}) "
        f"[{CARD}]")
    worst64 = max([worst64] + [d[0] for d in draws])
    check(worst64 <= tol, f"ssd_scan{name}: a draw's row against fp64 "
          f"{worst64} > {tol}")
    ins = inputs(2048)                       # timed, and the faults
    y_want, fin_want = ssd.ssd_scan_plain(*ins, chunk=chunk)
    tail = [t[:, chunk:].contiguous() if t.dim() > 1 else t for t in ins]
    head = [t[:, :-chunk].contiguous() if t.dim() > 1 else t for t in ins]
    ctl = min(
        control("ssd_scan", f"carry into the second chunk dropped{name}",
                torch, ssd.ssd_scan(*tail, chunk=chunk)[0],
                y_want[:, chunk:], factor=10),
        control("ssd_scan", f"final state one chunk short{name}", torch,
                ssd.ssd_scan(*head, chunk=chunk)[1].flatten(-2),
                fin_want.flatten(-2), factor=10),
        control("ssd_scan", f"state not passed between chunks{name}",
                torch, ssd.ssd_scan(*ins, chunk=chunk, no_carry=True)[0],
                y_want, factor=10))
    grid = ssd.grid_ctas(1, 2048, H, P, N, chunk)
    log(f"grid ssd_scan{name} S=2048: chunk states {grid[0]} CTAs, state "
        f"passing {grid[1]} CTAs, chunk scan {grid[2]} CTAs; 3 launches "
        f"per call "
        f"(a one-CTA-per-head scan would have {H}) [{CARD}]")
    med, rounds = in_turns(torch, {
        "kernel": lambda: ssd.ssd_scan(*ins, chunk=chunk)})
    ms = med["kernel"]
    passes = device_ms_by_kernel(
        torch, lambda: ssd.ssd_scan(*ins, chunk=chunk))
    log(f"timing ssd_scan{name} S=2048: kernel {ms:.4f} ms (median of "
        f"{TURNS} turns: {fmt(rounds['kernel'])}); device time per call by "
        f"pass "
        f"(torch.profiler): "
        + ", ".join(f"{re.search(r'(\w+)(<[^>]*>)?\(', k).group(1)} "
                    f"{v:.4f} ms" for k, v in passes.items()) + f" [{CARD}]")
    plain = time_ms(torch, lambda: ssd.ssd_scan_plain(*ins, chunk=chunk),
                    iters=5)
    by_chunk = {}
    for q in ssd.KERNEL_CHUNKS:           # every chunk the kernel takes
        by_chunk[q] = {re.search(r"(\w+)(<[^>]*>)?\(", k).group(1): v
                       for k, v in device_ms_by_kernel(
                           torch, lambda: ssd.ssd_scan(*ins, chunk=q)).items()}
        log(f"timing ssd_scan{name} S=2048 chunk={q}: device time per call "
            f"by pass {by_chunk[q]}, sum {sum(by_chunk[q].values()):.4f} ms "
            f"[{CARD}]")
    S, Q = 2048, chunk
    nc = -(-S // Q)
    # causal half only (ssd.work): the k <= q entries of C.B^T (once per
    # group: its heads share B and C) and of scores.x (per head), plus
    # C.state^T and the state update (per head)
    flops, nbytes = ssd.work(1, S, H, P, G, N, Q)
    # the count with C.B^T per head, for comparison with a per-head scan
    flops_per_head = H * nc * (Q * (Q + 1) * (N + P) + 4 * Q * P * N)
    # the products run in fp64 on the tensor cores: 67 TFLOP/s, the data
    # sheet's fp32 CUDA-core rate too
    b_ms, b_by = bound(nbytes, flops, PEAK_FP32)
    b_head_ms, _ = bound(nbytes, flops_per_head, PEAK_FP32)
    return dict(
        route="cuda", source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:83",
        max_abs_err=worst, row_rel_err=worst_rel,
        state_rel_err=worst_state, control_row_rel_err=ctl, tolerance=tol,
        ms=ms, turns_ms=rounds["kernel"], plain_ms=plain, library_ms=None,
        passes_ms=passes, chunks_ms=by_chunk,
        row_rel_err_fp64=worst64, draws_row_rel_err_fp64=draws,
        bound_ms=b_ms, bound_by=b_by, bound_per_head_scores_ms=b_head_ms,
        grid=dict(zip(("chunk_state", "state_pass", "chunk_scan"), grid),
                  launches_per_call=3),
        shape=f"B=1 S={S} H={H} P={P} N={N} G={G} chunk={chunk} fp32; "
              "bound_ms at the fp64 tensor-core rate, with C.B^T once per "
              "group; bound_per_head_scores_ms is the count with C.B^T per "
              "head, at the fp32 rate",
        library_call="none: no single PyTorch call computes the SSD scan")


# ---------------------------------------------------------------------
# phases 3-4 and 6: serving
# ---------------------------------------------------------------------

def serve_phase(torch, dev, name, arch, plan, params, n_requests,
                new_tokens, max_k: int = 24):
    """Serve ``n_requests`` prompts of 64k tokens (k seeded in 1..max_k)
    from ``from_plan(plan, params)``; returns the launch counts and the
    run's numbers."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.serve.engine import ServeEngine

    est = plan.estimates
    log(f"serve[{name}] plan {plan.content_hash()[:16]} target={plan.target} "
        f"kv_residency={est.get('kv_residency')} "
        f"kv_block_len={est.get('kv_block_len')} "
        f"kv_n_blocks={est.get('kv_n_blocks')} "
        f"kv_admission={est.get('kv_admission')} "
        f"kv_prefill_mode={est.get('kv_prefill_mode')} "
        f"tiles={ {k: dict(v.blocks) for k, v in plan.partitions.items()} }")
    eng = ServeEngine.from_plan(plan, params, arch=arch, seed=SEED)
    rng = np.random.default_rng(SEED)
    vocab = eng.arch.vocab_size
    prompts = [rng.integers(0, vocab,
                            (int(rng.integers(1, max_k + 1)) * 64,))
               for _ in range(n_requests)]
    ticks = [0]
    step = eng.step

    def counted():                     # decode ticks: the ones with slots
        n = step()
        ticks[0] += bool(eng.active) or n > 0
        return n

    eng.step = counted
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        eng.submit(p, max_new_tokens=new_tokens,
                   temperature=0.0 if i % 2 == 0 else 0.8)
    done = eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del eng.step            # the wrapper's closure would keep eng alive
    counts = ops.launch_counts()
    toks = sum(len(r.out_tokens) for r in done)
    ttft = np.array([(r.t_first - r.t_submit) * 1e3 for r in done])
    check(len(done) == n_requests, f"serve[{name}]: {len(done)} of "
          f"{n_requests} requests finished")
    for r in done:
        check(len(r.out_tokens) == new_tokens
              and all(0 <= t < vocab for t in r.out_tokens),
              f"serve[{name}]: request {r.rid} tokens {r.out_tokens}")
    # blocks a finished request leaves trie-indexed stay engine-cached;
    # dropped, both tiers must be whole again
    cached = eng.block_stats()["cached"]
    eng.drop_block_cache()
    st = eng.block_stats()
    check(st["free"] == st["total"] and st["in_use"] == 0
          and st["host_free"] == st["host_total"],
          f"serve[{name}]: blocks not all returned: {st}")
    log(f"serve[{name}] requests={len(done)} tokens={toks} "
        f"wall_s={wall:.3f} tok_per_s={toks / wall:.1f} "
        f"ttft_ms_p50={np.percentile(ttft, 50):.1f} "
        f"ttft_ms_p95={np.percentile(ttft, 95):.1f} "
        f"prompt_lens={[len(p) for p in prompts]} "
        f"prefill_calls={eng.prefill_calls} "
        f"prefill_batches={list(eng.prefill_batches)} ticks={eng.tick} "
        f"decode_ticks={ticks[0]} [{CARD}]")
    log(f"serve[{name}] kv_prefix_reuse={eng.kv_prefix_reuse} "
        f"kv_host_blocks={eng.host_blocks} kv_prefetch={eng.kv_prefetch} "
        f"cached_at_idle={cached} block_stats={st} launches={counts} "
        f"decode_path={eng.decode_path} [{CARD}]")
    log(f"serve[{name}] pressure_stats={eng.pressure_stats()} "
        f"tier_ms={eng.tier_ms} [{CARD}]")
    for r in done[:2]:
        log(f"serve[{name}]   rid={r.rid} prompt={len(r.prompt)} "
            f"t={r.temperature} -> {r.out_tokens[:8]}...")
    calls = eng.prefill_calls
    del eng, step, counted
    torch.cuda.empty_cache()
    return counts, {"requests": len(done), "tokens": toks, "wall_s": wall,
                    "tok_per_s": toks / wall,
                    "ttft_ms_p50": float(np.percentile(ttft, 50)),
                    "ttft_ms_p95": float(np.percentile(ttft, 95)),
                    "prefill_calls": calls, "decode_ticks": ticks[0],
                    "decode_launches_per_tick": {
                        k: counts[k] / max(ticks[0], 1) for k in (
                            "paged_decode_attention", "decode_attention")
                        if counts[k]},
                    "card": CARD}


def _recording_engine(ServeEngine, prefix_blocks: int = 0):
    """A ServeEngine that keeps, per request, the fp32 logits its first
    and second tokens were sampled from (the prefill's and the first
    decode step's) and, at every sampled token, the top-2 margin
    relative to the logits' largest magnitude (the margin rule of
    ``tests/test_torch_serve.py``).  With ``prefix_blocks`` > 0 it also
    keeps, at the first decode step, the K/V rows of the first
    ``prefix_blocks`` blocks of the request's table (paged), as
    ``(2, L, prefix_blocks, block_len, K, hd)``."""
    import torch

    class Recording(ServeEngine):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.first, self.second, self.margins = {}, {}, {}
            self.prefix_rows, self._rids = {}, []

        def _admit_group(self, group, *args):
            # a resumed request's prefill draws no sample
            self._rids = [r.rid for r in group if not r.out_tokens]
            super()._admit_group(group, *args)

        def _ensure_writable(self):
            super()._ensure_writable()
            # the rows of this tick's decode sample, in slot order
            self._rids = [self.active[s].rid for s in sorted(self.active)]

        def _sample(self, logits, temperatures):
            lf = logits[:, :self.arch.vocab_size].float()
            top = lf.topk(2, dim=-1).values
            rel = ((top[:, 0] - top[:, 1]) / lf.abs().amax(-1)).tolist()
            for rid, row, m in zip(self._rids, lf, rel):
                if rid in self.first and rid not in self.second:
                    self.second[rid] = row.cpu()
                    if prefix_blocks:
                        slot = next(s for s, r in self.active.items()
                                    if r.rid == rid)
                        blk = self.cache["block_tbl"][
                            slot, :prefix_blocks].long()
                        self.prefix_rows[rid] = torch.stack(
                            [self.cache[n][:, blk] for n in ("k", "v")])
                self.first.setdefault(rid, row.cpu())
                self.margins.setdefault(rid, []).append(m)
            return super()._sample(logits, temperatures)

    return Recording


def shared_prefix_phase(torch, dev, arch, plan, params):
    """Full-width qwen3-8b on the decode 2048 x 8 plan as frozen (prefix
    reuse on, 512 host blocks), against a control with both off, in the
    same call.  16 greedy requests of 32 new tokens: 12 open with one
    1,024-token system prompt (4 blocks of 256) and a distinct tail of
    64k tokens (k seeded in 1..8); 2 are the system prompt plus one token
    (1,025 tokens, the second a repeat of the first), which ride; 2 share
    nothing.  The first request is submitted, then one request a tick.

    Checks: fewer prefill calls than the control; at least one ride; the
    tail path launched the flash kernel at an offset; each hit request's
    first-token logits within the full-depth rms-relative bound
    (:data:`FULL_TOL`) of the control's, with the noise floor of two
    right paths printed (the full prefill under another flash tile);
    greedy tokens identical until a step where the control's top-2
    margin is within :data:`FULL_TOL` of its logits' largest magnitude.
    Then a cached system-prompt block is snapshot, every cold block
    spilled to the host tier, and a shared request resubmitted: the hit
    promotes, the promoted rows equal the snapshot bitwise, and both
    tiers are whole after ``drop_block_cache()``."""
    import numpy as np

    from repro_torch.core.passes.lowering import build_run_cfg
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.prefix_cache import chain_hashes

    Rec = _recording_engine(ServeEngine)
    rng = np.random.default_rng(SEED + 3)
    V = arch.vocab_size
    system = rng.integers(0, V, 1024).astype(np.int32)
    shared = [np.concatenate([system, rng.integers(0, V, 64 * int(k))
                              .astype(np.int32)])
              for k in rng.integers(1, 9, 12)]
    ride = np.concatenate([system, rng.integers(0, V, 1).astype(np.int32)])
    alone = [rng.integers(0, V, 64 * int(k)).astype(np.int32)
             for k in rng.integers(1, 17, 2)]
    order = (shared[:6] + [ride, alone[0]] + shared[6:10]
             + [ride.copy(), alone[1]] + shared[10:])
    hit_rids = [i for i, p in enumerate(order)
                if i > 0 and len(p) > 1024 and (p[:1024] == system).all()]

    def run(reuse: bool):
        over = {} if reuse else {"kv_prefix_reuse": "off",
                                 "kv_host_blocks": 0}
        eng = Rec.from_plan(plan, params, arch=arch, seed=SEED, **over)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        eng.submit(order[0], max_new_tokens=32)
        for p in order[1:]:
            eng.step()
            eng.submit(p, max_new_tokens=32)
        done = eng.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ops.launch_counts(), flash_tail=fa.tail_launches)
        check(len(done) == len(order)
              and all(len(r.out_tokens) == 32 for r in done),
              f"shared-prefix[{'reuse' if reuse else 'control'}]: "
              f"{len(done)} of {len(order)} requests finished")
        toks = {r.rid: r.out_tokens for r in done}
        ttft = np.array([(r.t_first - r.t_submit) * 1e3 for r in done])
        n = sum(len(t) for t in toks.values())
        ps = eng.pressure_stats()
        res = {"prefill_calls": eng.prefill_calls,
               "prefill_batches": list(eng.prefill_batches),
               "tokens": n, "wall_s": wall, "tok_per_s": n / wall,
               "ttft_ms_p50": float(np.percentile(ttft, 50)),
               "ttft_ms_p95": float(np.percentile(ttft, 95)),
               "ticks": eng.tick, "launches": counts,
               "pressure": {k: ps[k] for k in (
                   "prefix_hits", "prefix_hit_tokens", "prefix_rides",
                   "cow_copies", "spills", "promotes", "shared_blocks",
                   "cached_blocks")}}
        log(f"serve[shared-prefix {'reuse' if reuse else 'control'}] "
            f"kv_prefix_reuse={eng.kv_prefix_reuse} "
            f"kv_host_blocks={eng.host_blocks} prompt_lens="
            f"{[len(p) for p in order]} prefill_calls={eng.prefill_calls} "
            f"prefill_batches={res['prefill_batches']} tokens={n} "
            f"wall_s={wall:.3f} tok_per_s={n / wall:.1f} "
            f"ttft_ms_p50={res['ttft_ms_p50']:.1f} "
            f"ttft_ms_p95={res['ttft_ms_p95']:.1f} ticks={eng.tick} "
            f"launches={counts} pressure={res['pressure']} [{CARD}]")
        return eng, toks, res

    ctl, ctl_toks, ctl_res = run(False)
    ctl_first, ctl_margins = ctl.first, ctl.margins
    del ctl
    torch.cuda.empty_cache()
    eng, toks, res = run(True)
    check(res["prefill_calls"] < ctl_res["prefill_calls"],
          f"shared-prefix: {res['prefill_calls']} prefill calls with reuse, "
          f"{ctl_res['prefill_calls']} without")
    check(res["pressure"]["prefix_rides"] >= 1,
          f"shared-prefix: no ride ({res['pressure']})")
    check(res["launches"]["flash_tail"] > 0
          and ctl_res["launches"]["flash_tail"] == 0,
          f"shared-prefix: flash at an offset launched "
          f"{res['launches']['flash_tail']} times with reuse, "
          f"{ctl_res['launches']['flash_tail']} in the control")
    # first-token logits of every hit request against the control's
    errs = {rid: _rms_rel(torch, eng.first[rid], ctl_first[rid])
            for rid in hit_rids}
    cfg = build_run_cfg(plan, arch)
    toks1 = torch.from_numpy(order[hit_rids[0]][None]).to(dev)
    want = lm.prefill(arch, params, {"tokens": toks1}, cfg)[0][:, :V]
    other = lm.prefill(arch, params, {"tokens": toks1}, dataclasses.replace(
        cfg, flash_tiles=(16, 64)))[0][:, :V]
    floor = _rms_rel(torch, other.float(), want.float())
    worst = max(errs.values())
    log(f"check shared-prefix first-token logits, tail path or ride vs the "
        f"control's full prefill, {len(errs)} hit requests: worst rms_rel="
        f"{worst:.3e} (tol {FULL_TOL}; full prefill re-tiled against "
        f"itself {floor:.3e}) per request "
        f"{ {r: round(e, 5) for r, e in errs.items()} } [{CARD}]")
    check(worst <= FULL_TOL, f"shared-prefix: first-token logits rms_rel "
          f"{worst} > {FULL_TOL}")
    compared = same = 0
    for rid, want_toks in ctl_toks.items():
        for i, (a, b) in enumerate(zip(toks[rid], want_toks)):
            compared += 1
            if a != b:
                m = ctl_margins[rid][i]
                check(m <= FULL_TOL, f"shared-prefix: request {rid} token "
                      f"{i} differs ({a} vs {b}) at a control margin {m} "
                      f"> {FULL_TOL}")
                break
            same += 1
    log(f"check shared-prefix greedy tokens vs control: {same} identical "
        f"of {compared} compared (a request is compared up to its first "
        f"difference, allowed only where the control's top-2 margin is "
        f"<= {FULL_TOL} of its largest logit) [{CARD}]")
    res.update(first_logits_rms_rel=worst, noise_floor=floor,
               tokens_compared=compared, tokens_identical=same)

    # ---- spill every cold block, then a hit promotes the system prompt
    bl = eng.block_len

    def system_block():
        """The id of the system prompt's first block and its k/v rows
        (from whichever tier holds it), on the host."""
        b = eng._prefix.match(chain_hashes(system, bl))[0]
        if eng._alloc.tier_of(b) == "hbm":
            return b, {k: eng.cache[k][:, b].cpu() for k in ("k", "v")}
        return b, {k: eng._host[k][:, b - eng.n_blocks].clone()
                   for k in ("k", "v")}

    _, snap = system_block()
    ps0 = eng.pressure_stats()
    tier0 = dict(eng.tier_ms)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_spilled = eng.spill_cached()
    spill_wall = (time.perf_counter() - t0) * 1e3
    b_host, host_rows = system_block()
    check(eng._alloc.tier_of(b_host) == "host"
          and all(torch.equal(host_rows[k], snap[k]) for k in ("k", "v")),
          f"spill: {n_spilled} blocks spilled; the system prompt's first "
          "block is not on the host tier with its rows")
    rid = eng.submit(shared[1], max_new_tokens=4)
    eng.step()                        # admission promotes, tail prefill
    torch.cuda.synchronize()
    r = next(x for x in eng.active.values() if x.rid == rid)
    same_rows = all(torch.equal(eng.cache[k][:, r.blocks[0]].cpu(),
                                snap[k]) for k in ("k", "v"))
    eng.run_until_idle()
    ps1 = eng.pressure_stats()
    promoted = ps1["promotes"] - ps0["promotes"]
    spill_ms = (eng.tier_ms["spill"] - tier0["spill"]) / max(n_spilled, 1)
    promote_ms = ((eng.tier_ms["promote"] - tier0["promote"])
                  / max(promoted, 1))
    eng.drop_block_cache()
    st = eng.block_stats()
    mem = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                mem[key] = val.strip()
    log(f"check spill -> promote: {n_spilled} cold blocks spilled "
        f"({spill_ms:.2f} ms per block of {2 * snap['k'].numel() * 2} "
        f"bytes, host copy waited for; spill_cached() {spill_wall:.1f} ms "
        f"wall), {promoted} promoted ({promote_ms:.2f} ms per block, host "
        f"time of the copy), prefix_hits {ps0['prefix_hits']} -> "
        f"{ps1['prefix_hits']}, promoted rows bitwise equal to the "
        f"snapshot: {same_rows}, block_stats after drop_block_cache={st}; "
        f"host MemTotal={mem.get('MemTotal')} "
        f"MemAvailable={mem.get('MemAvailable')} [{CARD}]")
    check(promoted >= 1 and ps1["prefix_hits"] > ps0["prefix_hits"],
          f"promote: {promoted} promotes, hits {ps0['prefix_hits']} -> "
          f"{ps1['prefix_hits']}")
    check(same_rows, "promote: promoted rows differ from the spilled rows")
    check(st["free"] == st["total"] and st["host_free"] == st["host_total"]
          and st["prefix_trie"] == 0,
          f"spill/promote: blocks leaked: {st}")
    res.update(spilled=n_spilled, promoted=promoted, spill_ms_per_block=
               spill_ms, promote_ms_per_block=promote_ms,
               promoted_rows_bitwise=same_rows, meminfo=mem, card=CARD)
    del eng
    torch.cuda.empty_cache()
    return res, ctl_res


def ssm_park_check(torch, dev, arch, plan, params, name="mamba2", **over):
    """A model with an SSM parks with its state: an engine from the plan
    with a host tier (mamba2: ``kv_host_blocks=8`` in ``over`` turns on
    parks with state for a dense engine, as in the JAX engine; hymba's
    paged plan has its own 512 host blocks, and ``over`` is empty)
    serves 3 greedy requests twice, once untouched and once with
    ``preempt(rid)`` of the request with the most output at its third
    tick.  The victim's SSM state and conv window (and a paged engine's
    KV blocks, through the host pool) go to the host and come back: no
    prefill call across the park and resume, and every request's tokens
    identical to the untouched run."""
    import numpy as np

    from repro_torch.serve.engine import ServeEngine

    rng = np.random.default_rng(SEED + 5)
    prompts = [rng.integers(0, arch.vocab_size, 64 * k).astype(np.int32)
               for k in (1, 2, 3)]
    runs = []
    for park in (False, True):
        eng = ServeEngine.from_plan(plan, params, arch=arch, seed=SEED,
                                    **over)
        for p in prompts:
            eng.submit(p, max_new_tokens=16)
        for _ in range(3):
            eng.step()
        calls = eng.prefill_calls
        if park:
            victim = max(eng.active.values(), key=lambda r: len(r.out_tokens))
            at = len(victim.out_tokens)
            eng.preempt(victim.rid)
            st = eng.preempted[0].parked_state if eng.preempted else None
            check(st is not None and "ssm" in st and "conv" in st
                  and (eng.kv_residency != "paged" or st.get("kv_host")),
                  f"{name} park: the victim did not park with its state")
        eng.run_until_idle()
        torch.cuda.synchronize()
        runs.append(({r.rid: r.out_tokens for r in eng.finished},
                     eng.prefill_calls - calls, eng.pressure_stats()))
        del eng
    (want, _, _), (got, extra, ps) = runs
    same = got == want
    log(f"check {name} park: preempt(rid={victim.rid}) after {at} tokens, "
        f"parks_with_state={ps['parks_with_state']} resumes={ps['resumes']} "
        f"resumes_by_promote={ps['resumes_by_promote']} prefill calls "
        f"across the park and resume: {extra}; tokens identical to the "
        f"untouched run: {same} [{CARD}]")
    check(ps["parks_with_state"] == ps["resumes"] == 1 and extra == 0,
          f"{name} park: {ps} with {extra} prefill calls after the park")
    check(same, f"{name} park: tokens differ from the untouched run: {got} "
          f"vs {want}")
    torch.cuda.empty_cache()
    return {"victim_tokens_at_park": at, "prefill_calls_after_park": extra,
            "tokens_identical": same,
            "resumes_by_promote": ps["resumes_by_promote"]}


def grant_phase(torch, dev):
    """Full-width, full-depth deepseek-coder-33b (62 layers, d_model
    7168, 56 / 8 heads of 128: a GQA group of 7) on one card from its
    frozen ``h100-sxm`` plan at decode 2048 x 8, whose 66.7 GB of bf16
    weights leave an 8-block pool (one 2048-token sequence) behind
    grant admission, 64 host blocks, prefix reuse and prefetch.

    ``from_plan(plan, params)`` with no keyword serves 12 greedy
    requests of 64k tokens (k seeded in 2..10) and 48 new tokens, all
    submitted at t = 0: decode ticks cross block boundaries, grants
    fail, and the ladder spills cold blocks, preempts victims that park
    their KV on the host, and resumes them by promote (staged one tick
    ahead through the pinned buffer).  Then a reserve control on the
    same weights (64 blocks, reuse and host tier off).

    Checks: the plan's decisions and its G = 7 tiles; every request
    finishes, none shed; >= 1 preemption, park with state, resume by
    promote and consumed prefetch; no request prefilled twice (every
    park kept its state); 62 flash launches a prefill call and 62 paged
    decode launches a decode tick; greedy tokens equal the control's
    until a step whose control top-2 margin is <= :data:`FULL_TOL` of
    its largest logit.  Reported: first-token logits rms-relative against
    the control's, beside the noise floor of the full prefill re-tiled.
    Then the full-depth consistency check at G = 7 (top-1 under the
    margin rule)."""
    import numpy as np

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core import specialize
    from repro_torch.core.passes.lowering import build_run_cfg
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine

    free, total = torch.cuda.mem_get_info()
    log(f"33b-grant: device memory before the weights: {free} of {total} "
        f"bytes free (torch.cuda.mem_get_info) [{CARD}]")
    arch = get_arch("deepseek-coder-33b")
    G = arch.n_heads // arch.n_kv_heads
    plan = specialize(arch, ShapeConfig("serve_h100", "decode", 2048, 8),
                      mesh_shape=(1, 1), target="h100-sxm",
                      plan_dir=PLAN_DIR)
    est = plan.estimates
    pplan = specialize(arch, ShapeConfig("prefill_h100", "prefill", 2048, 8),
                       mesh_shape=(1, 1), target="h100-sxm",
                       plan_dir=PLAN_DIR)
    dec_tile = dict(plan.partitions["decode_attention"].blocks)
    fl_tile = dict(pplan.partitions["flash_attention"].blocks)
    log(f"33b-grant plan {plan.content_hash()[:16]}: kv_admission="
        f"{est.get('kv_admission')} kv_n_blocks={est.get('kv_n_blocks')} "
        f"kv_block_len={est.get('kv_block_len')} kv_host_blocks="
        f"{est.get('kv_host_blocks')} kv_prefix_reuse="
        f"{est.get('kv_prefix_reuse')} kv_prefetch={est.get('kv_prefetch')} "
        f"persistent_bytes={est.get('persistent_bytes_per_dev')} "
        f"kv_decode_tick_us={est.get('kv_decode_tick_us')}; decode tile "
        f"{dec_tile}; prefill plan {pplan.content_hash()[:16]} flash tile "
        f"{fl_tile} (G={G}) [{CARD}]")
    check(G == 7 and est.get("kv_admission") == "grant"
          and int(est.get("kv_n_blocks", 0)) == 8
          and int(est.get("kv_block_len", 0)) == 256,
          f"33b plan: G={G} {est}")
    check(dec_tile.get("block_kv") == 256
          and fl_tile.get("block_q") == 128 // G
          and fa.kernel_tiles(G, fl_tile["block_q"], fl_tile["block_kv"])
          == (128, 128),
          f"33b plans: decode tile {dec_tile}, flash tile {fl_tile}")
    t0 = time.perf_counter()
    params = lm.init_params(arch, torch.Generator(dev).manual_seed(SEED),
                            *plan.padded_sizes())
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    free, total = torch.cuda.mem_get_info()
    log(f"weights: deepseek-coder-33b layers={arch.n_layers} "
        f"d_model={arch.d_model} heads={arch.n_heads}/{arch.n_kv_heads} "
        f"d_ff={arch.d_ff} vocab={arch.vocab_size} params={n_params} "
        f"({2 * n_params} bytes bf16) random (seed {SEED}) in "
        f"{time.perf_counter() - t0:.1f} s; {free} bytes free after "
        f"[{CARD}]")

    Rec = _recording_engine(ServeEngine)
    rng = np.random.default_rng(SEED + 7)
    V = arch.vocab_size
    prompts = [rng.integers(0, V, 64 * int(k)).astype(np.int32)
               for k in rng.integers(2, 11, 12)]

    def run(name, make):
        eng = make()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        ticks = [0]
        step = eng.step

        def counted():                 # decode ticks: the ones with slots
            n = step()
            ticks[0] += bool(eng.active) or n > 0
            return n

        eng.step = counted
        t0 = time.perf_counter()
        for p in prompts:
            eng.submit(p, max_new_tokens=48)
        done = eng.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        del eng.step        # the wrapper's closure would keep eng alive
        counts = ops.launch_counts()
        check(len(done) == len(prompts)
              and all(len(r.out_tokens) == 48 for r in done),
              f"33b-grant[{name}]: {len(done)} of {len(prompts)} requests "
              "finished")
        ttft = np.array([(r.t_first - r.t_submit) * 1e3 for r in done])
        n = sum(len(r.out_tokens) for r in done)
        ps = eng.pressure_stats()
        res = {"prefill_calls": eng.prefill_calls,
               "prefill_batches": list(eng.prefill_batches),
               "prefilled_requests": sum(eng.prefill_batches),
               "ticks": eng.tick, "decode_ticks": ticks[0], "tokens": n,
               "wall_s": wall, "tok_per_s": n / wall,
               "ttft_ms_p50": float(np.percentile(ttft, 50)),
               "ttft_ms_p95": float(np.percentile(ttft, 95)),
               "launches": counts, "tier_ms": dict(eng.tier_ms),
               "pressure": {k: ps[k] for k in (
                   "preemptions", "migrations", "grant_denials", "shed",
                   "parks_with_state", "resumes", "resumes_by_promote",
                   "prefetch_staged", "prefetch_consumed", "spills",
                   "promotes", "prefix_hits", "cached_blocks")},
               "kv_admission": eng.kv_admission, "n_blocks": eng.n_blocks,
               "host_blocks": eng.host_blocks, "card": CARD}
        log(f"serve[33b-grant {name}] kv_admission={eng.kv_admission} "
            f"n_blocks={eng.n_blocks} host_blocks={eng.host_blocks} "
            f"kv_prefetch={eng.kv_prefetch} prompt_lens="
            f"{[len(p) for p in prompts]} prefill_calls={eng.prefill_calls} "
            f"prefill_batches={res['prefill_batches']} ticks={eng.tick} "
            f"decode_ticks={ticks[0]} tokens={n} wall_s={wall:.3f} "
            f"tok_per_s={n / wall:.2f} ttft_ms_p50={res['ttft_ms_p50']:.1f} "
            f"ttft_ms_p95={res['ttft_ms_p95']:.1f} launches={counts} "
            f"pressure={res['pressure']} tier_ms={res['tier_ms']} "
            f"[{CARD}]")
        eng.drop_block_cache()
        st = eng.block_stats()
        check(st["free"] == st["total"] and st["host_free"] == st["host_total"],
              f"33b-grant[{name}]: blocks not all returned: {st}")
        check(counts["flash_attention"] == arch.n_layers * eng.prefill_calls
              and counts["paged_decode_attention"]
              == arch.n_layers * ticks[0] > 0,
              f"33b-grant[{name}]: {counts} for {eng.prefill_calls} prefill "
              f"calls and {ticks[0]} decode ticks of {arch.n_layers} layers")
        toks = {r.rid: r.out_tokens for r in done}
        first, margins = eng.first, eng.margins
        del eng, step, counted
        torch.cuda.empty_cache()
        return toks, first, margins, res

    toks, first, _, res = run("plan", lambda: Rec.from_plan(plan, params))
    ps = res["pressure"]
    check(ps["shed"] == 0 and ps["preemptions"] >= 1
          and ps["parks_with_state"] >= 1 and ps["resumes_by_promote"] >= 1
          and ps["prefetch_consumed"] >= 1,
          f"33b-grant: the traffic did not walk the ladder: {ps}")
    check(res["prefilled_requests"] == len(prompts),
          f"33b-grant: {res['prefilled_requests']} prefilled requests for "
          f"{len(prompts)} (a park lost its state and re-prefilled)")
    cfg = build_run_cfg(plan, arch)
    ctl_toks, ctl_first, ctl_margins, ctl = run("reserve control", lambda: Rec(
        arch, params, cfg, max_batch=8, max_len=2048,
        kv_heads=cfg.kv_heads_padded, seed=SEED, kv_residency="paged",
        kv_block_len=256, kv_n_blocks=64, kv_admission="reserve",
        kv_prefix_reuse="off", kv_host_blocks=0))
    check(ctl["pressure"]["preemptions"] == 0
          and ctl["pressure"]["grant_denials"] == 0,
          f"33b control walked the ladder: {ctl['pressure']}")
    errs = {rid: _rms_rel(torch, first[rid], ctl_first[rid])
            for rid in ctl_first}
    toks1 = torch.from_numpy(prompts[0][None]).to(dev)
    want = lm.prefill(arch, params, {"tokens": toks1}, cfg)[0][:, :V]
    other = lm.prefill(arch, params, {"tokens": toks1}, dataclasses.replace(
        cfg, flash_tiles=(64 // G, 64)))[0][:, :V]
    floor = _rms_rel(torch, other.float(), want.float())
    worst = max(errs.values())
    # reported beside the noise floor; the tokens are held below
    log(f"report 33b-grant first-token logits vs the reserve control: "
        f"worst rms_rel={worst:.3e} (the full prefill re-tiled to "
        f"{64 // G} x 64 against itself {floor:.3e}); "
        f"{sum(e == 0.0 for e in errs.values())} of {len(errs)} bitwise "
        f"equal; per request { {r: round(e, 5) for r, e in errs.items()} } "
        f"[{CARD}]")
    compared = same = 0
    for rid, want_toks in ctl_toks.items():
        for i, (a, b) in enumerate(zip(toks[rid], want_toks)):
            compared += 1
            if a != b:
                m = ctl_margins[rid][i]
                check(m <= FULL_TOL, f"33b-grant: request {rid} token {i} "
                      f"differs ({a} vs {b}) at a control margin {m} > "
                      f"{FULL_TOL}")
                break
            same += 1
    log(f"check 33b-grant greedy tokens vs the reserve control: {same} "
        f"identical of {compared} compared (a request is compared up to its "
        f"first difference, allowed only where the control's top-2 margin "
        f"is <= {FULL_TOL} of its largest logit) [{CARD}]")
    res.update(first_logits_rms_rel=worst, noise_floor=floor,
               tokens_compared=compared, tokens_identical=same)
    consistency_check(torch, dev, arch, params, cfg,
                      int(est["kv_block_len"]), top1_margin=FULL_TOL)
    del params
    torch.cuda.empty_cache()
    return res, ctl


def _new_arch_plan(torch, dev, name, arch=None):
    """The full-width arch (``arch``, where given, cut from it), its
    ``h100-sxm`` decode 2048 x 8 plan and prefill plan (stored), and
    random weights from :data:`SEED`, with the device memory logged
    before and after the weights."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core import specialize
    from repro_torch.models import lm

    free, total = torch.cuda.mem_get_info()
    log(f"{name}: device memory before the weights: {free} of {total} bytes "
        f"free (torch.cuda.mem_get_info) [{CARD}]")
    arch = arch or get_arch(name)
    plan = specialize(arch, ShapeConfig("serve_h100", "decode", 2048, 8),
                      mesh_shape=(1, 1), target="h100-sxm",
                      plan_dir=PLAN_DIR)
    pplan = specialize(arch, ShapeConfig("prefill_h100", "prefill", 2048, 8),
                       mesh_shape=(1, 1), target="h100-sxm",
                       plan_dir=PLAN_DIR)
    t0 = time.perf_counter()
    params = lm.init_params(arch, torch.Generator(dev).manual_seed(SEED),
                            *plan.padded_sizes())
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    free, total = torch.cuda.mem_get_info()
    log(f"weights: {name} layers={arch.n_layers} d_model={arch.d_model} "
        f"heads={arch.n_heads}/{arch.n_kv_heads} of {arch.hd} "
        f"d_ff={arch.d_ff} gated_mlp={arch.gated_mlp} ssm_heads="
        f"{arch.ssm_heads if arch.has_ssm else 0} vocab={arch.vocab_size} "
        f"params={n_params} random (seed {SEED}) in "
        f"{time.perf_counter() - t0:.1f} s; {free} bytes free after "
        f"[{CARD}]")
    est = plan.estimates
    tiles = {k: dict(v.blocks) for k, v in plan.partitions.items()}
    ptiles = {k: dict(v.blocks) for k, v in pplan.partitions.items()}
    log(f"{name} plan {plan.content_hash()[:16]}: kv_residency="
        f"{est.get('kv_residency')} kv_admission={est.get('kv_admission')} "
        f"kv_n_blocks={est.get('kv_n_blocks')} kv_block_len="
        f"{est.get('kv_block_len')} kv_host_blocks="
        f"{est.get('kv_host_blocks')} kv_prefix_reuse="
        f"{est.get('kv_prefix_reuse')} tiles {tiles}; prefill plan "
        f"{pplan.content_hash()[:16]} tiles {ptiles} [{CARD}]")
    check(est.get("kv_residency") == "paged"
          and est.get("kv_admission") == "reserve"
          and int(est.get("kv_n_blocks", 0)) == 64
          and int(est.get("kv_block_len", 0)) == 256
          and int(est.get("kv_host_blocks", 0)) == 512
          and est.get("kv_prefix_reuse") == "on",
          f"{name} plan: {est}")
    G = arch.n_heads // arch.n_kv_heads
    check(tiles.get("decode_attention") == {"block_kv": 256,
                                             "head_dim": arch.hd}
          and ptiles.get("flash_attention", {}).get("block_q") == 128 // G,
          f"{name} plans: decode {tiles.get('decode_attention')}, flash "
          f"{ptiles.get('flash_attention')}")
    return arch, plan, params


def _check_layer_launches(name, arch, counts, res):
    """Each prefill call launches flash (and, with an SSM, the SSD scan)
    once a layer, each decode tick the paged decode kernel once a
    layer."""
    calls, ticks = res["prefill_calls"], res["decode_ticks"]
    L = arch.n_layers
    want = {"flash_attention": L * calls, "paged_decode_attention": L * ticks,
            "ssd_scan": L * calls if arch.has_ssm else 0}
    log(f"serve[{name}] launches {counts}: {L} layers x {calls} prefill calls"
        f" and x {ticks} decode ticks [{CARD}]")
    check(calls > 0 and ticks > 0
          and all(counts[k] == v for k, v in want.items()),
          f"serve[{name}]: launches {counts}, want {want}")


def hymba_shared_prefix_check(torch, dev, arch, plan, params):
    """hymba on its plan as frozen (prefix reuse on): 4 greedy requests
    open with one 1,024-token system prompt and a tail of 64k tokens (k
    seeded in 1..8); the first is submitted, then the rest a tick later.
    The trie aliases the system prompt's blocks (``prefix_hits`` > 0),
    but a hybrid's SSM state needs every token: every request is
    prefilled whole (no flash launch at a query offset, no ride, 4
    prefilled requests).  Against a control with reuse and the host tier
    off, per hit request at its first decode step (the first read of
    the aliased blocks: a whole prefill never reads them), within the
    full-depth rms-relative bound (:data:`FULL_TOL`) of the control's:
    the K/V rows its table maps for the system prompt, block by block,
    and the step's logits.  Beside each, the noise floor of two right
    paths (the dense prefill and step under another flash tile) and one
    system-prompt block's rows replaced by another block's, as a wrong
    table entry would read them: the rows' check must fail that, by
    :data:`FULL_TOL`; the logits' is only reported (random weights
    attend nearly evenly, so one block of ~1,500 moves them little).
    Greedy tokens are reported up to a request's first difference,
    which is allowed only where the control's top-2 margin is <=
    :data:`FULL_TOL` of its largest logit."""
    import numpy as np

    from repro_torch.core.passes.lowering import build_run_cfg
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine

    bl = int(plan.estimates["kv_block_len"])
    nsys = 1024 // bl                    # the system prompt's blocks
    Rec = _recording_engine(ServeEngine, prefix_blocks=nsys)
    rng = np.random.default_rng(SEED + 9)
    V = arch.vocab_size
    system = rng.integers(0, V, 1024).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(0, V, 64 * int(k))
                               .astype(np.int32)])
               for k in rng.integers(1, 9, 4)]
    out = {}
    for reuse in (False, True):
        over = {} if reuse else {"kv_prefix_reuse": "off",
                                 "kv_host_blocks": 0}
        eng = Rec.from_plan(plan, params, arch=arch, seed=SEED, **over)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        eng.submit(prompts[0], max_new_tokens=32)
        eng.step()
        for p in prompts[1:]:
            eng.submit(p, max_new_tokens=32)
        done = eng.run_until_idle()
        torch.cuda.synchronize()
        ps = eng.pressure_stats()
        counts = dict(ops.launch_counts(), flash_tail=fa.tail_launches)
        out[reuse] = dict(
            toks={r.rid: r.out_tokens for r in done}, margins=eng.margins,
            second=eng.second, rows=eng.prefix_rows,
            prefill_calls=eng.prefill_calls,
            prefilled=sum(eng.prefill_batches), launches=counts,
            pressure={k: ps[k] for k in ("prefix_hits", "prefix_hit_tokens",
                                         "prefix_rides", "shared_blocks",
                                         "cached_blocks")})
        log(f"serve[hymba shared-prefix {'reuse' if reuse else 'control'}] "
            f"prompt_lens={[len(p) for p in prompts]} prefill_calls="
            f"{eng.prefill_calls} prefill_batches={list(eng.prefill_batches)}"
            f" launches={counts} pressure={out[reuse]['pressure']} [{CARD}]")
        check(len(done) == 4 and all(len(r.out_tokens) == 32 for r in done),
              f"hymba shared-prefix: {len(done)} of 4 requests finished")
        eng.drop_block_cache()
        del eng
        torch.cuda.empty_cache()
    got, ctl = out[True], out[False]
    check(got["pressure"]["prefix_hits"] > 0
          and got["pressure"]["prefix_rides"] == 0
          and got["launches"]["flash_tail"] == 0
          and got["prefilled"] == ctl["prefilled"] == 4
          and got["launches"]["flash_attention"]
          == arch.n_layers * got["prefill_calls"],
          f"hymba shared-prefix: the hybrid skipped prefix compute or rode: "
          f"{got['pressure']} {got['launches']}")

    # ---- the first decode step of every hit request (requests 1..3,
    # behind request 0's blocks) against the control's: the system
    # prompt's K/V rows always, the logits where both runs sampled the
    # same first token

    def block_errs(a, b):
        """rms-relative error of each of the system prompt's blocks,
        ``(2, L, nsys, bl, K, hd)`` rows (or dense ``(2, L, 1, S, K,
        hd)``, cut into blocks)."""
        a, b = (t[:, :, :, :nsys * bl].reshape(*t.shape[:2], nsys, bl,
                                                 *t.shape[-2:])
                if t.shape[2] == 1 else t for t in (a, b))
        return [_rms_rel(torch, a[:, :, i].float(), b[:, :, i].float())
                for i in range(nsys)]

    rows_err, errs = {}, {}
    for rid in range(1, 4):
        rows_err[rid] = max(block_errs(got["rows"][rid], ctl["rows"][rid]))
        a, b = got["toks"][rid][0], ctl["toks"][rid][0]
        if a != b:
            m = ctl["margins"][rid][0]
            check(m <= FULL_TOL, f"hymba shared-prefix: request {rid}'s "
                  f"first token differs ({a} vs {b}) at a control margin "
                  f"{m} > {FULL_TOL}")
            continue
        errs[rid] = _rms_rel(torch, got["second"][rid],
                             ctl["second"][rid])
    check(bool(errs), "hymba shared-prefix: no hit request sampled the "
          "control's first token")
    # the wrong-block control on the rows: block nsys - 1 read as block 0
    rid = min(errs)
    bad = got["rows"][rid].clone()
    bad[:, :, nsys - 1] = bad[:, :, 0]
    wrong_rows = max(block_errs(bad, ctl["rows"][rid]))
    # the noise floors and the logits' wrong-block number, on the dense
    # path at the first compared request
    cfg = build_run_cfg(plan, arch)
    G = arch.n_heads // arch.n_kv_heads
    toks = torch.from_numpy(prompts[rid][None]).to(dev)
    tok0 = torch.tensor([[got["toks"][rid][0]]], dtype=torch.int32,
                        device=dev)
    max_len = -(-(toks.shape[1] + 1) // bl) * bl

    def step(run_cfg, wrong_block=False):
        """The dense prefill's system-prompt rows, ``(2, L, 1, S, K,
        hd)``, and the logits of the decode step after it."""
        _, cache = lm.prefill(arch, params, {"tokens": toks}, run_cfg,
                              max_len=max_len)
        if wrong_block:
            for name in ("k", "v"):
                cache[name][:, :, (nsys - 1) * bl:nsys * bl] = \
                    cache[name][:, :, :bl]
        rows = torch.stack([cache[n][:, :1, :nsys * bl] for n in ("k", "v")])
        logits = lm.decode_step(arch, params, cache, {"tokens": tok0},
                                run_cfg)[0][:, :V].float()
        return rows, logits

    rows, right = step(cfg)
    rows2, other = step(dataclasses.replace(cfg, flash_tiles=(64 // G, 64)))
    floor, rows_floor = _rms_rel(torch, other, right), max(block_errs(rows2,
                                                                      rows))
    wrong = _rms_rel(torch, step(cfg, wrong_block=True)[1], right)
    worst, worst_rows = max(errs.values()), max(rows_err.values())
    log(f"check hymba shared-prefix first decode step vs the control's, "
        f"system-prompt K/V rows ({nsys} blocks) of 3 hit requests: worst "
        f"block rms_rel={worst_rows:.3e} (tol {FULL_TOL}; dense prefill "
        f"re-tiled against itself {rows_floor:.3e}; block {nsys - 1} read "
        f"as block 0 {wrong_rows:.3e}) per request "
        f"{ {r: round(e, 5) for r, e in rows_err.items()} }; logits of "
        f"{len(errs)} requests with the control's first token: worst "
        f"rms_rel={worst:.3e} (tol {FULL_TOL}; dense prefill and step "
        f"re-tiled against themselves {floor:.3e}; block {nsys - 1} read as "
        f"block 0, reported only, {wrong:.3e}) per request "
        f"{ {r: round(e, 5) for r, e in errs.items()} } [{CARD}]")
    check(worst_rows <= FULL_TOL and worst <= FULL_TOL,
          f"hymba shared-prefix: first decode step rows {worst_rows} / "
          f"logits {worst} rms_rel > {FULL_TOL}")
    check(wrong_rows > FULL_TOL, f"hymba shared-prefix: the wrong-block "
          f"control passed the rows' check ({wrong_rows})")
    compared = same = 0
    for rid, want_toks in ctl["toks"].items():
        for i, (a, b) in enumerate(zip(got["toks"][rid], want_toks)):
            compared += 1
            if a != b:
                m = ctl["margins"][rid][i]
                check(m <= FULL_TOL, f"hymba shared-prefix: request {rid} "
                      f"token {i} differs ({a} vs {b}) at a control margin "
                      f"{m} > {FULL_TOL}")
                break
            same += 1
    log(f"check hymba shared-prefix: prefix_hits="
        f"{got['pressure']['prefix_hits']} rides=0, flash at an offset 0, "
        f"4 of 4 requests prefilled whole; greedy tokens vs the control: "
        f"{same} identical of {compared} compared [{CARD}]")
    drop = ("toks", "margins", "second", "rows")
    return {"reuse": {k: v for k, v in got.items() if k not in drop},
            "control": {k: v for k, v in ctl.items() if k not in drop},
            "prefix_rows_rms_rel": worst_rows, "rows_noise_floor": rows_floor,
            "rows_wrong_block_rms_rel": wrong_rows,
            "decode1_logits_rms_rel": worst, "noise_floor": floor,
            "logits_wrong_block_rms_rel": wrong,
            "tokens_compared": compared, "tokens_identical": same}


def hymba_phase(torch, dev):
    """Full-width, full-depth hymba-1.5b (32 layers, d_model 1600, 25 / 5
    heads of 64 and 50 SSM heads of 64 with state 16 in parallel in every
    layer; layers 0, 16 and 31 global, the rest through a 1024-token
    window) from its frozen ``h100-sxm`` plan: ``from_plan(plan,
    params)`` with no keyword serves 16 requests of 64k tokens (k seeded
    in 1..24, so prompts cross the window), 32 new tokens, temperature
    alternating 0 and 0.8: 32 flash, 32 SSD-scan launches a prefill call
    and 32 paged-decode launches a tick.  Then the shared-prefix check
    (blocks aliased, compute never skipped), a park with state (blocks
    and SSM rows) and the full-depth consistency check past the
    window."""
    from repro_torch.core.passes.lowering import build_run_cfg

    arch, plan, params = _new_arch_plan(torch, dev, "hymba-1.5b")
    counts, res = serve_phase(torch, dev, "hymba", arch, plan, params,
                              n_requests=16, new_tokens=32)
    _check_layer_launches("hymba", arch, counts, res)
    res["shared_prefix"] = hymba_shared_prefix_check(torch, dev, arch, plan,
                                                     params)
    res["park"] = ssm_park_check(torch, dev, arch, plan, params,
                                 name="hymba")
    check(res["park"]["resumes_by_promote"] == 1,
          f"hymba park: {res['park']}")
    consistency_check(torch, dev, arch, params, build_run_cfg(plan, arch),
                      int(plan.estimates["kv_block_len"]),
                      top1_margin=FULL_TOL, P=1100)
    del params
    torch.cuda.empty_cache()
    return counts, res, plan


def minitron_phase(torch, dev):
    """Full-width, full-depth minitron-8b (32 layers, d_model 4096, 32 /
    8 heads of 128, a squared-ReLU FFN of 16384, vocab 256000) from its
    frozen ``h100-sxm`` plan: ``from_plan(plan, params)`` with no
    keyword serves the paged phase's 16 requests (32 flash launches a
    prefill call, 32 paged-decode launches a tick), then the full-depth
    consistency check."""
    from repro_torch.core.passes.lowering import build_run_cfg

    arch, plan, params = _new_arch_plan(torch, dev, "minitron-8b")
    counts, res = serve_phase(torch, dev, "minitron", arch, plan, params,
                              n_requests=16, new_tokens=32)
    _check_layer_launches("minitron", arch, counts, res)
    consistency_check(torch, dev, arch, params, build_run_cfg(plan, arch),
                      int(plan.estimates["kv_block_len"]),
                      top1_margin=FULL_TOL)
    del params
    torch.cuda.empty_cache()
    return counts, res, plan


class RouteDrops:
    """Counts MoE routing drops on the card from ``moe.route``'s own
    output, without touching the engine or the model: while active,
    ``moe.route`` is wrapped, and each call keeps its group length T,
    its top-k and, on the device, the choices of each group (row) that
    got a slot (``dispatch`` holds one 1 for each choice within
    capacity: the sum of ``route``'s ``within`` masks).  Read after a
    synchronise."""

    def __init__(self, torch):
        from repro_torch.models import moe
        self.torch, self.moe, self.real, self.calls = torch, moe, moe.route, []

    def __enter__(self):
        real, calls, f32 = self.real, self.calls, self.torch.float32

        def counting(x, router_w, top_k, capacity, **kw):
            out = real(x, router_w, top_k, capacity, **kw)
            calls.append((x.shape[1], top_k,
                          out[0].sum((1, 2, 3), dtype=f32)))
            return out

        self.moe.route = counting
        return self

    def __exit__(self, *exc):
        self.moe.route = self.real

    def row_drops(self, prefill: bool = True):
        """Drops of each call, per group: ``[(T, [drops of row b])]``
        (prefill calls T > 1, or the decode calls T = 1)."""
        return [(T, [T * k - int(n) for n in kept.tolist()])
                for T, k, kept in self.calls if (T > 1) == prefill]

    def per_prefill_call(self, moe_layers: int):
        """Drops of each prefill call, summed over its rows (dummy rows
        of a padded batch included) and its ``moe_layers`` route calls."""
        d = [sum(rows) for _, rows in self.row_drops()]
        return [sum(d[i:i + moe_layers]) for i in range(0, len(d), moe_layers)]



def _moe_layers(arch) -> int:
    return arch.n_layers // max(arch.moe_interleave, 1)


def _log_moe_weights(name, arch, params):
    moe = _moe_leaves(params)
    log(f"weights: {name} experts={arch.n_experts} top_k="
        f"{arch.experts_per_token} moe_d_ff={arch.moe_d_ff} shared_experts="
        f"{arch.n_shared_experts} moe_interleave={arch.moe_interleave} "
        f"capacity_factor={arch.capacity_factor}; MoE leaves "
        f"{ {k: tuple(v.shape) for k, v in moe.items()} } [{CARD}]")


def _moe_leaves(params):
    """The stacked MoE leaves (``blocks["moe"]`` of a per-layer MoE tree,
    ``blocks["moe"]["moe"]`` of a super-block tree)."""
    blocks = params["blocks"]
    return blocks["moe"]["moe"] if "dense" in blocks else blocks["moe"]


def granite_phase(torch, dev):
    """Full-width, full-depth granite-moe-1b-a400m (24 layers, d_model
    1024, 16 / 8 heads of 64, 32 experts top-8 of ff 512 in every layer,
    tied vocab 49155): ``from_plan(plan, params)`` on its ``h100-sxm``
    decode 2048 x 8 plan (``dense_einsum``) serves the paged phase's 16
    requests (24 flash launches a prefill call, 24 paged-decode launches
    a tick), then the shared-prefix check and the full-depth consistency
    check; then the decode 1024 x 8 plan (``gshard_einsum``) on the same
    weights serves 16 requests of 64k tokens (k seeded in 1..12), with
    the routing drops of each prefill call printed, and a prefill batch
    held under ``gshard_einsum`` against ``dense_einsum`` on its rows
    with no drop."""
    import gc

    from repro_torch.configs import ShapeConfig
    from repro_torch.core import specialize
    from repro_torch.core.passes.lowering import build_run_cfg

    arch, plan, params = _new_arch_plan(torch, dev, GRANITE)
    _log_moe_weights("granite", arch, params)
    check(plan.estimates.get("moe_impl") == "dense_einsum",
          f"granite 2048 plan: moe_impl {plan.estimates.get('moe_impl')}")
    with RouteDrops(torch) as routes:
        counts, res = serve_phase(torch, dev, "granite", arch, plan, params,
                                  n_requests=16, new_tokens=32)
    check(not routes.calls, "granite dense_einsum: route() was called")
    _check_layer_launches("granite", arch, counts, res)
    res["shared_prefix"] = moe_shared_prefix_check(torch, dev, arch, plan,
                                                   params)
    consistency_check(torch, dev, arch, params, build_run_cfg(plan, arch),
                      int(plan.estimates["kv_block_len"]),
                      top1_margin=FULL_TOL)

    gplan = specialize(arch, ShapeConfig("serve_h100_1024", "decode", 1024,
                                         8),
                       mesh_shape=(1, 1), target="h100-sxm",
                       plan_dir=PLAN_DIR)
    est = gplan.estimates
    tiles = {k: dict(v.blocks) for k, v in gplan.partitions.items()}
    log(f"granite plan 1024 x 8 {gplan.content_hash()[:16]}: moe_impl="
        f"{est.get('moe_impl')} kv_residency={est.get('kv_residency')} "
        f"kv_n_blocks={est.get('kv_n_blocks')} kv_block_len="
        f"{est.get('kv_block_len')} tiles {tiles} [{CARD}]")
    check(est.get("moe_impl") == "gshard_einsum"
          and est.get("kv_residency") == "paged"
          and int(est.get("kv_block_len", 0)) == 128
          and tiles.get("decode_attention") == {"block_kv": 128,
                                                 "head_dim": 64},
          f"granite 1024 plan: {est} {tiles}")
    with RouteDrops(torch) as routes:
        gcounts, gres = serve_phase(torch, dev, "granite-gshard", arch,
                                    gplan, params, n_requests=16,
                                    new_tokens=32, max_k=12)
        torch.cuda.synchronize()
        drops = routes.per_prefill_call(_moe_layers(arch))
        dec_drops = sum(sum(r) for _, r in routes.row_drops(prefill=False))
    _check_layer_launches("granite-gshard", arch, gcounts, gres)
    log(f"serve[granite-gshard] routing drops per prefill call (choices "
        f"past capacity, summed over the call's rows and 24 layers; C = "
        f"_capacity(S, 32, 8, 1.25)): {drops}; decode ticks: {dec_drops} "
        f"(C = 4 for one token) [{CARD}]")
    check(len(drops) == gres["prefill_calls"] and dec_drops == 0,
          f"granite gshard: {len(drops)} prefill calls routed of "
          f"{gres['prefill_calls']}, {dec_drops} decode drops")
    gres["drops_per_prefill_call"] = drops
    res["gshard"] = gres
    res["gshard_vs_dense"] = gshard_vs_dense_check(
        torch, dev, arch, params, build_run_cfg(gplan, arch))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return counts, gcounts, res, plan, gplan


def gshard_vs_dense_check(torch, dev, arch, params, cfg):
    """Full width and depth granite: the prefill logits of 8 rows of S
    tokens under ``gshard_einsum`` (each row its routing group, C =
    ``_capacity(S, 32, 8, 1.25)``) against ``dense_einsum`` on the same
    weights.  The two paths compute the same function on a row where no
    layer drops a choice: S is the longest of 1024, 256, 64, 16 and 4
    with such a row (every row's drops printed; at S = 4 no expert can
    take more than its C = 4 tokens), and those rows are held at
    :data:`FULL_TOL`, rms-relative, with top-1 tokens equal where the
    top-2 margin exceeds it, beside the noise floor of two right paths
    (the dense path under another flash tile) and a wrong-token control
    that must fail."""
    from repro_torch.models import lm

    V = arch.vocab_size
    dense = dataclasses.replace(cfg, moe_impl="dense_einsum")
    tried = {}
    for S in (1024, 256, 64, 16, 4):
        g = torch.Generator(dev).manual_seed(SEED + 20)
        toks = torch.randint(0, V, (8, S), generator=g, device=dev,
                             dtype=torch.int32)
        with RouteDrops(torch) as routes:
            got = lm.prefill(arch, params, {"tokens": toks}, cfg)[0][:, :V]
            torch.cuda.synchronize()
            per_row = [sum(rows[b] for _, rows in routes.row_drops())
                       for b in range(8)]
        tried[S] = per_row
        rows = [b for b, n in enumerate(per_row) if n == 0]
        log(f"check granite gshard vs dense: S={S}, routing drops per row "
            f"over {_moe_layers(arch)} layers {per_row}; {len(rows)} rows "
            f"without a drop {rows} [{CARD}]")
        if rows:
            break
    check(bool(rows), "granite gshard vs dense: every row dropped a choice "
          f"at every length tried: {tried}")
    got = got.float()[rows]
    want = lm.prefill(arch, params, {"tokens": toks}, dense)[0][:, :V]
    want = want.float()[rows]
    G = arch.n_heads // arch.n_kv_heads
    other = lm.prefill(arch, params, {"tokens": toks}, dataclasses.replace(
        dense, flash_tiles=(64 // G, 64)))[0][:, :V].float()[rows]
    wrong_toks = toks.clone()
    wrong_toks[:, -1] = (toks[:, -1] + 1) % V
    wrong = lm.prefill(arch, params, {"tokens": wrong_toks}, cfg)[0][:, :V]
    rms = _rms_rel(torch, got, want)
    floor = _rms_rel(torch, other, want)
    control = _rms_rel(torch, wrong.float()[rows], want)
    top2 = want.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]) / want.abs().amax(-1)
    agree = got.argmax(-1) == want.argmax(-1)
    top1 = bool((agree | (margin <= FULL_TOL)).all())
    log(f"check granite gshard vs dense prefill logits on {len(rows)} "
        f"drop-free rows of S={S}: rms_rel={rms:.3e} (tol {FULL_TOL}; dense "
        f"under "
        f"another flash tile {floor:.3e}; wrong-token control "
        f"{control:.3e}) top1_agree={agree.tolist()} [{CARD}]")
    check(rms <= FULL_TOL and top1,
          f"granite gshard vs dense: rms_rel {rms} or top-1 differs")
    check(control > FULL_TOL,
          f"granite gshard vs dense: the wrong-token control passed "
          f"({control})")
    return {"S": S, "drops_per_row": tried, "rows_compared": rows,
            "rms_rel": rms, "noise_floor": floor, "control": control}


def moe_shared_prefix_check(torch, dev, arch, plan, params):
    """granite on its 2048 x 8 plan as frozen (``dense_einsum``, prefix
    reuse on): 4 greedy requests open with one 1,024-token system prompt
    and a tail of 64k tokens (k seeded in 1..8); the first is submitted,
    then the rest a tick later, against a control with reuse and the
    host tier off.  Under ``dense_einsum`` a token's experts depend on
    that token alone, so the tail prefill computes what the full prefill
    does: the hit requests run flash at an offset, their first-token
    logits are held within :data:`FULL_TOL` of the control's (the noise
    floor of the full prefill under another flash tile printed beside)
    and greedy tokens are compared under the margin rule.  Both tiers
    are whole after ``drop_block_cache()``."""
    import numpy as np

    from repro_torch.core.passes.lowering import build_run_cfg
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine

    Rec = _recording_engine(ServeEngine)
    rng = np.random.default_rng(SEED + 11)
    V = arch.vocab_size
    system = rng.integers(0, V, 1024).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(0, V, 64 * int(k))
                               .astype(np.int32)])
               for k in rng.integers(1, 9, 4)]
    out = {}
    for reuse in (False, True):
        over = {} if reuse else {"kv_prefix_reuse": "off",
                                 "kv_host_blocks": 0}
        eng = Rec.from_plan(plan, params, arch=arch, seed=SEED, **over)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        eng.submit(prompts[0], max_new_tokens=32)
        eng.step()
        for p in prompts[1:]:
            eng.submit(p, max_new_tokens=32)
        done = eng.run_until_idle()
        torch.cuda.synchronize()
        ps = eng.pressure_stats()
        counts = dict(ops.launch_counts(), flash_tail=fa.tail_launches)
        out[reuse] = dict(
            toks={r.rid: r.out_tokens for r in done}, margins=eng.margins,
            first=eng.first, prefill_calls=eng.prefill_calls,
            launches=counts,
            pressure={k: ps[k] for k in ("prefix_hits", "prefix_hit_tokens",
                                         "prefix_rides", "shared_blocks",
                                         "cached_blocks")})
        log(f"serve[granite shared-prefix {'reuse' if reuse else 'control'}]"
            f" prompt_lens={[len(p) for p in prompts]} prefill_calls="
            f"{eng.prefill_calls} prefill_batches={list(eng.prefill_batches)}"
            f" launches={counts} pressure={out[reuse]['pressure']} [{CARD}]")
        check(len(done) == 4 and all(len(r.out_tokens) == 32 for r in done),
              f"granite shared-prefix: {len(done)} of 4 requests finished")
        eng.drop_block_cache()
        st = eng.block_stats()
        check(st["free"] == st["total"]
              and st["host_free"] == st["host_total"],
              f"granite shared-prefix: blocks not all returned: {st}")
        del eng
        torch.cuda.empty_cache()
    got, ctl = out[True], out[False]
    check(got["pressure"]["prefix_hits"] >= 3
          and got["launches"]["flash_tail"] > 0
          and ctl["launches"]["flash_tail"] == 0,
          f"granite shared-prefix: no tail prefill: {got['pressure']} "
          f"{got['launches']} / control {ctl['launches']}")
    errs = {rid: _rms_rel(torch, got["first"][rid], ctl["first"][rid])
            for rid in range(1, 4)}
    cfg = build_run_cfg(plan, arch)
    G = arch.n_heads // arch.n_kv_heads
    toks1 = torch.from_numpy(prompts[1][None]).to(dev)
    want = lm.prefill(arch, params, {"tokens": toks1}, cfg)[0][:, :V]
    other = lm.prefill(arch, params, {"tokens": toks1}, dataclasses.replace(
        cfg, flash_tiles=(64 // G, 64)))[0][:, :V]
    floor = _rms_rel(torch, other.float(), want.float())
    worst = max(errs.values())
    log(f"check granite shared-prefix first-token logits, tail prefill vs "
        f"the control's full prefill, 3 hit requests: worst rms_rel="
        f"{worst:.3e} (tol {FULL_TOL}; full prefill re-tiled against itself "
        f"{floor:.3e}) per request "
        f"{ {r: round(e, 5) for r, e in errs.items()} }"
        f" [{CARD}]")
    check(worst <= FULL_TOL, f"granite shared-prefix: first-token logits "
          f"rms_rel {worst} > {FULL_TOL}")
    compared = same = 0
    for rid, want_toks in ctl["toks"].items():
        for i, (a, b) in enumerate(zip(got["toks"][rid], want_toks)):
            compared += 1
            if a != b:
                m = ctl["margins"][rid][i]
                check(m <= FULL_TOL, f"granite shared-prefix: request {rid} "
                      f"token {i} differs ({a} vs {b}) at a control margin "
                      f"{m} > {FULL_TOL}")
                break
            same += 1
    log(f"check granite shared-prefix greedy tokens vs control: {same} "
        f"identical of {compared} compared [{CARD}]")
    drop = ("toks", "margins", "first")
    return {"reuse": {k: v for k, v in got.items() if k not in drop},
            "control": {k: v for k, v in ctl.items() if k not in drop},
            "first_logits_rms_rel": worst, "noise_floor": floor,
            "tokens_compared": compared, "tokens_identical": same}


def llama4_phase(torch, dev):
    """llama4-maverick-400b-a17b at full width cut to one [dense, MoE]
    super-block (``n_layers`` 48 -> 2, 37.4 GB of bf16 weights; the only
    cut): d_model 5120, 40 / 8 heads of 128 (G = 5), a dense SwiGLU FFN
    of 16384, then 128 experts top-1 of ff 8192 beside one shared
    expert, untied vocab 202048.  ``from_plan(plan, params)`` on the cut
    arch's decode 2048 x 8 plan (``gshard_einsum``) serves 8 requests (2
    flash launches a prefill call, 2 paged-decode launches a tick), the
    routing drops of each prefill call printed; then the full-depth
    consistency check under ``dense_einsum`` on the same weights: a
    decode step (one token, C = 4) never drops a choice where a
    ``gshard_einsum`` prefill of 301 tokens over 128 experts (C = 4) may
    drop the last token's, so only the dense path makes the two compute
    the same function (the gshard path is held on the serve phase, by
    the small MoE check and against the JAX package on the CPU)."""
    import gc

    from repro_torch.configs import get_arch
    from repro_torch.core.passes.lowering import build_run_cfg

    full = get_arch(LLAMA4)
    cut = dataclasses.replace(full, n_layers=2)
    log(f"cut: {LLAMA4} n_layers {full.n_layers} -> {cut.n_layers} (one "
        f"[dense, MoE] super-block at full width; {full.param_count()} "
        f"parameters whole, {cut.param_count()} cut) [{CARD}]")
    arch, plan, params = _new_arch_plan(torch, dev, LLAMA4, arch=cut)
    _log_moe_weights("llama4", arch, params)
    check(plan.estimates.get("moe_impl") == "gshard_einsum"
          and "shared_wi" in _moe_leaves(params),
          f"llama4 plan: moe_impl {plan.estimates.get('moe_impl')}")
    with RouteDrops(torch) as routes:
        counts, res = serve_phase(torch, dev, "llama4", arch, plan, params,
                                  n_requests=8, new_tokens=32)
        torch.cuda.synchronize()
        drops = routes.per_prefill_call(_moe_layers(arch))
    _check_layer_launches("llama4", arch, counts, res)
    log(f"serve[llama4] routing drops per prefill call (choices past "
        f"capacity in its MoE layer, C = _capacity(S, 128, 1, 1.25)): "
        f"{drops} [{CARD}]")
    check(len(drops) == res["prefill_calls"],
          f"llama4: {len(drops)} prefill calls routed of "
          f"{res['prefill_calls']}")
    res["drops_per_prefill_call"] = drops
    log(f"consistency llama4: under dense_einsum (the decode step's routing "
        f"never drops; a gshard prefill's may) [{CARD}]")
    consistency_check(torch, dev, arch, params, dataclasses.replace(
        build_run_cfg(plan, arch), moe_impl="dense_einsum"),
        int(plan.estimates["kv_block_len"]), top1_margin=FULL_TOL)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return counts, res, plan


def qwen2vl_phase(torch, dev):
    """qwen2-vl-72b at full width cut to :data:`QWEN2VL_SERVE_LAYERS` of
    its 80 layers (d_model 8192, 64 / 8 heads of 128: G = 8, d_ff 29568,
    vocab 152064; about 33.1 GB of bf16 weights, every earlier weight
    freed; the whole arch, about 145 GB, is refused before any weight by
    the launcher's ``check_fits``).  ``from_plan(plan, params)`` on the
    cut arch's decode 2048 x 8 plan serves 16 token requests (the
    engine's input, as the reference's: M-RoPE's three streams are each
    row's position), 16 flash launches a prefill call and 16 paged
    decode launches a tick; then the full-depth consistency check and
    the M-RoPE check (:func:`mrope_check`)."""
    import gc

    from repro_torch.configs import get_arch
    from repro_torch.core.passes.lowering import build_run_cfg

    full = get_arch(QWEN2VL)
    cut = dataclasses.replace(full, n_layers=QWEN2VL_SERVE_LAYERS)
    log(f"cut: {QWEN2VL} n_layers {full.n_layers} -> {cut.n_layers} (full "
        f"width; {full.param_count()} parameters whole, "
        f"{cut.param_count()} cut) [{CARD}]")
    arch, plan, params = _new_arch_plan(torch, dev, QWEN2VL, arch=cut)
    counts, res = serve_phase(torch, dev, "qwen2-vl", arch, plan, params,
                              n_requests=16, new_tokens=32)
    _check_layer_launches("qwen2-vl", arch, counts, res)
    cfg = build_run_cfg(plan, arch)
    consistency_check(torch, dev, arch, params, cfg,
                      int(plan.estimates["kv_block_len"]),
                      top1_margin=FULL_TOL)
    res["mrope"], res["positions_launches"] = mrope_check(
        torch, dev, arch, params, cfg)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return counts, res, plan


def mrope_check(torch, dev, arch, params, cfg, B: int = 2, S: int = 1024,
                grid: int = 32):
    """M-RoPE on the card: a prefill of ``B`` x ``S`` random patch
    embeddings with ``(3, B, S)`` positions, the temporal stream each
    row's index (the mask by index), height and width a
    ``grid``-wide patch grid.  The last-token logits through the flash
    kernel against the same prefill through the plain attention
    (:func:`plain_kernels`) with the positions as given: rms-relative at
    :data:`FULL_TOL`.  The control collapses the three streams into the
    temporal one (plain RoPE over every slot): it must differ from the
    plain prefill by over :data:`FULL_TOL` and ten times the kernel's
    own difference, which shows that the sections take their streams.

    Then the same with repeated temporal ids, as ``get_rope_index`` lays
    a prompt out (:data:`VL_FWD_LAYOUT`: 896 patches of one image share
    one temporal id): the kernels' positions variant runs in every layer
    (its launches counted from a reset to the read after the prefill),
    held against the plain attention with the positions at
    :data:`FULL_TOL`, beside the positions-ignored control (the kernels
    masking by row index, :func:`positions_ignored`) that must fail it.
    Returns the numbers and the launch counts of that prefill."""
    from repro_torch.kernels import ops
    from repro_torch.models import lm

    g = torch.Generator(dev).manual_seed(SEED + 3)
    emb = torch.randn((B, S, arch.d_model), generator=g,
                      device=dev).to(torch.bfloat16)
    rows = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S)
    pos = torch.stack([rows, rows // grid, rows % grid]).contiguous()
    V = arch.vocab_size

    def logits(positions, plain):
        with plain_kernels(plain):
            out, _ = lm.prefill(arch, params, {"embeds": emb,
                                               "positions": positions}, cfg)
        return out[:, :V].float()

    want = logits(pos, True)
    got = logits(pos, False)
    collapsed = logits(rows.expand(3, B, S).contiguous(), True)
    check(bool(torch.isfinite(got).all()), "M-RoPE: logits not finite")
    noise = _rms_rel(torch, got, want)
    control = _rms_rel(torch, collapsed, want)
    log(f"check M-RoPE {arch.name} prefill of {B} x {S} patch embeddings, "
        f"sections {arch.mrope_sections}, temporal stream = row, height / "
        f"width a {grid}-wide grid: kernels vs plain attention rms_rel="
        f"{noise:.3e} (tol {FULL_TOL}); streams collapsed to the temporal "
        f"one rms_rel={control:.3e} (must exceed {FULL_TOL} and 10 x the "
        f"kernels') [{CARD}]")
    check(noise <= FULL_TOL, f"M-RoPE: kernels vs plain rms_rel {noise}")
    check(control > max(FULL_TOL, 10 * noise),
          f"M-RoPE: the collapsed-streams control ({control}) is not far "
          f"from the sections' result (kernels {noise})")
    # ---- repeated temporal ids: the mask by positions
    vpos = vl_positions(torch, dev, B, VL_FWD_LAYOUT)
    check(vpos.shape[-1] == S, f"M-RoPE: layout of {vpos.shape[-1]} rows")
    want_v = logits(vpos, True)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    got_v = logits(vpos, False)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    with positions_ignored():
        by_index = logits(vpos, False)
    check(bool(torch.isfinite(got_v).all()), "M-RoPE: logits not finite")
    noise_v = _rms_rel(torch, got_v, want_v)
    control_v = _rms_rel(torch, by_index, want_v)
    log(f"check M-RoPE {arch.name} prefill of {B} x {S} patch embeddings, "
        f"repeated temporal ids ({VL_FWD_LAYOUT}): kernels (positions "
        f"variant, {counts['flash_attention_positions']} launches for "
        f"{arch.n_layers} layers) vs plain attention rms_rel={noise_v:.3e} "
        f"(tol {FULL_TOL}); positions ignored (masked by index) rms_rel="
        f"{control_v:.3e} (must exceed {FULL_TOL}) [{CARD}]")
    check(counts["flash_attention_positions"] == arch.n_layers,
          f"M-RoPE: {counts['flash_attention_positions']} positions-variant "
          f"launches for {arch.n_layers} layers")
    check(noise_v <= FULL_TOL,
          f"M-RoPE repeated ids: kernels vs plain rms_rel {noise_v}")
    check(control_v > FULL_TOL, f"M-RoPE repeated ids: the positions-"
          f"ignored control passed ({control_v})")
    return dict(B=B, S=S, grid=grid, rms_rel=noise,
                collapsed_control=control, tol=FULL_TOL,
                repeated_ids=dict(layout=str(VL_FWD_LAYOUT), rms_rel=noise_v,
                                  positions_ignored_control=control_v,
                                  launches=counts)), counts


def small_moe_check(torch, dev):
    """Reduced granite (2 layers, 8 experts top-2, 4 / 2 heads of 64)
    under both MoE paths and reduced llama4 (two super-blocks, 8 experts
    top-1 and a shared expert, 10 / 2 heads of 128): prefill and four
    paged decode steps through the kernels on the card against the plain
    versions on the CPU, same weights, logits within :data:`LOGIT_TOL`;
    and every ``route`` call of the CPU run routed again on the card
    from the same inputs: ``dispatch`` (the integer slots) identical
    wherever no top router probability is within 1e-6 of the next."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core import specialize
    from repro_torch.core.passes.lowering import build_run_cfg
    from repro_torch.models import lm, moe

    cases = (("granite", "gshard_einsum"), ("granite", "dense_einsum"),
             ("llama4", "gshard_einsum"))
    for which, impl in cases:
        name = GRANITE if which == "granite" else LLAMA4
        arch = get_arch(name).reduced()
        arch = dataclasses.replace(arch, head_dim=64) if which == "granite" \
            else dataclasses.replace(arch, n_heads=10, n_kv_heads=2,
                                     head_dim=128)
        plan = specialize(arch, ShapeConfig("small", "decode", 512, 4),
                          mesh_shape=(1, 1), cache=False)
        cfg = dataclasses.replace(build_run_cfg(plan, arch), moe_impl=impl)
        params = lm.init_params(arch, torch.Generator().manual_seed(SEED),
                                *plan.padded_sizes())
        toks = torch.randint(0, arch.vocab_size, (4, 100),
                             generator=torch.Generator().manual_seed(SEED),
                             dtype=torch.int32)
        bl = int(plan.estimates["kv_block_len"])
        nb = 512 // bl
        outs, calls = {}, []
        real = moe.route

        def recording(x, router_w, top_k, capacity, **kw):
            if x.device.type == "cpu":
                calls.append((x, router_w, top_k, capacity))
            return real(x, router_w, top_k, capacity, **kw)

        moe.route = recording
        try:
            for d in (torch.device("cpu"), dev):
                p = _to(torch, params, d)
                logits, cache = lm.prefill(arch, p, {"tokens": toks.to(d)},
                                           cfg, max_len=512)
                cache = dict(
                    cache, k=cache["k"].reshape(arch.n_layers, 4 * nb, bl,
                                                *cache["k"].shape[3:]),
                    v=cache["v"].reshape(arch.n_layers, 4 * nb, bl,
                                         *cache["v"].shape[3:]),
                    block_tbl=torch.arange(4 * nb, dtype=torch.int32,
                                           device=d).reshape(4, nb))
                steps = [logits.float().cpu()]
                for i in range(4):
                    logits, cache = lm.decode_step(
                        arch, p, cache, {"tokens": toks[:, i:i + 1].to(d)},
                        cfg)
                    steps.append(logits.float().cpu())
                outs[d.type] = torch.stack(steps)
        finally:
            moe.route = real
        rel = float((outs["cuda"] - outs["cpu"]).abs().max()
                    / outs["cpu"].abs().max())
        compared = near = 0
        for x, router_w, top_k, capacity in calls:
            probs = torch.softmax(x.double() @ router_w.double(), -1).float()
            top = probs.topk(min(top_k + 1, probs.shape[-1]), -1).values
            if float((top[..., :-1] - top[..., 1:]).min()) <= 1e-6:
                near += 1
                continue
            want = real(x, router_w, top_k, capacity)[0]
            got = real(x.to(dev), router_w.to(dev), top_k, capacity)[0]
            check(torch.equal(got.cpu(), want),
                  f"small {which} {impl}: route on the card differs from "
                  "the CPU on the same inputs")
            compared += 1
        log(f"check small {which} ({impl}) card vs cpu logits: rel={rel:.3e} "
            f"(tol {LOGIT_TOL}); route calls re-routed on the card: "
            f"{compared} identical, {near} skipped for a near-tie within "
            f"1e-6 [{CARD}]")
        check(rel <= LOGIT_TOL, f"small {which} {impl}: rel {rel} > "
              f"{LOGIT_TOL}")
        check(compared >= (len(calls) + 1) // 2,
              f"small {which} {impl}: {compared} of {len(calls)} route "
              "calls compared")


# ---------------------------------------------------------------------
# phases 5 and 7: outputs against references
# ---------------------------------------------------------------------

def _rms_rel(torch, got, want) -> float:
    return float((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())


def consistency_check(torch, dev, arch, params, cfg, bl,
                      top1_margin: float = 0.0, P: int = 300):
    """Full width: the logits of one decode step after a prefill of
    ``P`` tokens against the flash prefill's last-token logits over the
    same ``P + 1`` tokens — once through the dense decode kernel and
    once through the paged one (the prefill cache laid out as pool
    blocks, in reverse order, behind a table).

    Through its bf16 layers (36 in qwen3-8b, 62 in deepseek-coder-33b)
    the model amplifies the kernels' rounding:
    the flash prefill against itself under another kv tile (64 keys
    where the plan's has 128: only the order of its online-softmax
    rescales and where P rounds to bf16 change; a row's arithmetic does
    not depend on how many rows share its CTA) differs by several 1e-2
    rms of the logits, and a wrong input token by more than 1.  So the
    check is rms-relative, at :data:`FULL_TOL`, with that noise floor
    printed beside it and a wrong-token control that must fail it; top-1
    tokens must agree — with ``top1_margin`` > 0, only where the flash
    prefill's top-2 margin exceeds that share of its largest logit (the
    margin rule; deepseek-coder-33b's 62 layers put the two right paths
    ~9e-2 rms apart, as far apart as a near-tie).  A hybrid's SSM state
    and conv window ride beside the pool as the prefill left them; ``P``
    past its window (hymba: 1100 of 1024) sends the windowed layers'
    decode through a window that starts mid-cache.  The kernels' own
    tolerance is held row by row in the kernel phase, and
    :data:`LOGIT_TOL` by :func:`small_model_check`.
    """
    from repro_torch.models import lm

    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(dev).manual_seed(SEED + 1)
    max_len = -(-(P + 1) // bl) * bl
    toks = torch.randint(0, arch.vocab_size, (2, P + 1), generator=g,
                         device=dev, dtype=torch.int32)
    V = arch.vocab_size
    want = lm.prefill(arch, params, {"tokens": toks}, cfg)[0][:, :V].float()
    # the 64-row, 64-kv tile: 64 // G positions a CTA
    G = arch.n_heads // arch.n_kv_heads
    retiled = dataclasses.replace(cfg, flash_tiles=(64 // G, 64))
    check(fa.kernel_tiles(G, 64 // G, 64) == (64, 64),
          f"consistency: no 64-row tile at G={G}")
    other = lm.prefill(arch, params, {"tokens": toks}, retiled)[0]
    floor = _rms_rel(torch, other[:, :V].float(), want)
    for residency in ("dense", "paged"):
        results = {}
        for name, last in (("right", toks[:, P:]),
                           ("wrong", (toks[:, P:] + 1) % V)):
            _, cache = lm.prefill(arch, params, {"tokens": toks[:, :P]}, cfg,
                                  max_len=max_len)
            if residency == "paged":
                nb = max_len // bl

                def pool(t):
                    return t.reshape(t.shape[0], 2 * nb, bl,
                                     *t.shape[3:]).flip(1).contiguous()

                cache = dict(cache, k=pool(cache["k"]), v=pool(cache["v"]),
                             block_tbl=(2 * nb - 1 - torch.arange(
                                 2 * nb, device=dev, dtype=torch.int32)
                             ).reshape(2, nb).contiguous())
            got, _ = lm.decode_step(arch, params, cache, {"tokens": last},
                                    cfg)
            check(tuple(got.shape) == (2, params["embed"].shape[0])
                  and bool(torch.isfinite(got).all()),
                f"consistency[{residency}]: logits {tuple(got.shape)} "
                "not finite or misshapen")
            results[name] = got[:, :V].float()
        rms = _rms_rel(torch, results["right"], want)
        control = _rms_rel(torch, results["wrong"], want)
        top2 = want.topk(2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]) / want.abs().amax(-1)
        agree = results["right"].argmax(-1) == want.argmax(-1)
        top1 = bool((agree | (margin <= top1_margin)).all())
        log(f"check full-width {arch.name} decode[{residency}] vs flash "
            f"prefill logits (G={G}): "
            f"rms_rel={rms:.3e} (tol {FULL_TOL}; flash re-tiled against "
            f"itself {floor:.3e}; wrong-token control {control:.3e}) "
            f"top1_agree={agree.tolist()} at top-2 margins "
            f"{[round(m, 5) for m in margin.tolist()]} (a disagreement "
            f"allowed at a margin <= {top1_margin}) "
            f"scale={float(want.abs().max()):.3f} [{CARD}]")
        check(rms <= FULL_TOL and top1,
              f"consistency[{residency}] rms_rel {rms} > {FULL_TOL} "
              f"or top-1 differs")
        check(control > FULL_TOL, f"consistency[{residency}]: the "
              f"wrong-token control passed ({control})")


def ssm_consistency_check(torch, dev, arch, params, cfg):
    """Full width and depth mamba2: the logits of one recurrent decode
    step after the kernel's prefill of ``P = 1000`` tokens (its final
    SSM state and conv tail carry the whole prompt) against the kernel's
    prefill of the same ``P + 1`` tokens.  rms-relative at
    :data:`FULL_TOL`, beside the noise floor of two right paths (the
    prefill against itself under chunk 128) and a wrong-token control
    that must fail; top-1 tokens must agree, but for a row whose top-2
    margin (relative to its largest logit) is within that noise floor,
    where two right paths may rank the pair either way.  The two paths
    round differently by design (the prefill conv sums bf16 taps one by
    one, the decode conv reduces its window in fp32)."""
    from repro_torch.models import lm

    g = torch.Generator(dev).manual_seed(SEED + 2)
    P = 1000
    V = arch.vocab_size
    toks = torch.randint(0, V, (2, P + 1), generator=g, device=dev,
                         dtype=torch.int32)
    want = lm.prefill(arch, params, {"tokens": toks}, cfg)[0][:, :V].float()
    rechunked = dataclasses.replace(cfg, ssd_chunk=128)
    floor = _rms_rel(torch, lm.prefill(arch, params, {"tokens": toks},
                                       rechunked)[0][:, :V].float(), want)
    results = {}
    for name, last in (("right", toks[:, P:]),
                       ("wrong", (toks[:, P:] + 1) % V)):
        _, cache = lm.prefill(arch, params, {"tokens": toks[:, :P]}, cfg)
        got, _ = lm.decode_step(arch, params, cache, {"tokens": last}, cfg)
        check(tuple(got.shape) == (2, params["embed"].shape[0])
              and bool(torch.isfinite(got).all()),
              f"ssm consistency: logits {tuple(got.shape)} not finite or "
              "misshapen")
        results[name] = got[:, :V].float()
    rms = _rms_rel(torch, results["right"], want)
    control = _rms_rel(torch, results["wrong"], want)
    top2 = want.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]) / want.abs().amax(-1)
    agree = results["right"].argmax(-1) == want.argmax(-1)
    top1 = bool((agree | (margin <= floor)).all())
    log(f"check full-depth mamba2 decode vs SSD-kernel prefill logits: "
        f"rms_rel={rms:.3e} (tol {FULL_TOL}; prefill re-chunked against "
        f"itself {floor:.3e}; wrong-token control {control:.3e}) "
        f"top1_agree={agree.tolist()} at top-2 margins "
        f"{[round(m, 5) for m in margin.tolist()]} (a disagreement allowed "
        f"at a margin <= the noise floor) "
        f"scale={float(want.abs().max()):.3f} [{CARD}]")
    check(rms <= FULL_TOL and top1,
          f"ssm consistency rms_rel {rms} > {FULL_TOL} or top-1 differs")
    check(control > FULL_TOL,
          f"ssm consistency: the wrong-token control passed ({control})")


def small_ssm_check(torch, dev):
    """A small mamba2 (2 layers, d_model 128, state 16, head_dim 32):
    a ragged 100-token prefill and four decode steps through the SSD
    kernel on the card against the plain version on the CPU."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core import specialize
    from repro_torch.core.passes.lowering import build_run_cfg
    from repro_torch.models import lm

    arch = get_arch("mamba2-2.7b").reduced()
    plan = specialize(arch, ShapeConfig("small", "decode", 512, 4),
                      mesh_shape=(1, 1), cache=False)
    cfg = build_run_cfg(plan, arch)
    params = lm.init_params(arch, torch.Generator().manual_seed(SEED),
                            *plan.padded_sizes())
    toks = torch.randint(0, arch.vocab_size, (4, 104),
                         generator=torch.Generator().manual_seed(SEED),
                         dtype=torch.int32)
    outs = {}
    for d in (torch.device("cpu"), dev):
        p = _to(torch, params, d)
        logits, cache = lm.prefill(arch, p, {"tokens": toks[:, :100].to(d)},
                                   cfg)
        steps = [logits.float().cpu()]
        for i in range(100, 104):
            logits, cache = lm.decode_step(arch, p, cache,
                                           {"tokens": toks[:, i:i + 1].to(d)},
                                           cfg)
            steps.append(logits.float().cpu())
        outs[d.type] = torch.stack(steps)
    rel = float((outs["cuda"] - outs["cpu"]).abs().max()
                / outs["cpu"].abs().max())
    log(f"check small mamba2 card vs cpu logits: rel={rel:.3e} "
        f"(tol {LOGIT_TOL}) [{CARD}]")
    check(rel <= LOGIT_TOL, f"small mamba2: rel {rel} > {LOGIT_TOL}")


#: the disagg phase: full-width qwen3-8b's unmodified h100-sxm decode
#: 4096 x 8 plan (kv_prefill_mode disagg, chunk 512), one worker, 8
#: greedy requests of 1,500-4,000 prompt tokens, new tokens each
DISAGG_SHAPE = (4096, 8)
DISAGG_REQUESTS, DISAGG_NEW = 8, 16
DISAGG_LENS = (1500, 4000)


def disagg_phase(torch, dev, arch, params):
    """Disaggregated prefill (phase 6b), on qwen3-8b's weights as phase 6
    left them (no second load).  The plan is the unmodified ``h100-sxm``
    decode 4096 x 8 plan, which records ``kv_prefill_mode: disagg``
    (chunk 512); ``from_plan(plan, params, disagg_workers=1)`` spawns one
    prefill worker, which maps the weights by CUDA IPC.  Five runs, one
    engine (and its 38.6 GB pool) at a time:

    * the handshake: a fleet told to expect a wrong plan hash raises
      :class:`PlanHandshakeError` before any weight or KV crosses;
    * disagg: 8 greedy requests of 1,500-4,000 prompt tokens
      (:data:`DISAGG_LENS`), each crossing several 512-token chunks; the
      worker's flash launches (reported with each finished prompt) must
      be the model's layers times the chunks it computed;
    * inline: the same requests on the same weights with the prefill in
      the engine (the control): tokens held under the margin rule (equal
      up to a first difference, allowed only where the control's top-2
      margin is within :data:`FULL_TOL` of its largest logit), and every
      request's journaled K/V rows against the inline prefill's,
      rms-relative at :data:`FULL_TOL`, beside their noise floor (the
      inline rows against a prefill re-tiled to 64 x 64) and a wrong-token
      control (every prompt token shifted by one) that must fail it;
    * SIGKILL: the disagg run again, its worker killed once a prompt has
      at least one journaled chunk (and more to come); the resumed run's
      tokens and journaled rows must equal the un-killed run's bitwise
      (the same chunks through the same deterministic kernels), with a
      death and a resume counted;
    * degraded: the same kill under ``max_restarts=0``: the fleet retires,
      the engine degrades to inline prefill (``DegradedMode`` in
      ``pressure_stats()``), and every request finishes.

    Each line carries the card; TTFT p50 / p95 and tok/s of disagg
    against inline, the worker's seconds from spawn to weights taken, and
    the chunks with their host milliseconds (the worker's copy out, this
    side's read of the pipe, the scatter into the pool)."""
    import gc

    import numpy as np

    from repro_torch.configs import ShapeConfig
    from repro_torch.core import specialize
    from repro_torch.core.passes.lowering import build_run_cfg
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve.disagg import PlanHandshakeError, PrefillFleet
    from repro_torch.serve.engine import ServeEngine

    t_phase = time.perf_counter()
    max_len, batch = DISAGG_SHAPE
    plan = specialize(arch, ShapeConfig("serve_h100_4k", "decode", max_len,
                                        batch),
                      mesh_shape=(1, 1), target="h100-sxm",
                      plan_dir=PLAN_DIR)
    est = plan.estimates
    cfg = build_run_cfg(plan, arch)
    bl = int(est["kv_block_len"])
    log(f"disagg plan {plan.content_hash()[:16]} {max_len} x {batch}: "
        f"kv_prefill_mode={est.get('kv_prefill_mode')} "
        f"kv_prefill_chunk={est.get('kv_prefill_chunk')} "
        f"kv_prefill_stall_ticks={est.get('kv_prefill_stall_ticks')} "
        f"kv_residency={est.get('kv_residency')} kv_block_len={bl} "
        f"kv_n_blocks={est.get('kv_n_blocks')} "
        f"kv_admission={est.get('kv_admission')} [{CARD}]")
    check(est.get("kv_prefill_mode") == "disagg"
          and int(est.get("kv_prefill_chunk", 0)) == 512 == bl
          and est.get("kv_residency") == "paged",
          f"disagg: the {max_len} x {batch} plan does not record disagg "
          f"prefill in 512-token chunks: {est}")
    check(tuple(plan.padded_sizes()) == (params["embed"].shape[0],
                                         *plan.padded_sizes()[1:])
          and lm.cache_heads(arch, params["blocks"])["kv_heads"]
          == cfg.kv_heads_padded,
          "disagg: the plan's padded sizes are not the loaded weights'")
    rng = np.random.default_rng(SEED + 26)
    V = arch.vocab_size
    lens = [int(n) for n in rng.integers(DISAGG_LENS[0], DISAGG_LENS[1] + 1,
                                         DISAGG_REQUESTS)]
    prompts = [rng.integers(0, V, (n,)).astype(np.int32) for n in lens]
    out = {"plan": plan.content_hash(), "prompt_lens": lens,
           "new_tokens": DISAGG_NEW, "card": CARD}

    # ---- the handshake: a wrong hash is refused before anything crosses
    t0 = time.perf_counter()
    fleet = None
    try:
        fleet = PrefillFleet(plan, arch, params, 1, block_len=bl,
                             kv_heads=cfg.kv_heads_padded,
                             _expect_hash="0" * 64)
        refused = ""
    except PlanHandshakeError as e:
        refused = str(e)
    finally:
        if fleet is not None:
            fleet.shutdown()
    log(f"check disagg handshake: a fleet expecting a wrong plan hash "
        f"raised PlanHandshakeError in {time.perf_counter() - t0:.1f} s: "
        f"{refused[:90]!r} [{CARD}]")
    check(bool(refused), "disagg: a wrong plan hash was accepted")
    out["handshake_refused"] = refused

    Base = _recording_engine(ServeEngine)

    class Recording(Base):
        """Keeps each request's prompt K/V rows from its pool blocks once
        its prefill is in (journaled chunks, or the inline scatter), on
        the card until the run ends."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.rows = {}

        def _keep(self, r):
            if r.rid in self.rows or not r.blocks:
                return
            ids = torch.as_tensor(r.blocks, device=self.device)
            self.rows[r.rid] = [
                lm.gather_blocks(self.cache[n], ids).flatten(1, 2)
                [:, :len(r.prompt)].clone() for n in ("k", "v")]

        def _admit_group(self, group, *args):
            super()._admit_group(group, *args)
            for r in group:
                self._keep(r)

        def _complete_prefill(self, fl, logits):
            r = fl.request
            self._rids = [] if r.out_tokens else [r.rid]
            super()._complete_prefill(fl, logits)
            self._keep(r)

    def run(label, inline=False, kill=False, max_restarts=4):
        opts = dict(heartbeat_s=0.5, heartbeat_timeout_s=120.0,
                    hello_timeout_s=300.0, max_restarts=max_restarts)
        kw = (dict(kv_prefill_mode="inline") if inline
              else dict(disagg_workers=1, disagg_opts=opts))
        t0 = time.perf_counter()
        eng = Recording.from_plan(plan, params, arch=arch, seed=SEED, **kw)
        t_build = time.perf_counter() - t0
        try:
            check(eng.prefill_mode == ("inline" if inline else "disagg"),
                  f"disagg[{label}]: prefill mode {eng.prefill_mode}")
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            for p in prompts:
                eng.submit(p, max_new_tokens=DISAGG_NEW)
            killed, deadline = None, time.time() + 600
            while (eng.pending or eng.active or eng._disagg) \
                    and time.time() < deadline:
                eng.step()
                if kill and killed is None:
                    fl = next((f for f in eng._disagg.values()
                               if 1 <= f.acked < f.nb_feed), None)
                    if fl is not None \
                            and eng._fleet.kill_worker(rid=fl.request.rid):
                        killed = (fl.request.rid, fl.acked, fl.nb_feed)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            check(not (eng.pending or eng.active or eng._disagg),
                  f"disagg[{label}]: not idle after 600 s")
            check(not kill or killed is not None,
                  f"disagg[{label}]: the kill window never opened")
            done = sorted(eng.finished, key=lambda r: r.rid)
            check(len(done) == DISAGG_REQUESTS and all(
                len(r.out_tokens) == DISAGG_NEW for r in done),
                f"disagg[{label}]: {len(done)} of {DISAGG_REQUESTS} "
                "requests finished whole")
            ttft = np.array([(r.t_first - r.t_submit) * 1e3 for r in done])
            n_tok = sum(len(r.out_tokens) for r in done)
            ps = eng.pressure_stats()
            fl_stats = eng.telemetry()["prefill"]["disagg"]["fleet"]
            res = dict(
                wall_s=wall, build_s=t_build, tokens=n_tok,
                tok_per_s=n_tok / wall,
                ttft_ms_p50=float(np.percentile(ttft, 50)),
                ttft_ms_p95=float(np.percentile(ttft, 95)),
                prefill_mode=eng.prefill_mode, launches=counts,
                killed=killed, fleet=fl_stats,
                chunk_scatter_ms=eng.tier_ms["disagg_chunk"],
                pressure={k: ps[k] for k in (
                    "prefill_mode", "degraded", "disagg_dispatches",
                    "disagg_chunks", "disagg_resumes", "disagg_inflight")})
            tokens = {r.rid: list(r.out_tokens) for r in done}
            rows = {rid: [t.cpu() for t in kv]
                    for rid, kv in eng.rows.items()}
            margins = dict(eng.margins)
        finally:
            eng.shutdown()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        log(f"serve[disagg {label}] requests={DISAGG_REQUESTS} "
            f"tokens={n_tok} "
            f"wall_s={wall:.3f} tok_per_s={res['tok_per_s']:.1f} "
            f"ttft_ms_p50={res['ttft_ms_p50']:.1f} "
            f"ttft_ms_p95={res['ttft_ms_p95']:.1f} prefill_mode="
            f"{res['prefill_mode']} engine built in {t_build:.1f} s "
            f"killed={killed} pressure={res['pressure']} launches={counts} "
            f"fleet={fl_stats} [{CARD}]")
        return res, tokens, rows, margins

    dis, dis_tok, dis_rows, _ = run("disagg")
    fl = dis["fleet"]
    n_chunks = sum(-(-n // bl) for n in lens)
    check(fl["chunks"] == n_chunks == dis["pressure"]["disagg_chunks"],
          f"disagg: {fl['chunks']} chunks received for {n_chunks}")
    wl = fl["worker_launches"]
    check(wl.get("flash_attention", 0) == arch.n_layers * n_chunks
          and wl.get("flash_attention_positions", 0) == 0
          and dis["launches"]["paged_decode_attention"] > 0
          and dis["launches"]["flash_attention"] == 0,
          f"disagg: worker launches {wl} for {n_chunks} chunks of "
          f"{arch.n_layers} layers; engine {dis['launches']}")
    per_chunk = dict(worker_ring_ms=fl["chunk_host_ms"] / n_chunks,
                     engine_read_ms=fl["recv_ms"] / n_chunks,
                     engine_scatter_ms=dis["chunk_scatter_ms"] / n_chunks)
    per_chunk["host_ms"] = sum(per_chunk.values())
    dis["per_chunk"] = per_chunk
    chunk_mb = 2 * arch.n_layers * bl * cfg.kv_heads_padded * arch.hd * 2 / 1e6
    log(f"disagg chunks: {n_chunks} of {bl} rows ({arch.n_layers} layers of "
        f"K and V, {chunk_mb:.1f} MB a chunk) through the engine's ring on the card (CUDA IPC); host "
        f"ms a chunk: worker into its slot, synchronised "
        f"{per_chunk['worker_ring_ms']:.2f}, engine reading the pipe and "
        f"copying the slot out {per_chunk['engine_read_ms']:.2f}, scatter "
        f"into the pool "
        f"{per_chunk['engine_scatter_ms']:.2f}, total "
        f"{per_chunk['host_ms']:.2f}; spawn to weights taken "
        f"{fl['spawn_to_ready_s']} s; worker flash launches "
        f"{wl.get('flash_attention')} = {arch.n_layers} layers x "
        f"{n_chunks} chunks [{CARD}]")

    inl, inl_tok, inl_rows, inl_margins = run("inline", inline=True)
    compared = same = 0
    for rid, want in inl_tok.items():
        for i, (a, b) in enumerate(zip(dis_tok[rid], want)):
            compared += 1
            if a != b:
                m = inl_margins[rid][i]
                check(m <= FULL_TOL, f"disagg: request {rid} token {i} "
                      f"differs ({a} vs {b}) at an inline margin {m} > "
                      f"{FULL_TOL}")
                break
            same += 1
    kv_rel = {rid: max(_rms_rel(torch, a.float(), b.float())
                       for a, b in zip(dis_rows[rid], inl_rows[rid]))
              for rid in inl_rows}
    # the noise floor and the wrong-token control, on request 0's prompt
    toks0 = torch.from_numpy(prompts[0][None]).to(dev)
    retiled = dataclasses.replace(
        cfg, flash_tiles=(64 // (arch.n_heads // arch.n_kv_heads), 64))
    n0 = lens[0]
    _, c_re = lm.prefill(arch, params, {"tokens": toks0}, retiled)
    floor = max(_rms_rel(torch, c_re[n][:, 0, :n0].float().cpu(),
                         inl_rows[0][i].float())
                for i, n in enumerate(("k", "v")))
    del c_re
    _, c_wr = lm.prefill(arch, params, {"tokens": (toks0 + 1) % V}, cfg)
    wrong = min(_rms_rel(torch, c_wr[n][:, 0, :n0].float().cpu(),
                         inl_rows[0][i].float())
                for i, n in enumerate(("k", "v")))
    del c_wr
    torch.cuda.empty_cache()
    worst = max(kv_rel.values())
    log(f"check disagg vs inline: greedy tokens {same} identical of "
        f"{compared} compared (a request compared up to its first "
        f"difference, allowed only where the inline top-2 margin is <= "
        f"{FULL_TOL}); journaled K/V rows vs the inline prefill's worst "
        f"rms_rel={worst:.3e} (tol {FULL_TOL}; inline re-tiled against "
        f"itself {floor:.3e}; wrong-token control {wrong:.3e}) per request "
        f"{ {r: round(e, 6) for r, e in kv_rel.items()} } [{CARD}]")
    check(worst <= FULL_TOL, f"disagg: journaled rows rms_rel {worst}")
    check(wrong > FULL_TOL, f"disagg: the wrong-token control passed "
          f"({wrong})")
    log(f"serve[disagg vs inline] TTFT p50 {dis['ttft_ms_p50']:.1f} ms vs "
        f"{inl['ttft_ms_p50']:.1f} ms, p95 {dis['ttft_ms_p95']:.1f} ms vs "
        f"{inl['ttft_ms_p95']:.1f} ms, tok/s {dis['tok_per_s']:.1f} vs "
        f"{inl['tok_per_s']:.1f} ({DISAGG_REQUESTS} requests, prompts "
        f"{lens}, {DISAGG_NEW} new tokens each, one worker) [{CARD}]")
    out.update(disagg=dis, inline=inl, tokens_compared=compared,
               tokens_identical=same, kv_rms_rel=kv_rel, kv_noise_floor=floor,
               kv_wrong_token_control=wrong, tol=FULL_TOL)
    del inl_rows

    # ---- SIGKILL: resumed from the journal, bitwise the un-killed run
    kil, kil_tok, kil_rows, _ = run("sigkill", kill=True)
    check(kil["fleet"]["deaths"] >= 1
          and kil["pressure"]["disagg_resumes"] >= 1,
          f"disagg sigkill: deaths {kil['fleet']['deaths']} resumes "
          f"{kil['pressure']['disagg_resumes']}")
    tok_same = all(kil_tok[r] == dis_tok[r] for r in dis_tok)
    rows_same = all(torch.equal(a, b) for r in dis_rows
                    for a, b in zip(kil_rows[r], dis_rows[r]))
    log(f"check disagg SIGKILL: worker killed at (rid, acked, blocks) "
        f"{kil['killed']}; disagg_resumes={kil['pressure']['disagg_resumes']}"
        f" deaths={kil['fleet']['deaths']} restarts="
        f"{kil['fleet']['restarts']}; tokens bitwise the un-killed run's: "
        f"{tok_same}; journaled K/V rows bitwise: {rows_same} [{CARD}]")
    check(tok_same and rows_same, "disagg sigkill: the resumed run differs "
          "from the un-killed one")
    out.update(sigkill=kil, sigkill_tokens_bitwise=tok_same,
               sigkill_rows_bitwise=rows_same)
    del kil_rows, dis_rows

    # ---- degraded: no restart budget, one kill
    deg, deg_tok, _, _ = run("degraded", kill=True, max_restarts=0)
    press = deg["pressure"]
    check(deg["prefill_mode"] == "degraded" and press["degraded"] is not None
          and press["prefill_mode"] == "degraded",
          f"disagg degraded: {press}")
    as_before = sum(deg_tok[r] in (inl_tok[r], dis_tok[r]) for r in deg_tok)
    log(f"check disagg degraded (max_restarts=0, one kill): prefill_mode="
        f"{press['prefill_mode']} degraded={press['degraded']}; every "
        f"request finished; {as_before} of {len(deg_tok)} with the inline "
        f"or the disagg run's tokens exactly [{CARD}]")
    out.update(degraded=deg, degraded_same_tokens=as_before)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"disagg phase took {out['phase_s']:.1f} s [{CARD}]")
    # the un-killed run's launches: the engine's decode and the worker's
    # prefill
    counts = {k: n + wl.get(k, 0) for k, n in dis["launches"].items()}
    return out, counts


def guarded_run(trainer, fail_injector=None):
    """The trainer's step under :class:`repro_torch.runtime.fault
    .StepGuard`, wired as the reference's tests wire the guard: batches
    drawn from the synthetic source by step (a replay sees the same
    batches), the starting state and every ``ckpt_every`` steps saved
    through the trainer's checkpointer, a failure restored through
    ``trainer.resume()``.  Returns ``(state, step, guard, history)``,
    ``history`` the ``(step, loss)`` of every step run."""
    from repro_torch.data import SyntheticSource, to_device
    from repro_torch.runtime import StepGuard

    source = SyntheticSource(trainer.arch, trainer.shape,
                             seed=trainer.cfg.seed)
    put = to_device(trainer.device)
    every, history, at = trainer.cfg.ckpt_every, [], {}

    def batches(step):
        at["step"] = step
        return put(source.batch_at(step))

    def make_step(mesh):
        def step_fn(state, batch):
            state, metrics = trainer.step_fn(state, batch)
            history.append((at["step"], float(metrics["loss"])))
            if (at["step"] + 1) % every == 0:
                trainer.ckpt.save(at["step"] + 1, state, blocking=True)
            return state, metrics
        return step_fn

    state = trainer.init_state(trainer.cfg.seed)
    trainer.ckpt.save(0, state, blocking=True)
    guard = StepGuard(make_step, lambda mesh: trainer.resume())
    state, step, _ = guard.run(state, batches, trainer.cfg.n_steps,
                               fail_injector=fail_injector)
    return state, step, guard, history


def step_guard_phase(torch, dev):
    """Training under :class:`repro_torch.runtime.fault.StepGuard` on the
    card: the small qwen3 (reduced, head_dim 128, its ``h100-sxm`` plan)
    trains 6 steps of 256 x 4 through the flash kernels, checkpointed
    every 2 steps through ``ckpt/checkpointer.py``; a RuntimeError is
    injected at step 3, the guard restores the step-2 checkpoint and
    replays; the final state (parameters, moments, master copy) must be
    bitwise that of a run that never failed, as must the replayed steps'
    losses."""
    import shutil as _shutil

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core import specialize
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw
    from repro_torch.train import Trainer, TrainerConfig

    t0 = time.perf_counter()
    full = get_arch("qwen3-8b")
    arch = dataclasses.replace(full.reduced(), head_dim=full.hd)
    shape = ShapeConfig("guard_train", "train", 256, 4)
    plan = specialize(arch, shape, mesh_shape=(1, 1), target="h100-sxm",
                      cache=False)
    opt = adamw.OptConfig.from_plan(plan, warmup_steps=1, total_steps=8)
    root = ROOT / "build" / "ckpt_guard"
    _shutil.rmtree(root, ignore_errors=True)

    def trainer(run):
        cfg = TrainerConfig(n_steps=6, ckpt_every=2, log_every=100,
                            seed=SEED, ckpt_dir=str(root / run))
        return Trainer(plan, None, cfg, opt, arch=arch, shape=shape,
                       device=dev)

    want, step, guard, calm = guarded_run(trainer("calm"))
    check(step == 6 and not guard.events, f"guard calm run: {guard.events}")
    fired = []

    def injector(step):
        if step == 3 and not fired:
            fired.append(step)
            raise RuntimeError("injected device failure at step 3")

    ops.reset_launch_counts()
    got, step, guard, hist = guarded_run(trainer("hit"), injector)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    steps = [h for h, _ in hist]
    same_losses = [x for _, x in hist[3:]] == [x for _, x in calm[2:]]
    same = all(torch.equal(a.detach(), b.detach())
               for a, b in zip(adamw.leaves(got), adamw.leaves(want)))
    log(f"check StepGuard on the card: a RuntimeError at step 3, events "
        f"{guard.events}; restored step {steps[3]} from "
        f"{root / 'hit'} and replayed: steps {steps}; replayed losses bitwise "
        f"{same_losses}; final state bitwise the never-failed run's: {same}; "
        f"flash launches {counts['flash_attention']} forward, "
        f"{counts['flash_attention_bwd']} backward; "
        f"{time.perf_counter() - t0:.1f} s [{CARD}]")
    check(step == 6 and len(guard.events) == 1
          and steps == [0, 1, 2, 2, 3, 4, 5],
          f"StepGuard: steps {steps}, events "
          f"{guard.events}")
    check(same and same_losses, "StepGuard: the replayed run differs from "
          "the never-failed one")
    check(counts["flash_attention"] > 0 and counts["flash_attention_bwd"] > 0,
          f"StepGuard: the flash kernels did not launch ({counts})")
    _shutil.rmtree(root, ignore_errors=True)
    return dict(events=guard.events, steps=steps,
                final_state_bitwise=same, losses_bitwise=same_losses,
                launches=counts, seconds=time.perf_counter() - t0,
                card=CARD), counts


def small_model_check(torch, dev):
    """A small qwen3 (2 layers, d_model 128, head_dim 128) through the
    kernels on the card against the plain versions on the CPU."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core import specialize
    from repro_torch.core.passes.lowering import build_run_cfg
    from repro_torch.models import lm

    arch = dataclasses.replace(get_arch("qwen3-8b").reduced(), head_dim=128)
    for residency in ("paged", "dense"):
        plan = specialize(arch, ShapeConfig("small", "decode", 512, 4),
                          mesh_shape=(1, 1), kv_residency=residency,
                          cache=False)
        cfg = build_run_cfg(plan, arch)
        cpu = torch.device("cpu")
        params = lm.init_params(arch, torch.Generator().manual_seed(SEED),
                                *plan.padded_sizes())
        toks = torch.randint(0, arch.vocab_size, (4, 100),
                             generator=torch.Generator().manual_seed(SEED),
                             dtype=torch.int32)
        outs = {}
        for d in (cpu, dev):
            p = _to(torch, params, d)
            logits, cache = lm.prefill(arch, p, {"tokens": toks.to(d)}, cfg,
                                       max_len=512)
            steps = [logits.float().cpu()]
            if residency == "paged":
                bl = int(plan.estimates["kv_block_len"])
                nb = 512 // bl
                cache = {"pos": cache["pos"],
                         "k": cache["k"].reshape(arch.n_layers, 4 * nb, bl,
                                                 *cache["k"].shape[3:]),
                         "v": cache["v"].reshape(arch.n_layers, 4 * nb, bl,
                                                 *cache["v"].shape[3:]),
                         "block_tbl": torch.arange(
                             4 * nb, dtype=torch.int32, device=d
                         ).reshape(4, nb)}
            for i in range(4):
                nxt = toks[:, i:i + 1].to(d)
                logits, cache = lm.decode_step(arch, p, cache,
                                               {"tokens": nxt}, cfg)
                steps.append(logits.float().cpu())
            outs[d.type] = torch.stack(steps)
        rel = float((outs["cuda"] - outs["cpu"]).abs().max()
                    / outs["cpu"].abs().max())
        log(f"check small model ({residency}) card vs cpu logits: "
            f"rel={rel:.3e} (tol {LOGIT_TOL}) [{CARD}]")
        check(rel <= LOGIT_TOL,
              f"small model {residency}: rel {rel} > {LOGIT_TOL}")


def _to(torch, tree, dev):
    if isinstance(tree, dict):
        return {k: _to(torch, v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ---------------------------------------------------------------------
# the flash backward (phase 2) and training (phases 15-16)
# ---------------------------------------------------------------------

def grad_row_err(torch, got, want):
    """:func:`row_err` for a gradient: ``max |got - want|`` and the worst
    row's rms |got - want| over ``max(rms |want row|, GRAD_FLOOR x rms
    |want|)``.  A gradient row can vanish where the output row does
    not: the first query of a causal sequence sees one key, so P = 1,
    dS = dP - Delta = 0 and its dq row is 0 up to the order of two fp32
    sums — relative to itself, noise.  The floor measures such a row
    against the tensor's scale; every other row against its own."""
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), "kernel gradient is not finite")
    e = (got - want).reshape(-1, got.shape[-1])
    w = want.reshape(-1, want.shape[-1])
    floor = GRAD_FLOOR * float(w.pow(2).mean().sqrt())
    rel = e.pow(2).mean(1).sqrt() / w.pow(2).mean(1).sqrt().clamp_min(
        max(floor, 1e-12))
    return float(e.abs().max()), float(rel.max())


#: the flash backward's shapes (B, S, H, K, D, window, causal): qwen3-8b's
#: train shape and B=2 S=1024, hymba's through its window, granite's,
#: qwen2-vl-72b's (G = 8) and hubert-xlarge's (16 heads of 80, non-causal)
FLASH_BWD_SHAPES = ((1, 2048, H, K, D, 0, True), (2, 1024, H, K, D, 0, True),
                    (1, 2048, H5, K5, D64, W5, True),
                    (1, 2048, *MOE_PAIRS["granite"], 0, True),
                    (1, 2048, *VLM_PAIR, 0, True),
                    (1, 2048, *ENC_PAIR, 0, False))


def flash_bwd_check(torch, F, fa, dev):
    """The flash backward at the training shape, qwen3-8b's widths (32 /
    8 heads of 128) at B=1 S=2048 causal, also at B=2 S=1024, at hymba's
    (25 / 5 heads of 64) through a 1024 window at B=1 S=2048, at
    granite's (16 / 8 heads of 64) at B=1 S=2048 causal (the MoE train
    shape ROADMAP item 8a queues), at qwen2-vl-72b's (64 / 8 heads of
    128, causal) and at hubert-xlarge's (16 / 16 heads of 80, non-causal:
    the kernel pads 80 to 128 columns) (:data:`FLASH_BWD_SHAPES`).
    dq, dk and dv are held row by row (:func:`grad_row_err`) against the
    plain backward on the same q, k, v, o, lse and dO (o and lse from the
    forward kernel), beside two planted faults on dk / dv that must fail
    the same check (a Q tile dropped; one head of the group summed, or,
    at G = 1 where that is no fault, the non-causal upper triangle
    dropped: the backward run causal); then timed in turns with the
    library yardstick (the
    backward of SDPA, ``is_causal`` and ``enable_gqa``, with a boolean
    mask for the window: ``torch.autograd.grad`` alone, the forward
    outside the timing), beside the plain version and the forward kernel
    with and without its log-sum-exp.  Bound: 2.5x the forward's causal
    multiply-adds at the bf16 peak, or the bytes (q, k, v, o, dO, lse in;
    dq, dk, dv out) at the memory rate, whichever is larger.  On a
    generator of its own: the kernel phase's shared draws stay as they
    were."""
    g = torch.Generator(dev).manual_seed(SEED + 20)
    tol = TOL["flash_attention_bwd"]
    out = {"shapes": []}
    for B, S, Hq, Kv, Dh, W, C in FLASH_BWD_SHAPES:
        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev).to(
                torch.bfloat16)

        q, k, v, do = (rnd(B, S, Hq, Dh), rnd(B, S, Kv, Dh),
                       rnd(B, S, Kv, Dh), rnd(B, S, Hq, Dh))
        o, lse = fa.flash_attention(q, k, v, causal=C, window=W,
                                    return_lse=True)
        want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                            causal=C, window=W)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=C,
                                     window=W)
        errs = [grad_row_err(torch, a, b) for a, b in zip(got, want)]
        err, rel = max(e for e, _ in errs), max(r for _, r in errs)
        tag = f"G={Hq // Kv} D={Dh} B={B} S={S}" + (
            f" window {W}" if W else "") + ("" if C else " non-causal")
        log(f"kernel flash_attention_bwd {tag}: max_abs_err={err:.3e} worst "
            f"row rel dq/dk/dv={[round(r, 6) for _, r in errs]} (tol {tol}, "
            f"rows floored at {GRAD_FLOOR} x the tensor's rms) [{CARD}]")
        check(rel <= tol, f"flash_attention_bwd {tag} row rel err {rel} > "
              f"{tol}")
        controls = {}
        faults = {"drop_tile": dict(causal=C, drop_tile=True)}
        if Hq > Kv:
            faults["group_fault"] = dict(causal=C, group_fault=True)
        else:                 # G = 1: no other head of a group to drop
            faults["upper triangle dropped"] = dict(causal=True)
        for fault, kw in faults.items():
            bad = fa.flash_attention_bwd(q, k, v, o, lse, do, window=W, **kw)
            c = min(grad_row_err(torch, a, b)[1]
                    for a, b in zip(bad[1:], want[1:]))
            log(f"control flash_attention_bwd {tag} {fault}: worst row rel "
                f"of dk, dv >= {c:.3e} (must exceed tol {tol}) [{CARD}]")
            check(c > tol, f"control flash_attention_bwd {fault} passed the "
                  f"check ({c} <= {tol})")
            controls[fault] = c
        # the yardstick: SDPA's backward on the same tensors
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        mask = None
        if W:
            pos = torch.arange(S, device=dev)
            mask = (pos[None, :] <= pos[:, None]) & \
                (pos[:, None] - pos[None, :] < W)
        lib_out = F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=C and not W,
            enable_gqa=True)
        dot = do.transpose(1, 2)
        med, rounds = in_turns(torch, {
            "kernel": lambda: fa.flash_attention_bwd(
                q, k, v, o, lse, do, causal=C, window=W),
            "library": lambda: torch.autograd.grad(
                lib_out, (qt, kt, vt), dot, retain_graph=True)})
        fwd, _ = in_turns(torch, {
            "with_lse": lambda: fa.flash_attention(
                q, k, v, causal=C, window=W, return_lse=True),
            "without": lambda: fa.flash_attention(q, k, v, causal=C,
                                                  window=W)})
        b_ms, b_by = work_bound(fa.bwd_work(B, S, S, Hq, Kv, Dh, causal=C,
                                            window=W))
        row = dict(B=B, S=S, H=Hq, K=Kv, D=Dh, window=W, causal=C,
                   ms=med["kernel"],
                   library_ms=med["library"], turns_ms=rounds["kernel"],
                   library_turns_ms=rounds["library"], bound_ms=b_ms,
                   bound_by=b_by, row_rel_err=rel, max_abs_err=err,
                   control_row_rel_err=controls,
                   fwd_with_lse_ms=fwd["with_lse"],
                   fwd_without_lse_ms=fwd["without"])
        log(f"timing flash_attention_bwd {tag}: kernel {med['kernel']:.4f} "
            f"ms, SDPA backward {med['library']:.4f} ms (medians of {TURNS} "
            f"turns: kernel {fmt(rounds['kernel'])}, SDPA "
            f"{fmt(rounds['library'])}), bound {b_ms:.4f} ms ({b_by}); "
            f"forward kernel with lse {fwd['with_lse']:.4f} ms, without "
            f"{fwd['without']:.4f} ms [{CARD}]")
        if (Hq, Kv, Dh) in (VLM_PAIR, ENC_PAIR):
            row["plain_ms"] = time_ms(
                torch, lambda: fa.flash_attention_bwd_plain(
                    q, k, v, o, lse, do, causal=C, window=W),
                iters=3, warmup=1)
        if not out["shapes"]:            # the headline: the train shape
            row["plain_ms"] = time_ms(torch, lambda: fa.flash_attention_bwd_plain(
                q, k, v, o, lse, do, causal=True), iters=3, warmup=1)
            out.update(
                route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                replaces="src/repro/models/attention.py:74",
                max_abs_err=err, row_rel_err=rel, tolerance=tol,
                control_row_rel_err=controls, ms=med["kernel"],
                plain_ms=row["plain_ms"], library_ms=med["library"],
                bound_ms=b_ms, bound_by=b_by,
                fwd_with_lse_ms=fwd["with_lse"],
                fwd_without_lse_ms=fwd["without"],
                shape=f"B={B} S={S} H={Hq} K={Kv} D={Dh} causal bf16, three "
                      f"launches a call; kernel and library: medians of "
                      f"{TURNS} turns",
                library_call="torch.autograd.grad of "
                             "F.scaled_dot_product_attention(is_causal, "
                             "enable_gqa)")
        out["shapes"].append(row)
        del qt, kt, vt, lib_out
    return out


#: qwen2-vl-72b prompts as Qwen2-VL's ``get_rope_index`` lays them out:
#: 64 text rows, a 32 x 28 image (896 patches sharing one temporal id),
#: text resuming at the largest id + 1; the forward's B = 2 x S = 1024 has
#: one image a prompt, the backward's B = 1 x S = 2048 two
VL_TEXT, VL_GRID = 64, (32, 28)
VL_FWD_LAYOUT = (("text", VL_TEXT), ("image", *VL_GRID), ("text", VL_TEXT))
VL_BWD_LAYOUT = (("text", VL_TEXT), ("image", *VL_GRID), ("text", VL_TEXT),
                 ("image", *VL_GRID), ("text", 2 * VL_TEXT))


def vl_positions(torch, dev, B, layout):
    """``(3, B, S)`` int32 M-RoPE positions of ``B`` prompts laid out by
    ``layout`` (``("text", n)`` or ``("image", grid_h, grid_w)``
    segments), as ``get_rope_index`` (HF transformers,
    ``modeling_qwen2_vl.py``) computes them for images: a text row's
    three streams are one running id; an image's patches share one
    temporal id (the next id), their height and width streams that id
    plus the patch's row and column; the next segment starts at the
    largest id so far + 1.  The temporal stream (index 0) is the one the
    attention mask compares."""
    streams, nxt = [[], [], []], 0
    for seg in layout:
        if seg[0] == "text":
            ids = list(range(nxt, nxt + seg[1]))
            for st in streams:
                st.extend(ids)
            nxt += seg[1]
        else:
            gh, gw = seg[1], seg[2]
            streams[0].extend([nxt] * (gh * gw))
            streams[1].extend(nxt + i for i in range(gh) for _ in range(gw))
            streams[2].extend(nxt + j for _ in range(gh) for j in range(gw))
            nxt += max(gh, gw)
    pos = torch.tensor(streams, dtype=torch.int32, device=dev)
    return pos[:, None, :].expand(3, B, pos.shape[1]).contiguous()


def _live_pairs(torch, pos, Sq=None, causal=True):
    """Live (query, key) pairs of ``pos`` ``(B, Skv)`` (queries the last
    ``Sq`` rows), and the ``(B, 1, Sq, Skv)`` boolean mask SDPA takes
    for them (True: live)."""
    Sq = Sq or pos.shape[1]
    qp, kp = pos[:, -Sq:, None].long(), pos[:, None, :].long()
    mask = (kp <= qp) if causal else torch.ones_like(qp - kp, dtype=torch.bool)
    return int(mask.sum()), mask[:, None]


def flash_pos_check(torch, F, fa, dev):
    """The flash kernels' positions variant (K7), at qwen2-vl-72b's 64 /
    8 heads of 128 on prompts laid out as ``get_rope_index`` lays them
    out (:func:`vl_positions`), on a generator of its own:

    * forward, B = 2 x S = 1024 (one image a prompt), and a 512-row tail
      at an offset over those keys, each row against the plain version
      with the positions, beside the planted fault (the positions
      dropped: the kernel masks by row index) that must fail the same
      check; and a 512-row prompt whose positions are a random
      permutation (rows in any order);
    * backward (dq, dk, dv), B = 1 x S = 2048 (two images), against the
      plain backward with the positions, beside the same planted fault;
    * positions equal to the row index give the index path's output,
      bitwise, forward and backward;
    * times, in turns with SDPA given the equivalent boolean mask (its
      backward through ``torch.autograd.grad``), beside the plain
      versions; the bounds count operations over the live pairs only."""
    g = torch.Generator(dev).manual_seed(SEED + 26)
    hq, kv, dh = VLM_PAIR
    tol, btol = TOL["flash_attention"], TOL["flash_attention_bwd"]

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    out = {}
    # ---- forward ----
    B, S = 2, 1024
    pos = vl_positions(torch, dev, B, VL_FWD_LAYOUT)[0]
    q, k, v = rnd(B, S, hq, dh), rnd(B, S, kv, dh), rnd(B, S, kv, dh)
    want = fa.flash_attention_plain(q, k, v, causal=True, positions=pos)
    err, rel = row_err(torch, fa.flash_attention(q, k, v, causal=True,
                                                 positions=pos), want)
    log(f"kernel flash_attention positions B={B} S={S} G={hq // kv}: "
        f"max_abs_err={err:.3e} worst row rel={rel:.3e} (tol {tol}) [{CARD}]")
    check(rel <= tol, f"flash_attention positions row rel err {rel} > {tol}")
    ctl = control("flash_attention", "positions ignored (masked by index)",
                  torch, fa.flash_attention(q, k, v, causal=True,
                                            positions=pos,
                                            ignore_positions=True), want)
    T = 512                          # a tail from inside the image on
    want_t = fa.flash_attention_plain(q[:, -T:], k, v, causal=True,
                                      positions=pos)
    terr, trel = row_err(torch, fa.flash_attention(
        q[:, -T:].contiguous(), k, v, causal=True, positions=pos), want_t)
    log(f"kernel flash_attention positions tail {T} over {S}: max_abs_err="
        f"{terr:.3e} worst row rel={trel:.3e} (tol {tol}) [{CARD}]")
    check(trel <= tol, f"flash_attention positions tail row rel {trel}")
    tctl = control("flash_attention", "tail, positions ignored", torch,
                   fa.flash_attention(q[:, -T:].contiguous(), k, v,
                                      causal=True, positions=pos,
                                      ignore_positions=True), want_t)
    perm = torch.randperm(T, generator=g, device=dev).to(torch.int32)
    pq, pk, pv = q[:1, :T].contiguous(), k[:1, :T].contiguous(), \
        v[:1, :T].contiguous()
    perr, prel = row_err(torch, fa.flash_attention(
        pq, pk, pv, causal=True, positions=perm[None]),
        fa.flash_attention_plain(pq, pk, pv, causal=True,
                                 positions=perm[None]))
    log(f"kernel flash_attention positions permuted 1 x {T}: max_abs_err="
        f"{perr:.3e} worst row rel={prel:.3e} (tol {tol}) [{CARD}]")
    check(prel <= tol, f"flash_attention permuted positions row rel {prel}")
    rows = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S)
    same = torch.equal(fa.flash_attention(q, k, v, causal=True,
                                          positions=rows),
                       fa.flash_attention(q, k, v, causal=True))
    log(f"check flash_attention positions 0..S-1 == the index path, "
        f"bitwise: {same} [{CARD}]")
    check(same, "flash_attention: positions 0..S-1 differ from the index "
          "path")
    live, mask = _live_pairs(torch, pos)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    med, rounds = in_turns(torch, {
        "kernel": lambda: fa.flash_attention(q, k, v, causal=True,
                                             positions=pos),
        "library": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True),
        "index": lambda: fa.flash_attention(q, k, v, causal=True)})
    plain = time_ms(torch, lambda: fa.flash_attention_plain(
        q, k, v, causal=True, positions=pos), iters=5)
    b_ms, b_by = work_bound(fa.work(B, S, S, hq, kv, dh, pairs=live,
                                    positions=True))
    log(f"timing flash_attention positions B={B} S={S}: kernel "
        f"{med['kernel']:.4f} ms, SDPA with the mask {med['library']:.4f} ms, "
        f"index path {med['index']:.4f} ms (medians of {TURNS} turns: kernel "
        f"{fmt(rounds['kernel'])}, SDPA {fmt(rounds['library'])}), plain "
        f"{plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}, {live} live pairs of "
        f"{B * S * S}) [{CARD}]")
    out["flash_attention"] = dict(
        shape=f"B={B} S={S} H={hq} K={kv} D={dh} causal bf16, temporal "
              f"positions of {VL_FWD_LAYOUT}", ms=med["kernel"],
        library_ms=med["library"], index_ms=med["index"], plain_ms=plain,
        bound_ms=b_ms, bound_by=b_by, live_pairs=live, max_abs_err=max(
            err, terr, perr), row_rel_err=max(rel, trel, prel),
        control_row_rel_err=min(ctl, tctl), index_bitwise=same,
        turns_ms=rounds["kernel"], library_turns_ms=rounds["library"],
        library_call="F.scaled_dot_product_attention(attn_mask, enable_gqa)")
    # ---- backward ----
    B, S = 1, 2048
    pos = vl_positions(torch, dev, B, VL_BWD_LAYOUT)[0]
    q, k, v, do = rnd(B, S, hq, dh), rnd(B, S, kv, dh), rnd(B, S, kv, dh), \
        rnd(B, S, hq, dh)
    o, lse = fa.flash_attention(q, k, v, causal=True, positions=pos,
                                return_lse=True)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True,
                                        positions=pos)
    errs = [grad_row_err(torch, a, b) for a, b in zip(
        fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                               positions=pos), want)]
    err, rel = max(e for e, _ in errs), max(r for _, r in errs)
    log(f"kernel flash_attention_bwd positions B={B} S={S} G={hq // kv}: "
        f"max_abs_err={err:.3e} worst row rel dq/dk/dv="
        f"{[round(r, 6) for _, r in errs]} (tol {btol}) [{CARD}]")
    check(rel <= btol, f"flash_attention_bwd positions row rel {rel}")
    bad = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                 positions=pos, ignore_positions=True)
    bctl = max(grad_row_err(torch, a, b)[1] for a, b in zip(bad, want))
    log(f"control flash_attention_bwd positions ignored (masked by index): "
        f"worst row rel of dq, dk, dv {bctl:.3e} (must exceed tol {btol}) "
        f"[{CARD}]")
    check(bctl > btol, f"control flash_attention_bwd positions ignored "
          f"passed the check ({bctl} <= {btol})")
    rows = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S)
    oi, li = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    same = all(torch.equal(a, b) for a, b in zip(
        fa.flash_attention_bwd(q, k, v, oi, li, do, causal=True,
                               positions=rows),
        fa.flash_attention_bwd(q, k, v, oi, li, do, causal=True)))
    log(f"check flash_attention_bwd positions 0..S-1 == the index path, "
        f"bitwise: {same} [{CARD}]")
    check(same, "flash_attention_bwd: positions 0..S-1 differ from the "
          "index path")
    live, mask = _live_pairs(torch, pos)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                             enable_gqa=True)
    dot = do.transpose(1, 2)
    med, rounds = in_turns(torch, {
        "kernel": lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                 causal=True, positions=pos),
        "library": lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                               retain_graph=True),
        "index": lambda: fa.flash_attention_bwd(q, k, v, oi, li, do,
                                                causal=True)})
    plain = time_ms(torch, lambda: fa.flash_attention_bwd_plain(
        q, k, v, o, lse, do, causal=True, positions=pos), iters=3, warmup=1)
    b_ms, b_by = work_bound(fa.bwd_work(B, S, S, hq, kv, dh, pairs=live,
                                        positions=True))
    log(f"timing flash_attention_bwd positions B={B} S={S}: kernel "
        f"{med['kernel']:.4f} ms, SDPA backward with the mask "
        f"{med['library']:.4f} ms, index path {med['index']:.4f} ms "
        f"(medians of {TURNS} turns: kernel {fmt(rounds['kernel'])}, SDPA "
        f"{fmt(rounds['library'])}), plain {plain:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}, {live} live pairs of {B * S * S}) [{CARD}]")
    out["flash_attention_bwd"] = dict(
        shape=f"B={B} S={S} H={hq} K={kv} D={dh} causal bf16, temporal "
              f"positions of {VL_BWD_LAYOUT}", ms=med["kernel"],
        library_ms=med["library"], index_ms=med["index"], plain_ms=plain,
        bound_ms=b_ms, bound_by=b_by, live_pairs=live, max_abs_err=err,
        row_rel_err=rel, control_row_rel_err=bctl, index_bitwise=same,
        turns_ms=rounds["kernel"], library_turns_ms=rounds["library"],
        library_call="torch.autograd.grad of "
                     "F.scaled_dot_product_attention(attn_mask, enable_gqa)")
    del qt, kt, vt, lib_out
    return out


#: the SSD backward's shapes (B, S, H, P, N, G, chunk, with an initial
#: state and a gradient of the final state): mamba2-2.7b's and
#: hymba-1.5b's at the train shape as training calls it (neither), then
#: a reduced width with both, a ragged S, G < H and a smaller chunk
SSD_BWD_SHAPES = ((1, 2048, SSD_H, SSD_P, SSD_N, SSD_G, 256, False),
                  (1, 2048, HSSD_H, SSD_P, HSSD_N, SSD_G, 256, False),
                  (2, 1000, 8, 32, 16, 2, 64, True))
SSD_BWD_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dinit")
#: the SSD backward's planted faults: the key side's diagonal query
#: tile left out; no gradient passed between chunks
SSD_BWD_FAULTS = ("skip_tile", "no_carry")


def ssd_bwd_check(torch, dev):
    """The SSD scan's backward kernel at :data:`SSD_BWD_SHAPES`: every
    gradient (dx, ddt, dA, dB, dC and, with an initial state, its
    gradient) held row by row (:func:`grad_row_err`: a row is one
    (batch, position, head)'s P values of dx, one position's H values of
    ddt, dA whole, one (position, group)'s N values of dB / dC) against
    ``ssd_scan_bwd_plain`` in fp64 on the fp64 forward's y and states, at
    the forward's bound :data:`TOL` ``["ssd_scan"]``; beside the planted
    faults (:data:`SSD_BWD_FAULTS`) that must each fail the same check.
    At mamba2's and hymba's shapes (the first two), timed in turns
    against torch autograd of the fp32 plain forward, beside the plain
    backward, the device time of each pass, and the bound: the
    operations the gradient needs (``ssd_scan.bwd_work``) at 67 TFLOP/s
    (fp64 tensor cores), or its bytes.  The result's top-level keys are
    mamba2's; each shape's row holds its own.  On a generator of its
    own."""
    import torch.nn.functional as F

    from repro_torch.kernels import ssd_scan as ssd

    g = torch.Generator(dev).manual_seed(SEED + 30)
    tol = TOL["ssd_scan_bwd"]
    out = {"shapes": []}

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    for B, S, H, P, N, G, chunk, ends in SSD_BWD_SHAPES:
        ins = (F.silu(rnd(B, S, H, P)), F.softplus(rnd(B, S, H) - 2.0),
               -torch.linspace(1.0, 16.0, H, device=dev),
               F.silu(rnd(B, S, G, N)), F.silu(rnd(B, S, G, N)))
        s0 = rnd(B, H, P, N) if ends else None
        dy = rnd(B, S, H, P)
        dfin = rnd(B, H, P, N) if ends else None
        y, fin, states = ssd.ssd_scan(*ins, chunk=chunk, initial_state=s0,
                                      return_states=True)

        def kernel(**fault):
            return ssd.ssd_scan_bwd(*ins, y, states, fin, dy, dfin,
                                    chunk=chunk, initial_grad=ends, **fault)

        def f64(t):
            return None if t is None else t.double()

        y64, fin64, st64 = ssd.ssd_scan_plain(
            *map(f64, ins), chunk=chunk, initial_state=f64(s0),
            return_states=True)
        want = ssd.ssd_scan_bwd_plain(*map(f64, ins), y64, st64, fin64,
                                      f64(dy), f64(dfin), chunk=chunk,
                                      initial_grad=ends)
        y32, fin32, st32 = ssd.ssd_scan_plain(*ins, chunk=chunk,
                                              initial_state=s0,
                                              return_states=True)
        plain = ssd.ssd_scan_bwd_plain(*ins, y32, st32, fin32, dy, dfin,
                                       chunk=chunk, initial_grad=ends)

        def rows(got):
            """(max abs err, worst row rel) of each gradient, by name."""
            return {n: grad_row_err(torch, a.reshape(-1, a.shape[-1]) if
                                    n != "dA" else a[None],
                                    b.reshape(-1, b.shape[-1]) if n != "dA"
                                    else b[None])
                    for n, a, b in zip(SSD_BWD_GRADS, got, want)
                    if b is not None}

        got = rows(kernel())
        rel = max(r for _, r in got.values())
        err = max(e for e, _ in got.values())
        plain_rel = max(r for _, r in rows(plain).values())
        ctls = {f: max(r for _, r in rows(kernel(**{f: True})).values())
                for f in SSD_BWD_FAULTS}
        ctl = min(ctls.values())
        tag = (f"B={B} S={S} H={H} P={P} N={N} G={G} chunk={chunk}"
               + (" with initial and final state gradients" if ends else ""))
        log(f"kernel ssd_scan_bwd {tag}: max_abs_err={err:.3e} worst row "
            f"rel against fp64 "
            f"{dict((n, round(r, 7)) for n, (_, r) in got.items())} (the "
            f"fp32 plain backward against fp64 {plain_rel:.3e}; tol {tol}, "
            f"rows floored at {GRAD_FLOOR} x the tensor's rms) [{CARD}]")
        for fault, c in ctls.items():
            log(f"control ssd_scan_bwd {tag} {fault}: worst row rel "
                f"{c:.3e} (must exceed tol {tol}) [{CARD}]")
            check(c > tol, f"control ssd_scan_bwd {fault} passed the check "
                  f"({c} <= {tol})")
        check(rel <= tol, f"ssd_scan_bwd {tag} row rel err {rel} > {tol}")
        row = dict(B=B, S=S, H=H, P=P, N=N, G=G, chunk=chunk, ends=ends,
                   row_rel_err={n: r for n, (_, r) in got.items()},
                   max_abs_err=err, plain_row_rel_err_fp64=plain_rel,
                   control_row_rel_err=ctl, controls=ctls)
        if len(out["shapes"]) < 2:       # mamba2's and hymba's shapes
            leaves = [t.detach().clone().requires_grad_() for t in ins]
            y_auto, _ = ssd.ssd_scan_plain(*leaves, chunk=chunk)
            med, rounds = in_turns(torch, {
                "kernel": lambda: kernel(),
                "autograd_plain": lambda: torch.autograd.grad(
                    y_auto, leaves, dy, retain_graph=True)})
            plain_ms = time_ms(torch, lambda: ssd.ssd_scan_bwd_plain(
                *ins, y32, st32, fin32, dy, chunk=chunk), iters=3, warmup=1)
            passes = {re.search(r"(\w+)(<[^>]*>)?\(", k).group(1): v
                      for k, v in device_ms_by_kernel(
                          torch, lambda: kernel()).items()}
            b_ms, b_by = work_bound(ssd.bwd_work(B, S, H, P, G, N, chunk),
                                    PEAK_FP32)
            log(f"timing ssd_scan_bwd {tag}: kernel {med['kernel']:.4f} ms, "
                f"autograd of the plain forward "
                f"{med['autograd_plain']:.4f} ms (medians of {TURNS} turns: "
                f"kernel {fmt(rounds['kernel'])}, autograd "
                f"{fmt(rounds['autograd_plain'])}), plain backward "
                f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); device "
                f"time per call by pass (torch.profiler) "
                + ", ".join(f"{k} {v:.4f} ms" for k, v in passes.items())
                + f" [{CARD}]")
            row.update(ms=med["kernel"], turns_ms=rounds["kernel"],
                       plain_ms=plain_ms,
                       autograd_plain_ms=med["autograd_plain"],
                       autograd_plain_turns_ms=rounds["autograd_plain"],
                       passes_ms=passes, bound_ms=b_ms, bound_by=b_by)
        if not out["shapes"]:            # the headline: mamba2's shape
            out.update(
                route="cuda",
                source="src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
                replaces="src/repro/models/ssm.py:53",
                max_abs_err=err, row_rel_err=rel, tolerance=tol,
                control_row_rel_err=ctl, ms=row["ms"],
                turns_ms=row["turns_ms"], plain_ms=row["plain_ms"],
                autograd_plain_ms=row["autograd_plain_ms"],
                autograd_plain_turns_ms=row["autograd_plain_turns_ms"],
                library_ms=None, passes_ms=row["passes_ms"],
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                shape=f"B={B} S={S} H={H} P={P} N={N} G={G} chunk={chunk} "
                      f"fp32, five launches a call; bound at the fp64 "
                      f"tensor-core rate",
                library_call="none: no PyTorch call computes the SSD scan's "
                             "backward (the reference differentiates its "
                             "jnp mirror with XLA)")
        out["shapes"].append(row)
    out["row_rel_err"] = max(max(r["row_rel_err"].values())
                             for r in out["shapes"])
    out["control_row_rel_err"] = min(r["control_row_rel_err"]
                                     for r in out["shapes"])
    return out


@contextlib.contextmanager
def plain_kernels(on: bool = True):
    """While ``on``, the model's attention runs ``flash_attention_plain``
    and its SSD scan ``ssd_scan_plain`` (both differentiable by torch
    autograd) on the card, in place of the kernels: the reference the
    train and M-RoPE checks hold the kernels against."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import ssm as ssm_mod

    routed = attn_mod.attention_chunked, ssm_mod.ssd_chunked
    if on:
        attn_mod.attention_chunked = (
            lambda q, k, v, *, causal, window, tiles, mode, mask_pos=None:
            fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                     positions=mask_pos))
        ssm_mod.ssd_chunked = (
            lambda x, dt, A, Bm, Cm, chunk, initial_state=None, *,
            heads_block=None, mode="auto": ssd.ssd_scan_plain(
                x, dt, A, Bm, Cm, chunk=chunk, initial_state=initial_state))
    try:
        yield
    finally:
        attn_mod.attention_chunked, ssm_mod.ssd_chunked = routed


def _last_layer_grads(torch, arch, params, batch, cfg, plain: bool):
    """The training loss of ``batch`` and the gradients of the last step
    of the layer loop (a layer: its leaves and its input): the steps
    before it run without autograd, the last with it under ``cfg.remat``
    (so its backward recomputes the forward as the plan's step does),
    then the final norm, the logits and the loss with the MoE layers' aux
    losses, as ``lm.train_loss`` computes them.  ``plain`` sends
    attention through ``flash_attention_plain`` and the SSD scan through
    ``ssd_scan_plain`` under torch autograd instead of the kernels'
    autograd functions (:func:`plain_kernels`).  A batch of ``embeds``
    (and M-RoPE ``positions``, an audio ``mask``) enters as
    ``lm.train_loss`` takes it."""
    from repro_torch.models import lm
    from repro_torch.models.common import cross_entropy_loss, rms_norm

    with plain_kernels(plain):
        groups = lm.layer_groups(arch, params["blocks"])
        g = arch.n_layers // len(groups)
        windows = lm._window_schedule(arch)

        def win(j):
            return tuple(windows[j * g:(j + 1) * g])

        aux = 0.0
        with torch.no_grad():
            x, positions, mask_pos = lm._embed_in(arch, params, batch)
            for j in range(len(groups) - 1):
                x, a = lm._group_fwd(arch, cfg, groups[j], x, positions,
                                     win(j), mask_pos)
                aux = aux if a is None else aux + a
        x = x.detach().requires_grad_()
        last = _map_tree(groups[-1], lambda t: t.detach().requires_grad_())
        block = lm._remat(functools.partial(lm._group_fwd, arch, cfg),
                          cfg.remat)
        y, a = block(last, x, positions, win(len(groups) - 1), mask_pos)
        aux = aux if a is None else aux + a
        y = rms_norm(y, params["final_norm"], arch.norm_eps)
        loss, _ = cross_entropy_loss(lm._logits(arch, params, y),
                                     batch["targets"], batch.get("mask"),
                                     vocab_size=arch.vocab_size)
        loss = loss + lm.AUX_LOSS_WEIGHT * aux
        named = [("input", x)] + _named(last)
        grads = torch.autograd.grad(loss, [t for _, t in named])
        return float(loss.detach()), {n: g for (n, _), g in zip(named, grads)}


@contextlib.contextmanager
def positions_ignored():
    """Send the flash kernels (forward and backward) positions' masks
    through their planted fault: the positions dropped, so the kernels
    mask by row index — a control the model-level checks must catch."""
    from repro_torch.kernels import flash_attention as fa

    kernels = fa.flash_attention, fa.flash_attention_bwd
    fa.flash_attention = functools.partial(kernels[0], ignore_positions=True)
    fa.flash_attention_bwd = functools.partial(kernels[1],
                                               ignore_positions=True)
    try:
        yield
    finally:
        fa.flash_attention, fa.flash_attention_bwd = kernels


@contextlib.contextmanager
def planted_bwd(fault: str):
    """Send a kernels' autograd function's backward through its kernel
    with one planted fault: the flash backward's ``drop_tile`` /
    ``group_fault``, or the SSD backward's (:data:`SSD_BWD_FAULTS`): a
    control that the check around it must catch."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd

    mod, name = (ssd, "ssd_scan_bwd") if fault in SSD_BWD_FAULTS \
        else (fa, "flash_attention_bwd")
    kernel = getattr(mod, name)
    setattr(mod, name, functools.partial(kernel, **{fault: True}))
    try:
        yield
    finally:
        setattr(mod, name, kernel)


def backward_faults(arch):
    """The planted backward faults a train check of ``arch`` must catch:
    the flash backward's dropped tile where it has attention, the SSD
    backward's skipped tile where it has an SSM.  (The SSD backward's
    missing carry is held by the kernel check, row by row: the model's
    decays, e^(dt A) per row with A from -1 to -16, leave little of a
    state to carry 256 rows on, so a parameter's gradient, summed over
    every row, barely moves.)"""
    return (("drop_tile",) if arch.has_attention else ()) + \
        (("skip_tile",) if arch.has_ssm else ())


def routed_leaf(arch, name: str) -> bool:
    """Whether the last layer's leaf ``name`` (a :func:`_named` path) is
    an MoE FFN's: its norm, router or experts."""
    if not arch.is_moe:
        return False
    if arch.moe_interleave > 1:          # a super-block: its MoE half
        if not name.startswith("moe/"):
            return False
        name = name[len("moe/"):]
    return name == "mlp_norm" or name.startswith("moe/")


def train_grad_check(torch, dev, arch, cfg, params, batch):
    """(b) of the train phase: the step-0 loss and the last layer's
    gradients through the kernels (forward and backward) against the same
    layer and loss through the plain attention and SSD scan under
    autograd, on the same card.  rms-relative per gradient tensor at the
    arch's :data:`TRAIN_GRAD_TOL`, an MoE FFN's leaves left out
    (:func:`routed_leaf`), beside its noise floor (the kernels against
    themselves under another tile: flash 64 rows x 64 keys, the SSD
    chunk 128) and controls that must fail it: a wrong input (the targets
    shifted by one) on every leaf held, and a wrong backward for each
    kernel pair the layer runs (:func:`backward_faults`, through the
    autograd route) on one."""
    loss_k, gk = _last_layer_grads(torch, arch, params, batch, cfg, False)
    loss_p, gp = _last_layer_grads(torch, arch, params, batch, cfg, True)
    gp = {n: g for n, g in gp.items() if not routed_leaf(arch, n)}
    retile = {}
    if arch.has_attention:
        retile["flash_tiles"] = (64 // (arch.n_heads // arch.n_kv_heads), 64)
    if arch.has_ssm:
        retile["ssd_chunk"] = 128
    _, gr = _last_layer_grads(torch, arch, params, batch,
                              dataclasses.replace(cfg, **retile), False)
    wrong = dict(batch, targets=(batch["targets"] + 1) % arch.vocab_size)
    _, gw = _last_layer_grads(torch, arch, params, wrong, cfg, False)
    dropped = {}
    for fault in backward_faults(arch):
        with planted_bwd(fault):
            _, gd = _last_layer_grads(torch, arch, params, batch, cfg, False)
        dropped[fault] = {n: _rms_rel(torch, gd[n].float(), gp[n].float())
                          for n in gp}
    tol = TRAIN_GRAD_TOL[arch.name]

    def rels(g, want):                   # over the leaves held
        return {n: round(_rms_rel(torch, g[n].float(), want[n].float()), 6)
                for n in gp}

    rel, floors, wrong_rel = rels(gk, gp), rels(gr, gk), rels(gw, gp)
    ctl = min(wrong_rel.values())
    planted = {f: max(d.values()) for f, d in dropped.items()}
    worst = max(rel.values())
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    log(f"check train {arch.name} step-0 loss kernels {loss_k:.6f} vs plain "
        f"{loss_p:.6f} (rel {loss_rel:.3e}); last layer's gradients "
        f"rms_rel worst {worst:.3e} ({max(rel, key=rel.get)}; tol {tol}"
        + (", an MoE FFN's leaves not held" if arch.is_moe else "")
        + f"; kernels re-tiled {retile} "
        f"against themselves {max(floors.values()):.3e}; wrong-target "
        f"control >= {ctl:.3e}; planted backward controls worst "
        + ", ".join(f"{f} {v:.3e}" for f, v in planted.items())
        + f") {rel}; floors {floors}; wrong target {wrong_rel}; "
        + "; ".join(f"{f} {dict((n, round(v, 6)) for n, v in d.items())}"
                    for f, d in dropped.items()) + f" [{CARD}]")
    check(all(math.isfinite(x) for x in (loss_k, loss_p)),
          "train check: loss not finite")
    check(worst <= tol and loss_rel <= LOGIT_TOL,
          f"train check: gradients rms_rel {rel} over {tol} or loss rel "
          f"{loss_rel} > {LOGIT_TOL}")
    check(ctl > tol, f"train check: the wrong-target control passed ({ctl})")
    for fault, v in planted.items():
        check(v > tol, f"train check: the {fault} backward control passed "
              f"({v})")
    return dict(loss_kernels=loss_k, loss_plain=loss_p, loss_rel=loss_rel,
                grad_rms_rel=rel, floors=floors, retile=retile,
                wrong_target=wrong_rel, control=ctl,
                planted_controls=dropped, tol=tol)


class RoundingCheck:
    """Wraps ``adamw._stochastic_round_bf16`` for (c) of the train phase:
    every element it rounds must come out as one of the two bf16
    neighbours of its fp32 value (the truncated bits, or those plus one
    bf16 ulp), and the count rounded up must match the expected count,
    the sum of the truncated fractions, within six standard deviations."""

    def __init__(self, torch, fn):
        self.torch, self.fn = torch, fn
        self.elements = self.off_pair = self.up = 0
        self.expect_up = self.var = 0.0

    def __call__(self, x, generator):
        torch = self.torch
        out = self.fn(x, generator)
        bits = x.float().contiguous().view(torch.int32)
        lo = bits & -65536
        got = out.float().view(torch.int32)
        up = got == lo + 65536
        frac = (bits & 0xFFFF).double() / 65536
        self.off_pair += int((~(up | (got == lo))).sum())
        self.up += int(up.sum())
        self.expect_up += float(frac.sum())
        self.var += float((frac * (1 - frac)).sum())
        self.elements += x.numel()
        return out


def expandable_segments(torch) -> dict:
    """Switch the caching allocator to segments that grow in place, for
    the training phases, and check that a fresh allocation lands in one.
    The train plans fill up to 0.95 of the card (qwen2-vl-72b's step
    peaks at 68.6 GiB): under the classic segments, blocks split for
    smaller requests left 13.31 GiB reserved but free when the fit asked
    for 6.32 GiB in one piece, and the run ran out of memory at 62.27
    GiB allocated in some runs of the same tree and not in others.
    Before this point classic segments are kept: the disaggregated
    prefill phase exports its weights as ``cuIpcGetMemHandle`` handles,
    which a segment mapped through the virtual-memory API does not
    give.  No later phase shares device memory across processes."""
    import gc

    settings = getattr(torch._C, "_accelerator_setAllocatorSettings", None)
    (settings or torch.cuda.memory._set_allocator_settings)(
        "expandable_segments:True")
    gc.collect()
    torch.cuda.empty_cache()
    probe = torch.empty(2 << 30, dtype=torch.uint8, device="cuda")
    ptr = probe.data_ptr()
    seg = [s for s in torch.cuda.memory_snapshot()
           if s["address"] <= ptr < s["address"] + s["total_size"]]
    del probe
    torch.cuda.empty_cache()
    expandable = [x.get("is_expandable") for x in seg]
    check(expandable == [True], "a 2 GiB allocation after switching to "
          f"expandable segments sits in segments {expandable}")
    res = dict(expandable_segments=True,
               probe_segment_bytes=seg[0]["total_size"],
               reserved_bytes=torch.cuda.memory_reserved(),
               allocated_bytes=torch.cuda.memory_allocated())
    log(f"allocator: expandable segments on for the training phases (a "
        f"2 GiB probe in a segment of {res['probe_segment_bytes']} B); "
        f"{res['allocated_bytes']} B allocated, {res['reserved_bytes']} B "
        f"reserved [{CARD}]")
    return res


def train_plan(specialize, arch, shape):
    """``arch`` at its full depth and its ``h100-sxm`` plan for
    ``shape``, or, if that plan's step-peak estimate does not fit the
    card (``step_fits`` 0 at every remat), the deepest cut whose plan
    fits."""
    for n in range(arch.n_layers, 0, -1):
        cut = dataclasses.replace(arch, n_layers=n)
        plan = specialize(cut, shape, mesh_shape=(1, 1), target="h100-sxm",
                          plan_dir=PLAN_DIR)
        if plan.estimates.get("step_fits"):
            return cut, plan
    fail(f"train: no depth of {arch.name} fits the card by its plan")


def expected_train_launches(arch, remat: str):
    """Kernel launches of one train step: each attention layer's flash
    forward and each SSM layer's SSD-scan forward once, twice under remat
    (the backward runs the layer's forward again), and each one's
    backward once; nothing else."""
    L_attn = arch.n_layers if arch.has_attention else 0
    L_ssm = arch.n_layers if arch.has_ssm else 0
    again = 1 if remat == "none" else 2
    return {"flash_attention": again * L_attn, "flash_attention_bwd": L_attn,
            "ssd_scan": again * L_ssm, "ssd_scan_bwd": L_ssm}


def train_phase(torch, dev, name="qwen3-8b"):
    """Full-width ``name`` at the depth its plan admits
    (:func:`train_plan`: every layer when the step fits), trained from
    the unmodified ``h100-sxm`` plan for ``ShapeConfig("train_2k",
    "train", 2048, 1)`` — optimizer state, remat, microbatches and the
    MoE path as planned — through ``Trainer.fit`` for
    :data:`TRAIN_STEPS` steps on the synthetic pipeline, every earlier
    weight freed first.  Before the fit, the kernels' gradient check
    (:func:`train_grad_check`; for an M-RoPE arch first on a batch with
    two images' repeated temporal ids, the positions variant, before the
    optimizer state is allocated); where the plan keeps no master copy
    (bf16 parameters updated by stochastic rounding) the last step runs
    with :class:`RoundingCheck` on the optimizer's rounding; the steps
    before it are timed clean.  The launches are held to
    :func:`expected_train_launches` a step, and the fit's peak allocated
    memory against the plan's step-peak estimate: ``peak <= estimate <=``
    :data:`STEP_PEAK_OVER` ``x peak``.  For an M-RoPE arch, one more step
    of ``trainer.step_fn`` after the fit, on a batch with two images'
    repeated temporal ids: finite, and its launches those of a step with
    the flash forward and backward taken by the positions variant."""
    import gc

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core import specialize
    from repro_torch.core.passes.lowering import build_run_cfg
    from repro_torch.data import SyntheticSource, to_device
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.train import plan_memory
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.train import Trainer, TrainerConfig

    shape = ShapeConfig("train_2k", "train", 2048, 1)
    full = get_arch(name)
    arch, plan = train_plan(specialize, full, shape)
    est = plan_memory(plan)
    remat = plan.comm.remat_policy
    decisions = {"opt": dict(plan.opt), "remat": remat,
                 "microbatches": plan.comm.microbatches,
                 **{k: dict(plan.partitions[k].blocks)
                    for k in ("flash_attention", "ssd_scan")
                    if k in plan.partitions}}
    if arch.is_moe:
        decisions["moe_impl"] = plan.estimates["moe_impl"]
    log(f"train plan {name} {plan.content_hash()[:12]} at {arch.n_layers} "
        f"of {full.n_layers} layers: {decisions}; step peak estimate "
        f"{est['peak'] / 2**30:.2f} GiB (state {est['state'] / 2**30:.2f}, "
        f"gradients {est['grads'] / 2**30:.2f}, saved activations "
        f"{est['saved'] / 2**30:.2f}, largest transient "
        f"{est['transient'] / 2**30:.2f}) against a budget of "
        f"{est['budget'] / 2**30:.2f} GiB (the plan's estimates)")
    for entry in plan.log:
        if entry[0] in ("data_organization", "communication"):
            log("  train plan: " + " | ".join(entry))
    if name == "qwen3-8b":
        check(plan.opt == {"moment_dtype": "bfloat16",
                           "master_weights": False},
              f"the train plan's optimizer decisions moved: {plan.opt}")
    cfg = build_run_cfg(plan, arch)
    trainer = Trainer(plan, None, TrainerConfig(
        n_steps=TRAIN_STEPS, ckpt_every=0, log_every=1, seed=SEED,
        ckpt_dir=str(ROOT / "build" / "ckpt_train")), arch=arch,
        shape=shape, device=dev)
    grad_pos = None
    if arch.mrope_sections is not None:
        # the gradient check with repeated temporal ids (the positions
        # variant of the flash forward and backward, its launches
        # counted) on the parameters init_state draws (the same
        # generator), before the optimizer state exists, then freed: the
        # fit's memory is as it was without it (qwen2-vl's plan fills the
        # card)
        params0 = lm.init_params(arch, torch.Generator(dev).manual_seed(SEED),
                                 *plan.padded_sizes())
        vpos = vl_positions(torch, dev, shape.global_batch, VL_BWD_LAYOUT)
        check(vpos.shape[-1] == shape.seq_len,
              f"train {name}: layout of {vpos.shape[-1]} rows")
        batch0 = dict(to_device(dev)(SyntheticSource(
            arch, shape, seed=SEED).batch_at(0)), positions=vpos)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        grad_pos = train_grad_check(torch, dev, arch, cfg, params0, batch0)
        torch.cuda.synchronize()
        pos_counts = ops.launch_counts()
        del params0, batch0
        gc.collect()
        torch.cuda.empty_cache()
        check(pos_counts["flash_attention_positions"] > 0
              and pos_counts["flash_attention_bwd_positions"] > 0,
              f"train {name}: the positions variant did not launch "
              f"({pos_counts})")
        grad_pos["launches"] = pos_counts
        log(f"check train {name} with repeated temporal ids "
            f"({VL_BWD_LAYOUT}): positions-variant launches forward "
            f"{pos_counts['flash_attention_positions']}, backward "
            f"{pos_counts['flash_attention_bwd_positions']} [{CARD}]")
    t0 = time.perf_counter()
    state = trainer.init_state(SEED)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(state["params"]))
    log(f"weights: {name} layers={arch.n_layers} (of {full.n_layers}) "
        f"d_model={arch.d_model} heads={arch.n_heads}/{arch.n_kv_heads} "
        f"ssm_heads={arch.ssm_heads if arch.has_ssm else 0} d_ff="
        f"{arch.d_ff} experts={arch.n_experts} vocab={arch.vocab_size} "
        f"params={n_params} random (seed {SEED}) with the optimizer state "
        f"in {time.perf_counter() - t0:.1f} s; allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB [{CARD}]")
    batch0 = to_device(dev)(SyntheticSource(arch, shape,
                                            seed=SEED).batch_at(0))
    grad = train_grad_check(torch, dev, arch, cfg, state["params"], batch0)
    del batch0
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    state, _ = trainer.fit(state, n_steps=TRAIN_STEPS - 1)
    stochastic = not plan.opt["master_weights"]
    sr = RoundingCheck(torch, adamw._stochastic_round_bf16)
    if stochastic:
        adamw._stochastic_round_bf16 = sr
    try:
        state, metrics = trainer.fit(state, n_steps=TRAIN_STEPS,
                                     start_step=TRAIN_STEPS - 1)
    finally:
        adamw._stochastic_round_bf16 = sr.fn
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    peak_reserved = torch.cuda.max_memory_reserved()
    hist = trainer.history
    for h in hist:
        note = (" (with the rounding check)"
                if stochastic and h is hist[-1] else "")
        log(f"train {name} step {h['step']}: loss {h['loss']:.6f} grad_norm "
            f"{h['grad_norm']:.6f} lr {h['lr']:.4e} {h['dt_s'] * 1e3:.1f} ms"
            f"{note} [{CARD}]")
    timed = hist[1:-1]
    step_ms = sorted(h["dt_s"] * 1e3 for h in timed)[len(timed) // 2]
    tok_s = shape.tokens / (step_ms / 1e3)
    bf16_elems = sum(t.numel() for _, t in _named(state["params"])
                     if t.dtype == torch.bfloat16)
    L = arch.n_layers
    per_step = expected_train_launches(arch, remat)
    log(f"train {name}: {len(hist)} steps at {L} layers, remat {remat}, "
        f"median step {step_ms:.1f} ms over steps 1..{len(hist) - 2} "
        f"({tok_s:.1f} tokens/s); launches {counts} ({per_step} a step "
        f"expected) [{CARD}]")
    log(f"train {name} {launch_train.memory_line(plan, peak)} (tol: "
        f"estimate within [1, {STEP_PEAK_OVER}] x the measured peak); "
        f"peak reserved {peak_reserved / 2**30:.2f} GiB [{CARD}]")
    if stochastic:
        log(f"train {name} rounding check: {sr.elements} bf16 elements "
            f"rounded of {bf16_elems}, {sr.off_pair} off their neighbour "
            f"pair, {sr.up} up against {sr.expect_up:.1f} expected (sd "
            f"{math.sqrt(sr.var):.1f}) [{CARD}]")
    check(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
              for h in hist), f"train {name}: a loss or grad norm is not "
          "finite")
    check(len(hist) == TRAIN_STEPS, f"train {name}: {len(hist)} steps")
    check(all(counts[k] == per_step.get(k, 0) * TRAIN_STEPS for k in counts),
          f"train {name}: launches {counts}, expected {per_step} a step "
          f"under remat {remat}")
    check(peak <= est["peak"] <= STEP_PEAK_OVER * peak,
          f"train {name}: the plan's step peak estimate {est['peak']} B is "
          f"not within [1, {STEP_PEAK_OVER}] x the measured peak {peak} B")
    check(abs(hist[0]["loss"] - grad["loss_kernels"])
          <= 1e-3 * abs(grad["loss_kernels"]),
          f"train {name}: step-0 loss {hist[0]['loss']} against the checked "
          f"{grad['loss_kernels']}")
    check(not stochastic or (
        sr.elements == bf16_elems and sr.off_pair == 0
        and abs(sr.up - sr.expect_up) <= 6 * math.sqrt(sr.var) + 1),
        f"train {name}: stochastic rounding left the neighbour pair or is "
        "biased")
    fit_pos = None
    if arch.mrope_sections is not None:
        # one more step of the trainer's own step function on a batch
        # laid out as get_rope_index lays out two images: the positions
        # variant on the training path, its launches from this step alone
        vbatch = dict(to_device(dev)(SyntheticSource(
            arch, shape, seed=SEED).batch_at(TRAIN_STEPS)),
            positions=vl_positions(torch, dev, shape.global_batch,
                                   VL_BWD_LAYOUT))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        state, vm = trainer.step_fn(state, vbatch)
        vloss = float(vm["loss"])
        torch.cuda.synchronize()
        fit_pos = dict(launches=ops.launch_counts(), loss=vloss,
                       grad_norm=float(vm["grad_norm"]))
        del vbatch, vm
        # a launch of the positions variant counts as a flash launch too
        want = {k: per_step.get(k, 0) for k in fit_pos["launches"]}
        want.update(flash_attention_positions=per_step["flash_attention"],
                    flash_attention_bwd_positions=per_step[
                        "flash_attention_bwd"])
        log(f"train {name} step {TRAIN_STEPS} on two images' repeated "
            f"temporal ids ({VL_BWD_LAYOUT}): loss {vloss:.6f} grad_norm "
            f"{fit_pos['grad_norm']:.6f}; launches {fit_pos['launches']} "
            f"[{CARD}]")
        check(math.isfinite(vloss) and math.isfinite(fit_pos["grad_norm"]),
              f"train {name}: the step with repeated temporal ids is not "
              "finite")
        check(fit_pos["launches"] == want,
              f"train {name}: the step with repeated temporal ids launched "
              f"{fit_pos['launches']}, expected {want}")
    res = dict(plan=plan.content_hash(), decisions=decisions,
               n_layers=L, n_params=n_params, steps=hist, step_ms=step_ms,
               tokens_per_s=tok_s, peak_bytes=peak,
               peak_reserved_bytes=peak_reserved,
               plan_memory=est, estimate_over_peak=est["peak"] / peak,
               launches=counts, launches_per_step=per_step,
               grad_check=grad, grad_check_positions=grad_pos,
               step_positions=fit_pos,
               final={k: float(v) for k, v in metrics.items()})
    if stochastic:
        res["rounding"] = dict(elements=sr.elements, off_pair=sr.off_pair,
                               up=sr.up, expect_up=sr.expect_up)
    del state, trainer, metrics
    torch.cuda.empty_cache()
    return counts, res


def frontend_phases(torch, dev):
    """Phases 20-23, each after every earlier weight was freed:
    qwen2-vl-72b served at full width cut to 16 layers
    (:func:`qwen2vl_phase`, with its consistency and M-RoPE checks), then
    trained at full width at the depth its ``h100-sxm`` 2048 x 1 train
    plan admits, on the synthetic source's patch embeddings and
    positions; hubert-xlarge trained at full width and depth (48 layers)
    from its own plan, on frames, targets and the audio mask, its
    attention through the non-causal flash forward and backward at
    head_dim 80 (:func:`train_phase` for both); then a small qwen2-vl and
    a small hubert on the card against the CPU
    (:func:`small_train_check`).  Returns the launch counts by run and
    the results."""
    from repro_torch.kernels import ops

    serve_counts, serve, _ = qwen2vl_phase(torch, dev)
    ops.reset_launch_counts()
    vl_counts, vl = train_phase(torch, dev, QWEN2VL)
    hu_counts, hu = train_phase(torch, dev, HUBERT)
    small = {name: small_train_check(torch, dev, name)
             for name in (QWEN2VL, HUBERT)}
    ops.reset_launch_counts()
    # the positions variant on the main path: the trainer's step on a
    # batch with repeated temporal ids (the M-RoPE prefill check's and
    # the gradient check's launches are logged with those checks)
    counts = {"qwen2-vl serve": serve_counts, "qwen2-vl train": vl_counts,
              "hubert train": hu_counts,
              "qwen2-vl positions": vl["step_positions"]["launches"]}
    return counts, {"qwen2-vl serve": serve, "qwen2-vl train": vl,
                    "hubert train": hu, "small_train": small,
                    "launches": counts}


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _named(tree, prefix=""):
    """``(path, leaf)`` pairs of a nested dict, keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _named(tree[k],
                                                        f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _clone(torch, tree):
    return _map_tree(tree, lambda t: t.detach().clone())


def small_train_check(torch, dev, name="qwen3-8b"):
    """A small model, its ``h100-sxm`` plan (fp32 moments and master
    weights at this size), 4 steps of 256 x 4 tokens (an SSM's: 1024 x 2,
    four of the plan's 256-row chunks, so that a gradient lost between
    chunks shows) on the card (the kernels) against the CPU (the plain
    versions) from the same init and batches, each step's loss within
    :data:`SMALL_TRAIN_TOL` and its grad norm within
    :data:`SMALL_GRAD_NORM_TOL`, and the step-0 gradient of every leaf
    within the arch's :data:`TRAIN_GRAD_TOL` (rms-relative; at this size
    an SSM's scan carries too little of the loss for the first two to see
    its backward); a run with a planted backward fault
    (:func:`backward_faults`) must fail one of the three;
    then a run saved through ``Checkpointer`` at step 2 and resumed by a
    fresh trainer's ``resume()``, whose steps 3-4 and final state must
    equal the uninterrupted card run's bitwise.  The model: the reduced
    qwen3 at head_dim 128 (as :func:`small_model_check` builds it), or
    reduced mamba2 (2 layers, 8 SSD heads of 32, state 16)."""
    import shutil as _shutil

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core import specialize
    from repro_torch.core.passes.lowering import build_run_cfg
    from repro_torch.data import SyntheticSource, to_device
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.train import Trainer, TrainerConfig

    full = get_arch(name)
    arch = full.reduced()
    if arch.has_attention:           # the published head_dim (M-RoPE's
        arch = dataclasses.replace(  # sections cover its half)
            arch, head_dim=full.hd, mrope_sections=full.mrope_sections)
    shape = ShapeConfig("small_train", "train",
                        *((1024, 2) if arch.has_ssm else (256, 4)))
    plan = specialize(arch, shape, mesh_shape=(1, 1), target="h100-sxm",
                      cache=False)
    check(plan.opt["master_weights"], f"small train plan: {plan.opt}")
    opt = adamw.OptConfig.from_plan(plan, warmup_steps=1, total_steps=8)
    root = ROOT / "build" / "ckpt_small"
    _shutil.rmtree(root, ignore_errors=True)

    def trainer(device, run, **kw):
        cfg = TrainerConfig(n_steps=4, ckpt_every=0, log_every=100,
                            seed=SEED, ckpt_dir=str(root / run))
        return Trainer(plan, None, dataclasses.replace(cfg, **kw), opt,
                       arch=arch, shape=shape, device=device)

    cpu = trainer("cpu", "cpu")
    init = cpu.init_state(SEED)
    cfg = build_run_cfg(plan, arch)
    batch0 = SyntheticSource(arch, shape, seed=SEED).batch_at(0)

    def step0_grads(device):
        """Every leaf's gradient of the step-0 loss on ``device``."""
        params = _map_tree(init["params"], lambda t: t.detach().to(
            device).requires_grad_(t.is_floating_point()))
        loss, _ = lm.train_loss(arch, params, to_device(device)(batch0), cfg)
        names = [n for n, _ in _named(params)]
        grads = torch.autograd.grad(loss, [t for _, t in _named(params)],
                                    allow_unused=True,
                                    materialize_grads=True)
        return {n: g.float().cpu() for n, g in zip(names, grads)}

    g_cpu = step0_grads("cpu")
    g_dev = step0_grads(dev)
    cpu.fit(_clone(torch, init))
    whole = trainer(dev, "whole")
    end, _ = whole.fit(_clone(torch, init))
    first = trainer(dev, "run", n_steps=2, ckpt_every=2)
    first.fit(_clone(torch, init))
    again = trainer(dev, "run")
    state, step = again.resume()
    state, _ = again.fit(state, start_step=step)
    fault = backward_faults(arch)[0]
    with planted_bwd(fault):
        faulty = trainer(dev, "faulty")
        faulty.fit(_clone(torch, init))
        g_bad = step0_grads(dev)
    torch.cuda.synchronize()
    gtol = TRAIN_GRAD_TOL[name]
    g_rel = {n: _rms_rel(torch, g_dev[n], g) for n, g in g_cpu.items()}
    g_ctl = max(_rms_rel(torch, g_bad[n], g) for n, g in g_cpu.items())
    l_cpu = [h["loss"] for h in cpu.history]
    l_dev = [h["loss"] for h in whole.history]
    l_res = [h["loss"] for h in again.history]
    l_bad = [h["loss"] for h in faulty.history]
    worst = max(abs(a - b) for a, b in zip(l_dev, l_cpu))
    ctl = max(abs(a - b) for a, b in zip(l_bad, l_cpu))
    gn_cpu = [h["grad_norm"] for h in cpu.history]
    gn_rel = max(abs(h["grad_norm"] - g) / g
                 for h, g in zip(whole.history, gn_cpu))
    gn_ctl = max(abs(h["grad_norm"] - g) / g
                 for h, g in zip(faulty.history, gn_cpu))
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(_named(state),
                                                           _named(end)))
    log(f"check small train {name} (4 steps of {shape.seq_len} x "
        f"{shape.global_batch}, master weights) "
        f"card losses {[round(x, 6) for x in l_dev]} vs cpu "
        f"{[round(x, 6) for x in l_cpu]}: worst |diff| {worst:.3e} (tol "
        f"{SMALL_TRAIN_TOL}; {fault} backward control {ctl:.3e}); grad "
        f"norm rel card vs cpu {gn_rel:.3e} (tol {SMALL_GRAD_NORM_TOL}; "
        f"{fault} backward control {gn_ctl:.3e}); step-0 gradients card vs "
        f"cpu worst rms_rel {max(g_rel.values()):.3e} "
        f"({max(g_rel, key=g_rel.get)}; tol {gtol}; {fault} "
        f"backward control {g_ctl:.3e}); resumed "
        f"at step {step}: steps 3-4 {l_res} vs {l_dev[2:]}, final state "
        f"bitwise equal {same} [{CARD}]")
    check(worst <= SMALL_TRAIN_TOL and gn_rel <= SMALL_GRAD_NORM_TOL
          and max(g_rel.values()) <= gtol,
          f"small train {name}: card vs cpu loss {worst}, grad norm rel "
          f"{gn_rel}, step-0 gradients {max(g_rel.values())}")
    check(ctl > SMALL_TRAIN_TOL or gn_ctl > SMALL_GRAD_NORM_TOL
          or g_ctl > gtol,
          f"small train {name}: the {fault} backward control passed (loss "
          f"{ctl}, grad norm rel {gn_ctl}, step-0 gradients {g_ctl})")
    check(step == 2 and l_res == l_dev[2:] and same,
          f"small train {name}: the resumed run differs from the "
          "uninterrupted one")
    _shutil.rmtree(root, ignore_errors=True)
    return dict(losses_card=l_dev, losses_cpu=l_cpu, worst=worst,
                fault=fault, fault_control=ctl, grad_norm_rel=gn_rel,
                grad_norm_control=gn_ctl, step0_grad_rms_rel=g_rel,
                step0_grad_control=g_ctl, resumed_losses=l_res,
                bitwise=same)


# ---------------------------------------------------------------------
# phase 8: the plan-driven matmul path
# ---------------------------------------------------------------------

def matmul_shapes(qwen, mamba):
    """``(name, arch, M, K, N, dtype)`` of the phase's GEMMs, from the
    two models' configs: qwen3-8b's fused gate/up and FFN down on a
    2048-token prefill and its logits on one 8-slot decode tick;
    mamba2-2.7b's in_proj on a ragged 1000-token prefill and its fp32
    ``y @ out_proj`` (JAX's promotion, which the port keeps)."""
    in_proj = (2 * mamba.d_inner + 2 * mamba.ssm_n_groups * mamba.ssm_state
               + mamba.ssm_heads)
    return (
        ("qwen3-8b gate/up, 2048-token prefill", "qwen3-8b", 2048,
         qwen.d_model, 2 * qwen.d_ff, "bfloat16"),
        ("qwen3-8b FFN down, 2048-token prefill", "qwen3-8b", 2048,
         qwen.d_ff, qwen.d_model, "bfloat16"),
        ("qwen3-8b logits, one 8-slot decode tick", "qwen3-8b", 8,
         qwen.d_model, qwen.vocab_size, "bfloat16"),
        ("mamba2-2.7b in_proj, 1000-token prefill", "mamba2-2.7b", 1000,
         mamba.d_model, in_proj, "bfloat16"),
        ("mamba2-2.7b y @ out_proj in fp32, 1000 tokens", "mamba2-2.7b",
         1000, mamba.d_inner, mamba.d_model, "float32"))


def matmul_path_phase(torch, dev, plans, shapes):
    """The plan-driven path of the tiled matmul: the serve phases'
    plans, already in the store at :data:`PLAN_DIR`, are reloaded by
    hash prefix and shown with the plan-store CLI; ``ops.matmul`` then
    runs each shape once on its model's plan's tiles (the launches this
    phase reports), held against the plain version row by row and by
    the JAX test's max/max error.  Two planted faults must fail the row
    check at every shape: the last K tile dropped (the kernel run on
    ``a[:, :K-bk]``, ``b[:K-bk]``) and the first two N tiles swapped (on
    ``b`` with those column blocks exchanged).  Then each shape is timed
    beside its bound, the plain version and ``torch.matmul``."""
    from repro_torch.core.planstore import PlanStore
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import tiled_matmul as mm
    from repro_torch.launch import plan as plan_cli

    store = PlanStore(PLAN_DIR)              # a fresh store: reads the disk
    d = str(PLAN_DIR)
    check(plan_cli.main(["--plan-dir", d, "list"]) == 0, "plan list failed")
    tiles = {}
    for name, plan in plans.items():
        h = plan.content_hash()
        hits = [f.stem for f in PLAN_DIR.glob(f"{h[:12]}*.json")]
        check(hits == [h], f"plan {name}: {h[:12]} not stored once: {hits}")
        log(f"matmul path: plan {name}: python -m repro_torch.launch.plan "
            f"show {h[:12]} --log")
        check(plan_cli.main(["--plan-dir", d, "show", h[:12], "--log"]) == 0,
              f"plan show {h[:12]} failed")
        again = store.load(hits[0])
        check(again is not None and again.content_hash() == h,
              f"plan {name}: reload by prefix {h[:12]} failed")
        t = ops.matmul_tiles(again)
        bp = again.partitions["tiled_matmul"]
        check(t in mm.KERNEL_TILES and bp.vmem_bytes == mm.smem_bytes(*t),
              f"plan {name}: tile {t}, {bp.vmem_bytes} B, is not a kernel "
              "tile")
        tiles[again.arch] = t
    check(plan_cli.main(["--plan-dir", d, "verify"]) == 0,
          "plan verify failed")

    g = torch.Generator(dev).manual_seed(SEED + 3)
    ins = [tuple(torch.randn(s, generator=g, device=dev).to(getattr(
        torch, dt)) for s in ((M, K), (K, N)))
        for _, _, M, K, N, dt in shapes]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    outs = [ops.matmul(a, b, tiles=tiles[arch])
            for (_, arch, *_), (a, b) in zip(shapes, ins)]
    torch.cuda.synchronize()
    launches = ops.launch_counts()["tiled_matmul"]
    check(launches == len(shapes), f"matmul path: {launches} launches for "
          f"{len(shapes)} calls")

    per = []
    for (name, arch, M, K, N, dt), (a, b), out in zip(shapes, ins, outs):
        t = tiles[arch]
        bk, bn = t[1], t[2]
        tol = MM_TOL[dt]
        want = mm.tiled_matmul_plain(a, b)
        check(out.dtype == a.dtype and tuple(out.shape) == (M, N),
              f"matmul {name}: {out.dtype} {tuple(out.shape)}")
        err, rel = row_err(torch, out, want)
        maxrel = float((out.float() - want.float()).abs().max()
                       / want.float().abs().max())
        log(f"check matmul {name} ({M}, {K}, {N}) {dt} tiles={t}: "
            f"max_abs_err={err:.3e} worst row rel={rel:.3e} max/max "
            f"rel={maxrel:.3e} (tol {tol}) [{CARD}]")
        check(rel <= tol and maxrel <= tol, f"matmul {name}: row rel {rel}, "
              f"max/max {maxrel} > {tol}")
        extra = {}
        if dt == "float32":     # against fp64, beside the TF32-on control
            want64 = a.double() @ b.double()
            r64 = rows64(torch, out, want64)
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                tf32 = rows64(torch, torch.matmul(a, b), want64)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            del want64
            log(f"check matmul {name}: against fp64 worst row rel "
                f"{r64[0]:.3e} max/max {r64[1]:.3e}; control torch.matmul "
                f"with TF32 on {tf32[0]:.3e} / {tf32[1]:.3e} (must exceed "
                f"tol {tol}) [{CARD}]")
            check(max(r64) <= tol, f"matmul {name}: {r64} against fp64 > "
                  f"{tol}")
            check(max(tf32) > tol, f"matmul {name}: the TF32-on control "
                  f"passed the check ({tf32} <= {tol})")
            extra = dict(fp64_rel_err=max(r64), tf32_control_rel_err=max(tf32))
        idx = torch.arange(N, device=dev)
        idx[:2 * bn] = idx[:2 * bn].roll(bn)
        ctl = []
        for fault, got in (
                ("last K tile dropped", lambda: ops.matmul(
                    a[:, :K - bk].contiguous(), b[:K - bk].contiguous(),
                    tiles=t)),
                ("two N tiles swapped", lambda: ops.matmul(
                    a, b[:, idx].contiguous(), tiles=t))):
            _, frel = row_err(torch, got(), want)
            log(f"control matmul {name} {fault}: worst row rel={frel:.3e} "
                f"(must exceed tol {tol}) [{CARD}]")
            check(frel > tol, f"control matmul {name} {fault} passed the "
                  f"check ({frel} <= {tol})")
            ctl.append(frel)
        del want
        med, rounds = in_turns(torch, {
            "kernel": lambda: mm.tiled_matmul(a, b, tiles=t),
            "library": lambda: torch.matmul(a, b)})
        ms, lib = med["kernel"], med["library"]
        plain = time_ms(torch, lambda: mm.tiled_matmul_plain(a, b), iters=5)
        e = a.element_size()
        if dt == "float32":
            b_ms, b_by, extra["ffma_bound_ms"] = mm_fp32_bound(M, K, N)
        else:
            b_ms, b_by = work_bound(mm.work(M, K, N, e))
        log(f"timing tiled_matmul {name} ({M}, {K}, {N}) {dt} tiles={t}: "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms, torch.matmul "
            f"{lib:.4f} ms (medians of {TURNS} turns: kernel "
            f"{fmt(rounds['kernel'])}, torch.matmul {fmt(rounds['library'])}"
            f"), {2 * M * K * N / ms / 1e9:.1f} TFLOP/s, bound {b_ms:.4f} ms "
            f"({b_by})" + (f", FFMA bound {extra['ffma_bound_ms']:.4f} ms"
                           if "ffma_bound_ms" in extra else "") + f" [{CARD}]")
        per.append(dict(name=name, M=M, K=K, N=N, dtype=dt, tiles=list(t),
                        ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                        bound_by=b_by, kernel_turns_ms=rounds["kernel"],
                        library_turns_ms=rounds["library"],
                        max_abs_err=err, row_rel_err=rel,
                        max_rel_err=maxrel, tolerance=tol,
                        control_row_rel_err=min(ctl), **extra))
        if dt == "bfloat16" and "map_encode_us" not in per[0]:
            enc = build.library("tiled_matmul").tiled_matmul_map_encode_us(
                a.data_ptr(), b.data_ptr(), M, K, N, t[0], t[1], 1000)
            check(enc > 0, f"tiled_matmul: tensor-map encoder failed ({enc})")
            log(f"host tiled_matmul: {enc:.3f} us per launch to encode its 2 "
                f"tensor maps (mean of 1000) [{CARD}]")
            per[0]["map_encode_us"] = enc
    ops.reset_launch_counts()       # comparison launches do not count
    by = {}
    for p in per:
        by[p["bound_by"]] = by.get(p["bound_by"], 0.0) + p["bound_ms"]
    return launches, dict(
        route="cuda", source="src/repro_torch/kernels/csrc/tiled_matmul.cu",
        replaces="src/repro/kernels/tiled_matmul.py:38",
        max_abs_err=max(p["max_abs_err"] for p in per),
        row_rel_err=max(p["row_rel_err"] for p in per),
        control_row_rel_err=min(p["control_row_rel_err"] for p in per),
        tolerance=MM_TOL, ms=sum(p["ms"] for p in per),
        plain_ms=sum(p["plain_ms"] for p in per),
        library_ms=sum(p["library_ms"] for p in per),
        bound_ms=sum(by.values()), bound_by=max(by, key=by.get),
        map_encode_us=per[0]["map_encode_us"],
        shape="sums over the matmul phase's five calls (each in 'shapes'); "
              f"kernel and library: medians of {TURNS} turns",
        shapes=per, library_call="torch.matmul (cuBLAS), TF32 off",
        launched_by="the plan-driven matmul phase; no serving path "
                    "launches it")


# ---------------------------------------------------------------------

# ---------------------------------------------------------------------
# multi-GPU serving: K8 (the decode kernels' per-shard partial) and two
# ranks on the card
# ---------------------------------------------------------------------

#: (label, query heads, kv heads, head_dim, window) of the K8 checks:
#: qwen3-8b, deepseek-coder-33b's G = 7, hymba-1.5b through its window
MESH_CASES = (("qwen3", H, K, D, 0), ("g7", 56, 8, 128, 0),
              ("hymba", H5, K5, D64, 1024))
MESH_SPLITS = (2, 4, 8)
MESH_B, MESH_S, MESH_BL, MESH_N = 8, 2048, 256, 64
#: what ``scripts/gloo_cuda_probe.py`` found gloo to carry for CUDA
#: tensors, two ranks on one H100 80GB HBM3 under torch 2.11.0+cu128:
#: every collective it tried but ``batch_isend_irecv`` (a transport
#: error, "Connection closed by peer"), so the ring and bidir combines
#: (neighbour sends) wait for a machine with more than one card, where
#: NCCL carries them (NCCL refuses two ranks on one card: "invalid
#: usage").  The engine's tensor-parallel step needs all_reduce and
#: all_gather; the flat combine all_reduce only
GLOO_CUDA = {"all_reduce": True, "broadcast": True, "all_gather": True,
             "all_gather_into_tensor": True, "all_to_all_single": True,
             "batch_isend_irecv": False, "device_mesh": True}
TWO_RANK_ENGINE = GLOO_CUDA["all_reduce"] and GLOO_CUDA["all_gather"] \
    and GLOO_CUDA["device_mesh"]


def fold(torch, parts, ring: bool, drop: int = -1):
    """The ranks' combine of partial ``(m, l, acc)`` terms, in one
    process: ``flat`` as the all-reduces compute it (a max, then sums),
    ``ring`` as the gathered buffer is folded, in source order; ``drop``
    leaves a shard out (the planted fault).  Returns ``acc / l``."""
    parts = [p for i, p in enumerate(parts) if i != drop]
    ms = torch.stack([p[0] for p in parts])
    if ring:
        m_glob = ms[0]
        for m in ms[1:]:
            m_glob = torch.maximum(m_glob, m)
    else:
        m_glob = ms.amax(0)
    coef = torch.where(ms == float("-inf"), 0.0, torch.exp(ms - m_glob))
    lw = [p[1] * c for p, c in zip(parts, coef)]
    aw = [p[2] * c[..., None] for p, c in zip(parts, coef)]
    if ring:
        lg, ag = lw[0], aw[0]
        for a, b in zip(lw[1:], aw[1:]):
            lg, ag = lg + a, ag + b
    else:
        lg, ag = torch.stack(lw).sum(0), torch.stack(aw).sum(0)
    return ag / lg.clamp_min(1e-30)[..., None]


def partial_err(torch, got, want):
    """K8 against the plain partial on one shard: the live pattern (the
    kernel's empty partial is ``m = -inf``, the plain one's ``NEG_INF``)
    exactly, ``m`` where live, and ``acc / l`` per (slot, head)
    rms-relative where live."""
    m, l, acc = got
    pm, pl, pa = want
    live = pm > -1e29
    check(torch.equal(live, m > float("-inf")),
          "K8: the live (slot, head) pattern differs from the plain one")
    if not bool(live.any()):
        return 0.0, 0.0
    dm = float((m - pm)[live].abs().max())
    ctx = (acc / l.clamp_min(1e-30)[..., None])[live]
    pctx = (pa / pl.clamp_min(1e-30)[..., None])[live]
    rel = ((ctx - pctx).pow(2).mean(-1).sqrt()
           / pctx.pow(2).mean(-1).sqrt().clamp_min(1e-6))
    return dm, float(rel.max())


def mesh_kernel_phase(torch, dev):
    """K8 at full width: each case's slice split into 2, 4 and 8 shards,
    every shard's partial held against the plain partial, the shards'
    partials folded flat and ring held against the unsharded decode
    kernel, beside three planted faults (a shard left out of the fold,
    ``kv_start`` / ``block_start`` off by one block, an unowned block
    counted as owned), and each shard's launch timed in turns with the
    unsharded kernel beside the byte bound of its rows."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ops
    g = torch.Generator(dev).manual_seed(SEED + 27)
    tol = TOL["decode_attention"]
    B, S, bl, N = MESH_B, MESH_S, MESH_BL, MESH_N
    nb = S // bl
    res = {"decode_partial": {}, "paged_decode_partial": {}}
    worst = {"decode_partial": [0.0, 0.0, 0.0],
             "paged_decode_partial": [0.0, 0.0, 0.0]}
    timing = {}
    for label, Hq, Kv, Dh, W in MESH_CASES:
        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev).to(
                torch.bfloat16)
        q = rnd(B, Hq, Dh)
        k, v = rnd(B, S, Kv, Dh), rnd(B, S, Kv, Dh)
        kp, vp = rnd(N, bl, Kv, Dh), rnd(N, bl, Kv, Dh)
        lens = torch.randint(1, S + 1, (B,), generator=g, device=dev,
                             dtype=torch.int32)
        lens[0], lens[1] = 1, S
        pos = (lens - 1).contiguous()
        tbl = torch.randperm(N, generator=g, device=dev).reshape(
            B, nb).to(torch.int32)
        # the first block of every split's second shard is live, inside
        # any window (slot 1 holds all 2048 rows; its last columns), so
        # an unowned block counted as owned shows in the fold
        for j, n in enumerate(MESH_SPLITS):
            r, col = (tbl == N // n).nonzero()[0].tolist()
            tbl[r, col], tbl[1, nb - 1 - j] = tbl[1, nb - 1 - j].clone(), \
                N // n
        used = (torch.arange(nb, device=dev)[None] * bl < lens[:, None])
        tbl = torch.where(used, tbl, -1).contiguous()
        want_d = dec.decode_attention(q, k, v, cache_len=lens, window=W)
        want_p = dec.paged_decode_attention(q, kp, vp, tbl, cache_len=lens,
                                            window=W)
        for n in MESH_SPLITS:
            Sl, Nl = S // n, N // n
            dense = [(k[:, i * Sl:(i + 1) * Sl].contiguous(),
                      v[:, i * Sl:(i + 1) * Sl].contiguous(), i * Sl)
                     for i in range(n)]
            paged = [(kp[i * Nl:(i + 1) * Nl], vp[i * Nl:(i + 1) * Nl],
                      i * Nl) for i in range(n)]
            for name, shards, want in (("decode_partial", dense, want_d),
                                       ("paged_decode_partial", paged,
                                        want_p)):
                def run(ks, vs, start):
                    if name == "decode_partial":
                        return dec.decode_partial(q, ks, vs, kv_start=start,
                                                  pos=pos, window=W)
                    return dec.paged_decode_partial(
                        q, ks, vs, tbl, block_start=start, pos=pos,
                        window=W)

                def plain(ks, vs, start):
                    if name == "decode_partial":
                        return dec.decode_partial_plain(
                            q, ks, vs, kv_start=start, pos=pos, window=W)
                    return dec.paged_decode_partial_plain(
                        q, ks, vs, tbl, block_start=start, pos=pos,
                        window=W)

                parts = []
                for ks, vs, start in shards:
                    got = run(ks, vs, start)
                    dm, rel = partial_err(torch, got, plain(ks, vs, start))
                    check(rel <= tol, f"{name} {label} {n} shards, shard "
                          f"at {start}: acc/l row rel {rel} > {tol}")
                    worst[name][0] = max(worst[name][0], dm)
                    worst[name][1] = max(worst[name][1], rel)
                    parts.append(got)
                for ring in (False, True):
                    e, rel = row_err(torch, fold(torch, parts, ring).to(
                        torch.bfloat16), want)
                    check(rel <= tol, f"{name} {label} {n} shards "
                          f"{'ring' if ring else 'flat'} fold: row rel "
                          f"{rel} > {tol}")
                    worst[name][2] = max(worst[name][2], rel)
                # planted faults, each must fail the fold's check
                ks, vs, start = shards[1]
                step = bl if name == "decode_partial" else 1
                off = list(parts)
                off[1] = run(ks, vs, start + step)
                c1 = control("decode_attention", f"{name} {label} {n} "
                             "shards: a shard left out", torch,
                             fold(torch, parts, False, drop=1).to(
                                 torch.bfloat16), want)
                c2 = control("decode_attention", f"{name} {label} {n} "
                             "shards: start off by one block", torch,
                             fold(torch, off, False).to(torch.bfloat16),
                             want)
                ctl = [c1, c2]
                if name == "paged_decode_partial":
                    wide = list(parts)
                    wide[0] = run(kp[:Nl + 1], vp[:Nl + 1], 0)
                    ctl.append(control(
                        "decode_attention", f"{name} {label} {n} shards: "
                        "an unowned block counted as owned", torch,
                        fold(torch, wide, False).to(torch.bfloat16), want))
                res[name].setdefault("controls", []).append(min(ctl))
                # timed at qwen3-8b's widths: each shard in turns with
                # the unsharded kernel, beside the bytes of its live rows
                if label != "qwen3":
                    continue
                lo = (lens - W).clamp_min(0) if W else torch.zeros_like(lens)
                fns = {"unsharded": (
                    (lambda: dec.decode_attention(q, k, v, cache_len=lens,
                                                  window=W))
                    if name == "decode_partial" else
                    (lambda: dec.paged_decode_attention(
                        q, kp, vp, tbl, cache_len=lens, window=W)))}
                rows = []
                for i, (ks, vs, start) in enumerate(shards):
                    fns[f"shard{i}"] = functools.partial(run, ks, vs, start)
                    if name == "decode_partial":
                        r0 = torch.clamp(lo - start, 0, Sl)
                        r1 = torch.clamp(lens - start, 0, Sl)
                        rows.append(int((r1 - r0).sum()))
                    else:
                        own = (tbl >= start) & (tbl < start + Nl)
                        col = torch.arange(nb, device=dev)[None] * bl
                        live = (torch.clamp(lens[:, None] - col, 0, bl)
                                * own).sum()
                        rows.append(int(live))
                med, rounds = in_turns(torch, fns, graph_ms)
                plain_ms = [None] * n
                if n == 2:              # the plain partial on each shard
                    pm, _ = in_turns(torch, {
                        i: functools.partial(plain, *sh)
                        for i, sh in enumerate(shards)})
                    plain_ms = [pm[i] for i in range(n)]
                bounds = [work_bound(dec.partial_work(B, Hq, Kv, Dh, r),
                                     PEAK_FP32) for r in rows]
                timing[(name, n)] = {
                    "unsharded_ms": med["unsharded"],
                    "shards_ms": [med[f"shard{i}"] for i in range(n)],
                    "shard_rows": rows,
                    "bound_ms": [b for b, _ in bounds],
                    "bound_by": bounds[0][1],
                    "plain_ms": plain_ms}
                log(f"timing {name} qwen3 {n} shards: unsharded "
                    f"{med['unsharded']:.4f} ms, shards "
                    f"{fmt([med[f'shard{i}'] for i in range(n)])} ms, "
                    f"bounds {fmt([b for b, _ in bounds])} ms (rows "
                    f"{rows}) in turns of {TURNS} [{CARD}]")
        log(f"kernel K8 {label} ({Hq}/{Kv}x{Dh}, window {W}): shards "
            f"{MESH_SPLITS} dense and paged, partials and folds held "
            f"(tol {tol}) [{CARD}]")
    out = {}
    for name, src_line in (("decode_partial", 156),
                           ("paged_decode_partial", 304)):
        t2 = timing[(name, 2)]
        i = max(range(2), key=lambda j: t2["shards_ms"][j])
        out[name] = dict(
            route="cuda",
            source="src/repro_torch/kernels/csrc/decode_attention.cu",
            replaces=f"src/repro/dist/flash_decode.py:{src_line}",
            max_abs_err=worst[name][0], row_rel_err=worst[name][1],
            fold_row_rel_err=worst[name][2], tolerance=tol,
            control_row_rel_err=min(res[name]["controls"]),
            ms=t2["shards_ms"][i], bound_ms=t2["bound_ms"][i],
            bound_by=t2["bound_by"], plain_ms=t2["plain_ms"][i],
            library_ms=None,
            shards_ms={str(n): timing[(name, n)] for n in MESH_SPLITS},
            shape=f"B={B} {'S=' + str(S) if name == 'decode_partial' else f'{N} blocks of {bl}'} "
                  f"H={H} K={K} D={D}, the slowest of 2 shards",
            library_call="none: the reference's partial is jnp code in a "
                         "shard_map")
    for name in out:
        r = out[name]
        log(f"timing {name}: kernel {r['ms']:.4f} ms a shard of 2, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}) [{CARD}]")
    ops.reset_launch_counts()       # comparison launches do not count
    return out


def _two_rank(rank: int, tmp: str, src: str, engine: bool) -> None:
    """One of the two ranks on ``cuda:0`` over gloo: the sharded flash
    decode (flat combine) at full width against the unsharded kernel,
    then, where :data:`TWO_RANK_ENGINE`, the (1, 2) tensor-parallel
    engine on full-width qwen3-8b."""
    import datetime
    import os
    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import flash_decode as fd
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ops
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    out = {}
    try:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                rank=rank, world_size=2,
                                timeout=datetime.timedelta(seconds=300))
        mesh = init_device_mesh("cuda", (1, 2),
                                mesh_dim_names=("data", "model"))
        g = torch.Generator(dev).manual_seed(SEED + 2)
        B, S, bl, N = MESH_B, MESH_S, MESH_BL, MESH_N

        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev).to(
                torch.bfloat16)
        q, kn, vn = rnd(B, 1, H, D), rnd(B, 1, K, D), rnd(B, 1, K, D)
        k, v = rnd(B, S, K, D), rnd(B, S, K, D)
        kp, vp = rnd(N, bl, K, D), rnd(N, bl, K, D)
        lens = torch.randint(1, S, (B,), generator=g, device=dev,
                             dtype=torch.int32)
        pos = lens.clone()                        # the appended row
        tbl = torch.randperm(N, generator=g, device=dev).reshape(
            B, S // bl).to(torch.int32)
        # rank 1's first block is live (slot 1's first column), so that a
        # rank 0 piece one block too wide counts it twice
        r_, c_ = (tbl == N // 2).nonzero()[0].tolist()
        tbl[r_, c_], tbl[1, 0] = tbl[1, 0].clone(), N // 2
        used = torch.arange(S // bl, device=dev)[None] * bl <= pos[:, None]
        tbl = torch.where(used, tbl, -1).contiguous()
        # the unsharded kernels over the appended whole cache
        kw, vw = k.clone(), v.clone()
        kw[torch.arange(B), pos.long()] = kn[:, 0]
        vw[torch.arange(B), pos.long()] = vn[:, 0]
        want_d = dec.decode_attention(q[:, 0], kw, vw, cache_len=pos + 1)
        kpw, vpw = kp.clone(), vp.clone()
        from repro_torch.models.lm import append_kv_paged
        append_kv_paged(kpw, kn, pos, tbl)
        append_kv_paged(vpw, vn, pos, tbl)
        want_p = dec.paged_decode_attention(q[:, 0], kpw, vpw, tbl,
                                            cache_len=pos + 1)
        m = mesh.get_local_rank("model")
        kl = k[:, m * S // 2:(m + 1) * S // 2].contiguous()
        vl = v[:, m * S // 2:(m + 1) * S // 2].contiguous()
        kpl = kp[m * N // 2:(m + 1) * N // 2].contiguous()
        vpl = vp[m * N // 2:(m + 1) * N // 2].contiguous()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        ctx_d, kl, vl = fd.flash_decode(q, kn, vn, kl, vl, pos, 0,
                                        mesh=mesh, combine="flat",
                                        seq_len=S, batch=B)
        ctx_p, kpl, vpl = fd.flash_decode_paged(q, kn, vn, kpl, vpl, tbl,
                                                pos, 0, mesh=mesh,
                                                combine="flat", n_blocks=N,
                                                batch=B)
        torch.cuda.synchronize()
        out["decode_launches"] = ops.launch_counts()

        def row_rel(got, want):
            e = (got[:, 0].float() - want.float())
            rel = (e.pow(2).mean(-1).sqrt()
                   / want.float().pow(2).mean(-1).sqrt().clamp_min(1e-6))
            return float(rel.max())
        for name, got, want in (("dense", ctx_d, want_d),
                                ("paged", ctx_p, want_p)):
            out[f"{name}_row_rel"] = row_rel(got, want)
        out["appended"] = bool(
            torch.equal(kl, kw[:, m * S // 2:(m + 1) * S // 2])
            and torch.equal(kpl, kpw[m * N // 2:(m + 1) * N // 2]))
        # the engine's own partials and combine (fd._partial_attend*,
        # fd._combine, fd._finish) over the appended pieces, exact and
        # with planted faults, each against the unsharded kernel
        grp = mesh.get_group("model")

        def folded(paged, drop=False, shift=0, wide=False):
            if paged:
                lo = m * N // 2
                hi = lo + N // 2 + (1 if wide and m == 0 else 0)
                part = fd._partial_attend_paged(
                    q, kpw[lo:hi], vpw[lo:hi], tbl, pos, 0,
                    start=lo + shift)
            else:
                part = fd._partial_attend(q, kl, vl, m * S // 2 + shift,
                                          pos, 0)
            mm, ll, aa = part
            if drop and m == 1:          # rank 1's partial left out
                mm = torch.full_like(mm, float("-inf"))
                ll, aa = torch.zeros_like(ll), torch.zeros_like(aa)
            return fd._finish(q, *fd._combine(mm, ll, aa, grp, 2, "flat"))
        out["engine_fold"] = {
            "dense": row_rel(folded(False), want_d),
            "paged": row_rel(folded(True), want_p),
            "dense, rank 1 left out": row_rel(folded(False, drop=True),
                                              want_d),
            "dense, kv_start off by a block": row_rel(
                folded(False, shift=bl), want_d),
            "paged, rank 1 left out": row_rel(folded(True, drop=True),
                                              want_p),
            "paged, block_start off by one": row_rel(
                folded(True, shift=1), want_p),
            "paged, an unowned block counted as owned": row_rel(
                folded(True, wide=True), want_p)}
        # the combine's time: one flat combine of qwen3-8b's decode terms
        ml = torch.randn(B, H, device=dev)
        for _ in range(3):
            fd._combine(ml, ml.abs(), torch.randn(B, H, D, device=dev),
                        mesh.get_group("model"), 2, "flat")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fd._combine(ml, ml.abs(), torch.randn(B, H, D, device=dev),
                        mesh.get_group("model"), 2, "flat")
        torch.cuda.synchronize()
        out["combine_host_ms"] = (time.perf_counter() - t0) / 20 * 1e3
        if engine:
            out.update(_two_rank_engine(torch, dev, mesh, tmp))
    except Exception as e:           # a failed rank fails the run
        import traceback
        out["error"] = traceback.format_exc()[-3000:]
    torch.save(out, os.path.join(tmp, f"r{rank}.pt"))
    if dist.is_initialized():
        dist.destroy_process_group()


TWO_RANK_REQUESTS, TWO_RANK_TOKENS = 8, 16


def _two_rank_prompts(arch):
    import numpy as np
    rng = np.random.default_rng(SEED + 3)
    return [rng.integers(0, arch.vocab_size, int(n)).astype(np.int32)
            for n in rng.integers(64, 1024, TWO_RANK_REQUESTS)]


def _two_rank_engine(torch, dev, mesh, tmp):
    """The (1, 2) tensor-parallel engine for full-width qwen3-8b: every
    rank builds only its pieces of the weights the seed gives
    (``param_pieces``, as the serve launcher does) and serves the same
    requests; the counts of its kernels' launches, its tokens and its
    peak memory come back."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core import specialize
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.sharded import param_pieces
    arch = get_arch("qwen3-8b")
    plan = specialize(arch, ShapeConfig("serve_h100", "decode", 2048, 8),
                      mesh_axes=("data", "model"), mesh_shape=(1, 2),
                      target="h100-sxm", cache=False)
    params = lm.init_params(arch, torch.Generator(dev).manual_seed(SEED),
                            *plan.padded_sizes(),
                            pieces=param_pieces(mesh, plan, arch))
    eng = _recording_engine(ServeEngine).from_plan(plan, params, arch=arch,
                                                   mesh=mesh)
    del params
    torch.cuda.empty_cache()
    held = sum(t.numel() * t.element_size() for t in _leaves(eng.params))
    for p in _two_rank_prompts(arch):
        eng.submit(p, max_new_tokens=TWO_RANK_TOKENS)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run_until_idle(max_ticks=4096)
    torch.cuda.synchronize()
    return {"engine_launches": ops.launch_counts(),
            "engine_first": eng.first,
            "engine_s": time.perf_counter() - t0,
            "engine_path": eng.decode_path, "engine_split": eng.cfg.kv_split,
            "engine_weight_bytes": held,
            "engine_cache_k": tuple(eng.cache["k"].shape),
            "engine_tokens": {r.rid: list(r.out_tokens) for r in done},
            "engine_peak": torch.cuda.max_memory_allocated()}


def two_rank_phase(torch, dev):
    """Two ranks on ``cuda:0`` over gloo (NCCL refuses two ranks on one
    card): the sharded flash decode with K8 on each rank against the
    unsharded kernel, and, as far as :data:`GLOO_CUDA` admits, the (1, 2)
    tensor-parallel engine on full-width qwen3-8b, its tokens against
    the one-rank engine's under the full-depth margin rule (equal up to
    the first step whose one-rank top-2 margin is within
    :data:`FULL_TOL`: a 36-layer bf16 path sums its partial products in
    another order).  A rank that fails fails the run."""
    import tempfile

    import torch.multiprocessing as mp
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core import specialize
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine
    res = {"gloo_cuda": GLOO_CUDA, "engine": TWO_RANK_ENGINE}
    one = None
    if TWO_RANK_ENGINE:
        arch = get_arch("qwen3-8b")
        shape = ShapeConfig("serve_h100", "decode", 2048, 8)
        plan = specialize(arch, shape, mesh_shape=(1, 1), target="h100-sxm",
                          plan_dir=PLAN_DIR)
        # the ranks' weights: the (1, 2) plan pads the vocab for its split
        # (152,064 rows), so both engines draw them at its padded sizes
        tp_plan = specialize(arch, shape, mesh_axes=("data", "model"),
                             mesh_shape=(1, 2), target="h100-sxm",
                             cache=False)
        params = lm.init_params(arch, torch.Generator(dev).manual_seed(SEED),
                                *tp_plan.padded_sizes())
        eng = _recording_engine(ServeEngine).from_plan(
            plan, params, kv_host_blocks=0, kv_prefix_reuse="off")
        for p in _two_rank_prompts(arch):
            eng.submit(p, max_new_tokens=TWO_RANK_TOKENS)
        done = eng.run_until_idle(max_ticks=4096)
        one = ({r.rid: list(r.out_tokens) for r in done}, eng.margins,
               eng.first)
        del eng, params
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_two_rank,
                             args=(r, tmp, str(SRC_IN_USE), TWO_RANK_ENGINE))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
            if p.is_alive():
                p.kill()
                p.join()
        ranks = []
        for r, p in enumerate(procs):
            path = Path(tmp) / f"r{r}.pt"
            check(path.exists(), f"two ranks: rank {r} left no result "
                  f"(exit {p.exitcode})")
            ranks.append(torch.load(path, weights_only=False))
    for r, out in enumerate(ranks):
        check("error" not in out, f"two ranks: rank {r} failed: "
              f"{out.get('error')}")
        for name in ("dense", "paged"):
            rel = out[f"{name}_row_rel"]
            log(f"two ranks: rank {r} flash_decode {name} (flat, K8 on "
                f"each rank) vs the unsharded kernel: worst row rel "
                f"{rel:.3e} (tol {TOL['decode_attention']}) [{CARD}]")
            check(rel <= TOL["decode_attention"],
                  f"two ranks: {name} row rel {rel}")
        check(out["appended"], f"two ranks: rank {r}'s append differs")
        for what, rel in out["engine_fold"].items():
            planted = "," in what
            log(f"two ranks: rank {r} fd._combine fold {what}: worst row "
                f"rel {rel:.3e} ({'a planted fault, must exceed' if planted else 'tol'} "
                f"{TOL['decode_attention']}) [{CARD}]")
            check((rel > TOL["decode_attention"]) if planted
                  else (rel <= TOL["decode_attention"]),
                  f"two ranks: fold {what}: row rel {rel}")
        c = out["decode_launches"]
        check(c["decode_partial"] == 1 and c["paged_decode_partial"] == 1,
              f"two ranks: rank {r}'s flash decode launched {c}")
    res["partial_launches"] = {
        k: sum(o["decode_launches"][k] for o in ranks)
        for k in ("decode_partial", "paged_decode_partial")}
    res["combine_host_ms"] = [o["combine_host_ms"] for o in ranks]
    res["engine_fold_row_rel"] = [o["engine_fold"] for o in ranks]
    if TWO_RANK_ENGINE:
        want, margins, first = one
        # the first token's logits, rms-relative, against the one-rank
        # engine's (the full-depth bound), and a wrong-request control
        rels = {rid: _rms_rel(torch, ranks[0]["engine_first"][rid], row)
                for rid, row in first.items()}
        wrong = _rms_rel(torch, ranks[0]["engine_first"][1], first[0])
        log(f"two ranks: first-token logits against the one-rank engine, "
            f"rms-relative by request {fmt(list(rels.values()))} (bound "
            f"{FULL_TOL}; another request's: {wrong:.3f}) [{CARD}]")
        check(max(rels.values()) <= FULL_TOL < wrong,
              f"two ranks: first logits {rels}, control {wrong}")
        res["first_logits_rms_rel"] = rels
        res["first_logits_wrong_request"] = wrong
        for r, out in enumerate(ranks):
            check(out["engine_tokens"] == ranks[0]["engine_tokens"],
                  "two ranks: the ranks' tokens differ")
            check(out["engine_split"] == "heads",
                  f"two ranks: split {out['engine_split']}")
            c = out["engine_launches"]
            check(c["flash_attention"] > 0
                  and c["paged_decode_attention"] > 0,
                  f"two ranks: the engine launched {c}")
        compared, splits = 0, []
        for rid, toks in want.items():
            got = ranks[0]["engine_tokens"][rid]
            check(len(got) == len(toks), "two ranks: token counts differ")
            for i, (a, b) in enumerate(zip(got, toks)):
                if a != b:
                    splits.append((rid, i, margins[rid][i]))
                    log(f"two ranks: request {rid} parts at token {i} "
                        f"({a} vs {b}), one-rank margin "
                        f"{margins[rid][i]:.4f} [{CARD}]")
                    check(margins[rid][i] <= FULL_TOL,
                          f"two ranks: request {rid} token {i}: {a} vs "
                          f"{b} at margin {margins[rid][i]}")
                    break
                compared += 1
        res.update(engine_tokens_compared=compared, engine_splits=splits,
                   engine_tokens=sum(len(t) for t in want.values()),
                   engine_launches=[o["engine_launches"] for o in ranks],
                   engine_s=[o["engine_s"] for o in ranks],
                   engine_path=ranks[0]["engine_path"],
                   engine_weight_bytes=[o["engine_weight_bytes"]
                                        for o in ranks],
                   engine_cache_k=ranks[0]["engine_cache_k"],
                   engine_peak=[o["engine_peak"] for o in ranks])
        log(f"two ranks: (1, 2) tensor-parallel qwen3-8b, "
            f"{TWO_RANK_REQUESTS} requests x {TWO_RANK_TOKENS} tokens in "
            f"{fmt(res['engine_s'])} s a rank, {compared} of "
            f"{res['engine_tokens']} tokens equal the one-rank engine's "
            f"before the first margin-rule split, weights "
            f"{res['engine_weight_bytes']} bytes a rank, peak allocated "
            f"{res['engine_peak']} bytes a rank [{CARD}]")
    log(f"two ranks: phase took {time.perf_counter() - t0:.1f} s [{CARD}]")
    return res



# ---------------------------------------------------------------------
# phase 24b: two-rank training on the one card
# ---------------------------------------------------------------------

MESH_TRAIN_SHAPE = ("mesh_train", "train", 2048, 2)
MESH_TRAIN_STEPS = 3
#: the share of the card each plan's per-rank step-peak estimate must
#: stay under (each rank may allocate 0.46 of it)
MESH_TRAIN_SHARE, MESH_TRAIN_FRACTION = 0.44, 0.46
#: a rank's measured peak allocated <= its estimate <= this x the peak
MESH_PEAK_SLACK = 1.15
#: mesh against one rank, the last layer's gradients row by row
#: (grad_row_err), and the losses relative to the one-rank run's: at
#: least this, and at least 4x the floor measured in the run (the one
#: rank's kernels against the plain attention on the same step-0 batch)
MESH_GRAD_TOL, MESH_LOSS_MIN = 0.05, 2e-4
MESH_GNORM_TOL = 0.05


def mesh_train_plans(torch):
    """Full-width qwen3-8b on :data:`MESH_TRAIN_SHAPE` at the largest
    depth <= 36 at which the ``h100-sxm`` (1, 2) plan's and the (2, 1)
    ``grad_compression="on"`` plan's (the wire lowered,
    ``grad_compress_lowered == 2``) per-rank step-peak estimates both
    stay under :data:`MESH_TRAIN_SHARE` of the card; the same (2, 1)
    plan specialized with ``"off"``."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core import specialize
    arch = get_arch("qwen3-8b")
    shape = ShapeConfig(*MESH_TRAIN_SHAPE)
    card = torch.cuda.get_device_properties(0).total_memory

    def plans(n):
        cut = dataclasses.replace(arch, n_layers=n)
        kw = dict(mesh_axes=("data", "model"), target="h100-sxm",
                  cache=False)
        return cut, {"tp": specialize(cut, shape, mesh_shape=(1, 2), **kw),
                     "on": specialize(cut, shape, mesh_shape=(2, 1),
                                      grad_compression="on", **kw),
                     "off": specialize(cut, shape, mesh_shape=(2, 1),
                                       grad_compression="off", **kw)}

    def fits(ps):
        return (max(ps[k].estimates["step_peak_bytes"] for k in ("tp", "on"))
                <= MESH_TRAIN_SHARE * card
                and ps["on"].estimates.get("grad_compress_lowered") == 2.0)
    lo, hi = 0, arch.n_layers            # fits(lo) by convention
    while lo < hi:                       # estimates grow with depth
        mid = (lo + hi + 1) // 2
        if fits(plans(mid)[1]):
            lo = mid
        else:
            hi = mid - 1
    check(lo > 0, "mesh train: no depth of qwen3-8b fits two ranks")
    cut, ps = plans(lo)
    return cut, shape, ps, card


def _layer_grads(torch, arch, params, batch, cfg, layout=None):
    """The loss of ``batch`` and the gradients of the last layer's
    leaves, whole (on a mesh gathered from the ranks' pieces), on the
    host in fp32."""
    from repro_torch.dist import fsdp
    from repro_torch.models import lm
    named = _named(params["blocks"])
    loss, _ = lm.train_loss(arch, params, batch, cfg)
    grads = torch.autograd.grad(loss, [t for _, t in named])
    out = {}
    for (n, _), g in zip(named, grads):
        g = g[-1]
        if layout is not None:
            spec = _named(layout.specs["blocks"])
            spec = dict(spec)[n][1:]
            g = fsdp.whole(g.contiguous(), spec, layout.mesh)
        out[n] = g.float().cpu()
    return float(loss.detach()), out


@contextlib.contextmanager
def copy_in_dropped():
    """The planted fault of phase 24b: ``tp.copy_in`` without its
    backward all-reduce (a replicated activation entering a split
    matrix keeps only the rank's share of its gradient)."""
    from repro_torch.models import tp
    keep = tp.copy_in
    tp.copy_in = lambda t, c: t
    try:
        yield
    finally:
        tp.copy_in = keep


def _mesh_batches(arch, shape):
    """The synthetic source's global batches of the fit's steps."""
    from repro_torch.data.pipeline import SyntheticSource
    src = SyntheticSource(arch, shape, seed=SEED)
    return [src.batch_at(t) for t in range(MESH_TRAIN_STEPS)]


def _on_dev(torch, batch, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _checksums(torch, params):
    """Two position-weighted sums of each bf16 leaf's 16-bit words
    (int64): equal leaves give equal sums."""
    out, step = {}, 1 << 24
    for n, t in _named(params):
        if t.dtype != torch.bfloat16:
            continue
        flat = t.detach().reshape(-1).view(torch.int16)
        a = b = 0
        for s0 in range(0, flat.numel(), step):
            w = flat[s0:s0 + step].long()
            i = torch.arange(s0, s0 + w.numel(), device=w.device)
            a += int(w.sum())
            b += int((w * (i % 65521 + 1)).sum())
        out[n] = (a, b)
    return out


def _mesh_fit(torch, dev, plan, arch, shape, mesh, record=None,
              steps=MESH_TRAIN_STEPS):
    """``Trainer(plan, mesh).fit`` for ``steps`` steps from the seed's
    weights: its losses and grad norms, the kernels' launches and the
    rank's peak allocated during the fit."""
    from repro_torch.kernels import ops
    from repro_torch.train.trainer import Trainer, TrainerConfig
    tr = Trainer(plan, mesh, TrainerConfig(
        n_steps=steps, ckpt_every=0, log_every=100, seed=SEED),
        arch=arch, shape=shape, device=dev)
    state = tr.init_state(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, _ = tr.fit(state)
    torch.cuda.synchronize()
    out = {"hist": [(h["loss"], h["grad_norm"]) for h in tr.history],
           "launches": ops.launch_counts(), "s": time.perf_counter() - t0,
           "peak": torch.cuda.max_memory_allocated(),
           "estimate": plan.estimates["step_peak_bytes"],
           "wire": tr.step_def.wire_dp, "ef": tr.step_def.ef}
    return tr, state, out


def _mesh_train_rank(rank: int, tmp: str, src: str, n_layers: int) -> None:
    """One of the two ranks of phase 24b on ``cuda:0`` over gloo: (a)
    the (1, 2) tensor-parallel plan (its last layer's gradients first,
    with the planted fault, then the fit), (b) the (2, 1) plan with the
    wire (one leaf's ``compressed_psum`` recorded; the replicas'
    checksums after the fit) and without it."""
    import datetime
    import os
    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import collectives
    torch.cuda.set_device(0)
    torch.cuda.set_per_process_memory_fraction(MESH_TRAIN_FRACTION, 0)
    dev = torch.device("cuda", 0)
    out = {}
    try:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                rank=rank, world_size=2,
                                timeout=datetime.timedelta(seconds=600))
        arch, shape, ps, _ = mesh_train_plans(torch)
        if arch.n_layers != n_layers:
            raise RuntimeError(f"the ranks' depth {arch.n_layers} is not "
                               f"the parent's {n_layers}")
        batches = _mesh_batches(arch, shape)
        # (a) the (1, 2) tensor-parallel plan
        mesh = init_device_mesh("cuda", (1, 2),
                                mesh_dim_names=("data", "model"))
        tr, state = _mesh_trainer(torch, dev, ps["tp"], arch, shape, mesh)
        b0 = _on_dev(torch, batches[0], dev)
        out["tp_grads"] = _layer_grads(torch, arch, state["params"], b0,
                                       tr.step_def.cfg, tr.step_def.layout)
        with copy_in_dropped():
            out["tp_grads_dropped"] = _layer_grads(
                torch, arch, state["params"], b0, tr.step_def.cfg,
                tr.step_def.layout)
        del tr, state
        torch.cuda.empty_cache()
        out["tp"] = _mesh_fit(torch, dev, ps["tp"], arch, shape, mesh)[2]
        torch.cuda.empty_cache()
        # (b) the (2, 1) plan with the wire, then without it
        mesh = init_device_mesh("cuda", (2, 1),
                                mesh_dim_names=("data", "model"))
        orig, calls = collectives.compressed_psum, []

        def recording(x, group=None):
            mean, err = orig(x, group)
            if not calls:
                calls.append(tuple(t.detach().cpu() for t in (x, mean, err)))
            return mean, err
        collectives.compressed_psum = recording
        try:
            tr, state, out["on"] = _mesh_fit(torch, dev, ps["on"], arch,
                                             shape, mesh)
        finally:
            collectives.compressed_psum = orig
        out["on_leaf"] = calls[0]
        out["on_checksums"] = _checksums(torch, state["params"])
        del tr, state
        torch.cuda.empty_cache()
        out["off"] = _mesh_fit(torch, dev, ps["off"], arch, shape, mesh)[2]
    except Exception:
        import traceback
        out["error"] = traceback.format_exc()[-4000:]
    torch.save(out, os.path.join(tmp, f"r{rank}.pt"))
    if dist.is_initialized():
        dist.destroy_process_group()


def _mesh_trainer(torch, dev, plan, arch, shape, mesh):
    """A trainer on ``mesh`` and its seed state, for the gradient check."""
    from repro_torch.train.trainer import Trainer, TrainerConfig
    tr = Trainer(plan, mesh, TrainerConfig(ckpt_every=0, seed=SEED),
                 arch=arch, shape=shape, device=dev)
    return tr, tr.init_state(SEED)


def _mesh_anchor(torch, dev, plan, arch, shape, batches, grads=True,
                 fit=True):
    """The one-rank run of ``plan`` on the card (the same cut, optimizer,
    remat and global batches): its fit, the last layer's gradients on
    the step-0 batch (with a wrong-target control) and its kernels' loss
    against the plain attention's (the loss floor); ``grads`` / ``fit``
    False leave those out."""
    tr, state = _mesh_trainer(torch, dev, plan, arch, shape, None)
    b0 = _on_dev(torch, batches[0], dev)
    cfg = tr.step_def.cfg
    out = {}
    if grads:
        out["grads"] = _layer_grads(torch, arch, state["params"], b0, cfg)
        wrong = dict(b0, targets=(b0["targets"] + 1) % arch.vocab_size)
        out["wrong_grads"] = _layer_grads(torch, arch, state["params"],
                                          wrong, cfg)
    from repro_torch.models import lm
    with torch.no_grad(), plain_kernels(True):
        out["plain_loss"] = float(lm.train_loss(arch, state["params"], b0,
                                                cfg)[0])
    del tr, state
    torch.cuda.empty_cache()
    if fit:
        out["fit"] = _mesh_fit(torch, dev, plan, arch, shape, None)[2]
        torch.cuda.empty_cache()
    return out


def mesh_train_phase(torch, dev):
    """Phase 24b: two ranks spawned on ``cuda:0`` over gloo, each held to
    0.46 of the card, train full-width qwen3-8b cut to the depth
    :func:`mesh_train_plans` finds: (a) the (1, 2) tensor-parallel plan,
    (b) the (2, 1) plan with the int8 + EF wire and the same plan with
    ``"off"``, :data:`MESH_TRAIN_STEPS` steps each on the same weights and
    global batches; then a one-rank run of each plan in this process.
    Checks: (a)'s losses and grad norms against the one-rank run, its
    last layer's gradients row by row with a wrong-target control and
    the planted ``copy_in`` fault; (b)'s step-0 losses equal bit for bit
    on and off, the wire's identity on one leaf, the replicas' bf16
    leaves equal; each rank's peak allocated <= its plan's estimate <=
    :data:`MESH_PEAK_SLACK` x that peak; the flash forward and backward
    launched once a layer a step on every rank.  A rank that fails
    fails the run."""
    import os
    import tempfile

    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    arch, shape, ps, card = mesh_train_plans(torch)
    L = arch.n_layers
    gib = 2 ** 30
    log("mesh train: qwen3-8b full width at depth %d (the largest <= 36 "
        "whose per-rank estimates fit %.2f of the card): (1, 2) %s %.3f "
        "GiB, (2, 1) on %s %.3f GiB (wire %s), (2, 1) off %.3f GiB [%s]" % (
            L, MESH_TRAIN_SHARE, ps["tp"].estimates["strategy"],
            ps["tp"].estimates["step_peak_bytes"] / gib,
            ps["on"].estimates["strategy"],
            ps["on"].estimates["step_peak_bytes"] / gib,
            ps["on"].estimates.get("grad_compress_lowered"),
            ps["off"].estimates["step_peak_bytes"] / gib, CARD))
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_mesh_train_rank,
                             args=(r, tmp, str(SRC_IN_USE), L))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=900)
            if p.is_alive():
                p.kill()
                p.join()
        ranks = []
        for r, p in enumerate(procs):
            path = Path(tmp) / f"r{r}.pt"
            check(path.exists(), f"mesh train: rank {r} left no result "
                  f"(exit {p.exitcode})")
            ranks.append(torch.load(path, weights_only=False))
    for r, out in enumerate(ranks):
        check("error" not in out, f"mesh train: rank {r} failed: "
              f"{out.get('error')}")
    t_ranks = time.perf_counter() - t0
    batches = _mesh_batches(arch, shape)
    anchors = {"tp": _mesh_anchor(torch, dev, ps["tp"], arch, shape,
                                  batches),
               "off": _mesh_anchor(torch, dev, ps["off"], arch, shape,
                                   batches)}
    res = {"n_layers": L, "card_bytes": card, "ranks_s": t_ranks,
           "estimates": {k: p.estimates["step_peak_bytes"]
                         for k, p in ps.items()},
           "strategy": {k: p.estimates["strategy"] for k, p in ps.items()}}
    # the loss floor: one rank's kernels against the plain attention
    fl = {k: abs(a["fit"]["hist"][0][0] - a["plain_loss"])
          / abs(a["plain_loss"]) for k, a in anchors.items()}
    loss_tol = max(MESH_LOSS_MIN, 4 * max(fl.values()))
    res["loss_floor"], res["loss_tol"] = fl, loss_tol
    log(f"mesh train: loss floor (one rank, kernels vs plain attention, "
        f"step 0) {fl}; losses held at {loss_tol:.3e} relative [{CARD}]")
    # (a)
    one = anchors["tp"]
    for r, out in enumerate(ranks):
        _mesh_track(f"(a) rank {r}", out["tp"], one["fit"], loss_tol)
    want = one["grads"][1]
    errs = {n: grad_row_err(torch, g, want[n])[1]
            for n, g in ranks[0]["tp_grads"][1].items()}
    wrong = {n: grad_row_err(torch, one["wrong_grads"][1][n], want[n])[1]
             for n in want}
    dropped = {n: grad_row_err(torch, g, want[n])[1]
               for n, g in ranks[0]["tp_grads_dropped"][1].items()}
    log(f"mesh train: (a) last layer's gradients (1, 2) against one rank, "
        f"worst row rel {max(errs.values()):.3e} (tol {MESH_GRAD_TOL}) "
        f"{ {n: round(v, 5) for n, v in errs.items()} }; wrong-target "
        f"control worst {max(wrong.values()):.3e}; copy_in without its "
        f"backward all-reduce worst {max(dropped.values()):.3e} "
        f"{ {n: round(v, 5) for n, v in dropped.items()} } [{CARD}]")
    check(max(errs.values()) <= MESH_GRAD_TOL,
          f"mesh train: (a) gradients {errs}")
    check(max(wrong.values()) > MESH_GRAD_TOL,
          f"mesh train: the wrong-target control passed {wrong}")
    check(max(dropped.values()) > MESH_GRAD_TOL,
          f"mesh train: the dropped-all-reduce control passed {dropped}")
    check(ranks[0]["tp_grads"][1].keys() == ranks[1]["tp_grads"][1].keys()
          and all(torch.equal(ranks[0]["tp_grads"][1][n],
                              ranks[1]["tp_grads"][1][n])
                  for n in ranks[0]["tp_grads"][1]),
          "mesh train: the ranks' gathered gradients differ")
    res["a"] = {"grad_row_rel": errs, "wrong_target": wrong,
                "copy_in_dropped": dropped,
                "hist": [o["tp"]["hist"] for o in ranks],
                "one_rank": one["fit"]["hist"]}
    # (b)
    offa = anchors["off"]
    for r, out in enumerate(ranks):
        check(out["on"]["wire"] == 2 and out["on"]["ef"]
              and out["off"]["wire"] == 0,
              f"mesh train: (b) rank {r} wire {out['on']['wire']}")
        on0, off0 = out["on"]["hist"][0][0], out["off"]["hist"][0][0]
        check(on0 == off0, f"mesh train: (b) step-0 losses on {on0!r} off "
              f"{off0!r} differ")
        _mesh_track(f"(b) on rank {r}", out["on"], offa["fit"], loss_tol)
        _mesh_track(f"(b) off rank {r}", out["off"], offa["fit"], loss_tol)
    (xa, ma, ea), (xb, mb, eb) = (o["on_leaf"] for o in ranks)
    lhs = ma.double() + (ea.double() + eb.double()) / 2
    rhs = (xa.double() + xb.double()) / 2
    ident = float((lhs - rhs).abs().max() / rhs.abs().max())
    log(f"mesh train: (b) the wire on one leaf ({tuple(xa.shape)}): the "
        f"ranks' delivered means equal: {torch.equal(ma, mb)}; mean + the "
        f"residuals' mean - the accumulators' mean, max rel {ident:.3e} "
        f"[{CARD}]")
    check(torch.equal(ma, mb) and ident <= 4 * 2 ** -23,
          f"mesh train: the wire's identity {ident}")
    same = ranks[0]["on_checksums"] == ranks[1]["on_checksums"]
    log(f"mesh train: (b) {len(ranks[0]['on_checksums'])} replicated bf16 "
        f"leaves after the last step, checksums equal across the data "
        f"ranks: {same} [{CARD}]")
    check(same, "mesh train: the data ranks' replicas drifted apart")
    res["b"] = {"identity_rel": ident, "replicas_equal": same,
                "on": [o["on"]["hist"] for o in ranks],
                "off": [o["off"]["hist"] for o in ranks],
                "one_rank": offa["fit"]["hist"]}
    # memory and launches
    launches = {"flash_attention": 0, "flash_attention_bwd": 0}
    res["peaks"], res["launches"] = {}, {}
    for r, out in enumerate(ranks):
        for k in ("tp", "on", "off"):
            o = out[k]
            want_l = expected_train_launches(arch, ps[k].comm.remat_policy)
            ratio = o["estimate"] / o["peak"]
            log(f"mesh train: rank {r} {k}: peak allocated {o['peak']} "
                f"bytes, estimate {o['estimate']:.0f} ({ratio:.4f} x the "
                f"peak), {MESH_TRAIN_STEPS} steps in {o['s']:.2f} s, "
                f"losses {[round(h[0], 5) for h in o['hist']]} [{CARD}]")
            check(o["peak"] <= o["estimate"] <= MESH_PEAK_SLACK * o["peak"],
                  f"mesh train: rank {r} {k} peak {o['peak']} against its "
                  f"estimate {o['estimate']}")
            res["peaks"][f"rank{r}/{k}"] = (o["peak"], o["estimate"])
            c = o["launches"]
            for name in launches:
                check(c[name] == MESH_TRAIN_STEPS * want_l[name],
                      f"mesh train: rank {r} {k} launched {name} "
                      f"{c[name]} times, not {MESH_TRAIN_STEPS} x "
                      f"{want_l[name]}")
                launches[name] += c[name]
            res["launches"][f"rank{r}/{k}"] = {n: c[n] for n in launches}
    res["launch_totals"] = launches
    res["phase_s"] = time.perf_counter() - t0
    log(f"mesh train: phase took {res['phase_s']:.1f} s (ranks "
        f"{t_ranks:.1f} s) [{CARD}]")
    return launches, res


def _mesh_track(what, got, want, loss_tol):
    """Every step's loss within ``loss_tol`` and grad norm within
    :data:`MESH_GNORM_TOL` of the one-rank run's."""
    for t, ((l, g), (lw, gw)) in enumerate(zip(got["hist"], want["hist"])):
        lr, gr = abs(l - lw) / abs(lw), abs(g - gw) / abs(gw)
        log(f"mesh train: {what} step {t}: loss {l:.6f} vs one rank "
            f"{lw:.6f} (rel {lr:.3e}), grad norm {g:.5f} vs {gw:.5f} "
            f"(rel {gr:.3e}) [{CARD}]")
        check(math.isfinite(l) and lr <= loss_tol and gr <= MESH_GNORM_TOL,
              f"mesh train: {what} step {t}: loss {l} vs {lw}, grad norm "
              f"{g} vs {gw}")


# ---------------------------------------------------------------------
# phase 24c: SSM and hybrid archs on two ranks of the one card
# ---------------------------------------------------------------------

#: the serving shape of (a) and (b): the archs' decode plans' own
SSM_MESH_SERVE = ("serve_h100", "decode", 2048, 8)
#: prompt lengths (one past hymba's 1024 window) and tokens a request
SSM_MESH_PROMPTS, SSM_MESH_TOKENS = (1100, 300, 160, 96), 8
#: (c)'s gradient check runs hymba at full width cut to this depth: the
#: last layer's gradients then hold the mixer's arithmetic, not 32
#: layers of bf16 forward drift (0.08-0.12 of a row at depth 32 on an
#: H100, as far as the norm control moved them: 0.13)
SSM_GRAD_LAYERS = 2
#: (d)'s steps (the fit of (c) takes :data:`MESH_TRAIN_STEPS`)
SSM_MESH_FSDP_STEPS = 2
#: (c)'s second fit: hymba's (1, 2) plan cut to this depth, its peak
#: against its estimate under the same :data:`MESH_PEAK_SLACK` (the
#: estimate once overshot 1.24x here: the rank's vocab piece and state,
#: F5), for :data:`SSM_MESH_FSDP_STEPS` steps
SSM_SHALLOW_LAYERS = 8
#: the plan estimates a one-rank engine takes from the (1, 2) plan, so
#: both draw the same weights and run the same dead heads
PADDED_KEYS = ("vocab_padded", "heads_padded", "kv_heads_padded",
               "ssm_heads_padded")
#: the last layer's SSM leaves whose gradients (c) holds against one rank
SSM_GRAD_LEAVES = ("ssm/in_proj", "ssm/conv_w", "ssm/A_log", "ssm/norm",
                   "ssm/out_proj")


def ssm_mesh_serve_plans(name):
    """``(arch, (1, 2) plan, one-rank plan)`` for serving ``name`` at
    :data:`SSM_MESH_SERVE` on ``h100-sxm``: the one-rank plan carries the
    (1, 2) plan's padded sizes (hymba's 26 / 13 heads, the split vocab)."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core import specialize
    arch = get_arch(name)
    shape = ShapeConfig(*SSM_MESH_SERVE)
    tp_plan = specialize(arch, shape, mesh_axes=("data", "model"),
                         mesh_shape=(1, 2), target="h100-sxm", cache=False)
    one = specialize(arch, shape, mesh_shape=(1, 1), target="h100-sxm",
                     cache=False)
    est = dict(one.estimates)
    est.update({k: tp_plan.estimates[k] for k in PADDED_KEYS
                if k in tp_plan.estimates})
    return arch, tp_plan, dataclasses.replace(one, estimates=est)


def _ssm_mesh_prompts(arch):
    import numpy as np
    rng = np.random.default_rng(SEED + 7)
    return [rng.integers(0, arch.vocab_size, n).astype(np.int32)
            for n in SSM_MESH_PROMPTS]


def _ssm_mesh_engine(torch, dev, mesh, name):
    """(a) / (b) on one rank: the (1, 2) engine of ``name`` built from
    the rank's pieces, the prompts served; its launches, tokens, first
    logits, decode path, weight bytes and peak."""
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.sharded import param_pieces
    arch, plan, _ = ssm_mesh_serve_plans(name)
    params = lm.init_params(arch, torch.Generator(dev).manual_seed(SEED),
                            *plan.padded_sizes(),
                            pieces=param_pieces(mesh, plan, arch))
    torch.cuda.reset_peak_memory_stats()
    eng = _recording_engine(ServeEngine).from_plan(plan, params, arch=arch,
                                                   mesh=mesh)
    del params
    held = sum(t.numel() * t.element_size() for t in _leaves(eng.params))
    for p in _ssm_mesh_prompts(arch):
        eng.submit(p, max_new_tokens=SSM_MESH_TOKENS)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run_until_idle(max_ticks=4096)
    torch.cuda.synchronize()
    out = {"launches": ops.launch_counts(), "s": time.perf_counter() - t0,
           "first": eng.first, "path": eng.decode_path,
           "split": eng.cfg.kv_split, "weight_bytes": held,
           "prefill_calls": eng.telemetry()["prefill"]["calls"],
           "ticks": eng.tick,
           "cache": {k: tuple(v.shape) for k, v in eng.cache.items()},
           "tokens": {r.rid: list(r.out_tokens) for r in done},
           "peak": torch.cuda.max_memory_allocated()}
    del eng
    torch.cuda.empty_cache()
    return out


def ssm_mesh_train_plans(torch):
    """(c) and (d)'s plans: hymba-1.5b's and mamba2-2.7b's ``h100-sxm``
    (1, 2) train plans on :data:`MESH_TRAIN_SHAPE` at the largest depth
    whose per-rank step-peak estimate fits :data:`MESH_TRAIN_SHARE` of
    the card, and hymba's at :data:`SSM_GRAD_LAYERS` (``"grads"``):
    ``{name: (arch cut to that depth, plan)}``."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core import specialize
    shape = ShapeConfig(*MESH_TRAIN_SHAPE)
    card = torch.cuda.get_device_properties(0).total_memory
    out = {}

    def cut_plan(arch, n):
        cut = dataclasses.replace(arch, n_layers=n)
        return cut, specialize(cut, shape, mesh_axes=("data", "model"),
                               mesh_shape=(1, 2), target="h100-sxm",
                               cache=False)
    out["grads"] = cut_plan(get_arch("hymba-1.5b"), SSM_GRAD_LAYERS)
    out["shallow"] = cut_plan(get_arch("hymba-1.5b"), SSM_SHALLOW_LAYERS)
    for name in ("hymba-1.5b", "mamba2-2.7b"):
        arch = get_arch(name)
        plan = functools.partial(cut_plan, arch)
        lo, hi = 0, arch.n_layers
        while lo < hi:                   # estimates grow with depth
            mid = (lo + hi + 1) // 2
            if plan(mid)[1].estimates["step_peak_bytes"] \
                    <= MESH_TRAIN_SHARE * card:
                lo = mid
            else:
                hi = mid - 1
        check(lo > 0, f"ssm mesh: no depth of {name} fits two ranks")
        out[name] = plan(lo)
    return shape, out


@contextlib.contextmanager
def ssm_fault(which):
    """(c)'s planted faults in ``models.ssm``: ``regroup``, the regroup's
    ``copy_in`` dropped (the gathered ``in_proj`` product and conv output
    cut into the rank's heads without summing the cuts' gradients);
    ``norm``, the gated norm's sum of squares all-reduced forward only
    (its gradient not summed over the ranks that use it)."""
    from repro_torch.models import ssm, tp
    name = {"regroup": "_regroup_in", "norm": "_norm_sum"}[which]
    keep = getattr(ssm, name)
    setattr(ssm, name, {"regroup": lambda t, c: t,
                        "norm": tp.reduce_sum}[which])
    try:
        yield
    finally:
        setattr(ssm, name, keep)


def _ssm_grads(grads):
    """The last layer's SSM leaves of :func:`_layer_grads`' gradients."""
    return {n: grads[n] for n in SSM_GRAD_LEAVES}


def _ssm_mesh_rank(rank: int, tmp: str, src: str) -> None:
    """One of phase 24c's two ranks on ``cuda:0`` over gloo, held to
    :data:`MESH_TRAIN_FRACTION` of the card: (a) and (b) served, (c)'s
    gradients (with the planted faults) and fit, (d)'s fit."""
    import datetime
    import os
    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.cuda.set_device(0)
    torch.cuda.set_per_process_memory_fraction(MESH_TRAIN_FRACTION, 0)
    dev = torch.device("cuda", 0)
    out = {}
    try:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                rank=rank, world_size=2,
                                timeout=datetime.timedelta(seconds=600))
        mesh = init_device_mesh("cuda", (1, 2),
                                mesh_dim_names=("data", "model"))
        t0, out["times"] = time.perf_counter(), {}

        def lap(what):
            out["times"][what] = time.perf_counter() - t0
        for name in ("mamba2-2.7b", "hymba-1.5b"):
            out[name] = _ssm_mesh_engine(torch, dev, mesh, name)
            lap(name)
        shape, plans = ssm_mesh_train_plans(torch)
        arch, plan = plans["grads"]
        batches = _mesh_batches(arch, shape)
        tr, state = _mesh_trainer(torch, dev, plan, arch, shape, mesh)
        b0 = _on_dev(torch, batches[0], dev)
        args = (torch, arch, state["params"], b0, tr.step_def.cfg,
                tr.step_def.layout)
        out["grads"] = _layer_grads(*args)
        for which in ("regroup", "norm"):
            with ssm_fault(which):
                out[f"grads_{which}"] = _layer_grads(*args)
        del tr, state, args
        torch.cuda.empty_cache()
        lap("grads")
        arch, plan = plans["hymba-1.5b"]
        out["fit"] = _mesh_fit(torch, dev, plan, arch, shape, mesh)[2]
        torch.cuda.empty_cache()
        lap("fit")
        arch, plan = plans["shallow"]
        out["fit_shallow"] = _mesh_fit(torch, dev, plan, arch, shape, mesh,
                                       steps=SSM_MESH_FSDP_STEPS)[2]
        torch.cuda.empty_cache()
        lap("fit_shallow")
        arch, plan = plans["mamba2-2.7b"]
        out["fsdp"] = _mesh_fit(torch, dev, plan, arch, shape, mesh,
                                steps=SSM_MESH_FSDP_STEPS)[2]
        lap("fsdp")
    except Exception:
        import traceback
        out["error"] = traceback.format_exc()[-4000:]
    torch.save(out, os.path.join(tmp, f"r{rank}.pt"))
    if dist.is_initialized():
        dist.destroy_process_group()


def _ssm_mesh_anchor_engine(torch, dev, name):
    """The one-rank engine of ``name`` at the (1, 2) plan's padded
    sizes (no host tier, no prefix reuse): tokens, margins, first
    logits."""
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine
    arch, plan, one = ssm_mesh_serve_plans(name)
    params = lm.init_params(arch, torch.Generator(dev).manual_seed(SEED),
                            *plan.padded_sizes())
    eng = _recording_engine(ServeEngine).from_plan(
        one, params, arch=arch, kv_host_blocks=0, kv_prefix_reuse="off")
    for p in _ssm_mesh_prompts(arch):
        eng.submit(p, max_new_tokens=SSM_MESH_TOKENS)
    done = eng.run_until_idle(max_ticks=4096)
    out = ({r.rid: list(r.out_tokens) for r in done}, eng.margins,
           eng.first, eng.decode_path)
    del eng, params
    torch.cuda.empty_cache()
    return out


def _ssm_mesh_served(torch, name, ranks, one):
    """(a) / (b)'s checks on both ranks' records against the one-rank
    engine's ``one``."""
    from repro_torch.models import lm
    arch, plan, _ = ssm_mesh_serve_plans(name)
    want, margins, first, one_path = one
    r0 = ranks[0][name]
    specs = lm.leaf_specs(arch, *plan.padded_sizes())
    whole = sum(math.prod(sp.shape) * sp.dtype.itemsize
                for sp in _leaves(specs))
    L = arch.n_layers
    res = {"path": r0["path"], "split": r0["split"], "whole_bytes": whole,
           "weight_bytes": [o[name]["weight_bytes"] for o in ranks],
           "launches": [o[name]["launches"] for o in ranks],
           "prefill_calls": r0["prefill_calls"], "ticks": r0["ticks"],
           "s": [o[name]["s"] for o in ranks],
           "peak": [o[name]["peak"] for o in ranks], "one_path": one_path}
    for r, out in enumerate(ranks):
        o = out[name]
        check(o["tokens"] == r0["tokens"], f"ssm mesh: {name}: the ranks' "
              "tokens differ")
        share = o["weight_bytes"] / whole
        check(0.45 <= share <= 0.55, f"ssm mesh: {name}: rank {r} holds "
              f"{share:.3f} of the weights")
        c = o["launches"]
        check(c["ssd_scan"] == L * o["prefill_calls"],
              f"ssm mesh: {name}: rank {r} launched ssd_scan "
              f"{c['ssd_scan']} times in {o['prefill_calls']} prefill calls")
        if arch.has_attention:
            check(c["flash_attention"] == L * o["prefill_calls"]
                  and c["paged_decode_partial"] > 0,
                  f"ssm mesh: {name}: rank {r} launched {c}")
    if arch.has_attention:
        check(r0["path"] == "shard_map_flash" and r0["split"] == "rows",
              f"ssm mesh: {name}: decode path {r0['path']}, split "
              f"{r0['split']}")
    rels = {rid: _rms_rel(torch, r0["first"][rid], row)
            for rid, row in first.items()}
    # a control: another request's logits
    wrong = _rms_rel(torch, r0["first"][1], first[0])
    check(max(rels.values()) <= FULL_TOL < wrong,
          f"ssm mesh: {name}: first logits {rels}, control {wrong}")
    compared, splits = 0, []
    for rid, toks in want.items():
        got = r0["tokens"][rid]
        check(len(got) == len(toks), f"ssm mesh: {name}: token counts")
        for i, (a, b) in enumerate(zip(got, toks)):
            if a != b:
                splits.append((rid, i, margins[rid][i]))
                check(margins[rid][i] <= FULL_TOL,
                      f"ssm mesh: {name}: request {rid} token {i}: {a} vs "
                      f"{b} at margin {margins[rid][i]}")
                break
            compared += 1
    res.update(first_logits_rms_rel=rels, first_logits_wrong_request=wrong,
               tokens_compared=compared, splits=splits,
               tokens=sum(len(t) for t in want.values()))
    log(f"ssm mesh: ({'a' if name.startswith('mamba') else 'b'}) {name} "
        f"full width, {L} layers, (1, 2) plan: decode path {r0['path']} "
        f"(split {r0['split']}; one rank {one_path}), "
        f"{len(want)} requests x {SSM_MESH_TOKENS} tokens in "
        f"{fmt(res['s'])} s a rank, {compared} of {res['tokens']} tokens "
        f"equal the one-rank engine's before the first margin-rule split "
        f"{splits}, first-token logits rms-relative "
        f"{fmt(list(rels.values()))} (bound {FULL_TOL}; another request's "
        f"{wrong:.3f}), weights {res['weight_bytes']} bytes a rank of "
        f"{whole}, launches a rank {res['launches'][0]} in "
        f"{r0['prefill_calls']} prefill calls and {r0['ticks']} ticks, "
        f"peak allocated {res['peak']} bytes a rank [{CARD}]")
    return res


def ssm_mesh_phase(torch, dev):
    """Phase 24c: two ranks spawned on ``cuda:0`` over gloo, each held to
    :data:`MESH_TRAIN_FRACTION` of the card, run (a) mamba2-2.7b and
    (b) hymba-1.5b served at full width and depth from their (1, 2)
    ``h100-sxm`` plans, (c) hymba trained on its (1, 2) ``megatron_tp``
    plan (its gradient check at :data:`SSM_GRAD_LAYERS`) and (d) mamba2
    on its (1, 2) ``fsdp_dp`` plan, each at the depth
    :func:`ssm_mesh_train_plans` finds; then the one-rank anchors in this
    process.  Returns ``(launches summed over both ranks' runs, the
    results)``.  A rank that fails fails the run."""
    import os
    import tempfile

    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    shape, plans = ssm_mesh_train_plans(torch)
    gib = 2 ** 30
    for name, (arch, plan) in plans.items():
        log(f"ssm mesh: {name} train at depth {arch.n_layers} (the largest "
            f"whose per-rank estimate fits {MESH_TRAIN_SHARE:.2f} of the "
            f"card): (1, 2) {plan.estimates['strategy']}, remat "
            f"{plan.comm.remat_policy}, estimate "
            f"{plan.estimates['step_peak_bytes'] / gib:.3f} GiB a rank "
            f"[{CARD}]")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_ssm_mesh_rank,
                             args=(r, tmp, str(SRC_IN_USE)))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=900)
            if p.is_alive():
                p.kill()
                p.join()
        ranks = []
        for r, p in enumerate(procs):
            path = Path(tmp) / f"r{r}.pt"
            check(path.exists(), f"ssm mesh: rank {r} left no result "
                  f"(exit {p.exitcode})")
            ranks.append(torch.load(path, weights_only=False))
    for r, out in enumerate(ranks):
        check("error" not in out, f"ssm mesh: rank {r} failed: "
              f"{out.get('error')}")
    t_ranks = time.perf_counter() - t0
    res = {"ranks_s": t_ranks, "rank_laps_s": ranks[0]["times"]}
    log(f"ssm mesh: the ranks took {t_ranks:.1f} s, rank 0's laps "
        f"{ {k: round(v, 1) for k, v in ranks[0]['times'].items()} } "
        f"[{CARD}]")
    launches = {k: 0 for k in ("ssd_scan", "ssd_scan_bwd", "flash_attention",
                               "flash_attention_bwd", "paged_decode_partial")}
    # (a), (b)
    for name in ("mamba2-2.7b", "hymba-1.5b"):
        one = _ssm_mesh_anchor_engine(torch, dev, name)
        res[name] = _ssm_mesh_served(torch, name, ranks, one)
        for out in ranks:
            for k in launches:
                launches[k] += out[name]["launches"][k]
    # (c): the gradients at SSM_GRAD_LAYERS, then the fit at full depth
    garch, gplan = plans["grads"]
    batches = _mesh_batches(garch, shape)
    gone = _mesh_anchor(torch, dev, gplan, garch, shape, batches, fit=False)
    arch, plan = plans["hymba-1.5b"]
    one = _mesh_anchor(torch, dev, plan, arch, shape, batches, grads=False)
    loss_tol = max(MESH_LOSS_MIN, 4 * abs(
        one["fit"]["hist"][0][0] - one["plain_loss"]) / abs(
            one["plain_loss"]))
    for r, out in enumerate(ranks):
        _mesh_track(f"ssm (c) hymba rank {r}", out["fit"], one["fit"],
                    loss_tol)
    want = _ssm_grads(gone["grads"][1])

    def errs(grads):
        return {n: grad_row_err(torch, g, want[n])[1]
                for n, g in _ssm_grads(grads).items()}
    got = errs(ranks[0]["grads"][1])
    controls = {"regroup_copy_in_dropped": errs(ranks[0]["grads_regroup"][1]),
                "norm_backward_all_reduce_dropped":
                    errs(ranks[0]["grads_norm"][1]),
                "wrong_target": errs(gone["wrong_grads"][1])}
    log(f"ssm mesh: (c) hymba depth {garch.n_layers}, the last layer's SSM "
        f"gradients (1, 2) against one rank, worst row rel "
        f"{max(got.values()):.3e} (tol {MESH_GRAD_TOL}) "
        f"{ {n: round(v, 5) for n, v in got.items()} }; planted controls, "
        f"worst: " + ", ".join(f"{k} {max(v.values()):.3e}"
                               for k, v in controls.items())
        + f"; loss tol {loss_tol:.3e} [{CARD}]")
    check(max(got.values()) <= MESH_GRAD_TOL,
          f"ssm mesh: (c) gradients {got}")
    for k, v in controls.items():
        check(max(v.values()) > MESH_GRAD_TOL,
              f"ssm mesh: (c) the control {k} passed {v}")
    check(all(torch.equal(ranks[0]["grads"][1][n], ranks[1]["grads"][1][n])
              for n in SSM_GRAD_LEAVES),
          "ssm mesh: (c) the ranks' gathered gradients differ")
    want_l = expected_train_launches(arch, plan.comm.remat_policy)
    peaks = {}
    for r, out in enumerate(ranks):
        o = out["fit"]
        ratio = o["estimate"] / o["peak"]
        peaks[f"rank{r}"] = (o["peak"], o["estimate"], ratio)
        log(f"ssm mesh: (c) rank {r}: peak allocated {o['peak']} bytes, "
            f"estimate {o['estimate']:.0f} ({ratio:.4f} x the peak), "
            f"{MESH_TRAIN_STEPS} steps in {o['s']:.2f} s, launches "
            f"{o['launches']} [{CARD}]")
        check(o["peak"] <= o["estimate"] <= MESH_PEAK_SLACK * o["peak"],
              f"ssm mesh: (c) rank {r} peak {o['peak']} against its "
              f"estimate {o['estimate']}")
        for k in ("ssd_scan", "ssd_scan_bwd", "flash_attention",
                  "flash_attention_bwd"):
            check(o["launches"][k] == MESH_TRAIN_STEPS * want_l[k],
                  f"ssm mesh: (c) rank {r} launched {k} "
                  f"{o['launches'][k]} times, not {MESH_TRAIN_STEPS} x "
                  f"{want_l[k]}")
            launches[k] += o["launches"][k]
    # F5: the same plan cut to SSM_SHALLOW_LAYERS, under the same bar
    sarch, splan = plans["shallow"]
    want_s = expected_train_launches(sarch, splan.comm.remat_policy)
    for r, out in enumerate(ranks):
        o = out["fit_shallow"]
        ratio = o["estimate"] / o["peak"]
        peaks[f"rank{r}/depth{sarch.n_layers}"] = (o["peak"], o["estimate"],
                                                   ratio)
        log(f"ssm mesh: (c) F5 rank {r} at depth {sarch.n_layers}: peak "
            f"allocated {o['peak']} bytes, estimate {o['estimate']:.0f} "
            f"({ratio:.4f} x the peak), {SSM_MESH_FSDP_STEPS} steps in "
            f"{o['s']:.2f} s [{CARD}]")
        check(o["peak"] <= o["estimate"] <= MESH_PEAK_SLACK * o["peak"],
              f"ssm mesh: (c) rank {r} at depth {sarch.n_layers}: peak "
              f"{o['peak']} against its estimate {o['estimate']}")
        for k in ("ssd_scan", "ssd_scan_bwd", "flash_attention",
                  "flash_attention_bwd"):
            check(o["launches"][k] == SSM_MESH_FSDP_STEPS * want_s[k],
                  f"ssm mesh: (c) rank {r} at depth {sarch.n_layers} "
                  f"launched {k} {o['launches'][k]} times")
            launches[k] += o["launches"][k]
    res["c"] = {"n_layers": arch.n_layers, "grad_layers": garch.n_layers,
                "shallow_layers": sarch.n_layers,
                "grad_row_rel": got,
                "controls": controls, "loss_tol": loss_tol, "peaks": peaks,
                "strategy": plan.estimates["strategy"],
                "hist": [o["fit"]["hist"] for o in ranks],
                "one_rank": one["fit"]["hist"],
                "s": [o["fit"]["s"] for o in ranks],
                "one_rank_s": one["fit"]["s"]}
    del one, gone
    torch.cuda.empty_cache()
    # (d)
    arch, plan = plans["mamba2-2.7b"]
    check(plan.estimates["strategy"] == "fsdp_dp",
          f"ssm mesh: (d) mamba2's (1, 2) plan is "
          f"{plan.estimates['strategy']}")
    one = _mesh_fit(torch, dev, plan, arch, shape, None,
                    steps=SSM_MESH_FSDP_STEPS)[2]
    torch.cuda.empty_cache()
    for r, out in enumerate(ranks):
        _mesh_track(f"ssm (d) mamba2 fsdp_dp rank {r}", out["fsdp"], one,
                    max(MESH_LOSS_MIN, loss_tol))
        o = out["fsdp"]
        log(f"ssm mesh: (d) rank {r}: peak allocated {o['peak']} bytes, "
            f"estimate {o['estimate']:.0f} ({o['estimate'] / o['peak']:.4f}"
            f" x the peak), {SSM_MESH_FSDP_STEPS} steps in {o['s']:.2f} s "
            f"[{CARD}]")
        for k in ("ssd_scan", "ssd_scan_bwd"):
            check(o["launches"][k] > 0, f"ssm mesh: (d) rank {r} launched "
                  f"{k} no time")
            launches[k] += o["launches"][k]
    res["d"] = {"n_layers": arch.n_layers,
                "strategy": plan.estimates["strategy"],
                "hist": [o["fsdp"]["hist"] for o in ranks],
                "one_rank": one["hist"],
                "peaks": [(o["fsdp"]["peak"], o["fsdp"]["estimate"])
                          for o in ranks],
                "s": [o["fsdp"]["s"] for o in ranks]}
    res["launches"] = launches
    res["phase_s"] = time.perf_counter() - t0
    log(f"ssm mesh: phase took {res['phase_s']:.1f} s (ranks "
        f"{t_ranks:.1f} s), launches over both ranks {launches} [{CARD}]")
    return launches, res


# ---------------------------------------------------------------------
# phase 24d: the paged plan as frozen on two ranks of the one card: the
# host tier, migration between the data shards' sub-pools, disaggregated
# prefill into a sharded pool
# ---------------------------------------------------------------------

#: (a)'s plan: qwen3-8b's (2, 1) ``h100-sxm`` decode 2048 x 8 plan, which
#: writes grant admission and a host tier (256 blocks of 256 rows) itself;
#: its pool is cut to :data:`TIER_BLOCKS` (4 a data shard's sub-pool) so
#: the burst walks the ladder: the one override of the plan, named
TIER_SHAPE = ("serve_h100", "decode", 2048, 8)
TIER_BLOCKS = 8
#: (a)'s waves (prompt lengths; the last wave's prompt opens with the
#: first prompt of the first), tokens a request, and the park's backoff
TIER_WAVES = ((512, 512), (700, 700, 700), (612,))
TIER_NEW, TIER_BACKOFF = 8, 2
#: the counters (a) holds equal to the one-rank engine's
TIER_COUNTERS = ("preemptions", "migrations", "grant_denials", "shed",
                 "parked", "spills", "promotes", "prefix_hits",
                 "prefix_rides", "cow_copies", "parks_with_state", "resumes",
                 "resumes_by_promote", "prefetch_staged",
                 "prefetch_consumed")
#: (b)'s plan: the (1, 2) decode 4096 x 8 plan, which writes disagg
#: (chunks of 512), with prompts and tokens a request
MESH_DISAGG_SHAPE = ("serve_h100_4k", "decode", 4096, 8)
MESH_DISAGG_REQUESTS, MESH_DISAGG_NEW = 4, 8
MESH_DISAGG_LENS = (1024, 1600)


def _tier_prompts(arch):
    import numpy as np
    rng = np.random.default_rng(SEED + 31)
    waves = [[rng.integers(0, arch.vocab_size, n).astype(np.int32)
              for n in lens] for lens in TIER_WAVES[:2]]
    first = waves[0][0]
    waves.append([np.concatenate([first, rng.integers(
        0, arch.vocab_size, TIER_WAVES[2][0] - len(first))]).astype(
            np.int32)])
    return waves


def tier_plan():
    """(a)'s ``(arch, (2, 1) plan cut to TIER_BLOCKS blocks)``."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core import specialize
    arch = get_arch("qwen3-8b")
    plan = specialize(arch, ShapeConfig(*TIER_SHAPE),
                      mesh_axes=("data", "model"), mesh_shape=(2, 1),
                      target="h100-sxm", cache=False)
    return arch, dataclasses.replace(plan, estimates={
        **plan.estimates, "kv_n_blocks": TIER_BLOCKS})


def tier_burst(eng):
    """(a) on either engine: the waves in turn, each run out; two ticks
    into the second wave the request with the most output is parked with
    state (its rows staged the tick before its resume)."""
    waves = _tier_prompts(eng.arch)
    for w, prompts in enumerate(waves):
        for p in prompts:
            eng.submit(p, max_new_tokens=TIER_NEW)
        if w == 1:
            for _ in range(2):
                eng.step()
            eng.preempt(max(eng.active.values(), key=lambda r: (
                len(r.out_tokens), -r.rid)).rid)
        eng.run_until_idle(max_ticks=4096)
    return eng


def _mesh_tier_engine(torch, dev, mesh):
    """(a) on one rank: the (2, 1) grant engine of full-width qwen3-8b
    (each rank the whole weights, its data shard's sub-pool, a whole copy
    of the host tier) through :func:`tier_burst`."""
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve.engine import PreemptionPolicy, ServeEngine
    from repro_torch.serve.sharded import param_pieces
    arch, plan = tier_plan()
    params = lm.init_params(arch, torch.Generator(dev).manual_seed(SEED),
                            *plan.padded_sizes(),
                            pieces=param_pieces(mesh, plan, arch))
    eng = ServeEngine.from_plan(
        plan, params, arch=arch, mesh=mesh, seed=SEED,
        preemption=PreemptionPolicy(backoff_base_ticks=TIER_BACKOFF))
    del params
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    tier_burst(eng)
    torch.cuda.synchronize()
    ps = eng.pressure_stats()
    out = {"launches": ops.launch_counts(), "s": time.perf_counter() - t0,
           "path": eng.decode_path, "split": eng.cfg.kv_split,
           "groups": eng.pool_groups, "n_blocks": eng.n_blocks,
           "host_blocks": eng.host_blocks,
           "host_shape": tuple(eng._host["k"].shape),
           "pool_shape": tuple(eng.cache["k"].shape),
           "counters": {k: ps[k] for k in TIER_COUNTERS},
           "prefill_calls": eng.prefill_calls, "ticks": eng.tick,
           "tier_ms": dict(eng.tier_ms),
           "tokens": {r.rid: list(r.out_tokens) for r in eng.finished}}
    del eng
    torch.cuda.empty_cache()
    return out


def _mesh_disagg_prompts(arch):
    import numpy as np
    rng = np.random.default_rng(SEED + 30)
    return [rng.integers(0, arch.vocab_size, int(n)).astype(np.int32)
            for n in rng.integers(MESH_DISAGG_LENS[0],
                                  MESH_DISAGG_LENS[1] + 1,
                                  MESH_DISAGG_REQUESTS)]


def _mesh_disagg_runs(torch, dev, mesh):
    """(b) on one rank: full-width qwen3-8b's (1, 2) 4096 x 8 plan
    (``kv_prefill_mode: disagg``) from the rank's pieces, inline first
    (the recording engine: tokens and their one-mesh margins), then with
    one prefill worker owned by rank 0 on the whole weights it gathers,
    the worker SIGKILLed once a prompt has a journaled chunk and more to
    come."""
    import gc

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core import specialize
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.sharded import param_pieces
    arch = get_arch("qwen3-8b")
    plan = specialize(arch, ShapeConfig(*MESH_DISAGG_SHAPE),
                      mesh_axes=("data", "model"), mesh_shape=(1, 2),
                      target="h100-sxm", cache=False)
    est = plan.estimates
    params = lm.init_params(arch, torch.Generator(dev).manual_seed(SEED),
                            *plan.padded_sizes(),
                            pieces=param_pieces(mesh, plan, arch))
    prompts = _mesh_disagg_prompts(arch)
    out = {"plan": {k: est.get(k) for k in (
        "kv_prefill_mode", "kv_prefill_chunk", "kv_block_len",
        "kv_n_blocks", "kv_admission", "kv_host_blocks")}}

    def serve(eng, kill):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        for p in prompts:
            eng.submit(p, max_new_tokens=MESH_DISAGG_NEW)
        killed, resume_tick, deadline = None, None, time.time() + 600
        while (eng.pending or eng.active or eng._disagg) \
                and time.time() < deadline:
            eng.step()
            if resume_tick is None and eng.disagg_resumes:
                resume_tick = eng.tick
            if kill and killed is None:
                fl = next((f for f in eng._disagg.values()
                           if 1 <= f.acked < f.nb_feed), None)
                if fl is not None \
                        and eng._fleet.kill_worker(rid=fl.request.rid):
                    killed = (fl.request.rid, fl.acked, fl.nb_feed)
        torch.cuda.synchronize()
        done = sorted(eng.finished, key=lambda r: r.rid)
        tel = eng.telemetry()
        return {"s": time.perf_counter() - t0, "launches": ops.launch_counts(),
                "idle": not (eng.pending or eng.active or eng._disagg),
                "tokens": {r.rid: list(r.out_tokens) for r in done},
                "killed": killed, "resume_tick": resume_tick,
                "prefill_mode": eng.prefill_mode,
                "disagg": tel["prefill"]["disagg"],
                "path": eng.decode_path, "split": eng.cfg.kv_split,
                "scatter_ms": eng.tier_ms["disagg_chunk"]}

    inline = _recording_engine(ServeEngine).from_plan(
        plan, params, arch=arch, mesh=mesh, seed=SEED,
        kv_prefill_mode="inline")
    out["inline"] = serve(inline, kill=False)
    out["inline"]["margins"] = dict(inline.margins)
    del inline
    gc.collect()
    torch.cuda.empty_cache()
    opts = dict(heartbeat_s=0.5, heartbeat_timeout_s=120.0,
                hello_timeout_s=300.0)
    t0 = time.perf_counter()
    eng = ServeEngine.from_plan(plan, params, arch=arch, mesh=mesh,
                                seed=SEED, disagg_workers=1,
                                disagg_opts=opts)
    build_s = time.perf_counter() - t0
    try:
        out["disagg"] = serve(eng, kill=True)
        out["disagg"].update(build_s=build_s,
                             fleet_weight_bytes=eng.fleet_weight_bytes,
                             record_ms=eng._fleet.record_ms,
                             slab_ms=eng._fleet.slab_ms,
                             wire=str(eng._fleet.device),
                             held_bytes=eng.pieces.param_bytes(
                                 eng.params)[0],
                             whole_bytes=eng.pieces.param_bytes(
                                 eng.params)[1])
    finally:
        eng.shutdown()
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mesh_tier_rank(rank: int, tmp: str, src: str) -> None:
    """One of phase 24d's two ranks on ``cuda:0`` over gloo, held to
    :data:`MESH_TRAIN_FRACTION` of the card: (a) on a (2, 1) mesh, then
    (b) on a (1, 2) mesh of the same two ranks."""
    import datetime
    import os
    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.cuda.set_device(0)
    torch.cuda.set_per_process_memory_fraction(MESH_TRAIN_FRACTION, 0)
    dev = torch.device("cuda", 0)
    out = {}
    try:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                rank=rank, world_size=2,
                                timeout=datetime.timedelta(seconds=600))
        t0, out["times"] = time.perf_counter(), {}
        mesh = init_device_mesh("cuda", (2, 1),
                                mesh_dim_names=("data", "model"))
        out["tier"] = _mesh_tier_engine(torch, dev, mesh)
        out["times"]["tier"] = time.perf_counter() - t0
        mesh = init_device_mesh("cuda", (1, 2),
                                mesh_dim_names=("data", "model"))
        out["disagg"] = _mesh_disagg_runs(torch, dev, mesh)
        out["times"]["disagg"] = time.perf_counter() - t0
        out["peak"] = torch.cuda.max_memory_allocated()
    except Exception:
        import traceback
        out["error"] = traceback.format_exc()[-4000:]
    torch.save(out, os.path.join(tmp, f"r{rank}.pt"))
    if dist.is_initialized():
        dist.destroy_process_group()


def _tier_anchor(torch, dev):
    """(a)'s one-rank engine on the same card: the (2, 1) plan's geometry
    with ``kv_pool_groups=2`` and the same host tier, the recording
    engine (tokens and their margins)."""
    from repro_torch.core.passes.lowering import build_run_cfg
    from repro_torch.models import lm
    from repro_torch.serve.engine import PreemptionPolicy, ServeEngine
    arch, plan = tier_plan()
    est = plan.estimates
    params = lm.init_params(arch, torch.Generator(dev).manual_seed(SEED),
                            *plan.padded_sizes())
    cfg = build_run_cfg(plan, arch)
    eng = _recording_engine(ServeEngine)(
        arch, params, cfg, max_batch=TIER_SHAPE[3], max_len=TIER_SHAPE[2],
        kv_heads=cfg.kv_heads_padded, seed=SEED, kv_residency="paged",
        kv_block_len=int(est["kv_block_len"]), kv_n_blocks=TIER_BLOCKS,
        kv_admission=str(est["kv_admission"]), kv_pool_groups=2,
        kv_prefix_reuse=str(est["kv_prefix_reuse"]),
        kv_host_blocks=int(est["kv_host_blocks"]),
        kv_prefetch=str(est["kv_prefetch"]),
        preemption=PreemptionPolicy(backoff_base_ticks=TIER_BACKOFF))
    tier_burst(eng)
    ps = eng.pressure_stats()
    out = {"counters": {k: ps[k] for k in TIER_COUNTERS},
           "prefill_calls": eng.prefill_calls, "ticks": eng.tick,
           "tokens": {r.rid: list(r.out_tokens) for r in eng.finished},
           "margins": dict(eng.margins), "path": eng.decode_path,
           "n_blocks": eng.n_blocks, "host_blocks": eng.host_blocks}
    del eng, params
    torch.cuda.empty_cache()
    return out


def _margin_rule(what, got, want, margins):
    """``got`` tokens (by rid) equal ``want``'s up to each request's first
    difference, allowed only where ``margins`` (the anchor's top-2 margin
    at that token) is within :data:`FULL_TOL`; returns (tokens held
    equal, the splits)."""
    check(sorted(got) == sorted(want), f"{what}: requests {sorted(got)} "
          f"against {sorted(want)}")
    compared, splits = 0, []
    for rid, toks in want.items():
        g = got[rid]
        check(len(g) == len(toks), f"{what}: request {rid} token count")
        for i, (a, b) in enumerate(zip(g, toks)):
            if a != b:
                m = margins[rid][i]
                splits.append((rid, i, m))
                check(m <= FULL_TOL, f"{what}: request {rid} token {i}: "
                      f"{a} vs {b} at margin {m}")
                break
            compared += 1
    return compared, splits


def mesh_tier_phase(torch, dev):
    """Phase 24d: two ranks spawned on ``cuda:0`` over gloo, each held to
    :data:`MESH_TRAIN_FRACTION` of the card, on classic allocator
    segments (CUDA IPC exports them): (a) full-width qwen3-8b's (2, 1)
    grant plan with its host tier, the pool cut to :data:`TIER_BLOCKS`,
    a burst that walks spill, promote, a park with a staged prefetch and
    the migrate rung between the data shards' sub-pools, against the
    one-rank engine on the same card with ``kv_pool_groups=2`` and the
    same tier (tokens by the full-depth margin rule, every counter
    equal); (b) the (1, 2) 4096 x 8 plan that writes ``disagg``, one
    prefill worker owned by rank 0 on the whole weights it gathered,
    SIGKILLed mid-flight and resumed, against the inline mesh engine.
    Returns ``(launches summed over both ranks' runs and the worker's,
    the results)``.  A rank that fails fails the run."""
    import os
    import tempfile

    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    keep = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:False"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ctx = mp.get_context("spawn")
            procs = [ctx.Process(target=_mesh_tier_rank,
                                 args=(r, tmp, str(SRC_IN_USE)))
                     for r in range(2)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(timeout=900)
                if p.is_alive():
                    p.kill()
                    p.join()
            ranks = []
            for r, p in enumerate(procs):
                path = Path(tmp) / f"r{r}.pt"
                check(path.exists(), f"mesh tier: rank {r} left no result "
                      f"(exit {p.exitcode})")
                ranks.append(torch.load(path, weights_only=False))
    finally:
        if keep is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = keep
    for r, out in enumerate(ranks):
        check("error" not in out, f"mesh tier: rank {r} failed: "
              f"{out.get('error')}")
    return mesh_tier_checks(torch, dev, ranks, t0)


def mesh_tier_checks(torch, dev, ranks, t0):
    """Phase 24d's checks on both ranks' records, with (a)'s one-rank
    anchor run here; returns what :func:`mesh_tier_phase` returns."""
    t_ranks = time.perf_counter() - t0
    res = {"ranks_s": t_ranks, "rank_laps_s": ranks[0]["times"],
           "peak": [o["peak"] for o in ranks]}
    # (a)
    one = _tier_anchor(torch, dev)
    a0 = ranks[0]["tier"]
    arch, plan = tier_plan()
    for r, out in enumerate(ranks):
        a = out["tier"]
        check(a["tokens"] == a0["tokens"] and a["counters"] == a0["counters"],
              f"mesh tier: (a) rank {r}'s tokens or counters differ from "
              "rank 0's")
        check(a["launches"]["paged_decode_partial"] > 0
              and a["launches"]["flash_attention"] > 0,
              f"mesh tier: (a) rank {r} launched {a['launches']}")
    check(a0["path"] == "shard_map_flash_paged_2d" and a0["split"] == "rows"
          and a0["groups"] == 2,
          f"mesh tier: (a) path {a0['path']}, split {a0['split']}, "
          f"{a0['groups']} sub-pools")
    check(a0["host_shape"][3] == a0["pool_shape"][3] == 8
          and a0["pool_shape"][1] == TIER_BLOCKS // 2,
          f"mesh tier: (a) host piece {a0['host_shape']}, pool piece "
          f"{a0['pool_shape']}")
    check(a0["counters"] == one["counters"]
          and a0["prefill_calls"] == one["prefill_calls"],
          f"mesh tier: (a) counters {a0['counters']} ({a0['prefill_calls']}"
          f" prefill calls) against one rank's {one['counters']} "
          f"({one['prefill_calls']})")
    c = a0["counters"]
    check(c["migrations"] >= 1 and c["spills"] >= 1 and c["promotes"] >= 1
          and c["parks_with_state"] >= 1 and c["prefetch_consumed"] >= 1
          and c["prefix_hits"] >= 1,
          f"mesh tier: (a) the burst did not walk the ladder: {c}")
    compared, splits = _margin_rule("mesh tier: (a)", a0["tokens"],
                                    one["tokens"], one["margins"])
    n_tok = sum(len(t) for t in one["tokens"].values())
    res["a"] = {"counters": c, "prefill_calls": a0["prefill_calls"],
                "ticks": a0["ticks"], "s": [o["tier"]["s"] for o in ranks],
                "tier_ms": [o["tier"]["tier_ms"] for o in ranks],
                "launches": [o["tier"]["launches"] for o in ranks],
                "tokens_compared": compared, "tokens": n_tok,
                "splits": splits, "one_rank_path": one["path"],
                "host_shape": a0["host_shape"],
                "pool_shape": a0["pool_shape"]}
    log(f"mesh tier: (a) qwen3-8b full width, {arch.n_layers} layers, (2, 1)"
        f" grant plan (pool cut to {TIER_BLOCKS} blocks of "
        f"{plan.estimates['kv_block_len']}, host tier "
        f"{plan.estimates['kv_host_blocks']} blocks, a whole copy a rank "
        f"{a0['host_shape']}): decode path {a0['path']} (one rank "
        f"{one['path']}); counters {c} equal the one-rank engine's "
        f"(kv_pool_groups=2); {compared} of {n_tok} tokens equal before the "
        f"first margin-rule splits {splits}; {a0['prefill_calls']} prefill "
        f"calls, {a0['ticks']} ticks in {fmt(res['a']['s'])} s a rank; tier "
        f"host ms rank 0 {a0['tier_ms']}; launches a rank "
        f"{res['a']['launches'][0]} [{CARD}]")
    # (b)
    b0 = ranks[0]["disagg"]
    d0 = b0["disagg"]
    for r, out in enumerate(ranks):
        b = out["disagg"]
        d = b["disagg"]
        check(b["inline"]["idle"] and d["idle"],
              f"mesh tier: (b) rank {r} not idle after 600 s")
        check(b["plan"]["kv_prefill_mode"] == "disagg"
              and d["prefill_mode"] == "disagg",
              f"mesh tier: (b) rank {r}: plan {b['plan']}, mode "
              f"{d['prefill_mode']}")
        check(d["killed"] is not None and d["disagg"]["resumes"] >= 1
              and d["disagg"]["fleet"]["deaths"] >= 1,
              f"mesh tier: (b) rank {r}: killed {d['killed']}, "
              f"{d['disagg']}")
        check(d["tokens"] == d0["tokens"]
              and b["inline"]["tokens"] == b0["inline"]["tokens"]
              and d["resume_tick"] == d0["resume_tick"]
              and d["disagg"] == d0["disagg"],
              f"mesh tier: (b) rank {r}'s tokens, resume tick or telemetry "
              "differ from rank 0's")
        check(d["launches"]["paged_decode_attention"] > 0
              and b["inline"]["launches"]["flash_attention"] > 0,
              f"mesh tier: (b) rank {r} launched {d['launches']} / "
              f"{b['inline']['launches']}")
    check(d0["fleet_weight_bytes"] == d0["whole_bytes"] > 0
          and ranks[1]["disagg"]["disagg"]["fleet_weight_bytes"] == 0,
          f"mesh tier: (b) whole weights gathered {d0['fleet_weight_bytes']}"
          f" / {ranks[1]['disagg']['disagg']['fleet_weight_bytes']} bytes "
          f"of {d0['whole_bytes']}")
    compared_b, splits_b = _margin_rule(
        "mesh tier: (b)", d0["tokens"], b0["inline"]["tokens"],
        b0["inline"]["margins"])
    fl = d0["disagg"]["fleet"]
    n_chunks = max(fl["chunks"], 1)
    per_chunk = {"worker_ring_ms": fl["chunk_host_ms"] / n_chunks,
                 "engine_read_ms": fl["recv_ms"] / n_chunks,
                 "record_bcast_ms": d0["record_ms"] / n_chunks,
                 "slab_bcast_ms": d0["slab_ms"] / n_chunks,
                 "scatter_ms": d0["scatter_ms"] / n_chunks}
    per_chunk["host_ms"] = sum(per_chunk.values())
    res["b"] = {"plan": b0["plan"], "killed": d0["killed"],
                "resume_tick": d0["resume_tick"],
                "fleet_weight_bytes": d0["fleet_weight_bytes"],
                "pieces_bytes": d0["held_bytes"],
                "collective": f"broadcast of {d0['wire']} tensors",
                "per_chunk": per_chunk,
                "chunks": fl["chunks"], "deaths": fl["deaths"],
                "spawn_to_ready_s": fl["spawn_to_ready_s"],
                "worker_launches": fl["worker_launches"],
                "build_s": d0["build_s"],
                "s": {"inline": [o["disagg"]["inline"]["s"] for o in ranks],
                      "disagg": [o["disagg"]["disagg"]["s"] for o in ranks]},
                "tokens_compared": compared_b, "splits": splits_b,
                "tokens": sum(len(t) for t in b0["inline"]["tokens"].values()),
                "launches": {"inline": [o["disagg"]["inline"]["launches"]
                                        for o in ranks],
                             "disagg": [o["disagg"]["disagg"]["launches"]
                                        for o in ranks]},
                "path": d0["path"], "split": d0["split"]}
    log(f"mesh tier: (b) qwen3-8b full width, (1, 2) 4096 x 8 plan "
        f"{b0['plan']}: one worker owned by rank 0, whole weights gathered "
        f"{d0['fleet_weight_bytes']} bytes beside its pieces "
        f"{d0['held_bytes']} bytes, engine with the fleet built in "
        f"{d0['build_s']:.1f} s; killed at (rid, acked, blocks) "
        f"{d0['killed']}, resumed at tick {d0['resume_tick']} on both ranks;"
        f" {compared_b} of {res['b']['tokens']} tokens equal the inline mesh"
        f" engine's before the first margin-rule splits {splits_b}; "
        f"{fl['chunks']} chunks by broadcast of {d0['wire']} tensors, host "
        f"ms a chunk "
        f"{ {k: round(v, 3) for k, v in per_chunk.items()} }; spawn to "
        f"weights taken {fl['spawn_to_ready_s']} s; serve s inline "
        f"{fmt(res['b']['s']['inline'])} / disagg "
        f"{fmt(res['b']['s']['disagg'])} a rank; worker launches "
        f"{fl['worker_launches']} [{CARD}]")
    launches = {k: 0 for k in ("flash_attention", "paged_decode_attention",
                               "paged_decode_partial")}
    for out in ranks:
        for run in (out["tier"]["launches"],
                    out["disagg"]["inline"]["launches"],
                    out["disagg"]["disagg"]["launches"]):
            for k in launches:
                launches[k] += run[k]
    launches["flash_attention"] += fl["worker_launches"].get(
        "flash_attention", 0)
    res["launches"] = launches
    res["phase_s"] = time.perf_counter() - t0
    log(f"mesh tier: phase took {res['phase_s']:.1f} s (ranks "
        f"{t_ranks:.1f} s, rank 0's laps "
        f"{ {k: round(v, 1) for k, v in ranks[0]['times'].items()} }), "
        f"peak allocated {res['peak']} bytes a rank, launches over both "
        f"ranks and the worker {launches} [{CARD}]")
    return launches, res



# ---------------------------------------------------------------------
# phase 2c: K9, decode over a head_dim-split cache, pass by pass
# ---------------------------------------------------------------------

#: K9's checked instances: (label, query heads, kv heads, head_dim, model
#: ranks m, window, timed).  hymba-1.5b's (1, 2) plan on the XLA decode
#: (26 / 13 padded heads: (G, D / m) = (2, 32)) and its (1, 4) plan (28 /
#: 7: (4, 16)), hymba's unpadded group of 5 split 2 and 4 ways, and
#: qwen3-8b's widths split 2 ways (4, 64)
SPLIT_CASES = (("hymba12", 26, 13, 64, 2, 1024, True),
               ("hymba14", 28, 7, 64, 4, 1024, False),
               ("g5m2", 25, 5, 64, 2, 0, True),
               ("g5m4", 25, 5, 64, 4, 1024, False),
               ("qwen3m2", 32, 8, 128, 2, 0, True))
SPLIT_B, SPLIT_S, SPLIT_BL, SPLIT_N = 8, 2048, 256, 64
#: K9 against its plain passes, row by row (one (slot, head)'s scores
#: over the cache rows in pass 1; one head's context columns for one
#: query in pass 2 and joined): fp32 scores and an fp32 softmax on both
#: sides, the output rounded to bf16 on both, as the fused decode's
TOL["decode_split"] = 3e-3


def split_kernel_phase(torch, dev):
    """K9 at full width, for each of :data:`SPLIT_CASES`, dense and
    paged: every rank's pass 1 over its columns against the plain pass
    1, the ranks' scores summed as the all-reduce sums them, every rank's
    pass 2 on those scores against the plain pass 2, and the ranks'
    columns joined against the plain unsharded decode; the planted
    faults, a 16-byte column chunk dropped from one rank's pass 1 and
    (paged) table entries 0 and 1 swapped in one rank's pass 2, must
    fail the joined check.  Each pass takes what the same tree's passes
    give it (the score buffer's layout is the tree's: ``--src`` runs a
    parent's), so the turns compare trees on the same q, cache and
    lengths.  The timed cases' rank-0 passes run in turns (:data:`TURNS`
    rounds of CUDA-graph device time) with the unsharded decode kernel
    at the same widths, dense pass 1 one ``torch.matmul`` of the same
    slice products, and one trivial graph-captured launch (a one-element
    add: the harness's fixed cost a launch), beside the byte bounds of
    what the inputs need: the slices' live rows, and each slot's live
    scores once."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ops
    g = torch.Generator(dev).manual_seed(SEED + 9)
    tol = TOL["decode_split"]
    B, S, bl, N = SPLIT_B, SPLIT_S, SPLIT_BL, SPLIT_N
    nb = S // bl
    worst = {"decode_split_scores": [0.0, 0.0],
             "decode_split_context": [0.0, 0.0], "joined": 0.0}
    controls = {"drop_chunk": [], "swap_entry": []}
    timing = {}
    one = torch.zeros(1, device=dev)
    for label, Hq, Kv, Dh, m, W, timed in SPLIT_CASES:
        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev).to(
                torch.bfloat16)
        q = rnd(B, Hq, Dh)
        k, v = rnd(B, S, Kv, Dh), rnd(B, S, Kv, Dh)
        kp, vp = rnd(N, bl, Kv, Dh), rnd(N, bl, Kv, Dh)
        lens = torch.randint(1, S + 1, (B,), generator=g, device=dev,
                             dtype=torch.int32)
        lens[0], lens[1] = 1, S
        tbl = torch.randperm(N, generator=g, device=dev).reshape(
            B, nb).to(torch.int32)
        used = torch.arange(nb, device=dev)[None] * bl < lens[:, None]
        tbl = torch.where(used, tbl, -1).contiguous()
        DS, scale = Dh // m, Dh ** -0.5
        cols = [slice(r * DS, (r + 1) * DS) for r in range(m)]
        for paged in (False, True):
            kk, vv, tb = (kp, vp, tbl) if paged else (k, v, None)
            want = (dec.paged_decode_attention_plain(
                q, kp, vp, tbl, cache_len=lens, window=W) if paged else
                dec.decode_attention_plain(q, k, v, cache_len=lens,
                                           window=W))
            qs = [q[..., c].contiguous() for c in cols]
            ks = [kk[..., c].contiguous() for c in cols]
            vs = [vv[..., c].contiguous() for c in cols]
            kw = dict(cache_len=lens, window=W)
            sc = []
            for r in range(m):
                got = dec.decode_split_scores(qs[r], ks[r], tb, scale=scale,
                                              **kw)
                ref = dec.decode_split_scores_plain(qs[r], ks[r], tb,
                                                    scale=scale, **kw)
                e, rel = row_err(torch, got, ref)
                check(rel <= tol, f"K9 scores {label} paged={paged} rank "
                      f"{r}: row rel {rel} > {tol}")
                w = worst["decode_split_scores"]
                w[0], w[1] = max(w[0], e), max(w[1], rel)
                sc.append(got)
            s = torch.stack(sc).sum(0)
            ctx = []
            for r in range(m):
                got = dec.decode_split_context(s, vs[r], tb, **kw)
                ref = dec.decode_split_context_plain(s, vs[r], tb, **kw)
                e, rel = row_err(torch, got, ref)
                check(rel <= tol, f"K9 context {label} paged={paged} rank "
                      f"{r}: row rel {rel} > {tol}")
                w = worst["decode_split_context"]
                w[0], w[1] = max(w[0], e), max(w[1], rel)
                ctx.append(got)
            _, rel = row_err(torch, torch.cat(ctx, -1), want)
            check(rel <= tol, f"K9 {label} paged={paged}: the ranks' "
                  f"columns joined against the unsharded plain decode, "
                  f"row rel {rel} > {tol}")
            worst["joined"] = max(worst["joined"], rel)
            # planted faults: each must fail the joined row check
            bad = dec.decode_split_scores(qs[0], ks[0], tb, scale=scale,
                                          drop_chunk=0, **kw)
            sbad = s - sc[0] + bad
            controls["drop_chunk"].append(control(
                "decode_split", f"{label} paged={paged}: a column chunk "
                "dropped from rank 0's pass 1", torch, torch.cat(
                    [dec.decode_split_context(sbad, vs[r], tb, **kw)
                     for r in range(m)], -1), want))
            if paged:
                swapped = [dec.decode_split_context(s, vs[0], tb,
                                                    swap_entry=True, **kw)]
                controls["swap_entry"].append(control(
                    "decode_split", f"{label}: table entries 0 and 1 "
                    "swapped in rank 0's pass 2", torch,
                    torch.cat(swapped + ctx[1:], -1), want))
            if not timed:
                continue
            lo = (lens - W).clamp_min(0) if W else torch.zeros_like(lens)
            live = int((torch.minimum(lens, torch.full_like(lens, S))
                        - lo).sum())
            fns = {"scores": functools.partial(
                       dec.decode_split_scores, qs[0], ks[0], tb,
                       scale=scale, **kw),
                   "context": functools.partial(
                       dec.decode_split_context, s, vs[0], tb, **kw)}
            if dec.takes_group(Hq // Kv, Dh):
                fns["unsharded"] = (
                    functools.partial(dec.paged_decode_attention, q, kp, vp,
                                      tbl, **kw) if paged else
                    functools.partial(dec.decode_attention, q, k, v, **kw))
            if not paged:
                qg = qs[0].reshape(B, Kv, Hq // Kv, DS)
                kt = ks[0].permute(0, 2, 3, 1).contiguous()
                fns["matmul"] = functools.partial(torch.matmul, qg, kt)
            fns["launch"] = functools.partial(one.add_, 1.0)
            med, rounds = in_turns(torch, fns, graph_ms)
            pmed, _ = in_turns(torch, {
                "scores": functools.partial(
                    dec.decode_split_scores_plain, qs[0], ks[0], tb,
                    scale=scale, **kw),
                "context": functools.partial(
                    dec.decode_split_context_plain, s, vs[0], tb, **kw)})
            b_sc = work_bound(dec.split_scores_work(B, Hq, Kv, DS, live),
                              PEAK_FP32)
            b_cx = work_bound(dec.split_context_work(B, Hq, Kv, DS, live),
                              PEAK_FP32)
            timing[(label, paged)] = {
                "scores_ms": med["scores"], "context_ms": med["context"],
                "unsharded_ms": med.get("unsharded"),
                "matmul_ms": med.get("matmul"), "launch_ms": med["launch"],
                "scores_cols": int(sc[0].shape[-1]),
                "plain_scores_ms": pmed["scores"],
                "plain_context_ms": pmed["context"],
                "bound_scores_ms": b_sc[0], "bound_context_ms": b_cx[0],
                "bound_by": b_sc[1], "live_rows": live,
                "rounds": {n: r for n, r in rounds.items()}}
            log(f"timing K9 {label} ({Hq}/{Kv} x {Dh} over {m} ranks: "
                f"{DS} columns) {'paged' if paged else 'dense'}: pass 1 "
                f"{med['scores']:.4f} ms (bound {b_sc[0]:.4f}, plain "
                f"{pmed['scores']:.4f}), pass 2 {med['context']:.4f} ms "
                f"(bound {b_cx[0]:.4f}, plain {pmed['context']:.4f}), the "
                f"unsharded decode kernel {med.get('unsharded')}, "
                f"torch.matmul of the slice products {med.get('matmul')}, "
                f"one trivial launch {med['launch']:.4f} ms, in turns of "
                f"{TURNS}; score buffer {tuple(sc[0].shape)} [{CARD}]")
        log(f"kernel K9 {label} ({Hq}/{Kv} x {Dh}, m = {m}, window {W}): "
            f"passes dense and paged held at {tol} [{CARD}]")
    head = timing[("hymba12", False)]
    headp = timing[("hymba12", True)]
    src = "src/repro_torch/kernels/csrc/decode_split.cu"
    shape = (f"B={B} S={S} (paged: {N} blocks of {bl}) H=26 K=13 D=64 "
             "over 2 ranks (32 columns), window 1024: hymba-1.5b's (1, 2) "
             "plan on the XLA decode; rank 0's launch")
    turns = {f"{lb} {'paged' if p else 'dense'}": t
             for (lb, p), t in timing.items()}
    out = {
        "decode_split_scores": dict(
            route="cuda", source=src,
            replaces="src/repro/models/lm.py:697 (the head_dim-split "
                     "decode through attention_decode, "
                     "src/repro/models/attention.py:171)",
            max_abs_err=worst["decode_split_scores"][0],
            row_rel_err=worst["decode_split_scores"][1], tolerance=tol,
            control_row_rel_err=min(controls["drop_chunk"]),
            kernel_check_row_rel_err=worst["joined"],
            ms=head["scores_ms"], plain_ms=head["plain_scores_ms"],
            bound_ms=head["bound_scores_ms"], bound_by=head["bound_by"],
            library_ms=head["matmul_ms"], launch_ms=head["launch_ms"],
            shape=shape, shapes=turns,
            library_call="torch.matmul of the rank's (B, K, G, 32) query "
                         "slices with its (B, K, 32, S) key slices (every "
                         "row; the kernel reads only the live ones)"),
        "decode_split_context": dict(
            route="cuda", source=src,
            replaces="src/repro/models/lm.py:697 (the head_dim-split "
                     "decode through attention_decode_paged, "
                     "src/repro/models/attention.py:195)",
            max_abs_err=worst["decode_split_context"][0],
            row_rel_err=worst["decode_split_context"][1], tolerance=tol,
            control_row_rel_err=min(controls["swap_entry"]),
            kernel_check_row_rel_err=worst["joined"],
            ms=headp["context_ms"], plain_ms=headp["plain_context_ms"],
            bound_ms=headp["bound_context_ms"], bound_by=headp["bound_by"],
            library_ms=None, launch_ms=headp["launch_ms"],
            shape=shape.replace("rank 0's launch",
                                                 "rank 0's launch, paged"),
            shapes=turns,
            library_call="none: no library call takes a block table")}
    ops.reset_launch_counts()       # comparison launches do not count
    # torch.matmul captured in a CUDA graph leaves a cuBLAS workspace
    # (32 MiB on this card) allocated for each stream it ran on; they
    # would sit in every later phase's peak (the train phase's estimate
    # check), so they are released here
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    return out


# ---------------------------------------------------------------------
# phases 24e and 24f: several data axes, and a cache split on head_dim
# ---------------------------------------------------------------------

#: 24e: the production mesh's axes cut to one card's four ranks
POD_MESH = (2, 2, 1)
POD_AXES = ("pod", "data", "model")
#: each of the four ranks may allocate this share of the card
POD_FRACTION = 0.2
#: 24e serving: hymba-1.5b's decode plan, two requests a data shard
#: (one prompt past the 1,024 window), 8 tokens each
POD_SERVE = ("serve_h100", "decode", 2048, 8)
POD_PROMPTS, POD_TOKENS = (1100, 300, 160, 96, 700, 512, 257, 64), 8
#: 24e training: hymba-1.5b at full width cut to this depth, one
#: sequence a rank (its per-rank estimate ~5.7 GiB: four ranks' whole
#: state ~23 GiB of the card), under the post-reduce error feedback and
#: under the wire (``grad_compression="on"``: wire_dp = pod x data = 4)
POD_TRAIN_SHAPE = ("mesh_pod", "train", 2048, 4)
POD_TRAIN_LAYERS, POD_TRAIN_STEPS = 2, MESH_TRAIN_STEPS
#: 24f: hymba-1.5b's (1, 2) plan on the XLA decode (kv heads 13 padded
#: do not split two ways, so the cache splits on head_dim), dense and
#: paged, the prompts of phase 24c
HEAD_DIM_SERVE = ("serve_h100", "decode", 2048, 8)


def _served_on_mesh(torch, dev, mesh, arch, plan, prompts, new_tokens):
    """One rank's engine of ``plan`` on ``mesh``, built from the rank's
    pieces, the prompts served: its launches, tokens, first logits,
    decode path, split and peak."""
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.sharded import param_pieces
    params = lm.init_params(arch, torch.Generator(dev).manual_seed(SEED),
                            *plan.padded_sizes(),
                            pieces=param_pieces(mesh, plan, arch))
    torch.cuda.reset_peak_memory_stats()
    eng = _recording_engine(ServeEngine).from_plan(plan, params, arch=arch,
                                                   mesh=mesh)
    del params
    for p in prompts:
        eng.submit(p, max_new_tokens=new_tokens)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run_until_idle(max_ticks=4096)
    torch.cuda.synchronize()
    out = {"launches": ops.launch_counts(), "s": time.perf_counter() - t0,
           "first": eng.first, "path": eng.decode_path,
           "split": eng.cfg.kv_split, "groups": eng.pool_groups,
           "cache": {k: tuple(v.shape) for k, v in eng.cache.items()},
           "tokens": {r.rid: list(r.out_tokens) for r in done},
           "ticks": eng.tick, "peak": torch.cuda.max_memory_allocated()}
    del eng
    torch.cuda.empty_cache()
    return out


def _one_rank_served(torch, dev, arch, plan, one, prompts, new_tokens):
    """The one-rank engine of ``one`` (``plan``'s padded sizes, no host
    tier, no prefix reuse): tokens, margins, first logits, path."""
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine
    params = lm.init_params(arch, torch.Generator(dev).manual_seed(SEED),
                            *plan.padded_sizes())
    eng = _recording_engine(ServeEngine).from_plan(
        one, params, arch=arch, kv_host_blocks=0, kv_prefix_reuse="off")
    for p in prompts:
        eng.submit(p, max_new_tokens=new_tokens)
    done = eng.run_until_idle(max_ticks=4096)
    out = ({r.rid: list(r.out_tokens) for r in done}, eng.margins,
           eng.first, eng.decode_path)
    del eng, params
    torch.cuda.empty_cache()
    return out


def _mesh_served_checks(torch, what, recs, one):
    """Every rank's tokens equal, and each rank's first-token logits
    within :data:`FULL_TOL` rms-relative of the one-rank engine's (beside
    another request's, which must not be), its tokens by the margin
    rule.  Returns the rank-0 summary."""
    want, margins, first, one_path = one
    r0 = recs[0]
    rels = []
    for r, o in enumerate(recs):
        check(o["tokens"] == r0["tokens"], f"{what}: rank {r}'s tokens "
              "differ from rank 0's")
        rel = {rid: _rms_rel(torch, o["first"][rid], row)
               for rid, row in first.items()}
        rels.append(max(rel.values()))
        wrong = _rms_rel(torch, o["first"][1], first[0])
        check(max(rel.values()) <= FULL_TOL < wrong,
              f"{what}: rank {r} first logits {rel}, control {wrong}")
    compared, splits = _margin_rule(what, r0["tokens"], want, margins)
    return {"path": r0["path"], "split": r0["split"], "one_path": one_path,
            "first_logits_rms_rel": rels, "tokens_compared": compared,
            "tokens": sum(len(t) for t in want.values()), "splits": splits,
            "s": [o["s"] for o in recs], "peak": [o["peak"] for o in recs],
            "ticks": r0["ticks"], "cache": r0["cache"]}


def _prompts_of(arch, lens, seed):
    import numpy as np
    rng = np.random.default_rng(SEED + seed)
    return [rng.integers(0, arch.vocab_size, n).astype(np.int32)
            for n in lens]


def pod_plans(grad_compression=None):
    """24e's plans of hymba-1.5b on :data:`POD_MESH`: ``(arch, serve
    plan, one-rank serve plan)`` and ``(cut arch, train plan, one-rank
    train plan)`` (``grad_compression="on"``: the wire)."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core import specialize
    arch = get_arch("hymba-1.5b")
    kw = dict(mesh_axes=POD_AXES, mesh_shape=POD_MESH, target="h100-sxm",
              cache=False)
    splan = specialize(arch, ShapeConfig(*POD_SERVE), **kw)
    sone = specialize(arch, ShapeConfig(*POD_SERVE), mesh_shape=(1, 1),
                      target="h100-sxm", cache=False)
    sone = dataclasses.replace(sone, estimates={
        **sone.estimates, **{k: splan.estimates[k] for k in PADDED_KEYS
                             if k in splan.estimates}})
    cut = dataclasses.replace(arch, n_layers=POD_TRAIN_LAYERS)
    tshape = ShapeConfig(*POD_TRAIN_SHAPE)
    gc_kw = {} if grad_compression is None else {
        "grad_compression": grad_compression}
    tplan = specialize(cut, tshape, **kw, **gc_kw)
    return (arch, splan, sone), (cut, tplan, tshape)


def _pod_rank(rank: int, tmp: str, src: str) -> None:
    """One of phase 24e's four ranks on ``cuda:0`` over gloo, held to
    :data:`POD_FRACTION` of the card, on the ``(pod, data, model)`` mesh
    :data:`POD_MESH`: hymba-1.5b served; the last layer's gradients of
    the cut train plan (the rank's share of the batch mean, summed over
    the four ranks on the host; the rank's share alone as the planted
    control); the fit under the post-reduce error feedback, then under
    the wire."""
    import datetime
    import os
    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.cuda.set_device(0)
    torch.cuda.set_per_process_memory_fraction(POD_FRACTION, 0)
    dev = torch.device("cuda", 0)
    out = {}
    try:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                rank=rank, world_size=4,
                                timeout=datetime.timedelta(seconds=600))
        mesh = init_device_mesh("cuda", POD_MESH, mesh_dim_names=POD_AXES)
        t0, out["times"] = time.perf_counter(), {}
        (arch, splan, _), (cut, tplan, tshape) = pod_plans()
        out["serve"] = _served_on_mesh(
            torch, dev, mesh, arch, splan,
            _prompts_of(arch, POD_PROMPTS, 11), POD_TOKENS)
        out["times"]["serve"] = time.perf_counter() - t0
        batches = _mesh_batches(cut, tshape)
        tr, state = _mesh_trainer(torch, dev, tplan, cut, tshape, mesh)
        lay = tr.step_def.layout
        b0 = {k: lay.batch_rows(v, 0)
              for k, v in _on_dev(torch, batches[0], dev).items()}
        loss, share = _layer_grads(torch, cut, state["params"], b0,
                                   tr.step_def.cfg, lay)
        summed = {}
        for n, g in share.items():
            t = g.clone()
            dist.all_reduce(t)
            summed[n] = t
        out["grads"] = (loss, summed)
        out["grads_share"] = share
        out["layout"] = (lay.batch_axes, lay.batch_index, lay.batch_count)
        del tr, state
        torch.cuda.empty_cache()
        out["times"]["grads"] = time.perf_counter() - t0
        out["ef"] = _mesh_fit(torch, dev, tplan, cut, tshape, mesh,
                              steps=POD_TRAIN_STEPS)[2]
        torch.cuda.empty_cache()
        out["times"]["ef"] = time.perf_counter() - t0
        _, (_, wplan, _) = pod_plans("on")
        out["wire"] = _mesh_fit(torch, dev, wplan, cut, tshape, mesh,
                                steps=POD_TRAIN_STEPS)[2]
        out["times"]["wire"] = time.perf_counter() - t0
    except Exception:
        import traceback
        out["error"] = traceback.format_exc()[-4000:]
    torch.save(out, os.path.join(tmp, f"r{rank}.pt"))
    if dist.is_initialized():
        dist.destroy_process_group()


def _spawn_ranks(torch, target, n: int, what: str, timeout: int = 600):
    """``target(rank, tmp, src)`` on ``n`` spawned ranks; their records
    (a rank that left none, or an error, fails the run)."""
    import tempfile

    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=target,
                             args=(r, tmp, str(SRC_IN_USE)))
                 for r in range(n)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=timeout)
            if p.is_alive():
                p.kill()
                p.join()
        ranks = []
        for r, p in enumerate(procs):
            path = Path(tmp) / f"r{r}.pt"
            check(path.exists(), f"{what}: rank {r} left no result "
                  f"(exit {p.exitcode})")
            ranks.append(torch.load(path, weights_only=False))
    for r, out in enumerate(ranks):
        check("error" not in out, f"{what}: rank {r} failed: "
              f"{out.get('error')}")
    return ranks


def pod_mesh_phase(torch, dev):
    """Phase 24e: four ranks spawned on ``cuda:0`` over gloo on the
    production mesh's axes cut to :data:`POD_MESH` ``(pod, data,
    model)``, each held to :data:`POD_FRACTION` of the card.  Serving:
    hymba-1.5b at full width and depth from its decode plan (the batch
    and a 2-D pool over the linearised ``(pod, data)`` data group, two
    requests a data shard), each rank's tokens and first-token logits
    held against one rank's engine on the same plan.  Training:
    hymba-1.5b cut to :data:`POD_TRAIN_LAYERS` layers, one sequence a
    rank: the last layer's gradients summed over the ranks against one
    rank's on the whole batch (the rank's share alone and a wrong target
    as controls), the fit under the post-reduce error feedback (an fp32
    sum over ``(pod, data)``, then ``ef_compress``) and under the wire
    (``wire_dp = 4``), losses and grad norms held against one rank's fit
    of the same plan.  Returns ``(launches over the four ranks, the
    results)``."""
    import os
    t0 = time.perf_counter()
    (arch, splan, sone), (cut, tplan, tshape) = pod_plans()
    _, (_, wplan, _) = pod_plans("on")
    gib = 2 ** 30
    check(tplan.axis_rules["batch"] == ("pod", "data")
          and tplan.comm.compress_pod_grads and wplan.comm.compress_grads,
          f"pod mesh: the train plans' batch rule "
          f"{tplan.axis_rules['batch']}")
    log(f"pod mesh: hymba-1.5b on {POD_MESH} {POD_AXES}: serve plan "
        f"{splan.estimates.get('kv_residency')}, train at depth "
        f"{cut.n_layers} {tplan.estimates['strategy']} estimate "
        f"{tplan.estimates['step_peak_bytes'] / gib:.3f} GiB a rank "
        f"(four ranks {4 * tplan.estimates['step_peak_bytes'] / gib:.3f} "
        f"GiB), the wire's {wplan.estimates['step_peak_bytes'] / gib:.3f} "
        f"GiB, wire_dp {wplan.estimates.get('grad_compress_lowered')} "
        f"[{CARD}]")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    ranks = _spawn_ranks(torch, _pod_rank, 4, "pod mesh")
    t_ranks = time.perf_counter() - t0
    res = {"ranks_s": t_ranks, "rank_laps_s": ranks[0]["times"]}
    # serving against one rank
    prompts = _prompts_of(arch, POD_PROMPTS, 11)
    one = _one_rank_served(torch, dev, arch, splan, sone, prompts,
                           POD_TOKENS)
    res["serve"] = _mesh_served_checks(torch, "pod mesh: serve",
                                       [o["serve"] for o in ranks], one)
    r0 = ranks[0]["serve"]
    check(r0["groups"] == 4 and r0["path"] == "shard_map_flash_paged_2d",
          f"pod mesh: serve path {r0['path']}, {r0['groups']} sub-pools")
    launches = {k: 0 for k in ("flash_attention", "paged_decode_partial",
                               "ssd_scan", "flash_attention_bwd",
                               "ssd_scan_bwd")}
    for o in ranks:
        c = o["serve"]["launches"]
        check(c["flash_attention"] > 0 and c["paged_decode_partial"] > 0
              and c["ssd_scan"] > 0, f"pod mesh: serve launched {c}")
        for k in ("flash_attention", "paged_decode_partial", "ssd_scan"):
            launches[k] += c[k]
    s = res["serve"]
    log(f"pod mesh: serve hymba-1.5b {len(POD_PROMPTS)} requests x "
        f"{POD_TOKENS} tokens on {POD_MESH}: path {s['path']} (one rank "
        f"{s['one_path']}), 4 data shards' sub-pools, {s['tokens_compared']}"
        f" of {s['tokens']} tokens equal the one-rank engine's before the "
        f"first margin-rule split {s['splits']}, first-token logits "
        f"rms-relative {fmt(s['first_logits_rms_rel'])} a rank (bound "
        f"{FULL_TOL}), {fmt(s['s'])} s a rank, peak {s['peak']} bytes "
        f"[{CARD}]")
    # training against one rank
    for o in ranks:
        check(o["layout"][0] == ("pod", "data") and o["layout"][2] == 4,
              f"pod mesh: a rank's batch layout {o['layout']}")
    check(sorted(o["layout"][1] for o in ranks) == [0, 1, 2, 3],
          "pod mesh: the ranks' batch slices are not 0..3")
    batches = _mesh_batches(cut, tshape)
    anchor = _mesh_anchor(torch, dev, tplan, cut, tshape, batches)
    loss_tol = max(MESH_LOSS_MIN, 4 * abs(
        anchor["fit"]["hist"][0][0] - anchor["plain_loss"]) / abs(
            anchor["plain_loss"]))
    want = anchor["grads"][1]
    got = {n: grad_row_err(torch, g, want[n])[1]
           for n, g in ranks[0]["grads"][1].items()}
    share = {n: grad_row_err(torch, g, want[n])[1]
             for n, g in ranks[0]["grads_share"].items()}
    wrong = {n: grad_row_err(torch, anchor["wrong_grads"][1][n], want[n])[1]
             for n in want}
    log(f"pod mesh: train the last layer's gradients at depth "
        f"{cut.n_layers}, summed over the four ranks against one rank, "
        f"worst row rel {max(got.values()):.3e} (tol {MESH_GRAD_TOL}); "
        f"controls: the rank's share alone {max(share.values()):.3e}, a "
        f"wrong target {max(wrong.values()):.3e} [{CARD}]")
    check(max(got.values()) <= MESH_GRAD_TOL,
          f"pod mesh: gradients {got}")
    check(max(share.values()) > MESH_GRAD_TOL,
          f"pod mesh: the unsummed-share control passed {share}")
    check(max(wrong.values()) > MESH_GRAD_TOL,
          f"pod mesh: the wrong-target control passed {wrong}")
    peaks = {}
    for r, out in enumerate(ranks):
        for k, wire in (("ef", 0), ("wire", 4)):
            o = out[k]
            check(o["wire"] == wire and o["ef"],
                  f"pod mesh: rank {r} {k}: wire {o['wire']} ef {o['ef']}")
            _mesh_track(f"pod {k} rank {r}", o, anchor["fit"], loss_tol)
            peaks[f"rank{r}/{k}"] = (o["peak"], o["estimate"],
                                     o["estimate"] / o["peak"])
            log(f"pod mesh: rank {r} {k}: peak allocated {o['peak']} bytes"
                f", estimate {o['estimate']:.0f} ({o['estimate'] / o['peak']:.4f}"
                f" x the peak), {POD_TRAIN_STEPS} steps in {o['s']:.2f} s "
                f"[{CARD}]")
            check(o["peak"] <= o["estimate"] <= MESH_PEAK_SLACK * o["peak"],
                  f"pod mesh: rank {r} {k} peak {o['peak']} against its "
                  f"estimate {o['estimate']}")
            for name in ("flash_attention_bwd", "ssd_scan_bwd",
                         "flash_attention", "ssd_scan"):
                check(o["launches"][name] > 0, f"pod mesh: rank {r} {k} "
                      f"launched {name} no time")
                launches[name] += o["launches"][name]
    res["train"] = {"n_layers": cut.n_layers, "grad_row_rel": got,
                    "controls": {"share_alone": share, "wrong_target": wrong},
                    "loss_tol": loss_tol, "peaks": peaks,
                    "ef": [o["ef"]["hist"] for o in ranks],
                    "wire": [o["wire"]["hist"] for o in ranks],
                    "one_rank": anchor["fit"]["hist"],
                    "s": {k: [o[k]["s"] for o in ranks]
                          for k in ("ef", "wire")}}
    del anchor
    torch.cuda.empty_cache()
    res["launches"] = launches
    res["phase_s"] = time.perf_counter() - t0
    log(f"pod mesh: phase took {res['phase_s']:.1f} s (ranks "
        f"{t_ranks:.1f} s), launches over the four ranks {launches} "
        f"[{CARD}]")
    return launches, res


def head_dim_plans(residency):
    """24f's ``(arch, (1, 2) plan, one-rank plan)`` of hymba-1.5b at
    :data:`HEAD_DIM_SERVE`, ``residency`` ``"paged"`` or ``"dense"``: the
    (1, 2) plan on the XLA decode (the cache splits on head_dim); the
    one-rank plan carries its padded sizes."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core import specialize
    arch = get_arch("hymba-1.5b")
    shape = ShapeConfig(*HEAD_DIM_SERVE)
    kw = {} if residency == "paged" else {"kv_residency": "dense"}
    tp_plan = specialize(arch, shape, mesh_axes=("data", "model"),
                         mesh_shape=(1, 2), target="h100-sxm", cache=False,
                         decode_impl="xla", **kw)
    one = specialize(arch, shape, mesh_shape=(1, 1), target="h100-sxm",
                     cache=False, **kw)
    est = dict(one.estimates)
    est.update({k: tp_plan.estimates[k] for k in PADDED_KEYS
                if k in tp_plan.estimates})
    return arch, tp_plan, dataclasses.replace(one, estimates=est)


def _head_dim_rank(rank: int, tmp: str, src: str) -> None:
    """One of phase 24f's two ranks on ``cuda:0`` over gloo, held to
    :data:`MESH_TRAIN_FRACTION` of the card: hymba-1.5b's (1, 2)
    head_dim-split engine served, dense then paged."""
    import datetime
    import os
    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.cuda.set_device(0)
    torch.cuda.set_per_process_memory_fraction(MESH_TRAIN_FRACTION, 0)
    dev = torch.device("cuda", 0)
    out = {}
    try:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                rank=rank, world_size=2,
                                timeout=datetime.timedelta(seconds=600))
        mesh = init_device_mesh("cuda", (1, 2),
                                mesh_dim_names=("data", "model"))
        for residency in ("dense", "paged"):
            arch, plan, _ = head_dim_plans(residency)
            out[residency] = _served_on_mesh(
                torch, dev, mesh, arch, plan, _ssm_mesh_prompts(arch),
                SSM_MESH_TOKENS)
    except Exception:
        import traceback
        out["error"] = traceback.format_exc()[-4000:]
    torch.save(out, os.path.join(tmp, f"r{rank}.pt"))
    if dist.is_initialized():
        dist.destroy_process_group()


def _score_reduce_bytes(arch, plan, cache):
    """The bytes of K9's score buffer that the all-reduce moves a layer,
    ``B * H * Wc * 4``, by the layers' window (``"global"`` or
    ``"window <w>"``: their count and bytes), from the engine's cache
    shapes and the tree's own buffer rule (a tree before the compact
    buffer scores every row: ``Wc`` is the view's capacity)."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.models import lm
    k = cache["k"]                  # (L, B, S, K, DS) or (L, N, bl, K, DS)
    tbl = cache.get("block_tbl")
    B, cap = (tbl[0], tbl[1] * k[2]) if tbl else (k[1], k[2])
    H = plan.padded_sizes()[1] or arch.n_heads
    cols = getattr(dec, "split_cols", lambda c, w: c)
    out = {}
    for w in lm._window_schedule(arch):
        name = f"window {w}" if w else "global"
        n, _ = out.get(name, (0, 0))
        out[name] = (n + 1, B * H * cols(cap, w) * 4)
    return {name: {"layers": n, "bytes": b} for name, (n, b) in out.items()}


def head_dim_phase(torch, dev):
    """Phase 24f: two ranks spawned on ``cuda:0`` over gloo serve
    hymba-1.5b at full width and depth from its (1, 2) plan on the XLA
    decode, whose cache splits on head_dim (each rank 32 of every kv
    head's 64 columns), dense and paged, with the window layers and the
    global layers (one prompt past the window): every decode tick runs
    K9's two passes a layer around an all-reduce of the scores.  Each
    rank's tokens and first-token logits are held against one rank's
    engine on the same padded sizes, and K9's launches are counted.
    Returns ``(K9's launches over both ranks, the results)``."""
    import os
    t0 = time.perf_counter()
    for residency in ("dense", "paged"):
        arch, plan, _ = head_dim_plans(residency)
        check(plan.placements["cache.k"].spec[4] == "model",
              f"head_dim: the (1, 2) {residency} plan's cache is "
              f"{plan.placements['cache.k'].spec}")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    ranks = _spawn_ranks(torch, _head_dim_rank, 2, "head_dim")
    t_ranks = time.perf_counter() - t0
    res = {"ranks_s": t_ranks}
    launches = {"decode_split_scores": 0, "decode_split_context": 0,
                "flash_attention": 0, "ssd_scan": 0}
    L = arch.n_layers
    for residency in ("dense", "paged"):
        arch, plan, one_plan = head_dim_plans(residency)
        prompts = _ssm_mesh_prompts(arch)
        one = _one_rank_served(torch, dev, arch, plan, one_plan, prompts,
                               SSM_MESH_TOKENS)
        recs = [o[residency] for o in ranks]
        r = _mesh_served_checks(torch, f"head_dim {residency}", recs, one)
        check(r["split"] == "head_dim" and r["path"] == "decode_split:cuda",
              f"head_dim {residency}: split {r['split']}, path {r['path']}")
        check(r["cache"]["k"][-1] == arch.hd // 2,
              f"head_dim {residency}: cache piece {r['cache']['k']}")
        for o in recs:
            c = o["launches"]
            check(c["decode_split_scores"] == c["decode_split_context"] > 0
                  and c["decode_split_scores"] % L == 0
                  and c["paged_decode_attention"] == 0
                  and c["decode_attention"] == 0,
                  f"head_dim {residency}: a rank launched {c}")
            for k in launches:
                launches[k] += c[k]
        r["launches"] = [o["launches"] for o in recs]
        r["score_reduce_bytes"] = _score_reduce_bytes(arch, plan,
                                                      r["cache"])
        res[residency] = r
        log(f"head_dim: ({residency}) the score all-reduce a rank, bytes a "
            f"layer (B * H * Wc * 4, the tree's score buffer): "
            f"{r['score_reduce_bytes']} [{CARD}]")
        log(f"head_dim: ({residency}) hymba-1.5b full width, {L} layers, "
            f"(1, 2) plan on the XLA decode: path {r['path']} (one rank "
            f"{r['one_path']}), cache piece {r['cache']['k']}, "
            f"{r['tokens_compared']} of {r['tokens']} tokens equal the "
            f"one-rank engine's before the first margin-rule split "
            f"{r['splits']}, first-token logits rms-relative "
            f"{fmt(r['first_logits_rms_rel'])} a rank (bound {FULL_TOL}), "
            f"K9 launches a rank {recs[0]['launches']['decode_split_scores']}"
            f" a pass in {r['ticks']} ticks, {fmt(r['s'])} s a rank "
            f"[{CARD}]")
    res["launches"] = launches
    res["phase_s"] = time.perf_counter() - t0
    log(f"head_dim: phase took {res['phase_s']:.1f} s (ranks "
        f"{t_ranks:.1f} s), launches over both ranks {launches} [{CARD}]")
    return launches, res



# ---------------------------------------------------------------------
# phase 24g: the tools
# ---------------------------------------------------------------------

#: phase 24g's target seconds (a soft bar: printed, not held)
TOOLS_BUDGET_S = 60
#: the tiny LM's last loss, at most this far above log(vocab): its
#: synthetic tokens and targets are independent uniform draws, so no
#: model can beat log(vocab) on a fresh batch and its loss does not fall
#: (10.4831 -> 10.4959 in 30 steps, -> 10.5102 in 100, with log(32768)
#: = 10.3972); a step that diverges or goes non-finite leaves this band
TINY_LM_BAND = 0.25
#: the tools phase's subprocesses: (name, script, arguments, the line of
#: success); each runs alone, with the card, from the checkout's root
TOOLS_RUNS = (
    ("roundtrip", "scripts/torch_plan_roundtrip_smoke.py", (),
     "plan round-trip smoke OK"),
    ("chaos", "scripts/torch_serve_smoke.py", ("--chaos",),
     "serve chaos OK"),
    ("disagg", "scripts/torch_serve_smoke.py", ("--disagg",),
     "serve disagg OK"),
    ("tiny_lm", "examples/torch_train_tiny_lm.py", ("--steps", "100"),
     "final loss"),
)
TOOLS_DEADLINE_S = 600


def _tools_runs():
    """Start :data:`TOOLS_RUNS` together, each on the classic allocator
    segments a fresh process starts with (the disagg workers' CUDA IPC
    needs them), output to ``chiprun_out/tools_<name>.log``."""
    import os
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if k != "PYTORCH_CUDA_ALLOC_CONF"}
    env["PYTHONPATH"] = str(SRC_IN_USE)
    procs = {}
    for name, script, argv, _ in TOOLS_RUNS:
        path = out_dir / f"tools_{name}.log"
        f = open(path, "w")
        procs[name] = (subprocess.Popen(
            [sys.executable, str(ROOT / script), *argv], cwd=ROOT, env=env,
            stdout=f, stderr=subprocess.STDOUT), f, path)
    return procs


def _tools_wait(procs, t0: float):
    """Each run's exit code, seconds and last lines; a run past
    :data:`TOOLS_DEADLINE_S` is killed and fails the phase."""
    out = {}
    for name, script, argv, ok_line in TOOLS_RUNS:
        p, f, path = procs[name]
        try:
            rc = p.wait(timeout=max(1.0, TOOLS_DEADLINE_S
                                    - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            p.kill()
            rc = p.wait()
        f.close()
        lines = path.read_text().splitlines()
        out[name] = dict(rc=rc, s=time.perf_counter() - t0,
                         last=lines[-3:], ok=rc == 0 and any(
                             ok_line in ln for ln in lines))
        log(f"tools {name}: {script} {' '.join(argv)} rc={rc} after "
            f"{out[name]['s']:.1f} s; {lines[-1] if lines else ''} [{CARD}]")
        check(out[name]["ok"], f"tools {name}: {script} failed (rc {rc}): "
              f"{lines[-5:]}")
    return out


def tools_phase(torch, dev, paged=None, train=None):
    """Phase 24g: the tools.  (a) The dry run
    (:func:`repro_torch.launch.dryrun.run_cell`, fake tensors, nothing
    launched) of the plans phases 3 and 16 ran on the card: qwen3-8b's
    2048 x 8 paged decode plan on (1, 1), one tick, and its 2048 x 1
    train step at the depth that phase trained; each kernel entry's
    count in the dry run must equal the launches those phases counted a
    tick and a step (``paged`` / ``train``, their result dicts; without
    them, under ``--only tools``, the counts the plans imply: a decode
    launch a layer a tick, :func:`expected_train_launches`).  Printed,
    with no bar: the dry run's peak of live bytes and the plan's
    step-peak estimate beside the measured peak, the modelled step time
    beside the measured one.  (b)-(d), started first and run meanwhile
    in processes of their own: the plan round trip, the serve smoke's
    ``--chaos`` and ``--disagg`` modes at the script's reduced size, and
    the tiny LM's 100 steps, every logged loss finite and the last
    within :data:`TINY_LM_BAND` of log(vocab)."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core import specialize
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    procs = _tools_runs()
    before = ops.launch_counts()
    full = get_arch("qwen3-8b")
    res = {}
    # (a) the paged decode plan, one tick
    shape = ShapeConfig("serve_h100", "decode", 2048, 8)
    cell = dryrun.run_cell(full.name, shape.name, mesh_shape=(1, 1),
                           arch=full, shape=shape)
    check("roofline" in cell, f"tools: the decode dry run refused or "
          f"failed: {cell.get('skip_reason')}")
    got = {k: v["calls"] for k, v in cell["kernels"].items()}
    want = (paged["decode_launches_per_tick"] if paged is not None
            else {"paged_decode_attention": full.n_layers})
    log(f"tools dry run decode {full.name} 2048 x 8 (1, 1) plan "
        f"{cell['plan_hash'][:12]}: kernel calls {got} against the serve "
        f"phase's launches a tick {want}; {cell['trace_s']} s of trace, "
        f"fake tensors on {cell['fake_device']}")
    check(got == want, f"tools: the decode dry run's kernel calls {got} "
          f"are not the launches a tick {want}")
    r = cell["roofline"]
    tick_ms = (paged["wall_s"] / paged["decode_ticks"] * 1e3
               if paged is not None else None)
    log(f"tools finding decode: modelled tick {r['step_time_s'] * 1e3:.4f} "
        f"ms ({r['bottleneck']}; compute {r['compute_s'] * 1e3:.4f}, memory "
        f"{r['memory_s'] * 1e3:.4f} ms, h100-sxm data sheet) beside the "
        f"serve phase's wall time a decode tick {tick_ms} ms (host clock, "
        f"prefills included) [{CARD}]")
    res["decode"] = dict(plan=cell["plan_hash"], calls=got, want=want,
                         modelled_ms=r["step_time_s"] * 1e3,
                         measured_wall_ms_per_tick=tick_ms,
                         peak_live_bytes=cell["memory_analysis"][
                             "peak_estimate_per_device"],
                         hlo_flops=r["hlo_flops"], hlo_bytes=r["hlo_bytes"],
                         trace_s=cell["trace_s"])
    # (a) the train step at the depth phase 16 trained
    tshape = ShapeConfig("train_2k", "train", 2048, 1)
    if train is not None:
        arch = dataclasses.replace(full, n_layers=train["n_layers"])
        plan = specialize(arch, tshape, mesh_shape=(1, 1),
                          target="h100-sxm", plan_dir=PLAN_DIR)
    else:
        arch, plan = train_plan(specialize, full, tshape)
    cell = dryrun.run_cell(full.name, tshape.name, mesh_shape=(1, 1),
                           arch=arch, shape=tshape)
    check("roofline" in cell, f"tools: the train dry run refused or "
          f"failed: {cell.get('skip_reason')}")
    check(cell["plan_hash"] == plan.content_hash()
          and (train is None or train["plan"] == plan.content_hash()),
          "tools: the train dry run's plan is not the train phase's")
    got = {k: v["calls"] for k, v in cell["kernels"].items()}
    if train is not None:
        want = {k: n // TRAIN_STEPS for k, n in train["launches"].items()
                if n}
    else:
        want = {k: n for k, n in expected_train_launches(
            arch, plan.comm.remat_policy).items() if n}
    log(f"tools dry run train {full.name} at {arch.n_layers} layers 2048 x 1 "
        f"(remat {plan.comm.remat_policy}) plan {cell['plan_hash'][:12]}: "
        f"kernel calls {got} against the train phase's launches a step "
        f"{want}; {cell['trace_s']} s of trace")
    check(got == want, f"tools: the train dry run's kernel calls {got} are "
          f"not the launches a step {want}")
    r = cell["roofline"]
    peak = cell["memory_analysis"]["peak_estimate_per_device"]
    est = plan.estimates.get("step_peak_bytes")
    measured = train["peak_bytes"] if train is not None else None
    step_ms = train["step_ms"] if train is not None else None
    log(f"tools finding train: dry-run peak of live bytes {peak} B, the "
        f"plan's step-peak estimate {est} B, the train phase's measured "
        f"peak {measured} B; modelled step {r['step_time_s'] * 1e3:.2f} ms "
        f"({r['bottleneck']}; compute {r['compute_s'] * 1e3:.2f}, memory "
        f"{r['memory_s'] * 1e3:.2f} ms, h100-sxm data sheet) beside the "
        f"measured median step {step_ms} ms (host clock around a "
        f"synchronising step) [{CARD}]")
    res["train"] = dict(plan=cell["plan_hash"], n_layers=arch.n_layers,
                        calls=got, want=want, peak_live_bytes=peak,
                        plan_step_peak_bytes=est,
                        measured_peak_bytes=measured,
                        modelled_ms=r["step_time_s"] * 1e3,
                        measured_step_ms=step_ms, hlo_flops=r["hlo_flops"],
                        hlo_bytes=r["hlo_bytes"], trace_s=cell["trace_s"])
    check(ops.launch_counts() == before,
          "tools: the dry runs launched a kernel")
    # (b)-(d)
    res["runs"] = _tools_wait(procs, t0)
    text = procs["tiny_lm"][2].read_text()
    losses = [float(x) for x in re.findall(r"loss\s+(\S+)\s+\S+ ms", text)]
    m = re.search(r"final loss (\S+) \(first (\S+)\)", text)
    floor = math.log(32768)             # the example's vocab
    check(m is not None and all(math.isfinite(x) for x in losses)
          and abs(float(m.group(1)) - floor) <= TINY_LM_BAND,
          f"tools tiny_lm: losses {losses}, last {m and m.group(1)}, not "
          f"finite or not within {TINY_LM_BAND} of log(32768) = {floor:.4f}")
    res["tiny_lm_loss"] = dict(first=float(m.group(2)),
                               last=float(m.group(1)), logged=losses,
                               log_vocab=floor)
    log(f"tools finding tiny_lm: loss {res['tiny_lm_loss']['first']} -> "
        f"{res['tiny_lm_loss']['last']} over 100 steps of independent "
        f"random tokens and targets (log(32768) = {floor:.4f}) [{CARD}]")
    res["s"] = time.perf_counter() - t0
    log(f"tools phase took {res['s']:.1f} s (target {TOOLS_BUDGET_S} s) "
        f"[{CARD}]")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the port on one NVIDIA card")
    ap.add_argument("--only", choices=("flash_bwd", "flash_pos", "ssd_bwd",
                                       "matmul_fp32", "mesh", "mesh_train",
                                       "ssm_mesh", "mesh_tier", "pod_mesh",
                                       "head_dim", "k9", "tools"),
                    help="run this kernel's check alone and print its "
                         "result")
    ap.add_argument("--src", type=Path, default=SRC,
                    help="the src directory whose repro_torch runs")
    args = ap.parse_args(argv)
    global SRC_IN_USE
    SRC_IN_USE = args.src
    if not (args.src / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: no port package at {args.src / 'repro_torch'}; "
              "run from a checkout of the repository", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test runs only on an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src))
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 1: device and build ----
    global CARD
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    CARD = smi
    log(smi)
    log(f"device {torch.cuda.get_device_name(0)} count "
        f"{torch.cuda.device_count()} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    if args.only == "flash_bwd":
        import torch.nn.functional as F
        from repro_torch.kernels import flash_attention as fa
        log(json.dumps({"src": str(args.src), "card": CARD,
                        "flash_attention_bwd":
                            flash_bwd_check(torch, F, fa, dev)}))
        return 0
    if args.only == "flash_pos":
        import torch.nn.functional as F
        from repro_torch.kernels import build
        from repro_torch.kernels import flash_attention as fa
        res = flash_pos_check(torch, F, fa, dev)
        for name in ("flash_attention", "flash_attention_bwd"):
            for kernel, regs, spills in build.ptxas_entries(
                    build.PTXAS_LOG.get(name, "")):
                log(f"ptxas {name}: {kernel}: {regs} registers at entry, "
                    f"{spills} bytes of spills [{CARD}]")
        log(json.dumps({"src": str(args.src), "card": CARD,
                        "flash_positions": res}))
        return 0
    if args.only == "ssd_bwd":
        from repro_torch.kernels import build
        res = ssd_bwd_check(torch, dev)
        for name, text in build.PTXAS_LOG.items():
            for kernel, regs, spills in build.ptxas_entries(text):
                log(f"ptxas {name}: {kernel}: {regs} registers at entry, "
                    f"{spills} bytes of spills [{CARD}]")
        res["sass"] = sass_by_kernel(build.sass("ssd_scan_bwd"))
        for kernel, counts in res["sass"].items():
            log(f"sass ssd_scan_bwd: {kernel}: " + ", ".join(
                f"{n} {op}" for op, n in counts.items()) + " instructions "
                "(cuobjdump --dump-sass)")
        log(json.dumps({"src": str(args.src), "card": CARD,
                        "ssd_scan_bwd": res}))
        return 0
    if args.only == "matmul_fp32":
        from repro_torch.kernels import build
        res = matmul_fp32_check(torch, dev)
        for kernel, regs, spills in build.ptxas_entries(
                build.PTXAS_LOG.get("tiled_matmul", "")):
            log(f"ptxas tiled_matmul: {kernel}: {regs} registers at entry, "
                f"{spills} bytes of spills [{CARD}]")
        res["sass"] = sass_by_kernel(build.sass("tiled_matmul"), MM_SASS_OPS)
        for kernel, counts in res["sass"].items():
            log(f"sass tiled_matmul: {kernel}: " + ", ".join(
                f"{n} {op}" for op, n in counts.items()) + " instructions "
                "(cuobjdump --dump-sass)")
        log(json.dumps({"src": str(args.src), "card": CARD,
                        "tiled_matmul_fp32": res}))
        return 0
    from repro_torch.kernels import build, ops
    t0 = time.perf_counter()
    build.build_all()
    if args.only == "mesh":
        log(f"build: {time.perf_counter() - t0:.1f} s [{CARD}]")
        res = {"kernels": mesh_kernel_phase(torch, dev),
               "two_ranks": two_rank_phase(torch, dev)}
        log(json.dumps({"src": str(args.src), "card": CARD, "mesh": res}))
        return 0
    if args.only == "mesh_train":
        log(f"build: {time.perf_counter() - t0:.1f} s [{CARD}]")
        expandable_segments(torch)
        _, res = mesh_train_phase(torch, dev)
        log(json.dumps({"src": str(args.src), "card": CARD,
                        "mesh_train": res}))
        return 0
    if args.only == "ssm_mesh":
        log(f"build: {time.perf_counter() - t0:.1f} s [{CARD}]")
        expandable_segments(torch)
        _, res = ssm_mesh_phase(torch, dev)
        log(json.dumps({"src": str(args.src), "card": CARD,
                        "ssm_mesh": res}))
        return 0
    if args.only == "mesh_tier":
        log(f"build: {time.perf_counter() - t0:.1f} s [{CARD}]")
        _, res = mesh_tier_phase(torch, dev)
        log(json.dumps({"src": str(args.src), "card": CARD,
                        "mesh_tier": res}))
        return 0
    if args.only == "pod_mesh":
        log(f"build: {time.perf_counter() - t0:.1f} s [{CARD}]")
        expandable_segments(torch)
        _, res = pod_mesh_phase(torch, dev)
        log(json.dumps({"src": str(args.src), "card": CARD,
                        "pod_mesh": res}))
        return 0
    if args.only == "tools":
        log(json.dumps({"src": str(args.src), "card": CARD,
                        "tools": tools_phase(torch, dev)}, default=str))
        return 0
    if args.only in ("head_dim", "k9"):
        log(f"build: {time.perf_counter() - t0:.1f} s [{CARD}]")
        for kernel, regs, spills in build.ptxas_entries(
                build.PTXAS_LOG.get("decode_split", "")):
            log(f"ptxas decode_split: {kernel}: {regs} registers at entry, "
                f"{spills} bytes of spills [{CARD}]")
        kern = split_kernel_phase(torch, dev)
        if args.only == "k9":
            log(json.dumps({"src": str(args.src), "card": CARD, "k9": kern}))
            return 0
        expandable_segments(torch)
        _, res = head_dim_phase(torch, dev)
        log(json.dumps({"src": str(args.src), "card": CARD,
                        "k9": kern, "head_dim": res}))
        return 0
    log(f"build: {len(build.SOURCES)} sources with nvcc for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s [{CARD}]")
    ptxas = {name: build.ptxas_entries(text)
             for name, text in build.PTXAS_LOG.items()}
    for name, entries in ptxas.items():
        log(f"ptxas {name}: {len(entries)} kernels, registers <= "
            f"{max(r for _, r, _ in entries)}, "
            f"{sum(sp for _, _, sp in entries)} bytes of spill stores and "
            f"loads [{CARD}]")
        for kernel, regs, spills in entries:
            log(f"ptxas {name}: {kernel}: {regs} registers at entry, "
                f"{spills} bytes of spills [{CARD}]")
    for name in build.SOURCES:
        sass = build.sass(name)
        hgmma = len(re.findall(r"\bHGMMA\b", sass))
        utmaldg = len(re.findall(r"\bUTMALDG\b", sass))
        dmma = len(re.findall(r"\bDMMA\b", sass))
        log(f"sass {name}: {hgmma} HGMMA, {utmaldg} UTMALDG, {dmma} DMMA "
            f"instructions "
            f"(cuobjdump --dump-sass) [{CARD}]")
        if name in HOPPER_SOURCES:
            check(hgmma > 0 and utmaldg > 0,
                  f"{name}: its library has {hgmma} HGMMA and {utmaldg} "
                  "UTMALDG instructions; the kernel is built on wgmma fed "
                  "by TMA")

    # ---- phase 2: kernels ----
    kern, mm_checks = kernel_phase(torch, dev)
    # ---- phase 2b: K8, the decode kernels' per-shard partial ----
    t0 = time.perf_counter()
    kern.update(mesh_kernel_phase(torch, dev))
    log(f"mesh kernel phase took {time.perf_counter() - t0:.1f} s [{CARD}]")
    # ---- phase 2c: K9, decode over a head_dim-split cache ----
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    kern.update(split_kernel_phase(torch, dev))
    torch.cuda.synchronize()
    check(torch.cuda.memory_allocated() <= held,
          f"the K9 kernel phase left {torch.cuda.memory_allocated() - held} "
          "bytes allocated")
    log(f"K9 kernel phase took {time.perf_counter() - t0:.1f} s [{CARD}]")

    # ---- phases 3-4: serve ----
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core import specialize
    from repro_torch.core.passes.lowering import build_run_cfg
    from repro_torch.models import lm

    arch = get_arch("qwen3-8b")
    shape = ShapeConfig("serve_h100", "decode", 2048, 8)
    shutil.rmtree(PLAN_DIR, ignore_errors=True)
    plan = specialize(arch, shape, mesh_shape=(1, 1), target="h100-sxm",
                      plan_dir=PLAN_DIR)
    check(plan.estimates.get("kv_residency") == "paged",
          f"the h100 plan is not paged: {plan.estimates.get('kv_residency')}")
    t0 = time.perf_counter()
    params = lm.init_params(arch, torch.Generator(dev).manual_seed(SEED),
                            *plan.padded_sizes())
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"weights: qwen3-8b layers={arch.n_layers} d_model={arch.d_model} "
        f"heads={arch.n_heads}/{arch.n_kv_heads} d_ff={arch.d_ff} "
        f"vocab={arch.vocab_size} params={n_params} random (seed {SEED}) "
        f"in {time.perf_counter() - t0:.1f} s [{CARD}]")
    paged_counts, paged = serve_phase(torch, dev, "paged", arch, plan,
                                      params, n_requests=16, new_tokens=32)
    check(paged_counts["flash_attention"] > 0
          and paged_counts["paged_decode_attention"] > 0,
          f"paged serve did not launch its kernels: {paged_counts}")
    dplan = specialize(arch, shape, mesh_shape=(1, 1), target="h100-sxm",
                       kv_residency="dense", plan_dir=PLAN_DIR)
    check(dplan.estimates.get("kv_residency") == "dense",
          "the dense plan is not dense")
    dense_counts, dense = serve_phase(torch, dev, "dense", arch, dplan,
                                      params, n_requests=8, new_tokens=16)
    check(dense_counts["flash_attention"] > 0
          and dense_counts["decode_attention"] > 0,
          f"dense serve did not launch its kernels: {dense_counts}")

    # ---- phase 5: shared prefixes, the plan as frozen against a control
    shared, shared_ctl = shared_prefix_phase(torch, dev, arch, plan, params)

    # ---- phase 6: outputs against references ----
    consistency_check(torch, dev, arch, params, build_run_cfg(plan, arch),
                      int(plan.estimates["kv_block_len"]))

    # ---- phase 6b: disaggregated prefill on the same weights ----
    disagg_res, disagg_counts = disagg_phase(torch, dev, arch, params)
    ops.reset_launch_counts()
    del params
    torch.cuda.empty_cache()
    small_model_check(torch, dev)

    # ---- phases 7-8: mamba2-2.7b, qwen's weights freed ----
    march = get_arch("mamba2-2.7b")
    mplan = specialize(march, shape, mesh_shape=(1, 1), target="h100-sxm",
                       plan_dir=PLAN_DIR)
    ssd_blocks = dict(mplan.partitions["ssd_scan"].blocks)
    check(ssd_blocks["chunk"] == 256 and ssd_blocks["heads_block"] == 1
          and "kv_residency" not in mplan.estimates,
          f"unexpected mamba2 h100 plan: {ssd_blocks} {mplan.estimates}")
    t0 = time.perf_counter()
    mparams = lm.init_params(march, torch.Generator(dev).manual_seed(SEED),
                             *mplan.padded_sizes())
    torch.cuda.synchronize()
    log(f"weights: mamba2-2.7b layers={march.n_layers} "
        f"d_model={march.d_model} d_inner={march.d_inner} "
        f"ssm_heads={march.ssm_heads}x{march.ssm_head_dim} "
        f"state={march.ssm_state} groups={march.ssm_n_groups} "
        f"conv={march.ssm_conv} vocab={march.vocab_size} (padded "
        f"{mparams['embed'].shape[0]}) params="
        f"{sum(t.numel() for t in _leaves(mparams))} random (seed {SEED}) "
        f"in {time.perf_counter() - t0:.1f} s [{CARD}]")
    ssm_counts, ssm_serve = serve_phase(torch, dev, "ssm", march, mplan,
                                        mparams, n_requests=16,
                                        new_tokens=32)
    calls = ssm_serve["prefill_calls"]
    check(ssm_counts["ssd_scan"] == march.n_layers * calls > 0,
          f"ssm serve: {ssm_counts['ssd_scan']} ssd_scan launches for "
          f"{calls} prefill calls of {march.n_layers} layers")
    log(f"serve[ssm] ssd_scan launches {ssm_counts['ssd_scan']} = "
        f"{march.n_layers} per prefill call x {calls} calls [{CARD}]")
    ssm_consistency_check(torch, dev, march, mparams,
                          build_run_cfg(mplan, march))
    ssm_park = ssm_park_check(torch, dev, march, mplan, mparams,
                              kv_host_blocks=8)
    del mparams
    torch.cuda.empty_cache()
    small_ssm_check(torch, dev)

    # ---- phase 9: deepseek-coder-33b, grant admission, every earlier
    # phase's weights freed ----
    grant, grant_ctl = grant_phase(torch, dev)
    ops.reset_launch_counts()

    # ---- phases 10-11: hymba-1.5b and minitron-8b, each after every
    # earlier phase's weights were freed ----
    hymba_counts, hymba, hplan = hymba_phase(torch, dev)
    minitron_counts, minitron, tplan = minitron_phase(torch, dev)
    ops.reset_launch_counts()

    # ---- phases 12-14: granite-moe-1b-a400m (both MoE paths), llama4's
    # super-block, the small MoE models, each after every earlier
    # phase's weights were freed ----
    granite_counts, granite_g_counts, granite, _, _ = granite_phase(torch,
                                                                    dev)
    llama4_counts, llama4, _ = llama4_phase(torch, dev)
    small_moe_check(torch, dev)
    ops.reset_launch_counts()
    granite_runs = (granite_counts, granite_g_counts,
                    granite["shared_prefix"]["reuse"]["launches"],
                    granite["shared_prefix"]["control"]["launches"])

    # ---- phase 15: the plan-driven matmul path ----
    serve_runs = {
        "paged": paged_counts, "dense": dense_counts, "ssm": ssm_counts,
        "shared": shared["launches"], "shared-control": shared_ctl["launches"],
        "33b-grant": grant["launches"], "33b-control": grant_ctl["launches"],
        "hymba": hymba_counts, "minitron": minitron_counts,
        "granite": granite_counts, "granite-gshard": granite_g_counts,
        "granite-shared": granite_runs[2],
        "granite-shared-control": granite_runs[3], "llama4": llama4_counts}
    for name in ("tiled_matmul", "flash_attention_bwd", "ssd_scan_bwd"):
        served = {n: c[name] for n, c in serve_runs.items()}
        check(not any(served.values()),
              f"a serving path launched {name}: {served}")
    t0 = time.perf_counter()
    mm_launches, kern["tiled_matmul"] = matmul_path_phase(
        torch, dev, {"qwen3-8b paged": plan, "qwen3-8b dense": dplan,
                     "mamba2-2.7b": mplan, "hymba-1.5b": hplan,
                     "minitron-8b": tplan}, matmul_shapes(arch, march))
    kern["tiled_matmul"].update(mm_checks)
    log(f"matmul path: {mm_launches} launches, phase took "
        f"{time.perf_counter() - t0:.1f} s [{CARD}]")

    # ---- phases 16-17: training, every earlier weight freed, on
    # segments that grow in place ----
    allocator = expandable_segments(torch)
    t0 = time.perf_counter()
    train_counts, train = train_phase(torch, dev)
    small_train = small_train_check(torch, dev)
    guard, guard_counts = step_guard_phase(torch, dev)
    ops.reset_launch_counts()
    log(f"train phases took {time.perf_counter() - t0:.1f} s [{CARD}]")

    # ---- phases 18-19: training the MoE, SSM and hybrid families, each
    # after every earlier weight was freed; a small mamba2 card vs CPU ----
    t0 = time.perf_counter()
    families = {name: train_phase(torch, dev, name) for name in TRAIN_FAMILIES}
    small_train_ssm = small_train_check(torch, dev, "mamba2-2.7b")
    ops.reset_launch_counts()
    log(f"family train phases took {time.perf_counter() - t0:.1f} s "
        f"[{CARD}]")

    # ---- phases 20-23: the frontends (qwen2-vl-72b serve and train,
    # hubert-xlarge train, the small models), each after every earlier
    # weight was freed ----
    t0 = time.perf_counter()
    front_counts, front = frontend_phases(torch, dev)
    log(f"frontend phases took {time.perf_counter() - t0:.1f} s [{CARD}]")

    # ---- phase 24: two ranks on the card (multi-GPU serving) ----
    two = two_rank_phase(torch, dev)

    # ---- phase 24b: two ranks training on the card ----
    mesh_launches, mesh_train = mesh_train_phase(torch, dev)

    # ---- phase 24c: SSM and hybrid archs on two ranks ----
    ssm_launches, ssm_mesh = ssm_mesh_phase(torch, dev)

    # ---- phase 24d: the host tier, migration and disagg on two ranks ----
    tier_launches, mesh_tier = mesh_tier_phase(torch, dev)

    # ---- phase 24e: several data axes, four ranks ----
    pod_launches, pod_mesh = pod_mesh_phase(torch, dev)

    # ---- phase 24f: a cache split on head_dim (K9), two ranks ----
    hd_launches, head_dim = head_dim_phase(torch, dev)

    # ---- phase 24g: the tools (dry run, smokes, an example) ----
    tools = tools_phase(torch, dev, paged, train)

    # ---- phase 25: results ----
    family_counts = [c for c, _ in families.values()]
    runs = (*serve_runs.values(), train_counts, *family_counts,
            *front_counts.values(), guard_counts, disagg_counts,
            *two.get("engine_launches", []))
    for name in ("flash_attention_positions",
                 "flash_attention_bwd_positions"):
        check(front_counts["qwen2-vl positions"][name] > 0,
              f"the positions variant's runs launched {name} no time")
    launches = {k: sum(c[k] for c in runs) for k in paged_counts}
    for name, n in mesh_launches.items():
        launches[name] += n
    for name, n in ssm_launches.items():
        if name != "paged_decode_partial":
            launches[name] += n
    for name in ("flash_attention", "paged_decode_attention"):
        launches[name] += tier_launches[name]
        kern[name]["mesh_tier"] = {
            "launches": tier_launches[name], "launched_by":
            "phase 24d: qwen3-8b's (2, 1) grant engine with its host tier "
            "and migration, and its (1, 2) engine inline and with a prefill "
            "worker (the worker's flash launches included), both ranks"}
    for name in ("flash_attention", "paged_decode_attention"):
        kern[name]["g7"]["launches"] = (grant["launches"][name]
                                        + grant_ctl["launches"][name])
        kern[name]["g5"]["launches"] = hymba_counts[name]
    kern["ssd_scan"]["hymba"]["launches"] = hymba_counts["ssd_scan"]
    for name in ("flash_attention", "flash_attention_bwd", "ssd_scan",
                 "ssd_scan_bwd"):
        kern[name]["train"] = {"launches": {
            n: c[name] for n, c in (("qwen3-8b", train_counts),
                                    *((f, c) for f, (c, _) in
                                      families.items()),
                                    (QWEN2VL, front_counts["qwen2-vl train"]),
                                    (HUBERT, front_counts["hubert train"]))}}
    for name in ("flash_attention", "flash_attention_bwd"):
        kern[name]["train"]["launches"][
            "qwen3-8b two ranks (1, 2) and (2, 1), both ranks"] = \
            mesh_launches[name]
    for name in ("flash_attention", "flash_attention_bwd", "ssd_scan",
                 "ssd_scan_bwd"):
        kern[name]["ssm_mesh"] = {
            "launches": ssm_launches[name], "launched_by":
            "phase 24c: mamba2-2.7b and hymba-1.5b served and trained on "
            "two ranks of a (1, 2) mesh on one card, both ranks"}
    # the frontends' pairs: qwen2-vl's plan is paged, so its dense decode
    # instance runs in the kernel phase only (0 on the main path)
    for name in ("flash_attention", "paged_decode_attention",
                 "decode_attention"):
        kern[name]["qwen2vl"]["launches"] = (
            front_counts["qwen2-vl serve"][name]
            + front_counts["qwen2-vl train"][name])
    kern["flash_attention"]["hubert"]["launches"] = \
        front_counts["hubert train"]["flash_attention"]
    # the MoE archs' pairs: both plans are paged, so their dense decode
    # instances run in the kernel phase only (0 on the main path)
    for name in ("flash_attention", "paged_decode_attention",
                 "decode_attention"):
        kern[name]["granite"]["launches"] = sum(c[name]
                                                for c in granite_runs)
        kern[name]["llama4"]["launches"] = llama4_counts[name]
    kern["flash_attention"]["tail_launches"] = sum(
        c.get("flash_tail", 0) for c in runs)
    launches["tiled_matmul"] = mm_launches
    for name in ("decode_partial", "paged_decode_partial"):
        launches[name] = two["partial_launches"][name]
        check(launches[name] > 0, f"the two-rank run launched {name} no "
              "time")
        kern[name]["launched_by"] = (
            "flash_decode / flash_decode_paged (flat combine) on each of "
            "two ranks of a (1, 2) mesh on one card over gloo")
    # K8 inside an engine: hymba-1.5b's shard_map_flash decode ticks, and
    # qwen3-8b's (2, 1) engine on its 2-D pool
    launches["paged_decode_partial"] += ssm_launches["paged_decode_partial"]
    launches["paged_decode_partial"] += tier_launches["paged_decode_partial"]
    kern["paged_decode_partial"]["mesh_tier"] = {
        "launches": tier_launches["paged_decode_partial"], "launched_by":
        "phase 24d: qwen3-8b's (2, 1) grant engine on the "
        "shard_map_flash_paged_2d path, every decode tick, both ranks"}
    kern["paged_decode_partial"]["ssm_mesh"] = {
        "launches": ssm_launches["paged_decode_partial"], "launched_by":
        "phase 24c: hymba-1.5b's (1, 2) engine on the shard_map_flash "
        "path, every decode tick, both ranks"}
    # phase 24e: the (pod, data, model) mesh's four ranks
    for name, n in pod_launches.items():
        launches[name] += n
        kern[name]["pod_mesh"] = {
            "launches": n, "launched_by":
            "phase 24e: hymba-1.5b served and trained on four ranks of a "
            "(2, 2, 1) (pod, data, model) mesh on one card"}
    # phase 24f: K9 inside hymba-1.5b's head_dim-split engines
    for name in ("decode_split_scores", "decode_split_context"):
        launches[name] = hd_launches[name]
        check(launches[name] > 0, f"the head_dim phase launched {name} no "
              "time")
        kern[name]["launched_by"] = (
            "phase 24f: hymba-1.5b's (1, 2) engines on the XLA decode, "
            "dense and paged, every decode tick a layer, both ranks")
    for name in ("flash_attention", "ssd_scan"):
        launches[name] += hd_launches[name]
    kernels = []
    for name, r in kern.items():
        kernels.append({"name": name, **{k: r[k] for k in (
            "route", "source", "replaces")}, "launches": launches[name],
            **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms",
                                 "row_rel_err", "state_rel_err",
                                 "max_rel_err", "tolerance",
                                 "control_row_rel_err",
                                 "kernel_check_row_rel_err", "fp32",
                                 "map_encode_us", "tiles_ms", "grid",
                                 "turns_ms", "library_turns_ms", "eager_ms",
                                 "library_eager_ms", "host_us", "timing",
                                 "passes_ms", "chunks_ms", "row_rel_err_fp64",
                                 "bound_per_head_scores_ms",
                                 "shape",
                                 "shapes", "library_call", "launched_by",
                                 "offset", "tail_launches", "g7", "g5",
                                 "hymba", "granite", "llama4", "train",
                                 "qwen2vl", "hubert", "noncausal128",
                                 "fwd_with_lse_ms", "fwd_without_lse_ms",
                                 "autograd_plain_ms", "fold_row_rel_err",
                                 "shards_ms", "ssm_mesh", "mesh_tier",
                                 "pod_mesh",
                                 "autograd_plain_turns_ms")
               if k in r},
            "ptxas": [[kernel, regs, spills] for kernel, regs, spills
                      in ptxas.get(Path(r["source"]).stem, [])],
            "card": CARD})
    log(json.dumps({"serve": {"paged": paged, "dense": dense,
                              "ssm": ssm_serve, "ssm_park": ssm_park,
                              "33b_grant": grant,
                              "33b_reserve_control": grant_ctl,
                              "shared_prefix": shared,
                              "shared_prefix_control": shared_ctl,
                              "hymba": hymba, "minitron": minitron,
                              "granite": granite, "llama4": llama4,
                              "launches": {"paged": paged_counts,
                                           "dense": dense_counts,
                                           "ssm": ssm_counts,
                                           "33b_grant": grant["launches"],
                                           "33b_reserve_control":
                                           grant_ctl["launches"],
                                           "hymba": hymba_counts,
                                           "minitron": minitron_counts,
                                           "granite": granite_counts,
                                           "granite_gshard":
                                           granite_g_counts,
                                           "llama4": llama4_counts}},
                    "train": train, "small_train": small_train,
                    "train_families": {n: r for n, (_, r) in
                                       families.items()},
                    "small_train_mamba2": small_train_ssm,
                    "frontends": front, "disagg": disagg_res,
                    "step_guard": guard, "two_ranks": two,
                    "mesh_train": mesh_train, "ssm_mesh": ssm_mesh,
                    "mesh_tier": mesh_tier, "pod_mesh": pod_mesh,
                    "head_dim": head_dim, "tools": tools,
                    "allocator": allocator}, default=str))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from start to "
        f"the results [{CARD}]")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
