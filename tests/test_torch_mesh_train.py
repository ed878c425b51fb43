"""Training on a ``(data, model)`` mesh of gloo CPU ranks, held against
the JAX reference's one-device step on the same global batch.

One world of 8 ranks is started once for the file; each cell's mesh is
cut from it (``8 / (D * M)`` replicas of the cell run the same work,
replica 0's results are read, every replica's must agree).  The cells:

* reduced qwen3-8b on a (1, 1) mesh, on (2, 1) and (2, 2)
  (``megatron_tp``: heads, ``ff`` and vocab over ``model``, the batch
  over ``data``, two microbatches), (1, 2) (``fsdp_dp``: ZeRO-3 over
  ``data`` and ``model``; also with ``grad_compression="on"``, which
  the wire gate refuses under FSDP: the post-reduce error feedback on
  the pieces), (2, 4) (the twin of the reference's
  ``test_train_step_fsdp_dp_multidevice``: whatever strategy the plan
  picks), the FSDP spill on (2, 1) (a plan whose axis rules put
  ``embed`` over ``data`` as ``data_organization.py:459-491`` writes
  them, built with ``dataclasses.replace``) and a masked batch whose
  data slices count different tokens (the global-mean rule);
* reduced granite-moe-1b-a400m on (2, 1) (the aux loss over the whole
  batch) and (1, 2) (experts over ``model``);
* reduced mamba2-2.7b on (2, 1) and (2, 2) (``megatron_tp``: the mixer
  split over ``model``, its ``in_proj`` product and conv output
  regrouped onto the rank's heads), reduced hymba-1.5b on (2, 2)
  (``megatron_tp``: attention and SSM heads split) and (1, 2)
  (``fsdp_dp``), and a mamba2 whose 3 SSM heads of 128 do not divide
  the model axis (the layout pass pads them to 4, as
  ``src/repro/core/passes/layout.py:104-111`` does).

Each runs two steps of ``lower_train_step(mesh=)`` from the reference's
weights (cut into the rank's pieces) on the reference's synthetic
batches; every rank's loss and grad norm and the parameters gathered
whole from the pieces are held against ``repro``'s one-device
``lower_train_step`` on the whole global batch (a JAX one-device mesh)
at :data:`BF16_TOL`.  Both packages' plans are the ``tpu-v5e`` ones of
the cell's mesh, content hashes equal, so their microbatches, optimizer
and compression agree.

The int8 + error-feedback wire on (2, 1) is held against the
reference's wire step composed on one device (``jax.value_and_grad`` of
``lm.train_loss`` per contiguous slice, ``compressed_slice_sum`` per
leaf of ``g + e``, ``adamw.apply_updates``), and its ``compressed_psum``
means bitwise against the port's ``compressed_slice_sum`` over the
gathered ``g + e`` with the telescoping identity.  On (2, 4), four
steps with the wire track four without it within 1e-3 with equal
step-0 losses (the reference's bars, ``tests/test_train_equivalence.py
:96-103``), and two uncompressed runs give bitwise-equal losses.  A
checkpoint saved on (2, 1) (the wire's EF residuals stacked ``(dp,
...)``) is read by the reference's ``Checkpointer`` and resumed on (1,
1) and (1, 2).  Several data axes: reduced qwen3-8b on the production
mesh's ``(pod, data, model)`` axes at (2, 2, 2) under the pod plan's
post-reduce error feedback (against the reference's one-device step)
and at (2, 2, 2) and (2, 2, 1) under the wire with ``wire_dp = 4``
(against the reference's wire step composed at dp 4), and the (2, 2, 1)
wire's checkpoint resumed on (1, 1).  The wire over an FSDP split stays
refused with the reference's reason.  F5: the per-rank step-peak
estimate's vocab and state terms at two depths.
"""

import contextlib
import dataclasses
import datetime
import os
from pathlib import Path

import numpy as np
import pytest
import torch

SRC = str(Path(__file__).resolve().parents[1] / "src")
BF16_TOL = 2e-2
QUICK = dict(name="mesh_train_t", kind="train", seq_len=64, global_batch=8)
STEPS = 2

#: cell: (arch, mesh, specialize options, variant)
CELLS = {
    "q11": ("qwen3-8b", (1, 1), {}, None),
    "q21": ("qwen3-8b", (2, 1), {}, None),
    "q22": ("qwen3-8b", (2, 2), {}, None),
    "q12": ("qwen3-8b", (1, 2), {}, None),
    "q24": ("qwen3-8b", (2, 4), {}, None),
    "q12on": ("qwen3-8b", (1, 2), {"grad_compression": "on"}, None),
    "spill21": ("qwen3-8b", (2, 1), {}, "spill"),
    "mask21": ("qwen3-8b", (2, 1), {}, "mask"),
    "g21": ("granite-moe-1b-a400m", (2, 1), {}, None),
    "g12": ("granite-moe-1b-a400m", (1, 2), {}, None),
    "m21": ("mamba2-2.7b", (2, 1), {}, None),
    "g12sm": ("granite-moe-1b-a400m", (1, 2), {}, "shard_map"),
    "wire21": ("qwen3-8b", (2, 1), {"grad_compression": "on"}, None),
    "q12rs": ("qwen3-8b", (1, 2), {}, None),
    "q22ci": ("qwen3-8b", (2, 2), {}, None),
    "m22": ("mamba2-2.7b", (2, 2), {}, None),
    "h22": ("hymba-1.5b", (2, 2), {}, None),
    "h12": ("hymba-1.5b", (1, 2), {}, None),
    "m22pad": ("mamba2-2.7b", (2, 2), {}, "ssm_pad"),
    "m22ci": ("mamba2-2.7b", (2, 2), {}, None),
    "p222": ("qwen3-8b", (2, 2, 2), {}, None),
    "p222w": ("qwen3-8b", (2, 2, 2), {"grad_compression": "on"}, None),
    "p221w": ("qwen3-8b", (2, 2, 1), {"grad_compression": "on"}, None),
}

#: the wire cells, each held against the reference's wire step composed
#: on one device at its data degree
WIRE_CELLS = ("p222w", "p221w")

#: planted faults, each a cell run with one collective broken; the
#: parity test's update check must fail them
FAULTS = {"q12rs": "reduce_scatter", "q22ci": "copy_in",
          "m22ci": "ssm_copy_in"}

#: variants that change the arch itself (both packages' plans and
#: weights follow it): 3 SSM heads of 128, which the layout pass pads
#: to a multiple of the model axis
ARCH_VARIANTS = {"ssm_pad": dict(ssm_expand=3, ssm_head_dim=128)}


def _arch_of(cell, get_arch):
    """The cell's reduced arch (``get_arch`` either package's)."""
    name, _, _, variant = CELLS[cell]
    arch = get_arch(name).reduced()
    if variant in ARCH_VARIANTS:
        arch = dataclasses.replace(arch, **ARCH_VARIANTS[variant])
    return arch


def _wkey(cell) -> str:
    """The name the cell's weights and batches are kept under."""
    name, _, _, variant = CELLS[cell]
    return f"{name}_{variant}" if variant in ARCH_VARIANTS else name


def _opt_kw():
    """AdamW with ``eps = 1``: the update is about ``lr * m``, linear in
    the gradients, so the parameters after two steps hold the gradients
    to the bf16 tolerance (at the default eps an element whose gradient
    changes sign between steps moves by a whole ``lr`` on a
    rounding-level difference); the arithmetic itself is held bit for
    bit in ``tests/test_torch_train.py``."""
    return dict(peak_lr=1e-2, warmup_steps=1, total_steps=10, eps=1.0)


def _variant(plan, variant):
    """The cell's plan: the FSDP spill's axis rules, or one microbatch
    for the masked batch (the reference's microbatch split has no batch
    dim for a text model's mask)."""
    if variant == "spill":
        rules = dict(plan.axis_rules, embed="data",
                     flat_params=("data", "model"))
        return dataclasses.replace(plan, axis_rules=rules)
    if variant == "mask":
        return dataclasses.replace(plan, comm=dataclasses.replace(
            plan.comm, microbatches=1))
    if variant == "shard_map":
        return dataclasses.replace(plan, estimates=dict(
            plan.estimates, moe_impl="shard_map_alltoall"))
    return plan


def _axes(mesh):
    """A mesh shape's axes: ``(data, model)``, or the production
    mesh's ``(pod, data, model)`` for three dims."""
    return ("pod", "data", "model") if len(mesh) == 3 else ("data", "model")


def _tplan(cell, **over):
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core.pipeline import specialize
    name, mesh, kw, variant = CELLS[cell]
    arch = _arch_of(cell, get_arch)
    mesh = over.pop("mesh", mesh)
    plan = specialize(arch, ShapeConfig(**QUICK), mesh_axes=_axes(mesh),
                      mesh_shape=mesh, target="tpu-v5e",
                      cache=False, **{**kw, **over})
    return arch, _variant(plan, variant)


def _mask(batch):
    """A loss mask: rows 0-3 (data rank 0's) count every token, rows
    4-7 one in four."""
    m = np.ones(batch["targets"].shape, np.float32)
    m[4:, 1::4] = 0.0
    m[4:, 2::4] = 0.0
    m[4:, 3::4] = 0.0
    return dict(batch, mask=m)


def _mesh(shape, names=None):
    """This rank's ``shape`` mesh of the 8-rank world (replica-major)."""
    from torch.distributed.device_mesh import DeviceMesh
    names = names or _axes(shape)
    n = int(np.prod(shape))
    grid = torch.arange(8).reshape(8 // n, *shape)
    return DeviceMesh("cpu", grid, mesh_dim_names=("rep",) + tuple(names))[
        tuple(names)]


def _rep(shape) -> int:
    import torch.distributed as dist
    return dist.get_rank() // int(np.prod(shape))


def _trainable(tree):
    if isinstance(tree, dict):
        return {k: _trainable(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(tree.is_floating_point())


def _pieces_of(whole, layout):
    from repro_torch.dist.sharding import local_shard
    from repro_torch.optim.adamw import tree_map
    return tree_map(lambda t, spec: local_shard(t, layout.mesh, spec),
                    whole, layout.specs)


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return torch.equal(a, b)


@contextlib.contextmanager
def _planted(fault):
    """The cell's planted fault: the FSDP reduce-scatter handing each
    rank its neighbour's piece of the summed gradient (the norm is
    kept), ``tp.copy_in`` without its backward all-reduce, or the SSM
    regroup's ``copy_in`` alone dropped (``models.ssm._regroup_in``:
    the gathered ``in_proj`` product and conv output cut into the
    rank's heads without summing the cuts' gradients)."""
    import torch.distributed as dist

    from repro_torch.dist import fsdp
    from repro_torch.models import ssm, tp
    if fault is None:
        yield
        return
    if fault == "ssm_copy_in":
        keep = ssm._regroup_in
        ssm._regroup_in = lambda t, c: t
        try:
            yield
        finally:
            ssm._regroup_in = keep
        return
    name, keep = {"reduce_scatter": ("_reduce_scatter0",
                                     fsdp._reduce_scatter0),
                  "copy_in": ("copy_in", tp.copy_in)}[fault]

    def swapped(t, group, n):
        s = t.clone()
        dist.all_reduce(s, group=group)
        w = t.shape[0] // n
        r = (dist.get_rank(group) + 1) % n
        return s.narrow(0, r * w, w).contiguous()

    mod = fsdp if fault == "reduce_scatter" else tp
    setattr(mod, name, swapped if fault == "reduce_scatter"
            else (lambda t, c: t))
    try:
        yield
    finally:
        setattr(mod, name, keep)


def _run_cell(cell, tmp, steps=STEPS, record_psum=False, **over):
    """Two steps of the cell's mesh step from the reference's weights on
    its batches (under its planted fault, if any); returns the rank's
    record."""
    from repro_torch.core.passes.lowering import lower_train_step
    from repro_torch.dist import collectives
    from repro_torch.dist.collectives import ef_state
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import whole_state
    name, shape, _, variant = CELLS[cell]
    shape = over.get("mesh", shape)
    arch, plan = _tplan(cell, **over)
    from repro_torch.configs import ShapeConfig
    tshape = ShapeConfig(**QUICK)
    mesh = _mesh(shape)
    opt_cfg = adamw.OptConfig.from_plan(plan, **_opt_kw())
    calls = []
    if record_psum:
        orig = collectives.compressed_psum

        def recording(x, group=None):
            mean, err = orig(x, group)
            if len(calls) < 4:
                calls.append((x.clone(), mean.clone(), err.clone()))
            return mean, err
        collectives.compressed_psum = recording
    step = lower_train_step(plan, arch, tshape, mesh, opt_cfg)
    params = _trainable(_pieces_of(torch.load(Path(tmp) / f"{_wkey(cell)}.pt"),
                                   step.layout))
    opt = adamw.init_opt_state(params, opt_cfg)
    if step.ef:
        opt["ef"] = ef_state(params)
    state = {"params": params, "opt": opt}
    batches = torch.load(Path(tmp) / f"{_wkey(cell)}_batches.pt",
                         weights_only=False)
    hist = []
    try:
        with _planted(FAULTS.get(cell)):
            for t in range(steps):
                b = batches[t] if variant != "mask" else _mask(batches[t])
                state, m = step.fn(state, {k: torch.from_numpy(v)
                                           for k, v in b.items()})
                hist.append((float(m["loss"]), float(m["grad_norm"])))
    finally:
        if record_psum:
            collectives.compressed_psum = orig
    whole = whole_state(state, step)
    return {"hist": hist, "strategy": plan.estimates.get("strategy"),
            "micro": plan.comm.microbatches, "wire": step.wire_dp,
            "fsdp": step.layout.fsdp, "whole": whole["params"],
            "master": whole["opt"].get("master"),
            "ef": whole["opt"].get("ef"), "psum": calls,
            "coord": tuple(mesh.get_coordinate())}


def _world(rank, world, tmp):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    res = {}
    try:
        for cell in CELLS:
            res[cell] = _run_cell(cell, tmp, record_psum=cell == "wire21")
        res.update(_extras(tmp))
    except Exception:
        import traceback
        res["error"] = traceback.format_exc()[-4000:]
    torch.save(res, Path(tmp) / f"r{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def _extras(tmp):
    """The trajectory, determinism, checkpoint, pieces and refusal
    checks on the world."""
    import torch.distributed as dist

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core.pipeline import specialize
    from repro_torch.dist.sharding import local_shard
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.serve.sharded import param_pieces
    from repro_torch.dist.collectives import axes_groups
    from repro_torch.optim.adamw import tree_map
    from repro_torch.train.trainer import Trainer, TrainerConfig, whole_state
    out = {}
    # the wire's trajectory against no wire, and determinism, on (2, 4)
    for gc in ("on", "off", "off"):
        r = _run_cell("q24", tmp, steps=4, grad_compression=gc)
        out.setdefault("traj", []).append((gc, r["hist"], r["wire"]))
    # a checkpoint of the wire on (2, 1), resumed on (1, 2)
    arch = get_arch("qwen3-8b").reduced()
    tshape = ShapeConfig(**QUICK)
    m21 = _mesh((2, 1))
    ck = Path(tmp) / f"ck_{_rep((2, 1))}"
    plan = specialize(arch, tshape, mesh_axes=("data", "model"),
                      mesh_shape=(2, 1), target="tpu-v5e", cache=False,
                      grad_compression="on")
    tr = Trainer(plan, m21, TrainerConfig(n_steps=2, ckpt_every=2,
                                          ckpt_dir=str(ck), log_every=100),
                 opt_cfg=adamw.OptConfig.from_plan(plan, **_opt_kw()),
                 arch=arch, shape=tshape, device="cpu")
    state, _ = tr.fit()
    out["ckpt_whole"] = whole_state(state, tr.step_def)
    out["ckpt_wire"] = tr.step_def.wire_dp
    dist.barrier()
    m12 = _mesh((1, 2))
    plan12 = specialize(arch, tshape, mesh_axes=("data", "model"),
                        mesh_shape=(1, 2), target="tpu-v5e", cache=False)
    tr12 = Trainer(plan12, m12, TrainerConfig(
        ckpt_dir=str(Path(tmp) / f"ck_{_rep((1, 2)) % 4}")),
        opt_cfg=adamw.OptConfig.from_plan(plan12, **_opt_kw()),
        arch=arch, shape=tshape, device="cpu")
    st12, step12 = tr12.resume()
    out["resume12"] = (whole_state(st12, tr12.step_def), step12,
                       tr12.step_def.layout.fsdp)
    # the pieces-built state against the pieces cut from the whole
    mine = tr12.init_state(seed=3)["params"]
    whole = lm.init_params(arch, torch.Generator().manual_seed(3),
                           *plan12.padded_sizes())
    cut = tree_map(lambda t, spec: local_shard(t, m12, spec), whole,
                   tr12.step_def.layout.specs)
    out["pieces_equal"] = _same({k: v.detach() for k, v in
                                 _flat(mine).items()}, _flat(cut))
    out["pieces_spec"] = param_pieces(m12, plan12, arch)["embed"]
    # global_norm over pieces against the whole tree's
    g = torch.Generator().manual_seed(7)
    tree = tree_map(lambda t: torch.randn(t.shape, generator=g), whole)
    pcs = [adamw.Piece(tuple(axes_groups(m12, pl.split_axes)), pl.piece)
           for pl in tr12.step_def.layout.leaf_places()]
    out["norm"] = (float(adamw.global_norm(
        _pieces_of(tree, tr12.step_def.layout), pcs)),
        float(adamw.global_norm(tree)))
    # a hybrid's checkpoint on (2, 2) (``megatron_tp``: SSM pieces)
    hy = get_arch("hymba-1.5b").reduced()
    hplan = specialize(hy, tshape, mesh_axes=("data", "model"),
                       mesh_shape=(2, 2), target="tpu-v5e", cache=False)
    ckh = Path(tmp) / f"ckh_{_rep((2, 2))}"
    trh = Trainer(hplan, _mesh((2, 2)), TrainerConfig(
        n_steps=2, ckpt_every=2, ckpt_dir=str(ckh), log_every=100),
        opt_cfg=adamw.OptConfig.from_plan(hplan, **_opt_kw()), arch=hy,
        shape=tshape, device="cpu")
    sth, _ = trh.fit()
    out["ckh_whole"] = whole_state(sth, trh.step_def)
    out["ckh_strategy"] = hplan.estimates.get("strategy")
    dist.barrier()
    hplan12 = specialize(hy, tshape, mesh_axes=("data", "model"),
                         mesh_shape=(1, 2), target="tpu-v5e", cache=False)
    trh12 = Trainer(hplan12, m12, TrainerConfig(
        ckpt_dir=str(Path(tmp) / f"ckh_{_rep((1, 2)) % 2}")),
        opt_cfg=adamw.OptConfig.from_plan(hplan12, **_opt_kw()), arch=hy,
        shape=tshape, device="cpu")
    sth12, steph12 = trh12.resume()
    out["ckh_resume12"] = (whole_state(sth12, trh12.step_def), steph12,
                           hplan12.estimates.get("strategy"))
    # the wire's checkpoint on the production mesh's (2, 2, 1): its EF
    # residuals stacked (4, ...) over (pod, data)
    _, pplan = _tplan("p221w")
    ckp = Path(tmp) / f"ckp_{_rep((2, 2, 1))}"
    trp = Trainer(pplan, _mesh((2, 2, 1)), TrainerConfig(
        n_steps=2, ckpt_every=2, ckpt_dir=str(ckp), log_every=100),
        opt_cfg=adamw.OptConfig.from_plan(pplan, **_opt_kw()), arch=arch,
        shape=tshape, device="cpu")
    stp, _ = trp.fit()
    out["ckp_whole"] = whole_state(stp, trp.step_def)
    out["ckp_layout"] = (trp.step_def.wire_dp,
                         trp.step_def.layout.batch_axes,
                         trp.step_def.layout.batch_index)
    dist.barrier()
    # what stays refused: the wire over FSDP leaves (the reference's
    # reason)
    refused = {}
    _, splan = _tplan("spill21", grad_compression="on")
    try:
        Trainer(splan, m21, arch=arch, shape=tshape, device="cpu")
    except NotImplementedError as e:
        refused["wire_over_fsdp"] = str(e)
    out["refused"] = refused
    out["codes"] = _codes_on_pieces()
    out["keeps"] = {n: _saved_on_pieces(n, m12)
                    for n in ("mamba2-2.7b", "hymba-1.5b")}
    return out


def _saved_on_pieces(name, mesh):
    """``(bytes autograd keeps for one layer on this rank's pieces of
    the (2, 2) ``megatron_tp`` plan's model split, the per-rank estimate
    of them)`` on the (1, 2) ``mesh``: 2 x 64 tokens, the SSD chunk 16,
    as ``tests/test_torch_plan.py``'s one-card check counts them (the
    storages the saved-tensor hooks see, alive while the output is)."""
    import weakref

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core import costmodel
    from repro_torch.core.passes.lowering import lower_train_step
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    arch = get_arch(name).reduced()
    _, plan = _tplan("m22" if name.startswith("mamba") else "h22")
    step = lower_train_step(plan, arch, ShapeConfig(**QUICK), mesh)
    whole = lm.init_params(arch, torch.Generator().manual_seed(0),
                           *plan.padded_sizes())
    params = _trainable(_pieces_of(whole, step.layout))
    owned = {t.untyped_storage().data_ptr() for t in adamw.leaves(params)}
    B, S = 2, 64
    x = torch.randn(B, S, arch.d_model).to(torch.bfloat16).requires_grad_()
    positions = torch.arange(S).expand(B, S)
    owned.add(positions.untyped_storage().data_ptr())
    seen = []

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in owned:
            seen.append((st.data_ptr(), st.nbytes(), weakref.ref(t)))
        return t
    cfg = dataclasses.replace(step.cfg, ssd_chunk=16)
    grp = lm.layer_groups(arch, params["blocks"])[0]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = lm._group_fwd(arch, cfg, grp, x, positions, (0, 0))
    got = sum({p: n for p, n, ref in seen if ref() is not None}.values())
    del y
    m = 2
    C = arch.d_inner + 2 * arch.ssm_n_groups * arch.ssm_state
    want = costmodel.eager_layer_saved_bytes(
        arch, B * S, max(arch.n_heads // m, 1), max(arch.n_kv_heads // m, 1),
        "none", seqs=B, ffn=costmodel.layer_group_ffns(arch)[0],
        ssd_chunk=16, ff_shards=m, ssm_heads=arch.ssm_heads // m,
        conv_channels=C // m)
    return got, want


def _codes_on_pieces():
    """The step's error feedback and wire on a rank's pieces against
    the whole leaves' codes, bit for bit: random whole gradients and
    residuals of every leaf cut into the pieces of (1, 2)'s ``fsdp_dp``
    layout (the post-reduce ``ef_compress``, 128-element blocks of the
    flattened leaf) and of (2, 2)'s ``megatron_tp`` wire (blocks along
    the last dim; each data rank's leaves drawn from its own seed, held
    against ``compressed_slice_sum`` of the data ranks' whole ``g +
    e``).  ``{kind: (equal, leaves whose pieces cut the blocks,
    leaves)}``."""
    from repro_torch.core.passes import lowering
    from repro_torch.dist.collectives import (axes_groups,
                                              compressed_slice_sum,
                                              ef_compress)
    from repro_torch.dist.fsdp import MeshLayout
    from repro_torch.dist.sharding import local_shard

    def draw(places, seed):
        g = torch.Generator().manual_seed(seed)
        return ([torch.randn(pl.whole, generator=g).to(torch.bfloat16)
                 for pl in places],
                [(torch.randn(pl.whole, generator=g) * 1e-2).to(
                    torch.bfloat16) for pl in places])

    out = {}
    for kind, cell, shape in (("ef", "q12on", (1, 2)),
                              ("wire", "q22", (2, 2))):
        arch, plan = _tplan(cell, grad_compression="on")
        mesh = _mesh(shape)
        lay = MeshLayout(plan, arch, mesh)
        places = lay.leaf_places()
        if kind == "ef":
            gw, ew = draw(places, 11)
            want = [ef_compress(g, e) for g, e in zip(gw, ew)]
        else:
            assert lowering.wire_compression(plan, mesh, arch) == 2
            rows = [draw(places, 20 + r) for r in range(2)]
            want = []
            for k in range(len(places)):
                acc = torch.stack([g[k].float() + e[k].float()
                                   for g, e in rows])
                mean, err = compressed_slice_sum(
                    acc[:, None] if acc.dim() == 1 else acc)
                mean, err = mean.reshape(acc.shape[1:]), err.reshape(
                    acc.shape)
                want.append((mean.to(torch.bfloat16),
                             err[lay.batch_index].to(torch.bfloat16)))
            gw, ew = rows[lay.batch_index]
        gp = [local_shard(t, mesh, pl.spec) for t, pl in zip(gw, places)]
        ep = [local_shard(t, mesh, pl.spec) for t, pl in zip(ew, places)]
        if kind == "ef":
            got = zip(*lowering._ef_compress(gp, ep, lay, places))
        else:
            got = zip(*lowering._wire(gp, ep, axes_groups(
                mesh, lay.batch_axes), lay, places))
        equal = all(
            torch.equal(g, local_shard(wg, mesh, pl.spec))
            and torch.equal(e, local_shard(we, mesh, pl.spec))
            for (g, e), (wg, we), pl in zip(got, want, places))
        spans = sum(lowering._codes_span_pieces(lay, pl, kind == "wire")
                    for pl in places)
        out[kind] = (equal, spans, len(places))
    return out


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else k))
        return out
    return {path: tree}


# ---------------------------------------------------------------------
# the reference, on one device, in this process
# ---------------------------------------------------------------------

def _rmesh():
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


_REF = {}


def _ref_cell(cell, batches, rparams, steps=STEPS):
    """The reference's one-device step on the whole global batch, from
    ``rparams``, with the cell's plan; ``(losses, grad norms, params,
    the port's plan, the reference's)``.  Cells whose plans agree on what
    one device runs (microbatches, optimizer, compression) share one
    run."""
    import jax
    from repro.configs import ShapeConfig as RShape
    from repro.configs import get_arch as rget_arch
    from repro.core import specialize as rspecialize
    from repro.core.passes.lowering import lower_train_step as rlower
    from repro.dist.collectives import ef_state as ref_state
    from repro.optim import adamw as radamw
    name, mesh, kw, variant = CELLS[cell]
    rarch = _arch_of(cell, rget_arch)
    rplan = rspecialize(rarch, RShape(**QUICK), mesh_axes=_axes(mesh),
                        mesh_shape=mesh, cache=False, **kw)
    _, tplan = _tplan(cell)
    if variant is None or variant in ARCH_VARIANTS:
        assert rplan.content_hash() == tplan.content_hash()
    rplan = _variant(rplan, variant)
    key = (_wkey(cell), rplan.comm.microbatches,
           tuple(sorted(rplan.opt.items())),
           rplan.comm.compresses_gradients, variant == "mask")
    if key in _REF:
        return (*_REF[key], tplan, rplan)
    ropt = radamw.OptConfig.from_plan(rplan, **_opt_kw())
    step = rlower(rplan, rarch, RShape(**QUICK), _rmesh(), ropt)
    opt = radamw.init_opt_state(rparams, ropt)
    if rplan.comm.compresses_gradients:
        opt["ef"] = ref_state(rparams)
    state = {"params": rparams, "opt": opt}
    fn = jax.jit(step.fn)
    hist = []
    for t in range(steps):
        b = _mask(batches[t]) if variant == "mask" else batches[t]
        state, m = fn(state, b)
        hist.append((float(m["loss"]), float(m["grad_norm"])))
    _REF[key] = (hist, jax.tree.map(np.asarray, state["opt"].get(
        "master", state["params"])))
    return (*_REF[key], tplan, rplan)


def _ref_wire(batches, rparams, mesh=(2, 1), steps=STEPS):
    """The reference's wire step composed on one device
    (``src/repro/core/passes/lowering.py:269-351``) for the plan of
    ``mesh`` with ``grad_compression="on"``, at its lowered data degree
    (the ``(pod, data)`` slices of a three-dim mesh, data-major, as its
    ``_dp_entry`` stacks them): per contiguous slice the loss and
    gradients (microbatches interleaved within it), per leaf
    ``compressed_slice_sum`` of the stacked ``g + e``, then
    ``apply_updates``."""
    import jax
    import jax.numpy as jnp
    from repro.configs import ShapeConfig as RShape
    from repro.configs import get_arch as rget_arch
    from repro.core import specialize as rspecialize
    from repro.core.passes.lowering import build_run_cfg as rbuild
    from repro.dist.collectives import compressed_slice_sum
    from repro.models import lm as rlm
    from repro.optim import adamw as radamw
    rarch = rget_arch("qwen3-8b").reduced()
    rplan = rspecialize(rarch, RShape(**QUICK), mesh_axes=_axes(mesh),
                        mesh_shape=mesh, cache=False,
                        grad_compression="on")
    dp = int(rplan.estimates["grad_compress_lowered"])
    rows = QUICK["global_batch"] // dp
    nm = max(rplan.comm.microbatches, 1)
    cfg = rbuild(rplan, rarch, None)
    ropt = radamw.OptConfig.from_plan(rplan, **_opt_kw())
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: rlm.train_loss(rarch, p, b, cfg)[0]))

    @jax.jit
    def wire(gs, ef, params, opt):
        flat_g = [jax.tree.leaves(g) for g in gs]
        flat_e, tdef = jax.tree.flatten(ef)
        out_g, out_e = [], []
        for k, e in enumerate(flat_e):
            acc = jnp.stack([flat_g[i][k].astype(jnp.float32)
                             for i in range(dp)]) + e.astype(jnp.float32)
            scalar = acc.ndim == 1
            if scalar:
                acc = acc[:, None]
            gh, err = compressed_slice_sum(acc)
            if scalar:
                gh, err = gh[..., 0], err[..., 0]
            out_g.append(gh.astype(flat_g[0][k].dtype))
            out_e.append(err.astype(jnp.bfloat16))
        grads = jax.tree.unflatten(tdef, out_g)
        params, opt, om = radamw.apply_updates(params, grads, opt, ropt)
        return params, opt, jax.tree.unflatten(tdef, out_e), om

    params, opt = rparams, radamw.init_opt_state(rparams, ropt)
    ef = jax.tree.map(lambda p: jnp.zeros((dp,) + p.shape, jnp.bfloat16),
                      params)
    hist = []
    for t in range(steps):
        b = batches[t]
        losses, gs = [], []
        for i in range(dp):
            sl = {k: v[i * rows:(i + 1) * rows] for k, v in b.items()}
            if nm == 1:
                l_, g_ = vg(params, sl)
            else:
                l_, g_ = 0.0, None
                for j in range(nm):
                    mb = {k: v[j::nm] for k, v in sl.items()}
                    lj, gj = vg(params, mb)
                    gj = jax.tree.map(lambda x: x.astype(jnp.float32), gj)
                    g_ = gj if g_ is None else jax.tree.map(jnp.add, g_, gj)
                    l_ = l_ + lj
                l_ = l_ / nm
                g_ = jax.tree.map(lambda x: x / nm, g_)
            losses.append(l_)
            gs.append(g_)
        params, opt, ef, om = wire(gs, ef, params, opt)
        hist.append((float(jnp.mean(jnp.stack(losses))),
                     float(om["grad_norm"])))
    return hist, jax.tree.map(np.asarray, opt["master"]), jax.tree.map(
        np.asarray, ef)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's weights and batches written once, the 8-rank
    world run, and its results read."""
    import jax
    import torch.multiprocessing as mp
    from repro.configs import ShapeConfig as RShape
    from repro.configs import get_arch as rget_arch
    from repro.data.pipeline import SyntheticSource as RSource
    from repro.models import lm as rlm

    from repro_torch.models import convert
    tmp = tmp_path_factory.mktemp("mesh_train")
    refs = {}
    from repro_torch.configs import get_arch
    for key in {_wkey(c) for c in CELLS}:
        cell = next(c for c in CELLS if _wkey(c) == key)
        rarch = _arch_of(cell, rget_arch)
        _, tplan = _tplan(cell)
        rparams = rlm.init_params(rarch, jax.random.PRNGKey(0),
                                  *tplan.padded_sizes())
        npp = jax.tree.map(np.asarray, rparams)
        torch.save(convert.params_from_numpy(
            _arch_of(cell, get_arch), npp, device="cpu"), tmp / f"{key}.pt")
        src = RSource(rarch, RShape(**QUICK), seed=0)
        batches = [src.batch_at(t) for t in range(4)]
        torch.save(batches, tmp / f"{key}_batches.pt")
        refs[key] = (rparams, batches)
    mp.start_processes(_world, args=(8, str(tmp)), nprocs=8,
                       start_method="spawn")
    ranks = [torch.load(tmp / f"r{r}.pt", weights_only=False)
             for r in range(8)]
    for r in ranks:
        assert "error" not in r, r["error"]
    return ranks, refs, tmp


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(t):
    return t.detach().float().numpy()


def _rflat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_rflat(tree[k], f"{path}/{k}" if path else k))
        return out
    if isinstance(tree, torch.Tensor):
        return {path: tree.detach().float().numpy()}
    return {path: np.asarray(tree, np.float32)}


#: (arch, leaf) whose bf16 gradients the two packages' one-card steps
#: already part beyond the bf16 bar at this shape: mamba2's conv bias
#: (a sum over every token, 2.4% apart after these two steps through the
#: port's one-card step too); the mesh is held against that step there
ONE_CARD_ANCHORED = {("mamba2-2.7b", "blocks/ssm/conv_b")}


def _one_card(cell, rparams, batches, steps=STEPS):
    """The port's one-card step from the reference's weights on the
    whole batches: its master weights (or parameters)."""
    import jax

    from repro_torch.configs import ShapeConfig
    from repro_torch.core.passes.lowering import lower_train_step
    from repro_torch.models import convert
    from repro_torch.optim import adamw
    arch, plan = _tplan(cell)
    params = _trainable(convert.params_from_numpy(
        arch, jax.tree.map(np.asarray, rparams), device="cpu"))
    opt_cfg = adamw.OptConfig.from_plan(plan, **_opt_kw())
    step = lower_train_step(plan, arch, ShapeConfig(**QUICK), None, opt_cfg)
    state = {"params": params, "opt": adamw.init_opt_state(params, opt_cfg)}
    for t in range(steps):
        state, _ = step.fn(state, {k: torch.from_numpy(v)
                                   for k, v in batches[t].items()})
    return _rflat(state["opt"].get("master", state["params"]))


def _routed(key: str, name: str) -> bool:
    """An MoE layer's FFN leaf (its norm, router, experts): held in fp32
    only, as ``tests/test_torch_train_families.py`` says why (routing
    flips on bf16 near-ties; the port's one-card step moves granite's
    ``mlp_norm`` 4.5% from the reference's after these two steps)."""
    return name.startswith("granite") and (
        key.endswith("mlp_norm") or "/moe/" in f"/{key}")


def _cell_ranks(ranks, cell):
    return [r[cell] for r in ranks[:int(np.prod(CELLS[cell][1]))]]


PARITY = ["q11", "q21", "q22", "q12", "q24", "q12on", "spill21", "mask21",
          "g21", "g12", "m21", "m22", "h22", "h12", "m22pad", "p222"]

#: the update check: each leaf's change over the two steps against the
#: reference's, as a norm relative to the norm of the reference's change
DELTA_TOL = 5e-2


def _delta_err(got, want, init) -> float:
    """``|(got - init) - (want - init)| / |want - init|`` (Frobenius
    norms, fp64): the update against the reference's update.  The
    parameters themselves move by about ``lr * m`` (eps = 1), far inside
    the bf16 bar held on them, so this is the check that sees an update
    skipped, turned or handed to the wrong piece."""
    got, want, init = (np.asarray(a, np.float64) for a in (got, want, init))
    dw = want - init
    return float(np.linalg.norm((got - init) - dw) /
                 max(np.linalg.norm(dw), 1e-30))


def _update_errs(world, cell):
    """The cell's parameters after two steps against the reference's:
    ``{leaf: (rel error of the parameters, error of the update)}``
    (granite's routed leaves left out; the leaves the port's one-card
    step already parts from the reference held against that step)."""
    ranks, refs, _ = world
    name = CELLS[cell][0]
    rparams, batches = refs[_wkey(cell)]
    _, wparams, _, _ = _ref_cell(cell, batches, rparams)
    mine = _cell_ranks(ranks, cell)
    got = _rflat(mine[0]["master"] if mine[0]["master"] is not None
                 else mine[0]["whole"])
    wflat, init = _rflat(wparams), _rflat(rparams)
    assert got.keys() == wflat.keys()
    out, one = {}, None
    for k in wflat:
        if _routed(k, name):
            continue
        want = wflat[k]
        if (name, k) in ONE_CARD_ANCHORED:
            one = one or _one_card(cell, rparams, batches)
            print(cell, k, "one card vs the reference",
                  _rel(one[k], wflat[k]), _delta_err(one[k], wflat[k],
                                                     init[k]))
            want = one[k]
        out[k] = (_rel(got[k], want), _delta_err(got[k], want, init[k]))
    return out


@pytest.mark.parametrize("cell", PARITY)
def test_mesh_step_matches_the_reference_one_device_step(world, cell):
    ranks, refs, _ = world
    name, mesh, _, variant = CELLS[cell]
    rparams, batches = refs[_wkey(cell)]
    want, _, tplan, rplan = _ref_cell(cell, batches, rparams)
    mine = _cell_ranks(ranks, cell)
    print(cell, mine[0]["strategy"], "microbatches", mine[0]["micro"],
          "fsdp", mine[0]["fsdp"])
    for r in mine:
        for (l, g), (lw, gw) in zip(r["hist"], want):
            assert _rel(l, lw) <= BF16_TOL, (cell, l, lw)
            assert _rel(g, gw) <= BF16_TOL, (cell, g, gw)
        # every rank reports the same numbers
        assert r["hist"] == mine[0]["hist"]
    errs = _update_errs(world, cell)
    print(cell, "worst update error", max(d for _, d in errs.values()))
    for k, (rel, delta) in errs.items():
        assert rel <= BF16_TOL, (cell, k, rel)
        assert delta <= DELTA_TOL, (cell, k, delta)
    if cell in ("q12", "q12on"):
        assert mine[0]["strategy"] == "fsdp_dp" and mine[0]["fsdp"]
    if cell == "q12on":          # the post-reduce EF under FSDP, no wire
        assert mine[0]["wire"] == 0 and mine[0]["ef"] is not None
    if cell == "spill21":
        assert mine[0]["fsdp"] and mine[0]["strategy"] == "megatron_tp"
    if cell in ("q21", "q22", "g21", "m21"):
        assert mine[0]["micro"] == 2
    if cell in ("m22", "h22", "m22pad"):
        assert mine[0]["strategy"] == "megatron_tp" and not mine[0]["fsdp"]
    if cell == "h12":
        assert mine[0]["strategy"] == "fsdp_dp" and mine[0]["fsdp"]
    if cell == "m22pad":            # 3 SSM heads padded to 4
        assert tplan.padded_sizes()[2] == 4
    if cell == "p222":
        # the production mesh's pod plan: the batch over (pod, data), the
        # int8 + EF booked on the slow channel; the wire needs
        # ``compress_grads``, so the post-reduce error feedback runs
        # after an fp32 sum over both data axes
        assert tplan.axis_rules["batch"] == ("pod", "data")
        assert tplan.comm.compress_pod_grads and not tplan.comm.compress_grads
        assert mine[0]["wire"] == 0 and mine[0]["ef"] is not None
        assert [c[:2] for c in (r["coord"] for r in mine)] == [
            (i // 4, (i // 2) % 2) for i in range(8)]


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_the_update_check_fails_a_planted_fault(world, cell):
    """The FSDP reduce-scatter handing each rank its neighbour's piece
    (``fsdp_dp`` on (1, 2): the gradient norm is kept), ``copy_in``
    without its backward all-reduce (``megatron_tp`` on (2, 2)) and the
    SSM regroup's ``copy_in`` dropped (mamba2, ``megatron_tp`` on (2,
    2)): the update check fails each by more than four times its bar."""
    errs = _update_errs(world, cell)
    worst = max(d for _, d in errs.values())
    print(cell, FAULTS[cell], "worst update error", worst,
          "worst parameter error", max(r for r, _ in errs.values()))
    assert worst > 4 * DELTA_TOL, (cell, worst)


def test_error_feedback_and_wire_on_pieces_code_the_whole_leaf_blocks(
        world):
    """A piece whose blocks are not its whole leaf's (reduced widths:
    an ``embed`` dim of 64 a rank, a head dim's 64 columns) is coded on
    the whole leaf gathered; the others on the piece: every rank's
    delivered gradient and residual are its piece of the whole leaf's,
    bit for bit, and both ways were taken."""
    ranks, _, _ = world
    for r in ranks:
        for kind in ("ef", "wire"):
            equal, spans, n = r["codes"][kind]
            assert equal, kind
            assert 0 < spans < n, (kind, spans, n)


def test_moe_shard_map_trains_through_its_exchanges(world):
    """granite's (1, 2) plan with ``moe_impl`` set to
    ``shard_map_alltoall`` (the planner picks it for no train shape):
    each rank routes its half of the sequence and the all-to-alls carry
    the gradients back; the losses are finite, every rank's equal, and
    near the ``gshard_einsum`` cell's (the routing groups differ: each
    rank's tokens are one group, so capacity drops do)."""
    ranks, _, _ = world
    sm, gs = _cell_ranks(ranks, "g12sm"), _cell_ranks(ranks, "g12")
    for r in sm:
        assert r["hist"] == sm[0]["hist"]
        for (l, g), (lw, gw) in zip(r["hist"], gs[0]["hist"]):
            assert np.isfinite(l) and np.isfinite(g)
            assert abs(l - lw) / lw <= 1e-2 and abs(g - gw) / gw <= 0.1, \
                (l, lw, g, gw)


def test_masked_slices_count_different_tokens(world):
    """The masked cell's two data slices count 256 and 64 tokens: the
    mean of the ranks' means would differ from the global mean."""
    _, refs, _ = world
    _, batches = refs["qwen3-8b"]
    m = _mask(batches[0])["mask"]
    assert m[:4].sum() == 256 and m[4:].sum() == 64


def test_wire_matches_the_composed_reference_wire_step(world):
    ranks, refs, _ = world
    rparams, batches = refs["qwen3-8b"]
    want, wparams, wef = _ref_wire(batches, rparams)
    assert _tplan("wire21")[1].opt["master_weights"]
    mine = _cell_ranks(ranks, "wire21")
    assert mine[0]["wire"] == 2
    for r in mine:
        for (l, g), (lw, gw) in zip(r["hist"], want):
            assert _rel(l, lw) <= BF16_TOL, (l, lw)
            assert _rel(g, gw) <= BF16_TOL, (g, gw)
    got, init = _rflat(mine[0]["master"]), _rflat(rparams)
    for k, w in _rflat(wparams).items():
        assert _rel(got[k], w) <= BF16_TOL, k
        assert _delta_err(got[k], w, init[k]) <= DELTA_TOL, k
    # the EF residuals, stacked (dp, ...) as the reference keeps them;
    # each is what its slice's rounding left (under half a code step),
    # so they are not held element by element (a rounding-level
    # difference in g + e moves a code by one step) but by size
    gef = _rflat(mine[0]["ef"])
    for k, w in _rflat(wef).items():
        assert gef[k].shape == w.shape, k
        rms = float(np.sqrt(np.mean(gef[k] ** 2)))
        wrms = float(np.sqrt(np.mean(w ** 2)))
        assert 0.5 * wrms <= rms <= 2 * wrms, (k, rms, wrms)


@pytest.mark.parametrize("cell", WIRE_CELLS)
def test_wire_over_pod_and_data_matches_the_composed_reference(world,
                                                               cell):
    """The wire on the production mesh's ``(pod, data)``: ``wire_dp =
    pod x data = 4``, one linearised data group (the codes' MAX and SUM
    over each axis in turn), each rank's EF row the reference's
    ``_dp_entry`` row (data-major), held against the reference's wire
    step composed on one device at dp 4; the EF residuals stacked
    ``(4, ...)``."""
    ranks, refs, _ = world
    rparams, batches = refs["qwen3-8b"]
    want, wparams, wef = _ref_wire(batches, rparams, CELLS[cell][1])
    mine = _cell_ranks(ranks, cell)
    assert mine[0]["wire"] == 4
    for r in mine:
        assert r["hist"] == mine[0]["hist"]
        for (l, g), (lw, gw) in zip(r["hist"], want):
            assert _rel(l, lw) <= BF16_TOL, (l, lw)
            assert _rel(g, gw) <= BF16_TOL, (g, gw)
    got, init = _rflat(mine[0]["master"]), _rflat(rparams)
    for k, w in _rflat(wparams).items():
        assert _rel(got[k], w) <= BF16_TOL, k
        assert _delta_err(got[k], w, init[k]) <= DELTA_TOL, k
    gef = _rflat(mine[0]["ef"])
    for k, w in _rflat(wef).items():
        assert gef[k].shape == w.shape and w.shape[0] == 4, k
        rms = float(np.sqrt(np.mean(gef[k] ** 2)))
        wrms = float(np.sqrt(np.mean(w ** 2)))
        assert 0.5 * wrms <= rms <= 2 * wrms, (k, rms, wrms)


def test_compressed_psum_is_the_slice_sum_of_the_gathered_accumulators(
        world):
    from repro_torch.dist.collectives import compressed_slice_sum
    ranks, _, _ = world
    a, b = (r["wire21"]["psum"] for r in ranks[:2])
    assert len(a) == len(b) >= 2
    for (xa, ma, ea), (xb, mb, eb) in zip(a, b):
        mean, err = compressed_slice_sum(torch.stack([xa, xb]))
        assert torch.equal(mean, ma) and torch.equal(mean, mb)
        assert torch.equal(err[0], ea) and torch.equal(err[1], eb)
        # delivered mean + the residuals' mean == the accumulators' mean
        lhs = ma.double() + (ea.double() + eb.double()) / 2
        rhs = (xa.double() + xb.double()) / 2
        eps = float(torch.finfo(torch.float32).eps)
        assert float((lhs - rhs).abs().max()) <= 4 * eps * max(
            float(rhs.abs().max()), 1e-30)


def test_wire_trajectory_tracks_no_wire_and_off_is_deterministic(world):
    ranks, _, _ = world
    for r in ranks:
        (gc_on, on, w_on), (_, off, w_off), (_, off2, _) = r["traj"]
        assert w_on == 2 and w_off == 0
        assert on[0][0] == off[0][0], (on[0], off[0])
        for (a, _), (b, _) in zip(on, off):
            assert abs(a - b) < 1e-3, (a, b)
        for (_, a), (_, b) in zip(on, off):
            assert abs(a - b) / max(abs(b), 1e-9) < 0.05, (a, b)
        assert [x for x, _ in off] == [x for x, _ in off2]
        assert off == ranks[0]["traj"][1][1]


def test_checkpoint_on_2x1_resumes_on_1x2_and_1x1(world):
    from repro.ckpt.checkpointer import Checkpointer as RCheckpointer

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core.pipeline import specialize
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import Trainer, TrainerConfig
    ranks, _, tmp = world
    saved = ranks[0]["ckpt_whole"]
    ck = tmp / "ck_0"
    # the reference reads the manifest and every leaf
    rstate, manifest = RCheckpointer(ck).restore()
    assert manifest["step"] == 2
    for k, v in _flat(saved["params"]).items():
        assert manifest["keys"][f"params/{k}"]["shape"] == list(v.shape)
    params = _flat(saved["params"])
    for k in _flat(saved["opt"]["ef"]):
        assert manifest["keys"][f"opt/ef/{k}"]["shape"] == \
            [2, *params[k].shape], k
    # (1, 2): its pieces gathered are the saved whole leaves
    whole12, step12, fsdp12 = ranks[0]["resume12"]
    assert step12 == 2 and fsdp12
    assert _same(whole12["params"], saved["params"])
    for key in ("m", "v"):
        assert _same(whole12["opt"][key], saved["opt"][key])
    assert "ef" not in whole12["opt"]
    # (1, 1) with the wire's plan on one card: the residuals' mean
    arch = get_arch("qwen3-8b").reduced()
    tshape = ShapeConfig(**QUICK)
    plan = specialize(arch, tshape, mesh_axes=("data", "model"),
                      mesh_shape=(1, 1), target="tpu-v5e", cache=False,
                      grad_compression="on")
    tr = Trainer(plan, None, TrainerConfig(ckpt_dir=str(ck)),
                 opt_cfg=adamw.OptConfig.from_plan(plan, **_opt_kw()),
                 arch=arch, shape=tshape, device="cpu")
    st, step = tr.resume()
    assert step == 2
    assert _same({k: v.detach() for k, v in _flat(st["params"]).items()},
                 _flat(saved["params"]))
    for k, e in _flat(st["opt"]["ef"]).items():
        stacked = _flat(saved["opt"]["ef"])[k]
        assert torch.equal(e, stacked.float().mean(0).to(e.dtype)), k
    st, _ = tr.fit(st, n_steps=3, start_step=2)
    assert np.isfinite(tr.history[-1]["loss"])


def test_hybrid_checkpoint_on_2x2_resumes_on_1x1(world):
    """hymba's checkpoint saved on (2, 2) (``megatron_tp``: its SSM and
    attention leaves split over ``model``) holds whole leaves: one card
    resumes it at step 2 with exactly those parameters and moments, and
    trains on; (1, 2) resumes it too."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core.pipeline import specialize
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import Trainer, TrainerConfig
    ranks, _, tmp = world
    saved = ranks[0]["ckh_whole"]
    assert ranks[0]["ckh_strategy"] == "megatron_tp"
    arch = get_arch("hymba-1.5b").reduced()
    tshape = ShapeConfig(**QUICK)
    plan = specialize(arch, tshape, mesh_axes=("data", "model"),
                      mesh_shape=(1, 1), target="tpu-v5e", cache=False)
    tr = Trainer(plan, None, TrainerConfig(ckpt_dir=str(tmp / "ckh_0")),
                 opt_cfg=adamw.OptConfig.from_plan(plan, **_opt_kw()),
                 arch=arch, shape=tshape, device="cpu")
    st, step = tr.resume()
    assert step == 2
    ssm = _flat(saved["params"])["blocks/ssm/in_proj"]
    assert ssm.shape[-1] == 2 * arch.d_inner + 2 * arch.ssm_state \
        + arch.ssm_heads
    assert _same({k: v.detach() for k, v in _flat(st["params"]).items()},
                 _flat(saved["params"]))
    for key in ("m", "v"):
        assert _same(st["opt"][key], saved["opt"][key])
    st, _ = tr.fit(st, n_steps=3, start_step=2)
    assert np.isfinite(tr.history[-1]["loss"])
    # (1, 2), ``fsdp_dp``: its pieces gathered are the saved leaves
    whole12, step12, strategy12 = ranks[0]["ckh_resume12"]
    assert step12 == 2 and strategy12 == "fsdp_dp"
    assert _same(whole12["params"], saved["params"])
    for key in ("m", "v"):
        assert _same(whole12["opt"][key], saved["opt"][key])


@pytest.mark.parametrize("name", ["mamba2-2.7b", "hymba-1.5b"])
def test_rank_estimate_is_what_autograd_keeps_on_ssm_pieces(world, name):
    """The per-rank saved-bytes term of the step-peak estimate for a
    layer whose mixer is split over two model ranks (the rank's heads,
    conv channels and regrouped cuts: ``costmodel._ssm_saved_bytes``
    with ``heads`` / ``conv_channels``; hymba's attention heads too)
    against what PyTorch keeps on each rank, byte for byte."""
    ranks, _, _ = world
    for r in ranks:
        got, want = r["keeps"][name]
        assert got == want, (name, got, want)


@pytest.mark.parametrize("n_layers", [8, 32])
def test_rank_step_peak_counts_the_rank_vocab_and_state(n_layers):
    """F5: hymba-1.5b's full-width (1, 2) ``megatron_tp`` train plan at
    two depths.  The IR leaves its odd vocab (32001) whole, but the
    model splits the padded table (32256) over the model ranks, so the
    loss's region is the vocab-split cross-entropy's 14 T V over the
    rank's vocab piece, not the whole logits' 20 T V; the state is the
    rank's pieces as the trainer builds them (``param_pieces``: the kv
    heads padded to 13 a rank), parameters, two fp32 moments and the
    fp32 master, counted exactly; and the two depths differ only by
    their layers' terms."""
    import math

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core import specialize
    from repro_torch.core.passes import communication as comm
    from repro_torch.serve.sharded import param_pieces
    seen = []
    keep = comm.eager_train_step_memory

    def spy(arch, **kw):
        out = keep(arch, **kw)
        seen.append((kw, out))
        return out
    ests = {}
    for n in (n_layers, n_layers // 2):
        arch = dataclasses.replace(get_arch("hymba-1.5b"), n_layers=n)
        seen.clear()
        comm.eager_train_step_memory = spy
        try:
            plan = specialize(arch, ShapeConfig("t", "train", 2048, 2),
                              mesh_axes=("data", "model"),
                              mesh_shape=(1, 2), target="h100-sxm",
                              cache=False)
        finally:
            comm.eager_train_step_memory = keep
        kw, est = seen[-1]
        assert plan.comm.remat_policy == "none" and kw["remat"] == "none"
        T = 2048 * 2
        pieces = param_pieces(_FakeMesh((1, 2)), plan, arch)
        vl = pieces["lm_head"][1][-1]
        assert vl == 32256 // 2 and pieces["embed"][1][0] == vl
        assert kw["vocab"] == vl and kw["vocab_split"]
        assert est["loss"] == 14 * T * vl
        # the rank's state, exactly: bf16 leaves, fp32 m, v and master
        from repro_torch.models import lm
        specs = lm.leaf_specs(arch, *plan.padded_sizes())

        def walk(sp, pc):
            if isinstance(sp, dict):
                return sum(walk(sp[k], pc[k]) for k in sp)
            return math.prod(pc[1]) * (sp.dtype.itemsize + 4 + 4 + 4)
        assert plan.opt["moment_dtype"] == "float32" \
            and plan.opt["master_weights"]
        assert est["state"] == walk(specs, pieces)
        assert plan.estimates["step_peak_bytes"] == est["peak"]
        ests[n] = est
    lo, hi = ests[n_layers // 2], ests[n_layers]
    for k in ("runtime", "loss", "ssd_workspace"):
        assert hi[k] == lo[k], k
    half = n_layers // 2
    per = (hi["saved"] - lo["saved"]) / half
    assert per > 0 and lo["saved"] - half * per == \
        pytest.approx(hi["saved"] - n_layers * per)


def test_pieces_norm_and_every_plan_runs(world):
    ranks, _, _ = world
    r0 = ranks[0]
    assert r0["pieces_equal"]
    assert r0["pieces_spec"][1][1] == 128 // 2        # embed over 2 ranks
    got, want = r0["norm"]
    assert abs(got - want) <= 1e-5 * want
    # every rank of every cell ran; replicas agree
    for cell in CELLS:
        n = int(np.prod(CELLS[cell][1]))
        for rep in range(8 // n):
            for i in range(n):
                assert ranks[rep * n + i][cell]["hist"] == \
                    ranks[i][cell]["hist"]


def test_warm_start_specializes_for_the_mesh(world, tmp_path):
    """``Trainer.warm_start(ckpt_dir, mesh)`` without the stored plan
    re-specializes for the mesh's shape."""
    import shutil

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.train.trainer import Trainer
    _, _, tmp = world
    ck = tmp_path / "ck"
    shutil.copytree(tmp / "ck_0", ck, ignore=shutil.ignore_patterns("plans"))
    mesh = _FakeMesh((1, 2))
    tr = Trainer.warm_start(ck, mesh, arch=get_arch("qwen3-8b").reduced(),
                            shape=ShapeConfig(**QUICK), device="cpu")
    assert tuple(tr.plan.mesh_shape) == (1, 2)
    assert tr.step_def.layout.fsdp         # reduced qwen3 at (1, 2)


class _FakeMesh:
    """What a trainer reads of a DeviceMesh before its first step."""

    def __init__(self, shape, names=("data", "model")):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(names)
        self.device_type = "cpu"

    def size(self, i=None):
        return self.shape[i] if i is not None else int(np.prod(self.shape))

    def get_coordinate(self):
        return [0] * len(self.shape)

    def get_group(self, axis):
        return axis


def test_what_stays_refused_names_item_10b(world):
    """What training on a mesh still refuses: the wire over FSDP leaves,
    with the reference's reason (it cannot lower such a plan either).
    Several data axes train (the pod cells above; the (2, 2, 1) wire's
    checkpoint below), as SSM and hybrid archs do."""
    ranks = world[0]
    refused = ranks[0]["refused"]
    assert set(refused) == {"wire_over_fsdp"}
    assert "P(dp, *pspec)" in refused["wire_over_fsdp"]
    assert "cannot lower this plan either" in refused["wire_over_fsdp"]
    for i, r in enumerate(ranks[:4]):
        assert r["ckp_layout"] == (4, ("pod", "data"), i)


def test_checkpoint_on_2x2x1_resumes_on_1x1(world):
    """The wire's checkpoint written on the production mesh's (2, 2, 1)
    (residuals stacked ``(4, ...)`` over ``(pod, data)``, data-major)
    resumes on one card at step 2: the parameters exactly, each
    residual the mean of the four rows (what the slices still owe), and
    trains on."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core.pipeline import specialize
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import Trainer, TrainerConfig
    ranks, _, tmp = world
    saved = ranks[0]["ckp_whole"]
    params = _flat(saved["params"])
    for k, e in _flat(saved["opt"]["ef"]).items():
        assert tuple(e.shape) == (4, *params[k].shape), k
    arch = get_arch("qwen3-8b").reduced()
    tshape = ShapeConfig(**QUICK)
    plan = specialize(arch, tshape, mesh_axes=("data", "model"),
                      mesh_shape=(1, 1), target="tpu-v5e", cache=False,
                      grad_compression="on")
    tr = Trainer(plan, None, TrainerConfig(ckpt_dir=str(tmp / "ckp_0")),
                 opt_cfg=adamw.OptConfig.from_plan(plan, **_opt_kw()),
                 arch=arch, shape=tshape, device="cpu")
    st, step = tr.resume()
    assert step == 2
    assert _same({k: v.detach() for k, v in _flat(st["params"]).items()},
                 params)
    for k, e in _flat(st["opt"]["ef"]).items():
        stacked = _flat(saved["opt"]["ef"])[k]
        assert torch.equal(e, stacked.float().mean(0).to(e.dtype)), k
    st, _ = tr.fit(st, n_steps=3, start_step=2)
    assert np.isfinite(tr.history[-1]["loss"])


@pytest.mark.parametrize("launcher", ["train", "serve", "train_mp",
                                      "serve_hybrid"])
def test_launchers_take_a_mesh_under_torchrun(launcher):
    """Both launchers' ``--mesh 1x2 --device cpu`` (and the train
    launcher's ``--model-parallel 2``, the reference's flag) under
    ``torchrun --standalone`` on two gloo ranks, through the shared
    ``launch.mesh.init_mesh``: rank 0 reports the (1, 2) plan and the
    run's end (reduced hymba-1.5b too: its attention and SSM heads
    split over the two ranks)."""
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    args = {"train": ["repro_torch.launch.train", "--mesh", "1x2",
                      "--steps", "2", "--seq-len", "32", "--batch", "4"],
            "train_mp": ["repro_torch.launch.train", "--model-parallel",
                         "2", "--steps", "2", "--seq-len", "32",
                         "--batch", "4"],
            "serve": ["repro_torch.launch.serve", "--mesh", "1x2",
                      "--requests", "2", "--new-tokens", "3",
                      "--max-len", "64", "--max-batch", "2"],
            "serve_hybrid": ["repro_torch.launch.serve", "--arch",
                             "hymba-1.5b", "--mesh", "1x2", "--requests",
                             "2", "--new-tokens", "3", "--max-len", "64",
                             "--max-batch", "2"]}[launcher]
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", *args, "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "mesh=(1, 2)" in out.stdout
    if launcher.startswith("serve"):
        assert out.stdout.count("served 2 requests, 6 tokens") == 1
    else:
        assert out.stdout.count("trained 2 steps") == 1


def test_a_cuda_mesh_without_a_card_raises(monkeypatch):
    """``make_host_mesh`` / ``init_mesh`` take the device type from the
    caller: a CUDA mesh where no card is visible raises, it never
    becomes a CPU one."""
    from repro_torch.launch import mesh as lmesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no card"):
        lmesh.make_host_mesh(1, device_type="cuda")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="no card"):
        lmesh.init_mesh("1x1", "cuda")
