"""Training parity for the MoE, SSM and hybrid families: the port against
the JAX package.

Reduced granite-moe-1b-a400m (8 experts top-2, under ``dense_einsum``
and ``gshard_einsum``), mamba2-2.7b, hymba-1.5b (attention through a
window beside an SSD mixer in each layer) and llama4-maverick's [dense,
MoE] super-blocks (a shared expert, top-1): the reference's parameters
cross into the port through ``repro_torch.models.convert``, the same
synthetic batch goes to both ``train_loss`` functions, and the loss, the
router's aux loss and every gradient leaf are held against ``jax.grad``
of the reference's, under remat ``none`` and ``full``.  The SSD chunk is
32 in both packages, so the 80-token sequences cross three chunks, the
last ragged.  The port runs on the CPU: attention through the flash
autograd function's plain pair, the scan through ``SSDScan``'s
(``ssd_scan_plain`` and ``ssd_scan_bwd_plain``).

Tolerances, as ``tests/test_torch_train.py`` states them: 2e-2 of the
largest magnitude in bf16 (the models' loss and gradients: the packages
round bf16 streams at other places), the aux loss within 2e-2 of the
reference's; 1e-5 in fp32.  An MoE layer's FFN gradients (its norm,
router and experts) are held in fp32 only: routing is discontinuous, and
the packages' bf16 roundings (an ulp of the normed input) flip near-tied
choices and, under ``gshard_einsum``, the capacity slots after them (the
reference's own bf16 run moves llama4's expert gradients by 40% from its
fp32 run; in fp32 the two packages agree within 1e-6 on every leaf), and
the router's gradient passes the softmax's backward, whose cancellation
leaves it 6% apart in bf16 where no choice flips (granite,
``dense_einsum``).  Every other leaf is held in bf16 too.
Recomputation under remat ``full`` repeats the same arithmetic, routing
included, so its loss and gradients equal those without remat
bitwise.  The quickstart flow (128 x 4 tokens, ten steps
from the same init through both packages' ``Trainer``) holds every
step's loss within 1e-3 of the reference's for one MoE and one SSM arch,
as ``tests/test_torch_train.py`` holds qwen3.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import ShapeConfig as RShape
from repro.configs import get_arch as rget_arch
from repro.core import specialize as rspecialize
from repro.data.pipeline import SyntheticSource as RSource
from repro.models import lm as rlm
from repro.optim import adamw as radamw
from repro.train.trainer import Trainer as RTrainer
from repro.train.trainer import TrainerConfig as RTrainerConfig
from repro_torch.ckpt import Checkpointer
from repro_torch.configs import ShapeConfig as TShape
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core import specialize as tspecialize
from repro_torch.kernels import ops
from repro_torch.models import convert
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw
from repro_torch.train import Trainer, TrainerConfig

F32_TOL, BF16_TOL = 1e-5, 2e-2
LOSS_BOUND = 1e-3
SHAPE = dict(name="families", kind="train", seq_len=80, global_batch=2)
QUICK = dict(name="quickstart", kind="train", seq_len=128, global_batch=4)
CHUNK = 32
ARCHS = {"granite": "granite-moe-1b-a400m", "mamba2": "mamba2-2.7b",
         "hymba": "hymba-1.5b", "llama4": "llama4-maverick-400b-a17b"}
#: (arch, MoE path): both paths of granite; llama4's super-blocks under
#: the path its plans pick at this size
CASES = [("granite", "dense_einsum"), ("granite", "gshard_einsum"),
         ("mamba2", "gshard_einsum"), ("hymba", "gshard_einsum"),
         ("llama4", "gshard_einsum")]


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _trainable(tree):
    if isinstance(tree, dict):
        return {k: _trainable(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(tree.is_floating_point())


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


_MODELS = {}


def _model(key):
    """Reduced ``key`` in both packages from the reference's init, and a
    batch of the synthetic source (cached per module)."""
    if key not in _MODELS:
        rarch = rget_arch(ARCHS[key]).reduced()
        tarch = tget_arch(ARCHS[key]).reduced()
        rparams = rlm.init_params(rarch, jax.random.PRNGKey(0))
        _MODELS[key] = dict(
            rarch=rarch, tarch=tarch, rparams=rparams,
            tparams=convert.params_from_numpy(tarch, _tree_np(rparams),
                                              device="cpu"),
            batch=RSource(rarch, RShape(**SHAPE), seed=0).batch_at(0))
    return _MODELS[key]


def _float32(tree):
    if isinstance(tree, dict):
        return {k: _float32(v) for k, v in tree.items()}
    return tree.float()


_PORT = {}


def _port(key, impl, remat, fp32=False):
    """The port's loss, aux loss, cross-entropy and gradients (cached),
    in the model's dtypes or with every parameter in fp32."""
    if (key, impl, remat, fp32) not in _PORT:
        m = _model(key)
        params = _trainable(_float32(m["tparams"]) if fp32
                            else m["tparams"])
        leaves = list(adamw.leaves(params))
        cfg = tlm.RunCfg(ssd_chunk=CHUNK, moe_impl=impl, remat=remat)
        batch = {k: torch.from_numpy(v) for k, v in m["batch"].items()}
        loss, metrics = tlm.train_loss(m["tarch"], params, batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
        _PORT[key, impl, remat, fp32] = (
            float(loss.detach()), float(metrics["aux_loss"].detach()),
            float(metrics["ce_loss"].detach()), grads)
    return _PORT[key, impl, remat, fp32]


def _reference(key, impl, remat, fp32=False):
    m = _model(key)
    params = m["rparams"]
    if fp32:
        params = jax.tree.map(lambda a: a.astype(np.float32), params)
    rcfg = rlm.RunCfg(ssd_chunk=CHUNK, moe_impl=impl, remat=remat)
    (want, rmet), gwant = jax.value_and_grad(
        lambda p: rlm.train_loss(m["rarch"], p, m["batch"], rcfg),
        has_aux=True)(params)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(gwant)[0]]
    return float(want), rmet, paths, jax.tree.leaves(gwant)


def _moe_ffn_leaf(arch, path: str) -> bool:
    """A leaf of an MoE layer's FFN: its norm, router or experts."""
    if not arch.is_moe:
        return False
    layer = "['blocks']['moe']" if arch.moe_interleave > 1 else "['blocks']"
    return path.startswith(layer + "['moe']") or \
        path == layer + "['mlp_norm']"


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("key,impl", CASES, ids=[f"{k}-{i}" if k in (
    "granite", "llama4") else k for k, i in CASES])
def test_train_loss_and_grads_match_reference_under_remat(key, impl, remat):
    m = _model(key)
    want, rmet, paths, wleaves = _reference(key, impl, remat)
    loss, aux, ce, grads = _port(key, impl, remat)
    assert _rel(loss, want) <= BF16_TOL
    assert _rel(ce, float(rmet["ce_loss"])) <= BF16_TOL
    assert np.isfinite(aux)
    assert abs(aux - float(rmet["aux_loss"])) <= BF16_TOL * max(
        abs(float(rmet["aux_loss"])), 1.0)
    if m["tarch"].is_moe:
        assert aux > 0 and loss == pytest.approx(
            ce + tlm.AUX_LOSS_WEIGHT * aux, rel=1e-6)
    else:
        assert aux == 0.0 and loss == ce
    assert len(grads) == len(wleaves)
    for path, g, w in zip(paths, grads, wleaves):
        assert g.shape == w.shape, path
        if not _moe_ffn_leaf(m["tarch"], path):
            assert _rel(_np(g), np.asarray(w, np.float32)) <= BF16_TOL, path
    # recomputation repeats the same arithmetic (and routing)
    base = _port(key, impl, "none")
    assert loss == base[0] and aux == base[1]
    assert all(torch.equal(a, b) for a, b in zip(grads, base[3]))


@pytest.mark.parametrize("key,impl", CASES, ids=[f"{k}-{i}" if k in (
    "granite", "llama4") else k for k, i in CASES])
def test_train_loss_and_grads_match_reference_in_fp32(key, impl):
    """Every parameter in fp32 in both packages: the loss, the aux loss
    and every gradient leaf, MoE leaves included, within 1e-5."""
    want, rmet, paths, wleaves = _reference(key, impl, "none", fp32=True)
    loss, aux, _, grads = _port(key, impl, "none", fp32=True)
    assert _rel(loss, want) <= F32_TOL
    assert abs(aux - float(rmet["aux_loss"])) <= F32_TOL * max(
        abs(float(rmet["aux_loss"])), 1.0)
    for path, g, w in zip(paths, grads, wleaves):
        assert _rel(_np(g), np.asarray(w, np.float32)) <= F32_TOL, path


@pytest.mark.parametrize("impl", ["dense_einsum", "gshard_einsum"])
def test_gradients_reach_the_router_and_every_expert(impl):
    """Both MoE paths train the router (through the gates and the aux
    loss) and the experts: on granite's dense path every expert's slice
    of wi and wo, on the capacity path every expert a token reached."""
    m = _model("granite")
    params = _trainable(m["tparams"])
    batch = {k: torch.from_numpy(v) for k, v in m["batch"].items()}
    loss, _ = tlm.train_loss(m["tarch"], params,  batch,
                             tlm.RunCfg(moe_impl=impl))
    moe = params["blocks"]["moe"]
    g_router, g_wi, g_wo = torch.autograd.grad(
        loss, [moe["router"], moe["wi"], moe["wo"]])
    assert g_router.abs().amax((1, 2)).min() > 0          # every layer
    reached = g_wi.float().abs().amax((2, 3)) > 0          # (L, E)
    assert torch.equal(reached, g_wo.float().abs().amax((2, 3)) > 0)
    assert reached.all() if impl == "dense_einsum" else reached.any(1).all()


def test_train_step_carries_the_aux_loss_to_the_metrics():
    """``lower_train_step`` on reduced granite: the step's loss is the
    cross-entropy plus the weighted aux loss, and both are reported."""
    from repro_torch.core.passes.lowering import lower_train_step
    m = _model("granite")
    shape = TShape(**SHAPE)
    plan = tspecialize(m["tarch"], shape, mesh_shape=(1, 1),
                       target="tpu-v5e")
    step = lower_train_step(plan, m["tarch"], shape)
    params = _trainable(m["tparams"])
    state = {"params": params, "opt": adamw.init_opt_state(
        params, adamw.OptConfig.from_plan(plan))}
    batch = {k: torch.from_numpy(v) for k, v in m["batch"].items()}
    _, metrics = step.fn(state, batch)
    aux, ce = float(metrics["aux_loss"]), float(metrics["ce_loss"])
    assert aux > 0 and float(metrics["loss"]) == pytest.approx(
        ce + 0.01 * aux, rel=1e-6)


@pytest.mark.parametrize("key", ["granite", "mamba2"])
def test_quickstart_flow_tracks_the_reference(key, tmp_path):
    """Reduced ``key``, 128 tokens x 4, ten steps through both packages'
    Trainer from the same init (tpu-v5e plans, whose hashes the port
    keeps)."""
    rarch = rget_arch(ARCHS[key]).reduced()
    tarch = tget_arch(ARCHS[key]).reduced()
    rshape, tshape = RShape(**QUICK), TShape(**QUICK)
    rplan = rspecialize(rarch, rshape, mesh_shape=(1, 1))
    tplan = tspecialize(tarch, tshape, mesh_shape=(1, 1), target="tpu-v5e")
    assert tplan.content_hash() == rplan.content_hash()
    rtr = RTrainer(rplan, _mesh(), RTrainerConfig(
        n_steps=10, ckpt_every=0, log_every=100,
        ckpt_dir=str(tmp_path / "r")),
        opt_cfg=radamw.OptConfig(total_steps=10), arch=rarch, shape=rshape)
    rinit = _tree_np(rtr.init_state(0))
    rtr.fit()
    ttr = Trainer(tplan, None, TrainerConfig(
        n_steps=10, ckpt_every=0, log_every=100,
        ckpt_dir=str(tmp_path / "t")),
        opt_cfg=adamw.OptConfig(total_steps=10), arch=tarch, shape=tshape,
        device="cpu")
    ttr.fit(jax.tree.map(lambda a: convert.tensor_from_numpy(a, "cpu"),
                         rinit))
    want = [h["loss"] for h in rtr.history]
    got = [h["loss"] for h in ttr.history]
    assert len(got) == len(want) == 10
    assert max(abs(a - b) for a, b in zip(got, want)) <= LOSS_BOUND, \
        (got, want)


def test_train_launcher_runs_reduced_mamba2_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train as launch_train
    ops.reset_launch_counts()
    launch_train.main(["--arch", "mamba2-2.7b", "--device", "cpu",
                       "--steps", "2", "--seq-len", "48", "--batch", "2",
                       "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "plan decisions:" in out and "trained 2 steps" in out
    assert "ssd_scan" in out                # the plan's SSD tile decision
    assert Checkpointer(tmp_path).latest_step() == 2
    assert ops.launch_counts()["ssd_scan_bwd"] == 0       # CPU: no kernel
