"""Training parity: the port's training slice against the JAX package's.

Inputs are made with numpy and handed to both packages; JAX parameters
cross into the port through ``repro_torch.models.convert``.  The port
runs on the CPU: attention through the flash autograd function's plain
forward and plain backward.  JAX meshes here are ``jax.sharding.Mesh``
over the one CPU device (auto axes), so the reference's sharded step
runs unsharded.

Tolerances, as ``tests/test_kernels.py`` states them: 1e-5 of the
largest magnitude in fp32 (the attention backward, the loss, AdamW's
arithmetic, the lr schedule, the norm), 2e-2 in bf16 (the model's loss
and gradients: both packages round bf16 streams at other places).
AdamW's bf16 parameters under the master path round the same fp32 value
to nearest; an fp32 value within an ulp of a bf16 tie may round the
other way, so at most 1e-3 of them may differ, by one bf16 ulp.  The
quickstart flow (reduced qwen3-8b, 128 x 4 tokens, 10 steps from the
same init) holds every step's loss within :data:`LOSS_BOUND` of the
reference's: the two bf16 models' losses differed by at most 7.8e-5 over
the ten steps on the CPU (the warmup's small steps keep the trajectories
close), so the bound leaves a factor of ten.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.ckpt.checkpointer import Checkpointer as RCheckpointer
from repro.configs import ShapeConfig as RShape
from repro.configs import get_arch as rget_arch
from repro.core import specialize as rspecialize
from repro.core.passes.lowering import build_run_cfg as rbuild_run_cfg
from repro.core.passes.lowering import lower_train_step as rlower_train_step
from repro.data.pipeline import SyntheticSource as RSource
from repro.kernels import ref as rref
from repro.models import attention as rattn
from repro.models import common as rcommon
from repro.models import lm as rlm
from repro.optim import adamw as radamw
from repro.train.trainer import Trainer as RTrainer
from repro.train.trainer import TrainerConfig as RTrainerConfig
from repro_torch.ckpt import Checkpointer
from repro_torch.configs import ShapeConfig as TShape
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core import specialize as tspecialize
from repro_torch.core.passes.lowering import build_run_cfg, lower_train_step
from repro_torch.data import PrefetchPipeline, SyntheticSource, to_device
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.models import common as tcommon
from repro_torch.models import convert
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw
from repro_torch.train import Trainer, TrainerConfig

F32_TOL, BF16_TOL = 1e-5, 2e-2
LOSS_BOUND = 1e-3
QUICK = dict(name="quickstart", kind="train", seq_len=128, global_batch=4)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _to_torch(tree):
    """A JAX state tree (numpy leaves) as CPU tensors, bf16 by its words."""
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return convert.tensor_from_numpy(np.asarray(tree), "cpu")


def _trainable(tree):
    """A copy of a tensor tree whose float leaves require grad."""
    if isinstance(tree, dict):
        return {k: _trainable(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(tree.is_floating_point())


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


# ---------------------------------------------------------------------
# the attention backward
# ---------------------------------------------------------------------

BWD_CASES = [  # (B, S, K, G, D, causal, window)
    (1, 64, 2, 1, 64, True, 0),
    (2, 37, 2, 4, 64, True, 0),        # ragged S
    (1, 50, 1, 5, 64, True, 16),       # hymba's group, a window
    (1, 45, 1, 7, 128, True, 0),       # G = 7
    (1, 40, 2, 4, 128, False, 0),
    (1, 70, 1, 4, 128, True, 24),
]


def _bwd_inputs(case, seed=0):
    B, S, K, G, D, _, _ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, S, K * G, D), (B, S, K, D), (B, S, K, D), (B, S, K * G, D))]


@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_flash_bwd_plain_matches_jax_vjp_and_torch_autograd(case):
    *_, causal, window = case
    q, k, v, do = _bwd_inputs(case)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tfa.flash_attention_plain(tq, tk, tv, causal=causal,
                                       window=window, return_lse=True)
    got = tfa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo,
                                        causal=causal, window=window)

    def chunked(q, k, v):
        return rattn.attention_chunked(q, k, v, causal=causal,
                                       window=window, block_q=16)

    def reference(q, k, v):
        return rref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window)

    for fn in (chunked, reference):
        out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k),
                           jnp.asarray(v))
        assert _rel(_np(o), out) <= F32_TOL
        for g, w in zip(got, vjp(jnp.asarray(do))):
            assert _rel(_np(g), w) <= F32_TOL, fn.__name__
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    auto = torch.autograd.grad(
        tfa.flash_attention_plain(*leaves, causal=causal, window=window),
        leaves, tdo)
    for g, w in zip(got, auto):
        assert _rel(_np(g), _np(w)) <= F32_TOL


def test_ops_flash_attention_routes_gradients_through_the_plain_pair():
    case = BWD_CASES[1]
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _bwd_inputs(case, seed=1))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.reset_launch_counts()
    out = ops.flash_attention(*leaves, causal=True)
    got = torch.autograd.grad(out, leaves, do)
    o, lse = tfa.flash_attention_plain(q, k, v, return_lse=True)
    want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and torch.equal(g, w)
    assert torch.equal(out.detach(), o)
    assert ops.launch_counts()["flash_attention_bwd"] == 0   # CPU: no kernel
    with torch.no_grad():                    # serving: the forward alone
        assert not ops.flash_attention(*leaves).requires_grad
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        tfa.flash_attention_bwd(q, k, v, o, lse, do)


# ---------------------------------------------------------------------
# loss, optimizer, schedule
# ---------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(2)
    logits = (3 * rng.standard_normal((2, 9, 40))).astype(np.float32)
    targets = rng.integers(0, 33, (2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) < 0.6).astype(np.float32) if masked else None

    def rloss(x):
        return rcommon.cross_entropy_loss(
            x, jnp.asarray(targets),
            None if mask is None else jnp.asarray(mask), vocab_size=33)

    (want, n), gwant = jax.value_and_grad(rloss, has_aux=True)(
        jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    got, tn = tcommon.cross_entropy_loss(
        t, torch.from_numpy(targets),
        None if mask is None else torch.from_numpy(mask), vocab_size=33)
    (g,) = torch.autograd.grad(got, [t])
    assert _rel(float(got.detach()), float(want)) <= F32_TOL
    assert float(tn) == float(n)
    assert _rel(_np(g), gwant) <= F32_TOL
    assert float(g[..., 33:].abs().max()) == 0.0      # the padded slots


def _opt_tree(rng):
    return {"blocks": {"w": rng.standard_normal((2, 8, 16)),
                       "norm": rng.standard_normal((2, 16))},
            "embed": rng.standard_normal((32, 8))}


def _opt_inputs(seed):
    rng = np.random.default_rng(seed)
    params = _opt_tree(rng)
    rparams = {"blocks": {"w": jnp.asarray(params["blocks"]["w"],
                                           jnp.bfloat16),
                          "norm": jnp.asarray(params["blocks"]["norm"],
                                              jnp.float32)},
               "embed": jnp.asarray(params["embed"], jnp.bfloat16)}
    grads = [jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape) * 0.5, p.dtype), rparams)
        for _ in range(3)]
    return rparams, grads


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_master_path_matches_reference(moments):
    rparams, grads = _opt_inputs(3)
    rcfg = radamw.OptConfig(moment_dtype=moments, master_weights=True,
                            warmup_steps=2, total_steps=6)
    tcfg = adamw.OptConfig(moment_dtype=moments, master_weights=True,
                           warmup_steps=2, total_steps=6)
    rstate = radamw.init_opt_state(rparams, rcfg)
    tparams = _to_torch(_tree_np(rparams))
    tstate = adamw.init_opt_state(tparams, tcfg)
    for g in grads:
        rparams, rstate, rm = radamw.apply_updates(rparams, g, rstate, rcfg)
        tparams, tstate, tm = adamw.apply_updates(
            tparams, _to_torch(_tree_np(g)), tstate, tcfg)
        assert _rel(float(tm["grad_norm"]), float(rm["grad_norm"])) <= F32_TOL
        assert _rel(tm["lr"], float(rm["lr"])) <= F32_TOL
    assert int(tstate["step"]) == int(rstate["step"]) == 3
    for name in ("m", "v", "master"):
        got, want = _flat(tstate[name]), _flat(_tree_np(rstate[name]))
        for key in want:
            tol = F32_TOL if moments == "float32" or name == "master" \
                else BF16_TOL / 8          # one bf16 ulp (2^-8)
            assert _rel(_np(got[key]), want[key]) <= tol, (name, key)
    got, want = _flat(tparams), _flat(_tree_np(rparams))
    for key in want:
        g, w = _np(got[key]), np.asarray(want[key], np.float32)
        differ = g != w
        assert differ.mean() <= 1e-3, key
        assert np.all(np.abs(g - w)[differ] <= np.abs(w[differ]) * 2 ** -7)


def test_adamw_stochastic_rounding_neighbours_and_unbiased():
    """No master copy: every bf16 element lands on one of the two bf16
    neighbours of its fp32 update (the master path's value), the same
    pair as the reference's; the norm leaf (fp32) is the fp32 update."""
    rparams, grads = _opt_inputs(4)
    kw = dict(moment_dtype="bfloat16", warmup_steps=1, total_steps=4,
              peak_lr=3e-2)
    sr = {}
    for master in (True, False):
        rcfg = radamw.OptConfig(master_weights=master, **kw)
        tcfg = adamw.OptConfig(master_weights=master, **kw)
        tparams = _to_torch(_tree_np(rparams))
        rp, rs, _ = radamw.apply_updates(
            rparams, grads[0], radamw.init_opt_state(rparams, rcfg), rcfg)
        tp, ts, _ = adamw.apply_updates(
            tparams, _to_torch(_tree_np(grads[0])),
            adamw.init_opt_state(tparams, tcfg), tcfg)
        sr[master] = (_flat(_tree_np(rs.get("master", rp))),
                      _flat(_tree_np(rp)), _flat(tp))
    w32, _, _ = sr[True]
    _, rsr, tsr = sr[False]
    for key, w in w32.items():
        w = np.asarray(w, np.float32)
        if key == "blocks/norm":
            assert _rel(_np(tsr[key]), w) <= F32_TOL
            continue
        lo = (w.view(np.uint32) & 0xFFFF0000).view(np.float32)
        hi = ((w.view(np.uint32) & 0xFFFF0000) + 0x10000).view(np.float32)
        for got in (_np(tsr[key]), np.asarray(rsr[key], np.float32)):
            on_pair = (got == lo) | (got == hi)
            assert on_pair.mean() >= 0.999, key
    # unbiased: the mean of many draws of one value is the value
    gen = torch.Generator().manual_seed(0)
    for x in (1.0 + 0.3 * 2 ** -7, -3.0 - 0.71 * 2 ** -6, 0.1):
        xs = torch.full((200_000,), x, dtype=torch.float32)
        mean = float(adamw._stochastic_round_bf16(xs, gen).double().mean())
        ulp = 2.0 ** (np.floor(np.log2(abs(x))) - 7)
        assert abs(mean - x) <= 5 * ulp * 0.5 / np.sqrt(xs.numel())


def test_lr_schedule_and_global_norm_match_reference():
    cfg, rcfg = adamw.OptConfig(), radamw.OptConfig()
    for step in (0, 1, 50, 99, 100, 101, 4000, 9999, 10_000, 20_000):
        want = float(radamw.lr_schedule(rcfg, jnp.asarray(step, jnp.int32)))
        assert abs(float(adamw.lr_schedule(cfg, step)) - want) \
            <= F32_TOL * rcfg.peak_lr
    rparams, _ = _opt_inputs(5)
    want = float(radamw.global_norm(rparams))
    got = float(adamw.global_norm(_to_torch(_tree_np(rparams))))
    assert _rel(got, want) <= F32_TOL


# ---------------------------------------------------------------------
# the model's loss and gradients, the lowered step
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def reduced():
    """Reduced qwen3-8b in both packages from the reference's init, a
    batch of the synthetic source, and both RunCfgs (tpu-v5e plans,
    whose hashes the port keeps)."""
    rarch = rget_arch("qwen3-8b").reduced()
    tarch = tget_arch("qwen3-8b").reduced()
    rshape, tshape = RShape(**QUICK), TShape(**QUICK)
    rplan = rspecialize(rarch, rshape, mesh_shape=(1, 1))
    tplan = tspecialize(tarch, tshape, mesh_shape=(1, 1), target="tpu-v5e")
    assert tplan.content_hash() == rplan.content_hash()
    rparams = rlm.init_params(rarch, jax.random.PRNGKey(0),
                              *rplan.padded_sizes())
    batch = RSource(rarch, rshape, seed=0).batch_at(0)
    return dict(rarch=rarch, tarch=tarch, rshape=rshape, tshape=tshape,
                rplan=rplan, tplan=tplan, rparams=rparams, batch=batch,
                tparams=convert.params_from_numpy(
                    tarch, _tree_np(rparams), device="cpu"))


def _port_grads(m, remat):
    params = _trainable(m["tparams"])
    leaves = list(adamw.leaves(params))
    cfg = dataclasses.replace(build_run_cfg(m["tplan"], m["tarch"]),
                              remat=remat)
    batch = {k: torch.from_numpy(v) for k, v in m["batch"].items()}
    loss, _ = tlm.train_loss(m["tarch"], params, batch, cfg)
    return float(loss.detach()), torch.autograd.grad(loss, leaves)


@pytest.fixture(scope="module")
def port_grads(reduced):
    return {r: _port_grads(reduced, r)
            for r in ("none", "full", "dots_saveable")}


@pytest.mark.parametrize("remat", ["none", "full", "dots_saveable"])
def test_train_loss_and_grads_match_reference_under_remat(reduced,
                                                          port_grads,
                                                          remat):
    m = reduced
    rcfg = dataclasses.replace(rbuild_run_cfg(m["rplan"], m["rarch"], None),
                               remat=remat)
    (want, _), gwant = jax.value_and_grad(
        lambda p: rlm.train_loss(m["rarch"], p, m["batch"], rcfg),
        has_aux=True)(m["rparams"])
    loss, grads = port_grads[remat]
    assert _rel(loss, float(want)) <= BF16_TOL
    for g, w in zip(grads, jax.tree.leaves(gwant)):
        assert _rel(_np(g), np.asarray(w, np.float32)) <= BF16_TOL
    # recomputation repeats the same arithmetic: equal to no remat
    base_loss, base = port_grads["none"]
    assert loss == base_loss
    assert all(torch.equal(a, b) for a, b in zip(grads, base))


def test_remat_policy_is_checked():
    with pytest.raises(ValueError, match="remat policy"):
        tlm._remat(lambda x: x, "offload")


def test_lower_train_step_with_two_microbatches(reduced):
    m = reduced
    rplan = dataclasses.replace(
        m["rplan"], comm=dataclasses.replace(m["rplan"].comm,
                                             microbatches=2))
    tplan = dataclasses.replace(
        m["tplan"], comm=dataclasses.replace(m["tplan"].comm,
                                             microbatches=2))
    ropt = radamw.OptConfig.from_plan(rplan, total_steps=10)
    topt = adamw.OptConfig.from_plan(tplan, total_steps=10)
    rstep = rlower_train_step(rplan, m["rarch"], m["rshape"], _mesh(), ropt)
    rstate = {"params": m["rparams"],
              "opt": radamw.init_opt_state(m["rparams"], ropt)}
    rstate, rmet = jax.jit(rstep.fn)(rstate, m["batch"])
    tstep = lower_train_step(tplan, m["tarch"], m["tshape"], None, topt)
    tparams = _trainable(_to_torch(_tree_np(m["rparams"])))
    tstate = {"params": tparams, "opt": adamw.init_opt_state(tparams, topt)}
    batch = {k: torch.from_numpy(v) for k, v in m["batch"].items()}
    tstate, tmet = tstep.fn(tstate, batch)
    for key in ("loss", "grad_norm", "tokens"):
        assert _rel(float(tmet[key]), float(rmet[key])) <= BF16_TOL, key
    got, want = _flat(tstate["params"]), _flat(_tree_np(rstate["params"]))
    for key in want:
        assert _rel(_np(got[key]), want[key]) <= BF16_TOL, key
    assert int(tstate["opt"]["step"]) == 1


def test_post_reduce_error_feedback_on_one_card_matches_the_reference(
        reduced):
    """A plan that compresses gradients without lowering the wire (one
    card: no data degree) runs ``ef_compress`` on each gradient with one
    bf16 residual a leaf, as the reference's step does
    (``src/repro/core/passes/lowering.py:391-405``)."""
    from repro.dist.collectives import ef_state as ref_state

    from repro_torch.dist.collectives import ef_state
    m = reduced
    rplan = rspecialize(m["rarch"], m["rshape"], mesh_shape=(1, 1),
                        grad_compression="on")
    tplan = tspecialize(m["tarch"], m["tshape"], mesh_shape=(1, 1),
                        target="tpu-v5e", grad_compression="on")
    assert tplan.content_hash() == rplan.content_hash()
    assert tplan.comm.compresses_gradients
    assert "grad_compress_lowered" not in tplan.estimates
    # eps = 1: an update about lr * m, linear in the gradients (at the
    # default eps an element whose gradient changes sign between the two
    # steps moves by a whole lr on a rounding-level difference)
    kw = dict(total_steps=10, peak_lr=1e-2, warmup_steps=1, eps=1.0)
    ropt = radamw.OptConfig.from_plan(rplan, **kw)
    topt = adamw.OptConfig.from_plan(tplan, **kw)
    rstep = jax.jit(rlower_train_step(rplan, m["rarch"], m["rshape"],
                                      _mesh(), ropt).fn)
    ropt_state = radamw.init_opt_state(m["rparams"], ropt)
    ropt_state["ef"] = ref_state(m["rparams"])
    rstate = {"params": m["rparams"], "opt": ropt_state}
    tstep = lower_train_step(tplan, m["tarch"], m["tshape"], None, topt)
    assert tstep.ef and not tstep.wire_dp
    tparams = _trainable(_to_torch(_tree_np(m["rparams"])))
    topt_state = adamw.init_opt_state(tparams, topt)
    topt_state["ef"] = ef_state(tparams)
    tstate = {"params": tparams, "opt": topt_state}
    batch = {k: torch.from_numpy(v) for k, v in m["batch"].items()}
    for _ in range(2):
        rstate, rmet = rstep(rstate, m["batch"])
        tstate, tmet = tstep.fn(tstate, batch)
        for key in ("loss", "grad_norm"):
            assert _rel(float(tmet[key]), float(rmet[key])) <= BF16_TOL, key
    which = "master" if tplan.opt["master_weights"] else None
    got = _flat(tstate["opt"][which] if which else tstate["params"])
    want = _flat(_tree_np(rstate["opt"][which] if which
                          else rstate["params"]))
    init = _flat(_tree_np(m["rparams"]))
    for key in want:
        assert _rel(_np(got[key]), want[key]) <= BF16_TOL, key
        # the update itself (the parameters move by about lr * m, far
        # inside the bar above): its change against the reference's
        dw = np.asarray(want[key], np.float64) - np.asarray(init[key],
                                                            np.float64)
        dg = _np(got[key]).astype(np.float64) - np.asarray(init[key],
                                                           np.float64)
        err = np.linalg.norm(dg - dw) / max(np.linalg.norm(dw), 1e-30)
        assert err <= 5e-2, (key, err)
    # the residuals: bf16, one a leaf, each under half its block's code
    # step (a rounding-level difference in g moves a code by one step,
    # so they are held by size, not element by element)
    gef, wef = _flat(tstate["opt"]["ef"]), _flat(_tree_np(
        rstate["opt"]["ef"]))
    for key in wef:
        assert gef[key].dtype == torch.bfloat16
        assert tuple(gef[key].shape) == wef[key].shape
        rms = float(gef[key].float().square().mean().sqrt())
        wrms = float(np.sqrt(np.mean(np.asarray(wef[key], np.float32) ** 2)))
        assert 0.5 * wrms <= rms <= 2 * wrms, (key, rms, wrms)


def test_error_feedback_chunks_give_the_whole_leaf_codes(monkeypatch,
                                                        tmp_path):
    """The step's error feedback and wire run a leaf ``adamw.CHUNK``
    elements at a time: bit for bit the whole leaf's ``ef_compress`` and
    ``compressed_psum`` (here with a 256-element chunk, on a one-rank
    gloo group)."""
    import torch.distributed as dist

    from repro_torch.core.passes import lowering
    from repro_torch.dist.collectives import compressed_psum, ef_compress
    g = torch.Generator().manual_seed(3)
    grads = [torch.randn(7, 300, generator=g).to(torch.bfloat16),
             torch.randn(1000, generator=g), torch.randn((), generator=g)]
    efs = [(torch.randn(t.shape, generator=g) * 1e-3).to(torch.bfloat16)
           for t in grads]
    want = [ef_compress(t, e) for t, e in zip(grads, efs)]
    monkeypatch.setattr(adamw, "CHUNK", 256)
    got_g, got_e = lowering._ef_compress([t.clone() for t in grads],
                                         [e.clone() for e in efs])
    for (wg, we), gg, ge in zip(want, got_g, got_e):
        assert torch.equal(wg, gg) and torch.equal(we, ge)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                            rank=0, world_size=1)
    try:
        group = dist.new_group([0])
        want = []
        for t, e in zip(grads, efs):
            acc = t.float() + e.float()
            mean, err = compressed_psum(acc.reshape(-1) if acc.dim() == 0
                                        else acc, group)
            want.append((mean.reshape(t.shape).to(t.dtype),
                         err.reshape(e.shape).to(torch.bfloat16)))
        got_g, got_e = lowering._wire([t.clone() for t in grads],
                                      [e.clone() for e in efs],
                                      [(group, 1)])
    finally:
        dist.destroy_process_group()
    for (wg, we), gg, ge in zip(want, got_g, got_e):
        assert torch.equal(wg, gg) and torch.equal(we, ge)


class _Mesh:
    """What ``MeshLayout`` and the refusals read of a DeviceMesh, for one
    coordinate of a mesh without a process group."""

    def __init__(self, shape, names=("data", "model"), coord=None,
                 device_type="cpu"):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(names)
        self._coord = list(coord or [0] * len(shape))
        self.device_type = device_type

    def size(self, i=None):
        return self.shape[i] if i is not None else int(np.prod(self.shape))

    def get_coordinate(self):
        return self._coord

    def get_group(self, axis):
        return f"group:{axis}"


def _mesh_plan(arch, mesh, **kw):
    return tspecialize(arch, TShape(**dict(QUICK, seq_len=64,
                                           global_batch=8)),
                       mesh_axes=("data", "model"), mesh_shape=mesh,
                       target="h100-sxm", cache=False, **kw)


@pytest.mark.parametrize("case", ["ssm_on_model", "two_data_axes",
                                  "wire_over_fsdp", "device_type"])
def test_what_a_mesh_still_refuses(case):
    """What training on a mesh does not do raises before any weight:
    the wire over an FSDP split, with the reference's own reason; a mesh
    built for CUDA never trains on the CPU.  Several data axes
    (``two_data_axes``) are no longer refused: the layout splits the
    batch over ``(pod, data)`` under either gradient path.  An SSM arch whose mixer ``megatron_tp`` splits over ``model``
    is no longer refused: its SSM leaves are tensor-parallel pieces
    (split over ``model``, no FSDP gather, gradients summed over
    ``data``)."""
    from repro_torch.core.passes.lowering import mesh_refusals
    qwen = tget_arch("qwen3-8b").reduced()
    if case == "ssm_on_model":
        mam = tget_arch("mamba2-2.7b").reduced()
        plan = _mesh_plan(mam, (2, 2))
        assert plan.estimates["strategy"] == "megatron_tp"
        layout = mesh_refusals(plan, mam, _Mesh((2, 2)))
        places = layout.places["blocks"]["ssm"]
        assert set(places) == {"in_proj", "conv_w", "conv_b", "A_log", "D",
                               "dt_bias", "norm", "out_proj"}
        for name, pl in places.items():
            assert pl.split_axes == ("model",), name
            assert pl.gather is None and pl.reduce_axes == ("data",), name
        assert layout.piece_shape(places["A_log"]) == (
            mam.n_layers, mam.ssm_heads // 2)
    elif case == "two_data_axes":
        # no longer refused: the batch splits over (pod, data), one
        # linearised data group of 4, under the post-reduce EF and the
        # wire (wire_dp = pod x data)
        from repro_torch.core.passes.lowering import wire_compression
        pod = _Mesh((2, 2, 2), ("pod", "data", "model"))
        for gc in ("off", "on"):
            plan = tspecialize(qwen, TShape(**dict(QUICK, seq_len=64,
                                                   global_batch=8)),
                               mesh_axes=("pod", "data", "model"),
                               mesh_shape=(2, 2, 2), target="h100-sxm",
                               cache=False, grad_compression=gc)
            wire = wire_compression(plan, pod, qwen)
            assert wire == (4 if gc == "on" else 0)
            layout = mesh_refusals(plan, qwen, pod, wire_dp=wire)
            assert layout.batch_axes == ("pod", "data")
            assert layout.batch_count == 4 and plan.comm.compress_pod_grads
    elif case == "wire_over_fsdp":
        plan = _mesh_plan(qwen, (2, 1), grad_compression="on")
        plan = dataclasses.replace(plan, axis_rules=dict(
            plan.axis_rules, embed="data", flat_params=("data", "model")))
        with pytest.raises(NotImplementedError, match=r"P\(dp, \*pspec\)"):
            mesh_refusals(plan, qwen, _Mesh((2, 1)), wire_dp=2)
    else:
        plan = _mesh_plan(qwen, (1, 2))
        with pytest.raises(ValueError, match="cannot train on cpu"):
            Trainer(plan, _Mesh((1, 2), device_type="cuda"), arch=qwen,
                    shape=TShape(**dict(QUICK, seq_len=64, global_batch=8)),
                    device="cpu")


@pytest.mark.parametrize("layout", ["megatron_2x2", "fsdp_dp_1x2",
                                    "spill_2x1", "fsdp_dp_data_2x2",
                                    "hybrid_2x2"])
def test_mesh_layout_reads_the_placements(layout):
    """``MeshLayout``: which dim of a leaf is an FSDP split (gathered at
    use, its gradient reduce-scattered), which axes a gradient is summed
    over, the rank's piece and batch rows, for each strategy's rules."""
    from repro_torch.dist.fsdp import MeshLayout
    qwen = tget_arch("qwen3-8b").reduced()
    name, shape = layout.rsplit("_", 1)
    mesh = tuple(int(x) for x in shape.split("x"))
    plan = _mesh_plan(qwen, mesh)
    rules = {"spill": dict(embed="data", flat_params=("data", "model")),
             "fsdp_dp_data": dict(batch=("data", "model"), embed="data",
                                  heads=None, kv_heads=None, ff=None,
                                  vocab=None, experts=None),
             "hybrid": dict(batch="data", embed=("data", "model"),
                            heads=None, kv_heads=None, ff=None, vocab=None,
                            experts=None)}.get(name)
    if rules:
        plan = dataclasses.replace(plan, axis_rules=dict(plan.axis_rules,
                                                         **rules))
    lay = MeshLayout(plan, qwen, _Mesh(mesh, coord=[mesh[0] - 1,
                                                     mesh[1] - 1]))
    wq = lay.places["blocks"]["attn"]["wq"]
    qn = lay.places["blocks"]["attn"]["q_norm"]
    if name == "megatron":
        assert plan.estimates["strategy"] == "megatron_tp"
        assert not lay.fsdp and wq.spec == (None, None, "model")
        assert wq.reduce_axes == ("data",) and wq.piece == 1
        assert qn.split_axes == () and qn.reduce_axes == ("data",)
        assert lay.batch_axes == ("data",) and lay.batch_index == 1
    elif name == "fsdp_dp":
        assert plan.estimates["strategy"] == "fsdp_dp"
        g = wq.gather
        assert g.dim == 1 and g.rep == 1 and g.extra == ()
        assert [n for _, n in g.groups] == [2] and wq.reduce_axes == ()
        assert qn.reduce_axes == ("model",)
        assert lay.batch_axes == ("model",) and lay.batch_count == 2
    elif name == "spill":
        g = wq.gather
        assert wq.spec == (None, "data", "model")
        assert g.dim == 1 and [n for _, n in g.groups] == [2]
        assert wq.piece == 1 and wq.split_axes == ("data", "model") \
            or wq.split_axes == ("data",)
    elif name == "fsdp_dp_data":
        g = wq.gather
        assert [n for _, n in g.groups] == [2] and g.rep == 1
        assert [n for _, n in g.extra] == [2]        # summed over model too
        assert lay.batch_count == 4 and lay.batch_index == 3
    else:
        g = wq.gather
        assert [n for _, n in g.groups] == [2, 2] and g.rep == 2
        assert g.extra == () and lay.batch_count == 2
    rows = torch.arange(8)[:, None].expand(8, 3)
    got = lay.batch_rows(rows, 0)
    n = 8 // lay.batch_count
    assert torch.equal(got[:, 0], torch.arange(lay.batch_index * n,
                                               (lay.batch_index + 1) * n))


def test_wire_compression_takes_the_live_mesh():
    qwen = tget_arch("qwen3-8b").reduced()
    plan = _mesh_plan(qwen, (2, 1), grad_compression="on")
    assert plan.estimates["grad_compress_lowered"] == 2.0
    from repro_torch.core.passes.lowering import wire_compression
    assert wire_compression(plan, _Mesh((2, 1)), qwen) == 2
    assert wire_compression(plan, {"data": 4, "model": 1}, qwen) == 4
    assert wire_compression(plan, _Mesh((1, 2)), qwen) == 0
    assert wire_compression(_mesh_plan(qwen, (1, 2), grad_compression="on"),
                            _Mesh((1, 2)), qwen) == 0          # fsdp_dp


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2), (2, 2)])
def test_step_estimate_counts_each_rank_share(mesh):
    """On a split plan the step-peak estimate's gradients are each
    parameter's bytes over its shard factor (the IR's placements), with
    the fp32 microbatch sum besides; the logits' region is the rank's
    vocab piece."""
    from repro_torch.core.costmodel import MeshModel, spec_shards
    from repro_torch.core.describe import describe_program
    from repro_torch.core.ir import Role
    qwen = tget_arch("qwen3-8b").reduced()
    shape = TShape(**dict(QUICK, seq_len=64, global_batch=8))
    plan = _mesh_plan(qwen, mesh)
    one = _mesh_plan(qwen, (1, 1))
    mm = MeshModel(("data", "model"), mesh)
    ir = describe_program(qwen, shape)
    params = ir.by_role(Role.PARAM, Role.EXPERT_PARAM)
    share = sum(t.nbytes // spec_shards(plan.placements[t.name].spec, mm)
                for t in params)
    whole = sum(t.nbytes for t in params)
    micro = 3 if plan.comm.microbatches > 1 else 1
    assert plan.estimates["step_grad_bytes"] == share * micro
    assert one.estimates["step_grad_bytes"] == whole
    if mesh[1] > 1:
        assert share < whole


def test_one_device_plans_keep_their_hashes_and_estimates():
    """``tests/torch_one_device_plans.json``: each one-device h100-sxm
    train plan's content hash and step-peak estimate as they were before
    the per-rank estimate (six archs, full and reduced): a (1, 1) plan
    keeps both bit for bit.  The five reduced plans' hashes were pinned
    again when the flash kernel's groups took in G = 3: their head_dim
    32 gets no kernel tile, and the logged reason lists the groups."""
    import json
    from pathlib import Path
    pinned = json.loads((Path(__file__).parent
                         / "torch_one_device_plans.json").read_text())
    assert len(pinned) == 18
    for key, (h, peak) in pinned.items():
        name, cfg, size = key.split("/")
        S, B = (int(x) for x in size.split("x"))
        arch = tget_arch(name) if cfg == "full" else \
            tget_arch(name).reduced()
        plan = tspecialize(arch, TShape("t", "train", S, B),
                           mesh_axes=("data", "model"), mesh_shape=(1, 1),
                           target="h100-sxm", cache=False)
        assert plan.content_hash() == h, key
        assert plan.estimates.get("step_peak_bytes") == peak, key


# ---------------------------------------------------------------------
# data, checkpoints, the trainer
# ---------------------------------------------------------------------

def test_deadline_skipper_matches_reference():
    from repro.runtime import straggler as rstrag
    from repro_torch.runtime import straggler as tstrag
    waits = [0.1] * 9 + [0.5, 0.1, 0.9, 0.05] + [1.0] * 12
    verdicts = []
    for mod in (rstrag, tstrag):
        timer, skipper = mod.StepTimer(), mod.DeadlineSkipper(max_skips=4)
        got = []
        for step, w in enumerate(waits):
            got.append(skipper.should_skip(step, w, timer))
            timer.observe(0.1 + 0.01 * (step % 3))
        verdicts.append((got, skipper.skipped_steps, skipper.skips))
    assert verdicts[0] == verdicts[1]
    assert verdicts[1][2] == 4                     # bounded by max_skips


@pytest.mark.parametrize("arch,kind", [("qwen3-8b", "train"),
                                       ("qwen3-8b", "decode"),
                                       ("hubert-xlarge", "train"),
                                       ("qwen2-vl-72b", "train")])
def test_synthetic_source_is_bit_identical(arch, kind):
    rarch, tarch = rget_arch(arch).reduced(), tget_arch(arch).reduced()
    rs = RSource(rarch, RShape("t", kind, 32, 4), seed=7)
    ts = SyntheticSource(tarch, TShape("t", kind, 32, 4), seed=7)
    for step in (0, 3, 11):
        want, got = rs.batch_at(step), ts.batch_at(step)
        assert sorted(want) == sorted(got)
        for k in want:
            assert want[k].dtype == got[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_prefetch_pipeline_yields_steps_in_order_as_tensors():
    arch = tget_arch("qwen3-8b").reduced()
    src = SyntheticSource(arch, TShape("t", "train", 16, 2), seed=1)
    pipe = PrefetchPipeline(src, prefetch_depth=3, start_step=5,
                            device_put=to_device("cpu"))
    try:
        for want_step in range(5, 12):
            step, batch = next(pipe)
            assert step == want_step
            np.testing.assert_array_equal(batch["tokens"].numpy(),
                                          src.batch_at(step)["tokens"])
    finally:
        pipe.close()
    with pytest.raises(StopIteration):
        next(pipe)


def _ckpt_state(m):
    ropt = radamw.OptConfig.from_plan(m["rplan"])
    rstate = {"params": m["rparams"],
              "opt": radamw.init_opt_state(m["rparams"], ropt)}
    rstate["opt"]["m"] = jax.tree.map(lambda x: x + 0.25, rstate["opt"]["m"])
    return rstate


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_cross_packages_bit_for_bit(reduced, tmp_path, writer):
    rstate = _ckpt_state(reduced)
    meta = {"plan_hash": "abc", "arch": "qwen3-8b"}
    rdir, tdir = tmp_path / "r", tmp_path / "t"
    RCheckpointer(rdir).save(3, rstate, meta=meta, blocking=True)
    Checkpointer(tdir).save(3, _to_torch(_tree_np(rstate)), meta=meta,
                            blocking=True)
    rman = json.loads((rdir / "step_00000003" / "manifest.json").read_text())
    tman = json.loads((tdir / "step_00000003" / "manifest.json").read_text())
    for man in (rman, tman):
        man.pop("time")
    assert tman == rman
    src = rdir if writer == "jax" else tdir
    got, man = Checkpointer(src).restore(device="cpu")
    rgot, _ = RCheckpointer(src).restore()
    want = _flat(_tree_np(rstate))
    assert man["step"] == 3 and sorted(_flat(got)) == sorted(want)
    for key, w in want.items():
        for g in (_flat(got)[key], _flat(rgot)[key]):
            g = np.asarray(g) if not isinstance(g, torch.Tensor) else (
                g.view(torch.int16).numpy().view(np.uint16)
                if g.dtype == torch.bfloat16 else g.numpy())
            wb = w.view(np.uint16) if w.dtype.name == "bfloat16" else w
            gb = g.view(np.uint16) if g.dtype.name == "bfloat16" else g
            assert gb.dtype == wb.dtype and np.array_equal(gb, wb), key
    assert Checkpointer(src).validate(3)


def _small_trainer(m, tmp_path, **kw):
    cfg = TrainerConfig(n_steps=4, ckpt_every=2, ckpt_dir=str(tmp_path),
                        log_every=100)
    return Trainer(m["tplan"], None, dataclasses.replace(cfg, **kw),
                   adamw.OptConfig.from_plan(m["tplan"], total_steps=10),
                   arch=m["tarch"], shape=m["tshape"], device="cpu")


def test_trainer_resume_replays_bitwise_and_warm_starts(reduced, tmp_path,
                                                        capsys):
    m = reduced
    whole = _small_trainer(m, tmp_path / "whole", ckpt_every=0)
    end, _ = whole.fit()
    first = _small_trainer(m, tmp_path / "run", n_steps=2)
    first.fit()
    assert first.ckpt.latest_step() == 2
    assert first.ckpt.plan_hash() == m["tplan"].content_hash()
    again = _small_trainer(m, tmp_path / "run")
    state, step = again.resume()
    assert step == 2
    state, _ = again.fit(state, start_step=step)
    assert [h["loss"] for h in again.history] == \
        [h["loss"] for h in whole.history[2:]]
    for a, b in zip(adamw.leaves(state), adamw.leaves(end)):
        assert torch.equal(a.detach(), b.detach())
    warm = Trainer.warm_start(tmp_path / "run", device="cpu",
                              arch=m["tarch"], shape=m["tshape"])
    assert warm.plan_hash == m["tplan"].content_hash()
    # a trainer under other decisions: resume still restores, and says so
    other = dataclasses.replace(
        m["tplan"], comm=dataclasses.replace(m["tplan"].comm,
                                             prefetch_depth=3))
    moved = Trainer(other, None, TrainerConfig(ckpt_dir=str(tmp_path / "run")),
                    arch=m["tarch"], shape=m["tshape"], device="cpu")
    capsys.readouterr()
    moved.resume()
    assert "plan hash changed" in capsys.readouterr().out


def test_quickstart_flow_tracks_the_reference(reduced, tmp_path):
    """``examples/quickstart.py``: reduced qwen3-8b, 128 tokens x 4, ten
    steps through both packages' Trainer from the same init."""
    m = reduced
    rtr = RTrainer(m["rplan"], _mesh(), RTrainerConfig(
        n_steps=10, ckpt_every=0, log_every=100,
        ckpt_dir=str(tmp_path / "r")),
        opt_cfg=radamw.OptConfig(total_steps=10), arch=m["rarch"],
        shape=m["rshape"])
    rinit = _tree_np(rtr.init_state(0))
    rtr.fit()
    ttr = Trainer(m["tplan"], None, TrainerConfig(
        n_steps=10, ckpt_every=0, log_every=100,
        ckpt_dir=str(tmp_path / "t")),
        opt_cfg=adamw.OptConfig(total_steps=10), arch=m["tarch"],
        shape=m["tshape"], device="cpu")
    ttr.fit(_to_torch(rinit))
    want = [h["loss"] for h in rtr.history]
    got = [h["loss"] for h in ttr.history]
    assert len(got) == len(want) == 10
    assert max(abs(a - b) for a, b in zip(got, want)) <= LOSS_BOUND, \
        (got, want)


def test_train_launcher_runs_reduced_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train as launch_train
    launch_train.main(["--device", "cpu", "--steps", "2", "--seq-len", "32",
                       "--batch", "2", "--ckpt-dir", str(tmp_path),
                       "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "plan decisions:" in out and "trained 2 steps" in out
    assert Checkpointer(tmp_path).latest_step() == 2
    # --model-parallel builds a mesh of torchrun's ranks
    with pytest.raises(SystemExit, match="torchrun"):
        launch_train.main(["--device", "cpu", "--model-parallel", "2"])
