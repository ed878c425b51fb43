"""The kernels without a backward refuse autograd, and serving still runs.

``ops.decode_attention``, ``ops.paged_decode_attention``,
``ops.matmul`` and K9's ``ops.decode_split_scores`` /
``ops.decode_split_context`` write their CUDA outputs through ctypes, so under autograd
those outputs would carry no ``grad_fn`` and a loss through them would
train nothing upstream (ROADMAP §3, F3).  Each entry raises when grad
mode is on and a tensor input requires grad, on the CPU as on the card,
and runs under ``torch.no_grad()``.  ``ops.ssd_scan`` has its backward
(``SSDScan``): its case holds that gradients take that route.  Serving
calls them with grad mode on and parameters that do not require grad:
the reduced qwen3 and mamba2 still prefill and decode, dense and paged,
with every output free of autograd history.  All on the CPU (the plain
versions).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.core import specialize
from repro_torch.core.passes.lowering import build_run_cfg
from repro_torch.kernels import ops
from repro_torch.models import lm


def _rnd(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _call(name, grad: bool):
    """One call of the ``ops`` entry ``name`` on small inputs made from a
    seed with numpy, its first tensor input requiring grad if ``grad``."""
    rng = np.random.default_rng(0)
    B, H, K, D, S = 2, 4, 2, 32, 16
    if name == "decode_attention":
        args = [_rnd(rng, B, H, D), _rnd(rng, B, S, K, D),
                _rnd(rng, B, S, K, D)]
        kw = dict(cache_len=torch.tensor([5, 9], dtype=torch.int32))
    elif name == "paged_decode_attention":
        args = [_rnd(rng, B, H, D), _rnd(rng, 4, 8, K, D),
                _rnd(rng, 4, 8, K, D),
                torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)]
        kw = dict(cache_len=torch.tensor([7, 12], dtype=torch.int32))
    elif name == "decode_split_scores":
        args = [_rnd(rng, B, H, D // 2), _rnd(rng, B, S, K, D // 2)]
        kw = dict(cache_len=torch.tensor([5, 9], dtype=torch.int32),
                  scale=D ** -0.5)
    elif name == "decode_split_context":
        args = [_rnd(rng, B, H, S), _rnd(rng, B, S, K, D // 2)]
        kw = dict(cache_len=torch.tensor([5, 9], dtype=torch.int32))
    elif name == "ssd_scan":
        args = [_rnd(rng, 1, S, H, 8), _rnd(rng, 1, S, H).abs(),
                -_rnd(rng, H).abs(), _rnd(rng, 1, S, 1, 4),
                _rnd(rng, 1, S, 1, 4)]
        kw = dict(chunk=8)
    else:
        args = [_rnd(rng, 8, 16), _rnd(rng, 16, 4)]
        kw = {}
    args[0].requires_grad_(grad)
    return getattr(ops, name)(*args, **kw)


ENTRIES = ["decode_attention", "paged_decode_attention", "ssd_scan",
           "matmul", "decode_split_scores", "decode_split_context"]


def _ssd_scan_routes_gradients_through_ssdscan():
    """The SSD scan under autograd: its outputs carry ``SSDScan``'s
    backward, whose gradient is the plain backward's; under
    ``torch.no_grad()`` the forward alone."""
    from repro_torch.kernels import ssd_scan as tssd
    rng = np.random.default_rng(0)
    ins = [_rnd(rng, 1, 16, 4, 8), _rnd(rng, 1, 16, 4).abs(),
           -_rnd(rng, 4).abs(), _rnd(rng, 1, 16, 1, 4),
           _rnd(rng, 1, 16, 1, 4)]
    x = ins[0].clone().requires_grad_()
    y, fin = ops.ssd_scan(x, *ins[1:], chunk=8)
    assert type(y.grad_fn).__name__ == "SSDScanBackward"
    assert fin.grad_fn is y.grad_fn
    (dx,) = torch.autograd.grad(y.sum(), [x])
    yp, finp, states = tssd.ssd_scan_plain(*ins, chunk=8, return_states=True)
    want = tssd.ssd_scan_bwd_plain(*ins, yp, states, finp,
                                   torch.ones_like(yp), chunk=8)
    assert torch.equal(dx, want[0])
    with torch.no_grad():
        for t in ops.ssd_scan(x, *ins[1:], chunk=8):
            assert torch.isfinite(t).all() and t.grad_fn is None


@pytest.mark.parametrize("name", ENTRIES)
def test_entries_without_backward_refuse_autograd(name):
    if name == "ssd_scan":
        _ssd_scan_routes_gradients_through_ssdscan()
        return
    kernel = "tiled_matmul" if name == "matmul" else name
    with pytest.raises(RuntimeError, match=rf"{kernel}: the kernel has no "
                       r"backward \(serving and the plan-driven matmul"):
        _call(name, grad=True)
    with torch.no_grad():
        out = _call(name, grad=True)
    for t in (out if isinstance(out, tuple) else (out,)):
        assert torch.isfinite(t).all() and t.grad_fn is None
    out = _call(name, grad=False)          # grad mode on, nothing to train
    for t in (out if isinstance(out, tuple) else (out,)):
        assert not t.requires_grad


@pytest.mark.parametrize("name", ["qwen3-8b", "mamba2-2.7b"])
@pytest.mark.parametrize("residency", ["dense", "paged"])
def test_serving_runs_with_grad_mode_on(name, residency):
    """Prefill and decode as the engine runs them: grad mode on (no
    ``no_grad`` anywhere in ``serve/``), parameters that do not require
    grad; dense and paged caches (mamba2's state is dense either way)."""
    assert torch.is_grad_enabled()
    arch = get_arch(name).reduced()
    plan = specialize(arch, ShapeConfig("t", "decode", 64, 2),
                      mesh_shape=(1, 1), target="h100-sxm",
                      kv_residency=residency, cache=False)
    cfg = build_run_cfg(plan, arch)
    params = lm.init_params(arch, torch.Generator().manual_seed(0),
                            *plan.padded_sizes())
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, arch.vocab_size, (2, 20))
        .astype(np.int32))
    logits, cache = lm.prefill(arch, params, {"tokens": tokens}, cfg,
                               max_len=64)
    if residency == "paged" and arch.has_attention:
        bl = int(plan.estimates["kv_block_len"])
        dense = cache
        cache = lm.init_paged_cache(arch, 2, 64, bl, 2 * (64 // bl),
                                    device="cpu",
                                    **lm.cache_heads(arch, params["blocks"]))
        cache["block_tbl"].copy_(torch.arange(
            2 * (64 // bl), dtype=torch.int32).reshape(2, -1))
        for key in ("k", "v"):
            cache[key].copy_(dense[key].reshape(cache[key].shape))
        cache["pos"] = dense["pos"]
    steps = [logits]
    for _ in range(3):
        nxt = steps[-1].float().argmax(-1).to(torch.int32)[:, None]
        logits, cache = lm.decode_step(arch, params, cache, {"tokens": nxt},
                                       cfg)
        steps.append(logits)
    for t in steps:
        assert t.shape[0] == 2 and t.shape[1] >= arch.vocab_size
        assert torch.isfinite(t.float()).all() and not t.requires_grad


def test_trainable_leaves_through_the_guarded_entries_raise():
    """A trainer's leaves handed to a decode step (the path that would
    drop their gradients on the card) raise on the CPU too."""
    arch = dataclasses.replace(get_arch("qwen3-8b").reduced(), n_layers=1)
    plan = specialize(arch, ShapeConfig("t", "decode", 64, 2),
                      mesh_shape=(1, 1), target="h100-sxm",
                      kv_residency="dense", cache=False)
    cfg = build_run_cfg(plan, arch)
    params = lm.init_params(arch, torch.Generator().manual_seed(0),
                            *plan.padded_sizes())
    tokens = torch.zeros((2, 4), dtype=torch.int32)
    with torch.no_grad():
        _, cache = lm.prefill(arch, params, {"tokens": tokens}, cfg,
                              max_len=64)
    for leaf in params["blocks"]["attn"].values():
        leaf.requires_grad_(leaf.is_floating_point())
    with pytest.raises(RuntimeError, match="decode_attention: the kernel "
                       "has no backward"):
        lm.decode_step(arch, params, cache,
                       {"tokens": torch.zeros((2, 1), dtype=torch.int32)},
                       cfg)
