"""Model parity: the port's serving path against the JAX package's.

Reduced qwen3-8b (2 layers, d_model 128, GQA 4:2, qk-norm, untied head)
and reduced mamba2-2.7b (2 layers, d_model 128, 8 SSM heads of 32,
state 16, tied embeddings), the JAX package's ``init_params`` carried
across by ``repro_torch.models.convert``.  Both packages run the same function on
the same weights and tokens: the port through its kernels' plain
versions (CPU tensors), the JAX package through its XLA mirrors.

Tolerance: 2e-2 of the reference's largest magnitude, for logits and
for every K/V row.  Both run in bf16 and round at different places
(the JAX mirror scales q in bf16 before the scores, the port in fp32;
the softmax sums run in another order); the same 2e-2 for mamba2's
logits, SSM state and conv window, whose bf16 projections round at
other places too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeConfig as RShape
from repro.configs import get_arch as rget_arch
from repro.core import specialize as rspecialize
from repro.core.passes.lowering import build_run_cfg as rbuild_run_cfg
from repro.models import lm as rlm
from repro_torch.configs import ShapeConfig as TShape
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core import specialize as tspecialize
from repro_torch.core.passes.lowering import build_run_cfg as tbuild_run_cfg
from repro_torch.models import convert
from repro_torch.models import lm as tlm

TOL = 2e-2
B, S, MAX_LEN, BL = 2, 24, 64, 16


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.fixture(scope="module")
def model():
    """Both packages' arch, RunCfg and parameters (same values)."""
    rarch = rget_arch("qwen3-8b").reduced()
    tarch = tget_arch("qwen3-8b").reduced()
    rplan = rspecialize(rarch, RShape("serve_demo", "decode", 128, 4),
                        mesh_shape=(1, 1))
    tplan = tspecialize(tarch, TShape("serve_demo", "decode", 128, 4),
                        mesh_shape=(1, 1), target="tpu-v5e")
    assert tplan.content_hash() == rplan.content_hash()
    rparams = rlm.init_params(rarch, jax.random.PRNGKey(0),
                              *rplan.padded_sizes())
    tree = jax.tree.map(np.asarray, rparams)
    tparams = convert.params_from_numpy(tarch, tree, device="cpu")
    tokens = np.random.default_rng(0).integers(
        0, rarch.vocab_size, (B, S)).astype(np.int32)
    return {"rarch": rarch, "tarch": tarch, "rparams": rparams,
            "tparams": tparams, "rcfg": rbuild_run_cfg(rplan, rarch, None),
            "tcfg": tbuild_run_cfg(tplan, tarch), "tokens": tokens}


def test_convert_carries_every_leaf_bit_for_bit(model):
    flat_r = jax.tree_util.tree_flatten_with_path(model["rparams"])[0]
    for path, leaf in flat_r:
        t = model["tparams"]
        for k in path:
            t = t[k.key]
        want = np.asarray(leaf)
        assert tuple(t.shape) == want.shape
        if want.dtype.name == "bfloat16":
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy(), want.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), want)


def test_prefill_logits_and_kv_rows_match(model):
    rl, rc = rlm.prefill(model["rarch"], model["rparams"],
                         {"tokens": jnp.asarray(model["tokens"])},
                         model["rcfg"], max_len=MAX_LEN)
    tl, tc = tlm.prefill(model["tarch"], model["tparams"],
                         {"tokens": torch.from_numpy(model["tokens"])},
                         model["tcfg"], max_len=MAX_LEN)
    assert tl.dtype == torch.bfloat16 and tuple(tl.shape) == rl.shape
    assert _rel(_np(tl), rl) < TOL
    for key in ("k", "v"):
        want = np.asarray(rc[key], np.float32)
        got = _np(tc[key])
        assert got.shape == want.shape
        # every row, layer by layer (rows past S are zeros in both)
        for layer in range(want.shape[0]):
            for pos in range(S):
                assert _rel(got[layer, :, pos], want[layer, :, pos]) < TOL
        assert not got[:, :, S:].any() and not want[:, :, S:].any()
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(rc["pos"]))


def _paged(cache_np, nb_pool):
    """A dense (L, B, T, K, hd) prefill cache as a paged one: slot b owns
    blocks ``perm[b*nb:(b+1)*nb]`` of a pool with spare blocks."""
    L, Bc, T, Kh, hd = cache_np["k"].shape
    nb = T // BL
    perm = np.random.default_rng(7).permutation(nb_pool)[:Bc * nb]
    tbl = perm.reshape(Bc, nb).astype(np.int32)
    out = {"block_tbl": tbl, "pos": cache_np["pos"]}
    for key in ("k", "v"):
        pool = np.zeros((L, nb_pool, BL, Kh, hd), np.float32)
        rows = cache_np[key].reshape(L, Bc, nb, BL, Kh, hd)
        for b in range(Bc):
            pool[:, tbl[b]] = rows[:, b]
        out[key] = pool
    return out


@pytest.mark.parametrize("residency", ["dense", "paged"])
def test_decode_steps_match(model, residency):
    """Four decode steps from the same prefilled cache, fed the same
    (reference-greedy) tokens: logits agree at every step."""
    _, rc = rlm.prefill(model["rarch"], model["rparams"],
                        {"tokens": jnp.asarray(model["tokens"])},
                        model["rcfg"], max_len=MAX_LEN)
    cache_np = {k: np.asarray(v, np.float32) for k, v in rc.items()}
    cache_np["pos"] = np.asarray(rc["pos"])
    if residency == "paged":
        cache_np = _paged(cache_np, nb_pool=2 * B * MAX_LEN // BL)
    rcache = {k: (jnp.asarray(v, jnp.bfloat16) if k in ("k", "v")
                  else jnp.asarray(v)) for k, v in cache_np.items()}
    tcache = {k: (torch.from_numpy(v).to(torch.bfloat16) if k in ("k", "v")
                  else torch.from_numpy(np.array(v))) for k, v in cache_np.items()}
    tok = model["tokens"][:, -1:]
    for _ in range(4):
        rl, rcache = rlm.decode_step(model["rarch"], model["rparams"], rcache,
                                     {"tokens": jnp.asarray(tok)},
                                     model["rcfg"])
        tl, tcache = tlm.decode_step(model["tarch"], model["tparams"], tcache,
                                     {"tokens": torch.from_numpy(tok)},
                                     model["tcfg"])
        assert _rel(_np(tl), rl) < TOL
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(rcache["pos"]))
        tok = np.asarray(jnp.argmax(rl.astype(jnp.float32), -1),
                         np.int32)[:, None]
    for key in ("k", "v"):
        assert _rel(_np(tcache[key]), np.asarray(rcache[key], np.float32)) \
            < TOL


def test_unported_archs_raise_naming_the_arch():
    """Every arch of ``configs`` is admitted now (qwen2-vl-72b's M-RoPE
    and hubert-xlarge's encoder were the last two refused): each gets
    ``leaf_specs`` equal in shape and dtype to the reference's
    ``param_shapes``, full size and reduced.  A family the JAX package
    lacks is still refused, naming the arch."""
    from repro.configs import all_archs
    archs = all_archs()
    assert len(archs) == 10 and {"qwen2-vl-72b", "hubert-xlarge"} <= set(
        archs)
    for name in archs:
        for size in ("full", "reduced"):
            rarch, tarch = rget_arch(name), tget_arch(name)
            if size == "reduced":
                rarch, tarch = rarch.reduced(), tarch.reduced()
            tlm.check_supported(tarch)
            want = jax.tree_util.tree_flatten_with_path(
                rlm.param_shapes(rarch))[0]
            got = tlm.leaf_specs(tarch)
            assert len(want) == len(list(_spec_paths(got))), (name, size)
            for path, spec in want:
                leaf = got
                for k in path:
                    leaf = leaf[k.key]
                assert leaf.shape == tuple(spec.shape), (name, size, path)
                assert str(leaf.dtype).split(".")[-1] == str(spec.dtype)
    with pytest.raises(NotImplementedError, match="qwen3-8b"):
        tlm.leaf_specs(dataclasses.replace(tget_arch("qwen3-8b"),
                                           family="diffusion"))


def _spec_paths(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _spec_paths(v)
    else:
        yield tree


# ---------------------------------------------------------------------
# mamba2 (attention-free SSM)
# ---------------------------------------------------------------------

SSM_S = 100                 # ragged against the plan's chunk


@pytest.fixture(scope="module")
def ssm_model():
    rarch = rget_arch("mamba2-2.7b").reduced()
    tarch = tget_arch("mamba2-2.7b").reduced()
    shape = ("serve_demo", "decode", 128, 4)
    rplan = rspecialize(rarch, RShape(*shape), mesh_shape=(1, 1))
    tplan = tspecialize(tarch, TShape(*shape), mesh_shape=(1, 1),
                        target="tpu-v5e")
    assert tplan.content_hash() == rplan.content_hash()
    rparams = rlm.init_params(rarch, jax.random.PRNGKey(0),
                              *rplan.padded_sizes())
    tparams = convert.params_from_numpy(
        tarch, jax.tree.map(np.asarray, rparams), device="cpu")
    tokens = np.random.default_rng(1).integers(
        0, rarch.vocab_size, (B, SSM_S)).astype(np.int32)
    rcfg = rbuild_run_cfg(rplan, rarch, None)
    tcfg = tbuild_run_cfg(tplan, tarch)
    assert (tcfg.ssd_chunk, tcfg.ssd_heads_block) == (
        rcfg.ssd_chunk, tplan.partitions["ssd_scan"].blocks["heads_block"])
    return {"rarch": rarch, "tarch": tarch, "rparams": rparams,
            "tparams": tparams, "rcfg": rcfg, "tcfg": tcfg,
            "tokens": tokens}


def test_ssm_convert_carries_every_leaf_bit_for_bit(ssm_model):
    flat_r = jax.tree_util.tree_flatten_with_path(ssm_model["rparams"])[0]
    assert set(ssm_model["tparams"]["blocks"]) == {"pre_norm", "ssm"}
    n = 0
    for path, leaf in flat_r:
        t = ssm_model["tparams"]
        for k in path:
            t = t[k.key]
        want = np.asarray(leaf)
        assert tuple(t.shape) == want.shape
        if want.dtype.name == "bfloat16":
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy(), want.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), want)
        n += 1
    assert n == 11                  # embed, final_norm, pre_norm, 8 ssm


def test_ssm_init_params_fixes_the_ssm_leaves(ssm_model):
    """The port's own init draws other numbers, but its A_log, D and
    dt_bias are the JAX package's fixed values."""
    arch = ssm_model["tarch"]
    params = tlm.init_params(arch, torch.Generator().manual_seed(0))
    want = ssm_model["rparams"]["blocks"]["ssm"]
    for key in ("A_log", "D", "dt_bias"):
        np.testing.assert_allclose(params["blocks"]["ssm"][key].numpy(),
                                   np.asarray(want[key]), rtol=1e-6)


def _ssm_prefill(m):
    rl, rc = rlm.prefill(m["rarch"], m["rparams"],
                         {"tokens": jnp.asarray(m["tokens"])}, m["rcfg"],
                         max_len=MAX_LEN)
    tl, tc = tlm.prefill(m["tarch"], m["tparams"],
                         {"tokens": torch.from_numpy(m["tokens"])}, m["tcfg"],
                         max_len=MAX_LEN)
    return rl, rc, tl, tc


def test_ssm_prefill_logits_and_state_match(ssm_model):
    rl, rc, tl, tc = _ssm_prefill(ssm_model)
    assert sorted(tc) == sorted(rc) == ["conv", "pos", "ssm"]
    assert tl.dtype == torch.bfloat16 and tuple(tl.shape) == rl.shape
    assert _rel(_np(tl), rl) < TOL
    assert tc["ssm"].dtype == torch.float32
    assert tc["conv"].dtype == torch.bfloat16
    for key in ("ssm", "conv"):
        want = np.asarray(rc[key], np.float32)
        got = _np(tc[key])
        assert got.shape == want.shape
        for layer in range(want.shape[0]):       # layer by layer
            assert _rel(got[layer], want[layer]) < TOL
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(rc["pos"]))


def test_ssm_decode_steps_match(ssm_model):
    """Four decode steps from the same prefilled state, fed the same
    (reference-greedy) tokens: logits, state and window agree."""
    _, rcache, _, tcache = _ssm_prefill(ssm_model)
    tok = ssm_model["tokens"][:, -1:]
    for _ in range(4):
        rl, rcache = rlm.decode_step(ssm_model["rarch"],
                                     ssm_model["rparams"], rcache,
                                     {"tokens": jnp.asarray(tok)},
                                     ssm_model["rcfg"])
        tl, tcache = tlm.decode_step(ssm_model["tarch"],
                                     ssm_model["tparams"], tcache,
                                     {"tokens": torch.from_numpy(tok)},
                                     ssm_model["tcfg"])
        assert _rel(_np(tl), rl) < TOL
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(rcache["pos"]))
        tok = np.asarray(jnp.argmax(rl.astype(jnp.float32), -1),
                         np.int32)[:, None]
    for key in ("ssm", "conv"):
        assert _rel(_np(tcache[key]), np.asarray(rcache[key], np.float32)) \
            < TOL
