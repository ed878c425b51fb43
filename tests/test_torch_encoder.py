"""hubert-xlarge (a non-causal encoder over precomputed frame embeddings):
the port against the JAX package.

Reduced hubert: 2 layers, d_model 128, 4 / 2 heads of 32, no RoPE
(``rope_theta = 0``), the sinusoidal position table added to the frame
embeddings, a one-matrix GELU FFN, ``causal=False``, vocab 504.  The JAX
package's ``init_params`` are carried across by
``repro_torch.models.convert``; the port runs its kernels' plain
versions (CPU tensors), the JAX package its XLA mirrors, its ``ref.py``
oracles and ``jax.vjp`` of ``attention_chunked`` for the backward.  The
flash plain versions are also held at hubert's published head_dim 80,
where the CUDA kernels pad each row to 128 columns.

Tolerances (those of ``tests/test_kernels.py``): 1e-5 in fp32 and 2e-2
in bf16, relative to the reference's largest magnitude.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.kernels.flash_attention as tfa
from repro.configs import get_arch as rget_arch
from repro.kernels import ref as jref
from repro.models import attention as rattn
from repro.models import common as rcommon
from repro.models import lm as rlm
from repro.models.lm import RunCfg as RRunCfg
from repro_torch.configs import ShapeConfig as TShape
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core import costmodel as tcm
from repro_torch.core import specialize as tspecialize
from repro_torch.kernels import flash_attention as tflash
from repro_torch.models import common as tcommon
from repro_torch.models import convert
from repro_torch.models import lm as tlm
from repro_torch.models.lm import RunCfg as TRunCfg
from repro_torch.optim import adamw

NAME = "hubert-xlarge"
F32_TOL, BF16_TOL = 1e-5, 2e-2
RCFG = RRunCfg(block_q=16)
TCFG = TRunCfg()
B, S = 2, 48


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _trainable(tree):
    if isinstance(tree, dict):
        return {k: _trainable(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(tree.is_floating_point())


_MODEL = {}


def _model():
    if not _MODEL:
        rarch, tarch = rget_arch(NAME).reduced(), tget_arch(NAME).reduced()
        rparams = rlm.init_params(rarch, jax.random.PRNGKey(0))
        _MODEL.update(rarch=rarch, tarch=tarch, rparams=rparams,
                      tparams=convert.params_from_numpy(
                          tarch, jax.tree.map(np.asarray, rparams),
                          device="cpu"))
    m = _MODEL
    return m["rarch"], m["tarch"], m["rparams"], m["tparams"]


def _batch(seed=0, with_targets=True):
    """Frame embeddings (bf16 in both), targets and an audio mask that
    drops about half the frames, from numpy."""
    rng = np.random.default_rng(seed)
    arch = _model()[0]
    emb = rng.standard_normal((B, S, arch.d_model)).astype(np.float32)
    r = {"embeds": jnp.asarray(emb, jnp.bfloat16)}
    t = {"embeds": torch.from_numpy(emb).to(torch.bfloat16)}
    if with_targets:
        targets = rng.integers(0, arch.vocab_size, (B, S)).astype(np.int32)
        mask = (rng.random((B, S)) < 0.5).astype(np.float32)
        r.update(targets=jnp.asarray(targets), mask=jnp.asarray(mask))
        t.update(targets=torch.from_numpy(targets),
                 mask=torch.from_numpy(mask))
    return r, t


def test_reduced_hubert_is_a_non_causal_encoder_without_rope():
    _, tarch, _, tparams = _model()
    assert tarch.is_encoder and not tarch.causal and tarch.rope_theta == 0
    assert tarch.modality == "audio" and tarch.gated_mlp
    # the encoder's FFN is one (d, ff) matrix, gated_mlp notwithstanding
    assert tuple(tparams["blocks"]["mlp"]["wi"].shape) == (
        tarch.n_layers, tarch.d_model, tarch.d_ff)


@pytest.mark.parametrize("seq,dim", [(48, 128), (2048, 1280), (7, 80)])
def test_sinusoidal_positions_match_jax(seq, dim):
    want = rcommon.sinusoidal_positions(seq, dim)
    got = tcommon.sinusoidal_positions(seq, dim)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(_np(got), want) <= F32_TOL


def test_gelu_ffn_matches_jax():
    """The tanh GELU of one matrix, in fp32 and cast back, as
    ``jax.nn.gelu``'s default computes it."""
    rng = np.random.default_rng(1)
    z = rng.standard_normal((4, 64)).astype(np.float32) * 3
    want = jax.nn.gelu(jnp.asarray(z))
    got = torch.nn.functional.gelu(torch.from_numpy(z), approximate="tanh")
    assert _rel(_np(got), want) <= F32_TOL


def test_forward_matches_jax():
    """Non-causal attention, the sinusoidal table on the frame
    embeddings, GELU: the final hidden states."""
    rarch, tarch, rparams, tparams = _model()
    rb, tb = _batch(with_targets=False)
    want, _ = rlm.forward(rarch, rparams, rb, RCFG)
    got, aux = tlm.forward(tarch, tparams, tb, TCFG)
    assert float(aux) == 0.0
    assert _rel(_np(got), want) <= BF16_TOL


@pytest.mark.parametrize("remat", ["none", "full"])
def test_masked_train_loss_and_every_grad_leaf_match_jax(remat):
    """The loss over the frames the mask keeps (about half) and every
    gradient leaf; the embedding table, which frame embeddings bypass,
    gets zeros, as ``jax.grad`` gives it.  Recomputation repeats the
    same arithmetic."""
    rarch, tarch, rparams, tparams = _model()
    rb, tb = _batch(seed=2)
    kept = float(tb["mask"].sum())
    assert 0.3 * B * S < kept < 0.7 * B * S
    rcfg = dataclasses.replace(RCFG, remat=remat)
    (want, rmet), gwant = jax.value_and_grad(
        lambda p: rlm.train_loss(rarch, p, rb, rcfg), has_aux=True)(rparams)
    params = _trainable(tparams)
    leaves = list(adamw.leaves(params))
    loss, met = tlm.train_loss(tarch, params, tb,
                               dataclasses.replace(TCFG, remat=remat))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    assert float(met["tokens"]) == kept == float(rmet["tokens"])
    assert _rel(float(loss), float(want)) <= BF16_TOL
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(gwant)[0]]
    assert len(paths) == len(grads)
    for path, g, w in zip(paths, grads, jax.tree.leaves(gwant)):
        assert g.shape == w.shape, path
        if path == "['embed']":
            assert not g.any() and not np.asarray(w).any()
        else:
            assert _rel(_np(g), np.asarray(w, np.float32)) <= BF16_TOL, path
    # controls: the mask dropped, or the attention made causal, moves
    # the gradients far past the tolerance
    want = dict(zip(paths, jax.tree.leaves(gwant)))
    for name, arch, batch, leaf in (
            ("unmasked", tarch, {k: v for k, v in tb.items() if k != "mask"},
             "['lm_head']"),
            ("causal", dataclasses.replace(tarch, causal=True), tb,
             "['blocks']['attn']['wk']")):
        params = _trainable(tparams)
        bad_loss, _ = tlm.train_loss(arch, params, batch, TCFG)
        g = dict(zip(paths, torch.autograd.grad(
            bad_loss, list(adamw.leaves(params)), allow_unused=True,
            materialize_grads=True)))
        assert _rel(_np(g[leaf]), np.asarray(want[leaf], np.float32)) > \
            5 * BF16_TOL, name


#: head_dim 80 (hubert's), non-causal, a GQA group of 1 and of 2; fp32
CASES80 = [(2, 40, 3, 1, 80), (1, 33, 2, 2, 80)]


@pytest.mark.parametrize("case", CASES80, ids=str)
def test_flash_plain_at_head_dim_80_non_causal_matches_ref(case):
    B_, S_, K_, G_, D_ = case
    rng = np.random.default_rng(4)
    q = rng.standard_normal((B_, S_, K_ * G_, D_)).astype(np.float32)
    k, v = (rng.standard_normal((B_, S_, K_, D_)).astype(np.float32)
            for _ in range(2))
    want = jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                    causal=False)
    got = tfa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                    causal=False)
    assert _rel(_np(got), want) <= F32_TOL


@pytest.mark.parametrize("case", CASES80, ids=str)
def test_flash_bwd_plain_at_head_dim_80_non_causal_matches_jax_vjp(case):
    """The plain backward (the kernel's arithmetic, step by step) against
    ``jax.vjp`` of the reference's ``attention_chunked`` and of its
    ``ref.py`` oracle, non-causal at head_dim 80, in fp32."""
    B_, S_, K_, G_, D_ = case
    rng = np.random.default_rng(5)
    q, do = (rng.standard_normal((B_, S_, K_ * G_, D_)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B_, S_, K_, D_)).astype(np.float32)
            for _ in range(2))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tflash.flash_attention_plain(tq, tk, tv, causal=False,
                                          return_lse=True)
    got = tflash.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo,
                                           causal=False)

    def chunked(q, k, v):
        return rattn.attention_chunked(q, k, v, causal=False, block_q=16)

    def reference(q, k, v):
        return jref.flash_attention_ref(q, k, v, causal=False)

    for fn in (chunked, reference):
        out, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
        assert _rel(_np(o), out) <= F32_TOL
        for g, w in zip(got, vjp(jnp.asarray(do))):
            assert _rel(_np(g), w) <= F32_TOL, fn.__name__


def test_flash_kernel_takes_head_dim_80_in_padded_tiles():
    """The kernel's tiles at head_dim 80 are laid out at 128 columns:
    the shared memory the plan charges is the padded layout's."""
    assert 80 in tfa.HEAD_DIMS and tfa.padded_dim(80) == 128
    assert tfa.padded_dim(64) == 64 and tfa.padded_dim(128) == 128
    assert tfa.smem_bytes(128, 128, 80) == tfa.smem_bytes(128, 128, 128)
    plan = tspecialize(tget_arch(NAME), TShape("t", "train", 2048, 1),
                       mesh_shape=(1, 1), target="h100-sxm", cache=False)
    bp = plan.partitions["flash_attention"]
    assert bp.blocks == {"block_q": 128, "block_kv": 128, "head_dim": 80}
    assert bp.vmem_bytes == tfa.smem_bytes(128, 128, 80)


def test_serving_an_encoder_is_refused_before_any_weight():
    """An encoder has no decode step: the engine and the launcher refuse
    it with the reference's reason, before any plan or weight; the
    device check needs no decode instance for it."""
    from repro_torch.launch import serve as tserve
    from repro_torch.serve.engine import ServeEngine
    _, tarch, _, tparams = _model()
    with pytest.raises(NotImplementedError, match="no decode step"):
        tserve.main(["--arch", NAME, "--full", "--device", "cuda",
                     "--from-plan"])
    with pytest.raises(NotImplementedError, match="no decode step"):
        ServeEngine(tarch, tparams, TCFG)
    tlm.check_on_device(tget_arch(NAME), "cuda")


def test_train_launcher_runs_reduced_hubert_on_the_cpu(tmp_path, capsys):
    """The train launcher on the reduced arch at the published head_dim
    80: two steps on the synthetic frames, targets and mask."""
    from repro_torch.launch import train as ttrain
    ttrain.main(["--arch", NAME, "--device", "cpu", "--steps", "2",
                 "--seq-len", "32", "--batch", "2",
                 "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "trained 2 steps" in out


def test_encoder_step_estimate_counts_the_gelu_ffn():
    """The step-peak estimate's encoder layer: the GELU FFN keeps its
    fp32 input and bf16 output (6 T F) where the gated FFN keeps 12 T F;
    no RoPE terms; non-causal attention keeps what causal does."""
    arch = tget_arch(NAME)
    T = 2048
    enc = tcm.eager_layer_saved_bytes(arch, T, 16, 16, "none")
    gated = tcm.eager_layer_saved_bytes(
        dataclasses.replace(arch, family="dense"), T, 16, 16, "none")
    assert gated - enc == 6 * T * arch.d_ff
    plan = tspecialize(arch, TShape("t", "train", 2048, 1), mesh_shape=(1, 1),
                       target="h100-sxm", cache=False)
    assert plan.estimates["step_fits"] == 1.0
