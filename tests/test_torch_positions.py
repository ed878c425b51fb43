"""Attention masked by positions (the flash kernels' positions variant):
the port's plain versions against the JAX package's
``attention_chunked(positions=...)`` and ``jax.vjp`` of it, then reduced
qwen2-vl's prefill and ``train_loss`` gradients with repeated temporal
ids against the reference.

Inputs are made from a seeded numpy generator at a few narrow widths:
causal, causal with a window, non-causal with a window; positions laid
out as Qwen2-VL's ``get_rope_index`` lays out an image (its patches
share one temporal id), in any order (a permutation), and a query block
at an offset (the last ``Sq`` rows of the key stream).  Tolerances are
the reference tests': 1e-5 in fp32 and 2e-2 of the reference's largest
magnitude in bf16.  On the card the same functions run the kernels,
held against these plain versions in ``tests/test_torch_cuda.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as rget_arch
from repro.models import attention as rattn
from repro.models import lm as rlm
from repro.models.lm import RunCfg as RRunCfg
from repro_torch.configs import get_arch as tget_arch
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.models import convert
from repro_torch.models import lm as tlm
from repro_torch.models.lm import RunCfg as TRunCfg
from repro_torch.optim import adamw

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
RCFG = RRunCfg(block_q=16)
TCFG = TRunCfg()


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


def _image_positions(S, start=8, n=20, B=2):
    """Temporal ids of ``B`` prompts: text, ``n`` patches sharing one id
    from row ``start`` (the second prompt's image 3 rows later), text
    resuming past the grid's extent."""
    out = np.empty((B, S), np.int32)
    for b in range(B):
        s0 = start + 3 * b
        row = np.arange(S, dtype=np.int32)
        row[s0:s0 + n] = s0
        row[s0 + n:] = s0 + 6 + np.arange(S - s0 - n, dtype=np.int32)
        out[b] = row
    return out


def _case(seed, B, S, H, K, D, dtype):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, S, h, D)).astype(np.float32)
                   for h in (H, K, K, H))
    if dtype == "bfloat16":
        q, k, v, do = (np.asarray(jnp.asarray(t, jnp.bfloat16), np.float32)
                       for t in (q, k, v, do))
    return q, k, v, do


def _torch(a, dtype):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


MASKS = [("causal", True, 0), ("causal window 5", True, 5),
         ("non-causal window 4", False, 4)]
LAYOUTS = ["image", "permuted"]


def _positions(layout, S, seed):
    pos = _image_positions(S)
    if layout == "permuted":
        rng = np.random.default_rng(seed)
        pos = np.stack([rng.permutation(p) for p in pos]).astype(np.int32)
    return pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name,causal,window", MASKS)
@pytest.mark.parametrize("H,K,D", [(4, 2, 32), (8, 1, 16)])
def test_plain_forward_masks_by_positions_like_jax(H, K, D, name, causal,
                                                   window, layout, dtype):
    """The forward with positions against the reference's
    ``attention_chunked(positions=...)``, whole and for a query block at
    an offset (the reference's last rows)."""
    B, S = 2, 48
    q, k, v, _ = _case(S + H + D, B, S, H, K, D, dtype)
    pos = _positions(layout, S, H)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(rattn.attention_chunked(
        *(jnp.asarray(t, jd) for t in (q, k, v)), causal=causal,
        window=window, block_q=16, positions=jnp.asarray(pos)), np.float32)
    tq, tk, tv = (_torch(t, dtype) for t in (q, k, v))
    tpos = torch.from_numpy(pos)
    got = tfa.flash_attention_plain(tq, tk, tv, causal=causal,
                                    window=window, positions=tpos)
    assert _rel(got.float().numpy(), want) <= TOL[dtype]
    for Sq in (17, 1):                       # a tail at an offset
        tail = tfa.flash_attention_plain(tq[:, -Sq:], tk, tv, causal=causal,
                                         window=window, positions=tpos)
        assert _rel(tail.float().numpy(), want[:, -Sq:]) <= TOL[dtype]
    # the row index is another mask: a kernel that ignored the positions
    # would fail this check
    by_rows = tfa.flash_attention_plain(tq, tk, tv, causal=causal,
                                        window=window)
    assert _rel(by_rows.float().numpy(), want) > 10 * TOL["bfloat16"]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name,causal,window", MASKS)
@pytest.mark.parametrize("Sq", [48, 20])
def test_plain_backward_masks_by_positions_like_jax_vjp(name, causal,
                                                        window, layout, Sq):
    """dq, dk, dv of the plain backward with positions against
    ``jax.vjp`` of the reference's ``attention_chunked`` (fp32), for the
    whole sequence and for a query block at an offset (the cotangent
    zero on the rows before it)."""
    B, S, H, K, D = 2, 48, 4, 2, 32
    q, k, v, do = _case(7 + Sq, B, S, H, K, D, "float32")
    pos = _positions(layout, S, Sq)
    jpos = jnp.asarray(pos)

    def f(q_, k_, v_):
        return rattn.attention_chunked(q_, k_, v_, causal=causal,
                                       window=window, block_q=16,
                                       positions=jpos)

    _, vjp = jax.vjp(f, *(jnp.asarray(t) for t in (q, k, v)))
    cot = np.zeros_like(do)
    cot[:, S - Sq:] = do[:, S - Sq:]
    wq, wk, wv = (np.asarray(g) for g in vjp(jnp.asarray(cot)))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    tpos = torch.from_numpy(pos)
    o, lse = tfa.flash_attention_plain(tq[:, S - Sq:], tk, tv, causal=causal,
                                       window=window, return_lse=True,
                                       positions=tpos)
    dq, dk, dv = tfa.flash_attention_bwd_plain(
        tq[:, S - Sq:], tk, tv, o, lse,
        torch.from_numpy(np.ascontiguousarray(do[:, S - Sq:])),
        causal=causal, window=window, positions=tpos)
    assert _rel(dq.numpy(), wq[:, S - Sq:]) <= TOL["float32"]
    assert _rel(dk.numpy(), wk) <= TOL["float32"]
    assert _rel(dv.numpy(), wv) <= TOL["float32"]


def test_autograd_route_saves_the_positions_for_the_backward():
    """``ops.flash_attention`` under autograd (the training route, the
    plain pair on the CPU) with positions gives the plain backward's
    gradients, bitwise, and the row-index mask gives others."""
    B, S, H, K, D = 2, 40, 4, 2, 32
    q, k, v, do = (torch.from_numpy(t) for t in
                   _case(3, B, S, H, K, D, "float32"))
    pos = torch.from_numpy(_image_positions(S))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves, positions=pos)
    got = torch.autograd.grad(out, leaves, do)
    o, lse = tfa.flash_attention_plain(q, k, v, return_lse=True,
                                       positions=pos)
    want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, positions=pos)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(out.detach(), o)
    other = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    assert not torch.equal(got[1], other[1])


def test_positions_equal_to_the_rows_are_the_index_mask():
    B, S, H, K, D = 1, 33, 4, 2, 32
    q, k, v, do = (torch.from_numpy(t) for t in
                   _case(5, B, S, H, K, D, "float32"))
    rows = torch.arange(S, dtype=torch.int32)[None]
    o, lse = tfa.flash_attention_plain(q, k, v, window=7, return_lse=True)
    o2, lse2 = tfa.flash_attention_plain(q, k, v, window=7, return_lse=True,
                                         positions=rows)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    a = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, window=7)
    b = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, window=7,
                                      positions=rows)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="positions"):
        tfa.flash_attention_plain(q, k, v, positions=rows[:, :-1])


# ---------------------------------------------------------------------
# reduced qwen2-vl with repeated temporal ids
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def vl():
    rarch = rget_arch("qwen2-vl-72b").reduced()
    tarch = tget_arch("qwen2-vl-72b").reduced()
    rparams = rlm.init_params(rarch, jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(
        tarch, jax.tree.map(np.asarray, rparams), device="cpu")
    return rarch, tarch, rparams, tparams


def _vl_batch(arch, B, S, seed):
    """Patch embeddings and ``(3, B, S)`` M-RoPE positions as
    ``get_rope_index`` lays out one image a prompt: the temporal stream
    repeats one id over the patches, height and width walk the grid."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((B, S, arch.d_model)).astype(np.float32)
    t = _image_positions(S, start=6, n=12, B=B)
    h, w = t.copy(), t.copy()
    for b in range(B):
        s0 = 6 + 3 * b
        h[b, s0:s0 + 12] = s0 + np.arange(12) // 4
        w[b, s0:s0 + 12] = s0 + np.arange(12) % 4
    pos = np.stack([t, h, w]).astype(np.int32)
    return emb, pos


def test_reduced_qwen2vl_prefill_with_repeated_ids_matches_jax(vl):
    """The last-token logits and every layer's K/V of a prefill whose
    temporal stream repeats an id (the mask by positions in every
    layer), against the reference."""
    rarch, tarch, rparams, tparams = vl
    B, S = 2, 40
    emb, pos = _vl_batch(rarch, B, S, seed=9)
    rb = {"embeds": jnp.asarray(emb), "positions": jnp.asarray(pos)}
    tb = {"embeds": torch.from_numpy(emb), "positions": torch.from_numpy(pos)}
    rl, rc = rlm.prefill(rarch, rparams, rb, RCFG)
    tl, tc = tlm.prefill(tarch, tparams, tb, TCFG)
    V = rarch.vocab_size
    assert _rel(tl[:, :V].float().numpy(),
                np.asarray(rl[:, :V], np.float32)) <= TOL["bfloat16"]
    for key in ("k", "v"):
        assert _rel(tc[key][:, :, :S].float().numpy(),
                    np.asarray(rc[key][:, :, :S], np.float32)) \
            <= TOL["bfloat16"]
    # these positions reach attention as its mask (the row index would
    # give none: the model passes only what differs from it)
    assert tlm._embed_in(tarch, tparams, tb)[2] is not None


@pytest.mark.parametrize("remat", ["none", "full"])
def test_reduced_qwen2vl_train_loss_grads_with_repeated_ids_match_jax(vl,
                                                                      remat):
    """The loss and every gradient leaf of ``train_loss`` on a batch with
    repeated temporal ids (the autograd route saves the positions for
    the backward) against ``jax.grad`` of the reference's, as
    ``tests/test_torch_vlm.py`` holds them with distinct streams; the
    embedding table, which an ``embeds`` batch does not reach, gets
    zeros as ``jax.grad`` gives it."""
    rarch, tarch, rparams, tparams = vl
    B, S = 2, 40
    emb, pos = _vl_batch(rarch, B, S, seed=10)
    targets = np.random.default_rng(11).integers(
        0, rarch.vocab_size, (B, S)).astype(np.int32)
    rb = {"embeds": jnp.asarray(emb, jnp.bfloat16),
          "positions": jnp.asarray(pos), "targets": jnp.asarray(targets)}
    tb = {"embeds": torch.from_numpy(emb).to(torch.bfloat16),
          "positions": torch.from_numpy(pos),
          "targets": torch.from_numpy(targets)}
    rcfg = dataclasses.replace(RCFG, remat=remat)
    (want, _), gwant = jax.value_and_grad(
        lambda p: rlm.train_loss(rarch, p, rb, rcfg), has_aux=True)(rparams)

    def trainable(tree):
        if isinstance(tree, dict):
            return {k: trainable(v) for k, v in tree.items()}
        return tree.detach().clone().requires_grad_(tree.is_floating_point())

    params = trainable(tparams)
    leaves = list(adamw.leaves(params))
    loss, _ = tlm.train_loss(tarch, params, tb,
                             dataclasses.replace(TCFG, remat=remat))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    assert _rel(float(loss), float(want)) <= TOL["bfloat16"]
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(gwant)[0]]
    for path, g, w in zip(paths, grads, jax.tree.leaves(gwant)):
        assert g.shape == w.shape, path
        if path == "['embed']":
            assert not g.any() and not np.asarray(w).any()
        else:
            assert _rel(g.detach().float().numpy(),
                        np.asarray(w, np.float32)) <= TOL["bfloat16"], path
