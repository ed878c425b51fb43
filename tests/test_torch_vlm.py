"""qwen2-vl-72b (M-RoPE, precomputed patch embeddings): the port against
the JAX package.

Reduced qwen2-vl: 2 layers, d_model 128, 4 query heads over 2 kv heads
of 32, M-RoPE sections (4, 6, 6) over the 16 frequency slots.  The JAX
package's ``init_params`` are carried across by
``repro_torch.models.convert``; the port runs its kernels' plain
versions (CPU tensors), the JAX package its XLA mirrors.  Inputs are
made with numpy and handed to both.  "Distinct streams" positions keep
the temporal stream at each row's index (what the flash kernel masks
by) and give the height and width streams a patch grid, so a rotary
section that took the wrong stream would show.

Tolerances (those of ``tests/test_kernels.py``): 1e-5 in fp32 and 2e-2
in bf16, relative to the reference's largest magnitude.  Greedy tokens
must be identical wherever the reference's top-2 logit margin exceeds
2e-2 of its largest logit (the margin rule).
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
from repro.core.passes.lowering import lower_train_step as rlower_train_step
from repro.models import common as rcommon
from repro.models import frontends as rfrontends
from repro.models import lm as rlm
from repro.models.lm import RunCfg as RRunCfg
from repro.optim import adamw as radamw
from repro.serve.engine import ServeEngine as RServeEngine
from repro_torch.configs import ShapeConfig as TShape
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core import specialize as tspecialize
from repro_torch.core.passes.lowering import lower_train_step
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import convert
from repro_torch.models import frontends as tfrontends
from repro_torch.models import lm as tlm
from repro_torch.models.lm import RunCfg as TRunCfg
from repro_torch.optim import adamw
from repro_torch.serve.engine import ServeEngine as TServeEngine

NAME = "qwen2-vl-72b"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
MARGIN_TOL = 2e-2
RCFG = RRunCfg(block_q=16)
TCFG = TRunCfg()
B, S, MAX_LEN, BL = 2, 40, 64, 16


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


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
                          tarch, _tree_np(rparams), device="cpu"))
    m = _MODEL
    return m["rarch"], m["tarch"], m["rparams"], m["tparams"]


def _positions(Bn, Sn, grid=5, offset=0):
    """``(3, B, S)`` int32: the temporal stream at each row's index
    (from ``offset``), height and width a ``grid``-wide patch grid that
    differs per sequence."""
    rows = np.arange(offset, offset + Sn, dtype=np.int32)
    b = np.arange(Bn, dtype=np.int32)[:, None]
    return np.stack([np.broadcast_to(rows, (Bn, Sn)),
                     rows // grid + b, rows % grid + 2 * b]).astype(np.int32)


def _embeds(Bn, Sn, d, seed=0):
    x = np.random.default_rng(seed).standard_normal((Bn, Sn, d))
    return x.astype(np.float32)


def _batches(embeds, positions=None):
    """The same inputs for both packages: embeds in bf16 (as both cast
    them), positions as given."""
    r = {"embeds": jnp.asarray(embeds, jnp.bfloat16)}
    t = {"embeds": torch.from_numpy(embeds).to(torch.bfloat16)}
    if positions is not None:
        r["positions"] = jnp.asarray(positions)
        t["positions"] = torch.from_numpy(positions)
    return r, t


# ---------------------------------------------------------------------
# frontends and M-RoPE
# ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sections", [(16, 24, 24), (4, 6, 6)])
def test_apply_rope_mrope_matches_jax(dtype, sections):
    """Each frequency slot rotated by its section's stream, fp32 angles,
    at qwen2-vl's published sections (head_dim 128) and the reduced
    ones (32)."""
    hd = 2 * sum(sections)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 24, 3, hd)).astype(np.float32)
    pos = _positions(2, 24, grid=4, offset=7)
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = rcommon.apply_rope(jnp.asarray(x, jd), jnp.asarray(pos), 1e6,
                              sections)
    got = tcommon.apply_rope(torch.from_numpy(x).to(td),
                             torch.from_numpy(pos), 1e6, sections)
    assert got.dtype == td
    assert _rel(_np(got), want) <= TOL[dtype]
    # each stream drives its own section: collapsing the streams moves it
    flat = tcommon.apply_rope(torch.from_numpy(x).to(td),
                              torch.from_numpy(np.broadcast_to(
                                  pos[:1], pos.shape).copy()), 1e6, sections)
    assert _rel(_np(flat), want) > 10 * TOL[dtype]


def test_apply_rope_refuses_sections_that_miss_head_dim():
    with pytest.raises(ValueError, match="sections"):
        tcommon.apply_rope(torch.zeros(1, 2, 1, 32),
                           torch.zeros(3, 1, 2, dtype=torch.int32), 1e4,
                           (4, 6, 5))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("name", [NAME, "hubert-xlarge", "qwen3-8b"])
def test_input_specs_and_synthetic_batch_match_jax(name, kind):
    """The same inputs with the same shapes and dtypes and axes; the
    synthetic batch's deterministic parts (positions) equal, its random
    ones in range."""
    rarch, tarch = rget_arch(name), tget_arch(name)
    rshape, tshape = RShape("t", kind, 64, 4), TShape("t", kind, 64, 4)
    assert tfrontends.input_axes(tarch, tshape) == \
        rfrontends.input_axes(rarch, rshape)
    want = rfrontends.input_specs(rarch, rshape)
    got = tfrontends.input_specs(tarch, tshape)
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == tuple(want[k].shape), k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
    rb = rfrontends.synthetic_batch(rarch.reduced(), rshape,
                                    jax.random.PRNGKey(0))
    tb = tfrontends.synthetic_batch(tarch.reduced(), tshape,
                                    torch.Generator().manual_seed(0))
    assert list(tb) == list(rb)
    for k in rb:
        assert tuple(tb[k].shape) == rb[k].shape, k
        if k == "positions":
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(rb[k]))
        elif k in ("tokens", "targets"):
            assert 0 <= int(tb[k].min()) and int(tb[k].max()) < \
                tarch.vocab_size
        elif k == "mask":
            assert set(np.unique(tb[k].numpy())) <= {0.0, 1.0}
    if "positions" in tb:
        assert tfrontends.batch_dims(tarch, tshape)["positions"] == 1


# ---------------------------------------------------------------------
# the model paths
# ---------------------------------------------------------------------

@pytest.mark.parametrize("streams", [False, True],
                         ids=["default-positions", "distinct-streams"])
def test_forward_matches_jax(streams):
    rarch, tarch, rparams, tparams = _model()
    emb = _embeds(B, S, rarch.d_model)
    rb, tb = _batches(emb, _positions(B, S) if streams else None)
    want, _ = rlm.forward(rarch, rparams, rb, RCFG)
    got, aux = tlm.forward(tarch, tparams, tb, TCFG)
    assert float(aux) == 0.0
    assert _rel(_np(got), want) <= TOL["bfloat16"]


@pytest.mark.parametrize("streams", [False, True],
                         ids=["default-positions", "distinct-streams"])
def test_prefill_logits_and_kv_rows_match(streams):
    rarch, tarch, rparams, tparams = _model()
    emb = _embeds(B, S, rarch.d_model, seed=1)
    rb, tb = _batches(emb, _positions(B, S) if streams else None)
    rl, rc = rlm.prefill(rarch, rparams, rb, RCFG, max_len=MAX_LEN)
    tl, tc = tlm.prefill(tarch, tparams, tb, TCFG, max_len=MAX_LEN)
    assert _rel(_np(tl), rl) <= TOL["bfloat16"]
    for key in ("k", "v"):
        want = np.asarray(rc[key], np.float32)
        assert tuple(tc[key].shape) == want.shape
        for layer in range(want.shape[0]):
            assert _rel(_np(tc[key][layer]), want[layer]) <= \
                TOL["bfloat16"], (key, layer)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(rc["pos"]))


def _paged(cache_np, nb_pool):
    L, Bc, T, Kh, hd = cache_np["k"].shape
    nb = T // BL
    perm = np.random.default_rng(7).permutation(nb_pool)[:Bc * nb]
    tbl = perm.reshape(Bc, nb).astype(np.int32)
    out = dict(cache_np, block_tbl=tbl)
    for key in ("k", "v"):
        pool = np.zeros((L, nb_pool, BL, Kh, hd), np.float32)
        rows = cache_np[key].reshape(L, Bc, nb, BL, Kh, hd)
        for b in range(Bc):
            pool[:, tbl[b]] = rows[:, b]
        out[key] = pool
    return out


@pytest.mark.parametrize("explicit", [False, True],
                         ids=["cache-positions", "batch-positions"])
@pytest.mark.parametrize("residency", ["dense", "paged"])
def test_decode_steps_match(residency, explicit):
    """A prefill of patch embeddings with distinct streams, then four
    token decode steps fed the reference-greedy tokens, dense and paged:
    rotary positions from each slot's ``pos`` broadcast to three streams,
    or given in the batch (which win)."""
    rarch, tarch, rparams, tparams = _model()
    rb, tb = _batches(_embeds(B, S, rarch.d_model, seed=2),
                      _positions(B, S))
    _, rc = rlm.prefill(rarch, rparams, rb, RCFG, max_len=MAX_LEN)
    cache_np = {k: np.asarray(v, np.float32) for k, v in rc.items()}
    cache_np["pos"] = np.asarray(rc["pos"])
    if residency == "paged":
        cache_np = _paged(cache_np, nb_pool=2 * B * MAX_LEN // BL)

    def jx(k, v):
        return jnp.asarray(v, jnp.bfloat16) if k in ("k", "v") \
            else jnp.asarray(v)

    def th(k, v):
        t = torch.from_numpy(np.array(v))
        return t.to(torch.bfloat16) if k in ("k", "v") else t

    rcache = {k: jx(k, v) for k, v in cache_np.items()}
    tcache = {k: th(k, v) for k, v in cache_np.items()}
    tok = np.array([[3], [11]], np.int32)
    for step in range(4):
        batch = {"tokens": tok}
        if explicit:      # a later patch-grid row: streams of their own
            batch["positions"] = np.stack([
                np.full((B, 1), S + step), np.full((B, 1), 2 + step),
                np.full((B, 1), 9 - step)]).astype(np.int32)
        rl, rcache = rlm.decode_step(
            rarch, rparams, rcache,
            {k: jnp.asarray(v) for k, v in batch.items()}, RCFG)
        tl, tcache = tlm.decode_step(
            tarch, tparams, tcache,
            {k: torch.from_numpy(v.copy()) for k, v in batch.items()}, TCFG)
        assert _rel(_np(tl), rl) <= TOL["bfloat16"], step
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(rcache["pos"]))
        tok = np.asarray(jnp.argmax(rl.astype(jnp.float32), -1),
                         np.int32)[:, None]


def test_prefill_tail_matches_jax():
    """A tail of 8 tokens over a 32-row resident prefix (the engine's
    prefix-reuse prefill): positions ``M + arange(T)`` in all three
    streams; logits and tail K/V against the reference's."""
    rarch, tarch, rparams, tparams = _model()
    rng = np.random.default_rng(5)
    toks = rng.integers(0, rarch.vocab_size, (B, 40)).astype(np.int32)
    M, T = 32, 8
    _, rc = rlm.prefill(rarch, rparams, {"tokens": jnp.asarray(toks[:, :M])},
                        RCFG)
    rl, rk, rv = rlm.prefill_tail(rarch, rparams,
                                  {"tokens": jnp.asarray(toks[:, M:])},
                                  RCFG, rc["k"], rc["v"])
    # the prefix rows as a pool of BL-row blocks, addressed by a table
    L, Kh, hd = tarch.n_layers, tarch.n_kv_heads, tarch.hd
    nbm = M // BL
    pool_k = torch.from_numpy(np.asarray(rc["k"], np.float32)).to(
        torch.bfloat16).reshape(L, B * nbm, BL, Kh, hd)
    pool_v = torch.from_numpy(np.asarray(rc["v"], np.float32)).to(
        torch.bfloat16).reshape(L, B * nbm, BL, Kh, hd)
    ids = torch.arange(B * nbm, dtype=torch.int32).reshape(B, nbm)
    tl, tk, tv = tlm.prefill_tail(tarch, tparams,
                                  {"tokens": torch.from_numpy(toks[:, M:])},
                                  TCFG, pool_k, pool_v, ids)
    assert _rel(_np(tl), rl) <= TOL["bfloat16"]
    assert _rel(_np(tk), rk) <= TOL["bfloat16"]
    assert _rel(_np(tv), rv) <= TOL["bfloat16"]


def test_decode_matches_forward_like_the_reference():
    """The reference's vlm oracle (``tests/test_models_smoke.py``): the
    forward over 32 patch embeddings plus one token's embedding, against
    a prefill of the patches and one decode step of the token, in both
    packages, and each against the other."""
    rarch, tarch, rparams, tparams = _model()
    emb = _embeds(2, 32, rarch.d_model, seed=4)
    tok = np.array([[5], [17]], np.int32)
    tok_emb = np.asarray(jnp.take(rparams["embed"], jnp.asarray(tok),
                                  axis=0), np.float32)
    full = np.concatenate([emb, tok_emb], axis=1)
    out = {}
    for pkg, arch, params, cfg in (("jax", rarch, rparams, RCFG),
                                   ("torch", tarch, tparams, TCFG)):
        mod = rlm if pkg == "jax" else tlm
        cast = (lambda a: jnp.asarray(a, jnp.bfloat16)) if pkg == "jax" \
            else (lambda a: torch.from_numpy(a).to(torch.bfloat16))
        x, _ = mod.forward(arch, params, {"embeds": cast(full)}, cfg)
        oracle = _np(mod._logits(arch, params, x[:, -1:], cfg)[:, 0]
                     if pkg == "jax" else mod._logits(arch, params,
                                                      x[:, -1:])[:, 0])
        _, cache = mod.prefill(arch, params, {"embeds": cast(emb)}, cfg,
                               max_len=48)
        dec_tok = jnp.asarray(tok) if pkg == "jax" else torch.from_numpy(tok)
        logits, cache2 = mod.decode_step(arch, params, cache,
                                         {"tokens": dec_tok}, cfg)
        err = np.abs(oracle - _np(logits)).max()
        assert err <= 1e-3 * max(np.abs(oracle).max(), 1.0), (pkg, err)
        assert np.all(np.asarray(_np(cache2["pos"])) == 33)
        out[pkg] = (oracle, _np(logits))
    for a, b in zip(out["torch"], out["jax"]):
        assert _rel(a, b) <= TOL["bfloat16"]


def test_attention_masks_by_the_temporal_stream():
    """A block of 12 image rows sharing one temporal id (rows 8..19 at
    temporal position 8, the rest counting on after it): the reference
    masks by that stream, so the block's rows see each other whatever
    their order.  The port's plain path on the CPU matches it (forward
    and prefill); the row-index mask would not.  A non-CPU tensor with
    such positions raises, naming the kernel and the mask."""
    rarch, tarch, rparams, tparams = _model()
    pos = _positions(B, S)
    t0 = np.arange(S, dtype=np.int32)
    t0[8:20] = 8
    t0[20:] = np.arange(9, 9 + S - 20)
    pos[0] = t0
    rb, tb = _batches(_embeds(B, S, rarch.d_model, seed=6), pos)
    want, _ = rlm.forward(rarch, rparams, rb, RCFG)
    got, _ = tlm.forward(tarch, tparams, tb, TCFG)
    assert _rel(_np(got), want) <= TOL["bfloat16"]
    rl, _ = rlm.prefill(rarch, rparams, rb, RCFG)
    tl, _ = tlm.prefill(tarch, tparams, tb, TCFG)
    assert _rel(_np(tl), rl) <= TOL["bfloat16"]
    # attention alone: the position mask against the reference's, and
    # the row-index mask (the kernel's) is another function here
    from repro.models import attention as rattn
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((B, S, h, 32)).astype(np.float32)
               for h in (4, 2, 2))
    want = rattn.attention_chunked(*map(jnp.asarray, (q, k, v)), causal=True,
                                   block_q=16, positions=jnp.asarray(pos[0]))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = tattn.attention_chunked(tq, tk, tv, causal=True,
                                  mask_pos=torch.from_numpy(pos[0]))
    assert _rel(_np(got), want) <= TOL["float32"]
    by_rows = tattn.attention_chunked(tq, tk, tv, causal=True)
    assert _rel(_np(by_rows), want) > 10 * TOL["bfloat16"]
    # the positions reach the kernels' entry point (on the card, the
    # flash kernels' positions variant), which routes by device alone
    seen = {}
    real = tattn.ops.flash_attention

    def spy(*a, **kw):
        seen.update(kw)
        return real(*a, **kw)

    tattn.ops.flash_attention = spy
    try:
        again = tattn.attention_chunked(tq, tk, tv, causal=True,
                                        mask_pos=torch.from_numpy(pos[0]))
    finally:
        tattn.ops.flash_attention = real
    assert seen["positions"] is not None and torch.equal(again, got)
    q = torch.zeros(1, 4, 2, 32, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel for meta"):
        tattn.attention_chunked(q, q, q, causal=True,
                                mask_pos=torch.zeros(1, 4, device="meta"))


@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_loss_and_every_grad_leaf_match_jax(remat):
    """The loss and every gradient leaf from embeds with distinct
    streams; the embedding table, which the loss does not reach, gets
    zeros as ``jax.grad`` gives it.  Recomputation repeats the same
    arithmetic."""
    rarch, tarch, rparams, tparams = _model()
    rng = np.random.default_rng(8)
    emb = _embeds(B, S, rarch.d_model, seed=8)
    targets = rng.integers(0, rarch.vocab_size, (B, S)).astype(np.int32)
    rb, tb = _batches(emb, _positions(B, S))
    rb["targets"], tb["targets"] = jnp.asarray(targets), \
        torch.from_numpy(targets)
    rcfg = dataclasses.replace(RCFG, remat=remat)
    (want, _), gwant = jax.value_and_grad(
        lambda p: rlm.train_loss(rarch, p, rb, rcfg), has_aux=True)(rparams)
    params = _trainable(tparams)
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
            assert _rel(_np(g), np.asarray(w, np.float32)) <= \
                TOL["bfloat16"], path


def test_microbatch_split_takes_positions_on_their_batch_dim(monkeypatch):
    """``lower_train_step`` with two microbatches on a vlm batch: embeds
    ``(B, S, d)`` split on dim 0, M-RoPE positions ``(3, B, S)`` on dim 1
    (each sequence with a patch grid of its own).  The gradients the step
    hands AdamW (the two microbatches' mean) against ``jax.grad`` of the
    reference's loss over the whole batch, leaf by leaf, and the step's
    loss and grad norm against the reference's two-microbatch step."""
    rarch, tarch, rparams, _ = _model()
    shape = dict(name="vlm", kind="train", seq_len=32, global_batch=4)
    rshape, tshape = RShape(**shape), TShape(**shape)
    rplan = rspecialize(rarch, rshape, mesh_shape=(1, 1))
    tplan = tspecialize(tarch, tshape, mesh_shape=(1, 1), target="tpu-v5e")
    rplan = dataclasses.replace(rplan, comm=dataclasses.replace(
        rplan.comm, microbatches=2))
    tplan = dataclasses.replace(tplan, comm=dataclasses.replace(
        tplan.comm, microbatches=2))
    ropt = radamw.OptConfig.from_plan(rplan, total_steps=10)
    topt = adamw.OptConfig.from_plan(tplan, total_steps=10)
    rng = np.random.default_rng(9)
    batch = {"embeds": _embeds(4, 32, rarch.d_model, seed=9),
             "positions": _positions(4, 32, grid=3),
             "targets": rng.integers(0, rarch.vocab_size,
                                     (4, 32)).astype(np.int32)}
    from jax.sharding import Mesh
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    rstep = rlower_train_step(rplan, rarch, rshape, mesh, ropt)
    rstate = {"params": rparams, "opt": radamw.init_opt_state(rparams, ropt)}
    _, rmet = jax.jit(rstep.fn)(rstate, batch)
    rbatch = dict(batch, embeds=jnp.asarray(batch["embeds"], jnp.bfloat16))
    _, gwant = jax.value_and_grad(
        lambda p: rlm.train_loss(rarch, p, rbatch, RCFG), has_aux=True)(
        rparams)
    seen = {}
    apply = adamw.apply_updates

    def spy(params, grads, *a, **kw):
        seen["grads"] = grads
        return apply(params, grads, *a, **kw)

    monkeypatch.setattr(adamw, "apply_updates", spy)
    tstep = lower_train_step(tplan, tarch, tshape, None, topt)
    tparams = _trainable(convert.params_from_numpy(
        tarch, _tree_np(rparams), device="cpu"))
    tstate = {"params": tparams, "opt": adamw.init_opt_state(tparams, topt)}
    _, tmet = tstep.fn(tstate, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    for key in ("loss", "grad_norm"):
        assert _rel(float(tmet[key]), float(rmet[key])) <= TOL["bfloat16"], \
            key
    for path, want in jax.tree_util.tree_flatten_with_path(gwant)[0]:
        got = seen["grads"]
        for k in path:
            got = got[k.key]
        assert _rel(_np(got), want) <= TOL["bfloat16"], path


def test_convert_round_trips_the_reduced_arch_and_specs_match():
    """The reference's parameters cross bit for bit (a dense arch's
    leaves: nothing the reference lacks), and the full arch's leaf
    shapes are the reference's ``param_shapes``."""
    rarch, tarch, rparams, tparams = _model()
    for (path, w) in jax.tree_util.tree_flatten_with_path(
            _tree_np(rparams))[0]:
        leaf = tparams
        for k in path:
            leaf = leaf[k.key]
        assert _rel(_np(leaf), w) == 0.0, path


# ---------------------------------------------------------------------
# engines and launchers
# ---------------------------------------------------------------------

def _margin(prompt, out, i) -> float:
    rarch, _, rparams, _ = _model()
    toks = np.concatenate([prompt, np.asarray(out[:i], np.int32)])
    logits, _ = rlm.prefill(rarch, rparams,
                            {"tokens": jnp.asarray(toks[None])}, RCFG)
    lf = np.asarray(logits[0, :rarch.vocab_size], np.float32)
    top = np.sort(lf)[-2:]
    return float((top[1] - top[0]) / np.abs(lf).max())


@pytest.mark.parametrize("residency", ["paged", "dense"])
def test_engines_from_h100_plans_match_jax(residency):
    """The reduced arch's ``h100-sxm`` decode plan (paged as frozen, and
    a dense-residency plan), ``from_plan(plan, params)`` against the JAX
    engine built with the plan's decisions, on token prompts (the
    engine's input, as the reference's): greedy tokens under the margin
    rule, prefill calls and block accounting equal."""
    rarch, tarch, rparams, tparams = _model()
    shape = TShape("serve", "decode", 128, 4)
    over = {} if residency == "paged" else {"kv_residency": "dense"}
    plan = tspecialize(tarch, shape, mesh_shape=(1, 1), target="h100-sxm",
                       cache=False, **over)
    est = plan.estimates
    assert est.get("kv_residency", "dense") == residency
    teng = TServeEngine.from_plan(plan, tparams, arch=tarch)
    kw = {}
    if residency == "paged":
        kw = dict(kv_block_len=int(est["kv_block_len"]),
                  kv_n_blocks=int(est["kv_n_blocks"]),
                  kv_admission=str(est["kv_admission"]),
                  kv_host_blocks=int(est["kv_host_blocks"]),
                  kv_prefix_reuse=str(est["kv_prefix_reuse"]),
                  kv_prefetch=str(est["kv_prefetch"]))
    reng = RServeEngine(rarch, rparams, RCFG, max_batch=4, max_len=128,
                        kv_residency=residency, **kw)
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, rarch.vocab_size, n).astype(np.int32)
               for n in (9, 23, 40, 5, 17)]
    for eng in (reng, teng):
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
        eng.run_until_idle(max_ticks=64)
    assert teng.prefill_calls == reng.prefill_calls
    assert teng.block_stats() == reng.block_stats()
    got = {r.rid: r for r in teng.finished}
    compared = 0
    for w in reng.finished:
        g = got[w.rid]
        assert len(g.out_tokens) == len(w.out_tokens)
        for i, (a, b) in enumerate(zip(g.out_tokens, w.out_tokens)):
            if a != b:
                m = _margin(np.asarray(w.prompt), w.out_tokens, i)
                assert m <= MARGIN_TOL, (w.rid, i, a, b, m)
                break
            compared += 1
    assert compared >= 15


def test_launchers_run_reduced_qwen2_vl_on_the_cpu(tmp_path, capsys):
    """Both launchers on the reduced arch at its published head_dim and
    sections: serve from its ``h100-sxm`` plan, train two steps on the
    synthetic embeds and positions."""
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain
    tserve.main(["--arch", NAME, "--device", "cpu", "--from-plan",
                 "--requests", "3", "--max-len", "64", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out
    ttrain.main(["--arch", NAME, "--device", "cpu", "--steps", "2",
                 "--seq-len", "32", "--batch", "2",
                 "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "trained 2 steps" in out


def test_full_width_serve_is_refused_by_its_weight_bytes_before_weights(
        monkeypatch):
    """The full 80 layers (about 145 GB of bf16 weights) are refused by
    ``check_fits`` before any weight exists, naming the bytes, on a
    device with an H100's 80 GB free; 16 layers at full width (about
    33 GB) fit."""
    from repro_torch.launch import serve as tserve
    arch = tget_arch(NAME)
    need = sum(int(np.prod(s.shape)) * s.dtype.itemsize
               for s in tserve._spec_leaves(tlm.leaf_specs(arch)))
    assert need > 140e9
    pages = {"SC_AVPHYS_PAGES": 80 * 10**9 // 4096, "SC_PAGE_SIZE": 4096}
    monkeypatch.setattr(tserve.os, "sysconf", pages.__getitem__)
    with pytest.raises(NotImplementedError, match=r"weight bytes.*n-layers"):
        tserve.check_fits(arch, (), "cpu")
    tserve.check_fits(dataclasses.replace(arch, n_layers=16), (), "cpu")
