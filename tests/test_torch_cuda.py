"""The port's CUDA kernels on the card, against their plain versions.

Every test here but the planted-fault check of the comparison itself
needs an NVIDIA card and skips without one (the kernels have no CPU
mode).  The file imports no JAX, so it also runs where only the port is
installed:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Inputs are bf16, at qwen3-8b's attention widths (32 query heads, 8 kv
heads, head_dim 128) unless a test sweeps the GQA group.  Tolerance:
the worst row's rms |kernel - plain| / rms |plain|, a row being one
head's head_dim outputs for one query, <= 1e-2 for flash and 3e-3 for
decode.  Rows, because the outputs' scale falls ~100x from a one-key
row to a 2048-key row, and one global scale would hide a long row's
fault.  The flash kernel rounds the softmax probabilities to bf16 before
the P·V product (the decode kernels and the plain versions keep them in
fp32) and all round the output to bf16: a few parts in 1e3 of a row at
most, where a dropped or misread tile of a long row is tens of parts in
100 (:func:`test_row_check_rejects_planted_faults`).  Logits of the
small model on the card against the CPU: 2e-2 of their largest
magnitude.
"""

import dataclasses

import pytest
import torch

import repro_torch.kernels.decode_attention as tdec
import repro_torch.kernels.flash_attention as tfa
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.core import specialize
from repro_torch.core.passes.lowering import build_run_cfg
from repro_torch.kernels import ops
from repro_torch.models import lm

FLASH_TOL = 1e-2            # worst row, rms-relative (see above)
DECODE_TOL = 3e-3
LOGIT_TOL = 2e-2
H, K, D = 32, 8, 128


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst row's rms-relative error (a row: one head, one query)."""
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    e = (got - want).reshape(-1, got.shape[-1])
    w = want.reshape(-1, want.shape[-1])
    return float((e.pow(2).mean(1).sqrt()
                  / w.pow(2).mean(1).sqrt().clamp_min(1e-6)).max())


def _rnd(gen, *shape):
    return torch.randn(shape, generator=gen, device=gen.device).to(
        torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [64, 130, 1000, 2048])
@pytest.mark.parametrize("window", [0, 300])
@pytest.mark.parametrize("tiles", [None, (16, 128), (32, 64)])
def test_flash_kernel_matches_plain(dev, S, window, tiles):
    g = torch.Generator(dev).manual_seed(S + window)
    q, k, v = _rnd(g, 2, S, H, D), _rnd(g, 2, S, K, D), _rnd(g, 2, S, K, D)
    bq, bkv = tiles or (None, None)
    got = tfa.flash_attention(q, k, v, causal=True, window=window,
                              block_q=bq, block_kv=bkv)
    want = tfa.flash_attention_plain(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert _rel_err(got, want) < FLASH_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("heads,kv", [(8, 8), (8, 4), (16, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_gqa_groups(dev, heads, kv, causal):
    g = torch.Generator(dev).manual_seed(heads * kv)
    S = 200
    q, k, v = (_rnd(g, 1, S, heads, D), _rnd(g, 1, S, kv, D),
               _rnd(g, 1, S, kv, D))
    got = tfa.flash_attention(q, k, v, causal=causal)
    want = tfa.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _rel_err(got, want) < FLASH_TOL


def _paged_case(g, bl, B=6, max_len=2048):
    """A pool, tables with -1 tails and one freed slot (row -1, length
    1), per-slot lengths from 1 to ``max_len``."""
    nb = -(-max_len // bl)
    lens = torch.tensor([1, 7, 300, 1000, max_len, 1], dtype=torch.int32,
                        device=g.device)[:B]
    need = [-(-int(n) // bl) for n in lens]
    need[-1] = 0                                       # the freed slot
    N = sum(need) + 3
    perm = torch.randperm(N, generator=g, device=g.device).int()
    tbl = torch.full((B, nb), -1, dtype=torch.int32, device=g.device)
    at = 0
    for b, n in enumerate(need):
        tbl[b, :n] = perm[at:at + n]
        at += n
    q = _rnd(g, B, H, D)
    return q, _rnd(g, N, bl, K, D), _rnd(g, N, bl, K, D), tbl, lens


@pytest.mark.cuda
@pytest.mark.parametrize("bl", [16, 256, 512])
@pytest.mark.parametrize("tile", [64, 128, 256])
@pytest.mark.parametrize("window", [0, 100])
def test_paged_kernel_matches_plain(dev, bl, tile, window):
    g = torch.Generator(dev).manual_seed(bl + tile + window)
    q, kp, vp, tbl, lens = _paged_case(g, bl)
    got = tdec.paged_decode_attention(q, kp, vp, tbl, cache_len=lens,
                                      window=window, block_kv=tile)
    want = tdec.paged_decode_attention_plain(q, kp, vp, tbl, cache_len=lens,
                                             window=window)
    torch.cuda.synchronize()
    assert _rel_err(got, want) < DECODE_TOL
    assert float(got[-1].float().abs().max()) == 0.0   # freed slot: zeros


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [64, 128, 256])
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("kv", [8, 4, 32])              # G = 4, 8, 1
def test_dense_kernel_matches_plain(dev, tile, window, kv):
    g = torch.Generator(dev).manual_seed(tile + window + kv)
    B, S = 5, 2048
    lens = torch.tensor([1, 64, 513, 1999, 2048], dtype=torch.int32,
                        device=dev)
    q, k, v = _rnd(g, B, H, D), _rnd(g, B, S, kv, D), _rnd(g, B, S, kv, D)
    got = tdec.decode_attention(q, k, v, cache_len=lens, window=window,
                                block_kv=tile)
    want = tdec.decode_attention_plain(q, k, v, cache_len=lens,
                                       window=window)
    torch.cuda.synchronize()
    assert _rel_err(got, want) < DECODE_TOL


@pytest.mark.cuda
def test_wrappers_count_launches_and_refuse_what_the_kernels_do_not_take(dev):
    g = torch.Generator(dev).manual_seed(0)
    ops.reset_launch_counts()
    q, k = _rnd(g, 1, 64, H, D), _rnd(g, 1, 64, K, D)
    ops.flash_attention(q, k, k)
    qd = _rnd(g, 2, H, D)
    kd = _rnd(g, 2, 256, K, D)
    lens = torch.tensor([3, 256], dtype=torch.int32, device=dev)
    ops.decode_attention(qd, kd, kd, cache_len=lens)
    tbl = torch.tensor([[0], [1]], dtype=torch.int32, device=dev)
    ops.paged_decode_attention(qd, kd, kd, tbl, cache_len=lens)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"flash_attention": 1,
                                   "paged_decode_attention": 1,
                                   "decode_attention": 1}
    with pytest.raises(RuntimeError, match="use_pallas='off'"):
        ops.flash_attention(q, k, k, mode="off")
    with pytest.raises(TypeError, match="bfloat16"):
        ops.flash_attention(q.float(), k.float(), k.float())
    with pytest.raises(ValueError, match="not one of the kernel's tiles"):
        ops.decode_attention(qd, kd, kd, cache_len=lens, block_kv=32)
    with pytest.raises(ValueError, match="not one the kernel is built for"):
        ops.flash_attention(q, k, k, tiles=(128, 128))
    with pytest.raises(ValueError, match="head_dim"):
        tdec.decode_attention(qd[..., :64].contiguous(),
                              kd[..., :64].contiguous(),
                              kd[..., :64].contiguous(), cache_len=lens)
    assert sum(ops.launch_counts().values()) == 3


def _faulted(fault: str, d: torch.device):
    """``(got, want)``: ``ops`` on a planted fault against the plain
    version of the right input.  On the CPU both sides are plain."""
    g = torch.Generator(d).manual_seed(7)
    if fault == "flash drops one kv tile":
        S = 512 if d.type == "cpu" else 2048
        q, k, v = _rnd(g, 1, S, H, D), _rnd(g, 1, S, K, D), _rnd(g, 1, S, K, D)
        return (ops.flash_attention(q, k, v, window=S - 64),
                tfa.flash_attention_plain(q, k, v))
    q, kp, vp, tbl, lens = _paged_case(g, 256)
    want = tdec.paged_decode_attention_plain(q, kp, vp, tbl, cache_len=lens)
    if fault == "paged one table entry swapped":
        bad = tbl.clone()
        bad[4, 0] = tbl[3, 0]
        return (ops.paged_decode_attention(q, kp, vp, bad, cache_len=lens),
                want)
    short = lens.clone()
    short[4] -= 256
    return ops.paged_decode_attention(q, kp, vp, tbl, cache_len=short), want


@pytest.mark.parametrize("fault", ["flash drops one kv tile",
                                   "paged one tile short",
                                   "paged one table entry swapped"])
@pytest.mark.parametrize("where", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_row_check_rejects_planted_faults(where, fault):
    """The comparison the kernels pass must fail a kernel that drops or
    misreads one tile of the longest row (on the CPU the plain version
    plays the faulty kernel)."""
    if where == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    got, want = _faulted(fault, torch.device(where))
    assert _rel_err(got, want) > 5 * FLASH_TOL


def _card_arch():
    """qwen3-8b reduced in depth and width, with its published head_dim
    (the kernels are built for 128)."""
    return dataclasses.replace(get_arch("qwen3-8b").reduced(), head_dim=128)


@pytest.mark.cuda
@pytest.mark.parametrize("residency", ["paged", "dense"])
def test_model_on_card_matches_cpu(dev, residency):
    """Prefill and four decode steps through the kernels on the card
    against the plain versions on the CPU, same weights: logits within
    2e-2 of the CPU logits' scale."""
    arch = _card_arch()
    plan = specialize(arch, ShapeConfig("t", "decode", 512, 4),
                      mesh_shape=(1, 1), kv_residency=residency, cache=False)
    cfg = build_run_cfg(plan, arch)
    params_cpu = lm.init_params(arch, torch.Generator().manual_seed(0),
                                *plan.padded_sizes())
    params_gpu = _to(params_cpu, dev)
    toks = torch.randint(0, arch.vocab_size, (4, 100),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    for name, params, d in (("cpu", params_cpu, torch.device("cpu")),
                            ("gpu", params_gpu, dev)):
        ops.reset_launch_counts()
        logits, dense = lm.prefill(arch, params, {"tokens": toks.to(d)}, cfg,
                                   max_len=512)
        steps = [logits]
        cache = dense
        if residency == "paged":
            bl = int(plan.estimates["kv_block_len"])
            cache = lm.init_paged_cache(arch, 4, 512, bl, 4 * (512 // bl),
                                        kv_heads=cfg.kv_heads_padded,
                                        device=d)
            nb = 512 // bl
            cache["block_tbl"].copy_(torch.arange(4 * nb, device=d,
                                                  dtype=torch.int32
                                                  ).reshape(4, nb))
            for key in ("k", "v"):
                cache[key].copy_(dense[key].reshape(cache[key].shape))
            cache["pos"] = dense["pos"]
        for _ in range(4):
            nxt = steps[-1].float().argmax(-1).to(torch.int32)[:, None]
            if name == "gpu":
                nxt = out["cpu_tokens"][len(steps) - 1]
            logits, cache = lm.decode_step(arch, params, cache,
                                           {"tokens": nxt.to(d)}, cfg)
            steps.append(logits)
            out.setdefault(f"{name}_tokens", []).append(nxt.cpu())
        out[name] = [s.float().cpu() for s in steps]
        if d.type == "cuda":
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            assert counts["flash_attention"] == arch.n_layers
            kernel = ("paged_decode_attention" if residency == "paged"
                      else "decode_attention")
            assert counts[kernel] == 4 * arch.n_layers
    for c, gpu in zip(out["cpu"], out["gpu"]):
        assert float((gpu - c).abs().max() / c.abs().max()) < LOGIT_TOL


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)
