"""SSM parity: the port's SSD scan and mamba2 mixer against the JAX package's.

Inputs are drawn with numpy from a seed and fed to both packages (JAX
on the CPU).  The port runs its kernel's plain version (CPU tensors).

Tolerances, each relative to the reference's largest magnitude:

* 1e-5 for the fp32 SSD scan against JAX's chunked ``ssd_chunked``:
  the same chunked algorithm in fp32, summed in other orders;
* 1e-3 against the sequential oracle ``ssd_scan_ref`` and the Pallas
  kernel in interpret mode, as ``tests/test_kernels.py`` holds them
  (the chunked and sequential forms round differently);
* 2e-2 for the bf16 mixer (projections and the conv in bf16), the bf16
  tolerance of the reference's own tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as rget_arch
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro.models import lm as rlm
from repro.models import ssm as rssm
from repro_torch.configs import get_arch as tget_arch
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models import convert
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm

FP32_TOL = 1e-5
ORACLE_TOL = 1e-3
BF16_TOL = 2e-2


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _scan_inputs(seed, B, S, H, P, G, N):
    """fp32 numpy inputs: x and B/C model-like (SiLU of a normal), dt a
    softplus around the model's softplus(-2), A = -linspace(1, 16, H)."""
    rng = np.random.default_rng(seed)

    def silu(v):
        return v / (1.0 + np.exp(-v))

    x = silu(rng.standard_normal((B, S, H, P)))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) - 2.0))
    A = -np.linspace(1.0, 16.0, H)
    Bm = silu(rng.standard_normal((B, S, G, N)))
    Cm = silu(rng.standard_normal((B, S, G, N)))
    return [a.astype(np.float32) for a in (x, dt, A, Bm, Cm)]


@pytest.mark.parametrize("S,chunk", [(128, 32), (256, 64), (100, 32),
                                     (7, 32), (300, 256)])
@pytest.mark.parametrize("H,G", [(4, 1), (4, 4), (6, 2)])
def test_ssd_plain_matches_jax_ssd_chunked(S, chunk, H, G):
    ins = _scan_inputs(S + H + G, 2, S, H, 16, G, 8)
    yr, fr = rssm.ssd_chunked(*map(jnp.asarray, ins), chunk=chunk)
    y, f = tssd.ssd_scan_plain(*map(torch.from_numpy, ins), chunk=chunk)
    assert tuple(y.shape) == yr.shape and tuple(f.shape) == fr.shape
    assert _rel(_np(y), yr) < FP32_TOL
    assert _rel(_np(f), fr) < FP32_TOL


def test_ssd_plain_carries_an_initial_state():
    ins = _scan_inputs(3, 1, 96, 4, 16, 1, 8)
    s0 = np.random.default_rng(4).standard_normal((1, 4, 16, 8)).astype(
        np.float32)
    yr, fr = rssm.ssd_chunked(*map(jnp.asarray, ins), chunk=32,
                              initial_state=jnp.asarray(s0))
    y, f = tssm.ssd_chunked(*map(torch.from_numpy, ins), chunk=32,
                            initial_state=torch.from_numpy(s0))
    assert _rel(_np(y), yr) < FP32_TOL and _rel(_np(f), fr) < FP32_TOL


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 64, 2, 16, 8, 16),
    (2, 128, 4, 32, 16, 32),
    (1, 96, 2, 64, 32, 32),
])
def test_ssd_plain_matches_oracle_and_pallas(B, S, H, P, N, chunk):
    """At the shapes of ``tests/test_kernels.py``'s SSD test, groups
    pre-broadcast (G = H): the port's plain version, the port's oracle,
    JAX's oracle and the Pallas kernel in interpret mode agree."""
    rng = np.random.default_rng(B + S + H + P + N)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal((H,)) * 0.3)).astype(np.float32)
    Bm = rng.standard_normal((B, S, H, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, H, N)).astype(np.float32)
    ins = (x, dt, A, Bm, Cm)
    yr, fr = jref.ssd_scan_ref(*map(jnp.asarray, ins))
    yp = pallas_ssd(*map(jnp.asarray, ins), chunk=chunk, interpret=True)
    tins = [torch.from_numpy(a) for a in ins]
    y, f = tssd.ssd_scan_plain(*tins, chunk=chunk)
    yo, fo = tref.ssd_scan_ref(*tins)
    assert _rel(_np(y), yr) < ORACLE_TOL and _rel(_np(f), fr) < ORACLE_TOL
    assert _rel(_np(y), yp) < ORACLE_TOL
    assert _rel(_np(yo), yr) < FP32_TOL and _rel(_np(fo), fr) < FP32_TOL


def test_ssd_on_cpu_tensors_launches_no_kernel():
    ops.reset_launch_counts()
    ins = [torch.from_numpy(a) for a in _scan_inputs(0, 1, 40, 4, 16, 1, 8)]
    y, f = ops.ssd_scan(*ins, chunk=256, heads_block=3)  # plain: no tiles
    assert tuple(y.shape) == (1, 40, 4, 16) and tuple(f.shape) == (1, 4, 16, 8)
    assert ops.launch_counts()["ssd_scan"] == 0
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        tssd.ssd_scan(*ins)                   # the wrapper never falls back
    with pytest.raises(ValueError, match="not one of the kernel's chunks"):
        tssd.kernel_tiles(96, 1, 80)
    with pytest.raises(ValueError, match="does not divide"):
        tssd.kernel_tiles(256, 3, 80)
    assert tssd.kernel_tiles(None, None, 80) == (256, 1)
    assert tssd.smem_bytes(64, 128) <= 232448


# ---------------------------------------------------------------------
# the scan's backward
# ---------------------------------------------------------------------

def _rms_rel(got, want) -> float:
    """rms |got - want| / rms |want| over the whole tensor."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(((got - want) ** 2).mean() / (want ** 2).mean()))


#: (B, S, H, P, N, G, chunk, initial state): ragged S, G < H, a
#: carried-in state or none, one chunk or several
BWD_CASES = [(1, 37, 4, 8, 4, 2, 16, True), (2, 64, 4, 16, 8, 1, 16, False),
             (1, 50, 6, 8, 16, 3, 64, True), (1, 100, 4, 32, 16, 1, 32, True),
             (2, 7, 2, 8, 4, 1, 32, False)]


@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_ssd_bwd_plain_matches_jax_vjp_and_torch_autograd(case):
    """``ssd_scan_bwd_plain`` (the backward kernel's passes in plain
    PyTorch) against ``jax.vjp`` of the reference's ``ssd_chunked`` and
    against torch autograd of ``ssd_scan_plain``, every gradient (x, dt,
    A, B, C and the initial state) from gradients of y and of the final
    state, rms-relative within 1e-5 in fp32."""
    B, S, H, P, N, G, chunk, init = case
    ins = _scan_inputs(S + H, B, S, H, P, G, N)
    rng = np.random.default_rng(S)
    s0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    dy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dfin = rng.standard_normal((B, H, P, N)).astype(np.float32)
    tins = [torch.from_numpy(a) for a in ins]
    ts0 = torch.from_numpy(s0) if init else None
    y, fin, states = tssd.ssd_scan_plain(*tins, chunk=chunk,
                                         initial_state=ts0,
                                         return_states=True)
    got = tssd.ssd_scan_bwd_plain(*tins, y, states, fin,
                                  torch.from_numpy(dy),
                                  torch.from_numpy(dfin), chunk=chunk,
                                  initial_grad=init)
    assert (got[-1] is not None) == init

    def ref(x, dt, A, Bm, Cm, s):
        return rssm.ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk,
                                initial_state=s if init else None)

    _, vjp = jax.vjp(ref, *map(jnp.asarray, ins), jnp.asarray(s0))
    want = vjp((jnp.asarray(dy), jnp.asarray(dfin)))
    leaves = [t.clone().requires_grad_() for t in tins] + \
        ([ts0.clone().requires_grad_()] if init else [])
    ya, fa = tssd.ssd_scan_plain(*leaves[:5], chunk=chunk,
                                 initial_state=leaves[5] if init else None)
    auto = torch.autograd.grad((ya, fa), leaves,
                               (torch.from_numpy(dy), torch.from_numpy(dfin)))
    names = ["x", "dt", "A", "B", "C", "initial state"][:len(leaves)]
    for name, g, w, a in zip(names, got, want, auto):
        assert tuple(g.shape) == w.shape
        assert _rms_rel(_np(g), w) < FP32_TOL, name
        assert _rms_rel(_np(g), _np(a)) < FP32_TOL, name


def test_ssdscan_routes_both_devices_and_launches_no_kernel_on_the_cpu():
    """``ops.ssd_scan`` under autograd goes through ``SSDScan``: on CPU
    tensors the plain forward and plain backward (no kernel launch), the
    gradients those of ``ssd_scan_bwd_plain``; with no gradient of the
    final state as with one; the backward wrapper refuses CPU tensors."""
    ins = [torch.from_numpy(a) for a in _scan_inputs(5, 1, 70, 4, 32, 1, 16)]
    dy = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 70, 4, 32)).astype(np.float32))
    y, fin, states = tssd.ssd_scan_plain(*ins, chunk=32, return_states=True)
    want = tssd.ssd_scan_bwd_plain(*ins, y, states, fin, dy, chunk=32)
    ops.reset_launch_counts()
    leaves = [t.clone().requires_grad_() for t in ins]
    yk, fk = ops.ssd_scan(*leaves, chunk=32)
    got = torch.autograd.grad(yk, leaves, dy)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(yk.detach(), y) and torch.equal(fk.detach(), fin)
    assert ops.launch_counts()["ssd_scan"] == 0
    assert ops.launch_counts()["ssd_scan_bwd"] == 0
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        tssd.ssd_scan_bwd(*ins, y, states, fin, dy, chunk=32)


# ---------------------------------------------------------------------
# the mamba2 mixer
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixer():
    """Reduced mamba2's first-layer mixer parameters in both packages
    (the JAX package's init, carried across), and its dims."""
    rarch = rget_arch("mamba2-2.7b").reduced()
    tarch = tget_arch("mamba2-2.7b").reduced()
    rparams = rlm.init_params(rarch, jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(
        tarch, jax.tree.map(np.asarray, rparams), device="cpu")
    rsp = rssm.SSMParams(**{k: v[0] for k, v in
                            rparams["blocks"]["ssm"].items()})
    tsp = tssm.SSMParams(**{k: v[0] for k, v in
                            tparams["blocks"]["ssm"].items()})
    return {"rarch": rarch, "tarch": tarch, "rparams": rparams,
            "tparams": tparams, "rsp": rsp, "tsp": tsp,
            "dims": rlm._ssm_dims(rarch, rsp),
            "tdims": tlm._ssm_dims(tarch, tsp)}


def _bf16_pair(rng, shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    j = jnp.asarray(a, jnp.bfloat16)
    return j, convert.tensor_from_numpy(np.asarray(j), device="cpu")


def test_dims_match(mixer):
    assert tuple(mixer["tdims"]) == tuple(mixer["dims"])


@pytest.mark.parametrize("S", [1, 3, 50])
def test_causal_conv_matches_jax(mixer, S):
    rng = np.random.default_rng(S)
    cdim = mixer["rsp"].conv_w.shape[1]
    jx, tx = _bf16_pair(rng, (2, S, cdim))
    want = rssm.causal_conv(jx, mixer["rsp"].conv_w, mixer["rsp"].conv_b)
    got = tssm.causal_conv(tx, mixer["tsp"].conv_w, mixer["tsp"].conv_b)
    assert got.dtype == torch.bfloat16
    assert _rel(_np(got), want) < BF16_TOL


@pytest.mark.parametrize("S,chunk", [(64, 32), (77, 32), (200, 256)])
def test_ssm_forward_matches_jax(mixer, S, chunk):
    rng = np.random.default_rng(S + chunk)
    jx, tx = _bf16_pair(rng, (2, S, mixer["rarch"].d_model))
    want = rssm.ssm_forward(jx, mixer["rsp"], mixer["dims"], chunk=chunk)
    got = tssm.ssm_forward(tx, mixer["tsp"], mixer["tdims"], chunk=chunk)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert _rel(_np(got), want) < BF16_TOL


def test_ssm_decode_step_matches_jax(mixer):
    rng = np.random.default_rng(9)
    d = mixer["dims"]
    jx, tx = _bf16_pair(rng, (3, 1, d.d_model))
    st = (rng.standard_normal((3, d.n_heads, d.head_dim, d.state))
          * 0.1).astype(np.float32)
    jc, tc = _bf16_pair(rng, (3, d.conv_k, d.d_inner + 2 * d.n_groups
                              * d.state))
    wy, ws, wc = rssm.ssm_decode_step(jx, mixer["rsp"], d, jnp.asarray(st),
                                      jc)
    gy, gs, gc = tssm.ssm_decode_step(tx, mixer["tsp"], mixer["tdims"],
                                      torch.from_numpy(st), tc)
    assert gy.dtype == torch.bfloat16 and tuple(gy.shape) == wy.shape
    assert _rel(_np(gy), wy) < BF16_TOL
    assert _rel(_np(gs), ws) < FP32_TOL
    np.testing.assert_array_equal(_np(gc), np.asarray(wc, np.float32))


@pytest.mark.parametrize("S", [1, 2, 3, 5])
def test_short_prompts_conv_tail_and_next_step(mixer, S):
    """Prompts shorter than (and just past) the conv window: the conv
    tail is the last k pre-conv rows, left-padded with zeros, and the
    decode step after it matches the reference."""
    tokens = np.random.default_rng(S).integers(0, 512, (2, S)).astype(
        np.int32)
    rarch, tarch = mixer["rarch"], mixer["tarch"]
    rcfg = rlm.RunCfg()
    tcfg = tlm.RunCfg()
    rl, rc = rlm.prefill(rarch, mixer["rparams"],
                         {"tokens": jnp.asarray(tokens)}, rcfg)
    tl, tc = tlm.prefill(tarch, mixer["tparams"],
                         {"tokens": torch.from_numpy(tokens)}, tcfg)
    # the tail rows are bf16 projections: equal up to bf16 rounding
    assert tuple(tc["conv"].shape) == rc["conv"].shape
    assert _rel(_np(tc["conv"]), rc["conv"]) < BF16_TOL
    k = tarch.ssm_conv
    if S < k:                               # left zero padding
        assert not tc["conv"][:, :, :k - S].any()
    assert _rel(_np(tl), rl) < BF16_TOL
    # the state sums bf16 projections: an ulp of one input moves it
    assert _rel(_np(tc["ssm"]), rc["ssm"]) < BF16_TOL
    nxt = tokens[:, -1:]
    rl, _ = rlm.decode_step(rarch, mixer["rparams"], rc,
                            {"tokens": jnp.asarray(nxt)}, rcfg)
    tl, _ = tlm.decode_step(tarch, mixer["tparams"], tc,
                            {"tokens": torch.from_numpy(nxt)}, tcfg)
    assert _rel(_np(tl), rl) < BF16_TOL
