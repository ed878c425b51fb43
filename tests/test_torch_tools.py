"""The port's tools against the JAX package's: the kernels' work counts,
the collective ring model, the roofline, the report, the session cache
of a plan and the serve steps, and the kernel entries' routes.

``work()`` is held to ``PERF.md`` §6's Bound column (what
``chip_smoke.py``'s kernel phase printed on the card: the larger of the
bytes at 3.35 TB/s and the operations at the data-sheet rate of the
kernel's arithmetic) to the 4 digits printed.  The serve steps run on
the reference's parameters carried across by
``repro_torch.models.convert`` (the port through its kernels' plain
versions on CPU tensors), at the 2e-2 of ``tests/test_torch_model.py``
(both in bf16, rounding at other places).
"""

import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.analysis import hlo_stats as rhlo
from repro.analysis import report as rreport
from repro.analysis import roofline as rroof
from repro.configs import ShapeConfig as RShape
from repro.configs import all_archs as rall_archs
from repro.configs import get_arch as rget_arch
from repro.configs import get_shape as rget_shape
from repro.core import specialize as rspecialize
from repro.core.passes import lowering as rlow
from repro.models import lm as rlm
from repro_torch.analysis import op_stats, report, roofline
from repro_torch.configs import ShapeConfig as TShape
from repro_torch.configs import get_arch as tget_arch
from repro_torch.configs import get_shape as tget_shape
from repro_torch.core import specialize as tspecialize
from repro_torch.core.passes import lowering as tlow
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import fake
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels import tiled_matmul as mm
from repro_torch.models import convert

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-2
# the H100 SXM data sheet (chip_smoke.py's constants)
BF16, FP32, TF32, HBM_BW = 989e12, 67e12, 495e12, 3.35e12
LENS = [1, 64, 300, 777, 1024, 1500, 1999, 2048]   # the decode checks'

# (work, peak, PERF.md §6's Bound column, ms)
BOUNDS = {
    "flash B=2 S=1024 32/8x128": (fa.work(2, 1024, 1024, 32, 8, 128),
                                  BF16, 0.0174),
    "flash G=7": (fa.work(2, 1024, 1024, 56, 8, 128), BF16, 0.0304),
    "flash offset M=1024 T=256": (fa.work(2, 256, 1280, 32, 8, 128),
                                  BF16, 0.0098),
    "flash G=5 D=64": (fa.work(2, 1024, 1024, 25, 5, 64), BF16, 0.0068),
    "flash G=5 window 1024": (fa.work(1, 2048, 2048, 25, 5, 64,
                                      window=1024), BF16, 0.0102),
    "flash G=5 offset window": (fa.work(2, 256, 1280, 25, 5, 64,
                                        window=1024), BF16, 0.0034),
    "flash granite": (fa.work(2, 1024, 1024, 16, 8, 64), BF16, 0.0043),
    "flash llama4": (fa.work(2, 1024, 1024, 40, 8, 128), BF16, 0.0217),
    "flash qwen2-vl": (fa.work(2, 1024, 1024, 64, 8, 128), BF16, 0.0348),
    "flash hubert non-causal": (fa.work(1, 2048, 2048, 16, 16, 80,
                                        causal=False), BF16, 0.0217),
    "flash non-causal 32/8x128": (fa.work(1, 2048, 2048, 32, 8, 128,
                                          causal=False), BF16, 0.0695),
    "gemm 2048x4096x24576": (mm.work(2048, 4096, 24576), BF16, 0.4169),
    "gemm 2048x12288x4096": (mm.work(2048, 12288, 4096), BF16, 0.2085),
    "gemm 8x4096x151936": (mm.work(8, 4096, 151936), BF16, 0.3723),
    "gemm 1000x2560x10576": (mm.work(1000, 2560, 10576), BF16, 0.0548),
    "gemm fp32 1000x5120x2560": (mm.work(1000, 5120, 2560, 4), TF32,
                                 0.1589),
    "gemm fp32 2048x5120x2560": (mm.work(2048, 5120, 2560, 4), TF32,
                                 0.3254),
    "ssd mamba2": (ssd.work(1, 2048, 80, 64, 1, 128, 256), FP32, 0.1214),
    "ssd hymba": (ssd.work(1, 2048, 50, 64, 1, 16, 256), FP32, 0.0315),
    "ssd bwd mamba2": (ssd.bwd_work(1, 2048, 80, 64, 1, 128, 256), FP32,
                       0.4820),
    "ssd bwd hymba": (ssd.bwd_work(1, 2048, 50, 64, 1, 16, 256), FP32,
                      0.0817),
    "flash bwd B=1 S=2048": (fa.bwd_work(1, 2048, 2048, 32, 8, 128), BF16,
                             0.0869),
    "flash bwd B=2 S=1024": (fa.bwd_work(2, 1024, 1024, 32, 8, 128), BF16,
                             0.0435),
    "flash bwd G=5 window": (fa.bwd_work(1, 2048, 2048, 25, 5, 64,
                                         window=1024), BF16, 0.0255),
    "flash bwd qwen2-vl": (fa.bwd_work(1, 2048, 2048, 64, 8, 128), BF16,
                           0.1738),
    "flash bwd hubert": (fa.bwd_work(1, 2048, 2048, 16, 16, 80,
                                     causal=False), BF16, 0.0543),
    "decode paged": (dec.work(8, 32, 8, 128, LENS, block_len=256), BF16,
                     0.0095),
    "decode dense": (dec.work(8, 32, 8, 128, LENS), BF16, 0.0095),
    "decode G=5 window 1024": (dec.work(8, 25, 5, 64, LENS, window=1024),
                               BF16, 0.0020),
    "decode granite": (dec.work(8, 16, 8, 64, LENS), BF16, 0.0047),
}


@pytest.mark.parametrize("case", sorted(BOUNDS))
def test_work_reproduces_the_bound_column(case):
    (flops, nbytes), peak, want = BOUNDS[case]
    got = max(nbytes / HBM_BW, flops / peak) * 1e3
    assert f"{got:.4f}" == f"{want:.4f}", (case, got, want)


def test_causal_pairs_counts_every_live_pair():
    for Sq, Skv, W in ((7, 7, 0), (5, 12, 0), (9, 9, 4), (6, 20, 5),
                       (3, 3, 10), (30, 30, 30)):
        rows = torch.arange(Skv - Sq, Skv)[:, None]
        cols = torch.arange(Skv)[None, :]
        live = cols <= rows
        if W:
            live &= rows - cols < W
        assert fa.causal_pairs(Sq, Skv, W) == int(live.sum()), (Sq, Skv, W)


@pytest.mark.parametrize("kind", list(rhlo.COLLECTIVES) + ["unknown"])
def test_collective_bytes_match_the_reference(kind):
    for g in (1, 2, 3, 8, 16, 256, 512):
        for out_b, in_b in ((0, 0), (4096, 512), (1 << 20, 3 << 20)):
            assert op_stats.collective_bytes(kind, out_b, in_b, g) == \
                rhlo._collective_bytes(kind, out_b, in_b, g), (kind, g)


def _scan_hlo():
    """``tests/test_runtime_dist.py``'s scan of six tanh(x @ w) layers,
    compiled: the reference's HLO text."""
    def f(w, x):
        def body(x, wl):
            return jnp.tanh(x @ wl), None
        x, _ = jax.lax.scan(body, x, w)
        return x
    return jax.jit(f).lower(jnp.zeros((6, 32, 32)),
                            jnp.zeros((8, 32))).compile().as_text()


@pytest.mark.parametrize("target", ["tpu-v5e", "tpu-v5p"])
def test_roofline_matches_the_reference_on_parse_hlo_stats(target):
    txt = _scan_hlo()
    stats = rhlo.parse_hlo(txt, 1)
    rarch, tarch = (rget_arch("qwen3-8b").reduced(),
                    tget_arch("qwen3-8b").reduced())
    rshape, tshape = RShape("s", "train", 64, 4), TShape("s", "train", 64, 4)
    want = rroof.analyze(arch=rarch, shape=rshape, kind="train",
                         hlo_text=txt, n_devices=1, target=target)
    got = roofline.analyze(arch=tarch, shape=tshape, kind="train",
                           stats=stats, n_devices=1, target=target)
    for key in ("hlo_flops", "hlo_bytes", "collective_bytes", "compute_s",
                "memory_s", "collective_s", "model_flops", "useful_ratio",
                "bottleneck", "step_time_s", "mfu"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.xla_flops_raw == got.xla_bytes_raw == 0.0
    assert "xla" in got.notes
    assert set(got.to_json()) == set(want.to_json())


@pytest.mark.parametrize("name", sorted(rall_archs()))
def test_model_flops_match_the_reference(name):
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        assert roofline.model_flops_per_step(
            tget_arch(name), tget_shape(shape)) == \
            rroof.model_flops_per_step(rget_arch(name), rget_shape(shape))


def test_report_renders_a_reference_cell_as_the_reference(tmp_path,
                                                          monkeypatch):
    cell = "qwen3-8b@decode_32k@16x16.json"
    shutil.copy(ROOT / "results" / "dryrun" / cell, tmp_path / cell)
    monkeypatch.setattr(rreport, "RESULTS", tmp_path)
    assert report.roofline_table("16x16", results=tmp_path) == \
        rreport.roofline_table("16x16")
    assert report.dryrun_table("16x16", results=tmp_path) == \
        rreport.dryrun_table("16x16")


def test_report_holds_the_fit_to_the_cells_target(tmp_path):
    base = {"arch": "qwen3-8b", "shape": "decode_32k", "runnable": True,
            "kind": "decode", "trace_s": 1.0, "target": "h100-sxm",
            "memory_analysis": {"peak_estimate_per_device": 60 * 2**30},
            "roofline": {k: 0.0 for k in (
                "compute_s", "memory_s", "collective_s", "model_flops",
                "useful_ratio", "mfu", "hlo_flops", "collective_bytes")}}
    base["roofline"].update(bottleneck="memory", collective_by_kind={})
    import json
    (tmp_path / "qwen3-8b@decode_32k@16x16.json").write_text(
        json.dumps(base))
    table = report.roofline_table("16x16", results=tmp_path)
    assert "≤ target HBM" in table and "| yes |" in table
    assert "| trace s |" in report.dryrun_table("16x16", results=tmp_path)


def _plans(name, **opts):
    rarch, tarch = rget_arch(name).reduced(), tget_arch(name).reduced()
    shape = ("smoke_dec", "decode", 64, 4)
    rplan = rspecialize(rarch, RShape(*shape), mesh_shape=(1, 1), **opts)
    tplan = tspecialize(tarch, TShape(*shape), mesh_shape=(1, 1),
                        target="tpu-v5e", **opts)
    assert tplan.content_hash() == rplan.content_hash()
    return rarch, tarch, rplan, tplan


@pytest.mark.parametrize("name", ["qwen3-8b", "hymba-1.5b"])
@pytest.mark.parametrize("residency", ["paged", "dense"])
def test_init_plan_cache_matches_the_reference(name, residency):
    opts = {} if residency == "paged" else {"kv_residency": "dense"}
    rarch, tarch, rplan, tplan = _plans(name, **opts)
    assert rplan.estimates.get("kv_residency", "dense") == residency
    kv = int(rplan.estimates.get("kv_heads_padded", 0))
    want = jax.eval_shape(lambda: rlow.init_plan_cache(
        rplan, rarch, 4, 64, kv_heads=kv))
    got = tlow.init_plan_cache(tplan, tarch, 4, 64, kv_heads=kv,
                               device="meta")
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k


@pytest.fixture(scope="module")
def served():
    """Reduced qwen3-8b: both packages' plans, the reference's params and
    the port's copy of them."""
    rarch, tarch = rget_arch("qwen3-8b").reduced(), \
        tget_arch("qwen3-8b").reduced()
    dshape = ("smoke_dec", "decode", 64, 4)
    pshape = ("smoke_pre", "prefill", 32, 2)
    out = {"rarch": rarch, "tarch": tarch}
    for key, shape in (("dec", dshape), ("pre", pshape)):
        out[f"r{key}"] = rspecialize(rarch, RShape(*shape),
                                     mesh_shape=(1, 1))
        out[f"t{key}"] = tspecialize(tarch, TShape(*shape),
                                     mesh_shape=(1, 1), target="tpu-v5e")
        out[f"{key}_shape"] = shape
    rparams = rlm.init_params(rarch, jax.random.PRNGKey(0),
                              *out["rdec"].padded_sizes())
    out["rparams"] = rparams
    out["tparams"] = convert.params_from_numpy(
        tarch, jax.tree.map(np.asarray, rparams), device="cpu")
    out["mesh"] = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                       ("data", "model"))
    return out


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


def test_lower_serve_step_decode_matches_the_reference(served):
    m = served
    B, S = m["dec_shape"][3], m["dec_shape"][2]
    rstep = rlow.lower_serve_step(m["rdec"], m["rarch"],
                                  RShape(*m["dec_shape"]), m["mesh"])
    tstep = tlow.lower_serve_step(m["tdec"], m["tarch"],
                                  TShape(*m["dec_shape"]))
    assert rstep.kind == tstep.kind == "decode"
    rcache = rlow.init_plan_cache(m["rdec"], m["rarch"], B, S)
    assert "block_tbl" in rcache
    nb = rcache["block_tbl"].shape[1]
    rcache["block_tbl"] = jnp.arange(B * nb, dtype=jnp.int32).reshape(B, nb)
    tcache = tlow.init_plan_cache(m["tdec"], m["tarch"], B, S, device="cpu")
    tcache["block_tbl"] = torch.arange(B * nb, dtype=torch.int32).reshape(
        B, nb)
    tokens = np.full((B, 1), 7, np.int32)
    rl, rc = rstep.jit()(m["rparams"], rcache,
                         {"tokens": jnp.asarray(tokens)})
    tl, tc = tstep.fn(m["tparams"], tcache,
                      {"tokens": torch.from_numpy(tokens)})
    assert tuple(tl.shape) == rl.shape
    assert _rel(tl.float().numpy(), rl) < TOL
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(rc["pos"]))


def test_lower_serve_step_prefill_matches_the_reference(served):
    m = served
    B, S = m["pre_shape"][3], m["pre_shape"][2]
    rstep = rlow.lower_serve_step(m["rpre"], m["rarch"],
                                  RShape(*m["pre_shape"]), m["mesh"])
    tstep = tlow.lower_serve_step(m["tpre"], m["tarch"],
                                  TShape(*m["pre_shape"]))
    assert rstep.kind == tstep.kind == "prefill"
    tokens = np.random.default_rng(0).integers(
        0, m["rarch"].vocab_size, (B, S)).astype(np.int32)
    rl, rc = rstep.jit()(m["rparams"], {"tokens": jnp.asarray(tokens)})
    tl, tc = tstep.fn(m["tparams"], {"tokens": torch.from_numpy(tokens)})
    assert _rel(tl.float().numpy(), rl) < TOL
    assert _rel(tc["k"].float().numpy(), np.asarray(rc["k"], np.float32)) \
        < TOL


def test_lower_step_dispatches_on_the_shape_kind(served):
    m = served
    arch = m["tarch"]
    step = tlow.lower_step(m["tdec"], arch=arch, shape=TShape(
        *m["dec_shape"]))
    assert step.kind == "decode" and step.make_args is not None
    tshape = TShape("smoke", "train", 32, 2)
    plan = tspecialize(arch, tshape, mesh_shape=(1, 1))
    assert tlow.lower_step(plan, arch=arch, shape=tshape).kind == "train"


# ---- the kernel entries' routes --------------------------------------

def _entries(dev=None):
    """Each ops entry and a call of it on small inputs (made on ``dev``,
    or under the caller's mode)."""
    kw = {} if dev is None else {"device": dev}
    bf = dict(dtype=torch.bfloat16, **kw)
    q4, k4 = torch.randn(1, 8, 4, 64, **bf), torch.randn(1, 8, 2, 64, **bf)
    q3, kc = torch.randn(2, 4, 64, **bf), torch.randn(2, 16, 2, 64, **bf)
    pool = torch.randn(4, 8, 2, 64, **bf)
    tbl = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32, **kw)
    lens = torch.tensor([5, 16], dtype=torch.int32, **kw)
    x = torch.randn(1, 64, 2, 64, **kw)
    dt, A = torch.rand(1, 64, 2, **kw), -torch.rand(2, **kw)
    Bm = torch.randn(1, 64, 1, 16, **kw)
    a, b = torch.randn(16, 32, **bf), torch.randn(32, 8, **bf)
    return {
        "flash_attention": lambda: ops.flash_attention(q4, k4, k4),
        "decode_attention": lambda: ops.decode_attention(
            q3, kc, kc, cache_len=lens),
        "paged_decode_attention": lambda: ops.paged_decode_attention(
            q3, pool, pool, tbl, cache_len=lens),
        "decode_partial": lambda: ops.decode_partial(
            q3, kc, kc, kv_start=0, pos=lens - 1),
        "paged_decode_partial": lambda: ops.paged_decode_partial(
            q3, pool, pool, tbl, block_start=0, pos=lens - 1),
        "decode_split_scores": lambda: ops.decode_split_scores(
            q3, kc, cache_len=lens, scale=0.125),
        "decode_split_context": lambda: ops.decode_split_context(
            torch.randn(2, 4, 16, **kw), kc, cache_len=lens),
        "ssd_scan": lambda: ops.ssd_scan(x, dt, A, Bm, Bm, chunk=64),
        "tiled_matmul": lambda: ops.matmul(a, b),
    }


@pytest.mark.parametrize("name", sorted(_entries("cpu")))
def test_a_fake_tensor_takes_the_fake_path(name, monkeypatch):
    """Outputs of the plain version's shapes and dtypes, the call's work
    recorded under its launch key, no launch counted, and no plain
    version run."""
    want = _entries("cpu")[name]()
    for mod in (fa, dec, ssd, mm):
        for attr in dir(mod):
            if attr.endswith("_plain"):
                monkeypatch.setattr(mod, attr, _refuse)
    got, seen = None, []
    before = ops.launch_counts()
    with FakeTensorMode(), fake.recording(lambda *a: seen.append(a)):
        got = _entries()[name]()
    flat = lambda o: list(o) if isinstance(o, tuple) else [o]
    assert [tuple(t.shape) for t in flat(got)] == \
        [tuple(t.shape) for t in flat(want)]
    assert [t.dtype for t in flat(got)] == [t.dtype for t in flat(want)]
    assert [s[0] for s in seen] == [name]
    assert seen[0][1] > 0 and seen[0][2] > 0
    assert ops.launch_counts() == before


def _refuse(*args, **kwargs):
    raise AssertionError("a fake tensor ran a plain version")


def test_a_fake_tensor_under_autograd_records_both_passes():
    seen = []
    with FakeTensorMode(), fake.recording(lambda *a: seen.append(a[0])):
        q = torch.randn(1, 8, 4, 64, dtype=torch.bfloat16,
                        requires_grad=True)
        k = torch.randn(1, 8, 2, 64, dtype=torch.bfloat16,
                        requires_grad=True)
        ops.flash_attention(q, k, k).float().sum().backward()
        x = torch.randn(1, 64, 2, 64, requires_grad=True)
        dt, A = torch.rand(1, 64, 2), -torch.rand(2)
        Bm = torch.randn(1, 64, 1, 16)
        y, _ = ops.ssd_scan(x, dt, A, Bm, Bm, chunk=64)
        y.sum().backward()
        assert q.grad.shape == q.shape and x.grad.shape == x.shape
    assert seen == ["flash_attention", "flash_attention_bwd", "ssd_scan",
                    "ssd_scan_bwd"]


def test_a_meta_tensor_still_raises_and_a_cpu_tensor_runs_plain():
    meta = torch.empty(1, 8, 4, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        ops.flash_attention(meta, meta[:, :, :2], meta[:, :, :2])
    before = ops.launch_counts()
    q, k = torch.randn(1, 8, 4, 64), torch.randn(1, 8, 2, 64)
    torch.testing.assert_close(ops.flash_attention(q, k, k),
                               fa.flash_attention_plain(q, k, k))
    assert ops.launch_counts() == before


def test_op_stats_counts_a_product_and_a_collective_free_step():
    with FakeTensorMode(), op_stats.OpStats() as st:
        a = torch.empty(8, 16)
        b = torch.empty(16, 4)
        c = (a @ b).relu()
        del c
    res = st.result()
    assert res["flops"] == 2 * 8 * 16 * 4
    # mm: a, b read and c written; relu: c read and written
    assert res["hbm_bytes"] == 4 * (8 * 16 + 16 * 4 + 8 * 4) + 4 * 2 * 8 * 4
    assert res["collective_bytes"] == 0 and res["kernels"] == {}
    assert res["peak_live_bytes"] == 4 * (8 * 16 + 16 * 4 + 2 * 8 * 4)
