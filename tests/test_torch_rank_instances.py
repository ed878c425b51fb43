"""What a rank of the reference's 16x16 mesh launches, and what the card
refuses: the port judges each rank by the kernel instances its step
launches (``lm.kernel_instances``), not by the global padded group.

* every runnable (arch, shape) cell of the 16x16 mesh, its rank's
  instances by the model code's rules: flash at the rank's group (a
  piece of a padded group where the model axis splits the query heads
  but not the kv heads: llama4-maverick's 3 of 6, hymba-1.5b's and
  qwen3-8b's 2 of 4), its backward where the step trains, K8 at the
  global group where the cache splits its rows; each one the kernels
  take, and the plan's flash tile one the rank's group runs;
* each fake path (the dry run's) raising where its launch would, at an
  instance that is not built, and taking the instances that are;
* the six cells the port refused while it judged the global group
  (llama4-maverick's train_4k, prefill_32k and decode_32k, hymba-1.5b's
  prefill_32k, decode_32k and long_500k) dry-run on the fake 16x16 mesh
  at a cut depth in a process of their own: traced, not refused, each
  layer's decode or flash entry called once.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_arch, get_shape
from repro_torch.core.pipeline import specialize
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import lm, tp
from repro_torch.serve.sharded import cache_split

ROOT = Path(__file__).resolve().parents[1]
DEADLINE_S = 240

#: (arch, shape) -> the (kernel, GQA group, head_dim) instances a rank of
#: the 16x16 mesh launches; the six cells the port refused come first
INSTANCES = {
    ("llama4-maverick-400b-a17b", "train_4k"): (
        ("flash_attention", 3, 128), ("flash_attention_bwd", 3, 128)),
    ("llama4-maverick-400b-a17b", "prefill_32k"): (
        ("flash_attention", 3, 128),),
    ("llama4-maverick-400b-a17b", "decode_32k"): (
        ("flash_attention", 3, 128), ("paged_decode_partial", 6, 128)),
    ("hymba-1.5b", "prefill_32k"): (("flash_attention", 2, 64),),
    ("hymba-1.5b", "decode_32k"): (
        ("flash_attention", 2, 64), ("paged_decode_partial", 4, 64)),
    ("hymba-1.5b", "long_500k"): (
        ("flash_attention", 2, 64), ("decode_partial", 4, 64)),
    ("hymba-1.5b", "train_4k"): (
        ("flash_attention", 5, 64), ("flash_attention_bwd", 5, 64)),
    ("hubert-xlarge", "train_4k"): (
        ("flash_attention", 1, 80), ("flash_attention_bwd", 1, 80)),
    ("hubert-xlarge", "prefill_32k"): (("flash_attention", 1, 80),),
    ("qwen2-vl-72b", "train_4k"): (
        ("flash_attention", 8, 128), ("flash_attention_bwd", 8, 128)),
    ("qwen2-vl-72b", "prefill_32k"): (("flash_attention", 4, 128),),
    ("qwen2-vl-72b", "decode_32k"): (
        ("flash_attention", 4, 128), ("paged_decode_partial", 8, 128)),
    ("mamba2-2.7b", "train_4k"): (),
    ("mamba2-2.7b", "prefill_32k"): (),
    ("mamba2-2.7b", "decode_32k"): (),
    ("mamba2-2.7b", "long_500k"): (),
    ("granite-moe-1b-a400m", "train_4k"): (
        ("flash_attention", 2, 64), ("flash_attention_bwd", 2, 64)),
    ("granite-moe-1b-a400m", "prefill_32k"): (("flash_attention", 1, 64),),
    ("granite-moe-1b-a400m", "decode_32k"): (
        ("flash_attention", 1, 64), ("paged_decode_partial", 2, 64)),
    ("qwen3-8b", "train_4k"): (
        ("flash_attention", 4, 128), ("flash_attention_bwd", 4, 128)),
    ("qwen3-8b", "prefill_32k"): (("flash_attention", 2, 128),),
    ("qwen3-8b", "decode_32k"): (
        ("flash_attention", 2, 128), ("paged_decode_partial", 4, 128)),
    ("deepseek-7b", "train_4k"): (
        ("flash_attention", 1, 128), ("flash_attention_bwd", 1, 128)),
    ("deepseek-7b", "prefill_32k"): (("flash_attention", 1, 128),),
    ("deepseek-7b", "decode_32k"): (
        ("flash_attention", 1, 128), ("paged_decode_partial", 1, 128)),
    ("deepseek-coder-33b", "train_4k"): (
        ("flash_attention", 7, 128), ("flash_attention_bwd", 7, 128)),
    ("deepseek-coder-33b", "prefill_32k"): (("flash_attention", 4, 128),),
    ("deepseek-coder-33b", "decode_32k"): (
        ("flash_attention", 4, 128), ("paged_decode_partial", 8, 128)),
    ("minitron-8b", "train_4k"): (
        ("flash_attention", 4, 128), ("flash_attention_bwd", 4, 128)),
    ("minitron-8b", "prefill_32k"): (("flash_attention", 2, 128),),
    ("minitron-8b", "decode_32k"): (
        ("flash_attention", 2, 128), ("paged_decode_partial", 4, 128)),
}
#: the six cells and the depth each is cut to (llama4-maverick's two
#: layers one dense-and-MoE super-block; hymba-1.5b's three a global, a
#: windowed and a global attention layer)
SIX = {("llama4-maverick-400b-a17b", "train_4k"): 2,
       ("llama4-maverick-400b-a17b", "prefill_32k"): 2,
       ("llama4-maverick-400b-a17b", "decode_32k"): 2,
       ("hymba-1.5b", "prefill_32k"): 3,
       ("hymba-1.5b", "decode_32k"): 3,
       ("hymba-1.5b", "long_500k"): 3}
#: the entry each of the six cells' steps calls once a layer
ENTRY = {"train_4k": "flash_attention_bwd", "prefill_32k": "flash_attention",
         "decode_32k": "paged_decode_partial", "long_500k": "decode_partial"}


@pytest.fixture(scope="module")
def six_cells(tmp_path_factory):
    """The six cells' dry runs in one process of their own (it starts a
    fake process group of 256 ranks), started when the first test asks
    for it; their JSON when it is done."""
    out = tmp_path_factory.mktemp("dryrun16")
    code = ("import dataclasses, json, sys\n"
            "from pathlib import Path\n"
            "from repro_torch.configs import get_arch\n"
            "from repro_torch.launch import dryrun\n"
            "for a, s, n in json.loads(sys.argv[2]):\n"
            "    cut = dataclasses.replace(get_arch(a), n_layers=n)\n"
            "    cell = dryrun.run_cell(a, s, arch=cut)\n"
            "    (Path(sys.argv[1]) / f'{a}@{s}.json').write_text(\n"
            "        json.dumps(cell, default=str))\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.Popen(
        [sys.executable, "-c", code, str(out),
         json.dumps([[a, s, n] for (a, s), n in SIX.items()])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def result():
        try:
            log, _ = proc.communicate(timeout=DEADLINE_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise
        assert proc.returncode == 0, log[-3000:]
        return {(a, s): json.loads((out / f"{a}@{s}.json").read_text())
                for a, s in SIX}

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def test_the_six_cells_start(six_cells):
    """Starts the subprocess; the in-process tests below run meanwhile."""
    assert callable(six_cells)


def _plan(arch, shape):
    return specialize(arch, shape, mesh_axes=("data", "model"),
                      mesh_shape=(16, 16), target="h100-sxm")


@pytest.mark.parametrize("cell", list(INSTANCES),
                         ids=[f"{a}@{s}" for a, s in INSTANCES])
def test_a_rank_of_the_16x16_mesh_launches_built_instances(cell):
    arch, shape = get_arch(cell[0]), get_shape(cell[1])
    plan = _plan(arch, shape)
    got = lm.kernel_instances(
        arch, shape.kind, plan,
        cache_split=cache_split(plan, arch) if shape.kind == "decode"
        else None)
    assert tuple(tuple(i[:3]) for i in got) == INSTANCES[cell]
    assert all(not lm.instance_refusal(i) for i in got)
    lm.check_on_device(arch, "cuda", instances=got)
    if not got:
        return
    # the plan's flash tile is one the rank's group runs, the group the
    # model code's own rule gives the rank's query heads
    flash = got[0]
    H, K = plan.padded_sizes()[1], plan.padded_sizes()[3]
    if flash.tiles is not None:
        rows, _ = fa.kernel_tiles(flash.group, *flash.tiles)
        assert flash.tiles[0] == rows // flash.group
    split = "model" in str(plan.axis_rules.get("heads"))
    if split and K % 16 and flash.group != H // K:
        # the rank's 16th of the query heads over every kv head
        assert tp.flash_group(H, K, H // 16) == flash.group
        k = torch.zeros(1, 1, K, 1)
        assert tp.kv_for_heads(k, 0, H // 16, H // K).shape[2] * \
            flash.group == H // 16


def test_the_one_card_check_names_the_instances():
    llama4 = get_arch("llama4-maverick-400b-a17b")
    plan = _plan(llama4, get_shape("decode_32k"))
    # the global padded group (48 / 8: 6) is not what a rank launches
    with pytest.raises(NotImplementedError, match=r"flash_attention at "
                       r"\(G, head_dim\) = \(6, 128\)"):
        lm.check_on_device(llama4, "cuda", lm.kernel_instances(
            llama4, "decode", heads=48, kv_heads=8, flash_tiles=(21, 128)))
    lm.check_on_device(llama4, "cuda", lm.kernel_instances(
        llama4, "decode", plan, cache_split=cache_split(plan, llama4)))
    with pytest.raises(ValueError, match="step kind"):
        lm.kernel_instances(llama4, "serve", plan)
    # a mesh plan's decode is named by where the caller placed the cache
    with pytest.raises(ValueError, match=r"cache_split"):
        lm.kernel_instances(llama4, "decode", plan)


def _fake(*shapes, dtype=torch.bfloat16):
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode()
    with mode:
        return mode, [torch.empty(s, dtype=dtype) for s in shapes]


def _calls(G, D):
    """Each fake entry at ``G`` query heads over one kv head of ``D``
    (K9: ``D`` columns a head)."""
    tbl = torch.zeros(2, 2, dtype=torch.int32)
    mode, (q4, k4, q3, kc, pool, s) = _fake(
        (1, 64, G, D), (1, 64, 1, D), (2, G, D), (2, 16, 1, D),
        (4, 8, 1, D), (2, G, 16))
    return mode, {
        "flash_attention": lambda: ops.flash_attention(q4, k4, k4),
        "flash_attention_bwd": lambda: fa.flash_attention_bwd_fake(q4, k4,
                                                                   k4),
        "decode_attention": lambda: ops.decode_attention(
            q3, kc, kc, cache_len=16),
        "paged_decode_attention": lambda: ops.paged_decode_attention(
            q3, pool, pool, tbl, cache_len=16),
        "decode_partial": lambda: ops.decode_partial(
            q3, kc, kc, kv_start=0, pos=torch.zeros(2, dtype=torch.int32)),
        "paged_decode_partial": lambda: ops.paged_decode_partial(
            q3, pool, pool, tbl, block_start=0,
            pos=torch.zeros(2, dtype=torch.int32)),
        "decode_split_scores": lambda: ops.decode_split_scores(
            q3, kc, cache_len=16, scale=0.125),
        "decode_split_context": lambda: ops.decode_split_context(
            s, kc, cache_len=16),
    }


#: (entry, an instance it has, one it has not)
FAKE_CASES = (("flash_attention", (3, 128), (6, 128)),
              ("flash_attention_bwd", (3, 128), (3, 96)),
              ("decode_attention", (6, 128), (3, 128)),
              ("paged_decode_attention", (4, 64), (6, 64)),
              ("decode_partial", (4, 64), (3, 64)),
              ("paged_decode_partial", (6, 128), (6, 64)),
              ("decode_split_scores", (4, 64), (4, 4)),
              ("decode_split_context", (2, 32), (2, 8)))


@pytest.mark.parametrize("entry,built,unbuilt", FAKE_CASES,
                         ids=[c[0] for c in FAKE_CASES])
def test_a_fake_call_raises_where_the_launch_would(entry, built, unbuilt):
    mode, calls = _calls(*built)
    with mode:
        calls[entry]()
    mode, calls = _calls(*unbuilt)
    with mode, pytest.raises(ValueError, match="kernel takes|K9 takes|"
                             "checked at"):
        calls[entry]()


def test_a_fake_flash_call_raises_at_a_tile_its_group_cannot_run():
    mode, (q, k) = _fake((1, 64, 3, 128), (1, 64, 1, 128))
    with mode:
        ops.flash_attention(q, k, k, tiles=(42, 128))
        with pytest.raises(ValueError, match="not one the kernel is built"):
            ops.flash_attention(q, k, k, tiles=(32, 128))


@pytest.mark.parametrize("cell", list(SIX), ids=[f"{a}@{s}" for a, s in SIX])
def test_the_six_cells_trace_on_the_fake_16x16_mesh(six_cells, cell):
    out = six_cells()[cell]
    assert out["runnable"] is True, out.get("skip_reason")
    assert "roofline" in out and out["mesh"] == "16x16"
    calls = {k: v["calls"] for k, v in out["kernels"].items()}
    assert calls[ENTRY[cell[1]]] == SIX[cell], calls
    for name in calls:
        assert name in {i[0] for i in INSTANCES[cell]} | {"ssd_scan"}, calls
