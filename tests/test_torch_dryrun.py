"""The port's dry run against the JAX package's plans and counts.

A subprocess runs ``repro_torch.launch.dryrun`` on the reference's
``qwen3-8b@decode_32k@16x16`` cell under ``--overrides '{"target":
"tpu-v5e"}'`` (fake tensors, a fake process group of 256 ranks) and
writes its JSON to a temporary directory: the plan hash and
``model_flops`` must be the reference's for the same cell, the step a
decode, each decode kernel entry counted once a layer.  In process, at
reduced sizes on (1, 1) (at the published head_dim and GQA group the
card's kernels take, as the dry run refuses what they do not): the
kernel entries' counts of a decode tick
and a train step, an encoder's forward, a refused cell written with the
port's reason, and the refusals the dry run keeps.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import roofline as rroof
from repro.configs import get_arch as rget_arch
from repro.configs import get_shape as rget_shape
from repro.core import specialize as rspecialize
from repro_torch.configs import ShapeConfig, get_arch, reduced_on
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]
DEADLINE_S = 120
CELL = ("qwen3-8b", "decode_32k")
DECODE_ENTRIES = ("decode_attention", "paged_decode_attention",
                  "decode_partial", "paged_decode_partial",
                  "decode_split_scores", "decode_split_context")


@pytest.fixture(scope="module")
def reference_cell(tmp_path_factory):
    """The dry run of the reference's cell in its own process, started
    when the first test asks for it; its JSON when it is done."""
    out = tmp_path_factory.mktemp("dryrun_torch")
    code = ("import sys\nfrom pathlib import Path\n"
            "from repro_torch.launch import dryrun\n"
            "dryrun.RESULTS = Path(sys.argv[1])\n"
            "sys.exit(dryrun.main(sys.argv[2:]))\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.Popen(
        [sys.executable, "-c", code, str(out), "--arch", CELL[0], "--shape",
         CELL[1], "--overrides", json.dumps({"target": "tpu-v5e"})],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def result():
        try:
            log, _ = proc.communicate(timeout=DEADLINE_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise
        assert proc.returncode == 0, log[-3000:]
        return json.loads((out / f"{CELL[0]}@{CELL[1]}@16x16.json")
                          .read_text())

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def test_the_reference_cell_starts(reference_cell):
    """Starts the subprocess; the in-process tests below run meanwhile."""
    assert callable(reference_cell)


def test_a_decode_tick_counts_a_decode_launch_a_layer():
    arch = reduced_on(get_arch("qwen3-8b"), "cuda")
    shape = ShapeConfig("dry_dec", "decode", 64, 4)
    cell = dryrun.run_cell(arch.name, shape.name, mesh_shape=(1, 1),
                           arch=arch, shape=shape)
    assert cell["runnable"] and cell["kind"] == "decode"
    assert {k: v["calls"] for k, v in cell["kernels"].items()} == \
        {"paged_decode_attention": arch.n_layers}
    assert cell["roofline"]["hlo_flops"] > 0
    assert cell["memory_analysis"]["peak_estimate_per_device"] >= \
        cell["memory_analysis"]["argument_size"] > 0
    assert dryrun.DECODE_NOTE in cell["notes"]


def test_a_train_step_counts_each_layers_forward_and_backward():
    arch = dataclasses.replace(reduced_on(get_arch("hymba-1.5b"), "cuda"),
                               n_layers=3)
    shape = ShapeConfig("dry_train", "train", 64, 2)
    cell = dryrun.run_cell(arch.name, shape.name, mesh_shape=(1, 1),
                           arch=arch, shape=shape)
    assert cell["kind"] == "train"
    calls = {k: v["calls"] for k, v in cell["kernels"].items()}
    L = arch.n_layers
    # each layer's forward once, twice under remat (the backward runs it
    # again), and its backward once
    assert calls["flash_attention_bwd"] == calls["ssd_scan_bwd"] == L
    assert calls["flash_attention"] == calls["ssd_scan"] in (L, 2 * L)
    assert cell["roofline"]["model_flops"] > 0


def test_an_encoder_prefill_is_a_forward():
    arch = reduced_on(get_arch("hubert-xlarge"), "cuda")
    shape = ShapeConfig("dry_pre", "prefill", 64, 2)
    cell = dryrun.run_cell(arch.name, shape.name, mesh_shape=(1, 1),
                           arch=arch, shape=shape)
    assert cell["kind"] == "forward"
    assert cell["kernels"]["flash_attention"]["calls"] == arch.n_layers


def test_a_refused_cell_is_written_with_the_ports_reason(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    assert dryrun.main(["--arch", "hymba-1.5b", "--shape",
                        "decode_32k"]) == 0
    out = json.loads((tmp_path / "hymba-1.5b@decode_32k@16x16.json")
                     .read_text())
    assert out["runnable"] is False and "roofline" not in out
    assert out["skip_reason"].startswith("port: hymba-1.5b")
    assert "refused on CUDA" in out["skip_reason"]
    assert out["plan_hash"]


def test_an_inapplicable_cell_keeps_the_reference_reason(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    dryrun.main(["--arch", "hubert-xlarge", "--shape", "decode_32k"])
    out = json.loads((tmp_path / "hubert-xlarge@decode_32k@16x16.json")
                     .read_text())
    assert out["runnable"] is False
    assert out["skip_reason"] == "encoder-only arch has no decode step"


def test_no_fake_store_is_an_exit(monkeypatch):
    monkeypatch.setitem(sys.modules,
                        "torch.testing._internal.distributed.fake_pg", None)
    with pytest.raises(SystemExit, match="FakeStore"):
        dryrun.fake_world(4)


def test_a_real_cuda_mesh_is_still_refused_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    from repro_torch.launch.mesh import make_host_mesh
    with pytest.raises(RuntimeError, match="no card"):
        make_host_mesh(device_type="cuda")


def test_the_reference_cell_matches_the_reference(reference_cell):
    out = reference_cell()
    rplan = rspecialize(CELL[0], CELL[1], mesh_axes=("data", "model"),
                        mesh_shape=(16, 16))
    assert out["plan_hash"] == rplan.content_hash()
    assert out["target"] == "tpu-v5e" and out["kind"] == "decode"
    r = out["roofline"]
    assert r["model_flops"] == rroof.model_flops_per_step(
        rget_arch(CELL[0]), rget_shape(CELL[1])) / 256
    L = rget_arch(CELL[0]).n_layers
    entries = {k: v["calls"] for k, v in out["kernels"].items()
               if k in DECODE_ENTRIES}
    assert entries and all(n == L for n in entries.values()), entries
    for key in ("compute_s", "memory_s", "collective_s", "bottleneck",
                "mfu", "hlo_flops", "hlo_bytes", "collective_by_kind"):
        assert key in r
    assert "trace_s" in out and "compile_s" not in out
    assert dryrun.NVLINK_NOTE in out["notes"]
