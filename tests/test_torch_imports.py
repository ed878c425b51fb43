"""The port stands alone: it never imports JAX or the JAX package."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"\bimport jax\b|\bfrom jax\b|\bimport ml_dtypes\b"
                       r"|\brepro\.")


def test_port_imports_without_jax_or_reference():
    code = ("import sys\n"
            "import repro_torch, repro_torch.serve.engine, "
            "repro_torch.kernels.ops, repro_torch.launch.serve, "
            "repro_torch.launch.train, repro_torch.train.trainer, "
            "repro_torch.optim.adamw, repro_torch.data.pipeline, "
            "repro_torch.ckpt.checkpointer, repro_torch.dist, "
            "repro_torch.dist.sharding, repro_torch.dist.collectives, "
            "repro_torch.dist.flash_decode, repro_torch.launch.mesh, "
            "repro_torch.serve.sharded, repro_torch.models.tp\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.') or m == 'ml_dtypes')\n"
            "print(','.join(bad))\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"loaded: {out.stdout.strip()}"


def _port_files():
    files = sorted(p for p in PORT.rglob("*")
                   if p.suffix in (".py", ".cu", ".cuh"))
    return files + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_names_no_jax_or_reference(path):
    text = path.read_text()
    hits = [ln for ln in text.splitlines() if FORBIDDEN.search(ln)]
    assert not hits, f"{path.relative_to(ROOT)}: {hits[:3]}"
