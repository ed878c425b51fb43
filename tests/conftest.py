import os
import sys
from pathlib import Path

# tests are run as `PYTHONPATH=src pytest tests/`; make that robust even
# when invoked from elsewhere
SRC = Path(__file__).resolve().parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

# smoke tests must see the single real CPU device (the dry-run sets its
# own 512-device flag in its own subprocess)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

# isolate the on-disk plan store: tests must never see (or pollute) the
# developer's ~/.cache/repro/plans; subprocess tests inherit the same
# per-run directory via the environment
if "REPRO_PLAN_DIR" not in os.environ:
    import tempfile
    os.environ["REPRO_PLAN_DIR"] = tempfile.mkdtemp(prefix="repro_plans_test_")

import jax  # noqa: E402

jax.config.update("jax_threefry_partitionable", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (runs the port's CUDA kernels); "
        "skips where torch.cuda is unavailable")
