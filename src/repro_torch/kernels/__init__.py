"""The port's hand-written Hopper kernels (``csrc/``), their Python
wrappers and plain versions (``flash_attention``, ``decode_attention``,
``ssd_scan``, ``tiled_matmul``), the torch oracles (``ref``) and the
entry points the model calls (``ops``).  The kernel modules keep their
names: the package does not re-export their functions under the same
names; the plan-driven GEMM's entry point is ``matmul``."""

from repro_torch.kernels import ops, ref
from repro_torch.kernels.ops import matmul, matmul_tiles

__all__ = ["matmul", "matmul_tiles", "ops", "ref"]
