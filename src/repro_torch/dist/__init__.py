"""repro_torch.dist: the distributed layer on ``torch.distributed``.

The port of ``repro/dist``:

* :mod:`repro_torch.dist.collectives`: int8 block quantization with
  error feedback, and ``compressed_psum`` over a process group;
* :mod:`repro_torch.dist.sharding`: PartitionSpec resolution with the
  data-organization pass's divisibility repair, and DTensor placements
  on a ``DeviceMesh``;
* :mod:`repro_torch.dist.flash_decode`: the sharded flash-decode over a
  seq- or pool-sharded KV cache (local append, per-rank partial softmax
  through the decode kernels' ``PARTIAL`` mode, cross-rank combine);
* :mod:`repro_torch.dist.fsdp`: training on a mesh, each leaf's place
  (``MeshLayout``: the FSDP splits, the axes a gradient is summed over,
  the rank's piece and batch rows) and the per-layer FSDP gather whose
  backward reduce-scatters the gradient.

The plan decides whether these paths run; this package implements how.
The JAX package's ``compat`` shim (a ``jax.shard_map`` alias) has no
counterpart: there is nothing to alias in PyTorch.
"""

from __future__ import annotations

from repro_torch.dist.collectives import (  # noqa: F401
    compressed_psum,
    compressed_slice_sum,
    dequantize_int8,
    ef_compress,
    ef_state,
    quantize_int8,
)
from repro_torch.dist.sharding import (  # noqa: F401
    cache_pspecs,
    mesh_sizes,
    resolve_pspec,
    tree_shardings,
)
