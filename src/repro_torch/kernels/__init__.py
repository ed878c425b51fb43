"""The port's hand-written Hopper kernels (``csrc/``), their Python
wrappers and plain versions (``flash_attention``, ``decode_attention``),
the torch oracles (``ref``) and the entry points the model calls
(``ops``).  The kernel modules keep their names: the package does not
re-export their functions under the same names."""

from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
