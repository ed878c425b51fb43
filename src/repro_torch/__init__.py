"""PyTorch + CUDA port of the memory-template specialization system.

The JAX package ``repro`` is the reference; this package mirrors its
module layout (``configs``, ``hw``, ``core``, ``models``, ``kernels``,
``serve``, ``runtime``, ``launch``) and imports torch and numpy only.
Its kernels are hand-written for Hopper (``kernels/csrc``) and build at
first use; entry points run on ``cuda`` unless given ``device="cpu"``.
"""
