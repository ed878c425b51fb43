"""Hardware target specification: the capacities the passes budget against.

The paper sizes *physical* memories for an FPGA; on an accelerator the
memories are fixed, so the target spec is the set of capacities and
bandwidths the passes budget against.

The port serves on an NVIDIA H100, so ``specialize()`` defaults to the
``h100-sxm`` target.  Its numbers are NVIDIA data-sheet values, not
measurements: 80 GB of HBM3 at 3.35 TB/s, 989 TFLOP/s dense bf16, 227 KB
(232,448 bytes) of shared memory per thread block as the on-chip
("VMEM") budget, NVLink 450 GB/s each way, PCIe Gen5 x16 to the host.
The TPU targets (``tpu-v5e`` 197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s
per ICI link; ``tpu-v5p``) stay in the registry only as planning models:
the plan-parity tests hold this flow against the JAX package under
``tpu-v5e``.  None of their numbers describes the card.

:class:`TpuTarget` stays the target type for every entry, the H100
included (the passes read its fields by name).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

KiB = 1024
MiB = 1024 * KiB
GiB = 1024 * MiB


@dataclasses.dataclass(frozen=True)
class TpuTarget:
    """Capability/capacity model of one TPU chip + its interconnect."""

    name: str = "tpu-v5e"
    # --- compute ---
    peak_bf16_flops: float = 197e12  # FLOP/s per chip (MXU, bf16)
    peak_f32_flops: float = 98.5e12  # ~half rate for fp32 accumulate paths
    mxu_dim: int = 128               # systolic array edge -> matmul tile quantum
    vpu_lanes: Tuple[int, int] = (8, 128)  # (sublane, lane) tiling quantum

    # --- memories (the "template components" with fixed size on TPU) ---
    hbm_bytes: int = 16 * GiB
    hbm_bw: float = 819e9            # bytes/s
    vmem_bytes: int = 64 * MiB       # usable VMEM planning budget per core
    smem_bytes: int = 1 * MiB        # scalar memory (for scalar prefetch)

    # --- interconnect ("channels" in the paper's template) ---
    ici_link_bw: float = 50e9        # bytes/s per ICI link, per direction
    ici_links_per_chip: int = 4      # 2D torus on v5e: 4 links
    dcn_bw: float = 6.25e9           # bytes/s per host NIC (pod axis, 50 Gb/s)

    # --- host tier (the DRAM behind the PCIe attach) ---
    # The serving engine can spill cold KV blocks to pinned host memory
    # and stream them back ahead of their decode tick; these two numbers
    # size that tier.  ``host_bytes_per_chip`` is each chip's share of
    # the host's DRAM (a v5e host serves 8 chips), ``pcie_bw`` the
    # per-chip host<->HBM DMA bandwidth the stream-back must fit in.
    pcie_bw: float = 16e9            # bytes/s per chip (PCIe Gen3 x16 class)
    host_bytes_per_chip: int = 48 * GiB

    # --- derived helpers -------------------------------------------------
    def matmul_time(self, flops: float, dtype_bytes: int = 2) -> float:
        peak = self.peak_bf16_flops if dtype_bytes <= 2 else self.peak_f32_flops
        return flops / peak

    def hbm_time(self, nbytes: float) -> float:
        return nbytes / self.hbm_bw

    def ici_time(self, nbytes: float) -> float:
        """Time to move nbytes across one ICI link."""
        return nbytes / self.ici_link_bw

    def pcie_time(self, nbytes: float) -> float:
        """Time to stream nbytes between host DRAM and HBM."""
        return nbytes / self.pcie_bw

    def align_up(self, n: int, q: int | None = None) -> int:
        q = q or self.mxu_dim
        return ((n + q - 1) // q) * q

    def vmem_fit(self, *tile_bytes: int, buffers: int = 2) -> bool:
        """Does a working set (with ``buffers``-way banking) fit in VMEM?

        ``buffers=2`` models the double-buffered pipeline (the paper's
        multi-bank PLM: one bank is filled by DMA while the other is read
        by the datapath).
        """
        return buffers * sum(tile_bytes) <= self.vmem_bytes


# Registry so configs can say ``target="h100-sxm"`` (or a TPU model).
_TARGETS = {
    "tpu-v5e": TpuTarget(),
    "tpu-v5p": TpuTarget(
        name="tpu-v5p",
        peak_bf16_flops=459e12,
        peak_f32_flops=229.5e12,
        hbm_bytes=95 * GiB,
        hbm_bw=2765e9,
        ici_link_bw=100e9,
        ici_links_per_chip=6,  # 3D torus
        vmem_bytes=128 * MiB,
        pcie_bw=32e9,
        host_bytes_per_chip=96 * GiB,
    ),
    # NVIDIA H100 SXM5 — every number is a data-sheet value, none was
    # measured.  The planning model maps: MXU quantum -> the 64-row wgmma
    # tile edge rounded to the 128 the layout pass pads to; VMEM -> the
    # shared memory one thread block may opt into; ICI -> NVLink.
    "h100-sxm": TpuTarget(
        name="h100-sxm",
        peak_bf16_flops=989e12,        # data sheet: dense bf16 tensor core
        peak_f32_flops=67e12,          # data sheet: fp32 outside tensor cores
        mxu_dim=128,
        vpu_lanes=(8, 128),
        hbm_bytes=80 * 10**9,          # data sheet: 80 GB HBM3
        hbm_bw=3.35e12,                # data sheet: 3.35 TB/s
        vmem_bytes=232_448,            # 227 KB shared memory per block
        smem_bytes=64 * KiB,           # constant/param space for scalars
        ici_link_bw=450e9,             # NVLink 4: 450 GB/s each way
        ici_links_per_chip=1,          # all-to-all through NVSwitch
        dcn_bw=50e9,                   # 400 Gb/s NIC per card
        pcie_bw=64e9,                  # data sheet: PCIe Gen5 x16
        host_bytes_per_chip=128 * GiB,
    ),
}


def get_target(name: str = "tpu-v5e") -> TpuTarget:
    try:
        return _TARGETS[name]
    except KeyError as e:
        raise KeyError(f"unknown target {name!r}; have {sorted(_TARGETS)}") from e
