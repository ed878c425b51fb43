"""Modality frontends (stubs) and the inputs each step consumes.

The port of ``repro/models/frontends.py``.  The ``[audio]`` and
``[vlm]`` architectures specify the transformer backbone only: the conv
feature extractor (hubert) and the vision tower (qwen2-vl) are stubs
that provide *precomputed* frame or patch embeddings.  This module says
what each (arch x shape) step function consumes:

* :func:`input_axes` — the logical axes of each input (``batch`` names
  the dim a microbatch split slices: M-RoPE ``positions`` are ``(3, B,
  S)``, batch on dim 1);
* :func:`input_specs` — ``(shape, dtype)`` records, no allocation;
* :func:`synthetic_batch` — real tensors from an explicit
  ``torch.Generator`` (smoke tests), on the generator's device.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig


class InputSpec(NamedTuple):
    """An input's shape and dtype (the JAX package's
    ``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_axes(arch: ArchConfig, shape: ShapeConfig) -> Dict[str, Tuple]:
    """Logical axes per input (the Memory IR's vocabulary)."""
    ax: Dict[str, Tuple] = {}
    if shape.kind == "decode":
        ax["tokens"] = ("batch", None)
    elif arch.modality in ("audio", "vlm"):
        ax["embeds"] = ("batch", "seq", None)
        if arch.mrope_sections is not None:
            ax["positions"] = (None, "batch", "seq")
        if shape.kind == "train":
            ax["targets"] = ("batch", "seq")
        if arch.modality == "audio" and shape.kind == "train":
            ax["mask"] = ("batch", "seq")
    else:
        ax["tokens"] = ("batch", "seq")
        if shape.kind == "train":
            ax["targets"] = ("batch", "seq")
    return ax


def batch_dims(arch: ArchConfig, shape: ShapeConfig) -> Dict[str, int]:
    """The batch dim of each input that has one, from
    :func:`input_axes` (the reference's rule,
    ``src/repro/core/passes/lowering.py:265-266``)."""
    return {k: ax.index("batch")
            for k, ax in input_axes(arch, shape).items() if "batch" in ax}


def input_specs(arch: ArchConfig, shape: ShapeConfig
                ) -> Dict[str, InputSpec]:
    """An :class:`InputSpec` for every model input (no allocation)."""
    B, S = shape.global_batch, shape.seq_len
    out: Dict[str, InputSpec] = {}
    if shape.kind == "decode":
        out["tokens"] = InputSpec((B, 1), torch.int32)
        return out
    if arch.modality in ("audio", "vlm"):
        out["embeds"] = InputSpec((B, S, arch.d_model), torch.bfloat16)
        if arch.mrope_sections is not None:
            out["positions"] = InputSpec((3, B, S), torch.int32)
        if shape.kind == "train":
            out["targets"] = InputSpec((B, S), torch.int32)
        if arch.modality == "audio" and shape.kind == "train":
            out["mask"] = InputSpec((B, S), torch.float32)
    else:
        out["tokens"] = InputSpec((B, S), torch.int32)
        if shape.kind == "train":
            out["targets"] = InputSpec((B, S), torch.int32)
    return out


def synthetic_batch(arch: ArchConfig, shape: ShapeConfig,
                    generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """A random batch matching :func:`input_specs`, drawn from
    ``generator`` on its device: token ids uniform over the vocab,
    positions the default ``0..S-1`` in every stream, an audio mask
    keeping about half the frames, embeddings standard normal (fp32,
    then the spec's bf16)."""
    dev = generator.device
    out: Dict[str, torch.Tensor] = {}
    for name, spec in input_specs(arch, shape).items():
        if name in ("tokens", "targets"):
            out[name] = torch.randint(0, arch.vocab_size, spec.shape,
                                      generator=generator, device=dev,
                                      dtype=spec.dtype)
        elif name == "positions":
            out[name] = torch.arange(spec.shape[-1], dtype=spec.dtype,
                                     device=dev).expand(
                                         spec.shape).contiguous()
        elif name == "mask":
            out[name] = (torch.rand(spec.shape, generator=generator,
                                    device=dev) < 0.5).to(spec.dtype)
        else:  # embeds
            out[name] = torch.randn(spec.shape, generator=generator,
                                    device=dev).to(spec.dtype)
    return out
