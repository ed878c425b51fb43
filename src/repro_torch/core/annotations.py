"""Domain-specific annotations (paper §1: "use domain-specific annotations
to pass useful information to the compiler").

Model code does not build :class:`~repro_torch.core.ir.TensorDecl` objects by
hand; it calls the helpers below, which encode the *domain knowledge* of
LM workloads (weights are broadcast-read + high reuse, activations are
streamed, KV caches are session-lived + random-read at decode, ...).

These are the same defaults a designer would attach with ``#pragma``-style
annotations in the paper's C/MLIR flow.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from repro_torch.core.ir import (
    AccessPattern,
    Lifetime,
    Reuse,
    Role,
    TensorDecl,
)


def weight(
    name: str,
    shape: Tuple[int, ...],
    axes: Tuple[Optional[str], ...],
    dtype: str = "bfloat16",
    expert: bool = False,
    **ann: Any,
) -> TensorDecl:
    return TensorDecl(
        name=name,
        shape=shape,
        dtype=dtype,
        role=Role.EXPERT_PARAM if expert else Role.PARAM,
        logical_axes=axes,
        access=AccessPattern.BROADCAST,
        reuse=Reuse.HIGH,
        lifetime=Lifetime.PERSISTENT,
        annotations=ann,
    )


def activation(
    name: str,
    shape: Tuple[int, ...],
    axes: Tuple[Optional[str], ...],
    dtype: str = "bfloat16",
    **ann: Any,
) -> TensorDecl:
    return TensorDecl(
        name=name,
        shape=shape,
        dtype=dtype,
        role=Role.ACTIVATION,
        logical_axes=axes,
        access=AccessPattern.SEQUENTIAL,
        reuse=Reuse.NONE,
        lifetime=Lifetime.EPHEMERAL,
        annotations=ann,
    )


def model_input(
    name: str,
    shape: Tuple[int, ...],
    axes: Tuple[Optional[str], ...],
    dtype: str = "int32",
    **ann: Any,
) -> TensorDecl:
    return TensorDecl(
        name=name,
        shape=shape,
        dtype=dtype,
        role=Role.INPUT,
        logical_axes=axes,
        access=AccessPattern.SEQUENTIAL,
        reuse=Reuse.NONE,
        lifetime=Lifetime.STEP,
        annotations=ann,
    )


def kv_cache(
    name: str,
    shape: Tuple[int, ...],
    axes: Tuple[Optional[str], ...],
    dtype: str = "bfloat16",
    **ann: Any,
) -> TensorDecl:
    return TensorDecl(
        name=name,
        shape=shape,
        dtype=dtype,
        role=Role.KV_CACHE,
        logical_axes=axes,
        # decode reads the whole cache every step: streamed, high reuse
        access=AccessPattern.SEQUENTIAL,
        reuse=Reuse.HIGH,
        lifetime=Lifetime.SESSION,
        annotations=ann,
    )


def ssm_state(
    name: str,
    shape: Tuple[int, ...],
    axes: Tuple[Optional[str], ...],
    dtype: str = "float32",
    **ann: Any,
) -> TensorDecl:
    return TensorDecl(
        name=name,
        shape=shape,
        dtype=dtype,
        role=Role.SSM_STATE,
        logical_axes=axes,
        access=AccessPattern.SEQUENTIAL,
        reuse=Reuse.HIGH,
        lifetime=Lifetime.SESSION,
        annotations=ann,
    )


def opt_state(
    name: str,
    shape: Tuple[int, ...],
    axes: Tuple[Optional[str], ...],
    dtype: str = "float32",
    **ann: Any,
) -> TensorDecl:
    return TensorDecl(
        name=name,
        shape=shape,
        dtype=dtype,
        role=Role.OPT_STATE,
        logical_axes=axes,
        access=AccessPattern.SEQUENTIAL,
        reuse=Reuse.LOW,
        lifetime=Lifetime.PERSISTENT,
        annotations=ann,
    )


def gradient(
    name: str,
    shape: Tuple[int, ...],
    axes: Tuple[Optional[str], ...],
    dtype: str = "bfloat16",
    **ann: Any,
) -> TensorDecl:
    return TensorDecl(
        name=name,
        shape=shape,
        dtype=dtype,
        role=Role.GRAD,
        logical_axes=axes,
        access=AccessPattern.REDUCTION,
        reuse=Reuse.LOW,
        lifetime=Lifetime.STEP,
        annotations=ann,
    )
