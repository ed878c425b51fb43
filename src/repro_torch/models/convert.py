"""Carry the JAX package's parameters into the port.

The JAX model's parameters are nested dicts of arrays stacked over
layers; :func:`params_from_numpy` takes that tree with every leaf
converted to numpy (``np.asarray`` per leaf) and returns the port's
tree of tensors — same keys, same shapes, same values, bit for bit —
so both packages compute the same function.  bf16 leaves arrive as
numpy arrays of the ``bfloat16`` extension dtype; they cross as raw
16-bit words, so nothing here needs that dtype's package.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import LeafSpec, layer_params, leaf_specs


def tensor_from_numpy(arr: np.ndarray, device="cuda") -> torch.Tensor:
    """One leaf: bf16 by reinterpretation of its 16-bit words."""
    arr = np.array(arr, order="C")         # a writable copy torch may own
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def _convert(tree: Any, device) -> Any:
    if isinstance(tree, Mapping):
        return {k: _convert(v, device) for k, v in tree.items()}
    return tensor_from_numpy(np.asarray(tree), device)


def _check(arch: ArchConfig, params, specs, path: str = "") -> None:
    if isinstance(specs, LeafSpec):
        if tuple(params.shape) != specs.shape or params.dtype != specs.dtype:
            raise ValueError(
                f"{arch.name}: parameter {path} is {tuple(params.shape)} "
                f"{params.dtype}, the port expects {specs.shape} "
                f"{specs.dtype}")
        return
    if set(params) != set(specs):
        raise ValueError(f"{arch.name}: parameter keys at {path or '/'} "
                         f"{sorted(params)} != {sorted(specs)}")
    for k in specs:
        _check(arch, params[k], specs[k], f"{path}/{k}")


def params_from_numpy(arch: ArchConfig, tree: Mapping[str, Any],
                      device="cuda") -> dict:
    """The port's parameters from a JAX parameter tree of numpy arrays,
    checked leaf by leaf against :func:`leaf_specs` (padded sizes are
    read off the tree's own shapes, at layer 0: through
    ``blocks["dense"]`` in a super-block tree).  MoE leaves and the
    super-block tree cross like any other."""
    params = _convert(tree, device)
    hd = arch.hd
    grp = layer_params(params["blocks"], 0)
    attn, ssm = grp.get("attn"), grp.get("ssm")
    specs = leaf_specs(
        arch, vocab_padded=params["embed"].shape[0],
        heads_padded=attn["wq"].shape[-1] // hd if attn else 0,
        ssm_heads_padded=ssm["A_log"].shape[-1] if ssm else 0,
        kv_heads_padded=attn["wk"].shape[-1] // hd if attn else 0)
    _check(arch, params, specs)
    return params
