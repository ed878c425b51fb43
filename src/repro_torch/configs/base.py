"""Architecture + shape configuration system.

Every assigned architecture is a frozen :class:`ArchConfig`; shapes are
:class:`ShapeConfig`.  ``registry()`` exposes them to the CLI
(``--arch <id> --shape <id>``).  Reduced configs for CPU smoke tests come
from :meth:`ArchConfig.reduced`.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encoder
    modality: str = "text"       # text | audio | vlm
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0            # 0 -> d_model // n_heads

    # attention details
    causal: bool = True
    qk_norm: bool = False
    rope_theta: float = 1e4
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl
    window: int = 0              # 0 = full attention; >0 = sliding window
    global_every: int = 0        # hymba: every k-th layer is global attn
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    gated_mlp: bool = True       # SwiGLU (3 mats) vs squared-ReLU (2 mats)

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0            # expert hidden dim (0 -> d_ff)
    moe_interleave: int = 1      # MoE every k-th layer (llama4: 2)
    n_shared_experts: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_n_groups: int = 1

    dtype: str = "bfloat16"
    source: str = ""             # provenance tag from the assignment

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def has_attention(self) -> bool:
        return self.n_heads > 0

    @property
    def has_ssm(self) -> bool:
        return self.ssm_state > 0

    @property
    def is_encoder(self) -> bool:
        return self.family == "encoder"

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch handle 500k-token context (decode) sanely?"""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.window > 0

    # --- parameter counts (analytical; cross-checked in tests) ---------
    def param_count(self) -> int:
        d, L = self.d_model, self.n_layers
        n = 0
        # embeddings (+ untied head)
        n += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.has_attention:
            q = d * self.n_heads * self.hd
            kv = 2 * d * self.n_kv_heads * self.hd
            o = self.n_heads * self.hd * d
            per_layer += q + kv + o
        if self.has_ssm:
            di, g, s = self.d_inner, self.ssm_n_groups, self.ssm_state
            in_proj = d * (2 * di + 2 * g * s + self.ssm_heads)
            conv = (di + 2 * g * s) * self.ssm_conv
            out = di * d
            per_layer += in_proj + conv + out + 2 * self.ssm_heads  # A,D
        n += per_layer * L
        # FFN: dense layers + MoE layers
        if self.is_moe:
            moe_ff = self.moe_d_ff or self.d_ff
            n_moe_layers = L // self.moe_interleave
            n_dense_layers = L - n_moe_layers
            n += n_moe_layers * self.n_experts * 3 * d * moe_ff
            n += n_moe_layers * self.n_shared_experts * 3 * d * moe_ff
            n += n_moe_layers * d * self.n_experts          # router
            n += n_dense_layers * 3 * d * self.d_ff
        elif self.d_ff:
            # SwiGLU (gate, up, down) vs plain 2-matrix FFN (hubert, minitron)
            mult = 3 if (self.gated_mlp and self.family != "encoder") else 2
            n += L * mult * d * self.d_ff
        # norms
        n += L * 2 * d + d
        return n

    def active_param_count(self) -> int:
        """Per-token active params (MoE: only routed experts count)."""
        if not self.is_moe:
            return self.param_count()
        full = self.param_count()
        moe_ff = self.moe_d_ff or self.d_ff
        n_moe_layers = self.n_layers // self.moe_interleave
        all_experts = n_moe_layers * self.n_experts * 3 * self.d_model * moe_ff
        active = n_moe_layers * self.experts_per_token * 3 * self.d_model * moe_ff
        return full - all_experts + active

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        r = lambda v, m: min(v, m) if v else v
        mrope = None
        if self.mrope_sections is not None:
            half = 32 // 2          # reduced head_dim is 32
            s = half * 3 // 8
            mrope = (half - 2 * s, s, s)
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 2 * max(self.moe_interleave, 1)),
            d_model=128,
            n_heads=r(self.n_heads, 4),
            n_kv_heads=r(self.n_kv_heads, 2),
            head_dim=32 if self.n_heads else 0,
            d_ff=r(self.d_ff, 256) if self.d_ff else 0,
            moe_d_ff=r(self.moe_d_ff, 128) if self.moe_d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            n_experts=r(self.n_experts, 8),
            experts_per_token=r(self.experts_per_token, 2),
            ssm_state=r(self.ssm_state, 16),
            ssm_head_dim=32 if self.ssm_state else 64,
            window=min(self.window, 64) if self.window else 0,
            mrope_sections=mrope,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        if self.kind == "decode":
            return self.global_batch          # one new token per sequence
        return self.seq_len * self.global_batch


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Which (arch × shape) cells are runnable (DESIGN.md §5)."""
    if arch.is_encoder and shape.kind == "decode":
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, "pure full-attention arch; 500k KV decode excluded per spec"
    return True, ""


_ARCH_MODULES = {
    "hubert-xlarge": "hubert_xlarge",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "mamba2-2.7b": "mamba2_2p7b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "qwen3-8b": "qwen3_8b",
    "deepseek-7b": "deepseek_7b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "minitron-8b": "minitron_8b",
    "hymba-1.5b": "hymba_1p5b",
}


def get_arch(name: str) -> ArchConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


def reduced_on(arch: ArchConfig, device) -> ArchConfig:
    """``arch.reduced()`` for a run on ``device``: on a CUDA device kept
    at the published head_dim and GQA group (the widths the card's
    kernels are built for), on any other as it is."""
    import torch
    small = arch.reduced()
    if torch.device(device).type != "cuda" or not arch.n_heads:
        return small
    group = arch.n_heads // arch.n_kv_heads
    return dataclasses.replace(small, head_dim=arch.hd,
                               n_heads=small.n_kv_heads * group)


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; have {sorted(SHAPES)}")
    return SHAPES[name]


def all_archs() -> Tuple[str, ...]:
    return tuple(_ARCH_MODULES)


def all_cells() -> Tuple[Tuple[str, str, bool, str], ...]:
    """Every (arch, shape, runnable, reason) cell — 40 total."""
    out = []
    for a in all_archs():
        cfg = get_arch(a)
        for s in SHAPES:
            ok, why = applicable(cfg, SHAPES[s])
            out.append((a, s, ok, why))
    return tuple(out)
