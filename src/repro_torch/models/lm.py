"""Dense-decoder language model: parameters, prefill and decode.

The port of ``repro/models/lm.py``'s serving path for dense GQA
decoders with a SiLU-gated FFN (qwen3-8b, deepseek-7b,
deepseek-coder-33b).  Parameters are the JAX package's nested dicts,
stacked over layers (``params["blocks"]["attn"]["wq"]`` is ``(L, d,
H*hd)``), so :mod:`repro_torch.models.convert` carries a reference
parameter tree across unchanged; layers run as a Python loop over that
stack.  SSM, hybrid, MoE, M-RoPE and audio architectures raise
:class:`NotImplementedError` naming the arch.

Attention runs through :mod:`repro_torch.kernels.ops`: the port's
hand-written kernels on the card, their plain versions on the CPU.
Projections and the FFN are ``torch.matmul`` in bf16, as the JAX
package left them to XLA.

Unlike the JAX functions, which returned new arrays, the session cache
is updated **in place**: :func:`append_kv`, :func:`append_kv_paged` and
:func:`decode_step` write into the cache tensors they are given (and
:func:`decode_step` replaces ``cache["pos"]``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.describe import global_layer_mask
from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import AttnParams
from repro_torch.models.common import rms_norm, truncated_normal_


@dataclasses.dataclass(frozen=True)
class RunCfg:
    """Plan-derived knobs (filled by ``core.passes.lowering.build_run_cfg``).

    ``flash_tiles`` is the plan's ``flash_attention`` BlockPlan as
    ``(block_q, block_kv)`` and ``decode_block_kv`` its
    ``decode_attention`` tile (both decode kernels, paged and dense,
    stage that many cache rows per step); ``None`` means the plan has
    none and the kernel module's documented default applies.
    ``kernels`` is the plan's ``use_pallas`` mode.  The JAX package's
    mesh and sharding fields are gone (the port runs on one card), and
    so are the knobs of paths the port does not have yet.
    """

    kv_heads_padded: int = 0       # 0 -> arch.n_kv_heads
    flash_tiles: Optional[Tuple[int, int]] = None
    decode_block_kv: Optional[int] = None
    kernels: str = "auto"


def check_supported(arch: ArchConfig) -> None:
    """Raise for an architecture the port cannot run yet."""
    why = None
    if arch.has_ssm:
        why = "SSM/hybrid mixers"
    elif arch.is_moe:
        why = "MoE FFNs"
    elif arch.mrope_sections is not None:
        why = "M-RoPE"
    elif arch.modality != "text" or arch.is_encoder:
        why = f"{arch.modality} {arch.family} models"
    elif not arch.has_attention:
        why = "attention-free models"
    elif not arch.gated_mlp:
        why = "non-gated FFNs"
    if why is not None:
        raise NotImplementedError(
            f"{arch.name}: the port serves dense GQA decoders with a "
            f"SiLU-gated FFN; {why} are not ported yet")


# =====================================================================
# Parameters
# =====================================================================

class LeafSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype
    scale: float = 0.02             # 0.0 -> zeros


def leaf_specs(arch: ArchConfig, vocab_padded: int = 0,
               heads_padded: int = 0, ssm_heads_padded: int = 0,
               kv_heads_padded: int = 0) -> Dict[str, Any]:
    """The parameter-spec tree (same keys, shapes and argument order as
    the JAX one; ``ssm_heads_padded`` has no leaf in a dense decoder)."""
    check_supported(arch)
    bf, f32 = torch.bfloat16, torch.float32
    d, L, hd, ff = arch.d_model, arch.n_layers, arch.hd, arch.d_ff
    V = vocab_padded or arch.vocab_size
    H = heads_padded or arch.n_heads
    K = kv_heads_padded or arch.n_kv_heads
    out_scale = 0.02 / math.sqrt(2 * L)
    attn = {
        "wq": LeafSpec((L, d, H * hd), bf),
        "wk": LeafSpec((L, d, K * hd), bf),
        "wv": LeafSpec((L, d, K * hd), bf),
        "wo": LeafSpec((L, H * hd, d), bf, out_scale),
    }
    if arch.qk_norm:
        attn["q_norm"] = LeafSpec((L, hd), f32, 0.0)
        attn["k_norm"] = LeafSpec((L, hd), f32, 0.0)
    specs: Dict[str, Any] = {
        "embed": LeafSpec((V, d), bf),
        "final_norm": LeafSpec((d,), f32, 0.0),
        "blocks": {
            "pre_norm": LeafSpec((L, d), f32, 0.0),
            "attn": attn,
            "mlp_norm": LeafSpec((L, d), f32, 0.0),
            "mlp": {"wi": LeafSpec((L, d, 2 * ff), bf),
                    "wo": LeafSpec((L, ff, d), bf, out_scale)},
        },
    }
    if not arch.tie_embeddings:
        specs["lm_head"] = LeafSpec((d, V), bf)
    return specs


def _map_specs(specs, fn):
    if isinstance(specs, LeafSpec):
        return fn(specs)
    return {k: _map_specs(v, fn) for k, v in specs.items()}


def init_params(arch: ArchConfig, generator: torch.Generator,
                vocab_padded: int = 0, heads_padded: int = 0,
                ssm_heads_padded: int = 0,
                kv_heads_padded: int = 0) -> Dict[str, Any]:
    """Random parameters on ``generator``'s device: truncated normal
    (two standard deviations) at each leaf's scale, zeros where the
    scale is 0 (norm weights — :func:`rms_norm` scales by ``1 + w``).
    Layout-padded heads get zero projections, as in the JAX package."""
    dev = generator.device

    def leaf(s: LeafSpec) -> torch.Tensor:
        t = torch.zeros(s.shape, dtype=s.dtype, device=dev)
        if s.scale != 0.0:
            truncated_normal_(t, s.scale, generator)
        return t

    params = _map_specs(leaf_specs(arch, vocab_padded, heads_padded,
                                   ssm_heads_padded, kv_heads_padded), leaf)
    attn = params["blocks"]["attn"]
    if heads_padded and heads_padded != arch.n_heads:
        cut = arch.n_heads * arch.hd
        attn["wq"][..., cut:] = 0
        attn["wo"][:, cut:, :] = 0
    if kv_heads_padded and kv_heads_padded != arch.n_kv_heads:
        cut = arch.n_kv_heads * arch.hd
        attn["wk"][..., cut:] = 0
        attn["wv"][..., cut:] = 0
    return params


def _layer(blocks: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i``'s slice of the stacked block parameters (views)."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in blocks.items()}


def _window_schedule(arch: ArchConfig) -> List[int]:
    """Per-layer attention window (0 = global)."""
    return [0 if g else arch.window for g in global_layer_mask(arch)]


# =====================================================================
# Forward pieces
# =====================================================================

def _embed_in(arch: ArchConfig, params, batch) -> torch.Tensor:
    """Token embeddings ``(B, S, d)`` bf16.  The port takes token ids
    at positions ``0..S-1`` only (no precomputed embeddings or custom
    position streams)."""
    if "embeds" in batch or "positions" in batch:
        raise NotImplementedError(
            f"{arch.name}: the port takes token ids at default positions")
    return params["embed"][batch["tokens"].long()]


def _logits(arch: ArchConfig, params, x: torch.Tensor) -> torch.Tensor:
    """Logits stay bf16 (the sampler upcasts)."""
    w = params["embed"].T if arch.tie_embeddings else params["lm_head"]
    return x @ w


def _attn_params(grp) -> AttnParams:
    a = grp["attn"]
    return AttnParams(a["wq"], a["wk"], a["wv"], a["wo"], a.get("q_norm"),
                      a.get("k_norm"))


def _qkv(arch: ArchConfig, grp, h: torch.Tensor, positions: torch.Tensor):
    ap = _attn_params(grp)
    return ap, attn_mod.project_qkv(
        h, ap, ap.wq.shape[-1] // arch.hd, ap.wk.shape[-1] // arch.hd,
        arch.hd, positions, arch.rope_theta, arch.norm_eps)


def _mixer_fwd(arch: ArchConfig, cfg: RunCfg, grp, x: torch.Tensor,
               positions: torch.Tensor, window: int):
    """Pre-norm attention over a whole prompt.  Returns ``(x, k, v)``
    with this layer's post-RoPE keys and values for the cache."""
    h = rms_norm(x, grp["pre_norm"], arch.norm_eps)
    ap, (q, k, v) = _qkv(arch, grp, h, positions)
    ctx = attn_mod.attention_chunked(q, k, v, causal=arch.causal,
                                     window=window, tiles=cfg.flash_tiles,
                                     mode=cfg.kernels)
    return x + ctx.reshape(*ctx.shape[:2], -1) @ ap.wo, k, v


def _ffn_fwd(arch: ArchConfig, grp, x: torch.Tensor) -> torch.Tensor:
    """Pre-norm SiLU-gated FFN."""
    h = rms_norm(x, grp["mlp_norm"], arch.norm_eps)
    g, u = (h @ grp["mlp"]["wi"]).chunk(2, dim=-1)
    z = F.silu(g.float()).to(x.dtype) * u
    return x + z @ grp["mlp"]["wo"]


# =====================================================================
# Session cache
# =====================================================================

def _kv_geometry(arch: ArchConfig, kv_heads: int) -> Tuple[int, int, int]:
    check_supported(arch)
    return arch.n_layers, kv_heads or arch.n_kv_heads, arch.hd


def init_cache(arch: ArchConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, kv_heads: int = 0,
               device="cuda") -> Dict[str, torch.Tensor]:
    """Dense session state: ``k``/``v`` stripes ``(L, B, max_len, K,
    hd)`` and per-slot positions ``pos`` ``(B,)``."""
    L, K, hd = _kv_geometry(arch, kv_heads)
    shape = (L, batch_size, max_len, K, hd)
    return {"pos": torch.zeros((batch_size,), dtype=torch.int32,
                               device=device),
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_cache(arch: ArchConfig, batch_size: int, max_len: int,
                     block_len: int, n_blocks: int, dtype=torch.bfloat16,
                     kv_heads: int = 0, device="cuda"
                     ) -> Dict[str, torch.Tensor]:
    """Paged session state: ``k``/``v`` block pools ``(L, n_blocks,
    block_len, K, hd)`` shared by all slots (one block id addresses the
    same block in every layer), ``block_tbl`` ``(B, ceil(max_len /
    block_len))`` int32 with -1 = unassigned, and ``pos`` ``(B,)``."""
    L, K, hd = _kv_geometry(arch, kv_heads)
    nb = -(-max_len // block_len)
    shape = (L, n_blocks, block_len, K, hd)
    return {"pos": torch.zeros((batch_size,), dtype=torch.int32,
                               device=device),
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "block_tbl": torch.full((batch_size, nb), -1, dtype=torch.int32,
                                    device=device)}


def append_kv(cache: torch.Tensor, new: torch.Tensor,
              pos: torch.Tensor) -> torch.Tensor:
    """Per-slot append **in place**: ``cache[b, pos[b]] = new[b, 0]``
    for ``cache`` ``(B, S, K, hd)``, ``new`` ``(B, 1, K, hd)``, ``pos``
    ``(B,)`` (oracle: ``ref.decode_append_ref``).  Returns ``cache``."""
    B = cache.shape[0]
    b = torch.arange(B, device=cache.device)
    cache[b, pos.long().reshape(-1).expand(B)] = new[:, 0].to(cache.dtype)
    return cache


def paged_targets(pos: torch.Tensor, tbl: torch.Tensor, block_len: int):
    """``(slot, block, row)`` of each slot's append whose owning table
    entry is assigned; slots whose entry is -1 (freed slots) are masked
    out here, before any write (torch has no scatter ``mode="drop"``).
    On the card the boolean mask costs one host sync."""
    pos = pos.long()
    blk = tbl.long().gather(1, (pos // block_len)[:, None])[:, 0]
    keep = blk >= 0
    b = torch.arange(pos.shape[0], device=pos.device)
    return b[keep], blk[keep], (pos % block_len)[keep]


def append_kv_paged(pool: torch.Tensor, new: torch.Tensor,
                    pos: torch.Tensor, tbl: torch.Tensor,
                    targets=None) -> torch.Tensor:
    """Paged append **in place**: write ``new[b, 0]`` into slot b's
    owning block, ``pool[tbl[b, pos[b] // bl], pos[b] % bl]``; a slot
    whose owning entry is -1 writes nothing (oracle:
    ``ref.paged_append_ref``).  ``targets`` reuses a
    :func:`paged_targets` result across layers.  Returns ``pool``."""
    b, blk, row = targets if targets is not None else \
        paged_targets(pos, tbl, pool.shape[1])
    pool[blk, row] = new[b, 0].to(pool.dtype)
    return pool


# =====================================================================
# Serving: prefill + decode
# =====================================================================

def prefill(arch: ArchConfig, params, batch, cfg: RunCfg,
            max_len: int = 0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Process prompts ``batch["tokens"]`` ``(B, S)``: returns the
    last-token logits ``(B, V)`` and a dense cache of ``max_len`` rows
    (default ``S``) holding every layer's post-RoPE K/V for rows
    ``0..S-1`` (zeros past them) with ``pos = S``."""
    x = _embed_in(arch, params, batch)
    B, S = x.shape[:2]
    max_len = max_len or S
    positions = torch.arange(S, device=x.device).expand(B, S)
    blocks = params["blocks"]
    cache = init_cache(arch, B, max_len,
                       kv_heads=blocks["attn"]["wk"].shape[-1] // arch.hd,
                       device=x.device)
    for i, w in enumerate(_window_schedule(arch)):
        grp = _layer(blocks, i)
        x, k, v = _mixer_fwd(arch, cfg, grp, x, positions, w)
        x = _ffn_fwd(arch, grp, x)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    x = rms_norm(x[:, -1:], params["final_norm"], arch.norm_eps)
    cache["pos"].fill_(S)
    return _logits(arch, params, x)[:, 0], cache


def decode_step(arch: ArchConfig, params, cache: Dict[str, torch.Tensor],
                batch, cfg: RunCfg
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode for every slot: appends each slot's K/V at its
    own ``cache["pos"]`` (in place), attends over ``pos + 1`` rows, and
    sets ``cache["pos"] = pos + 1``.  A ``block_tbl`` in the cache
    selects paged residency.  Returns ``(logits (B, V), cache)``."""
    x = _embed_in(arch, params, batch)                      # (B, 1, d)
    B = x.shape[0]
    pos = torch.as_tensor(cache["pos"], dtype=torch.int32, device=x.device)
    pos = pos.reshape(-1).expand(B).contiguous()
    positions = pos[:, None]
    cache_len = pos + 1
    tbl = cache.get("block_tbl")
    targets = (paged_targets(pos, tbl, cache["k"].shape[2])
               if tbl is not None else None)
    blocks = params["blocks"]
    for i, w in enumerate(_window_schedule(arch)):
        grp = _layer(blocks, i)
        h = rms_norm(x, grp["pre_norm"], arch.norm_eps)
        ap, (q, k, v) = _qkv(arch, grp, h, positions)
        kc, vc = cache["k"][i], cache["v"][i]
        if tbl is not None:
            append_kv_paged(kc, k, pos, tbl, targets)
            append_kv_paged(vc, v, pos, tbl, targets)
            ctx = attn_mod.attention_decode_paged(
                q, kc, vc, tbl, cache_len=cache_len, window=w,
                block_kv=cfg.decode_block_kv, mode=cfg.kernels)
        else:
            append_kv(kc, k, pos)
            append_kv(vc, v, pos)
            ctx = attn_mod.attention_decode(
                q, kc, vc, cache_len=cache_len, window=w,
                block_kv=cfg.decode_block_kv, mode=cfg.kernels)
        x = x + ctx.reshape(B, 1, -1) @ ap.wo
        x = _ffn_fwd(arch, grp, x)
    x = rms_norm(x, params["final_norm"], arch.norm_eps)
    cache["pos"] = cache_len
    return _logits(arch, params, x)[:, 0], cache
