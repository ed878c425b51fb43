"""Language model: parameters, training forward and loss, prefill and
decode.

The port of ``repro/models/lm.py``'s serving path for dense GQA
decoders with a SiLU-gated FFN (qwen3-8b, deepseek-7b,
deepseek-coder-33b) or a squared-ReLU FFN (minitron-8b), attention-free
mamba2 SSM decoders (mamba2-2.7b), the hybrid hymba-1.5b, whose layers
run attention (global or a sliding window, per layer) and a mamba2
mixer in parallel, and MoE decoders: an MoE FFN in every layer
(granite-moe-1b-a400m) or super-blocks of a dense and an MoE layer
(llama4-maverick-400b-a17b, ``moe_interleave = 2``, with a shared
expert), qwen2-vl-72b (a dense decoder whose rotary embedding is M-RoPE
over three position streams, fed precomputed patch embeddings) and the
encoder hubert-xlarge (non-causal attention without RoPE, a one-matrix
GELU FFN, precomputed frame embeddings plus a sinusoidal position
table; no decode step).  Parameters are the JAX package's nested
dicts, stacked over layers (``params["blocks"]["attn"]["wq"]`` is ``(L, d, H*hd)``; a
super-block tree stacks ``blocks["dense"]`` and ``blocks["moe"]`` over
the ``L / 2`` super-blocks), so :mod:`repro_torch.models.convert`
carries a reference parameter tree across unchanged; layers run as a
Python loop, each reading its slice through :func:`layer_params`.
A batch holds ``tokens`` or ``embeds`` (the frontend stubs':
:mod:`repro_torch.models.frontends`) and optional ``positions``; the
reference masks attention by the positions' temporal stream, which the
flash kernel does only where it is each row's index
(:func:`_embed_in`, :func:`repro_torch.models.attention
.attention_chunked`).

Attention and the SSD scan run through :mod:`repro_torch.kernels.ops`:
the port's hand-written kernels on the card, their plain versions on
the CPU.  Projections, the FFN and the MoE products
(:mod:`repro_torch.models.moe`) are ``torch.matmul`` / ``torch.bmm``
in bf16, as the JAX package left them to XLA.

Training (:func:`forward`, :func:`train_loss`) runs every family
prefill serves: the same layer pieces (``_qkv``, ``_ffn``,
``_residual``), attention through the flash kernels' autograd function
and the SSD scan through the scan kernels' (forward and backward kernels
on the card), the MoE FFN's router aux loss summed over layers, each
layer (a super-block: both its layers) wrapped in the plan's remat
policy (:func:`_remat`).  The stacked parameter leaves are split into
layers by one ``unbind`` each, so the backward stacks each leaf's
gradient once (a per-layer ``leaf[i]`` would allocate a whole
zero-filled stack per layer in its backward).

Unlike the JAX functions, which returned new arrays, the session cache
is updated **in place**: :func:`append_kv`, :func:`append_kv_paged` and
:func:`decode_step` write into the cache tensors they are given (and
:func:`decode_step` replaces ``cache["pos"]``); so does the SSM state.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.describe import global_layer_mask
from repro_torch.dist import fsdp
from repro_torch.kernels.fake import is_fake
from repro_torch.kernels.ssd_scan import DEFAULT_CHUNK
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import tp
from repro_torch.models.attention import AttnParams
from repro_torch.models.common import (
    Z_LOSS,
    rms_norm,
    sinusoidal_positions,
    token_nll,
    truncated_normal_,
)
from repro_torch.models.moe import MoEParams
from repro_torch.models.ssm import SSMDims, SSMParams


@dataclasses.dataclass(frozen=True)
class RunCfg:
    """Plan-derived knobs (filled by ``core.passes.lowering.build_run_cfg``).

    ``flash_tiles`` is the plan's ``flash_attention`` BlockPlan as
    ``(block_q, block_kv)`` and ``decode_block_kv`` its
    ``decode_attention`` tile (both decode kernels, paged and dense,
    stage that many cache rows per step); ``None`` means the plan has
    none and the kernel module's documented default applies.
    ``ssd_chunk`` and ``ssd_heads_block`` are the plan's ``ssd_scan``
    BlockPlan (the kernel module's ``DEFAULT_CHUNK`` and one head
    without one).  ``moe_impl`` is the communication pass's MoE path
    (:data:`repro_torch.models.moe.IMPLS`; any other raises when an MoE
    layer runs).
    ``kernels`` is the plan's ``use_pallas`` mode.  ``remat`` is the
    communication pass's remat policy (``none``, ``dots`` /
    ``dots_saveable``, ``full``).  The padded vocab needs no field on
    one card: the logits take their width from ``lm_head`` and the loss
    masks past ``arch.vocab_size``.

    On a mesh, ``mesh``
    is the :class:`torch.distributed.device_mesh.DeviceMesh` whose ranks
    each hold their piece of the parameters and cache, ``data_axes`` and
    ``model_axis`` name its axes, ``heads_padded`` / ``vocab_padded`` /
    ``ssm_heads_padded`` the whole sizes a piece is measured against
    (0: the arch's; the layout pass pads SSM heads to a multiple of the
    model axis where it splits them), and
    ``decode_impl`` / ``combine_topology`` the plan's decode decisions.
    Training on a mesh sets ``fsdp``, the tree of each leaf's FSDP
    gather (:class:`repro_torch.dist.fsdp.MeshLayout`), and
    ``batch_axes``, the axes the loss averages over: a rank's loss is
    its share of the mean over the whole global batch (empty: over its
    own tokens, as the compressed wire step's per-slice losses are).
    The engine that placed the cache sets ``kv_split``: ``"heads"``
    (the kv-head dim is split over the model axis: every rank decodes
    its own heads), ``"rows"`` (the seq dim, or a paged cache's pool
    dim, is split: :mod:`repro_torch.dist.flash_decode`), ``"head_dim"``
    (each rank holds its columns of every kv head: K9's two passes
    around an all-reduce of the scores), or ``"none"``;
    and ``kv_whole``, the whole cache's ``(batch, seq_len or
    n_blocks)``.
    """

    kv_heads_padded: int = 0       # 0 -> arch.n_kv_heads
    flash_tiles: Optional[Tuple[int, int]] = None
    decode_block_kv: Optional[int] = None
    ssd_chunk: int = DEFAULT_CHUNK
    ssd_heads_block: int = 1
    moe_impl: str = "gshard_einsum"
    kernels: str = "auto"
    remat: str = "none"
    mesh: Any = None
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    decode_impl: str = "xla"
    combine_topology: Optional[str] = None
    heads_padded: int = 0
    vocab_padded: int = 0
    ssm_heads_padded: int = 0
    kv_split: str = "none"
    kv_whole: Tuple[int, int] = (0, 0)
    fsdp: Any = None
    batch_axes: Tuple[str, ...] = ()


#: the families and modalities the port runs (every arch of ``configs``)
FAMILIES = ("dense", "moe", "ssm", "hybrid", "encoder")
MODALITIES = ("text", "audio", "vlm")


def check_supported(arch: ArchConfig) -> None:
    """Raise for an architecture the port cannot run: a family or a
    modality the JAX package does not have."""
    if arch.family not in FAMILIES or arch.modality not in MODALITIES:
        raise NotImplementedError(
            f"{arch.name}: the port runs the families {FAMILIES} in the "
            f"modalities {MODALITIES}, not {arch.family} / {arch.modality}")


def check_serves(arch: ArchConfig) -> None:
    """Raise for an arch that cannot be served: an encoder has no decode
    step (the reference's reason, ``src/repro/configs/base.py:194-195``)."""
    check_supported(arch)
    if arch.is_encoder:
        raise NotImplementedError(
            f"{arch.name}: encoder-only arch has no decode step")


def check_on_device(arch: ArchConfig, device, *, heads: int = 0,
                    kv_heads: int = 0,
                    flash_tiles: Optional[Tuple[int, int]] = None,
                    head_dim_ways: int = 0) -> None:
    """Raise, before any weights are built, for an architecture whose
    attention the port's CUDA kernels do not take on ``device``: the
    rules are the kernels' own (:func:`repro_torch.kernels
    .flash_attention.kernel_tiles` at the plan's flash tiles and its
    ``HEAD_DIMS``, and :func:`repro_torch.kernels.decode_attention
    .takes_group`; an encoder, which has no decode step, needs no decode
    instance).  On the CPU every arch :func:`check_supported`
    admits runs (the plain versions take any GQA group and head_dim).
    ``heads``/``kv_heads`` are the layout pass's padded counts (0: the
    arch's own).  ``head_dim_ways`` > 0: the cache splits on head_dim
    over that many model ranks, so the decode runs K9 at ``(G, head_dim
    / head_dim_ways)`` (:func:`repro_torch.kernels.decode_attention
    .takes_split`) instead of the fused decode kernels."""
    check_supported(arch)
    if torch.device(device).type != "cuda" or not arch.has_attention:
        return
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    H, K = heads or arch.n_heads, kv_heads or arch.n_kv_heads
    G = H // K
    refused = []
    if arch.hd not in fa.HEAD_DIMS:
        refused.append(f"flash_attention (built for head_dim in "
                       f"{fa.HEAD_DIMS}, got {arch.hd})")
    try:
        fa.kernel_tiles(G, *(flash_tiles or (None, None)))
    except ValueError as e:
        refused.append(f"flash_attention ({e})")
    if head_dim_ways:
        DS = arch.hd // head_dim_ways
        if not dec.takes_split(G, DS):
            refused.append(
                f"K9 decode_split at (G, head_dim / m) = ({G}, {DS}), the "
                f"head_dim split over {head_dim_ways} ranks (built for "
                f"{dec.SPLIT_INSTANCES})")
    elif not arch.is_encoder and not dec.takes_group(G, arch.hd):
        refused.append(f"decode_attention (built for (GQA group, head_dim) "
                       f"in {dec.INSTANCES})")
    if refused:
        raise NotImplementedError(
            f"{arch.name}: GQA group G = {G} ({H} query heads over {K} kv "
            f"heads) at head_dim {arch.hd} is refused on CUDA by "
            + "; ".join(refused) + "; the plain versions serve it on the "
            "CPU")


# =====================================================================
# Parameters
# =====================================================================

class LeafSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype
    scale: float = 0.02             # 0.0 -> zeros


def _ssm_specs(arch: ArchConfig, L: int, d: int,
               ssm_heads_padded: int = 0) -> Dict[str, LeafSpec]:
    """The mamba2 mixer's leaves (``src/repro/models/lm.py:158-177``)."""
    bf, f32 = torch.bfloat16, torch.float32
    H = ssm_heads_padded or arch.ssm_heads
    di = H * arch.ssm_head_dim
    G, N = arch.ssm_n_groups, arch.ssm_state
    cdim = di + 2 * G * N
    return {
        "in_proj": LeafSpec((L, d, 2 * di + 2 * G * N + H), bf),
        "conv_w": LeafSpec((L, arch.ssm_conv, cdim), bf),
        "conv_b": LeafSpec((L, cdim), bf, 0.0),
        "A_log": LeafSpec((L, H), f32, 0.0),
        "D": LeafSpec((L, H), f32, 0.0),
        "dt_bias": LeafSpec((L, H), f32, 0.0),
        "norm": LeafSpec((L, di), f32, 0.0),
        "out_proj": LeafSpec((L, di, d), bf, 0.02 / math.sqrt(2 * L)),
    }


def _moe_specs(arch: ArchConfig, Lg: int, d: int) -> Dict[str, LeafSpec]:
    """The MoE FFN's leaves (``src/repro/models/lm.py:137-155``): the
    fp32 router, the gate||up and down expert stacks, and the shared
    expert's two matrices where the arch has one."""
    bf, f32 = torch.bfloat16, torch.float32
    ff, E = arch.moe_d_ff or arch.d_ff, arch.n_experts
    out_scale = 0.02 / math.sqrt(2 * arch.n_layers)
    specs = {"router": LeafSpec((Lg, d, E), f32),
             "wi": LeafSpec((Lg, E, d, 2 * ff), bf),
             "wo": LeafSpec((Lg, E, ff, d), bf, out_scale)}
    if arch.n_shared_experts:
        sf = ff * arch.n_shared_experts
        specs["shared_wi"] = LeafSpec((Lg, d, 2 * sf), bf)
        specs["shared_wo"] = LeafSpec((Lg, sf, d), bf, out_scale)
    return specs


def leaf_specs(arch: ArchConfig, vocab_padded: int = 0,
               heads_padded: int = 0, ssm_heads_padded: int = 0,
               kv_heads_padded: int = 0) -> Dict[str, Any]:
    """The parameter-spec tree (same keys, shapes and argument order as
    the JAX one).  A mamba2 block holds only ``pre_norm`` and ``ssm``;
    an MoE block ``moe`` where a dense one holds ``mlp``; an interleaved
    MoE arch ``blocks = {"dense": {...}, "moe": {...}}``, each stacked
    over the ``L / 2`` super-blocks (``src/repro/models/lm.py:212-221``)."""
    check_supported(arch)
    bf, f32 = torch.bfloat16, torch.float32
    d, L, hd, ff = arch.d_model, arch.n_layers, arch.hd, arch.d_ff
    V = vocab_padded or arch.vocab_size
    H = heads_padded or arch.n_heads
    K = kv_heads_padded or arch.n_kv_heads
    out_scale = 0.02 / math.sqrt(2 * L)
    # layers a super-block: llama4's [dense, MoE] pair, else 1
    g = arch.moe_interleave if arch.is_moe and arch.moe_interleave > 1 \
        else 1
    Lg = L // g

    def mixer(Lh: int) -> Dict[str, Any]:
        out: Dict[str, Any] = {"pre_norm": LeafSpec((Lh, d), f32, 0.0)}
        if arch.has_attention:
            attn = {
                "wq": LeafSpec((Lh, d, H * hd), bf),
                "wk": LeafSpec((Lh, d, K * hd), bf),
                "wv": LeafSpec((Lh, d, K * hd), bf),
                "wo": LeafSpec((Lh, H * hd, d), bf, out_scale),
            }
            if arch.qk_norm:
                attn["q_norm"] = LeafSpec((Lh, hd), f32, 0.0)
                attn["k_norm"] = LeafSpec((Lh, hd), f32, 0.0)
            out["attn"] = attn
        if arch.has_ssm:
            out["ssm"] = _ssm_specs(arch, Lh, d, ssm_heads_padded)
        return out

    def mlp(Lh: int) -> Dict[str, LeafSpec]:
        # SwiGLU fuses gate and up into one (d, 2 ff) matrix; the
        # squared-ReLU and the encoder's GELU FFN have one (d, ff)
        # (``_mlp_specs``)
        n_in = 2 if _gated(arch) else 1
        return {"wi": LeafSpec((Lh, d, n_in * ff), bf),
                "wo": LeafSpec((Lh, ff, d), bf, out_scale)}

    if arch.family == "ssm":
        blocks = mixer(L)
    elif g > 1:
        blocks = {"dense": {**mixer(Lg),
                            "mlp_norm": LeafSpec((Lg, d), f32, 0.0),
                            "mlp": mlp(Lg)},
                  "moe": {**mixer(Lg),
                          "mlp_norm": LeafSpec((Lg, d), f32, 0.0),
                          "moe": _moe_specs(arch, Lg, d)}}
    else:
        blocks = {**mixer(L), "mlp_norm": LeafSpec((L, d), f32, 0.0)}
        if arch.is_moe:
            blocks["moe"] = _moe_specs(arch, L, d)
        else:
            blocks["mlp"] = mlp(L)
    specs: Dict[str, Any] = {
        "embed": LeafSpec((V, d), bf),
        "final_norm": LeafSpec((d,), f32, 0.0),
        "blocks": blocks,
    }
    if not arch.tie_embeddings:
        specs["lm_head"] = LeafSpec((d, V), bf)
    return specs


def _map_specs(specs, fn):
    if isinstance(specs, LeafSpec):
        return fn(specs)
    return {k: _map_specs(v, fn) for k, v in specs.items()}


#: each leaf's logical axes by ``(parent key, leaf key)``, as the JAX
#: package's ``LeafSpec.axes`` name them (``src/repro/models/lm.py
#: :103-222``); a parent of ``None`` is a top-level or mixer leaf
_AXES = {
    (None, "embed"): ("vocab", "embed"),
    (None, "final_norm"): ("embed",),
    (None, "lm_head"): ("embed", "vocab"),
    (None, "pre_norm"): ("layers", "embed"),
    (None, "mlp_norm"): ("layers", "embed"),
    ("attn", "wq"): ("layers", "embed", "heads"),
    ("attn", "wk"): ("layers", "embed", "kv_heads"),
    ("attn", "wv"): ("layers", "embed", "kv_heads"),
    ("attn", "wo"): ("layers", "heads", "embed"),
    ("attn", "q_norm"): ("layers", None),
    ("attn", "k_norm"): ("layers", None),
    ("mlp", "wi"): ("layers", "embed", "ff"),
    ("mlp", "wo"): ("layers", "ff", "embed"),
    ("moe", "router"): ("layers", "embed", None),
    ("moe", "wi"): ("layers", "experts", "embed", "ff"),
    ("moe", "wo"): ("layers", "experts", "ff", "embed"),
    ("moe", "shared_wi"): ("layers", "embed", "ff"),
    ("moe", "shared_wo"): ("layers", "ff", "embed"),
    ("ssm", "in_proj"): ("layers", "embed", "ssm_inner"),
    ("ssm", "conv_w"): ("layers", None, "ssm_inner"),
    ("ssm", "conv_b"): ("layers", "ssm_inner"),
    ("ssm", "A_log"): ("layers", "ssm_heads"),
    ("ssm", "D"): ("layers", "ssm_heads"),
    ("ssm", "dt_bias"): ("layers", "ssm_heads"),
    ("ssm", "norm"): ("layers", "ssm_inner"),
    ("ssm", "out_proj"): ("layers", "ssm_inner", "embed"),
}


def _axes_tree(specs, parent=None):
    out = {}
    for k, v in specs.items():
        if isinstance(v, LeafSpec):
            # llama4's super-block subtree is named "moe" too: its norms
            # are mixer leaves
            out[k] = _AXES.get((parent, k)) or _AXES[(None, k)]
        else:
            out[k] = _axes_tree(v, k)
    return out


def param_shapes(arch: ArchConfig, vocab_padded: int = 0,
                 heads_padded: int = 0, ssm_heads_padded: int = 0,
                 kv_heads_padded: int = 0) -> Dict[str, Any]:
    """Each leaf's shape, in the tree of :func:`leaf_specs`."""
    return _map_specs(leaf_specs(arch, vocab_padded, heads_padded,
                                 ssm_heads_padded, kv_heads_padded),
                      lambda s: s.shape)


def param_axes(arch: ArchConfig, vocab_padded: int = 0,
               heads_padded: int = 0, ssm_heads_padded: int = 0,
               kv_heads_padded: int = 0) -> Dict[str, Any]:
    """Each leaf's logical axes (``src/repro/models/lm.py:245-252``), in
    the tree of :func:`leaf_specs`."""
    return _axes_tree(leaf_specs(arch, vocab_padded, heads_padded,
                                 ssm_heads_padded, kv_heads_padded))


def init_params(arch: ArchConfig, generator: torch.Generator,
                vocab_padded: int = 0, heads_padded: int = 0,
                ssm_heads_padded: int = 0,
                kv_heads_padded: int = 0, pieces=None) -> Dict[str, Any]:
    """Random parameters on ``generator``'s device: truncated normal
    (two standard deviations) at each leaf's scale, zeros where the
    scale is 0 (norm weights — :func:`rms_norm` scales by ``1 + w``).
    Layout-padded heads get zero projections, and the SSM leaves the JAX
    package's fixed values (``A_log = log(linspace(1, 16, H))``, ``D =
    1``, ``dt_bias = -2``).

    ``pieces``, a tree of :func:`leaf_specs`'s shape holding each
    leaf's ``(start, shape)`` (an offset and a size a dim), builds only
    those pieces: each leaf is drawn whole, slice by slice, as without
    it, and keeps its piece (:func:`truncated_normal_`), so a rank of a
    mesh holds exactly its pieces of the whole weights the same seed
    gives, and never a whole leaf
    (:func:`repro_torch.serve.sharded.param_pieces`)."""
    dev = generator.device
    specs = leaf_specs(arch, vocab_padded, heads_padded, ssm_heads_padded,
                       kv_heads_padded)

    def build(s, piece):
        if isinstance(s, dict):
            return {k: build(v, piece[k] if piece else None)
                    for k, v in s.items()}
        start, shape = piece if piece else (None, s.shape)
        t = torch.zeros(shape, dtype=s.dtype, device=dev)
        if s.scale != 0.0:
            truncated_normal_(t, s.scale, generator,
                              whole=s.shape if piece else None, start=start)
        return t

    def from_(t, at, dim, cut):
        # zero ``t`` from the whole index ``cut`` on along ``dim``
        k = min(max(cut - (at[dim] if at else 0), 0), t.shape[dim])
        t.narrow(dim, k, t.shape[dim] - k).zero_()

    params = build(specs, pieces)
    starts = _map_specs(specs, lambda s: None) if pieces is None else \
        _tree_map(lambda x: x[0], pieces)
    for grp, at, sp in zip(_mixer_groups(params["blocks"]),
                           _mixer_groups(starts["blocks"]),
                           _mixer_groups(specs["blocks"])):
        attn = grp.get("attn")
        if attn is not None and heads_padded and heads_padded != arch.n_heads:
            cut = arch.n_heads * arch.hd
            from_(attn["wq"], at["attn"]["wq"], 2, cut)
            from_(attn["wo"], at["attn"]["wo"], 1, cut)
        if attn is not None and kv_heads_padded \
                and kv_heads_padded != arch.n_kv_heads:
            cut = arch.n_kv_heads * arch.hd
            from_(attn["wk"], at["attn"]["wk"], 2, cut)
            from_(attn["wv"], at["attn"]["wv"], 2, cut)
        ssm = grp.get("ssm")
        if ssm is not None:
            H = sp["ssm"]["A_log"].shape[-1]
            a0 = at["ssm"]["A_log"][-1] if at["ssm"]["A_log"] else 0
            n = ssm["A_log"].shape[-1]
            ssm["A_log"].copy_(torch.log(torch.linspace(1.0, 16.0, H))
                               [a0:a0 + n])
            ssm["D"].fill_(1.0)
            ssm["dt_bias"].fill_(-2.0)
    return params


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _mixer_groups(blocks: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The stacks holding mixer leaves: a super-block tree's dense and
    MoE halves, else the block tree itself."""
    return [blocks["dense"], blocks["moe"]] if "dense" in blocks \
        else [blocks]


def _slice(blocks: Dict[str, Any], i: int) -> Dict[str, Any]:
    return {k: (_slice(v, i) if isinstance(v, dict) else v[i])
            for k, v in blocks.items()}


def layer_params(blocks: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i``'s parameters, as views of the stacked block tree.  In
    a super-block tree layer ``2j`` is ``blocks["dense"]`` row ``j`` and
    layer ``2j + 1`` is ``blocks["moe"]`` row ``j``: the cache's layer
    order of the reference's ``reshape(Lg, g)`` (``src/repro/models
    /lm.py:741-770``)."""
    if "dense" in blocks:
        j, r = divmod(i, 2)
        return _slice(blocks["moe" if r else "dense"], j)
    return _slice(blocks, i)



def _window_schedule(arch: ArchConfig) -> List[int]:
    """Per-layer attention window (0 = global; 0 in every layer of an
    arch without attention)."""
    mask = global_layer_mask(arch) or (True,) * arch.n_layers
    return [0 if g else arch.window for g in mask]


def _ssm_dims(arch: ArchConfig, sp: SSMParams,
              cfg: Optional[RunCfg] = None) -> SSMDims:
    """The whole mixer's dims.  On one card they are read off ``sp``, so
    that they follow the layout pass's padding (heads from ``A_log``,
    ``d_inner`` from ``out_proj``); on a mesh, whose ranks hold pieces,
    from the plan's padded head count (``cfg.ssm_heads_padded``)."""
    if tp.ctx(cfg) is None:
        H = sp.A_log.shape[-1]
        di = sp.out_proj.shape[-2]
    else:
        H = cfg.ssm_heads_padded or arch.ssm_heads
        di = H * arch.ssm_head_dim
    return SSMDims(arch.d_model, di, H, di // H, arch.ssm_state,
                   arch.ssm_n_groups, arch.ssm_conv)


# =====================================================================
# Forward pieces
# =====================================================================

def _gated(arch: ArchConfig) -> bool:
    """The SiLU-gated FFN (``src/repro/models/lm.py:128``): the
    encoder's is GELU whatever ``gated_mlp`` says."""
    return arch.gated_mlp and arch.family != "encoder"


def _embed_in(arch: ArchConfig, params, batch, cfg: Optional[RunCfg] = None):
    """``(x, positions, mask_pos)`` (``src/repro/models/lm.py:311-332``):
    ``x`` ``(B, S, d)`` bf16, the token embeddings or the batch's
    ``embeds`` (plus the sinusoidal table for audio); ``positions`` the
    batch's (``(3, B, S)`` under M-RoPE) or ``0..S-1``, broadcast to
    three streams under M-RoPE; ``mask_pos`` the positions attention is
    masked by, the temporal stream, or ``None`` where that is each
    row's index (the mask the flash kernel applies).  On a mesh the
    table's rows may be split over the model ranks (:func:`tp.embed`)."""
    if "embeds" in batch:
        x = batch["embeds"].to(torch.bfloat16)
        B, S = x.shape[:2]
        if arch.modality == "audio":
            x = x + sinusoidal_positions(S, arch.d_model,
                                         x.device)[None].to(x.dtype)
    else:
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = tp.embed(params["embed"], tokens, _vocab(arch, cfg), tp.ctx(cfg))
    rows = torch.arange(S, device=x.device)
    mask_pos = None
    if "positions" in batch:
        positions = batch["positions"].to(x.device)
        pos0 = positions[0] if positions.dim() == 3 else positions
        # the dry run's fake positions have no values: they are taken
        # as differing from the row index (an image's repeated ids)
        if is_fake(pos0) or not bool((pos0 == rows).all()):
            mask_pos = pos0
    else:
        positions = rows.expand(B, S)
        if arch.mrope_sections is not None:
            positions = positions.expand(3, B, S)
    return x, positions, mask_pos


def _logits(arch: ArchConfig, params, x: torch.Tensor,
            cfg: Optional[RunCfg] = None) -> torch.Tensor:
    """Logits stay bf16 (the sampler upcasts); on a mesh a vocab split
    over the model ranks is gathered whole."""
    w = params["embed"].T if arch.tie_embeddings else params["lm_head"]
    y = x @ w
    c = tp.ctx(cfg)
    if tp.split(_vocab(arch, cfg), w.shape[-1], c):
        y = tp.gather_model(y, -1, c)
    return y


def _vocab(arch: ArchConfig, cfg: Optional[RunCfg]) -> int:
    return (cfg.vocab_padded if cfg is not None else 0) or arch.vocab_size


def _heads(arch: ArchConfig, cfg: RunCfg) -> Tuple[int, int]:
    """The whole ``(query heads, kv heads)`` a rank's pieces are of."""
    return (cfg.heads_padded or arch.n_heads,
            cfg.kv_heads_padded or arch.n_kv_heads)


def _attn_out(arch: ArchConfig, cfg: RunCfg, c, ap: AttnParams,
              ctx: torch.Tensor, h0: int, hl: int) -> torch.Tensor:
    """The attention output projection: ``ctx`` ``(B, S, Hc, hd)`` holds
    the ``hl`` query heads from ``h0`` that this rank's rows of ``wo``
    take, or on a mesh all heads (then cut to the rank's); where ``wo``
    is split over the model ranks, their partials are summed."""
    if ctx.shape[2] != hl:
        ctx = ctx[:, :, h0:h0 + hl]
    y = ctx.reshape(*ctx.shape[:2], -1) @ ap.wo
    if tp.split(_heads(arch, cfg)[0] * arch.hd, ap.wo.shape[-2], c):
        y = tp.reduce_sum(y, c)
    return y


def _attention(arch: ArchConfig, cfg: RunCfg, grp, h: torch.Tensor,
               positions: torch.Tensor, window: int, mask_pos=None,
               prefix=None):
    """One layer's attention over the whole sequence (prefill, the
    training forward), or with ``prefix`` ``(pk, pv)``, the rows before
    these in the cache's head layout, a tail prefill's.  On a mesh each
    rank attends with its own query heads over the kv heads they read
    (tensor parallel, exact) and :func:`_attn_out` sums the output
    projection's partials.  Returns ``(out, k, v)``, ``k``/``v`` in the
    cache's head layout (on a mesh ``cfg.kv_split``'s: the rank's kv
    heads, or all of them)."""
    c = tp.ctx(cfg)
    ap, (q, k, v) = _qkv(arch, grp, h, positions, cfg)
    h0, hl = 0, q.shape[2]

    def own(t):
        return t
    if c is not None:
        H, K = _heads(arch, cfg)
        h0, hl = tp.head_range(H, hl, c)
        if tp.split(K, k.shape[2], c) and cfg.kv_split != "heads":
            k, v = tp.gather_model(k, 2, c), tp.gather_model(v, 2, c)

        def own(t):
            # the kv heads this rank's query heads read, of rows that
            # hold every kv head (the same on every model rank: their
            # gradients are summed where the heads part)
            if t.shape[2] != K:
                return t
            if hl != H:
                t = tp.copy_in(t, c)
            return tp.kv_for_heads(t, h0, hl, H // K)
    ks, vs = own(k), own(v)
    if prefix is None:
        ctx = attn_mod.attention_chunked(
            q, ks.contiguous(), vs.contiguous(), causal=arch.causal,
            window=window, tiles=cfg.flash_tiles, mode=cfg.kernels,
            mask_pos=mask_pos)
    else:
        pk, pv = prefix
        ctx = attn_mod.attention_tail(
            q, torch.cat([own(pk).to(ks.dtype), ks], 1),
            torch.cat([own(pv).to(vs.dtype), vs], 1), causal=arch.causal,
            window=window, tiles=cfg.flash_tiles, mode=cfg.kernels)
    return _attn_out(arch, cfg, c, ap, ctx, h0, hl), k, v


def _attn_params(grp) -> AttnParams:
    a = grp["attn"]
    return AttnParams(a["wq"], a["wk"], a["wv"], a["wo"], a.get("q_norm"),
                      a.get("k_norm"))


def _qkv(arch: ArchConfig, grp, h: torch.Tensor, positions: torch.Tensor,
         cfg: Optional[RunCfg] = None):
    """q/k/v of ``h``.  On a mesh a projection whose columns are split
    within a head (8 ranks over one kv head's 128 columns, as the plan's
    divisibility rule allows) has its product's columns joined whole
    before the heads are formed; one split at whole heads stays the
    rank's heads."""
    ap = _attn_params(grp)
    c = tp.ctx(cfg)
    hd = arch.hd

    def cols(w):
        n = w.shape[-1]
        return n * c.msize if c is not None and n % hd else n

    if c is None:
        return ap, attn_mod.project_qkv(
            h, ap, cols(ap.wq) // hd, cols(ap.wk) // hd, hd, positions,
            arch.rope_theta, arch.mrope_sections, arch.norm_eps)
    H, K = _heads(arch, cfg)
    split = {id(w): tp.split(n * hd, w.shape[-1], c)
             for w, n in ((ap.wq, H), (ap.wk, K), (ap.wv, K))}
    every = all(split.values())
    x = tp.copy_in(h, c) if every else h

    def proj(x, w):
        # a column-split product sums the ranks' input gradients
        y = (x if every or not split[id(w)] else tp.copy_in(x, c)) @ w
        return tp.gather_model(y, -1, c) if w.shape[-1] % hd else y

    # a norm over heads this rank alone holds: its gradient is summed
    q_own = split[id(ap.wq)]
    k_own = split[id(ap.wk)] and ap.wk.shape[-1] % hd == 0
    if ap.q_norm is not None and (q_own or k_own):
        ap = ap._replace(
            q_norm=tp.copy_in(ap.q_norm, c) if q_own else ap.q_norm,
            k_norm=tp.copy_in(ap.k_norm, c) if k_own else ap.k_norm)
    return ap, attn_mod.project_qkv(
        x, ap, cols(ap.wq) // hd, cols(ap.wk) // hd, hd, positions,
        arch.rope_theta, arch.mrope_sections, arch.norm_eps, proj=proj)


def _residual(x: torch.Tensor, outs: List[torch.Tensor]) -> torch.Tensor:
    """Add the layer's mixer outputs to the residual: their mean, as the
    JAX block combines parallel attention and SSM paths (``x + out /
    n_paths``); a single path is added as it is."""
    out = outs[0]
    for o in outs[1:]:
        out = out + o
    return x + (out if len(outs) == 1 else out / len(outs))


def _ffn_fwd(arch: ArchConfig, grp, x: torch.Tensor,
             moe_impl: str = "gshard_einsum", cfg: Optional[RunCfg] = None
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Pre-norm FFN: SiLU-gated, a squared ReLU of one matrix
    (minitron-8b), the encoder's GELU (tanh form, ``jax.nn.gelu``'s
    default) of one matrix in fp32, or, in a layer holding ``moe``, the
    MoE FFN on the
    path ``moe_impl`` (``src/repro/models/lm.py:382-415``).  Returns
    ``(x + FFN(x), aux)``, ``aux`` the router's load-balance loss (fp32)
    of an MoE FFN, ``None`` for a dense one.  On a mesh (``cfg.mesh``)
    the dense FFN's ff dims may be split (:func:`_mlp`) and an MoE FFN
    is :func:`_mesh_moe`."""
    h = rms_norm(x, grp["mlp_norm"], arch.norm_eps)
    c = tp.ctx(cfg)
    if "moe" not in grp:
        return x + _mlp(arch, c, grp["mlp"]["wi"], grp["mlp"]["wo"], h,
                        _gated(arch), arch.d_ff), None
    if c is not None:
        return _mesh_moe(arch, cfg, c, grp, x, h)
    m = grp["moe"]
    y, aux = moe_mod.moe_forward(
        moe_impl, h, MoEParams(m["router"], m["wi"], m["wo"],
                               m.get("shared_wi"), m.get("shared_wo")),
        top_k=arch.experts_per_token,
        capacity_factor=arch.capacity_factor)
    return x + y, aux


def _mlp(arch: ArchConfig, c, wi: torch.Tensor, wo: torch.Tensor,
         h: torch.Tensor, gated: bool, ff: int) -> torch.Tensor:
    """A dense FFN of ``wi`` ``(d, n_in * ff)`` and ``wo`` ``(ff, d)``.
    On a mesh its ff dims may be split over the model ranks: a gated
    ``wi`` is gate||up, so a rank's columns are not a gate and its up,
    and the product's pieces are joined whole before the split; the rank
    keeps its ff piece of the activation for its rows of ``wo``, and
    the ranks' partial products are summed."""
    n_in = 2 if gated else 1
    wi_split = tp.split(n_in * ff, wi.shape[-1], c)
    wo_split = tp.split(ff, wo.shape[0], c)
    if wi_split:
        h = tp.copy_in(h, c)
    z = h @ wi
    if gated:
        if wi_split and wo_split:
            z = tp.regroup_gated(z, c)
        elif wi_split:
            z = tp.gather_model(z, -1, c)
        g, u = z.chunk(2, dim=-1)
        z = F.silu(g.float()).to(h.dtype) * u
        if wo_split and not wi_split:
            z = tp.copy_in(z, c)[..., c.mrank * wo.shape[0]:
                                 (c.mrank + 1) * wo.shape[0]]
    elif arch.family == "encoder":
        z = F.gelu(z.float(), approximate="tanh").to(h.dtype)
    else:
        z = torch.square(F.relu(z.float())).to(h.dtype)
    y = z @ wo
    return tp.reduce_sum(y, c) if wo_split else y


def _mesh_moe(arch: ArchConfig, cfg: RunCfg, c, grp, x: torch.Tensor,
              h: torch.Tensor
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """An MoE FFN on a mesh.  It routes over every expert (the router is
    whole); with the expert stacks split over the model ranks,
    ``gshard_einsum`` and ``dense_einsum`` run the rank's experts and
    sum the fp32 partials, and ``shard_map_alltoall`` is
    :func:`repro_torch.models.moe.moe_shard_map` over the sequence's
    model pieces (whole where they do not divide it).  The shared expert
    runs as a dense FFN (:func:`_mlp`), added in bf16 where
    :func:`repro_torch.models.moe.moe_forward` adds it before rounding."""
    m = grp["moe"]
    E = m["router"].shape[-1]
    p = MoEParams(m["router"], m["wi"], m["wo"])
    kw = dict(top_k=arch.experts_per_token,
              capacity_factor=arch.capacity_factor)
    if cfg.moe_impl == "shard_map_alltoall":
        S = h.shape[1]
        seq = c.msize > 1 and S % c.msize == 0 and S >= c.msize
        hs = tp.copy_in(h, c)[:, c.mrank * (S // c.msize):
                              (c.mrank + 1) * (S // c.msize)] \
            if seq else h
        # the router routes this rank's tokens: its gradient is summed
        p = p._replace(router=tp.copy_in(p.router, c) if seq else p.router)
        y, aux = moe_mod.moe_shard_map(hs, p, mesh=cfg.mesh,
                                       data_axes=cfg.data_axes,
                                       model_axis=cfg.model_axis, **kw)
        if seq:
            y = tp.gather_model(y, 1, c)
    else:
        if cfg.moe_impl not in moe_mod.IMPLS:
            raise ValueError(f"moe_impl={cfg.moe_impl!r} is not one of "
                             f"{moe_mod.IMPLS + ('shard_map_alltoall',)}")
        fn = (moe_mod.moe_dense_einsum if cfg.moe_impl == "dense_einsum"
              else moe_mod.moe_gshard_einsum)
        # the aux loss's statistics over every rank the loss averages over
        kw["stats"] = functools.partial(tp.batch_sum, c=c)
        if tp.split(E, m["wi"].shape[0], c):
            y, aux = fn(h, p, local_experts=c.mrank * m["wi"].shape[0],
                        partial=True, copy_in=functools.partial(
                            tp.copy_in, c=c), **kw)
            y = tp.reduce_sum(y, c).to(h.dtype)
        else:
            y, aux = fn(h, p, **kw)
    if m.get("shared_wi") is not None:
        y = y + _mlp(arch, c, m["shared_wi"], m["shared_wo"], h, True,
                     (arch.moe_d_ff or arch.d_ff) * arch.n_shared_experts)
    return x + y, aux


# =====================================================================
# Training: full-sequence forward and loss
# =====================================================================

REMAT_POLICIES = ("none", "dots", "dots_saveable", "full")
#: the MoE router's load-balance loss's weight in :func:`train_loss`
AUX_LOSS_WEIGHT = 0.01   # src/repro/models/lm.py:72


def _unbind_layers(blocks: Dict[str, Any], n_layers: int
                   ) -> List[Dict[str, Any]]:
    """The stacked block tree as one dict a layer, each leaf split by a
    single ``unbind``."""
    layers: List[Dict[str, Any]] = [{} for _ in range(n_layers)]
    for k, v in blocks.items():
        parts = (_unbind_layers(v, n_layers) if isinstance(v, dict)
                 else v.unbind(0))
        for i in range(n_layers):
            layers[i][k] = parts[i]
    return layers


def _block_fwd(arch: ArchConfig, cfg: RunCfg, grp, x: torch.Tensor,
               positions: torch.Tensor, window: int,
               mask_pos: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One layer of the training forward (``src/repro/models/lm.py
    :353-422``): the mixer, attention over the whole sequence and/or the
    SSD mixer, their mean added to the residual, then the FFN (none in
    the SSM family).  ``mask_pos`` as :func:`_embed_in` returns it.
    Returns ``(x, aux)``, ``aux`` the MoE router's loss or ``None``."""
    h = rms_norm(x, grp["pre_norm"], arch.norm_eps)
    outs = []
    if "attn" in grp:
        outs.append(_attention(arch, cfg, grp, h, positions, window,
                               mask_pos)[0])
    if "ssm" in grp:
        sp = SSMParams(**grp["ssm"])
        outs.append(ssm_mod.ssm_forward(
            h, sp, _ssm_dims(arch, sp, cfg), cfg.ssd_chunk,
            heads_block=cfg.ssd_heads_block, mode=cfg.kernels,
            c=tp.ctx(cfg)))
    x = _residual(x, outs)
    if arch.family == "ssm":
        return x, None
    return _ffn_fwd(arch, grp, x, cfg.moe_impl, cfg)


def _group_fwd(arch: ArchConfig, cfg: RunCfg, grp, x: torch.Tensor,
               positions: torch.Tensor, windows: Tuple[int, ...],
               mask_pos: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One step of the layer loop: a layer, or a super-block's dense
    then MoE layer (``src/repro/models/lm.py:455-466``); their aux
    losses summed.  On a mesh with FSDP leaves the step's slice of each
    is gathered here, inside the remat region, so a recomputed step
    gathers it again and no gathered layer outlives its step."""
    grp = fsdp.gather_layer(grp, cfg.fsdp)
    if "dense" not in grp:
        return _block_fwd(arch, cfg, grp, x, positions, windows[0], mask_pos)
    x, _ = _block_fwd(arch, cfg, grp["dense"], x, positions, windows[0],
                      mask_pos)
    return _block_fwd(arch, cfg, grp["moe"], x, positions, windows[1],
                      mask_pos)


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective checkpointing's rule for ``dots``: keep the outputs of
    the 2-D products (``aten.mm``: the projections and the FFN, which
    the reference's ``dots_with_no_batch_dims_saveable`` keeps) and
    recompute everything else in the backward."""
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, policy: str):
    """``fn`` under the plan's remat policy (``src/repro/models/lm.py
    :425-432``): ``none`` as it is, ``full`` recomputed whole in the
    backward (non-reentrant ``torch.utils.checkpoint``), ``dots`` /
    ``dots_saveable`` with the 2-D products' outputs kept
    (:func:`_dots_policy`)."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat policy {policy!r} not in {REMAT_POLICIES}")
    if policy == "none":
        return fn
    from torch.utils.checkpoint import (
        checkpoint,
        create_selective_checkpoint_contexts,
    )
    kw = {}
    if policy != "full":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)

    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped


def layer_groups(arch: ArchConfig, blocks: Dict[str, Any]
                 ) -> List[Dict[str, Any]]:
    """The training loop's steps: one layer's dict each, or, in a
    super-block tree, ``{"dense": ..., "moe": ...}`` a super-block,
    every stacked leaf split by one ``unbind``."""
    if "dense" not in blocks:
        return _unbind_layers(blocks, arch.n_layers)
    Lg = arch.n_layers // 2
    return [{"dense": d, "moe": m} for d, m in zip(
        _unbind_layers(blocks["dense"], Lg),
        _unbind_layers(blocks["moe"], Lg))]


def forward(arch: ArchConfig, params, batch, cfg: RunCfg
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: ``(hidden (B, S, d), aux_loss)``, the
    aux loss the MoE layers' router losses summed (0 without one), as
    the reference returns it (``src/repro/models/lm.py:441-484``).  Each
    step of :func:`layer_groups` runs under the plan's remat policy, with
    its windows from the per-layer schedule.  On a mesh with FSDP leaves
    the embedding, final norm and head are gathered first, each layer's
    stacks in its step of the loop."""
    return _forward(arch, fsdp.gather_top(params, cfg.fsdp), batch, cfg)


def _forward(arch: ArchConfig, params, batch, cfg: RunCfg
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`forward` of ``params`` whose leaves outside the stacks are
    whole (gathered)."""
    check_supported(arch)
    x, positions, mask_pos = _embed_in(arch, params, batch, cfg)
    windows = _window_schedule(arch)
    groups = layer_groups(arch, params["blocks"])
    g = arch.n_layers // len(groups)
    block = _remat(functools.partial(_group_fwd, arch, cfg), cfg.remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for j, grp in enumerate(groups):
        x, a = block(grp, x, positions, tuple(windows[j * g:(j + 1) * g]),
                     mask_pos)
        if a is not None:
            aux = aux + a
    x = rms_norm(x, params["final_norm"], arch.norm_eps)
    return x, aux


def train_loss(arch: ArchConfig, params, batch, cfg: RunCfg):
    """Scalar loss of one batch (``tokens`` or ``embeds``, optional
    ``positions``, ``targets``, optional ``mask``: the audio frames the
    loss counts), ``ce + AUX_LOSS_WEIGHT * aux``, and its metrics
    ``ce_loss``, ``aux_loss``, ``tokens`` (``src/repro/models/lm.py
    :487-497``): the masked mean of each token's cross-entropy with
    z-loss, in fp32.

    On a mesh the logits of a vocab split over the model ranks stay
    split: the log-sum-exp is taken across the model group
    (:func:`_split_ce`).  With ``cfg.batch_axes`` the loss is this
    rank's share of the mean over every rank's tokens: its summed token
    losses over the whole batch's token count (the ranks' counts
    summed), so the ranks' losses add up to the whole batch's mean and
    their gradients to its gradient; the MoE aux loss's statistics are
    summed over those ranks before their product.  The metrics are then
    the whole batch's (without ``cfg.batch_axes``, this rank's
    tokens')."""
    c = tp.ctx(cfg)
    params = fsdp.gather_top(params, cfg.fsdp)
    x, aux = _forward(arch, params, batch, cfg)
    w = params["embed"].T if arch.tie_embeddings else params["lm_head"]
    if c is not None and tp.split(_vocab(arch, cfg), w.shape[-1], c):
        nll = _split_ce(tp.copy_in(x, c) @ w, batch["targets"],
                        arch.vocab_size, c)
    else:
        nll = token_nll(x @ w, batch["targets"], arch.vocab_size)
    mask = batch.get("mask")
    if mask is not None:
        mask = mask.float()
        total, n = (nll * mask).sum(), mask.sum()
    else:
        total = nll.sum()
        n = torch.tensor(float(nll.numel()), device=nll.device)
    n = tp.batch_sum(n, c).clamp_min(1.0)
    loss = total / n
    metrics = {"ce_loss": tp.batch_sum(loss.detach(), c), "aux_loss": aux,
               "tokens": n}
    return loss + AUX_LOSS_WEIGHT * aux, metrics


def _split_ce(logits: torch.Tensor, targets: torch.Tensor, vocab_size: int,
              c) -> torch.Tensor:
    """Each token's cross-entropy with z-loss over a vocab whose
    columns are split over the model ranks (``logits`` the rank's ``V /
    msize``): the row max all-reduced (MAX, no gradient: the log-sum-exp
    does not depend on it), the exponentials' sums and the target's
    logit summed over the ranks; every rank gets the same values."""
    import torch.distributed as dist
    z = logits.float()
    vl = z.shape[-1]
    lo = c.mrank * vl
    slot = lo + torch.arange(vl, device=z.device)
    z = torch.where(slot < vocab_size, z, -1e30)
    m = z.detach().amax(-1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=c.mgroup)
    s = tp.reduce_sum(torch.exp(z - m[..., None]).sum(-1), c)
    lse = m + torch.log(s)
    loc = targets.long() - lo
    mine = (loc >= 0) & (loc < vl)
    ll = z.gather(-1, loc.clamp(0, vl - 1)[..., None])[..., 0]
    ll = tp.reduce_sum(torch.where(mine, ll, torch.zeros_like(ll)), c)
    return lse - ll + Z_LOSS * lse.square()


# =====================================================================
# Session cache
# =====================================================================

def _kv_geometry(arch: ArchConfig, kv_heads: int) -> Tuple[int, int, int]:
    check_supported(arch)
    return arch.n_layers, kv_heads or arch.n_kv_heads, arch.hd


def init_cache(arch: ArchConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, kv_heads: int = 0, ssm_heads: int = 0,
               device="cuda", conv_dim: int = 0) -> Dict[str, torch.Tensor]:
    """Dense session state: per-slot positions ``pos`` ``(B,)``; with
    attention, ``k``/``v`` stripes ``(L, B, max_len, K, hd)``; with an
    SSM, the fp32 ``ssm`` state ``(L, B, H, P, N)`` and the bf16 ``conv``
    window ``(L, B, k, di + 2GN)`` (``src/repro/models/lm.py:513-525``;
    ``conv_dim``, where given, is its last dim: a rank's piece of the
    channels)."""
    L, K, hd = _kv_geometry(arch, kv_heads)
    cache = {"pos": torch.zeros((batch_size,), dtype=torch.int32,
                                device=device)}
    if arch.has_attention:
        shape = (L, batch_size, max_len, K, hd)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    cache.update(_ssm_cache(arch, batch_size, ssm_heads, device, conv_dim))
    return cache


def _ssm_cache(arch: ArchConfig, batch_size: int, ssm_heads: int,
               device, conv_dim: int = 0) -> Dict[str, torch.Tensor]:
    """The per-slot SSM state and conv window (none without an SSM)."""
    if not arch.has_ssm:
        return {}
    L = arch.n_layers
    H, P = ssm_heads or arch.ssm_heads, arch.ssm_head_dim
    G, N = arch.ssm_n_groups, arch.ssm_state
    return {"ssm": torch.zeros((L, batch_size, H, P, N),
                               dtype=torch.float32, device=device),
            "conv": torch.zeros(
                (L, batch_size, arch.ssm_conv,
                 conv_dim or H * P + 2 * G * N),
                dtype=torch.bfloat16, device=device)}


def init_paged_cache(arch: ArchConfig, batch_size: int, max_len: int,
                     block_len: int, n_blocks: int, dtype=torch.bfloat16,
                     kv_heads: int = 0, ssm_heads: int = 0, device="cuda",
                     conv_dim: int = 0) -> Dict[str, torch.Tensor]:
    """Paged session state: ``k``/``v`` block pools ``(L, n_blocks,
    block_len, K, hd)`` shared by all slots (one block id addresses the
    same block in every layer), ``block_tbl`` ``(B, ceil(max_len /
    block_len))`` int32 with -1 = unassigned, and ``pos`` ``(B,)``.  A
    hybrid's SSM state and conv window stay dense per slot beside the
    pools (O(1) in the sequence), as :func:`init_cache` lays them out
    (``src/repro/models/lm.py:528-565``)."""
    L, K, hd = _kv_geometry(arch, kv_heads)
    nb = -(-max_len // block_len)
    shape = (L, n_blocks, block_len, K, hd)
    cache = {"pos": torch.zeros((batch_size,), dtype=torch.int32,
                                device=device),
             "k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device),
             "block_tbl": torch.full((batch_size, nb), -1,
                                     dtype=torch.int32, device=device)}
    cache.update(_ssm_cache(arch, batch_size, ssm_heads, device, conv_dim))
    return cache


def init_host_pool(arch: ArchConfig, n_host_blocks: int, block_len: int,
                   dtype=torch.bfloat16, kv_heads: int = 0
                   ) -> Dict[str, torch.Tensor]:
    """Host-DRAM spill tier behind the paged pool (``kv_tier_split``):
    ``k``/``v`` CPU tensors ``(L, host_blocks, block_len, K, hd)`` in the
    device pool's dtype, so a spill → promote round trip is bitwise
    (``src/repro/models/lm.py:568-594``).

    Allocated with ``torch.empty`` and not pinned: like the JAX
    package's ``np.zeros``, untouched pages cost no RAM (a full-width
    plan's pool is tens of GB), and rows are read only after a spill
    has written them."""
    L, K, hd = _kv_geometry(arch, kv_heads)
    shape = (L, n_host_blocks, block_len, K, hd)
    return {"k": torch.empty(shape, dtype=dtype, device="cpu"),
            "v": torch.empty(shape, dtype=dtype, device="cpu")}


def init_staging(arch: ArchConfig, n_blocks: int, block_len: int,
                 dtype=torch.bfloat16, kv_heads: int = 0, pin: bool = False
                 ) -> Dict[str, torch.Tensor]:
    """The staging buffer of the resume prefetch: flat ``k``/``v`` CPU
    tensors with room for ``n_blocks`` blocks of every layer (one
    sequence's blocks, the most one resume promotes; 520 MB for
    deepseek-coder-33b at 2048 rows), viewed as ``(L, n, block_len, K,
    hd)`` for ``n <= n_blocks``.  ``pin`` page-locks it (the engine on a
    card), so its host → device copy runs asynchronously on a side
    stream; the host pool itself (:func:`init_host_pool`) stays
    pageable."""
    L, K, hd = _kv_geometry(arch, kv_heads)
    n = L * n_blocks * block_len * K * hd
    return {"k": torch.empty(n, dtype=dtype, pin_memory=pin),
            "v": torch.empty(n, dtype=dtype, pin_memory=pin)}


def gather_blocks(pool: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Whole blocks of a ``(L, n_blocks, block_len, K, hd)`` pool as
    ``(L, len(ids), block_len, K, hd)`` rows, one batched gather."""
    return pool[:, ids]


def scatter_blocks(pool: torch.Tensor, ids: torch.Tensor,
                   rows: torch.Tensor) -> torch.Tensor:
    """Write whole blocks into a pool **in place** (the inverse of
    :func:`gather_blocks`, one batched scatter); ``rows`` may lie on
    another device (a host → device promote).  Returns ``pool``."""
    pool[:, ids] = rows.to(pool.device)
    return pool


def append_kv(cache: torch.Tensor, new: torch.Tensor,
              pos: torch.Tensor) -> torch.Tensor:
    """Per-slot append **in place**: ``cache[b, pos[b]] = new[b, 0]``
    for ``cache`` ``(B, S, K, hd)``, ``new`` ``(B, 1, K, hd)``, ``pos``
    ``(B,)`` (oracle: ``ref.decode_append_ref``).  Returns ``cache``."""
    B = cache.shape[0]
    b = torch.arange(B, device=cache.device)
    cache[b, pos.long().reshape(-1).expand(B)] = new[:, 0].to(cache.dtype)
    return cache


def paged_targets(pos: torch.Tensor, tbl: torch.Tensor, block_len: int,
                  start: int = 0, n_local: Optional[int] = None):
    """``(slot, block, row)`` of each slot's append whose owning table
    entry is assigned; slots whose entry is -1 (freed slots) are masked
    out here, before any write (torch has no scatter ``mode="drop"``).
    On the card the boolean mask costs one host sync.  A sharded pool's
    piece holds the ``n_local`` blocks from the global block ``start``:
    ``block`` is then local, and entries outside it are masked too (only
    the owner writes)."""
    pos = pos.long()
    blk = tbl.long().gather(1, (pos // block_len)[:, None])[:, 0] - start
    b = torch.arange(pos.shape[0], device=pos.device)
    if is_fake(tbl):
        # the dry run's fake table has no values: every slot's row is
        # taken as landing in a block this piece holds
        return b, blk, pos % block_len
    keep = (blk >= 0) if n_local is None else (blk >= 0) & (blk < n_local)
    return b[keep], blk[keep], (pos % block_len)[keep]


def append_kv_paged(pool: torch.Tensor, new: torch.Tensor,
                    pos: torch.Tensor, tbl: torch.Tensor,
                    targets=None, *, start: int = 0) -> torch.Tensor:
    """Paged append **in place**: write ``new[b, 0]`` into slot b's
    owning block, ``pool[tbl[b, pos[b] // bl], pos[b] % bl]``; a slot
    whose owning entry is -1 writes nothing (oracle:
    ``ref.paged_append_ref``).  ``targets`` reuses a
    :func:`paged_targets` result across layers.  ``start``: ``pool`` is
    the piece of a sharded pool from that global block, and only blocks
    in it are written.  Returns ``pool``."""
    b, blk, row = targets if targets is not None else \
        paged_targets(pos, tbl, pool.shape[1], start, pool.shape[0])
    pool[blk, row] = new[b, 0].to(pool.dtype)
    return pool


# =====================================================================
# Serving: prefill + decode
# =====================================================================

def _ssm_prefill(h: torch.Tensor, sp: SSMParams, arch: ArchConfig,
                 cfg: RunCfg):
    """The SSD mixer over a whole prompt, with the final states for the
    cache (``src/repro/models/lm.py:1034-1057``): ``(y, ssm_state,
    conv_tail)``, the tail being the last ``k`` pre-conv rows, left-padded
    with zeros for prompts shorter than ``k``."""
    dims = _ssm_dims(arch, sp, cfg)
    y, final, xbc_raw = ssm_mod.mixer(h, sp, dims, cfg.ssd_chunk,
                                      heads_block=cfg.ssd_heads_block,
                                      mode=cfg.kernels, c=tp.ctx(cfg))
    k = dims.conv_k
    tail = F.pad(xbc_raw, (0, 0, k - 1, 0))[:, -k:, :].to(torch.bfloat16)
    return y, final, tail


def cache_heads(arch: ArchConfig, blocks) -> Dict[str, int]:
    """Cache head counts read off the (possibly padded) parameters of
    layer 0 (every layer has the same), and the conv window's channels
    (``conv_dim``; a rank's piece of them on a mesh)."""
    grp = layer_params(blocks, 0)
    out = {}
    if "attn" in grp:
        out["kv_heads"] = grp["attn"]["wk"].shape[-1] // arch.hd
    if "ssm" in grp:
        out["ssm_heads"] = grp["ssm"]["A_log"].shape[-1]
        out["conv_dim"] = grp["ssm"]["conv_w"].shape[-1]
    return out


def prefill(arch: ArchConfig, params, batch, cfg: RunCfg,
            max_len: int = 0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Process prompts ``batch["tokens"]`` ``(B, S)`` (or ``embeds``,
    with optional ``positions``, as :func:`_embed_in` takes them):
    returns the last-token logits ``(B, V)`` and a dense cache with
    ``pos = S``:
    with attention, ``max_len`` rows (default ``S``) of every layer's
    post-RoPE K/V for rows ``0..S-1`` (zeros past them); with an SSM,
    every layer's final state and conv tail.  On a mesh every rank
    prefills the whole batch with its pieces of the weights, and the
    cache holds the kv heads in the layout ``cfg.kv_split`` names."""
    x, positions, mask_pos = _embed_in(arch, params, batch, cfg)
    B, S = x.shape[:2]
    max_len = max_len or S
    blocks = params["blocks"]
    cache = init_cache(arch, B, max_len, **_cache_heads_on(arch, cfg, blocks),
                       device=x.device)
    windows = _window_schedule(arch)
    for i in range(arch.n_layers):
        grp = layer_params(blocks, i)
        h = rms_norm(x, grp["pre_norm"], arch.norm_eps)
        outs = []
        if arch.has_attention:
            out, k, v = _attention(arch, cfg, grp, h, positions, windows[i],
                                   mask_pos)
            outs.append(out)
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
        if arch.has_ssm:
            y, cache["ssm"][i], cache["conv"][i] = _ssm_prefill(
                h, SSMParams(**grp["ssm"]), arch, cfg)
            outs.append(y)
        x = _residual(x, outs)
        if arch.family != "ssm":
            x, _ = _ffn_fwd(arch, grp, x, cfg.moe_impl, cfg)
    x = rms_norm(x[:, -1:], params["final_norm"], arch.norm_eps)
    cache["pos"].fill_(S)
    return _logits(arch, params, x, cfg)[:, 0], cache


def _cache_heads_on(arch: ArchConfig, cfg: RunCfg, blocks) -> Dict[str, int]:
    """:func:`cache_heads`, with all kv heads where a mesh's cache holds
    them whole (``cfg.kv_split`` other than ``"heads"``)."""
    heads = cache_heads(arch, blocks)
    if cfg.mesh is not None and cfg.kv_split != "heads" \
            and "kv_heads" in heads:
        heads["kv_heads"] = _heads(arch, cfg)[1]
    return heads


def prefill_tail(arch: ArchConfig, params, batch, cfg: RunCfg,
                 k_pool: torch.Tensor, v_pool: torch.Tensor,
                 prefix_blocks: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill only the unmatched *tail* of prompts whose leading ``M``
    rows sit in resident pool blocks (cross-request prefix reuse;
    ``src/repro/models/lm.py:882-968``).

    ``batch["tokens"]`` is ``(B, T)`` tail tokens; ``prefix_blocks``
    ``(B, nbm)`` names each prompt's matched blocks in the
    ``(L, N, bl, K, hd)`` pools (``M = nbm * bl`` rows, post-RoPE at
    positions ``0..M-1``, as the donor's prefill wrote them).  The tail
    is embedded at positions ``M..M+T-1`` (in all three streams under
    M-RoPE, ``src/repro/models/lm.py:914-916``); each layer gathers its own
    prefix rows from the pool (one layer's share, never the whole
    ``(L, B, M, K, hd)`` stack), appends the tail's K/V and attends
    through :func:`repro_torch.models.attention.attention_tail` — the
    flash kernel at a query offset on the card.

    Returns ``(last-token logits (B, V), tail_k, tail_v)``, the tail
    K/V ``(L, B, T, K, hd)`` for the caller to scatter into fresh blocks.
    Raises for an arch with an SSM: its state at position ``M`` depends
    on every earlier token, so the prefix compute cannot be skipped."""
    ids = prefix_blocks.long().to(k_pool.device)
    B, nbm = ids.shape
    M, K = nbm * k_pool.shape[2], k_pool.shape[3]

    def rows(i):
        return (k_pool[i][ids].reshape(B, M, K, arch.hd),
                v_pool[i][ids].reshape(B, M, K, arch.hd))

    return _prefill_tail(arch, params, batch, cfg, M, rows)


def prefill_tail_rows(arch: ArchConfig, params, batch, cfg: RunCfg,
                      prefix_k: torch.Tensor, prefix_v: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`prefill_tail` with the prefix rows given as they are,
    ``prefix_k`` / ``prefix_v`` ``(L, B, M, K, hd)`` (the reference's
    ``prefill_tail`` signature, ``src/repro/models/lm.py:882``), not
    gathered from a pool."""
    return _prefill_tail(arch, params, batch, cfg, prefix_k.shape[2],
                         lambda i: (prefix_k[i], prefix_v[i]))


def _prefill_tail(arch: ArchConfig, params, batch, cfg: RunCfg, M: int,
                  prefix_rows) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The tail prefill over ``M`` prefix rows, layer ``i``'s ``(B, M, K,
    hd)`` k and v from ``prefix_rows(i)``."""
    if arch.has_ssm:
        raise ValueError(
            f"prefill_tail cannot skip prefix compute for {arch.name}: "
            "SSM state at the split point depends on the whole prefix")
    x, _, _ = _embed_in(arch, params, batch, cfg)
    B, T = x.shape[:2]
    positions = (M + torch.arange(T, device=x.device)).expand(B, T)
    if arch.mrope_sections is not None:
        positions = positions.expand(3, B, T)
    blocks = params["blocks"]
    windows = _window_schedule(arch)
    K = _cache_heads_on(arch, cfg, blocks)["kv_heads"]
    tail_k = torch.empty((arch.n_layers, B, T, K, arch.hd), dtype=x.dtype,
                         device=x.device)
    tail_v = torch.empty_like(tail_k)
    for i in range(arch.n_layers):
        grp = layer_params(blocks, i)
        h = rms_norm(x, grp["pre_norm"], arch.norm_eps)
        out, k, v = _attention(arch, cfg, grp, h, positions, windows[i],
                               prefix=prefix_rows(i))
        x = x + out
        x, _ = _ffn_fwd(arch, grp, x, cfg.moe_impl, cfg)
        tail_k[i] = k
        tail_v[i] = v
    x = rms_norm(x[:, -1:], params["final_norm"], arch.norm_eps)
    return _logits(arch, params, x, cfg)[:, 0], tail_k, tail_v


def prefill_chunked(arch: ArchConfig, params, tokens, chunk: int,
                    cfg: RunCfg, kv_heads: int = 0,
                    prefix_k: Optional[torch.Tensor] = None,
                    prefix_v: Optional[torch.Tensor] = None,
                    on_chunk=None
                    ) -> Tuple[torch.Tensor, List[torch.Tensor],
                               List[torch.Tensor]]:
    """Block-native chunked prefill of ONE prompt
    (``src/repro/models/lm.py:970``): no dense ``(B, plen)`` prefill.

    ``tokens`` ``(T,)`` is the feed past any prefix already in hand;
    ``prefix_k`` / ``prefix_v`` ``(L, M, K, hd)`` are the rows of its
    first ``M`` tokens (``None``: a fresh prompt).  The tail runs in
    ``chunk``-sized slices, each a :func:`prefill_tail_rows` call over
    the rows so far (on the card, the flash kernel at a query offset),
    so every slice comes out pool-block-shaped.  ``on_chunk(block_idx,
    k_c, v_c)`` fires after each slice with its ``(L, t, K, hd)`` rows
    (``block_idx`` counts from the start of the feed, prefix included):
    the disaggregated-prefill worker streams them home between
    heartbeats.

    Returns ``(last-token logits (V,), ks, vs)``, the per-chunk row
    lists.  Refused as the reference refuses: an arch with an SSM (its
    state is sequential across the whole prompt), ``chunk < 1``, an
    empty tail, a prefix that is not a whole number of chunks."""
    if arch.has_ssm:
        raise ValueError(
            f"prefill_chunked needs pure-attention KV for {arch.name}: "
            "SSM state is sequential across the whole prompt")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    device = params["embed"].device
    tokens = torch.as_tensor(tokens).to(device=device, dtype=torch.int32)
    (T,) = tokens.shape
    if T < 1:
        raise ValueError("prefill_chunked needs at least one tail token")
    L = arch.n_layers
    K = kv_heads or cache_heads(arch, params["blocks"])["kv_heads"]
    M = 0 if prefix_k is None else prefix_k.shape[1]
    if M % chunk:
        raise ValueError(f"prefix length {M} not block-aligned to {chunk}")
    # the rows so far, prefix then each slice's, in one buffer: a slice
    # attends over a view of its first rows (no re-concatenation a chunk)
    bufs = []
    for pre in (prefix_k, prefix_v):
        buf = torch.empty((L, 1, M + T, K, arch.hd), dtype=torch.bfloat16,
                          device=device)
        if M:
            buf[:, 0, :M] = pre.to(device=device, dtype=torch.bfloat16)
        bufs.append(buf)
    kbuf, vbuf = bufs
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    logits = None
    for i in range(0, T, chunk):
        tok = tokens[None, i:i + chunk]                     # (1, t)
        n = M + i
        logits, tk, tv = prefill_tail_rows(
            arch, params, {"tokens": tok}, cfg, kbuf[:, :, :n],
            vbuf[:, :, :n])
        t = tk.shape[2]
        kbuf[:, :, n:n + t] = tk
        vbuf[:, :, n:n + t] = tv
        ks.append(kbuf[:, 0, n:n + t])                      # (L, t, K, hd)
        vs.append(vbuf[:, 0, n:n + t])
        if on_chunk is not None:
            on_chunk(n // chunk, ks[-1], vs[-1])
    return logits[0], ks, vs


def decode_step(arch: ArchConfig, params, cache: Dict[str, torch.Tensor],
                batch, cfg: RunCfg
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode for every slot: appends each slot's K/V at its
    own ``cache["pos"]`` (in place), attends over ``pos + 1`` rows, and
    sets ``cache["pos"] = pos + 1``.  A ``block_tbl`` in the cache
    selects paged residency.  A mamba2 model instead steps each layer's
    SSM state and conv window (in place); freed slots step too, on stale
    state, as in the JAX engine.  Rotary positions: the batch's
    ``positions`` where it has them, else each slot's ``pos`` (in all
    three streams under M-RoPE, ``src/repro/models/lm.py:655-658``).
    Returns ``(logits (B, V), cache)``.

    On a mesh (``cfg.mesh``) each rank decodes the batch rows its cache
    piece holds (all of them unless the batch is split over the data
    axis) and the logits are gathered whole on every rank.  Attention
    follows ``cfg.kv_split``: ``"heads"``, the rank's own heads through
    the decode kernels; ``"rows"``, the sharded flash decode
    (:func:`repro_torch.dist.flash_decode.flash_decode`, paged
    :func:`~repro_torch.dist.flash_decode.flash_decode_paged`: every
    query head over the rank's rows, the partials combined over the
    model ranks), as the reference's ``shard_map_flash`` branch
    (``src/repro/models/lm.py:677-690``); ``"none"``, every head over
    the whole cache.  ``cache["pos"]`` and ``block_tbl`` stay whole."""
    c = tp.ctx(cfg)
    rows = _mesh_rows(cfg, c, cache) if c is not None else None
    if rows is not None:
        batch = {k: v[rows[0]:rows[1]] for k, v in batch.items()}
    x, positions, _ = _embed_in(arch, params, batch, cfg)   # (B, 1, d)
    B = x.shape[0]
    pos_all = torch.as_tensor(cache["pos"], dtype=torch.int32,
                              device=x.device).reshape(-1)
    pos = pos_all if rows is None else pos_all[rows[0]:rows[1]]
    pos = pos.expand(B).contiguous()
    if "positions" not in batch:
        positions = pos[:, None]
        if arch.mrope_sections is not None:
            positions = positions.expand(3, B, 1)
    cache_len = pos + 1
    tbl = cache.get("block_tbl")
    if tbl is not None and rows is not None:
        tbl = tbl[rows[0]:rows[1]]
    targets = (paged_targets(pos, tbl, cache["k"].shape[2])
               if tbl is not None and cfg.kv_split != "rows" else None)
    blocks = params["blocks"]
    windows = _window_schedule(arch)
    for i in range(arch.n_layers):
        grp = layer_params(blocks, i)
        h = rms_norm(x, grp["pre_norm"], arch.norm_eps)
        outs = []
        if arch.has_attention:
            outs.append(_decode_attn(arch, cfg, c, grp, h, positions,
                                     cache["k"][i], cache["v"][i], tbl, pos,
                                     cache_len, windows[i], targets))
        if arch.has_ssm:
            outs.append(_ssm_decode(arch, cfg, c, grp, h, cache, i))
        x = _residual(x, outs)
        if arch.family != "ssm":
            x, _ = _ffn_fwd(arch, grp, x, cfg.moe_impl, cfg)
    x = rms_norm(x, params["final_norm"], arch.norm_eps)
    logits = _logits(arch, params, x, cfg)[:, 0]
    if rows is not None:
        if rows[1] - rows[0] < pos_all.shape[0]:
            logits = tp.gather_data(logits, 0, c)
        cache["pos"] = pos_all + 1
    else:
        cache["pos"] = cache_len
    return logits, cache


def _ssm_decode(arch: ArchConfig, cfg: RunCfg, c, grp, h: torch.Tensor,
                cache: Dict[str, torch.Tensor], i: int) -> torch.Tensor:
    """Layer ``i``'s SSM recurrence, its state and conv window stepped
    in place (on a mesh the rank's pieces: its heads, its conv channels,
    the slots of the rows it decodes)."""
    sp = SSMParams(**grp["ssm"])
    y, sc, cc = ssm_mod.ssm_decode_step(h, sp, _ssm_dims(arch, sp, cfg),
                                        cache["ssm"][i], cache["conv"][i],
                                        c=c)
    cache["ssm"][i].copy_(sc)
    cache["conv"][i].copy_(cc)
    return y


def _mesh_rows(cfg: RunCfg, c, cache) -> Tuple[int, int]:
    """The batch rows ``[r0, r1)`` this rank decodes: its data shard's
    where the cache piece splits the batch (a dense cache's batch dim,
    a paged pool split ``"2d"``), else all of them."""
    from repro_torch.dist.flash_decode import pool_sharding_kind
    B = cache["pos"].reshape(-1).shape[0]
    if "block_tbl" in cache:
        split = cfg.kv_split == "rows" and pool_sharding_kind(
            cfg.mesh, cfg.kv_whole[1], cfg.kv_whole[0], cfg.data_axes,
            cfg.model_axis) == "2d"
        bl = B // c.dsize if split else B
    else:
        bl = cache["k" if "k" in cache else "ssm"].shape[1]
    if bl == B:
        return 0, B
    return c.drank * bl, (c.drank + 1) * bl


def _decode_cols(cfg: RunCfg, c, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                 tbl: Optional[torch.Tensor], pos: torch.Tensor,
                 cache_len: torch.Tensor, window: int, targets,
                 hd: int) -> torch.Tensor:
    """Decode attention over a cache split on head_dim (``cfg.kv_split
    == "head_dim"``): every head's q, k and v whole on every rank, the
    rank's columns ``[mrank * DS, (mrank + 1) * DS)`` of the new k/v
    appended to its cache piece, then K9 through
    :func:`repro_torch.models.attention.attention_decode_split` (the
    compact ``(B, H, Wc)`` scores, each slot's live rows only, summed
    over the model ranks between its passes), and the context's columns
    gathered whole: ``(B, 1, H, hd)``."""
    from repro_torch.dist.collectives import sum_over_
    n = kc.shape[-1]
    c0 = c.mrank * n
    kn, vn = (t[..., c0:c0 + n].contiguous() for t in (k, v))
    if tbl is not None:
        append_kv_paged(kc, kn, pos, tbl, targets)
        append_kv_paged(vc, vn, pos, tbl, targets)
    else:
        append_kv(kc, kn, pos)
        append_kv(vc, vn, pos)
    ctx = attn_mod.attention_decode_split(
        q[..., c0:c0 + n], kc, vc, tbl, cache_len=cache_len, head_dim=hd,
        window=window, mode=cfg.kernels,
        reduce=lambda s: sum_over_(s, [(c.mgroup, c.msize)]))
    return tp.gather_model(ctx, -1, c)


def _decode_attn(arch: ArchConfig, cfg: RunCfg, c, grp, h: torch.Tensor,
                 positions: torch.Tensor, kc: torch.Tensor,
                 vc: torch.Tensor, tbl: Optional[torch.Tensor],
                 pos: torch.Tensor, cache_len: torch.Tensor, window: int,
                 targets=None) -> torch.Tensor:
    """One layer's decode attention: each slot's new row appended at its
    ``pos`` (in place), then ``cache_len = pos + 1`` rows attended through the dense
    or paged decode kernel.  On a mesh whose cache holds every kv head
    (``cfg.kv_split`` ``"rows"``, ``"head_dim"`` or ``"none"``) the
    rank's query and kv heads are gathered whole and every head attends,
    through the sharded flash decode over the rank's rows under
    ``"rows"``, through K9 over the rank's columns under ``"head_dim"``
    (:func:`_decode_cols`); the rank keeps its heads for its rows of
    ``wo`` (:func:`_attn_out`)."""
    ap, (q, k, v) = _qkv(arch, grp, h, positions, cfg)
    h0, hl = 0, q.shape[2]
    if c is not None and cfg.kv_split != "heads":
        H, K = _heads(arch, cfg)
        h0, hl = tp.head_range(H, hl, c)
        if hl < H:
            q = tp.gather_model(q, 2, c)
        if tp.split(K, k.shape[2], c):
            k, v = tp.gather_model(k, 2, c), tp.gather_model(v, 2, c)
    if cfg.kv_split == "head_dim":
        ctx = _decode_cols(cfg, c, q, k, v, kc, vc, tbl, pos, cache_len,
                           window, targets, arch.hd)
    elif cfg.kv_split == "rows":
        from repro_torch.dist import flash_decode as fd
        kw = dict(mesh=cfg.mesh, data_axes=cfg.data_axes,
                  model_axis=cfg.model_axis, combine=cfg.combine_topology,
                  batch=cfg.kv_whole[0], block_kv=cfg.decode_block_kv)
        if tbl is not None:
            ctx, _, _ = fd.flash_decode_paged(q, k, v, kc, vc, tbl, pos,
                                              window,
                                              n_blocks=cfg.kv_whole[1], **kw)
        else:
            ctx, _, _ = fd.flash_decode(q, k, v, kc, vc, pos, window,
                                        seq_len=cfg.kv_whole[1], **kw)
    elif tbl is not None:
        append_kv_paged(kc, k, pos, tbl, targets)
        append_kv_paged(vc, v, pos, tbl, targets)
        ctx = attn_mod.attention_decode_paged(
            q, kc, vc, tbl, cache_len=cache_len, window=window,
            block_kv=cfg.decode_block_kv, mode=cfg.kernels)
    else:
        append_kv(kc, k, pos)
        append_kv(vc, v, pos)
        ctx = attn_mod.attention_decode(
            q, kc, vc, cache_len=cache_len, window=window,
            block_kv=cfg.decode_block_kv, mode=cfg.kernels)
    return _attn_out(arch, cfg, c, ap,
                     ctx.reshape(q.shape[0], 1, -1, arch.hd), h0, hl)
