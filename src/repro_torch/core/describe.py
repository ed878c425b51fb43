"""Build the Memory IR for an (architecture × shape) workload.

This is the flow's *frontend*: it walks the model family and emits one
annotated :class:`TensorDecl` per logical tensor class plus coarse
:class:`OpDecl` entries with FLOP/byte estimates.  In the paper this
information arrives via source-level annotations; here the annotation
helpers in :mod:`repro_torch.core.annotations` encode the same knowledge.

Logical axis vocabulary (consumed by the data-organization pass):
  params:       layers, embed, heads, kv_heads, head_dim, ff, vocab,
                experts, ssm_inner
  activations:  batch, seq, act_embed, act_heads, act_ff, act_experts
  caches:       batch, seq_kv, kv_heads, head_dim / ssm_heads
"""

from __future__ import annotations

from typing import Tuple

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core import annotations as A
from repro_torch.core.ir import OpDecl, OpKind, ProgramIR


def describe_program(arch: ArchConfig, shape: ShapeConfig,
                     training: bool | None = None) -> ProgramIR:
    training = shape.kind == "train" if training is None else training
    ir = ProgramIR(name=f"{arch.name}@{shape.name}")
    L, d, V = arch.n_layers, arch.d_model, arch.vocab_size
    B, S = shape.global_batch, shape.seq_len
    hd = arch.hd
    H, K = arch.n_heads, arch.n_kv_heads
    T = shape.tokens                      # tokens processed per step
    Sctx = S if shape.kind != "train" else S  # context length

    # ---------------- parameters ----------------------------------------
    ir.declare(A.weight("embed", (V, d), ("vocab", "embed")))
    if not arch.tie_embeddings:
        ir.declare(A.weight("lm_head", (d, V), ("embed", "vocab")))

    if arch.has_attention:
        ir.declare(A.weight("attn.wq", (L, d, H * hd), ("layers", "embed", "heads")))
        ir.declare(A.weight("attn.wk", (L, d, K * hd), ("layers", "embed", "kv_heads")))
        ir.declare(A.weight("attn.wv", (L, d, K * hd), ("layers", "embed", "kv_heads")))
        ir.declare(A.weight("attn.wo", (L, H * hd, d), ("layers", "heads", "embed")))

    if arch.has_ssm:
        di = arch.d_inner
        g, st = arch.ssm_n_groups, arch.ssm_state
        nh = arch.ssm_heads
        in_dim = 2 * di + 2 * g * st + nh
        ir.declare(A.weight("ssm.in_proj", (L, d, in_dim), ("layers", "embed", "ssm_inner")))
        ir.declare(A.weight("ssm.conv", (L, arch.ssm_conv, di + 2 * g * st),
                            ("layers", None, "ssm_inner")))
        ir.declare(A.weight("ssm.out_proj", (L, di, d), ("layers", "ssm_inner", "embed")))
        ir.declare(A.weight("ssm.A", (L, nh), ("layers", None), dtype="float32"))

    if arch.is_moe:
        Lm = L // arch.moe_interleave
        Ld = L - Lm
        ff = arch.moe_d_ff or arch.d_ff
        E = arch.n_experts
        ir.declare(A.weight("moe.wi", (Lm, E, d, 2 * ff),
                            ("layers", "experts", "embed", "ff"), expert=True))
        ir.declare(A.weight("moe.wo", (Lm, E, ff, d),
                            ("layers", "experts", "ff", "embed"), expert=True))
        ir.declare(A.weight("moe.router", (Lm, d, E), ("layers", "embed", "act_experts")))
        if arch.n_shared_experts:
            ir.declare(A.weight("moe.shared_wi", (Lm, d, 2 * ff * arch.n_shared_experts),
                                ("layers", "embed", "ff")))
            ir.declare(A.weight("moe.shared_wo", (Lm, ff * arch.n_shared_experts, d),
                                ("layers", "ff", "embed")))
        if Ld:
            ir.declare(A.weight("mlp.wi", (Ld, d, 2 * arch.d_ff), ("layers", "embed", "ff")))
            ir.declare(A.weight("mlp.wo", (Ld, arch.d_ff, d), ("layers", "ff", "embed")))
    elif arch.d_ff:
        gated = arch.gated_mlp and arch.family != "encoder"
        n_in = 2 if gated else 1                       # SwiGLU: gate+up fused
        ir.declare(A.weight("mlp.wi", (L, d, n_in * arch.d_ff), ("layers", "embed", "ff")))
        ir.declare(A.weight("mlp.wo", (L, arch.d_ff, d), ("layers", "ff", "embed")))

    ir.declare(A.weight("norms", (L, 2, d), ("layers", None, "embed"), dtype="float32"))

    # ---------------- step inputs / activations -------------------------
    if shape.kind == "decode":
        ir.declare(A.model_input("tokens", (B, 1), ("batch", None)))
        if arch.has_attention:
            # cache layout is decided by the layout pass; declared seq-major.
            # names match the runtime cache pytree (dist.sharding.cache_axes)
            for nm in ("cache.k", "cache.v"):
                ir.declare(A.kv_cache(nm, (L, B, S, K, hd),
                                      ("layers", "batch", "seq_kv",
                                       "kv_heads", "head_dim")))
        if arch.has_ssm:
            ir.declare(A.ssm_state("cache.ssm",
                                   (L, B, arch.ssm_heads, arch.ssm_head_dim, arch.ssm_state),
                                   ("layers", "batch", "ssm_heads", None, None)))
            ir.declare(A.ssm_state("cache.conv",
                                   (L, B, arch.ssm_conv,
                                    arch.d_inner + 2 * arch.ssm_n_groups * arch.ssm_state),
                                   ("layers", "batch", None, "ssm_inner")))
        act_T = B
    else:
        ir.declare(A.model_input("tokens", (B, S), ("batch", "seq")))
        if training:
            ir.declare(A.model_input("targets", (B, S), ("batch", "seq")))
        act_T = B * S

    ir.declare(A.activation("residual", (act_T, d), (None, "act_embed")))
    if arch.has_attention:
        ir.declare(A.activation("qkv", (act_T, (H + 2 * K) * hd), (None, "act_heads")))
    if arch.d_ff:
        ir.declare(A.activation("ffn_hidden", (act_T, arch.d_ff), (None, "act_ff")))

    # ---------------- optimizer state (training only) -------------------
    if training:
        # padded so any mesh factorization divides (the real opt state is a
        # per-leaf pytree; this flat decl only feeds the byte cost model)
        n_params = -(-arch.param_count() // 65536) * 65536
        ir.declare(A.opt_state("adam_m", (n_params,), ("flat_params",)))
        ir.declare(A.opt_state("adam_v", (n_params,), ("flat_params",)))
        ir.declare(A.opt_state("master", (n_params,), ("flat_params",)))
        ir.declare(A.gradient("grads", (n_params,), ("flat_params",)))

    # ---------------- coarse ops (FLOP model) ---------------------------
    def op(name, kind, flops, nbytes, operands=("residual",), results=("residual",), **dims):
        ir.add_op(OpDecl(name, kind, tuple(operands), tuple(results),
                         float(flops), float(nbytes), dims))

    tokens_name = "tokens"
    op("embed_lookup", OpKind.EMBED, 0, act_T * d * 2, operands=(tokens_name, "embed"))

    if arch.has_attention:
        proj_flops = 2 * act_T * d * (H + 2 * K) * hd * L
        op("attn.qkv_proj", OpKind.MATMUL, proj_flops,
           (d * (H + 2 * K) * hd * 2) * L, operands=("residual", "attn.wq"))
        # attention context per query token
        if shape.kind == "decode":
            ctx = S if arch.window == 0 else min(S, arch.window)
            # hymba: global layers see the whole context
            n_glob = _n_global_layers(arch)
            att_flops = 4 * B * hd * H * (ctx * (L - n_glob) + S * n_glob)
            kind = OpKind.ATTENTION_DECODE
            operands = ("qkv", "cache.k")
        else:
            ctx = S if arch.window == 0 else min(S, arch.window)
            n_glob = _n_global_layers(arch)
            per_layer_full = 4 * B * S * S * hd * H * 0.5  # causal half
            per_layer_win = 4 * B * S * ctx * hd * H * (0.5 if ctx >= S else 1.0)
            att_flops = per_layer_full * n_glob + per_layer_win * (L - n_glob)
            if not arch.causal:
                att_flops = 4 * B * S * S * hd * H * L
            kind = OpKind.ATTENTION
            operands = ("qkv",)
        op("attn.core", kind, att_flops, act_T * H * hd * 2 * L * 2,
           operands=operands, heads=H, head_dim=hd, ctx=ctx)
        op("attn.out_proj", OpKind.MATMUL, 2 * act_T * H * hd * d * L,
           H * hd * d * 2 * L)

    if arch.has_ssm:
        di, st = arch.d_inner, arch.ssm_state
        in_dim = 2 * di + 2 * arch.ssm_n_groups * st + arch.ssm_heads
        op("ssm.in_proj", OpKind.MATMUL, 2 * act_T * d * in_dim * L,
           d * in_dim * 2 * L, operands=("residual", "ssm.in_proj"))
        chunk = 256
        ssd_flops = (4 * act_T * di * st + 2 * act_T * min(chunk, Sctx) * di) * L
        op("ssm.ssd", OpKind.SSD_SCAN, ssd_flops, act_T * di * 2 * L * 2,
           state=st, chunk=chunk)
        op("ssm.out_proj", OpKind.MATMUL, 2 * act_T * di * d * L, di * d * 2 * L)

    if arch.is_moe:
        Lm = L // arch.moe_interleave
        Ld = L - Lm
        ff = arch.moe_d_ff or arch.d_ff
        topk = arch.experts_per_token
        op("moe.router", OpKind.MATMUL, 2 * act_T * d * arch.n_experts * Lm,
           d * arch.n_experts * 4 * Lm, operands=("residual", "moe.router"),
           results=("residual",))
        moe_flops = 2 * act_T * d * ff * 3 * topk * Lm
        moe_flops += 2 * act_T * d * ff * 3 * arch.n_shared_experts * Lm
        op("moe.experts", OpKind.MOE_DISPATCH, moe_flops,
           arch.n_experts * 3 * d * ff * 2 * Lm,
           operands=("residual", "moe.wi", "moe.wo"),
           experts=arch.n_experts, topk=topk, capacity_factor=arch.capacity_factor)
        if Ld:
            op("mlp.dense", OpKind.MATMUL, 2 * act_T * d * arch.d_ff * 3 * Ld,
               3 * d * arch.d_ff * 2 * Ld, operands=("residual", "mlp.wi"))
    elif arch.d_ff:
        mult = 3 if (arch.gated_mlp and arch.family != "encoder") else 2
        op("mlp", OpKind.MATMUL, 2 * act_T * d * arch.d_ff * mult * L,
           mult * d * arch.d_ff * 2 * L, operands=("residual", "mlp.wi"))

    op("norms", OpKind.NORM, act_T * d * 8 * L, act_T * d * 2 * 2 * L)
    if training or shape.kind == "decode":
        op("lm_head", OpKind.MATMUL, 2 * act_T * d * V, d * V * 2,
           operands=("residual", "embed" if arch.tie_embeddings else "lm_head"))

    ir.meta.update(
        arch=arch.name, shape=shape.name, training=training,
        tokens_per_step=T, model_params=arch.param_count(),
        active_params=arch.active_param_count(),
    )
    ir.validate()
    return ir


def _n_global_layers(arch: ArchConfig) -> int:
    if arch.window == 0:
        return arch.n_layers if arch.has_attention else 0
    if arch.global_every <= 0:
        return 0
    # hymba convention: first, every global_every-th, and last layer
    idxs = set(range(0, arch.n_layers, arch.global_every)) | {arch.n_layers - 1}
    return len(idxs)


def global_layer_mask(arch: ArchConfig) -> Tuple[bool, ...]:
    """Per-layer: does this layer use global (full) attention?"""
    if not arch.has_attention:
        return tuple()
    if arch.window == 0:
        return tuple(True for _ in range(arch.n_layers))
    idxs = set(range(0, arch.n_layers, arch.global_every)) | {arch.n_layers - 1} \
        if arch.global_every > 0 else set()
    return tuple(i in idxs for i in range(arch.n_layers))
