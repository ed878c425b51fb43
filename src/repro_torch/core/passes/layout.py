"""Layout pass (paper §4, second level).

Paper: "reorganizes the computation to better exploit local memories."

TPU re-targeting: physical layout choices that make the MXU/VPU (and the
collectives) see well-shaped data:

* pad matmul-visible dims (vocab above all) to MXU multiples × TP width;
* fuse the QKV projection into one matmul when head counts allow it;
* pick the KV-cache layout (seq-major for append-heavy decode);
* assign compute dtypes (bf16 streams, fp32 softmax/router/logits).

These are the paper's "special functions" (e.g. transposition) folded
into the plan instead of bolted onto a datapath.
"""

from __future__ import annotations

import math

from repro_torch.core.ir import Role
from repro_torch.core.passes import Pass, PassContext


def pad_up(n: int, q: int) -> int:
    return ((n + q - 1) // q) * q


class LayoutPass(Pass):
    name = "layout"

    def run(self, ctx: PassContext) -> None:
        plan, arch, mesh = ctx.plan, ctx.arch, ctx.mesh
        tgt = ctx.target
        tp = mesh.axis_size("model")

        # ---- vocab padding (embed table + lm head + logits) -------------
        quantum = tgt.mxu_dim * tp if arch.vocab_size >= tgt.mxu_dim * tp \
            else tgt.vpu_lanes[1]
        vpad = pad_up(arch.vocab_size, quantum)
        plan.estimates["vocab_padded"] = float(vpad)
        if vpad != arch.vocab_size:
            for name in ("embed", "lm_head"):
                if name in plan.placements:
                    p = plan.placements[name]
                    p.layout["vocab_padded"] = vpad
                    p.decided_by.append(self.name)
            self.record(ctx, "vocab", f"{arch.vocab_size} -> {vpad}",
                        f"pad to mxu({tgt.mxu_dim}) x TP({tp}) so the logits "
                        "matmul tiles cleanly and shards evenly")

        # ---- QKV projection layout ---------------------------------------
        tp_heads = plan.axis_rules.get("heads") == "model"
        if arch.has_attention and not tp_heads:
            # fsdp_dp strategy: heads unsharded -> no padding, no constraint
            plan.estimates["heads_padded"] = float(arch.n_heads)
            plan.estimates["kv_heads_padded"] = float(arch.n_kv_heads)
            plan.estimates["kv_heads_sharded"] = 1.0
            self.record(ctx, "heads", "unsharded (fsdp_dp)",
                        "batch carries the model axis; head dims stay whole")
        if arch.has_attention and tp_heads:
            # split projections: fused-QKV section boundaries almost never
            # align with TP shard boundaries -> GSPMD collective-permute halos
            plan.estimates["fuse_qkv"] = 0.0
            self.record(ctx, "qkv", "split",
                        "fused QKV split points land mid-shard under "
                        f"TP={tp}; split projections shard cleanly")

            # pad head counts to make the (tokens, H, hd) reshape
            # GSPMD-expressible: Hp % TP == 0 (sharding) AND Hp % Kp == 0
            # (GQA grouping).  Joint search over (Hp, Kp) minimizes the
            # padding waste — e.g. hymba 25q/5kv -> 32q/8kv (1.28x) instead
            # of 80q/5kv (3.2x).
            H, K = arch.n_heads, arch.n_kv_heads
            best = None
            for Kp in range(K, 4 * K + 1):
                m = math.lcm(tp, Kp) if H % tp else Kp
                Hp = pad_up(H, m)
                if Hp % Kp == 0 and (best is None or Hp < best[0]
                                     or (Hp == best[0] and Kp < best[1])):
                    best = (Hp, Kp)
            Hp, Kp = best
            plan.estimates["heads_padded"] = float(Hp)
            plan.estimates["kv_heads_padded"] = float(Kp)
            if (Hp, Kp) != (H, K):
                self.record(ctx, "heads", f"q {H}->{Hp}, kv {K}->{Kp}",
                            f"head counts not TP({tp})/GQA-expressible: pad "
                            "with dead (zero-init) heads; +"
                            f"{100*(Hp-H)/H:.0f}% attention FLOPs beats "
                            "replicated attention (the useful-FLOP ratio in "
                            "§Roofline accounts for the waste)")
            # kv heads: shard when divisible, else replicate the (small)
            # k/v activations across the model axis
            kv_sharded = Kp % tp == 0
            plan.estimates["kv_heads_sharded"] = float(kv_sharded)
            if not kv_sharded:
                self.record(ctx, "kv_heads", "replicated over model axis",
                            f"{Kp} kv heads < TP={tp}: replicating k/v "
                            "activations (B,S,K,hd is small) avoids "
                            "inexpressible shardings; the KV cache shards "
                            "its head_dim instead (data_organization)")

        # ---- SSM head padding ---------------------------------------------
        if arch.has_ssm and plan.axis_rules.get("ssm_inner") != "model":
            plan.estimates["ssm_heads_padded"] = float(arch.ssm_heads)
        elif arch.has_ssm:
            Hs = arch.ssm_heads
            Hsp = pad_up(Hs, tp) if Hs % tp else Hs
            plan.estimates["ssm_heads_padded"] = float(Hsp)
            if Hsp != Hs:
                self.record(ctx, "ssm_heads", f"{Hs} -> {Hsp}",
                            f"d_inner/head reshape not TP({tp})-expressible "
                            "otherwise; padded heads are dead at init")

        # ---- KV cache layout ----------------------------------------------
        for t in ctx.ir.by_role(Role.KV_CACHE):
            p = plan.placements[t.name]
            p.layout["order"] = "seq_major"   # (L, 2, B, S, K, hd)
            p.layout["append"] = "dynamic_update_slice"
            p.decided_by.append(self.name)
            self.record(ctx, t.name, "seq-major",
                        "decode appends one token/step: seq-major makes the "
                        "append a contiguous DMA and the decode read a stream")

        # ---- dtype assignments -------------------------------------------
        for t in ctx.ir.by_role(Role.PARAM, Role.EXPERT_PARAM):
            plan.placements[t.name].dtype = arch.dtype
        for t in ctx.ir.by_role(Role.OPT_STATE):
            plan.placements[t.name].dtype = "float32"
        plan.estimates["softmax_dtype_f32"] = 1.0
        self.record(ctx, "dtypes", "bf16 streams, fp32 softmax/router/adam",
                    "MXU-native bf16; numerically-sensitive reductions in fp32")

        # ---- MXU alignment notes for projections --------------------------
        for t in ctx.ir.by_role(Role.PARAM, Role.EXPERT_PARAM):
            last = t.shape[-1]
            if last % tgt.mxu_dim != 0:
                p = plan.placements[t.name]
                p.pad_to = tuple(
                    pad_up(s, tgt.mxu_dim) if i == len(t.shape) - 1 else s
                    for i, s in enumerate(t.shape)
                )
                p.decided_by.append(self.name)
