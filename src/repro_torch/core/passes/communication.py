"""Communication pass (paper §4, third level).

Paper: "the prefetcher is configured to hide transfer latency based on
the data access patterns."

TPU re-targeting — everything that moves bytes between memories/chips:

* gradient reduction schedule (all-reduce vs reduce-scatter+all-gather),
  chosen from the static cost model;
* gradient compression on the *slow channel* (the DCN "pod" axis) with
  int8 + error feedback — the template's ``special.compress`` function;
* microbatching (grad accumulation) so collectives overlap compute;
* host input-pipeline prefetch depth (the literal prefetcher);
* remat policy — recompute-vs-refetch is a transfer-hiding decision too:
  it trades HBM traffic for FLOPs when activations overflow the budget.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

from repro_torch.core.costmodel import (REMAT_LADDER, compressed_ratio,
                                        eager_train_step_memory,
                                        estimate_step)
from repro_torch.core.ir import Role
from repro_torch.core.passes import Pass, PassContext


def moe_costs(arch, shape) -> Tuple[str, float, float]:
    """The MoE path of a plan and the per-token-per-d FLOPs it weighs:
    ``(impl, dense, dispatch)``.  Dense runs every expert's FFN (6 E ff);
    dispatch the routed FFN (6 k ff) plus the two one-hot dispatch /
    combine matmuls at 4 k cf T_group, quadratic in the routing group
    (``route()`` groups per sequence)."""
    ff = arch.moe_d_ff or arch.d_ff
    k, cf, E = arch.experts_per_token, arch.capacity_factor, arch.n_experts
    dense_cost = 6.0 * E * ff
    disp_cost = 6.0 * k * ff + 4.0 * k * cf * shape.seq_len
    impl = "dense_einsum" if dense_cost <= disp_cost else "gshard_einsum"
    return impl, dense_cost, disp_cost

class CommunicationPass(Pass):
    name = "communication"

    act_budget_frac: float = 0.25     # activations may use this HBM share
    #: the share of a CUDA card the whole eager train step may peak at:
    #: the persistent share (``DataOrganizationPass.hbm_budget_frac``,
    #: 0.70) and the activation share together
    step_budget_frac: float = 0.95

    def run(self, ctx: PassContext) -> None:
        plan, mesh, tgt = ctx.plan, ctx.mesh, ctx.target
        comm = plan.comm
        training = ctx.training
        axis_map = plan.axis_rules

        if training:
            # ---- grad schedule: model both, pick the cheaper -------------
            ar = estimate_step(ctx.ir, axis_map, mesh, tgt, training=True,
                               grad_schedule="all_reduce")
            rs = estimate_step(ctx.ir, axis_map, mesh, tgt, training=True,
                               grad_schedule="reduce_scatter")
            fsdp = any("fsdp" in d for p in plan.placements.values()
                       for d in p.decided_by)
            if fsdp:
                comm.grad_schedule = "reduce_scatter"
                why = "FSDP shards params: reduce-scatter matches shard layout"
            else:
                comm.grad_schedule = (
                    "reduce_scatter" if rs.collective_s <= ar.collective_s
                    else "all_reduce")
                why = (f"modelled collective time rs={rs.collective_s*1e3:.2f}ms "
                       f"vs ar={ar.collective_s*1e3:.2f}ms")
            self.record(ctx, "grad_schedule", comm.grad_schedule, why)

            # ---- slow-channel compression --------------------------------
            if "pod" in mesh.axes and mesh.axis_size("pod") > 1:
                comm.compress_pod_grads = True
                comm.compress_bits = 8
                ctx.template["special.compress"].refine(
                    self.name, bits=8, axis="pod", error_feedback=True)
                self.record(ctx, "pod_grads", "int8 + error feedback",
                            f"DCN bw {tgt.dcn_bw/1e9:.1f} GB/s << ICI "
                            f"{tgt.ici_link_bw/1e9:.0f} GB/s: 4x volume cut "
                            "on the slow channel dominates the quantization "
                            "noise (error feedback keeps it unbiased)")
            else:
                ctx.template["special.compress"].remove(
                    self.name, "single-pod mesh: ICI fast enough")

            # ---- ICI-wide compressed reduction (collective-bound steps) ---
            # The paper's "technology requirements" knob as a measurable
            # perf decision: when the modeled step is bound by the gradient
            # collective, switch the whole DP reduction (not just the pod
            # channel) to int8 + error feedback and book the volume cut.
            raw = rs if comm.grad_schedule == "reduce_scatter" else ar
            ratio = compressed_ratio(bits=8)
            plan.estimates["est_collective_s_raw"] = raw.collective_s
            plan.estimates["est_collective_s_int8"] = raw.collective_s * ratio
            collective_bound = raw.collective_s > 0 and \
                raw.collective_s >= max(raw.compute_s, raw.memory_s)
            forced_gc = ctx.options.get("grad_compression")
            if forced_gc is not None:
                collective_bound = forced_gc == "on"
            if collective_bound:
                comm.compress_grads = True
                comm.compress_bits = 8
                comp = ctx.template["special.compress"]
                comp.enabled = True           # may have been removed above
                comp.params.pop("removed_reason", None)
                comp.refine(
                    self.name, bits=8, axis="+".join(self._dp_axes(ctx)),
                    error_feedback=True)
                self.record(
                    ctx, "grad_compression", "int8 + error feedback (ICI)",
                    "forced by options" if forced_gc is not None else
                    f"step is collective-bound "
                    f"(coll {raw.collective_s*1e3:.2f}ms >= compute "
                    f"{raw.compute_s*1e3:.2f}ms, mem {raw.memory_s*1e3:.2f}ms"
                    f"): int8 codes + per-128 scales cut the reduction to "
                    f"{ratio:.2f}x = {raw.collective_s*ratio*1e3:.2f}ms; "
                    "error feedback keeps it unbiased over steps")
            else:
                self.record(
                    ctx, "grad_compression", "off",
                    "forced by options" if forced_gc is not None else
                    f"step not collective-bound (coll "
                    f"{raw.collective_s*1e3:.2f}ms < max(compute "
                    f"{raw.compute_s*1e3:.2f}ms, mem {raw.memory_s*1e3:.2f}"
                    "ms)): full-precision reduction overlaps for free; "
                    "compression would only add quantization noise")
            plan.estimates["grad_compress"] = float(comm.compress_grads)

            # ---- lowering verdict: do codes actually cross the wire? ------
            # The modeled volume cut only becomes real if the train step
            # can replace its f32 reduction with the int16 code sum; the
            # shared wire_compression predicate decides, and the artifact
            # records the verdict so `plan show` never claims a cut the
            # lowered step does not deliver.
            if comm.compress_grads:
                from repro_torch.core.passes.lowering import wire_compression
                dp = wire_compression(plan, None, ctx.arch)
                comm.compress_lowered = dp > 0
                if dp:
                    # key presence == lowered: gate-refused plans render
                    # through the same "post-reduce" fallback as
                    # artifacts stored before the wire lowering existed
                    plan.estimates["grad_compress_lowered"] = float(dp)
                    self.record(
                        ctx, "grad_compress_lowering",
                        f"int16 code sum on the wire (dp={dp})",
                        "vmap-sliced grads quantize against a shared scale "
                        "and the per-slice int8 codes sum across the data "
                        f"axes in int16 ({dp} * 127 = {dp * 127} <= 32767): "
                        "the step's only gradient-sized cross-data "
                        "collective runs in integer dtype")
                else:
                    self.record(
                        ctx, "grad_compress_lowering", "post-reduce EF",
                        "wire gate failed (FSDP shard layout, batch not "
                        "divisible by dp x microbatches, dp > 256, or "
                        "shard_map MoE dispatch): EF still models the "
                        "compression but the reduction stays full-precision")

            # ---- microbatching: activation budget + comm overlap ----------
            est = estimate_step(ctx.ir, axis_map, mesh, tgt, training=True,
                                grad_schedule=comm.grad_schedule,
                                grad_bits=8 if comm.compress_grads else None)
            budget = self.act_budget_frac * tgt.hbm_bytes
            # hard floor on saved memory: the per-layer scan carry
            # (L x tokens_local x d_model, bf16) cannot be rematted away
            carry = self._carry_bytes(ctx, microbatches=1)
            nmicro = 1
            dp = self._dp(ctx)
            batch_local = max(ctx.shape.global_batch // dp, 1)
            while carry / nmicro > budget and nmicro < batch_local:
                nmicro *= 2
            if est.collective_s > 0.25 * est.compute_s and nmicro < 2:
                nmicro = min(2, batch_local)
                self.record(ctx, "microbatches", str(nmicro),
                            f"collective {est.collective_s*1e3:.1f}ms vs "
                            f"compute {est.compute_s*1e3:.1f}ms: pipeline grad "
                            "reduction behind the next microbatch's backward")
            comm.microbatches = nmicro
            if nmicro > 1:
                self.record(
                    ctx, "microbatches", str(nmicro),
                    f"layer-carry activations {carry/2**30:.1f} GiB/chip vs "
                    f"budget {budget/2**30:.1f} GiB -> split the step into "
                    f"{nmicro} microbatches ({carry/nmicro/2**30:.1f} GiB each)")
            plan.estimates.update(
                est_compute_s=est.compute_s, est_memory_s=est.memory_s,
                est_collective_s=est.collective_s,
                carry_bytes_per_dev=carry / nmicro)

            # ---- remat policy ---------------------------------------------
            from repro_torch.core.passes.partitioning import CUDA_TARGETS
            act_bytes = self._activation_bytes(ctx)
            if ctx.target.name in CUDA_TARGETS:
                self._remat_by_step_peak(ctx, nmicro)
            elif carry / nmicro + act_bytes / nmicro > budget:
                comm.remat_policy = "full"
                self.record(ctx, "remat", "full",
                            f"intra-layer activations {act_bytes/nmicro/2**30:.1f}"
                            f" GiB/chip on top of carries "
                            f"{carry/nmicro/2**30:.1f} GiB exceed budget "
                            f"{budget/2**30:.1f} GiB: save only layer inputs, "
                            "recompute the block in backward")
            elif act_bytes > budget or nmicro > 1:
                comm.remat_policy = "dots_saveable"
                self.record(ctx, "remat", "dots_saveable",
                            f"activations {act_bytes/2**30:.1f} GiB/chip "
                            f"(budget {budget/2**30:.1f} GiB, {nmicro} micro): "
                            "recompute element-wise ops, keep matmul outputs")
            else:
                comm.remat_policy = "none"
                self.record(ctx, "remat", "none",
                            f"activations {act_bytes/2**30:.2f} GiB/chip fit")
        else:
            comm.grad_schedule = "none"
            comm.remat_policy = "none"

        # ---- prefetcher (host pipeline + pallas lookahead) ---------------
        comm.prefetch_depth = 2 if ctx.shape.kind != "decode" else 4
        ctx.template["prefetch.host"].refine(self.name, depth=comm.prefetch_depth)
        ctx.template["prefetch.grid"].refine(self.name, lookahead=1)
        if ctx.shape.kind == "decode" and not ctx.arch.has_attention:
            # all state on-chip & constant-size: the paper's removal rule
            ctx.template["prefetch.host"].remove(
                self.name, "decode with on-chip constant state only")
        self.record(ctx, "prefetch_depth", str(comm.prefetch_depth),
                    "hide host->HBM latency behind step compute")

        # ---- decode combine topology -------------------------------------
        # The flash-decode softmax combine crosses the model axis every
        # tick; its wire pattern (flat psums vs a packed ring gather) is
        # a per-mesh-geometry choice the plan records like kv_residency,
        # so every consumer (kernels, engine, benchmarks) dispatches the
        # same way.
        if ctx.shape.kind == "decode" and ctx.arch.has_attention:
            from repro_torch.core.costmodel import (choose_combine_topology,
                                              combine_hops)
            msize = mesh.axis_size("model") if "model" in mesh.axes else 1
            forced_ct = ctx.options.get("combine_topology")
            if msize <= 1:
                topo = "flat"
                why = "model degree 1: no cross-shard combine exists"
            elif forced_ct is not None:
                topo = forced_ct
                why = "forced by options"
            else:
                topo = choose_combine_topology(msize)
                hops = {t: combine_hops(msize, t)
                        for t in ("flat", "ring", "bidir")}
                why = (f"model degree {msize}: latency chains flat="
                       f"{hops['flat']} hops (3 collectives XLA fuses at "
                       f"small degrees), ring={hops['ring']}, bidir="
                       f"{hops['bidir']} -> {topo} at the calibrated "
                       "crossover degrees (8/16)")
            comm.combine_topology = topo
            plan.estimates["combine_topology"] = topo
            plan.estimates["combine_hops"] = float(combine_hops(msize, topo))
            self.record(ctx, "combine_topology", topo, why)

        # ---- channel configuration ---------------------------------------
        ctx.template["channel.ici"].refine(
            self.name, axes=[a for a in mesh.axes if a != "pod"],
            collectives=comm.grad_schedule)
        if "pod" in mesh.axes:
            ctx.template["channel.dcn"].refine(
                self.name, axes=["pod"],
                compressed=comm.compress_pod_grads)
        else:
            ctx.template["channel.dcn"].remove(self.name, "single-pod mesh")

        # ---- MoE execution strategy ---------------------------------------
        if ctx.arch.is_moe:
            impl, dense_cost, disp_cost = moe_costs(ctx.arch, ctx.shape)
            plan.estimates["moe_impl"] = impl
            self.record(
                ctx, "moe_impl", impl,
                f"per-token-per-layer cost model: dense={dense_cost/1e3:.1f}k "
                f"d-flops vs dispatch={disp_cost/1e3:.1f}k — "
                + ("all-expert dense execution beats the one-hot "
                   "dispatch matmuls (and drops the (T,E,C) tensors + "
                   "all-to-all entirely)" if impl == "dense_einsum" else
                   "capacity dispatch is cheaper at this expert count"))

        comm.donate_state = True
        comm.overlap_collectives = True

    # ------------------------------------------------------------------
    def _remat_by_step_peak(self, ctx: PassContext, nmicro: int) -> None:
        """Remat on a CUDA target: the least recomputation
        (:data:`REMAT_LADDER`) whose whole eager step, state, gradients,
        saved activations and the largest transient
        (:func:`eager_train_step_memory`), stays under
        :attr:`step_budget_frac` of the card; ``full`` when none does,
        with ``step_fits`` 0.  The TPU path holds persistent state and
        fused activations to two shares apart; the eager step's gradient
        buffer and saved tensors belong to neither, so the two shares are
        held together."""
        from repro_torch.kernels import ssd_scan as ssd

        plan, arch = ctx.plan, ctx.arch
        budget = self.step_budget_frac * ctx.target.hbm_bytes
        _, heads, _, kv_heads = plan.padded_sizes()
        heads, kv_heads = heads or arch.n_heads, kv_heads or arch.n_kv_heads
        params = ctx.ir.by_role(Role.PARAM, Role.EXPERT_PARAM)
        share = _RankShare(plan, ctx.mesh, params)
        heads, kv_heads = share.heads(heads, kv_heads)
        stacked = [share.bytes(t) for t in params
                   if t.logical_axes and t.logical_axes[0] == "layers"]
        tokens = ctx.shape.tokens / self._dp(ctx)
        vocab = plan.padded_sizes()[0] or arch.vocab_size
        tried = {}
        for policy in REMAT_LADDER:
            tried[policy] = eager_train_step_memory(
                arch, tokens=tokens, seqs=tokens / ctx.shape.seq_len,
                moe_impl=(moe_costs(arch, ctx.shape)[0] if arch.is_moe
                          else ""),
                ssd_chunk=(ssd.cuda_chunk(arch.ssm_head_dim, arch.ssm_state)
                           or ssd.DEFAULT_CHUNK),
                heads=heads, kv_heads=kv_heads,
                vocab=share.vocab(vocab),
                state_bytes=(share.state(arch) if ctx.mesh.n_devices > 1
                             else plan.estimates["persistent_bytes_per_dev"]),
                param_bytes=sum(share.bytes(t) for t in params),
                largest_stacked_bytes=max(stacked, default=0),
                embed_bytes=sum(share.bytes(t) for t in params
                                if t.name == "embed"),
                remat=policy, microbatches=nmicro,
                ff_shards=share.ff_shards(),
                vocab_split=share.vocab(vocab) != vocab,
                gathered_layer_bytes=share.gathered_layer(arch),
                **share.ssm(arch, plan.padded_sizes()[2]),
                ef_bytes=(sum(2 * share.bytes(t) // t.dtype_bytes
                              for t in params)
                          if plan.comm.compresses_gradients else 0.0))
            if tried[policy]["peak"] <= budget:
                break
        est = tried[policy]
        fits = est["peak"] <= budget
        plan.comm.remat_policy = policy
        plan.estimates.update(
            step_peak_bytes=est["peak"], step_grad_bytes=est["grads"],
            step_saved_bytes=est["saved"],
            step_transient_bytes=max(est["loss"], est["tail"]),
            step_runtime_bytes=est["runtime"],
            step_budget_bytes=float(budget), step_fits=float(fits))
        gib = 2 ** 30
        self.record(
            ctx, "remat", policy,
            "eager step peak " + ", ".join(
                f"{p} {e['peak'] / gib:.2f}" for p, e in tried.items())
            + f" GiB against {self.step_budget_frac:.2f} of the card "
            f"({budget / gib:.2f} GiB): state {est['state'] / gib:.2f}, "
            f"runtime {est['runtime'] / gib:.2f}, "
            f"gradients {est['grads'] / gib:.2f}, saved activations "
            f"{est['saved'] / gib:.2f}, the loss's backward "
            f"{est['loss'] / gib:.2f}, stacking / optimizer tail "
            f"{est['tail'] / gib:.2f} GiB"
            + ("" if fits else "; no remat fits: the step does not fit"))

    def _dp_axes(self, ctx: PassContext) -> tuple:
        """Mesh axes the batch rule actually uses (the DP reduction set)."""
        assign = ctx.plan.axis_rules.get("batch", "data")
        names = (assign,) if isinstance(assign, str) else tuple(assign)
        return tuple(n for n in names if n in ctx.mesh.axes)

    def _dp(self, ctx: PassContext) -> int:
        """Data-parallel width from the batch axis rule."""
        dp = 1
        for n in self._dp_axes(ctx):
            dp *= ctx.mesh.axis_size(n)
        return max(dp, 1)

    def _carry_bytes(self, ctx: PassContext, microbatches: int = 1) -> float:
        """Per-layer scan-carry saves: L x tokens_local x d_model, bf16."""
        arch, shape = ctx.arch, ctx.shape
        tokens_local = shape.tokens / self._dp(ctx) / max(microbatches, 1)
        return arch.n_layers * tokens_local * arch.d_model * 2

    def _activation_bytes(self, ctx: PassContext) -> float:
        """Live activations per chip for one (micro)batch, no remat."""
        arch, shape, mesh = ctx.arch, ctx.shape, ctx.mesh
        tokens_local = shape.tokens / self._dp(ctx) / \
            max(ctx.plan.comm.microbatches, 1)
        # residual + attn in/out + ffn hidden per layer, bf16
        width = arch.d_model * 3 + (arch.d_ff or arch.d_inner)
        tp = mesh.axis_size("model") \
            if ctx.plan.axis_rules.get("ff") == "model" else 1
        per_layer = tokens_local * width * 2 / tp
        if arch.has_ssm:
            # SSD intra-chunk quadratic tensors (L-matrix, scores, decay):
            # ~(tokens/chunk) x H x chunk x chunk f32 each
            chunk = 256
            per_layer += 3 * tokens_local * chunk * arch.ssm_heads * 4
        if arch.is_moe:
            # GShard dispatch/combine one-hots + expert slot activations:
            # tokens x E x C x (bf16 + f32) per MoE layer — these dominate
            # the per-layer saves if not rematerialized
            E = arch.n_experts
            # route() groups per sequence: capacity from the SEQ length
            cap = ctx.shape.seq_len * arch.experts_per_token * \
                arch.capacity_factor / E
            # dispatch/combine one-hots are TOKEN-sharded (E dim is full
            # on every device) — do NOT divide by the expert-parallel width
            moe_bytes = tokens_local * E * max(cap, 4) * 6
            per_layer = per_layer + moe_bytes / max(arch.moe_interleave, 1)
        return per_layer * arch.n_layers


class _RankShare:
    """One rank's share of the parameters under the plan's placements
    (``plan.placements``, divisibility repaired): what the eager step
    estimate counts on a mesh.  On one device every share is the
    whole, so a ``(1, 1)`` plan's estimate is the one-card formula's,
    byte for byte."""

    def __init__(self, plan, mesh, params):
        from repro_torch.core.costmodel import spec_shards
        self.plan, self.mesh, self._shards = plan, mesh, spec_shards
        self.params = {t.name: t for t in params}

    def _spec(self, name):
        """``name``'s placement; a leaf with a vocab dim is placed as the
        model places it: the layout pass pads the vocab after the
        placements were repaired on the IR's unpadded dim, so an odd
        vocab (hymba's 32001) that the IR leaves whole is split once
        padded (``lowering.param_pspecs``)."""
        p = self.plan.placements.get(name)
        spec = tuple(p.spec) if p is not None and p.spec else ()
        t = self.params.get(name)
        vpad = int(self.plan.estimates.get("vocab_padded", 0))
        if t is None or "vocab" not in t.logical_axes or not vpad:
            return spec
        from repro_torch.dist.sharding import resolve_pspec
        shape = [vpad if a == "vocab" else n
                 for n, a in zip(t.shape, t.logical_axes)]
        return tuple(resolve_pspec(self.plan.axis_rules, shape,
                                   t.logical_axes, self._sizes()))

    def _sizes(self) -> Dict[str, int]:
        return {a: self.mesh.axis_size(a) for a in self.mesh.axes}

    def state(self, arch) -> float:
        """The rank's parameters, moments and master copy as the trainer
        holds them (``Trainer.init_state``): each leaf of the model's
        plan-padded tree over its resolved spec
        (``lowering.param_pspecs``), in its dtype, with two moments in
        the plan's moment dtype and, with master weights, an fp32 copy.
        The IR's placements undercount a mesh rank's state where the
        layout pass pads heads (hymba's 5 kv heads to 13 a rank at (1,
        2)) and overcount it where they leave an odd vocab whole."""
        import torch

        from repro_torch.core.costmodel import spec_shards
        from repro_torch.core.passes.lowering import param_pspecs
        from repro_torch.models import lm
        padded = self.plan.padded_sizes()
        specs = lm.leaf_specs(arch, *padded)
        pspecs = param_pspecs(self.plan, arch, self._sizes(),
                              shapes=lm.param_shapes(arch, *padded))
        opt = self.plan.opt
        moment = torch.empty((), dtype=getattr(
            torch, opt["moment_dtype"])).element_size()
        master = 4 if opt["master_weights"] else 0
        total = 0.0

        def walk(sp, ps):
            nonlocal total
            if isinstance(sp, dict):
                for k in sp:
                    walk(sp[k], ps[k])
                return
            n = math.prod(sp.shape) // spec_shards(tuple(ps), self.mesh)
            total += n * (sp.dtype.itemsize + 2 * moment + master)
        walk(specs, pspecs)
        return total

    def _dim(self, name, logical) -> int:
        t = self.params.get(name)
        if t is None or logical not in t.logical_axes:
            return 1
        return self._shards(self._spec(name), self.mesh,
                            {t.logical_axes.index(logical)})

    def bytes(self, t) -> int:
        """``t``'s bytes over its shard factor."""
        return t.nbytes // self._shards(self._spec(t.name), self.mesh)

    def heads(self, heads: int, kv_heads: int):
        """The query and kv heads a rank attends with (whole where a cut
        does not fall on whole heads)."""
        fq, fk = self._dim("attn.wq", "heads"), self._dim("attn.wk",
                                                          "kv_heads")
        return (heads // fq if heads % fq == 0 else heads,
                kv_heads // fk if kv_heads % fk == 0 else kv_heads)

    def vocab(self, vocab: int) -> int:
        head = "lm_head" if "lm_head" in self.params else "embed"
        f = self._dim(head, "vocab")
        return vocab // f if vocab % f == 0 else vocab

    def ff_shards(self) -> int:
        fi, fo = self._dim("mlp.wi", "ff"), self._dim("mlp.wo", "ff")
        return fi if fi == fo else 1

    def ssm(self, arch, heads_padded: int) -> Dict[str, int]:
        """The SSM heads and conv channels a rank holds where the model
        axis splits its heads (``ssm.out_proj`` on ``ssm_inner``); none
        where they are whole."""
        f = self._dim("ssm.out_proj", "ssm_inner")
        if not arch.has_ssm or f == 1:
            return {}
        H = heads_padded or arch.ssm_heads
        C = H * arch.ssm_head_dim + 2 * arch.ssm_n_groups * arch.ssm_state
        fc = self._dim("ssm.conv", "ssm_inner")
        return {"ssm_heads": H // f,
                "conv_channels": C // fc if C % fc == 0 else C}

    def gathered_layer(self, arch) -> float:
        """One layer's stacked leaves gathered whole on their FSDP
        (``embed``) dims, each still cut on its other dims (0.0 without
        FSDP)."""
        total = 0.0
        for t in self.params.values():
            ax = t.logical_axes
            if not ax or ax[0] != "layers" or "embed" not in ax:
                continue
            e = ax.index("embed")
            spec = self._spec(t.name)
            if self._shards(spec, self.mesh, {e}) == 1:
                continue
            rest = set(range(len(spec))) - {e}
            total += t.nbytes / self._shards(spec, self.mesh, rest) \
                / t.shape[0]
        return total
