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

from repro_torch.core.costmodel import compressed_ratio, estimate_step
from repro_torch.core.ir import Role
from repro_torch.core.passes import Pass, PassContext


class CommunicationPass(Pass):
    name = "communication"

    act_budget_frac: float = 0.25     # activations may use this HBM share

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
            act_bytes = self._activation_bytes(ctx)
            if carry / nmicro + act_bytes / nmicro > budget:
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
            a = ctx.arch
            ff = a.moe_d_ff or a.d_ff
            k, cf, E = a.experts_per_token, a.capacity_factor, a.n_experts
            # per-token-per-d FLOPs:
            #   dense:    every expert's FFN                6*E*ff
            #   dispatch: routed FFN 6*k*ff + two one-hot dispatch/combine
            #             matmuls at 4*k*cf*T_group (quadratic in the
            #             routing group size!)
            t_group = ctx.shape.seq_len     # route() groups per sequence
            dense_cost = 6.0 * E * ff
            disp_cost = 6.0 * k * ff + 4.0 * k * cf * t_group
            impl = ("dense_einsum" if dense_cost <= disp_cost
                    else "gshard_einsum")
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
