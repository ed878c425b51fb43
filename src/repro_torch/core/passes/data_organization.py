"""Data-organization pass (paper §4, highest abstraction level).

Paper: "analyzes the data representations to determine the coarse memory
structure, i.e. deciding which data are stored off-chip or on-chip."

TPU re-targeting: *on-chip* for a given chip means "the shard of the
tensor this chip owns".  The pass therefore decides, per logical tensor:

* the mesh sharding (which logical axes map to which mesh axes), and
* the residency class (HBM / HOST / REMOTE),

under a per-chip HBM byte budget — the paper's "given area constraints".
The outputs are the plan's ``axis_rules`` plus per-tensor placement specs
with divisibility validated against real dims.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

from repro_torch.core.costmodel import (MeshModel, bytes_per_device,
                                  kv_block_geometry, kv_prefill_split,
                                  kv_tier_split, shard_factor)
from repro_torch.core.ir import MemorySpace, Role, TensorDecl
from repro_torch.core.passes import Pass, PassContext


class DataOrganizationPass(Pass):
    name = "data_organization"

    #: fraction of HBM the persistent state (params + opt + caches) may use
    hbm_budget_frac: float = 0.70

    def run(self, ctx: PassContext) -> None:
        mesh = ctx.mesh
        plan = ctx.plan
        has_pod = "pod" in mesh.axes

        # ---- sharding strategy: Megatron-TP vs FSDP-DP -------------------
        # TP moves activation bytes per layer (2 all-reduces x token bytes);
        # FSDP-DP moves weight bytes per layer (all-gather fwd+bwd).  Pick
        # whichever moves fewer bytes for this (arch x shape) — the paper's
        # data-organization phase deciding placement from static analysis.
        strategy = self._pick_strategy(ctx)
        batch_axes: Tuple[str, ...] = (("pod", "data") if has_pod else ("data",))
        if strategy.startswith("fsdp"):
            full_dp = batch_axes if strategy == "fsdp_hybrid" \
                else batch_axes + ("model",)
            if strategy == "fsdp_dp_data":
                embed_assign = ("data",)
            else:
                embed_assign = ("data", "model")
            rules: Dict[str, Optional[object]] = {
                "batch": full_dp,
                "seq": None,
                "act_embed": None,
                "act_heads": None,
                "act_ff": None,
                "act_experts": None,
                "layers": None,
                "embed": embed_assign,           # ZeRO-3 over the fast axes
                "heads": None,
                "kv_heads": None,
                "head_dim": None,
                "ff": None,
                "vocab": None,
                "experts": None,
                "ssm_inner": None,
                "seq_kv": None,
                "ssm_heads": None,
                "flat_params": embed_assign,
            }
            self.record(
                ctx, "strategy", strategy,
                "per-layer weight all-gather moves fewer bytes than TP "
                "activation all-reduces for this workload "
                "(hybrid: batch over pod+data only — global batch smaller "
                "than the device count)" if strategy == "fsdp_hybrid" else
                "per-layer weight all-gather moves fewer bytes than TP "
                "activation all-reduces (see est_* in estimates)")
        else:
            rules = {
                # activations
                "batch": batch_axes if len(batch_axes) > 1 else batch_axes[0],
                "seq": None,
                "act_embed": None,
                "act_heads": "model",
                "act_ff": "model",
                "act_experts": None,
                # params (tensor-parallel axes)
                "layers": None,
                "embed": None,
                "heads": "model",
                "kv_heads": "model",
                "head_dim": None,
                "ff": "model",
                "vocab": "model",
                "experts": "model",
                "ssm_inner": "model",
                "seq_kv": None,
                "ssm_heads": "model",
                "flat_params": "model",
            }
            self.record(ctx, "strategy", "megatron_tp",
                        "TP activation traffic below FSDP weight traffic "
                        "(or inference shape: keep weights TP-resident)")
        plan.estimates["strategy"] = strategy
        plan.axis_rules = dict(rules)
        self.record(ctx, "axis_rules",
                    f"{strategy}, DP=" + "+".join(batch_axes),
                    "template channel assignment (ICI fast axes)")

        # ---- per-tensor placements with divisibility repair --------------
        for t in ctx.ir.tensors.values():
            spec = self._resolve(ctx, t)
            p = plan.placement(t.name)
            p.spec = spec
            p.residency = MemorySpace.HBM.value
            p.decided_by.append(self.name)

        # inputs stream from the host pipeline (off-chip analogue)
        for t in ctx.ir.by_role(Role.INPUT):
            plan.placement(t.name).residency = MemorySpace.HOST.value
            self.record(ctx, t.name, "HOST->HBM streamed",
                        "step inputs are produced by the host pipeline")

        # ---- HBM budget check → FSDP spill (the paper's on/off-chip split)
        budget = self.hbm_budget_frac * ctx.target.hbm_bytes
        persistent = self._persistent_bytes_per_dev(ctx)
        if persistent > budget:
            self._enable_fsdp(ctx)
            persistent2 = self._persistent_bytes_per_dev(ctx)
            self.record(
                ctx, "fsdp", "enabled",
                f"persistent state {persistent/2**30:.1f} GiB/chip exceeds "
                f"budget {budget/2**30:.1f} GiB; FSDP over data axis brings "
                f"it to {persistent2/2**30:.1f} GiB",
            )
            persistent = persistent2
            # next rungs of the ladder: optimizer-state precision
            # (the paper's "technology requirements" dimension)
            if persistent > budget:
                plan.opt["moment_dtype"] = "bfloat16"
                for t in ctx.ir.by_role(Role.OPT_STATE):
                    if t.name in ("adam_m", "adam_v"):
                        t.dtype = "bfloat16"
                persistent = self._persistent_bytes_per_dev(ctx)
                self.record(ctx, "opt_moments", "bfloat16",
                            f"still over budget: Adam moments to bf16 -> "
                            f"{persistent/2**30:.1f} GiB/chip")
            if persistent > budget:
                plan.opt["master_weights"] = False
                for t in ctx.ir.by_role(Role.OPT_STATE):
                    if t.name == "master":
                        t.annotations["folded"] = True  # no separate fp32 copy
                persistent = self._persistent_bytes_per_dev(ctx)
                self.record(ctx, "master_weights", "dropped",
                            "bf16 params updated with stochastic rounding "
                            f"(no fp32 copy) -> {persistent/2**30:.1f} GiB/chip")
        else:
            self.record(
                ctx, "fsdp", "disabled",
                f"persistent state {persistent/2**30:.1f} GiB/chip fits "
                f"budget {budget/2**30:.1f} GiB — keep weights TP-only "
                "(no per-layer all-gather needed)",
            )
        plan.estimates["persistent_bytes_per_dev"] = float(persistent)

        # KV cache placement sanity (decode shapes)
        for t in ctx.ir.by_role(Role.KV_CACHE):
            self._shard_cache(ctx, t, budget)

        # KV residency: dense per-slot stripes vs a plan-sized block pool
        self._choose_kv_residency(ctx, budget, persistent)

        plan.estimates["hbm_budget_bytes"] = float(budget)

    # ------------------------------------------------------------------
    def _choose_kv_residency(self, ctx: PassContext, budget: float,
                             persistent: float) -> None:
        """Dense per-slot stripes vs a plan-sized paged block pool.

        The serving KV cache is the one memory whose *occupancy* varies
        at runtime (slots churn); paging turns freed slots back into pool
        capacity instead of dead masked rows.  The pass decides the 2-D
        geometry (block_len, n_blocks split data-major into per-data-
        shard sub-pools, each model-shardable) from the workload dims
        and the HBM left after persistent state: on a data×model mesh
        the pool shards over BOTH axes — batch slots partition across
        data and each (data, model) shard owns its block slice, the
        partitioned-multi-bank specialization of the template.  Dense
        wins when the cache is too shallow for blocks to matter, or when
        the batch cannot partition over the data degree (slots could not
        be owned per data shard, which would force the pool back to
        data-replication and regress per-chip compute).  An
        ``options['kv_residency']`` override forces either.
        """
        plan, arch, shape = ctx.plan, ctx.arch, ctx.shape
        if shape.kind != "decode" or not arch.has_attention:
            return
        # the pool spans every chip (data-major sub-pools × model
        # shards), so its budget is the GLOBAL HBM headroom; capacity
        # still targets 1/data_degree of the all-slots-at-max footprint
        # (the reclamation bet — churn keeps the sub-pools fed), which
        # is what puts per-chip paged bytes below the dense stripes.
        # (zero headroom is a real cap — it clamps each sub-pool to the
        # one-sequence floor, not to the uncapped worst case.)
        msize = ctx.mesh.axis_size("model") if "model" in ctx.mesh.axes else 1
        dsize = max(1, ctx.mesh.n_devices // msize)
        left = max(budget - persistent, 0.0) * msize * dsize
        geo = kv_block_geometry(
            shape.seq_len, shape.global_batch, arch.n_layers,
            arch.n_kv_heads, arch.hd, budget_bytes=left,
            data_shards=dsize, align=msize)
        batch_ok = dsize == 1 or shape.global_batch % dsize == 0
        forced = ctx.options.get("kv_residency")
        paged = (geo.blocks_per_seq >= 2 and batch_ok) if forced is None \
            else forced == "paged"
        plan.estimates["kv_residency"] = "paged" if paged else "dense"
        if not paged:
            if forced is not None:
                why = "forced by options"
            elif not batch_ok:
                why = (f"batch {shape.global_batch} does not partition "
                       f"over the {dsize}-wide data degree — slots could "
                       "not be owned per data shard, so the pool would "
                       "fall back to data-replication (per-chip working "
                       "set and compute regress vs dense stripes)")
            else:
                why = (f"cache depth {shape.seq_len} yields "
                       f"{geo.blocks_per_seq} block(s)/seq at "
                       f"block_len={geo.block_len} — paging buys no "
                       "reclamation granularity")
            self.record(ctx, "kv_residency", "dense", why)
            return
        plan.estimates["kv_block_len"] = geo.block_len
        plan.estimates["kv_n_blocks"] = geo.n_blocks
        plan.estimates["kv_dense_bytes"] = float(geo.dense_bytes)
        plan.estimates["kv_paged_bytes"] = float(geo.paged_bytes)
        plan.estimates["kv_pool_data_degree"] = geo.data_degree
        plan.estimates["kv_pool_model_degree"] = geo.model_degree
        plan.estimates["kv_admission"] = geo.admission
        plan.estimates["kv_preempt_headroom"] = geo.headroom_blocks
        # cross-request prefix reuse rides on the paged pool: record it
        # plus the expected-hit-rate headroom so from_plan engines and
        # the decision log carry the data-level-reuse bet explicitly
        residents = max(1, shape.global_batch // dsize)
        reuse_headroom = geo.prefix_hit_headroom(residents)
        plan.estimates["kv_prefix_reuse"] = geo.prefix_reuse
        plan.estimates["kv_prefix_hit_headroom"] = reuse_headroom
        self.record(
            ctx, "kv_prefix_reuse", geo.prefix_reuse,
            f"full prompt-prefix blocks are content-hashed and aliased "
            f"across requests (refcounted, CoW on divergence): at the "
            f"assumed {geo.assumed_hit_rate:.0%} shared-prefix rate, "
            f"{residents} resident seq(s)/sub-pool pin "
            f"~{reuse_headroom} fewer block(s) "
            f"(capacity x{geo.prefix_capacity_factor(residents):.2f}) "
            "and matched tokens skip prefill compute entirely")
        if geo.admission == "grant":
            self.record(
                ctx, "kv_admission", "grant",
                f"pool ({geo.n_blocks} blocks) is below the worst case "
                f"({shape.global_batch}x{geo.blocks_per_seq} blocks) — "
                "the reclamation bet; worst-case reservation would refuse "
                "servable requests, so admission grows holdings one block "
                "boundary at a time with preemption as the backstop "
                f"(headroom {geo.headroom_blocks} block(s)/sub-pool past "
                "one max sequence)")
        else:
            self.record(
                ctx, "kv_admission", "reserve",
                f"pool covers every slot's worst case "
                f"({shape.global_batch}x{geo.blocks_per_seq} blocks) — "
                "reserving full budgets at admission costs nothing and "
                "mid-decode grants can never fail")
        # multi-tier residency: size the host-DRAM spill pool behind the
        # HBM pool (the template specialized *across* tiers, not within
        # one).  The decode tick is modeled memory-bound — params plus
        # the per-chip pool read once per token — and the stream-back
        # check asks whether one block crosses PCIe inside the
        # block_len ticks between a slot's block-boundary crossings
        # (the engine's one-tick-lookahead prefetch window).
        n_chips = dsize * msize
        pin_frac = float(ctx.options.get("kv_host_pin_frac", 0.5))
        tick_s = ctx.target.hbm_time(persistent + geo.paged_bytes / n_chips)
        split = kv_tier_split(
            geo,
            host_budget_bytes=ctx.target.host_bytes_per_chip
            * n_chips * pin_frac,
            pcie_bw=ctx.target.pcie_bw,
            decode_tick_s=tick_s)
        plan.estimates["kv_tier_split"] = split.tier_name
        plan.estimates["kv_host_blocks"] = split.host_blocks
        plan.estimates["kv_host_bytes"] = float(split.host_bytes)
        plan.estimates["kv_stream_block_us"] = split.stream_block_s * 1e6
        plan.estimates["kv_decode_tick_us"] = split.decode_tick_s * 1e6
        plan.estimates["kv_prefetch"] = (
            "on" if split.prefetch_feasible else "off")
        if split.host_blocks:
            feas = ("feasible" if split.prefetch_feasible
                    else "NOT feasible (resumes may stall a tick on PCIe)")
            self.record(
                ctx, "kv_tier_split", split.tier_name,
                f"host pin budget ({pin_frac:.0%} of "
                f"{ctx.target.host_bytes_per_chip * n_chips / 2**30:.0f} "
                f"GiB) backs {split.host_blocks} spill block(s) behind "
                f"the {split.hbm_blocks}-block HBM pool; cold blocks "
                "(parked sessions, evicted prefix tails) park on host "
                f"and stream back at {ctx.target.pcie_bw / 1e9:.0f} GB/s "
                f"— one block in {split.stream_block_s * 1e6:.0f} us vs "
                f"a {split.lookahead_ticks}-tick boundary interval of "
                f"{split.lookahead_ticks * tick_s * 1e6:.0f} us, so "
                f"one-tick-lookahead prefetch is {feas}")
        else:
            self.record(
                ctx, "kv_tier_split", "hbm-only",
                "host pin budget cannot park even one full sequence "
                f"({split.block_bytes} B/block x {geo.blocks_per_seq} "
                "blocks/seq) — spilling a session that can never fully "
                "park only fragments the tier")
        # disaggregated prefill: one memory template per ROLE.  Prefill
        # is a flops-bound burst, decode a bandwidth-bound tick; run in
        # one process a worst-case prompt's prefill steals stall_ticks
        # consecutive decode ticks from every live slot.  Past the
        # threshold the plan flips to disagg — supervised prefill
        # workers stream block_len-sized KV chunks to the decode engine
        # (serve/disagg.py) and decode never waits on a prompt.
        psplit = kv_prefill_split(
            shape.seq_len, persistent, ctx.target.peak_bf16_flops,
            tick_s, chunk_len=geo.block_len)
        pmode = psplit.mode if not arch.has_ssm else "inline"
        plan.estimates["kv_prefill_mode"] = pmode
        plan.estimates["kv_prefill_chunk"] = psplit.chunk_len
        plan.estimates["kv_prefill_stall_ticks"] = psplit.stall_ticks
        if arch.has_ssm:
            self.record(
                ctx, "kv_prefill_mode", "inline",
                f"{arch.name} has an SSM path — its state is sequential "
                "across the whole prompt, so chunked block-native "
                "prefill (pure-attention KV) cannot ship blocks "
                "incrementally; prefill stays in-process")
        else:
            self.record(
                ctx, "kv_prefill_mode", pmode,
                f"worst-case {shape.seq_len}-token prefill burns "
                f"{psplit.prefill_s * 1e3:.1f} ms of chip flops vs a "
                f"{tick_s * 1e6:.0f} us decode tick — "
                f"{psplit.stall_ticks:.0f} tick(s) of head-of-line "
                f"stall (threshold {psplit.threshold_ticks:.0f}); "
                + ("prefill moves to supervised workers streaming "
                   f"{psplit.chunk_len}-token pool-block chunks"
                   if pmode == "disagg" else
                   "inline prefill cannot stall decode enough to pay "
                   "for a worker fleet"))
        for t in ctx.ir.by_role(Role.KV_CACHE):
            plan.placement(t.name).layout["kv_residency"] = "paged"
            plan.placement(t.name).decided_by.append(self.name + ":paged")
        self.record(
            ctx, "kv_residency",
            f"paged block_len={geo.block_len} n_blocks={geo.n_blocks} "
            f"pool_sharding={dsize}x{msize}",
            f"pool {geo.paged_bytes/n_chips/2**30:.2f} GiB/chip (2-D "
            f"sharded: {dsize} data-major sub-pools of "
            f"{geo.sub_pool_blocks} blocks x model degree {msize}, batch "
            f"partitioned across data) vs dense stripes "
            f"{geo.dense_bytes/n_chips/2**30:.2f} GiB/chip; freed slots "
            "return blocks to their sub-pool instead of masking rows")

    # ------------------------------------------------------------------
    def _pick_strategy(self, ctx: PassContext) -> str:
        """Static byte model: TP activation ARs vs FSDP weight AGs."""
        arch, shape, mesh = ctx.arch, ctx.shape, ctx.mesh
        if shape.kind != "train":
            return "megatron_tp"     # serving keeps weights TP-resident
        tp = mesh.axis_size("model")
        if tp <= 1:
            return "megatron_tp"
        n_dev = mesh.n_devices
        dp = n_dev // tp
        if shape.global_batch % n_dev != 0:
            # batch too small for full-DP (e.g. 256 samples on 512 chips).
            # hybrid (batch over pod+data, ZeRO-3 over data+model) pays the
            # weight all-gather once PER MICROBATCH and re-reads gathered
            # weights from HBM — measured 2x worse than its wire bytes
            # suggest (EXPERIMENTS.md §Perf, refuted iteration), so it must
            # beat TP with that penalty before we pick it.
            if shape.global_batch % dp == 0 and \
                    arch.d_model % (mesh.axis_size("data") * tp) == 0:
                L = max(arch.n_layers, 1)
                tokens_local = shape.tokens / dp
                tp_bytes = (2 * 3 * tokens_local * arch.d_model * 2
                            * 2 * (tp - 1) / tp) * L
                params_b = arch.param_count() * 2
                carry = L * tokens_local * arch.d_model * 2
                nmicro = max(1, int(carry // (4 * 2**30)) + 1)
                hybrid_bytes = 3 * params_b * nmicro
                if 2 * hybrid_bytes < tp_bytes:
                    return "fsdp_hybrid"
            return "megatron_tp"
        if arch.d_model % n_dev != 0:
            if arch.d_model % dp == 0:
                return "fsdp_dp_data"   # shard weights over data axis only
            return "megatron_tp"     # ZeRO-3 shards the embed dim
        L = max(arch.n_layers, 1)
        # TP: ~2 all-reduces of the residual per layer, fwd + 2x bwd,
        # ring volume 2(g-1)/g, bf16
        tokens_local = shape.tokens / dp
        tp_bytes = (2 * 3 * tokens_local * arch.d_model * 2
                    * 2 * (tp - 1) / tp) * L
        # FSDP: gather each layer's params fwd + bwd, reduce-scatter grads
        layer_params = (arch.param_count()
                        - arch.vocab_size * arch.d_model
                        * (1 if arch.tie_embeddings else 2)) / L
        fsdp_bytes = 3 * layer_params * 2 * (n_dev - 1) / n_dev * L
        ctx.plan.estimates["est_tp_coll_bytes"] = float(tp_bytes)
        ctx.plan.estimates["est_fsdp_coll_bytes"] = float(fsdp_bytes)
        return "fsdp_dp" if fsdp_bytes < tp_bytes else "megatron_tp"

    def _resolve(self, ctx: PassContext, t: TensorDecl) -> Tuple:
        """Apply axis rules to one tensor, dropping non-divisible assigns."""
        plan = ctx.plan
        mesh = ctx.mesh
        spec = list(plan.sharding_spec(t.logical_axes))
        for i, (dim, assign) in enumerate(zip(t.shape, spec)):
            if assign is None:
                continue
            names = (assign,) if isinstance(assign, str) else tuple(assign)
            size = math.prod(mesh.axis_size(n) for n in names)
            if dim % size != 0:
                spec[i] = None
                self.record(
                    ctx, t.name,
                    f"dim{i}={dim} not divisible by {names}({size}) -> unsharded",
                    "divisibility repair",
                )
        # a mesh axis may appear only once per tensor
        seen = set()
        for i, assign in enumerate(spec):
            if assign is None:
                continue
            names = (assign,) if isinstance(assign, str) else tuple(assign)
            keep = tuple(n for n in names if n not in seen)
            seen.update(keep)
            spec[i] = (keep[0] if len(keep) == 1 else (keep or None) and keep) \
                if keep else None
        return tuple(spec)

    def _persistent_bytes_per_dev(self, ctx: PassContext) -> int:
        total = 0
        for t in ctx.ir.by_role(Role.PARAM, Role.EXPERT_PARAM, Role.OPT_STATE):
            if t.annotations.get("folded"):
                continue
            spec = ctx.plan.placements[t.name].spec
            total += t.nbytes // _spec_factor(spec, ctx.mesh)
        return total

    def _enable_fsdp(self, ctx: PassContext) -> None:
        """Shard params' embed dim (and flat opt state) over the data axis.

        Feature-dim FSDP (not layer-dim) so ``lax.scan`` over layers sees a
        uniform per-iteration all-gather that XLA can software-pipeline.
        """
        plan = ctx.plan
        mesh = ctx.mesh
        dsize = mesh.axis_size("data")
        dp_axes = ("pod", "data") if "pod" in mesh.axes else ("data",)
        plan.axis_rules["embed"] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
        plan.axis_rules["flat_params"] = dp_axes + ("model",)
        for t in ctx.ir.by_role(Role.PARAM, Role.EXPERT_PARAM, Role.OPT_STATE):
            spec = list(plan.placements[t.name].spec)
            used = {n for s in spec if s is not None
                    for n in ((s,) if isinstance(s, str) else s)}
            if "data" in used:
                continue
            for i, (dim, ax) in enumerate(zip(t.shape, t.logical_axes)):
                if ax not in ("embed", "flat_params"):
                    continue
                # prepend the DP axes to whatever already shards this dim
                existing = spec[i]
                names = dp_axes + (
                    () if existing is None
                    else ((existing,) if isinstance(existing, str)
                          else tuple(existing)))
                size = math.prod(mesh.axis_size(n) for n in names)
                if dim % size == 0:
                    spec[i] = names[0] if len(names) == 1 else names
                    break
            plan.placements[t.name].spec = tuple(spec)
            plan.placements[t.name].decided_by.append(self.name + ":fsdp")

    def _shard_cache(self, ctx: PassContext, t: TensorDecl, budget: float) -> None:
        """KV caches must also fit; spill to seq-dim sharding if needed.

        When kv_heads isn't divisible by the model axis (GQA kv=8 on a
        16-wide TP axis) the head dim stays unsharded and the *sequence*
        dim takes the model axis instead — decode attention then reduces
        over a sharded seq axis (flash-decode semantics via psum).
        """
        plan, mesh = ctx.plan, ctx.mesh
        spec = list(plan.placements[t.name].spec)
        used = {n for s in spec if s is not None
                for n in ((s,) if isinstance(s, str) else s)}
        per_dev = t.nbytes // _spec_factor(tuple(spec), mesh)
        if "model" not in used and "model" in mesh.axes:
            # shard_map flash-decode owns its append -> seq sharding is
            # best (local write + 3-term combine); the XLA-automatic path
            # prefers head_dim (local append, score-tensor psum) because a
            # runtime-offset update on a sharded seq dim becomes a gather
            impl = ctx.options.get("decode_impl", "shard_map_flash")
            ctx.plan.estimates["decode_impl"] = impl
            order = ("seq_kv", "head_dim") if impl == "shard_map_flash" \
                else ("head_dim", "seq_kv")
            for want in order:
                for i, ax in enumerate(t.logical_axes):
                    if ax == want and t.shape[i] % mesh.axis_size("model") == 0:
                        spec[i] = "model"
                        plan.placements[t.name].spec = tuple(spec)
                        plan.placements[t.name].decided_by.append(
                            self.name + ":cache")
                        self.record(
                            ctx, t.name, f"{want} -> model",
                            f"kv_heads not shardable by model axis; cache was "
                            f"{per_dev/2**30:.2f} GiB/chip — shard {want} "
                            "instead (flash-decode reduction)",
                        )
                        return


def _spec_factor(spec: Tuple, mesh: MeshModel) -> int:
    f = 1
    for s in spec:
        if s is None:
            continue
        names = (s,) if isinstance(s, str) else tuple(s)
        for n in names:
            f *= mesh.axis_size(n)
    return f
