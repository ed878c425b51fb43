"""Local-partitioning pass (paper §4, fourth level).

Paper: "determines the multi-bank PLM architecture, also sharing physical
memories for data with disjoint lifetimes."

TPU re-targeting: the PLM is VMEM, banks are pipeline buffers, ports are
per-grid-step tiles.  For every kernel-eligible op this pass derives the
Pallas BlockSpec tile shapes under the VMEM budget with double buffering,
MXU-aligned.  The kernels in :mod:`repro_torch.kernels` read these
:class:`~repro_torch.core.plan.BlockPlan` entries — kernel code never chooses
its own tiles (the paper's separation: the template is configured by the
compiler, the datapath just uses it).

"Sharing physical memories for data with disjoint lifetimes" maps to
buffer donation (input/output aliasing), decided here and applied by the
lowering pass.
"""

from __future__ import annotations

from repro_torch.core.costmodel import attention_tile_bytes, matmul_tile_bytes
from repro_torch.core.ir import OpKind
from repro_torch.core.plan import BlockPlan
from repro_torch.core.passes import Pass, PassContext

#: targets whose kernels (flash_attention, decode_attention, ssd_scan,
#: tiled_matmul) are the hand-written CUDA ones
CUDA_TARGETS = ("h100-sxm",)


def _align_down(n: int, q: int) -> int:
    return max(q, (n // q) * q)


class LocalPartitioningPass(Pass):
    name = "local_partitioning"

    vmem_budget_frac: float = 0.75

    def run(self, ctx: PassContext) -> None:
        tgt = ctx.target
        budget = int(self.vmem_budget_frac * tgt.vmem_bytes)
        arch, mesh = ctx.arch, ctx.mesh
        kinds = {op.kind for op in ctx.ir.ops}

        if OpKind.ATTENTION in kinds:
            self._attention(ctx, budget)
        if OpKind.ATTENTION_DECODE in kinds:
            self._decode(ctx, budget)
        if OpKind.SSD_SCAN in kinds:
            self._ssd(ctx, budget)
        self._matmul(ctx, budget)

        # disjoint-lifetime sharing -> donation set
        ctx.plan.comm.donate_state = True
        self.record(ctx, "buffer_sharing", "donate params/opt/cache buffers",
                    "step N+1 state reuses step N's physical pages "
                    "(disjoint lifetimes across the step boundary)")

    # ------------------------------------------------------------------
    def _attention(self, ctx: PassContext, budget: int) -> None:
        if ctx.target.name in CUDA_TARGETS:
            self._attention_cuda(ctx, budget)
            return
        arch, mesh = ctx.arch, ctx.mesh
        hd = arch.hd
        seq = ctx.shape.seq_len
        # start from the biggest MXU-aligned q tile and shrink to fit.
        # Causal workloads get SQUARE tiles: the kernel's packed-causal
        # grid (which skips the above-diagonal kv blocks, ~2x fewer
        # steps at long S) only engages when block_q == block_kv.
        if arch.causal:
            block_q = block_kv = 512
            while attention_tile_bytes(block_q, block_kv, hd) * 2 > budget \
                    and block_q > 128:
                block_q //= 2
                block_kv //= 2
        else:
            block_q, block_kv = 512, 1024
            while attention_tile_bytes(block_q, block_kv, hd) * 2 > budget:
                if block_kv > 128:
                    block_kv //= 2
                elif block_q > 128:
                    block_q //= 2
                else:
                    break
        block_q = min(block_q, _align_down(seq, 128))
        block_kv = min(block_kv, _align_down(seq, 128))
        vm = attention_tile_bytes(block_q, block_kv, hd)
        packed = arch.causal and block_q == block_kv
        bp = BlockPlan(
            kernel="flash_attention",
            blocks={"block_q": block_q, "block_kv": block_kv, "head_dim": hd},
            n_buffers=2,
            vmem_bytes=vm,
            grid_note=("packed-causal grid=(heads/TP, ceil(n/2), n+1), "
                       f"n=seq/{block_q}; above-diagonal kv blocks pruned"
                       if packed else
                       f"grid=(heads/TP, seq/{block_q}); kv streamed in "
                       f"{block_kv}-row banks, 2-deep pipeline"),
        )
        ctx.plan.partitions[bp.kernel] = bp
        ctx.template["plm.attention"].refine(
            self.name, **bp.blocks, n_buffers=2, vmem_bytes=vm)
        self.record(ctx, "flash_attention",
                    f"block_q={block_q} block_kv={block_kv}"
                    + (" (square: packed-causal grid)" if packed else ""),
                    f"2-bank working set {2*vm/2**20:.1f} MiB <= "
                    f"budget {budget/2**20:.0f} MiB; tiles MXU-aligned")

    def _attention_cuda(self, ctx: PassContext, budget: int) -> None:
        """On a CUDA card the tile is one the flash kernel is built for.
        Its CTA holds ``rows = block_q * G`` query rows (``block_q``
        positions times the ``G`` query heads of one kv head) and streams
        ``block_kv`` K/V rows a tile: the most rows, then the widest kv
        tile, whose shared memory (Q plus the K/V ring) fits the budget.
        The rows hold ``block_q = rows // G`` whole positions, the
        kernel's own rule (G = 7: 18 positions in 128 rows, 2 of them
        pad; G = 5: 25 positions, 3 pad).  S, P and the O accumulator
        live in registers, so only those tiles are charged, at the arch's
        head_dim.  An arch the kernel is not built for (a head_dim
        outside ``fa.HEAD_DIMS``, or a GQA group outside ``fa.GROUPS``)
        gets no tile, and the kernel's wrapper raises on it at launch.
        ``G`` is the group a rank's flash call runs at: on a mesh whose
        model axis splits the heads but not the kv heads, a rank holds a
        piece of a group or a run of groups
        (:func:`repro_torch.models.tp.flash_group`; llama4-maverick's 48
        / 8 padded heads on a 16-wide axis: 3 of a group of 6)."""
        from repro_torch.dist.sharding import _names
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.models import tp

        arch, est = ctx.arch, ctx.plan.estimates
        H = int(est.get("heads_padded", arch.n_heads))
        K = int(est.get("kv_heads_padded", arch.n_kv_heads))
        G = tp.rank_group(
            H, K, ctx.mesh.axis_size("model")
            if "model" in ctx.mesh.axes else 1,
            "model" in _names(ctx.plan.axis_rules.get("heads")))
        fits = [t for t in fa.KERNEL_TILES
                if fa.smem_bytes(*t, arch.hd) <= budget]
        if arch.hd not in fa.HEAD_DIMS or G not in fa.GROUPS or not fits:
            self.record(ctx, "flash_attention", "no kernel tile",
                        f"the CUDA kernel is built for head_dim in "
                        f"{fa.HEAD_DIMS} and GQA groups {fa.GROUPS}; this "
                        f"arch has head_dim {arch.hd} and G={G}")
            return
        rows, block_kv = max(fits)
        block_q = rows // G
        # a group that divides no tile leaves pad rows (G = 7: 126 of 128)
        held = "=" if block_q * G == rows else "hold"
        smem = fa.smem_bytes(rows, block_kv, arch.hd)
        bp = BlockPlan(
            kernel="flash_attention",
            blocks={"block_q": block_q, "block_kv": block_kv,
                    "head_dim": arch.hd},
            n_buffers=fa.STAGES,
            vmem_bytes=smem,
            grid_note=(f"grid=(batch x kv_heads, ceil(seq/{block_q})) CTAs, "
                       f"longest q tiles first; {rows} query rows {held} "
                       f"{block_q} positions x G={G}; K/V in a "
                       f"{fa.STAGES}-stage TMA ring of {block_kv}-row tiles; "
                       "S, P and the O accumulator in registers"),
        )
        ctx.plan.partitions[bp.kernel] = bp
        ctx.template["plm.attention"].refine(
            self.name, **bp.blocks, n_buffers=fa.STAGES, vmem_bytes=smem)
        self.record(ctx, "flash_attention",
                    f"block_q={block_q} block_kv={block_kv}",
                    f"{rows} query rows {held} {block_q} x G={G}; Q plus a "
                    f"{fa.STAGES}-stage K/V TMA ring, {smem} B of shared "
                    f"memory <= budget {budget} B; S, P and the O "
                    "accumulator in registers; a tile the CUDA kernel is "
                    "built for")

    def _decode(self, ctx: PassContext, budget: int) -> None:
        if ctx.target.name in CUDA_TARGETS:
            self._decode_cuda(ctx, budget)
            return
        arch = ctx.arch
        hd = arch.hd
        # decode reads the whole cache once: wide kv tiles amortize the
        # grid overhead; q fits entirely (1 token x heads)
        block_kv = 2048
        q_bytes = arch.n_heads * hd * 2
        while (block_kv * hd * 2 * 2 + q_bytes) * 2 > budget and block_kv > 256:
            block_kv //= 2
        bp = BlockPlan(
            kernel="decode_attention",
            blocks={"block_kv": block_kv, "head_dim": hd},
            n_buffers=2,
            vmem_bytes=block_kv * hd * 2 * 2 + q_bytes,
            grid_note="grid=(kv_heads, cache_len/block_kv); online softmax "
                      "combine across grid steps",
        )
        ctx.plan.partitions[bp.kernel] = bp
        ctx.template["cache.kv"].refine(self.name, block_kv=block_kv)
        self.record(ctx, "decode_attention", f"block_kv={block_kv}",
                    "stream the session cache through VMEM in 2 banks")

    def _decode_cuda(self, ctx: PassContext, budget: int) -> None:
        """On a CUDA card ``block_kv`` is the split-KV kernel's tile: each
        CTA's split of the cache is a whole number of tiles.  The widest
        tile whose splits still give the grid :data:`SPLIT_CTAS` CTAs at
        the plan's batch, kv heads and cache length, else the narrowest.
        The shared memory charged is the kernel's: the warps' cp.async K/V
        rings, which do not depend on the tile.  An arch the kernel is not
        built for (a (GQA group, head_dim) pair without an instance,
        ``dec.takes_group``) gets no tile and a logged reason."""
        from repro_torch.kernels import decode_attention as dec

        arch, est = ctx.arch, ctx.plan.estimates
        K = int(est.get("kv_heads_padded", arch.n_kv_heads))
        G = int(est.get("heads_padded", arch.n_heads)) // K
        smem = dec.smem_bytes(G, dec.DEFAULT_BLOCK_KV, arch.hd)
        if not dec.takes_group(G, arch.hd) or smem > budget:
            self.record(ctx, "decode_attention", "no kernel tile",
                        f"the CUDA kernel is built for (GQA group, head_dim) "
                        f"in {dec.INSTANCES}; this arch has head_dim "
                        f"{arch.hd} and G={G}")
            return
        B, cap = ctx.shape.global_batch, ctx.shape.seq_len

        def ctas(tile):
            return B * K * dec.decode_split(B, K, cap, tile)[0]

        full = [t for t in dec.KERNEL_TILES if ctas(t) >= dec.SPLIT_CTAS]
        block_kv = max(full) if full else min(dec.KERNEL_TILES)
        splits, rows = dec.decode_split(B, K, cap, block_kv)
        bp = BlockPlan(
            kernel="decode_attention",
            blocks={"block_kv": block_kv, "head_dim": arch.hd},
            n_buffers=dec.STAGES,
            vmem_bytes=smem,
            grid_note=(f"grid=(batch x kv_heads) x {splits} splits of "
                       f"{rows} rows = {ctas(block_kv)} CTAs at batch {B}; "
                       f"each warp a {dec.STAGES}-stage cp.async K/V ring; "
                       "the last split to finish merges in the same launch"),
        )
        ctx.plan.partitions[bp.kernel] = bp
        ctx.template["cache.kv"].refine(self.name, block_kv=block_kv)
        self.record(ctx, "decode_attention", f"block_kv={block_kv}",
                    f"{splits} splits of {rows} rows give {ctas(block_kv)} "
                    f"CTAs (>= {dec.SPLIT_CTAS} where the cache allows); "
                    f"{dec.STAGES}-stage cp.async K/V rings, {smem} B of "
                    f"shared memory <= budget {budget} B; a tile the CUDA "
                    "kernel is built for")

    def _ssd(self, ctx: PassContext, budget: int) -> None:
        if ctx.target.name in CUDA_TARGETS:
            self._ssd_cuda(ctx, budget)
            return
        arch = ctx.arch
        chunk = 256
        hd, st = arch.ssm_head_dim, arch.ssm_state
        # working set per head-block: x(chunk,hd) B/C(chunk,st) state(hd,st)
        heads_block = 8
        per = (chunk * hd + 2 * chunk * st + hd * st * 2) * 4 * heads_block
        while per * 2 > budget and heads_block > 1:
            heads_block //= 2
            per //= 2
        bp = BlockPlan(
            kernel="ssd_scan",
            blocks={"chunk": chunk, "heads_block": heads_block,
                    "head_dim": hd, "state": st},
            n_buffers=2,
            vmem_bytes=per,
            grid_note="grid=(heads/heads_block, seq/chunk); carry = (hd,state) "
                      "running state in VMEM across chunk steps",
        )
        ctx.plan.partitions[bp.kernel] = bp
        ctx.template["plm.scan"].refine(self.name, **bp.blocks)
        self.record(ctx, "ssd_scan", f"chunk={chunk} heads_block={heads_block}",
                    "SSD duality: intra-chunk matmul (MXU) + inter-chunk "
                    "recurrence (VPU) with state resident in VMEM")

    def _ssd_cuda(self, ctx: PassContext, budget: int) -> None:
        """On a CUDA card the chunk is :func:`ssd_scan.cuda_chunk`'s, where
        the three-pass kernel's shared memory (C, two cp.async B/x stages,
        the score tile) fits the budget.  ``heads_block`` stays 1:
        the kernel validates it but its grid gives every (batch, head,
        chunk) its own CTAs.  Widths the kernel is not built for get no
        tile and a logged reason."""
        from repro_torch.kernels import ssd_scan as ssd

        arch = ctx.arch
        P, N = arch.ssm_head_dim, arch.ssm_state
        smem, chunk = ssd.smem_bytes(P, N), ssd.cuda_chunk(P, N)
        if chunk is None or smem > budget:
            self.record(ctx, "ssd_scan", "no kernel tile",
                        f"the CUDA kernel is built for (head_dim, state) in "
                        f"{ssd.KERNEL_WIDTHS}; this arch has ({P}, {N})")
            return
        bp = BlockPlan(
            kernel="ssd_scan",
            blocks={"chunk": chunk, "heads_block": 1, "head_dim": P,
                    "state": N},
            n_buffers=2,
            vmem_bytes=smem,
            grid_note=(f"three launches: chunk states (batch x heads x "
                       f"chunks CTAs), state passing over the chunks, chunk "
                       f"scan (x {chunk // 64} query tiles); B/x tiles on two "
                       "cp.async stages; fp32 states in a workspace"),
        )
        ctx.plan.partitions[bp.kernel] = bp
        ctx.template["plm.scan"].refine(self.name, **bp.blocks)
        self.record(ctx, "ssd_scan", f"chunk={chunk} heads_block=1",
                    f"chunk-parallel SSD: each (batch, head, chunk) on its "
                    f"own CTAs, the carried state passed by a second launch; "
                    f"{smem} B of shared memory <= budget {budget} B; "
                    "heads_block is validated but unused by the CUDA grid")

    def _matmul(self, ctx: PassContext, budget: int) -> None:
        if ctx.target.name in CUDA_TARGETS:
            self._matmul_cuda(ctx, budget)
            return
        bm, bk, bn = 512, 512, 512
        while matmul_tile_bytes(bm, bk, bn) * 2 > budget and bm > 128:
            bm //= 2
            bn //= 2
        bp = BlockPlan(
            kernel="tiled_matmul",
            blocks={"bm": bm, "bk": bk, "bn": bn},
            n_buffers=2,
            vmem_bytes=matmul_tile_bytes(bm, bk, bn),
            grid_note="grid=(M/bm, N/bn, K/bk); fp32 accumulator tile",
        )
        ctx.plan.partitions[bp.kernel] = bp
        ctx.template["plm.matmul"].refine(self.name, **bp.blocks)
        self.record(ctx, "tiled_matmul", f"{bm}x{bk}x{bn}",
                    f"2-bank {2*bp.vmem_bytes/2**20:.1f} MiB working set; "
                    "K-inner grid for accumulator reuse")

    def _matmul_cuda(self, ctx: PassContext, budget: int) -> None:
        """On a CUDA card the tile is one the kernel is built for: the
        largest ``bm x bn`` (then ``bk``) whose bf16 TMA ring fits the
        shared-memory budget.  The fp32 accumulator lives in registers,
        not in shared memory, so it is not charged here."""
        from repro_torch.kernels import tiled_matmul as mm

        fits = [t for t in mm.KERNEL_TILES if mm.smem_bytes(*t) <= budget]
        bm, bk, bn = max(fits, key=lambda t: (t[0] * t[2], t[1]))
        smem = mm.smem_bytes(bm, bk, bn)
        bp = BlockPlan(
            kernel="tiled_matmul",
            blocks={"bm": bm, "bk": bk, "bn": bn},
            n_buffers=mm.STAGES,
            vmem_bytes=smem,
            grid_note=(f"grid=ceil(M/{bm}) x ceil(N/{bn}) CTAs, K loop inside "
                       f"each CTA; a {mm.STAGES}-stage TMA ring of bf16 "
                       "operand tiles feeding wgmma (deeper at M <= 64); "
                       "fp32 accumulator in registers"),
        )
        ctx.plan.partitions[bp.kernel] = bp
        ctx.template["plm.matmul"].refine(self.name, **bp.blocks)
        self.record(ctx, "tiled_matmul", f"{bm}x{bk}x{bn}",
                    f"{mm.STAGES}-stage bf16 TMA ring, {smem} B of shared "
                    f"memory <= budget {budget} B; fp32 accumulator in "
                    "registers, not shared memory; a tile the CUDA kernel is "
                    "built for")
