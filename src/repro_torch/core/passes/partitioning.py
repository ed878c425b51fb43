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

    def _decode(self, ctx: PassContext, budget: int) -> None:
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

    def _ssd(self, ctx: PassContext, budget: int) -> None:
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

    def _matmul(self, ctx: PassContext, budget: int) -> None:
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
