"""Napkin-math cost model used by the passes.

The paper's passes size memories and configure prefetchers from static
analysis of the IR; this module is that analysis.  Everything here is a
*model* (no execution): bytes per chip under a sharding, minimum HBM
traffic of a step, collective volumes for a given schedule, VMEM fit of a
tile configuration.  The roofline report in
:mod:`repro_torch.analysis.roofline` cross-checks these numbers against the
compiled artifact (`cost_analysis()` + HLO collective parse).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

from repro_torch.core.ir import ProgramIR, Role, TensorDecl
from repro_torch.hw.tpu import TpuTarget
from repro_torch.optim.adamw import CHUNK as OPT_CHUNK


@dataclasses.dataclass(frozen=True)
class MeshModel:
    """Static view of the device mesh (no framework imports)."""

    axes: Tuple[str, ...]
    shape: Tuple[int, ...]

    @property
    def n_devices(self) -> int:
        return int(math.prod(self.shape))

    def axis_size(self, name: Optional[str]) -> int:
        if name is None:
            return 1
        return self.shape[self.axes.index(name)]


def shard_factor(
    decl: TensorDecl,
    axis_map: Mapping[str, Optional[str]],
    mesh: MeshModel,
) -> int:
    """Total number of shards a tensor is split into under an axis mapping."""
    f = 1
    seen = set()
    for logical in decl.logical_axes:
        if logical is None:
            continue
        mesh_axes = axis_map.get(logical)
        if mesh_axes is None:
            continue
        names = (mesh_axes,) if isinstance(mesh_axes, str) else tuple(mesh_axes)
        for m in names:
            if m in seen:  # a mesh axis can only shard one dim
                continue
            seen.add(m)
            f *= mesh.axis_size(m)
    return f


def spec_shards(spec: Sequence, mesh: MeshModel, dims=None) -> int:
    """How many pieces a placement ``spec`` cuts a tensor into (over its
    dims ``dims`` only, where given)."""
    f = 1
    for i, s in enumerate(spec):
        if s is None or (dims is not None and i not in dims):
            continue
        for n in ((s,) if isinstance(s, str) else tuple(s)):
            if n in mesh.axes:
                f *= mesh.axis_size(n)
    return f


def bytes_per_device(
    decl: TensorDecl,
    axis_map: Mapping[str, Optional[str]],
    mesh: MeshModel,
) -> int:
    return decl.nbytes // shard_factor(decl, axis_map, mesh)


def program_bytes_per_device(
    ir: ProgramIR,
    axis_map: Mapping[str, Optional[str]],
    mesh: MeshModel,
    roles: Sequence[Role] = (Role.PARAM, Role.EXPERT_PARAM, Role.OPT_STATE),
) -> int:
    return sum(
        bytes_per_device(t, axis_map, mesh) for t in ir.by_role(*roles)
    )


# ---------------------------------------------------------------------------
# Collective volume models (communication pass + roofline cross-check)
# ---------------------------------------------------------------------------

def allreduce_bytes(nbytes: int, n: int) -> float:
    """Per-device bytes moved by a ring all-reduce of an nbytes buffer."""
    if n <= 1:
        return 0.0
    return 2.0 * nbytes * (n - 1) / n


def reduce_scatter_bytes(nbytes: int, n: int) -> float:
    if n <= 1:
        return 0.0
    return nbytes * (n - 1) / n


def allgather_bytes(nbytes: int, n: int) -> float:
    """nbytes = size of the *gathered* (full) buffer."""
    if n <= 1:
        return 0.0
    return nbytes * (n - 1) / n


def all_to_all_bytes(nbytes_local: int, n: int) -> float:
    if n <= 1:
        return 0.0
    return nbytes_local * (n - 1) / n


def compressed_ratio(bits: int = 8, dtype_bytes: int = 2,
                     block: int = 128) -> float:
    """Wire-volume ratio of block-quantized vs raw gradient collectives.

    int8 codes plus one f32 scale per ``block`` values: for bf16 grads
    (the IR's gradient dtype) int8 halves the volume; for f32 it is ~4x.
    Matches :func:`repro_torch.dist.collectives.quantize_int8`'s layout.
    """
    return (bits / 8.0 + 4.0 / block) / dtype_bytes


@dataclasses.dataclass
class StepCost:
    """Three-term roofline estimate for one step on one device."""

    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def bound(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_overlap(self) -> float:
        """Perfect-overlap model: max of the three engines."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def step_time_serial(self) -> float:
        return self.compute_s + self.memory_s + self.collective_s


def estimate_step(
    ir: ProgramIR,
    axis_map: Mapping[str, Optional[str]],
    mesh: MeshModel,
    target: TpuTarget,
    training: bool = True,
    grad_schedule: str = "reduce_scatter",
    dp_axes: Sequence[str] = ("data",),
    grad_bits: Optional[int] = None,
) -> StepCost:
    """Static three-term estimate of one train/serve step.

    Used by the communication pass to choose between candidate schedules
    *before* lowering (the paper's passes make decisions from the IR, not
    from profiles).
    """
    n_dev = mesh.n_devices
    fwd_flops = ir.total_flops()
    flops = fwd_flops * (3.0 if training else 1.0)  # fwd + 2x bwd
    compute_s = flops / n_dev / target.peak_bf16_flops

    # Minimum HBM traffic: every persistent byte read once, activations
    # read+written once (very coarse; the compiled artifact refines this).
    persist = program_bytes_per_device(ir, axis_map, mesh)
    act = sum(
        bytes_per_device(t, axis_map, mesh)
        for t in ir.by_role(Role.ACTIVATION, Role.INPUT, Role.KV_CACHE,
                            Role.SSM_STATE)
    )
    mem_bytes = persist * (3 if training else 1) + 2 * act
    memory_s = mem_bytes / target.hbm_bw

    # Collectives: data-parallel grad reduction over dp axes (training),
    # TP activation collectives folded into a fudge on activations.
    coll_bytes = 0.0
    if training:
        grad_bytes = sum(
            bytes_per_device(t, axis_map, mesh)
            for t in ir.by_role(Role.PARAM, Role.EXPERT_PARAM)
        )
        dp = 1
        for a in dp_axes:
            if a in mesh.axes:
                dp *= mesh.axis_size(a)
        if grad_schedule == "all_reduce":
            coll_bytes += allreduce_bytes(grad_bytes, dp)
        else:
            coll_bytes += reduce_scatter_bytes(grad_bytes, dp) + allgather_bytes(
                grad_bytes, dp
            )
        if grad_bits:  # int8(+scales) compression of the grad reduction
            coll_bytes *= compressed_ratio(grad_bits)
    collective_s = coll_bytes / target.ici_link_bw

    return StepCost(compute_s=compute_s, memory_s=memory_s,
                    collective_s=collective_s)


# ---------------------------------------------------------------------------
# KV residency model (data-organization pass, serving shapes)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KVBlockGeometry:
    """Plan-chosen block-pool geometry for the paged KV template.

    The serving KV cache is the template's biggest memory consumer; the
    data-organization pass sizes it like any other memory: a block pool
    of ``n_blocks`` blocks of ``block_len`` cache rows each, shared by
    all layers (one block id indexes every layer's pool), with a per-slot
    block table mapping sequence positions to blocks.
    """

    block_len: int                 # cache rows per block
    blocks_per_seq: int            # ceil(seq_len / block_len)
    n_blocks: int                  # pool capacity (global, all sub-pools)
    dense_bytes: int               # B x seq_len stripe footprint (k+v, all layers)
    paged_bytes: int               # pool footprint at this capacity
    data_degree: int = 1           # sub-pools the block dim splits into
    model_degree: int = 1          # model shards per sub-pool
    admission: str = "reserve"     # "reserve" (worst-case up front) | "grant"
    headroom_blocks: int = 0       # per-sub-pool free blocks past one max seq
    prefix_reuse: str = "on"       # cross-request prefix KV sharing
    # assumed shared-prefix fraction of serving traffic the reuse model
    # is evaluated at (system prompts + session history dominate
    # production feeds; 0.5 is the model's deliberately conservative
    # default — the engine reports the *measured* rate at runtime)
    assumed_hit_rate: float = 0.5

    @property
    def table_cols(self) -> int:
        return self.blocks_per_seq

    @property
    def sub_pool_blocks(self) -> int:
        """Blocks each data shard's sub-pool owns (2-D pool sharding:
        the block dim is split data-major into ``data_degree`` sub-pools,
        each serving the batch slots that data shard hosts)."""
        return self.n_blocks // max(1, self.data_degree)

    def prefix_capacity_factor(self, residents: int,
                               hit_rate: Optional[float] = None) -> float:
        """Effective capacity multiplier of prefix sharing: with
        ``residents`` concurrent sequences each sharing a ``hit_rate``
        fraction of their blocks, the shared run is pinned once instead
        of ``residents`` times — ``r / (h + r*(1-h))``, approaching
        ``1/(1-h)`` as residency grows.  1.0 when reuse is off."""
        if self.prefix_reuse != "on" or residents <= 1:
            return 1.0
        h = self.assumed_hit_rate if hit_rate is None else hit_rate
        h = min(max(h, 0.0), 1.0)
        return residents / (h + residents * (1.0 - h))

    def prefix_hit_headroom(self, residents: int,
                            hit_rate: Optional[float] = None) -> int:
        """Expected per-sub-pool blocks *freed* by sharing at the
        assumed hit rate: every resident past the first aliases the
        shared-prefix blocks instead of pinning private copies —
        ``(residents - 1) * floor(h * blocks_per_seq)``, capped at the
        sub-pool.  This is headroom the admission ladder gets back
        before it ever migrates or preempts."""
        if self.prefix_reuse != "on" or residents <= 1:
            return 0
        h = self.assumed_hit_rate if hit_rate is None else hit_rate
        shared = int(min(max(h, 0.0), 1.0) * self.blocks_per_seq)
        return min((residents - 1) * shared, self.sub_pool_blocks)


def kv_block_len(seq_len: int, min_block: int = 16,
                 max_block: int = 512) -> int:
    """Block length for a ``seq_len``-deep cache: the largest power of
    two in [min_block, max_block] that still leaves >= 8 blocks per
    sequence (reclamation granularity), floored at ``min_block``.

    Powers of two keep the in-block offset a cheap mask and the block
    row count a multiple of the TPU sublane tile.
    """
    bl = min_block
    while bl * 2 <= max_block and bl * 2 * 8 <= seq_len:
        bl *= 2
    return bl


def kv_block_geometry(
    seq_len: int,
    batch: int,
    n_layers: int,
    kv_heads: int,
    head_dim: int,
    dtype_bytes: int = 2,
    budget_bytes: Optional[float] = None,
    data_shards: int = 1,
    align: int = 1,
) -> KVBlockGeometry:
    """Choose the paged-pool geometry for a decode workload.

    2-D pool sharding: the block dim is split data-major into
    ``data_shards`` sub-pools (one per data shard, serving the batch
    slots that shard hosts) and each sub-pool shards over the ``align``
    model-axis degree — so unlike the pre-2-D pool the capacity
    *shards* over the data axis instead of replicating there.
    ``data_shards`` still divides the worst-case capacity: the pool
    covers ``1/data_shards`` of the all-slots-at-max footprint, which
    is the reclamation bet — churn keeps the sub-pools fed — and what
    puts per-chip paged bytes *below* the dense stripes it replaces.
    A ``budget_bytes`` cap (the *global* HBM left for the cache across
    every chip the pool spans) shrinks it further — never below one
    full sequence per sub-pool, the minimum each data shard's slots
    need to make progress.  Every sub-pool is rounded to an ``align``
    multiple: a non-divisible sub-pool would silently *replicate* per
    model shard instead, blowing the very budget this sizing validated.

    The geometry also fixes the **admission mode** the serving engine
    must run: when the pool covers every slot's worst case
    (``n_blocks >= batch * blocks_per_seq``) admission can safely
    ``reserve`` the full budget up front — grants never fail, no
    preemption machinery ever engages.  When the pool is *smaller* than
    worst case (the 1/data_shards reclamation bet, or a budget cap),
    worst-case reservation would refuse requests the pool can in fact
    serve — so admission must be ``grant`` (grow-on-demand per block
    boundary) with preemption as the backstop.  ``headroom_blocks``
    records the per-sub-pool slack past one maximum sequence — the
    cost model's estimate of how much concurrent growth a sub-pool
    absorbs before the engine starts walking the migrate/preempt
    ladder (0 means any second resident sequence rides entirely on
    reclamation).
    """
    bl = kv_block_len(seq_len)
    per_seq = -(-seq_len // bl)
    want = max(1, batch) * per_seq
    block_bytes = 2 * n_layers * bl * kv_heads * head_dim * dtype_bytes
    d = max(1, data_shards)
    n = max(per_seq, want // d)
    if budget_bytes is not None and block_bytes > 0:
        cap = int(budget_bytes // block_bytes)
        n = max(per_seq, min(n, cap))
    # per-sub-pool floor + alignment: each data shard owns n/d blocks,
    # shardable by the model axis and >= one full sequence (rounding the
    # floor UP when needed — slightly over budget beats a pool that
    # silently replicates per model shard)
    sub = n // d
    if align > 1:
        sub = align * (sub // align)
    sub = max(sub, align * (-(-per_seq // align)) if align > 1 else per_seq)
    n = d * sub
    return KVBlockGeometry(
        admission="reserve" if n >= want else "grant",
        headroom_blocks=max(0, sub - per_seq),
        block_len=bl,
        blocks_per_seq=per_seq,
        n_blocks=n,
        dense_bytes=2 * n_layers * max(1, batch) * seq_len
        * kv_heads * head_dim * dtype_bytes,
        paged_bytes=n * block_bytes,
        data_degree=d,
        model_degree=max(1, align),
    )


@dataclasses.dataclass(frozen=True)
class KVTierSplit:
    """Two-tier residency split for the paged KV pool.

    The paper's template is *multi-level*: a specialized memory is not
    one pool but a hierarchy sized per tier.  For the serving KV cache
    the tiers are the HBM block pool (the :class:`KVBlockGeometry` the
    pass already sized from HBM headroom) plus a **host-DRAM spill
    pool** behind it, sized here from the host pin budget.  Cold blocks
    (parked sessions, evicted prefix-trie tails) move to the host tier
    and stream back over PCIe ahead of their decode tick.

    ``prefetch_feasible`` is the stream-back-latency check: a decoding
    slot crosses a block boundary once every ``block_len`` ticks, so a
    one-block-lookahead prefetch hides the PCIe transfer exactly when
    one block streams in less than ``lookahead_ticks`` decode ticks.
    Infeasible does not disable the tier — parked sessions still resume
    from host — it means a resume may stall a tick on the transfer.
    """

    hbm_blocks: int                # HBM pool capacity (== geometry n_blocks)
    host_blocks: int               # host spill pool capacity (0 = hbm-only)
    block_bytes: int               # one block, k+v, all layers
    pcie_bw: float                 # host<->HBM stream bandwidth (bytes/s)
    decode_tick_s: float           # modeled steady-state decode tick
    lookahead_ticks: int           # ticks between one slot's boundary crossings

    @property
    def stream_block_s(self) -> float:
        """PCIe time to move one block (k+v rows, every layer)."""
        if self.pcie_bw <= 0:
            return float("inf")
        return self.block_bytes / self.pcie_bw

    @property
    def prefetch_feasible(self) -> bool:
        return self.stream_block_s <= self.lookahead_ticks * self.decode_tick_s

    @property
    def host_bytes(self) -> int:
        return self.host_blocks * self.block_bytes

    @property
    def tier_name(self) -> str:
        return "hbm+host" if self.host_blocks else "hbm-only"


def kv_tier_split(
    geo: KVBlockGeometry,
    host_budget_bytes: float,
    pcie_bw: float,
    decode_tick_s: float,
    max_park_factor: int = 8,
) -> KVTierSplit:
    """Size the host-DRAM spill tier behind an already-sized HBM pool.

    ``geo`` carries the HBM side of the split (sized from HBM headroom
    by :func:`kv_block_geometry`); this sizes the host side from the
    pin budget (the host DRAM the deployment may pin for DMA), capped
    at ``max_park_factor`` times the HBM pool — parking depth beyond a
    few full pools buys nothing but pinned pages the OS cannot reclaim.
    A host pool too small to park even one full sequence is reported as
    0 (hbm-only): spilling a session you can never fully park only
    fragments the tier.
    """
    block_bytes = geo.paged_bytes // max(1, geo.n_blocks)
    host = 0
    if block_bytes > 0 and host_budget_bytes > 0:
        host = int(host_budget_bytes // block_bytes)
        host = min(host, max_park_factor * geo.n_blocks)
    if host < geo.blocks_per_seq:
        host = 0
    return KVTierSplit(
        hbm_blocks=geo.n_blocks,
        host_blocks=host,
        block_bytes=block_bytes,
        pcie_bw=pcie_bw,
        decode_tick_s=decode_tick_s,
        lookahead_ticks=geo.block_len,
    )


@dataclasses.dataclass(frozen=True)
class KVPrefillSplit:
    """Inline-vs-disaggregated prefill decision for the serve engine.

    The paper's flow specializes one memory template per *role*; prefill
    and decode are different roles with opposite profiles — prefill is a
    flops-bound burst over the whole prompt, decode a bandwidth-bound
    tick over one token.  Run inline, a worst-case prompt's prefill
    steals ``stall_ticks`` consecutive decode ticks from every other
    slot (head-of-line blocking).  Past a few ticks of stall the plan
    flips to ``disagg``: prefill moves to supervised worker processes
    that stream ``chunk_len``-sized pool-block-shaped KV chunks back to
    the decode engine (``serve/disagg.py``), and decode never waits.
    """

    prefill_flops: float           # worst-case full-prompt prefill, one chip
    peak_flops: float              # chip peak (bf16)
    decode_tick_s: float           # modeled steady-state decode tick
    chunk_len: int                 # disagg streaming granule (== block_len)
    threshold_ticks: float = 8.0   # stall tolerated before flipping

    @property
    def prefill_s(self) -> float:
        if self.peak_flops <= 0:
            return 0.0
        return self.prefill_flops / self.peak_flops

    @property
    def stall_ticks(self) -> float:
        """Decode ticks an inline worst-case prefill steals in one gulp."""
        if self.decode_tick_s <= 0:
            return 0.0
        return self.prefill_s / self.decode_tick_s

    @property
    def mode(self) -> str:
        return "disagg" if self.stall_ticks > self.threshold_ticks \
            else "inline"


def kv_prefill_split(
    seq_len: int,
    persistent_bytes: float,
    peak_flops: float,
    decode_tick_s: float,
    chunk_len: int,
    threshold_ticks: float = 8.0,
) -> KVPrefillSplit:
    """Decide inline vs disaggregated prefill from the interference model.

    The forward cost of one prefill token is ~2 flops per resident
    parameter; with bf16 params ``persistent_bytes`` *is* the per-chip
    flops/token (2 flops x bytes/2 params), so the worst-case prompt
    (the shape's full ``seq_len``) costs ``seq_len * persistent_bytes``
    flops on each chip — tensor parallelism scales both sides of the
    ratio identically.  Compare that burst against the decode tick the
    tier split already modeled: more than ``threshold_ticks`` ticks of
    head-of-line stall flips the plan to ``disagg`` with ``chunk_len``
    (the pool block length) as the streaming granule, so every shipped
    chunk is exactly one pool block.
    """
    return KVPrefillSplit(
        prefill_flops=float(seq_len) * max(0.0, persistent_bytes),
        peak_flops=peak_flops,
        decode_tick_s=decode_tick_s,
        chunk_len=chunk_len,
        threshold_ticks=threshold_ticks,
    )


# ---------------------------------------------------------------------------
# decode combine topology (communication pass)
# ---------------------------------------------------------------------------

#: legal values of ``comm.combine_topology`` (and the kernels' ``combine=``)
COMBINE_TOPOLOGIES = ("flat", "ring", "bidir")

#: flat < ring < bidir — the chosen topology's rank is monotone
#: nondecreasing in the model degree (the property tests pin this)
COMBINE_TOPOLOGY_RANK = {"flat": 0, "ring": 1, "bidir": 2}

#: calibrated crossover degrees.  These are thresholds, not derivations:
#: all three latency chains below are linear in n, and two lines cross
#: exactly once — a linear model alone can never produce the observed
#: flat -> ring -> bidir progression.  What the chains miss is that XLA
#: fuses the flat combine's three tiny collectives into one launch at
#: small n (so flat wins there despite the worse chain), while past
#: ~one ring's worth of hops the fused launch stops amortizing and the
#: explicit rings win on chain length.  The degrees encode where those
#: regimes flip on the reference ICI mesh.
COMBINE_RING_DEGREE = 8          # flat while model degree <= this
COMBINE_BIDIR_DEGREE = 16       # ring while model degree <= this


def choose_combine_topology(model_degree: int) -> str:
    """Pick the model-axis softmax-combine topology for a decode step.

    A degenerate model axis (degree <= 1) has no cross-shard combine at
    all — "flat" by definition, whatever the overrides say.  Otherwise
    the calibrated thresholds above apply.
    """
    n = int(model_degree)
    if n <= COMBINE_RING_DEGREE:
        return "flat"
    if n <= COMBINE_BIDIR_DEGREE:
        return "ring"
    return "bidir"


def combine_hops(model_degree: int, topology: str) -> int:
    """Latency-chain length (dependent neighbor hops) of one combine.

    * ``flat``  — pmax + two psums, each a 2(n-1)-hop ring all-reduce:
      ``6(n-1)`` chained hops before fusion.
    * ``ring``  — one packed (m, l, acc) all-gather around the ring:
      ``n-1`` hops.
    * ``bidir`` — the same gather split across both ring directions:
      ``ceil((n-1)/2)`` hops on the longer arm.

    Hop *count* is the narrative number the decision log reports; the
    crossovers themselves are the calibrated degrees above.
    """
    n = int(model_degree)
    if n <= 1:
        return 0
    if topology == "flat":
        return 6 * (n - 1)
    if topology == "ring":
        return n - 1
    if topology == "bidir":
        return (n - 1 + 1) // 2
    raise ValueError(f"unknown combine topology {topology!r}; "
                     f"expected one of {COMBINE_TOPOLOGIES}")


# ---------------------------------------------------------------------------
# VMEM tiling model (local partitioning pass)
# ---------------------------------------------------------------------------

def tile_bytes(shape: Sequence[int], dtype_bytes: int = 2) -> int:
    return int(math.prod(shape)) * dtype_bytes


def attention_tile_bytes(
    block_q: int, block_kv: int, head_dim: int, dtype_bytes: int = 2
) -> int:
    """VMEM working set of one flash-attention grid step (per head)."""
    q = block_q * head_dim
    k = block_kv * head_dim
    v = block_kv * head_dim
    s = block_q * block_kv          # scores tile (fp32) — count at 4B
    o = block_q * head_dim
    acc = block_q * (head_dim + 2)  # running max / denom
    return (q + k + v + o) * dtype_bytes + (s + acc) * 4


def matmul_tile_bytes(bm: int, bk: int, bn: int, dtype_bytes: int = 2) -> int:
    return (bm * bk + bk * bn) * dtype_bytes + bm * bn * 4  # fp32 acc


# ---------------------------------------------------------------------------
# eager train step memory (CUDA targets)
# ---------------------------------------------------------------------------

#: remat policies in the order a CUDA plan tries them: the least
#: recomputation that fits comes first.  ``dots_saveable`` is not a rung:
#: it never fits where ``full`` does not, and on the eager step its
#: selective checkpoint, a policy call on every op of the forward and the
#: recompute, made the 36-layer qwen3-8b step 13% slower than ``full``
#: at the same peak (``scripts/remat_turns.py``, PERF.md §6)
REMAT_LADDER = ("none", "full")

#: bytes a train step holds beside its state that no term of
#: :func:`eager_train_step_memory` lists: cuBLAS and cuBLASLt workspaces,
#: the batch, scalars, gradients in flight between two layers
STEP_RUNTIME_BYTES = 512 << 20

#: fp32 / int32 temporaries an AdamW update keeps of one chunk
#: (:data:`OPT_CHUNK` elements) at once
OPT_CHUNK_TEMPS = 10


def _norm_bytes(T: float, width: float) -> float:
    """An fp32 RMS norm over ``width``: its fp32 input and normalised
    output, the reciprocal rms and the scale 1 + w (the bf16 normed
    output is counted where a product keeps it)."""
    return 8 * T * width + 4 * T + 4 * width


def _ssm_saved_bytes(arch, T: float, seqs: float, chunk: int,
                     heads: int = 0, conv_channels: int = 0) -> float:
    """The mamba2 mixer after its pre-norm (``models.ssm.mixer`` and
    :class:`repro_torch.kernels.ssd_scan.SSDScan` as PyTorch records
    them): the conv's zero-padded bf16 input (k - 1 rows more a
    sequence) and the fp32 input of its SiLU over the ``C = d_inner + 2
    G N`` channels, the fp32 inputs of the dt softplus and of ``-exp``'s
    output; the scan's fp32 x, dt, A, B, C, y, final state and the state
    carried into each chunk; the SiLU's output (the D skip keeps a view
    of it); the gated norm's z, y, SiLU(z), its input, rsqrt, scale and
    normed output, and the fp32 ``out_proj`` copy.

    On a mesh whose model ranks each hold ``heads`` SSM heads and
    ``conv_channels`` conv channels (``models.ssm``'s regroup): the
    conv's padded input is the rank's channels; its output, gathered
    whole, is cut before the SiLU, which keeps the fp32 inputs of the
    rank's heads of ``x`` and of the whole ``B`` and ``C``, and whose
    outputs are the scan's own (no whole-width copy is kept: the
    gathered products die in the forward); every per-head term counts
    the rank's heads, the gated norm its ``heads * P`` channels."""
    P, N, G = arch.ssm_head_dim, arch.ssm_state, arch.ssm_n_groups
    H = heads or arch.ssm_heads
    di, d, k = H * P, arch.d_model, arch.ssm_conv
    S = T / seqs
    nc = math.ceil(S / min(chunk, S))
    scan = (8 * T * di + 4 * T * H + 4 * H + 8 * T * G * N
            + 4 * seqs * (nc + 1) * H * P * N)
    gated = 12 * T * di + _norm_bytes(T, di) + 4 * T * di + 4 * di * d
    if not heads:
        C = di + 2 * G * N
        conv = 2 * seqs * (S + k - 1) * C + 4 * T * C + 4 * T * H + 4 * H
        return conv + scan + 4 * T * C + gated
    conv = (2 * seqs * (S + k - 1) * conv_channels
            + 4 * T * (di + 2 * G * N) + 4 * T * H + 4 * H)
    return conv + scan + gated


def _moe_saved_bytes(arch, T: float, seqs: float, impl: str) -> float:
    """The MoE FFN after its norm (``models.moe``), by path: the router's
    fp64 operands and softmax; the aux loss's token fractions; then for
    ``dense_einsum`` the threshold mask, the bf16 normed input, the
    expert stack ``wi`` as the broadcast product copies it, the (E, T,
    2 ff) product, its fp32 gate and bf16 SiLU, the SwiGLU output, the
    gates and the fp32 (E, T, d) outputs of the combine; for
    ``gshard_einsum`` (C slots an expert a sequence, R = seqs C) each of
    the k routing steps' indices, remaining probabilities and mask (the
    last step's mask dies with its unused product) and (B, S, E, C) slot
    one-hots, the dispatch one-hots, the (E, R, d) expert input, the
    (E, R, 2 ff) product's SwiGLU terms and the fp64 combine operands; and
    a shared expert's gated FFN."""
    from repro_torch.models.moe import _capacity

    d, E, k = arch.d_model, arch.n_experts, arch.experts_per_token
    ff = arch.moe_d_ff or arch.d_ff
    router = 8 * T * d + 8 * d * E + 4 * T * E
    if impl == "dense_einsum":
        out = (router + 4 * E + T * E + 2 * T * d + 4 * E * d * ff
               + 12 * E * T * ff + 4 * T * E + 4 * E * T * d)
        normed_kept = True
    elif impl == "gshard_einsum":
        S = T / seqs
        C = _capacity(int(S), E, k, arch.capacity_factor)
        R = seqs * C
        route = k * 8 * T + 8 * (k - 1) * T * E + 4 * k * T * E * C
        out = (router + 4 * seqs * E + route + 2 * T * E * C + 2 * E * R * d
               + 12 * E * R * ff + 8 * T * E * C + 8 * E * R * d)
        normed_kept = False
    else:
        raise ValueError(f"moe_impl {impl!r} has no saved-bytes model")
    if arch.n_shared_experts:
        out += 12 * T * ff * arch.n_shared_experts \
            + (0 if normed_kept else 2 * T * d)
    return out


def eager_layer_saved_bytes(arch, tokens: float, heads: int, kv_heads: int,
                            remat: str, *, seqs: float = 1, ffn: str = "mlp",
                            ssd_chunk: int = 256, ff_shards: int = 1,
                            ssm_heads: int = 0, conv_channels: int = 0
                            ) -> float:
    """Bytes eager autograd keeps for one layer between its forward and
    its backward, under ``remat`` (the port's ``models.lm._block_fwd`` as
    PyTorch records it, T = ``tokens`` over ``seqs`` sequences); ``ffn``
    is the layer's FFN: ``mlp`` (dense), ``none`` (the SSM family) or the
    MoE path ``dense_einsum`` / ``gshard_einsum``:

    * ``none``: the pre-mixer fp32 RMS norm (:func:`_norm_bytes`) and
      its bf16 normed output (2 T d, which the projections keep); with
      attention, the q/k norms over (H + K) hd and their normed outputs,
      RoPE's fp32 sin and cos (T x hd/2 each, for q and for k), flash q,
      k, v, o (bf16) and the fp32 log-sum-exp (4 T H); with an SSM, the
      mamba2 mixer (:func:`_ssm_saved_bytes`; a hybrid keeps both
      paths); then the FFN's norm and, for the gated FFN, its normed
      input, bf16 gate/up product (4 T F), the fp32 gate (4 T F), the
      bf16 SiLU (2 T F) and the bf16 product (2 T F); for the encoder's
      GELU FFN, its normed input, the fp32 input of the GELU (4 T F) and
      its bf16 output (2 T F); or the MoE FFN (:func:`_moe_saved_bytes`).
      Attention keeps the same tensors causal or not (the encoder's is
      not), and no RoPE terms where the arch has none;
    * ``full``: the layer's input alone (2 T d).

    On a mesh ``heads`` / ``kv_heads`` are a rank's and ``ff_shards``
    the model ranks the dense FFN's ff dims are cut over (each keeps
    its ``1 / ff_shards`` of the FFN's tensors; the norms and the normed
    input stay whole), and ``ssm_heads`` / ``conv_channels`` the SSM
    heads and conv channels a rank holds where its heads are split (0:
    whole; :func:`_ssm_saved_bytes`).
    """
    T, d, hd = tokens, arch.d_model, arch.hd
    if remat == "full":
        return 2 * T * d
    if remat != "none":
        raise ValueError(f"remat policy {remat!r} not in {REMAT_LADDER}")
    out = _norm_bytes(T, d) + 2 * T * d
    if arch.has_attention:
        if arch.qk_norm:                       # fp32 in and out, rsqrt,
            out += (8 * T * (heads + kv_heads) * hd   # scale; normed out
                    + 4 * T * (heads + kv_heads) + 8 * hd)
        if arch.rope_theta > 0:
            out += 8 * T * hd
        out += 4 * T * (heads + kv_heads) * hd + 4 * T * heads
    if arch.has_ssm:
        out += _ssm_saved_bytes(arch, T, seqs, ssd_chunk, ssm_heads,
                                conv_channels)
    if ffn == "mlp":
        per_ff = 6 if arch.family == "encoder" else 12
        ff = arch.d_ff or arch.d_inner
        if ff_shards > 1:
            ff = ff / ff_shards
        out += _norm_bytes(T, d) + 2 * T * d + per_ff * T * ff
    elif ffn != "none":
        out += _norm_bytes(T, d) + _moe_saved_bytes(arch, T, seqs, ffn)
    return out


def layer_group_ffns(arch, moe_impl: str = "") -> Tuple[str, ...]:
    """The FFN of each layer in one step of the training loop
    (``models.lm.layer_groups``): a super-block's dense and MoE layer,
    else one layer's (``none`` in the SSM family, ``moe_impl`` in an MoE
    arch, ``mlp`` otherwise)."""
    if arch.is_moe and arch.moe_interleave > 1:
        return ("mlp", moe_impl)
    if arch.family == "ssm":
        return ("none",)
    return (moe_impl,) if arch.is_moe else ("mlp",)


def eager_train_step_memory(arch, *, tokens: float, heads: int,
                            kv_heads: int, vocab: int, state_bytes: float,
                            param_bytes: float, largest_stacked_bytes: float,
                            embed_bytes: float, remat: str,
                            microbatches: int = 1, seqs: float = 1,
                            moe_impl: str = "", ssd_chunk: int = 256,
                            ff_shards: int = 1, vocab_split: bool = False,
                            gathered_layer_bytes: float = 0.0,
                            ef_bytes: float = 0.0, ssm_heads: int = 0,
                            conv_channels: int = 0) -> Dict[str, float]:
    """The peak bytes of one eager train step on one card
    (``core.passes.lowering.lower_train_step``: autograd through
    ``models.lm.train_loss``, then AdamW in place), by part:

    * ``state``: parameters, moments and the master copy (the data
      organisation pass's persistent bytes);
    * ``runtime``: :data:`STEP_RUNTIME_BYTES` beside them (cuBLAS
      workspaces, the batch, small tensors no other term lists);
    * ``grads``: the gradient buffer ``torch.autograd.grad`` returns, in
      the parameters' dtype; with microbatches the fp32 sum besides
      (4 bytes a parameter on top of a microbatch's);
    * ``saved``: what the layers keep for the backward
      (:func:`eager_layer_saved_bytes` per layer, ``T = tokens /
      microbatches`` over ``seqs / microbatches`` sequences, each layer's
      FFN by :func:`layer_group_ffns`; under remat the layer input of
      each step of the loop, a super-block's for both its layers), plus,
      under remat, the one step recomputed in the backward, and the
      final norm's 10 T d;
    * ``loss``: the logits' region as the backward starts: the fp32
      logits the log-sum-exp keeps and four fp32 T x V temporaries of the
      loss's backward (its exp, the product, the gather's scatter and
      their sum): 20 T V;
    * ``ssd_workspace``: with an SSM, the SSD backward's workspace
      (``kernels.ssd_scan.bwd_workspace_floats``, fp32) while one layer's
      backward runs, after the loss's region is freed: the turn holds
      the larger of the two;
    * ``tail``: the end of the backward, where each stacked ``(L, ...)``
      leaf's gradient is stacked from its per-layer pieces: the largest
      leaf once more, beside every gradient but the embedding's (made
      after the stacks) and the input's gradient on its way to it
      (2 T d); or the optimizer's fp32 chunk temporaries beside all the
      gradients, whichever is larger.

    The peak is ``state + runtime`` plus the larger of the turn from
    forward to backward (``saved`` and the larger of ``loss`` and
    ``ssd_workspace``, with the fp32 sum of earlier microbatches) and the
    end (``grads`` and ``tail``).

    On a mesh every term is one rank's (the caller's arguments): its
    tokens, heads and vocab piece (``vocab``), its gradient bytes
    (``param_bytes``, ``largest_stacked_bytes``, ``embed_bytes``: each
    leaf over its shard factor), ``ff_shards``, ``ssm_heads`` and
    ``conv_channels`` as in :func:`eager_layer_saved_bytes` (the SSD
    backward's workspace then the rank's heads'); with ``vocab_split``
    the loss's
    region is the vocab-split cross-entropy's (``models.lm._split_ce``:
    the fp32 exponentials it keeps, then, as its backward starts, their
    product with the gradient, the padding mask's output and its bf16
    cast: 14 T V of the rank's V); FSDP's gathered layer
    (``gathered_layer_bytes``) is saved once more for each step the
    backward holds it (every step without remat, the recomputed one
    under it) with its fp32 gradient before the reduce-scatter; and a
    plan that compresses gradients keeps ``ef_bytes`` of bf16 residuals
    beside its state."""
    nmicro = max(microbatches, 1)
    T = tokens / nmicro
    ffns = layer_group_ffns(arch, moe_impl)
    group = sum(eager_layer_saved_bytes(
        arch, T, heads, kv_heads, "none", seqs=seqs / nmicro, ffn=f,
        ssd_chunk=ssd_chunk, ff_shards=ff_shards, ssm_heads=ssm_heads,
        conv_channels=conv_channels) for f in ffns)
    steps = arch.n_layers // len(ffns)
    if remat == "none":
        saved = steps * group
    else:
        saved = steps * eager_layer_saved_bytes(arch, T, heads, kv_heads,
                                                remat) + group
    saved += 10 * T * arch.d_model
    if gathered_layer_bytes:
        saved += gathered_layer_bytes * (
            (steps if remat == "none" else 1) + 2)
    loss = (14 if vocab_split else 20) * T * vocab
    ssd_ws = 0.0
    if arch.has_ssm:
        from repro_torch.kernels.ssd_scan import bwd_workspace_floats
        ssd_ws = 4.0 * bwd_workspace_floats(
            math.ceil(seqs / nmicro), round(T * nmicro / seqs),
            ssm_heads or arch.ssm_heads, arch.ssm_head_dim, arch.ssm_state,
            arch.ssm_n_groups, ssd_chunk)
    sum32 = 2 * param_bytes if nmicro > 1 else 0.0
    grads = param_bytes + sum32
    stacking = largest_stacked_bytes - embed_bytes + 2 * T * arch.d_model
    tail = max(stacking, OPT_CHUNK_TEMPS * OPT_CHUNK * 4)
    turn = saved + max(loss, ssd_ws) + sum32
    end = grads + tail
    state_bytes = state_bytes + ef_bytes
    return {"state": float(state_bytes), "runtime": float(STEP_RUNTIME_BYTES),
            "grads": float(grads), "saved": float(saved),
            "loss": float(loss), "ssd_workspace": ssd_ws,
            "tail": float(tail),
            "peak": float(state_bytes + STEP_RUNTIME_BYTES
                          + max(turn, end))}
