"""Batched serving engine: continuous batching over prefill + decode.

The port of ``repro/serve/engine.py``'s plan-driven core.  The session
cache is the template's ``cache.kv`` component, allocated once at
engine start (shape from the plan), slots assigned to requests, freed on
completion.  Waiting requests are admitted in same-length buckets: every
pending prompt of the head-of-line length that fits a free slot (and,
when paged, the block pool) is prefilled in ONE call, its batch padded
to a power of two; then every engine tick decodes one token for all
slots.  Positions are per slot, and freed slots decode as ``(token 0,
pos 0)`` with a ``-1`` table row, so they never write the pool and
their output is discarded.

KV residency is the plan's ``kv_residency``: ``dense`` per-slot
``max_len`` stripes, or ``paged`` — a block pool whose geometry the
data-organization pass chose.  On the card, prefill runs the port's
flash-attention kernel and every decode tick its paged (or dense) decode
kernel.  An attention-free (mamba2) model has no KV to page: it is dense
whatever is asked, each slot holding its SSM state and conv window; its
prefill runs the SSD-scan kernel and its decode ticks the recurrence.  A
hybrid (hymba-1.5b) pages its KV and keeps each slot's SSM state and conv
window dense beside the pool: its rows move with the slot through
prefill, migration, park and resume.

Admission is the plan's ``kv_admission``.  Under ``reserve`` every
admitted request holds its worst-case block budget until it finishes.
Under ``grant`` it holds only the blocks of its (re-)prefill rows, and
a decode tick that crosses a block boundary asks for one more: when the
slot's sub-pool has none, the engine walks the JAX engine's ladder —
spill a cold cached block to the host tier, else migrate the slot to an
idler sub-pool (``kv_pool_groups`` > 1), else preempt a victim
(:class:`PreemptionPolicy`: fewest tokens generated first, deadline'd
requests spared).  With a host tier the victim **parks with state**:
its KV blocks spill to the host pool (dense stripes and SSM/conv rows
are copied to the host), and its resume promotes them into a free
slot's sub-pool with no prefill call.  One tick before a parked
request's backoff ends its rows are staged: copied from the host pool
into a pinned staging buffer (:func:`repro_torch.models.lm
.init_staging`) and from there onto the card on a side stream, ordered
by an event before the tick that consumes them (the twin of the JAX
engine's asynchronous device put).  Without a host tier (or
when the victim shares blocks) the victim releases everything and
re-prefills its prompt plus the tokens generated so far.  Past its
retry budget or a missed deadline a request is shed
(``Request.error``), and past the preemption-rate threshold ``submit``
raises :class:`OverloadError`.

A paged engine serves the plan's **cross-request prefix reuse**
(``kv_prefix_reuse``) and **host spill tier** (``kv_host_blocks``) as
the JAX engine does: every full ``block_len`` chunk of an admitted
prompt is chain-hashed (:mod:`repro_torch.serve.prefix_cache`) and
matched against a radix trie of resident blocks, one trie per sub-pool.
Matched blocks are aliased into the new request's table with a refcount
bump instead of re-prefilled: only the tail runs, through
:func:`repro_torch.models.lm.prefill_tail` (the flash kernel at a query
offset on the card), and a request whose whole prompt but its last
token is resident skips prefill entirely (a "ride": its first decode
tick feeds that token).  A hybrid's SSM state at the split point
depends on every earlier token, so there matched blocks are aliased but
the whole feed is prefilled and nothing rides.  A copy-on-write barrier
before each decode tick copies any shared append block into a fresh one
(preempting a victim when the pool has none).  With a host tier, blocks a finished request
would free but the trie still indexes stay engine-cached; under pool
pressure the spill scheduler moves the oldest to a host-DRAM pool
(:func:`repro_torch.models.lm.init_host_pool`), and a later prefix hit
on a spilled block promotes it back.  Spill and promote are synchronous
copies: a spill reads rows from ids already back on the free list, safe
because the copy ends before any next tenant writes.

When the plan says ``kv_prefill_mode: disagg`` and the caller asks for
workers (``from_plan(..., disagg_workers=N)``), prefill runs out of
process, in a supervised fleet of spawned workers
(:mod:`repro_torch.serve.disagg`): admission reserves a slot and its
blocks and dispatches the feed; each ``block_len`` chunk the worker
streams home is scattered into its pool block, and the count of whole
chunks scattered in order is the request's **journal**
(:class:`_DisaggFlight`); when the worker's last-token logits arrive the
table row is installed and the first token sampled, as an inline
prefill would.  A worker death re-dispatches the request from its last
journaled block (the journaled rows gathered back out of the pool are
the resume prefix); when every worker slot has spent its restart
budget the engine degrades to in-process prefill under a typed
:class:`~repro_torch.serve.disagg.DegradedMode`.  Disagg needs paged
residency and a pure-attention arch; otherwise, and with no workers,
prefill stays inline, as in the JAX engine.

On a mesh (``from_plan(mesh=...)``, a ``DeviceMesh``) every rank runs
this engine on the same requests with its pieces of the weights and the
cache (:mod:`repro_torch.serve.sharded`); the decode runs each rank's
heads, or the sharded flash decode (:mod:`repro_torch.dist
.flash_decode`), as the placement says, and an SSM arch's mixer its
heads (its state and conv window pieces written and read through
:class:`~repro_torch.serve.sharded.MeshPieces`).  The paged plan is
served as frozen there too.  The host tier keeps a piece a rank (the
rank's kv heads where they split; where the pool splits by blocks, every
head of every host block, a whole copy of the tier, so that a promote
writes its owner's rows with no collective), and a spill, a promote, a
park and a staged prefetch move each rank's rows through the pieces.
Migration moves a slot between the data shards' sub-pools of a 2-D pool:
its blocks' rows are read from the old owner and written on the new one.
A prefill fleet is owned by the mesh's first rank, whose workers map the
whole weights it gathers from the ranks' pieces; every tick that rank
broadcasts what the fleet said (the chunk slabs, the logits, deaths and
the degraded record) and every rank applies it in the same order, so the
host decisions stay the same on every rank; for the same reason the
deadlines read that rank's clock, broadcast once a tick.  Several data
axes (``("pod", "data", "model")``) act as one linearised data group: a
data shard's slots, sub-pool and stripes are its index in that group's
data-major order.  A cache split on head_dim (``kv_split ==
"head_dim"``) decodes each rank's columns through the split decode
(:func:`repro_torch.models.attention.attention_decode_split`).

State lives in torch tensors on the device of the parameters; the
cache, the block table and ``pos`` are updated in place.  Sampling
draws from one seeded ``torch.Generator`` on that device (the JAX
engine's key stream has no torch twin, so only greedy decoding is
token-comparable across the two).
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, get_arch
from repro_torch.core.costmodel import kv_block_len as default_block_len
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.models.lm import RunCfg
from repro_torch.runtime.fault import RestartPolicy
from repro_torch.runtime.straggler import StepTimer
from repro_torch.serve.allocator import BlockAllocator
from repro_torch.serve.prefix_cache import PrefixCache, chain_hashes


class OverloadError(RuntimeError):
    """The engine is shedding load: the recent preemption rate crossed
    the policy threshold, so new admissions would only thrash the pool.
    Callers back off and retry, or route to another replica."""


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray             # (prompt_len,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    blocks: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    deadline: Optional[float] = None   # absolute wall-clock deadline
    preemptions: int = 0               # times evicted mid-decode
    error: str = ""                    # set when shed (never finished)
    # chain hashes of the feed's full blocks at last (re-)admission:
    # migration and resume re-register the moved blocks under these
    prefix_hashes: List[str] = dataclasses.field(default_factory=list)

    @property
    def feed_tokens(self) -> np.ndarray:
        """The tokens a (re-)prefill builds KV for: the prompt, plus,
        after a preemption, every generated token but the last (whose KV
        row does not exist yet; the next decode tick feeds it)."""
        if not self.out_tokens:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.out_tokens[:-1], np.int32)])


@dataclasses.dataclass
class _DisaggFlight:
    """A request whose prefill is out at the worker fleet.  It owns a
    slot and its admission blocks, but its table row stays -1 until
    completion (the freed-slot dummy decode must never append into a
    half-written block).  ``acked`` counts the whole blocks scattered
    into the pool in order: the idempotent journal a re-dispatch resumes
    from after a worker death."""

    request: Request
    slot: int
    group: int
    nb_feed: int                   # ceil(feed length / block_len)
    acked: int = 0


@dataclasses.dataclass
class PreemptionPolicy:
    """How the engine degrades when a mid-decode block grant fails.

    Victims go fewest-tokens-generated first (least work thrown away);
    requests with a deadline are spared while any deadline-free victim
    exists, and among them the latest deadline goes first.  Backoff and
    retry budget are a :class:`RestartPolicy` measured in engine ticks.
    """

    max_preemptions: int = 4          # per-request retry budget
    backoff_base_ticks: int = 1       # first re-admission delay
    backoff_cap_ticks: int = 32       # exponential backoff ceiling
    shed_window_ticks: int = 64       # sliding window for the rate
    shed_rate: float = 0.5            # preemptions/tick that means overload

    def restart_policy(self) -> RestartPolicy:
        return RestartPolicy(max_restarts=self.max_preemptions,
                             backoff_base_s=float(self.backoff_base_ticks),
                             backoff_cap_s=float(self.backoff_cap_ticks))

    def pick_victim(self, candidates: List[Request],
                    now: float) -> Request:
        def key(r: Request):
            if r.deadline is None:
                return (0, len(r.out_tokens), 0.0, r.rid)
            return (1, len(r.out_tokens), -(r.deadline - now), r.rid)
        return min(candidates, key=key)


@dataclasses.dataclass
class PreemptedRequest:
    """A parked eviction.  Its generated tokens stay on the request.
    Without ``parked_state`` it re-prefills at ``not_before_tick``; with
    it (a park with state) its KV lives on in the host tier (ids in
    ``request.blocks``) or as host copies of its dense stripe, with its
    SSM/conv rows beside them, and the resume copies them back."""

    request: Request
    not_before_tick: int
    # {"slot_len": int, "kv_host": [host ids]} for paged KV,
    # {"kv_rows": (k, v)} for dense stripes, plus "ssm"/"conv" host copies
    parked_state: Optional[Dict[str, Any]] = None


#: a request's prefix-match state for one admission pass: the feed's
#: chain hashes and a per-sub-pool memo of its trie matches
MatchInfo = Dict[str, Any]


def _unsupported(decision: str, value, hint: str) -> NotImplementedError:
    return NotImplementedError(
        f"{decision}={value!r} is not ported yet; {hint}")


class ServeEngine:
    def __init__(self, arch: ArchConfig, params, cfg: RunCfg,
                 max_batch: int = 8, max_len: int = 512, kv_heads: int = 0,
                 seed: int = 0, kv_residency: str = "dense",
                 kv_block_len: int = 0, kv_n_blocks: int = 0,
                 kv_admission: str = "reserve", kv_pool_groups: int = 0,
                 kv_prefix_reuse: str = "on", kv_host_blocks: int = 0,
                 kv_prefetch: str = "on",
                 preemption: Optional[PreemptionPolicy] = None):
        if kv_admission not in ("reserve", "grant"):
            raise ValueError(f"kv_admission must be 'reserve' or 'grant', "
                             f"got {kv_admission!r}")
        if kv_prefix_reuse not in ("on", "off"):
            raise ValueError(f"kv_prefix_reuse must be 'on' or 'off', "
                             f"got {kv_prefix_reuse!r}")
        if kv_prefetch not in ("on", "off"):
            raise ValueError(
                f"kv_prefetch must be 'on' or 'off', got {kv_prefetch!r}")
        if kv_host_blocks < 0:
            raise ValueError(
                f"kv_host_blocks must be >= 0, got {kv_host_blocks}")
        lm.check_serves(arch)
        self.device = params["embed"].device
        if cfg.mesh is None:
            # one card: its heads are the weights'; on a mesh the rank's
            # instances are judged where its pieces are placed
            attn = lm.layer_params(params["blocks"], 0).get("attn")
            lm.check_on_device(arch, self.device, lm.kernel_instances(
                arch, "decode",
                heads=attn["wq"].shape[-1] // arch.hd if attn else 0,
                kv_heads=attn["wk"].shape[-1] // arch.hd if attn else 0,
                flash_tiles=cfg.flash_tiles,
                cache_split=("none", 0, kv_residency == "paged")))
        self.arch, self.params, self.cfg = arch, params, cfg
        self.plan = None               # set by from_plan()
        self.pieces = None             # a mesh's MeshPieces (from_plan)
        self.max_batch, self.max_len = max_batch, max_len
        self.kv_admission = kv_admission
        self.preemption = preemption or PreemptionPolicy()
        self.kv_prefill_mode = "inline"
        # an SSM-only arch has no KV stripes to page (its state is O(1)
        # in the sequence), as in the JAX engine
        self.kv_residency = ("paged" if kv_residency == "paged"
                             and arch.has_attention else "dense")
        self.host_blocks = 0
        self.pool_groups = 1
        self._host: Optional[Dict[str, torch.Tensor]] = None
        self._staging: Optional[Dict[str, torch.Tensor]] = None
        self._prefix: Optional[PrefixCache] = None
        # on a mesh the cache is sized here (its whole shapes, no memory)
        # and from_plan allocates the rank's pieces (_place_on_mesh)
        cache_dev = "meta" if cfg.mesh is not None else self.device
        ssm_heads = (cfg.ssm_heads_padded if cfg.mesh is not None else
                     lm.cache_heads(arch, params["blocks"]).get(
                         "ssm_heads", 0))
        if self.kv_residency == "paged":
            self.block_len = kv_block_len or default_block_len(max_len)
            per_seq = -(-max_len // self.block_len)
            # never larger than this engine's slots can ever pin; a
            # plan-shrunk (budget-capped) pool stays shrunk
            cap = max_batch * per_seq
            self.n_blocks = min(kv_n_blocks, cap) if kv_n_blocks else cap
            if cfg.mesh is not None:
                self._mesh_pool(cfg, max_batch, kv_n_blocks)
            if kv_pool_groups:
                # explicit sub-pools (single-card emulation of the JAX
                # engine's 2-D pool contract): equal slot ranges per group
                if self.n_blocks % kv_pool_groups \
                        or max_batch % kv_pool_groups:
                    raise ValueError(
                        f"kv_pool_groups={kv_pool_groups} must divide both "
                        f"n_blocks={self.n_blocks} and "
                        f"max_batch={max_batch}")
                self.pool_groups = kv_pool_groups
            self.cache = lm.init_paged_cache(
                arch, max_batch, max_len, self.block_len, self.n_blocks,
                kv_heads=kv_heads, ssm_heads=ssm_heads, device=cache_dev)
            # the host spill tier, clamped like the pool (to a park depth
            # of 8 full worst-case batches, as in the JAX engine); on a
            # mesh _place_on_mesh allocates the rank's piece of it
            self.host_blocks = (min(kv_host_blocks, 8 * cap)
                                if kv_host_blocks > 0 else 0)
            if self.host_blocks and cfg.mesh is None:
                self._host = lm.init_host_pool(
                    arch, self.host_blocks, self.block_len,
                    kv_heads=kv_heads)
            if kv_prefix_reuse == "on":
                self._prefix = PrefixCache(self.pool_groups)
        else:
            self.block_len = 0
            self.n_blocks = 0
            self.cache = lm.init_cache(
                arch, max_batch, max_len, kv_heads=kv_heads,
                ssm_heads=ssm_heads, device=cache_dev)
        self._alloc = BlockAllocator(self.n_blocks, self.pool_groups,
                                     host_blocks=self.host_blocks)
        self.kv_prefix_reuse = self._prefix is not None
        # parks with state: paged blocks need the host pool, dense and
        # SSM slots copy their rows to the host without one
        self.kv_tiering = kv_host_blocks > 0
        self.kv_prefetch = kv_prefetch == "on"
        # engine-held cold blocks: ones a release would have freed but the
        # trie still indexes (refcount 1, held here), oldest first; only
        # populated with the host tier on
        self._cached: Dict[int, None] = {}
        # prefetch staging: rid -> (host ids, k rows, v rows, event), put
        # on the device one tick before the parked request's resume
        self._staged: Dict[int, Tuple] = {}
        self._stage_stream = None      # side stream of the staging copies
        self._stage_event = None       # the last copy out of the buffer
        # per admission pass: promoted host id -> its new pool id, so a
        # second request matching a just-promoted block follows it
        self._promo_map: Dict[int, int] = {}
        # matched tokens' prefill compute is skippable only when the whole
        # per-token state is attention KV (a hybrid's SSM state needs
        # every token: it aliases the blocks but prefills the whole feed)
        self._skip_prefix = self._prefix is not None and not arch.has_ssm
        self.free_slots = list(range(max_batch))
        self.active: Dict[int, Request] = {}
        self.pending: List[Request] = []
        self.finished: List[Request] = []
        # overload state: parked evictions, shed requests (never finished;
        # Request.error says why), per-request backoff budgets and the
        # sliding window of preemption ticks
        self.preempted: List[PreemptedRequest] = []
        self.shed: List[Request] = []
        self._backoff: Dict[int, RestartPolicy] = {}
        self._preempt_ticks: Deque[int] = deque(maxlen=4096)
        self._rid = 0
        self.tick = 0
        self.preemptions = 0
        self.migrations = 0
        self.grant_denials = 0
        # the ladder's outcomes beyond the JAX engine's counters: parks
        # with state, their resumes (by a promote of host blocks, or of
        # host copies of dense/SSM rows), staged prefetches and those a
        # resume consumed
        self.parks_with_state = 0
        self.resumes = 0
        self.resumes_by_promote = 0
        self.prefetch_staged = 0
        self.prefetch_consumed = 0
        # chaos/test hook: return True to deny one mid-decode grant even
        # when blocks are free (drives the ladder like a hot sub-pool)
        self.grant_fault: Optional[Callable[[], bool]] = None
        self.tick_timer = StepTimer()
        self.straggler_ticks = 0
        # per-slot valid lengths; mirrored into cache["pos"] every tick
        # (freed slots stay at 0 — their stale KV is masked out)
        self.slot_len = np.zeros((max_batch,), np.int32)
        self._gen = torch.Generator(self.device).manual_seed(seed)
        # admission telemetry: bucketed prefill batch sizes per call
        self.prefill_calls = 0
        self.prefill_batches: Deque[int] = deque(maxlen=1024)
        # prefix-sharing telemetry (hit/miss counters live on _prefix)
        self.cow_copies = 0
        self.prefix_rides = 0          # admissions with zero prefill calls
        # host ms spent in the tier copies (spill: device -> host, waited
        # for; promote: host -> device, enqueued behind its copy; stage:
        # host pool -> pinned buffer, and the side stream's copy enqueued)
        # and in the disagg chunks' scatter (host rows -> pool blocks)
        self.tier_ms = {"spill": 0.0, "promote": 0.0, "stage": 0.0,
                        "disagg_chunk": 0.0}
        # disaggregated prefill (attach_fleet() turns it on)
        self._fleet = None
        self._disagg: Dict[int, _DisaggFlight] = {}
        self._redispatch: List[int] = []
        self._inline_poison: set = set()   # rids whose worker prefill raised
        self.degraded = None               # disagg.DegradedMode once degraded
        self.disagg_dispatches = 0
        self.disagg_chunks = 0
        self.disagg_resumes = 0
        # on a mesh, the bytes of whole weights the first rank gathered
        # for its fleet's workers, beside its pieces (0 elsewhere)
        self.fleet_weight_bytes = 0
        # on a mesh, the first rank's wall clock at the start of this tick
        self._mesh_now = 0.0

    def _mesh_pool(self, cfg: RunCfg, max_batch: int,
                   kv_n_blocks: int) -> None:
        """On a mesh: keep the pool divisible by the mesh through the
        clamp (a clamp that broke it would downgrade the pool-sharded
        decode, 2-D -> 1-D -> single shard, and replicate the pool on
        the broken axis), and where the pool is split 2-D, one sub-pool
        a data shard, so every slot's blocks lie in its data shard's
        piece (``src/repro/serve/engine.py:318-350``).  The JAX engine
        groups only for ``shard_map_flash``; here the 2-D placement
        itself runs the sharded decode, so it groups whenever that
        placement holds."""
        from repro_torch.dist.flash_decode import pool_sharding_kind
        from repro_torch.dist.sharding import mesh_sizes
        sizes = mesh_sizes(cfg.mesh)
        msize = sizes.get(cfg.model_axis, 1)
        dsize = math.prod(sizes.get(a, 1) for a in cfg.data_axes)
        n = self.n_blocks
        aligns = []
        if dsize > 1 and max_batch % dsize == 0:
            aligns.append(dsize * msize)
        if msize > 1:
            aligns.append(msize)
        for align in aligns:
            if align > 1 and n % align and \
                    (not kv_n_blocks or kv_n_blocks % align == 0):
                n = align * (-(-n // align))
                if kv_n_blocks:
                    n = min(kv_n_blocks, n)
                break
        self.n_blocks = n
        if pool_sharding_kind(cfg.mesh, n, max_batch, cfg.data_axes,
                              cfg.model_axis) == "2d":
            self.pool_groups = dsize

    # ------------------------------------------------------------------
    @classmethod
    def from_plan(cls, plan, params, *, arch: Optional[ArchConfig] = None,
                  mesh=None, max_batch: Optional[int] = None,
                  max_len: Optional[int] = None, seed: int = 0,
                  kv_admission: Optional[str] = None,
                  kv_prefix_reuse: Optional[str] = None,
                  kv_host_blocks: Optional[int] = None,
                  kv_prefetch: Optional[str] = None,
                  combine_topology: Optional[str] = None,
                  preemption: Optional[PreemptionPolicy] = None,
                  kv_prefill_mode: Optional[str] = None,
                  disagg_workers: int = 0,
                  disagg_opts: Optional[Dict[str, Any]] = None,
                  fleet=None) -> "ServeEngine":
        """Build an engine from the frozen plan artifact.

        The plan supplies the RunCfg (padded sizes, kernel tiles, kernel
        mode), the KV residency and pool geometry, the admission mode
        (``grant`` walks the grant → migrate → preempt ladder), the
        batching limits (the workload dims carried in the artifact),
        prefix reuse, the host spill tier, the prefetch and the prefill
        mode; ``max_batch``/``max_len`` may lower the limits, never raise
        them, and the ``kv_*`` keywords override plan decisions as in the
        JAX engine.  Where the prefill mode is ``disagg`` and the engine
        is paged over a pure-attention arch, ``disagg_workers`` > 0
        spawns a :class:`repro_torch.serve.disagg.PrefillFleet` of that
        many workers (keywords ``disagg_opts``), or ``fleet`` attaches a
        given one; otherwise prefill stays inline.

        With ``mesh``, a :class:`torch.distributed.device_mesh.DeviceMesh`
        of the plan's axes and sizes, every rank builds the engine from
        the same plan, params (whole, or the rank's pieces) and requests,
        and keeps only its pieces (:meth:`_place_on_mesh`); the decode
        follows the placement (``RunCfg.kv_split``: the rank's heads, or
        the sharded flash decode with the plan's ``combine_topology``,
        which ``combine_topology`` overrides).  The plan's host tier is
        kept there (a piece a rank), and a fleet is spawned in (or
        ``fleet`` given by) the mesh's first rank only
        (:meth:`_mesh_fleet`).  A plan specialized for a mesh wants one:
        without it raises :class:`NotImplementedError`.
        """
        from repro_torch.core.passes.lowering import build_run_cfg
        from repro_torch.dist.sharding import mesh_sizes
        if mesh is None and any(int(n) > 1 for n in plan.mesh_shape):
            raise _unsupported(
                "mesh", tuple(plan.mesh_shape),
                "this plan shards over a mesh: pass its DeviceMesh "
                "(mesh=...), or specialize with mesh_shape=(1, 1) for one "
                "card")
        if mesh is not None and mesh_sizes(mesh) != dict(
                zip(plan.mesh_axes, (int(n) for n in plan.mesh_shape))):
            raise ValueError(
                f"mesh {mesh_sizes(mesh)} is not the plan's "
                f"{dict(zip(plan.mesh_axes, plan.mesh_shape))}")
        arch = arch if arch is not None else get_arch(plan.arch)
        if plan.shape_kind != "decode":
            if max_batch is None or max_len is None:
                raise ValueError(
                    f"plan {plan.content_hash()[:12]} was specialized for "
                    f"shape_kind={plan.shape_kind!r}, not a decode workload; "
                    "pass max_batch= and max_len= explicitly, or specialize "
                    "a decode shape")
        else:
            if max_len is not None and plan.seq_len and max_len > plan.seq_len:
                raise ValueError(
                    f"max_len={max_len} exceeds the seq_len={plan.seq_len} "
                    "this plan was specialized for; respecialize instead")
            if max_batch is not None and plan.global_batch \
                    and max_batch > plan.global_batch:
                raise ValueError(
                    f"max_batch={max_batch} exceeds the global_batch="
                    f"{plan.global_batch} this plan was specialized for; "
                    "respecialize instead")
        est = plan.estimates

        def pick(override, key, default):
            return override if override is not None else est.get(key, default)

        cfg = build_run_cfg(plan, arch, mesh)
        if combine_topology is not None:
            cfg = dataclasses.replace(cfg, combine_topology=combine_topology)
        if max_batch is None:
            max_batch = (plan.global_batch
                         if plan.shape_kind == "decode" and plan.global_batch
                         else 8)
        if max_len is None:
            max_len = plan.seq_len or 512
        eng = cls(arch, params, cfg, max_batch=max_batch, max_len=max_len,
                  kv_heads=cfg.kv_heads_padded, seed=seed,
                  kv_residency=str(est.get("kv_residency", "dense")),
                  kv_block_len=int(est.get("kv_block_len", 0)),
                  kv_n_blocks=int(est.get("kv_n_blocks", 0)),
                  kv_admission=str(pick(kv_admission, "kv_admission",
                                        "reserve")),
                  kv_prefix_reuse=str(pick(kv_prefix_reuse,
                                           "kv_prefix_reuse", "on")),
                  kv_host_blocks=int(pick(kv_host_blocks, "kv_host_blocks",
                                          0)),
                  kv_prefetch=str(pick(kv_prefetch, "kv_prefetch", "on")),
                  preemption=preemption)
        eng.plan = plan
        if mesh is not None:
            eng._place_on_mesh(mesh)
        # disaggregated prefill: the plan's kv_prefill_mode (or the
        # override), a fleet when workers are asked for; anything else
        # keeps the inline path, as the pass's own fallback does
        if str(pick(kv_prefill_mode, "kv_prefill_mode", "inline")) \
                == "disagg":
            spawn = fleet is None and disagg_workers > 0 \
                and eng.kv_residency == "paged" \
                and arch.has_attention and not arch.has_ssm
            if mesh is not None:
                eng._mesh_fleet(fleet, disagg_workers if spawn else 0,
                                disagg_opts)
                return eng
            if spawn:
                from repro_torch.serve.disagg import PrefillFleet
                fleet = PrefillFleet(
                    plan, arch, params, disagg_workers,
                    block_len=eng.block_len, kv_heads=cfg.kv_heads_padded,
                    **(disagg_opts or {}))
            if fleet is not None:
                eng.attach_fleet(fleet)
        return eng

    def _mesh_fleet(self, fleet, workers: int,
                    disagg_opts: Optional[Dict[str, Any]]) -> None:
        """A prefill fleet on a mesh, owned by its first rank: that rank's
        ``fleet``, or ``workers`` spawned there, whose workers map the
        whole weights (each leaf gathered from the ranks' pieces, after
        a check that they fit that rank's device beside its pieces).
        Every rank calls this; the first rank's verdicts are broadcast,
        so every rank attaches, or refuses, alike."""
        from repro_torch.serve import disagg
        pc = self.pieces
        root = pc.is_root
        have = pc.bcast_object(fleet is not None if root else None)
        if not (have or workers):
            return
        if not have:
            held, whole = pc.param_bytes(self.params)
            err = pc.bcast_object(
                disagg.fleet_fit_error(whole, held, self.device)
                if root else None)
            if err:
                raise RuntimeError(err)
            params = pc.whole_params(self.params)
            if root:
                fleet = disagg.PrefillFleet(
                    self.plan, self.arch, params, workers,
                    block_len=self.block_len,
                    kv_heads=self.cfg.kv_heads_padded,
                    **(disagg_opts or {}))
                self.fleet_weight_bytes = whole
            del params
        self.attach_fleet(fleet)

    # ---------------- disaggregated prefill ---------------------------
    @property
    def prefill_mode(self) -> str:
        """``"disagg"`` while a fleet serves, ``"degraded"`` after it
        spent its restart budget (prefill back in-process), ``"inline"``
        otherwise."""
        if self.degraded is not None:
            return "degraded"
        return self.kv_prefill_mode

    def attach_fleet(self, fleet) -> None:
        """Switch prefill to disaggregated mode through ``fleet`` (a
        :class:`repro_torch.serve.disagg.PrefillFleet`).  Refused as the
        JAX engine refuses: chunked prefill needs the paged pool to
        scatter into and pure-attention KV to chunk.  On a mesh every
        rank calls it, the first with its fleet and the others with
        ``None``: each sees the fleet through a
        :class:`~repro_torch.serve.disagg.MeshFleet`."""
        if self.kv_residency != "paged":
            raise ValueError(
                "disaggregated prefill streams pool-block-shaped KV "
                "chunks — a dense-residency engine has no block pool "
                "to scatter them into")
        if not self.arch.has_attention or self.arch.has_ssm:
            raise ValueError(
                f"disaggregated prefill needs pure-attention KV; "
                f"{self.arch.name} carries SSM state that is sequential "
                "across the whole prompt")
        if self.pieces is not None:
            from repro_torch.serve.disagg import MeshFleet
            fleet = MeshFleet(self.pieces, fleet, self.device)
        self._fleet = fleet
        self.kv_prefill_mode = "disagg"

    def shutdown(self) -> None:
        """Stop the prefill fleet (if any) and reap its workers.
        Idempotent."""
        if self._fleet is not None:
            self._fleet.shutdown()

    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16,
               temperature: float = 0.0,
               deadline_s: Optional[float] = None) -> int:
        """Queue a request; refuses one that can never fit the cache.
        ``deadline_s`` (seconds from now) sheds it if still pending past
        that, and spares it as a victim while a deadline-free one exists.
        Raises :class:`OverloadError` while the engine is past its
        preemption-rate threshold."""
        prompt = np.asarray(prompt, np.int32)
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"request needs {len(prompt)} prompt + {max_new_tokens} new "
                f"tokens > max_len={self.max_len} cache rows; raise max_len "
                "or lower max_new_tokens")
        if self.kv_residency == "paged":
            need = self._blocks_needed(len(prompt), max_new_tokens)
            sub = self.n_blocks // self.pool_groups
            if need > sub:
                raise ValueError(
                    f"request needs {need} blocks of {self.block_len} rows "
                    f"but each sub-pool holds only {sub} ({self.n_blocks} "
                    f"blocks over {self.pool_groups} sub-pool(s)); raise "
                    "kv_n_blocks or lower max_new_tokens")
        if self.overloaded():
            raise OverloadError(
                f"engine is shedding load: {self._recent_preemptions()} "
                f"preemption(s) in the last "
                f"{self.preemption.shed_window_ticks} ticks exceeds the "
                f"shed rate {self.preemption.shed_rate}/tick; back off "
                "and retry, or route to another replica")
        r = Request(self._rid, prompt, max_new_tokens, temperature,
                    t_submit=time.time())
        if deadline_s is not None:
            # on a mesh the first rank's clock (every rank submits the
            # same requests), so every rank holds the same deadline
            r.deadline = (r.t_submit if self.pieces is None
                          else self._mesh_clock()) + deadline_s
        self._rid += 1
        self.pending.append(r)
        return r.rid

    def _blocks_needed(self, plen: int, max_new: int) -> int:
        """Blocks covering every cache row the request can touch; a
        request the prefill sample already satisfies needs none."""
        if max_new <= 1:
            return 0
        return -(-(plen + max_new) // self.block_len)

    def _admission_blocks(self, r: Request) -> int:
        """Blocks admission secures before prefilling ``r``: the full
        worst-case budget under ``reserve``, just the (re-)prefill rows'
        blocks under ``grant``; 0 if dense."""
        if self.kv_residency != "paged":
            return 0
        if r.max_new_tokens <= 1 and not r.out_tokens:
            return 0                   # satisfied by the prefill sample
        if self.kv_admission == "grant":
            return -(-len(r.feed_tokens) // self.block_len)
        return self._blocks_needed(len(r.prompt), r.max_new_tokens)

    def block_stats(self) -> Dict[str, int]:
        """Pool accounting (``free + in_use == total`` per tier; dense
        engines report an empty 0-block pool).  ``shared`` counts
        resident blocks with more than one holder, ``prefix_trie`` the
        blocks the prefix cache indexes, ``cached`` the engine-held cold
        blocks (trie-retained, either tier) the spill scheduler may
        reclaim; ``host_*`` is the host spill tier."""
        st = self._alloc.stats()
        st["prefix_trie"] = len(self._prefix) if self._prefix is not None \
            else 0
        st["cached"] = len(self._cached)
        return st

    def pressure_stats(self) -> Dict[str, Any]:
        """The JAX engine's pressure telemetry, key for key (the ladder,
        the prefix counters, the tier's spills and promotes, the prefill
        mode and the disagg counters and degraded record), and the port's
        ladder outcomes: parks with state, resumes (by promote), and the
        prefetches staged and consumed."""
        pc = self._prefix
        on = pc is not None            # (an empty trie is falsy)
        return {"tick": self.tick,
                "preemptions": self.preemptions,
                "migrations": self.migrations,
                "grant_denials": self.grant_denials,
                "shed": len(self.shed),
                "parked": len(self.preempted),
                "straggler_ticks": self.straggler_ticks,
                "overloaded": self.overloaded(),
                "shared_blocks": self._alloc.shared_blocks,
                "prefix_hits": pc.hits if on else 0,
                "prefix_hit_tokens": pc.hit_tokens if on else 0,
                "prefix_trie": len(pc) if on else 0,
                "prefix_rides": self.prefix_rides,
                "cow_copies": self.cow_copies,
                "spills": self._alloc.spills,
                "promotes": self._alloc.promotes,
                "cached_blocks": len(self._cached),
                "prefill_mode": self.prefill_mode,
                "degraded": (self.degraded.to_json()
                             if self.degraded is not None else None),
                "disagg_dispatches": self.disagg_dispatches,
                "disagg_chunks": self.disagg_chunks,
                "disagg_resumes": self.disagg_resumes,
                "disagg_inflight": len(self._disagg),
                "parks_with_state": self.parks_with_state,
                "resumes": self.resumes,
                "resumes_by_promote": self.resumes_by_promote,
                "prefetch_staged": self.prefetch_staged,
                "prefetch_consumed": self.prefetch_consumed}

    def _place_on_mesh(self, mesh) -> None:
        """Keep this rank's pieces of the params (the plan's axis rules,
        :func:`repro_torch.core.passes.lowering.param_pspecs`) and of the
        session cache (:func:`repro_torch.dist.sharding.cache_pspecs`;
        ``pos`` and ``block_tbl`` stay whole), and tell the model code
        where the kv rows lie (``RunCfg.kv_split``, ``kv_whole``)."""
        from repro_torch.serve.sharded import MeshPieces
        pieces = MeshPieces(mesh, self.plan, self.arch, self.params,
                            self.cache)
        # refuse, before the cache exists, an instance this rank would
        # launch that is not built: its flash group and the decode its
        # cache's split runs (K8, K9 or the fused kernels)
        lm.check_on_device(self.arch, self.device, lm.kernel_instances(
            self.arch, "decode", self.plan,
            flash_tiles=self.cfg.flash_tiles,
            cache_split=(pieces.kv_split,
                         self.arch.hd // pieces.coln
                         if pieces.kv_split == "head_dim" else 0,
                         pieces.paged)))
        self.params = pieces.place_params(self.params)
        self.cache = pieces.place_cache(self.cache, self.device)
        self.pieces = pieces
        if self.host_blocks:
            self._host = lm.init_host_pool(
                self.arch, self.host_blocks, self.block_len,
                kv_heads=pieces.host_kv_heads)
        whole = self.n_blocks if self.kv_residency == "paged" \
            else self.max_len
        self.cfg = dataclasses.replace(
            self.cfg, kv_split=pieces.kv_split,
            kv_whole=(self.max_batch, whole))

    @property
    def decode_path(self) -> str:
        """What the decode ticks run.  On one card: the paged or dense
        decode kernel on the card, its plain version on the CPU; for an
        attention-free arch the SSM recurrence (plain PyTorch on either
        device).  On a mesh, the JAX engine's names where its
        ``shard_map_flash`` runs: ``shard_map_flash_paged_2d`` (the pool
        split 2-D), ``shard_map_flash`` (the seq dim or the pool split
        over the model axis), ``flash`` (the plan's ``shard_map_flash``
        on a placement that does not split the rows); where the kv
        heads split, the kernel names, each rank decoding its heads; and
        where the cache splits on head_dim, ``decode_split`` (K9)."""
        if self.pieces is not None and self.cfg.kv_split == "rows":
            from repro_torch.dist.flash_decode import pool_sharding_kind
            if self.kv_residency == "paged" and pool_sharding_kind(
                    self.cfg.mesh, self.n_blocks, self.max_batch,
                    self.cfg.data_axes, self.cfg.model_axis) == "2d":
                return "shard_map_flash_paged_2d"
            return "shard_map_flash"
        if self.pieces is not None and \
                self.cfg.decode_impl == "shard_map_flash":
            return "flash"
        on_card = self.device.type == "cuda"
        if self.pieces is not None and self.cfg.kv_split == "head_dim":
            return f"decode_split:{'cuda' if on_card else 'plain'}"
        if not self.arch.has_attention:
            return f"ssm_recurrence:{'cuda' if on_card else 'cpu'}"
        kernel = ("paged_decode_attention" if self.kv_residency == "paged"
                  else "decode_attention")
        return f"{kernel}:{'cuda' if on_card else 'plain'}"

    @property
    def combine_topology(self) -> str:
        """The model-axis combine the decode ticks run
        (:func:`repro_torch.dist.flash_decode.combine_topology` with the
        config's override); ``"flat"`` on paths with no cross-rank
        combine."""
        if self.decode_path not in ("shard_map_flash",
                                    "shard_map_flash_paged_2d"):
            return "flat"
        from repro_torch.dist.flash_decode import combine_topology
        return combine_topology(self.cfg.mesh,
                                model_axis=self.cfg.model_axis,
                                override=self.cfg.combine_topology)

    def telemetry(self) -> Dict[str, Any]:
        """One JSON-serializable snapshot of the engine (in disagg mode
        with the fleet's supervision counters)."""
        fleet = self._fleet.stats() if self._fleet is not None else None
        return {
            "tick": self.tick,
            "decode_path": self.decode_path,
            "combine_topology": self.combine_topology,
            "kv_residency": self.kv_residency,
            "kv_admission": self.kv_admission,
            "prefill_mode": self.prefill_mode,
            "requests": {"pending": len(self.pending),
                         "active": len(self.active),
                         "finished": len(self.finished),
                         "shed": len(self.shed),
                         "parked": len(self.preempted),
                         "disagg_inflight": len(self._disagg)},
            "kv_prefix_reuse": self.kv_prefix_reuse,
            "kv_host_blocks": self.host_blocks,
            "kv_prefetch": self.kv_prefetch,
            "prefill": {"calls": self.prefill_calls,
                        "batches": [int(b) for b in
                                    list(self.prefill_batches)[-32:]],
                        "rides": self.prefix_rides,
                        "disagg": {"dispatches": self.disagg_dispatches,
                                   "chunks": self.disagg_chunks,
                                   "resumes": self.disagg_resumes,
                                   "fleet": fleet}},
            "blocks": {k: int(v) for k, v in self.block_stats().items()},
            "pressure": self.pressure_stats(),
            "tier_ms": dict(self.tier_ms),
            "straggler_ticks": self.straggler_ticks,
            "kernel_launches": ops.launch_counts(),
        }

    def _recent_preemptions(self) -> int:
        lo = self.tick - self.preemption.shed_window_ticks
        return sum(1 for t in self._preempt_ticks if t > lo)

    def overloaded(self) -> bool:
        """True while the recent preemption rate says new admissions
        would only thrash (the load-shedding trigger)."""
        return (self._recent_preemptions()
                > self.preemption.shed_rate
                * self.preemption.shed_window_ticks)

    def _slot_group(self, slot: int) -> int:
        """The sub-pool that hosts a slot: contiguous slot ranges map 1:1
        onto the sub-pools."""
        return slot * self.pool_groups // self.max_batch

    # ---------------- prefix matching at admission --------------------
    def _match_info(self, r: Request) -> Optional[MatchInfo]:
        """``r``'s match state for one admission pass (``None`` with
        prefix reuse off)."""
        if self._prefix is None:
            return None
        return {"hashes": chain_hashes(r.feed_tokens, self.block_len),
                "matches": {}}

    def _match_for(self, r: Request, info: Optional[MatchInfo],
                   group: int) -> List[int]:
        """The block ids of ``r``'s longest resident prefix in
        ``group``'s trie, capped one token short of the whole feed: the
        last feed token's compute always runs here (its logits seed the
        first sample; a resumed request's next tick appends its row)."""
        if info is None:
            return []
        got = info["matches"].get(group)
        if got is None:
            got = self._prefix.match(info["hashes"], group)
            got = got[:(len(r.feed_tokens) - 1) // self.block_len]
            info["matches"][group] = got
        return got

    def _bucket_key(self, r: Request, matched: List[int]):
        """Admission bucket identity ``(matched_tokens, tail_tokens)``:
        one tail prefill per bucket, so every member skips the same
        rows."""
        flen = len(r.feed_tokens)
        if self._skip_prefix and matched:
            m = len(matched) * self.block_len
            return (m, flen - m)
        return (0, flen)

    def _can_ride(self, r: Request, matched: List[int]) -> bool:
        """True when admission skips prefill entirely: a fresh request
        whose whole feed but its last token is aliased.  The first decode
        tick feeds that token and samples the first output."""
        if not (self._skip_prefix and matched and not r.out_tokens):
            return False
        if r.max_new_tokens <= 1:
            return False      # satisfied by the sample; never holds blocks
        return len(matched) * self.block_len == len(r.feed_tokens) - 1

    def _register_prefix(self, r: Request, info: Optional[MatchInfo],
                         group: int) -> None:
        """Index ``r``'s full feed blocks in its sub-pool's trie (first
        writer wins) and keep the hashes for migration and resume."""
        if self._prefix is None or info is None or not r.blocks:
            return
        hashes = info["hashes"]
        r.prefix_hashes = list(hashes)
        self._prefix.insert(hashes, r.blocks[:len(hashes)], group)

    def _release_blocks(self, blocks: List[int]) -> None:
        """A holder lets go of ``blocks`` (:meth:`_free`).  With the host
        tier on, a block whose last holder is releasing but which the
        trie still indexes stays resident in the engine's cold-block
        cache instead."""
        if self.kv_tiering and self._prefix is not None:
            kept = []
            for b in blocks:
                if self._alloc.refcount(b) == 1 \
                        and self._prefix.has_block(b) \
                        and b not in self._cached:
                    self._cached[b] = None
                else:
                    kept.append(b)
            blocks = kept
        if blocks:
            self._free(blocks)

    def _free(self, blocks: List[int]) -> List[int]:
        """Drop one holder reference per block and prune the trie entries
        of the blocks that actually left the pool (a freed id's next
        tenant writes unrelated rows).  Returns those blocks."""
        freed = self._alloc.release(blocks)
        if self._prefix is not None and freed:
            self._prefix.evict(freed)
        return freed

    # ---------------- tier transitions + spill scheduler --------------
    def _ids(self, ids: List[int]) -> torch.Tensor:
        return torch.as_tensor(ids, dtype=torch.long, device=self.device)

    def _spill_rows(self, pairs: List[Tuple[int, int]]) -> None:
        """Copy the k/v rows of just-spilled blocks into the host pool,
        synchronously: the vacated pool ids are already free, and the
        copy must end before a next tenant writes them.  On a mesh each
        rank copies its piece of the tier's rows (:meth:`_read_blocks`:
        its heads, or every head of a block gathered from its owner)."""
        t0 = time.perf_counter()
        old = [b for b, _ in pairs]
        idx = [h - self.n_blocks for _, h in pairs]
        for key in ("k", "v"):
            self._host[key][:, idx] = self._read_blocks(key, old).cpu()
        self.tier_ms["spill"] += (time.perf_counter() - t0) * 1e3

    def _promote_rows(self, pairs: List[Tuple[int, int]],
                      k_rows: Optional[torch.Tensor] = None,
                      v_rows: Optional[torch.Tensor] = None) -> None:
        """Copy spilled k/v rows back into the pool at the pairs' new ids:
        from the staged device rows when a prefetch landed them (the
        caller ordered this stream after their copy), else a host →
        device copy of the host pool's rows; then one scatter per
        tensor."""
        t0 = time.perf_counter()
        new = [b for _, b in pairs]
        if k_rows is None:
            idx = [h - self.n_blocks for h, _ in pairs]
            k_rows, v_rows = self._host["k"][:, idx], self._host["v"][:, idx]
        self._write_blocks("k", new, k_rows)
        self._write_blocks("v", new, v_rows)
        self.tier_ms["promote"] += (time.perf_counter() - t0) * 1e3

    def _promote_matched(self, matched: List[int], group: int) -> List[int]:
        """Resolve a matched block list to pool ids (hit-after-spill):
        ids promoted earlier in this admission pass are followed through
        ``_promo_map``; host-tier blocks are promoted into ``group`` now,
        their rows copied back and trie and cold-cache entries re-keyed.
        Placement budgeted the draws (:meth:`_hbm_matched`)."""
        if not self.kv_tiering or not matched:
            return list(matched)
        out = [self._promo_map.get(b, b) for b in matched]
        host_ids = [b for b in out if self._alloc.tier_of(b) == "host"]
        if not host_ids:
            return out
        pairs = self._alloc.promote(host_ids, group)
        assert pairs is not None, "placement budgeted the promote draw"
        self._promote_rows(pairs)
        self._prefix.rekey(pairs, "hbm")
        for old, new in pairs:
            if old in self._cached:
                del self._cached[old]
                self._cached[new] = None
            self._promo_map[old] = new
        trans = dict(pairs)
        return [trans.get(b, b) for b in out]

    def _evict_cached_host(self, n: int) -> int:
        """Drop up to ``n`` oldest engine-cached host-tier blocks (free
        the ids, prune the trie): the host pool's own reclamation."""
        victims = [b for b in self._cached
                   if self._alloc.tier_of(b) == "host"][:n]
        for b in victims:
            del self._cached[b]
            self._free([b])
        return len(victims)

    def _spill_cold(self, group: int, need: int) -> int:
        """The rung before the ladder: free up to ``need`` pool blocks of
        ``group`` by moving the oldest unpinned cold cached blocks to the
        host tier (evicting the oldest cached host block when the host
        pool is full, dropping the cold block when there is no host room
        at all).  Returns the blocks freed."""
        if not self.kv_tiering:
            return 0
        freed = 0
        while freed < need:
            cand = next((b for b in self._cached if b < self.n_blocks
                         and self._alloc.group_of(b) == group
                         and self._alloc.refcount(b) == 1), None)
            if cand is None:
                break
            if self._alloc.host_free == 0:
                self._evict_cached_host(1)
            if self._alloc.host_free > 0:
                pairs = self._alloc.spill([cand])
                assert pairs is not None, "host headroom was just checked"
                self._spill_rows(pairs)
                self._prefix.rekey(pairs, "host")
                del self._cached[cand]
                self._cached[pairs[0][1]] = None
            else:
                del self._cached[cand]
                self._free([cand])
            freed += 1
        return freed

    def spill_cached(self, group: Optional[int] = None) -> int:
        """Force-spill every unpinned cached pool block to the host tier
        (the ops/test hook that drives hit-after-spill without real pool
        pressure).  Returns the number of blocks spilled."""
        total = 0
        for g in (range(self.pool_groups) if group is None else [group]):
            n = sum(1 for b in self._cached
                    if b < self.n_blocks and self._alloc.group_of(b) == g
                    and self._alloc.refcount(b) == 1)
            total += self._spill_cold(g, n)
        return total

    def drop_block_cache(self) -> int:
        """Release every engine-cached cold block (both tiers) and prune
        their trie entries, so that ``free == total`` per tier once no
        request is live.  Returns the number of blocks freed."""
        blocks = list(self._cached)
        self._cached.clear()
        return len(self._free(blocks)) if blocks else 0

    def _hbm_matched(self, matched: List[int]) -> int:
        """Matched blocks already in the pool: only those reduce the
        admission draw (a host-tier match still saves the compute, but
        its promote takes a free pool block)."""
        if not self.kv_tiering:
            return len(matched)
        return sum(1 for b in matched if self._alloc.tier_of(b) == "hbm")

    def _place(self, r: Request, avail: List[int],
               free_by_group: Dict[int, int],
               info: Optional[MatchInfo] = None) -> Optional[int]:
        """Reserve a free slot whose sub-pool covers ``r``'s admission
        need net of aliased pool blocks; both accounting structures are
        updated.  With several sub-pools the slots are tried longest
        match first, else first free first."""
        need_full = self._admission_blocks(r)
        order = list(range(len(avail)))
        if info is not None and self.pool_groups > 1:
            order.sort(key=lambda i: (
                -len(self._match_for(r, info, self._slot_group(avail[i]))),
                avail[i]))
        for i in order:
            g = self._slot_group(avail[i])
            matched = self._match_for(r, info, g) if info is not None else []
            need = max(0, need_full - self._hbm_matched(matched))
            if need <= free_by_group[g]:
                free_by_group[g] -= need
                return avail.pop(i)
        return None

    def _place_bucket(self, r: Request, info: Optional[MatchInfo], key,
                      avail: List[int],
                      free_by_group: Dict[int, int]) -> Optional[int]:
        """Like :meth:`_place`, but only into a slot whose sub-pool's
        match keeps ``r`` in the head request's admission bucket."""
        need_full = self._admission_blocks(r)
        for i, s in enumerate(avail):
            g = self._slot_group(s)
            matched = self._match_for(r, info, g) if info is not None else []
            if self._bucket_key(r, matched) != key:
                continue
            need = max(0, need_full - self._hbm_matched(matched))
            if need <= free_by_group[g]:
                free_by_group[g] -= need
                return avail.pop(i)
        return None

    def _free_by_group(self) -> Dict[int, int]:
        return {g: self._alloc.free_in(g) for g in range(self.pool_groups)}

    # ------------------------------------------------------------------
    def _admit(self) -> None:
        """Bucketed batched admission: every pending prompt sharing the
        head-of-line's bucket — feed length, plus the matched-prefix
        length when prefix reuse aliases resident blocks — that fits a
        (slot, sub-pool) pair is prefilled in one call (tail-only when a
        prefix is aliased).  A request whose whole feed but its last
        token is resident rides straight to decode.  When no pair covers
        the head request, cold cached blocks spill to the host tier and
        the placement is retried once; then admission waits for a
        finisher (head-of-line blocking, so exhaustion delays rather than
        starves).  In disagg mode admission goes through
        :meth:`_admit_disagg` instead."""
        if self._fleet is not None and self.prefill_mode == "disagg":
            self._admit_disagg()
            return
        self._promo_map.clear()        # the promoted-id map is per pass
        while self.pending and self.free_slots:
            head = self.pending[0]
            info0 = self._match_info(head)
            avail = list(self.free_slots)
            fbg = self._free_by_group()
            s0 = self._place(head, avail, fbg, info0)
            if s0 is None:
                if not (self.kv_tiering and self._cached):
                    return             # pool exhausted: wait for frees
                need0 = self._admission_blocks(head)
                for g in range(self.pool_groups):
                    short = need0 - self._alloc.free_in(g)
                    if short > 0:
                        self._spill_cold(g, short)
                # the match memo is stale after a rekey
                info0 = self._match_info(head)
                avail = list(self.free_slots)
                fbg = self._free_by_group()
                s0 = self._place(head, avail, fbg, info0)
                if s0 is None:
                    return             # truly exhausted: wait for frees
            m0 = self._match_for(head, info0, self._slot_group(s0))
            if self._can_ride(head, m0):
                self.pending.pop(0)
                self.free_slots.remove(s0)
                self._admit_ride(head, s0, info0)
                continue
            key0 = self._bucket_key(head, m0)
            group, slots, matches = [head], [s0], [m0]
            infos, rest = [info0], []
            for r in self.pending[1:]:
                s, info = None, None
                if len(r.feed_tokens) == len(head.feed_tokens):
                    info = self._match_info(r)
                    s = self._place_bucket(r, info, key0, avail, fbg)
                if s is None:
                    rest.append(r)
                else:
                    group.append(r)
                    slots.append(s)
                    matches.append(
                        self._match_for(r, info, self._slot_group(s)))
                    infos.append(info)
            self.pending = rest
            for s in slots:
                self.free_slots.remove(s)
            # hit-after-spill: matches may name host-tier (or just
            # promoted) blocks; resolve them before any read of the pool
            matches = [self._promote_matched(m, self._slot_group(s))
                       for m, s in zip(matches, slots)]
            self._admit_group(group, slots, matches, infos, key0)

    # ---------------- disaggregated prefill paths ---------------------
    def _admit_disagg(self) -> None:
        """Head-of-line admission in disagg mode
        (``src/repro/serve/engine.py:1173``): a feed that rides still
        rides inline (no prefill either way); every other reserves a slot
        and its whole admission budget and is dispatched to the fleet.
        A partial prefix match is not aliased on this path: the worker
        computes the whole feed and the trie indexes the finished blocks
        at completion."""
        self._promo_map.clear()
        while self.pending and self.free_slots:
            head = self.pending[0]
            info = self._match_info(head)
            avail = list(self.free_slots)
            s_alias = self._place(head, avail, self._free_by_group(), info)
            if s_alias is not None and self._can_ride(
                    head, self._match_for(head, info,
                                          self._slot_group(s_alias))):
                self.pending.pop(0)
                self.free_slots.remove(s_alias)
                self._admit_ride(head, s_alias, info)
                continue
            s0 = self._place(head, list(self.free_slots),
                             self._free_by_group(), None)
            if s0 is None and self.kv_tiering and self._cached:
                # the tier rung: spill cold cached blocks, retry once
                need0 = self._admission_blocks(head)
                for g in range(self.pool_groups):
                    short = need0 - self._alloc.free_in(g)
                    if short > 0:
                        self._spill_cold(g, short)
                s0 = self._place(head, list(self.free_slots),
                                 self._free_by_group(), None)
            if s0 is None:
                return             # pool exhausted: wait for frees
            if head.rid in self._inline_poison:
                # this rid's worker prefill raised: run it in-process
                self.pending.pop(0)
                self.free_slots.remove(s0)
                self._admit_group([head], [s0], [[]], [None],
                                  (0, len(head.feed_tokens)))
                continue
            if not self._dispatch_prefill(head, s0):
                return             # no live worker (a respawn in flight)
            self.pending.pop(0)
            self.free_slots.remove(s0)

    def _dispatch_prefill(self, r: Request, slot: int,
                          start_block: int = 0,
                          flight: Optional[_DisaggFlight] = None) -> bool:
        """Ship ``r``'s feed to the fleet.  A fresh dispatch draws the
        admission blocks first (the journal's scatter target); a
        re-dispatch (``flight`` set) keeps them and gathers the journaled
        blocks' rows back out of the pool as the worker's resume prefix
        (the rows a whole prefill would have computed)."""
        g = self._slot_group(slot)
        fresh = flight is None
        if fresh:
            blocks = self._alloc.allocate(self._admission_blocks(r), g)
            if blocks is None:
                return False       # placement said yes; lost the race
            r.blocks = blocks
        pk = pv = None
        if start_block:
            ids = r.blocks[:start_block]
            m = start_block * self.block_len
            pk, pv = (self._whole_rows(key, ids) for key in ("k", "v"))
            pk, pv = (t.reshape(t.shape[0], m, *t.shape[3:])
                      for t in (pk, pv))
        feed = r.feed_tokens
        ok = self._fleet.dispatch(r.rid, feed[start_block * self.block_len:],
                                  prefix_k=pk, prefix_v=pv)
        if not ok:
            if fresh and r.blocks:
                self._release_blocks(r.blocks)
                r.blocks = []
            return False
        if fresh:
            r.slot = int(slot)
            self._disagg[r.rid] = _DisaggFlight(
                request=r, slot=slot, group=g,
                nb_feed=-(-len(feed) // self.block_len))
        elif start_block:
            self.disagg_resumes += 1
        self.disagg_dispatches += 1
        return True

    def _on_chunk(self, fl: _DisaggFlight, idx: int, k_rows: torch.Tensor,
                  v_rows: torch.Tensor) -> None:
        """Scatter one streamed pool-block-shaped slab (host ``(L, t, K,
        hd)`` rows) into its pool block and advance the journal.  A chunk
        re-sent after a re-dispatch overwrites equal rows (same chunks,
        same deterministic kernels): idempotent.  A request with no
        blocks (satisfied by the prefill sample) needs only the logits,
        so its chunks drop."""
        r = fl.request
        if not r.blocks or idx >= len(r.blocks) or idx > fl.acked:
            return
        t0 = time.perf_counter()
        t = k_rows.shape[1]
        for key, rows in (("k", k_rows), ("v", v_rows)):
            if self.pieces is not None:
                # the worker's rows carry every head: the rank's heads,
                # into the block where this rank owns it
                rows = self.pieces.cut_heads(rows)
            rows = rows.to(self.device, non_blocking=True)
            if t < self.block_len:
                # a partial last block: zero rows past the feed (slot_len
                # masks them, as the inline scatter's clamped rows)
                rows = torch.nn.functional.pad(
                    rows, (0, 0, 0, 0, 0, self.block_len - t))
            self._write_blocks(key, [r.blocks[idx]], rows[:, None])
        self.tier_ms["disagg_chunk"] += (time.perf_counter() - t0) * 1e3
        self.disagg_chunks += 1
        if t == self.block_len and idx == fl.acked:
            fl.acked = idx + 1

    def _complete_prefill(self, fl: _DisaggFlight,
                          logits: torch.Tensor) -> None:
        """A worker finished a prompt: install the table row, activate the
        slot, and (for a fresh request) sample the first token from the
        streamed logits, as the inline prefill would."""
        r, slot = fl.request, fl.slot
        del self._disagg[r.rid]
        if r.rid in self._redispatch:
            self._redispatch.remove(r.rid)
        self.prefill_calls += 1
        self.prefill_batches.append(1)
        if r.blocks:
            self._table_row(slot, r.blocks)
        if not r.out_tokens:
            tok = self._sample(logits.to(self.device)[None],
                               [r.temperature])[0]
            r.out_tokens.append(tok)
            r.t_first = time.time()
            if len(r.out_tokens) >= r.max_new_tokens:
                r.done = True
                r.t_done = r.t_first
                self.finished.append(r)
                self._release_slot(slot, r)
                return
        # a resumed re-prefill keeps its tokens: the sample these logits
        # would give is already on the request
        self.slot_len[slot] = len(r.feed_tokens)
        r.slot = int(slot)
        self.active[slot] = r
        if self._prefix is not None and r.blocks:
            hashes = chain_hashes(r.feed_tokens, self.block_len)
            r.prefix_hashes = list(hashes)
            self._prefix.insert(hashes, r.blocks[:len(hashes)], fl.group)
            self._prefix.misses += 1

    def _abort_flight(self, fl: _DisaggFlight) -> None:
        """Retire a flight: journal dropped, blocks released, slot
        returned; the fleet-side cancel drops any late chunk of a worker
        still running it."""
        r = fl.request
        self._disagg.pop(r.rid, None)
        if r.rid in self._redispatch:
            self._redispatch.remove(r.rid)
        if self._fleet is not None:
            self._fleet.cancel(r.rid)
        if r.blocks:
            self._release_blocks(r.blocks)
            r.blocks = []
        r.slot = -1
        self.free_slots.append(fl.slot)
        self.slot_len[fl.slot] = 0
        fl.acked = 0

    def _on_worker_error(self, rid: int, err: str) -> None:
        """A worker's prefill *raised* for this request (a poison input,
        not a death): re-dispatching would loop, so the flight aborts and
        the request re-queues marked inline-only."""
        fl = self._disagg.get(rid)
        if fl is None:
            return
        self._abort_flight(fl)
        self._inline_poison.add(rid)
        self.pending.insert(0, fl.request)

    def _mesh_clock(self) -> float:
        """The mesh's first rank's ``time.time()`` on every rank (every
        rank must call it at the same point)."""
        return float(self.pieces.bcast_object(
            time.time() if self.pieces.is_root else None))

    def _now(self) -> float:
        """The wall clock the deadline decisions read: ``time.time()`` on
        one card; on a mesh the first rank's at the start of this tick,
        so every rank sheds, spares and picks victims alike."""
        return time.time() if self.pieces is None else self._mesh_now

    def _shed_expired_flights(self) -> None:
        """A request whose deadline passes mid-prefill sheds as a pending
        one does: blocks released, ``Request.error`` set."""
        if not any(fl.request.deadline is not None
                   for fl in self._disagg.values()):
            return
        now = self._now()
        for fl in list(self._disagg.values()):
            r = fl.request
            if r.deadline is not None and now > r.deadline:
                self._abort_flight(fl)
                self._shed(r, f"deadline missed during disagg prefill "
                              f"(tick {self.tick})")

    def _enter_degraded(self) -> None:
        """Every fleet slot retired past its restart budget: prefill goes
        back in-process under a typed ``DegradedMode``, and the orphaned
        flights re-queue at the front of the pending queue, oldest first
        (greedy decoding gives the same tokens: the inline prefill
        rebuilds the KV the workers would have streamed)."""
        if self.degraded is not None:
            return
        self.degraded = dataclasses.replace(self._fleet.degraded,
                                            at_tick=self.tick)
        for rid in sorted(self._disagg, reverse=True):
            fl = self._disagg[rid]
            self._abort_flight(fl)
            self.pending.insert(0, fl.request)
        self._redispatch = []
        self._fleet.shutdown()

    def _poll_disagg(self) -> None:
        """Drain the fleet's events: scatter chunks, complete prefills,
        queue re-dispatches for the rids a death orphaned, degrade when
        the whole fleet has retired; then retry the queued re-dispatches,
        each resuming at its last journaled block (never past the feed's
        last block, so the worker has a tail token to take the logits
        from)."""
        if self._fleet is None or self.degraded is not None:
            return
        for ev in self._fleet.poll():
            kind, fl = ev[0], self._disagg.get(ev[1])
            if kind == "chunk" and fl is not None:
                self._on_chunk(fl, ev[2], ev[3], ev[4])
            elif kind == "done" and fl is not None:
                self._complete_prefill(fl, ev[2])
            elif kind == "dead" and fl is not None \
                    and ev[1] not in self._redispatch:
                self._redispatch.append(ev[1])
            elif kind == "error":
                self._on_worker_error(ev[1], ev[2])
        if self._fleet.degraded is not None:
            self._enter_degraded()
            return
        still: List[int] = []
        for rid in self._redispatch:
            fl = self._disagg.get(rid)
            if fl is None:
                continue
            start = (min(fl.acked, fl.nb_feed - 1) if fl.request.blocks
                     else 0)
            if not self._dispatch_prefill(fl.request, fl.slot,
                                          start_block=start, flight=fl):
                still.append(rid)
        self._redispatch = still

    def _table_row(self, slot: int, blocks: List[int]) -> None:
        """Install one slot's table row (-1 past its blocks)."""
        row = torch.full((self.cache["block_tbl"].shape[1],), -1,
                         dtype=torch.int32)
        row[:len(blocks)] = torch.as_tensor(blocks, dtype=torch.int32)
        self.cache["block_tbl"][slot] = row.to(self.device)

    def _admit_ride(self, r: Request, slot: int, info: MatchInfo) -> None:
        """Zero-prefill admission: alias the matched blocks, draw the
        fresh ones the budget calls for, install the table row, and hand
        the request to decode at position ``matched_tokens``."""
        g = self._slot_group(slot)
        matched = self._promote_matched(self._match_for(r, info, g), g)
        need = self._admission_blocks(r)
        self._alloc.retain(matched)
        fresh = self._alloc.allocate(need - len(matched), g)
        assert fresh is not None, "placement checked the free count"
        r.blocks = list(matched) + fresh
        self._table_row(slot, r.blocks)
        r.slot = int(slot)
        m_tok = len(matched) * self.block_len
        self.slot_len[slot] = m_tok
        self.active[slot] = r
        self._register_prefix(r, info, g)
        self._prefix.hits += 1
        self._prefix.hit_tokens += m_tok
        self.prefix_rides += 1

    def _admit_group(self, group: List[Request], slots: List[int],
                     matches: List[List[int]],
                     infos: List[Optional[MatchInfo]], bucket) -> None:
        """One prefill call for a bucket of requests, each with a
        pre-reserved slot (its sub-pool is the one its blocks come
        from).  A resumed (preempted, stateless) request's feed is its
        prompt plus the tokens generated but the last: the prefill
        rebuilds its KV rows and its sample is not drawn (the request
        already holds the token).  With a matched-prefix bucket, only the
        tails run (:func:`repro_torch.models.lm.prefill_tail`, reading
        the aliased rows from the pool); the matched blocks are aliased,
        not rewritten.  The batch is padded to the next power of two
        (dummy rows repeat the first request and are discarded)."""
        m_tok = bucket[0]
        toks = np.stack([r.feed_tokens[m_tok:] for r in group])
        padded = 1
        while padded < len(group):
            padded *= 2
        padded = min(padded, self.max_batch)
        extra = padded - len(group)
        if extra:
            toks = np.concatenate([toks, np.repeat(toks[:1], extra, axis=0)])
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        cacheg = tail_k = tail_v = None
        if m_tok:
            blk = np.asarray(matches, np.int64)            # (Bs, nbm)
            if extra:
                blk = np.concatenate([blk, np.repeat(blk[:1], extra, 0)])
            if self.pieces is not None:
                # the prefix rows from the pool's ranks, (L, B, M, K, hd)
                pk, pv = (self._read_blocks(key, blk.reshape(-1).tolist())
                          .reshape(self.cache[key].shape[0], blk.shape[0],
                                   blk.shape[1] * self.block_len,
                                   *self.cache[key].shape[3:])
                          for key in ("k", "v"))
                logits, tail_k, tail_v = lm.prefill_tail_rows(
                    self.arch, self.params, batch, self.cfg, pk, pv)
            else:
                logits, tail_k, tail_v = lm.prefill_tail(
                    self.arch, self.params, batch, self.cfg,
                    self.cache["k"], self.cache["v"], torch.from_numpy(blk))
        else:
            logits, cacheg = lm.prefill(self.arch, self.params, batch,
                                        self.cfg, max_len=toks.shape[1])
        self.prefill_calls += 1
        self.prefill_batches.append(len(group))
        fresh = [i for i, r in enumerate(group) if not r.out_tokens]
        first = (self._sample(logits[fresh],
                              [group[i].temperature for i in fresh])
                 if fresh else [])
        t_first = time.time()
        live: List[Request] = []
        idxs: List[int] = []
        for i, tok in zip(fresh, first):
            r = group[i]
            r.out_tokens.append(tok)
            r.t_first = t_first
        for i, r in enumerate(group):
            if len(r.out_tokens) >= r.max_new_tokens:
                # the prefill sample met the budget: no decode tick, no
                # blocks, and the reserved slot goes back
                r.done = True
                r.t_done = r.t_first
                self.finished.append(r)
                self.free_slots.append(slots[i])
            else:
                live.append(r)
                idxs.append(i)
        if not live:
            return
        plen = len(live[0].feed_tokens)
        live_slots = np.asarray([slots[i] for i in idxs], np.int64)
        gidx = np.asarray(idxs, np.int64)
        live_matches = [matches[i] for i in idxs]
        st = torch.from_numpy(live_slots).to(self.device)
        gi = torch.from_numpy(gidx).to(self.device)
        if self.kv_residency == "paged":
            if m_tok:
                self._scatter_tail(live, live_slots, gi, tail_k, tail_v,
                                   plen, m_tok, live_matches)
            else:
                self._scatter_paged_prefill(live, live_slots, gidx, cacheg,
                                            plen, live_matches)
        elif self.arch.has_attention and self.pieces is not None:
            for key in ("k", "v"):
                self.pieces.write_slots(self.cache[key], live_slots,
                                        cacheg[key][:, gi], plen)
        elif self.arch.has_attention:
            for key in ("k", "v"):
                self.cache[key][:, st, :plen] = cacheg[key][:, gi]
        for key in ("ssm", "conv"):
            if key in self.cache:
                self._write_state(key, live_slots, cacheg[key][:, gi])
        for slot, r in zip(live_slots, live):
            r.slot = int(slot)
            self.slot_len[slot] = plen
            self.active[int(slot)] = r
        for i, r in enumerate(live):
            self._register_prefix(r, infos[idxs[i]],
                                  self._slot_group(int(live_slots[i])))
            if self._prefix is not None:
                if live_matches[i]:
                    self._prefix.hits += 1
                    self._prefix.hit_tokens += \
                        len(live_matches[i]) * self.block_len
                else:
                    self._prefix.misses += 1

    def _draw_blocks(self, r: Request, matched: List[int],
                     slot: int) -> List[int]:
        """``r``'s admission budget from its slot's sub-pool: the matched
        blocks aliased (refcount bump), the rest drawn fresh (reserved
        at placement, so the draw cannot fail)."""
        if matched:
            self._alloc.retain(matched)
        fresh = self._alloc.allocate(
            self._admission_blocks(r) - len(matched), self._slot_group(slot))
        assert fresh is not None, "admission reserved these blocks"
        r.blocks = list(matched) + fresh
        return r.blocks

    def _install_rows(self, live: List[Request], slots: np.ndarray) -> None:
        """Install the live requests' table rows (-1 past each
        allocation)."""
        rows = np.full((len(live), self.cache["block_tbl"].shape[1]), -1,
                       np.int32)
        for i, r in enumerate(live):
            rows[i, :len(r.blocks)] = r.blocks
        self.cache["block_tbl"][torch.from_numpy(slots).to(self.device)] = \
            torch.from_numpy(rows).to(self.device)

    def _scatter_paged_prefill(self, live: List[Request], slots: np.ndarray,
                               gidx: np.ndarray, cacheg, plen: int,
                               matches: List[List[int]]) -> None:
        """Move a bucket's prefilled KV rows into their pool blocks: each
        survivor draws its budget (:meth:`_draw_blocks`); only the
        unmatched feed columns are scattered, in one gather/scatter per
        cache tensor (a matched block already holds those rows)."""
        bl = self.block_len
        nbp = -(-plen // bl)               # blocks holding prefilled rows
        ent_req: List[int] = []            # prefill batch row per block
        ent_col: List[int] = []            # feed block column per block
        ent_blk: List[int] = []            # destination pool block
        for i, r in enumerate(live):
            blocks = self._draw_blocks(r, matches[i], int(slots[i]))
            assert len(blocks) >= nbp >= len(matches[i]), \
                (len(blocks), nbp, len(matches[i]))
            for c in range(len(matches[i]), nbp):
                ent_req.append(int(gidx[i]))
                ent_col.append(c)
                ent_blk.append(blocks[c])
        if ent_blk:
            S = cacheg["k"].shape[2]
            dev = self.device
            req = torch.as_tensor(ent_req, device=dev)[:, None]
            # rows past the prompt in its last block clamp onto the last
            # prefilled row: garbage, but masked (pos >= cache_len) until
            # a decode append overwrites them
            ridx = np.minimum(np.asarray(ent_col)[:, None] * bl
                              + np.arange(bl)[None, :], S - 1)
            ridx = torch.from_numpy(ridx).to(dev)
            for key in ("k", "v"):
                self._write_blocks(key, ent_blk, cacheg[key][:, req, ridx])
        self._install_rows(live, slots)

    def _scatter_tail(self, live: List[Request], slots: np.ndarray,
                      gi: torch.Tensor, tail_k: torch.Tensor,
                      tail_v: torch.Tensor, plen: int, m_tok: int,
                      matches: List[List[int]]) -> None:
        """The tail-prefill counterpart of :meth:`_scatter_paged_prefill`:
        the first ``m_tok`` rows were never recomputed (their blocks are
        aliased as they are); the tail's rows go to fresh blocks."""
        bl = self.block_len
        nbm, nbp = m_tok // bl, -(-plen // bl)
        tail_blocks: List[int] = []
        for i, r in enumerate(live):
            assert len(matches[i]) == nbm, (len(matches[i]), nbm)
            blocks = self._draw_blocks(r, matches[i], int(slots[i]))
            assert len(blocks) >= nbp > nbm, (len(blocks), nbp, nbm)
            tail_blocks.extend(blocks[nbm:nbp])
        ntb, T = nbp - nbm, plen - m_tok
        for key, src in (("k", tail_k), ("v", tail_v)):
            upd = src[:, gi]                           # (L, Bs, T, K, hd)
            if T < ntb * bl:
                upd = torch.nn.functional.pad(
                    upd, (0, 0, 0, 0, 0, ntb * bl - T))
            upd = upd.reshape(upd.shape[0], len(live) * ntb, bl,
                              *upd.shape[3:])
            self._write_blocks(key, tail_blocks, upd)
        self._install_rows(live, slots)

    def _write_blocks(self, key: str, ids: List[int],
                      rows: torch.Tensor) -> None:
        """``cache[key][:, ids] = rows`` (rows on any device); on a mesh,
        into the blocks this rank's pool piece holds."""
        if self.pieces is not None:
            self.pieces.write_blocks(self.cache[key], ids, rows)
        else:
            lm.scatter_blocks(self.cache[key], self._ids(ids), rows)

    def _write_state(self, key: str, slots, rows: torch.Tensor) -> None:
        """``cache[key][:, slots] = rows`` for a per-slot SSM state; on a
        mesh, into the slots this rank's piece holds."""
        if self.pieces is not None:
            self.pieces.write_state(self.cache[key], slots, rows)
        else:
            self.cache[key][:, self._ids(slots)] = rows.to(self.device)

    def _read_state(self, key: str, slots) -> torch.Tensor:
        """``cache[key][:, slots]`` of a per-slot SSM state; on a mesh,
        from the data shard that holds each slot."""
        if self.pieces is not None:
            return self.pieces.read_state(self.cache[key], slots)
        return self.cache[key][:, self._ids(slots)]

    def _read_blocks(self, key: str, ids: List[int]) -> torch.Tensor:
        """``cache[key][:, ids]``; on a mesh, gathered from the pool's
        ranks where the pool is split by blocks."""
        if self.pieces is not None:
            return self.pieces.read_blocks(self.cache[key], ids)
        return self.cache[key][:, self._ids(ids)]

    def _whole_rows(self, key: str, ids: List[int]) -> torch.Tensor:
        """Every kv head of blocks ``ids`` (what a prefill worker, which
        runs the whole model, resumes from); on a mesh every rank takes
        part in the gathers."""
        rows = self._read_blocks(key, ids)
        return self.pieces.whole_heads(rows) if self.pieces is not None \
            else rows

    def _read_stripe(self, key: str, slot: int, n: int) -> torch.Tensor:
        """The first ``n`` rows of a dense slot's stripe, ``(L, n, K,
        hd)``; on a mesh the rank's heads, from the ranks that hold the
        slot and its rows."""
        if self.pieces is not None:
            return self.pieces.read_slots(self.cache[key], [slot], n)[:, 0]
        return self.cache[key][:, slot, :n]

    def _write_stripe(self, key: str, slot: int, rows: torch.Tensor
                      ) -> None:
        """The inverse of :meth:`_read_stripe`."""
        n = rows.shape[1]
        if self.pieces is not None:
            self.pieces.write_slots(self.cache[key], np.asarray([slot]),
                                    rows[:, None].to(self.device), n)
        else:
            self.cache[key][:, slot, :n] = rows.to(self.device)

    # ---------------- grow-on-demand grants + the ladder --------------
    def _needs_block(self, r: Request) -> bool:
        """True when this tick's append row falls past the blocks the
        slot holds (decode crossed a block boundary)."""
        return len(r.blocks) < int(self.slot_len[r.slot]) \
            // self.block_len + 1

    def _grant(self, group: int) -> Optional[int]:
        """One-block grant from a sub-pool, through the chaos hook."""
        if self.grant_fault is not None and self.grant_fault():
            self.grant_denials += 1
            return None
        blk = self._alloc.allocate_one(group)
        if blk is None:
            self.grant_denials += 1
        return blk

    def _install_block(self, r: Request, blk: int) -> None:
        r.blocks.append(blk)
        self.cache["block_tbl"][r.slot, len(r.blocks) - 1] = blk

    def _ensure_grants(self) -> None:
        """Grant admission: before a decode tick every active slot must
        hold the block its append row lands in (a -1 entry would drop the
        append and corrupt the request).  A failed grant walks the
        ladder: spill a cold cached block to the host tier, else migrate
        the slot to an idler sub-pool, else preempt a victim (maybe the
        needy request itself) and retry.  After this returns, every
        remaining active slot can decode."""
        if self.kv_residency != "paged" or self.kv_admission != "grant":
            return
        for r in sorted(self.active.values(), key=lambda x: x.rid):
            guard = 0
            while self.active.get(r.slot) is r and self._needs_block(r):
                guard += 1
                assert guard <= self.max_batch + 2 * self.n_blocks + 2, \
                    "grant ladder did not converge"
                blk = self._grant(self._slot_group(r.slot))
                if blk is not None:
                    self._install_block(r, blk)
                    continue
                if self._spill_cold(self._slot_group(r.slot), 1):
                    continue
                if self._try_migrate(r):
                    continue
                self._preempt_for(r)

    # ---------------- copy-on-write barrier ---------------------------
    def _ensure_writable(self) -> None:
        """Before a decode tick no slot may append into a block with more
        than one holder: its append block is copied to a fresh one
        first.  Natural admission never shares an append block (only
        full feed chunks are aliased, one token short of the feed);
        this barrier is the structural guarantee.  Without a free block
        it spills a cold one, else preempts a victim from the slot's
        sub-pool, as a failed grant does (migration refuses shared
        blocks)."""
        if self._prefix is None or self._alloc.shared_blocks == 0:
            return
        for r in sorted(self.active.values(), key=lambda x: x.rid):
            guard = 0
            while self.active.get(r.slot) is r:
                col = int(self.slot_len[r.slot]) // self.block_len
                if col >= len(r.blocks) \
                        or self._alloc.refcount(r.blocks[col]) <= 1:
                    break          # the grant ladder owns missing blocks
                guard += 1
                assert guard <= self.max_batch + 2 * self.n_blocks + 2, \
                    "CoW ladder did not converge"
                fresh = self._grant(self._slot_group(r.slot))
                if fresh is not None:
                    self._cow_copy(r, col, fresh)
                    break
                if self._spill_cold(self._slot_group(r.slot), 1):
                    continue
                self._preempt_for(r)

    def _cow_copy(self, r: Request, col: int, fresh: int) -> None:
        """Copy ``r``'s shared append block into ``fresh`` (k/v rows in
        place, and the table entry) and drop this holder's reference to
        the original; the sharers keep it, trie entry and all."""
        old = r.blocks[col]
        for key in ("k", "v"):
            self._write_blocks(key, [fresh], self._read_blocks(key, [old]))
        self.cache["block_tbl"][r.slot, col] = fresh
        r.blocks[col] = fresh
        self._release_blocks([old])
        self.cow_copies += 1

    def _try_migrate(self, r: Request) -> bool:
        """Rung 2: move ``r`` — blocks, table row, per-slot states — to a
        free slot of an idler sub-pool that covers its holding plus the
        block it asks for (the idlest wins).  A slot holding a shared
        block stays put: the sharers' tables point at the original
        ids."""
        if self.pool_groups <= 1:
            return False
        if any(self._alloc.refcount(b) > 1 for b in r.blocks):
            return False
        src = self._slot_group(r.slot)
        need_now = len(r.blocks) + 1
        best = None
        for s2 in sorted(self.free_slots):
            g2 = self._slot_group(s2)
            if g2 == src or self._alloc.free_in(g2) < need_now:
                continue
            if best is None or self._alloc.free_in(g2) \
                    > self._alloc.free_in(self._slot_group(best)):
                best = s2
        if best is None:
            return False
        s1, s2 = r.slot, best
        g2 = self._slot_group(s2)
        new_blocks = self._alloc.allocate(need_now, g2)
        assert new_blocks is not None, "donor free count was just checked"
        old = list(r.blocks)
        if old:
            # on a mesh the old owner's rows reach the new owner (another
            # data shard's sub-pool) through the pool's ranks
            for key in ("k", "v"):
                self._write_blocks(key, new_blocks[:len(old)],
                                   self._read_blocks(key, old))
        for key in ("ssm", "conv"):
            if key in self.cache:
                self._write_state(key, [s2], self._read_state(key, [s1]))
        self._table_row(s2, new_blocks)
        self.cache["block_tbl"][s1] = -1
        self._release_blocks(old)
        r.blocks = list(new_blocks)
        if self._prefix is not None and r.prefix_hashes:
            # the moved blocks hold the same content: index them in the
            # donor sub-pool (first writer wins)
            self._prefix.insert(r.prefix_hashes,
                                r.blocks[:len(r.prefix_hashes)], g2)
        del self.active[s1]
        self.active[s2] = r
        r.slot = int(s2)
        self.free_slots.remove(s2)
        self.free_slots.append(s1)
        self.slot_len[s2] = self.slot_len[s1]
        self.slot_len[s1] = 0
        self.migrations += 1
        return True

    def _preempt_for(self, r: Request) -> None:
        """Rung 3: evict a victim from the needy slot's sub-pool (maybe
        the needy request itself).  With prefix reuse, candidates holding
        the fewest shared blocks go first: evicting a sharer frees at
        most its private blocks."""
        group = self._slot_group(r.slot)
        cands = [a for a in self.active.values()
                 if self._slot_group(a.slot) == group]
        if self._prefix is not None and len(cands) > 1:
            def shared(a: Request) -> int:
                return sum(1 for b in a.blocks
                           if self._alloc.refcount(b) > 1)
            lo = min(shared(a) for a in cands)
            cands = [a for a in cands if shared(a) == lo]
        self._preempt(self.preemption.pick_victim(cands, self._now()))

    def _preempt(self, r: Request) -> None:
        """Evict an active request to the host side.  With tiering on it
        parks with state (:meth:`_park_state`), so its resume skips the
        prefill; without tiering, or when it pins shared blocks, its
        blocks are released and its resume re-prefills prompt plus
        generated tokens.  Past its retry budget or an already-missed
        deadline it is shed instead."""
        slot = r.slot
        del self.active[slot]
        r.slot = -1
        r.preemptions += 1
        self.preemptions += 1
        self._preempt_ticks.append(self.tick)
        shed_why = ""
        delay = 0
        if r.deadline is not None and self._now() > r.deadline:
            shed_why = ("deadline missed at preemption: a re-prefill "
                        "could not finish in time")
        else:
            pol = self._backoff.setdefault(
                r.rid, self.preemption.restart_policy())
            try:
                delay = int(pol.next_delay())
            except RuntimeError:
                shed_why = ("preemption retry budget exhausted "
                            f"({self.preemption.max_preemptions})")
        state = (self._park_state(r, slot)
                 if not shed_why and self.kv_tiering else None)
        if state is not None:
            self.free_slots.append(slot)
            self.slot_len[slot] = 0
            self.preempted.append(
                PreemptedRequest(r, self.tick + delay, state))
            self.parks_with_state += 1
            return
        self._release_slot(slot, r)
        if shed_why:
            self._shed(r, shed_why)
            return
        self.preempted.append(PreemptedRequest(r, self.tick + delay))

    def _host_copy(self, t: torch.Tensor) -> torch.Tensor:
        """A host copy that owns its memory (``.cpu()`` of a CPU tensor
        would alias the cache row a next tenant overwrites)."""
        return t.to("cpu", copy=True)

    def _park_state(self, r: Request, slot: int) -> Optional[Dict[str, Any]]:
        """Capture a victim's per-slot state on the host so its resume
        needs no prefill: paged KV blocks spill to the host tier (ids
        stay on ``r.blocks``), dense stripes copy their valid rows,
        SSM/conv states their slot rows.  Returns ``None`` when it cannot
        park with state — it pins shared blocks, or the host pool cannot
        hold its blocks even after evicting cold host entries — and the
        caller falls back to the release + re-prefill park."""
        st: Dict[str, Any] = {"slot_len": int(self.slot_len[slot])}
        if self.kv_residency == "paged" and r.blocks:
            if self._host is None:
                return None
            if any(self._alloc.refcount(b) > 1 for b in r.blocks):
                return None
            short = len(r.blocks) - self._alloc.host_free
            if short > 0:
                self._evict_cached_host(short)
            if len(r.blocks) > self._alloc.host_free:
                return None
            # the spilled blocks are private copies of this sequence: a
            # trie match against them would alias state the resume owns
            if self._prefix is not None:
                self._prefix.evict(list(r.blocks))
            pairs = self._alloc.spill(list(r.blocks))
            assert pairs is not None, "host headroom was just checked"
            self._spill_rows(pairs)
            r.blocks = [h for _, h in pairs]
            st["kv_host"] = list(r.blocks)
            self.cache["block_tbl"][slot] = -1
        elif self.arch.has_attention and self.kv_residency == "dense":
            n = st["slot_len"]
            st["kv_rows"] = tuple(self._host_copy(self._read_stripe(
                key, slot, n)) for key in ("k", "v"))
        for key in ("ssm", "conv"):
            if key in self.cache:
                st[key] = self._host_copy(self._read_state(key, [slot])[:, 0])
        return st

    def preempt(self, rid: int) -> None:
        """Evict an active request (chaos/test hook and ops escape hatch;
        the engine preempts on its own when a grant fails)."""
        for r in self.active.values():
            if r.rid == rid:
                self._preempt(r)
                return
        raise KeyError(f"request {rid} is not active")

    def _shed(self, r: Request, why: str) -> None:
        assert not r.blocks, "shed request still holds blocks"
        r.error = why
        self.shed.append(r)
        self._backoff.pop(r.rid, None)

    def _shed_expired_pending(self) -> None:
        if not any(r.deadline is not None for r in self.pending):
            return
        now = self._now()
        keep: List[Request] = []
        for r in self.pending:
            if r.deadline is not None and now > r.deadline:
                self._shed(r, f"deadline missed while pending "
                              f"(tick {self.tick})")
            else:
                keep.append(r)
        self.pending = keep

    # ---------------- resume ------------------------------------------
    def _readmit_preempted(self) -> None:
        """Parked evictions whose backoff ended rejoin service.  Stateless
        parks go to the front of the pending queue (oldest rid first) and
        re-prefill; parks with state skip the queue: :meth:`_admit_resume`
        copies their state into a free slot and decode continues where
        the eviction cut in, with no prefill call.  A resume that does
        not fit this tick stays parked and retries next tick."""
        if not self.preempted:
            return
        ready = [p for p in self.preempted if p.not_before_tick <= self.tick]
        if not ready:
            return
        keep = [p for p in self.preempted if p.not_before_tick > self.tick]
        for p in sorted(ready, key=lambda p: p.request.rid, reverse=True):
            if p.parked_state is None:
                self.pending.insert(0, p.request)
                continue
            r = p.request
            if r.deadline is not None and self._now() > r.deadline:
                self._drop_parked(p)
                self._shed(r, f"deadline missed while parked "
                              f"(tick {self.tick})")
                continue
            if not self._admit_resume(p):
                keep.append(p)
        self.preempted = keep

    def _admit_resume(self, p: PreemptedRequest) -> bool:
        """Resume a park with state: promote its host KV blocks into a
        free slot's sub-pool (from the staged rows when the prefetch
        landed them), restore dense/SSM/conv rows, and hand the request
        back to decode.  No prefill call: the next tick feeds the last
        generated token at the parked position."""
        r, st = p.request, p.parked_state
        if not self.free_slots:
            return False
        host_ids = st.get("kv_host", [])
        if host_ids:
            # the free slot whose sub-pool covers the promote wins
            # (emptiest first); spill cold cached blocks to make room
            slot = None
            for s in sorted(self.free_slots,
                            key=lambda s: (-self._alloc.free_in(
                                self._slot_group(s)), s)):
                g = self._slot_group(s)
                short = len(host_ids) - self._alloc.free_in(g)
                if short > 0:
                    self._spill_cold(g, short)
                if self._alloc.free_in(g) >= len(host_ids):
                    slot = s
                    break
            if slot is None:
                return False
            g = self._slot_group(slot)
            staged = self._staged.pop(r.rid, None)
            pairs = self._alloc.promote(host_ids, g)
            assert pairs is not None, "free count was just checked"
            if staged is not None and staged[0] == tuple(host_ids):
                if staged[3] is not None:
                    torch.cuda.current_stream(self.device).wait_event(
                        staged[3])
                self._promote_rows(pairs, staged[1], staged[2])
                self.prefetch_consumed += 1
            else:
                self._promote_rows(pairs)
            r.blocks = [b for _, b in pairs]
            self._table_row(slot, r.blocks)
            if self._prefix is not None and r.prefix_hashes:
                # back in the pool, the prefix blocks are shareable again
                self._prefix.insert(r.prefix_hashes,
                                    r.blocks[:len(r.prefix_hashes)], g)
            self.resumes_by_promote += 1
        else:
            slot = min(self.free_slots)
            if "kv_rows" in st:
                for key, rows in zip(("k", "v"), st["kv_rows"]):
                    self._write_stripe(key, slot, rows)
        for key in ("ssm", "conv"):
            if key in st:
                self._write_state(key, [slot], st[key][:, None])
        self.free_slots.remove(slot)
        self.slot_len[slot] = st["slot_len"]
        r.slot = int(slot)
        self.active[slot] = r
        self.resumes += 1
        return True

    def _drop_parked(self, p: PreemptedRequest) -> None:
        """Release a parked eviction's host-side holdings (shed or
        abandoned): its host blocks go back to the host free list and any
        staged prefetch is discarded."""
        r = p.request
        self._staged.pop(r.rid, None)
        if p.parked_state and p.parked_state.get("kv_host"):
            self._free(r.blocks)
            r.blocks = []

    def _stage_prefetch(self) -> None:
        """For every park with state whose backoff ends by the next tick,
        start the host → device copy of its spilled rows now, so that
        this tick's decode runs while they stream in and the resume finds
        them on the card (``kv_prefetch="off"`` turns it off: the resume
        copies synchronously)."""
        if not (self.kv_prefetch and self.kv_tiering
                and self._host is not None):
            return
        for p in self.preempted:
            st = p.parked_state
            if st is None or not st.get("kv_host"):
                continue
            if p.not_before_tick > self.tick + 1:
                continue
            rid = p.request.rid
            ids = tuple(st["kv_host"])
            got = self._staged.get(rid)
            if got is not None and got[0] == ids:
                continue
            self._staged[rid] = (ids, *self._stage_rows(ids))
            self.prefetch_staged += 1

    def _stage_rows(self, ids: Tuple[int, ...]):
        """``(k rows, v rows, event)`` of host blocks ``ids`` on the
        engine's device.  The rows are gathered from the host pool into
        the staging buffer; on the card (pinned buffer) a side stream
        copies them to device tensors allocated on the current stream,
        after the work already queued there, and records the event the
        consumer waits for.  The buffer is reused only once the previous
        copy out of it has ended.  On the CPU the staged rows are the
        buffer's copy and the event is ``None``."""
        t0 = time.perf_counter()
        on_card = self.device.type == "cuda"
        if self._staging is None:
            # one sequence's blocks: the most one resume promotes; made at
            # the first staging, so an engine that never parks pins nothing
            self._staging = lm.init_staging(
                self.arch, -(-self.max_len // self.block_len),
                self.block_len, kv_heads=self._host["k"].shape[3],
                pin=on_card)
        idx = torch.as_tensor([h - self.n_blocks for h in ids],
                              dtype=torch.long)
        shape = (self._host["k"].shape[0], len(ids),
                 *self._host["k"].shape[2:])
        numel = int(np.prod(shape))
        if on_card and self._stage_event is not None:
            self._stage_event.synchronize()
        bufs = []
        for key in ("k", "v"):
            buf = self._staging[key][:numel].view(shape)
            torch.index_select(self._host[key], 1, idx, out=buf)
            bufs.append(buf)
        if not on_card:
            self.tier_ms["stage"] += (time.perf_counter() - t0) * 1e3
            return bufs[0].clone(), bufs[1].clone(), None
        main = torch.cuda.current_stream(self.device)
        if self._stage_stream is None:
            self._stage_stream = torch.cuda.Stream(self.device)
        rows = [torch.empty(shape, dtype=b.dtype, device=self.device)
                for b in bufs]
        self._stage_stream.wait_stream(main)
        with torch.cuda.stream(self._stage_stream):
            for dst, src in zip(rows, bufs):
                dst.copy_(src, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._stage_stream)
        self._stage_event = ev
        self.tier_ms["stage"] += (time.perf_counter() - t0) * 1e3
        return rows[0], rows[1], ev

    # ------------------------------------------------------------------
    def _sample(self, logits: torch.Tensor, temperatures: List[float]
                ) -> List[int]:
        """One token per row: argmax at temperature 0, else a draw from
        ``softmax(logits / t)`` on the engine's generator.  Padded vocab
        slots are cut before either."""
        lf = logits[:, :self.arch.vocab_size].float()
        out = lf.argmax(dim=-1)
        if any(t > 0 for t in temperatures):
            t = torch.tensor([max(float(x), 1e-6) for x in temperatures],
                             device=lf.device)
            probs = torch.softmax(lf / t[:, None], dim=-1)
            drawn = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
            hot = torch.tensor([float(x) > 0 for x in temperatures],
                               device=lf.device)
            out = torch.where(hot, drawn, out)
        return [int(x) for x in out.tolist()]

    def _sync_pos(self) -> None:
        """Mirror per-slot lengths into the cache (freed slots 0)."""
        self.cache["pos"] = torch.from_numpy(self.slot_len.copy()).to(
            self.device)

    def step(self) -> int:
        """One engine tick: shed expired pending requests, resume parked
        evictions, admit, secure grants, the copy-on-write barrier, stage
        the next tick's resume rows, then decode one token for every
        active slot.  Returns the number of requests that finished."""
        t0 = time.perf_counter()
        self.tick += 1
        if self.pieces is not None:
            self._mesh_now = self._mesh_clock()
        if self.kv_residency == "paged" and \
                self.tick % self.preemption.shed_window_ticks == 0:
            # a new low-water epoch once a window: one transient dip must
            # not read as a hot sub-pool forever
            self._alloc.reset_low_water()
        self._poll_disagg()
        self._shed_expired_pending()
        self._shed_expired_flights()
        self._readmit_preempted()
        self._admit()
        self._ensure_grants()
        self._ensure_writable()
        self._stage_prefetch()
        if not self.active:
            if self._disagg:
                # only flights in play: the workers compute out of
                # process; do not spin the tick counter meanwhile
                time.sleep(0.01)
            self._observe_tick(t0)
            return 0
        self._sync_pos()
        tokens = np.zeros((self.max_batch, 1), np.int32)
        for slot, r in self.active.items():
            # a ride has no output yet: its first tick feeds the last
            # prompt token (the one admission left unaliased)
            tokens[slot, 0] = (r.out_tokens[-1] if r.out_tokens
                               else int(r.feed_tokens[-1]))
        logits, self.cache = lm.decode_step(
            self.arch, self.params, self.cache,
            {"tokens": torch.from_numpy(tokens).to(self.device)}, self.cfg)
        slots = sorted(self.active)
        toks = self._sample(logits[slots],
                            [self.active[s].temperature for s in slots])
        finished = 0
        for slot, tok in zip(slots, toks):
            r = self.active[slot]
            r.out_tokens.append(tok)
            if r.t_first == 0.0:       # a ride's first token
                r.t_first = time.time()
            self.slot_len[slot] += 1
            if len(r.out_tokens) >= r.max_new_tokens:
                r.done = True
                r.t_done = time.time()
                self.finished.append(r)
                del self.active[slot]
                self._release_slot(slot, r)
                self._backoff.pop(r.rid, None)
                finished += 1
        self._observe_tick(t0)
        return finished

    def _observe_tick(self, t0: float) -> None:
        dt = time.perf_counter() - t0
        if self.tick_timer.is_straggler(dt):
            self.straggler_ticks += 1
        self.tick_timer.observe(dt)

    def _release_slot(self, slot: int, r: Request) -> None:
        """Return the slot and, when paged, its blocks (through
        :meth:`_release_blocks`: a trie-indexed block may stay cached);
        the table row is cleared to -1 so the freed slot's dummy decode
        neither writes the pool nor reads a block."""
        self.free_slots.append(slot)
        self.slot_len[slot] = 0
        if self.kv_residency == "paged" and r.blocks:
            self._release_blocks(r.blocks)
            r.blocks = []
            self.cache["block_tbl"][slot] = -1

    def run_until_idle(self, max_ticks: int = 1000) -> List[Request]:
        """Tick until no live work remains (parked evictions and flights
        at the prefill fleet count as live); raises :class:`TimeoutError`
        naming the stuck request ids past ``max_ticks``."""
        ticks = 0
        while self.pending or self.active or self.preempted or self._disagg:
            if ticks >= max_ticks:
                stuck = sorted([r.rid for r in self.pending]
                               + [r.rid for r in self.active.values()]
                               + [p.request.rid for p in self.preempted]
                               + list(self._disagg))
                raise TimeoutError(
                    f"run_until_idle: {len(stuck)} request(s) still live "
                    f"after {max_ticks} ticks (pending={len(self.pending)} "
                    f"active={len(self.active)} "
                    f"preempted={len(self.preempted)} "
                    f"disagg={len(self._disagg)}): rids {stuck}")
            self.step()
            ticks += 1
        return self.finished
