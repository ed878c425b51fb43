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
data-organization pass chose, with every admitted request reserving its
worst-case block budget (``kv_admission="reserve"``) and returning it
on finish.  On the card, prefill runs the port's flash-attention kernel
and every decode tick its paged (or dense) decode kernel.  An
attention-free (mamba2) model has no KV to page: it is dense whatever
is asked, each slot holding its SSM state and conv window; its prefill
runs the SSD-scan kernel and its decode ticks the recurrence.

A paged engine serves the plan's **cross-request prefix reuse**
(``kv_prefix_reuse``) and **host spill tier** (``kv_host_blocks``) as
the JAX engine does (``src/repro/serve/engine.py``, one sub-pool):
every full ``block_len`` chunk of an admitted prompt is chain-hashed
(:mod:`repro_torch.serve.prefix_cache`) and matched against a radix
trie of resident blocks.  Matched blocks are aliased into the new
request's table with a refcount bump instead of re-prefilled: only the
tail runs, through :func:`repro_torch.models.lm.prefill_tail` (the
flash kernel at a query offset on the card), and a request whose whole
prompt but its last token is resident skips prefill entirely (a
"ride": its first decode tick feeds that token).  A copy-on-write
barrier before each decode tick copies any shared append block into a
fresh one.  With a host tier, blocks a finished request would free but
the trie still indexes stay engine-cached; under pool pressure the
spill scheduler moves the oldest to a host-DRAM pool
(:func:`repro_torch.models.lm.init_host_pool`), and a later prefix hit
on a spilled block promotes it back.  Spill and promote are
synchronous copies: a spill reads rows from ids already back on the
free list, safe because the copy ends before any next tenant writes.

What the port does not have yet, and refuses loudly: grow-on-demand
grants with migration and preemption (``kv_admission="grant"``, with
the prefetch staging that only a parked request uses: ``kv_prefetch``
is recorded and reported), disaggregated prefill workers (a plan that
says ``disagg`` with no workers stays inline, as in the JAX engine),
and meshes.

State lives in torch tensors on the device of the parameters; the
cache, the block table and ``pos`` are updated in place.  Sampling
draws from one seeded ``torch.Generator`` on that device (the JAX
engine's key stream has no torch twin, so only greedy decoding is
token-comparable across the two).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, get_arch
from repro_torch.core.costmodel import kv_block_len as default_block_len
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.models.lm import RunCfg
from repro_torch.runtime.straggler import StepTimer
from repro_torch.serve.allocator import BlockAllocator
from repro_torch.serve.prefix_cache import PrefixCache, chain_hashes


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

    @property
    def feed_tokens(self) -> np.ndarray:
        """The tokens prefill builds KV for (the prompt: the port has
        no preemption, so nothing is ever re-fed)."""
        return self.prompt


#: a request's prefix-match state for one admission pass: the feed's
#: chain hashes and the memo of its trie match (``None`` until asked)
MatchInfo = Dict[str, Any]


def _unsupported(decision: str, value, hint: str) -> NotImplementedError:
    return NotImplementedError(
        f"{decision}={value!r} is not ported yet; {hint}")


class ServeEngine:
    def __init__(self, arch: ArchConfig, params, cfg: RunCfg,
                 max_batch: int = 8, max_len: int = 512, kv_heads: int = 0,
                 seed: int = 0, kv_residency: str = "dense",
                 kv_block_len: int = 0, kv_n_blocks: int = 0,
                 kv_admission: str = "reserve",
                 kv_prefix_reuse: str = "on", kv_host_blocks: int = 0,
                 kv_prefetch: str = "on"):
        if kv_admission != "reserve":
            raise _unsupported("kv_admission", kv_admission,
                               "use kv_admission='reserve'")
        if kv_prefix_reuse not in ("on", "off"):
            raise ValueError(f"kv_prefix_reuse must be 'on' or 'off', "
                             f"got {kv_prefix_reuse!r}")
        if kv_prefetch not in ("on", "off"):
            raise ValueError(
                f"kv_prefetch must be 'on' or 'off', got {kv_prefetch!r}")
        if kv_host_blocks < 0:
            raise ValueError(
                f"kv_host_blocks must be >= 0, got {kv_host_blocks}")
        self.device = params["embed"].device
        attn = params["blocks"].get("attn")
        lm.check_on_device(
            arch, self.device,
            heads=attn["wq"].shape[-1] // arch.hd if attn else 0,
            kv_heads=attn["wk"].shape[-1] // arch.hd if attn else 0,
            flash_tiles=cfg.flash_tiles)
        self.arch, self.params, self.cfg = arch, params, cfg
        self.plan = None               # set by from_plan()
        self.max_batch, self.max_len = max_batch, max_len
        self.kv_admission = kv_admission
        self.kv_prefill_mode = "inline"
        # an SSM-only arch has no KV stripes to page (its state is O(1)
        # in the sequence), as in the JAX engine
        self.kv_residency = ("paged" if kv_residency == "paged"
                             and arch.has_attention else "dense")
        self.host_blocks = 0
        self._host: Optional[Dict[str, torch.Tensor]] = None
        self._prefix: Optional[PrefixCache] = None
        if self.kv_residency == "paged":
            self.block_len = kv_block_len or default_block_len(max_len)
            per_seq = -(-max_len // self.block_len)
            # never larger than this engine's slots can ever pin; a
            # plan-shrunk (budget-capped) pool stays shrunk
            cap = max_batch * per_seq
            self.n_blocks = min(kv_n_blocks, cap) if kv_n_blocks else cap
            self.cache = lm.init_paged_cache(
                arch, max_batch, max_len, self.block_len, self.n_blocks,
                kv_heads=kv_heads, device=self.device)
            # the host spill tier, clamped like the pool (to a park depth
            # of 8 full worst-case batches, as in the JAX engine)
            self.host_blocks = (min(kv_host_blocks, 8 * cap)
                                if kv_host_blocks > 0 else 0)
            if self.host_blocks:
                self._host = lm.init_host_pool(
                    arch, self.host_blocks, self.block_len,
                    kv_heads=kv_heads)
            if kv_prefix_reuse == "on":
                self._prefix = PrefixCache(1)
        else:
            self.block_len = 0
            self.n_blocks = 0
            self.cache = lm.init_cache(
                arch, max_batch, max_len, kv_heads=kv_heads,
                ssm_heads=lm.cache_heads(arch, params["blocks"]).get(
                    "ssm_heads", 0), device=self.device)
        self._alloc = BlockAllocator(self.n_blocks, 1,
                                     host_blocks=self.host_blocks)
        self.kv_prefix_reuse = self._prefix is not None
        self.kv_tiering = self.host_blocks > 0
        self.kv_prefetch = kv_prefetch == "on"
        # engine-held cold blocks: ones a release would have freed but the
        # trie still indexes (refcount 1, held here), oldest first; only
        # populated with the host tier on
        self._cached: Dict[int, None] = {}
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
        self._rid = 0
        self.tick = 0
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
        # for; promote: host -> device, enqueued behind its copy)
        self.tier_ms = {"spill": 0.0, "promote": 0.0}

    # ------------------------------------------------------------------
    @classmethod
    def from_plan(cls, plan, params, *, arch: Optional[ArchConfig] = None,
                  mesh=None, max_batch: Optional[int] = None,
                  max_len: Optional[int] = None, seed: int = 0,
                  kv_admission: Optional[str] = None,
                  kv_prefix_reuse: Optional[str] = None,
                  kv_host_blocks: Optional[int] = None,
                  kv_prefetch: Optional[str] = None,
                  kv_prefill_mode: Optional[str] = None) -> "ServeEngine":
        """Build an engine from the frozen plan artifact.

        The plan supplies the RunCfg (padded sizes, kernel tiles, kernel
        mode), the KV residency and pool geometry, the admission mode and
        the batching limits (the workload dims carried in the artifact),
        prefix reuse and the host spill tier; ``max_batch``/``max_len``
        may lower the limits, never raise them, and the ``kv_*`` keywords
        override plan decisions as in the JAX engine.  A decision the
        port cannot honour yet (``kv_admission="grant"``, a mesh), with
        no override that changes it, raises :class:`NotImplementedError`
        naming it.
        """
        from repro_torch.core.passes.lowering import build_run_cfg
        if mesh is not None or any(int(n) > 1 for n in plan.mesh_shape):
            raise _unsupported(
                "mesh", mesh if mesh is not None else tuple(plan.mesh_shape),
                "specialize with mesh_shape=(1, 1) for one card")
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
        admission = (kv_admission if kv_admission is not None
                     else str(est.get("kv_admission", "reserve")))
        prefix = (kv_prefix_reuse if kv_prefix_reuse is not None
                  else str(est.get("kv_prefix_reuse", "on")))
        host = (kv_host_blocks if kv_host_blocks is not None
                else int(est.get("kv_host_blocks", 0)))
        prefetch = (kv_prefetch if kv_prefetch is not None
                    else str(est.get("kv_prefetch", "on")))
        residency = str(est.get("kv_residency", "dense"))
        if residency != "paged":
            prefix, host = "off", 0    # dense engines have no pool to share
        if admission != "reserve":
            raise _unsupported("kv_admission", admission,
                               "pass kv_admission='reserve'")
        cfg = build_run_cfg(plan, arch)
        if max_batch is None:
            max_batch = (plan.global_batch
                         if plan.shape_kind == "decode" and plan.global_batch
                         else 8)
        if max_len is None:
            max_len = plan.seq_len or 512
        eng = cls(arch, params, cfg, max_batch=max_batch, max_len=max_len,
                  kv_heads=cfg.kv_heads_padded, seed=seed,
                  kv_residency=residency,
                  kv_block_len=int(est.get("kv_block_len", 0)),
                  kv_n_blocks=int(est.get("kv_n_blocks", 0)),
                  kv_admission=admission, kv_prefix_reuse=prefix,
                  kv_host_blocks=host, kv_prefetch=prefetch)
        eng.plan = plan
        # kv_prefill_mode: a plan (or override) that says disagg has no
        # worker fleet here, so prefill stays inline — exactly what the
        # JAX engine does when it is given no workers
        return eng

    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16,
               temperature: float = 0.0) -> int:
        """Queue a request; refuses one that can never fit the cache."""
        prompt = np.asarray(prompt, np.int32)
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"request needs {len(prompt)} prompt + {max_new_tokens} new "
                f"tokens > max_len={self.max_len} cache rows; raise max_len "
                "or lower max_new_tokens")
        if self.kv_residency == "paged":
            need = self._blocks_needed(len(prompt), max_new_tokens)
            if need > self.n_blocks:
                raise ValueError(
                    f"request needs {need} blocks of {self.block_len} rows "
                    f"but the pool holds only {self.n_blocks}; raise "
                    "kv_n_blocks or lower max_new_tokens")
        r = Request(self._rid, prompt, max_new_tokens, temperature,
                    t_submit=time.time())
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
        """The full worst-case budget (reserve admission), 0 if dense."""
        if self.kv_residency != "paged":
            return 0
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
        """The JAX engine's pressure telemetry, key for key: the prefix
        counters (hits, aliased tokens, rides, CoW copies), the tier's
        spills and promotes, and the grant → migrate → preempt ladder
        and disagg counters, which stay 0 / ``None`` on a
        reserve-admission, inline engine."""
        pc = self._prefix
        on = pc is not None            # (an empty trie is falsy)
        return {"tick": self.tick,
                "preemptions": 0,
                "migrations": 0,
                "grant_denials": 0,
                "shed": 0,
                "parked": 0,
                "straggler_ticks": self.straggler_ticks,
                "overloaded": False,
                "shared_blocks": self._alloc.shared_blocks,
                "prefix_hits": pc.hits if on else 0,
                "prefix_hit_tokens": pc.hit_tokens if on else 0,
                "prefix_trie": len(pc) if on else 0,
                "prefix_rides": self.prefix_rides,
                "cow_copies": self.cow_copies,
                "spills": self._alloc.spills,
                "promotes": self._alloc.promotes,
                "cached_blocks": len(self._cached),
                "prefill_mode": self.kv_prefill_mode,
                "degraded": None,
                "disagg_dispatches": 0,
                "disagg_chunks": 0,
                "disagg_resumes": 0,
                "disagg_inflight": 0}

    @property
    def decode_path(self) -> str:
        """What the decode ticks run: the paged or dense decode kernel on
        the card, its plain version on the CPU; for an attention-free
        arch the SSM recurrence (plain PyTorch on either device)."""
        on_card = self.device.type == "cuda"
        if not self.arch.has_attention:
            return f"ssm_recurrence:{'cuda' if on_card else 'cpu'}"
        kernel = ("paged_decode_attention" if self.kv_residency == "paged"
                  else "decode_attention")
        return f"{kernel}:{'cuda' if on_card else 'plain'}"

    def telemetry(self) -> Dict[str, Any]:
        """One JSON-serializable snapshot of the engine."""
        return {
            "tick": self.tick,
            "decode_path": self.decode_path,
            "kv_residency": self.kv_residency,
            "kv_admission": self.kv_admission,
            "prefill_mode": self.kv_prefill_mode,
            "requests": {"pending": len(self.pending),
                         "active": len(self.active),
                         "finished": len(self.finished)},
            "kv_prefix_reuse": self.kv_prefix_reuse,
            "kv_host_blocks": self.host_blocks,
            "kv_prefetch": self.kv_prefetch,
            "prefill": {"calls": self.prefill_calls,
                        "batches": [int(b) for b in
                                    list(self.prefill_batches)[-32:]],
                        "rides": self.prefix_rides},
            "blocks": {k: int(v) for k, v in self.block_stats().items()},
            "pressure": self.pressure_stats(),
            "tier_ms": dict(self.tier_ms),
            "straggler_ticks": self.straggler_ticks,
            "kernel_launches": ops.launch_counts(),
        }

    # ---------------- prefix matching at admission --------------------
    def _match_info(self, r: Request) -> Optional[MatchInfo]:
        """``r``'s match state for one admission pass (``None`` with
        prefix reuse off)."""
        if self._prefix is None:
            return None
        return {"hashes": chain_hashes(r.feed_tokens, self.block_len),
                "matched": None}

    def _match_for(self, r: Request, info: Optional[MatchInfo]) -> List[int]:
        """The block ids of ``r``'s longest resident prefix, capped one
        token short of the whole feed: the last feed token's compute
        always runs here (its logits seed the first sample)."""
        if info is None:
            return []
        if info["matched"] is None:
            got = self._prefix.match(info["hashes"])
            info["matched"] = got[:(len(r.feed_tokens) - 1) // self.block_len]
        return info["matched"]

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
        """True when admission skips prefill entirely: the whole feed but
        its last token is aliased.  The first decode tick feeds that
        token and samples the first output."""
        if not (self._skip_prefix and matched and not r.out_tokens):
            return False
        if r.max_new_tokens <= 1:
            return False      # satisfied by the sample; never holds blocks
        return len(matched) * self.block_len == len(r.feed_tokens) - 1

    def _register_prefix(self, r: Request,
                         info: Optional[MatchInfo]) -> None:
        """Index ``r``'s full feed blocks in the trie (first writer
        wins)."""
        if self._prefix is None or info is None or not r.blocks:
            return
        hashes = info["hashes"]
        self._prefix.insert(hashes, r.blocks[:len(hashes)])

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
        copy must end before a next tenant writes them."""
        t0 = time.perf_counter()
        old = self._ids([b for b, _ in pairs])
        idx = [h - self.n_blocks for _, h in pairs]
        for key in ("k", "v"):
            self._host[key][:, idx] = lm.gather_blocks(
                self.cache[key], old).cpu()
        self.tier_ms["spill"] += (time.perf_counter() - t0) * 1e3

    def _promote_rows(self, pairs: List[Tuple[int, int]]) -> None:
        """Copy spilled k/v rows back into the pool at the pairs' new
        ids (a host → device copy, then one scatter per tensor)."""
        t0 = time.perf_counter()
        new = self._ids([b for _, b in pairs])
        idx = [h - self.n_blocks for h, _ in pairs]
        for key in ("k", "v"):
            lm.scatter_blocks(self.cache[key], new, self._host[key][:, idx])
        self.tier_ms["promote"] += (time.perf_counter() - t0) * 1e3

    def _promote_matched(self, matched: List[int]) -> List[int]:
        """Resolve a matched block list to pool ids (hit-after-spill):
        ids promoted earlier in this admission pass are followed through
        ``_promo_map``; host-tier blocks are promoted now, their rows
        copied back and trie and cold-cache entries re-keyed.  Placement
        budgeted the draws (:meth:`_hbm_matched`)."""
        if not self.kv_tiering or not matched:
            return list(matched)
        out = [self._promo_map.get(b, b) for b in matched]
        host_ids = [b for b in out if self._alloc.tier_of(b) == "host"]
        if not host_ids:
            return out
        pairs = self._alloc.promote(host_ids, 0)
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

    def _spill_cold(self, need: int) -> int:
        """Free up to ``need`` pool blocks by moving the oldest unpinned
        cold cached blocks to the host tier (evicting the oldest cached
        host block when the host pool is full, dropping the cold block
        when there is no host room at all).  Returns the blocks freed."""
        if not self.kv_tiering:
            return 0
        freed = 0
        while freed < need:
            cand = next((b for b in self._cached if b < self.n_blocks
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

    def spill_cached(self) -> int:
        """Force-spill every unpinned cached pool block to the host tier
        (the ops/test hook that drives hit-after-spill without real pool
        pressure).  Returns the number of blocks spilled."""
        n = sum(1 for b in self._cached
                if b < self.n_blocks and self._alloc.refcount(b) == 1)
        return self._spill_cold(n)

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

    def _place(self, r: Request, info: Optional[MatchInfo], avail: List[int],
               free: List[int], key=None) -> Optional[int]:
        """Reserve the first free slot for ``r`` if the pool covers its
        admission need net of aliased pool blocks (and, given a bucket
        ``key``, its match keeps it in that bucket); ``free[0]`` is the
        pass's running free count."""
        if not avail:
            return None
        matched = self._match_for(r, info)
        if key is not None and self._bucket_key(r, matched) != key:
            return None
        need = max(0, self._admission_blocks(r) - self._hbm_matched(matched))
        if need > free[0]:
            return None
        free[0] -= need
        return avail.pop(0)

    # ------------------------------------------------------------------
    def _admit(self) -> None:
        """Bucketed batched admission: every pending prompt sharing the
        head-of-line's bucket — feed length, plus the matched-prefix
        length when prefix reuse aliases resident blocks — that fits a
        free slot and the pool is prefilled in one call (tail-only when a
        prefix is aliased).  A request whose whole feed but its last
        token is resident rides straight to decode.  When the pool cannot
        cover the head request, cold cached blocks spill to the host tier
        and the placement is retried once; then admission waits for a
        finisher (head-of-line blocking, so exhaustion delays rather than
        starves)."""
        self._promo_map.clear()        # the promoted-id map is per pass
        while self.pending and self.free_slots:
            head = self.pending[0]
            info0 = self._match_info(head)
            avail = list(self.free_slots)
            free = [self._alloc.free_in(0)]
            s0 = self._place(head, info0, avail, free)
            if s0 is None:
                if not (self.kv_tiering and self._cached):
                    return             # pool exhausted: wait for frees
                short = self._admission_blocks(head) - self._alloc.free_in(0)
                if short > 0:
                    self._spill_cold(short)
                # the match memo is stale after a rekey
                info0 = self._match_info(head)
                avail = list(self.free_slots)
                free = [self._alloc.free_in(0)]
                s0 = self._place(head, info0, avail, free)
                if s0 is None:
                    return             # truly exhausted: wait for frees
            m0 = self._match_for(head, info0)
            if self._can_ride(head, m0):
                self.pending.pop(0)
                self.free_slots.remove(s0)
                self._admit_ride(head, s0, info0)
                continue
            key0 = self._bucket_key(head, m0)
            group, slots, infos, rest = [head], [s0], [info0], []
            for r in self.pending[1:]:
                s, info = None, None
                if len(r.feed_tokens) == len(head.feed_tokens):
                    info = self._match_info(r)
                    s = self._place(r, info, avail, free, key0)
                if s is None:
                    rest.append(r)
                else:
                    group.append(r)
                    slots.append(s)
                    infos.append(info)
            self.pending = rest
            for s in slots:
                self.free_slots.remove(s)
            # hit-after-spill: matches may name host-tier (or just
            # promoted) blocks; resolve them before any read of the pool
            matches = [self._promote_matched(self._match_for(r, i))
                       for r, i in zip(group, infos)]
            self._admit_group(group, slots, matches, infos, key0)

    def _admit_ride(self, r: Request, slot: int, info: MatchInfo) -> None:
        """Zero-prefill admission: alias the matched blocks, draw the
        fresh ones the budget calls for, install the table row, and hand
        the request to decode at position ``matched_tokens``."""
        matched = self._promote_matched(self._match_for(r, info))
        need = self._admission_blocks(r)
        self._alloc.retain(matched)
        fresh = self._alloc.allocate(need - len(matched), 0)
        assert fresh is not None, "placement checked the free count"
        r.blocks = list(matched) + fresh
        row = torch.full((self.cache["block_tbl"].shape[1],), -1,
                         dtype=torch.int32)
        row[:len(r.blocks)] = torch.as_tensor(r.blocks, dtype=torch.int32)
        self.cache["block_tbl"][slot] = row.to(self.device)
        r.slot = int(slot)
        m_tok = len(matched) * self.block_len
        self.slot_len[slot] = m_tok
        self.active[slot] = r
        self._register_prefix(r, info)
        self._prefix.hits += 1
        self._prefix.hit_tokens += m_tok
        self.prefix_rides += 1

    def _admit_group(self, group: List[Request], slots: List[int],
                     matches: List[List[int]],
                     infos: List[Optional[MatchInfo]], bucket) -> None:
        """One prefill call for a bucket of requests, each with a
        pre-reserved slot.  With a matched-prefix bucket, only the tails
        run (:func:`repro_torch.models.lm.prefill_tail`, reading the
        aliased rows from the pool); the matched blocks are aliased, not
        rewritten.  The batch is padded to the next power of two (dummy
        rows repeat the first request and are discarded)."""
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
            logits, tail_k, tail_v = lm.prefill_tail(
                self.arch, self.params, batch, self.cfg, self.cache["k"],
                self.cache["v"], torch.from_numpy(blk))
        else:
            logits, cacheg = lm.prefill(self.arch, self.params, batch,
                                        self.cfg, max_len=toks.shape[1])
        self.prefill_calls += 1
        self.prefill_batches.append(len(group))
        first = self._sample(logits[:len(group)],
                             [r.temperature for r in group])
        t_first = time.time()
        live: List[Request] = []
        idxs: List[int] = []
        for i, (r, tok) in enumerate(zip(group, first)):
            r.out_tokens.append(tok)
            r.t_first = t_first
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
        elif self.arch.has_attention:
            for key in ("k", "v"):
                self.cache[key][:, st, :plen] = cacheg[key][:, gi]
        for key in ("ssm", "conv"):
            if key in self.cache:
                self.cache[key][:, st] = cacheg[key][:, gi]
        for slot, r in zip(live_slots, live):
            r.slot = int(slot)
            self.slot_len[slot] = plen
            self.active[int(slot)] = r
        for i, r in enumerate(live):
            self._register_prefix(r, infos[idxs[i]])
            if self._prefix is not None:
                if live_matches[i]:
                    self._prefix.hits += 1
                    self._prefix.hit_tokens += \
                        len(live_matches[i]) * self.block_len
                else:
                    self._prefix.misses += 1

    def _draw_blocks(self, r: Request, matched: List[int]) -> List[int]:
        """``r``'s admission budget: the matched blocks aliased (refcount
        bump), the rest drawn fresh (reserved at placement, so the draw
        cannot fail)."""
        if matched:
            self._alloc.retain(matched)
        fresh = self._alloc.allocate(
            self._admission_blocks(r) - len(matched), 0)
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
            blocks = self._draw_blocks(r, matches[i])
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
            blk_ids = self._ids(ent_blk)
            for key in ("k", "v"):
                self.cache[key][:, blk_ids] = cacheg[key][:, req, ridx]
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
            blocks = self._draw_blocks(r, matches[i])
            assert len(blocks) >= nbp > nbm, (len(blocks), nbp, nbm)
            tail_blocks.extend(blocks[nbm:nbp])
        ntb, T = nbp - nbm, plen - m_tok
        blk_ids = self._ids(tail_blocks)
        for key, src in (("k", tail_k), ("v", tail_v)):
            upd = src[:, gi]                           # (L, Bs, T, K, hd)
            if T < ntb * bl:
                upd = torch.nn.functional.pad(
                    upd, (0, 0, 0, 0, 0, ntb * bl - T))
            upd = upd.reshape(upd.shape[0], len(live) * ntb, bl,
                              *upd.shape[3:])
            self.cache[key][:, blk_ids] = upd
        self._install_rows(live, slots)

    # ---------------- copy-on-write barrier ---------------------------
    def _ensure_writable(self) -> None:
        """Before a decode tick no slot may append into a block with more
        than one holder: its append block is copied to a fresh one
        first.  Natural admission never shares an append block (only
        full feed chunks are aliased, one token short of the feed);
        this barrier is the structural guarantee.  Without a free block
        it spills a cold one; the port has no preemption to fall back on
        (ROADMAP §1 item 3), so it raises past that."""
        if self._prefix is None or self._alloc.shared_blocks == 0:
            return
        for r in sorted(self.active.values(), key=lambda x: x.rid):
            col = int(self.slot_len[r.slot]) // self.block_len
            if col >= len(r.blocks) \
                    or self._alloc.refcount(r.blocks[col]) <= 1:
                continue
            fresh = self._alloc.allocate_one(0)
            if fresh is None and self._spill_cold(1):
                fresh = self._alloc.allocate_one(0)
            if fresh is None:
                raise RuntimeError(
                    f"request {r.rid}: copy-on-write needs a free block "
                    "and the pool has none (reserve admission has no "
                    "preemption to fall back on)")
            self._cow_copy(r, col, fresh)

    def _cow_copy(self, r: Request, col: int, fresh: int) -> None:
        """Copy ``r``'s shared append block into ``fresh`` (k/v rows in
        place, and the table entry) and drop this holder's reference to
        the original; the sharers keep it, trie entry and all."""
        old = r.blocks[col]
        for key in ("k", "v"):
            self.cache[key][:, fresh] = self.cache[key][:, old]
        self.cache["block_tbl"][r.slot, col] = fresh
        r.blocks[col] = fresh
        self._release_blocks([old])
        self.cow_copies += 1

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
        """One engine tick: admit, then decode one token for every slot.
        Returns the number of requests that finished."""
        t0 = time.perf_counter()
        self.tick += 1
        self._admit()
        self._ensure_writable()
        if not self.active:
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
        """Tick until no live work remains; raises :class:`TimeoutError`
        naming the stuck request ids past ``max_ticks``."""
        ticks = 0
        while self.pending or self.active:
            if ticks >= max_ticks:
                stuck = sorted([r.rid for r in self.pending]
                               + [r.rid for r in self.active.values()])
                raise TimeoutError(
                    f"run_until_idle: {len(stuck)} request(s) still live "
                    f"after {max_ticks} ticks (pending={len(self.pending)} "
                    f"active={len(self.active)}): rids {stuck}")
            self.step()
            ticks += 1
        return self.finished
