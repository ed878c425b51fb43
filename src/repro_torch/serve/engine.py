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

What the port does not have yet, and refuses loudly: grow-on-demand
grants with migration and preemption (``kv_admission="grant"``),
cross-request prefix reuse, the host spill tier, disaggregated prefill
workers (a plan that says ``disagg`` with no workers stays inline, as
in the JAX engine), and meshes.

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
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, get_arch
from repro_torch.core.costmodel import kv_block_len as default_block_len
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.models.lm import RunCfg
from repro_torch.runtime.straggler import StepTimer
from repro_torch.serve.allocator import BlockAllocator


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


def _unsupported(decision: str, value, hint: str) -> NotImplementedError:
    return NotImplementedError(
        f"{decision}={value!r} is not ported yet; {hint}")


class ServeEngine:
    def __init__(self, arch: ArchConfig, params, cfg: RunCfg,
                 max_batch: int = 8, max_len: int = 512, kv_heads: int = 0,
                 seed: int = 0, kv_residency: str = "dense",
                 kv_block_len: int = 0, kv_n_blocks: int = 0,
                 kv_admission: str = "reserve",
                 kv_prefix_reuse: str = "off", kv_host_blocks: int = 0):
        if kv_admission != "reserve":
            raise _unsupported("kv_admission", kv_admission,
                               "use kv_admission='reserve'")
        if kv_prefix_reuse != "off":
            raise _unsupported("kv_prefix_reuse", kv_prefix_reuse,
                               "use kv_prefix_reuse='off'")
        if kv_host_blocks:
            raise _unsupported("kv_host_blocks", kv_host_blocks,
                               "use kv_host_blocks=0")
        lm.check_supported(arch)
        self.arch, self.params, self.cfg = arch, params, cfg
        self.device = params["embed"].device
        self.plan = None               # set by from_plan()
        self.max_batch, self.max_len = max_batch, max_len
        self.kv_admission = kv_admission
        self.kv_prefill_mode = "inline"
        # an SSM-only arch has no KV stripes to page (its state is O(1)
        # in the sequence), as in the JAX engine
        self.kv_residency = ("paged" if kv_residency == "paged"
                             and arch.has_attention else "dense")
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
        else:
            self.block_len = 0
            self.n_blocks = 0
            self.cache = lm.init_cache(
                arch, max_batch, max_len, kv_heads=kv_heads,
                ssm_heads=lm.cache_heads(arch, params["blocks"]).get(
                    "ssm_heads", 0), device=self.device)
        self._alloc = BlockAllocator(self.n_blocks, 1)
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

    # ------------------------------------------------------------------
    @classmethod
    def from_plan(cls, plan, params, *, arch: Optional[ArchConfig] = None,
                  mesh=None, max_batch: Optional[int] = None,
                  max_len: Optional[int] = None, seed: int = 0,
                  kv_admission: Optional[str] = None,
                  kv_prefix_reuse: Optional[str] = None,
                  kv_host_blocks: Optional[int] = None,
                  kv_prefill_mode: Optional[str] = None) -> "ServeEngine":
        """Build an engine from the frozen plan artifact.

        The plan supplies the RunCfg (padded sizes, kernel tiles, kernel
        mode), the KV residency and pool geometry, the admission mode and
        the batching limits (the workload dims carried in the artifact);
        ``max_batch``/``max_len`` may lower the limits, never raise them,
        and the ``kv_*`` keywords override plan decisions as in the JAX
        engine.  A decision the port cannot honour yet, with no override
        that changes it, raises :class:`NotImplementedError` naming it.
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
        residency = str(est.get("kv_residency", "dense"))
        if residency != "paged":
            prefix, host = "off", 0    # dense engines have no pool to share
        if admission != "reserve":
            raise _unsupported("kv_admission", admission,
                               "pass kv_admission='reserve'")
        if prefix != "off":
            raise _unsupported("kv_prefix_reuse", prefix,
                               "pass kv_prefix_reuse='off'")
        if host:
            raise _unsupported("kv_host_blocks", host,
                               "pass kv_host_blocks=0")
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
                  kv_host_blocks=host)
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
        """Pool accounting (``free + in_use == total``; dense engines
        report an empty 0-block pool)."""
        st = self._alloc.stats()
        st["prefix_trie"] = 0
        st["cached"] = 0
        return st

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
            "prefill": {"calls": self.prefill_calls,
                        "batches": [int(b) for b in
                                    list(self.prefill_batches)[-32:]]},
            "blocks": {k: int(v) for k, v in self.block_stats().items()},
            "straggler_ticks": self.straggler_ticks,
            "kernel_launches": ops.launch_counts(),
        }

    # ------------------------------------------------------------------
    def _admit(self) -> None:
        """Bucketed batched admission: every pending prompt of the
        head-of-line length that fits a free slot and the pool is
        prefilled in one call.  When the pool cannot cover the head
        request, admission waits for a finisher (head-of-line
        blocking, so exhaustion delays rather than starves)."""
        while self.pending and self.free_slots:
            head = self.pending[0]
            avail = list(self.free_slots)
            free = self._alloc.free_in(0)
            need = self._admission_blocks(head)
            if need > free:
                return                 # pool exhausted: wait for frees
            free -= need
            group, slots, rest = [head], [avail.pop(0)], []
            for r in self.pending[1:]:
                need = self._admission_blocks(r)
                if avail and len(r.feed_tokens) == len(head.feed_tokens) \
                        and need <= free:
                    free -= need
                    group.append(r)
                    slots.append(avail.pop(0))
                else:
                    rest.append(r)
            self.pending = rest
            for s in slots:
                self.free_slots.remove(s)
            self._admit_group(group, slots)

    def _admit_group(self, group: List[Request], slots: List[int]) -> None:
        """One prefill call for a bucket of same-length requests, each
        with a pre-reserved slot.  The batch is padded to the next power
        of two (dummy rows repeat the first prompt and are discarded)."""
        toks = np.stack([r.feed_tokens for r in group])
        padded = 1
        while padded < len(group):
            padded *= 2
        padded = min(padded, self.max_batch)
        if padded > len(group):
            toks = np.concatenate(
                [toks, np.repeat(toks[:1], padded - len(group), axis=0)])
        plen = toks.shape[1]
        logits, cacheg = lm.prefill(
            self.arch, self.params,
            {"tokens": torch.from_numpy(toks).to(self.device)}, self.cfg,
            max_len=plen)
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
        live_slots = np.asarray([slots[i] for i in idxs], np.int64)
        gidx = np.asarray(idxs, np.int64)
        st = torch.from_numpy(live_slots).to(self.device)
        gi = torch.from_numpy(gidx).to(self.device)
        if self.kv_residency == "paged":
            self._scatter_paged_prefill(live, live_slots, gidx, cacheg, plen)
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

    def _scatter_paged_prefill(self, live: List[Request], slots: np.ndarray,
                               gidx: np.ndarray, cacheg, plen: int) -> None:
        """Move a bucket's prefilled KV rows into their pool blocks:
        each survivor draws its admission budget from the pool (reserved
        at placement, so the draw cannot fail), the prefilled rows are
        scattered block by block in one gather/scatter per cache tensor,
        and the table rows are installed (-1 past the allocation)."""
        bl = self.block_len
        nbp = -(-plen // bl)               # blocks holding prefilled rows
        nb_cols = self.cache["block_tbl"].shape[1]
        rows = np.full((len(live), nb_cols), -1, np.int32)
        ent_req: List[int] = []            # prefill batch row per block
        ent_col: List[int] = []            # feed block column per block
        ent_blk: List[int] = []            # destination pool block
        for i, r in enumerate(live):
            need = self._admission_blocks(r)
            assert need >= nbp, (need, nbp)
            fresh = self._alloc.allocate(need, 0)
            assert fresh is not None, "admission reserved these blocks"
            r.blocks = fresh
            rows[i, :need] = fresh
            for c in range(nbp):
                ent_req.append(int(gidx[i]))
                ent_col.append(c)
                ent_blk.append(fresh[c])
        S = cacheg["k"].shape[2]
        dev = self.device
        req = torch.as_tensor(ent_req, device=dev)[:, None]
        # rows past the prompt in its last block clamp onto the last
        # prefilled row: garbage, but masked (pos >= cache_len) until a
        # decode append overwrites them
        ridx = np.minimum(np.asarray(ent_col)[:, None] * bl
                          + np.arange(bl)[None, :], S - 1)
        ridx = torch.from_numpy(ridx).to(dev)
        blk_ids = torch.as_tensor(ent_blk, device=dev)
        for key in ("k", "v"):
            self.cache[key][:, blk_ids] = cacheg[key][:, req, ridx]
        self.cache["block_tbl"][torch.from_numpy(slots).to(dev)] = \
            torch.from_numpy(rows).to(dev)

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
        if not self.active:
            self._observe_tick(t0)
            return 0
        self._sync_pos()
        tokens = np.zeros((self.max_batch, 1), np.int32)
        for slot, r in self.active.items():
            tokens[slot, 0] = r.out_tokens[-1]
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
        """Return the slot and, when paged, its blocks to the pool; the
        table row is cleared to -1 so the freed slot's dummy decode
        neither writes the pool nor reads a block."""
        self.free_slots.append(slot)
        self.slot_len[slot] = 0
        if self.kv_residency == "paged" and r.blocks:
            self._alloc.release(r.blocks)
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
