"""Block-pool allocator for the paged KV cache — sub-pool aware,
refcounted for cross-request block sharing, tier-aware for host spill.

The serving engine's residency management for a paged plan is exactly
this object: blocks are handed out on admission (or granted one at a
time as decode crosses block boundaries) and returned on finish.
Under 2-D pool sharding (:func:`repro_torch.dist.flash_decode
.pool_sharding_kind` == ``"2d"``) the pool splits data-major into one
*sub-pool per data shard* and a slot may only hold blocks from the
sub-pool of the data shard hosting it — a foreign block would be owned
by no shard in the slot's data row and silently mask out of the
combine.  The allocator enforces that contract structurally: every
``allocate`` draws from one group's free list, and ``release`` returns
each block to the group its id belongs to.

Prefix sharing (cross-request KV reuse) adds **per-block refcounts**:
``allocate`` hands out blocks at count 1, ``retain`` bumps the count
when another request aliases a block into its table (a prefix-cache
hit), and ``release`` only returns a block to its sub-pool's free list
when the count reaches zero.  Conservation is counted over *unique*
resident blocks — a block aliased by five requests pins one block, not
five; ``stats()["shared"]`` reports how many resident blocks currently
have more than one holder.

Multi-tier residency (the plan's ``kv_tier_split``): behind the HBM
pool sits an optional **host-DRAM spill pool** of ``host_blocks``
blocks.  Residency is explicit in the id space — HBM blocks are
``[0, n_blocks)`` (grouped into sub-pools as before), host blocks are
``[n_blocks, n_blocks + host_blocks)`` (one flat pool; host DRAM has
no combine contract to respect).  ``spill(blocks)`` moves resident
HBM blocks to host ids — the whole refcount travels with the content,
the vacated HBM id returns to its sub-pool's free list — and
``promote(blocks, group)`` is the inverse, drawing fresh HBM ids from
one sub-pool (so a promoted block lands in the requesting slot's data
shard).  Callers move the actual k/v rows; the allocator moves the
*accounting*, and hands back ``(old_id, new_id)`` pairs so block
tables and prefix-trie entries can be re-keyed.  Conservation is
counted **per tier**: the HBM identity ``free + in_use == n_blocks``
and the host identity ``host_free + host_in_use == host_blocks`` are
asserted independently on every ``stats()`` call.

Grow-on-demand support (the grant admission mode): free lists are
:class:`collections.deque` (O(1) grants at any pool size — ``pop(0)``
on a list is O(n) and showed up at production pool sizes), and each
sub-pool tracks a *low watermark* (the smallest free count it reached
in the current epoch) so the engine's rebalancer can tell a
persistently hot sub-pool from a transient dip without keeping its own
history.  Watermarks are **epoch-based**: ``reset_low_water()`` starts
a new epoch by snapping every watermark to its sub-pool's current free
count — without it the mark only ever ratchets down, so one transient
dip poisons the hot-sub-pool signal for the engine's whole lifetime
(the bug the epoch reset fixes; the engine calls it once per rebalance
cycle).

Invariants (the property suite in ``tests/test_properties.py`` fuzzes
these over random admit/grant/retain/spill/promote/finish sequences):

* conservation per tier — ``free + in_use == n_blocks`` for the HBM
  tier and ``host_free + host_in_use == host_blocks`` for the host
  tier at every point, where ``in_use`` counts unique resident blocks
  regardless of how many holders share them (``stats()`` re-asserts
  both on every call);
* no double-assignment — a block is *allocated* to at most one holder;
  additional holders arrive only through an explicit ``retain``;
* group integrity — allocations never cross a sub-pool boundary, and a
  ``promote`` lands in exactly the group it was asked for;
* refcount transfer — ``spill``/``promote`` move a block's holder
  count unchanged (shared prefix blocks are spillable; a writer must
  promote before touching them, which the engine's CoW barrier already
  forces for any shared block);
* no leaks — releasing every holder's reference restores
  ``free == n_blocks`` and ``host_free == host_blocks``;
* no grant after free — a released block sits in its free list until
  re-allocated; it is never still owned by its previous holder;
* refcount sanity — resident blocks have count >= 1, freeing past
  zero (double free) raises, and ``release([])`` is an explicit no-op
  that never touches low-water bookkeeping.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple


class BlockAllocator:
    """FIFO free-list allocator over ``groups`` equal sub-pools, plus
    an optional flat host-tier spill pool.

    Group ``g`` owns the contiguous HBM block ids ``[g * n/groups,
    (g+1) * n/groups)`` — the data-major layout the 2-D pool's
    PartitionSpec gives the block dim, so "group" == "data shard".
    ``groups=1`` is the 1-D (or unsharded) pool.  Host block ids live
    past the HBM range: ``[n_blocks, n_blocks + host_blocks)``.
    """

    def __init__(self, n_blocks: int, groups: int = 1,
                 host_blocks: int = 0):
        if groups < 1:
            raise ValueError(f"groups must be >= 1, got {groups}")
        if n_blocks < 0 or n_blocks % groups:
            raise ValueError(
                f"n_blocks={n_blocks} must be a non-negative multiple of "
                f"groups={groups} (equal sub-pools per data shard)")
        if host_blocks < 0:
            raise ValueError(f"host_blocks must be >= 0, got {host_blocks}")
        self.n_blocks = n_blocks
        self.groups = groups
        self.group_size = n_blocks // groups
        self.host_blocks = host_blocks
        self._free: List[Deque[int]] = [
            deque(range(g * self.group_size, (g + 1) * self.group_size))
            for g in range(groups)]
        self._host_free: Deque[int] = deque(
            range(n_blocks, n_blocks + host_blocks))
        self._owned: set = set()
        # per-block holder counts for resident blocks (absent == free);
        # 1 = private, >1 = aliased by multiple block tables
        self._ref: Dict[int, int] = {}
        # per-sub-pool pressure telemetry: smallest free count seen in
        # the current epoch (the rebalancer's "hot sub-pool" signal)
        # and grant/tier-transition counters
        self._low_water: List[int] = [self.group_size] * groups
        self.grants: int = 0
        self.spills: int = 0
        self.promotes: int = 0
        self.low_water_epochs: int = 0

    # ------------------------------------------------------------------
    def group_of(self, block_id: int) -> int:
        """The sub-pool an HBM block id belongs to.  Host-tier ids have
        no group (host DRAM has no combine contract) and are rejected —
        a caller asking is about to violate the slot→sub-pool mapping."""
        if not 0 <= block_id < self.n_blocks:
            raise ValueError(f"block id {block_id} outside HBM pool "
                             f"[0, {self.n_blocks})")
        return block_id // self.group_size if self.group_size else 0

    def tier_of(self, block_id: int) -> str:
        """``"hbm"`` or ``"host"`` — residency is the id range."""
        if not 0 <= block_id < self.n_blocks + self.host_blocks:
            raise ValueError(
                f"block id {block_id} outside both tiers "
                f"[0, {self.n_blocks + self.host_blocks})")
        return "hbm" if block_id < self.n_blocks else "host"

    def free_in(self, group: int = 0) -> int:
        return len(self._free[group])

    @property
    def free(self) -> int:
        """Free HBM blocks (the decode-visible tier)."""
        return sum(len(f) for f in self._free)

    @property
    def host_free(self) -> int:
        return len(self._host_free)

    def low_water(self, group: int = 0) -> int:
        """Smallest free count this sub-pool reached in the current
        epoch — 0 means it has been fully drained since the last
        ``reset_low_water()`` (a hot sub-pool)."""
        return self._low_water[group]

    def reset_low_water(self) -> None:
        """Start a new low-water epoch: snap every sub-pool's watermark
        to its *current* free count.  The mark only ever decreases
        between resets, so without an epoch boundary one transient dip
        (a burst that drained a sub-pool once, hours ago) reads as a
        permanently hot sub-pool and the rebalancer's signal goes
        stale.  The engine calls this once per rebalance cycle."""
        for g in range(self.groups):
            self._low_water[g] = len(self._free[g])
        self.low_water_epochs += 1

    def allocate(self, need: int, group: int = 0) -> Optional[List[int]]:
        """``need`` HBM blocks from one sub-pool, or None if it cannot
        cover them (callers treat None as "wait for a finisher" or
        "preempt a victim" — partial grants would deadlock two
        half-admitted requests).  Fresh blocks start at refcount 1."""
        if need < 0:
            raise ValueError(f"need must be >= 0, got {need}")
        free = self._free[group]
        if need > len(free):
            return None
        blocks = [free.popleft() for _ in range(need)]
        self._owned.update(blocks)
        for b in blocks:
            self._ref[b] = 1
        self.grants += 1
        if len(free) < self._low_water[group]:
            self._low_water[group] = len(free)
        return blocks

    def allocate_one(self, group: int = 0) -> Optional[int]:
        """One-block grant (the grow-on-demand path: a slot asks for its
        next block only when decode crosses a block boundary)."""
        got = self.allocate(1, group)
        return got[0] if got is not None else None

    def retain(self, blocks: Sequence[int]) -> None:
        """Bump the holder count of resident blocks — the prefix-cache
        hit path: another request aliases these blocks into its table.
        Retaining a block the pool does not currently hold is loud (the
        aliased content would be whatever the next tenant writes)."""
        for b in blocks:
            if b not in self._owned:
                raise ValueError(
                    f"block {b} is not currently allocated — cannot retain "
                    "a free (or never-owned) block; an alias to it would "
                    "read the next tenant's rows")
            self._ref[b] += 1

    def refcount(self, block_id: int) -> int:
        """Current holder count (0 = free).  Refcount > 1 means the
        block is shared: writers must copy it first (CoW)."""
        return self._ref.get(block_id, 0)

    @property
    def shared_blocks(self) -> int:
        """Resident blocks with more than one holder."""
        return sum(1 for c in self._ref.values() if c > 1)

    # ---------------- tier transitions --------------------------------
    def _validate_resident(self, blocks: Sequence[int], tier: str) -> None:
        seen = set()
        for b in blocks:
            if b in seen:
                raise ValueError(f"block {b} listed twice — a tier "
                                 "transition moves each block once")
            seen.add(b)
            if b not in self._owned:
                raise ValueError(
                    f"block {b} is not currently allocated — only "
                    "resident blocks change tier")
            if self.tier_of(b) != tier:
                raise ValueError(
                    f"block {b} is {self.tier_of(b)}-resident, "
                    f"expected {tier}")

    def spill(self, blocks: Sequence[int]
              ) -> Optional[List[Tuple[int, int]]]:
        """Move resident HBM blocks to the host tier.  Returns
        ``(hbm_id, host_id)`` pairs — the caller copies the k/v rows and
        re-keys tables/trie entries — or None when the host pool cannot
        cover them all (partial spills would strand a request across an
        un-promotable split).  The vacated HBM ids return to their
        sub-pools' free lists; each block's holder count travels with
        it, so shared blocks are spillable (sharers all follow the new
        id; a writer must promote first — the engine's CoW barrier
        already forbids writing any shared block in place)."""
        self._validate_resident(blocks, "hbm")
        if len(blocks) > len(self._host_free):
            return None
        pairs: List[Tuple[int, int]] = []
        for b in blocks:
            h = self._host_free.popleft()
            self._ref[h] = self._ref.pop(b)
            self._owned.discard(b)
            self._owned.add(h)
            self._free[self.group_of(b)].append(b)
            pairs.append((b, h))
        self.spills += len(pairs)
        return pairs

    def promote(self, blocks: Sequence[int], group: int = 0
                ) -> Optional[List[Tuple[int, int]]]:
        """Move resident host-tier blocks back into one HBM sub-pool
        (the slot that needs them decodes there — group integrity is
        preserved by construction).  Returns ``(host_id, hbm_id)``
        pairs, or None when the sub-pool cannot cover them all.  The
        freed host ids return to the host free list; holder counts
        travel unchanged."""
        self._validate_resident(blocks, "host")
        free = self._free[group]
        if len(blocks) > len(free):
            return None
        pairs: List[Tuple[int, int]] = []
        for h in blocks:
            b = free.popleft()
            self._ref[b] = self._ref.pop(h)
            self._owned.discard(h)
            self._owned.add(b)
            self._host_free.append(h)
            pairs.append((h, b))
        self.promotes += len(pairs)
        if len(free) < self._low_water[group]:
            self._low_water[group] = len(free)
        return pairs

    # ------------------------------------------------------------------
    def release(self, blocks: Sequence[int]) -> List[int]:
        """Drop one holder reference per listed block; a block returns
        to its tier's free list (its sub-pool's for HBM ids, the host
        pool's for host ids) only when its count reaches zero.  Returns
        the blocks actually freed (so the engine can prune prefix-trie
        entries pointing at them).  Double frees stay loud — a silent
        one would let two slots share a block they never agreed to
        share.

        An empty ``blocks`` sequence is an explicit no-op: a request
        that sheds before any grant releases nothing, and that path must
        not touch free lists or low-water bookkeeping (pinned by the
        churn fuzz)."""
        if not blocks:
            # no-op by contract; re-assert conservation so a corrupted
            # caller path fails here rather than at the next decode
            hbm_in_use = sum(1 for b in self._owned if b < self.n_blocks)
            assert self.free + hbm_in_use == self.n_blocks, (
                f"block conservation violated on empty release: "
                f"free={self.free} in_use={hbm_in_use} "
                f"total={self.n_blocks}")
            return []
        freed: List[int] = []
        for b in blocks:
            if b not in self._owned:
                raise ValueError(
                    f"block {b} is not currently allocated "
                    "(double free, or a block this pool never owned)")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                self._owned.discard(b)
                if b < self.n_blocks:
                    self._free[self.group_of(b)].append(b)
                else:
                    self._host_free.append(b)
                freed.append(b)
        return freed

    def stats(self) -> Dict[str, int]:
        free = self.free
        hbm_in_use = sum(1 for b in self._owned if b < self.n_blocks)
        host_in_use = len(self._owned) - hbm_in_use
        # conservation is the invariant everything else leans on; a
        # broken free list must fail here, not as a downstream decode
        # reading a double-assigned block.  Sharing does not bend it
        # (in_use counts unique resident blocks, however many holders)
        # and neither does tiering: each tier balances independently.
        assert free + hbm_in_use == self.n_blocks, (
            f"HBM block conservation violated: free={free} "
            f"in_use={hbm_in_use} total={self.n_blocks}")
        assert self.host_free + host_in_use == self.host_blocks, (
            f"host block conservation violated: free={self.host_free} "
            f"in_use={host_in_use} total={self.host_blocks}")
        assert all(c >= 1 for c in self._ref.values()), (
            "resident block with refcount < 1")
        assert set(self._ref) == self._owned, (
            "refcount map out of sync with ownership set")
        return {"total": self.n_blocks, "free": free,
                "in_use": hbm_in_use, "shared": self.shared_blocks,
                "groups": self.groups,
                "host_total": self.host_blocks,
                "host_free": self.host_free,
                "host_in_use": host_in_use}
