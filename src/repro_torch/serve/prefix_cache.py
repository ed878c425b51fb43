"""Cross-request prefix index over resident KV blocks.

The port's own copy of ``repro/serve/prefix_cache.py`` (hashlib and
numpy only; chain hashes byte-identical to the JAX package's).

Production serving traffic is dominated by shared prefix tokens —
system prompts, few-shot headers, multi-turn session history.  The
paged pool plus the content-addressing idiom of
:mod:`repro_torch.core.planstore` compose into a fleet-level prefix cache:
every *full* ``block_len``-aligned chunk of a request's feed tokens is
content-hashed with a **chained** hash (each block's hash folds in its
predecessor's, exactly like ``FrozenPlan.content_hash`` folds the whole
canonical payload), so a single hash names an entire prefix path.  The
chain is what makes a flat ``hash -> block id`` dict a radix trie with
maximal path compression: walking a request's chunk hashes in order and
stopping at the first miss *is* the longest-prefix descent, because a
chain hash can only match when every earlier chunk matched too.

One trie per allocator sub-pool: under 2-D pool sharding a slot may
only hold blocks from its data shard's sub-pool, so a match in a
foreign sub-pool would alias a block the slot's combine masks out.
Admission therefore matches per sub-pool and prefers placing the
request where the longest match lives.

Lifecycle contract (the engine owns it):

* ``insert`` after a request's feed rows land in pool blocks — only
  blocks covering *complete* chunks are indexed (a partial tail block
  is still being written and has no stable content);
* ``match`` at admission returns the resident block ids covering the
  longest indexed prefix of the feed;
* ``evict`` whenever blocks actually return to the free list
  (``BlockAllocator.release`` reports them) — a freed id's next tenant
  writes unrelated rows, so a stale trie entry would alias garbage.
  While *any* holder keeps a block resident its trie entry stays live,
  which is what lets request B keep hitting a prefix request A
  registered even after A finished, as long as a sharer pins it;
* ``rekey`` when a resident block changes id *without* changing
  content — a spill to the host tier, a promote back, a migration.
  Entries are **tier-tagged** so a hit can tell a decode-ready HBM
  block from a spilled one that must be promoted first: a hit on a
  spilled prefix promotes, it does not miss.  Only an actual free
  evicts.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence, Tuple

import numpy as np


def chain_hashes(tokens: Sequence[int], block_len: int) -> List[str]:
    """Chained content hashes of the full ``block_len`` chunks of
    ``tokens``: ``h[i] = sha256(h[i-1] || tokens[i*bl:(i+1)*bl])``.

    Only complete chunks are hashed — a trailing partial chunk has no
    entry (its block is still mutable).  The chain means ``h[i]``
    commits to every token before position ``(i+1)*bl``, so equal
    hashes imply equal whole prefixes, not merely equal chunks.
    """
    if block_len <= 0:
        return []
    toks = np.asarray(tokens, np.int64)
    out: List[str] = []
    h = b"kv-prefix-root"
    for i in range(len(toks) // block_len):
        chunk = toks[i * block_len:(i + 1) * block_len]
        h = hashlib.sha256(h + b"|" + chunk.tobytes()).digest()
        out.append(h.hex())
    return out


class PrefixCache:
    """Radix trie (chain-hash compressed) over resident pool blocks,
    one per allocator sub-pool."""

    def __init__(self, groups: int = 1):
        if groups < 1:
            raise ValueError(f"groups must be >= 1, got {groups}")
        self.groups = groups
        self._trie: List[Dict[str, int]] = [dict() for _ in range(groups)]
        self._by_block: Dict[int, Tuple[int, str]] = {}
        # residency tag per indexed block ("hbm" | "host"): a hit on a
        # host-tagged block is still a hit — the engine promotes it
        # back before aliasing (hit-after-spill)
        self._tier: Dict[int, str] = {}
        # telemetry: admission-time outcomes
        self.hits = 0           # requests admitted with >= 1 matched block
        self.misses = 0         # requests admitted with no match
        self.hit_tokens = 0     # total tokens whose prefill was aliased

    def __len__(self) -> int:
        return len(self._by_block)

    def has_block(self, block: int) -> bool:
        """Is this block id currently indexed by any trie entry?"""
        return block in self._by_block

    def tier_of(self, block: int) -> str:
        """Residency tag of an indexed block (KeyError if unindexed)."""
        return self._tier[block]

    def match(self, hashes: Sequence[str], group: int = 0) -> List[int]:
        """Longest-prefix descent: resident block ids for the leading
        run of chunk hashes present in ``group``'s trie."""
        t = self._trie[group]
        out: List[int] = []
        for h in hashes:
            b = t.get(h)
            if b is None:
                break
            out.append(b)
        return out

    def insert(self, hashes: Sequence[str], blocks: Sequence[int],
               group: int = 0, tier: str = "hbm") -> None:
        """Index ``blocks[i]`` as holding the prefix named ``hashes[i]``.
        First writer wins: a hash already present keeps its original
        block (the new copy is a private duplicate — correct, just not
        shared), and a block id already indexed under another hash is
        left alone (it cannot hold two different contents)."""
        t = self._trie[group]
        for h, b in zip(hashes, blocks):
            if h in t or b in self._by_block:
                continue
            t[h] = b
            self._by_block[b] = (group, h)
            self._tier[b] = tier

    def rekey(self, pairs: Sequence[Tuple[int, int]], tier: str) -> None:
        """Follow indexed blocks through a tier transition (or any
        id-preserving-content move): entry ``old`` becomes ``new``,
        tagged with the destination ``tier``.  The entry stays in its
        original group's trie — a spilled block still belongs to the
        sub-pool whose requests can promote it, and a promote re-tags
        in place.  Unindexed ``old`` ids are skipped (not every spilled
        block was ever registered)."""
        for old, new in pairs:
            gh = self._by_block.pop(old, None)
            if gh is None:
                continue
            self._tier.pop(old, None)
            g, h = gh
            self._trie[g][h] = new
            self._by_block[new] = (g, h)
            self._tier[new] = tier

    def evict(self, blocks: Sequence[int]) -> None:
        """Prune entries whose backing blocks left the pool (freed, or
        about to be rewritten by migration/CoW)."""
        for b in blocks:
            gh = self._by_block.pop(b, None)
            if gh is not None:
                self._trie[gh[0]].pop(gh[1], None)
            self._tier.pop(b, None)

    def stats(self) -> Dict[str, int]:
        return {"trie_blocks": len(self._by_block),
                "host_blocks": sum(1 for t in self._tier.values()
                                   if t == "host"),
                "hits": self.hits, "misses": self.misses,
                "hit_tokens": self.hit_tokens}
