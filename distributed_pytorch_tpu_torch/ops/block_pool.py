"""Paged KV-cache block pool: host-side allocator + device-side ops.

Counterpart of the reference package's `ops/block_pool.py`. KV rows live
in fixed-size BLOCKS drawn from a global pool; each sequence owns an
ordered list of block ids (its *block table*), and immutable full blocks
are content-addressed so identical prompt prefixes resolve to the *same*
physical blocks (PagedAttention; PAPERS.md).

* **Device ops** (`paged_update`, `paged_gather`): the (n_blocks, bs, ...)
  pool is a plain tensor. A token write is a 2-index scatter through the
  block table, done IN PLACE (the pool is the engine's largest buffer, and
  nothing holds an older version of it); a logical view for the naive
  attention path is one advanced-indexing gather. The CUDA kernels
  (ops/flash_decode.py) skip the gather and read blocks straight from the
  pool through the table. Physical block 0 is the NULL block: retired
  slots' table rows are zeroed, and any write whose logical block falls
  off the table is routed there explicitly — torch indexing has no
  "drop out-of-range rows" mode, so the routing is spelled out.
* **`BlockPool`** and the **prefix index** (`lookup`/`register`,
  `chain_keys`): plain Python on the engine's thread, copied from the
  reference — refcounted blocks, an LRU of cached refcount-0 blocks, and
  chain keys (parent digest, block tokens) forming a flattened radix tree.
"""

from __future__ import annotations

import collections
import hashlib
from typing import Iterable, Optional

import numpy as np
import torch

#: physical block 0 is never allocated: zeroed table rows route dead-slot
#: writes here (see module docstring)
NULL_BLOCK = 0


class NoFreeBlocks(RuntimeError):
    """The pool has no free or evictable block — every block is referenced
    by a live sequence. At admission this means "stay queued"; during
    decode the engine preempts a victim instead."""


# ---------------------------------------------------------------------------
# device-side paged-cache ops
# ---------------------------------------------------------------------------

def paged_update(pool: torch.Tensor, new: torch.Tensor, pos,
                 block_tables: torch.Tensor) -> torch.Tensor:
    """Write `new` (B, T, ...) rows into the (n_blocks, bs, ...) pool at
    logical positions [pos, pos+T) of each sequence, addressed through
    `block_tables` (B, max_blocks) int32. Updates `pool` in place and
    returns it.

    * T == 1 (decode step): `pos` is per-sequence (B,) (or a scalar); one
      2-index scatter writes every slot's row. A row whose logical block
      lies past the table lands in the null block.
    * T > 1 (bucketed prefill): B == 1, `pos` an int, block-aligned (the
      reused-prefix length), T a multiple of the block size; whole blocks
      are scattered in one shot. The table window's start clamps so it
      stays inside the table, as the reference's dynamic slice does.
    """
    new = new.to(pool.dtype)
    B, T = new.shape[:2]
    bs = pool.shape[1]
    W = block_tables.shape[1]
    if T == 1:
        p = torch.as_tensor(pos, device=pool.device).long().reshape(-1)
        p = p.expand(B)
        q = p // bs
        blk = torch.gather(block_tables.long(), 1,
                           q.clamp(max=W - 1)[:, None])[:, 0]
        blk = torch.where(q < W, blk, torch.full_like(blk, NULL_BLOCK))
        pool[blk, p % bs] = new[:, 0]
        return pool
    assert B == 1, "paged prefill writes one sequence at a time"
    assert isinstance(pos, int), "paged prefill takes a host int offset"
    assert T % bs == 0, f"prefill length {T} not a multiple of block {bs}"
    nblk = T // bs
    start = min(max(pos // bs, 0), W - nblk)
    blks = block_tables[0, start:start + nblk].long()
    pool[blks] = new[0].reshape((nblk, bs) + tuple(new.shape[2:]))
    return pool


def paged_gather(pool: torch.Tensor,
                 block_tables: torch.Tensor) -> torch.Tensor:
    """Materialize the logical (B, max_blocks*bs, ...) view of each
    sequence's cache for the naive attention path. Rows past a sequence's
    extent map through null/stale blocks and carry garbage; they are
    causally masked to weight 0.0 before they can touch the output."""
    B, n_max = block_tables.shape
    g = pool[block_tables.long()]               # (B, n_max, bs, ...)
    return g.reshape((B, n_max * pool.shape[1]) + tuple(pool.shape[2:]))


# ---------------------------------------------------------------------------
# host-side allocator + prefix index
# ---------------------------------------------------------------------------

#: ancestry digest of the empty prefix (the radix root)
ROOT_DIGEST = b"\x00" * 16


def _child_digest(parent: bytes, block: tuple) -> bytes:
    h = hashlib.blake2b(parent, digest_size=16)
    # host-side chain-key hashing over concrete python ints — never traced
    h.update(np.asarray(block, np.int64).tobytes())
    return h.digest()


def chain_keys(tokens, block_size: int, n_blocks: int,
               parent=ROOT_DIGEST) -> list:
    """Chain keys for the first `n_blocks` FULL blocks of `tokens`:
    key_i = (digest_{i-1}, tokens of block i), where digest_i folds
    block i into its parent's digest. The digest stands in for the whole
    ancestry, so a key encodes the prefix up to and including its block
    (equal keys imply equal content at equal positions, up to blake2b
    collisions) while hashing in O(block_size) — the naive nested-tuple
    key made one admission's lookup+register pass O(n^2 * block_size)
    host-side for an n-block prompt."""
    keys = []
    for i in range(n_blocks):
        block = tuple(int(t) for t in tokens[i * block_size:(i + 1) * block_size])
        keys.append((parent, block))
        parent = _child_digest(parent, block)
    return keys


class BlockPool:
    """Refcounted block allocator with an LRU prefix cache.

    Block states (disjoint):
    * free        — on the free list, content garbage;
    * referenced  — refcount >= 1 live sequences own it (possibly shared);
    * cached      — refcount 0 but registered in the prefix index: content
                    retained, evictable LRU-first when the free list runs
                    dry.

    The null block (id 0) is reserved and never enters any state.
    """

    def __init__(self, n_blocks: int, block_size: int):
        assert n_blocks >= 2, "pool needs the null block plus one real one"
        self.n_blocks = n_blocks
        self.block_size = block_size
        self._free: collections.deque[int] = collections.deque(
            range(1, n_blocks))
        self._ref: dict[int, int] = {}           # block -> refcount (>= 1)
        self._key_of: dict[int, tuple] = {}      # registered block -> key
        self._index: dict[tuple, int] = {}       # chain key -> block
        self._lru: collections.OrderedDict[int, None] = \
            collections.OrderedDict()            # cached blocks, oldest first
        # eviction hook: called as on_evict(blk, key) the moment a cached
        # block is about to be recycled, BEFORE its contents are
        # overwritten (a host-RAM tier would demote the block here). None
        # (default) keeps plain drop-at-eviction semantics.
        self.on_evict = None
        # lifetime counters (engine metrics read these)
        self.n_evicted = 0
        self.n_allocs = 0

    # -- capacity accounting -------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_cached(self) -> int:
        return len(self._lru)

    @property
    def n_referenced(self) -> int:
        return len(self._ref)

    @property
    def capacity(self) -> int:
        """Allocatable blocks (the null block is not one)."""
        return self.n_blocks - 1

    @property
    def utilization(self) -> float:
        """Referenced fraction of the pool (cached blocks are reclaimable,
        so they don't count as used)."""
        return self.n_referenced / self.capacity if self.capacity else 0.0

    # -- alloc / free ---------------------------------------------------
    def alloc(self) -> Optional[int]:
        """A fresh private block (refcount 1), evicting the LRU cached
        block when the free list is empty. None when every block is
        referenced — the caller preempts or stays queued."""
        if self._free:
            blk = self._free.popleft()
        elif self._lru:
            blk, _ = self._lru.popitem(last=False)   # oldest cached
            key = self._key_of.pop(blk)
            self._index.pop(key, None)
            self.n_evicted += 1
            if self.on_evict is not None:
                # second-tier demotion: the block is refcount-0 and its
                # contents still intact — the hook copies them out before
                # this alloc's owner overwrites the rows
                self.on_evict(blk, key)
        else:
            return None
        self._ref[blk] = 1
        self.n_allocs += 1
        return blk

    def alloc_many(self, n: int) -> Optional[list[int]]:
        """n fresh blocks or None (all-or-nothing: a partial admission
        would leak refs)."""
        got: list[int] = []
        for _ in range(n):
            blk = self.alloc()
            if blk is None:
                for b in got:
                    self.release(b)
                return None
            got.append(blk)
        return got

    def ref(self, blk: int) -> None:
        """Take a reference on a cached or already-referenced block (a
        prefix hit sharing it with a new sequence)."""
        if blk in self._ref:
            self._ref[blk] += 1
            return
        assert blk in self._lru, f"block {blk} is neither live nor cached"
        del self._lru[blk]
        self._ref[blk] = 1

    def release(self, blk: int) -> None:
        """Drop one reference. At refcount 0 a registered block is
        retained on the LRU (prefix cache); an unregistered one goes back
        to the free list."""
        n = self._ref[blk] - 1
        if n:
            self._ref[blk] = n
            return
        del self._ref[blk]
        if blk in self._key_of:
            self._lru[blk] = None                # most-recently released
        else:
            self._free.append(blk)

    def release_all(self, blocks: Iterable[int]) -> None:
        """Release a sequence's blocks tail-first, so when eviction comes
        the deepest (least shareable) blocks go before their ancestors —
        the chain walk needs ancestors to reach descendants at all."""
        for blk in reversed(list(blocks)):
            self.release(blk)

    # -- prefix index ---------------------------------------------------
    def lookup(self, key: tuple) -> Optional[int]:
        """Block holding this chain key's content, or None. Touches the
        LRU so a hit streak keeps a hot prefix resident."""
        blk = self._index.get(key)
        if blk is not None and blk in self._lru:
            self._lru.move_to_end(blk)
        return blk

    def register(self, blk: int, key: tuple) -> None:
        """Publish a full, immutable, referenced block under its chain
        key. First writer wins: a concurrent identical prefill keeps its
        private copy unregistered (it frees normally on release)."""
        if key in self._index or blk in self._key_of:
            return
        assert blk in self._ref, "only referenced blocks can be registered"
        self._index[key] = blk
        self._key_of[blk] = key
