"""Paged KV-cache accounting (counterpart of `areal_tpu/engine/kv_pool.py`,
`KVBlockAllocator` and `PoolDry`, :48-180).

One pool tensor `[L, n_blocks, block_size, nKV, hd]` per K/V lives on the
device; the block tables that map each slot's logical rows to pool blocks
are host-side numpy, owned by the decode scheduler thread. The decode
step receives a `[R, nb]` slice of them each chunk.

Block 0 is a reserved null block: unallocated table entries point at it,
and the writes of inactive slots land in it. Its rows are read but never
scored (the validity mask hides them).
"""

from __future__ import annotations

import numpy as np


class PoolDry(Exception):
    """No free blocks; the caller reclaims (preempts) and retries."""


class KVBlockAllocator:
    """Host-side block accounting for one decode engine. Not thread-safe
    by itself: the decode scheduler thread is the only mutator."""

    def __init__(self, n_slots: int, n_blocks: int, block_size: int,
                 max_blocks_per_slot: int):
        if n_blocks < max_blocks_per_slot + 1:
            raise ValueError(
                "pool must fit one full-context request plus the null block: "
                f"n_blocks={n_blocks} max_blocks_per_slot={max_blocks_per_slot}"
            )
        self.block_size = int(block_size)
        self.n_blocks = int(n_blocks)
        self.max_blocks_per_slot = int(max_blocks_per_slot)
        # refcount[0] (null block) is pinned so it can never be allocated
        self.refcount = np.zeros(n_blocks, dtype=np.int32)
        self.refcount[0] = 1
        self._free: list[int] = list(range(n_blocks - 1, 0, -1))
        self.tables = np.zeros((n_slots, max_blocks_per_slot), dtype=np.int32)
        self.nblocks = np.zeros(n_slots, dtype=np.int32)
        # bumped on every table mutation; consumers cache uploads against it
        self.version = 0

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def usable_blocks(self) -> int:
        return self.n_blocks - 1

    def blocks_for(self, tokens: int) -> int:
        return max(-(-int(tokens) // self.block_size), 0)

    def table_slice(self, nb: int) -> np.ndarray:
        """[n_slots, nb] table head (a copy: the scheduler mutates the
        original while the device reads the upload)."""
        return self.tables[:, :nb].copy()

    def row(self, slot: int, nb: int) -> np.ndarray:
        return self.tables[slot, :nb].copy()

    def _alloc(self, n: int) -> list[int] | None:
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self.refcount[b] = 1
        return out

    def free_slot(self, slot: int) -> None:
        nb = int(self.nblocks[slot])
        if nb:
            self.version += 1
        for j in range(nb):
            b = int(self.tables[slot, j])
            if b == 0:
                continue
            self.refcount[b] -= 1
            if self.refcount[b] == 0:
                self._free.append(b)
        self.tables[slot, :] = 0
        self.nblocks[slot] = 0

    def ensure(self, slot: int, tokens: int) -> bool:
        """Grow the slot's table to cover `tokens` KV rows. False = pool
        dry (the caller reclaims and retries)."""
        target = min(self.blocks_for(tokens), self.max_blocks_per_slot)
        cur = int(self.nblocks[slot])
        if target <= cur:
            return True
        got = self._alloc(target - cur)
        if got is None:
            return False
        self.tables[slot, cur:target] = got
        self.nblocks[slot] = target
        self.version += 1
        return True
