"""Paged KV-cache accounting (counterpart of `areal_tpu/engine/kv_pool.py`,
`KVBlockAllocator` and `PoolDry`, :48-232).

One pool tensor `[L, n_blocks, block_size, nKV, hd]` per K/V lives on the
device; the block tables that map each slot's logical rows to pool blocks
are host-side numpy, owned by the decode scheduler thread. The decode
step receives a `[R, nb]` slice of them each chunk.

Sharing: a prefix fork aliases the donor's full blocks (a reference
count bump, a table write) and copies only the partial block at the
shared boundary. Aliased blocks are never written: a slot writes at
positions at or past its length, which is at or past the shared
boundary, and the boundary block is always the copied one.

Block 0 is a reserved null block: unallocated table entries point at it,
and the writes of inactive slots land in it. Its rows are read but never
scored (the validity mask hides them).
"""

from __future__ import annotations

import numpy as np


class PoolDry(Exception):
    """No free blocks; the caller reclaims (drops donor registrations and
    parked KV, then preempts) and retries or falls back."""


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
        self.reset_peaks()

    def reset_peaks(self) -> None:
        """Start the high-water marks over: `peak_blocks`, the most distinct
        blocks in use at once, and `peak_table_blocks`, the most table
        entries at once (an aliased block counted once per holder: the
        blocks the same slots would hold without sharing)."""
        self.peak_blocks = self.used_blocks
        self.peak_table_blocks = int(self.nblocks.sum())

    def _note_peaks(self) -> None:
        self.peak_blocks = max(self.peak_blocks, self.used_blocks)
        self.peak_table_blocks = max(self.peak_table_blocks, int(self.nblocks.sum()))

    @property
    def used_blocks(self) -> int:
        """Distinct blocks in use (aliased blocks count once)."""
        return self.usable_blocks - len(self._free)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def usable_blocks(self) -> int:
        return self.n_blocks - 1

    def blocks_for(self, tokens: int) -> int:
        return max(-(-int(tokens) // self.block_size), 0)

    def allocated_tokens(self) -> int:
        """Distinct blocks in use x block_size (aliased blocks count once)."""
        return self.used_blocks * self.block_size

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
        self._note_peaks()
        return True

    def fork(self, src: int, dst: int, covered: int) -> tuple[int, int] | None:
        """Point dst at src's first `covered` tokens of KV.

        Full blocks below the boundary are aliased (reference count + 1);
        the partial boundary block is freshly allocated and must be copied
        on the device by the caller: returns (src_block, dst_block) for
        that copy, or None when the boundary is block-aligned. src == dst
        is a no-op (in-place reuse of a retired donor slot). Raises
        PoolDry, with the aliases rolled back, when the boundary block
        cannot be allocated."""
        if src == dst:
            return None
        self.free_slot(dst)
        full = covered // self.block_size
        partial = covered % self.block_size
        for j in range(full):
            b = int(self.tables[src, j])
            self.tables[dst, j] = b
            if b != 0:
                self.refcount[b] += 1
        self.nblocks[dst] = full
        self.version += 1
        if partial:
            got = self._alloc(1)
            if got is None:
                # roll back the aliases; the caller reclaims or falls back
                self.free_slot(dst)
                raise PoolDry("no block for the fork boundary")
            self.tables[dst, full] = got[0]
            self.nblocks[dst] = full + 1
            self._note_peaks()
            return int(self.tables[src, full]), got[0]
        self._note_peaks()
        return None
