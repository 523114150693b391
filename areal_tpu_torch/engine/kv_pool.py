"""Paged KV-cache accounting and the host KV tier (counterpart of
`areal_tpu/engine/kv_pool.py`: `KVBlockAllocator` and `PoolDry`, :48-182,
`HostKVEntry` and `HostKVStore`, :183-537).

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

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from areal_tpu_torch.core import fault_injection


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

    def fragmentation_blocks(self) -> int:
        """Free blocks that cannot back another max-context admission: the
        remainder after whole `max_blocks_per_slot` reservations (JAX
        :94-99). Paged allocation needs no contiguity, so this is the only
        structural waste a full-context request can see; the router's
        admission subtracts it from a replica's headroom."""
        return len(self._free) % self.max_blocks_per_slot

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


@dataclass
class HostKVEntry:
    """One offloaded slot's KV (JAX :183-263): the slot's first `nb` pool
    blocks gathered into `[L, nb, block_size, nKV, hd]` K/V tensors, and
    the metadata a resume needs to promote them without a prefill.

    On the card `k`/`v` are pinned host tensors whose copies from the
    gathered device buffers (`dev`) may still be in flight on a side
    stream; `event` marks their end. `HostKVStore` materializes them
    behind a small pending window; `materialize` waits on the event and
    drops the device buffers. On the CPU the copies are synchronous and
    `event` is None.

    Int8 pools: `ks`/`vs` are the scale blocks gathered with the data
    (`[L, nb, nKV, block_size]`); the bytes and scales travel as they are,
    so a promoted stream reads the exact bytes the original scatter wrote.
    """

    rid: str
    k: Any
    v: Any
    nb: int
    covered: int  # rows [0, covered) of the blocks are valid
    tokens: list[int]  # the covered token ids, for the exact-resume check
    base_key: np.ndarray  # the slot's sampling key, restored at promotion
    # the weight version the KV was computed under; -1 unknown
    weight_version: int = -1
    ks: Any = None
    vs: Any = None
    # the pool scheme that wrote k/v ("fp" | "int8"): an exported session
    # carries it, and an import into a pool of the other scheme is refused
    kv_dtype: str = "fp"
    # the slot's m-rope position delta (an image session's; 0 for text),
    # restored at promotion (JAX :183-263)
    rope_delta: int = 0
    # an image session: its KV depends on pixels its tokens cannot key, so
    # it takes no fabric keys and never travels as identity only
    image: bool = False
    # the fabric's content keys of the entry's complete blocks
    # (`core/kv_fabric.chain_keys` over `tokens` at the pool's block size,
    # salted with the weight version and the dtype): the store indexes
    # them, so `match_blocks` serves a matching run to any request. Empty
    # when the fabric is off.
    block_keys: tuple[int, ...] = ()
    nbytes: int = 0
    pending: bool = field(default=False, repr=False)
    event: Any = field(default=None, repr=False)
    dev: tuple = field(default=(), repr=False)  # device buffers the copies read

    @property
    def meta_only(self) -> bool:
        """An identity-only entry (a cheap drain): resume metadata with no
        KV bytes. The blocks come back from the fleet or by a prefill; it
        never serves a block match."""
        return self.k is None

    def materialize(self) -> None:
        """Finish the device-to-host copies (waiting only if they are still
        in flight) and drop the device buffers."""
        if self.pending and self.event is not None:
            self.event.synchronize()
        self.event = None
        self.dev = ()
        self.pending = False


class HostKVStore:
    """Host-RAM tier under the paged pool (JAX :266-537): a byte-budgeted
    store of offloaded slots keyed by rid, with its own LRU.

    The eviction paths that would drop a parked or preempted slot's blocks
    offload them here instead, and a resume promotes them back into fresh
    device blocks, so `kv_pool_tokens` is a working-set size, not a wall.

    Not thread-safe by itself: the decode engine takes its `_host_lock`
    around every call.

    Counters (`swap_out_bytes_total`, `swap_in_bytes_total`, `hits`,
    `misses`, `evictions`, `rejected_puts`, `reprefill_tokens_avoided`,
    `version_rejects`) feed the engine's `get_metrics`. A miss is an
    exact-resume lookup whose entry was dropped (LRU, a weight-install
    clear: a bounded tombstone set remembers those rids) or went stale
    (the prompt diverged); a request that was never offloaded counts
    nothing.

    Imported sessions (`TorchDecodeEngine.import_session`) land here too,
    and a drain exports every resident entry (`rids`, `take`). The fabric's
    block index maps each resident block's content key to its entry
    (`match_blocks`, `fabric_keys`); an identity-only entry (`meta_only`)
    is never indexed.
    """

    def __init__(self, budget_bytes: int, block_nbytes: int, block_size: int,
                 pending_window: int = 2, tombstone_cap: int = 1024):
        if not (budget_bytes > 0 and block_nbytes > 0 and block_size > 0):
            raise ValueError("budget_bytes, block_nbytes and block_size must be positive")
        self.budget_bytes = int(budget_bytes)
        self.block_nbytes = int(block_nbytes)  # K+V bytes per pool block
        self.block_size = int(block_size)
        self.bytes_used = 0
        self._entries: OrderedDict[str, HostKVEntry] = OrderedDict()
        # rids whose entries were dropped: a later resume lookup of one is
        # an honest miss; a bounded FIFO
        self._tombstones: OrderedDict[str, None] = OrderedDict()
        self._tombstone_cap = int(tombstone_cap)
        # entries whose copies may still be in flight, oldest first,
        # materialized once more than `pending_window` are outstanding
        self._pending: list[str] = []
        self._pending_window = max(int(pending_window), 0)
        # the fabric's block index: content key -> (rid, ordinal) of a
        # resident entry holding that block. The first writer wins (equal
        # keys mean equal bytes); identity-only entries are never indexed.
        self._block_index: dict[int, tuple[str, int]] = {}
        self.swap_out_bytes_total = 0
        self.swap_in_bytes_total = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.rejected_puts = 0
        self.reprefill_tokens_avoided = 0
        # lookups rejected for a weight version that is no longer the
        # engine's (each also counts in `misses`)
        self.version_rejects = 0

    def __len__(self) -> int:
        return len(self._entries)

    def rids(self) -> list[str]:
        """Resident entries' rids, least recently used first (a drain
        exports every one of them)."""
        return list(self._entries)

    def resident_tokens(self) -> int:
        return sum(e.covered for e in self._entries.values())

    def occupancy(self) -> float:
        return self.bytes_used / self.budget_bytes if self.budget_bytes else 0.0

    def tombstone(self, rid: str) -> None:
        """Mark `rid` known but unusable: its next exact-resume lookup
        counts a miss."""
        self._tombstones[rid] = None
        self._tombstones.move_to_end(rid)
        while len(self._tombstones) > self._tombstone_cap:
            self._tombstones.popitem(last=False)

    def _unindex(self, e: HostKVEntry) -> None:
        for key in e.block_keys:
            owner = self._block_index.get(key)
            if owner is not None and owner[0] == e.rid:
                del self._block_index[key]

    def _index(self, e: HostKVEntry) -> None:
        if e.meta_only:
            return
        for i, key in enumerate(e.block_keys):
            self._block_index.setdefault(key, (e.rid, i))

    def _drop(self, rid: str, tombstone: bool) -> None:
        e = self._entries.pop(rid, None)
        if e is None:
            return
        self.bytes_used -= e.nbytes
        self._unindex(e)
        if rid in self._pending:
            self._pending.remove(rid)
        if tombstone:
            self.tombstone(rid)

    def _drain_pending(self, keep: int) -> None:
        while len(self._pending) > keep:
            e = self._entries.get(self._pending.pop(0))
            if e is not None:
                e.materialize()

    def put(self, entry: HostKVEntry) -> bool:
        """Admit an offloaded slot's KV, evicting least recently used
        entries to fit. False (counted in `rejected_puts`, the rid
        tombstoned) when the entry alone exceeds the budget: the caller
        drops the blocks, as with no tier."""
        # the D2H offload seam: an abort models the host copy failing; the
        # engine counts it and drops the blocks
        fault_injection.fire("kv.swap_out", rid=entry.rid)
        # an identity-only entry is charged a nominal footprint for its
        # token list, so it ages out under pressure without competing with
        # block bytes
        entry.nbytes = (entry.nb * self.block_nbytes if not entry.meta_only
                        else 64 + 4 * len(entry.tokens))
        if entry.nbytes > self.budget_bytes:
            self.tombstone(entry.rid)
            self.rejected_puts += 1
            return False
        self._drop(entry.rid, tombstone=False)  # replace, never duplicate
        while self.bytes_used + entry.nbytes > self.budget_bytes:
            self._drop(next(iter(self._entries)), tombstone=True)
            self.evictions += 1
        self._entries[entry.rid] = entry
        self.bytes_used += entry.nbytes
        self._index(entry)
        if entry.pending:
            self._pending.append(entry.rid)
            self._drain_pending(self._pending_window)
        self.swap_out_bytes_total += entry.nbytes
        return True

    def match(self, rid: str, covered: int, tokens: list[int],
              weight_version: int | None = None) -> bool:
        """Exact-resume peek: does an entry cover precisely `tokens`? A rid
        that was offloaded but can no longer serve this resume counts a
        miss (a stale entry is dropped); a rid never offloaded counts
        nothing. An entry computed under another `weight_version` is
        rejected as a miss too."""
        e = self._entries.get(rid)
        if e is None:
            if rid in self._tombstones:
                del self._tombstones[rid]
                self.misses += 1
            return False
        if e.meta_only:
            # no bytes to promote: the engine claims the sampling key on
            # its own and rebuilds the blocks through the fabric or a prefill
            return False
        if (weight_version is not None and e.weight_version >= 0
                and e.weight_version != weight_version):
            self._drop(rid, tombstone=False)
            self.misses += 1
            self.version_rejects += 1
            return False
        if e.covered == covered and e.tokens == tokens:
            return True
        self._drop(rid, tombstone=False)  # the prompt diverged
        self.misses += 1
        return False

    def take(self, rid: str) -> HostKVEntry | None:
        """Pop the entry for promotion, materialized. The caller reports
        the outcome: `note_hit` after the upload, or `restore` when no
        device blocks could back it."""
        # the promotion seam: an abort models the upload dying before any
        # state moved; the engine counts it and prefills instead
        fault_injection.fire("kv.swap_in", rid=rid)
        e = self._entries.pop(rid, None)
        if e is None:
            return None
        self.bytes_used -= e.nbytes
        self._unindex(e)
        if rid in self._pending:
            self._pending.remove(rid)
        e.materialize()
        return e

    def note_hit(self, entry: HostKVEntry) -> None:
        self.hits += 1
        self.swap_in_bytes_total += entry.nbytes
        self.reprefill_tokens_avoided += entry.covered

    def restore(self, entry: HostKVEntry) -> None:
        """Undo a `take` whose promotion found no device blocks; the entry
        goes back least recently used first, so a retry comes soon."""
        self.bytes_used += entry.nbytes
        self._entries[entry.rid] = entry
        self._index(entry)
        self._entries.move_to_end(entry.rid, last=False)

    def peek(self, rid: str) -> HostKVEntry | None:
        """The entry of `rid`, with no counter or LRU change."""
        return self._entries.get(rid)

    def match_blocks(self, chain: list[int],
                     min_blocks: int = 1) -> tuple[HostKVEntry, int] | None:
        """The longest content-keyed run the store can serve: the largest
        n >= `min_blocks` with chain[n-1] indexed, as (entry, n). The keys
        bind positions, so the entry's first n blocks hold exactly the
        request's first n blocks of tokens. Counts nothing: the engine
        attributes fabric hits, and a block match must not move the
        exact-resume hit rate."""
        for n in range(len(chain), max(0, min_blocks - 1), -1):
            owner = self._block_index.get(chain[n - 1])
            if owner is None:
                continue
            rid, ordinal = owner
            e = self._entries.get(rid)
            # an ordinal off the chain's position is a 64-bit collision
            # between prefixes of different lengths
            if e is None or e.meta_only or ordinal != n - 1 or e.nb < n:
                continue
            e.materialize()
            return e, n
        return None

    def fabric_keys(self) -> list[int]:
        """Resident content keys that can be served (the /metrics digest)."""
        return list(self._block_index)

    def flush_pending(self) -> None:
        self._drain_pending(0)

    def clear(self) -> int:
        """Drop every entry (weight installs, abort, destroy: KV of old
        weights never seeds generation under new ones). Each dropped rid is
        tombstoned, so its resume counts a miss."""
        n = len(self._entries)
        for rid in list(self._entries):
            self._drop(rid, tombstone=True)
        self._pending.clear()
        self._block_index.clear()
        return n
