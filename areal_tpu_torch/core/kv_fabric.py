"""Content-keyed KV block runs for the fleet-wide KV fabric (counterpart
of `areal_tpu/core/kv_fabric.py`, kept as the port's own copy).

Every complete KV block gets a 64-bit content key:

    key_i = blake2b(key_{i-1} || weight_version || kv_dtype
                    || tokens[i*B:(i+1)*B])[:8]

Chaining binds a key to its position: two token sequences with equal
key_i hold equal first i+1 blocks, so "this key is resident" means "the
whole prefix up to here is resident", and a matched run needs no token
comparison. The weight version and the pool dtype salt every key: a
weight flip or another dtype changes all of them, and stale blocks are
honest misses, never served.

Keys are blake2b, not Python's `hash`, so they are equal across
processes, machines and the two packages: a replica's digest means the
same to the router and to every sibling.

Only numpy and hashlib: the router and supervisor import it without the
device stack.
"""

from __future__ import annotations

import base64
import hashlib
import logging
import struct
from typing import Iterable, Sequence

import numpy as np

logger = logging.getLogger("kv_fabric")

# parent key of every chain's block 0 (any fixed 64-bit constant)
CHAIN_ROOT = 0x9E3779B97F4A7C15

# most keys a digest carries whatever the caller asks: a digest rides in
# the /metrics JSON
DIGEST_HARD_CAP = 4096


def content_key(parent: int, token_block: Sequence[int], weight_version: int,
                kv_dtype: str) -> int:
    """The 64-bit content key of one block, chained on its parent's key."""
    h = hashlib.blake2b(digest_size=8)
    h.update(struct.pack("<Qq", parent & 0xFFFFFFFFFFFFFFFF, int(weight_version)))
    h.update(kv_dtype.encode())
    h.update(np.asarray(token_block, dtype=np.uint32).tobytes())
    return int.from_bytes(h.digest(), "little")


def chain_keys(tokens: Sequence[int], block_size: int, weight_version: int,
               kv_dtype: str, max_blocks: int = 0) -> list[int]:
    """Chained content keys of every complete block of `tokens`.

    The trailing partial block is never keyed: its pool rows are shared
    with whatever the owner writes next, and a suffix prefill recomputes
    it anyway. `max_blocks` > 0 caps the chain (the router's hints)."""
    bs = max(1, int(block_size))
    nb = len(tokens) // bs
    if max_blocks > 0:
        nb = min(nb, max_blocks)
    keys: list[int] = []
    parent = CHAIN_ROOT
    for i in range(nb):
        parent = content_key(parent, tokens[i * bs:(i + 1) * bs],
                             weight_version, kv_dtype)
        keys.append(parent)
    return keys


def longest_run(chain: Sequence[int], resident: "set[int] | dict") -> int:
    """The largest n with chain[n-1] resident (0 if none). Chaining makes
    a match at n-1 imply blocks 0..n-1 all match."""
    for n in range(len(chain), 0, -1):
        if chain[n - 1] in resident:
            return n
    return 0


def encode_digest(keys: Iterable[int], cap: int = 1024) -> str:
    """Pack keys into base64 little-endian uint64s, at most `cap` of them
    (and never more than DIGEST_HARD_CAP). Order matters only for hints (a
    chain run); a replica's digest is a set."""
    cap = min(int(cap), DIGEST_HARD_CAP) if cap > 0 else DIGEST_HARD_CAP
    arr = np.fromiter((int(k) & 0xFFFFFFFFFFFFFFFF for k in keys),
                      dtype=np.uint64)[:cap]
    return base64.b64encode(arr.tobytes()).decode("ascii")


def decode_digest(digest: str) -> list[int]:
    """Inverse of `encode_digest`; a malformed digest decodes to []."""
    if not digest or not isinstance(digest, str):
        return []
    try:
        raw = base64.b64decode(digest.encode("ascii"), validate=True)
    except Exception as e:  # noqa: BLE001 — an unreadable digest advertises nothing
        logger.debug(f"malformed fabric digest ignored: {e!r}")
        return []
    if len(raw) % 8:
        return []
    return [int(k) for k in np.frombuffer(raw, dtype=np.uint64)]
