"""Deterministic per-role seeding (counterpart of
`areal_tpu/utils/seeding.py`).

`set_random_seed` seeds `random` and numpy exactly as the JAX package
does, from a fold of (seed, role key). Where JAX hands out PRNG keys
(`new_prng_key`), the port hands out seeded `torch.Generator`s.
"""

from __future__ import annotations

import hashlib
import random

import numpy as np
import torch

_BASE_SEED: int | None = None
_SEED_KEY: str = ""


def _fold(seed: int, key: str) -> int:
    digest = hashlib.sha256(f"{seed}/{key}".encode()).digest()
    return int.from_bytes(digest[:8], "little") % (2**31 - 1)


def set_random_seed(seed: int, key: str) -> None:
    """Seed host-side RNGs deterministically per (seed, role-key) pair."""
    global _BASE_SEED, _SEED_KEY
    _BASE_SEED, _SEED_KEY = seed, key
    folded = _fold(seed, key)
    random.seed(folded)
    np.random.seed(folded % (2**32 - 1))


def get_seed() -> int:
    if _BASE_SEED is None:
        raise RuntimeError("set_random_seed() has not been called")
    return _fold(_BASE_SEED, _SEED_KEY)


def new_generator(subkey: str = "", device: str | torch.device = "cpu") -> torch.Generator:
    """A `torch.Generator` on `device` seeded from the global (seed, key)
    plus `subkey`: the seed JAX's `new_prng_key(subkey)` builds its key
    from."""
    if _BASE_SEED is None:
        raise RuntimeError("set_random_seed() has not been called")
    return torch.Generator(device=device).manual_seed(_fold(_BASE_SEED, f"{_SEED_KEY}/{subkey}"))
