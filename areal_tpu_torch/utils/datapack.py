"""First-fit-decreasing bin packing (a copy of `ffd_allocate` and `flat2d`
from `areal_tpu/utils/datapack.py`, its numpy path, same semantics).

Host-side: it decides which samples share a micro-batch and never runs on
the device.
"""

from __future__ import annotations


def flat2d(arr: list[list]) -> list:
    """Flatten one nesting level."""
    return [x for sub in arr for x in sub]


def ffd_allocate(
    values: list[int], capacity: int, min_groups: int = 1
) -> list[list[int]]:
    """Group indices of `values` into bins whose sums stay <= capacity,
    producing at least `min_groups` bins. Items larger than `capacity` get
    singleton bins."""
    values = list(values)
    if capacity <= 0:
        raise ValueError("capacity must be positive")
    order = sorted(range(len(values)), key=lambda i: values[i], reverse=True)
    bins: list[list[int]] = []
    bin_sums: list[int] = []
    for idx in order:
        v = values[idx]
        placed = False
        for b in range(len(bins)):
            if bin_sums[b] + v <= capacity:
                bins[b].append(idx)
                bin_sums[b] += v
                placed = True
                break
        if not placed:
            bins.append([idx])
            bin_sums.append(v)
    # meet the minimum group count by splitting the largest bins
    while len(bins) < min_groups:
        cand = max(
            (b for b in range(len(bins)) if len(bins[b]) > 1),
            key=lambda b: bin_sums[b],
            default=None,
        )
        if cand is None:  # all singletons: pad with empty bins
            bins.append([])
            bin_sums.append(0)
            continue
        items = bins[cand]
        half = len(items) // 2
        bins[cand] = items[:half]
        bin_sums[cand] = sum(values[i] for i in items[:half])
        bins.append(items[half:])
        bin_sums.append(sum(values[i] for i in items[half:]))
    # deterministic order: sort each bin's indices, sort bins by first index
    bins = [sorted(b) for b in bins]
    bins.sort(key=lambda b: (b[0] if b else 1 << 60))
    return bins
