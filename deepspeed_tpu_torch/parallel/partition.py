"""Balanced partitioning of weighted items into contiguous parts — a copy
of ``deepspeed_tpu/parallel/partition.py`` (pure Python; the port keeps
its own copy and imports nothing of the JAX package).

Used for pipeline layer assignment (reference: deepspeed/runtime/utils.py:295-377
``partition_uniform``/``partition_balanced``).  The balanced variant here is a
binary search on the bottleneck capacity with a greedy feasibility sweep —
O(n log(sum(weights))) — rather than the reference's probe machinery; output
contract is identical: ``parts`` of length ``num_parts+1`` with
``parts[p] .. parts[p+1]`` the half-open item range of part ``p``.
"""
from __future__ import annotations

from typing import List, Sequence


def partition_uniform(num_items: int, num_parts: int) -> List[int]:
    parts = [0] * (num_parts + 1)
    if num_parts == 0:
        return parts
    base = num_items // num_parts
    extra = num_items % num_parts
    for p in range(num_parts):
        parts[p + 1] = parts[p] + base + (1 if p < extra else 0)
    assert parts[-1] == num_items
    return parts


def _feasible(weights: Sequence[float], num_parts: int, cap: float) -> bool:
    """Can weights be split into <= num_parts contiguous chunks each <= cap?"""
    count, acc = 1, 0.0
    for w in weights:
        if w > cap:
            return False
        if acc + w > cap:
            count += 1
            acc = w
            if count > num_parts:
                return False
        else:
            acc += w
    return True


def partition_balanced(weights: Sequence[float], num_parts: int,
                       eps: float = 1e-3) -> List[int]:
    """Minimize the max part weight over contiguous partitions."""
    n = len(weights)
    if n == 0 or num_parts <= 0:
        return [0] * (num_parts + 1)
    if num_parts >= n:
        # one item per part, trailing empty parts
        parts = list(range(n + 1)) + [n] * (num_parts - n)
        return parts

    lo, hi = max(weights), sum(weights)
    while hi - lo > eps * max(1.0, lo):
        mid = (lo + hi) / 2
        if _feasible(weights, num_parts, mid):
            hi = mid
        else:
            lo = mid
    cap = hi

    # Greedy sweep at the found capacity.  Feasibility guarantees <= num_parts
    # chunks; the must_split guard keeps enough items in reserve that every
    # remaining part ends up non-empty.
    parts = [0]
    acc = 0.0
    for i, w in enumerate(weights):
        interior_remaining = (num_parts - 1) - (len(parts) - 1)
        if interior_remaining > 0 and i > parts[-1]:
            must_split = (n - i) <= interior_remaining
            if must_split or acc + w > cap:
                parts.append(i)
                acc = 0.0
        acc += w
    parts.append(n)
    assert len(parts) == num_parts + 1, (parts, num_parts)
    assert all(parts[i] < parts[i + 1] for i in range(num_parts))
    return parts


def prefix_sum_inc(weights: Sequence[float]) -> List[float]:
    out, acc = [], 0.0
    for w in weights:
        acc += w
        out.append(acc)
    return out
