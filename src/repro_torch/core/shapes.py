"""Geometric shape bucketing of the simulator's dispatch axes.

The reference quantizes every static axis of a jitted simulator program
to a bucket grid so that nearby shapes share one compiled executable.
The port keeps the same buckets because the dispatch accounting
(``qn_sim.sim_stats``/``padding_stats``) and the lane layout must equal
the reference's call for call.  The grid is the reference's default
``geo`` grid: powers of two plus their 1.5x midpoints (1, 2, 3, 4, 6, 8,
12, 16, 24, 32, 48, 64, 96, 128, 192, ...).

Logical event budgets (``qn_sim.padded_event_budget``) stay on the pow2
grid: they are RNG fold offsets, so their grid is part of the simulated
values.  ``h_users`` is never bucketed: the initial think-time draw has
shape ``(H,)``.
"""
from __future__ import annotations


def pow2(n: int) -> int:
    """Smallest power of two >= max(n, 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def bucket(n: int, *, floor: int = 1) -> int:
    """Smallest point of the geo grid >= max(n, floor): a power of two or
    its 1.5x midpoint 3·2^k."""
    n = max(int(n), int(floor), 1)
    p = pow2(n)
    # the midpoint 3·2^(k-2) sits between 2^(k-1) and 2^k
    mid = 3 * (p // 4)
    return mid if mid >= n else p


def bucket_lanes(n: int) -> int:
    """Bucket a lane count (candidate axis).  Padding lanes replicate a
    real lane and are dropped on the way out — lane results are
    independent, so values are unchanged."""
    return bucket(n)


def bucket_slots(n: int) -> int:
    """Bucket a ``max_slots`` axis.  Slots past a lane's capacity are
    disabled and never win a selection — values are unchanged."""
    return bucket(n)


def bucket_events(n: int) -> int:
    """Bucket a logical event budget: always pow2, since the budget is the
    RNG fold offset of the think-redraw stream and so part of the
    simulated values."""
    return pow2(n)


def bucket_stages(n: int) -> int:
    """Bucket a DAG stage-array length.  Each lane carries its true stage
    count and clips every stage index to it, so padded stages are
    unreachable — values are unchanged."""
    return bucket(n)
