"""Lane partitioning of fused dispatches — the single-device part.

The reference splits the flat lane axis (lane = candidate x replication)
across a device mesh.  The port runs every fused dispatch on one CUDA
device, so the shard count is always 1 and the device-aware lane bucket
degenerates to ``shapes.bucket_lanes``.  The functions keep the
reference's names and signatures so that the dispatch accounting
(``qn_sim.padding_stats``) is computed by the same formulas.
``shard_info`` stamps the service's stats and the provenance record.
"""
from __future__ import annotations

from repro_torch.core import shapes as _shapes


def shard_count(lanes: int = None) -> int:
    """Shards of a fused dispatch: always 1 (one device)."""
    return 1


def bucket_lanes(n: int, shards: int = 1) -> int:
    """Candidate-axis bucket of a dispatch over ``shards`` devices."""
    if shards != 1:
        raise NotImplementedError("lane sharding across devices is not "
                                  "ported yet")
    return _shapes.bucket_lanes(n)


def shard_info() -> dict:
    """Stamp of the sharding plane, with the reference's keys: the spec
    (always ``"off"``: one device), the CUDA devices this process sees
    (``None`` where torch cannot tell), the shard count and the mesh."""
    try:
        import torch
        n = torch.cuda.device_count()
    except Exception:                      # pragma: no cover - no torch
        n = None
    return {"spec": "off", "devices": n, "shards": shard_count(),
            "mesh": [shard_count()]}
