"""Build-provenance stamp of the port, for the flight recorder and
``/statz``.

One dict answers "which commit and which card produced this artifact?":
the git SHA, ``torch.__version__`` and ``torch.version.cuda``, the CUDA
device name and count, the platform, Python, and the sharding plane
(``partition.shard_info()``).  It records no JAX key: the port never
imports JAX.

Every field degrades to ``None`` rather than failing: stamps must work
outside a git checkout and on a host without a card just the same.
Computed once per process (the SHA cannot change under a running
solver).
"""
from __future__ import annotations

import os
import platform as _platform
import subprocess
from typing import Optional

_PROVENANCE: Optional[dict] = None


def provenance() -> dict:
    global _PROVENANCE
    if _PROVENANCE is not None:
        return _PROVENANCE
    sha = None
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=10, cwd=os.path.dirname(os.path.abspath(__file__)),
        ).stdout.strip() or None
    except Exception:
        pass
    torch_version = cuda_version = device = None
    devices = None
    try:
        import torch
        torch_version = torch.__version__
        cuda_version = torch.version.cuda
        devices = torch.cuda.device_count()
        if devices:
            device = torch.cuda.get_device_name(0)
    except Exception:
        pass
    shard = None
    try:
        from repro_torch.core import partition
        shard = partition.shard_info()
    except Exception:
        pass
    _PROVENANCE = {
        "git_sha": sha,
        "torch": torch_version,
        "cuda": cuda_version,
        "device": device,
        "devices": devices,
        "platform": _platform.platform(),
        "python": _platform.python_version(),
        "shard": shard,
    }
    return _PROVENANCE
