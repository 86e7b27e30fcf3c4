"""Kernel-build accounting: the port's counterpart of the reference's
XLA-compile counters.

The port compiles its CUDA kernels once per source hash
(``repro_torch.kernels.build``).  Three registry metrics record that:

  * ``qn.compiles``           — ``nvcc`` builds actually performed;
  * ``qn.compile_ms``         — total milliseconds spent in them (integer);
  * ``qn.compile_cache_hits`` — libraries loaded from the build directory
                                without compiling (same source hash).

``RunReport.telemetry["compile"]`` carries the per-run deltas of
``compile_stats()``, as in the reference.
"""
from __future__ import annotations

from repro_torch.obs import metrics as _obs_metrics

_REG = _obs_metrics.registry()
_COMPILES = _REG.counter("qn.compiles", help="kernel builds performed")
_COMPILE_MS = _REG.counter("qn.compile_ms",
                           help="total kernel build time [ms, int]")
_CACHE_HITS = _REG.counter("qn.compile_cache_hits",
                           help="kernel libraries loaded without a build")


def record_build(ms: float) -> None:
    with _REG.lock:
        _COMPILES.inc()
        _COMPILE_MS.inc(round(ms))


def record_cache_hit() -> None:
    _CACHE_HITS.inc()


def compile_stats() -> dict:
    """Consistent snapshot: ``compiles``, ``compile_ms``, ``cache_hits``."""
    with _REG.lock:
        return {"compiles": _COMPILES.value,
                "compile_ms": _COMPILE_MS.value,
                "cache_hits": _CACHE_HITS.value}


def reset_compile_stats() -> None:
    with _REG.lock:
        _COMPILES.reset()
        _COMPILE_MS.reset()
        _CACHE_HITS.reset()
