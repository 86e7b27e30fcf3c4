"""Telemetry plane of the port: span tracing, the labelled metrics
registry (the port's own, apart from the reference's), per-tenant SLO
tracking, OpenMetrics export, the flight recorder, kernel-build
accounting and the provenance stamp.

Stdlib only apart from ``provenance``, which reads torch and the card
when asked.  The reference's ``enable_persistent_cache`` (JAX's
compilation cache) has no counterpart: the port's kernels are built once
per source hash (``repro_torch.kernels.build``).
"""
from .compile import (  # noqa: F401
    compile_stats,
    reset_compile_stats,
)
from .export import (  # noqa: F401
    parse_openmetrics,
    render_openmetrics,
)
from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    counter_delta,
    registry,
)
from .provenance import provenance  # noqa: F401
from .recorder import FlightRecorder  # noqa: F401
from .slo import (  # noqa: F401
    P2Quantile,
    SLOTracker,
    TenantSLO,
    solve_slo_summary,
)
from .trace import (  # noqa: F401
    Span,
    Tracer,
    active,
    install,
    span,
    tracing,
    uninstall,
    validate_chrome_trace,
)
