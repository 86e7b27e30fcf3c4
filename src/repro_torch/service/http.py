"""Scrape surface of the solver service: /metrics, /healthz, /statz.

A stdlib ``ThreadingHTTPServer`` on a daemon thread — the surface a node
registry would health-check and scrape, with zero new dependencies:

  * ``/metrics``  — the whole registry in OpenMetrics text format
    (``repro_torch.obs.export.render_openmetrics`` over the port's own
    registry), tenant-labeled series included; scrape it with Prometheus
    or curl;
  * ``/healthz``  — liveness JSON: solver-pool state (queue depth,
    active jobs, rounds driven), admission pressure (in-flight event and
    core budgets), recorder drop count.  200 while the service object is
    reachable — the judgement of *degraded* is the scraper's, from the
    numbers;
  * ``/statz``    — the deep-dive JSON: per-tenant usage + SLO state,
    per-job summaries, service stats, flight-recorder tail.

Handlers only *read* service state (every endpoint renders under the
registry/service locks' own consistency rules), so scraping never blocks
a scheduling round beyond one snapshot.  JSON is sanitized for strict
parsers: ``inf``/``nan`` (legal in reports, e.g. an infeasible class's
predicted time) become strings.
"""
from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.obs.export import render_openmetrics

#: content type the OpenMetrics spec prescribes for text exposition
OPENMETRICS_CONTENT_TYPE = \
    "application/openmetrics-text; version=1.0.0; charset=utf-8"


def _clean(obj):
    """JSON-strict copy: non-finite floats become their string names
    (json.dumps would emit bare ``Infinity``, which strict parsers
    reject)."""
    if isinstance(obj, float):
        if math.isinf(obj):
            return "inf" if obj > 0 else "-inf"
        if math.isnan(obj):
            return "nan"
        return obj
    if isinstance(obj, dict):
        return {str(k): _clean(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_clean(v) for v in obj]
    return obj


class ScrapeServer:
    """Handle of a running scrape endpoint (``serve()`` builds it)."""

    def __init__(self, httpd: ThreadingHTTPServer, thread: threading.Thread):
        self._httpd = httpd
        self._thread = thread

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def healthz(service) -> dict:
    """The /healthz document: liveness + load of one solver service."""
    adm = service.admission
    return {
        "ok": True,
        "queue_depth": service.queue_depth,
        "active_jobs": service.active_jobs,
        "rounds": service.rounds,
        "admission": {
            "policy": adm.policy,
            "inflight_events": adm.stats.inflight_events,
            "max_inflight_events": adm.max_inflight_events,
            "inflight_cores": adm.stats.inflight_cores,
            "max_physical_cores": adm.max_physical_cores,
        },
        "cache_entries": len(service.cache),
        "recorder": service.recorder.stats(),
    }


def serve(service, *, host: str = "127.0.0.1",
          port: int = 0) -> ScrapeServer:
    """Start the scrape surface for ``service`` on a daemon thread.
    ``port=0`` binds an ephemeral port (read it from the returned
    handle's ``.port``).  A failure to bind raises (``OSError``)."""

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):                                  # noqa: N802
            path = self.path.split("?", 1)[0]
            try:
                if path == "/metrics":
                    body = render_openmetrics().encode()
                    ctype = OPENMETRICS_CONTENT_TYPE
                elif path == "/healthz":
                    body = json.dumps(_clean(healthz(service)),
                                      indent=1).encode()
                    ctype = "application/json"
                elif path == "/statz":
                    body = json.dumps(_clean(service.statz()),
                                      indent=1, default=str).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404, "unknown endpoint")
                    return
            except Exception as e:                         # pragma: no cover
                self.send_error(500, f"{type(e).__name__}: {e}")
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):                         # keep stdout clean
            pass

    httpd = ThreadingHTTPServer((host, port), Handler)
    httpd.daemon_threads = True
    thread = threading.Thread(target=httpd.serve_forever,
                              name="repro-torch-scrape", daemon=True)
    thread.start()
    return ScrapeServer(httpd, thread)
