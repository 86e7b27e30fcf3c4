"""Service flight recorder: a bounded ring buffer of structured events.

``SolverService`` records one event per noteworthy transition — submit,
admission verdict, activation, per-round progress, flush shape, finish,
failure — into a :class:`FlightRecorder`.  When a job fails the service
dumps the buffer as JSON (``service.dump_flight_recorder()`` /
``recorder_path=``), so the rounds *leading up to* the failure are
preserved without logging every round of every healthy run.

The buffer is a ``deque(maxlen=capacity)``: O(1) append, oldest events
evicted first, eviction counted in ``dropped``.  Events are plain dicts
(``seq``, ``t`` monotonic relative seconds, ``wall`` unix time,
``tenant``, ``kind``, + free-form fields) so the dump is grep-able and
diff-able: ``t`` orders events robustly across clock steps, ``wall``
correlates them with logs and scrapes from other processes, ``tenant``
makes a mixed-tenant ring filterable per job.  Dumps carry a
``provenance`` stamp (git SHA, torch and CUDA versions, the card — see
``repro_torch.obs.provenance``) so a recovered black box is attributable
to the build that wrote it.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from .provenance import provenance as _provenance


class FlightRecorder:
    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._buf: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._t0 = time.perf_counter()

    def record(self, kind: str, *, tenant: Optional[str] = None,
               **fields: Any) -> Dict[str, Any]:
        ev = {"seq": None, "t": round(time.perf_counter() - self._t0, 6),
              "wall": round(time.time(), 6), "tenant": tenant,
              "kind": kind, **fields}
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            self._buf.append(ev)
        return ev

    # ------------------------------------------------------------ reading
    @property
    def recorded(self) -> int:
        """Total events ever recorded (including evicted ones)."""
        with self._lock:
            return self._seq

    @property
    def dropped(self) -> int:
        """Events evicted from the ring to make room."""
        with self._lock:
            return self._seq - len(self._buf)

    def events(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            evs = list(self._buf)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        return evs

    def dump(self) -> Dict[str, Any]:
        with self._lock:
            return {"capacity": self.capacity, "recorded": self._seq,
                    "dropped": self._seq - len(self._buf),
                    "provenance": _provenance(),
                    "events": list(self._buf)}

    def save(self, path) -> Dict[str, Any]:
        obj = self.dump()
        with open(path, "w") as f:
            json.dump(obj, f, indent=1, default=str)
        return obj

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._seq = 0
            self._t0 = time.perf_counter()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"capacity": self.capacity, "recorded": self._seq,
                    "buffered": len(self._buf),
                    "dropped": self._seq - len(self._buf)}
