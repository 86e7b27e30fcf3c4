"""Fault-tolerance runtime, the reference's ``distributed.fault``:
preemption and stragglers.

* ``PreemptionHandler``: SIGTERM (or ``trigger()``) sets a flag; the
  trainer checkpoints at the next step boundary and exits cleanly.
* ``StragglerDetector``: per-worker step-time EWMA against the fleet
  median; sustained outliers are flagged for replacement.
* ``ElasticPlan.shard_assignment``: on a fleet change, the old data
  shards map onto the new ones; the pipeline is randomly addressable, so
  re-sharding moves no data.  ``ElasticPlan.replan_capacity`` re-runs the
  capacity planner (``core/capacity``) for the training that remains.
"""
from __future__ import annotations

import signal
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np


class PreemptionHandler:
    def __init__(self, signals=(signal.SIGTERM,)):
        self._flag = threading.Event()
        self._signals = signals

    def install(self) -> "PreemptionHandler":
        for s in self._signals:
            try:
                signal.signal(s, self._on_signal)
            except ValueError:
                pass                     # not the main thread (tests)
        return self

    def _on_signal(self, signum, frame):
        self._flag.set()

    def preempted(self) -> bool:
        return self._flag.is_set()

    def trigger(self) -> None:          # tests / chaos injection
        self._flag.set()


@dataclass
class StragglerDetector:
    """Flags workers whose EWMA step time exceeds ``threshold`` x the
    fleet median for ``patience`` consecutive checks."""
    n_workers: int
    alpha: float = 0.3
    threshold: float = 1.8
    patience: int = 3
    _ewma: Optional[np.ndarray] = None
    _strikes: Optional[np.ndarray] = None

    def __post_init__(self):
        self._ewma = np.zeros(self.n_workers)
        self._strikes = np.zeros(self.n_workers, dtype=int)

    def observe(self, step_times: np.ndarray) -> List[int]:
        """Feed per-worker step times; the worker ids flagged now."""
        st = np.asarray(step_times, dtype=float)
        if self._ewma.sum() == 0:
            self._ewma[:] = st
        else:
            self._ewma = (1 - self.alpha) * self._ewma + self.alpha * st
        med = np.median(self._ewma)
        slow = self._ewma > self.threshold * med
        self._strikes = np.where(slow, self._strikes + 1, 0)
        return list(np.nonzero(self._strikes >= self.patience)[0])

    def reset(self, worker: int) -> None:
        self._strikes[worker] = 0
        self._ewma[worker] = np.median(self._ewma)


@dataclass
class ElasticPlan:
    """Re-plan on a fleet change: the pipeline re-shards by (n_shards,
    shard_id), and training resumes from the last checkpoint step."""
    old_shards: int
    new_shards: int
    resume_step: int

    def shard_assignment(self) -> Dict[int, int]:
        return {i: i % self.new_shards for i in range(self.old_shards)}

    @staticmethod
    def replan_capacity(arch: str, steps_remaining: int, deadline_h: float,
                        dryrun_path: str = "results/dryrun.json",
                        device=None):
        """The capacity planner's allocation for the remaining steps
        (reserved base + preemptible top-up), from the dry-run record at
        ``dryrun_path``.  ``device`` is the planner's (the CUDA card by
        default)."""
        from repro_torch.core.capacity import (TPUCapacityPlanner,
                                               TrainClass, load_dryrun)
        planner = TPUCapacityPlanner(load_dryrun(dryrun_path), device=device)
        return planner.plan_training([TrainClass(
            name=f"replan-{arch}", arch=arch, steps=steps_remaining,
            deadline_h=deadline_h)])
