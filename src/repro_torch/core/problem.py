"""Problem specification — faithful to D-SPACE4Cloud §2 (Tables 1 & 2).

An instance couples application classes C (each with concurrency H_i, think
time Z_i, deadline D_i, spot bound eta_i) with a VM-type catalog V (cores,
spot price sigma_j, effective reserved price pi_j) and per-(class, vmtype)
job profiles P_ij extracted from execution logs.

A class's per-VM-type profile is a *workload* (``repro_torch.core.workload``):
either the paper's MapReduce ``JobProfile`` below or a Tez/Spark-style
``workload.DagJob`` stage chain — one ``Problem`` may mix both kinds, and
the whole evaluation plane (analytic tier, batched QN tier, service)
dispatches on ``workload.kind``.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.workload import (
    MAPREDUCE,
    workload_from_dict,
    workload_to_dict,
)


@dataclass(frozen=True)
class JobProfile:
    """Compact job behaviour characterization (paper §2, after [41,30]).

    Durations in milliseconds.  The *typical* shuffle is folded into the
    reduce task durations (as in the ARIA profile); the first-wave shuffle
    S1 is kept separate and is exercised by the detailed cluster simulator.
    """
    n_map: int
    n_reduce: int
    m_avg: float
    m_max: float
    r_avg: float
    r_max: float
    s1_avg: float = 0.0
    s1_max: float = 0.0

    @property
    def kind(self) -> str:
        return MAPREDUCE

    def scaled(self, speed: float) -> "JobProfile":
        """Profile on a VM type whose cores run ``speed``x faster."""
        s = 1.0 / speed
        return JobProfile(self.n_map, self.n_reduce,
                          self.m_avg * s, self.m_max * s,
                          self.r_avg * s, self.r_max * s,
                          self.s1_avg * s, self.s1_max * s)

    @property
    def total_work(self) -> float:
        """Total core-milliseconds of one job."""
        return self.n_map * self.m_avg + self.n_reduce * self.r_avg


@dataclass(frozen=True)
class VMType:
    """IaaS catalog entry (paper Table 1: sigma_j, pi_j + capacity)."""
    name: str
    cores: int
    sigma: float                  # spot unit price [currency/h]
    pi: float                     # reserved effective price [currency/h]
    speed: float = 1.0            # relative per-core speed (profiles scale)
    containers_per_core: int = 1  # YARN containers hosted per core

    @property
    def slots(self) -> int:
        return self.cores * self.containers_per_core


@dataclass(frozen=True)
class ApplicationClass:
    """One user class i (paper Table 1).

    ``profiles`` maps VM-type name -> workload: a ``JobProfile`` or a
    ``workload.DagJob`` (the per-class performance model is pluggable; see
    docs/workloads.md).  The ``"_ref"`` entry, when present, is the
    fallback profile scaled by VM speed for catalog entries without a
    dedicated profiling run."""
    name: str
    h_users: int                  # H_i concurrency level
    think_ms: float               # Z_i
    deadline_ms: float            # D_i
    eta: float = 0.3              # max spot fraction
    profiles: Dict[str, object] = field(default_factory=dict)  # by VM name

    def profile_for(self, vm: VMType):
        if vm.name in self.profiles:
            return self.profiles[vm.name]
        # fall back to a reference profile scaled by VM speed
        ref = self.profiles.get("_ref")
        if ref is None:
            raise KeyError(f"no profile for class {self.name} on {vm.name}")
        return ref.scaled(vm.speed)


@dataclass(frozen=True)
class ClassSolution:
    """Decision variables for one class (paper Table 2)."""
    vm_type: str                  # tau_i  (x_ij == 1 for j == tau_i)
    nu: int                       # total VMs
    reserved: int                 # R_i
    spot: int                     # s_i
    cost_per_h: float
    predicted_ms: float           # T_i from the evaluator used
    feasible: bool

    def as_dict(self):
        return asdict(self)


@dataclass
class Problem:
    """One planning instance.  ``deployment`` is the optional private
    deployment target (a ``repro_torch.cloud.hosts.PrivateCloud``):
    ``None`` means the paper's public-cloud scenario — capacity
    unbounded, classes planned independently.  With a deployment
    attached, every optimizer gait packs the chosen fleet onto the
    physical hosts and coordinates classes under a shared core price when
    they over-commit it (``repro_torch.cloud.joint``)."""
    classes: List[ApplicationClass]
    vm_types: List[VMType]
    deployment: Optional[object] = None      # PrivateCloud | None

    def vm_by_name(self, name: str) -> VMType:
        for v in self.vm_types:
            if v.name == name:
                return v
        raise KeyError(name)

    # ---------------------------------------------------------------- JSON
    @staticmethod
    def from_json(text: str) -> "Problem":
        raw = json.loads(text)
        vms = [VMType(**v) for v in raw["vm_types"]]
        classes = []
        for c in raw["classes"]:
            profs = {k: workload_from_dict(p)
                     for k, p in c.pop("profiles").items()}
            classes.append(ApplicationClass(profiles=profs, **c))
        deployment = None
        if raw.get("deployment") is not None:
            # lazy: the cloud package depends on this module
            from repro_torch.cloud.hosts import deployment_from_dict
            deployment = deployment_from_dict(raw["deployment"])
        return Problem(classes=classes, vm_types=vms, deployment=deployment)

    def to_json(self) -> str:
        return json.dumps({
            "classes": [
                {**{k: v for k, v in asdict(c).items() if k != "profiles"},
                 "profiles": {k: workload_to_dict(p)
                              for k, p in c.profiles.items()}}
                for c in self.classes
            ],
            "vm_types": [asdict(v) for v in self.vm_types],
            "deployment": (self.deployment.to_dict()
                           if self.deployment is not None else None),
        }, indent=1)


def solution_cost(sols: Dict[str, ClassSolution]) -> float:
    """Objective (1): sum over classes of sigma*s + pi*R."""
    return sum(s.cost_per_h for s in sols.values())
