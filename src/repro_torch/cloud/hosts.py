"""Physical host catalog + the ``PrivateCloud`` deployment spec.

D-SPACE4Cloud targets *both* public and private clouds (paper §2): in the
private scenario the VMs chosen for every application class must be
placed onto a finite physical cluster the organisation owns, so classes
*contend* for cores and memory instead of renting an unbounded pool.
This module describes that cluster:

  * ``Host`` — one physical machine: cores, memory, and the energy cost
    of keeping it powered for an hour (owned hardware is paid in watts,
    not in σ/π rental prices — see ``pricing.host_energy_cost``);
  * ``homogeneous_hosts`` — the common case: racks of identical nodes;
  * ``PrivateCloud`` — the deployment spec the optimizer plans against:
    the host list plus the per-VM-type memory footprint used by the
    bin-packing placement (``cloud.placement``).

A ``PrivateCloud`` attaches to a ``Problem`` (its ``deployment`` field)
or is passed straight to ``DSpace4Cloud(..., deployment=...)`` / the
solver service as a solver option.  ``deployment=None`` everywhere means
the paper's public-cloud scenario — capacity unbounded, behaviour
bit-identical to the pre-private-cloud tool (regression-tested).

Capacity conventions: one VM vCPU occupies one physical core (no
over-subscription — the paper's containers-per-core mapping happens
*inside* the VM, between vCPUs and YARN containers).  A VM type without
an explicit memory footprint defaults to ``DEFAULT_GB_PER_CORE`` GB per
vCPU, and a host constructed without memory defaults to the same ratio —
so memory never binds unless the modeller says otherwise.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.problem import VMType

DEFAULT_GB_PER_CORE = 4.0


@dataclass(frozen=True)
class Host:
    """One physical machine of the private cluster."""
    name: str
    cores: int
    memory_gb: float = 0.0        # 0 -> DEFAULT_GB_PER_CORE * cores
    energy_cost_per_h: float = 0.0  # cost of keeping the host powered [/h]
    rack: str = "r0"

    def __post_init__(self):
        if self.memory_gb <= 0.0:
            object.__setattr__(self, "memory_gb",
                               DEFAULT_GB_PER_CORE * self.cores)


def homogeneous_hosts(count: int, cores: int, *, memory_gb: float = 0.0,
                      energy_cost_per_h: float = 0.0, hosts_per_rack: int = 16,
                      prefix: str = "node") -> List[Host]:
    """``count`` identical nodes, named ``node-000``..., racked in groups
    of ``hosts_per_rack`` (rack identity is carried for placement spread
    policies and reporting; the packer itself is rack-agnostic)."""
    return [Host(name=f"{prefix}-{i:03d}", cores=cores, memory_gb=memory_gb,
                 energy_cost_per_h=energy_cost_per_h,
                 rack=f"rack{i // hosts_per_rack}")
            for i in range(count)]


@dataclass
class PrivateCloud:
    """The private deployment target: what the joint allocator packs into.

    ``vm_memory_gb`` maps VM-type name -> memory footprint of one VM of
    that type (defaults to ``DEFAULT_GB_PER_CORE`` per vCPU).
    """
    hosts: List[Host]
    vm_memory_gb: Dict[str, float] = field(default_factory=dict)
    name: str = "private"

    @property
    def total_cores(self) -> int:
        return sum(h.cores for h in self.hosts)

    @property
    def total_memory_gb(self) -> float:
        return sum(h.memory_gb for h in self.hosts)

    def vm_mem(self, vm: VMType) -> float:
        """Memory footprint of one VM of ``vm``'s type [GB]."""
        return self.vm_memory_gb.get(vm.name,
                                     DEFAULT_GB_PER_CORE * vm.cores)

    # ---------------------------------------------------------------- JSON
    def to_dict(self) -> dict:
        return {"name": self.name,
                "hosts": [asdict(h) for h in self.hosts],
                "vm_memory_gb": dict(self.vm_memory_gb)}

    @staticmethod
    def from_dict(d: dict) -> "PrivateCloud":
        return PrivateCloud(
            hosts=[Host(**h) for h in d["hosts"]],
            vm_memory_gb={k: float(v)
                          for k, v in (d.get("vm_memory_gb") or {}).items()},
            name=d.get("name", "private"))


def deployment_from_dict(d: Optional[dict]) -> Optional[PrivateCloud]:
    """Decode an optional deployment section (``None`` -> public cloud)."""
    return None if d is None else PrivateCloud.from_dict(d)
