"""VM -> host placement: bin packing with a batched feasibility plane.

The private-cloud decision is not only *how many* VMs each class gets
(the allocation the optimizer races) but *whether the chosen fleet
physically fits* the host catalog — a 2-dimensional (cores, memory) bin
packing.  Two layers:

  * greedy packers (numpy): first-fit-decreasing and friends generate
    candidate assignments host-by-host in microseconds;
  * ``feasibility_batch`` (torch, on the plan's device): ONE batched
    check validates *many* candidate packings at once — per-host
    core/memory sums scattered into a ``(B, H)`` float32 tensor with
    ``scatter_add_`` (no matmul: TF32 could round the operands), padded
    across candidates exactly like the QN simulator pads candidate lanes
    (``qn_sim.response_time_batch``'s padded-batch idiom: static shapes,
    masked no-ops for the padding), and one read-back of the ``(B,)``
    mask.

``pack`` ties them together: it generates several greedy candidates
(different host orders / fit rules), validates them all in one batched
call, and returns the feasible packing with the lowest energy cost —
powered hosts are the private cloud's cost driver, so consolidating onto
few cheap hosts is the placement objective.  ``feasibility_batch`` is
also what the 24-hour planner uses to validate a whole day of window
fleets in one call (``cloud.windows``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.cloud.hosts import PrivateCloud
from repro_torch.core.problem import ClassSolution, Problem

_EPS = 1e-6


@dataclass
class Placement:
    """One packing of a VM fleet onto the host catalog.

    ``assignment[v]`` is the host index VM ``v`` landed on (-1 =
    unplaceable).  ``feasible`` means every VM is placed within every
    host's core and memory capacity."""
    assignment: np.ndarray
    feasible: bool
    hosts_used: int
    energy_cost_per_h: float
    cores_used: int
    cores_total: int
    unplaced: int = 0
    strategy: str = ""
    vm_labels: List[str] = field(default_factory=list)

    def summary(self) -> dict:
        return {"feasible": self.feasible, "hosts_used": self.hosts_used,
                "energy_cost_per_h": self.energy_cost_per_h,
                "cores_used": self.cores_used,
                "cores_total": self.cores_total,
                "unplaced": self.unplaced, "strategy": self.strategy}


def fleet_of(problem: Problem, sols: Dict[str, ClassSolution],
             cloud: PrivateCloud
             ) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Expand per-class (vm type, nu) decisions into the per-VM fleet the
    packer places: aligned (cores, memory, label) arrays, one entry per
    individual VM."""
    cores: List[float] = []
    mem: List[float] = []
    labels: List[str] = []
    for name, sol in sols.items():
        vm = problem.vm_by_name(sol.vm_type)
        for _ in range(int(sol.nu)):
            cores.append(float(vm.cores))
            mem.append(cloud.vm_mem(vm))
            labels.append(f"{name}@{vm.name}")
    return (np.asarray(cores, np.float32), np.asarray(mem, np.float32),
            labels)


def demand_cores(problem: Problem, sols: Dict[str, ClassSolution]) -> int:
    """Total physical cores the allocation asks for (the over-commit
    signal the joint coordinator prices)."""
    return sum(int(sol.nu) * problem.vm_by_name(sol.vm_type).cores
               for sol in sols.values())


# --------------------------------------------------------------- greedy end

def _greedy_pack(cores: np.ndarray, mem: np.ndarray,
                 host_cores: np.ndarray, host_mem: np.ndarray,
                 vm_order: np.ndarray, host_order: np.ndarray,
                 best_fit: bool = False) -> np.ndarray:
    """One greedy packing: place VMs in ``vm_order``, scanning hosts in
    ``host_order`` (first fit) or choosing the tightest remaining host
    (best fit).  Returns the assignment array (-1 = unplaceable)."""
    free_c = host_cores.astype(np.float64).copy()
    free_m = host_mem.astype(np.float64).copy()
    out = np.full(len(cores), -1, np.int64)
    for v in vm_order:
        c, m = cores[v], mem[v]
        fit = None
        if best_fit:
            slack = np.inf
            for h in host_order:
                if free_c[h] + _EPS >= c and free_m[h] + _EPS >= m:
                    s = free_c[h] - c
                    if s < slack:
                        slack, fit = s, h
        else:
            for h in host_order:
                if free_c[h] + _EPS >= c and free_m[h] + _EPS >= m:
                    fit = h
                    break
        if fit is None:
            continue
        out[v] = fit
        free_c[fit] -= c
        free_m[fit] -= m
    return out


def pack_ffd(cores: np.ndarray, mem: np.ndarray,
             cloud: PrivateCloud) -> np.ndarray:
    """Plain first-fit-decreasing (by cores, memory tie-break) over hosts
    in catalog order — the baseline strategy ``pack`` always includes."""
    host_cores = np.asarray([h.cores for h in cloud.hosts], np.float32)
    host_mem = np.asarray([h.memory_gb for h in cloud.hosts], np.float32)
    vm_order = np.lexsort((-mem, -cores))
    return _greedy_pack(cores, mem, host_cores, host_mem, vm_order,
                        np.arange(len(cloud.hosts)))


# ------------------------------------------------------------ batched plane

def feasibility_batch(assignments: np.ndarray, vm_cores: np.ndarray,
                      vm_mem: np.ndarray, host_cores: np.ndarray,
                      host_mem: np.ndarray, *, device=None) -> np.ndarray:
    """Validate MANY candidate packings in ONE batched check on ``device``.

    ``assignments`` is ``(B, V)`` int (host index per VM; -1 marks a pad
    slot or an unplaced VM), ``vm_cores``/``vm_mem`` are ``(B, V)`` floats
    with 0 on pad slots, ``host_cores``/``host_mem`` are ``(H,)``.  A
    candidate is feasible iff every real VM (``vm_cores > 0``) is placed
    and no host's core or memory capacity is exceeded.  Shapes are static
    across the batch (candidates with smaller fleets pad with zeros), so
    the whole check is one program — the same padded-batch contract as
    ``qn_sim.response_time_batch``.  The per-host sums are float32, each
    VM added into its host's column (a pad slot, an unplaced VM or a host
    index past ``H`` into a spare column that is never read).  ``device``
    is where the check runs (the CUDA card by default).  Returns a
    ``(B,)`` bool array: one read-back.
    """
    dev = resolve_device(device)
    a, vc, vmem, hc, hm = (
        torch.tensor(np.asarray(x, t), device=dev)
        for x, t in ((assignments, np.int64), (vm_cores, np.float32),
                     (vm_mem, np.float32), (host_cores, np.float32),
                     (host_mem, np.float32)))
    n_hosts = hc.shape[0]

    placed = a >= 0
    real = vc > 0.0
    # masked one-hot as an index: pad/unplaced rows land in column H
    on_host = placed & (a < n_hosts)
    col = torch.where(on_host, a, torch.full_like(a, n_hosts))
    sums = torch.zeros((2, a.shape[0], n_hosts + 1), dtype=torch.float32,
                       device=dev)
    sums[0].scatter_add_(1, col, torch.where(on_host, vc, 0.0))
    sums[1].scatter_add_(1, col, torch.where(on_host, vmem, 0.0))
    per_host_c, per_host_m = sums[0, :, :n_hosts], sums[1, :, :n_hosts]
    ok = (per_host_c <= hc[None, :] + _EPS).all(dim=-1)
    ok &= (per_host_m <= hm[None, :] + _EPS).all(dim=-1)
    ok &= (placed | ~real).all(dim=-1)
    return ok.cpu().numpy()


def pad_batch(fleets: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]]
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad variable-size fleets to one static (B, Vmax) batch: assignment
    -1, cores/mem 0 on pad slots (the idle lanes of the fused check)."""
    vmax = max((len(c) for _, c, _ in fleets), default=0)
    vmax = max(vmax, 1)
    b = len(fleets)
    a = np.full((b, vmax), -1, np.int64)
    vc = np.zeros((b, vmax), np.float32)
    vmem = np.zeros((b, vmax), np.float32)
    for i, (asg, c, m) in enumerate(fleets):
        a[i, :len(c)] = asg
        vc[i, :len(c)] = c
        vmem[i, :len(c)] = m
    return a, vc, vmem


# ------------------------------------------------------------- the packer

def pack(problem: Problem, sols: Dict[str, ClassSolution],
         cloud: PrivateCloud, *, device=None) -> Placement:
    """Place the allocation's fleet onto the host catalog.

    Generates several greedy candidates — FFD over hosts in energy order
    (consolidate onto cheap nodes), FFD over largest hosts first,
    best-fit-decreasing, and a memory-major FFD — validates ALL of them
    in one ``feasibility_batch`` call, and returns the feasible candidate
    with the lowest powered-host energy cost.  When none is feasible the
    best-effort candidate (fewest unplaced VMs) is returned with
    ``feasible=False`` — the joint coordinator treats that as the
    over-commit signal.  ``device`` is where the check runs.
    """
    device = resolve_device(device)
    cores, mem, labels = fleet_of(problem, sols, cloud)
    host_cores = np.asarray([h.cores for h in cloud.hosts], np.float32)
    host_mem = np.asarray([h.memory_gb for h in cloud.hosts], np.float32)
    energy = np.asarray([h.energy_cost_per_h for h in cloud.hosts],
                        np.float64)
    if len(cores) == 0:
        return Placement(assignment=np.zeros(0, np.int64), feasible=True,
                         hosts_used=0, energy_cost_per_h=0.0, cores_used=0,
                         cores_total=cloud.total_cores, strategy="empty")

    n_hosts = len(cloud.hosts)
    ffd = np.lexsort((-mem, -cores))            # cores-major decreasing
    mfd = np.lexsort((-cores, -mem))            # memory-major decreasing
    orders = [
        ("ffd-energy", ffd, np.lexsort((host_cores * -1, energy)), False),
        ("ffd-big-host", ffd, np.argsort(-host_cores, kind="stable"), False),
        ("bfd-energy", ffd, np.lexsort((host_cores * -1, energy)), True),
        ("ffd-mem-major", mfd, np.lexsort((host_cores * -1, energy)), False),
        ("ffd-catalog", ffd, np.arange(n_hosts), False),
    ]
    cands = [_greedy_pack(cores, mem, host_cores, host_mem, vo, ho, bf)
             for _, vo, ho, bf in orders]

    feas = feasibility_batch(np.stack(cands),
                             np.broadcast_to(cores, (len(cands), len(cores))),
                             np.broadcast_to(mem, (len(cands), len(mem))),
                             host_cores, host_mem, device=device)

    def _energy(asg: np.ndarray) -> float:
        used = np.unique(asg[asg >= 0])
        return float(energy[used].sum())

    best_i, best_cost = None, np.inf
    for i, ok in enumerate(feas):
        if ok and _energy(cands[i]) < best_cost:
            best_i, best_cost = i, _energy(cands[i])
    if best_i is None:                          # over-committed: best effort
        best_i = int(np.argmin([int((c < 0).sum()) for c in cands]))
        best_cost = _energy(cands[best_i])
    asg = cands[best_i]
    used = np.unique(asg[asg >= 0])
    return Placement(
        assignment=asg, feasible=bool(feas[best_i]),
        hosts_used=len(used), energy_cost_per_h=best_cost,
        cores_used=int(cores[asg >= 0].sum()),
        cores_total=cloud.total_cores,
        unplaced=int((asg < 0).sum()), strategy=orders[best_i][0],
        vm_labels=labels)
