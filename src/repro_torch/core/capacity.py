"""TPU capacity planner, the reference's ``core/capacity``: D-SPACE4Cloud's
technique applied to TPU slices for the LM stack's serving and training.

The mapping builds a paper ``Problem`` and runs the unchanged optimizer
stack (KKT initial solution -> QN-verified hill climbing -> reserved/spot
mix):

  VM type j          ->  TPU slice type (v5e-16/64/256, v5p-128) with
                         reserved and preemptible hourly prices
  containers/VM      ->  concurrent sequence slots a slice holds (KV-memory
                         bound, from the arch config)
  job profile P_ij   ->  prefill/decode service times from a dry-run
                         record's roofline terms (HLO FLOPs, bytes,
                         collective bytes), scaled to the slice
  Map task           ->  prefill (one a request)
  Reduce task        ->  the decode phase (gen_len steps)
  deadline D_i       ->  the per-request latency SLO
  spot bound eta_i   ->  the largest preemptible share of the capacity

Training classes take the KKT deadline-binding allocation on the makespan
(steps x step_time <= deadline); a training job owns its slices, so no
queueing network is needed.

The slice catalog's prices and chip figures are the planner's input data,
carried unchanged from the reference so that its decisions equal the
reference's.  ``TPUCapacityPlanner`` verifies serving plans with the
point-wise QN evaluator on its ``device``: one scalar ``qn_event``
dispatch a probe; everything else is host arithmetic in float64.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch import resolve_device
from repro_torch.core.evaluators import make_qn_evaluator
from repro_torch.core.hillclimb import hill_climb
from repro_torch.core.milp import initial_solution
from repro_torch.core.pricing import optimal_mix
from repro_torch.core.problem import (
    ApplicationClass,
    ClassSolution,
    JobProfile,
    Problem,
    VMType,
)

# TPU v5e figures (as launch/roofline.py's)
V5E_PEAK_TFLOPS = 197.0
V5E_HBM_GBPS = 819.0
V5E_HBM_GB = 16.0
V5E_ICI_GBPS = 50.0


@dataclass(frozen=True)
class SliceType:
    name: str
    chips: int
    peak_tflops: float = V5E_PEAK_TFLOPS
    hbm_gbps: float = V5E_HBM_GBPS
    hbm_gb: float = V5E_HBM_GB
    ici_gbps: float = V5E_ICI_GBPS
    price_reserved: float = 1.20     # $/chip/h
    price_preemptible: float = 0.54
    step_overhead_ms: float = 0.3    # dispatch/launch floor a step

    @property
    def hourly_reserved(self) -> float:
        return self.price_reserved * self.chips

    @property
    def hourly_preemptible(self) -> float:
        return self.price_preemptible * self.chips


# the catalog: the paper's m4-vs-CINECA granularity/price axis
V5E_16 = SliceType("v5e-16", 16)
V5E_64 = SliceType("v5e-64", 64)
V5E_256 = SliceType("v5e-256", 256)
V5P_128 = SliceType("v5p-128", 128, peak_tflops=459.0, hbm_gbps=2765.0,
                    hbm_gb=95.0, ici_gbps=90.0, price_reserved=4.20,
                    price_preemptible=1.89)
SLICE_CATALOG = [V5E_16, V5E_64, V5E_256, V5P_128]


@dataclass(frozen=True)
class ServingClass:
    """One serving workload: requests over an (arch x decode-shape) cell."""
    name: str
    arch: str
    prompt_len: int = 4096
    gen_len: int = 256
    h_sessions: int = 32             # concurrent interactive sessions
    think_ms: float = 5_000.0
    deadline_ms: float = 30_000.0    # per-request latency SLO
    eta: float = 0.3


@dataclass(frozen=True)
class TrainClass:
    """One training workload: ``steps`` optimizer steps of an arch."""
    name: str
    arch: str
    steps: int = 50_000
    deadline_h: float = 24.0 * 14
    eta: float = 0.5                 # checkpoint/restart tolerates preemption


# --------------------------------------------------------------------------
# Dry-run profile extraction
# --------------------------------------------------------------------------

@dataclass
class CellCost:
    flops_per_dev: float             # one step, a device, on the ref mesh
    bytes_per_dev: float
    coll_bytes_per_dev: float
    ref_chips: int = 256


def load_dryrun(path: str = "results/dryrun.json"
                ) -> Dict[Tuple[str, str], CellCost]:
    """The ``16x16`` mesh's supported cells of a dry-run record."""
    with open(path) as f:
        recs = json.load(f)
    out = {}
    for r in recs:
        if "error" in r or not r.get("supported"):
            continue
        if r["mesh"] != "16x16":
            continue
        ca = r.get("cost_analysis", {})
        # the trip-count-aware parse first, and the analytic memory model
        # (the kernels' on-chip temporaries excluded)
        flops = float(r.get("parsed_flops_per_dev") or ca.get("flops", 0.0))
        try:
            from repro_torch.configs.registry import get_config, get_shape
            from repro_torch.launch.roofline import analytic_memory_bytes
            mem = analytic_memory_bytes(get_config(r["arch"]),
                                        get_shape(r["shape"]),
                                        r.get("n_devices", 256))
        except Exception:
            mem = float(ca.get("bytes_accessed", 0.0))
        out[(r["arch"], r["shape"])] = CellCost(
            flops_per_dev=flops,
            bytes_per_dev=mem,
            coll_bytes_per_dev=float(sum(r["collective_bytes"].values())),
            ref_chips=r.get("n_devices", 256),
        )
    return out


def step_time_ms(cost: CellCost, slc: SliceType) -> float:
    """Roofline step time on one slice: the reference mesh's global work
    spread over ``slc.chips`` chips; the three terms scale with 1/chips
    (a fixed problem size), plus a constant dispatch floor."""
    scale = cost.ref_chips / slc.chips
    t_comp = cost.flops_per_dev * scale / (slc.peak_tflops * 1e12)
    t_mem = cost.bytes_per_dev * scale / (slc.hbm_gbps * 1e9)
    t_coll = cost.coll_bytes_per_dev * scale / (slc.ici_gbps * 1e9)
    return max(t_comp, t_mem, t_coll) * 1e3 + slc.step_overhead_ms


# --------------------------------------------------------------------------
# Serving: slots + profiles
# --------------------------------------------------------------------------

def kv_bytes_per_token(arch: str) -> float:
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    if cfg.family == "ssm":
        return 0.0                   # the state is O(1) in sequence length
    kinds = cfg.layer_kinds()
    n_global = sum(1 for k in kinds if k in ("global", "attn")) * cfg.n_groups
    # local layers keep ring buffers: ~0 a further token
    return n_global * 2 * cfg.kv_dim * 2.0   # k+v, bf16


def slice_slots(cls: ServingClass, slc: SliceType) -> int:
    """Concurrent sequences one slice holds (KV memory bound)."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(cls.arch)
    param_bytes = 2.0 * _param_count(cfg)          # bf16 serving weights
    free = slc.hbm_gb * 1e9 * slc.chips * 0.9 - param_bytes
    if free <= 0:
        return 0
    per_seq = kv_bytes_per_token(cls.arch) * (cls.prompt_len + cls.gen_len)
    if per_seq <= 0:                                # SSM: state-bound
        per_seq = 4e6                               # conv+ssm state budget
    return max(0, int(free / per_seq))


def _param_count(cfg) -> float:
    from repro_torch.distributed.sharding import param_count
    from repro_torch.models import api
    return float(param_count(api.param_specs(cfg)))


def serving_profile(cls: ServingClass, slc: SliceType,
                    costs: Dict[Tuple[str, str], CellCost]
                    ) -> Optional[JobProfile]:
    """One request as a (1 map = prefill, 1 reduce = decode) profile.

    Service time = the wall time a request holds ONE sequence slot:
      * prefill: the per-token cost of the prefill_32k cell (batch 32) at
        the request's prompt length;
      * decode: gen_len x the per-sequence token cost of the decode_32k
        cell at its batch-128 operating point (the weights' read shared
        across the batch).
    """
    pf = costs.get((cls.arch, "prefill_32k"))
    dc = costs.get((cls.arch, "decode_32k"))
    if dc is None:
        return None
    if pf is not None:
        per_tok_pf = step_time_ms(pf, slc) / (32 * 32768)
        t_prefill = per_tok_pf * cls.prompt_len
    else:
        t_prefill = step_time_ms(dc, slc) / 128 * 4.0  # state-build approx
    per_seq_tok = step_time_ms(dc, slc) / 128
    t_decode = per_seq_tok * cls.gen_len
    # the same op every step: a low service CV, max ~1.3-1.5x avg
    return JobProfile(n_map=1, n_reduce=1,
                      m_avg=t_prefill, m_max=1.5 * t_prefill,
                      r_avg=t_decode, r_max=1.3 * t_decode)


# --------------------------------------------------------------------------
# Planner
# --------------------------------------------------------------------------

class TPUCapacityPlanner:
    """D-SPACE4Cloud over TPU slices.  ``plan_serving`` builds a paper
    Problem and runs the same optimizer; its QN probes run on ``device``
    (the current CUDA card by default; it raises without one unless given
    ``device="cpu"``).  ``plan_training`` applies the KKT deadline-binding
    allocation with preemptible-mix pricing."""

    def __init__(self, costs: Dict[Tuple[str, str], CellCost],
                 catalog: Optional[List[SliceType]] = None, device=None):
        self.costs = costs
        self.catalog = catalog or SLICE_CATALOG
        self.device = resolve_device(device)

    # -------------------------------------------------------------- serving
    def serving_problem(self, c: ServingClass) -> Problem:
        """A one-class Problem (classes decouple in P1, so each serving
        class gets its own, with its own slot capacities)."""
        vms, profiles = [], {}
        for slc in self.catalog:
            prof = serving_profile(c, slc, self.costs)
            slots = slice_slots(c, slc)
            if prof is None or slots <= 0:
                continue
            # "cores" = sequence slots (the FCR capacity unit); prices are
            # per whole slice, so the billing stays right
            vms.append(VMType(
                name=slc.name, cores=slots,
                sigma=slc.hourly_preemptible, pi=slc.hourly_reserved,
                speed=1.0, containers_per_core=1))
            profiles[slc.name] = prof
        if not vms:
            raise ValueError(f"{c.name}: no slice type can host it")
        app = ApplicationClass(
            name=c.name, h_users=c.h_sessions, think_ms=c.think_ms,
            deadline_ms=c.deadline_ms, eta=c.eta, profiles=profiles)
        return Problem(classes=[app], vm_types=vms)

    def plan_serving(self, classes: List[ServingClass],
                     use_qn: bool = True) -> Dict[str, ClassSolution]:
        out: Dict[str, ClassSolution] = {}
        for c in classes:
            prob = self.serving_problem(c)
            init = initial_solution(prob)
            if not use_qn:
                out.update(init)
                continue
            ev = make_qn_evaluator(min_jobs=25, replications=1, seed=0,
                                   device=self.device)
            sols, _ = hill_climb(prob, init, ev)
            out.update(sols)
        return out

    # ------------------------------------------------------------- training
    def plan_training(self, classes: List[TrainClass]
                      ) -> Dict[str, ClassSolution]:
        out = {}
        for c in classes:
            cost = self.costs.get((c.arch, "train_4k"))
            if cost is None:
                raise KeyError(f"no train_4k dry-run record for {c.arch}")
            best: Optional[ClassSolution] = None
            for slc in self.catalog:
                # KKT: the makespan binds -> the smallest n whose n-slice
                # step time meets the deadline.  Data parallel across
                # slices: the step time is a slice's; n slices divide the
                # steps.
                vm = VMType(name=slc.name, cores=slc.chips,
                            sigma=slc.hourly_preemptible,
                            pi=slc.hourly_reserved)
                t_step_ms = step_time_ms(cost, slc)
                total_h = c.steps * t_step_ms / 3.6e6
                n = max(1, math.ceil(total_h / c.deadline_h))
                # preemptible slices lose ~8% of their duty to restarts
                r, s, _ = optimal_mix(n, c.eta, vm)
                eff = r + 0.92 * s
                while eff * c.deadline_h < total_h:
                    n += 1
                    r, s, _ = optimal_mix(n, c.eta, vm)
                    eff = r + 0.92 * s
                cost_h = slc.hourly_reserved * r + slc.hourly_preemptible * s
                sol = ClassSolution(vm_type=slc.name, nu=n, reserved=r,
                                    spot=s, cost_per_h=cost_h,
                                    predicted_ms=total_h / max(eff, 1e-9)
                                    * 3.6e6,
                                    feasible=eff * c.deadline_h >= total_h)
                if sol.feasible and (best is None or
                                     sol.cost_per_h < best.cost_per_h):
                    best = sol
            if best is None:
                raise ValueError(f"{c.name}: infeasible within deadline")
            out[c.name] = best
        return out
