"""The private-cloud deployment plane (paper §2-§3, private scenario).

Public-cloud planning (the rest of the repo) rents capacity: classes are
optimized independently against an unbounded pool.  This package makes
the paper's OTHER deployment target first-class: a finite physical
cluster the organisation owns, where classes contend for cores/memory
and the chosen fleet must actually bin-pack onto hosts.

  * ``hosts``      — the host/rack catalog + the ``PrivateCloud`` spec;
  * ``placement``  — FFD-style packers (numpy, on the host) + the
                     batched feasibility check over many candidate
                     packings at once (torch, on the plan's device);
  * ``joint``      — the capacity-coupled coordinator: a shared dual
                     price on cores re-races classes (through the fused
                     QN plane) until the packed plan is feasible;
  * ``windows``    — 24-hour concurrency-profile planning with day-long
                     reserved contracts.

See ``docs/private_cloud.md`` (the reference's; the port keeps its
names and semantics, and takes a ``device`` wherever a check runs).
"""
from repro_torch.cloud.hosts import (                            # noqa: F401
    Host,
    PrivateCloud,
    deployment_from_dict,
    homogeneous_hosts,
)
from repro_torch.cloud.joint import (                            # noqa: F401
    JointPlan,
    coordinate,
    coordinate_requests,
    truncate_to_fit,
)
from repro_torch.cloud.placement import (                        # noqa: F401
    Placement,
    feasibility_batch,
    fleet_of,
    pack,
    pack_ffd,
)


def __getattr__(name):
    # ``windows`` drives the optimizer facade, which itself imports this
    # package (for the coordinator) — a lazy re-export breaks the cycle
    if name in ("DayPlan", "DayContract", "plan_day"):
        from repro_torch.cloud import windows
        return getattr(windows, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
