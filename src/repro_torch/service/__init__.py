"""Multi-tenant capacity-planning service (D-SPACE4Cloud as a *tool*) on
the port.

Many tenants' ``Problem`` instances solved concurrently with cross-job
fused QN scheduling on one device, a shared persistent evaluation cache
(whose JSON spill the reference's service reads and writes alike), and
admission control.
"""
from repro_torch.service.admission import AdmissionController, \
    estimate_job_cores, estimate_job_events
from repro_torch.service.cache import EvalCache, profile_hash
from repro_torch.service.engine import SolverService
from repro_torch.service.http import ScrapeServer, healthz, serve
from repro_torch.service.jobs import Job, JobState, parse_submission
from repro_torch.service.scheduler import FusionScheduler, SimSpec, WindowRequest

__all__ = [
    "AdmissionController", "estimate_job_cores", "estimate_job_events",
    "EvalCache", "profile_hash", "SolverService", "Job", "JobState",
    "parse_submission", "FusionScheduler", "SimSpec", "WindowRequest",
    "ScrapeServer", "healthz", "serve",
]
