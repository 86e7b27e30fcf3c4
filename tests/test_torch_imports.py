"""The port stands alone: importing it pulls in neither JAX nor the JAX
reference package, no file of it (or ``chip_smoke.py``) imports them, and
an entry point asked for no device raises when there is no CUDA card
instead of falling back to the CPU."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_module_leaves_jax_and_repro_out():
    mods = list(_port_modules())
    assert len(mods) > 20
    for m in ("repro_torch.configs.registry", "repro_torch.models.api",
              "repro_torch.kernels.flash_attention.ops",
              "repro_torch.kernels.ssd_scan.ops", "repro_torch.models.mamba2",
              "repro_torch.serve.engine", "repro_torch.launch.serve",
              "repro_torch.core.dag", "repro_torch.kernels.dag_event.ops",
              "repro_torch.kernels.dag_event.ref", "repro_torch.service",
              "repro_torch.service.cache", "repro_torch.service.scheduler",
              "repro_torch.service.jobs", "repro_torch.service.admission",
              "repro_torch.service.engine", "repro_torch.service.http",
              "repro_torch.obs", "repro_torch.obs.metrics",
              "repro_torch.obs.slo", "repro_torch.obs.trace",
              "repro_torch.obs.provenance", "repro_torch.obs.recorder",
              "repro_torch.obs.export", "repro_torch.cloud",
              "repro_torch.cloud.hosts", "repro_torch.cloud.placement",
              "repro_torch.cloud.joint", "repro_torch.cloud.windows",
              "repro_torch.models.moe", "repro_torch.models.encdec",
              "repro_torch.optim", "repro_torch.optim.adamw",
              "repro_torch.data", "repro_torch.data.pipeline",
              "repro_torch.ckpt", "repro_torch.ckpt.checkpointer",
              "repro_torch.distributed.compression",
              "repro_torch.distributed.fault", "repro_torch.train",
              "repro_torch.train.step", "repro_torch.train.trainer",
              "repro_torch.launch.train", "repro_torch.core.capacity",
              "repro_torch.launch.roofline", "repro_torch.launch.plan",
              "repro_torch.launch.qn_record"):
        assert m in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print(bad)\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_importing_torch_scenarios_leaves_jax_and_repro_out():
    """``benchmarks/torch_scenarios.py`` drives the port alone."""
    code = ("import sys\n"
            "import benchmarks.torch_scenarios\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')"
            " or m == 'benchmarks.common')\n"
            "print(bad)\n")
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT}"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True,
                         cwd=str(ROOT))
    assert out.stdout.strip() == "[]", out.stdout


def _imported_names(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py",
                            ROOT / "benchmarks" / "torch_scenarios.py",
                            ROOT / "benchmarks" / "torch_dag_event_ab.py",
                            ROOT / "benchmarks" / "torch_qn_event_ab.py",
                            ROOT / "benchmarks" / "torch_flash_bwd_ab.py",
                            ROOT / "benchmarks" / "torch_flash_bwd_ulps.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax_or_repro(path):
    for name in _imported_names(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


def _tiny_problem():
    from repro_torch.core.problem import (ApplicationClass, JobProfile,
                                          Problem, VMType)
    prof = JobProfile(n_map=4, n_reduce=1, m_avg=100.0, m_max=200.0,
                      r_avg=50.0, r_max=90.0)
    vm = VMType(name="vm", cores=2, sigma=0.1, pi=0.2)
    return Problem(classes=[ApplicationClass(
        name="c", h_users=2, think_ms=1000.0, deadline_ms=5000.0,
        profiles={"vm": prof})], vm_types=[vm])


def test_entry_points_without_a_device_raise_on_a_cpu_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device exists")
    from repro_torch import resolve_device
    from repro_torch.core import evaluators, qn_sim
    from repro_torch.core.optimizer import DSpace4Cloud
    prob = _tiny_problem()
    cls, vm = prob.classes[0], prob.vm_types[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        DSpace4Cloud(prob)
    with pytest.raises(RuntimeError, match="CUDA"):
        DSpace4Cloud(prob, batched=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluators.make_qn_evaluator()
    with pytest.raises(RuntimeError, match="CUDA"):
        qn_sim.response_time(4, 1, 100.0, 50.0, 1000.0, 2, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        qn_sim.response_time_batch(4, 1, 100.0, 50.0, 1000.0, 2, [2])
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluators.amva_frontier(cls, vm, 1, 4)
    from repro_torch.core import dag
    chain = dag.DagJob("d", (dag.Stage(4, 100.0), dag.Stage(2, 50.0)))
    with pytest.raises(RuntimeError, match="CUDA"):
        dag.dag_response_time(chain, 2, 1000.0, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        dag.response_time_batch([chain], 1000.0, [2], 2)
    from repro_torch.service import FusionScheduler, SolverService
    with pytest.raises(RuntimeError, match="CUDA"):
        SolverService()
    with pytest.raises(RuntimeError, match="CUDA"):
        FusionScheduler()
    from repro_torch.cloud import PrivateCloud, feasibility_batch, \
        homogeneous_hosts, pack, plan_day
    cloud = PrivateCloud(hosts=homogeneous_hosts(2, 4))
    with pytest.raises(RuntimeError, match="CUDA"):
        DSpace4Cloud(prob, deployment=cloud)
    with pytest.raises(RuntimeError, match="CUDA"):
        plan_day(prob, {"c": [1, 2]})
    with pytest.raises(RuntimeError, match="CUDA"):
        pack(prob, {}, cloud)
    with pytest.raises(RuntimeError, match="CUDA"):
        feasibility_batch(np.zeros((1, 1), np.int64), np.ones((1, 1)),
                          np.ones((1, 1)), np.ones(1), np.ones(1))
    assert resolve_device("cpu") == torch.device("cpu")
    t = DSpace4Cloud(prob, device="cpu", min_jobs=4).run_fast()
    assert np.isfinite(t.solutions["c"].predicted_ms)
    t = DSpace4Cloud(prob, device="cpu", min_jobs=4, batched=False).run()
    assert np.isfinite(t.solutions["c"].predicted_ms)


def test_serve_launcher_without_a_device_raises_on_a_cpu_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device exists")
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--requests", "1"])
    summary = serve.main(["--device", "cpu", "--requests", "3",
                          "--prompt", "5", "--gen", "2", "--batch", "2"])
    assert summary["n"] == 3 and summary["tokens_per_s"] > 0


def test_chip_smoke_alone_or_without_a_card_fails(tmp_path):
    """``chip_smoke.py`` exits nonzero and prints no result without a card
    and in a directory holding nothing else of the repository."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    scripts = [alone]
    if not torch.cuda.is_available():
        scripts.append(ROOT / "chip_smoke.py")
    procs = [subprocess.Popen([sys.executable, str(script)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.DEVNULL, text=True,
                              cwd=str(script.parent)) for script in scripts]
    for proc in procs:                  # both run at once
        stdout, _ = proc.communicate(timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in stdout
