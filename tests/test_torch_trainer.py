"""The port's train step and trainer on the CPU: five steps of
``make_train_step`` against the reference's (jit-compiled, its Pallas
flash forward in interpret mode) from the same carried-across state and
the same batches (the pipelines are bit-identical), plain, with two
microbatches, with the 8-bit optimizer and with EF-int8 gradient
compression, in float32 and bfloat16 activations; then the trainer's own
behaviour, the reference's ``tests/test_fault_tolerance.py`` on the port
(restart-resume parity, preemption, stragglers, elastic shard maps), and
the training launcher.

Tolerances, with their measured values:
  * float32: losses 1e-5 absolute (measured 9.5e-7); parameters after five
    steps 2e-5 absolute (measured 2.5e-6), 5e-4 with the 8-bit optimizer
    or EF-int8 compression (measured 6.0e-5 and 1.2e-4: a gradient an ulp
    apart can round to the neighbouring int8 code, a step of 1/127 of its
    row's largest magnitude).
  * bfloat16: losses 5e-3 (measured 1.2e-3), parameters 1e-2 (measured
    3.8e-3): the per-step gradient differences of
    tests/test_torch_train_grads.py, through five Adam steps.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticPipeline as JPipeline
from repro.distributed import compression as jcomp
from repro.distributed.sharding import init_params as ref_init_params
from repro.models import api as japi
from repro.optim import adamw as jopt
from repro.train import step as jstep
from repro_torch.configs import registry as treg
from repro_torch.core.interop import train_state_from_reference
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed.fault import ElasticPlan, StragglerDetector
from repro_torch.optim import adamw as topt
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import step as tstep
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

LOSS_TOL = {"float32": 1e-5, "bfloat16": 5e-3}
PARAM_TOL = {("float32", False): 2e-5, ("float32", True): 5e-4,
             ("bfloat16", False): 1e-2, ("bfloat16", True): 1e-2}


@pytest.mark.parametrize("variant", ["plain", "microbatches=2", "8bit",
                                     "compress_grads"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_five_train_steps_follow_the_reference(variant, dtype):
    cj = jreg.get_smoke_config("granite-3-2b").replace(dtype=dtype)
    ct = treg.get_smoke_config("granite-3-2b").replace(dtype=dtype)
    kw = dict(lr=1e-3, warmup=2, total_steps=10,
              mode="8bit" if variant == "8bit" else "fp32")
    mb = 2 if variant == "microbatches=2" else 1
    ef = variant == "compress_grads"
    pj = ref_init_params(japi.param_specs(cj), jax.random.key(0))
    sj = jstep.init_train_state(cj, jopt.AdamWConfig(**kw), pj)
    if ef:
        sj["ef_err"] = jcomp.init_error_state(pj)
    st = train_state_from_reference(jax.tree_util.tree_map(np.asarray, sj))
    fj = jax.jit(jstep.make_train_step(
        cj, jopt.AdamWConfig(**kw), microbatches=mb, attn_impl="pallas",
        grad_transform=jcomp.ef_int8_transform if ef else None))
    ft = tstep.make_train_step(
        ct, topt.AdamWConfig(**kw), microbatches=mb,
        grad_transform=tcomp.ef_int8_transform if ef else None)
    data = dict(vocab_size=cj.vocab_size, seq_len=32, global_batch=4, seed=1)
    dj, dt = JPipeline(JDataConfig(**data)), SyntheticPipeline(
        DataConfig(**data))
    for step in range(5):
        sj, mj = fj(sj, dj.batch_at(step))
        st, mt = ft(st, dt.batch_at(step))
        assert abs(float(mt["loss"]) - float(mj["loss"])) <= LOSS_TOL[dtype]
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mj["grad_norm"]), rtol=0.05)
        # the jit-compiled schedule's cos may differ by one float32 ulp
        np.testing.assert_allclose(float(mt["lr"]), float(mj["lr"]),
                                   rtol=1e-6)
    assert int(st["opt"]["step"]) == int(sj["opt"]["step"]) == 5
    tol = PARAM_TOL[dtype, variant in ("8bit", "compress_grads")]
    want = jax.tree_util.tree_leaves(sj["params"])
    for w, g in zip(want, topt.tree_leaves(st["params"])):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), atol=tol,
                                   rtol=0)


# ---------------------------------------------------------------- trainer

CFG = treg.get_smoke_config("granite-3-2b")


def _tc(tmp, steps, ckpt_every=10, horizon=25, **kw):
    # the schedule's horizon is the run's total length, not the segment's
    return TrainerConfig(steps=steps, global_batch=4, seq_len=32,
                         ckpt_dir=tmp, ckpt_every=ckpt_every, log_every=0,
                         opt=AdamWConfig(total_steps=horizon, warmup=2), **kw)


@pytest.mark.parametrize("compress", [False, True])
def test_restart_resumes_identical_trajectory(tmp_path, compress):
    t_full = Trainer(CFG, _tc(str(tmp_path / "full"), steps=25,
                              compress_grads=compress), device="cpu")
    t_full.run()
    full_losses = t_full.losses()

    t_a = Trainer(CFG, _tc(str(tmp_path / "ab"), steps=10,
                           compress_grads=compress), device="cpu")
    t_a.run()
    t_b = Trainer(CFG, _tc(str(tmp_path / "ab"), steps=25,
                           compress_grads=compress), device="cpu")
    state, start = t_b.restore_or_init()
    assert start == 10
    t_b.run(state, start)
    np.testing.assert_allclose(t_b.losses(), full_losses[10:], rtol=1e-5)
    assert full_losses[-1] < full_losses[0]


def test_preemption_checkpoints_and_exits(tmp_path):
    tr = Trainer(CFG, _tc(str(tmp_path), steps=50, ckpt_every=100),
                 device="cpu")
    tr.preemption.trigger()                       # preempt before step 1
    state, step = tr.run()
    assert step == 1
    assert tr.ckpt.latest_step() == 1
    restored, at = Trainer(CFG, _tc(str(tmp_path), steps=50),
                           device="cpu").restore_or_init()
    assert at == 1 and int(restored["opt"]["step"]) == 1


def test_straggler_detection():
    det = StragglerDetector(n_workers=8, threshold=1.5, patience=2)
    rng = np.random.default_rng(0)
    flagged = []
    for _ in range(6):
        times = rng.normal(1.0, 0.03, 8)
        times[3] = 2.5                            # persistent straggler
        flagged = det.observe(times)
    assert flagged == [3]
    det.reset(3)
    assert det.observe(rng.normal(1.0, 0.03, 8)) == []


def test_elastic_replan_shard_map():
    amap = ElasticPlan(old_shards=16, new_shards=12,
                       resume_step=1000).shard_assignment()
    assert set(amap.values()) <= set(range(12))
    assert len(amap) == 16


def test_trainer_without_a_device_raises_on_a_cpu_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(CFG, _tc(None, steps=1))


def test_train_launcher_on_the_cpu(tmp_path):
    from repro_torch.launch import train
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train.main(["--steps", "1"])
    tr = train.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                     "--seq", "16", "--microbatches", "2",
                     "--compress-grads",
                     "--ckpt-dir", str(tmp_path)])
    assert len(tr.losses()) == 3 and np.isfinite(tr.losses()).all()
    assert tr.ckpt.latest_step() == 3
