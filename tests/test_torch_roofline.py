"""The roofline tools (``launch/roofline``) and the measured QN/AMVA kernel
record (``launch/qn_record``): the port against the live reference in one
process on the CPU.

Every roofline figure is host arithmetic in float64 and must equal the
reference's exactly, for every registry arch x shape at 16, 64 and 256
chips, on synthetic dry-run records.  The port's QN record has the
reference's cells and keys; on the CPU only its plain implementation runs
(``parity_bit_exact`` None), and that plain simulation of the quick cell
equals the reference's ``_sim_batch_jit``: its job counts exactly, its
mean response times within a relative 1e-3 (exponential mode: the draws'
one-ulp ``log1p`` differences; one lane's mean parts by one ulp).  ~20 s
alone.
"""
import json
import sys

import numpy as np
import pytest
import torch

from benchmarks import torch_scenarios as port_drive
from repro.configs.registry import ARCH_IDS, SHAPES
from repro.configs.registry import get_config as ref_config
from repro.launch import qn_record as ref_qn_record
from repro.launch import roofline as rr
from repro_torch.configs.registry import get_config as port_config
from repro_torch.configs.registry import get_shape as port_shape
from repro_torch.launch import qn_record
from repro_torch.launch import roofline as pr

torch.set_num_threads(1)    # the plain event loop is many tiny ops

CHIPS = (16, 64, 256)


def test_tpu_constants_are_the_references():
    assert (pr.PEAK_FLOPS, pr.HBM_BW, pr.ICI_BW) == \
        (rr.PEAK_FLOPS, rr.HBM_BW, rr.ICI_BW)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_flops_and_memory_every_shape_and_chip_count(arch):
    r_cfg, p_cfg = ref_config(arch), port_config(arch)
    assert pr.active_param_count(p_cfg) == rr.active_param_count(r_cfg)
    for shape in SHAPES:
        p_shape = port_shape(shape.name)
        assert pr.model_flops(p_cfg, p_shape) == \
            rr.model_flops(r_cfg, shape), shape.name
        for chips in CHIPS:
            assert pr.analytic_memory_bytes(p_cfg, p_shape, chips) == \
                rr.analytic_memory_bytes(r_cfg, shape, chips), \
                (shape.name, chips)


def _records():
    """Dry-run records of every arch x shape at three chip counts, each
    bottleneck reached (scaled flops, bytes and collectives), some with the
    trip-count-aware parse, plus the rows ``analyze_record`` skips."""
    g = np.random.default_rng(5)
    recs = []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            for chips, mesh in zip(CHIPS, ("4x4", "8x8", "16x16")):
                fl, nb, coll = (float(x) for x in g.uniform(
                    [1e9, 1e8, 1e5], [1e14, 1e12, 1e11]))
                rec = {"arch": arch, "shape": shape.name, "mesh": mesh,
                       "supported": True, "n_devices": chips,
                       "cost_analysis": {"flops": fl, "bytes_accessed": nb},
                       "collective_bytes": {"all-reduce": coll,
                                            "all-to-all": coll / 3,
                                            "collective-permute": 0.0}}
                if g.uniform() < 0.3:
                    rec["parsed_flops_per_dev"] = fl * 4
                    rec["parsed_bytes_per_dev"] = nb * 2
                recs.append(rec)
    recs += port_drive.capacity_record()
    recs.append({"arch": "granite-3-2b", "shape": "train_4k",
                 "mesh": "16x16", "supported": True,
                 "cost_analysis": {"error": "no cost analysis"},
                 "collective_bytes": {}})
    return recs


def test_analyze_record_and_format_table():
    recs = _records()
    want = [rr.analyze_record(r) for r in recs]
    got = [pr.analyze_record(r) for r in recs]
    assert [g is None for g in got] == [w is None for w in want]
    assert sum(w is None for w in want) == 3
    want = [w for w in want if w is not None]
    got = [g for g in got if g is not None]
    assert [g.as_dict() for g in got] == [w.as_dict() for w in want]
    assert {w.bottleneck for w in want} == {"compute", "memory",
                                            "collective"}
    assert pr.format_table(got) == rr.format_table(want)


def test_analyze_file_and_main(tmp_path, capsys, monkeypatch):
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps(_records()))
    assert [r.as_dict() for r in pr.analyze_file(str(path))] == \
        [r.as_dict() for r in rr.analyze_file(str(path))]
    monkeypatch.setattr(sys, "argv", ["roofline", "--dryrun", str(path),
                                      "--out", str(tmp_path / "ref.json")])
    rr.main()
    want = capsys.readouterr().out
    pr.main(["--dryrun", str(path), "--out", str(tmp_path / "port.json")])
    got = capsys.readouterr().out
    assert got.replace("port.json", "ref.json") == want
    assert json.loads((tmp_path / "port.json").read_text()) == \
        json.loads((tmp_path / "ref.json").read_text())


def test_kernel_record_rows():
    """``analyze_kernel_record`` on records with a cost analysis (the
    reference's CPU form), with the error form (the port's), with a zero
    wall, and on rows it skips."""
    recs = [{"cell": "meta", "backend": "cpu", "quick": True}]
    for impl, ca, wall in (("jnp", {"flops": 3.2e7, "bytes_accessed": 8e6,
                                    "transcendentals": 4e3}, 0.0123),
                           ("pallas", {"error": "unsupported"}, 0.004),
                           ("cuda", {"flops": 1e6, "bytes_accessed": 0.0},
                            0.0)):
        recs.append({"cell": "qn_event", "impl": impl, "batch": 8,
                     "cost_analysis": ca, "wall_s": wall,
                     "events_per_s": 4096 / max(wall, 1e-9),
                     "parity_bit_exact": impl != "cuda"})
        recs.append({"cell": "amva_ps", "impl": impl, "batch": 1024,
                     "cost_analysis": ca, "wall_s": wall,
                     "candidates_per_s": 1024 / max(wall, 1e-9),
                     "parity_bit_exact": None})
    want = [rr.analyze_kernel_record(r) for r in recs]
    got = [pr.analyze_kernel_record(r) for r in recs]
    assert [g is None for g in got] == [w is None for w in want] == \
        [True] + [False] * 6
    assert [g.as_dict() for g in got[1:]] == [w.as_dict() for w in want[1:]]
    assert pr.format_kernel_table(got[1:]) == \
        rr.format_kernel_table(want[1:])


@pytest.fixture(scope="module")
def qn_records(tmp_path_factory):
    out = tmp_path_factory.mktemp("qn") / "dryrun_qn_torch.json"
    got = qn_record.record_qn_cells(out=str(out), quick=True, device="cpu")
    want = ref_qn_record.record_qn_cells(out=None, quick=True)
    return got, want, out


def test_qn_record_has_the_references_cells_and_keys(qn_records):
    got, want, out = qn_records
    assert json.loads(out.read_text()) == got
    assert got[0] == {"cell": "meta", "backend": "cpu", "quick": True}
    ref_cells = [r for r in want[1:] if r["impl"] == "jnp"]
    assert len(got) - 1 == len(ref_cells) == 2
    shape_keys = ("cell", "batch", "n_map", "n_reduce", "h_users",
                  "min_jobs", "warmup_jobs", "n_events", "max_slots",
                  "lanes", "events_total", "iters")
    for g, w in zip(got[1:], ref_cells):
        assert list(g) == list(w)
        assert {k: g[k] for k in shape_keys if k in w} == \
            {k: w[k] for k in shape_keys if k in w}
        assert g["impl"] == "plain" and g["parity_bit_exact"] is None
        assert g["wall_s"] > 0 and "error" in g["cost_analysis"]
        rate = "events_per_s" if g["cell"] == "qn_event" else \
            "candidates_per_s"
        assert g[rate] > 0


def test_qn_record_rows_read_no_flops(qn_records):
    _, _, out = qn_records
    rows = pr.analyze_qn_file(str(out))
    assert [(r.cell, r.impl) for r in rows] == [("qn_event", "plain"),
                                               ("amva_ps", "plain")]
    for r in rows:
        assert r.throughput > 0 and r.flops == 0.0
        assert r.peak_fraction == 0.0 and r.parity_bit_exact is None
    table = pr.format_kernel_table(rows)
    assert "qn_event" in table and "amva_ps" in table


def test_qn_record_cells_compute_the_references_numbers():
    """The quick cells' inputs through the port's plain versions against
    the reference's jnp implementations on the same cells: the job counts
    and the AMVA fixed point bit for bit, the exponential-mode means within
    a relative 1e-3."""
    import jax.numpy as jnp

    from repro.core import mva as ref_mva
    from repro.core import qn_sim as ref_qn_sim
    from repro_torch.kernels.amva import ref as amva_ref
    from repro_torch.kernels.qn_event import ref as qn_ref

    cell = dict(batch=8, n_map=8, n_reduce=2, m_avg=40.0, r_avg=60.0,
                think_ms=1000.0, h_users=3, min_jobs=8, warmup_jobs=2)
    r_args, r_statics = ref_qn_record._qn_batch(**cell)
    p_args, p_statics = qn_record._qn_batch(torch.device("cpu"), **cell)
    assert p_statics == r_statics
    want = ref_qn_sim._sim_batch_jit(*r_args, **r_statics)
    got = qn_ref.sim_batch(*p_args, **p_statics)
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert float(got[1].min()) > 0
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-3, atol=0)
    rng = np.random.default_rng(0)
    cols = [rng.uniform(1.0, 50.0, 1024), rng.uniform(0.1, 5.0, 1024),
            rng.uniform(1.0, 100.0, 1024), np.full(1024, 10.0)]
    want = ref_mva.ps_response_batch(*(jnp.asarray(c, jnp.float32)
                                       for c in cols))
    got = amva_ref.ps_fixed_point(*(torch.as_tensor(c, dtype=torch.float32)
                                    for c in cols))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_qn_record_without_a_device_raises_on_a_cpu_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        qn_record.record_qn_cells(out=None, quick=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        qn_record.main(["--quick", "--out", "unused.json"])
