"""The ctypes signatures the port binds its kernels' library with
(``repro_torch.kernels.build.SIGNATURES``) against the C prototypes in
``src/repro_torch/csrc/*.cu``: one parameter each, a pointer where ctypes
passes ``c_void_p``, an ``int`` where it passes ``c_int``, a ``long long``
where it passes ``c_longlong``.  A mismatch would pass garbage to a launch
on the card, where no test here reaches; this holds the two on the CPU.
The DAG kernels' wrappers are held to their launch rule here too: the
plain version on a CPU tensor (no launch counted), a raise on any other
device that is not CUDA, and on inputs the kernel would misread."""
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest

from repro_torch.kernels import build

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _prototypes() -> dict:
    out = {}
    for path in sorted(CSRC.glob("*.cu")):
        for name, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)\s*\{', path.read_text()):
            out[name] = [" ".join(p.split()) for p in params.split(",")]
    return out


def _ctype(param: str):
    if "*" in param:
        return ctypes.c_void_p
    kind = param.rsplit(" ", 1)[0]
    return {"int": ctypes.c_int, "long long": ctypes.c_longlong}[kind]


@pytest.mark.parametrize("name", sorted(build.SIGNATURES))
def test_signature_matches_the_c_prototype(name):
    protos = _prototypes()
    assert name in protos, f"no extern \"C\" {name} in {CSRC}"
    assert [_ctype(p) for p in protos[name]] == build.SIGNATURES[name], \
        protos[name]


def test_every_entry_point_is_bound():
    """Every ``extern "C"`` function of the sources has a signature."""
    assert sorted(_prototypes()) == sorted(build.SIGNATURES)


def test_dag_wrappers_launch_only_on_cuda_and_take_the_plain_version_on_cpu():
    """The DAG kernels' wrappers: a CPU tensor takes the plain version and
    counts no launch; a tensor on another device raises rather than
    falling back; inputs the kernel would misread raise first."""
    import torch

    from repro_torch.kernels.dag_event import ops

    i32 = lambda x, d="cpu": torch.tensor(x, dtype=torch.int32, device=d)
    f32 = lambda x, d="cpu": torch.tensor(x, dtype=torch.float32, device=d)
    before = ops.dag_streams.launches, ops.dag_event.launches
    tables = ops.dag_streams(f32([500.0]), torch.tensor([3]), i32([64]),
                             h_users=2, n_events=64, n_samples=5)
    lane = (i32([[3, 2]]), f32([[40.0, 60.0]]), i32([2]), i32([2]),
            i32([64]), f32([500.0]))
    smp = f32(np.full((2, 5), 50.0, np.float32))
    s, c = ops.dag_event(*lane, *tables, smp, max_slots=2, warmup_jobs=0)
    assert c[0] > 0 and (ops.dag_streams.launches,
                         ops.dag_event.launches) == before
    with pytest.raises(ValueError, match="int32"):        # replay: indices
        ops.dag_event(*lane, tables[0], tables[1].float(), tables[2], smp,
                      max_slots=2, warmup_jobs=0)
    with pytest.raises(ValueError, match="stage arrays"):
        ops.dag_event(lane[0][:, :1], *lane[1:], *tables, smp, max_slots=2,
                      warmup_jobs=0)
    meta = [x.to("meta") for x in (*lane, *tables, smp)]
    with pytest.raises(ValueError, match="no dag_event kernel"):
        ops.dag_event(*meta, max_slots=2, warmup_jobs=0)
    with pytest.raises(ValueError, match="no dag_streams kernel"):
        ops.dag_streams(meta[5], torch.tensor([3], device="meta"), meta[4],
                        h_users=2, n_events=64)
