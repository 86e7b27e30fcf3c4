"""The ctypes signatures the port binds its kernels' library with
(``repro_torch.kernels.build.SIGNATURES``) against the C prototypes in
``src/repro_torch/csrc/*.cu``: one parameter each, a pointer where ctypes
passes ``c_void_p``, an ``int`` where it passes ``c_int``, a ``long long``
where it passes ``c_longlong``.  A mismatch would pass garbage to a launch
on the card, where no test here reaches; this holds the two on the CPU."""
import ctypes
import re
from pathlib import Path

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
