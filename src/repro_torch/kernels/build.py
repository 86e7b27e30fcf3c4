"""Build and bind the port's CUDA kernels.

Every ``src/repro_torch/csrc/*.cu`` file is compiled by one ``nvcc`` call
into a shared library with a plain C interface, which ``ctypes`` loads:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -shared -Xcompiler -fPIC -o build/repro_torch/libqn_<hash>.so ...

``--fmad=false`` keeps the compiler from contracting any multiply-add:
the kernels write ``__fmaf_rn`` exactly where the reference's XLA
programs contract, and nowhere else.  The library is named by a hash of
the flags and the sources, so an edited source rebuilds and an unchanged
one loads from ``build/repro_torch/`` without compiling
(``obs.compile`` counts both).  The build runs at first use, never at
import; a build that fails raises.  Each C entry point returns
``cudaGetLastError()`` after its launch, and ``check`` raises on a
nonzero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from repro_torch.obs import compile as _obs_compile

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = (ARCH, "-std=c++17", "-O3", "--fmad=false", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: (name, argtypes); every entry point returns an int
# (the cudaError_t of its launch)
SIGNATURES = {
    "amva_ps_launch": [_P, _P, _P, _P, _P, _I, _I, _P],
    "qn_event_launch": [_P] * 11 + [_P, _P, _P, _P] + [_I] * 6 + [_P],
}

_lock = threading.Lock()
_lib = None
build_log = ""          # nvcc's output of the last build (ptxas usage)


def sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _compile(out: Path) -> None:
    global build_log
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *FLAGS, "-o", str(tmp), *map(str, sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    ms = (time.perf_counter() - t0) * 1e3
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, out)
    _obs_compile.record_build(ms)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its hash is new."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = BUILD_DIR / f"libqn_{source_hash()}.so"
        if path.exists():
            _obs_compile.record_cache_hit()
        else:
            _compile(path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(rc: int, kernel: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")
