"""Build and bind the port's CUDA kernels.

Every ``src/repro_torch/csrc/*.cu`` file (with the ``*.cuh`` headers it
includes) is compiled by its own ``nvcc`` process, all started together,
and the objects are linked into one shared library with a plain C
interface, which ``ctypes`` loads:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -Xcompiler -fPIC -c -o <source>.o <source>.cu      (each source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o build/repro_torch/libqn_<hash>.so *.o

``--fmad=false`` keeps the compiler from contracting any multiply-add:
the kernels write ``__fmaf_rn`` exactly where the reference's XLA
programs contract, and nowhere else.  The library is named by a hash of
the flags, the sources and the headers, so an edited source or header
rebuilds and an unchanged one loads from ``build/repro_torch/`` without
compiling (``obs.compile`` counts both).  The build runs at first use,
never at import; a build that fails raises.  Each C entry point returns
``cudaGetLastError()`` after its launch, and ``check`` raises on a
nonzero code; ``count`` then adds the launch to the wrapper's count.
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

import torch

from repro_torch.obs import compile as _obs_compile

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = (ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_D, _F = ctypes.c_double, ctypes.c_float
# C signatures: (name, argtypes); every entry point returns an int (the
# cudaError_t of its launch, or for the *_scratch_bytes queries a size)
SIGNATURES = {
    "amva_ps_launch": [_P, _P, _P, _P, _P, _I, _I, _P],
    # a (float64), slots, nu_lo, n; b, think, h (float32); t_out; iters;
    # stream: one AMVA frontier from its scalars
    "amva_ps_frontier_launch": [_D, _I, _I, _I, _F, _F, _F, _P, _I, _P],
    # demand, think, r_out; n, h_users; stream
    "amva_mva_launch": [_P, _P, _P, _I, _I, _P],
    # counts, means, think0, tables (11); resp_sum, resp_cnt, scratch;
    # lanes, H, max_slots, E, warmup_jobs, replay, general; out: the route
    # that ran (0 qn_event_general, 1 qn_event_fast, 2 qn_event_wide,
    # 3 qn_event_many: qn_event/ops.py ROUTES); stream
    "qn_event_launch": [_P] * 11 + [_P, _P, _P] + [_I] * 7 + [_P, _P],
    # H, max_slots, E -> per-lane bytes of global scratch (0: shared
    # memory)
    "qn_event_scratch_bytes": [_I, _I, _I],
    # seed, budgets, think_ms, sample lists, think0, st_m, st_r, td; B, H,
    # E, list lengths, replay; stream
    "qn_streams_launch": [_P] * 9 + [_I] * 6 + [_P],
    # stage arrays, lane counts, think_ms, think0, st, td, samples (10);
    # resp_sum, resp_cnt, scratch; lanes, K, H, max_slots, E, n_samples,
    # sample rows, warmup_jobs, replay, fast (1: dag_event_fast); stream
    "dag_event_launch": [_P] * 10 + [_P, _P, _P] + [_I] * 10 + [_P],
    # H, max_slots -> per-lane bytes of global scratch (0: shared memory)
    "dag_event_scratch_bytes": [_I, _I],
    # seed, budgets, think_ms, the tables (one buffer: st, td, think0); B,
    # H, E, n_samples, replay; stream
    "dag_streams_launch": [_P] * 4 + [_I] * 5 + [_P],
    # seed, stage arrays, lane counts, think_ms, samples, the tables'
    # buffer, resp (sum then count), scratch (11); lanes, K, H, max_slots,
    # E, n_samples, sample rows, warmup_jobs, replay, fast, depth; stream:
    # the tables then the event loop on one stream
    "dag_sim_launch": [_P] * 11 + [_I] * 11 + [_P],
    # stream: one launch of an empty kernel (the launch floor)
    "launch_floor_launch": [_P],
    # out (32 words), rounds, collective (0 redux, 1 ballot + ffs, 2
    # shfl); stream: a probe of the fast step's collectives
    "dag_collective_chain_launch": [_P, _I, _I, _P],
    # q, k, v, o, lse (null: none); B, S, H, KV, Dh; (b, s, head) strides
    # of q, k, v, o; causal, window, dtype; stream
    "flash_attention_launch": [_P] * 5 + [_I] * 5 + [_L] * 12
                              + [_I] * 3 + [_P],
    # q, k, v (float32), their parts qp, kp, vp; B, S, H, KV, Dh; (b, s,
    # head) strides of q, k, v; stream: the float32 wgmma route's split
    "fa_fwd_split_launch": [_P] * 6 + [_I] * 5 + [_L] * 9 + [_P],
    # qp, kp, vp, o, lse (null: none); B, S, H, KV, Dh; (b, s, head)
    # strides of o; causal, window; stream: its wgmma kernel
    "fa_fwd_parts_launch": [_P] * 5 + [_I] * 5 + [_L] * 3 + [_I] * 2
                           + [_P],
    # o, dout, delta; B, S, H, Dh; (b, s, head) strides of o, dout; dtype;
    # stream
    "fa_bwd_delta_launch": [_P] * 3 + [_I] * 4 + [_L] * 6 + [_I, _P],
    # q, k, v, dout, lse, delta, dk, dv; B, S, H, KV, Dh; (b, s, head)
    # strides of q, k, v, dout, dk, dv; causal, window, dtype; stream
    "fa_bwd_dkdv_launch": [_P] * 8 + [_I] * 5 + [_L] * 18 + [_I] * 3
                          + [_P],
    # q, k, v, dout, lse, delta, dq; B, S, H, KV, Dh; (b, s, head) strides
    # of q, k, v, dout, dq; causal, window, dtype; stream
    "fa_bwd_dq_launch": [_P] * 7 + [_I] * 5 + [_L] * 15 + [_I] * 3 + [_P],
    # q, k, v, o, dout, lse, rows (written: lse * log2(e) and delta), dq;
    # B, S, H, KV, Dh; (b, s, head) strides of q, k, v, o, dout, dq;
    # causal, window, dtype; stream
    "fa_bwd_dq_wgmma_launch": [_P] * 8 + [_I] * 5 + [_L] * 18 + [_I] * 3
                              + [_P],
    # q, k, v, dout, rows, dk, dv; B, S, H, KV, Dh; (b, s, head) strides
    # of q, k, v, dout, dk, dv; causal, window, dtype; stream
    "fa_bwd_dkdv_wgmma_launch": [_P] * 7 + [_I] * 5 + [_L] * 18 + [_I] * 3
                                + [_P],
    # q, k, v, o, dout, lse, rows, and the parts of q, k, v, dout (null
    # for bfloat16); B, S, H, KV, Dh; (b, s, head) strides of q, k, v, o,
    # dout; dtype; stream
    "fa_bwd_prep_launch": [_P] * 11 + [_I] * 5 + [_L] * 15 + [_I, _P],
    # the operands q, k, v, dout (parts or tensors), rows, dq; B, S, H,
    # KV, Dh; (b, s, head) strides of the operands and dq; causal, window,
    # dtype; stream
    "fa_bwd_dq_parts_launch": [_P] * 6 + [_I] * 5 + [_L] * 15 + [_I] * 3
                              + [_P],
    # the operands, rows, dk, dv; B, S, H, KV, Dh; strides of the operands,
    # dk, dv; causal, window, dtype; stream
    "fa_bwd_dkdv_parts_launch": [_P] * 7 + [_I] * 5 + [_L] * 18 + [_I] * 3
                                + [_P],
    # x, dt, A, B, C, y, state; B, S, H, P, N, chunk; (b, s, head) strides
    # of x and dt, A's stride, (b, s) strides of B and C; dtypes of x, dt,
    # A, B/C; route; stream
    "ssd_scan_launch": [_P] * 7 + [_I] * 6 + [_L] * 11 + [_I] * 5 + [_P],
    # x, B, C, their parts xp and bcp; B, S, H, P, N; (b, s, head) strides
    # of x, (b, s) strides of B and C; dtypes of x and B/C; stream: the
    # float32 SSD route's split
    "ssd_parts_split_launch": [_P] * 5 + [_I] * 5 + [_L] * 7 + [_I] * 2
                              + [_P],
    # xp, bcp, dt, A, y, state; scratch g, u, e; B, S, H, P, N, chunk;
    # (b, s, head) strides of dt, A's stride; dtypes of dt, A and y;
    # stream: its four kernels
    "ssd_parts_launch": [_P] * 9 + [_I] * 6 + [_L] * 4 + [_I] * 3 + [_P],
    # x, dt, A, B, C, dy, dstate; dx, ddt, dA, dB, dC; scratch: states,
    # dstates, rows, chunks, dB and dC by head; B, S, H, P, N, chunk;
    # (b, s, head) strides of x and dt, A's stride, (b, s) strides of B and
    # C, (b, s, head) strides of dy; dtypes of x, dt, A, B/C, dy; stream
    "ssd_bwd_launch": [_P] * 18 + [_I] * 6 + [_L] * 14 + [_I] * 5 + [_P],
    # x, dt, A, B, C, dy, dstate; dx, ddt, dA, dB, dC; scratch: the
    # states' and cotangents' images, dG summed by head group, rows,
    # chunks, dB and dC by head group; B, S, H, P, N, chunk, the head
    # groups of the chunk and dB/dC passes; strides as ssd_bwd_launch's;
    # dtypes of dt and A; stream: the bf16 route
    "ssd_bwd_wgmma_launch": [_P] * 18 + [_I] * 8 + [_L] * 14 + [_I] * 2
                            + [_P],
}

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None
build_log = ""          # nvcc's output of the last build (ptxas usage)


def sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    """A hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _run_all(cmds):
    """Run the commands at once; their joined output, or raise."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(outs)
    for p in procs:
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{log}")
    return log


def _compile(out: Path) -> None:
    global build_log
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [out.with_name(f"{tag}.{src.stem}.o") for src in sources()]
    tmp = out.with_name(f"{tag}.so.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        build_log = _run_all([[nvcc, *FLAGS, "-c", "-o", str(obj), str(src)]
                              for src, obj in zip(sources(), objs)])
        build_log += _run_all([[nvcc, ARCH, "-shared", "-o", str(tmp),
                                *map(str, objs)]])
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    _obs_compile.record_build((time.perf_counter() - t0) * 1e3)


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


def launch(dev, entry, *args) -> int:
    """``entry(*args, stream)``: a C entry point called on the current
    stream of the CUDA device ``dev``, switching the current device only
    where ``dev`` is not it already; returns the entry point's code."""
    cur = torch.cuda.current_device()
    idx = cur if dev.index is None else dev.index
    # torch's own lookup of the stream pointer, without a Stream object
    if idx == cur:
        return entry(*args, torch._C._cuda_getCurrentRawStream(cur))
    with torch.cuda.device(idx):
        return entry(*args, torch._C._cuda_getCurrentRawStream(idx))


def check(rc: int, kernel: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")


def count(wrapper, route=None) -> None:
    """Add one to ``wrapper.launches`` (and to ``wrapper.routes[route]``
    for a wrapper with several kernels), under a lock: the point-wise
    planner launches kernels from worker threads."""
    with _count_lock:
        wrapper.launches += 1
        if route is not None:
            wrapper.routes[route] += 1


if __name__ == "__main__":
    # Build time of one nvcc over every source against one nvcc per source
    # in parallel plus a link (what library() runs), alternated twice:
    #   PYTHONPATH=src python -m repro_torch.kernels.build
    out = BUILD_DIR / "timing"
    out.mkdir(parents=True, exist_ok=True)
    one = [_nvcc(), *FLAGS, "-shared", "-o", str(out / "one.so"),
           *map(str, sources())]
    for way, build in 2 * [("one nvcc", lambda: _run_all([one])),
                           ("parallel", lambda: _compile(out / "par.so"))]:
        t0 = time.perf_counter()
        build()
        print(f"[build] {way}: {time.perf_counter() - t0:.2f} s", flush=True)
    shutil.rmtree(out)
