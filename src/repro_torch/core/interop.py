"""Carry a planning problem and its evaluation state across from the JAX
reference package, through JSON and numpy only (nothing of the reference
is imported).

  * ``problem_from_reference`` — a reference ``Problem.to_json()`` document
    becomes a port ``Problem`` (the schema is shared; a private
    ``deployment`` section becomes the port's ``PrivateCloud``);
  * ``samples_from_reference`` — replay lists ``{(class, vm): (m, r)}``
    as float32 numpy arrays, the form both packages digest;
  * ``cache_from_reference`` — a reference evaluation cache, keyed
    ``(profile_hash, vm_name, nu, seed)``: the port computes the same
    ``profile_hash``, so adopted entries are hits for the same points;
  * ``params_from_reference`` — a reference model parameter tree (nested
    dicts of arrays, stacked group axes and all) as the port's tensors;
  * ``train_state_from_reference`` — a reference train state (params,
    ``opt`` with its step, moments or 8-bit codes and scales and master
    copy, ``ef_err``) as the port's, bit for bit.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.problem import Problem


def problem_from_reference(doc: str) -> Problem:
    """Port ``Problem`` from a reference ``Problem.to_json()`` document,
    its private ``deployment`` (hosts, per-type VM memory, name) carried
    across as a ``repro_torch.cloud.hosts.PrivateCloud``."""
    return Problem.from_json(doc)


def samples_from_reference(samples: Dict) -> Dict[Tuple[str, str], tuple]:
    """Replay lists keyed ``(class_name, vm_name)`` -> ``(m_list, r_list)``
    (a MapReduce class), checked (1-D, non-empty, finite) and converted to
    float32 arrays; a DAG class's per-stage ``(K, NS)`` array (a numpy
    array, as the reference keys it) stays one float32 array."""
    out = {}
    for key, pair in samples.items():
        if not (isinstance(key, tuple) and len(key) == 2
                and all(isinstance(k, str) for k in key)):
            raise ValueError(f"sample key must be (class, vm): {key!r}")
        if isinstance(pair, np.ndarray):
            arr = np.asarray(pair, np.float32)
            if arr.ndim != 2 or arr.size == 0 or not np.isfinite(arr).all():
                raise ValueError(f"replay lists of {key} must be a finite, "
                                 "non-empty (stages, samples) array")
            out[key] = arr
            continue
        ms, rs = (np.asarray(x, np.float32) for x in pair)
        for x in (ms, rs):
            if x.ndim != 1 or x.size == 0 or not np.isfinite(x).all():
                raise ValueError(f"replay list of {key} must be a finite, "
                                 "non-empty 1-D array")
        out[key] = (ms, rs)
    return out


def cache_from_reference(cache: Dict) -> Dict[tuple, float]:
    """Check a reference evaluation cache and return it as a port cache
    (a new dict; values as Python floats, ``inf`` allowed for points where
    no job completed)."""
    out = {}
    for key, val in cache.items():
        ok = (isinstance(key, tuple) and len(key) == 4
              and isinstance(key[0], str) and len(key[0]) == 16
              and isinstance(key[1], str)
              and all(isinstance(k, (int, np.integer))
                      and not isinstance(k, bool) for k in key[2:]))
        if not ok:
            raise ValueError("cache key must be (profile_hash, vm, nu, "
                             f"seed): {key!r}")
        t = float(val)
        if math.isnan(t) or t < 0:
            raise ValueError(f"cache value of {key!r} is not a time: {val!r}")
        out[(key[0], key[1], int(key[2]), int(key[3]))] = t
    return out


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: carry the bits
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16))
        return t.view(torch.bfloat16).to(device)
    if a.dtype not in (np.float32, np.int32, np.int8):
        raise ValueError(f"array dtype {a.dtype} is not float32, "
                         "bfloat16, int32 or int8")
    return torch.from_numpy(a.copy()).to(device)


def params_from_reference(tree, device="cpu"):
    """A reference parameter tree (nested dicts whose leaves are arrays, as
    ``numpy.asarray`` gives them) as the same tree of torch tensors on
    ``device``, bit for bit; the stacked group axes stay."""
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def train_state_from_reference(tree, device="cpu"):
    """A reference train state (``init_train_state``'s tree, as
    ``numpy.asarray`` gives its leaves: params, ``opt.step``, ``opt.mv``
    with m/v or the int8 codes and float32 scales, ``opt.master``,
    ``ef_err``) as the same tree of torch tensors on ``device``, bit for
    bit and dtype for dtype."""
    return params_from_reference(tree, device)
