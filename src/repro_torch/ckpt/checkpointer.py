"""Atomic, async checkpointing of a tree of tensors: the reference's
``ckpt.checkpointer`` layout, so that a checkpoint written by either
package restores in the other.

Layout: ``<dir>/step_<N>/arrays_p<rank>.npz`` + ``manifest.json``.
  * keys: each leaf's path in the tree of nested dicts, the keys joined
    with "/" (``params/groups/l0/attn/wq``, ``opt/step``), as the
    reference names them;
  * atomic: written to ``step_<N>.tmp``, then renamed;
  * async: the device-to-host snapshot is taken at once (a consistent
    cut: the port's optimizer updates its tensors in place, so the
    snapshot copies), and a writer thread serializes it;
  * retention: the newest ``keep`` checkpoints stay;
  * restore: the latest complete step (``.tmp`` directories are ignored).

A bfloat16 leaf is stored as the reference's numpy stores one: two raw
bytes a value (dtype ``|V2``).  The port restores it bit for bit; the
reference's restore cannot cast that dtype back, in its own checkpoints
as in the port's.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _paths(tree, prefix=""):
    """(key, leaf) pairs of a tree of nested dicts, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``, independent of its storage."""
    t = t.detach()
    t = t.cpu() if t.is_cuda else t.clone()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _from_numpy(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=like.device, dtype=like.dtype)


def flatten(tree) -> Dict[str, np.ndarray]:
    return {k: _to_numpy(v) for k, v in _paths(tree)}


def unflatten(tree_like, flat: Dict[str, np.ndarray], prefix=""):
    """``tree_like``'s tree with each leaf read from ``flat``, in the
    leaf's dtype and on its device."""
    if isinstance(tree_like, dict):
        return {k: unflatten(tree_like[k], flat,
                             f"{prefix}/{k}" if prefix else str(k))
                for k in tree_like}
    return _from_numpy(flat[prefix], tree_like)


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3, rank: int = 0,
                 async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.rank = rank
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ----------------------------------------------------------------- save
    def save(self, state: Any, step: int, block: bool = False) -> None:
        flat = flatten(state)                     # consistent snapshot NOW
        self.wait()                               # one writer at a time

        def _write():
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, f"arrays_p{self.rank}.npz"), **flat)
            manifest = {"step": step, "n_processes": 1, "time": time.time(),
                        "keys": sorted(flat)}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if self.async_write and not block:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        for s in self.completed_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -------------------------------------------------------------- restore
    def completed_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name,
                                               "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.completed_steps()
        return steps[-1] if steps else None

    def restore(self, state_like: Any,
                step: Optional[int] = None) -> Tuple[Any, int]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step}",
                            f"arrays_p{self.rank}.npz")
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        return unflatten(state_like, flat), step
