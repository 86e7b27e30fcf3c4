"""Abstract parameter specs and their initializer.

The reference's ``sharding`` module also maps logical axes onto a device
mesh; the port runs on one device, so it keeps only ``ParamSpec`` and
``init_params``.  The reference's ``shard_act`` is the
identity outside a mesh context, so the port's model code drops it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    dtype: str = "float32"
    axes: Tuple[Optional[str], ...] = ()
    init: str = "normal"          # normal | zeros | ones
    scale: float = 1.0            # stddev multiplier for normal init

    def __post_init__(self):
        assert len(self.axes) == len(self.shape), (self.shape, self.axes)

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def map_tree(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a tree of nested dicts, keys visited
    in sorted order (the order the reference flattens a dict in)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def param_count(specs) -> int:
    total = 0

    def add(s: ParamSpec):
        nonlocal total
        total += s.size
    map_tree(add, specs)
    return total


def init_params(specs, generator: torch.Generator,
                hold: Optional[Callable[[str, ParamSpec], torch.dtype]] = None
                ) -> Dict[str, Any]:
    """Materialize parameters on the generator's device: zeros, ones, or
    ``normal * scale / sqrt(fan_in)`` drawn in float32 from ``generator``
    and cast to the spec's dtype, leaves in sorted-key order.  A leaf
    stacked over layers (its first axis ``"layers"``) is drawn one layer
    at a time.  The draws are torch's, not ``jax.random``'s: tests carry
    the reference's weights across with
    ``core.interop.params_from_reference`` instead.

    ``hold(name, spec)``, where given, names the dtype each leaf is kept
    in (``name`` is its key): each layer's draw is cast to the spec's
    dtype and then at once into a preallocated tensor of that dtype, so
    the tree equals the default tree cast leaf by leaf, and no float32
    copy of a stacked leaf exists beside it.  This is how a model whose
    float32 tree does not fit on one device is built in bfloat16
    (``serve.step.init_working_params``)."""
    device = generator.device

    def one(name: str, s: ParamSpec) -> torch.Tensor:
        dtype = DTYPES[s.dtype]
        out = torch.empty(s.shape, device=device,
                          dtype=hold(name, s) if hold else dtype)
        if s.init == "zeros":
            return out.zero_()
        if s.init == "ones":
            return out.fill_(1)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else max(s.shape[-1], 1)
        std = s.scale / math.sqrt(max(fan_in, 1))
        for part in (out if s.axes[:1] == ("layers",) else out[None]):
            v = torch.randn(part.shape, generator=generator,
                            dtype=torch.float32, device=device)
            part.copy_(v.mul_(std).to(dtype))
        return out

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(tree[k], k) for k in sorted(tree)}
        return one(name, tree)
    return walk(specs)
