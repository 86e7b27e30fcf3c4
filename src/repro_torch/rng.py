"""Counter-based threefry2x32 random numbers, bit-compatible with the
reference's ``jax.random`` (default ``threefry2x32`` implementation with
``jax_threefry_partitionable=True``, 32-bit mode).

A key is an int64 tensor of shape ``(..., 2)`` whose two entries hold the
two uint32 key words; every function accepts a batch of keys (leading
dimensions) and draws independently per key, which is what the
reference's ``jax.vmap`` over per-lane keys computes.  torch has no
general uint32 arithmetic, so every word is carried in an int64 and
masked back to 32 bits after each add and shift: the bits are the same,
and the ops run unchanged on CPU and CUDA tensors.

What is bit-exact against ``jax.random``: ``key``, ``split``,
``fold_in``, ``random_bits``, ``uniform`` and ``randint``.
``exponential`` is ``-log1p(-uniform)``: torch's ``log1p`` is not XLA's,
and the two differ by one ulp on a few percent of draws
(``tests/test_torch_rng.py`` states the measured count).
``categorical`` draws the same uniform bits as ``jax.random.categorical``;
its Gumbel noise goes through torch's ``log``, so the two agree wherever
the winning category is not a near tie.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

MASK32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry-2x32 block cipher (20 rounds), elementwise over the
    broadcast shape of its four uint32-valued int64 operands."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & MASK32
    b = (x2 + ks[1]) & MASK32
    for block in range(5):
        for r in _ROT[block % 2]:
            a = (a + b) & MASK32
            b = _rotl(b, r) ^ a
        a = (a + ks[(block + 1) % 3]) & MASK32
        b = (b + ks[(block + 2) % 3] + block + 1) & MASK32
    return a, b


def key(seed, device=None) -> torch.Tensor:
    """``jax.random.key(seed)`` for int32 seeds (the reference's lanes
    carry int32 seeds): the key words are ``(0, seed mod 2**32)``.  A
    tensor of seeds gives a batch of keys."""
    s = torch.as_tensor(seed, dtype=torch.int64)
    if bool(((s < -(1 << 31)) | (s >= (1 << 31))).any()):
        raise ValueError("seeds must fit in int32")
    s = s.to(device) if device is not None else s
    return torch.stack([torch.zeros_like(s), s & MASK32], dim=-1)


def _hash_counts(k: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
                 ndim: int):
    """threefry over per-key counters: ``k`` is ``(..., 2)``, the counters
    carry ``ndim`` trailing draw dimensions."""
    k1 = k[..., 0].reshape(k.shape[:-1] + (1,) * ndim)
    k2 = k[..., 1].reshape(k.shape[:-1] + (1,) * ndim)
    return threefry2x32(k1, k2, hi, lo)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``(..., num, 2)`` keys."""
    lo = torch.arange(num, dtype=torch.int64, device=k.device)
    y1, y2 = _hash_counts(k, torch.zeros_like(lo), lo, 1)
    return torch.stack([y1, y2], dim=-1)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``; ``data`` may be a tensor that
    broadcasts against the key batch (one fold per element)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & MASK32
    y1, y2 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def random_bits(k: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """32 random bits per element of ``shape`` per key (the partitionable
    scheme: counter = flat index, result = the two output words xor'd)."""
    shape = tuple(int(d) for d in shape)
    n = 1
    for d in shape:
        n *= d
    idx = torch.arange(n, dtype=torch.int64, device=k.device).reshape(shape)
    y1, y2 = _hash_counts(k, idx >> 32, idx & MASK32, len(shape))
    return y1 ^ y2


def uniform(k: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """float32 uniform on [0, 1): 23 random mantissa bits under the
    exponent of 1.0, minus 1.0 (exact)."""
    bits = (random_bits(k, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def exponential(k: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """Unit-rate float32 exponential draws, ``-log1p(-u)``."""
    return -torch.log1p(-uniform(k, shape))


def randint_words(k: torch.Tensor, shape: Sequence[int] = ()
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two 32-bit words ``randint`` reduces per draw (from the two
    halves of ``split(key)``).  They do not depend on the bounds, so draws
    with several spans from one key can share them."""
    ks = split(k)
    return random_bits(ks[..., 0, :], shape), random_bits(ks[..., 1, :], shape)


def randint(k: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int, words=None) -> torch.Tensor:
    """``jax.random.randint`` for int32 bounds: the two words of
    ``randint_words`` (passed in, or drawn from ``k``) reduced modulo the
    span with uint32 wrap-around, exactly as the reference does."""
    span = int(maxval) - int(minval)
    span = 1 if span <= 0 else span & MASK32
    higher, lower = words if words is not None else randint_words(k, shape)
    mult = (1 << 16) % span
    mult = ((mult * mult) & MASK32) % span
    off = ((higher % span) * mult + (lower % span)) & MASK32
    return int(minval) + off % span


def categorical(k: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` for one key: the
    Gumbel-max trick, ``argmax(logits - log(-log(u)))`` over the last
    axis, with ``u`` the uniform draws of ``logits``'s shape clamped to
    [tiny, 1) as the reference does.  ``k`` may lie on another device
    than ``logits``."""
    tiny = torch.finfo(torch.float32).tiny
    u = uniform(k.to(logits.device), logits.shape)
    u = torch.clamp_min(u * (1.0 - tiny) + tiny, tiny)
    return torch.argmax(-torch.log(-torch.log(u)) + logits.float(), dim=-1)
