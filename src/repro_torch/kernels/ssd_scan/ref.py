"""Plain PyTorch version of the ``ssd_scan`` kernel: the Mamba2 chunked SSD
scan (arXiv:2405.21060 §6), in float32.

``ssd_chunked`` is the reference model's own scan (an intra-chunk
quadratic term plus an inter-chunk state recurrence, the chunks in
order), with an optional incoming state; it requires ``S % chunk == 0``.
``ssd`` has the semantics of the reference's kernel entry ``ssd_fwd``:
the chunk is first clamped to ``min(chunk, S)``.  The kernel computes the
same sums in another order (its own cumulative sum, its own products), so
the two agree up to float32 rounding, not bit for bit.  Both take the
cumulative sums of ``dt * A`` in float64 and round them once to float32,
so their value does not depend on the order of the sum (in float32, at a
chunk of 128, where they reach about -100, the order alone moves y by
~4e-4); the reference sums in float32.  At chunk 128 both this version
and the reference are within their float32 tolerance of the exact scan,
not always of each other (tests/test_torch_ssd.py).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def cumsum(dA: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive cumulative sum of float32 ``dA``, in float64, rounded once
    to float32."""
    return torch.cumsum(dA.double(), dim=dim).float()


def segsum(dA: torch.Tensor) -> torch.Tensor:
    """dA: (..., Q) -> (..., Q, Q) lower-triangular segment sums:
    ``out[..., l, s] = sum_{j=s+1..l} dA[..., j]`` for ``l >= s``, -inf
    above the diagonal (so that ``exp`` gives 0 there and never
    overflows)."""
    Q = dA.shape[-1]
    cs = cumsum(dA, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=dA.device).tril()
    return seg.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B_: torch.Tensor, C_: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,H,P) head values; dt: (B,S,H) (post-softplus, > 0); A: (H,)
    negative; B_, C_: (B,S,N) (one SSD group, shared by the heads).
    Returns (y (B,S,H,P) in x's dtype, final state (B,H,P,N) float32)."""
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {chunk}")
    nc = S // chunk
    f32 = torch.float32
    xdt = x.to(f32) * dt.to(f32)[..., None]
    dA = dt.to(f32) * A.to(f32)                                  # (B,S,H)
    xc = xdt.reshape(Bb, nc, chunk, H, P)
    dAc = dA.reshape(Bb, nc, chunk, H)
    Bc = B_.to(f32).reshape(Bb, nc, chunk, N)
    Cc = C_.to(f32).reshape(Bb, nc, chunk, N)
    state = (torch.zeros((Bb, H, P, N), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    ys = []
    for c in range(nc):
        xk, dAk, Bk, Ck = xc[:, c], dAc[:, c], Bc[:, c], Cc[:, c]
        cs = cumsum(dAk, dim=1)                                  # (B,Q,H)
        L = torch.exp(segsum(dAk.transpose(1, 2)))               # (B,H,Q,Q)
        G = torch.einsum("bln,bsn->bls", Ck, Bk)                 # (B,Q,Q)
        Y = torch.einsum("bls,bhls,bshp->blhp", G, L, xk)
        Y = Y + torch.einsum("bln,bhpn,blh->blhp", Ck, state, torch.exp(cs))
        decay = torch.exp(cs[:, -1:, :] - cs)                    # (B,Q,H)
        state = state * torch.exp(cs[:, -1])[..., None, None]
        state = state + torch.einsum("bsn,bsh,bshp->bhpn", Bk, decay, xk)
        ys.append(Y)
    y = torch.stack(ys, dim=1).reshape(Bb, S, H, P)
    return y.to(x.dtype), state


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        B_: torch.Tensor, C_: torch.Tensor, chunk: int = 128
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function: ``ssd_chunked`` with the chunk clamped to
    ``min(chunk, S)``; raises ``ValueError`` when S is not a multiple of
    the clamped chunk."""
    return ssd_chunked(x, dt, A, B_, C_, min(int(chunk), x.shape[1]))
