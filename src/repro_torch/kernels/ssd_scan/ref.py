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

``split_parts`` and ``split`` are the plain version of the float32 route's
split pass (``csrc/ssd_scan_parts.cu``): x, B and C as three bfloat16
parts each, whose sum is the value exactly.

``ssd_bwd`` is the plain version of the backward kernels
(``csrc/ssd_scan_bwd.cu``): the vjp of ``ssd`` written out chunk by chunk
in reverse, without autograd; the kernels take the same sums in other
orders (tests/test_torch_ssd_bwd.py holds it to ``jax.vjp`` of the
reference's op and to autograd through ``ssd``).
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


def split_parts(t: torch.Tensor) -> torch.Tensor:
    """One operand's split: ``t`` (..., D), float32 or bfloat16, as three
    bfloat16 parts (..., 3 DP), DP = D rounded up to 64: hi = t rounded to
    bf16 in columns [0, DP), mid = what hi leaves, rounded, in [DP, 2 DP),
    lo = what mid leaves in [2 DP, 3 DP), zeros past D.  8 + 8 + 8 bits:
    the parts sum to ``t`` exactly where |t| >= 2^-110 or t = 0 (below,
    mid and lo fall among the subnormals and lose bits)."""
    D = t.shape[-1]
    DP = -(-D // 64) * 64
    out = torch.zeros((*t.shape[:-1], 3, DP), dtype=torch.bfloat16,
                      device=t.device)
    rest = t.float()
    for p in range(3):
        out[..., p, :D] = rest.to(torch.bfloat16)
        rest = rest - out[..., p, :D].float()
    return out.reshape(*t.shape[:-1], 3 * DP)


def split(x: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split pass: (xp (B,S,H,3 DP), bcp (B,S,2,3 NP)), x's parts and
    B's and C's (bcp's head 0 B, head 1 C), contiguous bfloat16, as
    ``ssd_parts_split_kernel`` writes them."""
    return split_parts(x), torch.stack([split_parts(B_), split_parts(C_)],
                                       dim=2)


def join_parts(parts: torch.Tensor, D: int) -> torch.Tensor:
    """The value the three parts of ``split_parts`` hold, float32 (..., D):
    hi + mid, then + lo (each sum exact)."""
    DP = parts.shape[-1] // 3
    hi, mid, lo = (parts[..., i * DP:i * DP + D].float() for i in range(3))
    return (hi + mid) + lo


def revcumsum(d: torch.Tensor, dim: int) -> torch.Tensor:
    """Reverse inclusive cumulative sum of float32 ``d`` (the vjp of
    ``cumsum``), in float64, rounded once to float32."""
    return torch.flip(torch.cumsum(torch.flip(d.double(), (dim,)), dim=dim),
                      (dim,)).float()


def ssd_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B_: torch.Tensor, C_: torch.Tensor, dy: torch.Tensor,
            dstate: torch.Tensor, chunk: int = 128):
    """The vjp of ``ssd`` at (dy, dstate), written out (no autograd):
    (dx, ddt, dA, dB, dC) in the dtypes of x, dt, A, B_ and C_.

    Per chunk, with xdt = x dt, cs = cumsum(dt A), L[l, s] = exp(cs[l] -
    cs[s]) for s <= l, G = C B^T, S0 the state entering the chunk, decay[s]
    = exp(cs[Q-1] - cs[s]) and dS the cotangent of the state leaving it:
      d xdt[s] = sum_l (G o L)[l, s] dy[l] + decay[s] dS B[s]
      dG       = L o (dy xdt^T), summed over heads; dL o L = dG o G
      dC[l]    = sum_s dG[l, s] B[s] + exp(cs[l]) dy[l] S0
      dB[s]    = sum_l dG[l, s] C[l] + decay[s] xdt[s] dS
      dS_prev  = exp(cs[Q-1]) dS + sum_l exp(cs[l]) dy[l]^T C[l]
      dcs      = rows of dL o L - its columns + exp(cs[l]) dy[l].(S0 C[l])
                 - decay[s] xdt[s].(dS B[s]) (their sum again at Q-1)
                 + exp(cs[Q-1]) <dS, S0> at Q-1
    and da = the reverse cumulative sum of dcs, dx = d xdt dt, ddt =
    sum_p d xdt x + da A (each term rounded to dt's dtype before the sum,
    as the reference's two paths are), dA = sum_{b,s} da dt.  The chunks
    run in reverse
    after a forward replay that keeps each chunk's entering state.  Sums
    in float32; the cumulative sums in float64, rounded once, as ``ssd``
    takes its own."""
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    Q = min(int(chunk), S)
    if S % Q:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {Q}")
    nc = S // Q
    f32 = torch.float32
    dtf, Af = dt.to(f32), A.to(f32)
    xc = (x.to(f32) * dtf[..., None]).reshape(Bb, nc, Q, H, P)
    dyc = dy.to(f32).reshape(Bb, nc, Q, H, P)
    Bc = B_.to(f32).reshape(Bb, nc, Q, N)
    Cc = C_.to(f32).reshape(Bb, nc, Q, N)
    cs = cumsum((dtf * Af).reshape(Bb, nc, Q, H), dim=2)        # (B,nc,Q,H)
    tril = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()

    states = []                                  # the state entering each
    state = torch.zeros((Bb, H, P, N), dtype=f32, device=x.device)
    for c in range(nc):
        states.append(state)
        decay = torch.exp(cs[:, c, -1:] - cs[:, c])
        state = state * torch.exp(cs[:, c, -1])[..., None, None] + \
            torch.einsum("bsn,bsh,bshp->bhpn", Bc[:, c], decay, xc[:, c])

    dS = dstate.to(f32)
    dxdt = torch.empty((Bb, nc, Q, H, P), dtype=f32, device=x.device)
    dB = torch.empty((Bb, nc, Q, N), dtype=f32, device=x.device)
    dC = torch.empty_like(dB)
    dcs = torch.empty((Bb, nc, Q, H), dtype=f32, device=x.device)
    for c in reversed(range(nc)):
        xk, dyk, Bk, Ck, S0 = xc[:, c], dyc[:, c], Bc[:, c], Cc[:, c], \
            states[c]
        csk = cs[:, c]                                           # (B,Q,H)
        e = torch.exp(csk)
        e_last = torch.exp(csk[:, -1])                           # (B,H)
        decay = torch.exp(csk[:, -1:] - csk)
        seg = csk.transpose(1, 2)[..., :, None] - \
            csk.transpose(1, 2)[..., None, :]                    # (B,H,l,s)
        L = torch.exp(seg.masked_fill(~tril, float("-inf")))
        G = torch.einsum("bln,bsn->bls", Ck, Bk)[:, None]        # (B,1,l,s)
        dG = L * torch.einsum("blhp,bshp->bhls", dyk, xk)        # (B,H,l,s)
        dLL = dG * G
        dxdt[:, c] = torch.einsum("bhls,blhp->bshp", G * L, dyk) + \
            decay[..., None] * torch.einsum("bhpn,bsn->bshp", dS, Bk)
        dC[:, c] = torch.einsum("bhls,bsn->bln", dG, Bk) + \
            torch.einsum("blh,blhp,bhpn->bln", e, dyk, S0)
        dB[:, c] = torch.einsum("bhls,bln->bsn", dG, Ck) + \
            torch.einsum("bsh,bshp,bhpn->bsn", decay, xk, dS)
        state_in = e * torch.einsum("blhp,bhpn,bln->blh", dyk, S0, Ck)
        to_state = decay * torch.einsum("bshp,bhpn,bsn->bsh", xk, dS, Bk)
        d = (dLL.sum(-1) - dLL.sum(-2)).transpose(1, 2) + state_in - to_state
        d[:, -1] += to_state.sum(1) + e_last * (dS * S0).sum((-2, -1))
        dcs[:, c] = d
        dS = e_last[..., None, None] * dS + \
            torch.einsum("blh,blhp,bln->bhpn", e, dyk, Ck)

    da = revcumsum(dcs, dim=2).reshape(Bb, S, H)
    dxdt = dxdt.reshape(Bb, S, H, P)
    dx = dxdt * dtf[..., None]
    # dt enters twice (x dt and dt A): each path's cotangent takes dt's
    # dtype before the two are added, as the reference's vjp adds them
    ddt = (dxdt * x.to(f32)).sum(-1).to(dt.dtype) + (da * Af).to(dt.dtype)
    dA = (da * dtf).sum((0, 1))
    return (dx.to(x.dtype), ddt, dA.to(A.dtype),
            dB.reshape(Bb, S, N).to(B_.dtype),
            dC.reshape(Bb, S, N).to(C_.dtype))
