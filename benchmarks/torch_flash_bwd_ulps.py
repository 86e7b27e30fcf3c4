"""Where the flash backward's bfloat16 gradients part from the plain
version, counted in bfloat16 steps, at granite-3-2b's training shape
(B=8, S=1024, H=32, KV=8, Dh=64, causal):

    python3 benchmarks/torch_flash_bwd_ulps.py

The inputs are those of ``chip_smoke.py``'s backward check at that shape
(drawn on the card from seed S + H, out and lse from the port's forward
kernel).  (dq, dk, dv) are computed six ways:

  wgmma       ``flash_attention_bwd``: the wgmma route's two kernels
  simt        the simt route's three kernels
  plain       ``ref.flash_attention_bwd``, what the checks hold both to:
              float32 sums, p = exp(s * scale - lse)
  plain_loop  the same formulas one batch element at a time (its float32
              sums run in another order than plain's)
  plain_exp2  plain_loop with p formed as the wgmma kernels form it,
              exp2(fma(s, scale * log2(e), -lse * log2(e))) (the kernels'
              ex2.approx is within 2 float32 ulps of exp2)
  exact       float64 sums, p and ds rounded to bfloat16 where the plain
              version rounds them, no final cast

For each of dq, dk and dv it reports, against plain, how many elements
lie 0, 1, 2 or more bfloat16 steps away and the largest absolute
difference with the magnitude where it sits; against exact, the same in
units of the last place of bfloat16 at the exact value (a correctly
rounded sum is within 0.5).  It also counts the live (query, key) pairs
where plain_exp2's p or ds, rounded to bfloat16, differ from
plain_loop's.  Prints one JSON line; needs a CUDA card, imports only
torch and this tree's ``repro_torch``.
"""
import json
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

B, S, H, KV, DH = 8, 1024, 32, 8, 64
CAUSAL, WINDOW = True, 0
LOG2E = 1.4426950408889634
BF = torch.bfloat16


def f32(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float32))


def inputs(dev):
    g = torch.Generator(device=dev).manual_seed(S + H)
    return tuple(torch.randn((B, S, n, DH), generator=g, device=dev).to(BF)
                 for n in (H, KV, KV, H))


def grads(q, k, v, out, lse, dout, form):
    """(dq, dk, dv) unrounded, in float64 for ``form`` "exact", else
    float32 ("exp" or "exp2", p's formula), one batch element at a time;
    for "exp2" also the live pairs whose bf16 p or ds differ from
    "exp"'s."""
    acc = torch.float64 if form == "exact" else torch.float32
    G, scale = H // KV, 1.0 / math.sqrt(DH)
    c2, l2e = f32(LOG2E / math.sqrt(DH)), f32(LOG2E)
    mask = ref.band_mask(S, CAUSAL, WINDOW, q.device)
    dev = q.device
    dq = torch.empty((B, S, H, DH), dtype=acc, device=dev)
    dk = torch.empty((B, S, KV, DH), dtype=acc, device=dev)
    dv = torch.empty((B, S, KV, DH), dtype=acc, device=dev)
    flips = {"live": 0, "p": 0, "ds": 0, "p_f32_differs": 0}

    def finish(p, dp, delta):
        p = p.masked_fill(~mask, 0.0)
        ds = (p * (dp - delta[..., None]) * scale).masked_fill(~mask, 0.0)
        return p, ds

    for b in range(B):
        qg = q[b].to(acc).reshape(S, KV, G, DH)
        kb, vb = k[b].to(acc), v[b].to(acc)
        dog = dout[b].to(acc).reshape(S, KV, G, DH)
        og = out[b].to(acc).reshape(S, KV, G, DH)
        s = torch.einsum("qkgd,skd->kgqs", qg, kb)
        lse_b = lse[b].reshape(KV, G, S)[..., None]
        delta = torch.einsum("qkgd,qkgd->kgq", dog, og)
        dp = torch.einsum("qkgd,skd->kgqs", dog, vb)
        p_exp = torch.exp(s * scale - lse_b.to(acc))
        p, ds = finish(p_exp, dp, delta)
        if form == "exp2":
            # fl32(s * c2 - fl32(lse * log2 e)): the kernels' one FMA
            x = (s.double() * c2 - (lse_b * l2e).double()).float()
            p2, ds2 = finish(torch.exp2(x), dp, delta)
            flips["live"] += int(mask.sum()) * KV * G
            flips["p"] += int((p2.to(BF) != p.to(BF)).sum())
            flips["ds"] += int((ds2.to(BF) != ds.to(BF)).sum())
            flips["p_f32_differs"] += int((p2 != p).sum())
            p, ds = p2, ds2
        p, ds = p.to(BF).to(acc), ds.to(BF).to(acc)
        dv[b] = torch.einsum("kgqs,qkgd->skd", p, dog)
        dk[b] = torch.einsum("kgqs,qkgd->skd", ds, qg)
        dq[b] = torch.einsum("kgqs,skd->qkgd", ds, kb).reshape(S, H, DH)
        del s, dp, p_exp, p, ds
    return (dq, dk, dv), flips


def ordered(x):
    """bfloat16 values as integers in the order of the values: adjacent
    bfloat16 numbers differ by one."""
    i = x.view(torch.int16).int()
    return torch.where(i < 0, -(i & 0x7FFF), i)


def where_max(d, want):
    i = int(d.flatten().argmax())
    idx = [int(t) for t in torch.unravel_index(torch.tensor(i), d.shape)]
    return {"at_b_s_head_d": idx, "magnitude": abs(float(want.flatten()[i]))}


def against_plain(got, want):
    steps = (ordered(got) - ordered(want)).abs()
    d = (got.float() - want.float()).abs()
    n = steps.numel()
    return {"steps_0": int((steps == 0).sum()) / n,
            "steps_1": int((steps == 1).sum()) / n,
            "steps_2": int((steps == 2).sum()) / n,
            "steps_more": int((steps > 2).sum()) / n,
            "max_abs_diff": float(d.max()), **where_max(d, want)}


def against_exact(got, exact):
    e = exact.abs().clamp_min(1e-30)
    ulp = torch.ldexp(torch.ones_like(e), torch.floor(torch.log2(e)) - 7)
    u = (got.double() - exact).abs() / ulp
    n = u.numel()
    return {"ulp_le_0.5": int((u <= 0.5).sum()) / n,
            "ulp_le_1": int((u <= 1).sum()) / n,
            "ulp_le_2": int((u <= 2).sum()) / n,
            "ulp_more": int((u > 2).sum()) / n,
            "max_ulp": float(u.max()), **where_max(u, exact)}


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    q, k, v, dout = inputs(dev)
    out, lse = ops.flash_attention_fwd(q, k, v, causal=CAUSAL, window=WINDOW)
    assert ops.bwd_route(q, k, v) == "wgmma"
    kw = dict(causal=CAUSAL, window=WINDOW)
    runs = {"wgmma": ops.flash_attention_bwd(q, k, v, out, lse, dout, **kw)}
    delta = ops.fa_bwd_delta(out, dout)
    dk, dv = ops.fa_bwd_dkdv(q, k, v, dout, lse, delta, CAUSAL, WINDOW)
    runs["simt"] = (ops.fa_bwd_dq(q, k, v, dout, lse, delta, CAUSAL, WINDOW),
                    dk, dv)
    runs["plain"] = ref.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    loop, _ = grads(q, k, v, out, lse, dout, "exp")
    runs["plain_loop"] = tuple(x.to(BF) for x in loop)
    exp2, flips = grads(q, k, v, out, lse, dout, "exp2")
    runs["plain_exp2"] = tuple(x.to(BF) for x in exp2)
    exact, _ = grads(q, k, v, out, lse, dout, "exact")
    torch.cuda.synchronize()
    names = ("dq", "dk", "dv")
    res = {"card": torch.cuda.get_device_name(0),
           "shape": f"B={B} S={S} H={H} KV={KV} Dh={DH} bf16 causal",
           "exp2_flips": flips,
           "magnitude": {n: {"max": float(x.abs().max()),
                             "median": float(x.abs().median())}
                         for n, x in zip(names, exact)},
           "against_plain": {r: {n: against_plain(g, w) for n, g, w in
                                 zip(names, runs[r], runs["plain"])}
                             for r in runs if r != "plain"},
           "against_exact": {r: {n: against_exact(g, e) for n, g, e in
                                 zip(names, runs[r], exact)}
                             for r in runs}}
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
