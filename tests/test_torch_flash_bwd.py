"""The flash backward's routes and wrappers on the CPU: ``ops.bwd_route``
at its edges, the wgmma wrappers' refusals before any launch, the wgmma
route's rows buffer, and the CPU path counting no launch on any wrapper.  The
kernels themselves run only on the card (``tests/test_torch_cuda.py``,
marker ``cuda``); their parity with the reference's ``jnp_impl._bwd_vjp``
on the CPU is ``tests/test_torch_train.py``'s."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


# every kernel wrapper of the backward: the wgmma route's two, the simt
# route's three
WRAPPERS = (ops.fa_bwd_dq_wgmma, ops.fa_bwd_dkdv_wgmma, ops.fa_bwd_delta,
            ops.fa_bwd_dkdv, ops.fa_bwd_dq)


def _qkv(dtype, Dh, S=8, H=4, KV=2, device="cpu"):
    g = np.random.default_rng(Dh)
    return tuple(torch.from_numpy(g.standard_normal((1, S, n, Dh)).astype(
        np.float32)).to(device=device, dtype=dtype) for n in (H, KV, KV))


# (dtype, head dim) -> the route: bfloat16 up to a head dim of 128 takes
# the wgmma kernels (TMA pads the head dim to 64 or 128), float32 and the
# wider heads the SIMT kernels
@pytest.mark.parametrize("dtype,Dh,want", [
    (torch.bfloat16, 8, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 112, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 136, "simt"), (torch.bfloat16, 256, "simt"),
    (torch.float32, 8, "simt"), (torch.float32, 64, "simt"),
    (torch.float32, 256, "simt")])
def test_bwd_route_at_its_edges(dtype, Dh, want):
    q, k, v = _qkv(dtype, Dh, device="meta")
    assert ops.bwd_route(q, k, v) == want


def test_cpu_backward_counts_no_launch_on_any_wrapper():
    """A CPU backward takes the plain version: no wrapper counts a launch,
    on any route."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _qkv(dtype, 16)
        out, lse = ops.flash_attention_fwd(q, k, v, causal=True)
        before = [w.launches for w in WRAPPERS]
        dq, dk, dv = ops.flash_attention_bwd(q, k, v, out, lse,
                                             torch.ones_like(q), causal=True)
        assert [w.launches for w in WRAPPERS] == before
        assert (dq.dtype, dk.dtype, dv.dtype) == (dtype,) * 3


@pytest.mark.parametrize("dtype,Dh", [(torch.float32, 64),
                                      (torch.bfloat16, 256)])
def test_wgmma_wrappers_refuse_what_they_cannot_run_before_any_launch(
        dtype, Dh):
    """Inputs off the wgmma route raise before the library is built or a
    launch counted (the C launchers refuse them too: the card test)."""
    q, k, v = _qkv(dtype, Dh)
    lse = torch.zeros((1, 4, 8))
    rows = torch.zeros(ops.rows_shape(q))
    before = [w.launches for w in WRAPPERS]
    with pytest.raises(ValueError, match="wgmma backward takes bfloat16"):
        ops.fa_bwd_dq_wgmma(q, k, v, q, q, lse, True, 0)
    with pytest.raises(ValueError, match="wgmma backward takes bfloat16"):
        ops.fa_bwd_dkdv_wgmma(q, k, v, q, rows, True, 0)
    assert [w.launches for w in WRAPPERS] == before


@pytest.mark.parametrize("S,pad", [(1, 64), (64, 64), (77, 128),
                                   (1000, 1024), (1024, 1024)])
def test_rows_buffer_pads_s_to_the_dkdv_tile(S, pad):
    """The wgmma dq pass's rows buffer: (B, H, S_pad, 2) float32 with S_pad
    a multiple of 64, so each 64-row tile is one aligned 512-byte bulk
    copy; delta is its second channel's first S rows."""
    q, k, v = _qkv(torch.bfloat16, 16, S=S, H=3, KV=3)
    assert ops.rows_shape(q) == (1, 3, pad, 2) and pad % ops.ROWS_TILE == 0
    rows = torch.zeros(ops.rows_shape(q))
    assert tuple(ops.rows_delta(rows, S).shape) == (1, 3, S)
    # the dkdv kernel reads no other buffer: refused before any launch
    before = ops.fa_bwd_dkdv_wgmma.launches
    for bad in (rows[:, :, 1:], rows.double(), rows.transpose(0, 1)):
        with pytest.raises(ValueError, match="rows buffer"):
            ops.fa_bwd_dkdv_wgmma(q, k, v, q, bad, True, 0)
    assert ops.fa_bwd_dkdv_wgmma.launches == before


def test_tma_ready_copies_only_what_tma_cannot_read():
    x = torch.zeros((2, 16, 4, 64), dtype=torch.bfloat16)
    assert ops._tma_ready(x) is x
    odd = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)[1:].view(x.shape)
    assert odd.data_ptr() % 16
    fixed = ops._tma_ready(odd)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, odd)
    strided = torch.zeros((2, 16, 4, 68), dtype=torch.bfloat16)[..., :64]
    assert strided.stride(2) % 8
    assert ops._tma_ready(strided).is_contiguous()


def test_backward_kernels_are_named_for_the_profilers_group():
    """Every kernel of the backward's source starts with ``fa_bwd_``, which
    chip_smoke.py's training profile gathers as "flash backward"; the
    wgmma route has its two kernels."""
    src = (CSRC / "flash_attention_bwd.cu").read_text()
    names = set(re.findall(
        r"__global__ void __launch_bounds__\([^)]*\)\s*(\w+)\(", src))
    assert names and all(n.startswith("fa_bwd_") for n in names), names
    assert {"fa_bwd_dq_wgmma_kernel", "fa_bwd_dkdv_wgmma_kernel",
            "fa_bwd_delta_kernel", "fa_bwd_dkdv_kernel",
            "fa_bwd_dq_kernel"} == names


@pytest.mark.parametrize("entry", ["fa_bwd_dq_wgmma_launch",
                                   "fa_bwd_dkdv_wgmma_launch"])
def test_wgmma_limits_match_the_c_launchers(entry):
    """``bwd_route``'s head-dim limit is the one each wgmma launcher
    refuses past, and the rows buffer's padding is the kernels'."""
    src = (CSRC / "flash_attention_bwd.cu").read_text()
    body = src[src.index(f'extern "C" int {entry}('):]
    body = body[:body.index("\n}\n")]
    limit = re.search(r"dtype != 1 \|\| Dh > (\d+)", body)
    assert limit and int(limit.group(1)) == ops.MAX_WGMMA_BWD_HEAD_DIM
    pad = re.search(r"int rows_pad\(int S\) \{ return \(S \+ (\d+)\) / "
                    r"(\d+) \* (\d+); \}", src)
    assert pad and [int(x) for x in pad.groups()] == [
        ops.ROWS_TILE - 1, ops.ROWS_TILE, ops.ROWS_TILE]
