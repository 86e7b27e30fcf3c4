"""The flash backward's routes and wrappers on the CPU: ``ops.bwd_route``
and ``ops.wgmma_kernels`` at their edges, the wgmma wrappers' refusals
(the pair's and the parts kernels') before any launch, the rows buffer
and the float32 parts, and the CPU path counting no launch on any
wrapper.  The
kernels themselves run only on the card (``tests/test_torch_cuda.py``,
marker ``cuda``); their parity with the reference's ``jnp_impl._bwd_vjp``
on the CPU is ``tests/test_torch_train.py``'s."""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


# every kernel wrapper of the backward: the wgmma route's pair and its
# three parts kernels, the simt route's three
WRAPPERS = (ops.fa_bwd_dq_wgmma, ops.fa_bwd_dkdv_wgmma, ops.fa_bwd_delta,
            ops.fa_bwd_dkdv, ops.fa_bwd_dq, ops.fa_bwd_prep,
            ops.fa_bwd_dq_parts, ops.fa_bwd_dkdv_parts)


def _qkv(dtype, Dh, S=8, H=4, KV=2, device="cpu"):
    g = np.random.default_rng(Dh)
    return tuple(torch.from_numpy(g.standard_normal((1, S, n, Dh)).astype(
        np.float32)).to(device=device, dtype=dtype) for n in (H, KV, KV))


# (dtype, head dim) -> the route: bfloat16 up to a head dim of 256 and
# float32 up to 128 take the wgmma kernels (TMA pads the head dim to a
# multiple of 64), float32's wider heads the SIMT kernels
@pytest.mark.parametrize("dtype,Dh,want", [
    (torch.bfloat16, 8, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 112, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 136, "wgmma"), (torch.bfloat16, 256, "wgmma"),
    (torch.float32, 8, "wgmma"), (torch.float32, 64, "wgmma"),
    (torch.float32, 256, "simt"), (torch.bfloat16, 192, "wgmma"),
    (torch.float32, 128, "wgmma"), (torch.float32, 136, "simt"),
    (torch.float32, 192, "simt")])
def test_bwd_route_at_its_edges(dtype, Dh, want):
    q, k, v = _qkv(dtype, Dh, device="meta")
    assert ops.bwd_route(q, k, v) == want


# (dtype, head dim) -> the wgmma route's kernels: the bfloat16 pair up to
# a head dim of 128, the parts kernels past it and for float32
@pytest.mark.parametrize("dtype,Dh,want", [
    (torch.bfloat16, 8, "pair"), (torch.bfloat16, 128, "pair"),
    (torch.bfloat16, 136, "parts"), (torch.bfloat16, 192, "parts"),
    (torch.bfloat16, 256, "parts"), (torch.float32, 8, "parts"),
    (torch.float32, 64, "parts"), (torch.float32, 128, "parts")])
def test_wgmma_kernels_at_their_edges(dtype, Dh, want):
    q, _, _ = _qkv(dtype, Dh, device="meta")
    assert ops.wgmma_kernels(q) == want


# (dtype, head dim) -> the kernels a CUDA backward launches, from a
# config's dtype and head dim alone: bwd_route, then wgmma_kernels
@pytest.mark.parametrize("dtype,Dh,want", [
    (torch.bfloat16, 128, "pair"), (torch.bfloat16, 136, "parts"),
    (torch.bfloat16, 256, "parts"), (torch.float32, 64, "parts"),
    (torch.float32, 128, "parts"), (torch.float32, 136, "simt"),
    (torch.float32, 256, "simt")])
def test_bwd_kernels_from_dtype_and_head_dim(dtype, Dh, want):
    q, k, v = _qkv(dtype, Dh, device="meta")
    assert ops.bwd_kernels(dtype, Dh) == want
    assert want == (ops.wgmma_kernels(q) if ops.bwd_route(q, k, v)
                    == "wgmma" else "simt")


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# a training step's backward launches in chip_smoke.py follow
# ops.bwd_kernels: granite-3-2b in bfloat16 (head dim 64) and float32,
# nemotron-4-340b (head dim 192) in bfloat16
@pytest.mark.parametrize("arch,dtype,kernels", [
    ("granite-3-2b", "bfloat16", "pair"), ("granite-3-2b", "float32", "parts"),
    ("nemotron-4-340b", "bfloat16", "parts")])
def test_train_launches_take_the_routes_kernels(arch, dtype, kernels):
    from repro_torch.configs.registry import get_config

    cs = _chip_smoke()
    want = cs.train_launches(get_config(arch).replace(n_layers=2,
                                                      dtype=dtype))
    assert want == {"flash_attention": 4,
                    **dict.fromkeys(cs.BWD_ROUTE_KERNELS[kernels], 2)}


def test_prep_bound_counts_k_and_v_only_for_float32():
    """``fa_bwd_prep`` reads out, dout and lse and writes the rows buffer;
    only for float32 does it read q, k and v (to write their parts), so
    only there do its bytes grow with the kv heads."""
    cs = _chip_smoke()

    def nbytes(dtype, KV):
        return cs.fa_bwd_bounds(1, 128, 8, KV, 64, True, 0,
                                dtype)["fa_bwd_prep"][3]
    assert nbytes(torch.bfloat16, 2) == nbytes(torch.bfloat16, 8) == \
        2 * (128 * 8 * 64 * 2) + 3 * (8 * 128 * 4)
    assert nbytes(torch.float32, 8) > nbytes(torch.float32, 2)


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
    """Inputs off the wgmma pair (float32, or a head dim past 128: the
    parts kernels') raise before the library is built or a launch counted
    (the C launchers refuse them too: the card test)."""
    q, k, v = _qkv(dtype, Dh)
    lse = torch.zeros((1, 4, 8))
    rows = torch.zeros(ops.rows_shape(q))
    before = [w.launches for w in WRAPPERS]
    with pytest.raises(ValueError, match="wgmma pair takes bfloat16"):
        ops.fa_bwd_dq_wgmma(q, k, v, q, q, lse, True, 0)
    with pytest.raises(ValueError, match="wgmma pair takes bfloat16"):
        ops.fa_bwd_dkdv_wgmma(q, k, v, q, rows, True, 0)
    assert [w.launches for w in WRAPPERS] == before


@pytest.mark.parametrize("dtype,Dh", [(torch.bfloat16, 64),
                                      (torch.bfloat16, 128),
                                      (torch.float32, 136),
                                      (torch.float32, 256)])
def test_parts_wrappers_refuse_what_they_cannot_run_before_any_launch(
        dtype, Dh):
    """Inputs off the parts kernels (bfloat16 up to head dim 128: the
    pair's; float32 past 128: simt's) raise before the library is built
    or a launch counted."""
    q, k, v = _qkv(dtype, Dh)
    lse = torch.zeros((1, 4, 8))
    rows = torch.zeros(ops.rows_shape(q))
    before = [w.launches for w in WRAPPERS]
    with pytest.raises(ValueError, match="parts kernels take"):
        ops.fa_bwd_prep(q, k, v, q, q, lse)
    with pytest.raises(ValueError, match="parts kernels take"):
        ops.fa_bwd_dq_parts(q, (q, k, v, q), rows, True, 0)
    with pytest.raises(ValueError, match="parts kernels take"):
        ops.fa_bwd_dkdv_parts(q, k, (q, k, v, q), rows, True, 0)
    assert [w.launches for w in WRAPPERS] == before


@pytest.mark.parametrize("Dh,cols", [(8, 192), (64, 192), (72, 384),
                                     (128, 384)])
def test_float32_parts_pad_the_head_dim_to_64(Dh, cols):
    """A float32 operand's parts: three bf16 copies of DP columns, DP the
    head dim rounded up to 64, what the parts kernels' TMA maps read."""
    q, k, _ = _qkv(torch.float32, Dh, device="meta")
    assert ops.parts_shape(q) == (1, 8, 4, cols)
    assert ops.parts_shape(k) == (1, 8, 2, cols)


def test_parts_kernels_refuse_a_foreign_rows_buffer():
    """The parts dq and dkdv kernels read only the rows buffer of
    ``fa_bwd_prep``'s shape: anything else is refused before a launch."""
    q, k, v = _qkv(torch.bfloat16, 192, S=77)
    rows = torch.zeros(ops.rows_shape(q))
    before = [w.launches for w in WRAPPERS]
    for bad in (rows[:, :, 1:], rows.double(), rows.transpose(0, 1)):
        with pytest.raises(ValueError, match="rows buffer"):
            ops.fa_bwd_dq_parts(q, (q, k, v, q), bad, True, 0)
        with pytest.raises(ValueError, match="rows buffer"):
            ops.fa_bwd_dkdv_parts(q, k, (q, k, v, q), bad, True, 0)
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
    """``wgmma_kernels``' head-dim limit of the pair is the one each pair
    launcher refuses past, and the rows buffer's padding is the kernels'
    (``rows_pad``, in the header both sources share)."""
    src = (CSRC / "flash_attention_bwd.cu").read_text()
    body = src[src.index(f'extern "C" int {entry}('):]
    body = body[:body.index("\n}\n")]
    limit = re.search(r"dtype != 1 \|\| Dh > (\d+)", body)
    assert limit and int(limit.group(1)) == ops.MAX_PAIR_HEAD_DIM
    header = (CSRC / "flash_attention_bwd.cuh").read_text()
    pad = re.search(r"int rows_pad\(int S\) \{ return \(S \+ (\d+)\) / "
                    r"(\d+) \* (\d+); \}", header)
    assert pad and [int(x) for x in pad.groups()] == [
        ops.ROWS_TILE - 1, ops.ROWS_TILE, ops.ROWS_TILE]


def test_parts_limits_match_the_c_launchers():
    """The parts launchers' limits (``bad_parts``) are ``bwd_route``'s and
    ``wgmma_kernels``': bfloat16 past the pair's head dim up to 256,
    float32 up to 128, and ``fa_bwd_prep`` writes float32's three parts."""
    src = (CSRC / "flash_attention_bwd_parts.cu").read_text()
    m = re.search(r"dtype == 1 \? Dh > (\d+) && Dh <= (\d+) : dtype == 0 "
                  r"&& Dh <= (\d+)", src)
    assert m and [int(x) for x in m.groups()] == [
        ops.MAX_PAIR_HEAD_DIM, ops.MAX_WGMMA_BWD_HEAD_DIM,
        ops.MAX_F32_WGMMA_BWD_HEAD_DIM]
    assert "fa_bwd_prep_kernel<float, 3>" in src
    q = torch.empty((1, 8, 4, 128), device="meta")
    assert ops.parts_shape(q)[-1] == 3 * 128


def test_parts_kernels_are_named_for_the_profilers_group():
    """The parts kernels start with ``fa_bwd_`` too, which chip_smoke.py's
    training profile gathers as "flash backward"."""
    src = (CSRC / "flash_attention_bwd_parts.cuh").read_text()
    names = set(re.findall(
        r"__global__ void __launch_bounds__\([^)]*\)\s*(\w+)\(", src))
    assert names == {"fa_bwd_prep_kernel", "fa_bwd_dq_parts_kernel",
                     "fa_bwd_dkdv_parts_kernel"}
