"""The ctypes signatures the port binds its kernels' library with
(``repro_torch.kernels.build.SIGNATURES``) against the C prototypes in
``src/repro_torch/csrc/*.cu``: one parameter each, a pointer where ctypes
passes ``c_void_p``, an ``int`` where it passes ``c_int``, a ``long long``
where it passes ``c_longlong``, a ``double`` or ``float`` where it passes
``c_double`` or ``c_float``.  A mismatch would pass garbage to a launch
on the card, where no test here reaches; this holds the two on the CPU.
The DAG kernels' wrappers are held to their launch rule here too: the
plain version on a CPU tensor (no launch counted), a raise on any other
device that is not CUDA, and on inputs the kernel would misread; the
DAG event loop's route rule (``kernels/dag_event/ops.py`` ``route``) at its
edges and against the limits the C launcher refuses past; and the QN event
loop's route names (``kernels/qn_event/ops.py`` ``ROUTES``) against the
route indices its launcher reports."""
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest

from repro_torch.kernels import build

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _prototypes() -> dict:
    out = {}
    for path in sorted(CSRC.glob("*.cu")):
        for name, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)\s*\{', path.read_text()):
            out[name] = [" ".join(p.split()) for p in params.split(",")]
    return out


def _ctype(param: str):
    if "*" in param:
        return ctypes.c_void_p
    kind = param.rsplit(" ", 1)[0]
    return {"int": ctypes.c_int, "long long": ctypes.c_longlong,
            "double": ctypes.c_double, "float": ctypes.c_float}[kind]


@pytest.mark.parametrize("name", sorted(build.SIGNATURES))
def test_signature_matches_the_c_prototype(name):
    protos = _prototypes()
    assert name in protos, f"no extern \"C\" {name} in {CSRC}"
    assert [_ctype(p) for p in protos[name]] == build.SIGNATURES[name], \
        protos[name]


def test_every_entry_point_is_bound():
    """Every ``extern "C"`` function of the sources has a signature."""
    assert sorted(_prototypes()) == sorted(build.SIGNATURES)


def test_dag_wrappers_launch_only_on_cuda_and_take_the_plain_version_on_cpu():
    """The DAG kernels' wrappers: a CPU tensor takes the plain version and
    counts no launch; a tensor on another device raises rather than
    falling back; inputs the kernel would misread raise first."""
    import torch

    from repro_torch.kernels.dag_event import ops

    i32 = lambda x, d="cpu": torch.tensor(x, dtype=torch.int32, device=d)
    f32 = lambda x, d="cpu": torch.tensor(x, dtype=torch.float32, device=d)
    before = (ops.dag_streams.launches, ops.dag_event.launches,
              dict(ops.dag_event.routes))
    tables = ops.dag_streams(f32([500.0]), torch.tensor([3]), i32([64]),
                             h_users=2, n_events=64, n_samples=5)
    lane = (i32([[3, 2]]), f32([[40.0, 60.0]]), i32([2]), i32([2]),
            i32([64]), f32([500.0]))
    smp = f32(np.full((2, 5), 50.0, np.float32))
    s, c = ops.dag_event(*lane, *tables, smp, max_slots=2, warmup_jobs=0)
    g = ops.dag_event(*lane, *tables, smp, max_slots=2, warmup_jobs=0,
                      general=True)
    assert c[0] > 0 and torch.equal(g[0], s) and torch.equal(g[1], c)
    assert (ops.dag_streams.launches, ops.dag_event.launches,
            ops.dag_event.routes) == before
    with pytest.raises(ValueError, match="int32"):        # replay: indices
        ops.dag_event(*lane, tables[0], tables[1].float(), tables[2], smp,
                      max_slots=2, warmup_jobs=0)
    with pytest.raises(ValueError, match="stage arrays"):
        ops.dag_event(lane[0][:, :1], *lane[1:], *tables, smp, max_slots=2,
                      warmup_jobs=0)
    meta = [x.to("meta") for x in (*lane, *tables, smp)]
    with pytest.raises(ValueError, match="no dag_event kernel"):
        ops.dag_event(*meta, max_slots=2, warmup_jobs=0)
    with pytest.raises(ValueError, match="no dag_streams kernel"):
        ops.dag_streams(meta[5], torch.tensor([3], device="meta"), meta[4],
                        h_users=2, n_events=64)


# (h_users, max_slots, K, E, general) -> the route; dag_sweep's frontier
# shape first, then each limit, met and passed by one
DAG_ROUTE_EDGES = [
    ((3, 128, 4, 8192, False), "dag_event_fast"),
    ((32, 512, 31, (1 << 22) - 1, False), "dag_event_fast"),
    ((33, 512, 31, (1 << 22) - 1, False), "dag_event_general"),
    ((32, 513, 31, (1 << 22) - 1, False), "dag_event_general"),
    ((32, 512, 32, (1 << 22) - 1, False), "dag_event_general"),
    ((32, 512, 31, 1 << 22, False), "dag_event_general"),
    ((1, 1, 1, 1, True), "dag_event_general"),
    ((3, 128, 4, 8192, True), "dag_event_general"),
]


@pytest.mark.parametrize("shape,want", DAG_ROUTE_EDGES)
def test_dag_event_route_at_its_edges(shape, want):
    from repro_torch.kernels.dag_event import ops

    *dims, general = shape
    assert ops.route(*dims, general=general) == want
    assert want in ops.dag_event.routes


def test_dag_event_route_limits_match_the_c_launcher():
    """``route``'s limits are the ones ``dag_event_launch`` refuses a fast
    launch past (``fits_fast`` in ``csrc/dag_event.cu``): users, slots (16
    a thread of one warp), stages (the queue key's stage field) and events
    (its rank field)."""
    from repro_torch.kernels.dag_event import ops

    src = (CSRC / "dag_event.cu").read_text() + \
        (CSRC / "event_loop.cuh").read_text()
    const = {k: int(v) for k, v in
             re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    body = re.search(r"bool fits_fast\([^)]*\) \{(.*?)\n\}", src, re.S)[1]
    assert "h_users <= kFastUsers" in body and \
        "max_slots <= 32 * kFastSlots" in body and \
        "K <= kMaxDepth" in body and "n_events < (1 << kRankBits)" in body
    assert (ops.FAST_USERS, ops.FAST_SLOTS, ops.FAST_STAGES,
            ops.FAST_EVENTS) == (const["kFastUsers"],
                                 32 * const["kFastSlots"],
                                 const["kMaxDepth"], 1 << const["kRankBits"])
    # the queue key's fields fill 32 bits: stage depth, rank, user
    assert const["kDepthShift"] == const["kRankBits"] + 5 and \
        (const["kMaxDepth"] + 1) << const["kDepthShift"] == 1 << 32


def test_qn_event_routes_match_the_launchers_route_indices():
    """``ops.ROUTES[i]`` names the kernel that ``qn_event_launch`` runs when
    it reports route ``i`` (``enum Route`` in ``csrc/qn_event.cu``): each
    index names a ``__global__`` kernel of that name, the launcher reports
    ``plan()``'s route, and ``plan()`` sends the fast route up to 32 users
    and 512 slots, the wide one up to 16384 slots."""
    from repro_torch.kernels.qn_event import ops

    src = (CSRC / "qn_event.cu").read_text()
    body = re.search(r"enum Route \{([^}]*)\};", src)[1]
    index = {int(v): k for k, v in re.findall(r"k(\w+) = (\d+)", body)}
    assert sorted(index) == list(range(len(ops.ROUTES)))
    assert [f"qn_event_{index[i].lower()}" for i in sorted(index)] == \
        list(ops.ROUTES)
    for name in ops.ROUTES:
        assert re.search(rf"__global__ void __launch_bounds__\([^)]*\) "
                         rf"{name}\(", src), name
    assert "*route = p.route;" in src
    launch = re.search(r'extern "C" int qn_event_launch\(.*', src, re.S)[0]
    assert "kernel = replay ? qn_event_fast<true>" in launch and \
        "wide_kernel<true>(p.groups)" in launch and \
        "qn_event_general<<<" in launch
    plan = re.search(r"int plan\([^)]*\) \{(.*?)\n\}", src, re.S)[1]
    assert "h_users <= kFastUsers" in plan and \
        "max_slots <= 32 * kFastSlots ? kFast" in plan and \
        "max_slots <= 32 * kWideGroups * kFastSlots" in plan
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);",
        src + (CSRC / "event_loop.cuh").read_text())}
    assert (const["kFastUsers"], 32 * const["kFastSlots"],
            32 * const["kWideGroups"] * const["kFastSlots"]) == \
        (32, 512, 16384)


def test_qn_event_many_route_in_the_source():
    """``qn_event_many`` (33 to 2048 users): its ``Route`` entry, its
    ``__launch_bounds__`` kernel and its instances (a flat slot block or
    4 to 32 groups of slots a thread, one or four groups of users, each
    mode), ``plan()``'s rule for it (more than 32 users up to 2048, fewer
    than 2**20 events, up to 16384 slots, its shared memory under the
    card's limit; ``general`` takes none of it), the queue key's fields
    filling 32 bits, and the largest instance's shared memory (computed
    from the source's layout) under an H100's 232448 bytes a block."""
    src = (CSRC / "qn_event.cu").read_text()
    assert re.search(r"enum Route \{[^}]*kMany = 3[^}]*\};", src)
    assert re.search(r"template <int G, int UG, bool REPLAY>\n__global__ "
                     r"void __launch_bounds__\(32, 1\) qn_event_many\(", src)
    many = re.search(r"LaneKernel many_instance\(bool flat, int groups\) "
                     r"\{(.*?)\n\}", src, re.S)[1]
    assert [int(g) for g in re.findall(r"qn_event_many<(\d+), UG, REPLAY>",
                                       many)] == [0, 4, 8, 16]
    assert "qn_event_many<kWideGroups, UG, REPLAY>" in many
    assert "many_instance<1, REPLAY>" in src and \
        "many_instance<kManyGroups, REPLAY>" in src
    launch = re.search(r'extern "C" int qn_event_launch\(.*', src, re.S)[0]
    assert "kernel = replay ? many_kernel<true>(p) : many_kernel<false>(p);" \
        in launch and "smem = 4 * p.many_words;" in launch
    plan = re.search(r"int plan\([^)]*\) \{(.*?)\n\}", src, re.S)[1]
    rule = re.search(r"const bool many = (.*?);", plan, re.S)[1]
    assert " ".join(rule.split()) == (
        "!general && h_users > kFastUsers && h_users <= kManyUsers && "
        "n_events < (1 << kManyRankBits) && "
        "max_slots <= 32 * kWideGroups * kFastSlots && "
        "4 * p->many_words <= (size_t)limit")
    assert "p->route = many ? kMany" in plan
    assert "p->ugroups = h_users <= 32 * UserBlock<1>::kPad ? 1 : " \
        "kManyGroups;" in plan
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);",
        src + (CSRC / "event_loop.cuh").read_text())}
    assert 1 << const["kManyUserBits"] == const["kManyUsers"] == 2048
    assert 1 + const["kManyRankBits"] + const["kManyUserBits"] == 32
    assert 32 * 16 * const["kManyGroups"] == const["kManyUsers"]
    # GroupBlock<G>::kWords and UserBlock<UG>::kWords as the source lays
    # them out, at the largest instance
    G, UG = const["kWideGroups"], const["kManyGroups"]
    assert "kWords = 64 * kStride + 64 * kGStride + 32 * kFStride;" in src
    slot_words = 64 * (G * 16 + 4) + 64 * (G + 4) + 32 * (G + 1)
    assert re.search(r"kWords =\s+6 \* 32 \* kStride \+ \(UG > 1 \? "
                     r"3 \* 32 \* kGStride : 0\);", src)
    user_words = 6 * 32 * (16 * UG + 4) + 3 * 32 * (UG + 4)
    assert 4 * (slot_words + user_words) == 200832 <= 232448


# (h_users, max_slots, K, E, depth) -> the route: a lane deeper than its
# stage arrays takes the general route (past 31 stages the fast route's
# queue key could not hold it), one within them the fast one
DAG_DEPTH_EDGES = [
    ((3, 128, 4, 8192, 0), "dag_event_fast"),
    ((3, 128, 4, 8192, 4), "dag_event_fast"),
    ((3, 128, 4, 8192, 5), "dag_event_general"),
    ((3, 128, 4, 8192, 32), "dag_event_general"),
    ((3, 128, 4, 8192, 40), "dag_event_general"),
    ((32, 512, 31, (1 << 22) - 1, 31), "dag_event_fast"),
    ((32, 512, 31, (1 << 22) - 1, 32), "dag_event_general"),
]


@pytest.mark.parametrize("shape,want", DAG_DEPTH_EDGES)
def test_dag_event_route_by_the_deepest_lane(shape, want):
    from repro_torch.kernels.dag_event import ops

    *dims, depth = shape
    assert ops.route(*dims, depth=depth) == want


def test_dag_sim_launch_refuses_deep_lanes_on_the_fast_route():
    """The combined entry point refuses a fast launch over a lane deeper
    than the stage arrays (and past ``fits_fast``'s limits), as ``route``
    sends such a batch to the general route, before it launches
    anything."""
    src = (CSRC / "dag_event.cu").read_text()
    body = re.search(r'extern "C" int dag_sim_launch\([^)]*\) \{(.*?)\n\}',
                     src, re.S)[1]
    refuse, launch = body.index("fits_fast("), body.index("dag_streams_launch(")
    assert "depth > K" in body[refuse:launch]
    assert "cudaErrorInvalidValue" in body[refuse:launch]


def test_dag_tables_are_one_allocation_laid_out_as_the_kernel_writes_them():
    """``_table_views`` cuts (think0, st, td) from one buffer of 32-bit
    words at the offsets the C entry points use: st at 0, td at B*E words,
    think0 at 2*B*E, in both modes; ``dag_sim_launch`` hands the event
    loop the same offsets and its outputs follow the tables."""
    import torch

    from repro_torch.kernels.dag_event import ops

    B, H, E = 3, 5, 7
    buf = torch.arange(B * (2 * E + H), dtype=torch.float32)
    for replay in (False, True):
        think0, st, td = ops._table_views(buf, B, H, E, replay)
        assert (think0.shape, st.shape, td.shape) == ((B, H), (B, E), (B, E))
        assert st.dtype == (torch.int32 if replay else torch.float32)
        assert think0.dtype == td.dtype == torch.float32
        for x, at in ((st, 0), (td, B * E), (think0, 2 * B * E)):
            assert x.untyped_storage().data_ptr() == buf.data_ptr()
            assert x.storage_offset() == at and x.is_contiguous()
        assert torch.equal(st.view(torch.int32).flatten(),
                           buf[:B * E].view(torch.int32))
    streams = (CSRC / "dag_streams.cu").read_text()
    assert "unsigned* const td = tables + (size_t)B * E;" in streams
    assert "unsigned* const think0 = tables + 2 * (size_t)B * E;" in streams
    sim = (CSRC / "dag_event.cu").read_text()
    assert re.search(r"reinterpret_cast<const float\*>\(tables \+ 2 \* n\), "
                     r"tables,\s+reinterpret_cast<const float\*>\(tables \+ "
                     r"n\), samples, resp,\s+resp \+ lanes,", sim)


def _threefries(src: str, fn: str) -> int:
    body = re.search(rf"void {fn}\([^)]*\) \{{(.*?)\n\}}", src, re.S)[1]
    return len(re.findall(r"\b(?:derive|bits_at|threefry2x32)\(", body))


def test_dag_streams_threefries_per_event_match_the_bound():
    """The draw-table kernel's threefry calls per event, counted in its
    source (``exponential_event``, ``replay_event``), are the counts
    ``chip_smoke.py``'s bound charges (``DAG_THREEFRY_PER_EVENT``): 4 in
    exponential mode, 7 in replay mode; the lane keys come from shared
    memory, not from the per-event functions."""
    src = (CSRC / "dag_streams.cu").read_text()
    smoke = (CSRC.parents[2] / "chip_smoke.py").read_text()
    want = re.search(r"DAG_THREEFRY_PER_EVENT = \{False: (\d+), True: (\d+)\}",
                     smoke)
    got = (_threefries(src, "exponential_event"),
           _threefries(src, "replay_event"))
    assert got == (int(want[1]), int(want[2])) == (4, 7)
    kernel = re.search(r"dag_streams_kernel\((.*?)\n\}", src, re.S)[1]
    assert len(re.findall(r"\bderive\(0u, s, [01]u,", kernel)) == 2


def test_amva_frontier_entry_takes_the_scalars_by_value():
    """The AMVA frontier's C entry point takes a as a double and b, think
    and h as floats, and the frontier kernel divides a by nu * slots in
    float64 and rounds to float32, as the reference's host code does."""
    src = (CSRC / "amva.cu").read_text()
    proto = _prototypes()["amva_ps_frontier_launch"]
    assert proto[:7] == ["double a", "int slots", "int nu_lo", "int n",
                         "float b", "float z", "float h"]
    assert "__double2float_rn(__ddiv_rn(a, c))" in src
    assert "__dmul_rn((double)(nu_lo + i), (double)slots)" in src


def test_frontier_and_combined_wrappers_on_the_cpu():
    """``ps_frontier`` on the CPU takes the plain version and counts no
    launch; ``sim_batch`` on the CPU counts none either."""
    import torch

    from repro_torch.kernels.amva import ops as amva_ops
    from repro_torch.kernels.dag_event import ops

    before = amva_ops.ps_frontier.launches
    t = amva_ops.ps_frontier(2.0e6, 8, 20, 5, 9000.0, 1e4, 10.0,
                             device="cpu")
    assert t.shape == (5,) and amva_ops.ps_frontier.launches == before
    assert amva_ops.ps_frontier(2.0e6, 8, 20, 0, 9000.0, 1e4, 10.0,
                                device="cpu").shape == (0,)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    counts = (ops.dag_streams.launches, ops.dag_event.launches)
    mean, cnt = ops.sim_batch(i32([[3, 2]]), f32([[40.0, 60.0]]), i32([2]),
                              f32([500.0]), i32([2]), torch.tensor([3]),
                              i32([64]), None, h_users=2, max_slots=2,
                              n_events=64, warmup_jobs=0)
    assert cnt[0] > 0 and bool(torch.isfinite(mean).all())
    assert (ops.dag_streams.launches, ops.dag_event.launches) == counts
    with pytest.raises(ValueError, match="no dag_streams kernel"):
        ops.sim_batch(*(x.to("meta") for x in (
            i32([[3, 2]]), f32([[40.0, 60.0]]), i32([2]), f32([500.0]),
            i32([2]), torch.tensor([3]), i32([64]))), None, h_users=2,
            max_slots=2, n_events=64, warmup_jobs=0)
