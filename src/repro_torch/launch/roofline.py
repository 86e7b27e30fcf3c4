"""Roofline analysis of a dry-run record, the reference's
``launch/roofline``.

Per (arch x shape x mesh) cell of a TPU dry-run record
(``results/dryrun.json``, written by the reference's multi-device dry
run), derive:

    compute term    = HLO_FLOPs_per_device / peak_FLOP/s        [s]
    memory term     = HLO_bytes_per_device / HBM_bw             [s]
    collective term = collective_bytes_per_device / link_bw     [s]

and MODEL_FLOPS = 6 N_active D (train) | 2 N_active D (prefill/decode),
useful-compute ratio = MODEL_FLOPS/chips / HLO_FLOPs_per_device.

``PEAK_FLOPS``, ``HBM_BW`` and ``ICI_BW`` are the TPU v5e deploy target's
figures (197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s a link of ICI): they
grade a TPU record against the TPU it was compiled for, and are the
planner's input data, not a property of the device this package runs on.
Everything here is host arithmetic in float64; nothing runs on a device.

The same grading applies to the measured QN/AMVA kernel record
(``launch/qn_record``): ``analyze_qn_file`` turns it into
``KernelRooflineRow``s.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from typing import List, Optional

PEAK_FLOPS = 197e12
HBM_BW = 819e9
ICI_BW = 50e9


def active_param_count(cfg) -> float:
    """Per-token active parameters (MoE counts shared + top_k experts)."""
    from repro_torch.distributed.sharding import param_count
    from repro_torch.models import api

    total = param_count(api.param_specs(cfg))
    if cfg.moe is None:
        return float(total)
    m = cfg.moe
    wi_cols = 2 if cfg.gated_mlp else 1
    per_expert = cfg.d_model * m.d_ff_expert * (wi_cols + 1)
    n_moe_layers = cfg.n_layers // max(cfg.moe_every, 1)
    inactive = per_expert * (m.n_experts - m.top_k) * n_moe_layers
    return float(total - inactive)


def model_flops(cfg, shape) -> float:
    """Global model FLOPs of one step (6ND train / 2ND inference)."""
    n_active = active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch * 1          # one new token per sequence
    return 2.0 * n_active * tokens


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    t_compute_s: float
    t_memory_s: float               # analytic (the TPU kernels; see below)
    t_collective_s: float
    bottleneck: str
    roofline_fraction: float        # compute term / dominant term
    model_flops: float
    hlo_flops_per_dev: float
    useful_ratio: float             # model_flops/chips / hlo_flops_per_dev
    t_memory_hlo_s: float = 0.0     # the HLO parse's traffic (diagnostic)
    note: str = ""

    def as_dict(self):
        return asdict(self)


def analytic_memory_bytes(cfg, shape, chips: int) -> float:
    """First-principles per-device HBM traffic of one step on the TPU
    target, where the attention and SSD kernels keep their block
    temporaries on chip (the HLO parse counts them, so it overestimates
    the deployed path; it stays a diagnostic in ``t_memory_hlo_s``).

      train:   3x gathered weights (fwd+bwd+refwd reads)
               + grads r/w + opt m,v (+master) r/w on the local shard
               + residual-carry save/restore (+1 recompute read)
               + KV write+read per attention layer + logits r/w (f32)
      prefill: 1x weights read + activations write/read + KV cache write
      decode:  1x weights read + KV cache read (+ ring write)
    """
    from repro_torch.distributed.sharding import param_count
    from repro_torch.models import api

    P = param_count(api.param_specs(cfg))
    pbytes = 2.0 if cfg.param_dtype == "bfloat16" else 4.0
    model_shards = 16 if chips >= 256 else max(1, chips)
    data_shards = max(1, chips // model_shards)
    D = cfg.d_model
    tokens = shape.global_batch * shape.seq_len
    tokens_dev = tokens / chips                  # batch x seq sharded (SP)
    L = cfg.n_layers
    kv_dim = cfg.kv_dim if cfg.n_kv_heads else 0
    n_attn = sum(1 for k in cfg.layer_kinds() if k != "mamba") * max(
        cfg.n_groups, 1)
    vocab_dev = cfg.padded_vocab / model_shards

    if shape.kind == "train":
        opt_bytes = {"fp32": 8.0, "8bit": 6.0}.get(cfg.optimizer_mode, 8.0)
        w = 3.0 * P * pbytes / model_shards          # gathered reads
        g_opt = P / chips * (8.0 + 2.0 * opt_bytes)  # grads + moments r/w
        acts = 3.0 * L * tokens_dev * D * 2.0        # carry w+r+recompute
        kv = 4.0 * n_attn * tokens_dev * kv_dim * 2.0
        logits = 3.0 * tokens_dev * vocab_dev * 4.0
        return w + g_opt + acts + kv + logits
    if shape.kind == "prefill":
        w = P * pbytes / model_shards
        acts = 2.0 * L * tokens_dev * D * 2.0
        kv = 2.0 * n_attn * tokens_dev * kv_dim * 2.0
        logits = shape.global_batch / chips * vocab_dev * 4.0
        return w + acts + kv + logits
    # decode: read all weights once + read the KV cache once
    w = P * pbytes / model_shards
    cache_tokens_dev = shape.global_batch * shape.seq_len / chips
    kv = 2.0 * n_attn * cache_tokens_dev * kv_dim * 2.0
    if cfg.family in ("ssm",):
        kv = L * shape.global_batch / data_shards * 4e5
    return w + kv


def analyze_record(rec: dict) -> Optional[RooflineRow]:
    from repro_torch.configs.registry import get_config, get_shape

    if "error" in rec or not rec.get("supported"):
        return None
    ca = rec.get("cost_analysis", {})
    if "flops" not in ca:
        return None
    cfg = get_config(rec["arch"])
    shape = get_shape(rec["shape"])
    chips = rec.get("n_devices", 256)

    # the trip-count-aware parse first (a cost analysis counts a scan's
    # body once), else the raw cost analysis
    flops = rec.get("parsed_flops_per_dev") or ca["flops"]
    bytes_hlo = rec.get("parsed_bytes_per_dev") or ca["bytes_accessed"]
    t_comp = flops / PEAK_FLOPS
    t_mem_hlo = bytes_hlo / HBM_BW
    # the memory term of the deployed path: the analytic model, capped by
    # the HLO parse
    t_mem = min(analytic_memory_bytes(cfg, shape, chips) / HBM_BW, t_mem_hlo)
    t_coll = sum(rec["collective_bytes"].values()) / ICI_BW
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    bottleneck = max(terms, key=terms.get)
    dom = terms[bottleneck]
    mf = model_flops(cfg, shape)
    useful = (mf / chips) / max(flops, 1e-30)
    frac = t_comp / max(dom, 1e-30)
    note = _suggestion(bottleneck, useful, rec)
    return RooflineRow(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        t_compute_s=t_comp, t_memory_s=t_mem, t_collective_s=t_coll,
        bottleneck=bottleneck, roofline_fraction=frac,
        model_flops=mf, hlo_flops_per_dev=flops,
        useful_ratio=useful, t_memory_hlo_s=t_mem_hlo, note=note)


def _suggestion(bottleneck: str, useful: float, rec: dict) -> str:
    if bottleneck == "collective":
        big = max(rec["collective_bytes"], key=rec["collective_bytes"].get)
        return (f"dominant collective is {big}; reduce via sharding that "
                f"keeps the contraction local or int8-compressed reduction")
    if bottleneck == "memory":
        return ("HBM-bound: raise arithmetic intensity (fuse, bigger "
                "per-chip batch, bf16 activations end-to-end)")
    if useful < 0.5:
        return ("compute-bound but <50% useful FLOPs: cut remat recompute "
                "or masked-block waste (block-sparse attention schedule)")
    return "compute-bound; near roofline for this shape"


@dataclass
class KernelRooflineRow:
    """Roofline view of one measured planner-kernel cell of the QN record
    (``launch/qn_record``).  ``throughput`` is events/s for the simulator
    cells and candidates/s for AMVA; ``peak_fraction`` is the achieved
    FLOP/s as a share of ``PEAK_FLOPS`` (0 where the record has no cost
    analysis, as the port's records do)."""
    cell: str
    impl: str
    batch: int
    wall_s: float
    throughput: float
    unit: str
    flops: float
    bytes_accessed: float
    flop_per_byte: float
    achieved_flops: float
    peak_fraction: float
    parity_bit_exact: Optional[bool]

    def as_dict(self):
        return asdict(self)


def analyze_kernel_record(rec: dict) -> Optional[KernelRooflineRow]:
    if rec.get("cell") not in ("qn_event", "amva_ps"):
        return None
    ca = rec.get("cost_analysis", {})
    flops = float(ca.get("flops", 0.0))
    nbytes = float(ca.get("bytes_accessed", 0.0))
    wall = float(rec["wall_s"])
    if rec["cell"] == "qn_event":
        throughput, unit = rec["events_per_s"], "events/s"
    else:
        throughput, unit = rec["candidates_per_s"], "candidates/s"
    achieved = flops / wall if wall > 0 else 0.0
    return KernelRooflineRow(
        cell=rec["cell"], impl=rec["impl"], batch=int(rec["batch"]),
        wall_s=wall, throughput=float(throughput), unit=unit,
        flops=flops, bytes_accessed=nbytes,
        flop_per_byte=flops / nbytes if nbytes > 0 else 0.0,
        achieved_flops=achieved, peak_fraction=achieved / PEAK_FLOPS,
        parity_bit_exact=rec.get("parity_bit_exact"))


def analyze_qn_file(path: str = "results/dryrun_qn_torch.json",
                    ) -> List[KernelRooflineRow]:
    recs = json.loads(open(path).read())
    rows = [analyze_kernel_record(r) for r in recs]
    return [r for r in rows if r is not None]


def format_kernel_table(rows: List[KernelRooflineRow]) -> str:
    hdr = (f"{'cell':10s} {'impl':7s} {'batch':>6s} {'wall(ms)':>9s} "
           f"{'throughput':>12s} {'unit':12s} {'F/B':>6s} {'parity':>7s}")
    lines = [hdr, "-" * len(hdr)]
    for r in sorted(rows, key=lambda r: (r.cell, r.batch, r.impl)):
        parity = "-" if r.parity_bit_exact is None else str(r.parity_bit_exact)
        lines.append(
            f"{r.cell:10s} {r.impl:7s} {r.batch:6d} {r.wall_s*1e3:9.2f} "
            f"{r.throughput:12.3e} {r.unit:12s} {r.flop_per_byte:6.2f} "
            f"{parity:>7s}")
    return "\n".join(lines)


def analyze_file(path: str = "results/dryrun.json") -> List[RooflineRow]:
    recs = json.loads(open(path).read())
    rows = [analyze_record(r) for r in recs]
    return [r for r in rows if r is not None]


def format_table(rows: List[RooflineRow]) -> str:
    hdr = (f"{'arch':24s} {'shape':12s} {'mesh':8s} "
           f"{'t_comp(ms)':>10s} {'t_mem(ms)':>10s} {'t_coll(ms)':>10s} "
           f"{'bound':>10s} {'frac':>6s} {'useful':>7s}")
    lines = [hdr, "-" * len(hdr)]
    for r in sorted(rows, key=lambda r: (r.mesh, r.arch, r.shape)):
        lines.append(
            f"{r.arch:24s} {r.shape:12s} {r.mesh:8s} "
            f"{r.t_compute_s*1e3:10.2f} {r.t_memory_s*1e3:10.2f} "
            f"{r.t_collective_s*1e3:10.2f} {r.bottleneck:>10s} "
            f"{r.roofline_fraction:6.2f} {r.useful_ratio:7.2f}")
    return "\n".join(lines)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default="results/dryrun.json")
    ap.add_argument("--out", default="results/roofline_torch.json")
    args = ap.parse_args(argv)
    rows = analyze_file(args.dryrun)
    print(format_table(rows))
    with open(args.out, "w") as f:
        json.dump([r.as_dict() for r in rows], f, indent=1)
    print(f"\n{len(rows)} cells -> {args.out}")
    return rows


if __name__ == "__main__":
    main()
