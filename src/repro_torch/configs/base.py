"""Model / workload configuration dataclasses.

One ``ModelConfig`` describes any architecture in the assigned pool: dense
decoder LMs, MoE, Mamba2 (SSD), Zamba2-style hybrids, enc-dec (whisper) and
modality-stubbed backbones (vlm/audio).  Configs are plain frozen dataclasses
so they can be hashed into jit static args.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0            # routed experts
    top_k: int = 1
    n_shared_experts: int = 0     # always-on experts (qwen2-moe style)
    d_ff_expert: int = 0          # hidden dim of each routed expert
    d_ff_shared: int = 0          # hidden dim of the shared expert block
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD block configuration."""
    d_state: int = 128
    head_dim: int = 64            # SSD head dim (P)
    expand: int = 2               # d_inner = expand * d_model
    d_conv: int = 4               # causal depthwise conv width
    chunk: int = 128              # SSD chunk length (Q)
    dt_min: float = 0.001
    dt_max: float = 0.1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0               # 0 -> d_model // n_heads
    activation: str = "silu"      # silu | gelu | relu2
    # --- attention pattern -------------------------------------------------
    local_window: int = 0         # sliding-window size for local layers
    local_global_ratio: int = 0   # e.g. 5 -> repeating [5 local, 1 global]
    rope_theta: float = 10000.0
    gated_mlp: bool = True        # SwiGLU/GeGLU when True, plain MLP when False
    # --- MoE ---------------------------------------------------------------
    moe: Optional[MoEConfig] = None
    moe_every: int = 1            # apply MoE in every k-th layer (1 = all)
    # --- SSM / hybrid ------------------------------------------------------
    ssm: Optional[SSMConfig] = None
    # hybrid: repeating unit = `hybrid_mamba_per_attn` mamba blocks followed by
    # one attention block; if `shared_attn` the attention params are reused
    # across all applications (Zamba2 trick).
    hybrid_mamba_per_attn: int = 0
    shared_attn: bool = False
    # --- enc-dec -----------------------------------------------------------
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    # --- modality frontend stub --------------------------------------------
    frontend: str = "none"        # none | patches | frames
    frontend_len: int = 0         # number of patch/frame embeddings
    # --- numerics / memory --------------------------------------------------
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"       # activation/compute dtype
    param_dtype: str = "float32"  # stored parameter dtype
    optimizer_mode: str = "fp32"  # fp32 | 8bit  (see repro.optim)
    remat: bool = True
    # "nothing": recompute everything (min memory, recomputes the TP
    # collectives too); "proj_outs": save attention/MLP projection outputs
    # so the backward recompute skips the all-reduce/reduce-scatters
    # (~44 MB/layer on gemma3; collective traffic -1/3)
    remat_policy: str = "proj_outs"
    logits_softcap: float = 0.0
    tie_embeddings: bool = True
    # scan grouping: number of layers folded into one scan step.  Derived
    # automatically for local:global and hybrid patterns.
    scan_unroll: int = 1

    # embedding tables are padded to this multiple so the vocab dim shards
    # cleanly over the model axis (Megatron practice); padded logits are
    # masked to -inf before softmax/sampling.
    vocab_pad_to: int = 512

    # ------------------------------------------------------------------ api
    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def group_size(self) -> int:
        """Number of layers in one repeating scan unit."""
        if self.family in ("ssm",):
            return 1
        if self.hybrid_mamba_per_attn:
            return self.hybrid_mamba_per_attn + 1
        if self.local_global_ratio:
            return self.local_global_ratio + 1
        return 1

    @property
    def n_groups(self) -> int:
        return self.n_layers // self.group_size

    @property
    def n_tail_layers(self) -> int:
        """Layers that do not fit an integer number of groups (run unscanned)."""
        return self.n_layers - self.n_groups * self.group_size

    def layer_kinds(self) -> Tuple[str, ...]:
        """Kind of each layer inside one repeating group.

        Returns a tuple like ('local', 'local', ..., 'global') or
        ('mamba', 'mamba', 'attn').
        """
        if self.family == "ssm":
            return ("mamba",)
        if self.hybrid_mamba_per_attn:
            return ("mamba",) * self.hybrid_mamba_per_attn + ("attn",)
        if self.local_global_ratio:
            return ("local",) * self.local_global_ratio + ("global",)
        return ("global",)

    def all_layer_kinds(self) -> Tuple[str, ...]:
        """Kind of every layer, in order: the groups, then the tail."""
        kinds = self.layer_kinds()
        return kinds * self.n_groups + kinds[: self.n_tail_layers]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        assert self.d_model > 0 and self.n_layers > 0
        if self.family != "ssm":
            assert self.n_heads % max(self.n_kv_heads, 1) == 0, (
                f"{self.name}: n_heads {self.n_heads} not divisible by "
                f"n_kv_heads {self.n_kv_heads}")
        if self.moe is not None:
            assert self.moe.n_experts > 0 and self.moe.top_k >= 1
        if self.hybrid_mamba_per_attn or self.family == "ssm":
            assert self.ssm is not None
        if self.local_global_ratio:
            assert self.local_window > 0


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode
    # decode shapes: KV cache length == seq_len, one new token generated.


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", seq_len=4096, global_batch=256, kind="train"),
    ShapeConfig("prefill_32k", seq_len=32768, global_batch=32, kind="prefill"),
    ShapeConfig("decode_32k", seq_len=32768, global_batch=128, kind="decode"),
    ShapeConfig("long_500k", seq_len=524288, global_batch=1, kind="decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def sub_quadratic(cfg: ModelConfig) -> bool:
    """True when the architecture supports the 500k-token decode cell.

    SSM / hybrid archs and mostly-local-attention archs qualify; pure
    full-attention archs are skipped per the assignment brief (recorded in
    DESIGN.md §Arch-applicability).
    """
    if cfg.family in ("ssm", "hybrid"):
        return True
    if cfg.local_global_ratio >= 4:  # e.g. gemma3 5:1 local:global
        return True
    return False


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch x shape) is a runnable cell; returns (ok, reason)."""
    if shape.name == "long_500k" and not sub_quadratic(cfg):
        return False, "pure full-attention arch: long_500k skipped (DESIGN.md)"
    return True, ""
