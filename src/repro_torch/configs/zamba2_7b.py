"""zamba2-7b — hybrid: Mamba2 backbone + SHARED attention block.

[arXiv:2411.15242; unverified]  81L d_model=3584 32H (kv=32) d_ff=14336
vocab=32000 ssm_state=64.  Repeating unit: 2 Mamba2 blocks + 1 attention
block whose parameters are REUSED across all 27 applications (the Zamba
weight-sharing trick).  Hybrid -> long_500k RUNS.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

ARCH_ID = "zamba2-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="hybrid",
        n_layers=81,                    # 27 x (2 mamba + 1 shared attn)
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        d_head=112,
        d_ff=14336,
        vocab_size=32000,
        activation="silu",
        rope_theta=10000.0,
        ssm=SSMConfig(d_state=64, head_dim=64, expand=2, d_conv=4, chunk=128),
        hybrid_mamba_per_attn=2,
        shared_attn=True,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name=ARCH_ID + "-smoke",
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab_size=512,
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, d_conv=4, chunk=16),
    )
