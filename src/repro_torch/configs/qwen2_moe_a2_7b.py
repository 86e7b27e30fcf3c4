"""qwen2-moe-a2.7b — 4 shared + 60 routed experts, top-4.

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]  24L d_model=2048 16H (GQA kv=16)
expert d_ff=1408 vocab=151936.  Pure full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

ARCH_ID = "qwen2-moe-a2.7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_head=128,
        d_ff=5632,                      # shared-expert hidden dim (4x1408)
        vocab_size=151936,
        activation="silu",
        rope_theta=1000000.0,
        moe=MoEConfig(
            n_experts=60,
            top_k=4,
            n_shared_experts=4,
            d_ff_expert=1408,
            d_ff_shared=5632,
            capacity_factor=1.25,
        ),
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name=ARCH_ID + "-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=96, vocab_size=512,
        moe=MoEConfig(n_experts=8, top_k=2, n_shared_experts=1,
                      d_ff_expert=48, d_ff_shared=96, capacity_factor=2.0),
    )
