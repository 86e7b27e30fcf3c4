"""llama4-scout-17b-a16e — MoE, 16 routed experts top-1 + 1 shared expert.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]  48L d_model=5120 40H
(GQA kv=8) expert d_ff=8192 vocab=202048.  Text backbone only (early-fusion
frontend out of scope per the assignment).  The assigned spec lists plain
full attention, so long_500k is skipped (DESIGN.md §Arch-applicability).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

ARCH_ID = "llama4-scout-17b-a16e"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_head=128,
        d_ff=8192,                      # shared-expert hidden dim
        vocab_size=202048,
        activation="silu",
        rope_theta=500000.0,
        moe=MoEConfig(
            n_experts=16,
            top_k=1,
            n_shared_experts=1,
            d_ff_expert=8192,
            d_ff_shared=8192,
            capacity_factor=1.25,
        ),
        param_dtype="bfloat16",        # 109B total params -> 8-bit optimizer
        optimizer_mode="8bit",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name=ARCH_ID + "-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=96, vocab_size=512,
        moe=MoEConfig(n_experts=4, top_k=1, n_shared_experts=1,
                      d_ff_expert=96, d_ff_shared=96, capacity_factor=2.0),
        param_dtype="float32", optimizer_mode="fp32",
    )
