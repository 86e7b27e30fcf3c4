"""stablelm-3b — dense, MHA (kv == heads).

[hf:stabilityai/stablelm-2-1_6b (family); unverified]  32L d_model=2560
32H (kv=32, head_dim=80) d_ff=6912 vocab=50304.  long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "stablelm-3b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=32,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_head=80,
        d_ff=6912,
        vocab_size=50304,
        activation="silu",
        rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name=ARCH_ID + "-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab_size=512,
    )
