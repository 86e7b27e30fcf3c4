"""granite-3-2b — dense GQA baseline.

[hf:ibm-granite/granite-3.0-2b-base; hf]  40L d_model=2048 32H (GQA kv=8)
d_ff=8192 vocab=49155.  Pure full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "granite-3-2b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=40,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        d_head=64,
        d_ff=8192,
        vocab_size=49155,
        activation="silu",
        rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name=ARCH_ID + "-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=512,
    )
