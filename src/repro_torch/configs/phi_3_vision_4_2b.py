"""phi-3-vision-4.2b — phi3-mini backbone + CLIP frontend STUB.

[hf:microsoft/Phi-3-vision-128k-instruct; hf]  32L d_model=3072 32H
(kv=32, head_dim=96) d_ff=8192 vocab=32064.  The vision tower is a stub:
``input_specs()`` provides precomputed patch embeddings (B, n_patch,
d_model) that are prepended to the token embeddings (early fusion).
long_500k skipped (full attention).
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "phi-3-vision-4.2b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="vlm",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_head=96,
        d_ff=8192,
        vocab_size=32064,
        activation="silu",
        rope_theta=10000.0,
        frontend="patches",
        frontend_len=576,               # 24x24 CLIP patch grid
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name=ARCH_ID + "-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab_size=512, frontend_len=8,
    )
