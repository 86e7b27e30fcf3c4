"""nemotron-4-340b — dense, GQA, squared-ReLU MLP.  The memory stress case.

[arXiv:2402.16819; unverified]  96L d_model=18432 96H (GQA kv=8,
head_dim=192) d_ff=73728 vocab=256000.  340B params -> bf16 params +
8-bit optimizer states so the FSDP shards fit v5e HBM.  Pure full
attention -> long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "nemotron-4-340b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=96,
        d_model=18432,
        n_heads=96,
        n_kv_heads=8,
        d_head=192,
        d_ff=73728,
        vocab_size=256000,
        activation="relu2",             # squared ReLU
        gated_mlp=False,
        rope_theta=10000.0,
        param_dtype="bfloat16",
        optimizer_mode="8bit",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name=ARCH_ID + "-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=256, vocab_size=512,
        param_dtype="float32", optimizer_mode="fp32",
    )
