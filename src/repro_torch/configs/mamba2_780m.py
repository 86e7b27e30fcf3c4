"""mamba2-780m — attention-free SSD (state-space duality).

[arXiv:2405.21060; unverified]  48L d_model=1536 vocab=50280 ssm_state=128.
Sub-quadratic: all four shape cells run, including long_500k.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

ARCH_ID = "mamba2-780m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="ssm",
        n_layers=48,
        d_model=1536,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, d_conv=4, chunk=128),
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name=ARCH_ID + "-smoke",
        n_layers=2, d_model=64, vocab_size=512,
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, d_conv=4, chunk=16),
    )
