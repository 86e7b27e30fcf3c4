"""whisper-tiny — encoder-decoder, conv audio frontend STUB.

[arXiv:2212.04356; unverified]  4L (enc) + 4L (dec) d_model=384 6H
(kv=6, head_dim=64) d_ff=1536 vocab=51865.  The mel/conv frontend is a
stub: ``input_specs()`` provides precomputed frame embeddings
(B, frames, d_model).  Decode cells lower the decoder step (self-KV +
cross-KV over encoder frames).  long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "whisper-tiny"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="audio",
        n_layers=4,                     # decoder layers
        n_enc_layers=4,
        is_encoder_decoder=True,
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        d_head=64,
        d_ff=1536,
        vocab_size=51865,
        activation="gelu",
        gated_mlp=False,
        rope_theta=10000.0,
        frontend="frames",
        frontend_len=1500,              # 30 s audio -> 1500 frames
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name=ARCH_ID + "-smoke",
        n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_head=16, d_ff=128, vocab_size=512, frontend_len=8,
    )
