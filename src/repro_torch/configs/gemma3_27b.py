"""gemma3-27b — dense, 5:1 local:global attention, 128k context.

[hf:google/gemma-3-1b-pt (family); unverified]  62L d_model=5376 32H
(GQA kv=16, head_dim=128) d_ff=21504 vocab=262144, sliding window 1024.
Mostly-local attention -> long_500k RUNS (51/62 layers are O(S*w);
global layers at decode are O(S) per token).
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "gemma3-27b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=62,                    # 10 groups of (5 local + 1 global) + 2 local tail
        d_model=5376,
        n_heads=32,
        n_kv_heads=16,
        d_head=128,
        d_ff=21504,
        vocab_size=262144,
        activation="gelu",
        local_window=1024,
        local_global_ratio=5,
        rope_theta=1000000.0,
        # bf16 params + 8-bit Adam (fp32 master): halves the FSDP weight
        # all-gather traffic that dominates the train_4k collective term
        # (measured 473 GB/step/device with f32 params)
        param_dtype="bfloat16",
        optimizer_mode="8bit",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name=ARCH_ID + "-smoke",
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=512, local_window=8, local_global_ratio=2,
        param_dtype="float32", optimizer_mode="fp32",
    )
