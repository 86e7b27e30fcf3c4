"""Architecture registry: ``--arch <id>`` resolution for every launcher."""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

from repro_torch.configs import (
    gemma3_27b,
    granite_3_2b,
    llama4_scout_17b_a16e,
    mamba2_780m,
    nemotron_4_340b,
    phi_3_vision_4_2b,
    qwen2_moe_a2_7b,
    stablelm_3b,
    whisper_tiny,
    zamba2_7b,
)
from repro_torch.configs.base import (
    SHAPES,
    SHAPES_BY_NAME,
    ModelConfig,
    ShapeConfig,
    cell_supported,
)

_MODULES = (
    llama4_scout_17b_a16e,
    qwen2_moe_a2_7b,
    mamba2_780m,
    gemma3_27b,
    nemotron_4_340b,
    granite_3_2b,
    stablelm_3b,
    zamba2_7b,
    phi_3_vision_4_2b,
    whisper_tiny,
)

ARCHS: Dict[str, Callable[[], ModelConfig]] = {
    m.ARCH_ID: m.config for m in _MODULES
}
SMOKE_ARCHS: Dict[str, Callable[[], ModelConfig]] = {
    m.ARCH_ID: m.smoke_config for m in _MODULES
}
ARCH_IDS: Tuple[str, ...] = tuple(ARCHS)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    cfg = ARCHS[arch_id]()
    cfg.validate()
    return cfg


def get_smoke_config(arch_id: str) -> ModelConfig:
    cfg = SMOKE_ARCHS[arch_id]()
    cfg.validate()
    return cfg


def get_shape(shape_name: str) -> ShapeConfig:
    if shape_name not in SHAPES_BY_NAME:
        raise KeyError(
            f"unknown shape {shape_name!r}; known: {sorted(SHAPES_BY_NAME)}")
    return SHAPES_BY_NAME[shape_name]


def all_cells(include_skipped: bool = False) -> List[Tuple[str, str, bool, str]]:
    """All 40 (arch x shape) cells as (arch_id, shape_name, supported, reason)."""
    cells = []
    for arch_id in ARCH_IDS:
        cfg = get_config(arch_id)
        for shape in SHAPES:
            ok, reason = cell_supported(cfg, shape)
            if ok or include_skipped:
                cells.append((arch_id, shape.name, ok, reason))
    return cells
