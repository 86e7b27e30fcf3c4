from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    MoEConfig,
    SSMConfig,
    ShapeConfig,
    SHAPES,
    SHAPES_BY_NAME,
    cell_supported,
    sub_quadratic,
)
