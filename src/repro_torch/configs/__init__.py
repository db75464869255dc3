from repro_torch.configs.base import (
    INPUT_SHAPES,
    LONG_CONTEXT_WINDOW,
    InputShape,
    ModelConfig,
    for_shape,
    get_config,
    get_tiny_config,
    list_archs,
)

__all__ = [
    "INPUT_SHAPES",
    "LONG_CONTEXT_WINDOW",
    "InputShape",
    "ModelConfig",
    "for_shape",
    "get_config",
    "get_tiny_config",
    "list_archs",
]
