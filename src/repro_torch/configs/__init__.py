from .base import (ModelConfig, ShapeConfig, SHAPES, get_config, list_archs,
                   register, smoke_config)

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "get_config", "list_archs",
           "register", "smoke_config"]
