"""Import all architecture configs (populates the registry)."""
from . import (arctic_480b, falcon_mamba_7b, llama3_8b, minitron_4b,  # noqa: F401
               phi3_medium_14b, qwen2_72b, qwen2_vl_72b, qwen3_moe_30b_a3b,
               recurrentgemma_2b, whisper_tiny)
from .base import (ModelConfig, ShapeConfig, SHAPES, get_config, list_archs,
                   register, smoke_config)

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "get_config", "list_archs",
           "register", "smoke_config"]
