"""Import the ported architecture configs (populates the registry).  The
reference's other archs are listed in `base.NOT_PORTED`."""
from . import (arctic_480b, falcon_mamba_7b, llama3_8b, minitron_4b,  # noqa: F401
               phi3_medium_14b, qwen2_72b, qwen2_vl_72b, qwen3_moe_30b_a3b)
