"""Import the ported architecture configs (populates the registry).  The
reference's other archs are listed in `base.NOT_PORTED`."""
from . import falcon_mamba_7b, llama3_8b  # noqa: F401
