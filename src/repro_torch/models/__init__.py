from .lm import LM
from .whisper import Whisper


def get_model(cfg, device="cuda"):
    """The model class for a config, its parameters allocated on `device`
    (not initialised: call `.init(seed)` or load weights)."""
    if cfg.family == "audio":
        return Whisper(cfg, device=device)
    return LM(cfg, device=device)


__all__ = ["LM", "Whisper", "get_model"]
