from .lm import LM


def get_model(cfg, device="cuda"):
    """The model class for a config, its parameters allocated on `device`
    (not initialised: call `.init(seed)` or load weights)."""
    if cfg.family == "audio":
        raise NotImplementedError("the audio family (Whisper) is not ported "
                                  "yet (ROADMAP.md, 'Modules to port')")
    return LM(cfg, device=device)


__all__ = ["LM", "get_model"]
