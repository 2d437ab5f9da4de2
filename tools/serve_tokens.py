#!/usr/bin/env python3
"""The tokens that chip_smoke.py's phase 4 serves, from one tree's sources.

    python3 tools/serve_tokens.py [--tree DIR] [--seed N]

Imports `repro_torch` from DIR/src (the checkout's own by default) and
serves phase 4's models and requests through `ServeEngine` (DIR's default
path: its compiled steps where DIR has `serve/graph.py`), then
whisper-tiny's batch through DIR's serving steps (graphed where DIR has
them), with phase 4's own constants, depth cuts, prompts, audio batch and
digest (imported from this checkout's chip_smoke.py): full width, random
weights from --seed.  An arch that DIR's `get_config` does not know is
reported as not in that tree, so that an earlier tree's digests still
print.  Prints one JSON line: each model's tokens' crc32 and count, as
phase 4's `[serve] ... crc32` lines.  Run it for two trees (a parent
unpacked by `git archive` into the git-ignored `.checkout/`, and the
checkout) in separate processes on the same card to show that a change
left the served tokens as they were.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as smoke  # noqa: E402  (phase 4's constants and prompts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=ROOT)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.tree.resolve() / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("serve_tokens.py: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.serve import ServeEngine
    out = {"tree": str(args.tree), "device": torch.cuda.get_device_name(0)}
    for arch in smoke.SERVE_ARCHS:
        try:
            cfg = smoke.serve_config(get_config, arch)
        except KeyError:           # an arch the other tree does not serve
            out[arch] = "not in this tree"
            continue
        model = get_model(cfg).init(args.seed)
        eng = ServeEngine(cfg, model, slots=smoke.SERVE_SLOTS,
                          max_seq=smoke.serve_max_seq(arch))
        reqs = [eng.submit(p, smoke.SERVE_MAX_NEW)
                for p in smoke.serve_prompts(np, cfg, args.seed)]
        eng.run()
        n, crc = smoke.served_digest(np, reqs)
        out[arch] = {"tokens": n, "crc32": crc}
        del model, eng
        torch.cuda.empty_cache()
    import zlib

    from repro_torch import serve
    cfg = get_config(smoke.AUDIO_ARCH)
    model = get_model(cfg).init(args.seed)
    max_seq = smoke.AUDIO_PROMPT + smoke.SERVE_MAX_NEW
    prefill = serve.make_prefill_step(cfg, max_seq)
    decode = serve.make_decode_step(cfg)
    if hasattr(serve, "graphed_prefill"):
        prefill = serve.graphed_prefill(prefill)
        decode = serve.graphed_decode(decode)
    toks, _ = smoke.serve_audio(torch, model,
                                smoke.audio_batch(torch, np, cfg, args.seed),
                                prefill, decode)
    out[smoke.AUDIO_ARCH] = {
        "tokens": int(toks.size),
        "crc32": zlib.crc32(toks.astype(np.int64).tobytes()) & 0xFFFFFFFF}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
