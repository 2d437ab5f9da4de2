#!/usr/bin/env python3
"""Time model prefills with the flash forward's wgmma route against the
same prefills with that route's launches sent to the mma.sync kernel.

    python3 tools/flash_route_ab.py [--reps N]

Run from the root of a checkout on a machine with a CUDA card.  For
whisper-tiny (4 requests of 1500 stub frames and 300 tokens) and
recurrentgemma-2b (one prompt of 300 and of 2048 tokens), full size,
random weights from seed 0, `make_prefill_step` is timed with
`kernels/flash_attention.py::_route` as it is and with its "wgmma"
answers turned into "mma", in turns (route, mma.sync, mma.sync, route):
the median wall ms of each turn, then one call of each under
torch.profiler: the device's busy ms and the flash kernels' device ms.
Prints the card, then one line a prefill.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from chip_smoke import card_line  # noqa: E402

CASES = (("whisper-tiny", 4, 300), ("recurrentgemma-2b", 1, 300),
         ("recurrentgemma-2b", 1, 2048))


def _wall_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    return sorted(ts)[len(ts) // 2]


def _device_ms(torch, fn):
    """(busy ms, {flash kernel: ms}) of one call under torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [(e.key, e.device_time_total / 1e3) for e in prof.key_averages()
          if e.device_time_total > 0]
    return (sum(t for _, t in ev),
            {k[:60]: t for k, t in ev if "flash" in k})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("flash_route_ab.py: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.serve import make_prefill_step
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    route = fa._route

    def mma_route(dtype, hd, sq):
        r = route(dtype, hd, sq)
        return "mma" if r == "wgmma" else r

    print(card_line(), flush=True)
    for arch, b, prompt in CASES:
        cfg = get_config(arch)
        model = get_model(cfg).init(0)
        rng = np.random.default_rng(0)
        batch = {"tokens": torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (b, prompt)).astype(np.int32), device="cuda")}
        if cfg.family == "audio":
            batch["frames"] = torch.as_tensor(rng.standard_normal(
                (b, cfg.enc_seq, cfg.d_model)).astype(np.float32),
                device="cuda")
        prefill = make_prefill_step(cfg, prompt + 32)
        rec = {"prefill": f"{arch} {b} x {prompt}", "wall_ms": {}}
        try:
            for which in ("route", "mma.sync", "mma.sync", "route"):
                fa._route = route if which == "route" else mma_route
                rec["wall_ms"].setdefault(which, []).append(
                    _wall_ms(torch, lambda: prefill(model, batch), args.reps))
            for which in ("route", "mma.sync"):
                fa._route = route if which == "route" else mma_route
                busy, flash = _device_ms(torch, lambda: prefill(model, batch))
                rec[f"busy_ms {which}"] = busy
                rec[f"flash_ms {which}"] = flash
        finally:
            fa._route = route
        print(json.dumps(rec), flush=True)
        del model
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
