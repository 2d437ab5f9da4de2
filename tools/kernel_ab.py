#!/usr/bin/env python3
"""Time a backward kernel's source against edited copies of it, on the card.

    python3 tools/kernel_ab.py NAME [DIR ...] [--reps N]

Run from the root of a checkout on a machine with a CUDA card.  NAME is
`flash_attention_bwd` or `selective_scan_bwd`.  Each DIR is a copy of
src/repro_torch/kernels/csrc in which that source was edited (another
layout or design to compare: edit the copy, never the package); the
package's own csrc comes first.  Every library is built with the
package's nvcc line and served to the same wrapper in turn: at phase 8's
shape (flash [128, 2048, 128] bf16 causal, the scan [4, 2048, 8192, 16]
with bf16 x, the inputs of chip_smoke.py's phase 2) each is held against
the plain version with phase 2's tolerances and launched twice for its
bits, then all are timed by CUDA events in turns (first to last, then
last to first), and one call of each is traced with torch.profiler for
its launches' device times.  Prints the card, then one JSON line per
library; exits 1 if one disagrees with the plain version.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from chip_smoke import card_line, time_ms  # noqa: E402


def _flash(torch, g):
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain)
    q, k, v, do = (torch.randn(128, 2048, 128, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True)
    return (lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=True),
            want, dict(dq=2e-2, dk=2e-2, dv=2e-2))


def _scan(torch, g):
    scan = importlib.import_module("repro_torch.kernels.selective_scan")
    b, s, d, n = 4, 2048, 8192, 16
    dt = torch.nn.functional.softplus(
        torch.rand(b, s, d, generator=g, device="cuda") * 4 - 6)
    A = -torch.arange(1, n + 1, device="cuda", dtype=torch.float32).repeat(
        d, 1) * (0.5 + torch.rand(d, 1, generator=g, device="cuda"))
    Bm, Cm = (torch.randn(b, s, n, generator=g, device="cuda")
              for _ in range(2))
    x = torch.randn(b, s, d, generator=g, device="cuda").to(torch.bfloat16)
    dy = torch.randn(b, s, d, generator=g, device="cuda")
    _, _, states = scan._fused_launch(dt, A, Bm, Cm, x, None, True, True)
    want = scan.selective_scan_fused_bwd_plain(dt, A, Bm, Cm, x, None, dy)
    tols = dict(ddt=1e-4, dA=1e-4, dBm=1e-4, dCm=1e-4, dx=8e-3, dh0=1e-4)
    return (lambda: scan.selective_scan_fused_bwd(dt, A, Bm, Cm, x, None, dy,
                                                  states=states),
            want, tols)


CASES = {"flash_attention_bwd": _flash, "selective_scan_bwd": _scan}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("name", choices=sorted(CASES))
    ap.add_argument("dirs", nargs="*", type=Path)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    import torch
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("kernel_ab.py: no CUDA device", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    srcs = [_build.CSRC, *args.dirs]
    libs = [_build.load(args.name, d) for d in srcs]
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    call, want, tols = CASES[args.name](torch, g)
    recs, ok = [], True
    try:
        for src, lib in zip(srcs, libs):
            _build._LIBS[args.name] = lib
            got = call()
            again = call()
            torch.cuda.synchronize()
            errs = {k: float((a.float() - w.float()).abs().max())
                    / float(w.float().abs().max())
                    for k, a, w in zip(tols, got, want)}
            good = all(errs[k] <= tol for k, tol in tols.items())
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            ok &= good and same
            recs.append(dict(source=str(src), rel_err=errs, within_tol=good,
                             same_bits=same, ms=[]))
            del got, again
        for i in [*range(len(libs)), *reversed(range(len(libs)))]:
            _build._LIBS[args.name] = libs[i]
            recs[i]["ms"].append(time_ms(torch, call, args.reps))
        for rec, lib in zip(recs, libs):
            _build._LIBS[args.name] = lib
            call()
            torch.cuda.synchronize()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            rec["launch_ms"] = {e.key[:80]: e.device_time_total / 1e3
                                for e in prof.key_averages()
                                if e.device_time_total > 0}
    finally:
        _build._LIBS[args.name] = libs[0]
    for rec in recs:
        print(json.dumps(rec), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
