#!/usr/bin/env python3
"""Time a kernel's source against edited copies of it, on the card.

    python3 tools/kernel_ab.py NAME [DIR ...] [--reps N]

Run from the root of a checkout on a machine with a CUDA card.  NAME is
`flash_attention` (the forward's wgmma route), `flash_attention_bwd` or
`selective_scan_bwd`.  Each DIR is a copy of src/repro_torch/kernels/csrc
in which that source was edited (another layout or design to compare:
edit the copy, never the package); the package's own csrc comes first.
Every library is built with the package's nvcc line and served to the
same wrapper in turn.  The backwards run at phase 8's shapes (flash [128,
2048, 128] bf16 causal, the scan [4, 2048, 8192, 16] with bf16 x, the
inputs of chip_smoke.py's phase 2) and at rows 4bn's, 4bw's and 5ba's
(flash bf16 non-causal at hd 64: whisper-tiny's encoder [24, 1500, 64]
and cross-attention [24, 448, 64] x [24, 1500, 64], as a training
microbatch launches them, and [48, 1500, 64], the shape row 4bn was
first timed at; [10, 4096, 256] causal within a 2048-key window and [10,
2048, 256] causal; the (a, bx) entry's backward at N = 1 [1, 4096,
2560], [1, 2048, 2560] and [2, 4096, 2560]).  The non-causal hd-64 cases
call the C entry with the one-pass kernel's scratch
(`chip_smoke._flash_bwd_launch_parent`), which the split route leaves
unread past D, so that an earlier library (whose one-pass kernel writes
a dQ workspace there) can be timed beside the current one; the forward
at the shapes of
chip_smoke.py's rows 4w and 4n (bf16 [10, 2048, 256] causal, [10, 8192,
256] and [10, 4096, 256] within a 2048-key window, [24, 1500, 64]
non-causal), each also timed through the package's mma.sync entry
(`flash_attention_launch`, the route those shapes took before) and
beside `scaled_dot_product_attention`.  Each case is held against the
plain version with phase 2's tolerances and launched twice for its bits,
then all libraries are timed by CUDA events in turns (first to last,
then last to first), and one call of each is traced with torch.profiler
for its launches' device times.  `--only TEXT` keeps the cases whose
name holds TEXT.  Prints the card, then one JSON line per case and
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

from chip_smoke import (_flash_bwd_launch_parent, card_line,  # noqa: E402
                        time_ms)


def _flash_bwd(torch, g):
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain)
    cases = []
    for bh, s, sk, hd, causal, window in (
            (24, 1500, 1500, 64, False, 0), (24, 448, 1500, 64, False, 0),
            (48, 1500, 1500, 64, False, 0), (128, 2048, 2048, 128, True, 0),
            (10, 4096, 4096, 256, True, 2048),
            (10, 2048, 2048, 256, True, 0)):
        q, do = (torch.randn(bh, s, hd, generator=g, device="cuda")
                 .to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(bh, sk, hd, generator=g, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        kw = dict(causal=causal, window=window)
        o, lse = flash_attention(q, k, v, return_lse=True, **kw)
        want = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        form = ("causal" if causal else "full") \
            + (f" window {window}" if window else "")
        shape = f"[{bh}, {s}, {hd}]" + ("" if sk == s else
                                        f"x[{bh}, {sk}, {hd}]")
        if hd == 64 and not causal:
            call = (lambda q=q, k=k, v=v, o=o, lse=lse, do=do:
                    _flash_bwd_launch_parent(torch, q, k, v, o, lse, do))
        else:
            call = (lambda q=q, k=k, v=v, o=o, lse=lse, do=do, kw=kw:
                    flash_attention_bwd(q, k, v, o, lse, do, **kw))
        cases.append(dict(case=f"{shape} bf16 {form}", call=call, want=want,
                          tols=dict(dq=2e-2, dk=2e-2, dv=2e-2)))
    return cases


def _row_err(got, want):
    """chip_smoke.py's flash check: the worst query row's error over that
    row's largest |value|."""
    diff = (got.float() - want.float()).abs().amax(-1)
    return float((diff / want.float().abs().amax(-1).clamp_min(1e-30)).max())


def _flash_fwd(torch, g):
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = []
    for bh, s, hd, causal, window in ((10, 2048, 256, True, 0),
                                      (10, 8192, 256, True, 2048),
                                      (10, 4096, 256, True, 2048),
                                      (24, 1500, 64, False, 0)):
        q, k, v = (torch.randn(bh, s, hd, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        kw = dict(causal=causal, window=window)
        want = flash_attention_plain(q, k, v, **kw)
        out = torch.empty_like(q)

        def mma(q=q, k=k, v=v, out=out, bh=bh, s=s, hd=hd, kw=kw):
            lib = _build.load("flash_attention", _build.CSRC)
            code = lib.flash_attention_launch(
                1, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                bh, s, s, hd, hd ** -0.5, int(kw["causal"]), kw["window"],
                torch.cuda.current_stream().cuda_stream)
            _build.check("flash_attention", code)
            return out
        if window:
            kp = torch.arange(s, device="cuda")
            mask = (kp[None, :] > kp[:, None] - window) \
                & (kp[None, :] <= kp[:, None])
            lib_call = (lambda q=q, k=k, v=v, mask=mask:
                        sdpa(q[None], k[None], v[None], attn_mask=mask))
        else:
            lib_call = (lambda q=q, k=k, v=v, causal=causal:
                        sdpa(q[None], k[None], v[None], is_causal=causal))
        form = ("causal" if causal else "full") \
            + (f" window {window}" if window else "")
        cases.append(dict(
            case=f"[{bh}, {s}, {hd}] bf16 {form}",
            call=lambda q=q, k=k, v=v, kw=kw: (flash_attention(q, k, v, **kw),),
            want=(want,), tols=dict(out=1e-2), err=_row_err,
            baselines={"mma.sync entry": mma, "sdpa": lib_call}))
    return cases


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
    cases = [dict(case="[4, 2048, 8192, 16] bf16 x",
                  call=lambda: scan.selective_scan_fused_bwd(
                      dt, A, Bm, Cm, x, None, dy, states=states),
                  want=want, tols=tols)]
    # the (a, bx) entry's backward at N = 1 (the RG-LRU's): row 5ba's
    # training microbatch, a 2048-token one and the whole batch
    for b, s, d in ((1, 4096, 2560), (1, 2048, 2560), (2, 4096, 2560)):
        a = torch.exp(-torch.randn(b, s, d, generator=g, device="cuda").abs())
        h, dy1 = (torch.randn(b, s, d, generator=g, device="cuda")
                  for _ in range(2))
        h0, dh = (torch.randn(b, d, generator=g, device="cuda")
                  for _ in range(2))
        cases.append(dict(
            case=f"(a, bx) [{b}, {s}, {d}] h0 and dh_last",
            call=lambda a=a, h=h, h0=h0, dy1=dy1, dh=dh:
            scan.selective_scan_bwd(a, h, h0, dy1, dh),
            want=scan.selective_scan_bwd_plain(a, h, h0, dy1, dh),
            tols=dict(da=1e-6, dbx=1e-6, dh0=1e-6)))
    return cases


CASES = {"flash_attention": _flash_fwd, "flash_attention_bwd": _flash_bwd,
         "selective_scan_bwd": _scan}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("name", choices=sorted(CASES))
    ap.add_argument("dirs", nargs="*", type=Path)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", default="", help="keep the cases whose name "
                    "holds this text")
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
    ok = True
    try:
        for case in CASES[args.name](torch, g):
            if args.only in case["case"]:
                ok &= _run_case(torch, _build, args, case, srcs, libs)
    finally:
        _build._LIBS[args.name] = libs[0]
    return 0 if ok else 1


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max()) \
        / float(want.float().abs().max())


def _run_case(torch, _build, args, case, srcs, libs) -> bool:
    call, want, tols = case["call"], case["want"], case["tols"]
    err = case.get("err", _rel_err)
    recs, ok = [], True
    for src, lib in zip(srcs, libs):
        _build._LIBS[args.name] = lib
        got = call()
        again = call()
        torch.cuda.synchronize()
        errs = {k: err(a, w) for k, a, w in zip(tols, got, want)}
        good = all(errs[k] <= tol for k, tol in tols.items())
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        ok &= good and same
        recs.append(dict(case=case["case"], source=str(src), rel_err=errs,
                         within_tol=good, same_bits=same, ms=[]))
        del got, again
    for i in [*range(len(libs)), *reversed(range(len(libs)))]:
        _build._LIBS[args.name] = libs[i]
        recs[i]["ms"].append(time_ms(torch, call, args.reps))
    _build._LIBS[args.name] = libs[0]
    base = {name: time_ms(torch, fn, args.reps)
            for name, fn in case.get("baselines", {}).items()}
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
        if base:
            rec["baseline_ms"] = base
        print(json.dumps(rec), flush=True)
    return ok


if __name__ == "__main__":
    sys.exit(main())
