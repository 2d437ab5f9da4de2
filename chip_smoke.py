#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout, on a machine with a CUDA card (an H100 is
what the sizes are chosen for).  Phases, each of which fails the run at its
first mismatch:

1. build   — compile the hand-written CUDA kernels (one nvcc per source, in
             parallel) and print the card, its power limit and the versions;
2. kernels — call each kernel's wrapper on the card at the shapes the main
             path gives it, hold it against its plain PyTorch version, and
             time kernel, plain version and one library call beside the
             least time the card could take (the bound);
3. main    — run all 15 paper programs through
             `repro_torch.core.compile_program(p).run(inputs)` at the data
             sizes below, each held against a numpy float64 reference of the
             program, with the kernels' launch counts read around the run;
             the programs the kernels serve, and the slowest, run once more
             under torch.profiler for the device's busy time and idle share;
             the group-by programs run again with the segment kernel pinned.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Without a CUDA device, or
outside a checkout, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): device memory and FP32/bf16
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

# main-path data sizes: what a user of an analytics compiler runs on one
# 80 GB card
N_ROWS = 2 ** 26
VOCAB = 2 ** 17
GROUPS = 2 ** 20
MAT = 8192
PR_VERTICES, PR_EDGES, PR_STEPS = 4_847_571, 68_993_773, 10   # soc-LiveJournal1
KM_POINTS, KM_K = 2 ** 24, 64
MF_N, MF_L = 4096, 64


class SmokeFailure(Exception):
    pass


def log(*a):
    print(*a, flush=True)


def require(cond, what):
    if not cond:
        raise SmokeFailure(what)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(torch, fn, reps=5, warmup=1):
    """Mean device time of one call, by CUDA events over `reps` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def phase_build(torch):
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    per = _build.build_all()
    total = time.perf_counter() - t0
    log(f"[build] kernels built in {total:.2f} s "
        + " ".join(f"{k}={v:.2f}s" for k, v in per.items()))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    log(card)
    log(f"[build] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[build] allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return card


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _segment_case(torch, g, n, k, d, op, dtype="float32", special=False,
                  hot=0.0, reps=5):
    from repro_torch.kernels.segment_reduce import (_identity,
                                                     segment_reduce,
                                                     segment_reduce_plain)
    dev = "cuda"
    lo, hi = (-max(1, k // 20), k + max(1, k // 20)) if special else (0, k)
    ids = torch.randint(lo, hi, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    if hot:
        # a hot key: this share of the rows all land on segment 0
        ids = torch.where(torch.rand(n, generator=g, device=dev) < hot,
                          0, ids).to(torch.int32)
    shape = (n,) if d == 1 else (n, d)
    if dtype == "int32":
        vals = torch.randint(-1000, 1000, shape, generator=g, device=dev,
                             dtype=torch.int32)
    else:
        vals = torch.randn(shape, generator=g, device=dev)
    if special:
        # dropped rows carry inf/NaN, which must not reach any segment; a
        # few kept rows carry NaN, which must propagate like jnp.min/max
        dropped = (ids < 0) | (ids >= k)
        bad = torch.where(torch.arange(n, device=dev) % 2 == 0,
                          float("inf"), float("nan"))
        vals = torch.where(dropped.reshape(-1, *([1] * (vals.dim() - 1))),
                           bad.reshape(vals.shape[:1] + (1,) * (vals.dim()
                                                                - 1)),
                           vals)
        vals[:: max(1, n // 7)] = float("nan")
    got = segment_reduce(ids, vals, k, op=op)
    want = segment_reduce_plain(ids, vals, k, op)
    torch.cuda.synchronize()
    if dtype == "int32":
        err = float((got.to(torch.int64) - want.to(torch.int64)).abs()
                    .max()) if got.numel() else 0.0
        require(got.dtype == torch.int32 and err == 0,
                f"segment_reduce int32 {op}: not exact (err {err})")
        tol_txt, ok = "exact", True
    else:
        nan_ok = bool((torch.isnan(got) == torch.isnan(want)).all())
        fin = ~torch.isnan(want)
        # empty segments hold ±inf in both: equal cells differ by 0
        diff = torch.where(got == want, 0.0, (got - want).abs())[fin]
        err = float(diff.max()) if diff.numel() else 0.0
        if op == "+":
            # atomics reorder each float32 sum: allow 1e-4·Σ|v| per segment
            scale = segment_reduce_plain(ids, vals.abs(), k, "+")[fin]
            ok = bool((diff <= 1e-4 * scale + 1e-6).all())
            tol_txt = "1e-4*sum|v| per segment (float32 atomics reorder sums)"
        else:
            ok = err == 0.0
            tol_txt = "exact (min/max do not depend on order)"
        ok = ok and nan_ok
        require(ok, f"segment_reduce n={n} k={k} d={d} {op}: err {err}, "
                    f"nan agreement {nan_ok}")
    # timings: kernel, plain version, one library call into a sentinel-
    # padded buffer (ids routed to the sentinel row beforehand)
    kernel_ms = time_ms(torch, lambda: segment_reduce(ids, vals, k, op=op),
                        reps)
    plain_ms = time_ms(torch, lambda: segment_reduce_plain(ids, vals, k, op),
                       reps)
    idx = torch.where((ids >= 0) & (ids < k), ids, k).to(torch.int64)
    acc = torch.int32 if dtype == "int32" else torch.float32
    vv = vals if vals.dim() == 2 else vals[:, None]
    ident = _identity(op, acc)
    if op == "+":
        def lib():
            return torch.full((k + 1, d), ident, dtype=acc,
                              device=dev).index_add_(0, idx, vv)
    else:
        idx2 = idx[:, None].expand(-1, d)
        red = "amin" if op == "min" else "amax"

        def lib():
            return torch.full((k + 1, d), ident, dtype=acc,
                              device=dev).scatter_reduce_(
                0, idx2, vv, red, include_self=True)
    library_ms = time_ms(torch, lib, reps)
    bytes_ = 4 * n + 4 * n * d + 8 * k * d
    bound_ms = bytes_ / HBM_BYTES_S * 1e3
    rec = dict(case=f"segment_reduce N={n} K={k} D={d} op={op} {dtype}"
               + (" ids<0,>=K, inf/NaN" if special else "")
               + (f" hot key holds {hot:.0%} of rows" if hot else ""),
               max_abs_err=err, tol=tol_txt, kernel_ms=kernel_ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
               bound_by="bytes")
    log("[kernels] " + json.dumps(rec))
    return rec


def _tile_case(torch, g, m, k, n, bm, dtype, masked, packed, reps=3):
    """One product through the dense entry `tile_matmul`, or through
    `tile_matmul_packed` on the tiles of `pack(a, bm, bm)` (the main
    path's form)."""
    from repro_torch.core.tiles import pack
    from repro_torch.kernels.tile_matmul import (tile_matmul,
                                                 tile_matmul_packed,
                                                 tile_matmul_packed_plain,
                                                 tile_matmul_plain)
    dev = "cuda"
    dt = getattr(torch, dtype)
    a = torch.randn(m, k, generator=g, device=dev).to(dt)
    b = torch.randn(k, n, generator=g, device=dev).to(dt)
    mt, kt = -(-m // bm), -(-k // bm)
    mask = None
    density = 1.0
    if masked:
        # exactly half the lhs tiles absent; absent tiles keep their
        # non-zero data, which must contribute nothing
        perm = torch.randperm(mt * kt, generator=g, device=dev)
        mask = torch.zeros(mt * kt, device=dev)
        mask[perm[: (mt * kt + 1) // 2]] = 1.0
        mask = mask.reshape(mt, kt)
        density = float(mask.mean())
    if packed:
        t = pack(a, bm, bm, prune_zero=False)
        if mask is None:
            mask = t.mask

        def kern():
            return tile_matmul_packed(t.tiles, mask, t.shape, b)

        def plain():
            return tile_matmul_packed_plain(t.tiles, mask, t.shape, b)
    else:
        def kern():
            return tile_matmul(a, b, mask, bm=bm, bk=bm)

        def plain():
            return tile_matmul_plain(a, b, mask, bm=bm, bk=bm)
    got = kern()
    want = plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    # two float32 summation orders over K products of unit normals
    tol = 1e-4 * math.sqrt(k) * 4 + 1e-4
    require(err <= tol, f"tile_matmul {m}x{k}x{n} {dtype} masked={masked} "
                        f"packed={packed}: err {err} > {tol}")
    kernel_ms = time_ms(torch, kern, reps)
    plain_ms = time_ms(torch, plain, reps)
    if mask is not None:
        dense_a = a * mask.repeat_interleave(bm, 0).repeat_interleave(
            bm, 1)[:m, :k].to(dt)
    else:
        dense_a = a
    library_ms = time_ms(torch, lambda: torch.matmul(dense_a, b), reps)
    flops = 2.0 * m * n * k * density
    esize = 2 if dtype == "bfloat16" else 4
    bytes_ = esize * (m * k * density + k * n) + 4 * m * n
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = bytes_ / HBM_BYTES_S * 1e3
    rec = dict(case=f"tile_matmul {m}x{k}x{n} bm=bk={bm} {dtype} "
               + (f"masked density={density:.3f}" if masked else "unmasked")
               + (" packed" if packed else " dense lhs"),
               max_abs_err=err, tol=f"{tol:.3g} abs", kernel_ms=kernel_ms,
               plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    log("[kernels] " + json.dumps(rec))
    return rec


def phase_kernels(torch, seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    seg = [
        _segment_case(torch, g, N_ROWS, 256, 1, "+"),
        _segment_case(torch, g, N_ROWS, GROUPS, 1, "+"),
        _segment_case(torch, g, N_ROWS, GROUPS, 1, "min"),
        _segment_case(torch, g, N_ROWS, GROUPS, 1, "max"),
        _segment_case(torch, g, 2 ** 24, 4096, 8, "+"),
        _segment_case(torch, g, N_ROWS, VOCAB, 1, "+", dtype="int32"),
        *[_segment_case(torch, g, 2 ** 22, 1000, 1, op, special=True)
          for op in ("+", "min", "max")],
        _segment_case(torch, g, N_ROWS, GROUPS, 1, "+", hot=0.25),
    ]
    # what a colliding row costs the kernel: the hot-key case against the
    # uniform one, per row that lands on the hot segment (the cost row's
    # dup_row prices the same thing)
    extra_us = (seg[-1]["kernel_ms"] - seg[1]["kernel_ms"]) * 1e3 \
        / (0.25 * N_ROWS)
    log(f"[kernels] segment_reduce collision cost: {extra_us:.3g} us per "
        f"row on one hot segment (N={N_ROWS}, K={GROUPS}, 25% hot)")
    from repro_torch.kernels import segment_reduce
    ids = torch.zeros(2, dtype=torch.int32, device="cuda")
    vals = torch.tensor([2 ** 24 + 1, 1], dtype=torch.int32, device="cuda")
    s = segment_reduce(ids, vals, 1)
    mx = segment_reduce(ids, vals, 1, op="max")
    require(s.dtype == torch.int32 and int(s[0]) == 2 ** 24 + 2
            and int(mx[0]) == 2 ** 24 + 1,
            f"segment_reduce int32 2^24+1: got {s.tolist()} {mx.tolist()}")
    log("[kernels] segment_reduce int32 exact at 2^24+1: "
        f"sum={int(s[0])} max={int(mx[0])}")
    tile = [
        _tile_case(torch, g, MAT, MAT, MAT, 128, "float32", True, True),
        _tile_case(torch, g, MAT, MAT, MAT, 128, "bfloat16", True, True),
        _tile_case(torch, g, MAT, MAT, MAT, 128, "float32", False, False),
        _tile_case(torch, g, 100, 70, 90, 32, "float32", True, True),
        _tile_case(torch, g, 100, 70, 90, 32, "float32", True, False),
    ]
    torch.cuda.synchronize()
    # the entries of the kernel line: the main path's shapes (the group-by
    # over 2^20 segments, the packed 8192^3 product through the packed
    # entry)
    return {"segment_reduce": seg[1], "tile_matmul": tile[0]}


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def _rel_err(out, ref):
    import numpy as np
    a = np.asarray(out)
    b = np.asarray(ref)
    dt = np.result_type(a.dtype, b.dtype, np.float32)   # f32 refs stay f32
    a, b = a.astype(dt, copy=False), b.astype(dt, copy=False)
    if a.shape != b.shape:
        raise SmokeFailure(f"shape {a.shape} != reference {b.shape}")
    if not np.all(np.isfinite(a)):
        raise SmokeFailure("non-finite output")
    scale = max(float(np.max(np.abs(b))) if b.size else 0.0, 1e-30)
    return float(np.max(np.abs(a - b))) / scale if b.size else 0.0


def _programs(np, rng, torch):
    """(name, inputs, reference() -> {output: array}[, rows]) for each
    program.  Inputs are made with numpy from the seed and every array is
    moved to the card once, so that run() times hold no host-to-device
    copy; references are numpy float64 (a sample of rows for the 8192^3
    products)."""
    from repro_torch.core.programs import ALL
    from repro_torch.core.tiles import pack

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    f32 = np.float32
    out = []
    v = rng.standard_normal(N_ROWS, dtype=f32)
    v64 = v.astype(np.float64)
    lim = 0.3

    def scal(x):
        return np.float32(x)

    out.append(("average", dict(V=(dev(v),), s=0.0, cnt=0.0, avg=0.0),
                lambda: dict(s=v64.sum(), cnt=float(N_ROWS),
                             avg=v64.sum() / N_ROWS)))
    out.append(("count", dict(V=(dev(v),), cnt=0.0),
                lambda: dict(cnt=float(N_ROWS))))
    out.append(("conditional_count", dict(V=(dev(v),), cnt=0.0, limit=lim),
                lambda: dict(cnt=float((v < scal(lim)).sum()))))
    out.append(("conditional_sum", dict(V=(dev(v),), s=0.0, limit=lim),
                lambda: dict(s=v64[v < scal(lim)].sum())))
    w = rng.integers(0, 3, N_ROWS).astype(f32)
    out.append(("equal", dict(W=(dev(w),), first=float(w[0]), diffs=0.0),
                lambda: dict(diffs=float((w != w[0]).sum()))))
    ws = rng.integers(0, 1000, N_ROWS).astype(f32)
    ks = (1.0, 500.0, 5000.0)
    out.append(("string_match",
                dict(W=(dev(ws),), k1=ks[0], k2=ks[1], k3=ks[2],
                     found=dev(np.zeros(3, f32))),
                lambda: dict(found=np.array([float((ws == k).any())
                                             for k in ks]))))
    toks = rng.integers(0, VOCAB, N_ROWS).astype(f32)
    out.append(("word_count",
                dict(W=(dev(toks),), C=dev(np.zeros(VOCAB, f32))),
                lambda: dict(C=np.bincount(toks.astype(np.int64),
                                           minlength=VOCAB))))
    px = [rng.integers(0, 256, N_ROWS).astype(f32) for _ in range(3)]
    out.append(("histogram",
                dict(P=tuple(dev(c) for c in px),
                     **{c: dev(np.zeros(256, f32)) for c in "RGB"}),
                lambda: {n_: np.bincount(c.astype(np.int64), minlength=256)
                         for n_, c in zip("RGB", px)}))
    keys = rng.integers(0, GROUPS, N_ROWS).astype(f32)
    gv = rng.standard_normal(N_ROWS, dtype=f32)
    out.append(("group_by",
                dict(S=(dev(keys), dev(gv)), C=dev(np.zeros(GROUPS, f32))),
                lambda: dict(C=np.bincount(keys.astype(np.int64),
                                           weights=gv.astype(np.float64),
                                           minlength=GROUPS))))
    x = rng.standard_normal(N_ROWS, dtype=f32)
    y = (2.0 * x + 1.0 + 0.1 * rng.standard_normal(N_ROWS, dtype=f32)) \
        .astype(f32)

    def lr_ref():
        x64, y64 = x.astype(np.float64), y.astype(np.float64)
        xb, yb = x64.mean(), y64.mean()
        xx = ((x64 - xb) ** 2).sum()
        xy = ((x64 - xb) * (y64 - yb)).sum()
        return dict(sum_x=x64.sum(), sum_y=y64.sum(), x_bar=xb, y_bar=yb,
                    xx_bar=xx, xy_bar=xy, slope=xy / xx,
                    intercept=yb - xy / xx * xb)
    out.append(("linear_regression",
                dict(P=(dev(x), dev(y)), n=N_ROWS,
                     **{k_: 0.0 for k_ in ("sum_x", "sum_y", "x_bar",
                                           "y_bar", "xx_bar", "xy_bar",
                                           "slope", "intercept")}),
                lr_ref))
    ma = rng.standard_normal((MAT, MAT), dtype=f32)
    mb = rng.standard_normal((MAT, MAT), dtype=f32)
    out.append(("matrix_addition",
                dict(M=dev(ma), N=dev(mb), R=torch.zeros(MAT, MAT,
                                                         device="cuda"),
                     n=MAT, m=MAT),
                lambda: dict(R=ma.astype(np.float64) + mb)))
    rows = np.sort(rng.choice(MAT, 64, replace=False))

    def mm_ref(lhs):
        return dict(R=lhs[rows].astype(np.float64) @ mb.astype(np.float64))
    out.append(("matrix_multiplication",
                dict(M=dev(ma), N=dev(mb), R=torch.zeros(MAT, MAT,
                                                         device="cuda"),
                     n=MAT, m=MAT, l=MAT),
                lambda: mm_ref(ma), rows))
    # packed lhs: half of the 128x128 tiles zero, packed with pack(M, 128,
    # 128), so TiledMatmul runs the tile kernel
    t = MAT // 128
    zero = rng.permutation(t * t)[: t * t // 2]
    mz = ma.copy().reshape(t, 128, t, 128)
    mz[zero // t, :, zero % t, :] = 0.0
    mz = mz.reshape(MAT, MAT)
    out.append(("matrix_multiplication[packed]",
                dict(M=pack(dev(mz), 128, 128), N=dev(mb),
                     R=torch.zeros(MAT, MAT, device="cuda"), n=MAT, m=MAT,
                     l=MAT),
                lambda: mm_ref(mz), rows))
    src = rng.integers(0, PR_VERTICES, PR_EDGES)
    dst = rng.integers(0, PR_VERTICES, PR_EDGES)
    b_ = 0.85

    def pr_ref():
        nv = PR_VERTICES
        c = np.bincount(src, minlength=nv).astype(np.float64)
        p = np.full(nv, 1.0 / nv)
        for _ in range(PR_STEPS):
            np_ = np.bincount(dst, weights=p[src] / c[src], minlength=nv)
            p = (1.0 - b_) / nv + b_ * np_
        return dict(P=p, NP=np_, C=c, steps=float(PR_STEPS))
    out.append(("pagerank",
                dict(E=(dev(src.astype(f32)), dev(dst.astype(f32))),
                     P=dev(np.full(PR_VERTICES, 1.0 / PR_VERTICES, f32)),
                     NP=dev(np.zeros(PR_VERTICES, f32)),
                     C=dev(np.zeros(PR_VERTICES, f32)), N=PR_VERTICES,
                     num_steps=float(PR_STEPS), steps=0.0, b=b_),
                pr_ref))
    kx = (rng.standard_normal(KM_POINTS, dtype=f32) * 3).astype(f32)
    ky = (rng.standard_normal(KM_POINTS, dtype=f32) * 3).astype(f32)
    cx = rng.standard_normal(KM_K, dtype=f32)
    cy = rng.standard_normal(KM_K, dtype=f32)

    def km_ref():
        # D in float32, as the program computes it, so that ties in the
        # argmin resolve the same way; the sums in float64
        d = (kx[:, None] - cx[None, :]) * (kx[:, None] - cx[None, :]) \
            + (ky[:, None] - cy[None, :]) * (ky[:, None] - cy[None, :])
        mind = np.minimum(np.float32(1e30), d.min(axis=1))
        cl = (KM_K - 1 - np.argmin(d[:, ::-1], axis=1)).astype(np.int64)
        sx = np.bincount(cl, weights=kx.astype(np.float64), minlength=KM_K)
        sy = np.bincount(cl, weights=ky.astype(np.float64), minlength=KM_K)
        cn = np.bincount(cl, minlength=KM_K).astype(np.float64)
        return dict(D=d, MinD=mind, Cl=cl.astype(np.float64), SX=sx, SY=sy,
                    CN=cn, NX=sx / np.maximum(cn, 1.0),
                    NY=sy / np.maximum(cn, 1.0))
    out.append(("kmeans_step",
                dict(P=(dev(kx), dev(ky)), CX=dev(cx), CY=dev(cy), K=KM_K,
                     D=torch.zeros(KM_POINTS, KM_K, device="cuda"),
                     MinD=torch.full((KM_POINTS,), 1e30, device="cuda"),
                     Cl=torch.zeros(KM_POINTS, device="cuda"),
                     **{a_: dev(np.zeros(KM_K, f32))
                        for a_ in ("SX", "SY", "CN", "NX", "NY")}),
                km_ref))
    n_, l_ = MF_N, MF_L
    R = rng.standard_normal((n_, n_), dtype=f32)
    Pm = (rng.standard_normal((n_, l_), dtype=f32) * 0.1).astype(f32)
    Qm = (rng.standard_normal((l_, n_), dtype=f32) * 0.1).astype(f32)
    Pp = (rng.standard_normal((n_, l_), dtype=f32) * 0.1).astype(f32)
    Qp = (rng.standard_normal((l_, n_), dtype=f32) * 0.1).astype(f32)
    a_, lam = 0.002, 0.02

    def mf_ref():
        P64, Q64, Pp64, Qp64 = (z.astype(np.float64)
                                for z in (Pm, Qm, Pp, Qp))
        pq = Pp64 @ Qp64
        err = R.astype(np.float64) - pq
        return dict(pq=pq, err=err,
                    P=P64 + a_ * (2.0 * err @ Qp64.T - lam * n_ * Pp64),
                    Q=Q64 + a_ * (2.0 * Pp64.T @ err - lam * n_ * Qp64))
    out.append(("matrix_factorization_step",
                dict(R=dev(R), P=dev(Pm), Q=dev(Qm), Pp=dev(Pp), Qp=dev(Qp),
                     pq=torch.zeros(n_, n_, device="cuda"),
                     err=torch.zeros(n_, n_, device="cuda"),
                     n=n_, m=n_, l=l_, a=a_, lam=lam),
                mf_ref))
    return ALL, out


# relative tolerance of each program's outputs (max |out - ref| over
# max |ref|): float32 sums of up to 2^26 terms in the port against float64
# references, and float32 products of depth 8192
TOLS = {"matrix_multiplication": 1e-4, "matrix_multiplication[packed]": 1e-4,
        "matrix_factorization_step": 1e-4, "pagerank": 1e-3,
        "kmeans_step": 1e-3, "linear_regression": 1e-3}
DEFAULT_TOL = 1e-4


def _run_program(torch, cp, inputs, reps):
    """One warm-up run (allocator, cuBLAS), then `reps` timed runs, each by
    the host clock around run() and a synchronize; returns the last
    outputs and the per-run ms, sorted."""
    out = cp.run(inputs)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = cp.run(inputs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, sorted(times)


def _ms_text(times):
    return (f"{times[len(times) // 2]:.3f} ms (median of {len(times)}; "
            f"min {times[0]:.3f}, max {times[-1]:.3f})")


# the programs whose run() the smoke also traces: those the kernels serve
# and the slowest ones
PROFILED = ("word_count", "histogram", "group_by",
            "matrix_multiplication[packed]", "pagerank", "kmeans_step")


def _profile(torch, name, cp, inputs, run_ms, top=5):
    """One more run() under torch.profiler: the device's busy time (the sum
    of the durations of the kernels and copies it ran), its idle share of
    `run_ms` (the unprofiled median run), and the kernels that took the
    most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cp.run(inputs)
        torch.cuda.synchronize()
    per: dict = {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            ms, c = per.get(e.name, (0.0, 0))
            per[e.name] = (ms + e.device_time_total / 1e3, c + 1)
    if not per:
        log(f"[profile] {name}: the profiler recorded no device time")
        return
    busy = sum(ms for ms, _ in per.values())
    rows = sorted(((ms, k, c) for k, (ms, c) in per.items()), reverse=True)
    log(f"[profile] {name}: device busy {busy:.3f} ms of a {run_ms:.3f} ms "
        f"run (unprofiled median), idle share "
        f"{max(0.0, 1.0 - busy / run_ms):.3f}; top kernels: "
        + "; ".join(f"{k[:70]} x{c} {ms:.3f} ms" for ms, k, c in rows[:top]))


def _check(name, out, ref_fn, rows=None):
    ref = ref_fn()
    tol = TOLS.get(name, DEFAULT_TOL)
    errs = {}
    for k, r in ref.items():
        o = out[k].detach().cpu().numpy()
        if rows is not None:
            o = o[rows]
        errs[k] = _rel_err(o, r)
    worst = max(errs.values())
    require(worst <= tol, f"{name}: rel err {errs} > tol {tol}")
    return worst, tol


def phase_main(torch, seed):
    import numpy as np
    from repro_torch.core import compile_program
    from repro_torch.kernels import ops
    rng = np.random.default_rng(seed)
    ALL, progs = _programs(np, rng, torch)
    medians = {}
    log(f"[main] sizes: bags N={N_ROWS} rows, word_count vocabulary "
        f"{VOCAB}, group_by {GROUPS} groups, matrices {MAT}x{MAT}, pagerank "
        f"{PR_VERTICES} vertices {PR_EDGES} edges {PR_STEPS} steps, kmeans "
        f"{KM_POINTS} points K={KM_K}, matrix factorization n=m={MF_N} "
        f"l={MF_L}; no cuts")
    ops.reset_launch_counts()
    before = ops.launch_counts()
    for item in progs:
        name, inputs, ref_fn = item[:3]
        rows = item[3] if len(item) > 3 else None
        pname = name.split("[")[0]
        cp = compile_program(ALL[pname])
        out, times = _run_program(torch, cp, inputs, reps=5)
        counts = ops.launch_counts()
        worst, tol = _check(name, out, ref_fn, rows)
        sel = [ln.strip() for ln in cp.explain(
            tiled={"M"} if "packed" in name else ()).splitlines()
            if ln.strip().startswith("selected:")]
        delta = {k: counts[k] - before[k] for k in counts}
        before = counts
        log(f"[main] {name}: {_ms_text(times)}  rel_err={worst:.3g} "
            f"(tol {tol})  launches={delta}  " + "; ".join(sel))
        medians[name] = (cp, times[len(times) // 2])
        if pname in ("word_count", "histogram", "group_by"):
            require(delta["segment_reduce"] > 0,
                    f"{name}: segment_reduce kernel was not launched")
        if "packed" in name:
            require(delta["tile_matmul"] > 0,
                    f"{name}: tile_matmul kernel was not launched")
        del out
        torch.cuda.empty_cache()
    launches = ops.launch_counts()
    log(f"[main] kernel launches on the main path: {json.dumps(launches)}")
    for k, v in launches.items():
        require(v > 0, f"kernel {k} was not launched on the main path")
    # the group-by programs once more with the segment kernel pinned
    for item in progs:
        name, inputs, ref_fn = item[:3]
        if name not in ("word_count", "histogram", "group_by", "pagerank",
                        "kmeans_step"):
            continue
        cp = compile_program(ALL[name], op_select="force:pallas")
        ops.reset_launch_counts()
        out, times = _run_program(torch, cp, inputs, reps=1)
        forced = ops.launch_counts()
        worst, tol = _check(name, out, ref_fn)
        sel = sorted({ln.strip() for ln in cp.explain().splitlines()
                      if "segment:" in ln})
        log(f"[main] {name} op_select=force:pallas: {times[0]:.3f} ms  "
            f"rel_err={worst:.3g} (tol {tol})  launches={forced}  "
            + "; ".join(sel))
        require(forced["segment_reduce"] > 0,
                f"{name} op_select=force:pallas: segment_reduce kernel was "
                "not launched")
        del out
        torch.cuda.empty_cache()
    # traced last, so that the profiler cannot slow a timed run
    for item in progs:
        name, inputs = item[:2]
        if name in PROFILED:
            cp, run_ms = medians[name]
            _profile(torch, name, cp, inputs, run_ms)
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              f"(no src/repro_torch beside {Path(__file__).name})",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t0 = time.perf_counter()
    try:
        phase_build(torch)
        per_kernel = phase_kernels(torch, args.seed)
        launches = phase_main(torch, args.seed)
    except SmokeFailure as ex:
        print(f"chip_smoke.py: FAILED: {ex}", file=sys.stderr)
        return 1
    sources = {"segment_reduce": ("src/repro_torch/kernels/csrc/"
                                  "segment_reduce.cu",
                                  "src/repro/kernels/segment_reduce.py:109"),
               "tile_matmul": ("src/repro_torch/kernels/csrc/tile_matmul.cu",
                               "src/repro/kernels/tile_matmul.py:69")}
    kernels = []
    for name, rec in per_kernel.items():
        src, repl = sources[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": repl, "launches": launches[name],
                        "max_abs_err": rec["max_abs_err"],
                        "ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"],
                        "bound_ms": rec["bound_ms"],
                        "bound_by": rec["bound_by"],
                        "library_ms": rec["library_ms"]})
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
