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
             least time the card could take (the bound), with the
             kernel's TFLOP/s and the bound's share of its time; the
             segment kernel at every main path's shape, each case also
             launched again and with int64 ids, all bit-equal; the scan's
             (a, bx) entry and its fused entry (a 2048- and a 1531-token
             prefill's dt, A, B, C and bf16 x), the fused one also timed
             against the unfused path; the segment kernel's whole run
             against a run range by range (the same bits); its
             device-count entry (a served lane's rows counted on the
             device, n < L, small and bucketed paths) bit-equal to a
             launch over the first n rows and timed against it; its
             lanes entry (`segment_reduce_lanes`: one served flush's
             group-by, 16 lanes in one launch a pass) at mix (b)'s
             group_by (bucketed) and kmeans_step shapes and mix (a)'s
             group_by (small path), every lane bit-equal to a launch
             over its rows, timed eagerly and as CUDA-graph replays
             interleaved with the 16 device-count launches it replaces
             (with --parent the earlier library's), which it must beat
             from a graph, beside one `index_add_` over lane-offset ids
             (each replay's device time by torch.profiler: the `[lanes]`
             lines, after phase 8, apart from the other traces); the
             two backward kernels at phase 8's shapes (flash
             [128, 2048, 128] bf16 causal against the backward of
             `scaled_dot_product_attention`, the scan [4, 2048, 8192, 16]
             with bf16 x) and at the edges of their tilings (flash
             [128, 1531, 128] and [128, 2048, 64], the scan [4, 1531,
             8136, 16]), each held against its plain version, which
             takes nothing from a kernel under test, and launched twice
             with the same bits; the same at the hybrid and audio
             families' training shapes: the flash backward bf16 [10,
             4096, 256] causal within a 2048-token window (one lattn
             layer of a recurrentgemma-2b microbatch; against the
             backward of `scaled_dot_product_attention` with the window's
             mask) on the backward's wgmma route
             (`flash_attention_bwd[wg]`, which each bf16 case checks by
             its launch count; tools/kernel_ab.py times it beside [10,
             2048, 256] causal), float32 [10, 1531, 256]
             within 256, whisper-tiny's encoder [24, 1500, 64] and
             cross-attention [24, 448, 64] x [24, 1500, 64] non-causal
             (a microbatch's launches: 4 rows of 6 heads) on the
             backward's split route (`flash_attention_bwd[full, hd 64]`,
             each case checks it by its launch count),
             and the scan's (a, bx) backward at N = 1 [1, 4096, 2560],
             [1, 2048, 2560] and [2, 4096, 2560] from h0 with dh_last
             (its RG-LRU), bit-equal to its plain version;
             and the forward kernels' training
             entries (flash with its lse, held against the plain
             version's; the scan with its checkpoint states) bit-equal to
             the serving ones; the segment kernel's wide route at the MoE
             combine's shapes (qwen3-moe-30b-a3b's 2048-token prefill:
             16,384 bf16 rows of 2,048 into 2,048 tokens, ids in runs of
             8; a decode tick's 32 rows into 4; a training microbatch's
             65,536 into 8,192; arctic-480b's 4,096 rows of 7,168 into
             2,048) against its plain version, launched twice with the
             same bits, timed beside `index_add_` and the reshape-and-sum
             of the same rows;
             the shapes of the hybrid and audio families: flash bf16
             [10, 8192, 256] causal within a 2048-token window (one lattn
             layer of recurrentgemma-2b's 8192-token prefill; against
             `scaled_dot_product_attention` with the same boolean mask),
             [10, 2048, 256] causal and [10, 4096, 256] within the window
             (a training microbatch's lattn layer), float32 [10, 1531,
             256] within a 256-token window, whisper-tiny's encoder [24,
             1500, 64] and a decode tick's cross-attention [24, 1, 64] x
             [24, 1500, 64], both full (the bf16 ones at hd 64 and 256
             from 64 query rows on the forward's wgmma route,
             `flash_attention[wg]`, which each case checks by its launch
             count); and the scan's (a, bx) entry as the RG-LRU calls
             it, [1, 2048, 2560, 1], [1, 8192, 2560, 1], [1, 4096,
             2560, 1] (a training microbatch) and [2, 4096, 2560, 1]
             with c = 1, h0 and the final state; each launched twice
             with the same bits;
3. main    — run all 15 paper programs through
             `repro_torch.core.compile_program(p).run(inputs)` at the data
             sizes below, in eager mode and in whole mode (the default:
             CUDA graphs captured on the first call, replayed after), each
             held against a numpy float64 reference of the program, with
             the kernels' launch counts read around the runs: run() ms of
             both modes and of the first whole call, the compile cache's
             counters, graphs, loop flag reads, host syncs, input staging
             ms and peak memory; whole outputs bit-equal to eager's for the
             group-by programs, and launches equal in both modes; the
             programs the kernels serve, and the slowest, run once more in
             whole mode under torch.profiler for the device's busy time and
             idle share; the group-by programs run again with the segment
             kernel pinned; memest's estimate beside each program's
             measured peak (it must not be lower);
5. ooc     — out-of-core and resume: group_by over 2^29 rows (4 GiB
             pinned on the host) under budgets of memest's all-resident
             estimate / 2 (whole-range chunks, bit-equal to all-resident
             eager run()) and / 10 (sub-range chunks, within 1e-4, the
             ledger says so), each with run ms, chunks, segment
             launches, host -> device GB/s beside a bare pinned copy's,
             device busy (the union of the copies' and kernels' profiled
             intervals, and their overlap) and idle share, peak memory
             under the budget, and the first run's bits unchanged by a
             run queued behind it with no sync; pagerank on LiveJournal's shape streamed in 2
             range-aligned chunks a pass, bit-equal to eager run() and
             run_stepwise; pagerank under LoopRunner(every=2) killed at
             iteration 5 and the stream killed at chunk 6, each resumed
             bit-equal (snapshot save and restore ms); group_by in whole
             mode under a process memory cap, a real out-of-memory error
             descending to chunked with the same bits;
6. plans   — buffer donation and plan serving: kmeans_step, pagerank,
             word_count and matrix_addition at phase 3's sizes with
             donate=True, each output fed back as the next call's donated
             input (bit-equal to whole mode; donated names staged 0 B,
             cloned 0 B, no recapture; a fresh donated tensor consumed; a
             held output unchanged; run() ms of donate / whole / eager);
             then `repro_torch.serve.PlanServer(max_batch=16,
             flush_ms=1.0)` serving two mixes, (a) the reference bench's
             own tiny requests and (b) requests with real work (group_by
             2^20 / 3·2^18 rows into 2^16 groups, pagerank 2^16 vertices
             with 2^20 / 3·2^18 edges and 10 steps, kmeans_step 2^18 /
             3·2^16 points, K = 64), 192 requests at 1, 8 and 64
             closed-loop clients (a warm pass, then the measured one):
             requests/s, p50 and p99, occupancy, padded rows, flushes,
             batch entries built and hit, sequential fallbacks, peak
             memory, and every lane of every flush bit-equal to its
             request's solo run(); the segment launches of each
             program's flush of 16 lanes (every group-by through the
             lanes entry, none through the device-count one) and of each
             mix; one flush of 16 lanes of each program
             against 16 solo run()s, traced for device busy and idle, and
             two flushes (the second stacked while the first computes)
             traced for their host-to-device copies and the share of them
             that ran under a kernel; then ragged
             average and linear_regression requests (float sums over the
             bag: bucketed at their own rows on the card) and hot-key
             group_by requests (salted as their solo runs), each lane
             bit-equal to its solo run();
7. dist    — distributed rounds (`repro_torch.core.compile_distributed`)
             for word_count, group_by, pagerank, kmeans_step and
             matrix_factorization_step at phase 3's sizes: first a world
             of 1 over NCCL in this process (the op_select cuda row's
             collective costs measured; each program's run() ms, median
             of 5, beside single-device whole and eager, bit-equal to
             eager, its round strategies, the segment and tile kernel
             launches of the distributed runs, and one distributed and
             one eager call under torch.profiler: device busy ms, idle
             share, top kernels); then 4 ranks spawned on
             the one card over gloo, every collective through pinned host
             memory (outputs within max |a - b| / (|b| + 1) < 1e-4 of
             single-device run(), two runs bit-equal, REP-everything
             within 1e-6 except kmeans_step, whose four whole copies do
             not fit one card, pagerank's N padded and masked; run() ms,
             bytes a run through each collective and its transport, peak
             memory a rank: not scaling numbers, four processes share one
             card); pagerank with rank 1's block lost after a round inside
             its loop bit-equal to the fault-free run, no descent, the
             reference's ledger text; a straggling round's speculative
             backup; and in both worlds data-parallel training
             (`[train-dp]` lines, `make_train_step(cfg, mesh)`): llama3-8b
             at phase 8's config, 3 steps without a mesh and 3 through
             the world of 1 from the same weights and batches
             (compress_grads on: the first step's parameters and moments
             bit-equal, 64-bit fingerprints on the card; step ms, the
             exchange's all_reduce calls and bytes a step, its NCCL
             device time in one profiled step, peak memory, launches as
             phase 8 counts them), then 3 more through the world of 1 as
             one CUDA graph (`graphed_step`), after the last step
             bit-equal to the eager mesh steps, then whisper-tiny whole
             at phase 8's batch over the 4 ranks, two rows each (a graph
             of the step over them raises on every rank: gloo stages
             through host memory): one float32 step against a world-of-1
             step of the same global batch in this
             process (loss and grad_norm within 1e-4, each summed
             gradient leaf within 1e-3 of its max |ref|), then 6 bf16
             steps through TrainRunner, every leaf's crc32 equal on every
             rank after each step, rank 0's last snapshot resumed in this
             process without a mesh at its step and data position with
             rank 0's crc32s (ms by rank: not scaling numbers);
4. serve   — serve llama3-8b, falcon-mamba-7b, minitron-4b,
             phi3-medium-14b, qwen2-72b (32 of 80 layers),
             qwen3-moe-30b-a3b, arctic-480b (2 of 35 layers) and
             recurrentgemma-2b at full width (bf16, random weights from
             --seed, one model on the card at a time; depth cut, in whole
             layout periods, only where the weights do not fit one 80 GB
             card) through `repro_torch.serve.ServeEngine` and its
             compiled steps (`serve/graph.py`: one CUDA graph for the
             decode, one a prompt length seen twice for the prefill, a
             length's first prefill by the plain step): 4 slots,
             max_seq 2112, six requests of 2048, 1531, 1024, 777, 512 and
             300 prompt tokens (recurrentgemma-2b: also one of 8192, four
             of its windows, at max_seq 8256), 32 new tokens each, then
             each length's prefill seen again (its graph built) and
             replayed, bit-equal to its build's eager warm-up, with the
             launch counts read around the engine run and the replays
             (flash_attention for every attention model, segment_reduce
             for the MoE combine, selective_scan for the RG-LRU; each
             also in the launches the replays credit): the decode ms a
             tick at 4 active slots and the decode call's host ms, each
             request's time to first token in the engine run, each
             length's prefill replay ms and time to first token replayed
             and at second sight (the entry's eager warm-up and capture),
             the capture seconds, peak device memory with the graphs'
             pools, and a torch.profiler trace of a replayed tick (device
             busy, idle share); for llama3-8b, falcon-mamba-7b,
             qwen3-moe-30b-a3b and recurrentgemma-2b also the same
             requests through an eager engine (`graphed=False`: each
             request's time to first token, the tick), whose tokens'
             crc32 must be the graphed engine's, and a trace of the
             longest prefill replayed; for the others the plain decode
             step, eagerly; whisper-tiny through the graphed `make_prefill_step`
             / `make_decode_step` (4 requests of 1500 stub frames and 300
             tokens from the seed, 32 new tokens: prefill ms with the
             encoder, decode ms a tick, time to first token at first,
             second and later sights), then through the plain steps
             eagerly, the same tokens; then a float32 copy (full width;
             weights drawn on the card from --seed and copied to the CPU)
             of llama3-8b, falcon-mamba-7b, qwen3-moe-30b-a3b (its
             300-token prompt drops rows by capacity; the smallest gap
             between the k-th and (k+1)-th router logit is printed) and
             qwen2-vl-72b (through `make_prefill_step` with three M-RoPE
             position streams from the seed) at 2 layers, of
             recurrentgemma-2b at one (rec, rec, lattn) period with a
             2300-token prompt (past the window, the ring wrapped), and
             of the whole whisper-tiny, run through the graphed steps on
             the card (the prefill's third call, a replay, then the
             decode's) against
             the same weights on the CPU (the kernels' plain versions);
             the served tokens' crc32 (tools/serve_tokens.py prints the
             same digest from another tree's sources);
8. train   — train llama3-8b (8 of 32 layers), falcon-mamba-7b (16 of
             64), qwen3-moe-30b-a3b (4 of 48), recurrentgemma-2b (all 26,
             batches of 2 x 4096 tokens, so that its 2048-token window
             masks) and whisper-tiny (whole: 8 rows of 448 tokens on 1500
             stub frames) at full width, bf16 with float32 moments, remat
             "full", the configs' ce_chunk and microbatch, through
             `repro_torch.runtime.TrainRunner` on `SyntheticLMData`
             batches (the others 4 x 2048 tokens), each first 3 steps
             eagerly, then from the same weights through the graphed
             step (`graphed_step`: one CUDA graph of the whole step, the
             reference's jit), bit-equal to the eager steps after the
             third: loss and grad_norm a step, step ms of both (median
             after the first), the graph's capture seconds, tokens/s,
             peak memory, the launches of each kernel (a forward kernel
             twice a layer and microbatch, a backward once, AdamW twice
             a step, every other none), one profiled step (device busy,
             idle share, top kernels, the hand-written kernels' share),
             and 10 steps on one fixed batch whose loss must fall (the
             graphed step alone timed); then whisper-tiny six steps against a
             run failed at step 5 and resumed from its step-4 snapshot
             (each array read once, its crc32 checked as it is loaded),
             bit-equal leaf by leaf; then a float32 copy of each but
             llama3-8b (weights drawn on the card from --seed and copied
             to the CPU: 1 layer of falcon-mamba-7b, 1 of
             qwen3-moe-30b-a3b with rows dropped by capacity, one (rec,
             rec, lattn) period of recurrentgemma-2b at 2300 tokens, past
             its window, the whole whisper-tiny) takes one step's
             gradients on the card and on the CPU: loss and grad_norm
             within 1e-4, every gradient leaf within 1e-3 of its max
             |ref| (compared on the card).

Phases 5, 6 and 7 run after phase 3 and before phase 4; phase 8 after 4;
last, phase 2's main lanes case is traced again (`[lanes]` lines).
The line before the last is a JSON object with one entry per kernel
(segment_reduce's launches count phases 3, 5, 6 and 7's world of 1;
segment_reduce[lanes]'s phase 6's served flushes, in segment_reduce's
too; segment_reduce[wide]'s the MoE combines of phases 4 and 8;
flash_attention's and selective_scan's (both entries) phases 4 and 8
and 7's [train-dp] steps (every rank's), adamw's phase 8's and
[train-dp]'s steps, flash_attention[wg]'s the
part of flash_attention's on the wgmma route (recurrentgemma-2b's and
whisper-tiny's full-sequence attentions); the backward kernels' phase 8
and [train-dp], the windowed hd-256 flash backward
(recurrentgemma-2b's) apart from the other flash backwards); the last line
is {"ok": true, "device": {...}}.
Without a CUDA device, or outside a checkout, the script exits non-zero
and prints no result.

    python3 chip_smoke.py --parent DIR

also builds the kernel sources of DIR (an earlier version of
src/repro_torch/kernels/csrc, e.g. `git archive HEAD
src/repro_torch/kernels/csrc` unpacked into the git-ignored `.checkout/`)
that differ from the current ones, and phase 2 times each such kernel
through the same wrapper with the earlier library and the current one,
interleaved (earlier, current, current, earlier): `parent_ms` and
`change_ms` in its `[kernels]` records, the backward kernels' too.  The
segment kernel's wide route, the scan's N = 1 path and the flash
forward's wgmma route call C entries that a library older than them
lacks, and the (a, bx) backward's chunked entry replaced the earlier
one; there the earlier library is timed through its own entries as
its wrapper called them (`_bucketed_launch`, `_scan_launch_n1_parent`,
`_flash_launch_parent`, `_abx_bwd_launch_parent`).
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): device memory and
# FP32/bf16.  The float32 peak is 132 SMs x 128 lanes x 2 operations at
# the SXM part's 1.98 GHz boost clock; the exponentials' rate takes the
# same clock: 16 a clock an SM on the special-function units (an upper
# bound on their time: part of them could run as polynomials on the FMA
# pipes)
SMS, BOOST_HZ = 132, 1.98e9
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": SMS * 128 * 2 * BOOST_HZ, "bfloat16": 989e12}
EXP_PER_S = 16 * SMS * BOOST_HZ

# main-path data sizes: what a user of an analytics compiler runs on one
# 80 GB card
N_ROWS = 2 ** 26
VOCAB = 2 ** 17
GROUPS = 2 ** 20
MAT = 8192
PR_VERTICES, PR_EDGES, PR_STEPS = 4_847_571, 68_993_773, 10   # soc-LiveJournal1
KM_POINTS, KM_K = 2 ** 24, 64
MF_N, MF_L = 4096, 64

# the kernels of the program path (phase 3)
PROGRAM_KERNELS = ("segment_reduce", "tile_matmul")

# the serve path: each config at full width in bf16, with the kernels it
# must launch; prompt lengths include ones that 128 and 256 do not divide
SERVE_ARCHS = {"llama3-8b": ("flash_attention",),
               "falcon-mamba-7b": ("selective_scan_fused",),
               "minitron-4b": ("flash_attention",),
               "phi3-medium-14b": ("flash_attention",),
               "qwen2-72b": ("flash_attention",),
               "qwen3-moe-30b-a3b": ("flash_attention", "segment_reduce"),
               "arctic-480b": ("flash_attention", "segment_reduce"),
               "recurrentgemma-2b": ("flash_attention", "flash_attention[wg]",
                                     "selective_scan")}
# layers kept where a config's bf16 weights do not fit one 80 GB card:
# qwen2-72b 145 GB -> 61.2 GB, arctic-480b 951 GB -> 55.4 GB (one layer's
# 128 experts are 26.8 GB); no cut is made in width
SERVE_DEPTH = {"qwen2-72b": 32, "arctic-480b": 2}
# the configs whose longest prefill phase 4 traces, and whose requests it
# also serves through an eager engine (the same tokens as the graphed one)
SERVE_TRACED = ("llama3-8b", "falcon-mamba-7b", "qwen3-moe-30b-a3b",
                "recurrentgemma-2b")
SERVE_SLOTS, SERVE_MAX_SEQ, SERVE_MAX_NEW = 4, 2112, 32
PROMPT_LENS = (2048, 1531, 1024, 777, 512, 300)
# one more prompt and its max_seq, for a config whose window it crosses:
# recurrentgemma-2b's 8192 tokens are four of its 2048-token windows (its
# lattn caches hold min(window, max_seq) rows, its rec state is O(1))
SERVE_LONG = {"recurrentgemma-2b": (8192, 8256)}
# whisper-tiny through the serving steps, as the reference's launcher
# drives it: a batch of 4 requests of 1500 stub frames from the seed, a
# 300-token prompt, 32 new tokens
AUDIO_ARCH, AUDIO_BATCH, AUDIO_PROMPT = "whisper-tiny", 4, 300
# the card-against-CPU checks: a float32 copy of each, full width, cut to
# whole layout periods of at least 2 layers (recurrentgemma-2b: one
# (rec, rec, lattn) period), whisper-tiny whole
CHECK_ARCHS = ("llama3-8b", "falcon-mamba-7b", "qwen3-moe-30b-a3b",
               "qwen2-vl-72b", "recurrentgemma-2b", "whisper-tiny")
CHECK_LAYERS, CHECK_PROMPT, CHECK_NEW = 2, 300, 8
# a prompt past recurrentgemma-2b's window that it does not divide, so
# that the window mask and the ring's wrap run on both devices
CHECK_PROMPTS = {"recurrentgemma-2b": 2300}
# the MoE combine's shape in phase 2: qwen3-moe-30b-a3b's 2048-token
# prefill, top 8 of 128 experts, d_model 2048
MOE_TOKENS, MOE_TOP_K, MOE_D = 2048, 8, 2048


def cut_layout(cfg, layers, **over):
    """`cfg` cut in depth to whole periods of its first layout group's
    pattern, at least `layers` layers: (rec, rec, lattn) x n keeps a
    hybrid config's pattern, (dense,) x n a dense one's."""
    pattern = cfg.layout[0][0]
    periods = -(-layers // len(pattern))
    return cfg.replace(layout=((pattern, periods),), **over)


def serve_config(get_config, arch):
    """Phase 4's config of `arch`: the registered one, cut to SERVE_DEPTH's
    layers where it gives a cut."""
    cfg = get_config(arch)
    if arch not in SERVE_DEPTH:
        return cfg
    return cut_layout(cfg, SERVE_DEPTH[arch])


def serve_max_seq(arch):
    return SERVE_LONG[arch][1] if arch in SERVE_LONG else SERVE_MAX_SEQ


def serve_prompts(np, cfg, seed):
    """Phase 4's prompts: one of each of PROMPT_LENS (then SERVE_LONG's
    one), random tokens of the config's vocabulary from `seed`."""
    rng = np.random.default_rng(seed)
    lens = PROMPT_LENS + ((SERVE_LONG[cfg.name][0],)
                          if cfg.name in SERVE_LONG else ())
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


def served_digest(np, reqs):
    """(count, crc32) of the tokens the requests were served, in order."""
    import zlib
    toks = np.asarray([t for r in reqs for t in r.out], np.int64)
    return int(toks.size), zlib.crc32(toks.tobytes()) & 0xFFFFFFFF


class SmokeFailure(Exception):
    pass


# name -> the library built from --parent's sources, where they differ
PARENT_LIBS: dict = {}


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


def queued_ms(torch, fn, reps=5, warmup=1, spin_cycles=50_000_000):
    """Mean device time of one call, as `time_ms`, with the stream held by
    a spin kernel (about 25 ms) while the host enqueues the start event,
    the `reps` calls and the end event: the window then holds the calls
    back to back on the device, and neither the host's launch time nor a
    stall of its shared cores lands in it.  For work of a few microseconds
    a call (a CUDA graph's replay), where `time_ms` reads the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin_cycles)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_ms(torch, name, fn, reps, parent_fn=None, entry=None):
    """The kernel's time in a `[kernels]` record: `fn`'s, or with --parent
    the mean of the current library's two times, interleaved with the
    earlier library's, all through the same wrapper; or, where the earlier
    library lacks `entry`, the C entry the current wrapper calls (the wide
    segment route, the N = 1 scan and its backward, the flash forward's
    wgmma route), through `parent_fn`, which calls the earlier library's
    unchanged entry as its wrapper did."""
    from repro_torch.kernels import _build
    if name not in PARENT_LIBS:
        return dict(kernel_ms=time_ms(torch, fn, reps))
    own = _build.load(name)
    if entry is not None and hasattr(PARENT_LIBS[name], entry):
        parent_fn = None
    times = {"parent": [], "change": []}
    try:
        for which in ("parent", "change", "change", "parent"):
            _build._LIBS[name] = PARENT_LIBS[name] if which == "parent" \
                else own
            run = parent_fn if which == "parent" and parent_fn else fn
            times[which].append(time_ms(torch, run, reps))
    finally:
        _build._LIBS[name] = own
    kernel_ms = sum(times["change"]) / 2
    return dict(kernel_ms=kernel_ms, parent_ms=times["parent"],
                change_ms=times["change"],
                speedup=sum(times["parent"]) / 2 / kernel_ms)


def _rates(rec, ops):
    """Add the achieved rate (`ops` operations over the kernel's time, in
    TFLOP/s) and the bound's share of the kernel's time to a record."""
    rec["tflops"] = ops / rec["kernel_ms"] / 1e9
    rec["bound_share"] = rec["bound_ms"] / rec["kernel_ms"]
    log("[kernels] " + json.dumps(rec))
    return rec


def card_line():
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"nvidia-smi failed: {smi.stderr.strip()}"


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def _source_text(csrc, name):
    """A kernel's source and the headers it includes, or None when `csrc`
    has no such kernel."""
    src = csrc / f"{name}.cu"
    if not src.exists():
        return None
    text = src.read_text()
    heads = re.findall(r'#include "([^"]+)"', text)
    return [text] + [(csrc / h).read_text() if (csrc / h).exists() else None
                     for h in heads]


def phase_build(torch, parent=None):
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    per = _build.build_all()
    total = time.perf_counter() - t0
    log(f"[build] kernels built in {total:.2f} s "
        + " ".join(f"{k}={v:.2f}s" for k, v in per.items()))
    if parent is not None:
        changed = [n for n in _build.SOURCES
                   if _source_text(parent, n) not in
                   (None, _source_text(_build.CSRC, n))]
        _build.build_all(changed, parent)
        PARENT_LIBS.update({n: _build.load(n, parent) for n in changed})
        log(f"[build] --parent {parent}: built {changed} (the other "
            "sources are the same)")
    card = card_line()
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
                  hot=0.0, broadcast=False, reps=5):
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
    if broadcast:
        # one value for every row (a count), as the executor hands it in:
        # read once, never copied
        vals = torch.ones((1,) * len(shape), device=dev).expand(shape)
    elif dtype == "int32":
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
    # deterministic: a second launch gives the same bits, and so do the
    # same ids as int64 (the executor's dtype, read as it is)
    again = segment_reduce(ids, vals, k, op=op)
    wide = segment_reduce(ids.to(torch.int64), vals, k, op=op)
    torch.cuda.synchronize()
    same = bool(torch.equal(got.view(torch.int32), again.view(torch.int32))
                and torch.equal(got.view(torch.int32),
                                wide.view(torch.int32)))
    require(same, f"segment_reduce n={n} k={k} d={d} {op} {dtype}: two "
                  "launches, or int32 and int64 ids, differ in their bits")
    del again, wide
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
            # the plain version (index_add_) sums in another order, with
            # atomics: allow 1e-4·Σ|v| per segment against it
            scale = segment_reduce_plain(ids, vals.abs(), k, "+")[fin]
            ok = bool((diff <= 1e-4 * scale + 1e-6).all())
            tol_txt = ("1e-4*sum|v| per segment against the plain version; "
                       "bit-equal across launches and id dtypes")
        else:
            ok = err == 0.0
            tol_txt = "exact (min/max do not depend on order)"
        ok = ok and nan_ok
        require(ok, f"segment_reduce n={n} k={k} d={d} {op}: err {err}, "
                    f"nan agreement {nan_ok}")
    # timings: kernel, plain version, one library call into a sentinel-
    # padded buffer (ids routed to the sentinel row beforehand)
    kern = _kernel_ms(torch, "segment_reduce",
                      lambda: segment_reduce(ids, vals, k, op=op), reps)
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
    # ids and values read once, each output cell written once
    bytes_ = 4 * n + (0 if broadcast else 4 * n * d) + 4 * k * d
    bound_ms = bytes_ / HBM_BYTES_S * 1e3
    rec = dict(case=f"segment_reduce N={n} K={k} D={d} op={op} {dtype}"
               + (" ids<0,>=K, inf/NaN" if special else "")
               + (f" hot key holds {hot:.0%} of rows" if hot else "")
               + (" one broadcast value" if broadcast else ""),
               max_abs_err=err, tol=tol_txt, **kern, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by="bytes")
    return _rates(rec, n * d)        # one ⊕ a value


def _segment_ranges_check(torch, g):
    """The order of the sums is fixed by ranges of rows, not by N: at
    pagerank's shape (two ranges), one call gives the bits of the same rows
    reduced range by range with the results folded in order (a chunked
    run)."""
    from repro_torch.kernels.segment_reduce import RANGE_ROWS, segment_reduce
    n, k = PR_EDGES, PR_VERTICES
    ids = torch.randint(0, k, (n,), generator=g, device="cuda",
                        dtype=torch.int32)
    vals = torch.randn(n, generator=g, device="cuda")
    whole = segment_reduce(ids, vals, k)
    chunked = None
    for i in range(0, n, RANGE_ROWS):
        part = segment_reduce(ids[i:i + RANGE_ROWS], vals[i:i + RANGE_ROWS],
                              k)
        chunked = part if chunked is None else chunked + part
    torch.cuda.synchronize()
    require(torch.equal(whole.view(torch.int32), chunked.view(torch.int32)),
            "segment_reduce: the whole run and the run range by range "
            "differ in their bits")
    log(f"[kernels] segment_reduce N={n} K={k} +: the whole run and "
        f"{-(-n // RANGE_ROWS)} ranges of {RANGE_ROWS} rows folded in order "
        "are bit-equal")


def _segment_rows_case(torch, g, L, n, k, op="+", reps=5):
    """The device-count entry (`n_rows=`, a served lane padded to L rows):
    bit-equal to the host-count launch over the first n rows, within the
    plain version's tolerance, and timed against that launch."""
    from repro_torch.kernels.segment_reduce import (segment_reduce,
                                                     segment_reduce_plain)
    ids = torch.randint(0, k, (L,), generator=g, device="cuda",
                        dtype=torch.int32)
    vals = torch.randn(L, generator=g, device="cuda")
    count = torch.tensor(n, dtype=torch.int32, device="cuda")
    got = segment_reduce(ids, vals, k, op=op, n_rows=count)
    host = segment_reduce(ids[:n], vals[:n], k, op=op)
    want = segment_reduce_plain(ids[:n], vals[:n], k, op)
    torch.cuda.synchronize()
    require(torch.equal(got.view(torch.int32), host.view(torch.int32)),
            f"segment_reduce n_rows={n} of L={L}, K={k}, {op}: the device "
            "count's bits differ from a launch over the first rows")
    diff = torch.where(got == want, 0.0, (got - want).abs())
    err = float(diff.max()) if diff.numel() else 0.0
    if op == "+":
        scale = segment_reduce_plain(ids[:n], vals[:n].abs(), k, "+")
        require(bool((diff <= 1e-4 * scale + 1e-6).all()),
                f"segment_reduce n_rows={n}: err {err} against the plain "
                "version")
    else:
        require(err == 0.0, f"segment_reduce n_rows={n} {op}: err {err}")
    kernel_ms = time_ms(torch, lambda: segment_reduce(ids, vals, k, op=op,
                                                      n_rows=count), reps)
    host_ms = time_ms(torch, lambda: segment_reduce(ids[:n], vals[:n], k,
                                                    op=op), reps)
    plain_ms = time_ms(torch, lambda: segment_reduce_plain(ids[:n], vals[:n],
                                                           k, op), reps)
    bound_ms = (8 * n + 4 * k) / HBM_BYTES_S * 1e3
    path = "small" if k <= 2048 else "bucketed"
    rec = dict(case=f"segment_reduce device count n={n} of L={L} K={k} "
               f"op={op} ({path} path)", max_abs_err=err, kernel_ms=kernel_ms,
               host_count_ms=host_ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by="bytes", bit_equal_to_host_count=True)
    log("[kernels] " + json.dumps(rec))
    return rec


def _lanes_flush(torch, g, lens, L, k):
    """One served flush's group-by: B lanes of L padded rows, lane b
    counting its first lens[b] in a [B] tensor.  Returns the inputs and
    its two forms: the lanes entry (`segment_reduce_lanes`, one launch a
    pass) and B device-count launches (`segment_reduce_launch_rows`, the
    entry served lanes called before the lanes entry; with --parent the
    earlier library's)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.segment_reduce import (segment_reduce,
                                                     segment_reduce_lanes)
    B = len(lens)
    ids = torch.randint(0, k, (B, L), generator=g, device="cuda",
                        dtype=torch.int32)
    vals = torch.randn(B, L, generator=g, device="cuda")
    counts = torch.tensor(lens, dtype=torch.int32, device="cuda")
    own = _build.load("segment_reduce")
    parent = PARENT_LIBS.get("segment_reduce", own)

    def lanes():
        return segment_reduce_lanes(list(ids), list(vals), k, counts)

    def rows():
        _build._LIBS["segment_reduce"] = parent
        try:
            return [segment_reduce(ids[b], vals[b], k, n_rows=counts[b])
                    for b in range(B)]
        finally:
            _build._LIBS["segment_reduce"] = own
    return ids, vals, counts, {"rows": rows, "lanes": lanes}


def _flush_graphs(torch, fns):
    """Each of `fns` captured into a CUDA graph, as a served flush's region
    captures it (after a warm-up on a side stream); the graphs and the
    outputs they write at each replay."""
    from repro_torch.kernels import ops
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns.values():
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graphs, outs = {}, {}
    for which, fn in fns.items():
        graphs[which] = torch.cuda.CUDAGraph()
        with ops.captured(), torch.cuda.graph(graphs[which]):
            outs[which] = fn()
    return graphs, outs


def _segment_lanes_case(torch, g, lens, L, k, reps=5, what="mix (b) "
                        "group_by"):
    """One served flush's group-by (`_lanes_flush`) through the lanes entry
    and through B device-count launches: every lane of both bit-equal to a
    launch over its own rows, eagerly and replayed from a graph, the lanes
    against the plain version lane by lane.  Timed eagerly and as CUDA-graph
    replays (how served lanes run), the two interleaved (B launches, lanes,
    lanes, B launches), beside one library call (`index_add_` of
    lane-offset ids into [B·K], pad rows to a sentinel).  The replays are
    timed queued on the device (`queued_ms`): a lanes replay takes about
    10 us, so one host stall in `time_ms`'s window outweighs it.  The
    replays must favour the lanes entry.  (Their device time by
    torch.profiler: `phase_lanes_trace`, after the other phases.)"""
    from repro_torch.kernels import ops
    from repro_torch.kernels.segment_reduce import (segment_reduce,
                                                     segment_reduce_lanes_plain)
    B = len(lens)
    ids, vals, counts, fns = _lanes_flush(torch, g, lens, L, k)
    before = ops.launch_counts()
    got = fns["lanes"]()
    after = ops.launch_counts()
    launches = after["segment_reduce[lanes]"] - before["segment_reduce[lanes]"]
    require(launches == -(-B // 32),
            f"segment_reduce lanes: {launches} lanes launches for {B} lanes")
    one = fns["rows"]()
    want = segment_reduce_lanes_plain(list(ids), list(vals), k, counts)
    graphs, outs = _flush_graphs(torch, fns)
    for which in fns:
        graphs[which].replay()
    torch.cuda.synchronize()
    err = 0.0
    for b, n in enumerate(lens):
        host = segment_reduce(ids[b, :n], vals[b, :n], k)
        for name, x in (("lanes entry", got[b]),
                        ("device-count launch", one[b]),
                        ("lanes graph", outs["lanes"][b]),
                        ("device-count launches' graph", outs["rows"][b])):
            require(torch.equal(x.view(torch.int32), host.view(torch.int32)),
                    f"segment_reduce {what} lane {b} (n={n} of {L}): the "
                    f"{name}'s bits differ from a launch over its rows")
        err = max(err, float((got[b] - want[b]).abs().max()))
    require(err <= 1e-4 * float(want.abs().max()) + 1e-6,
            f"segment_reduce {what} lanes: err {err} against the plain "
            "version")
    flat = torch.where(torch.arange(L, device="cuda")[None, :]
                       < counts[:, None],
                       ids.to(torch.int64)
                       + k * torch.arange(B, device="cuda")[:, None],
                       B * k).reshape(-1)
    vflat = vals.reshape(-1)

    def lib():
        return torch.zeros(B * k + 1, device="cuda").index_add_(0, flat,
                                                                vflat)
    eager = {"rows": [], "lanes": []}
    replay = {"rows": [], "lanes": []}
    for which in ("rows", "lanes", "lanes", "rows"):
        eager[which].append(time_ms(torch, fns[which], reps))
        replay[which].append(queued_ms(torch, graphs[which].replay, reps))
    plain_ms = time_ms(torch, lambda: segment_reduce_lanes_plain(
        list(ids), list(vals), k, counts), reps)
    library_ms = time_ms(torch, lib, reps)
    bound_ms = (8 * sum(lens) + 4 * B * k) / HBM_BYTES_S * 1e3
    path = "small" if k <= 2048 else "bucketed"
    rec = dict(case=f"segment_reduce lanes, one {what} flush: B={B} lanes "
               f"of L={L} padded rows ({min(lens)}..{max(lens)} counted), "
               f"K={k}, + ({path} path)", max_abs_err=err,
               kernel_ms=sum(eager["lanes"]) / 2,
               rows_ms=eager["rows"], lanes_ms=eager["lanes"],
               graph_rows_ms=replay["rows"], graph_lanes_ms=replay["lanes"],
               graph_speedup=sum(replay["rows"]) / sum(replay["lanes"]),
               rows_library="parent" if PARENT_LIBS else "this tree",
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
               bound_by="bytes", lanes_launches_a_pass=launches,
               rows_launches_a_flush=B)
    log("[kernels] " + json.dumps(rec))
    require(rec["graph_speedup"] > 1.0,
            f"segment_reduce {what}: the lanes graph replays no faster than "
            f"{B} device-count launches' ({replay})")
    return rec


def _bucketed_launch(torch, ids, vals, k):
    """A wide-row group-by (+) as the earlier wrapper launched it: the rows
    widened to float32, `_bucket_plan`'s split, the C entry
    `segment_reduce_launch` (unchanged): --parent's side of the wide
    route's timings."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.segment_reduce import _bucket_plan
    v = vals.float().contiguous()
    n, d = v.shape
    blocks, shift, nbytes = _bucket_plan(n, d, k, d)
    out = torch.empty((k, d), dtype=torch.float32, device=v.device)
    scratch = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=v.device)
    code = _build.load("segment_reduce").segment_reduce_launch(
        0, 0, ids.data_ptr(), v.data_ptr(), out.data_ptr(), n, d, d, k,
        torch.cuda.current_stream().cuda_stream,
        int(ids.dtype == torch.int64), scratch.data_ptr(), nbytes, blocks,
        shift)
    _build.check("segment_reduce", code)
    return out


# the MoE combine's shapes (phase 2): (tokens, rows a token, width) of
# qwen3-moe-30b-a3b's 2048-token prefill (top 8 of 128 experts, d_model
# 2048), a decode tick at 4 slots, a training microbatch of 4 x 2048
# tokens, and arctic-480b's 2048-token prefill (top 2, d_model 7168)
MOE_SHAPES = {"prefill": (MOE_TOKENS, MOE_TOP_K, MOE_D),
              "decode": (SERVE_SLOTS, MOE_TOP_K, MOE_D),
              "training": (4 * MOE_TOKENS, MOE_TOP_K, MOE_D),
              "arctic": (MOE_TOKENS, 2, 7168)}


def _segment_moe_case(torch, g, t, k, d, reps=5, what="prefill"):
    """The MoE combine (models/moe.py's `segment_add`): t tokens of k bf16
    rows of width d, ids in runs of k (int64, as the model hands them in),
    summed in float32 into [t, d] on the wide route.  Held against the
    plain version and launched twice with the same bits; timed beside
    `index_add_` of the same rows and the reshape-and-sum, which computes
    the same function here because the ids are sorted in runs of k; with
    --parent against the earlier kernel (`_bucketed_launch`)."""
    from repro_torch.kernels.segment_reduce import (segment_reduce,
                                                     segment_reduce_plain)
    dev = "cuda"
    n = t * k
    ids = torch.arange(t, device=dev).repeat_interleave(k)
    vals = torch.randn((n, d), generator=g, device=dev).to(torch.bfloat16)
    got = segment_reduce(ids, vals, t)
    again = segment_reduce(ids, vals, t)
    torch.cuda.synchronize()
    require(got.dtype == torch.float32
            and torch.equal(got.view(torch.int32), again.view(torch.int32)),
            f"segment_reduce MoE combine N={n} K={t} D={d}: two launches "
            "differ in their bits")
    del again
    want = segment_reduce_plain(ids, vals, t)
    diff = (got - want).abs()
    scale = segment_reduce_plain(ids, vals.abs(), t)
    err = float(diff.max())
    require(bool((diff <= 1e-4 * scale + 1e-6).all()),
            f"segment_reduce MoE combine N={n} K={t} D={d}: err {err}")

    def reshape_sum():
        return vals.view(t, k, d).sum(1, dtype=torch.float32)
    reshape_err = float((got - reshape_sum()).abs().max())
    del want, diff, scale
    kern = _kernel_ms(torch, "segment_reduce",
                      lambda: segment_reduce(ids, vals, t), reps,
                      parent_fn=lambda: _bucketed_launch(torch, ids, vals, t),
                      entry="segment_reduce_wide_launch")
    plain_ms = time_ms(torch, lambda: segment_reduce_plain(ids, vals, t),
                       reps)
    library_ms = time_ms(torch, lambda: torch.zeros(
        (t, d), dtype=torch.float32, device=dev).index_add_(
        0, ids, vals.float()), reps)
    reshape_ms = time_ms(torch, reshape_sum, reps)
    # ids and bf16 rows read once, the float32 [t, d] written once
    bytes_ = ids.element_size() * n + 2 * n * d + 4 * t * d
    rec = dict(case=f"segment_reduce MoE combine ({what}) N={n} K={t} "
               f"D={d} + bfloat16 rows, ids in runs of {k}, wide route",
               max_abs_err=err,
               tol="1e-4*sum|v| per segment against the plain version; "
                   "bit-equal across launches",
               reshape_sum_err=reshape_err, **kern, plain_ms=plain_ms,
               library_ms=library_ms, reshape_sum_ms=reshape_ms,
               bound_ms=bytes_ / HBM_BYTES_S * 1e3, bound_by="bytes")
    return _rates(rec, n * d)


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
    timed = _kernel_ms(torch, "tile_matmul", kern, reps)
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
               max_abs_err=err, tol=f"{tol:.3g} abs", **timed,
               plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    return _rates(rec, flops)


def _attended_pairs(sq, sk, causal, window):
    """The (query, key) pairs a mask keeps: causal keys j <= i, window keys
    j > i - window (the work of this run's shape, not the most it could
    be)."""
    i = [min(sk - 1, r) if causal else sk - 1 for r in range(sq)]
    lo = [max(0, r - window + 1) if window > 0 else 0 for r in range(sq)]
    return sum(max(0, h - l + 1) for h, l in zip(i, lo))


def _flash_case(torch, g, bh, s, hd, dtype, reps=5, sk=None, causal=True,
                window=0, again=False):
    """Attention at a prefill's shape [B·Hq, S, hd]: causal (with a local
    window when `window` > 0), or full with `sk` keys (an encoder, or
    cross-attention when sk != s).  `again`: a second launch must give the
    same bits.  A shape of the wgmma route (bf16, hd 64 or 256, S ≥ 64)
    also checks that the route took it, and --parent times the earlier
    library through the entry its wrapper called there
    (`_flash_launch_parent`)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (_route, flash_attention,
                                                     flash_attention_plain)
    dt = getattr(torch, dtype)
    sk = s if sk is None else sk
    q = torch.randn(bh, s, hd, generator=g, device="cuda").to(dt)
    k, v = (torch.randn(bh, sk, hd, generator=g, device="cuda").to(dt)
            for _ in range(2))
    kw = dict(causal=causal, window=window)
    wg = _route(dt, hd, s) == "wgmma"
    before = ops.launch_counts()["flash_attention[wg]"]
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    form = ("causal" if causal else "full") \
        + (f" window {window}" if window else "")
    shape = f"[{bh}, {s}, {hd}]" + ("" if sk == s else
                                    f"x[{bh}, {sk}, {hd}]")
    require(got.dtype == dt and got.shape == want.shape,
            f"flash_attention {form} {shape} {dtype}: got {got.dtype} "
            f"{tuple(got.shape)}")
    require(ops.launch_counts()["flash_attention[wg]"] == before + wg,
            f"flash_attention {form} {shape} {dtype}: the wgmma route "
            f"{'not ' if wg else ''}taken")
    if again:
        require(torch.equal(flash_attention(q, k, v, **kw), got),
                f"flash_attention {form} {shape} {dtype}: a second launch "
                "gave other bits")
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    # per query row: a row that attends to i keys has outputs of about
    # sqrt(e/i), so a whole-tensor scale (set by the first rows) would let
    # a dropped or stale key tile through in the long rows.  bf16: both
    # round the output to bf16 (1 ulp is 2^-8 to 2^-7 relative); float32:
    # the same sums in another order, and __expf
    rel = 1e-2 if dtype == "bfloat16" else 1e-4
    ref = want.float().abs()
    row_err = float((diff.amax(-1) / ref.amax(-1).clamp_min(1e-30)).max())
    require(row_err <= rel,
            f"flash_attention {form} {shape} {dtype}: worst query row "
            f"err/max|ref row| {row_err:.3g} > {rel} (whole tensor: err/"
            f"max|ref| {err / float(ref.max()):.3g})")
    del want, diff, ref
    kern = _kernel_ms(torch, "flash_attention",
                      lambda: flash_attention(q, k, v, **kw), reps,
                      parent_fn=(lambda: _flash_launch_parent(
                          torch, q, k, v, **kw)) if wg else None,
                      entry="flash_attention_wg_launch")
    plain_ms = time_ms(torch, lambda: flash_attention_plain(q, k, v, **kw),
                       reps if window == 0 else 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # as [1, BH, S, hd]: PyTorch's fused attention backends take 4-d inputs
    q4, k4, v4 = q[None], k[None], v[None]
    if window:
        kp = torch.arange(sk, device="cuda")[None, :]
        qp = torch.arange(s, device="cuda")[:, None]
        mask = (kp > qp - window) & ((kp <= qp) if causal else True)
        library = "scaled_dot_product_attention(attn_mask=the window)"
        library_ms = time_ms(torch, lambda: sdpa(q4, k4, v4, attn_mask=mask),
                             reps)
        del mask
    else:
        library = f"scaled_dot_product_attention(is_causal={causal})"
        library_ms = time_ms(torch, lambda: sdpa(q4, k4, v4,
                                                 is_causal=causal), reps)
    esize = 2 if dtype == "bfloat16" else 4
    flops = 4.0 * bh * hd * _attended_pairs(s, sk, causal, window)
    bytes_ = 2.0 * bh * (s + sk) * hd * esize    # q, k, v read; out written
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = bytes_ / HBM_BYTES_S * 1e3
    rec = dict(case=f"flash_attention {form} {shape} {dtype}",
               route=_route(dt, hd, s), max_abs_err=err, row_rel_err=row_err,
               tol=f"{rel:g}*max|ref row| per query row", **kern,
               plain_ms=plain_ms, library_ms=library_ms, library=library,
               bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               same_bits_twice=again or None)
    return _rates(rec, flops)


def _flash_launch_parent(torch, q, k, v, causal, window):
    """The bf16 forward as the earlier wrapper launched it at hd 64 and
    256: the C entry `flash_attention_launch` (unchanged) of the library
    `_kernel_ms` installed, which has no wgmma route: --parent's side of
    the wgmma route's timings."""
    from repro_torch.kernels import _build
    out = torch.empty_like(q)
    bh, s, hd = q.shape
    code = _build.load("flash_attention").flash_attention_launch(
        1, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s,
        k.shape[1], hd, hd ** -0.5, int(causal), window,
        torch.cuda.current_stream().cuda_stream)
    _build.check("flash_attention", code)
    return out


def _scan_case(torch, g, b, s, d, n, with_h0, reps=5, rglru=False):
    """The scan's (a, bx) entry at a prefill chunk's shape [B, S, D, N]:
    with h0 and the final state (a chunk after the first), or without
    either (the TPU kernel's form).  `rglru`: as the rec layer calls it
    (N = 1, c = 1, so y is the state; recurrentgemma-2b's lru_width
    2560), launched twice with the same bits."""
    from repro_torch.kernels.selective_scan import (selective_scan,
                                                    selective_scan_plain)
    dev = "cuda"
    a = torch.exp(-torch.randn(b, s, d, n, generator=g, device=dev).abs())
    bx = torch.randn(b, s, d, n, generator=g, device=dev) * 0.1
    c = torch.ones(b, s, n, device=dev) if rglru else \
        torch.randn(b, s, n, generator=g, device=dev)
    h0 = torch.randn(b, d, n, generator=g, device=dev) if with_h0 else None
    if with_h0:
        got = selective_scan(a, bx, c, h0, return_state=True)
        want = selective_scan_plain(a, bx, c, h0, return_state=True)
        if rglru:
            again = selective_scan(a, bx, c, h0, return_state=True)
            require(all(torch.equal(x, y) for x, y in zip(got, again)),
                    f"selective_scan [{b}, {s}, {d}, {n}]: a second launch "
                    "gave other bits")
    else:
        # the TPU kernel's form, and the same call asking for the state
        got = (selective_scan(a, bx, c),
               selective_scan(a, bx, c, return_state=True)[1])
        want = selective_scan_plain(a, bx, c, return_state=True)
    torch.cuda.synchronize()
    err = 0.0
    for name, x, ref in zip(("y", "h_last"), got, want):
        e = float((x - ref).abs().max())
        tol = 1e-4 * float(ref.abs().max())
        require(e <= tol, f"selective_scan [{b}, {s}, {d}, {n}] "
                          f"h0={with_h0} {name}: err {e} > {tol}")
        err = max(err, e)
    kern = _kernel_ms(torch, "selective_scan", lambda: selective_scan(
        a, bx, c, h0, return_state=with_h0), reps,
        parent_fn=(lambda: _scan_launch_n1_parent(torch, a, bx, c, h0,
                                                  with_h0)) if n == 1
        else None, entry="selective_scan_n1_launch")
    # the plain version walks S in Python: at N = 1 (the RG-LRU's 4096-
    # and 8192-step cases, half a second a call) one timed call after the
    # check's
    plain_ms = time_ms(torch, lambda: selective_scan_plain(
        a, bx, c, h0, return_state=with_h0), *((1, 0) if n == 1 else (2,)))
    state = 4 * b * d * n * (2 if with_h0 else 0)   # h0 read, h_last written
    bytes_ = 4.0 * (2 * b * s * d * n + b * s * n + b * s * d) + state
    rec = dict(case=f"selective_scan [{b}, {s}, {d}, {n}] float32 "
               + ("h0 and h_last" if with_h0 else "from zero, y only")
               + (", c = 1 (the RG-LRU), same bits twice" if rglru else ""),
               max_abs_err=err, tol="1e-4*max|ref| (y and h_last)",
               **kern, plain_ms=plain_ms, library_ms=None,
               library="none (no single PyTorch call)",
               bound_ms=bytes_ / HBM_BYTES_S * 1e3, bound_by="bytes")
    return _rates(rec, 4 * b * s * d * n)    # h = a·h + bx; y += c·h


def _scan_launch_n1_parent(torch, a, bx, c, h0, with_state):
    """The (a, bx) entry at N = 1 as the earlier wrapper launched it: the
    C entry `selective_scan_launch` (unchanged), which the current library
    refuses at N = 1: --parent's side of the N = 1 timings."""
    from repro_torch.kernels import _build
    b, s, d, n = a.shape
    y = torch.empty((b, s, d), dtype=torch.float32, device=a.device)
    h_last = torch.empty((b, d, n), dtype=torch.float32, device=a.device) \
        if with_state else None
    code = _build.load("selective_scan").selective_scan_launch(
        a.data_ptr(), bx.data_ptr(), c.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(),
        None if h_last is None else h_last.data_ptr(), b, s, d, n,
        torch.cuda.current_stream().cuda_stream)
    _build.check("selective_scan", code)
    return y


def _fused_scan_case(torch, g, b, s, d, n, x_dtype, with_h0=False, reps=5):
    """The fused entry at a falcon-mamba-7b prefill's shape: one call over
    the whole prompt from the model's dt, A, B, C and x, returning the
    final state, from zero as the prefill starts (or from an h0).  Also
    times the parent's path for the same function (the [B, S, D, N]
    discretisation in torch, then the (a, bx) entry)."""
    import importlib
    scan = importlib.import_module("repro_torch.kernels.selective_scan")
    dev = "cuda"
    dt = torch.nn.functional.softplus(
        torch.rand(b, s, d, generator=g, device=dev) * 4 - 6)
    A = -torch.arange(1, n + 1, device=dev, dtype=torch.float32).repeat(
        d, 1) * (0.5 + torch.rand(d, 1, generator=g, device=dev))
    Bm, Cm = (torch.randn(b, s, n, generator=g, device=dev) for _ in range(2))
    x = torch.randn(b, s, d, generator=g, device=dev).to(
        getattr(torch, x_dtype))
    h0 = torch.randn(b, d, n, generator=g, device=dev) if with_h0 else None
    got = scan.selective_scan_fused(dt, A, Bm, Cm, x, h0, return_state=True)
    want = scan.selective_scan_fused_plain(dt, A, Bm, Cm, x, h0,
                                           return_state=True)
    torch.cuda.synchronize()
    err = 0.0
    for name, v, ref in zip(("y", "h_last"), got, want):
        e = float((v - ref).abs().max())
        tol = 1e-4 * float(ref.abs().max())
        require(e <= tol, f"selective_scan_fused [{b}, {s}, {d}, {n}] x "
                          f"{x_dtype} {name}: err {e} > {tol}")
        err = max(err, e)
    del want
    torch.cuda.empty_cache()

    def fused():
        return scan.selective_scan_fused(dt, A, Bm, Cm, x, h0,
                                         return_state=True)

    def unfused():
        a = torch.exp(dt[..., None] * A)
        bx = (dt * x.float())[..., None] * Bm[..., None, :]
        return scan.selective_scan(a, bx, Cm, h0, return_state=True)
    kern = _kernel_ms(torch, "selective_scan", fused, reps)
    unfused_ms = time_ms(torch, unfused, 2)
    plain_ms = time_ms(torch, lambda: scan.selective_scan_fused_plain(
        dt, A, Bm, Cm, x, h0, return_state=True), 1, warmup=0)
    torch.cuda.empty_cache()
    esize = 2 if x_dtype == "bfloat16" else 4
    state = 4 * b * d * n * (2 if with_h0 else 1)    # h0 read, h_last written
    bytes_ = (4 + esize + 4) * b * s * d + 4 * d * n + 8 * b * s * n + state
    t_bytes = bytes_ / HBM_BYTES_S * 1e3
    # ~7 float32 operations a (t, d, n): dt·A, dt·x·B (2), h = a·h + bx (2),
    # y += c·h (2); one exponential a (t, d, n) at EXP_PER_S
    flops = 7.0 * b * s * d * n
    t_flops = flops / PEAK_FLOPS["float32"] * 1e3
    t_exp = b * s * d * n / EXP_PER_S * 1e3
    bound = max(t_bytes, t_flops, t_exp)
    rec = dict(case=f"selective_scan_fused [{b}, {s}, {d}, {n}] x {x_dtype}"
               + (", h0 and h_last" if with_h0 else ", h_last"),
               max_abs_err=err, tol="1e-4*max|ref| (y and h_last)",
               **kern, unfused_ms=unfused_ms, plain_ms=plain_ms,
               library_ms=None, library="none (no single PyTorch call)",
               bound_parts_ms=dict(bytes=t_bytes, float32=t_flops,
                                   exp=t_exp),
               bound_ms=bound,
               bound_by="bytes" if bound == t_bytes else "operations")
    return _rates(rec, flops)


def _grad_errs(what, got, want, tols):
    """max |got − want| of each named gradient, each within its tolerance
    times max |want|; returns the largest error."""
    worst = 0.0
    for name, g, w, tol in zip(tols, got, want, tols.values()):
        e = float((g.float() - w.float()).abs().max())
        bound = tol * float(w.float().abs().max())
        require(e <= bound, f"{what} {name}: err {e:.4g} > {tol:g}*max|ref| "
                            f"= {bound:.4g}")
        worst = max(worst, e)
    return worst


def _flash_bwd_case(torch, g, bh, s, hd, dtype, reps=5, plain_reps=2,
                    sk=None, causal=True, window=0):
    """The backward of attention at a training shape [B·Hq, S, hd]:
    causal (within a local window when `window` > 0), or full with `sk`
    keys (an encoder, or cross-attention when sk != s).  The kernel (from
    the forward kernel's lse) against the plain formula, a second launch
    bit-equal, and one backward of PyTorch's scaled_dot_product_attention
    (with the window's mask where there is one) as the library call.  A
    shape of the backward's wgmma routes (bf16 at hd 64, 128 and 256)
    also checks that the route took it, and of its split route (bf16 at
    hd 64, not causal) that route's own count.  With --parent the kernel
    is timed against the earlier library, interleaved; a split shape
    through `_flash_bwd_launch_parent`, with the earlier library's
    scratch."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        WG_BWD_ROUTES, _bwd_route, flash_attention, flash_attention_bwd,
        flash_attention_bwd_plain, flash_attention_plain)
    dt = getattr(torch, dtype)
    sk = s if sk is None else sk
    q, do = (torch.randn(bh, s, hd, generator=g, device="cuda").to(dt)
             for _ in range(2))
    k, v = (torch.randn(bh, sk, hd, generator=g, device="cuda").to(dt)
            for _ in range(2))
    kw = dict(causal=causal, window=window)
    form = ("causal" if causal else "full") \
        + (f" window {window}" if window else "")
    shape = f"[{bh}, {s}, {hd}]" + ("" if sk == s else f"x[{bh}, {sk}, {hd}]")
    what = f"{form} {shape} {dtype}"
    o, lse = flash_attention(q, k, v, return_lse=True, **kw)
    # the training entry writes the serving entry's output bits
    require(torch.equal(o, flash_attention(q, k, v, **kw)),
            f"flash_attention {what}: the lse entry's output differs from "
            "the serving entry's")
    # the kernel's lse against the plain version's: both float32 sums of
    # the same products, so they differ in summation order only
    wo, wlse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    lse_tol = 1e-3
    lse_err = float((lse - wlse).abs().max())
    log(f"[kernels] flash_attention lse {what}: max abs err {lse_err:.3g} "
        f"against the plain version (tol {lse_tol:g})")
    require(lse_err <= lse_tol,
            f"flash_attention {what}: lse err {lse_err:.4g} > {lse_tol:g}")
    route = _bwd_route(dt, hd, causal)
    before = ops.launch_counts()
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    after = ops.launch_counts()
    for key, took in (("flash_attention_bwd[wg]", route in WG_BWD_ROUTES),
                      ("flash_attention_bwd[full, hd 64]",
                       route == "wgmma-split")):
        require(after[key] == before[key] + took,
                f"flash_attention_bwd {what}: {key} "
                f"{'not ' if took else ''}counted")
    # the reference takes nothing from the kernels under test
    want = flash_attention_bwd_plain(q, k, v, wo, wlse, do, **kw)
    del wo, wlse
    torch.cuda.synchronize()
    # bf16: the kernel rounds P and dS to bf16 for the tensor cores (the
    # plain formula keeps them float32), then rounds the sums to bf16
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    err = _grad_errs(f"flash_attention_bwd {what}", got, want,
                     dict(dq=tol, dk=tol, dv=tol))
    del want
    again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            f"flash_attention_bwd {what}: a second launch gave other bits")
    del got, again
    torch.cuda.empty_cache()
    timed = _kernel_ms(torch, "flash_attention_bwd",
                       lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw),
                       reps, parent_fn=(lambda: _flash_bwd_launch_parent(
                           torch, q, k, v, o, lse, do))
                       if route == "wgmma-split" else None)
    plain_ms = time_ms(torch, lambda: flash_attention_bwd_plain(
        q, k, v, o, lse, do, **kw), plain_reps,
        warmup=1 if plain_reps > 1 else 0)
    torch.cuda.empty_cache()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = (x[None].detach().requires_grad_() for x in (q, k, v))
    if window:
        kp = torch.arange(sk, device="cuda")[None, :]
        qp = torch.arange(s, device="cuda")[:, None]
        mask = (kp > qp - window) & (kp <= qp)
        out4 = sdpa(q4, k4, v4, attn_mask=mask)
        library = ("autograd of scaled_dot_product_attention(attn_mask="
                   "the window): its backward alone")
    else:
        out4 = sdpa(q4, k4, v4, is_causal=causal)
        library = (f"autograd of scaled_dot_product_attention(is_causal="
                   f"{causal}): its backward alone")
    library_ms = time_ms(torch, lambda: torch.autograd.grad(
        out4, (q4, k4, v4), do[None], retain_graph=True), reps)
    del out4, q4, k4, v4
    torch.cuda.empty_cache()
    esize = 2 if dtype == "bfloat16" else 4
    # 5 products over the kept pairs: S = QKᵀ (recomputed), dP = dO Vᵀ,
    # dV = Pᵀ dO, dQ = dS K, dK = dSᵀ Q
    flops = 5 * 2.0 * bh * hd * _attended_pairs(s, sk, causal, window)
    # q, o, dO read and dq written [BH, S, hd]; k, v read and dk, dv
    # written [BH, Sk, hd]; lse read
    bytes_ = 4.0 * bh * (s + sk) * hd * esize + 4.0 * bh * s
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = bytes_ / HBM_BYTES_S * 1e3
    rec = dict(case=f"flash_attention_bwd {what}",
               route=route,
               max_abs_err=err, tol=f"{tol:g}*max|ref| (dq, dk, dv)",
               **timed, plain_ms=plain_ms, library_ms=library_ms,
               library=library, bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               same_bits_twice=True)
    return _rates(rec, flops)


def _flash_bwd_launch_parent(torch, q, k, v, o, lse, do):
    """The bf16 backward at hd 64 not causal as the earlier wrapper
    launched it: the same C entry (`flash_attention_bwd_launch`) of the
    library `_kernel_ms` installed, whose one-pass kernel writes its sync
    words and dQ workspace after D, so the scratch is that kernel's size
    (`_bwd_scratch_floats` as the earlier wrapper computed it): --parent's
    side of the split route's timings."""
    from repro_torch.kernels import _build
    bh, sq, hd = q.shape
    tiles = bh * -(-sq // 64)
    d = torch.empty(-(-(bh * sq + 1 + tiles) // 4) * 4 + tiles * 64 * hd,
                    dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    code = _build.load("flash_attention_bwd").flash_attention_bwd_launch(
        1, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), d.data_ptr(), bh, sq, k.shape[1], hd, hd ** -0.5,
        0, 0, torch.cuda.current_stream().cuda_stream)
    _build.check("flash_attention_bwd", code)
    return dq, dk, dv


def _abx_bwd_case(torch, g, b, s, d, reps=5):
    """The scan's (a, bx) backward at N = 1 at a recurrentgemma-2b
    training shape [B, S, lru_width]: from the forward's states (the (a,
    bx) entry's y with c = 1, from an h0) with the final state's
    gradient, the kernel against its plain version (the same chunk order,
    each sum and product rounded alone in both: 1e-6 of max|ref|, and
    whether the bits are equal), a second launch bit-equal.  With
    --parent the earlier library is timed through the entry its wrapper
    called (`_abx_bwd_launch_parent`)."""
    import importlib
    scan = importlib.import_module("repro_torch.kernels.selective_scan")
    dev = "cuda"
    a = torch.exp(-torch.randn(b, s, d, generator=g, device=dev).abs())
    bx = torch.randn(b, s, d, generator=g, device=dev) * 0.1
    h0, dh = (torch.randn(b, d, generator=g, device=dev) for _ in range(2))
    dy = torch.randn(b, s, d, generator=g, device=dev)
    h, _ = scan.selective_scan(a[..., None], bx[..., None],
                               torch.ones(b, s, 1, device=dev),
                               h0[..., None], return_state=True)
    what = f"selective_scan_bwd[a, bx] [{b}, {s}, {d}, 1]"
    got = scan.selective_scan_bwd(a, h, h0, dy, dh)
    want = scan.selective_scan_bwd_plain(a, h, h0, dy, dh)
    torch.cuda.synchronize()
    tol = 1e-6
    err = _grad_errs(what, got, want, dict(da=tol, dbx=tol, dh0=tol))
    same_as_plain = all(bool(torch.equal(x, y)) for x, y in zip(got, want))
    del want
    again = scan.selective_scan_bwd(a, h, h0, dy, dh)
    require(all(torch.equal(x, y) for x, y in zip(got, again)),
            f"{what}: a second launch gave other bits")
    del got, again
    timed = _kernel_ms(torch, "selective_scan_bwd",
                       lambda: scan.selective_scan_bwd(a, h, h0, dy, dh),
                       reps, parent_fn=lambda: _abx_bwd_launch_parent(
                           torch, a, h, h0, dy, dh),
                       entry="selective_scan_n1_bwd_launch")
    plain_ms = time_ms(torch, lambda: scan.selective_scan_bwd_plain(
        a, h, h0, dy, dh), 2)
    # read once: a, h, dy [B, S, D], h0, dh_last [B, D]; written once: da,
    # dbx [B, S, D], dh0 [B, D]
    bytes_ = 4.0 * 5 * b * s * d + 4.0 * 3 * b * d
    rec = dict(case=f"{what} float32, h0 and dh_last, same bits twice",
               max_abs_err=err, tol=f"{tol:g}*max|ref| (da, dbx, dh0)",
               bits_equal_to_plain=same_as_plain, **timed,
               plain_ms=plain_ms, library_ms=None,
               library="none (no single PyTorch call)",
               bound_ms=bytes_ / HBM_BYTES_S * 1e3, bound_by="bytes")
    return _rates(rec, 4.0 * b * s * d)   # g = dy + c, da, c = a·g


def _abx_bwd_launch_parent(torch, a, h, h0, dy, dh):
    """The (a, bx) backward as the earlier wrapper launched it: the C entry
    `selective_scan_abx_bwd_launch` (one reverse walk a channel), which the
    current library replaced by `selective_scan_n1_bwd_launch`: --parent's
    side of its timings."""
    import ctypes
    from repro_torch.kernels import _build
    b, s, d = a.shape
    da, dbx = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.empty((b, d), dtype=torch.float32, device=a.device)
    fn = _build.load("selective_scan_bwd").selective_scan_abx_bwd_launch
    fn.argtypes = [*[ctypes.c_void_p] * 8, *[ctypes.c_int] * 3,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(a.data_ptr(), h.data_ptr(), h0.data_ptr(), dy.data_ptr(),
              dh.data_ptr(), da.data_ptr(), dbx.data_ptr(), dh0.data_ptr(),
              b, s, d, torch.cuda.current_stream().cuda_stream)
    _build.check("selective_scan_bwd", code)
    return da


def _scan_bwd_case(torch, g, b, s, d, n, x_dtype, reps=5):
    """The fused scan's backward at a falcon-mamba-7b training step's
    shape: the kernel (from the forward's checkpoint states) against the
    plain reverse walk, a second launch bit-equal.  With --parent the
    kernel is timed against the earlier library, interleaved."""
    import importlib
    scan = importlib.import_module("repro_torch.kernels.selective_scan")
    dev = "cuda"
    dt = torch.nn.functional.softplus(
        torch.rand(b, s, d, generator=g, device=dev) * 4 - 6)
    A = -torch.arange(1, n + 1, device=dev, dtype=torch.float32).repeat(
        d, 1) * (0.5 + torch.rand(d, 1, generator=g, device=dev))
    Bm, Cm = (torch.randn(b, s, n, generator=g, device=dev) for _ in range(2))
    x = torch.randn(b, s, d, generator=g, device=dev).to(
        getattr(torch, x_dtype))
    dy = torch.randn(b, s, d, generator=g, device=dev)
    y, _, states = scan._fused_launch(dt, A, Bm, Cm, x, None, True, True)
    # the training entry writes the serving entry's output bits
    require(torch.equal(y, scan.selective_scan_fused(dt, A, Bm, Cm, x)),
            f"selective_scan_fused [{b}, {s}, {d}, {n}]: the checkpoint "
            "entry's y differs from the serving entry's")
    del y
    got = scan.selective_scan_fused_bwd(dt, A, Bm, Cm, x, None, dy,
                                        states=states)
    want = scan.selective_scan_fused_bwd_plain(dt, A, Bm, Cm, x, None, dy)
    torch.cuda.synchronize()
    # exp2f of a pre-scaled argument (as the forward) against exp, and the
    # sums over D and B·S in another order; dx in bf16: one rounding
    tol = 1e-4
    dx_tol = 8e-3 if x_dtype == "bfloat16" else tol
    err = _grad_errs(f"selective_scan_bwd [{b}, {s}, {d}, {n}] x {x_dtype}",
                     got, want, dict(ddt=tol, dA=tol, dBm=tol, dCm=tol,
                                     dx=dx_tol, dh0=tol))
    del want
    torch.cuda.empty_cache()
    again = scan.selective_scan_fused_bwd(dt, A, Bm, Cm, x, None, dy,
                                          states=states)
    require(all(torch.equal(p, q) for p, q in zip(got, again)),
            f"selective_scan_bwd [{b}, {s}, {d}, {n}]: a second launch gave "
            "other bits")
    del got, again
    timed = _kernel_ms(torch, "selective_scan_bwd",
                       lambda: scan.selective_scan_fused_bwd(
                           dt, A, Bm, Cm, x, None, dy, states=states), reps)
    plain_ms = time_ms(torch, lambda: scan.selective_scan_fused_bwd_plain(
        dt, A, Bm, Cm, x, None, dy), 1, warmup=0)
    torch.cuda.empty_cache()
    esize = 2 if x_dtype == "bfloat16" else 4
    elems = b * s * d
    # read once: dt, x, dy [B, S, D], A, Bm, Cm; written once: ddt, dx
    # [B, S, D], dA, dBm, dCm, dh0.  The forward's checkpoint states are
    # this kernel's design, not the function's: not counted
    bytes_ = (4 + esize + 4) * elems + (4 + esize) * elems \
        + 2 * 4 * d * n + 4 * 4 * b * s * n + 4 * b * d * n
    t_bytes = bytes_ / HBM_BYTES_S * 1e3
    # one exponential a (t, d, n) (a_t, needed by the reverse walk), ~16
    # float32 operations a (t, d, n) (g, g·B, dz, the four partial sums,
    # the carry)
    t_exp = elems * n / EXP_PER_S * 1e3
    flops = 16.0 * elems * n
    t_flops = flops / PEAK_FLOPS["float32"] * 1e3
    bound = max(t_bytes, t_exp, t_flops)
    rec = dict(case=f"selective_scan_bwd [{b}, {s}, {d}, {n}] x {x_dtype}",
               max_abs_err=err,
               tol=f"{tol:g}*max|ref| (dx in bf16: {dx_tol:g})",
               **timed, plain_ms=plain_ms, library_ms=None,
               library="none (no single PyTorch call)",
               bound_parts_ms=dict(bytes=t_bytes, float32=t_flops,
                                   exp=t_exp),
               bound_ms=bound,
               bound_by="bytes" if bound == t_bytes else "operations")
    return _rates(rec, flops)


def _hybrid_audio_cases(torch, g):
    """The shapes the hybrid and audio families give the two kernels
    (phases 4 and 8): one lattn layer of recurrentgemma-2b's 8192-token
    prefill (10 query heads on its one KV head, hd 256, window 2048), of
    the 2048-token one, and of a training microbatch (4096 tokens within
    the window: the forward of phase 8's step); the float32 check's
    variant over ragged tiles; whisper-tiny's encoder at 4 requests (6
    heads, 1500 frames, hd 64) and a decode tick's cross-attention; the
    rec layer's RG-LRU on the scan's (a, bx) entry.  Each held against its
    plain version and launched twice with the same bits.  Returns the
    RG-LRU's record, the (a, bx) entry's item of the kernels line, and the
    2048-token lattn layer's, the flash wgmma route's item."""
    from repro_torch.configs import get_config
    rg, wh = get_config("recurrentgemma-2b"), get_config(AUDIO_ARCH)
    (long_s, _), = SERVE_LONG.values()
    hq, hd = rg.num_heads, rg.head_dim
    _, rg_batch, rg_seq = TRAIN_ARCHS["recurrentgemma-2b"]
    flash = [_flash_case(torch, g, hq, long_s, hd, "bfloat16",
                         window=rg.window, again=True),
             _flash_case(torch, g, hq, PROMPT_LENS[0], hd, "bfloat16",
                         again=True),
             _flash_case(torch, g, rg_batch // rg.microbatch * hq, rg_seq, hd,
                         "bfloat16", window=rg.window, again=True),
             _flash_case(torch, g, hq, PROMPT_LENS[1], hd, "float32",
                         window=256, again=True)]
    bh = AUDIO_BATCH * wh.num_heads
    flash += [_flash_case(torch, g, bh, wh.enc_seq, wh.head_dim, "bfloat16",
                          causal=False, again=True),
              _flash_case(torch, g, bh, 1, wh.head_dim, "bfloat16",
                          sk=wh.enc_seq, causal=False, again=True)]
    torch.cuda.empty_cache()
    # the RG-LRU at a 2048- and the 8192-token prefill, a training
    # microbatch's (phase 8's step: 2 x 4096 tokens in microbatches of
    # one row) and the whole batch's
    rglru = [_scan_case(torch, g, b, s, rg.lru_width, 1, True, rglru=True)
             for b, s in ((1, PROMPT_LENS[0]), (1, long_s),
                          (rg_batch // rg.microbatch, rg_seq),
                          (rg_batch, rg_seq))]
    return rglru[0], flash[1]


def _family_bwd_cases(torch, g):
    """The backwards phase 8's hybrid and audio runs take: one lattn
    layer of a recurrentgemma-2b microbatch (10 query heads on its one KV
    head, hd 256, 4096 tokens within the 2048-token window) in bf16, and
    in float32 (the float32 check's form) over ragged tiles;
    whisper-tiny's encoder and cross-attention at a microbatch's rows (8
    requests in microbatches of 2: 4 rows of 6 heads of 64; 1500 frames,
    448 tokens on them), non-causal, on the split route; the RG-LRU's (a,
    bx) backward over the microbatch, over 2048 tokens and over the whole
    batch.  Returns the windowed bf16 record, the whisper encoder's and
    the microbatch's (a, bx) one, items of the kernels line."""
    from repro_torch.configs import get_config
    rg, wh = get_config("recurrentgemma-2b"), get_config(AUDIO_ARCH)
    _, rg_batch, rg_seq = TRAIN_ARCHS["recurrentgemma-2b"]
    rg_rows = rg_batch // rg.microbatch
    hq, hd = rg.num_heads, rg.head_dim
    win = _flash_bwd_case(torch, g, rg_rows * hq, rg_seq, hd, "bfloat16",
                          window=rg.window)
    _flash_bwd_case(torch, g, hq, PROMPT_LENS[1], hd, "float32", window=256,
                    plain_reps=1)
    bh = TRAIN_ARCHS[AUDIO_ARCH][1] // wh.microbatch * wh.num_heads
    enc, _ = [_flash_bwd_case(torch, g, bh, sq, wh.head_dim, "bfloat16",
                              sk=wh.enc_seq, causal=False, plain_reps=1)
              for sq in (wh.enc_seq, TRAIN_ARCHS[AUDIO_ARCH][2])]
    torch.cuda.empty_cache()
    abx = _abx_bwd_case(torch, g, rg_rows, rg_seq, rg.lru_width)
    for b, s in ((rg_rows, PROMPT_LENS[0]), (rg_batch, rg_seq)):
        _abx_bwd_case(torch, g, b, s, rg.lru_width)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return win, enc, abx


# the AdamW cases: arch -> (layers, moments): phase 8's llama3-8b leaves
# with float32 moments, and 2 of its layers with bf16 moments (the
# configs' opt_dtype="bf16", arctic-480b's)
ADAMW_CASES = (("llama3-8b", 8, "float32"), ("llama3-8b", 2, "bfloat16"))
ADAMW_STEP = 3.0     # the bias corrections of a mid-run step
ADAMW_FLOPS = 19     # float32 operations an element: the norm's 2, 17


def _adamw_state(torch, shapes, moments, seed):
    """[parameters, gradients, first moments, second moments] of leaves of
    (shape, dtype), drawn on the card from `seed`: a mid-run state whose
    global norm is above 1 (the clip scales), gradients in the
    parameters' dtype, moments in `moments` (None: the parameters')."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    out = [[], [], [], []]
    for shape, dt in shapes:
        mdt = dt if moments is None else moments
        out[0].append((torch.randn(shape, generator=g, device="cuda")
                       * 0.02).to(dt))
        out[1].append((torch.randn(shape, generator=g, device="cuda")
                       * 1e-3).to(dt))
        out[2].append((torch.randn(shape, generator=g, device="cuda")
                       * 1e-4).to(mdt))
        out[3].append((torch.rand(shape, generator=g, device="cuda")
                       * 1e-8).to(mdt))
    return out


def _fused_adamw_ms(torch, shapes, seed, reps):
    """`torch._fused_adamw_` (torch's fused AdamW, its moments in the
    parameters' dtype: its kernel takes one dtype a list; no clipping, the
    decay applied first) over the same leaves, a call a dtype: the
    library yardstick, never on the path."""
    p, gr, m, v = _adamw_state(torch, shapes, None, seed)
    groups = {}
    for i, (_, dt) in enumerate(shapes):
        groups.setdefault(dt, []).append(i)
    steps = [torch.full((), ADAMW_STEP, device="cuda") for _ in shapes]

    def call():
        for idx in groups.values():
            torch._fused_adamw_(
                [p[i] for i in idx], [gr[i] for i in idx],
                [m[i] for i in idx], [v[i] for i in idx], [],
                [steps[i] for i in idx], lr=TRAIN_LR, beta1=0.9, beta2=0.95,
                weight_decay=0.1, eps=1e-8, amsgrad=False, maximize=False)
    ms = time_ms(torch, call, reps)
    del p, gr, m, v
    torch.cuda.empty_cache()
    return ms


def _adamw_case(torch, arch, layers, moments, seed, reps=5):
    """The multi-tensor AdamW (norm and update, two launches) over `arch`'s
    leaves at `layers` layers (a meta model's shapes and dtypes) against
    its plain versions (the chunk-ordered norm, the per-leaf update) from
    the same state: the norm, the clip scale and every parameter and
    moment bit-equal (64-bit fingerprints on the card); kernel, plain and
    `torch._fused_adamw_` ms beside the byte bound (p, g, m, v read once,
    p, m, v written once)."""
    import importlib
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    K = importlib.import_module("repro_torch.kernels.adamw")
    mdt = getattr(torch, moments)
    cfg = train_config(get_config, arch, layers)
    shapes = [(tuple(p.shape), p.dtype)
              for _, p in get_model(cfg, device="meta").named_leaves()]
    n = sum(math.prod(s) for s, _ in shapes)
    step = torch.full((), ADAMW_STEP, device="cuda")
    kw = dict(lr_t=torch.full((), TRAIN_LR, device="cuda"),
              b1t=1.0 - torch.pow(0.9, step), b2t=1.0 - torch.pow(0.95, step),
              b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, max_norm=1.0)
    what = (f"adamw {arch} {cfg.num_layers} layers: {len(shapes)} leaves, "
            f"{n} parameters, moments {moments}")
    got, times = {}, {}
    for which, fn in (("kernel", K.adamw), ("plain", K.adamw_plain)):
        st = _adamw_state(torch, shapes, mdt, seed)
        before = K.adamw.launches
        gn, scale = fn(*st, **kw)
        launched = K.adamw.launches - before
        torch.cuda.synchronize()
        got[which] = ([gn.clone(), scale.clone()],
                      [_bits_digest(torch, t) for t in st[0] + st[2] + st[3]])
        if which == "kernel":
            require(launched == 2, f"{what}: {launched} launches, not 2")
            times[which] = time_ms(torch, lambda: fn(*st, **kw), reps)
        else:
            times[which] = time_ms(torch, lambda: fn(*st, **kw), 1)
        del st, gn, scale
        gc.collect()
        torch.cuda.empty_cache()
    (kn, kd), (pn, pd) = got["kernel"], got["plain"]
    differ = [shapes[i % len(shapes)] for i, (a, b) in
              enumerate(zip(kd, pd)) if a != b]
    require(torch.equal(kn[0], pn[0]) and torch.equal(kn[1], pn[1])
            and not differ,
            f"{what}: the kernel's norm {float(kn[0])!r}, scale "
            f"{float(kn[1])!r} against the plain versions' "
            f"{float(pn[0])!r}, {float(pn[1])!r}; {len(differ)} of "
            f"{len(kd)} parameters and moments differ (first "
            f"{differ[:3]})")
    library_ms = _fused_adamw_ms(torch, shapes, seed, reps)
    bytes_ = sum(math.prod(s) * (3 * dt.itemsize + 4 * mdt.itemsize)
                 for s, dt in shapes)
    rec = dict(case=f"{what}, norm {float(kn[0])!r}, clip scale "
               f"{float(kn[1])!r}: bit-equal to the plain versions (norm, "
               f"scale, every parameter and moment)", max_abs_err=0.0,
               tol="bit-equal", bits_equal_to_plain=True,
               kernel_ms=times["kernel"], plain_ms=times["plain"],
               library_ms=library_ms,
               library="torch._fused_adamw_ (moments in the parameters' "
               "dtype; no clipping, decay first)",
               bound_ms=bytes_ / HBM_BYTES_S * 1e3, bound_by="bytes",
               bytes=bytes_, launches_a_call=2)
    return _rates(rec, ADAMW_FLOPS * n)


def phase_kernels(torch, seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    # the main paths' shapes first: group_by, word_count and histogram
    # (counts: one broadcast value), kmeans_step's sums, pagerank's ⊕ of
    # 68,993,773 edges into 4,847,571 vertices
    seg = [
        _segment_case(torch, g, N_ROWS, GROUPS, 1, "+"),
        _segment_case(torch, g, N_ROWS, VOCAB, 1, "+", broadcast=True),
        _segment_case(torch, g, N_ROWS, 256, 1, "+", broadcast=True),
        _segment_case(torch, g, KM_POINTS, KM_K, 1, "+"),
        _segment_case(torch, g, PR_EDGES, PR_VERTICES, 1, "+"),
        _segment_case(torch, g, N_ROWS, 256, 1, "+"),
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
    extra_us = (seg[-1]["kernel_ms"] - seg[0]["kernel_ms"]) * 1e3 \
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
    _segment_ranges_check(torch, g)
    # the device-count entry (a served lane padded to its batch's rows):
    # mix (b)'s kmeans (small path) and group_by / pagerank (bucketed)
    # shapes, n < L
    for L, n, k in ((MIX_B_KM[0], MIX_B_KM[1], 64),
                    (MIX_B_ROWS[0], MIX_B_ROWS[1], MIX_B_GROUPS),
                    (MIX_B_ROWS[0], 1, MIX_B_GROUPS)):
        _segment_rows_case(torch, g, L, n, k)
    _segment_rows_case(torch, g, MIX_B_ROWS[0], MIX_B_ROWS[1], MIX_B_GROUPS,
                       op="max")
    # one served flush's group-bys through the lanes entry: mix (b)'s
    # group_by and pagerank shape (bucketed), its kmeans_step sums and mix
    # (a)'s group_by (small path)
    lanes = _segment_lanes_case(torch, g, [MIX_B_ROWS[i % 2]
                                           for i in range(SERVE_MAX_BATCH)],
                                MIX_B_ROWS[0], MIX_B_GROUPS)
    _segment_lanes_case(torch, g, [MIX_B_KM[i % 2]
                                   for i in range(SERVE_MAX_BATCH)],
                        MIX_B_KM[0], 64, what="mix (b) kmeans_step")
    _segment_lanes_case(torch, g, [MIX_A["group_by"][i % 2]
                                   for i in range(SERVE_MAX_BATCH)],
                        MIX_A["group_by"][0], 16, what="mix (a) group_by")
    # the MoE combine (phases 4 and 8) on the wide route
    moe = {what: _segment_moe_case(torch, g, *shape, what=what)
           for what, shape in MOE_SHAPES.items()}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    tile = [
        _tile_case(torch, g, MAT, MAT, MAT, 128, "float32", True, True),
        _tile_case(torch, g, MAT, MAT, MAT, 128, "bfloat16", True, True),
        _tile_case(torch, g, MAT, MAT, MAT, 128, "float32", False, False),
        _tile_case(torch, g, 100, 70, 90, 32, "float32", True, True),
        _tile_case(torch, g, 100, 70, 90, 32, "float32", True, False),
    ]
    torch.cuda.synchronize()
    flash = [_flash_case(torch, g, 32, 2048, 128, "bfloat16"),
             _flash_case(torch, g, 32, 1531, 128, "bfloat16"),
             _flash_case(torch, g, 32, 777, 128, "bfloat16"),
             _flash_case(torch, g, 32, 2048, 64, "bfloat16"),
             _flash_case(torch, g, 32, 2048, 128, "float32"),
             _flash_case(torch, g, 32, 777, 128, "float32")]
    scan = [_scan_case(torch, g, 1, 256, 8192, 16, True),
            _scan_case(torch, g, 1, 256, 8192, 16, False),
            _scan_case(torch, g, 1, 1531, 8192, 16, False)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rglru, wg = _hybrid_audio_cases(torch, g)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    fused = [_fused_scan_case(torch, g, 1, 2048, 8192, 16, "bfloat16"),
             _fused_scan_case(torch, g, 1, 1531, 8192, 16, "bfloat16",
                              with_h0=True),
             _fused_scan_case(torch, g, 1, 2048, 8192, 16, "float32")]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # the backward kernels at the training shapes (phase 8: llama3-8b's
    # 4 × 2048 tokens, 32 heads of 128; falcon-mamba-7b's d_inner 8192,
    # N 16); their float32 paths are held against the CPU in phase 8.
    # Then the edges of their tilings, plain versions timed once: a
    # sequence no 64-query tile or 128-key block divides, hd 64 (the other
    # head width of the wgmma path), and a scan whose S and D no chunk or
    # block of channels divides
    bwd = [_flash_bwd_case(torch, g, 128, 2048, 128, "bfloat16"),
           _flash_bwd_case(torch, g, 128, 1531, 128, "bfloat16",
                           plain_reps=1),
           _flash_bwd_case(torch, g, 128, 2048, 64, "bfloat16",
                           plain_reps=1)]
    torch.cuda.empty_cache()
    sbwd = [_scan_bwd_case(torch, g, 4, 2048, 8192, 16, "bfloat16"),
            _scan_bwd_case(torch, g, 4, 1531, 8136, 16, "bfloat16")]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    hyb, enc, abx = _family_bwd_cases(torch, g)
    adamw = [_adamw_case(torch, *case, seed) for case in ADAMW_CASES]
    # the entries of the kernel line: the main paths' shapes (the group-by
    # over 2^20 segments, the packed 8192^3 product through the packed
    # entry, the 2048-token llama3-8b prefill's attention, the scan kernel
    # through its fused entry on a 2048-token falcon-mamba-7b prefill, as
    # the serve path calls it, and through its (a, bx) entry on the RG-LRU
    # of a 2048-token recurrentgemma-2b prefill; the hybrid and audio
    # families' flash shapes are checked and timed above)
    return {"segment_reduce": seg[0], "tile_matmul": tile[0],
            "flash_attention": flash[0], "flash_attention[wg]": wg,
            "selective_scan": fused[0],
            "selective_scan[a, bx]": rglru,
            "flash_attention_bwd": bwd[0], "selective_scan_bwd": sbwd[0],
            "flash_attention_bwd[window, hd 256]": hyb,
            "flash_attention_bwd[full, hd 64]": enc,
            "selective_scan_bwd[a, bx]": abx,
            "segment_reduce[wide]": moe["prefill"],
            "segment_reduce[lanes]": lanes, "adamw": adamw[0]}


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


def _programs(np, rng, torch, only=None, device="cuda"):
    """(name, inputs, reference() -> {output: array}[, rows]) for each
    program (those named in `only`, when given).  Inputs are made with
    numpy from the seed and every array is moved to `device` once (the
    card, so that run() times hold no host-to-device copy); references
    are numpy float64 (a sample of rows for the 8192^3 products)."""
    from repro_torch.core.programs import ALL
    from repro_torch.core.tiles import pack

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    f32 = np.float32
    out = []

    def want(*names):
        return only is None or any(n in only for n in names)

    if want("average", "count", "conditional_count", "conditional_sum"):
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
        out.append(("conditional_count",
                    dict(V=(dev(v),), cnt=0.0, limit=lim),
                    lambda: dict(cnt=float((v < scal(lim)).sum()))))
        out.append(("conditional_sum", dict(V=(dev(v),), s=0.0, limit=lim),
                    lambda: dict(s=v64[v < scal(lim)].sum())))
    if want("equal"):
        w = rng.integers(0, 3, N_ROWS).astype(f32)
        out.append(("equal", dict(W=(dev(w),), first=float(w[0]), diffs=0.0),
                    lambda: dict(diffs=float((w != w[0]).sum()))))
    if want("string_match"):
        ws = rng.integers(0, 1000, N_ROWS).astype(f32)
        ks = (1.0, 500.0, 5000.0)
        out.append(("string_match",
                    dict(W=(dev(ws),), k1=ks[0], k2=ks[1], k3=ks[2],
                         found=dev(np.zeros(3, f32))),
                    lambda: dict(found=np.array([float((ws == k).any())
                                                 for k in ks]))))
    if want("word_count"):
        toks = rng.integers(0, VOCAB, N_ROWS).astype(f32)
        out.append(("word_count",
                    dict(W=(dev(toks),), C=dev(np.zeros(VOCAB, f32))),
                    lambda: dict(C=np.bincount(toks.astype(np.int64),
                                               minlength=VOCAB))))
    if want("histogram"):
        px = [rng.integers(0, 256, N_ROWS).astype(f32) for _ in range(3)]
        out.append(("histogram",
                    dict(P=tuple(dev(c) for c in px),
                         **{c: dev(np.zeros(256, f32)) for c in "RGB"}),
                    lambda: {n_: np.bincount(c.astype(np.int64), minlength=256)
                             for n_, c in zip("RGB", px)}))
    if want("group_by"):
        keys = rng.integers(0, GROUPS, N_ROWS).astype(f32)
        gv = rng.standard_normal(N_ROWS, dtype=f32)
        out.append(("group_by",
                    dict(S=(dev(keys), dev(gv)), C=dev(np.zeros(GROUPS, f32))),
                    lambda: dict(C=np.bincount(keys.astype(np.int64),
                                               weights=gv.astype(np.float64),
                                               minlength=GROUPS))))
    if want("linear_regression"):
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
    if want("matrix_addition", "matrix_multiplication",
            "matrix_multiplication[packed]"):
        ma = rng.standard_normal((MAT, MAT), dtype=f32)
        mb = rng.standard_normal((MAT, MAT), dtype=f32)
        out.append(("matrix_addition",
                    dict(M=dev(ma), N=dev(mb), R=torch.zeros(MAT, MAT,
                                                             device=device),
                         n=MAT, m=MAT),
                    lambda: dict(R=ma.astype(np.float64) + mb)))
        rows = np.sort(rng.choice(MAT, 64, replace=False))

        def mm_ref(lhs):
            return dict(R=lhs[rows].astype(np.float64) @ mb.astype(np.float64))
        out.append(("matrix_multiplication",
                    dict(M=dev(ma), N=dev(mb), R=torch.zeros(MAT, MAT,
                                                             device=device),
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
                         R=torch.zeros(MAT, MAT, device=device), n=MAT, m=MAT,
                         l=MAT),
                    lambda: mm_ref(mz), rows))
    if want("pagerank"):
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
    if want("kmeans_step"):
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
                         D=torch.zeros(KM_POINTS, KM_K, device=device),
                         MinD=torch.full((KM_POINTS,), 1e30, device=device),
                         Cl=torch.zeros(KM_POINTS, device=device),
                         **{a_: dev(np.zeros(KM_K, f32))
                            for a_ in ("SX", "SY", "CN", "NX", "NY")}),
                    km_ref))
    if want("matrix_factorization_step"):
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
                    dict(R=dev(R), P=dev(Pm), Q=dev(Qm), Pp=dev(Pp),
                         Qp=dev(Qp),
                         pq=torch.zeros(n_, n_, device=device),
                         err=torch.zeros(n_, n_, device=device),
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
    """One warm-up run (allocator, cuBLAS; in whole mode a cache hit), then
    `reps` timed runs, each by the host clock around run() and a
    synchronize; returns the last outputs and the per-run ms, sorted."""
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


# the programs whose run() the smoke also traces, in whole mode: those the
# kernels serve, the slowest ones, and the slowest of those that launch no
# kernel (the dense 8192^3 product, about 22 ms a run on an H100)
PROFILED = ("word_count", "histogram", "group_by",
            "matrix_multiplication[packed]", "pagerank", "kmeans_step",
            "matrix_factorization_step", "matrix_multiplication")

# whole-mode outputs equal to eager's bit for bit: the same plan, and the
# segment kernel gives the same bits on every launch
BIT_EQUAL = ("word_count", "histogram", "group_by", "pagerank",
             "kmeans_step")


def _union_ms(spans) -> float:
    """The time covered by the (start, end) intervals, in ms: work that
    ran at the same time (a copy under a kernel) is counted once."""
    total, end = 0.0, None
    for lo, hi in sorted(spans):
        if end is None or lo > end:
            total += hi - lo
            end = hi
        elif hi > end:
            total += hi - end
            end = hi
    return total / 1e3


def _profile(torch, name, fn, run_ms, top=5):
    """One more call of `fn` under torch.profiler: the device's busy time
    (the union of the intervals of the kernels and copies it ran, so work
    that overlapped counts once), its idle share of `run_ms` (the
    unprofiled median of the same call; a negative share would mean the
    profiled call kept the device busier than the unprofiled run lasted),
    and the kernels that took the most device time.  Returns the device
    time and count by name, and the intervals (start, end, name) in us."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per: dict = {}
    spans = []
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            ms, c = per.get(e.name, (0.0, 0))
            per[e.name] = (ms + e.device_time_total / 1e3, c + 1)
            spans.append((e.time_range.start, e.time_range.end, e.name))
    if not per:
        log(f"[profile] {name}: the profiler recorded no device time")
        return per, spans
    busy = _union_ms((lo, hi) for lo, hi, _ in spans)
    rows = sorted(((ms, k, c) for k, (ms, c) in per.items()), reverse=True)
    log(f"[profile] {name}: device busy {busy:.3f} ms of a {run_ms:.3f} ms "
        f"run (unprofiled median), idle share "
        f"{1.0 - busy / run_ms:.3f}; top kernels: "
        + "; ".join(f"{k[:70]} x{c} {ms:.3f} ms" for ms, k, c in rows[:top]))
    return per, spans


def _kernel_functions(names=PROGRAM_KERNELS):
    """Each named kernel source's device functions: the `__global__`
    functions of its source."""
    from repro_torch.kernels import _build
    out = {}
    for k in names:
        text = (_build.CSRC / f"{k}.cu").read_text()
        out[k] = re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                            r"\([^)]*\)\s*)?(\w+)\s*\(", text)
    return out


def _profiled_launches(torch, ops, fns, name, fn, run_ms):
    """One call of `fn` under the profiler: the kernel events of each
    program kernel that the device ran (by the names of its functions) and
    the launches its wrapper counted in that call."""
    before = ops.launch_counts()
    per, _ = _profile(torch, name, fn, run_ms)
    after = ops.launch_counts()
    pats = {k: re.compile(r"::(?:%s)[<(]" % "|".join(v))
            for k, v in fns.items()}
    ran = {k: sum(c for e, (_, c) in per.items() if p.search(e))
           for k, p in pats.items()}
    return ran, {k: after[k] - before[k] for k in fns}


def _check(name, out, ref, rows=None):
    """Worst relative error of `out` against the reference outputs `ref`;
    fails beyond the program's tolerance."""
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


def _count_syncs(torch, fn):
    """Host syncs of one call of `fn`: the synchronizing CUDA operations
    (a read of a device value, a copy to the host) that torch's sync debug
    mode reports."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in seen)


# profiled calls a program gets for its two modes to agree: the profiler
# can drop a kernel's event (seen once on the H100: the packed product's
# 16 ms tile kernel missing from its trace), while graphs that lack a
# kernel disagree on every try
PROFILE_TRIES = 3


def _same_kernels_on_device(torch, ops, fns, name, whole, eager, inputs,
                            ms_w, ms_e):
    """One whole and one eager call under the profiler: the device must
    run the same program kernels' functions in both, and run them exactly
    where their wrappers counted launches."""
    for attempt in range(1, PROFILE_TRIES + 1):
        ran_w, counted_w = _profiled_launches(
            torch, ops, fns, name, lambda: whole.run(inputs), ms_w)
        ran_e, counted_e = _profiled_launches(
            torch, ops, fns, f"{name} eager", lambda: eager.run(inputs), ms_e)
        what = (f"program kernels' device functions run in one profiled "
                f"call whole {ran_w} eager {ran_e}; launches counted whole "
                f"{counted_w} eager {counted_e}")
        log(f"[main] {name}: {what} (try {attempt})")
        if ran_w == ran_e and counted_w == counted_e and all(
                (n > 0) == (ran_w[k] > 0) and ran_w[k] >= n
                for k, n in counted_w.items()):
            return
    require(False, f"{name}: in {PROFILE_TRIES} tries, never the same "
            f"kernels on the device in both modes: {what}")


def _mode_runs(torch, ops, cp, inputs, on_first=None):
    """A mode's first call (in whole mode: warm-up, capture, replay), its
    warm-up and 5 timed runs.  Returns the last outputs, the timed runs'
    ms, the first call's ms, the kernel launches of the 6 later runs, the
    peak device memory of all of them above what was allocated before
    (GB), what stays allocated after them with the outputs dropped (GB:
    an entry's static inputs and the values its graphs share), the host
    syncs of one more run and what `on_first` made of the first call's
    outputs (which are dropped before the later runs)."""
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = cp.run(inputs)
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    seen = on_first(out) if on_first is not None else None
    del out
    before = ops.launch_counts()
    out, times = _run_program(torch, cp, inputs, reps=5)
    after = ops.launch_counts()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    syncs = _count_syncs(torch, lambda: cp.run(inputs))
    storages = {v.untyped_storage().data_ptr(): v.untyped_storage().nbytes()
                for v in out.values()}
    held = (torch.cuda.memory_allocated() - base
            - sum(storages.values())) / 1e9
    return (out, times, first, {k: after[k] - before[k] for k in after
                                if after[k] != before[k]},
            peak, held, syncs, seen)


def phase_main(torch, seed):
    import numpy as np
    from repro_torch.convert import inputs_from_numpy
    from repro_torch.core import compile_program
    from repro_torch.kernels import ops
    rng = np.random.default_rng(seed)
    ALL, progs = _programs(np, rng, torch)
    log(f"[main] sizes: bags N={N_ROWS} rows, word_count vocabulary "
        f"{VOCAB}, group_by {GROUPS} groups, matrices {MAT}x{MAT}, pagerank "
        f"{PR_VERTICES} vertices {PR_EDGES} edges {PR_STEPS} steps, kmeans "
        f"{KM_POINTS} points K={KM_K}, matrix factorization n=m={MF_N} "
        f"l={MF_L}; no cuts.  Each program runs in eager mode, then in "
        f"whole mode (the default: CUDA graphs captured once, replayed); "
        f"launches are a run's, peak memory is above the inputs already "
        f"on the card")
    fns = _kernel_functions()
    log(f"[main] program kernels' device functions: {fns}")
    ops.reset_launch_counts()
    for item in progs:
        name, inputs, ref_fn = item[:3]
        rows = item[3] if len(item) > 3 else None
        pname = name.split("[")[0]
        packed = "packed" in name
        ref = ref_fn()
        eager = compile_program(ALL[pname], compile_mode="eager")
        out_e, t_e, _, l_e, peak_e, _, syncs_e, _ = _mode_runs(
            torch, ops, eager, inputs)
        err_e, tol = _check(name, out_e, ref, rows)

        def first_call(o):
            # the call that captures: within tolerance, and eager's bits
            return (_check(name, o, ref, rows)[0],
                    all(torch.equal(o[k], out_e[k]) for k in out_e))
        cp = compile_program(ALL[pname])
        out, times, first, l_w, peak_w, held, syncs_w, (err_1, same_1) = \
            _mode_runs(torch, ops, cp, inputs, first_call)
        err_w, _ = _check(name, out, ref, rows)
        same = all(torch.equal(out[k], out_e[k]) for k in out_e)
        del out_e
        runs = 1 + 6 + 1                   # first call, _mode_runs' runs
        sel = [ln.strip() for ln in cp.explain(
            tiled={"M"} if packed else ()).splitlines()
            if ln.strip().startswith("selected:")]
        log(f"[main] {name}: whole {_ms_text(times)}; eager "
            f"{_ms_text(t_e)}; first whole call {first:.3f} ms  rel_err "
            f"whole {err_w:.3g} first whole call {err_1:.3g} eager "
            f"{err_e:.3g} (tol {tol})  whole==eager bits: {same} (first "
            f"whole call: {same_1})  launches a run: "
            f"{ {k: v / 6 for k, v in l_w.items()} }  " + "; ".join(sel))
        if packed:
            entry_text = ("runs eagerly in whole mode (a §5 packed input "
                          "takes the eager path, the reference's rule)")
            require(cp.trace_count == 0 and cp.cache_hits == 0,
                    f"{name}: a packed input built a whole-program entry")
        else:
            (entry, _), = cp._whole_cache.values()
            env = inputs_from_numpy(inputs, None, ALL[pname].program.params)
            stage = time_ms(torch, lambda: entry._stage(env))
            entry_text = (f"graphs {entry.graphs}, loop flag reads a run "
                          f"{entry.syncs}, input staging {stage:.3f} ms")
            require(cp.trace_count == 1 and cp.trace_failures == 0,
                    f"{name}: whole mode traced {cp.trace_count} times, "
                    f"{cp.trace_failures} failures")
            require(cp.cache_hits == runs - 1,
                    f"{name}: {cp.cache_hits} cache hits in {runs} calls")
            if pname == "pagerank":
                require(entry.syncs == PR_STEPS + 1,
                        f"{name}: {entry.syncs} loop flag reads a run")
        for mode, c in (("whole", cp), ("eager", eager)):
            require(c.faults.counters["descend"] == 0,
                    f"{name}: {mode} mode descended: {c.explain_faults()}")
        # memest's estimate of the temporaries above the resident inputs
        # (peak - resident: the worst node's temps and destination copy),
        # beside the peaks measured above the inputs already on the card
        est = eager.estimate_memory(inputs)
        est_temps = (est.peak_bytes - est.resident) / 1e9
        log(f"[main] {name} memest: peak {est.peak_bytes / 1e9:.3f} GB = "
            f"resident {est.resident / 1e9:.3f} + temps {est_temps:.3f} GB; "
            f"measured peak above the inputs eager {peak_e:.3f} GB, whole "
            f"{peak_w:.3f} GB")
        require(est_temps >= peak_e,
                f"{name}: memest's temps {est_temps:.3f} GB are under the "
                f"measured eager peak {peak_e:.3f} GB")
        log(f"[main] {name} whole: traced {cp.trace_count}, cache hits "
            f"{cp.cache_hits} of {runs} calls, trace failures "
            f"{cp.trace_failures}; {entry_text}; host syncs a run whole "
            f"{syncs_w} eager {syncs_e}; peak memory whole {peak_w:.3f} GB "
            f"eager {peak_e:.3f} GB; whole keeps {held:.3f} GB allocated "
            f"between calls")
        require(l_w == l_e, f"{name}: whole-mode launches {l_w} != "
                f"eager's {l_e}")
        if pname in BIT_EQUAL:
            require(same and same_1,
                    f"{name}: whole-mode outputs differ from eager's (first "
                    f"call: {same_1}, later calls: {same})")
        if pname in ("word_count", "histogram", "group_by"):
            require(l_w.get("segment_reduce", 0) > 0,
                    f"{name}: segment_reduce kernel was not launched")
        if packed:
            require(l_w.get("tile_matmul", 0) > 0,
                    f"{name}: tile_matmul kernel was not launched")
        # traced here, so that no entry's graph pool outlives its program;
        # the kernels the device ran in whole mode (inside the graphs)
        # against those it ran in eager mode, and the counted launches
        if name in PROFILED:
            _same_kernels_on_device(torch, ops, fns, name, cp, eager, inputs,
                                    times[len(times) // 2],
                                    t_e[len(t_e) // 2])
        out = cp = eager = entry = env = None    # the entry and its pool
        gc.collect()
        torch.cuda.empty_cache()
    launches = {k: ops.launch_counts()[k] for k in PROGRAM_KERNELS}
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
        worst, tol = _check(name, out, ref_fn())
        sel = sorted({ln.strip() for ln in cp.explain().splitlines()
                      if "segment:" in ln})
        log(f"[main] {name} op_select=force:pallas: {times[0]:.3f} ms  "
            f"rel_err={worst:.3g} (tol {tol})  launches={forced}  "
            + "; ".join(sel))
        require(forced["segment_reduce"] > 0,
                f"{name} op_select=force:pallas: segment_reduce kernel was "
                "not launched")
        require(cp.trace_count == 1 and cp.faults.counters["descend"] == 0,
                f"{name} op_select=force:pallas: traced {cp.trace_count} "
                f"times: {cp.explain_faults()}")
        del out, cp
        gc.collect()
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 5: out-of-core and resume
# ---------------------------------------------------------------------------

# group_by streamed from the host: 2^29 rows (keys and float32 values, 4 GiB
# on the host) into 2^20 groups; budgets of the all-resident estimate / 2
# and / 10, the ratios of benchmarks/outofcore_bench.py
OOC_ROWS = 2 ** 29
OOC_DIVS = (2, 10)
# the process cap of the real out-of-memory case: below what group_by's
# all-resident whole mode needs (4.3 GB of staged inputs and ~11 GB of
# temporaries), above what one streamed range needs (~2.5 GB)
OOC_CAP = 7e9
# the injected kills: pagerank's loop at iteration 5, the stream at chunk 5
KILL_ITER = KILL_CHUNK = 5


def _device_split(torch, name, fn, run_ms):
    """One profiled call: the device's busy ms (the union of its copies'
    and kernels' intervals), the copies' and the kernels' own busy ms, and
    the ms in which a copy ran under a kernel."""
    _, spans = _profile(torch, name, fn, run_ms)
    copies = [(lo, hi) for lo, hi, k in spans if "memcpy" in k.lower()]
    kernels = [(lo, hi) for lo, hi, k in spans if "memcpy" not in k.lower()]
    busy = _union_ms((lo, hi) for lo, hi, _ in spans)
    copy, kern = _union_ms(copies), _union_ms(kernels)
    return busy, copy, kern, copy + kern - busy


def _timed_runs(torch, fn, reps=3):
    """One warm-up call, then `reps` calls timed by the host clock ending in
    a synchronize; the last output and the sorted ms."""
    out = fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, sorted(times)


def _counted(ops, fn):
    """`fn()` with the launch counts set to 0 just before it; the output
    and the segment kernel launches it made."""
    ops.reset_launch_counts()
    out = fn()
    return out, ops.launch_counts()["segment_reduce"]


def _ooc_group_by(torch, np, ops, rng, tmp):
    from repro_torch.core import compile_program
    from repro_torch.core import faults as F
    from repro_torch.core.programs import ALL
    from repro_torch.kernels.segment_reduce import RANGE_ROWS
    from repro_torch.runtime import LoopRunner
    t0 = time.perf_counter()
    keys = rng.integers(0, GROUPS, OOC_ROWS, dtype=np.int32).astype(
        np.float32)
    vals = rng.standard_normal(OOC_ROWS, dtype=np.float32)
    host = (torch.from_numpy(keys).pin_memory(),
            torch.from_numpy(vals).pin_memory())
    ref64 = np.bincount(keys.astype(np.int64), weights=vals.astype(
        np.float64), minlength=GROUPS)
    del keys, vals
    inputs = dict(S=host, C=torch.zeros(GROUPS, device="cuda"))
    bag_bytes = sum(c.numel() * c.element_size() for c in host)
    log(f"[ooc] group_by: {OOC_ROWS} rows into {GROUPS} groups, "
        f"{bag_bytes / 2 ** 30:.2f} GiB pinned on the host, made in "
        f"{time.perf_counter() - t0:.1f} s")
    # a bare pinned host → device copy of the same bytes: the rate to beat
    dev = [torch.empty_like(c, device="cuda") for c in host]
    bare_ms = time_ms(torch, lambda: [d.copy_(c, non_blocking=True)
                                      for d, c in zip(dev, host)], reps=3)
    bare_gbs = bag_bytes / bare_ms / 1e6
    del dev
    log(f"[ooc] bare pinned host -> device copy: {bare_gbs:.2f} GB/s "
        f"({bare_ms:.3f} ms for the bag)")
    # the all-resident reference: eager run() of the same host inputs
    eager = compile_program(ALL["group_by"], compile_mode="eager")
    est = eager.estimate_memory(inputs)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ref, t_ref = _timed_runs(torch, lambda: eager.run(inputs))
    peak_ref = (torch.cuda.max_memory_allocated() - base) / 1e9
    ref = ref["C"]
    err64 = _rel_err(ref.cpu().numpy(), ref64)
    require(err64 <= DEFAULT_TOL, f"group_by all-resident: rel err {err64} "
            "against the numpy float64 reference")
    del ref64
    log(f"[ooc] group_by all-resident eager run(): {_ms_text(t_ref)}; rel "
        f"err {err64:.3g} against numpy float64; peak "
        f"{peak_ref:.3f} GB above the start; memest peak "
        f"{est.peak_bytes / 1e9:.3f} GB, per row "
        f"{est.per_row('S')} B, fixed {est.fixed_bytes / 1e9:.3f} GB")
    launches = 0
    for div in OOC_DIVS:
        budget = est.peak_bytes // div
        cp = compile_program(ALL["group_by"], memory_budget=budget)
        rows = cp._initial_chunk_rows(inputs)
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        first, n = _counted(ops, lambda: cp.run(inputs))
        launches += n
        peak = torch.cuda.max_memory_allocated() - base
        # the warm-up run is queued right behind the counted one, with no
        # host sync between them: the counted run's bits must survive it
        out, times = _timed_runs(torch, lambda: cp.run(inputs))
        require(torch.equal(first["C"], out["C"]),
                f"group_by / {div}: a run's output changed when the next "
                "run was queued behind it with no sync")
        del first
        med = times[len(times) // 2]
        busy, copy_ms, kern_ms, both_ms = _device_split(
            torch, f"group_by chunked / {div}", lambda: cp.run(inputs), med)
        chunks = -(-OOC_ROWS // rows)
        whole = rows % RANGE_ROWS == 0
        err = float((out["C"] - ref).abs().max()) / float(ref.abs().max())
        same = torch.equal(out["C"], ref)
        text = cp.explain_faults()
        log(f"[ooc] group_by budget = estimate / {div} = "
            f"{budget / 1e9:.3f} GB: run() {_ms_text(times)} against "
            f"all-resident eager {t_ref[len(t_ref) // 2]:.3f} ms; chunk rows "
            f"{rows} ({'whole ranges' if whole else 'sub-range'}), "
            f"{chunks} chunks, {n} segment launches a run; host -> device "
            f"{bag_bytes / med / 1e6:.2f} GB/s of the run (bare copy "
            f"{bare_gbs:.2f}); device busy {busy:.3f} ms (copies "
            f"{copy_ms:.3f}, kernels {kern_ms:.3f}, both at once "
            f"{both_ms:.3f}) of {med:.3f}, idle share "
            f"{1.0 - busy / med:.3f}; peak {peak / 1e9:.3f} GB "
            f"above the start, budget {budget / 1e9:.3f}, memest for the "
            f"tile {(est.fixed_bytes + rows * est.per_row('S')) / 1e9:.3f} "
            f"GB; rel err {err:.3g}, bits equal {same}")
        require(cp.faults.counters["admission"] >= 1,
                f"group_by / {div}: not admitted to the chunked tier")
        require(peak <= budget, f"group_by / {div}: peak {peak} B above the "
                f"budget {budget} B")
        require(n == -(-OOC_ROWS // min(rows, RANGE_ROWS)),
                f"group_by / {div}: {n} segment launches for {chunks} "
                f"chunks of {rows} rows")
        if whole:
            require(same, f"group_by / {div}: whole-range chunks are not "
                    "bit-equal to the all-resident run")
            require("inexact" not in text, f"group_by / {div}: {text}")
        else:
            require(err <= 1e-4, f"group_by / {div}: rel err {err}")
            require("not bit-identical" in text,
                    f"group_by / {div}: the ledger does not say the "
                    f"sub-range tiles are not bit-identical: {text}")
        del out, cp
    # killed at chunk 5 and resumed: the uninterrupted stream's bits, fewer
    # chunks run
    d = tmp / "group_by"

    def streamed():
        c = compile_program(ALL["group_by"], out_of_core="force",
                            chunk_rows=RANGE_ROWS)
        c.faults.sleep = lambda s: None
        return c
    runner = LoopRunner(streamed(), str(d), every=1)
    try:
        with F.inject(F.FaultSpec("lower.chunk_step", "deterministic",
                                  nth=KILL_CHUNK + 1, times=10 ** 6)):
            _counted(ops, lambda: runner.run(inputs, resume=False))
        require(False, "group_by: the injected kill did not fire")
    except F.DeterministicFault:
        launches += ops.launch_counts()["segment_reduce"]
    cp = streamed()
    resumed = LoopRunner(cp, str(d), every=1)
    t0 = time.perf_counter()
    out, n = _counted(ops, lambda: resumed.run(inputs, resume=True))
    torch.cuda.synchronize()
    res_ms = (time.perf_counter() - t0) * 1e3
    launches += n
    cold = -(-OOC_ROWS // RANGE_ROWS)
    log(f"[ooc] group_by killed at chunk {KILL_CHUNK + 1} of {cold} and "
        f"resumed from checkpoint step {resumed.resumed_from}: "
        f"{cp.chunker.chunks_run} chunks run (cold {cold}), {res_ms:.1f} ms, "
        f"bits equal {torch.equal(out['C'], ref)}")
    require(torch.equal(out["C"], ref) and cp.chunker.chunks_run < cold,
            f"group_by resume: bits equal {torch.equal(out['C'], ref)}, "
            f"{cp.chunker.chunks_run} chunks of {cold}")
    del out, cp, runner, resumed
    # a real out-of-memory error: the process capped below the
    # all-resident whole mode's need, which descends to chunked
    gc.collect()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    frac = (torch.cuda.memory_allocated() + OOC_CAP) / total
    torch.cuda.set_per_process_memory_fraction(frac)
    try:
        cp = compile_program(ALL["group_by"])
        cp.faults.sleep = lambda s: None
        out, n = _counted(ops, lambda: cp.run(inputs))
        launches += n
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    text = cp.explain_faults()
    log(f"[ooc] group_by whole mode under a cap of {OOC_CAP / 1e9:.1f} GB "
        f"(fraction {frac:.4f}): level reached "
        f"{cp.faults.level_reached!r}, {n} segment launches, bits equal "
        f"{torch.equal(out['C'], ref)}; ledger: "
        + " | ".join(ln.strip() for ln in text.splitlines()[1:3]))
    require(cp.faults.level_reached == "chunked"
            and "whole->chunked" in text and "out of memory" in text.lower(),
            f"group_by under the cap did not descend whole -> chunked on a "
            f"real out-of-memory error: {text}")
    require(torch.equal(out["C"], ref),
            "group_by under the cap: not bit-equal to all-resident")
    del out, cp, inputs, host, ref
    return launches


def _ooc_pagerank(torch, np, ops, rng, tmp):
    from repro_torch.core import compile_program
    from repro_torch.core import faults as F
    from repro_torch.core.programs import ALL
    from repro_torch.kernels.segment_reduce import RANGE_ROWS
    from repro_torch.runtime import LoopRunner
    src = rng.integers(0, PR_VERTICES, PR_EDGES, dtype=np.int32).astype(
        np.float32)
    dst = rng.integers(0, PR_VERTICES, PR_EDGES, dtype=np.int32).astype(
        np.float32)
    inputs = dict(E=(torch.from_numpy(src).pin_memory(),
                     torch.from_numpy(dst).pin_memory()),
                  P=np.full(PR_VERTICES, 1.0 / PR_VERTICES, np.float32),
                  NP=np.zeros(PR_VERTICES, np.float32),
                  C=np.zeros(PR_VERTICES, np.float32), N=PR_VERTICES,
                  num_steps=float(PR_STEPS), steps=0.0, b=0.85)
    del src, dst
    eager = compile_program(ALL["pagerank"], compile_mode="eager")
    ref, t_ref = _timed_runs(torch, lambda: eager.run(inputs), reps=1)
    step = eager.run_stepwise(inputs)
    require(all(torch.equal(step[k], ref[k]) for k in ref),
            "pagerank: run_stepwise is not bit-equal to eager run()")
    require(all(torch.isfinite(v).all().item() for v in ref.values()),
            "pagerank: non-finite output")
    # a budget that fits one range of edges a chunk: E streams in 2
    # range-aligned chunks a step
    est = eager.estimate_memory(inputs)
    budget = est.fixed_bytes + RANGE_ROWS * est.per_row("E")
    cp = compile_program(ALL["pagerank"], out_of_core="force",
                         memory_budget=budget)
    rows = cp._initial_chunk_rows(inputs)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, n = _counted(ops, lambda: cp.run(inputs))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    chunks = cp.chunker.chunks_run
    same = all(torch.equal(out[k], ref[k]) for k in ref)
    log(f"[ooc] pagerank {PR_VERTICES} vertices {PR_EDGES} edges "
        f"{PR_STEPS} steps, budget {budget / 1e9:.3f} GB: chunk rows {rows}, "
        f"{chunks} chunks a run ({chunks // (PR_STEPS + 1)} a pass), {n} "
        f"segment launches; run() {ms:.1f} ms against all-resident eager "
        f"{t_ref[0]:.1f} ms; peak {peak / 1e9:.3f} GB above the start; bits "
        f"equal to eager run() and run_stepwise {same}")
    require(rows == RANGE_ROWS and chunks == 2 * (PR_STEPS + 1),
            f"pagerank: {rows} rows, {chunks} chunks")
    require(same, "pagerank chunked: not bit-equal to all-resident")
    require(peak <= budget, f"pagerank: peak {peak} B above {budget} B")
    launches = n
    # LoopRunner every 2, killed at iteration 5, resumed
    d = tmp / "pagerank"
    cpk = compile_program(ALL["pagerank"], compile_mode="eager")
    cpk.faults.sleep = lambda s: None
    runner = LoopRunner(cpk, str(d), every=2)
    saves = []
    mgr_save = runner.mgr.save

    def timed_save(*a, **kw):
        t = time.perf_counter()
        mgr_save(*a, **kw)
        saves.append((time.perf_counter() - t) * 1e3)
    runner.mgr.save = timed_save
    try:
        with F.inject(F.FaultSpec("lower.loop_iter", "deterministic",
                                  nth=KILL_ITER + 1)):
            _counted(ops, lambda: runner.run(inputs, resume=False))
        require(False, "pagerank: the injected kill did not fire")
    except F.DeterministicFault:
        launches += ops.launch_counts()["segment_reduce"]
    resumed = LoopRunner(cpk, str(d), every=2)
    t0 = time.perf_counter()
    resumed.mgr.resume(resumed.mgr.restore_flat)
    restore_ms = (time.perf_counter() - t0) * 1e3
    out, n = _counted(ops, lambda: resumed.run(inputs, resume=True))
    launches += n
    same = all(torch.equal(out[k], step[k]) for k in step)
    log(f"[ooc] pagerank LoopRunner(every=2) killed at iteration "
        f"{KILL_ITER}, resumed from checkpoint step {resumed.resumed_from}: "
        f"bits equal to the uninterrupted run_stepwise {same}; snapshot save "
        f"ms {[round(x, 1) for x in saves]}, restore {restore_ms:.1f} ms "
        f"(3 carries of {PR_VERTICES} float32)")
    require(same and resumed.resumed_from is not None,
            "pagerank resume: not bit-equal to the uninterrupted run")
    return launches


def phase_ooc(torch, seed):
    """Out-of-core and resume; returns the segment kernel's launches on
    this phase's path (the streamed runs, the killed and resumed ones)."""
    import tempfile
    import numpy as np
    from repro_torch.kernels import ops
    rng = np.random.default_rng(seed + 5)
    # the checkpoints live in the checkout's git-ignored output directory
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp = Path(tmp)
        launches = _ooc_group_by(torch, np, ops, rng, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        launches += _ooc_pagerank(torch, np, ops, rng, tmp)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[ooc] segment_reduce launches on the out-of-core path: {launches}")
    require(launches > 0, "segment_reduce was not launched out of core")
    ops.reset_launch_counts()
    return launches


# ---------------------------------------------------------------------------
# phase 6: plans — buffer donation and plan serving
# ---------------------------------------------------------------------------

# the programs run with donate=True at phase 3's sizes
DONATED = ("kmeans_step", "pagerank", "word_count", "matrix_addition")
# the serving runs: closed-loop clients, requests a level, the server's knobs
SERVE_CLIENTS, SERVE_REQUESTS = (1, 8, 64), 192
SERVE_MAX_BATCH, SERVE_FLUSH_MS = 16, 1.0
POOL = 4            # distinct requests of each (program, rows); the 192 cycle
# (a) the reference's own mix (benchmarks/serve_bench.py): pagerank on 64
# vertices, 3 steps; group_by into 16 groups; kmeans_step K = 4
MIX_A = dict(pagerank=(256, 192), group_by=(256, 192), kmeans_step=(128, 96))
# (b) a tenant mix with real work a request; each pair of sizes shares one
# power-of-two bucket, so padding is on the measured path: group_by rows and
# pagerank edges, kmeans points
MIX_B_ROWS = (2 ** 20, 3 * 2 ** 18)
MIX_B_KM = (2 ** 18, 3 * 2 ** 16)
MIX_B_GROUPS = MIX_B_VERTICES = 2 ** 16
MIX_B = dict(pagerank=MIX_B_ROWS, group_by=MIX_B_ROWS, kmeans_step=MIX_B_KM)
SERVED = ("pagerank", "group_by", "kmeans_step")
# the segment kernel's counters: all its launches, and the device-count
# and lanes entries' among them
SEGMENT_COUNTERS = ("segment_reduce", "segment_reduce[rows]",
                    "segment_reduce[lanes]")


def _mix_request(np, mix, name, m, seed):
    """One request of a serving mix, its bag `m` rows long (numpy: the
    server canonicalizes and stacks on the host)."""
    rng = np.random.default_rng(seed)
    if mix == "a":               # the reference bench's own inputs
        nv, groups, K, steps, ft = 64, 16, 4, 3.0, np.float64
    else:
        nv, groups, K, steps, ft = MIX_B_VERTICES, MIX_B_GROUPS, 64, 10.0, \
            np.float32
    if name == "pagerank":
        return dict(E=(rng.integers(0, nv, m).astype(ft),
                       rng.integers(0, nv, m).astype(ft)),
                    P=np.full(nv, 1.0 / nv, ft), NP=np.zeros(nv, ft),
                    C=np.zeros(nv, ft), N=nv, num_steps=steps, steps=0.0,
                    b=0.85)
    if name == "group_by":
        return dict(S=(rng.integers(0, groups, m).astype(ft),
                       rng.standard_normal(m).astype(ft)),
                    C=np.zeros(groups, ft))
    return dict(P=((rng.standard_normal(m) * 3).astype(ft),
                   (rng.standard_normal(m) * 3).astype(ft)),
                CX=rng.standard_normal(K).astype(ft),
                CY=rng.standard_normal(K).astype(ft), K=K,
                D=np.zeros((m, K), ft), MinD=np.full(m, 1e30, ft),
                Cl=np.zeros(m, ft), SX=np.zeros(K, ft), SY=np.zeros(K, ft),
                CN=np.zeros(K, ft), NX=np.zeros(K, ft), NY=np.zeros(K, ft))


def _bits(a, b):
    import torch
    return all(bool(torch.equal(a[k], b[k])) for k in b)


def _donate_inputs(torch, name, seed):
    """Phase 3's sizes for a donated program, made on the card from the
    seed."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def ints(hi, n):
        return torch.randint(0, hi, (n,), generator=g,
                             device="cuda").to(torch.float32)

    def normal(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    def zeros(*shape):
        return torch.zeros(*shape, device="cuda")
    if name == "word_count":
        return dict(W=(ints(VOCAB, N_ROWS),), C=zeros(VOCAB))
    if name == "matrix_addition":
        return dict(M=normal(MAT, MAT), N=normal(MAT, MAT),
                    R=zeros(MAT, MAT), n=MAT, m=MAT)
    if name == "pagerank":
        return dict(E=(ints(PR_VERTICES, PR_EDGES),
                       ints(PR_VERTICES, PR_EDGES)),
                    P=torch.full((PR_VERTICES,), 1.0 / PR_VERTICES,
                                 device="cuda"),
                    NP=zeros(PR_VERTICES), C=zeros(PR_VERTICES),
                    N=PR_VERTICES, num_steps=float(PR_STEPS), steps=0.0,
                    b=0.85)
    return dict(P=(normal(KM_POINTS) * 3, normal(KM_POINTS) * 3),
                CX=normal(KM_K), CY=normal(KM_K), K=KM_K,
                D=zeros(KM_POINTS, KM_K),
                MinD=torch.full((KM_POINTS,), 1e30, device="cuda"),
                Cl=zeros(KM_POINTS),
                **{a_: zeros(KM_K) for a_ in ("SX", "SY", "CN", "NX", "NY")})


def _donate_runs(torch, np, seed):
    """kmeans_step, pagerank, word_count and matrix_addition at phase 3's
    sizes with donate=True, each output fed back as the next call's donated
    input: bit-equal to whole mode, no byte of a donated name copied in or
    out and no recapture on the feed-back pattern, a fresh donated tensor
    consumed, a held output unchanged by the next call; run() ms of
    donate / whole / eager."""
    from repro_torch.core import compile_program
    from repro_torch.core.programs import ALL
    for name in DONATED:
        inputs = _donate_inputs(torch, name, seed)
        whole = compile_program(ALL[name])
        outs = tuple(whole.program.outputs)

        def fresh():          # the donated names as new tensors on the card
            return {k: v.clone() if k in outs and torch.is_tensor(v) else v
                    for k, v in inputs.items()}

        def fed(prev, restart=False):
            x = dict(inputs)
            x.update(prev)
            if restart and name == "pagerank":
                x["steps"] = 0.0      # the same work each call: 10 steps
            return x
        w1 = whole.run(inputs)
        w2 = whole.run(fed(w1))
        _, t_w = _run_program(torch, whole, inputs, 5)
        del whole
        eager = compile_program(ALL[name], compile_mode="eager")
        _, t_e = _run_program(torch, eager, inputs, 5)
        del eager
        gc.collect()
        torch.cuda.empty_cache()
        don = compile_program(ALL[name], donate=True)
        f = fresh()
        given = [f[k] for k in outs if torch.is_tensor(f[k])]
        d1 = don.run(f)
        torch.cuda.synchronize()
        require(all(t.numel() == 0 for t in given),
                f"donate {name}: a donated tensor on the card was not "
                "consumed")
        require(_bits(d1, w1), f"donate {name}: bits differ from whole mode")
        (entry, _), = don._whole_cache.values()
        s0, c0, r0 = dict(entry.staged), entry.cloned_bytes, entry.rebinds
        d2 = don.run(fed(d1))
        torch.cuda.synchronize()
        require(_bits(d2, w2), f"donate {name}: the fed-back call's bits "
                "differ from whole mode's")
        staged = sum(entry.staged[k] - s0.get(k, 0) for k in outs)
        cloned = entry.cloned_bytes - c0
        rebinds = entry.rebinds - r0
        require(staged == 0 and cloned == 0 and rebinds == 0,
                f"donate {name}: the feed-back pattern staged {staged} and "
                f"cloned {cloned} bytes of donated names, {rebinds} rebinds")
        del w2
        keep = {k: v.clone() for k, v in d2.items()}
        d3 = don.run(fresh())
        torch.cuda.synchronize()
        require(_bits(d2, keep), f"donate {name}: a later call overwrote an "
                "output the caller held")
        require(_bits(d3, w1), f"donate {name}: bits differ from whole mode")
        held_clone = entry.cloned_bytes - c0
        del keep, d1, d2, w1
        prev, times = d3, []
        for i in range(6):
            x = fed(prev, restart=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prev = don.run(x)
            torch.cuda.synchronize()
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
        times.sort()
        direct = sorted(entry._direct)
        log(f"[plans] donate {name}: run() ms donate {_ms_text(times)}; "
            f"whole {_ms_text(t_w)}; eager {_ms_text(t_e)}; feed-back: "
            f"donated names staged 0 B, cloned 0 B, rebinds 0 (all "
            f"names staged {sum(entry.staged.values()) - sum(s0.values())} "
            f"B); bit-equal to whole; fresh donated tensors consumed; a "
            f"held output unchanged (the caller's tensors took "
            f"{held_clone} B of copies); written back in the graph: "
            f"{sorted(entry.wb - set(direct))}, lent from the graphs' "
            f"memory: {direct}; rebinds {entry.rebinds}")
        del don, prev, entry, inputs
        gc.collect()
        torch.cuda.empty_cache()


def _closed_loop(srv, pool, order, clients):
    """`clients` closed-loop clients on one thread: each submits a request
    (pool[order[i]]), waits for its answer and submits the next, until all
    of `order` was submitted; the server pumps in between.  Returns
    [(ticket, pool index)] and the run's seconds."""
    nxt, live, done = 0, [], []
    t0 = time.perf_counter()

    def submit():
        nonlocal nxt
        i = order[nxt]
        nxt += 1
        name, _, ins = pool[i]
        live.append((srv.submit(name, ins), i))
    while nxt < min(clients, len(order)):
        submit()
    while live:
        if srv.pump() == 0:
            time.sleep(2e-5)
        still = [(t, i) for t, i in live if not t.done()]
        fin = [(t, i) for t, i in live if t.done()]
        live[:] = still
        for item in fin:
            done.append(item)
            if nxt < len(order):
                submit()
    return done, time.perf_counter() - t0


def _serve_mix(torch, np, mix, sizes, seed):
    """One serving mix through PlanServer(max_batch=16, flush_ms=1.0) at
    1, 8 and 64 closed-loop clients, 192 requests a level (a warm pass,
    then the measured one), every lane held bit-equal to its request's
    solo whole run().  Then one flush of 16 lanes of each program against
    16 solo run()s of the same requests, traced."""
    from repro_torch.core import compile_program
    from repro_torch.core.programs import ALL
    from repro_torch.kernels import ops
    from repro_torch.serve import PlanServer
    at_start = ops.launch_counts()
    pool = [(name, m, _mix_request(np, mix, name, m,
                                   seed + 1000 * j + 10 * i + r))
            for j, name in enumerate(SERVED)
            for i, m in enumerate(sizes[name]) for r in range(POOL)]
    solo_cp = {n: compile_program(ALL[n]) for n in SERVED}
    solo = [{k: v.cpu().numpy() for k, v in solo_cp[n].run(ins).items()}
            for n, _, ins in pool]
    order = [int(i) for i in np.random.default_rng(seed).integers(
        0, len(pool), SERVE_REQUESTS)]
    cps = {n: compile_program(ALL[n]) for n in SERVED}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lanes = 0
    for clients in SERVE_CLIENTS:
        for measured in (False, True):
            srv = PlanServer(cps, max_batch=SERVE_MAX_BATCH,
                             flush_ms=SERVE_FLUSH_MS)
            done, secs = _closed_loop(srv, pool, order, clients)
            for t, i in done:
                require(t.state == "done", f"plans mix ({mix}): request "
                        f"{t.rid} {t.state}: {t.error!r}")
                for k, v in solo[i].items():
                    require(np.array_equal(t.output[k], v),
                            f"plans mix ({mix}) {pool[i][0]} rows "
                            f"{pool[i][1]}: lane output {k} differs from "
                            "its solo run()")
            lanes += len(done)
            st = srv.stats()
            if not measured:
                built = st["batch_traced"]
                continue
            pad = sum(b.pad_rows for b in srv._buckets.values())
            rows = sum(b.bag_rows for b in srv._buckets.values())
            log(f"[plans] mix ({mix}) clients={clients}: "
                f"{len(done) / secs:.1f} req/s ({len(done)} requests in "
                f"{secs * 1e3:.1f} ms), p50 {st['p50_ms']:.3f} ms, p99 "
                f"{st['p99_ms']:.3f} ms, occupancy {st['occupancy']:.1f}%, "
                f"padded rows {100.0 * pad / max(rows, 1):.1f}%, flushes "
                f"{st['flushes']}, batch entries built {st['batch_traced']} "
                f"hit {st['batch_hits']} (the warm pass built {built}), "
                f"sequential fallbacks "
                f"{st['seq_fallbacks']}, failed {st['failed']}; every lane "
                "bit-equal to its solo run()")
            require(st["failed"] == 0 and st["seq_fallbacks"] == 0,
                    f"plans mix ({mix}): failed or sequential flushes")
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[plans] mix ({mix}): {lanes} lanes bit-equal to solo run(); "
        f"peak device memory {peak:.3f} GB")
    for name in SERVED:
        reqs = [ins for n, _, ins in pool if n == name]
        reqs = [reqs[i % len(reqs)] for i in range(SERVE_MAX_BATCH)]
        srv = PlanServer(cps, max_batch=SERVE_MAX_BATCH,
                         flush_ms=SERVE_FLUSH_MS)

        def flush():
            ts = [srv.submit(name, r) for r in reqs]
            srv.drain()
            return ts

        def solo_runs():
            return [solo_cp[name].run(r) for r in reqs]
        flush()
        solo_runs()
        before = ops.launch_counts()
        flush()
        torch.cuda.synchronize()
        after = ops.launch_counts()
        seg = {k: after[k] - before[k] for k in SEGMENT_COUNTERS}
        log(f"[plans] mix ({mix}) {name}: segment launches a flush of "
            f"{SERVE_MAX_BATCH} lanes {json.dumps(seg)}")
        require(seg["segment_reduce[lanes]"] > 0
                and seg["segment_reduce[rows]"] == 0,
                f"plans mix ({mix}) {name}: a flush's group-bys did not go "
                f"through the lanes entry alone ({seg})")
        f_ms, s_ms = [], []
        for _ in range(3):
            for fn, acc in ((flush, f_ms), (solo_runs, s_ms)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                acc.append((time.perf_counter() - t0) * 1e3)
        f_ms.sort()
        s_ms.sort()
        log(f"[plans] mix ({mix}) {name}: one flush of {SERVE_MAX_BATCH} "
            f"lanes {_ms_text(f_ms)} against {SERVE_MAX_BATCH} solo whole "
            f"run()s {_ms_text(s_ms)}")
        _profile(torch, f"plans mix ({mix}) {name} flush of "
                 f"{SERVE_MAX_BATCH}", flush, f_ms[1])

        def two_flushes():
            ts = [srv.submit(name, r) for r in reqs + reqs]
            srv.drain()
            return ts
        two_flushes()
        t_ms = sorted(time_ms(torch, two_flushes, reps=1, warmup=0)
                      for _ in range(3))
        _, spans = _profile(torch, f"plans mix ({mix}) {name} two flushes "
                            f"of {SERVE_MAX_BATCH}, the second prefetched",
                            two_flushes, t_ms[1])
        h2d, under = _h2d_overlap(spans)
        log(f"[plans] mix ({mix}) {name}: two flushes {_ms_text(t_ms)}; "
            f"host-to-device copies {h2d:.3f} ms, {under:.3f} ms of it "
            "while a kernel ran")
    end = ops.launch_counts()
    seg = {k: end[k] - at_start[k] for k in SEGMENT_COUNTERS}
    log(f"[plans] mix ({mix}): segment launches {json.dumps(seg)}")
    require(seg["segment_reduce[lanes]"] > 0,
            f"plans mix ({mix}): no launch of the segment kernel's lanes "
            "entry")
    del cps, solo_cp
    gc.collect()
    torch.cuda.empty_cache()


def _h2d_overlap(spans):
    """The ms that a trace's host-to-device copies took, and the ms of
    them during which a kernel ran."""
    kern = sorted((lo, hi) for lo, hi, n in spans
                  if not n.startswith(("Memcpy", "Memset")))
    merged = []
    for lo, hi in kern:
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    total = under = 0.0
    for lo, hi, n in spans:
        if "HtoD" in n:
            total += hi - lo
            under += sum(max(0.0, min(hi, b) - max(lo, a))
                         for a, b in merged)
    return total / 1e3, under / 1e3


def _serve_exact(torch, np, seed):
    """Requests whose lanes the card must not pad, and hot keys: ragged
    average and linear_regression requests (float sums over the bag, so
    each is bucketed at its own rows) and group_by requests whose solo
    runs salt a hot key (their lanes salted alike), through one
    PlanServer(max_batch=16, flush_ms=1.0); every lane bit-equal to its
    request's solo whole run()."""
    from repro_torch.core import compile_program
    from repro_torch.core.programs import ALL
    from repro_torch.serve import PlanServer
    names = ("average", "linear_regression", "group_by")
    cps = {n: compile_program(ALL[n]) for n in names}
    solo_cp = {n: compile_program(ALL[n]) for n in names}
    require(not cps["average"].pads_exactly
            and not cps["linear_regression"].pads_exactly
            and cps["group_by"].pads_exactly,
            "plans: the card pads average or linear_regression, or does "
            "not pad group_by")
    rng = np.random.default_rng(seed)
    reqs = []
    for m in MIX_B_ROWS:
        for _ in range(2):
            v = rng.standard_normal(m).astype(np.float32)
            reqs.append(("average", m, dict(V=v, s=0.0, cnt=0.0, avg=0.0)))
            x = rng.standard_normal(m).astype(np.float32)
            y = (2 * x + 1 + 0.1 * rng.standard_normal(m)).astype(np.float32)
            reqs.append(("linear_regression", m, dict(
                P=(x, y), n=m, sum_x=0.0, sum_y=0.0, x_bar=0.0, y_bar=0.0,
                xx_bar=0.0, xy_bar=0.0, slope=0.0, intercept=0.0)))
            keys = rng.integers(0, MIX_B_GROUPS, m)
            keys[rng.random(m) < 0.6] = 7
            reqs.append(("group_by", m, dict(
                S=(keys.astype(np.float32),
                   rng.standard_normal(m).astype(np.float32)),
                C=np.zeros(MIX_B_GROUPS, np.float32))))
    for name, _, ins in reqs:
        if name == "group_by":
            require(cps[name].request_salts(cps[name].canonical_inputs(ins)),
                    "plans: a hot-key group_by request does not salt")
    srv = PlanServer(cps, max_batch=SERVE_MAX_BATCH, flush_ms=SERVE_FLUSH_MS)
    ts = [srv.submit(n, ins) for n, _, ins in reqs]
    srv.drain()
    for (name, m, ins), t in zip(reqs, ts):
        require(t.state == "done", f"plans exact: {name} request {t.rid} "
                f"{t.state}: {t.error!r}")
        for k, v in solo_cp[name].run(ins).items():
            require(np.array_equal(t.output[k], v.cpu().numpy()),
                    f"plans exact: {name} rows {m}: lane output {k} "
                    "differs from its solo run()")
    st = srv.stats()
    for b in srv._buckets.values():
        require(b.program == "group_by" or not b.limit_bags,
                f"plans exact: bucket {b.label} is padded")
    log(f"[plans] unpadded and hot-key lanes: {len(reqs)} requests in "
        f"{st['flushes']} flushes over {len(srv._buckets)} buckets ("
        + ", ".join(f"{b.label} salts {b.salts or '-'}"
                    for b in srv._buckets.values())
        + f"), sequential fallbacks {st['seq_fallbacks']}; every lane "
        "bit-equal to its solo run()")
    require(st["failed"] == 0 and st["seq_fallbacks"] == 0,
            "plans exact: failed or sequential flushes")
    del cps, solo_cp
    gc.collect()
    torch.cuda.empty_cache()


def phase_plans(torch, seed):
    import numpy as np
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    _donate_runs(torch, np, seed)
    _serve_mix(torch, np, "a", MIX_A, seed)
    _serve_mix(torch, np, "b", MIX_B, seed)
    _serve_exact(torch, np, seed)
    counts = ops.launch_counts()
    log(f"[plans] kernel launches in phase 6: {json.dumps(counts)}; "
        f"phase 6 took {time.perf_counter() - t0:.1f} s")
    require(counts["segment_reduce"] > 0,
            "phase 6 launched no segment kernel")
    ops.reset_launch_counts()
    return {k: counts[k] for k in SEGMENT_COUNTERS}


# ---------------------------------------------------------------------------
# phase 7: distributed rounds
# ---------------------------------------------------------------------------

# the reference's distributed benchmark set (BENCH_distributed.json), at
# phase 3's sizes; the ranks of part 2, sharing the one card
DIST_PROGRAMS = ("word_count", "group_by", "pagerank", "kmeans_step",
                 "matrix_factorization_step")
DIST_RANKS = 4
# a world of 1 holds the whole bag: the same rows reach the same kernels
DIST_BIT_EQUAL = ("word_count", "group_by", "pagerank", "kmeans_step")
# the reference test's limit (tests/test_core_distributed.py): max |a - b|
# / (|b| + 1) against single-device run(); the REP-everything placement
# against the sharded one
DIST_TOL, REP_TOL = 1e-4, 1e-6
# pagerank's injected shard loss: the 7th post-round site of the unfused
# plan, the P store of the loop's second iteration (an aligned store: a
# block-restricted recompute), of rank 1's block
LOST_NTH, LOST_SHARD = 7, 1
# the straggling round: the 12th of the unfused plan, the loop's 4th NP
# reduce, slowed 100x over its own three earlier runs on a fake clock
SLOW_NTH = 12


class FakeClock:
    """A clock that moves only when a slow fault advances it."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _dist_err(torch, a, b) -> float:
    """max |a - b| / (|b| + 1) on the card, in slices of 2^26 elements."""
    a = a.reshape(-1)
    b = b.reshape(-1)
    if a.shape != b.shape:
        raise SmokeFailure(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    worst = 0.0
    for lo in range(0, a.numel(), 1 << 26):
        x = a[lo:lo + (1 << 26)].double()
        y = b[lo:lo + (1 << 26)].double()
        if not bool(torch.isfinite(x).all()):
            raise SmokeFailure("non-finite output")
        worst = max(worst, float(((x - y).abs() / (y.abs() + 1)).max()))
    return worst


def _outputs_err(torch, out, ref) -> float:
    return max(_dist_err(torch, out[k], ref[k]) for k in ref)


def _coll_costs(torch, mesh):
    """The cuda row's collective costs (op_select), on this card over
    NCCL, each call synchronized: µs of an all_reduce of one element, µs
    an element beyond it (2^28 float32 against one; a world of 1 moves
    nothing between cards, so this is the card's own copy rate), and µs
    of an all_gather of one element (the output gather a sharded
    destination adds to a run).  Medians."""
    from repro_torch.core.collectives import Collectives
    coll = Collectives(mesh)
    one = torch.ones(1, device="cuda")
    big = torch.ones(1 << 28, device="cuda")

    def us(fn, reps):
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e6)
        return sorted(times)[reps // 2]
    fixed = us(lambda: coll.all_reduce(one), 51)
    row = max(0.0, us(lambda: coll.all_reduce(big), 11) - fixed) / (1 << 28)
    gather = us(lambda: coll.all_gather(one), 51)
    del big
    return fixed, row, gather


def _rung(dp) -> str:
    """The ladder rung every run of `dp` so far stayed on, or a failure:
    the rounds, their fused regions run fused (the ledger holds no
    descent, no fused → per-member fall-back and no divergence)."""
    ledger = dp.explain_faults()
    c = dp.faults.counters
    require(c["descend"] == 0 and c["diverged"] == 0
            and "per-member" not in ledger,
            f"dist {dp.cp.program.name}: a run left the rounds "
            f"rung:\n{ledger}")
    fused = sum(ln.strip().startswith("round: fused round")
                for ln in dp.explain_rounds().splitlines())
    return (f"rung: rounds, {fused} fused region(s) run fused, "
            f"0 descents, {c['retry']} retries")


def _digest(out) -> str:
    """One hash of a run's outputs: names, shapes, dtypes and bits."""
    import hashlib
    h = hashlib.sha256()
    for k in sorted(out):
        v = out[k].detach().contiguous().cpu()
        h.update(f"{k}{tuple(v.shape)}{v.dtype}".encode())
        h.update(v.numpy().tobytes())
    return h.hexdigest()


def _round_lines(text):
    return [ln.strip() for ln in text.splitlines()
            if ln.strip().startswith(("round:", "loop:", "transport:",
                                      "placement:", "balance["))]


def _dist_world1(torch, np, seed):
    """Part 1: every program through compile_distributed over a NCCL
    group of one rank (this process), against single-device eager and
    whole run(); the segment and tile launches of the distributed runs."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from repro_torch.core import compile_program
    from repro_torch.core.distributed import compile_distributed
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_test_mesh
    tmp = tempfile.mkdtemp(prefix="dist-store-")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=300))
    launches = {k: 0 for k in PROGRAM_KERNELS}
    try:
        mesh = make_test_mesh((1,), ("data",), device="cuda:0")
        fixed, row, gather = _coll_costs(torch, mesh)
        log(f"[dist] collectives over NCCL, world of 1, this card, "
            f"synchronized calls (not op_select's: nothing crosses cards): "
            f"all_reduce {fixed:.2f} us a call, {row:.3e} us an element; "
            f"all_gather {gather:.2f} us a call")
        rng = np.random.default_rng(seed + 7)
        ALL, progs = _programs(np, rng, torch, only=DIST_PROGRAMS)
        for name, inputs, *_ in progs:
            eager = compile_program(ALL[name], compile_mode="eager")
            out_e, t_e = _run_program(torch, eager, inputs, 5)
            whole = compile_program(ALL[name])
            _, t_w = _run_program(torch, whole, inputs, 5)
            del whole
            gc.collect()
            dp = compile_distributed(ALL[name], mesh)
            ops.reset_launch_counts()
            out_d, t_d = _run_program(torch, dp, inputs, 5)
            counts = ops.launch_counts()
            rung = _rung(dp)
            for k in launches:
                launches[k] += counts[k]
            err = _outputs_err(torch, out_d, out_e)
            require(err < DIST_TOL, f"dist {name}: world of 1 differs from "
                    f"eager run() by {err:.3e}")
            differ = [k for k in out_e if not torch.equal(out_d[k], out_e[k])]
            if name in DIST_BIT_EQUAL and differ:
                log(f"[dist] world=1 {name}: NOT bit-equal to eager run() "
                    f"in {differ}")
            med = {m: t[len(t) // 2] for m, t in
                   (("dist", t_d), ("whole", t_w), ("eager", t_e))}
            log(f"[dist] world=1 {name}: run() {_ms_text(t_d)}; single-"
                f"device whole {med['whole']:.3f} ms, eager "
                f"{med['eager']:.3f} ms; overhead over eager "
                f"{med['dist'] - med['eager']:+.3f} ms; rel_err vs eager "
                f"{err:.3e}; bits equal to eager "
                f"{'all' if not differ else 'not ' + ','.join(differ)}; "
                f"launches {json.dumps(counts)}; collectives "
                f"{json.dumps(dict(dp.coll.calls))}; {rung}")
            for line in _round_lines(dp.explain_rounds()):
                log(f"[dist]   {line}")
            # where the round machinery's time goes: the device's busy
            # time in one distributed and one eager call
            _profile(torch, f"dist world=1 {name}", lambda: dp.run(inputs),
                     med["dist"])
            _profile(torch, f"dist eager {name}",
                     lambda: eager.run(inputs), med["eager"])
            _rung(dp)
            del dp, eager, out_d, out_e
            gc.collect()
            torch.cuda.empty_cache()
        require(launches["segment_reduce"] > 0,
                "the distributed path launched no segment kernel")
        t = time.perf_counter()
        dp_launches = _train_dp_world1(torch, mesh, seed)
        dp_secs = time.perf_counter() - t
    finally:
        dist.destroy_process_group()
    return launches, dp_launches, dp_secs


def _quiet(cp):
    cp.policy.backoff_s = 0.0
    cp.policy.max_backoff_s = 0.0
    cp.faults.sleep = lambda s: None
    return cp


def _rank_case(mesh, name, seed):
    """Part 2, on one of the ranks that share the card: the program
    distributed over the group against single-device run() (rank 0 runs
    it), two runs' bits, REP-everything, bytes a run through each
    collective, the rank's peak memory and its kernel launches."""
    import numpy as np
    import torch

    from repro_torch.core import compile_program
    from repro_torch.core.distributed import compile_distributed
    from repro_torch.kernels import ops
    rng = np.random.default_rng(seed + 7)
    ALL, progs = _programs(np, rng, torch, only=(name,), device="cpu")
    inputs = progs[0][1]
    res = {"rank": mesh.rank}
    # eager: the same bits as whole mode (phase 3), and no graph memory
    # held beside the ranks' runs
    single = compile_program(ALL[name], compile_mode="eager").run(inputs) \
        if mesh.rank == 0 else None
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dp = compile_distributed(ALL[name], mesh)
    ops.reset_launch_counts()
    out = dp.run(inputs)
    res["bytes"] = dict(dp.coll.bytes)
    res["calls"] = dict(dp.coll.calls)
    # kmeans gathers its 4.3 GB D through host memory on every run
    reps = 1 if name == "kmeans_step" else 3
    # the straggler agreement's cost: runs with speculation off, each
    # after one with it on (its launches are not the main path's)
    launches = ops.launch_counts()
    off, same = None, True
    if name != "kmeans_step":
        off = compile_distributed(ALL[name], mesh, speculative=False)
        same = _digest(off.run(inputs)) == _digest(out)
    agreed = dp.coll.calls["agree"]
    times, times_off = [], []
    for _ in range(reps):
        before = ops.launch_counts()
        t, ok = _rank_times(torch, dp, inputs, out, 1)
        for k, n in ops.launch_counts().items():
            launches[k] += n - before[k]
        times += t
        same &= ok
        if off is not None:
            t, ok = _rank_times(torch, off, inputs, out, 1)
            times_off += t
            same &= ok
    res["agree_a_run"] = (dp.coll.calls["agree"] - agreed) / reps
    res["launches"] = launches
    res["times"] = sorted(times)
    res["same_bits"] = same
    res["rung"] = _rung(dp)
    res["digest"] = _digest(out)
    if off is not None:
        res["times_spec_off"] = sorted(times_off)
        _rung(off)
        del off
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["transport"] = dp.coll.transports()
    res["rounds"] = dp.explain_rounds()
    _placed, _bl, res["array_limits"] = dp.place(inputs) \
        if name == "pagerank" else (None, None, {})
    del _placed
    if single is not None:
        res["err"] = _outputs_err(torch, out, single)
        del single
    # REP-everything: four whole copies of kmeans' 4.3 GB D and its
    # temporaries do not fit beside each other on one card
    if name != "kmeans_step":
        rep = compile_distributed(ALL[name], mesh, shard_dense=False)
        res["rep_err"] = _outputs_err(torch, rep.run(inputs), out)
        _rung(rep)
    return res


def _rank_times(torch, dp, inputs, out, reps):
    """`reps` timed runs of dp (host clock around run() and a
    synchronize), sorted, and whether each gave `out`'s bits."""
    times, same = [], True
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = dp.run(inputs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        same &= all(torch.equal(again[k], out[k]) for k in out)
        del again
    return sorted(times), same


def _rank_pagerank_faults(mesh, seed):
    """Part 2's recovery runs on one rank: pagerank (unfused, so a round
    runs inside the loop) with rank LOST_SHARD's block lost after the
    LOST_NTH round, against the fault-free run; then round SLOW_NTH
    straggling on a fake clock."""
    import numpy as np
    import torch

    from repro_torch.core import compile_program
    from repro_torch.core import faults as F
    from repro_torch.core import plan as P
    from repro_torch.core.distributed import compile_distributed
    rng = np.random.default_rng(seed + 7)
    ALL, progs = _programs(np, rng, torch, only=("pagerank",), device="cpu")
    inputs = progs[0][1]

    def mk():
        return compile_distributed(_quiet(compile_program(
            ALL["pagerank"], round_fusion=False)), mesh)
    ref_dp = mk()
    ref = ref_dp.run(inputs)
    _rung(ref_dp)
    dp = mk()
    with F.inject(F.FaultSpec("dist.shard_lost", kind="shard_lost",
                              nth=LOST_NTH, shard=LOST_SHARD)):
        out = dp.run(inputs)
    loop = next(n for n in dp.cp.plan if isinstance(n, P.SeqLoop))
    lin = next(n for n in loop.body
               if isinstance(n, P.DenseMap) and n.dest == "P").lineage
    blk = -(-PR_VERTICES // mesh.size)
    s = LOST_SHARD * blk
    reads = ", ".join(f"{a}:{k}" for a, k in lin.reads) or "none"
    want = (f"  recovered[round:DenseMap] shard {LOST_SHARD}/{mesh.size}: "
            f"P[{s}:{s + blk}] via block-restricted recompute "
            f"(1/{mesh.size} of the round); lineage depth={lin.depth} (a "
            f"from-scratch restart would replay {lin.depth} round(s)); "
            f"reads[{reads}]; checksum ok")
    res = {"lost_bits": all(torch.equal(out[k], ref[k]) for k in ref),
           "lost_descents": dp.faults.counters["descend"],
           "lost_text": want in dp.explain_faults().splitlines(),
           "lost_ledger": dp.explain_faults()}
    dp = mk()
    clk = FakeClock()
    dp.faults.clock = clk
    specs = [F.FaultSpec("dist.round_exec", "slow", nth=1,
                         times=SLOW_NTH - 1, delay_s=0.01),
             F.FaultSpec("dist.round_exec", "slow", nth=SLOW_NTH,
                         delay_s=1.0)]
    with F.inject(*specs, clock=clk):
        out = dp.run(inputs)
    _rung(dp)
    res.update(spec_bits=all(torch.equal(out[k], ref[k]) for k in ref),
               speculative=dp.faults.counters["speculative"],
               spec_text=[ln for ln in dp.explain_faults().splitlines()
                          if "speculative" in ln and "[round" in ln])
    return res


def _dist_ranks(torch, np, seed):
    """Part 2: DIST_RANKS ranks spawned on the one card over gloo; their
    [train-dp] part's launches and seconds."""
    from repro_torch.launch.ranks import RankFailure, RankGroup
    try:
        with RankGroup(DIST_RANKS, backend="gloo", device="cuda:0",
                       timeout_s=300, deadline_s=900) as g:
            for name in DIST_PROGRAMS:
                res = g.run(_rank_case, name, seed)
                r0 = res[0]
                require(r0["err"] < DIST_TOL, f"dist {name}: {DIST_RANKS} "
                        f"ranks differ from single-device run() by "
                        f"{r0['err']:.3e}")
                require(all(r["same_bits"] for r in res),
                        f"dist {name}: two runs gave other bits")
                require(all(r["digest"] == r0["digest"] for r in res),
                        f"dist {name}: the ranks' outputs differ from rank "
                        f"0's")
                if "rep_err" in r0:
                    require(all(r["rep_err"] < REP_TOL for r in res),
                            f"dist {name}: REP-everything differs by "
                            f"{max(r['rep_err'] for r in res):.3e}")
                seg = [r["launches"]["segment_reduce"] for r in res]
                if name != "matrix_factorization_step":
                    require(all(seg), f"dist {name}: a rank launched no "
                            "segment kernel")
                if name == "pagerank":
                    require(r0["array_limits"].get("P") == PR_VERTICES,
                            "pagerank's N was not padded and masked")
                med = [r["times"][len(r["times"]) // 2] for r in res]
                log(f"[dist] ranks={DIST_RANKS} (gloo, one card shared: "
                    f"not a scaling number) {name}: run() ms by rank "
                    f"{[round(m, 3) for m in med]} (median of "
                    f"{len(r0['times'])}); "
                    f"rel_err vs single-device {r0['err']:.3e}"
                    + (f", REP-everything vs sharded "
                       f"{max(r['rep_err'] for r in res):.3e}"
                       if "rep_err" in r0 else ", REP-everything not run "
                       "(4 whole copies do not fit one card)")
                    + f"; two runs bit-equal; every rank's outputs "
                    f"bit-equal to rank 0's; peak GB by rank "
                    f"{[round(r['peak_gb'], 3) for r in res]}; segment "
                    f"launches by rank {seg}; {r0['rung']}")
                if "times_spec_off" in r0:
                    off = [r["times_spec_off"][len(r["times_spec_off"]) // 2]
                           for r in res]
                    log(f"[dist]   speculation off: run() ms by rank "
                        f"{[round(m, 3) for m in off]} (median of "
                        f"{len(r0['times_spec_off'])}); straggler "
                        f"agreements a run with it on "
                        f"{r0['agree_a_run']:g}")
                log(f"[dist]   bytes a run through each collective (rank "
                    f"0): {json.dumps(r0['bytes'])}; calls "
                    f"{json.dumps(r0['calls'])}; transport {r0['transport']}")
                for line in _round_lines(r0["rounds"]):
                    log(f"[dist]   {line}")
            t = time.perf_counter()
            dp_launches = _train_dp_ranks(torch, g, seed)
            dp_secs = time.perf_counter() - t
            res = g.run(_rank_pagerank_faults, seed)
    except RankFailure as ex:
        raise SmokeFailure(f"dist ranks: {ex}") from None
    for r in res:
        require(r["lost_bits"], "pagerank after a shard loss differs from "
                "the fault-free run")
        require(r["lost_descents"] == 0, "the shard loss descended")
        require(r["lost_text"], "the recovery ledger's text is not the "
                "reference's:\n" + r["lost_ledger"])
        require(r["spec_bits"] and r["speculative"] == 1,
                "the straggling round got no speculative backup")
    log(f"[dist] ranks={DIST_RANKS} pagerank: shard {LOST_SHARD} lost after "
        f"round {LOST_NTH}: bit-equal to the fault-free run, 0 descents, "
        f"ledger text the reference's; straggler: "
        f"{res[0]['spec_text'][0].strip()}")
    return dp_launches, dp_secs


# [train-dp]: data-parallel training in phase 7's worlds.  llama3-8b at
# phase 8's config over the NCCL world of 1 with compress_grads on (the
# reference's default): DP_STEPS steps without a mesh and DP_STEPS
# through it, from the same weights and batches, the first bit-equal;
# whisper-tiny whole at phase 8's batch over the DIST_RANKS gloo ranks
# that share the card (two rows a rank): one float32 step against a
# world-of-1 step of the same global batch in this process (phase 8's
# check tolerances), then TRAIN_STEPS bf16 steps through TrainRunner,
# rank 0 saving every DP_SAVE_EVERY steps, its last snapshot resumed here
DP_ARCH, DP_RANK_ARCH, DP_STEPS, DP_SAVE_EVERY = ("llama3-8b", "whisper-tiny",
                                                  3, 3)


def _bits_digest(torch, t):
    """A 64-bit fingerprint of a tensor's bits, on its device: its 16-bit
    words, each times an odd multiplier of its position, summed modulo
    2^64 (a word that differs changes the sum)."""
    w = t.detach().reshape(-1).view(torch.int16)
    total = torch.zeros((), dtype=torch.int64, device=t.device)
    step = 1 << 22        # 32 MB int64 temporaries a chunk: no peak of its own
    for lo in range(0, w.numel(), step):
        c = w[lo:lo + step].to(torch.int64) & 0xFFFF
        idx = torch.arange(lo, lo + c.numel(), dtype=torch.int64,
                           device=t.device)
        total += (c * ((idx * -7046029254386353131) | 1)).sum()
    return int(total)


def _dp_state(model, opt):
    """Every parameter and moment of a model and its AdamW state."""
    return [t for _, t in model.named_leaves()] + list(opt.mu.values()) \
        + list(opt.nu.values())


def _dp_opt(torch, cfg, model):
    """AdamW's state for `model`, its moments in the config's dtype."""
    from repro_torch.optim import adamw_init
    return adamw_init(dict(model.named_leaves()),
                      torch.bfloat16 if cfg.opt_dtype == "bf16"
                      else torch.float32)


def _crc32s(model, opt):
    """The crc32 of every parameter's and moment's bytes, on the host."""
    import torch
    from repro_torch.core.faults import checksum
    return [checksum(t.detach().reshape(-1).view(torch.uint8).cpu().numpy())
            for t in _dp_state(model, opt)]


def _dp_config(f32=False):
    """whisper-tiny at phase 8's config (float32 with `f32`) and its batch."""
    from repro_torch.configs import get_config
    layers, batch, seq = TRAIN_ARCHS[DP_RANK_ARCH]
    cfg = train_config(get_config, DP_RANK_ARCH, layers)
    if f32:
        import torch
        cfg = cfg.replace(param_dtype=torch.float32,
                          compute_dtype=torch.float32,
                          cache_dtype=torch.float32)
    return cfg, batch, seq


def _dp_grads(torch, cfg, mesh, seed, batch, seq):
    """One float32 step (compress_grads off) of `cfg` from the seed's
    weights on this process's rows: (loss, grad_norm, the gradients AdamW
    was handed: the ranks' sum over a mesh)."""
    from repro_torch.models import get_model
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_train_step
    from repro_torch.train import step as step_mod
    model = get_model(cfg).init(seed)
    rank, world = (0, 1) if mesh is None else (mesh.rank, mesh.size)
    data = _train_data(cfg, batch, seq, seed, rank, world)
    seen, real = {}, step_mod.adamw_update

    def spy(params, grads, state, **kw):
        seen.update({k: g.detach().clone() for k, g in grads.items()})
        return real(params, grads, state, **kw)
    step_mod.adamw_update = spy
    try:
        step = make_train_step(cfg, mesh, lr=TRAIN_LR, compress_grads=False)
        _, _, m = step(model, adamw_init(dict(model.named_leaves())),
                       data.next_batch())
    finally:
        step_mod.adamw_update = real
    return float(m["loss"]), float(m["grad_norm"]), seen


def _rank_dp_f32(mesh, seed):
    """[train-dp] on one of the ranks that share the card: one float32
    whisper-tiny step through the mesh on this rank's rows; the summed
    gradients (rank 0's, as numpy) and their crc32s; and the refusal of a
    graph of the step over this mesh (gloo through pinned host memory)."""
    import torch
    from repro_torch.core.faults import checksum
    from repro_torch.train import CaptureError, graphed_step, make_train_step
    cfg, batch, seq = _dp_config(f32=True)
    try:
        graphed_step(make_train_step(cfg, mesh))
        refused = None
    except CaptureError as ex:
        refused = str(ex)
    loss, gn, grads = _dp_grads(torch, cfg, mesh, seed, batch, seq)
    host = {k: g.cpu().numpy() for k, g in grads.items()}
    return {"loss": loss, "grad_norm": gn,
            "crc": [checksum(v) for v in host.values()],
            "grads": host if mesh.rank == 0 else None, "refused": refused}


def _rank_dp_runner(mesh, seed, ckpt_dir):
    """[train-dp] on one of the ranks: TRAIN_STEPS bf16 whisper-tiny steps
    through TrainRunner over the mesh (compress_grads on), rank 0 saving
    every DP_SAVE_EVERY: per step ms, loss and every leaf's crc32, the
    rank's kernel launches, collective calls and bytes, and peak memory."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import get_model
    from repro_torch.runtime import TrainRunner
    from repro_torch.train import make_train_step
    cfg, batch, seq = _dp_config()
    model = get_model(cfg).init(seed)
    opt = _dp_opt(torch, cfg, model)
    r = TrainRunner(make_train_step(cfg, mesh, lr=TRAIN_LR,
                                    compress_grads=True),
                    model, opt, _train_data(cfg, batch, seq, seed, mesh.rank,
                                            mesh.size),
                    ckpt_dir=ckpt_dir, ckpt_every=DP_SAVE_EVERY)
    calls, nbytes = dict(mesh.coll.calls), dict(mesh.coll.bytes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    ms, losses, crcs = [], [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = r.run(i + 1)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(m["loss"]))
        crcs.append(_crc32s(r.params, r.opt_state))
    return {"ms": ms, "losses": losses, "crcs": crcs,
            "launches": ops.launch_counts(),
            "calls": {k: n - calls.get(k, 0) for k, n in
                      mesh.coll.calls.items()},
            "bytes": {k: n - nbytes.get(k, 0) for k, n in
                      mesh.coll.bytes.items()},
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def _train_dp_world1(torch, mesh, seed):
    """[train-dp] part 1: llama3-8b at phase 8's config, DP_STEPS steps
    without a mesh, then from the same weights and batches DP_STEPS
    through the NCCL world of 1: every parameter and moment bit-equal
    after the first step (one rank: the sum is the identity, the division
    by 1 exact), each run's launches as `train_launches` says; then
    DP_STEPS through the world of 1 as one CUDA graph (`graphed_step`: a
    NCCL mesh is captured) from the same weights again, its parameters
    and moments after the last step bit-equal to the eager mesh step's,
    its collective calls and bytes the same; then one mesh step
    profiled.  Returns the launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import get_model
    from repro_torch.train import graphed_step, make_train_step
    layers, batch, seq = TRAIN_ARCHS[DP_ARCH]
    cfg = train_config(get_config, DP_ARCH, layers)
    data = _train_data(cfg, batch, seq, seed)
    batches = [data.next_batch() for _ in range(DP_STEPS)]
    model = get_model(cfg).init(seed)
    opt = _dp_opt(torch, cfg, model)
    per_step = train_launches(cfg, seq)
    launches, runs = {}, {}
    for name, m, graphed in (("no mesh", None, False),
                             ("world of 1", mesh, False),
                             ("world of 1, graph", mesh, True)):
        if m is not None:        # the seed's weights again, zero moments
            _reset(torch, model, opt, seed)
        step = make_train_step(cfg, m, lr=TRAIN_LR, compress_grads=True)
        if graphed:
            step = graphed_step(step)
        calls, nbytes = dict(mesh.coll.calls), dict(mesh.coll.bytes)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        ms, losses = [], []
        for i, b in enumerate(batches):
            torch.cuda.synchronize()
            t = time.perf_counter()
            model, opt, met = step(model, opt, b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            losses.append(float(met["loss"]))
            if i in (0, len(batches) - 1):
                digests = [_bits_digest(torch, t)
                           for t in _dp_state(model, opt)]
                if i == 0:
                    first = digests
        counts = ops.launch_counts()
        want = {k: per_step.get(k, 0) * DP_STEPS for k in counts}
        require(counts == want, f"train-dp {DP_ARCH} {name}: launches "
                f"{json.dumps(counts)} in {DP_STEPS} steps, expected "
                f"{json.dumps(want)}")
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        runs[name] = {"ms": ms, "losses": losses, "digests": first,
                      "last": digests,
                      "peak": torch.cuda.max_memory_allocated() / 1e9,
                      "calls": {k: (n - calls.get(k, 0)) / DP_STEPS
                                for k, n in mesh.coll.calls.items()
                                if n != calls.get(k, 0)},
                      "bytes": {k: (n - nbytes.get(k, 0)) / DP_STEPS
                                for k, n in mesh.coll.bytes.items()
                                if n != nbytes.get(k, 0)},
                      "step": step}
        if graphed:
            del step
            runs[name]["step"] = None
            gc.collect()
            torch.cuda.empty_cache()
    a, b, c = runs["no mesh"], runs["world of 1"], runs["world of 1, graph"]
    same = sum(x == y for x, y in zip(a["digests"], b["digests"]))
    require(same == len(a["digests"]) and a["losses"][0] == b["losses"][0],
            f"train-dp {DP_ARCH}: the world-of-1 step differs from the "
            f"mesh-free one in {len(a['digests']) - same} of "
            f"{len(a['digests'])} leaves (loss {b['losses'][0]!r} vs "
            f"{a['losses'][0]!r})")
    same_g = sum(x == y for x, y in zip(b["last"], c["last"]))
    require(same_g == len(b["last"]) and b["losses"] == c["losses"],
            f"train-dp {DP_ARCH}: after {DP_STEPS} steps the graphed mesh "
            f"step differs from the eager one in {len(b['last']) - same_g} "
            f"of {len(b['last'])} leaves (losses {c['losses']} vs "
            f"{b['losses']})")
    require(not a["calls"] and b["calls"].get("all_reduce", 0) >= 2
            and c["calls"] == b["calls"] and c["bytes"] == b["bytes"],
            f"train-dp {DP_ARCH}: collectives {a['calls']} without a mesh, "
            f"{b['calls']} through it, {c['calls']} through its graph")
    require(all(math.isfinite(x) for x in a["losses"] + b["losses"]),
            f"train-dp {DP_ARCH}: non-finite loss")
    buckets = len(b["step"].exchange.buckets)
    run_ms = _median(b["ms"][1:])
    per, _ = _profile(torch, f"train-dp {DP_ARCH} world-of-1 step", lambda: (
        b["step"](model, opt, batches[-1]), torch.cuda.synchronize()),
        run_ms, top=3)
    nccl = [(ms, c) for k, (ms, c) in per.items() if "nccl" in k.lower()]
    nccl_ms = sum(ms for ms, _ in nccl)
    log(f"[train-dp] {DP_ARCH}: phase 8's config ({cfg.num_layers} layers, "
        f"{batch} x {seq}, bf16), compress_grads on: {DP_STEPS} steps "
        f"without a mesh and {DP_STEPS} through a NCCL world of 1 from the "
        f"same weights and batches: the first step's parameters and moments "
        f"bit-equal in {same} of {len(a['digests'])} leaves (64-bit "
        f"fingerprints on the card), losses {a['losses']} / {b['losses']}; "
        f"step ms (steps 2-{DP_STEPS}) {[round(x, 1) for x in b['ms'][1:]]} "
        f"through the mesh, {[round(x, 1) for x in a['ms'][1:]]} without "
        f"(phase 8's median is on its [train] line); the exchange a step: "
        f"all_reduce calls {b['calls'].get('all_reduce', 0):g} "
        f"({buckets} buckets of at most 256 MiB and the loss), bytes "
        f"{json.dumps(b['bytes'])}; NCCL device time in the profiled step "
        f"{nccl_ms:.3f} ms over {sum(n for _, n in nccl)} kernels; peak "
        f"{b['peak']:.2f} GB through the mesh, {a['peak']:.2f} GB without; "
        f"the graphed mesh step (the first call the eager warm-up and the "
        f"capture, then replays): step ms {[round(x, 1) for x in c['ms']]}, "
        f"after {DP_STEPS} steps every parameter and moment bit-equal to "
        f"the eager mesh step's ({same_g} of {len(b['last'])} leaves), the "
        f"same losses, the same collective calls and bytes a step; peak "
        f"{c['peak']:.2f} GB; "
        f"launches {json.dumps({k: n for k, n in launches.items() if n})}")
    del runs, a, b, c, model, opt, batches
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _train_dp_ranks(torch, g, seed):
    """[train-dp] part 2, over the gloo ranks that share the card (not a
    scaling number: DIST_RANKS processes on one card): whisper-tiny's
    float32 step against a world-of-1 step here, then the bf16 runner,
    every leaf's crc32 equal on every rank after each step, rank 0's
    last snapshot resumed here at its step and data position with rank
    0's crc32s.  Returns the ranks' launches, summed."""
    import tempfile

    from repro_torch.models import get_model
    from repro_torch.optim.adamw import global_norm
    from repro_torch.runtime import TrainRunner
    from repro_torch.train import make_train_step
    t0 = time.perf_counter()
    res = g.run(_rank_dp_f32, seed)
    require(all(r["crc"] == res[0]["crc"] for r in res),
            "train-dp: the ranks' summed gradients differ")
    require(all(r["refused"] for r in res),
            f"train-dp: a graph of the step over the gloo ranks did not "
            f"raise on {[i for i, r in enumerate(res) if not r['refused']]}")
    log(f"[train-dp] {DP_RANK_ARCH}: graphed_step over the {DIST_RANKS} "
        f"gloo ranks raises on every rank: {res[0]['refused']}")
    cfg, batch, seq = _dp_config(f32=True)
    l_ref, gn_ref, g_ref = _dp_grads(torch, cfg, None, seed, batch, seq)
    l_got, gn_got = res[0]["loss"], res[0]["grad_norm"]
    e_loss = abs(l_got - l_ref) / abs(l_ref)
    e_gn = abs(gn_got - gn_ref) / abs(gn_ref)
    require(e_loss <= 1e-4 and e_gn <= 1e-4,
            f"train-dp {DP_RANK_ARCH}: loss {l_got} vs {l_ref} "
            f"({e_loss:.3g}), grad_norm {gn_got} vs {gn_ref} ({e_gn:.3g}), "
            "tol 1e-4")
    worst, where = 0.0, ""
    for k, ref in g_ref.items():
        got = torch.from_numpy(res[0]["grads"][k]).to(ref.device)
        e = float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                 1e-30)
        if e > worst:
            worst, where = e, k
    require(worst <= 1e-3, f"train-dp {DP_RANK_ARCH}: gradient {where} err "
                           f"{worst:.3g} of its max |ref| > 1e-3")
    require(abs(float(global_norm(g_ref)) - gn_ref) <= 1e-4 * gn_ref,
            "train-dp: the spied gradients are not the step's")
    log(f"[train-dp] {DP_RANK_ARCH}: {DIST_RANKS} gloo ranks on one card "
        f"({batch // DIST_RANKS} rows a rank of {batch} x {seq}, microbatch "
        f"{cfg.microbatch}), float32, one step against a world-of-1 step of "
        f"the same global batch here: loss {l_got!r} (here {l_ref!r}, rel "
        f"err {e_loss:.3g}), grad_norm {gn_got!r} (here {gn_ref!r}, rel err "
        f"{e_gn:.3g}), worst summed gradient leaf {where} {worst:.3g} of its "
        f"max |ref| (tol 1e-3); every rank's sums bit-equal")
    del g_ref, res
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        res = g.run(_rank_dp_runner, seed, tmp)
        for i in range(TRAIN_STEPS):
            require(all(r["crcs"][i] == res[0]["crcs"][i] for r in res),
                    f"train-dp {DP_RANK_ARCH}: the ranks' parameters or "
                    f"moments differ after step {i + 1}")
        require(all(math.isfinite(x) for r in res for x in r["losses"]),
                f"train-dp {DP_RANK_ARCH}: non-finite loss")
        cfg, batch, seq = _dp_config()
        per_step = train_launches(cfg, seq)
        for r in res:
            want = {k: per_step.get(k, 0) * TRAIN_STEPS
                    for k in r["launches"]}
            require(r["launches"] == want, f"train-dp {DP_RANK_ARCH}: a "
                    f"rank's launches {json.dumps(r['launches'])}, expected "
                    f"{json.dumps(want)}")
        model = get_model(cfg).init(seed + 1)
        one = TrainRunner(make_train_step(cfg, lr=TRAIN_LR,
                                          compress_grads=True),
                          model, _dp_opt(torch, cfg, model),
                          _train_data(cfg, batch, seq, seed), ckpt_dir=tmp,
                          ckpt_every=10 ** 6)
        t = time.perf_counter()
        require(one.maybe_resume() and one.step == TRAIN_STEPS
                and one.data.step == TRAIN_STEPS
                and int(one.opt_state.step) == TRAIN_STEPS,
                f"train-dp {DP_RANK_ARCH}: resumed at step {one.step}, data "
                f"{one.data.step}")
        t_resume = time.perf_counter() - t
        require(_crc32s(one.params, one.opt_state) == res[0]["crcs"][-1],
                f"train-dp {DP_RANK_ARCH}: the resumed state differs from "
                "rank 0's")
        del one, model
    launches = {}
    for r in res:
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
    med = [round(_median(r["ms"][1:]), 1) for r in res]
    calls, nbytes = ({k: n / TRAIN_STEPS for k, n in res[0][part].items()
                      if n} for part in ("calls", "bytes"))
    log(f"[train-dp] {DP_RANK_ARCH}: bf16, compress_grads on, {TRAIN_STEPS} "
        f"steps through TrainRunner on {DIST_RANKS} gloo ranks sharing one "
        f"card (a check of correctness, not a scaling number): every "
        f"parameter's and moment's crc32 equal on every rank after each "
        f"step; losses {[round(x, 4) for x in res[0]['losses']]}; step ms "
        f"by rank (median of steps 2-{TRAIN_STEPS}) {med}; collectives a "
        f"step (rank 0: the exchange, the runner's barrier, the first "
        f"call's crc32 gather) calls {json.dumps(calls)}, bytes "
        f"{json.dumps(nbytes)}; peak GB by rank {[round(r['peak_gb'], 3) for r in res]}; rank "
        f"0's step-{TRAIN_STEPS} snapshot resumed in one process (no mesh) "
        f"at step {TRAIN_STEPS}, data position {TRAIN_STEPS}, with rank 0's "
        f"crc32s, in {t_resume:.1f} s; launches (all ranks) "
        f"{json.dumps({k: n for k, n in launches.items() if n})}; "
        f"{time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_dist(torch, seed):
    """Phase 7: the distributed rounds, a world of 1 over NCCL, then
    DIST_RANKS ranks sharing the card over gloo, each world also training
    (`[train-dp]`).  Returns the program kernels' launches on the
    world-of-1 distributed path, and the [train-dp] parts' launches and
    seconds."""
    import numpy as np
    t0 = time.perf_counter()
    launches, dp_launches, dp_secs = _dist_world1(torch, np, seed)
    gc.collect()
    torch.cuda.empty_cache()
    more, secs = _dist_ranks(torch, np, seed)
    for k, n in more.items():
        dp_launches[k] = dp_launches.get(k, 0) + n
    dp_secs += secs
    log(f"[dist] launches on the distributed path (world of 1): "
        f"{json.dumps(launches)}; phase 7 took "
        f"{time.perf_counter() - t0:.1f} s, [train-dp] {dp_secs:.1f} s of "
        f"it; [train-dp] launches {json.dumps(dp_launches)}")
    return launches, {"launches": dp_launches, "secs": dp_secs}


# ---------------------------------------------------------------------------
# phase 4: serving the two LM families
# ---------------------------------------------------------------------------

def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _ms_range(xs):
    return f"median of {len(xs)}; min {min(xs):.3f}, max {max(xs):.3f}"


def _engine_run(torch, eng, prompts):
    """The prompts through the engine, SERVE_MAX_NEW tokens each: (the
    requests, every tick's ms, the ticks' ms that decoded every slot with
    no admission, seconds)."""
    reqs = [eng.submit(p, SERVE_MAX_NEW) for p in prompts]
    ticks, full_ticks = [], []
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    while any(eng.active) or eng.queue:
        full = all(r is not None for r in eng.active)   # no slot to admit
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        ticks.append(ms)
        if full:               # a pure decode tick over every slot
            full_ticks.append(ms)
    return reqs, ticks, full_ticks, time.perf_counter() - t_run


def _ttft_probe(torch, eng, into):
    """Time the engine's prefills: each call with its first token read on
    the host, in ms, into `into` by prompt length.  Returns the engine's
    own prefill step."""
    step = eng._prefill

    def prefill(model, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = step(model, batch)
        int(torch.argmax(logits[0]))
        into.setdefault(batch["tokens"].shape[1], []).append(
            (time.perf_counter() - t) * 1e3)
        return logits, cache
    eng._prefill = prefill
    return step


def _wall_ms(torch, fn, reps=3, long_ms=1000):
    """`fn`'s wall ms a call, synchronized around each of `reps` calls (a
    call over `long_ms` is timed once)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        if times[0] > long_ms:
            break
    return times


def _serve_model(torch, np, arch, kernels, seed):
    """Serve one model through the engine (its graphed steps, the default);
    returns the launch counts of the engine run and of the prefill
    replays that follow it."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import get_model
    from repro_torch.serve import ServeEngine, make_decode_step
    cfg = serve_config(get_config, arch)
    full = get_config(arch).num_layers
    depth = "full depth" if cfg.num_layers == full else \
        f"{cfg.num_layers} of {full} layers (depth cut to fit one card)"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = get_model(cfg).init(seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"[serve] {arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab_size}, {n_params / 1e9:.3f} B parameters, "
        f"{w_bytes / 1e9:.2f} GB of weights ({str(cfg.param_dtype)}), init "
        f"on the card from seed {seed} in {time.perf_counter() - t0:.1f} s; "
        f"full width, {depth}")
    prompts = serve_prompts(np, cfg, seed)
    max_seq = serve_max_seq(arch)

    # the main path: six requests through the graphed engine (each prompt
    # length's first sight: its prefill by the plain step; the decode
    # captured at the first tick, replayed after), each request's time to
    # first token and each decode call's host time read as the engine runs
    eng = ServeEngine(cfg, model, slots=SERVE_SLOTS, max_seq=max_seq)
    run_ttft, dec_host = {}, []
    graphed_prefill = _ttft_probe(torch, eng, run_ttft)
    graphed_decode = eng._decode

    def host_timed_decode(*args):
        t = time.perf_counter()
        out = graphed_decode(*args)
        dec_host.append((time.perf_counter() - t) * 1e3)
        return out
    eng._decode = host_timed_decode
    ops.reset_launch_counts()
    reqs, ticks, full_ticks, run_s = _engine_run(torch, eng, prompts)
    run_counts = ops.launch_counts()
    eng._prefill, eng._decode = graphed_prefill, graphed_decode
    require(graphed_prefill.plain_calls == len(prompts)
            and not graphed_prefill.entries,
            f"{arch}: the engine run's {len(prompts)} prompt lengths, each "
            f"seen once, built {graphed_prefill.entries_built} prefill "
            "entries")
    # then each length's second sight (its prefill eagerly on a side
    # stream, then captured: held against the replays that follow, bit for
    # bit) and its replays through the engine's own step, launches counted
    ttft2, first = {}, {}
    for p in prompts:
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, _ = graphed_prefill(model, {"tokens": p[None]})
        int(torch.argmax(logits[0]))
        ttft2[len(p)] = (time.perf_counter() - t) * 1e3
        first[len(p)] = logits.clone()
    built = ops.launch_counts()
    pre_ms, ttft_ms = {}, {}
    for p in prompts:
        # a replay's ms, and with the first token read on the host its time
        # to first token (a prefill of a second or more is timed once)
        pre, ttft = pre_ms.setdefault(len(p), []), \
            ttft_ms.setdefault(len(p), [])
        while len(pre) < 3 and (not pre or pre[0] < 1000):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, _ = graphed_prefill(model, {"tokens": p[None]})
            torch.cuda.synchronize()
            pre.append((time.perf_counter() - t) * 1e3)
            int(torch.argmax(logits[0]))
            ttft.append((time.perf_counter() - t) * 1e3)
        require(bool(torch.isfinite(logits).all())
                and tuple(logits.shape) == (1, cfg.vocab_size),
                f"{arch}: prefill of {len(p)} tokens gave non-finite logits "
                f"or shape {tuple(logits.shape)}")
        require(torch.equal(logits, first[len(p)]),
                f"{arch}: the replayed prefill of {len(p)} tokens gave other "
                "logits than its eager warm-up")
    counts = ops.launch_counts()
    replayed = {k: n - built[k] for k, n in counts.items() if n != built[k]}
    log(f"[serve] {arch}: graphed engine run of {len(reqs)} requests in "
        f"{run_s:.3f} s ({len(ticks)} ticks, {SERVE_SLOTS} slots); kernel "
        f"launches {json.dumps(run_counts)}; then each prompt length's "
        f"prefill built and replayed {sum(len(v) for v in pre_ms.values())} "
        f"times, launches credited {json.dumps(replayed)}")
    for kernel in kernels:
        require(run_counts[kernel] > 0, f"{arch}: {kernel} was not launched "
                                        "on the serve path")
        require(replayed.get(kernel, 0) > 0,
                f"{arch}: {kernel} was not credited to a prefill replay")
    if "selective_scan_fused" in kernels:
        # one scan a layer and prefill, each through the fused entry
        require(counts["selective_scan"] == 0,
                f"{arch}: {counts['selective_scan']} scans through the (a, "
                "bx) entry, which materialises [B, S, D, N]")
    for r in reqs:
        require(r.done and len(r.out) == SERVE_MAX_NEW,
                f"{arch}: request {r.rid} done={r.done} with {len(r.out)} "
                f"tokens, expected {SERVE_MAX_NEW}")
        require(all(0 <= t < cfg.vocab_size for t in r.out),
                f"{arch}: request {r.rid} produced a token out of the "
                "vocabulary")
    require(full_ticks, f"{arch}: no decode tick ran with every slot busy")
    require(graphed_decode.entries_built == 1,
            f"{arch}: {graphed_decode.entries_built} decode entries built")
    # the served tokens' digest: tools/serve_tokens.py computes the same
    # one from another tree's sources
    n_toks, crc = served_digest(np, reqs)
    log(f"[serve] {arch}: served tokens {n_toks}, crc32 {crc} (graphed)")
    dec_ms = _median(full_ticks)
    d = graphed_decode.entry
    log(f"[serve] {arch}: decode {dec_ms:.3f} ms per tick graphed at "
        f"{SERVE_SLOTS} active slots ({_ms_range(full_ticks)}), "
        f"{SERVE_SLOTS / dec_ms * 1e3:.1f} decode tokens/s; the decode "
        f"call's host ms (staging, replay, credit) {_median(dec_host):.3f} "
        f"({_ms_range(dec_host)}); its entry: warm-up "
        f"{d.warm_s * 1e3:.1f} ms, capture {d.capture_s * 1e3:.1f} ms")
    log(f"[serve] {arch}: time to first token in the graphed engine's run "
        "(each length's first sight: the plain prefill step): " + ", ".join(
            f"{n} tokens {v[0]:.3f} ms" for n, v in run_ttft.items()))
    # (warm-up s, capture s) by prompt length: the engine's prefill keys
    # on the [1, length] tokens alone
    builds = {e.key[0][1][1]: (e.warm_s, e.capture_s)
              for e in graphed_prefill.entries.values()}
    for n in sorted(pre_ms, reverse=True):
        warm, cap = builds[n]
        log(f"[serve] {arch}: prefill {n} tokens replayed "
            f"{_median(pre_ms[n]):.3f} ms ({_ms_range(pre_ms[n])}), "
            f"{n / _median(pre_ms[n]) * 1e3:.0f} tokens/s; time to first "
            f"token replayed {_median(ttft_ms[n]):.3f} ms, at first sight "
            f"{run_ttft[n][0]:.3f} ms (plain step), at second sight "
            f"{ttft2[n]:.1f} ms (warm-up {warm * 1e3:.1f}, capture "
            f"{cap * 1e3:.1f})")
    # one decode over the engine's cache, through the engine's own decode
    # step (a moe config's capacity groups are its slots): finite logits
    # for every slot
    toks = np.asarray([[r.out[-1]] for r in reqs[:SERVE_SLOTS]], np.int64)
    pos = np.minimum(eng.pos, max_seq - 1)
    logits, _ = eng._decode(model, eng.cache, toks, pos)
    require(bool(torch.isfinite(logits).all())
            and tuple(logits.shape) == (SERVE_SLOTS, cfg.vocab_size),
            f"{arch}: decode gave non-finite logits or shape "
            f"{tuple(logits.shape)}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[serve] {arch}: peak device memory {peak:.2f} GB "
        "(max_memory_allocated over init, the graphed run with its graphs' "
        f"pools and the replays; {len(builds)} prefill entries kept, "
        f"capture {sum(c for _, c in builds.values()) + d.capture_s:.2f} s "
        "in all)")
    top = 10 if "segment_reduce" in kernels else 5
    _profile(torch, f"{arch} decode tick at {SERVE_SLOTS} slots replayed",
             lambda: eng._decode(model, eng.cache, toks, pos), dec_ms, top)
    longest = max(prompts, key=len)
    if arch in SERVE_TRACED:
        _profile(torch, f"{arch} prefill {len(longest)} tokens replayed",
                 lambda: eng._prefill(model, {"tokens": longest[None]}),
                 _median(pre_ms[len(longest)]), top)

    # eagerly: SERVE_TRACED through an eager engine over the same requests,
    # whose tokens must be the graphed ones (each request's time to first
    # token as the engine calls its prefill); the others the plain decode
    # step on the graphed engine's cache (their plain prefill is the
    # graphed engine run's first sights)
    if arch not in SERVE_TRACED:
        decode = make_decode_step(cfg, moe_groups=SERVE_SLOTS)
        times = _wall_ms(torch, lambda: decode(model, eng.cache, toks, pos),
                         reps=5)
        log(f"[serve] {arch}: decode {_median(times):.3f} ms per tick eager "
            f"(the plain step on the engine's cache, {_ms_range(times)})")
    else:
        # the graphs' pools go before the eager engine's peak is read
        del eng, logits, graphed_prefill, graphed_decode, d, first
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eng = ServeEngine(cfg, model, slots=SERVE_SLOTS, max_seq=max_seq,
                          graphed=False)
        eager_ttft = {}
        _ttft_probe(torch, eng, eager_ttft)
        reqs, ticks, full_ticks, run_s = _engine_run(torch, eng, prompts)
        log(f"[serve] {arch}: time to first token in the eager engine's run "
            "(the plain prefill step): " + ", ".join(
                f"{n} tokens {v[0]:.3f} ms" for n, v in eager_ttft.items()))
        n_eager, crc_eager = served_digest(np, reqs)
        eager_ms = _median(full_ticks)
        log(f"[serve] {arch}: eager engine run in {run_s:.3f} s; decode "
            f"{eager_ms:.3f} ms per tick eager ({_ms_range(full_ticks)}); "
            f"served tokens {n_eager}, crc32 {crc_eager}; peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        require((n_eager, crc_eager) == (n_toks, crc),
                f"{arch}: the graphed engine served other tokens (crc32 "
                f"{crc}) than the eager one ({crc_eager})")
    del model, eng
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[serve] {arch}: {time.perf_counter() - t0:.1f} s for this config")
    return counts


def audio_batch(torch, np, cfg, seed):
    """whisper-tiny's served batch: AUDIO_BATCH rows of AUDIO_PROMPT tokens
    and enc_seq stub frames from `seed`, on the card."""
    rng = np.random.default_rng(seed)
    return {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (AUDIO_BATCH, AUDIO_PROMPT)).astype(np.int32),
        device="cuda"),
        "frames": torch.as_tensor(rng.standard_normal(
            (AUDIO_BATCH, cfg.enc_seq, cfg.d_model)).astype(np.float32),
            device="cuda")}


def serve_audio(torch, model, batch, prefill, decode, ticks=None,
                ttft=None):
    """One prefill, then SERVE_MAX_NEW - 1 greedy decode steps, as the
    reference's launcher drives them: the [AUDIO_BATCH, SERVE_MAX_NEW]
    tokens on the host and the last logits (each decode step's ms into
    `ticks`, the ms to the first tokens on the host into `ttft`)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, cache = prefill(model, batch)
    tok = torch.argmax(logits, -1)[:, None]
    out = [tok.cpu()]
    if ttft is not None:
        ttft.append((time.perf_counter() - t) * 1e3)
    for i in range(SERVE_MAX_NEW - 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = decode(model, cache, tok, AUDIO_PROMPT + i)
        tok = torch.argmax(logits, -1)[:, None]
        out.append(tok.cpu())
        if ticks is not None:
            ticks.append((time.perf_counter() - t) * 1e3)
    return torch.cat(out, 1).numpy(), logits


def _serve_whisper(torch, np, seed):
    """whisper-tiny through the graphed serving steps at full size, as the
    reference's launcher drives its jitted ones: AUDIO_BATCH requests of
    enc_seq stub frames and AUDIO_PROMPT tokens from the seed, one prefill
    (the encoder with it) then SERVE_MAX_NEW - 1 greedy decode steps.
    Three runs see the batch's signature first (the plain prefill step),
    second (its graph built) and third (replayed), each decoding from a
    cache of its own (the plain step's, the warm-up's, the graph's), so
    each builds a decode entry; the fourth is counted and builds none;
    then the plain steps' run, whose tokens must be the same.  Returns the
    launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import get_model
    from repro_torch.serve import (graphed_decode, graphed_prefill,
                                   make_decode_step, make_prefill_step)
    arch = AUDIO_ARCH
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = get_model(cfg).init(seed)
    n_params = sum(p.numel() for p in model.parameters())
    batch = audio_batch(torch, np, cfg, seed)
    max_seq = AUDIO_PROMPT + SERVE_MAX_NEW
    prefill = graphed_prefill(make_prefill_step(cfg, max_seq))
    decode = graphed_decode(make_decode_step(cfg))
    log(f"[serve] {arch}: {cfg.enc_layers} encoder and "
        f"{cfg.num_layers} decoder layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}, {n_params / 1e6:.1f} M parameters "
        f"({str(cfg.param_dtype)}), full size; batch of {AUDIO_BATCH}: "
        f"{cfg.enc_seq} stub frames and {AUDIO_PROMPT} prompt tokens each "
        f"from seed {seed}, {SERVE_MAX_NEW} new tokens")
    sights = []
    torch.cuda.synchronize()
    t = time.perf_counter()
    first, _ = serve_audio(torch, model, batch, prefill, decode, ttft=sights)
    first_s = time.perf_counter() - t
    for _ in range(2):
        serve_audio(torch, model, batch, prefill, decode, ttft=sights)
    (pe,) = prefill.entries.values()
    built = decode.entries_built
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    ticks = []
    toks, logits = serve_audio(torch, model, batch, prefill, decode, ticks)
    run_s = time.perf_counter() - t
    counts = ops.launch_counts()
    require(counts["flash_attention"] > 0 and counts["flash_attention[wg]"] > 0,
            f"{arch}: flash_attention (its wgmma route: "
            f"{counts['flash_attention[wg]']}) was not launched on the serve "
            "path")
    require(decode.entries_built == built and prefill.entries_built == 1
            and prefill.plain_calls == 1,
            f"{arch}: the counted run built an entry")
    require(bool(torch.isfinite(logits).all()) and toks.shape ==
            (AUDIO_BATCH, SERVE_MAX_NEW) and ((toks >= 0)
                                              & (toks < cfg.vocab_size)).all(),
            f"{arch}: served tokens {toks.shape} out of the vocabulary or "
            "non-finite logits")
    require(np.array_equal(toks, first), f"{arch}: the replayed run served "
                                         "other tokens than the first")
    import zlib
    crc = zlib.crc32(toks.astype(np.int64).tobytes()) & 0xFFFFFFFF
    log(f"[serve] {arch}: {AUDIO_BATCH} requests in {run_s:.3f} s replayed "
        f"({first_s:.3f} s at first sight, its decode entry built); kernel "
        f"launches {json.dumps(counts)}; served tokens {toks.size}, crc32 {crc} "
        "(graphed)")
    dec_ms = _median(ticks)
    log(f"[serve] {arch}: decode {dec_ms:.3f} ms per tick graphed at "
        f"{AUDIO_BATCH} requests ({_ms_range(ticks)}), "
        f"{AUDIO_BATCH / dec_ms * 1e3:.1f} decode tokens/s; its capture "
        f"{decode.entry.capture_s * 1e3:.1f} ms")
    times = _wall_ms(torch, lambda: prefill(model, batch))
    ttft = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, _ = prefill(model, batch)
        torch.argmax(logits, -1).cpu()
        ttft.append((time.perf_counter() - t) * 1e3)
    log(f"[serve] {arch}: prefill (encoder of {cfg.enc_seq} frames and "
        f"{AUDIO_PROMPT} tokens, batch {AUDIO_BATCH}) replayed "
        f"{_median(times):.3f} ms ({_ms_range(times)}); time to first token "
        f"replayed {_median(ttft):.3f} ms (the third run's "
        f"{sights[2]:.3f}), at first sight {sights[0]:.3f} ms (plain step), "
        f"at second sight {sights[1]:.1f} ms (warm-up "
        f"{pe.warm_s * 1e3:.1f}, capture {pe.capture_s * 1e3:.1f}); peak "
        "device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB with the graphs' "
        "pools")
    tok = torch.as_tensor(toks[:, -1:], device="cuda")
    _profile(torch, f"{arch} decode tick at {AUDIO_BATCH} requests replayed",
             lambda: decode(model, decode.entry.cache, tok,
                            AUDIO_PROMPT + SERVE_MAX_NEW - 1), dec_ms)
    # the plain steps, eagerly: the same tokens
    eprefill, edecode = make_prefill_step(cfg, max_seq), \
        make_decode_step(cfg)
    ticks = []
    etoks, _ = serve_audio(torch, model, batch, eprefill, edecode, ticks)
    ecrc = zlib.crc32(etoks.astype(np.int64).tobytes()) & 0xFFFFFFFF
    times = _wall_ms(torch, lambda: eprefill(model, batch))
    log(f"[serve] {arch}: eager decode {_median(ticks):.3f} ms per tick "
        f"({_ms_range(ticks)}), prefill {_median(times):.3f} ms "
        f"({_ms_range(times)}); served tokens crc32 {ecrc}; "
        f"{time.perf_counter() - t0:.1f} s for this config")
    require(ecrc == crc, f"{arch}: the graphed steps served other tokens "
                         f"(crc32 {crc}) than the eager ones ({ecrc})")
    del model, logits, prefill, decode
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _router_probe(torch, k):
    """Wrap the MoE router and dispatch: the smallest gap met between the
    k-th and (k+1)-th router logit of a token, and the rows dropped by
    capacity, over the calls made until `restore()`, a graph's capture
    apart (it runs nothing, and reads nothing back)."""
    from repro_torch.models import moe
    from repro_torch.models.common import dense
    seen = {"gap": float("inf"), "dropped": 0}
    router, dispatch = moe._router, moe._dispatch

    def probed_router(cfg, p, xt):
        if not torch.cuda.is_current_stream_capturing():
            with torch.no_grad():
                top = torch.sort(dense(xt, p["router"]).float(), dim=-1,
                                 descending=True).values
            seen["gap"] = min(seen["gap"],
                              float((top[:, k - 1] - top[:, k]).min()))
        return router(cfg, p, xt)

    def probed_dispatch(*a, **kw):
        out = dispatch(*a, **kw)
        if not torch.cuda.is_current_stream_capturing():
            seen["dropped"] += int((~out[1]).sum())
        return out

    def restore():
        moe._router, moe._dispatch = router, dispatch
    moe._router, moe._dispatch = probed_router, probed_dispatch
    return seen, restore


def _model_check(torch, np, arch, seed):
    """A 2-layer float32 copy of the model at full width: the port on the
    card against the same weights (drawn from the seed on the card) on the
    CPU (the kernels' plain versions), one prompt through the prefill step
    then greedy tokens.  A
    vlm config's prompt carries three M-RoPE position streams from the
    seed (its decode ropes plainly, as the reference's engine); a moe
    config prints the rows its capacity dropped and the smallest gap
    between the k-th and (k+1)-th router logit on each device, so that a
    failure from a genuine near-tie can be told from a fault."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.serve import (graphed_decode, graphed_prefill,
                                   make_decode_step, make_prefill_step)
    full = get_config(arch)
    f32 = dict(param_dtype=torch.float32, compute_dtype=torch.float32,
               cache_dtype=torch.float32)
    audio = full.family == "audio"
    cfg = full.replace(**f32) if audio else \
        cut_layout(full, CHECK_LAYERS, **f32)
    n_prompt = CHECK_PROMPTS.get(arch, CHECK_PROMPT)
    t0 = time.perf_counter()
    # drawn on the card and copied: the CPU's draw of a 72B config's
    # 4.3e9 numbers would take most of the check's time
    gpu = get_model(cfg).init(seed)
    cpu = get_model(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.default_rng(seed + 1)
    prompt = rng.integers(0, cfg.vocab_size, n_prompt).astype(np.int32)
    batch = {"tokens": prompt[None]}
    note = ""
    if cfg.mrope_sections:
        batch["pos_ids"] = rng.integers(0, n_prompt, (1, n_prompt, 3)
                                        ).astype(np.int32)
        note = "; M-RoPE positions: three streams from the seed"
    if audio:
        batch["frames"] = rng.standard_normal(
            (1, cfg.enc_seq, cfg.d_model)).astype(np.float32)
        note = f"; {cfg.enc_seq} stub frames from the seed"
    if cfg.window:
        note = (f"; window {cfg.window}: the prompt crosses it and wraps "
                f"the {min(cfg.window, n_prompt + CHECK_NEW)}-row ring")
    max_seq = n_prompt + CHECK_NEW
    # each device through its own graphed steps: the card's prefill is
    # called three times (the plain step, the graph's build, a replay) and
    # its third call is checked
    cpu_steps, card_steps = [(graphed_prefill(make_prefill_step(cfg,
                                                               max_seq)),
                              graphed_decode(make_decode_step(cfg)))
                             for _ in range(2)]
    probes = []

    def run(model, dev, prefill, calls):
        inputs = {n: torch.as_tensor(v, device=dev) for n, v in batch.items()}
        for i in range(calls):
            if cfg.num_experts and i == 0:
                probes.append(_router_probe(torch, cfg.top_k))
            try:
                out = prefill(model, inputs)
            finally:
                if cfg.num_experts and i == 0:
                    probes[-1][1]()
        return out
    ref, cc = run(cpu, "cpu", cpu_steps[0], 1)
    got, gc_ = run(gpu, "cuda", card_steps[0], 3)
    if cfg.num_experts:
        (c, _), (g, _) = probes
        note = (f"; prefill rows dropped by capacity {c['dropped']} (CPU), "
                f"{g['dropped']} (card); smallest gap between the "
                f"router logits {cfg.top_k} and {cfg.top_k + 1} of a token "
                f"{c['gap']:.3g} (CPU), {g['gap']:.3g} (card)")
        log(f"[serve] {arch} check{note}")
        require(c["dropped"] == g["dropped"],
                f"{arch} check: {g['dropped']} rows dropped on the card, "
                f"{c['dropped']} on the CPU")
    errs, toks = [], []
    for step in range(CHECK_NEW + 1):
        r, o = ref.double(), got.double().cpu()
        require(bool(torch.isfinite(o).all()), f"{arch} check: non-finite "
                                               "logits on the card")
        e = float((o - r).abs().max()) / float(r.abs().max())
        errs.append(e)
        t_ref, t_got = int(torch.argmax(ref[0])), int(torch.argmax(got[0]))
        require(e <= 1e-3, f"{arch} check step {step}: rel err {e} > 1e-3")
        require(t_ref == t_got, f"{arch} check step {step}: token {t_got} on "
                                f"the card, {t_ref} on the CPU")
        toks.append(t_ref)
        if step == CHECK_NEW:
            break
        pos = n_prompt + step
        ref, cc = cpu_steps[1](cpu, cc, [[t_ref]], pos)
        got, gc_ = card_steps[1](gpu, gc_, [[t_got]], pos)
    depth = "the whole model" if audio else (
        f"{cfg.num_layers} of {full.num_layers} layers (depth cut for this "
        "check only)")
    log(f"[serve] {arch} check: {depth}, full width, float32; prompt "
        f"{n_prompt} then {CHECK_NEW} greedy tokens, card vs CPU: max "
        f"rel err {max(errs):.3g} (tol 1e-3; prefill {errs[0]:.3g}), tokens "
        f"identical {toks}{note}; {time.perf_counter() - t0:.1f} s")
    del cpu, gpu, cc, gc_, cpu_steps, card_steps, ref, got
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve(torch, seed):
    import numpy as np
    from repro_torch.kernels import ops
    launches = {}
    t0 = time.perf_counter()
    for arch, kernels in SERVE_ARCHS.items():
        counts = _serve_model(torch, np, arch, kernels, seed)
        for k in kernels:
            launches[k] = launches.get(k, 0) + counts[k]
    counts = _serve_whisper(torch, np, seed)
    for k in ("flash_attention", "flash_attention[wg]"):
        launches[k] = launches.get(k, 0) + counts[k]
    t_checks = time.perf_counter()
    for arch in CHECK_ARCHS:
        _model_check(torch, np, arch, seed)
    log(f"[serve] phase 4 took {time.perf_counter() - t0:.1f} s (serving "
        f"{t_checks - t0:.1f} s, checks {time.perf_counter() - t_checks:.1f}"
        " s)")
    log(f"[serve] kernel launches on the serve path: {json.dumps(launches)}")
    ops.reset_launch_counts()
    return launches


# ---------------------------------------------------------------------------
# phase 8: training every family
# ---------------------------------------------------------------------------

# arch -> (layers kept, batch, tokens a row): full width, depth cut (in
# whole layout periods) so that bf16 parameters and gradients and float32
# AdamW moments fit one 80 GB card (PERF.md §4), None for the whole
# model; the configs' own remat ("full"), ce_chunk (512) and microbatch.
# recurrentgemma-2b's rows are 4096 tokens, so that its 2048-token window
# masks; whisper-tiny's batch carries 1500 stub frames a row.  One model
# on the card at a time
TRAIN_ARCHS = {"llama3-8b": (8, 4, 2048),
               "falcon-mamba-7b": (16, 4, 2048),
               "qwen3-moe-30b-a3b": (4, 4, 2048),
               "recurrentgemma-2b": (None, 2, 4096),
               "whisper-tiny": (None, 8, 448)}
TRAIN_STEPS, TRAIN_LR = 6, 3e-4
LEARN_STEPS = 10
# the eager steps each graphed run is held against, bit for bit
EAGER_STEPS = 3
# the resume check, on the model whose snapshot is small: six steps against
# a run failed at step 5 and resumed from its step-4 snapshot (the other
# families' resume is held on the CPU, tests/test_torch_train.py)
RESUME_ARCHS = ("whisper-tiny",)
RESUME_STEPS, RESUME_FAIL, RESUME_EVERY = 6, 5, 4
# the card-against-CPU checks, float32: arch -> (layers kept or None for
# the whole model, batch, tokens a row).  qwen3-moe-30b-a3b's capacity
# drops rows; recurrentgemma-2b's one (rec, rec, lattn) period runs past
# its window; falcon-mamba-7b's one layer crosses the CPU path's 256-step
# scan chunks (it had two before [train-dp] took its seconds).
# llama3-8b's (about 42 s, the costliest but one) left for the time
# limit: its attention and norms are qwen3-moe-30b-a3b's, whose check
# stays, and its float32 prefill is checked in phase 4
TRAIN_CHECKS = {"falcon-mamba-7b": (1, 1, 1024),
                "qwen3-moe-30b-a3b": (1, 1, 1024),
                "recurrentgemma-2b": (3, 1, 2300),
                "whisper-tiny": (None, 1, 448)}


def train_config(get_config, arch, layers):
    """`arch`'s config cut to `layers` in whole periods (None: whole)."""
    cfg = get_config(arch)
    return cfg if layers is None else cut_layout(cfg, layers)


def train_launches(cfg, seq) -> dict:
    """The launches one training step of rows of `seq` tokens makes of each
    counted kernel: under remat "full" (Whisper: every layer, as the
    reference) a forward kernel runs twice a layer and microbatch (the
    forward, the recompute), a backward once; the MoE combine's backward
    is a gather (no launch).  The flash forward's wgmma route counts the
    launches it takes (bf16 at hd 64 and 256: Whisper's every attention,
    its encoder's enc_seq and its decoder's `seq` rows both past the
    route's 64), the backward's (bf16 at hd 64, 128 and 256) every
    backward launch of a bf16 model, and of those its split route (bf16
    at hd 64, not causal) Whisper's encoder self-attention and decoder
    cross-attention.  The AdamW kernel launches twice a step (norm and
    update) for each table of up to MAX_LEAVES leaves."""
    from repro_torch.kernels.adamw import MAX_LEAVES
    from repro_torch.kernels.flash_attention import (WG_BWD_ROUTES,
                                                     _bwd_route, _route)
    from repro_torch.models import get_model
    if cfg.remat != "full":
        raise ValueError(f"{cfg.name}: remat {cfg.remat!r}, not 'full'")
    mb = max(1, cfg.microbatch)
    kinds = [k for pattern, reps in cfg.layout for _ in range(reps)
             for k in pattern]
    attn = cfg.enc_layers + 2 * len(kinds) if cfg.family == "audio" else \
        sum(k in ("dense", "moe", "lattn") for k in kinds)
    full = cfg.enc_layers + len(kinds) if cfg.family == "audio" else 0
    wg = min(seq, cfg.enc_seq) if cfg.family == "audio" else seq
    per_layer = {"flash_attention": (attn, 2),
                 "flash_attention[wg]": (
                     attn if _route(cfg.compute_dtype, cfg.head_dim, wg)
                     == "wgmma" else 0, 2),
                 "flash_attention_bwd": (attn, 1),
                 "flash_attention_bwd[wg]": (
                     attn if _bwd_route(cfg.compute_dtype, cfg.head_dim)
                     in WG_BWD_ROUTES else 0, 1),
                 "flash_attention_bwd[full, hd 64]": (
                     full if _bwd_route(cfg.compute_dtype, cfg.head_dim,
                                        causal=False) == "wgmma-split"
                     else 0, 1),
                 "segment_reduce": (kinds.count("moe"), 2),
                 "selective_scan_fused": (kinds.count("ssm"), 2),
                 "selective_scan_bwd": (kinds.count("ssm"), 1),
                 "selective_scan": (kinds.count("rec"), 2),
                 "selective_scan_bwd[a, bx]": (kinds.count("rec"), 1)}
    out = {k: n * times * mb for k, (n, times) in per_layer.items() if n}
    leaves = len(list(get_model(cfg, device="meta").named_leaves()))
    out["adamw"] = 2 * -(-leaves // MAX_LEAVES)
    return out


def _train_data(cfg, batch, seq, seed, rank=0, world=1):
    """The reference launcher's data: frames for the audio family, M-RoPE
    positions for the vlm family; rank `rank`'s rows of `world` (its part
    of each of the config's microbatches)."""
    from repro_torch.data import SyntheticLMData
    return SyntheticLMData(cfg.vocab_size, batch, seq, seed=seed,
                           host_index=rank, host_count=world,
                           microbatch=cfg.microbatch if world > 1 else 1,
                           with_frames=cfg.enc_seq
                           if cfg.family == "audio" else 0,
                           d_model=cfg.d_model,
                           with_pos_ids=cfg.family == "vlm")


def _runner(torch, cfg, seed, ckpt_dir, ckpt_every, batch, seq,
            model=None, opt=None):
    """A TrainRunner of `cfg` from the seed's weights (or `model` and
    `opt`) through the graphed step, as the launcher runs it."""
    from repro_torch.models import get_model
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import TrainRunner
    from repro_torch.train import graphed_step, make_train_step
    if model is None:
        model = get_model(cfg).init(seed)
        opt = adamw_init(dict(model.named_leaves()),
                         torch.bfloat16 if cfg.opt_dtype == "bf16"
                         else torch.float32)
    step = graphed_step(make_train_step(cfg, lr=TRAIN_LR,
                                        compress_grads=False))
    return TrainRunner(step, model, opt, _train_data(cfg, batch, seq, seed),
                       ckpt_dir=str(ckpt_dir), ckpt_every=ckpt_every)


def _reset(torch, model, opt, seed):
    """The seed's weights again, in place, zero moments and step."""
    with torch.no_grad():
        model.init(seed)
        opt.step.zero_()
        for v in [*opt.mu.values(), *opt.nu.values()]:
            v.zero_()


def _eager_digests(torch, cfg, model, opt, seed, batch, seq, steps):
    """`steps` eager steps (no graph) from the seed's weights on the
    runner's batches: the step ms (the step alone, its batch made before)
    and the 64-bit fingerprint of every parameter and moment after them;
    the state is reset after."""
    from repro_torch.train import make_train_step
    step = make_train_step(cfg, lr=TRAIN_LR, compress_grads=False)
    data = _train_data(cfg, batch, seq, seed)
    ms = []
    for _ in range(steps):
        batch = data.next_batch()
        torch.cuda.synchronize()
        t = time.perf_counter()
        model, opt, _ = step(model, opt, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    digests = [_bits_digest(torch, t) for t in _dp_state(model, opt)]
    _reset(torch, model, opt, seed)
    del step
    gc.collect()
    torch.cuda.empty_cache()
    return ms, digests


def _train_model(torch, np, arch, seed, tmp):
    """Train one model: EAGER_STEPS eager steps from the seed (no graph:
    their ms, peak and fingerprints), then from the seed's weights again
    TRAIN_STEPS steps through TrainRunner and the graphed step (the first
    the eager warm-up and the capture, the others replays) with the launch
    counts read around them (each kernel's as `train_launches` says, every
    other counted kernel none), the state after step EAGER_STEPS bit-equal
    to the eager run's, one profiled step, then LEARN_STEPS steps on one
    fixed batch.  Returns the launch counts of the run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import get_model
    from repro_torch.optim import adamw_init
    layers, batch, seq = TRAIN_ARCHS[arch]
    full = get_config(arch)
    cfg = train_config(get_config, arch, layers)
    t0 = time.perf_counter()
    model = get_model(cfg).init(seed)
    opt = adamw_init(dict(model.named_leaves()),
                     torch.bfloat16 if cfg.opt_dtype == "bf16"
                     else torch.float32)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    depth = "the whole model" if layers is None else \
        f"{cfg.num_layers} of {full.num_layers} layers"
    frames = f", {cfg.enc_seq} stub frames a row" \
        if cfg.family == "audio" else ""
    log(f"[train] {arch}: {depth}, full width (d_model {cfg.d_model}, "
        f"vocab {cfg.vocab_size}), {n_params / 1e9:.3f} B parameters "
        f"({str(cfg.param_dtype)}, moments {cfg.opt_dtype}), remat "
        f"{cfg.remat}, ce_chunk {cfg.ce_chunk}, microbatch "
        f"{cfg.microbatch}, batch {batch} x {seq}{frames}; init from seed "
        f"{seed} in {time.perf_counter() - t0:.1f} s")
    held = torch.cuda.memory_allocated() / 1e9   # the model, its moments
    torch.cuda.reset_peak_memory_stats()
    eager_ms, want = _eager_digests(torch, cfg, model, opt, seed, batch, seq,
                                    EAGER_STEPS)
    eager_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    r = _runner(torch, cfg, seed, tmp / arch, 10 ** 6, batch, seq, model,
                opt)
    del model, opt
    # the main path: TRAIN_STEPS graphed steps through the runner,
    # launches counted
    ops.reset_launch_counts()
    ms, losses, gnorms = [], [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = r.run(i + 1)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        if i + 1 == EAGER_STEPS:
            got = [_bits_digest(torch, t) for t in _dp_state(r.params,
                                                             r.opt_state)]
    counts = ops.launch_counts()
    require(all(math.isfinite(x) for x in losses + gnorms),
            f"{arch}: non-finite loss or grad_norm {losses} {gnorms}")
    same = sum(a == b for a, b in zip(got, want))
    require(same == len(want), f"{arch}: after {EAGER_STEPS} steps the "
            f"graphed step's parameters and moments differ from the eager "
            f"step's in {len(want) - same} of {len(want)} leaves")
    entry = r.step_fn.entry
    step_ms = _median(ms[1:])
    log(f"[train] {arch}: loss by step {[round(x, 4) for x in losses]}, "
        f"grad_norm {[round(x, 4) for x in gnorms]}")
    log(f"[train] {arch}: graphed step {step_ms:.1f} ms (median of steps "
        f"2-{TRAIN_STEPS}, replays; first {ms[0]:.1f}: the eager warm-up "
        f"{entry.warm_s:.2f} s and the capture {entry.capture_s:.2f} s; "
        f"min {min(ms[1:]):.1f}, max {max(ms[1:]):.1f}), "
        f"{batch * seq / step_ms * 1e3:.0f} tokens/s (the runner's step: "
        f"its batch made on the host in it); eager step alone "
        f"{_median(eager_ms[1:]):.1f} ms (steps 2-{EAGER_STEPS} "
        f"{[round(x, 1) for x in eager_ms[1:]]}; first {eager_ms[0]:.1f}); "
        f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
        f"GB graphed, {eager_peak:.2f} GB eager ({held:.2f} GB held before "
        f"the first step: the model, its moments and anything an earlier "
        f"phase left); after {EAGER_STEPS} steps "
        f"every parameter and moment bit-equal to the eager step's "
        f"({same} of {len(want)} leaves, 64-bit fingerprints on the card)")
    per_step = train_launches(cfg, seq)
    want = {k: per_step.get(k, 0) * TRAIN_STEPS for k in counts}
    log(f"[train] {arch}: kernel launches {json.dumps(counts)}; a step "
        f"{json.dumps(per_step)}")
    require(counts == want, f"{arch}: launches {json.dumps(counts)} in "
                            f"{TRAIN_STEPS} steps, expected "
                            f"{json.dumps(want)}")
    # one more step, profiled: device busy, idle share, the hand kernels'
    # share of the device time
    per, spans = _profile(torch, f"train {arch} step", lambda: (
        r.run(r.step + 1), torch.cuda.synchronize()), step_ms, top=8)
    from repro_torch.kernels import _build
    hand = re.compile(r"::(?:%s)[<(]" % "|".join(
        f for fns in _kernel_functions(_build.SOURCES).values() for f in fns))
    hand_ms = sum(t for e, (t, _) in per.items() if hand.search(e))
    dev_ms = sum(t for t, _ in per.values())
    if dev_ms:
        log(f"[profile] train {arch} step: hand-written kernels "
            f"{hand_ms:.3f} ms of {dev_ms:.3f} ms of device time "
            f"({hand_ms / dev_ms:.3f})")
    # learning: LEARN_STEPS steps on one fixed batch
    fixed = r.data.next_batch()
    learn, learn_ms = [], []
    for _ in range(LEARN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r.params, r.opt_state, m = r.step_fn(r.params, r.opt_state, fixed)
        learn.append(float(m["loss"]))
        learn_ms.append((time.perf_counter() - t) * 1e3)
    require(learn[-1] < learn[0], f"{arch}: the loss on one fixed batch did "
                                  f"not fall: {learn}")
    log(f"[train] {arch}: {LEARN_STEPS} steps on one fixed batch: loss "
        f"{learn[0]:.4f} -> {learn[-1]:.4f} (every step "
        f"{[round(x, 3) for x in learn]}); the graphed step alone (its "
        f"batch made before it, staged and replayed) {_median(learn_ms):.1f}"
        f" ms a step (median; min {min(learn_ms):.1f}, max "
        f"{max(learn_ms):.1f})")
    del r, m, fixed
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _state_bits(r):
    """Every parameter and moment of a runner, on the card."""
    return [t.detach().clone() for _, t in r.params.named_leaves()] \
        + [r.opt_state.mu[k].clone() for k in r.opt_state.mu] \
        + [r.opt_state.nu[k].clone() for k in r.opt_state.nu]


def _train_resume(torch, arch, seed, tmp):
    """RESUME_STEPS uninterrupted steps against a run failed at
    RESUME_FAIL and resumed from its step-RESUME_EVERY snapshot, at phase
    8's config and batch: bit-equal, leaf by leaf."""
    from repro_torch.configs import get_config
    from repro_torch.runtime.ft import SimulatedFailure
    layers, batch, seq = TRAIN_ARCHS[arch]
    cfg = train_config(get_config, arch, layers)
    t0 = time.perf_counter()
    a = _runner(torch, cfg, seed, tmp / f"{arch}-a", 10 ** 6, batch, seq)
    a.run(RESUME_STEPS)
    want = _state_bits(a)
    del a
    gc.collect()
    torch.cuda.empty_cache()
    b = _runner(torch, cfg, seed, tmp / f"{arch}-b", RESUME_EVERY, batch,
                seq)
    t_save = time.perf_counter()
    try:
        b.run(RESUME_STEPS, fail_at_step=RESUME_FAIL)
        require(False, f"{arch}: the injected failure did not fire")
    except SimulatedFailure:
        pass
    b.mgr.wait()
    t_save = time.perf_counter() - t_save
    del b
    gc.collect()
    torch.cuda.empty_cache()
    c = _runner(torch, cfg, seed + 1, tmp / f"{arch}-b", 10 ** 6, batch, seq)
    t = time.perf_counter()
    require(c.maybe_resume() and c.step == RESUME_EVERY
            and c.data.step == RESUME_EVERY
            and int(c.opt_state.step) == RESUME_EVERY,
            f"{arch}: resumed at step {c.step}, data {c.data.step}")
    t_restore = time.perf_counter() - t
    c.run(RESUME_STEPS)
    got = _state_bits(c)
    same = sum(bool(torch.equal(x, y)) for x, y in zip(got, want))
    require(same == len(want), f"{arch}: the resumed run differs from the "
                                f"uninterrupted one in {len(want) - same} of "
                                f"{len(want)} leaves")
    nbytes = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in
                 os.walk(tmp / f"{arch}-b") for f in fs)
    log(f"[train] {arch} resume: phase 8's config, {str(cfg.param_dtype)}: "
        f"{RESUME_STEPS} steps uninterrupted against a run failed at step "
        f"{RESUME_FAIL} and resumed from its step-{RESUME_EVERY} snapshot: "
        f"bit-equal in {same} of {len(want)} leaves (parameters and "
        f"moments); snapshots {nbytes / 1e9:.3f} GB on disk; the failed run "
        f"{t_save:.1f} s with its saves, resume {t_restore:.1f} s (each "
        "array read once, its crc32 checked as it is loaded); "
        f"{time.perf_counter() - t0:.1f} s")
    del c, got, want
    gc.collect()
    torch.cuda.empty_cache()


def _train_check(torch, np, arch, seed):
    """A float32 copy at TRAIN_CHECKS' depth and full width: one training
    step's loss and gradients on the card against the same weights
    (drawn on the card from the seed) and batch on the CPU (the kernels'
    plain versions): loss and grad_norm (the global norm AdamW clips by)
    within 1e-4 relative, every gradient leaf within 1e-3 of its leaf's
    max |ref|.  A moe config also prints the rows its capacity dropped on
    each device, which must agree and not be none."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.optim.adamw import global_norm
    layers, batch, seq = TRAIN_CHECKS[arch]
    full = get_config(arch)
    f32 = dict(param_dtype=torch.float32, compute_dtype=torch.float32,
               cache_dtype=torch.float32)
    cfg = full.replace(**f32) if layers is None else \
        cut_layout(full, layers, **f32)
    t0 = time.perf_counter()
    # the weights are drawn on the card and copied: a float32 draw on the
    # host of a full-width vocabulary takes seconds a leaf
    gpu = get_model(cfg).init(seed)
    cpu = get_model(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    data = _train_data(cfg, batch, seq, seed + 2).next_batch()
    out, probes, secs = {}, [], {}
    for name, model in (("cpu", cpu), ("card", gpu)):
        t = time.perf_counter()
        if cfg.num_experts:
            probes.append(_router_probe(torch, cfg.top_k))
        try:
            model.train_mode()
            params = dict(model.named_leaves())
            loss, _ = model.loss(data)
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
        finally:
            if cfg.num_experts:
                probes[-1][1]()
        out[name] = (float(loss.detach()), float(global_norm(grads)), grads)
        secs[name] = time.perf_counter() - t
    (l_ref, gn_ref, g_ref), (l_got, gn_got, g_got) = out["cpu"], out["card"]
    note = ""
    if cfg.num_experts:
        (c, _), (g, _) = probes
        note = (f"; rows dropped by capacity {c['dropped']} (CPU), "
                f"{g['dropped']} (card) of {batch * seq * cfg.top_k}")
        require(c["dropped"] == g["dropped"] and g["dropped"] > 0,
                f"{arch} train check: {g['dropped']} rows dropped on the "
                f"card, {c['dropped']} on the CPU")
    e_loss = abs(l_got - l_ref) / abs(l_ref)
    e_gn = abs(gn_got - gn_ref) / abs(gn_ref)
    require(e_loss <= 1e-4 and e_gn <= 1e-4,
            f"{arch} train check: loss {l_got} vs {l_ref} ({e_loss:.3g}), "
            f"grad_norm {gn_got} vs {gn_ref} ({e_gn:.3g}), tol 1e-4")
    # compared on the card, leaf by leaf: float64 copies of a full-width
    # vocabulary's leaves on the host took seconds each
    worst, where = 0.0, ""
    for k, ref in g_ref.items():
        ref = ref.to(g_got[k].device)
        e = float((g_got[k] - ref).abs().max()) \
            / max(float(ref.abs().max()), 1e-30)
        if e > worst:
            worst, where = e, k
        del ref
    require(worst <= 1e-3, f"{arch} train check: gradient {where} err "
                           f"{worst:.3g} of its max |ref| > 1e-3")
    depth = "the whole model" if layers is None else (
        f"{cfg.num_layers} of {full.num_layers} layers (depth cut for this "
        "check only)")
    log(f"[train] {arch} check: {depth}, full width, float32, batch "
        f"{batch} x {seq}, ce_chunk {cfg.ce_chunk}: one step's gradients on "
        f"the card against the CPU: loss {l_got!r} (CPU {l_ref!r}, rel err "
        f"{e_loss:.3g}), grad_norm {gn_got!r} (CPU {gn_ref!r}, rel err "
        f"{e_gn:.3g}), worst gradient leaf {where} {worst:.3g} of its max "
        f"|ref| (tol 1e-3){note}; CPU {secs['cpu']:.1f} s, card "
        f"{secs['card']:.1f} s, {time.perf_counter() - t0:.1f} s in all")
    del cpu, gpu, out, g_ref, g_got
    gc.collect()
    torch.cuda.empty_cache()


def phase_train(torch, seed):
    """Train every family; returns the launch counts of the main runs
    (TRAIN_STEPS steps of each model) by kernel, the windowed hd-256
    backward's (recurrentgemma-2b's lattn layers) apart from the other
    flash backwards."""
    import tempfile
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    launches, secs = {}, {}
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp = Path(tmp)
        for arch in TRAIN_ARCHS:
            t = time.perf_counter()
            counts = _train_model(torch, np, arch, seed, tmp)
            if get_config(arch).window:
                counts["flash_attention_bwd[window, hd 256]"] = \
                    counts.pop("flash_attention_bwd")
            for k, n in counts.items():
                launches[k] = launches.get(k, 0) + n
            secs[arch] = time.perf_counter() - t
        t = time.perf_counter()
        for arch in RESUME_ARCHS:
            _train_resume(torch, arch, seed, tmp)
        secs["resume"] = time.perf_counter() - t
    t = time.perf_counter()
    for arch in TRAIN_CHECKS:
        _train_check(torch, np, arch, seed)
    secs["checks"] = time.perf_counter() - t
    log(f"[train] kernel launches on the training path: "
        f"{json.dumps(launches)}; phase 8 took "
        f"{time.perf_counter() - t0:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()) + ")")
    ops.reset_launch_counts()
    return launches


# ---------------------------------------------------------------------------
# last: the lanes entry's replay under torch.profiler
# ---------------------------------------------------------------------------

def phase_lanes_trace(torch, seed):
    """Phase 2's main lanes case (mix (b)'s group_by flush) captured again,
    the lanes entry's graph and the 16 device-count launches' each replayed
    under torch.profiler, interleaved: the device time of each (`[lanes]`
    line).  It runs after every other phase, so that its traces of graph
    replays touch no other phase's."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    lens = [MIX_B_ROWS[i % 2] for i in range(SERVE_MAX_BATCH)]
    *_, fns = _lanes_flush(torch, g, lens, MIX_B_ROWS[0], MIX_B_GROUPS)
    graphs, _ = _flush_graphs(torch, fns)
    out = {}
    for which in ("rows", "lanes", "lanes", "rows"):
        run_ms = time_ms(torch, graphs[which].replay)
        _, spans = _profile(torch, f"segment_reduce mix (b) group_by flush "
                            f"of {len(lens)} lanes, the {which} graph's "
                            "replay", graphs[which].replay, run_ms)
        out.setdefault(which, []).append(
            (_union_ms((lo, hi) for lo, hi, _ in spans), len(spans)))
    # the graphs launch 6 kernels a lane (count, three scans, scatter,
    # reduce) and 6 in all: a trace with fewer events dropped some
    log(f"[lanes] one mix (b) group_by flush replayed: (device ms, kernel "
        f"events) {json.dumps(out)} (the 16 device-count launches' graph, "
        "rows, of 96 kernels, against the lanes entry's, of 6)")
    del graphs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", type=Path, help="a directory of earlier "
                    "kernel sources to time the current ones against")
    args = ap.parse_args(argv)
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              f"(no src/repro_torch beside {Path(__file__).name})",
              file=sys.stderr)
        return 2
    if args.parent is not None and not args.parent.is_dir():
        print(f"chip_smoke.py: --parent {args.parent} is not a directory",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t0 = time.perf_counter()
    secs = {}      # each phase's seconds, for the time limit's account

    def timed(name, phase, *a):
        t = time.perf_counter()
        out = phase(torch, *a)
        secs[name] = round(time.perf_counter() - t, 1)
        gc.collect()
        torch.cuda.empty_cache()
        return out
    try:
        timed("build", phase_build, args.parent)
        per_kernel = timed("kernels", phase_kernels, args.seed)
        launches = timed("main", phase_main, args.seed)
        launches["segment_reduce"] += timed("ooc", phase_ooc, args.seed)
        plans = timed("plans", phase_plans, args.seed)
        launches["segment_reduce"] += plans["segment_reduce"]
        # the lanes entry's launches: phase 6's served flushes
        launches["segment_reduce[lanes]"] = plans["segment_reduce[lanes]"]
        dist, dp = timed("dist", phase_dist, args.seed)
        for k, n in dist.items():
            launches[k] += n
        secs["dist"] = round(secs["dist"] - dp["secs"], 1)
        secs["train-dp"] = round(dp["secs"], 1)
        # phases 4 and 8 (and phase 7's [train-dp] part) launch the segment
        # kernel only as the MoE combine, on its wide route: the kernel
        # line's own item
        served = timed("serve", phase_serve, args.seed)
        for k, n in [*served.items(), *dp["launches"].items(),
                     *timed("train", phase_train, args.seed).items()]:
            k = "segment_reduce[wide]" if k == "segment_reduce" else k
            launches[k] = launches.get(k, 0) + n
        timed("lanes", phase_lanes_trace, args.seed)
    except SmokeFailure as ex:
        print(f"chip_smoke.py: FAILED: {ex}", file=sys.stderr)
        return 1
    # the scan kernel's two entries, each with its own item: the fused one
    # (falcon-mamba-7b) and the (a, bx) one (recurrentgemma-2b's RG-LRU)
    launches["selective_scan[a, bx]"] = launches.pop("selective_scan", 0)
    launches["selective_scan"] = launches.pop("selective_scan_fused", 0)
    sources = {"segment_reduce": ("src/repro_torch/kernels/csrc/"
                                  "segment_reduce.cu",
                                  "src/repro/kernels/segment_reduce.py:109"),
               "segment_reduce[wide]": ("src/repro_torch/kernels/csrc/"
                                        "segment_reduce.cu",
                                        "src/repro/kernels/segment_reduce.py"
                                        ":109"),
               # the same TPU kernel under the reference's vmap over a
               # served batch: the lanes entry
               "segment_reduce[lanes]": ("src/repro_torch/kernels/csrc/"
                                         "segment_reduce.cu",
                                         "src/repro/kernels/segment_reduce"
                                         ".py:109"),
               "tile_matmul": ("src/repro_torch/kernels/csrc/tile_matmul.cu",
                               "src/repro/kernels/tile_matmul.py:69"),
               "flash_attention": ("src/repro_torch/kernels/csrc/"
                                   "flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:70"),
               # the same TPU kernel's wgmma route (bf16, hd 64 and 256)
               "flash_attention[wg]": ("src/repro_torch/kernels/csrc/"
                                       "flash_attention.cu",
                                       "src/repro/kernels/flash_attention.py"
                                       ":70"),
               "selective_scan": ("src/repro_torch/kernels/csrc/"
                                  "selective_scan.cu",
                                  "src/repro/kernels/selective_scan.py:60"),
               "selective_scan[a, bx]": ("src/repro_torch/kernels/csrc/"
                                         "selective_scan.cu",
                                         "src/repro/kernels/selective_scan"
                                         ".py:60"),
               # the backwards of those two TPU kernels' functions (the TPU
               # kernels have none: the reference differentiates the jnp
               # forms)
               "flash_attention_bwd": ("src/repro_torch/kernels/csrc/"
                                       "flash_attention_bwd.cu",
                                       "src/repro/kernels/flash_attention.py"
                                       ":70"),
               "selective_scan_bwd": ("src/repro_torch/kernels/csrc/"
                                      "selective_scan_bwd.cu",
                                      "src/repro/kernels/selective_scan.py"
                                      ":60"),
               # the same backwards' hybrid paths: the flash backward
               # within a window at hd 256 (recurrentgemma-2b's lattn), the
               # (a, bx) entry's reverse walk at N = 1 (its RG-LRU)
               "flash_attention_bwd[window, hd 256]": (
                   "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                   "src/repro/kernels/flash_attention.py:70"),
               # and its split route at hd 64 not causal (whisper-tiny's
               # encoder and cross-attention), within flash_attention_bwd's
               # launches
               "flash_attention_bwd[full, hd 64]": (
                   "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                   "src/repro/kernels/flash_attention.py:70"),
               "selective_scan_bwd[a, bx]": (
                   "src/repro_torch/kernels/csrc/selective_scan_bwd.cu",
                   "src/repro/kernels/selective_scan.py:60"),
               # no TPU kernel: the reference's AdamW update, which XLA
               # fuses into the step it jits (src/repro/launch/train.py:61)
               "adamw": ("src/repro_torch/kernels/csrc/adamw.cu",
                         "src/repro/optim/adamw.py:44")}
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
    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        print(f"chip_smoke.py: FAILED: no launch on the main paths of "
              f"{idle}", file=sys.stderr)
        return 1
    log(f"[done] {time.perf_counter() - t0:.1f} s; by phase "
        f"{json.dumps(secs)}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
