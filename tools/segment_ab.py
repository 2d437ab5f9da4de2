#!/usr/bin/env python3
"""Time the segment kernel's sources against an earlier version of them,
at chip_smoke.py's phase-2 shapes, on the card.

    python3 tools/segment_ab.py PARENT_CSRC [--seed N]

Run from the root of a checkout on a machine with a CUDA card.
PARENT_CSRC is an earlier src/repro_torch/kernels/csrc (e.g. `git archive
HEAD src/repro_torch/kernels/csrc` unpacked into the git-ignored
`.checkout/`).  It builds both libraries (chip_smoke's `phase_build`) and
runs chip_smoke's own segment cases: the host-count launches at the
program path's shapes (group_by's 2^26 rows into 2^20 groups, word_count's
broadcast count into 2^17, pagerank's LiveJournal shape, rows of 8
values, int32 values, a 25% hot key), each timed parent, change, change,
parent through the same wrapper, and the lanes entry at two served
flushes (mix (b)'s group_by and kmeans_step) against 16 device-count
launches of the parent's library, eagerly and replayed from a graph.
Every case holds the kernel against its plain version and its bits as
phase 2 does.  Prints chip_smoke's `[kernels]` records.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path, help="an earlier kernels/csrc")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("segment_ab.py: no CUDA device", file=sys.stderr)
        return 2
    cs.phase_build(torch, args.parent)
    g = torch.Generator(device="cuda")
    g.manual_seed(args.seed)
    try:
        cs._segment_case(torch, g, cs.N_ROWS, cs.GROUPS, 1, "+")
        cs._segment_case(torch, g, cs.N_ROWS, cs.VOCAB, 1, "+",
                         broadcast=True)
        cs._segment_case(torch, g, cs.PR_EDGES, cs.PR_VERTICES, 1, "+")
        cs._segment_case(torch, g, 2 ** 24, 4096, 8, "+")
        cs._segment_case(torch, g, cs.N_ROWS, cs.VOCAB, 1, "+",
                         dtype="int32")
        cs._segment_case(torch, g, cs.N_ROWS, cs.GROUPS, 1, "+", hot=0.25)
        lanes = range(cs.SERVE_MAX_BATCH)
        cs._segment_lanes_case(torch, g, [cs.MIX_B_ROWS[i % 2] for i in lanes],
                               cs.MIX_B_ROWS[0], cs.MIX_B_GROUPS)
        cs._segment_lanes_case(torch, g, [cs.MIX_B_KM[i % 2] for i in lanes],
                               cs.MIX_B_KM[0], 64, what="mix (b) kmeans_step")
    except cs.SmokeFailure as ex:
        print(f"segment_ab.py: FAILED: {ex}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
