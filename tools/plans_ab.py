"""Serve chip_smoke.py's phase-6 mixes for one tree of the repository: the
A/B half of a parent-vs-change comparison of plan serving end to end.

Builds the tree's kernels (its own `phase_build`), then runs the tree's
own `_serve_mix` for each mix named: PlanServer(max_batch=16, flush_ms=1)
at 1, 8 and 64 closed-loop clients, every lane held bit-equal to its solo
run(), and each program's flush of 16 lanes timed and traced.  The tree's
`[plans]` and `[profile]` lines are printed as they come, after one line
naming the tree and the card.  Run each tree in its own process,
alternating, e.g.

    for t in parent change change parent; do
        python3 tools/plans_ab.py --tree $t --mixes a,b
    done

Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, required=True,
                    help="a checkout holding chip_smoke.py and src/")
    ap.add_argument("--mixes", default="a,b",
                    help="comma-separated, of a and b")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    tree = args.tree.resolve()
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("plans_ab.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    card = chip_smoke.phase_build(torch)
    print(f"[plans_ab] tree {tree} on {card}", flush=True)
    sizes = {"a": chip_smoke.MIX_A, "b": chip_smoke.MIX_B}
    try:
        for mix in args.mixes.split(","):
            chip_smoke._serve_mix(torch, np, mix, sizes[mix], args.seed)
    except chip_smoke.SmokeFailure as ex:
        print(f"plans_ab.py: FAILED: {ex}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
