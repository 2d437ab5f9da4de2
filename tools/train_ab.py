#!/usr/bin/env python3
"""One model's phase-8 training run of chip_smoke.py, from one tree's sources.

    python3 tools/train_ab.py --tree DIR [--arch whisper-tiny] [--seed N]

Imports `repro_torch` and `chip_smoke` from DIR (a checkout: DIR/src and
DIR/chip_smoke.py) and runs that tree's `_train_model` for `--arch`: its
TRAIN_ARCHS batch and depth, TRAIN_STEPS steps with the kernels' launches
checked, one step under torch.profiler (device busy ms, idle share, the
hand-written kernels' share: the `[train]` and `[profile]` lines), then
the steps on one fixed batch.  Only the kernels the model launches are
built, into DIR's own build directory.  Run it for two trees (a parent
unpacked by `git archive` into the git-ignored `.checkout/`, and the
checkout) in separate processes on the same card, alternating, e.g.

    for t in .checkout/parent . . .checkout/parent; do
        python3 tools/train_ab.py --tree $t
    done

so that the step's device time is compared within one call.  Each tree
launches its kernels through its own wrappers, so a kernel whose scratch
changed is given the size its own library needs.  Prints the tree's log
lines, then one JSON line {"tree", "card", "arch", "launches"}.  Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, required=True,
                    help="a checkout holding chip_smoke.py and src/")
    ap.add_argument("--arch", default="whisper-tiny")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    tree = args.tree.resolve()
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("train_ab.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    if args.arch not in chip_smoke.TRAIN_ARCHS:
        print(f"train_ab.py: {args.arch} is not in {tree}'s TRAIN_ARCHS",
              file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        launches = chip_smoke._train_model(torch, np, args.arch, args.seed,
                                           Path(tmp))
    print(json.dumps({"tree": str(args.tree), "card": chip_smoke.card_line(),
                      "arch": args.arch, "launches": launches}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
