#!/usr/bin/env python3
"""Phase 4 (serving) of chip_smoke.py, from one tree's sources, timed.

    python3 tools/serve_ab.py --tree DIR [--seed N]

Imports `repro_torch` and `chip_smoke` from DIR (a checkout: DIR/src and
DIR/chip_smoke.py), builds DIR's kernels into DIR's own build directory
(`phase_build`), then runs that tree's `phase_serve`: its `[serve]` and
`[profile]` lines, each config's seconds, the checks.  Run it for two
trees (a parent unpacked by `git archive` into the git-ignored
`.checkout/`, and the checkout) in separate processes on the same card,
e.g.

    for t in .checkout/parent .; do python3 tools/serve_ab.py --tree $t; done

so that the phase's seconds are compared within one call.  Prints the
tree's log lines, then one JSON line {"tree", "card", "build_s",
"serve_s", "launches"}.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, required=True,
                    help="a checkout holding chip_smoke.py and src/")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    tree = args.tree.resolve()
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import torch
    if not torch.cuda.is_available():
        print("serve_ab.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    t = time.perf_counter()
    chip_smoke.phase_build(torch)
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    launches = chip_smoke.phase_serve(torch, args.seed)
    serve_s = time.perf_counter() - t
    print(json.dumps({"tree": str(args.tree), "card": chip_smoke.card_line(),
                      "build_s": round(build_s, 1),
                      "serve_s": round(serve_s, 1), "launches": launches}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
