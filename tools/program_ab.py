"""Time the run() of some of chip_smoke.py's phase-3 programs, in eager and
whole mode (or the `--modes` given; `dist` is compile_distributed over a
NCCL group of one rank, this process), for one tree of the repository:
the A/B half of a parent-vs-change comparison that chip_smoke.py's
five-run medians leave unresolved.

Inputs are those of the tree's own chip_smoke.py (`_programs`, from
`--seed`), already on the card; each mode gets one warm-up call and `--reps`
timed calls, each by the host clock around run() ending in a synchronize.
Prints one JSON line: {"tree": ..., "card": ..., "ms": {"<program>/<mode>":
[sorted ms, ...]}}.  Run each tree in its own process, alternating, e.g.

    for t in parent change change parent; do
        python3 tools/program_ab.py --tree $t --programs equal,group_by
    done

Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, required=True,
                    help="a checkout holding chip_smoke.py and src/")
    ap.add_argument("--programs", required=True,
                    help="comma-separated names as chip_smoke.py prints them")
    ap.add_argument("--modes", default="eager,whole",
                    help="comma-separated, of eager, whole and dist")
    ap.add_argument("--reps", type=int, default=41)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    tree = args.tree.resolve()
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("program_ab.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.core import compile_program
    want = args.programs.split(",")
    modes = args.modes.split(",")
    if "dist" in modes:
        import datetime
        import tempfile

        import torch.distributed as dist

        from repro_torch.core.distributed import compile_distributed
        from repro_torch.launch.mesh import make_test_mesh
        store = tempfile.mkdtemp(prefix="ab-store-")
        dist.init_process_group("nccl", init_method=f"file://{store}/s",
                                rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=300))
        mesh = make_test_mesh((1,), ("data",), device="cuda:0")
    import inspect
    cut = {"only": tuple(n.split("[")[0] for n in want)} \
        if "only" in inspect.signature(chip_smoke._programs).parameters \
        else {}
    ALL, progs = chip_smoke._programs(np, np.random.default_rng(args.seed),
                                      torch, **cut)
    ms = {}
    for item in progs:
        name, inputs = item[:2]
        if name not in want:
            continue
        for mode in modes:
            prog = ALL[name.split("[")[0]]
            cp = compile_distributed(prog, mesh) if mode == "dist" else \
                compile_program(prog, compile_mode=mode)
            cp.run(inputs)
            times = []
            for _ in range(args.reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cp.run(inputs)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            ms[f"{name}/{mode}"] = sorted(times)
            if mode == "dist":     # the rung the timed runs stayed on
                ms[f"{name}/{mode}/descents"] = cp.faults.counters["descend"]
            del cp
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    print(json.dumps({"tree": str(args.tree), "card": card, "ms": ms}))
    if "dist" in modes:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
