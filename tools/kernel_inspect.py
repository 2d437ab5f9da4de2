#!/usr/bin/env python3
"""Show what nvcc made of the port's hand-written CUDA kernels.

    python3 tools/kernel_inspect.py [NAME ...] [--csrc DIR]

Run from the root of a checkout on a machine with the CUDA toolkit.  Each
named source of src/repro_torch/kernels/csrc (by default flash_attention
and tile_matmul; with --csrc, that source in DIR, an edited copy of
csrc) is compiled once more with the package's own nvcc command line plus
`-Xptxas -v`, and for each kernel function the script prints its
registers, stack frame and spill bytes, then the count of the instructions
of interest in its SASS (`cuobjdump -sass`): HGMMA (wgmma), HMMA
(mma.sync), FFMA, LDSM (ldmatrix), LDGSTS (cp.async), MUFU (exp2 and the
other special functions), SHFL (shuffles), MATCH (match-any), LDL and STL
(local memory: spills).  ptxas's warnings and its notes of a potential
performance loss (a wgmma it had to serialise, say) are printed as they
come.  To time one version of the sources
against another, use `chip_smoke.py --parent DIR`, or `tools/kernel_ab.py`
for edited copies of one kernel's source.
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from chip_smoke import card_line  # noqa: E402

SASS_OPS = ("HGMMA", "HMMA", "FFMA", "LDSM", "LDGSTS", "MUFU", "SHFL", "MATCH",
            "LDL", "STL")


def _demangle(names):
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if not Path(filt).exists():
        return {n: n for n in names}
    out = subprocess.run([filt, *names], capture_output=True, text=True)
    return dict(zip(names, out.stdout.splitlines()))


def inspect(name: str, tmp: Path, csrc=None) -> None:
    from repro_torch.kernels import _build
    lib = tmp / f"lib{name}.so"
    proc = subprocess.run(_build.nvcc_command(name, lib, csrc,
                                              extra=("-Xptxas", "-v")),
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {name}:\n{proc.stdout}"
                         f"{proc.stderr}")
    # ptxas: "Compiling entry function 'X'", then "N bytes stack frame, N
    # bytes spill stores, N bytes spill loads" and "Used N registers, ..."
    stats, fn = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        if "warning" in line.lower() or "performance" in line.lower():
            print(f"[inspect] {name}: {line.strip()}", flush=True)
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            stats[fn] = {}
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                      r"stores, (\d+) bytes spill loads", line)
        if m:
            stats[fn].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            stats[fn]["registers"] = int(m.group(1))
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    fn = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = m.group(1)
            stats.setdefault(fn, {})
            continue
        if fn is None:
            continue
        for op in SASS_OPS:
            if re.search(rf"\b{op}\b", line):
                stats[fn][op] = stats[fn].get(op, 0) + 1
    pretty = _demangle(list(stats))
    for f, st in stats.items():
        print(f"[inspect] {name}: {pretty[f]}: " + json.dumps(st), flush=True)


def main(argv=None):
    args = list(argv if argv is not None else sys.argv[1:])
    csrc = None
    if "--csrc" in args:
        at = args.index("--csrc")
        csrc = Path(args[at + 1])
        del args[at:at + 2]
    names = args or ["flash_attention", "tile_matmul"]
    print(card_line(), flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="kernel_inspect_"))
    try:
        for name in names:
            inspect(name, tmp, csrc)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
