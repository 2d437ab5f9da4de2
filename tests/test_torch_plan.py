"""The PyTorch port builds the reference package's plan, and imports
nothing of JAX or of the reference package.

The planner modules of `repro_torch.core` are copies of `repro.core`'s,
so for every paper program the port's pre-run explain() must equal the
reference's character for character (without the trailing
`whole-program:` line, which reports each package's own execution mode)."""
import ast
from pathlib import Path

import numpy as np
import pytest

from repro.core import compile_program as jax_compile
from repro.core.op_select import OpSelector as JaxOpSelector
from repro.core.programs import ALL as JAX_ALL
from repro_torch.core import compile_program
from repro_torch.core.op_select import (PROBE_ROWS, SEGMENT_CANDIDATES,
                                        OpSelector, probe_hot_fraction)
from repro_torch.core.programs import ALL

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _plan_text(cp, tiled=()):
    return cp.explain(tiled).rsplit("\nwhole-program:", 1)[0]


@pytest.mark.parametrize("optimize", [True, False])
@pytest.mark.parametrize("name", sorted(ALL))
def test_pre_run_plan_equals_reference(name, optimize):
    assert set(ALL) == set(JAX_ALL)
    ours = compile_program(ALL[name], optimize_contractions=optimize,
                           device="cpu")
    ref = jax_compile(JAX_ALL[name], optimize_contractions=optimize)
    assert _plan_text(ours) == _plan_text(ref)


def test_tiled_plan_equals_reference():
    ours = compile_program(ALL["matrix_multiplication"], device="cpu")
    ref = jax_compile(JAX_ALL["matrix_multiplication"])
    assert _plan_text(ours, {"M"}) == _plan_text(ref, {"M"})


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax_and_no_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:          # relative: stays inside the package
                continue
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, \
                f"{path.relative_to(ROOT)}:{node.lineno} imports {n}"


# ---------------------------------------------------------------------------
# operator selection: the cpu row is the reference's; the cuda row sends
# the main path through the hand-written kernels
# ---------------------------------------------------------------------------

_CLASSES = [(200_000, 1000, 1, "+"), (8192, 128, 1, "+"), (4096, 16, 1, "+"),
            (512, 8, 1, "+"), (200_000, 1000, 1, "min"),
            (65_536, 4096, 1, "*"), (2 ** 26, 2 ** 20, 1, "+"),
            (2 ** 26, 256, 1, "max")]


@pytest.mark.parametrize("n,k,d,op", _CLASSES)
def test_cpu_cost_decisions_equal_reference(n, k, d, op):
    ours = OpSelector(mode="cost", cache_path=None, platform="cpu")
    ref = JaxOpSelector(mode="cost", cache_path=None, platform="cpu")
    kw = dict(n=n, k=k, d=d, op=op, dtype="float32", dest_dist="ONED_ROW")
    a, b = ours.choose_segment(**kw), ref.choose_segment(**kw)
    assert (a.backend, a.source, a.why) == (b.backend, b.source, b.why)


@pytest.mark.parametrize("n,k,d,op", _CLASSES)
def test_cuda_cost_row_picks_the_segment_kernel(n, k, d, op):
    sel = OpSelector(mode="cost", cache_path=None, platform="cuda")
    dec = sel.choose_segment(n=n, k=k, d=d, op=op, dtype="float32",
                             dest_dist="ONED_ROW")
    want = "pallas" if "pallas" in SEGMENT_CANDIDATES[op] else "scatter"
    assert (dec.backend, dec.source) == (want, "cost")


def test_cuda_cost_row_picks_the_tile_kernel():
    sel = OpSelector(mode="cost", cache_path=None, platform="cuda")
    assert sel.choose_contract(m=8192, k=8192, n=8192).backend \
        == "pallas-tiled"
    assert OpSelector(mode="cost", cache_path=None, platform="cpu") \
        .choose_contract(m=8192, k=8192, n=8192).backend == "unpack-einsum"


# hot-key salting: the skew guard weighs the hottest key against what the
# probe's sample of uniform keys would show, however large K is
_SALT_K = [256, 4096, 2 ** 17, 2 ** 20]


def _probe(k, hot, seed):
    r = np.random.default_rng(seed)
    keys = r.integers(0, k, PROBE_ROWS)
    if hot:
        keys = np.where(r.random(PROBE_ROWS) < 0.25, 0, keys)
    return probe_hot_fraction(keys)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", _SALT_K)
def test_cuda_salt_guard_leaves_uniform_keys_alone(k, seed):
    sel = OpSelector(mode="cost", cache_path=None, platform="cuda")
    dec = sel.choose_salt(n=2 ** 26, k=k, op="+",
                          hot_frac=_probe(k, False, seed))
    assert (dec.backend, dec.source) == ("none", "cost")


@pytest.mark.parametrize("k", _SALT_K)
def test_cuda_salt_guard_salts_a_hot_key(k):
    sel = OpSelector(mode="cost", cache_path=None, platform="cuda")
    dec = sel.choose_salt(n=2 ** 26, k=k, op="+", hot_frac=_probe(k, True, 0))
    assert dec.backend.startswith("salt:") and dec.source == "cost"


@pytest.mark.parametrize("hot", [False, True])
@pytest.mark.parametrize("k", _SALT_K)
def test_cpu_salt_decisions_equal_reference(k, hot):
    h = _probe(k, hot, 0)
    kw = dict(n=2 ** 20, k=k, op="+", hot_frac=h)
    a = OpSelector(mode="cost", cache_path=None,
                   platform="cpu").choose_salt(**kw)
    b = JaxOpSelector(mode="cost", cache_path=None,
                      platform="cpu").choose_salt(**kw)
    assert (a.backend, a.source, a.why) == (b.backend, b.source, b.why)


def test_device_defaults_to_cuda_and_refuses_the_cpu_silently():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compile_program(ALL["count"])


def test_whole_program_mode_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        compile_program(ALL["count"], compile_mode="whole", device="cpu")
