"""The 15 paper programs through the PyTorch port, on the CPU, against the
JAX package's run() and the port's own sequential interpreter, plus the
places where PyTorch's semantics differ from JAX's (one test each).

Inputs are made with numpy from a seed and handed to both packages; the
tolerance is tests/test_core_programs.py's (rtol 2e-3, atol 1e-4).  The
test programs below are parsed by both packages' frontends, each of which
evaluates the (string) annotations with its own type helpers."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import compile_program as jax_compile
from repro.core import parse_program as jax_parse
from repro.core.lower import PlanExecutor as JaxPlanExecutor
from repro.core.programs import ALL as JAX_ALL
from repro_torch.core import compile_program, interpret, parse_program
from repro_torch.core.lower import segment_flat
from repro_torch.core.programs import ALL
from test_core_programs import data_for

RTOL, ATOL = 2e-3, 1e-4


def _copy(ins):
    return {k: (tuple(np.array(c) for c in v) if isinstance(v, tuple)
                else (np.array(v) if isinstance(v, np.ndarray) else v))
            for k, v in ins.items()}


def _np64(ins):
    return {k: (tuple(np.asarray(c, np.float64) for c in v)
                if isinstance(v, tuple) else
                (np.asarray(v, np.float64) if isinstance(v, np.ndarray)
                 else v)) for k, v in ins.items()}


def _close(ours, ref, err=""):
    for k in ref:
        a = ours[k]
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(ref[k], np.float64),
                                   rtol=RTOL, atol=ATOL, err_msg=f"{err}{k}")


def _both(prog_ours, prog_ref, ins, **kw):
    ours = compile_program(prog_ours, device="cpu", **kw).run(_copy(ins))
    ref = jax_compile(prog_ref, **kw).run(_copy(ins))
    return ours, ref


@pytest.mark.parametrize("name", sorted(ALL))
def test_program_equals_reference_and_interpreter(name):
    ins = data_for(name)
    ours, ref = _both(ALL[name], JAX_ALL[name], ins)
    _close(ours, ref, f"{name} vs jax: ")
    _close(ours, interpret(ALL[name].program, _np64(ins)),
           f"{name} vs interpret: ")


@pytest.mark.parametrize("name", sorted(ALL))
def test_paper_faithful_plan_equals_reference(name):
    ins = data_for(name)
    ours, ref = _both(ALL[name], JAX_ALL[name], ins,
                      optimize_contractions=False)
    _close(ours, ref, f"{name} paper-faithful: ")


def test_outputs_are_float32_tensors_on_the_device():
    out = compile_program(ALL["pagerank"], device="cpu").run(
        data_for("pagerank"))
    for v in out.values():
        assert isinstance(v, torch.Tensor) and v.dtype == torch.float32
        assert v.device.type == "cpu"


# ---------------------------------------------------------------------------
# every group-by backend, with negative and out-of-range keys
# ---------------------------------------------------------------------------

def _groupby_inputs(seed):
    r = np.random.default_rng(seed)
    nv, ne = int(r.integers(8, 60)), int(r.integers(16, 400))
    keys = r.integers(-4, nv + 5, ne).astype(np.float64)
    return {
        "word_count": dict(W=keys.copy(), C=np.zeros(nv)),
        "group_by": dict(S=(keys.copy(), r.standard_normal(ne)),
                         C=np.zeros(nv)),
        "histogram": dict(P=tuple(r.integers(-2, nv + 2, ne)
                                  .astype(np.float64) for _ in range(3)),
                          R=np.zeros(nv), G=np.zeros(nv), B=np.zeros(nv)),
    }


@pytest.mark.parametrize("backend", ["scatter", "sort", "onehot", "pallas"])
@pytest.mark.parametrize("name", ["word_count", "histogram", "group_by"])
@pytest.mark.parametrize("seed", [0, 1])
def test_forced_backend_with_negative_and_oob_keys(name, backend, seed):
    ins = _groupby_inputs(seed)[name]
    mode = f"force:{backend}"
    cp = compile_program(ALL[name], op_select=mode, device="cpu")
    ours = cp.run(_copy(ins))
    ref = jax_compile(JAX_ALL[name], op_select=mode).run(_copy(ins))
    _close(ours, ref, f"{name}/{mode}: ")
    _close(ours, interpret(ALL[name].program, _np64(ins)))
    assert f"segment:{backend}[pinned]" in cp.explain()


@pytest.mark.parametrize("backend", ["scatter", "sort", "onehot", "pallas"])
def test_salted_group_by(backend):
    r = np.random.default_rng(7)
    keys = np.where(r.random(500) < 0.6, 3.0, r.integers(-2, 40, 500))
    ins = dict(S=(keys.astype(np.float64), r.standard_normal(500)),
               C=np.zeros(37))
    kw = dict(skew_salting="force:4", op_select=f"force:{backend}")
    cp = compile_program(ALL["group_by"], device="cpu", **kw)
    ours = cp.run(_copy(ins))
    ref = jax_compile(JAX_ALL["group_by"], **kw).run(_copy(ins))
    _close(ours, ref, f"salted {backend}: ")
    assert "salt=4x[hint]" in cp.explain()


def test_autotune_measures_once_then_reads_its_cache(tmp_path):
    cache = str(tmp_path / "autotune.json")
    ins = _groupby_inputs(3)["group_by"]
    lines = []
    for _ in range(2):
        cp = compile_program(ALL["group_by"], op_select="autotune",
                             autotune_cache=cache, device="cpu")
        out = cp.run(_copy(ins))
        lines.append([ln.strip() for ln in cp.explain().splitlines()
                      if "selected:" in ln])
        _close(out, interpret(ALL["group_by"].program, _np64(ins)))
    assert lines[0][0].endswith("[autotune]")
    assert lines[1][0] == lines[0][0].replace("[autotune]", "[cache]")


def test_autotune_raises_on_a_failing_candidate_and_caches_nothing(
        tmp_path, monkeypatch):
    # a kernel that fails to build or launch must surface, never lose the
    # measurement quietly and leave a cached choice that avoids it
    from repro_torch.core import lower

    def broken(backend, *a, **kw):
        if backend == "pallas":
            raise RuntimeError("segment_reduce: CUDA error 209")
        return segment_flat(backend, *a, **kw)
    monkeypatch.setattr(lower, "segment_flat", broken)
    cache = tmp_path / "autotune.json"
    cp = compile_program(ALL["group_by"], op_select="autotune",
                         autotune_cache=str(cache), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA error"):
        cp.run(_copy(_groupby_inputs(3)["group_by"]))
    assert not cache.exists()


# ---------------------------------------------------------------------------
# traps: where torch differs from jax, one test each
# ---------------------------------------------------------------------------

def store_shifted(W: bag[1], V: vector):
    for i, w in items(W):
        V[i - 2] = w


def gather_by_value(E: bag[2], P: vector, C: vector):
    for s, d in E:
        C[d] += P[s]


def mod_floor(V: bag[1], m: vector):
    for v in V:
        m[0] += v % 3.0
        m[1] += v // 2.0


def shifted_store(M: matrix, R: matrix, n: dim, m: dim):
    for i in range(1, n - 1):
        for j in range(0, m):
            R[i, j] = M[i, j] * 2.0


def int_count(W: bag[1], C: map_):
    for w in W:
        C[w] += 1.0


def _pair(fn, int_dest=None):
    progs = parse_program(fn), jax_parse(fn)
    if int_dest is not None:        # no annotation declares an int map
        for p in progs:
            p.params[int_dest] = dataclasses.replace(p.params[int_dest],
                                                     dtype="int")
    return progs


def test_trap_a_out_of_range_writes_are_dropped():
    # torch has no drop-mode scatter: negative and too-large keys must go
    # to a sentinel slot, never wrap and never assert
    # (keys i-2 for i = 0..6 into 4 cells: -2, -1 and 4 drop)
    ours_p, ref_p = _pair(store_shifted)
    ins = dict(W=np.arange(7.0) + 1.0, V=np.full(4, -1.0))
    ours, ref = _both(ours_p, ref_p, ins)
    _close(ours, ref)
    np.testing.assert_array_equal(ours["V"].numpy(), [3.0, 4.0, 5.0, 6.0])
    assert "Scatter" in compile_program(ours_p, device="cpu").explain()


def test_trap_b_gathers_clamp_and_mask():
    # torch has no clip-mode gather: an out-of-range read (negative or
    # ≥ N) is clamped, and its row drops through the inRange mask
    ours_p, ref_p = _pair(gather_by_value)
    src = np.array([0.0, -1.0, 4.0, 2.0, 7.0, -3.0, 1.0])
    dst = np.array([1.0, 2.0, 3.0, 0.0, 1.0, 2.0, 3.0])
    ins = dict(E=(src, dst), P=np.arange(5.0) + 1.0, C=np.zeros(4))
    ours, ref = _both(ours_p, ref_p, ins)
    _close(ours, ref)
    _close(ours, interpret(ours_p, _np64(ins)))
    np.testing.assert_allclose(ours["C"].numpy(), [3.0, 1.0, 0.0, 7.0])


def test_trap_c_dtypes_follow_the_reference_canonicalisation():
    cases = [("linear_regression", data_for("linear_regression")),
             ("histogram", data_for("histogram")),
             ("kmeans_step", data_for("kmeans_step"))]
    for name, ins in cases:
        ins = dict(ins)
        ins.setdefault("n", 30)
        ours = compile_program(ALL[name], device="cpu").prepare_env(
            _copy(ins))
        ref = jax_compile(JAX_ALL[name]).prepare_env(_copy(ins))
        for k, v in ref.items():
            if isinstance(v, int):
                assert ours[k] == v and isinstance(ours[k], int), (name, k)
                continue
            vs = v if isinstance(v, tuple) else (v,)
            os_ = ours[k] if isinstance(ours[k], tuple) else (ours[k],)
            for a, b in zip(os_, vs):
                assert str(a.dtype).replace("torch.", "") == str(b.dtype), \
                    (name, k, a.dtype, b.dtype)
    from repro_torch.convert import to_tensor
    assert to_tensor(np.arange(3), "cpu").dtype == torch.int32
    assert to_tensor(3, "cpu").dtype == torch.int32
    assert to_tensor(0.5, "cpu").dtype == torch.float32


def test_trap_d_operator_spellings():
    # % and // floor (jnp.mod / jnp.floor_divide), also for negatives;
    # the general store's meshgrid is "ij" (n ≠ m, shifted rows)
    ours_p, ref_p = _pair(mod_floor)
    ins = dict(V=np.array([-7.5, -1.0, 2.5, 5.0, -0.5]), m=np.zeros(2))
    ours, ref = _both(ours_p, ref_p, ins)
    _close(ours, ref)
    v = ins["V"]
    np.testing.assert_allclose(ours["m"].numpy(),
                               [np.sum(np.mod(v, 3.0)),
                                np.sum(np.floor_divide(v, 2.0))], rtol=1e-6)
    ours_p, ref_p = _pair(shifted_store)
    M = np.random.default_rng(1).standard_normal((5, 3))
    ins = dict(M=M, R=np.full((5, 3), 9.0), n=5, m=3)
    ours, ref = _both(ours_p, ref_p, ins)
    _close(ours, ref)
    np.testing.assert_allclose(ours["R"].numpy()[1:4], 2.0 * M[1:4],
                               rtol=1e-6)
    np.testing.assert_array_equal(ours["R"].numpy()[[0, 4]], 9.0)


def test_trap_e_exact_int_one_hot():
    # CUDA has no int32 matmul: the one-hot path accumulates integers in
    # float64, exact at 2^24+1 where float32 would round
    ids = np.array([0, 0, 1, 2], np.int32)       # 2 == num: the sentinel
    vals = np.array([2 ** 24 + 1, 1, 5, 7], np.int32)
    ours = segment_flat("onehot", torch.from_numpy(ids),
                        torch.from_numpy(vals), 2, "+")
    import jax.numpy as jnp
    ref = JaxPlanExecutor(JAX_ALL["count"].program)._segment_flat(
        "onehot", jnp.asarray(ids), jnp.asarray(vals), 2, "+")
    assert ours.dtype == torch.int32
    assert ours.tolist() == [2 ** 24 + 2, 5] == np.asarray(ref).tolist()


def test_trap_e_int_destination_through_every_backend():
    ours_p, ref_p = _pair(int_count, int_dest="C")
    w = np.random.default_rng(2).integers(-2, 12, 200).astype(np.float64)
    for backend in ("scatter", "sort", "onehot", "pallas"):
        ins = dict(W=w, C=np.zeros(10))
        ours, ref = _both(ours_p, ref_p, ins, op_select=f"force:{backend}")
        assert ours["C"].dtype == torch.int32
        _close(ours, ref, backend)


@pytest.mark.parametrize("steps", [0.0, 1.0, 4.0])
def test_trap_f_seq_loop_runs_on_the_host(steps):
    ins = data_for("pagerank")
    ins["num_steps"] = steps
    ours, ref = _both(ALL["pagerank"], JAX_ALL["pagerank"], ins)
    _close(ours, ref)
    assert float(ours["steps"]) == steps


@pytest.mark.parametrize("name", ["word_count", "group_by",
                                  "conditional_sum", "kmeans_step",
                                  "linear_regression"])
def test_execute_with_pad_limits_like_the_reference(name):
    # padded bag rows, and the rows of dense arrays that ride the bag's row
    # count (a serving bucket's pad), never change a result
    from repro_torch.core.plan import bag_row_arrays
    ins = data_for(name)
    cp = compile_program(ALL[name], device="cpu")
    jp = jax_compile(JAX_ALL[name], compile_mode="eager")
    bag_name = next(n for n, t in ALL[name].program.params.items()
                    if t.kind == "bag")
    lim = 7
    arrays = {a: lim for a, b in bag_row_arrays(cp.plan).items()
              if b == bag_name}
    env_o = cp.prepare_env(_copy(ins))
    env_r = jp.prepare_env(_copy(ins))
    cp.execute(env_o, bag_limits={bag_name: lim}, array_limits=arrays)
    jp.execute(env_r, bag_limits={bag_name: lim}, array_limits=arrays)
    for k in ALL[name].program.outputs:
        np.testing.assert_allclose(
            np.asarray(env_o[k], np.float64),
            np.asarray(env_r[k], np.float64), rtol=RTOL, atol=ATOL,
            err_msg=f"{name}/{k}")
