"""Data-parallel training of the PyTorch port over a `RankGroup` of two
gloo ranks on the CPU, against the reference's single-controller step.

The reference's `make_train_step(cfg, mesh)` is one GSPMD program over the
global batch, so its result is `jax.jit(make_train_step(cfg, None))` on
that batch: that jitted step is the oracle.  Each rank runs the port's
`make_train_step(cfg, mesh)` on its rows of the same `SyntheticLMData`
draw (`host_index`, `host_count`, `microbatch`) and all-reduces the
gradients.  Tolerances are test_torch_train.py's: loss and grad_norm
within GRAD_TOL relative at every step; the parameters within PARAM_TOL
after the first step and after the last, but for the float32-rounding
elements that `ROUNDING_ELEMENTS` names (then set to the reference's
values); every rank's parameters and moments bit-equal after every step.
With `compress_grads` the ranks sum bf16 halves where the reference casts
the float32 sum once: see `test_compressed_exchange_is_bf16_rounding`.

One group of two rank processes for the module; what the ranks run is in
`torch_dp_ranks.py`, which imports no jax.
"""
import jax
import numpy as np
import pytest
import torch

import torch_dp_ranks as R
from repro.configs import list_archs
from repro.models.moe import _cap_e as jax_cap_e
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.ranks import RankFailure, RankGroup
from repro_torch.models import moe
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime import TrainRunner
from repro_torch.train import make_train_step
from test_torch_train import (GRAD_TOL, ROUNDING,
                              ROUNDING_ELEMENTS, _check_params, _flat, _pair,
                              _ref_grad_fn, _ref_params, _rel,
                              _tree_to_numpy)

ARCHS = list_archs()
SEED = 3
P = 2
MOE = ["qwen3-moe-30b-a3b", "arctic-480b"]


@pytest.fixture(scope="module")
def g2():
    with RankGroup(P, device="cpu") as g:
        yield g


def _np(tree):
    return dict(_flat(jax.tree.map(np.asarray, tree)))


def _tree(arch):
    """The reference's `model.init(0)` of an arch's smoke config, numpy."""
    return jax.tree.map(np.asarray, _ref_params(arch))


def _reference(arch, over, steps, compress=False):
    """The reference's jitted step on the global batches: (its initial
    weights as numpy, per step {loss, grad_norm, params, mu, nu})."""
    cfg, jcfg, params, _ = _pair(arch, **over)
    data = R.data(cfg, SEED)
    jstep = jax.jit(jax_make_train_step(jcfg, None, ("data",),
                                        compress_grads=compress))
    jopt = jax_adamw_init(params)
    tree = jax.tree.map(np.asarray, params)
    out = []
    for _ in range(steps):
        params, jopt, m = jstep(params, jopt, data.next_batch())
        out.append({"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]),
                    "params": _np(params), "mu": _np(jopt.mu),
                    "nu": _np(jopt.nu)})
    return tree, out


def _rounding_of(first):
    """The elements whose first gradient is float32 rounding (test_torch_
    train's `_rounding`), read from the first step's moment: mu = (1 − b1)
    · g · the clip scale, one scale for all leaves."""
    return {k: np.abs(m) < ROUNDING * np.abs(m).max()
            for k, m in first["mu"].items()}


def _same_replicas(res):
    """Every rank's parameters and moments bit-equal to rank 0's, at every
    step."""
    for i, step in enumerate(res[0]["steps"]):
        for other in res[1:]:
            for part, leaves in step["state"].items():
                for k, v in leaves.items():
                    assert np.array_equal(v, other["steps"][i]["state"]
                                          [part][k]), (i, part, k)


def _against_reference(res, ref, rounding, allowed):
    """Loss and grad_norm at every step, the parameters after the first
    step (rounding elements allowed) and after the last."""
    steps = res[0]["steps"]
    for mine, want in zip(steps, ref):
        assert _rel(mine["loss"], want["loss"]) <= GRAD_TOL
        assert _rel(mine["grad_norm"], want["grad_norm"]) <= GRAD_TOL
    _check_params(steps[0]["state"]["params"], ref[0]["params"], rounding,
                  allowed)
    _check_params(steps[-1]["state"]["params"], ref[-1]["params"])


def _train_against_reference(g, test, arch, over, steps=2):
    tree, ref = _reference(arch, over, steps)
    rounding = _rounding_of(ref[0])
    align = {"mask": rounding, **{n: ref[0][n] for n in ("params", "mu",
                                                         "nu")}}
    res = g.run(R.train, arch, over, tree, steps, SEED, False, align)
    _same_replicas(res)
    _against_reference(res, ref, rounding, ROUNDING_ELEMENTS.get((test,
                                                                 arch)))
    return tree, res


@pytest.mark.parametrize("arch", ARCHS)
def test_dp_step_matches_reference(g2, arch):
    """Two steps on two ranks (each its two rows of four) against the
    reference's jitted step on the global batch; the exchange is one
    bucket and the loss a step, and one crc32 gather at the first call."""
    _, res = _train_against_reference(g2, "steps", arch, {})
    calls = res[0]["calls"]
    assert calls["all_reduce"] == 2 * 2
    moe_calls = calls.get("all_gather_into_tensor", 0) - 1
    assert moe_calls >= 0 and (moe_calls > 0) == bool(
        R.config(arch, {}).num_experts)


def _global_keep(experts, n_experts, cf):
    """The reference's kept rows of one routed microbatch (token-major):
    a row's rank among the rows routed to its expert, in row order,
    below `_cap_e` of all the rows."""
    onehot = experts[:, None] == np.arange(n_experts)[None]
    rank = np.cumsum(onehot, axis=0)[np.arange(len(experts)), experts] - 1
    return rank < jax_cap_e(len(experts), n_experts, cf)


@pytest.mark.parametrize("arch", MOE)
def test_moe_capacity_counts_the_global_microbatch(g2, arch):
    """Microbatch 2 with the capacity that drops rows: the reference
    routes each global microbatch as one, and so do the ranks together.
    Each MoE call's rows, concatenated in rank order, are dropped where
    the reference's capacity over all of them drops them (and, in the
    first step, where the port's single-process step drops them); some
    are.  The step agrees with the reference's."""
    over = {"microbatch": 2}
    _, res = _train_against_reference(g2, "microbatch", arch, over)
    cfg, _, _, model = _pair(arch, **over)
    seen, restore = R._probe()
    try:
        make_train_step(cfg, compress_grads=False)(
            model, adamw_init(dict(model.named_leaves())),
            R.data(cfg, SEED).next_batch())
    finally:
        restore()
    calls = [r["dispatch"] for r in res]
    assert len(calls[0]) == len(calls[1]) == 2 * len(seen) > 0
    dropped = 0
    for j in range(len(calls[0])):
        experts = np.concatenate([c[j][0] for c in calls])
        keep = np.concatenate([c[j][1] for c in calls])
        want = _global_keep(experts, cfg.num_experts, cfg.capacity_factor)
        np.testing.assert_array_equal(keep, want, err_msg=str(j))
        if j < len(seen):
            np.testing.assert_array_equal(experts, seen[j][0],
                                          err_msg=str(j))
            np.testing.assert_array_equal(keep, seen[j][1], err_msg=str(j))
        dropped += int((~want).sum())
    assert dropped > 0


def test_compressed_exchange_is_bf16_rounding(g2):
    """compress_grads=True: each rank sends bf16(g_r / 2) and the ranks sum
    in bf16, where the reference casts the float32 mean g once.  Per
    element the two differ by bf16 rounding alone (unit roundoff u =
    2^-8): |exchanged − bf16(g)| ≤ u·(|g_0| + |g_1|)/2 + 2u·|g| (the two
    casts and the sum, against the reference's one cast), plus GRAD_TOL
    of the leaf's max |g| (float32 sums in another order).  Loss within
    GRAD_TOL and grad_norm within u relative, at both steps."""
    arch = "llama3-8b"
    cfg, jcfg, params, _ = _pair(arch)
    tree, ref = _reference(arch, {}, 2, compress=True)
    _, want = _ref_grad_fn(jcfg)(params, R.data(cfg, SEED).next_batch())
    res = g2.run(R.exchanged, arch, tree, SEED)
    u = 2.0 ** -8
    mine = [_reference_layout(cfg, r) for r in res]
    for k, gw in want.items():
        gw = np.asarray(gw, np.float64)
        ref_cast = np.asarray(torch.from_numpy(gw.astype(np.float32))
                              .to(torch.bfloat16).float(), np.float64)
        local = [m["local"][k] for m in mine]
        got = mine[0]["exchanged"][k]
        np.testing.assert_array_equal(got, mine[1]["exchanged"][k])
        bound = u * (np.abs(local[0]) + np.abs(local[1])) / 2 \
            + 2 * u * np.abs(gw) + GRAD_TOL * np.abs(gw).max()
        assert (np.abs(got - ref_cast) <= bound).all(), k
    for mine_step, want_step in zip(res[0]["steps"], ref):
        assert _rel(mine_step["loss"], want_step["loss"]) <= GRAD_TOL
        assert _rel(mine_step["grad_norm"], want_step["grad_norm"]) <= u


def _reference_layout(cfg, r):
    """A rank's first-step gradients, before and after the exchange, keyed
    by the reference's paths."""
    return {part: dict(_flat(_tree_to_numpy(cfg, {
        k: torch.from_numpy(v) for k, v in r[part].items()})))
        for part in ("local", "exchanged")}


def test_buckets_are_made_once_and_cut_by_size(g2):
    """The exchange keeps its buckets from call to call, cuts them at
    BUCKET_BYTES (a larger leaf alone), and gives the same bits however
    it is cut."""
    arch = "qwen3-moe-30b-a3b"
    tree = _tree(arch)
    whole = g2.run(R.train, arch, {}, tree, 2, SEED)
    cut = g2.run(R.bucketed, arch, tree, SEED, 1 << 12)
    for a, b in zip(whole, cut):
        for part, leaves in a["steps"][-1]["state"].items():
            for k, v in leaves.items():
                assert np.array_equal(v, b["state"][part][k]), (part, k)
    for r in cut:
        assert r["same_buckets"] and r["buckets"] > 2
        assert all(n <= 1 << 12 or leaves == 1
                   for n, leaves in r["sizes"])
        assert r["calls"]["all_reduce"] == 2 * (r["buckets"] + 1)


def test_elastic_resume(g2, tmp_path):
    """A two-rank run saving every 2 steps fails at step 3; rank 0's
    step-2 snapshot resumes on two ranks (bit-equal to the uninterrupted
    two-rank run on both) and in one process without a mesh (its own
    sums: within PARAM_TOL), at step 2 and data position 2."""
    arch = "llama3-8b"
    tree = _tree(arch)
    full = g2.run(R.run_to, arch, tree, str(tmp_path / "a"), 10 ** 6, SEED,
                  4)
    ckpt = str(tmp_path / "b")
    failed = g2.run(R.run_to, arch, tree, ckpt, 2, SEED, 4, 3)
    assert [r["step"] for r in failed] == [3, 3]
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) == [
        "step_00000002"]
    back = g2.run(R.run_to, arch, tree, ckpt, 10 ** 6, SEED, 4, None, True)
    for b, f in zip(back, full):
        assert b["resumed"] == 2 and b["data_step"] == 2 and b["step"] == 4
        for part, leaves in f["state"].items():
            for k, v in leaves.items():
                assert np.array_equal(v, b["state"][part][k]), (part, k)
    cfg = R.config(arch, {})
    model = R.model_of(cfg, tree)
    one = TrainRunner(make_train_step(cfg, compress_grads=False), model,
                      adamw_init(dict(model.named_leaves())),
                      R.data(cfg, SEED), ckpt_dir=ckpt,
                      ckpt_every=10 ** 6)
    assert one.maybe_resume() and one.step == 2 and one.data.step == 2
    assert one.data.local_batch == R.B
    one.run(4)
    got = R.state(cfg, one.params, one.opt_state)
    _check_params(got["params"], full[0]["state"]["params"])


def _mesh(**shape):
    return Mesh(tuple(shape), dict(shape), 0, torch.device("cpu"), "gloo")


def test_model_axis_raises_naming_the_item():
    """A mesh whose model axis is larger than 1 asks for tensor (or
    expert) parallelism: the step and the MoE layer raise, naming the
    ROADMAP item; model = 1 is plain data parallelism."""
    cfg = R.config("qwen3-moe-30b-a3b", {})
    with pytest.raises(NotImplementedError,
                       match="Tensor parallelism over the model axis"):
        make_train_step(cfg, _mesh(data=1, model=2))
    p = {k: torch.zeros(d.shape) for k, d in moe.moe_defs(cfg).items()}
    x = torch.zeros((1, 8, cfg.d_model))
    with pytest.raises(NotImplementedError,
                       match="expert parallelism over a RankGroup"):
        moe.moe_forward(cfg, p, x, mesh=_mesh(data=1, model=2))
    assert make_train_step(cfg, _mesh(data=1, model=1)).mesh is not None


def test_pipeline_cuts_each_microbatch_by_rank():
    """Host h of H with k microbatches holds the h-th part of each global
    microbatch, in row order; the rows of all hosts are the global draw."""
    cfg = R.config("llama3-8b", {"microbatch": 2})
    whole = R.data(cfg, SEED).next_batch()["tokens"]
    parts = [R.data(cfg, SEED, r, P).next_batch()["tokens"] for r in
             range(P)]
    m = R.B // 2
    for i in range(2):
        np.testing.assert_array_equal(
            np.concatenate([p[i * m // P:(i + 1) * m // P] for p in parts]),
            whole[i * m:(i + 1) * m])
    with pytest.raises(ValueError, match="microbatches"):
        R.data(cfg.replace(microbatch=4), SEED, 0, P)


def test_drifted_replica_raises(g2):
    """Ranks that start from different weights fail the step's first call
    (ReplicaDivergence on every rank), not fork silently."""
    tree = _tree("llama3-8b")
    with pytest.raises(RankFailure, match="ReplicaDivergence"):
        g2.run(R.drifted, "llama3-8b", tree, SEED)
