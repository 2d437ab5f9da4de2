"""The PyTorch port's MoE layer and M-RoPE against the JAX package's, on
the CPU.

`moe_local` takes the same numpy-seeded parameters and inputs as
`repro.models.moe.moe_local` (float32 smoke widths, the kernel's plain
version for the combine): outputs within 1e-5, the top-k choice and the
drop set exactly the reference's, at capacity factors 1.25 and 8.0, with
a router skewed toward expert 0 (rows drop at 1.25) and with tied router
columns (the lower index wins, as `jax.lax.top_k`).  `groups=G` equals G
separate calls.  The serve engine at 32 slots on a skewed qwen3-moe smoke
config gives the JAX engine's tokens only because its batched decode
routes each slot as a group of its own.  A moe layout trains and a
recorded combine takes its gradient through `SegmentAdd`; a meshed
`moe_forward` raises; the converter carries the expert leaves across
both ways.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import blocks as jax_blocks
from repro.models import get_model as jax_get_model
from repro.models import moe as jax_moe
from repro.models.common import apply_mrope as jax_apply_mrope
from repro.models.common import apply_rope as jax_apply_rope
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.models import blocks, moe
from repro_torch.models.common import apply_mrope, apply_rope
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import make_train_step

ARCH = "qwen3-moe-30b-a3b"
TOL = dict(rtol=1e-5, atol=1e-5)


def _moe_case(cfg, t, seed, router="random"):
    """Numpy params and tokens [1, t, d] for the smoke MoE layer."""
    r = np.random.default_rng(seed)
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {"router": r.standard_normal((d, e)) * d ** -0.5,
         "w_gate": r.standard_normal((e, d, ff)) * d ** -0.5,
         "w_in": r.standard_normal((e, d, ff)) * d ** -0.5,
         "w_out": r.standard_normal((e, ff, d)) * ff ** -0.5}
    x = r.standard_normal((1, t, d))
    if router == "skewed":
        # every token shares a direction that expert 0's column reads
        u = r.standard_normal(d)
        x = x + 1.5 * u
        p["router"][:, 0] += 2.0 * u / d
    elif router == "tied":
        # columns 0 = 1 and 2 = 3: every token's logits tie in pairs
        p["router"][:, 1] = p["router"][:, 0]
        p["router"][:, 3] = p["router"][:, 2]
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return p, x.astype(np.float32)


def _drops_of(experts, n_experts, cap_e):
    """The reference's drop rule, row by row in flat order."""
    seen = np.zeros(n_experts, int)
    keep = []
    for e in experts:
        keep.append(seen[e] < cap_e)
        seen[e] += 1
    return np.array(keep)


def _port(p, x):
    return ({k: torch.from_numpy(v) for k, v in p.items()},
            torch.from_numpy(x))


@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("router", ["skewed", "tied", "random"])
def test_moe_local_matches_reference(cf, router):
    cfg = smoke_config(ARCH).replace(capacity_factor=cf)
    jcfg = jax_smoke_config(ARCH).replace(capacity_factor=cf)
    p, x = _moe_case(cfg, 40, seed=3, router=router)
    pt, xt = _port(p, x)
    want = jax_moe.moe_local(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x))
    got = moe.moe_local(cfg, pt, xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the top-k choice, exactly
    jw, je = jax_moe._router(jcfg, {"router": jnp.asarray(p["router"])},
                             jnp.asarray(x[0]))
    gw, ge = moe._router(cfg, pt, xt[0])
    np.testing.assert_array_equal(ge.numpy(), np.asarray(je))
    np.testing.assert_allclose(gw.numpy(), np.asarray(jw), **TOL)
    # the drop set, exactly the reference rule's
    flat = np.asarray(je).reshape(-1)
    cap_e = jax_moe._cap_e(flat.size, cfg.num_experts, cf)
    _, keep, _ = moe._dispatch(ge.reshape(-1), cfg.num_experts, 1, cf)
    want_keep = _drops_of(flat, cfg.num_experts, cap_e)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if router == "skewed":
        assert (0 in flat.reshape(-1, cfg.top_k)[:, 0]) and \
            (~want_keep).any() == (cf == 1.25)
    if router == "tied":
        pairs = np.asarray(je)
        # where both of a tied pair were chosen, the lower index comes
        # first; where one was, it is the lower index
        for lo, hi in ((0, 1), (2, 3)):
            assert not (pairs == hi).any() or (pairs == lo).any()
            both = (pairs == lo).any(1) & (pairs == hi).any(1)
            assert both.any()
            assert (np.argmax(pairs == lo, 1) < np.argmax(pairs == hi, 1))[
                both].all()
            one = (pairs == lo).any(1) ^ (pairs == hi).any(1)
            assert not (pairs[one] == hi).any()


def test_dense_residual_block_ffn_matches_reference():
    """arctic's MoE + dense residual SwiGLU, the block's feed-forward."""
    arch = "arctic-480b"
    cfg, jcfg = smoke_config(arch), jax_smoke_config(arch)
    assert cfg.dense_residual
    p, x = _moe_case(cfg, 24, seed=4, router="skewed")
    r = np.random.default_rng(5)
    d, ff = cfg.d_model, cfg.d_ff
    mlp = {"w_gate": r.standard_normal((d, ff)) * d ** -0.5,
           "w_in": r.standard_normal((d, ff)) * d ** -0.5,
           "w_out": r.standard_normal((ff, d)) * ff ** -0.5}
    mlp = {k: v.astype(np.float32) for k, v in mlp.items()}
    want = jax_blocks._ffn(jcfg, "moe", {
        "moe": {k: jnp.asarray(v) for k, v in p.items()},
        "mlp": {k: jnp.asarray(v) for k, v in mlp.items()}},
        jnp.asarray(x), None, ("data",))
    got = blocks._ffn(cfg, "moe", {
        "moe": {k: torch.from_numpy(v) for k, v in p.items()},
        "mlp": {k: torch.from_numpy(v) for k, v in mlp.items()}},
        torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    alone = moe.moe_local(cfg, *_port(p, x))
    assert float((got - alone).abs().max()) > 1e-2


@pytest.mark.parametrize("groups", [2, 5])
def test_groups_equal_separate_calls(groups):
    cfg = smoke_config(ARCH)
    t = 32 * groups       # 32 tokens a group: cap_e 24 for 32 rows
    p, x = _moe_case(cfg, t, seed=6, router="skewed")
    pt, xt = _port(p, x)
    got = moe.moe_local(cfg, pt, xt, groups=groups)
    parts = [moe.moe_local(cfg, pt, part)
             for part in xt.split(t // groups, dim=1)]
    np.testing.assert_allclose(got.numpy(), torch.cat(parts, 1).numpy(),
                               rtol=1e-6, atol=1e-6)
    # the groups matter: routed as one call, rows drop that did not
    whole = moe.moe_local(cfg, pt, xt)
    assert float((whole - got).abs().max()) > 1e-2
    with pytest.raises(ValueError, match="equal groups"):
        moe.moe_local(cfg, pt, xt[:, :t - 1], groups=groups)


def _skewed_engine_models(seed=0):
    """Both packages' smoke qwen3-moe with one tree, skewed: a shared
    direction in every embedding row that each layer's router column 0
    reads, so that in each layer one expert is among nearly every token's
    top 2."""
    jcfg, cfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    params = jax_get_model(jcfg).init(seed)
    tree = jax.tree.map(np.array, params)
    r = np.random.default_rng(seed)
    u = r.standard_normal(cfg.d_model).astype(np.float32)
    tree["embed"] += 0.05 * u
    tree["g0"]["s0_moe"]["moe"]["router"][..., 0] += 2.0 * u / cfg.d_model \
        ** 0.5
    params = jax.tree.map(jnp.asarray, tree)
    return jcfg, params, cfg, lm_params_from_numpy(cfg, tree, device="cpu")


SLOTS = 32


def _serve(eng, prompts, max_new):
    reqs = [eng.submit(p, max_new=max_new) for p in prompts]
    eng.run()
    assert all(r.done for r in reqs)
    return [r.out for r in reqs]


def test_engine_at_32_slots_routes_each_slot_alone(monkeypatch):
    """32 slots (cap_e 24 for 32 tokens routed as one call, 8 for one),
    40 requests (every slot busy at first), a skewed router: the JAX
    engine's tokens.  The engine routed as one batch (moe_groups 1) drops
    rows of the later slots and serves other tokens."""
    jcfg, params, cfg, model = _skewed_engine_models()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(3, 9, 40)]
    ref = _serve(JaxServeEngine(jcfg, params, slots=SLOTS, max_seq=24),
                 prompts, 6)
    ours = _serve(ServeEngine(cfg, model, slots=SLOTS, max_seq=24), prompts,
                  6)
    assert ours == ref
    # the same engine with one capacity group for the batch
    from repro_torch.serve import engine as engine_mod
    step = engine_mod.make_decode_step
    monkeypatch.setattr(engine_mod, "make_decode_step",
                        lambda c, moe_groups: step(c, moe_groups=1))
    batched = _serve(ServeEngine(cfg, model, slots=SLOTS, max_seq=24),
                     prompts, 6)
    assert batched != ref


def test_training_a_moe_layout_raises():
    """A moe layout trains: make_train_step builds a step, and two steps
    give a finite loss and move the router and every expert's weights
    (the refusal is gone)."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import get_model
    from repro_torch.optim import adamw_init
    cfg = smoke_config(ARCH)
    model = get_model(cfg, device="cpu").init(0)
    before = {n: t.detach().clone() for n, t in model.named_leaves()}
    step = make_train_step(cfg, compress_grads=False)
    opt = adamw_init(dict(model.named_leaves()))
    data = SyntheticLMData(cfg.vocab_size, 2, 16, seed=2)
    for _ in range(2):
        model, opt, m = step(model, opt, data.next_batch())
    assert np.isfinite(float(m["loss"]))
    for n, t in model.named_leaves():
        if "/moe/" in n:
            assert not torch.equal(t.detach(), before[n]), n


def test_meshed_moe_forward_raises():
    """A mesh with a model axis larger than 1 asks for the reference's
    expert-parallel modes, which raise naming their ROADMAP item (model = 1
    is data parallelism: tests/test_torch_train_dp.py)."""
    from repro_torch.launch.mesh import Mesh
    cfg = smoke_config(ARCH)
    p, x = _moe_case(cfg, 8, seed=7)
    mesh = Mesh(("data", "model"), {"data": 1, "model": 2}, 0,
                torch.device("cpu"), "gloo")
    with pytest.raises(NotImplementedError,
                       match="expert parallelism over a RankGroup"):
        moe.moe_forward(cfg, *_port(p, x), mesh=mesh)


def test_recorded_combine_raises_on_the_card(monkeypatch):
    """A recorded combine no longer raises: it goes through `SegmentAdd`,
    whose forward calls the kernel's wrapper once (a spy around it here)
    and whose backward is the gather dy[src]; without grad mode it calls
    the wrapper directly and records nothing."""
    real = moe.segment_reduce
    calls = []

    def spy(*a):
        calls.append(a)
        return real(*a)
    monkeypatch.setattr(moe, "segment_reduce", spy)
    vals = torch.randn(6, 3, requires_grad=True)
    ids = torch.tensor([2, 0, 2, 1, 0, 2])
    out = moe.segment_add(vals, ids, 3)
    assert type(out.grad_fn).__name__ == "SegmentAddBackward"
    dy = torch.randn(3, 3)
    g, = torch.autograd.grad(out, vals, dy)
    assert torch.equal(g, dy[ids])
    with torch.no_grad():
        plain = moe.segment_add(vals, ids, 3)
    assert plain.grad_fn is None and torch.equal(plain, out.detach())
    assert len(calls) == 2


@pytest.mark.parametrize("arch", [ARCH, "arctic-480b"])
def test_converter_round_trips_expert_leaves(arch):
    jcfg, cfg = jax_smoke_config(arch), smoke_config(arch)
    tree = jax.tree.map(np.asarray, jax_get_model(jcfg).init(0))
    model = lm_params_from_numpy(cfg, tree, device="cpu")
    back = lm_params_to_numpy(cfg, model)
    experts = back["g0"]["s0_moe"]["moe"]
    assert experts["w_gate"].shape == (2, cfg.num_experts, cfg.d_model,
                                       cfg.moe_d_ff)
    assert ("mlp" in back["g0"]["s0_moe"]) == cfg.dense_residual

    def same(a, b):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], dict):
                same(a[k], b[k])
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    same(back, tree)
    model.load_tree(back)
    assert torch.equal(model.layers[1].moe.w_out,
                       torch.from_numpy(np.array(
                           tree["g0"]["s0_moe"]["moe"]["w_out"][1])))


def test_mrope_matches_reference_and_differs_from_rope():
    """M-RoPE as the reference computes it: the angle is the chosen
    stream's position itself, with no frequency factor."""
    r = np.random.default_rng(8)
    x = r.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos3 = r.integers(0, 50, (2, 7, 3)).astype(np.int32)
    sections = (2, 3, 3)
    want = jax_apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6, sections)
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), 1e6,
                      sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # the frequencies are left out: the same positions on every stream
    # are not RoPE's angles
    same = np.repeat(pos3[..., :1], 3, axis=-1)
    rope = apply_rope(torch.from_numpy(x), torch.from_numpy(same[..., 0]),
                      1e6)
    np.testing.assert_allclose(rope.numpy(), np.asarray(jax_apply_rope(
        jnp.asarray(x), jnp.asarray(same[..., 0]), 1e6)), rtol=1e-6,
        atol=1e-6)
    mrope = apply_mrope(torch.from_numpy(x), torch.from_numpy(same), 1e6,
                        sections)
    assert float((mrope - rope).abs().max()) > 0.1
    freqs = 1.0 / (1e6 ** (np.arange(0, 16, 2) / 16))
    ang = same[..., :1].astype(np.float64) * np.ones(8)      # no freqs
    x1, x2 = x[..., :8], x[..., 8:]
    c, s = np.cos(ang)[..., None, :], np.sin(ang)[..., None, :]
    np.testing.assert_allclose(
        mrope.numpy(), np.concatenate([x1 * c - x2 * s, x2 * c + x1 * s], -1),
        rtol=1e-5, atol=1e-5)
    assert not np.allclose(freqs, 1.0)
