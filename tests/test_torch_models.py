"""The PyTorch port's LM against the JAX package's LM, on the CPU.

The reference's `model.init(0)` weights are carried across with
`lm_params_from_numpy`; the prompts come from numpy seeds.  Prefill
logits, every leaf of the prefilled cache and four decode steps' logits
must agree at rtol = atol = 1e-4 (float32 smoke configs: the port's
kernels run their plain versions here, and the JAX LM computes with jnp).
Prompt length 13 takes the SSM's single-chunk fallback (scan_chunk 8) and
a ragged attention tile.  The configs with QKV biases (qwen2-72b,
qwen2-vl-72b) get random nonzero biases in the JAX tree before it is
carried across: the reference initialises them to zero."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import get_model as jax_get_model
from repro.models.common import is_def
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.convert import (lm_cache_from_numpy, lm_cache_to_numpy,
                                 lm_params_from_numpy)
from repro_torch.models import LM, get_model
from repro_torch.models.lm import layer_slots

ARCHS = ["llama3-8b", "falcon-mamba-7b", "minitron-4b", "phi3-medium-14b",
         "qwen2-72b", "qwen3-moe-30b-a3b", "arctic-480b", "qwen2-vl-72b",
         "recurrentgemma-2b"]
# the reference's one encoder-decoder config (tests/test_torch_whisper.py)
AUDIO_ARCHS = ["whisper-tiny"]
TOL = dict(rtol=1e-4, atol=1e-4)
MAX_SEQ = 32


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def with_biases(params, seed=0):
    """The JAX tree with every QKV bias drawn from a seed (nonzero)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if str(getattr(path[-1], "key", "")) in ("bq", "bk", "bv"):
            return jnp.asarray(rng.standard_normal(leaf.shape) * 0.5,
                               leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(draw, params)


def _make_pair(arch):
    """(port cfg, JAX model, JAX params, port model with JAX's weights)."""
    jcfg = jax_smoke_config(arch)
    jm = jax_get_model(jcfg)
    params = jm.init(0)
    if jcfg.qkv_bias:
        params = with_biases(params)
    tree = jax.tree.map(np.asarray, params)
    cfg = smoke_config(arch)
    return cfg, jm, params, lm_params_from_numpy(cfg, tree, device="cpu")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _make_pair(request.param)


def test_configs_read_the_same():
    # all ten of the reference's architectures
    assert list_archs() == sorted(ARCHS + AUDIO_ARCHS)
    for arch in ARCHS + AUDIO_ARCHS:
        for ours, ref in ((get_config(arch), jax_get_config(arch)),
                          (smoke_config(arch), jax_smoke_config(arch))):
            a, b = vars(ours), vars(ref)
            assert a.keys() == b.keys()
            for k in a:
                if k in ("param_dtype", "compute_dtype", "cache_dtype"):
                    assert _dtype_name(a[k]) == jnp.dtype(b[k]).name, k
                else:
                    assert a[k] == b[k], k
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gemma-9b")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["smoke", "full"])
def test_param_tree_matches_reference_defs(arch, size):
    """After unstacking, the port's parameters are the reference's defs():
    the same leaves, shapes and dtypes (full size on the meta device)."""
    if size == "smoke":
        cfg, jcfg = smoke_config(arch), jax_smoke_config(arch)
        model = get_model(cfg, device="cpu").init(0)
    else:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        model = LM(cfg, device="meta")
    ref = dict(jax.tree_util.tree_flatten_with_path(
        jax_get_model(jcfg).defs(), is_leaf=is_def)[0])
    ref = {"/".join(str(getattr(k, "key", k)) for k in path): d
           for path, d in ref.items()}

    def same(p, d, shape, key):
        assert tuple(p.shape) == shape, key
        assert _dtype_name(p.dtype) == jnp.dtype(d.dtype).name, key
    # each layer module holds one stack entry of each of its group's leaves
    seen = {}
    for layer, (g, s, r, _) in zip(model.layers, layer_slots(cfg)):
        for path, p, pd in layer.leaves():
            key = f"{g}/{s}/{path}"
            same(p, ref[key], ref[key].shape[1:], key)
            assert pd.init == ref[key].init, key
            seen.setdefault(key, set()).add(r)
    top = {path: (p, pd) for path, p, pd in model.leaves()
           if not path.startswith("layers/")}
    for key, (p, pd) in top.items():
        same(p, ref[key], ref[key].shape, key)
        assert pd.init == ref[key].init, key
    assert seen.keys() | top.keys() == ref.keys()
    assert all(seen[k] == set(range(ref[k].shape[0])) for k in seen)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_the_reference_distributions(arch):
    cfg = smoke_config(arch).replace(d_model=256, d_ff=512)
    model = get_model(cfg, device="cpu").init(3)
    again = get_model(cfg, device="cpu").init(3)
    for (path, p, d), (_, q, _) in zip(model.leaves(), again.leaves()):
        assert torch.equal(p, q), path           # one seed, one model
        x = p.double()
        if d.init == "lecun":
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            assert abs(x.std().item() * fan_in ** 0.5 - 1) < 0.1, path
        elif d.init == "normal":
            assert abs(x.std().item() / 0.02 - 1) < 0.1, path
        elif d.init == "zeros":
            assert not x.any(), path
        elif d.init == "ones":
            assert (x == 1).all(), path
        elif d.init == "ssm_a":
            n = d.shape[-1]
            assert torch.allclose(x[0], torch.log(torch.arange(
                1, n + 1, dtype=torch.float64)), atol=1e-6), path
        elif d.init == "ssm_dt":
            dt = torch.nn.functional.softplus(x)
            assert dt.min() >= 1e-3 * 0.999 and dt.max() <= 0.1 * 1.001


@pytest.mark.parametrize("plen", [16, 13])
def test_prefill_and_decode_match_reference(pair, plen):
    cfg, jm, params, model = pair
    rng = np.random.default_rng(plen)
    tokens = rng.integers(0, cfg.vocab_size, (2, plen)).astype(np.int32)
    jl, jc = jm.prefill(params, jnp.asarray(tokens), MAX_SEQ)
    pl, pc = model.prefill(torch.as_tensor(tokens), MAX_SEQ)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    ref_cache = dict(_flat(jax.tree.map(np.asarray, jc)))
    ours_cache = dict(_flat(lm_cache_to_numpy(cfg, pc)))
    assert ours_cache.keys() == ref_cache.keys()
    for k, v in ref_cache.items():
        assert ours_cache[k].dtype == v.dtype, k
        np.testing.assert_allclose(ours_cache[k], v, **TOL, err_msg=k)
    for step in range(4):
        tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        pos = plen + step
        jl, jc = jm.decode(params, jc, jnp.asarray(tok),
                           jnp.asarray(pos, jnp.int32))
        pl, pc = model.decode(pc, torch.as_tensor(tok), pos)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {step}")


def test_decode_from_reference_cache(pair):
    """A cache carried across from JAX decodes like JAX, with a per-row
    position vector that a scalar position broadcasts to."""
    cfg, jm, params, model = pair
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    _, jc = jm.prefill(params, jnp.asarray(tokens), MAX_SEQ)
    cache = lm_cache_from_numpy(cfg, jax.tree.map(np.asarray, jc), "cpu")
    tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    jl, _ = jm.decode(params, jc, jnp.asarray(tok), jnp.asarray(10, jnp.int32))
    pl, _ = model.decode(cache, torch.as_tensor(tok), np.array([10, 10]))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)


def test_mrope_prefill_and_decode_match_reference():
    """qwen2-vl-72b with M-RoPE positions: three different streams from a
    seed in the prefill, then decode steps with positions of their own."""
    cfg, jm, params, model = _make_pair("qwen2-vl-72b")
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    pos3 = rng.integers(0, 40, (2, 11, 3)).astype(np.int32)
    jl, jc = jm.prefill(params, jnp.asarray(tokens), MAX_SEQ,
                        pos_ids=jnp.asarray(pos3))
    pl, pc = model.prefill(torch.as_tensor(tokens), MAX_SEQ,
                           pos_ids=torch.as_tensor(pos3))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    plain, _ = model.prefill(torch.as_tensor(tokens), MAX_SEQ)
    assert float((plain - pl).abs().max()) > 1e-3
    for k, v in _flat(jax.tree.map(np.asarray, jc)):
        np.testing.assert_allclose(dict(_flat(lm_cache_to_numpy(cfg, pc)))[k],
                                   v, **TOL, err_msg=k)
    for step in range(2):
        tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        p1 = rng.integers(0, 40, (2, 1, 3)).astype(np.int32)
        jl, jc = jm.decode(params, jc, jnp.asarray(tok),
                           jnp.asarray(11 + step, jnp.int32),
                           pos_ids=jnp.asarray(p1))
        pl, pc = model.decode(pc, torch.as_tensor(tok), 11 + step,
                              pos_ids=torch.as_tensor(p1))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {step}")


def test_init_draws_large_leaves_in_slices(monkeypatch):
    """A leaf above _SLICE_CELLS is drawn slice by slice of leading rows
    with the whole leaf's scale (lecun's fan-in from the full shape):
    the same distributions, the same numbers from one seed.  A leaf of at
    most _SLICE_CELLS cells is one float32 draw of its whole shape."""
    from repro_torch.models import common
    cfg = smoke_config("arctic-480b").replace(d_model=256, d_ff=512,
                                              moe_d_ff=128)
    monkeypatch.setattr(common, "_SLICE_CELLS", 2 ** 13)
    model = get_model(cfg, device="cpu").init(3)
    again = get_model(cfg, device="cpu").init(3)
    big = small = 0
    for (path, p, d), (_, q, _) in zip(model.leaves(), again.leaves()):
        assert torch.equal(p, q), path
        if d.init not in ("lecun", "normal"):
            continue
        want = 0.02 if d.init == "normal" else 1.0 / d.shape[-2] ** 0.5
        if p.numel() > 2 ** 13:
            big += 1
            assert abs(p.double().std().item() / want - 1) < 0.05, path
            # the slices are not copies of one another
            assert not torch.equal(p[0], p[-1]), path
        else:
            small += 1
            x = torch.randn(d.shape, dtype=torch.float32, generator=(
                common.generator_for(3, path, "cpu")))
            assert torch.equal(p, x.mul_(want).to(d.dtype)), path
    assert big >= 5 and small >= 1


def test_converter_refuses_a_wrong_tree():
    cfg = smoke_config("llama3-8b")
    tree = jax.tree.map(np.asarray, jax_get_model(
        jax_smoke_config("llama3-8b")).init(0))
    tree["lm_head"] = tree["lm_head"][:, :-1]
    with pytest.raises(ValueError, match="lm_head"):
        lm_params_from_numpy(cfg, tree, device="cpu")
    tree = jax.tree.map(np.asarray, jax_get_model(
        jax_smoke_config("llama3-8b")).init(0))
    tree["g0"]["s0_dense"]["attn"]["bq"] = np.zeros((2, 64), np.float32)
    with pytest.raises(ValueError, match="bq"):
        lm_params_from_numpy(cfg, tree, device="cpu")


@pytest.mark.parametrize("kind", ["rec", "lattn"])
def test_unported_layer_kinds_raise(kind):
    # the rec and lattn kinds are ported: a layout of one builds; a kind
    # the reference does not have raises
    cfg = smoke_config("recurrentgemma-2b").replace(layout=(((kind,), 1),))
    assert get_model(cfg, device="cpu").kinds == [kind]
    with pytest.raises(ValueError, match=f"{kind}x"):
        get_model(cfg.replace(layout=(((kind + "x",), 1),)), device="cpu")


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model(smoke_config("llama3-8b"))


def _ssm_case(x_dtype):
    """Seeded SSM weights and conv'd activations for the smoke mamba
    layer, as numpy (x rounded to bf16 when asked, so both packages see
    the same values)."""
    cfg = smoke_config("falcon-mamba-7b")
    di, n, dtr = cfg.d_inner, cfg.ssm_state, cfg.ssm_dt_rank
    r = np.random.default_rng(11)
    p = {"x_proj": r.standard_normal((di, dtr + 2 * n)) * di ** -0.5,
         "dt_proj": r.standard_normal((dtr, di)) * dtr ** -0.5,
         "dt_bias": r.uniform(-4.0, -2.0, di),
         "a_log": np.log(np.tile(np.arange(1, n + 1), (di, 1)))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = torch.from_numpy(r.standard_normal((2, 24, di)).astype(np.float32))
    if x_dtype == "bfloat16":
        x = x.bfloat16()
    return cfg, p, x


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_fused_scan_matches_discretise_then_scan(x_dtype):
    """The fused entry (the model's prefill path) equals the port's
    `_ssm_params` followed by the plain scan, and the JAX package's
    `_ssm_params` followed by its Pallas `selective_scan` (interpret mode),
    to 1e-5·max|ref|."""
    from repro.kernels.selective_scan import selective_scan as jax_scan
    from repro.models.ssm import _ssm_params as jax_ssm_params
    from repro_torch.kernels.selective_scan import (selective_scan_fused,
                                                    selective_scan_plain)
    from repro_torch.models.ssm import _ssm_inputs, _ssm_params
    cfg, p, x = _ssm_case(x_dtype)
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    dt, a, bt, ct = _ssm_inputs(cfg, pt, x)
    got = selective_scan_fused(dt, a, bt, ct, x)
    want = selective_scan_plain(*_ssm_params(cfg, pt, x))
    tol = 1e-5 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol
    xj = jnp.asarray(x.float().numpy())
    if x_dtype == "bfloat16":
        xj = xj.astype(jnp.bfloat16)
    da, db, cj = jax_ssm_params(jax_smoke_config("falcon-mamba-7b"),
                                {k: jnp.asarray(v) for k, v in p.items()}, xj)
    ref = np.asarray(jax_scan(da, db, cj, bd=64, bk=8))
    tol = 1e-5 * float(np.abs(ref).max())
    assert float(np.abs(got.numpy() - ref).max()) <= tol


@pytest.mark.parametrize("plen", [21, 24])
def test_mamba_forward_chunks_carry_the_state(plen):
    """The CPU prefill scans in chunks of `scan_chunk` (8) carried through
    the state, or in one when 8 does not divide the prompt; both match the
    JAX layer."""
    cfg, jm, params, model = _make_pair("falcon-mamba-7b")
    rng = np.random.default_rng(plen)
    tokens = rng.integers(0, cfg.vocab_size, (2, plen)).astype(np.int32)
    jl, jc = jm.prefill(params, jnp.asarray(tokens), MAX_SEQ)
    pl, pc = model.prefill(torch.as_tensor(tokens), MAX_SEQ)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    ref_cache = dict(_flat(jax.tree.map(np.asarray, jc)))
    ours_cache = dict(_flat(lm_cache_to_numpy(cfg, pc)))
    for k, v in ref_cache.items():
        np.testing.assert_allclose(ours_cache[k], v, **TOL, err_msg=k)
