"""The port's AdamW (`repro_torch.optim.adamw_update` over the multi-tensor
kernel's wrapper, `repro_torch.kernels.adamw`) against the JAX package's
`repro.optim.adamw`.

On the CPU the wrapper runs its plain versions: the global norm summed in
the kernel's order (`adamw_norm_plain`) and the per-leaf update.  The
kernel itself needs a card: the test marked `cuda` holds it bit-equal to
the plain versions and skips here.  It needs no jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_adamw.py
"""
import importlib

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from repro.optim.adamw import adamw_init as jax_adamw_init
    from repro.optim.adamw import adamw_update as jax_adamw_update
    from repro.optim.adamw import clip_by_global_norm as jax_clip
except ImportError:     # the card's machine: only the `cuda` test runs there
    pass
from repro_torch.optim.adamw import adamw_init, adamw_update, global_norm

# the module (the kernels package's `adamw` is the wrapper)
K = importlib.import_module("repro_torch.kernels.adamw")

TOL = 1e-6           # relative to each leaf's max |reference|
# leaves across the kernel's chunks: one short of a chunk, one of three
# chunks and a ragged tail, small ones
SHAPES = {"embed": (K.CHUNK - 3,), "w": (3, K.CHUNK + 77), "b": (37, 19),
          "norm": (5,)}


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _leaves(rng, scale=1.0, exact=False):
    """numpy float32 leaves of SHAPES.  `exact`: multiples of 2^-6 in
    [-1/4, 1/4], whose squares sum exactly in float32 in any order, so
    that both packages clip by the same scale whatever order each sums
    in (and bf16 leaves round alike)."""
    if exact:
        return {k: rng.integers(-16, 17, s).astype(np.float32) / 64
                for k, s in SHAPES.items()}
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _torch(tree, dtype):
    # a copy: the port updates in place, and numpy may share its buffer
    return {k: torch.from_numpy(v.copy()).to(dtype) for k, v in tree.items()}


def _jax(tree, dtype):
    return {k: jnp.asarray(v.copy()).astype(dtype) for k, v in tree.items()}


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32))


@pytest.mark.parametrize("clip", [0.01, 1e6], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("moments", ["f32", "bf16"])
@pytest.mark.parametrize("params", ["f32", "bf16"])
def test_adamw_update_matches_reference(params, moments, clip):
    """Two steps (the step counter in place) from the same leaves and
    gradients: parameters, both moments, grad_norm and lr within TOL."""
    rng = np.random.default_rng(len(params) + 3 * len(moments))
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}
    p0 = _leaves(rng, 0.1)
    grads = [_leaves(rng, exact=True) for _ in range(2)]
    tp, jp = _torch(p0, tdt[params]), _jax(p0, jdt[params])
    st = adamw_init(tp, tdt[moments])
    js = jax_adamw_init(jp, jdt[moments])
    for g in grads:
        _, st, m = adamw_update(tp, _torch(g, tdt[params]), st, lr=1e-3,
                                max_norm=clip)
        jp, js, jm = jax_adamw_update(jp, _jax(g, jdt[params]), js, lr=1e-3,
                                      max_norm=clip)
        assert _rel(_np(m["grad_norm"]), jm["grad_norm"]) <= TOL
        assert _rel(_np(m["lr"]), jm["lr"]) <= TOL
    assert int(st.step) == int(js.step) == 2
    for k in SHAPES:
        assert _rel(_np(tp[k]), jp[k].astype(jnp.float32)) <= TOL, k
        assert _rel(_np(st.mu[k]), js.mu[k].astype(jnp.float32)) <= TOL, k
        assert _rel(_np(st.nu[k]), js.nu[k].astype(jnp.float32)) <= TOL, k
        assert tp[k].dtype == tdt[params] and st.mu[k].dtype == tdt[moments]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunk_ordered_norm_matches_global_norm_and_reference(dtype):
    """The plain norm in the kernel's order against `global_norm` and the
    reference's `clip_by_global_norm` (norm and the clip scale), over
    enough chunks that the partials take more than one row of the final
    sum (THREADS of them)."""
    rng = np.random.default_rng(11)
    g = {"big": rng.standard_normal(K.CHUNK * K.THREADS + 5)
         .astype(np.float32), **_leaves(rng)}
    tg = _torch(g, dtype)
    gn, scale = K.adamw_norm_plain(list(tg.values()), 1.0)
    assert gn.dtype == scale.dtype == torch.float32 and gn.dim() == 0
    assert _rel(_np(gn), _np(global_norm(tg))) <= TOL
    clipped, jgn = jax_clip(_jax(g, jnp.bfloat16 if dtype == torch.bfloat16
                                 else jnp.float32), 1.0)
    assert _rel(_np(gn), jgn) <= TOL
    for k in SHAPES:
        assert _rel(_np(tg[k]) * _np(scale), clipped[k]) <= TOL, k


def test_clip_scale_of_a_small_norm_is_one():
    gn, scale = K.adamw_norm_plain([torch.full((10,), 1e-3)], 1.0)
    assert float(scale) == 1.0 and float(gn) > 0


def test_step_counter_is_one_tensor_incremented_in_place():
    rng = np.random.default_rng(2)
    p = _torch(_leaves(rng), torch.float32)
    st = adamw_init(p)
    step = st.step
    for i in range(3):
        _, st, _ = adamw_update(p, _torch(_leaves(rng), torch.float32), st,
                                lr=1e-3)
        assert st.step is step and int(step) == i + 1


def test_update_refuses_leaves_that_differ():
    with pytest.raises(ValueError):
        K.adamw([torch.zeros(4)], [], [], [], lr_t=torch.tensor(1e-3),
                b1t=torch.tensor(0.1), b2t=torch.tensor(0.05), b1=0.9,
                b2=0.95, eps=1e-8, weight_decay=0.1, max_norm=1.0)


# ---------------------------------------------------------------------------
# on the card: the kernel against its plain versions, bit for bit
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
def test_cuda_adamw_bit_equal_to_plain(cuda, moments):
    """Norm, clip scale, parameters and both moments bit-equal to the
    plain versions on the card, with bf16 and float32 leaves and float32
    and bf16 gradients mixed, two launches a call."""
    def state(seed):
        g = torch.Generator(device=cuda)
        g.manual_seed(seed)
        out = []
        for i, s in enumerate(SHAPES.values()):
            pdt = torch.bfloat16 if i % 2 else torch.float32
            out.append((
                (torch.randn(s, generator=g, device=cuda) * .02).to(pdt),
                torch.randn(s, generator=g, device=cuda).to(
                    torch.bfloat16 if i % 3 else torch.float32),
                (torch.randn(s, generator=g, device=cuda) * 1e-3)
                .to(moments),
                (torch.rand(s, generator=g, device=cuda) * 1e-6)
                .to(moments)))
        return [list(x) for x in zip(*out)]
    kw = dict(lr_t=torch.full((), 3e-4, device=cuda),
              b1t=1.0 - torch.pow(0.9, torch.full((), 3.0, device=cuda)),
              b2t=1.0 - torch.pow(0.95, torch.full((), 3.0, device=cuda)),
              b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, max_norm=1.0)
    got, want = state(7), state(7)
    before = K.adamw.launches
    gn, scale = K.adamw(*got, **kw)
    assert K.adamw.launches == before + 2
    pgn, pscale = K.adamw_plain(*want, **kw)
    torch.cuda.synchronize()
    assert torch.equal(gn, pgn) and torch.equal(scale, pscale)
    assert float(scale) < 1.0
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
