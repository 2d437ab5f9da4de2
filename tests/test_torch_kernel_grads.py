"""The backward of the port's two LM kernels against the JAX package.

The reference's Pallas kernels have no backward: it trains by jax.grad of
the jnp forms.  So each plain backward and each autograd Function of
`repro_torch.kernels` runs here on the CPU against `jax.vjp` of the
reference's oracles: `flash_attention_ref` (causal and not, ragged
lengths, and GQA through the models' `_repeat_kv` against the reference's
`_attend`), and `selective_scan_ref` composed with the reference's
discretisation (`models/ssm.py`, `_ssm_params`), or the reference's chunk
recurrence (`associative_scan` from h0, as its `mamba_forward` computes a
chunk) where h0 and the final state's gradient dh_last come in.  Inputs
come from numpy seeds.  Tolerance: max |got − want| / max |want| ≤ 1e-5
per gradient, float32 (the same math summed in another order); a bf16 dx
is compared at 8e-3 (one bf16 rounding, 2^-8 relative, of float32 values
that differ in their last bits).

The CUDA kernels need a card: the tests marked `cuda` hold them against
their plain versions and skip here.  They need no jax, so on the machine
with the card they run alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernel_grads.py
"""
import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from repro.kernels.flash_attention_ref import flash_attention_ref
    from repro.kernels.selective_scan_ref import selective_scan_ref
    from repro.models.attention import _attend
    from repro.models.ssm import _assoc
except ImportError:     # the card's machine: only the `cuda` tests run there
    pass
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_plain)
from repro_torch.kernels.selective_scan import (SelectiveScanFused,
                                                _fused_launch,
                                                selective_scan_fused_bwd,
                                                selective_scan_fused_bwd_plain,
                                                selective_scan_fused_grad,
                                                selective_scan_fused_plain)
from repro_torch.models.attention import attention_core

TOL = 1e-5          # float32, max-normalised
TOL_BF16 = 8e-3     # a bf16 result: one rounding of float32 values


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _err(got, want):
    got = np.asarray(torch.as_tensor(got).float(), np.float64) \
        if torch.is_tensor(got) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

FLASH_SHAPES = [(2, 64, 64, 16), (3, 13, 13, 16), (2, 20, 45, 32),
                (1, 77, 77, 64)]


def _flash_inputs(seed, bh, sq, sk, hd):
    r = np.random.default_rng(seed)
    q, k, v = (r.standard_normal((bh, s, hd)).astype(np.float32)
               for s in (sq, sk, sk))
    do = r.standard_normal((bh, sq, hd)).astype(np.float32)
    return q, k, v, do


def _jax_flash_vjp(q, k, v, do, causal):
    out, vjp = jax.vjp(lambda a, b, c: flash_attention_ref(a, b, c, causal),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,sq,sk,hd", FLASH_SHAPES)
def test_flash_bwd_plain_matches_jax_vjp(bh, sq, sk, hd, causal):
    q, k, v, do = _flash_inputs(sq + sk + hd, bh, sq, sk, hd)
    out, want = _jax_flash_vjp(q, k, v, do, causal)
    o, lse = flash_attention_plain(_t(q), _t(k), _t(v), causal=causal,
                                   return_lse=True)
    assert _err(o, out) <= TOL
    got = flash_attention_bwd_plain(_t(q), _t(k), _t(v), o, lse, _t(do),
                                    causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _err(g, w) <= TOL, name


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,sq,sk,hd", FLASH_SHAPES[:3])
def test_flash_function_cpu_matches_jax_vjp(bh, sq, sk, hd, causal):
    # the Function's wiring: its forward and backward on CPU tensors
    q, k, v, do = _flash_inputs(7 * sq + hd, bh, sq, sk, hd)
    out, want = _jax_flash_vjp(q, k, v, do, causal)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    o = FlashAttention.apply(tq, tk, tv, causal)
    assert _err(o.detach(), out) <= TOL
    got = torch.autograd.grad(o, (tq, tk, tv), _t(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _err(g, w) <= TOL, name


@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 1), (2, 2)])
def test_attention_core_gqa_grads_match_reference(hq, hkv):
    """The models' attention_core (heads repeated by `_repeat_kv`, the
    Function on [B·Hq, S, hd]) against jax.vjp of the reference's
    `_attend`: dK and dV sum over each group of query heads."""
    r = np.random.default_rng(hq * 10 + hkv)
    b, s, hd = 2, 19, 16
    q = r.standard_normal((b, s, hq, hd)).astype(np.float32)
    k, v = (r.standard_normal((b, s, hkv, hd)).astype(np.float32)
            for _ in range(2))
    do = r.standard_normal((b, s, hq, hd)).astype(np.float32)
    pos = jnp.arange(s)
    out, vjp = jax.vjp(lambda a, c, e: _attend(a, c, e, pos, pos,
                                               causal=True, window=0),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    o = attention_core(tq, tk, tv, causal=True)
    assert _err(o.detach(), np.asarray(out)) <= TOL
    got = torch.autograd.grad(o, (tq, tk, tv), _t(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        assert _err(g, np.asarray(w)) <= TOL, name


def test_flash_grad_path_only_when_autograd_records():
    """Serving (no grad) calls the forward without lse, as before; the
    Function is taken only when autograd records."""
    from repro_torch.kernels.flash_attention import flash_attention_grad
    q = torch.randn(2, 9, 16)
    with torch.no_grad():
        a = flash_attention_grad(q.requires_grad_(), q, q)
    assert a.grad_fn is None
    assert torch.equal(a, flash_attention(q.detach(), q.detach(), q.detach()))
    b = flash_attention_grad(q, q, q)
    assert type(b.grad_fn).__name__ == "FlashAttentionBackward"
    assert torch.equal(a, b.detach())


# ---------------------------------------------------------------------------
# selective_scan (the fused entry)
# ---------------------------------------------------------------------------

SCAN_SHAPES = [(2, 11, 6, 4), (1, 16, 8, 16), (2, 33, 5, 2), (1, 7, 3, 1)]


def _scan_inputs(seed, b, s, d, n):
    r = np.random.default_rng(seed)
    # dt after softplus: positive; A = -exp(a_log): negative
    dt = np.log1p(np.exp(r.standard_normal((b, s, d)) - 2.0)) \
        .astype(np.float32)
    A = -np.exp(r.standard_normal((d, n)) * 0.5).astype(np.float32)
    Bm, Cm = (r.standard_normal((b, s, n)).astype(np.float32)
              for _ in range(2))
    x = r.standard_normal((b, s, d)).astype(np.float32)
    h0 = r.standard_normal((b, d, n)).astype(np.float32)
    dy = r.standard_normal((b, s, d)).astype(np.float32)
    dh = r.standard_normal((b, d, n)).astype(np.float32)
    return dt, A, Bm, Cm, x, h0, dy, dh


def _discretise(dt, A, Bm, x):
    """The reference's `_ssm_params` discretisation."""
    da = jnp.exp(dt[..., None] * A)
    db = (dt * x.astype(jnp.float32))[..., None] * Bm[..., None, :]
    return da, db


def _ref_chunk(dt, A, Bm, Cm, x, h0):
    """The reference's chunk recurrence from h0 (its mamba_forward's
    chunk_fn): (y, h_last)."""
    da, db = _discretise(dt, A, Bm, x)
    a_cum, b_cum = jax.lax.associative_scan(_assoc, (da, db), axis=1)
    h_all = a_cum * h0[:, None] + b_cum
    return jnp.einsum("bcdn,bcn->bcd", h_all, Cm), h_all[:, -1]


def _ref_from_zero(dt, A, Bm, Cm, x):
    da, db = _discretise(dt, A, Bm, x)
    return selective_scan_ref(da, db, Cm)


def _jax_scan_vjp(dt, A, Bm, Cm, x, h0, dy, dh):
    args = [jnp.asarray(a) for a in (dt, A, Bm, Cm)] + [x]
    if h0 is None:
        out, vjp = jax.vjp(_ref_from_zero, *args)
        grads = vjp(jnp.asarray(dy))
        return out, None, list(grads) + [None]
    out, vjp = jax.vjp(_ref_chunk, *args, jnp.asarray(h0))
    y, h_last = out
    return y, h_last, list(vjp((jnp.asarray(dy), jnp.asarray(dh))))


def _check_scan_grads(got, want, x_bf16):
    names = ("ddt", "dA", "dBm", "dCm", "dx", "dh0")
    for name, g, w in zip(names, got, want):
        if w is None:
            continue
        tol = TOL_BF16 if (name == "dx" and x_bf16) else TOL
        assert _err(g, np.asarray(w, np.float32)) <= tol, name


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("b,s,d,n", SCAN_SHAPES)
def test_scan_bwd_plain_matches_jax_vjp(b, s, d, n, with_h0, x_dtype):
    dt, A, Bm, Cm, x, h0, dy, dh = _scan_inputs(b * s + d * n, b, s, d, n)
    if not with_h0:
        h0 = dh = None
    jx = jnp.asarray(x).astype(x_dtype)
    tx = _t(x).to(getattr(torch, x_dtype))
    y, h_last, want = _jax_scan_vjp(dt, A, Bm, Cm, jx, h0, dy, dh)
    th0 = None if h0 is None else _t(h0)
    ty, th = selective_scan_fused_plain(_t(dt), _t(A), _t(Bm), _t(Cm), tx,
                                        th0, return_state=True)
    assert _err(ty, np.asarray(y)) <= TOL
    if h_last is not None:
        assert _err(th, np.asarray(h_last)) <= TOL
    got = selective_scan_fused_bwd_plain(
        _t(dt), _t(A), _t(Bm), _t(Cm), tx, th0, _t(dy),
        None if dh is None else _t(dh))
    assert got[4].dtype == tx.dtype and got[5].shape == (b, d, n)
    _check_scan_grads(got, want, x_dtype == "bfloat16")


@pytest.mark.parametrize("b,s,d,n", SCAN_SHAPES[:2])
def test_scan_function_cpu_matches_jax_vjp(b, s, d, n):
    # the Function's wiring: y and h_last both carry a gradient, as the
    # CPU path's chunks chain through h
    dt, A, Bm, Cm, x, h0, dy, dh = _scan_inputs(31 + s, b, s, d, n)
    _, _, want = _jax_scan_vjp(dt, A, Bm, Cm, jnp.asarray(x), h0, dy, dh)
    ins = [_t(a).requires_grad_() for a in (dt, A, Bm, Cm, x, h0)]
    y, h_last = SelectiveScanFused.apply(*ins)
    got = torch.autograd.grad((y, h_last), ins, (_t(dy), _t(dh)))
    _check_scan_grads(got, want, False)


def test_scan_function_two_chunks_chain_through_h():
    """Two chunks through the Function, the second from the first's
    h_last (the CPU path of mamba_forward), against one whole call."""
    dt, A, Bm, Cm, x, h0, dy, _ = _scan_inputs(5, 2, 16, 4, 4)
    whole = [_t(a).requires_grad_() for a in (dt, A, Bm, Cm, x)]
    y = selective_scan_fused_grad(*whole)
    gw = torch.autograd.grad(y, whole, _t(dy))
    parts = [_t(a).requires_grad_() for a in (dt, A, Bm, Cm, x)]
    ys, h = [], None
    for c0 in (0, 8):
        sl = [t[:, c0:c0 + 8] if t.dim() == 3 else t for t in parts]
        y_c, h = selective_scan_fused_grad(*sl, h, return_state=True)
        ys.append(y_c)
    gp = torch.autograd.grad(torch.cat(ys, 1), parts, _t(dy))
    for a, b_ in zip(gw, gp):
        assert _err(b_, a.numpy()) <= TOL


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (need a card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    return torch.device("cuda")


def _card_flash(cuda, seed, bh, sq, sk, hd, dtype, causal):
    q, k, v, do = (_t(a).to(cuda, dtype)
                   for a in _flash_inputs(seed, bh, sq, sk, hd))
    o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    return q, k, v, do, o, lse


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,sq,sk,hd", [(3, 77, 77, 64), (2, 130, 130, 128),
                                         (2, 50, 97, 32), (2, 97, 50, 16),
                                         (1, 1, 1, 16), (4, 256, 256, 128)])
def test_cuda_flash_bwd_matches_plain(cuda, bh, sq, sk, hd, dtype, causal):
    """bf16 rounds P and dS to bf16 for the tensor cores: 2e-2 of max|ref|
    per gradient; float32 1e-4 (sums in another order, expf).  Both with
    an absolute floor of 1e-6, for a gradient that vanishes in exact
    arithmetic (one key: dS = P·(dP − D) = 0, and dq is rounding noise)."""
    q, k, v, do, o, lse = _card_flash(cuda, sq * 3 + hd, bh, sq, sk, hd,
                                      dtype, causal)
    # the lse entry writes the same output bits as the serving entry
    assert torch.equal(o, flash_attention(q, k, v, causal=causal))
    wo, wlse = flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    assert float((lse - wlse).abs().max()) <= 1e-2 * max(
        1.0, float(wlse.abs().max()))
    before = ops.launch_counts()["flash_attention_bwd"]
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    assert ops.launch_counts()["flash_attention_bwd"] == before + 1
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        e = float((g.float() - w.float()).abs().max())
        assert e <= max(tol * float(w.float().abs().max()), 1e-6), (name, e)
    again = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    for g, h in zip(got, again):
        assert torch.equal(g, h)       # no atomics: the same bits


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,d,n", [(2, 37, 45, 16), (1, 16, 32, 16),
                                     (2, 100, 70, 1), (1, 33, 40, 2),
                                     (1, 64, 33, 4), (2, 20, 64, 8),
                                     (1, 50, 96, 32), (1, 1, 5, 16)])
def test_cuda_scan_bwd_matches_plain(cuda, b, s, d, n, x_dtype):
    """From the forward's checkpoint states, with h0 and dh_last, ragged S
    (16-step chunks) and D (32-channel blocks), every N: 1e-4 of
    max|ref| (exp2f of a pre-scaled argument; sums in another order); a
    bf16 dx at 8e-3 (one bf16 rounding)."""
    dt, A, Bm, Cm, x, h0, dy, dh = (
        _t(a).to(cuda) for a in _scan_inputs(s + d + n, b, s, d, n))
    x = x.to(x_dtype)
    ins = [t.requires_grad_() for t in (dt, A, Bm, Cm, x, h0)]
    before = ops.launch_counts()["selective_scan_bwd"]
    y, h_last = SelectiveScanFused.apply(*ins)
    got = torch.autograd.grad((y, h_last), ins, (dy, dh))
    assert ops.launch_counts()["selective_scan_bwd"] == before + 1
    want = selective_scan_fused_bwd_plain(
        *(t.detach() for t in ins), dy, dh)
    for name, g, w in zip(("ddt", "dA", "dBm", "dCm", "dx", "dh0"), got,
                          want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        tol = 8e-3 if (name == "dx" and x_dtype == torch.bfloat16) else 1e-4
        e = float((g.float() - w.float()).abs().max())
        assert e <= tol * float(w.float().abs().max()), (name, e)
    y2, h2, states = _fused_launch(*(t.detach() for t in ins), True, True)
    assert torch.equal(y2, y.detach()) and torch.equal(h2, h_last.detach())
    again = selective_scan_fused_bwd(*(t.detach() for t in ins), dy, dh,
                                     states=states)
    for g, h in zip(got, again):
        assert torch.equal(g, h)       # no atomics: the same bits


def _flash_bwd_check(cuda, seed, bh, sq, sk, hd, causal):
    """The bf16 backward against its plain version (2e-2 of max|ref|, an
    absolute floor of 1e-6) and a second launch bit-equal."""
    q, k, v, do, o, lse = _card_flash(cuda, seed, bh, sq, sk, hd,
                                      torch.bfloat16, causal)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        e = float((g.float() - w.float()).abs().max())
        assert e <= max(2e-2 * float(w.float().abs().max()), 1e-6), (name, e)
    again = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    for g, h in zip(got, again):
        assert torch.equal(g, h)       # the ordered dQ sums: the same bits


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("sq,sk", [(129, 257), (257, 129)])
def test_cuda_flash_bwd_ragged_tiles(cuda, sq, sk, hd, causal):
    """Sq and Sk that no 64-query tile or 128-key block divides, Sq ≠ Sk,
    every head width (hd 128 and hd 64 causal take the one-pass wgmma
    kernel, hd 64 not causal the split route's dK/dV and dQ blocks, 16
    and 32 the two mma.sync kernels)."""
    _flash_bwd_check(cuda, sq + 7 * sk + hd, 2, sq, sk, hd, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [64, 128])
def test_cuda_flash_bwd_ordered_dq(cuda, hd, causal):
    """Five 128-key blocks add to each late query tile of dQ (all of them
    when not causal), each waiting its turn on the tile's flag: the sum
    within tolerance and bit-equal on a second launch.  hd 64 not causal
    takes the split route (dQ in blocks of its own, no flags): the same
    checks."""
    _flash_bwd_check(cuda, 11 + hd, 3, 640, 640, hd, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 32])
def test_cuda_scan_bwd_ragged_chunks(cuda, n):
    """S (45) no 16-step chunk divides and D (130) no block of channels
    divides, with h0 and dh_last, every N: 1e-4 of max|ref|, a second
    launch bit-equal."""
    b, s, d = 2, 45, 130
    dt, A, Bm, Cm, x, h0, dy, dh = (
        _t(a).to(cuda) for a in _scan_inputs(3 * n, b, s, d, n))
    y, h_last, states = _fused_launch(dt, A, Bm, Cm, x, h0, True, True)
    got = selective_scan_fused_bwd(dt, A, Bm, Cm, x, h0, dy, dh,
                                   states=states)
    want = selective_scan_fused_bwd_plain(dt, A, Bm, Cm, x, h0, dy, dh)
    for name, g, w in zip(("ddt", "dA", "dBm", "dCm", "dx", "dh0"), got,
                          want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        e = float((g.float() - w.float()).abs().max())
        assert e <= 1e-4 * float(w.float().abs().max()), (name, e)
    again = selective_scan_fused_bwd(dt, A, Bm, Cm, x, h0, dy, dh,
                                     states=states)
    for g, h in zip(got, again):
        assert torch.equal(g, h)


@pytest.mark.cuda
def test_cuda_functions_match_cpu_functions(cuda):
    """The Functions on the card against the same Functions on the CPU
    (their plain versions), float32: the wiring is the same."""
    q, k, v, do = _flash_inputs(3, 2, 70, 70, 32)
    cpu = [_t(a).requires_grad_() for a in (q, k, v)]
    gpu = [_t(a).to(cuda).requires_grad_() for a in (q, k, v)]
    gc = torch.autograd.grad(FlashAttention.apply(*cpu, True), cpu, _t(do))
    gg = torch.autograd.grad(FlashAttention.apply(*gpu, True), gpu,
                             _t(do).to(cuda))
    for a, b_ in zip(gc, gg):
        assert _err(b_.cpu(), a.numpy()) <= 1e-4
    dt, A, Bm, Cm, x, h0, dy, dh = _scan_inputs(9, 2, 40, 36, 16)
    cpu = [_t(a).requires_grad_() for a in (dt, A, Bm, Cm, x, h0)]
    gpu = [_t(a).to(cuda).requires_grad_() for a in (dt, A, Bm, Cm, x, h0)]
    gc = torch.autograd.grad(SelectiveScanFused.apply(*cpu), cpu,
                             (_t(dy), _t(dh)))
    gg = torch.autograd.grad(SelectiveScanFused.apply(*gpu), gpu,
                             (_t(dy).to(cuda), _t(dh).to(cuda)))
    for a, b_ in zip(gc, gg):
        assert _err(b_.cpu(), a.numpy()) <= 1e-4


# ---------------------------------------------------------------------------
# the backwards the moe, hybrid and audio families train through (need a
# card): the flash backward within a window and at hd 256, the scan's
# (a, bx) backward at N = 1, the recorded forms of the three layers
# ---------------------------------------------------------------------------

def _flash_bwd_window_check(cuda, seed, bh, sq, sk, hd, dtype, causal,
                            window):
    """The backward with `window` against its plain version (bf16 2e-2,
    float32 1e-4 of max|ref|, an absolute floor of 1e-6), and a second
    launch bit-equal."""
    q, k, v, do = (_t(a).to(cuda, dtype)
                   for a in _flash_inputs(seed, bh, sq, sk, hd))
    o, lse = flash_attention(q, k, v, causal=causal, window=window,
                             return_lse=True)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                              window=window)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                     window=window)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        if window == 1 and name != "dv":
            # one key a query: P = 1 and dS = dP − D = 0 in exact
            # arithmetic, so dq and dk are the rounding of that difference
            # (two float32 sums of hd products of about 1) on both sides
            assert float(g.float().abs().max()) <= 1e-5, name
            assert float(w.float().abs().max()) <= 1e-5, name
            continue
        e = float((g.float() - w.float()).abs().max())
        assert e <= max(tol * float(w.float().abs().max()), 1e-6), (name, e)
    again = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                window=window)
    for g, h in zip(got, again):
        assert torch.equal(g, h)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s,window", [(3, 300, 64), (2, 130, 100),
                                         (1, 97, 16), (2, 70, 2048),
                                         (2, 65, 1)])
def test_cuda_flash_bwd_window_hd256(cuda, dtype, bh, s, window):
    """recurrentgemma-2b's lattn form, hd 256, causal within a window:
    S past the window (the band's first and last tiles), a window past S
    (every causal key), a window of 1 (the diagonal alone), ragged S."""
    _flash_bwd_window_check(cuda, s + window, bh, s, s, 256, dtype, True,
                            window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(77, 77), (129, 300), (300, 129)])
def test_cuda_flash_bwd_hd256(cuda, dtype, causal, sq, sk):
    """hd 256 without a window: causal and not, Sq != Sk, ragged."""
    _flash_bwd_window_check(cuda, sq * sk, 2, sq, sk, 256, dtype, causal, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [2048, 1000])
def test_cuda_flash_bwd_hd256_training_shape(cuda, window):
    """A recurrentgemma-2b microbatch's lattn layer, [10, 4096, 256] bf16
    causal, on hd 256's dK/dV and dQ blocks: its 2048-key window, and a
    window that 64 does not divide (its edge inside a tile)."""
    _flash_bwd_window_check(cuda, window, 10, 4096, 4096, 256,
                            torch.bfloat16, True, window)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,dtype,wg", [(256, torch.bfloat16, 1),
                                         (128, torch.bfloat16, 1),
                                         (64, torch.bfloat16, 1),
                                         (32, torch.bfloat16, 0),
                                         (256, torch.float32, 0)])
def test_cuda_flash_bwd_counts_the_wgmma_route(cuda, hd, dtype, wg):
    """"flash_attention_bwd[wg]" counts each launch of the backward's wgmma
    routes (bf16 at hd 64, 128 and 256), within flash_attention_bwd's own
    count, and no other (causal here: the one-pass kernel at hd 64;
    tests/test_torch_flash_split.py counts the split route's)."""
    q, k, v, do = (_t(a).to(cuda, dtype)
                   for a in _flash_inputs(hd, 2, 100, 100, hd))
    o, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    before = ops.launch_counts()
    flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    after = ops.launch_counts()
    assert after["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    assert after["flash_attention_bwd[wg]"] == \
        before["flash_attention_bwd[wg]"] + wg


@pytest.mark.cuda
@pytest.mark.parametrize("hd,dtype", [(16, torch.bfloat16),
                                      (32, torch.bfloat16),
                                      (64, torch.float32),
                                      (128, torch.float32)])
def test_cuda_flash_bwd_window_other_head_dims(cuda, hd, dtype):
    """Where no model trains a window, it works (bf16 hd 16 and 32 on
    mma.sync, float32 at every hd), or raises ValueError (bf16 hd 64 and
    128, the wgmma kernel): never a result without the mask."""
    _flash_bwd_window_check(cuda, hd, 2, 150, 150, hd, dtype, True, 40)
    if dtype == torch.float32:
        q = torch.randn(2, 40, hd, device=cuda, dtype=torch.bfloat16)
        o, lse = flash_attention(q, q, q, window=8, return_lse=True)
        with pytest.raises(ValueError, match="no window in the bf16"):
            flash_attention_bwd(q, q, q, o, lse, q, window=8)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk", [(45, 1500), (1500, 1500)])
def test_cuda_flash_bwd_whisper_shapes(cuda, sq, sk):
    """whisper-tiny's cross-attention (Sq tokens on 1500 frames) and its
    encoder (1500 on 1500), non-causal, 6 heads of 64, bf16: ragged last
    tiles (1500 is no multiple of 64 or 128)."""
    _flash_bwd_window_check(cuda, sq + sk, 6, sq, sk, 64, torch.bfloat16,
                            False, 0)


def _abx_inputs(seed, b, s, d, cuda):
    r = np.random.default_rng(seed)
    a = np.exp(-np.abs(r.standard_normal((b, s, d)))).astype(np.float32)
    h, dy = (r.standard_normal((b, s, d)).astype(np.float32)
             for _ in range(2))
    h0, dh = (r.standard_normal((b, d)).astype(np.float32)
              for _ in range(2))
    return [_t(x).to(cuda) for x in (a, h, h0, dy, dh)]


@pytest.mark.cuda
@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("b,s,d", [(1, 2048, 2560), (2, 77, 300),
                                   (3, 1, 40), (2, 33, 1), (1, 0, 8)])
def test_cuda_abx_bwd_matches_plain(cuda, b, s, d, with_state):
    """The (a, bx) entry's backward at N = 1 against its plain version:
    each sum and product rounded on its own in both, so within 1e-6 of
    max|ref|; one launch counted; a second launch bit-equal."""
    from repro_torch.kernels.selective_scan import (selective_scan_bwd,
                                                    selective_scan_bwd_plain)
    a, h, h0, dy, dh = _abx_inputs(s * d + b, b, s, d, cuda)
    if not with_state:
        h0 = dh = None
    before = ops.launch_counts()["selective_scan_bwd[a, bx]"]
    got = selective_scan_bwd(a, h, h0, dy, dh)
    assert ops.launch_counts()["selective_scan_bwd[a, bx]"] == before + 1
    want = selective_scan_bwd_plain(a, h, h0, dy, dh)
    for name, g, w in zip(("da", "dbx", "dh0"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        if w.numel():
            e = float((g - w).abs().max())
            assert e <= 1e-6 * max(float(w.abs().max()), 1e-30), (name, e)
    again = selective_scan_bwd(a, h, h0, dy, dh)
    for g, w in zip(got, again):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 64, 65, 4096])
def test_cuda_abx_bwd_chunk_edges(cuda, s):
    """The chunked (a, bx) backward at the edges of its chunks (S = 1, a
    chunk exactly, a chunk and one step, 4096 steps in 32 chunks of 128)
    over ragged blocks of channels, with a in [0.9, 0.999] (the RG-LRU's
    gates): the plain version's bits (the same chunk order, each
    operation rounded alone), and the same bits on a second launch."""
    from repro_torch.kernels.selective_scan import (selective_scan_bwd,
                                                    selective_scan_bwd_plain)
    b, d = 2, 300
    a, h, h0, dy, dh = _abx_inputs(s + 1, b, s, d, cuda)
    a = 0.9 + 0.099 * a
    got = selective_scan_bwd(a, h, h0, dy, dh)
    want = selective_scan_bwd_plain(a, h, h0, dy, dh)
    again = selective_scan_bwd(a, h, h0, dy, dh)
    for name, g, w, g2 in zip(("da", "dbx", "dh0"), got, want, again):
        assert torch.equal(g, w), name
        assert torch.equal(g, g2), name


@pytest.mark.cuda
def test_cuda_scan_function_and_rglru_match_cpu(cuda):
    """SelectiveScan on the card against the same Function on the CPU,
    and the RG-LRU layer's gradients (smoke widths, float32, with h0 and
    the final state's gradient), within 1e-4 of max|ref|; N > 1 raises on
    the card."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels.selective_scan import (SelectiveScan,
                                                    selective_scan_grad)
    from repro_torch.models import recurrent as rec
    r = np.random.default_rng(8)
    a = np.exp(-np.abs(r.standard_normal((2, 50, 30, 1)))).astype(np.float32)
    bx = r.standard_normal((2, 50, 30, 1)).astype(np.float32)
    h0 = r.standard_normal((2, 30, 1)).astype(np.float32)
    dy = r.standard_normal((2, 50, 30)).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda):
        ins = [_t(x).to(dev).requires_grad_() for x in (a, bx, h0)]
        y, hl = SelectiveScan.apply(*ins)
        out[str(dev)] = torch.autograd.grad((y, hl), ins,
                                            (_t(dy).to(dev), hl.detach()))
    for g, w in zip(out["cuda"], out["cpu"]):
        assert _err(g.cpu(), w.numpy()) <= 1e-4
    cfg = smoke_config("recurrentgemma-2b")
    d, w, k = cfg.d_model, cfg.lru_width, cfg.ssm_conv
    p = {"in_x": r.standard_normal((d, w)) * d ** -0.5,
         "in_y": r.standard_normal((d, w)) * d ** -0.5,
         "conv_w": r.standard_normal((k, w)) * 0.5,
         "conv_b": r.standard_normal(w) * 0.1,
         "gate_a": r.standard_normal((w, w)) * w ** -0.5,
         "gate_x": r.standard_normal((w, w)) * w ** -0.5,
         "lam": r.uniform(-2.0, 2.0, w),
         "out": r.standard_normal((w, d)) * w ** -0.5}
    x = r.standard_normal((2, 37, d))
    hh = r.standard_normal((2, w))
    grads = {}
    for dev in ("cpu", cuda):
        tp = {n: _t(v.astype(np.float32)).to(dev).requires_grad_()
              for n, v in p.items()}
        tx = _t(x.astype(np.float32)).to(dev).requires_grad_()
        th = _t(hh.astype(np.float32)).to(dev).requires_grad_()
        o, c = rec.rglru_forward(cfg, tp, tx, h0=th, return_state=True)
        assert o.grad_fn is not None and c["h"].grad_fn is not None
        grads[str(dev)] = torch.autograd.grad(
            (o, c["h"]), [*tp.values(), tx, th],
            (torch.ones_like(o), torch.ones_like(c["h"])))
    for g, w_ in zip(grads["cuda"], grads["cpu"]):
        assert _err(g.cpu(), w_.numpy()) <= 1e-4
    an = torch.rand(1, 5, 4, 2, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="N = 1"):
        selective_scan_grad(an, an)


@pytest.mark.cuda
def test_cuda_recorded_outputs_keep_their_history(cuda):
    """On the card, rglru_forward, moe_local and flash_attention_grad
    within a window at hd 256, called under autograd with an input that
    requires grad, return outputs with an autograd history (or raise):
    none drops the gradient silently."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels.flash_attention import flash_attention_grad
    from repro_torch.models import get_model
    from repro_torch.models import moe
    from repro_torch.models import recurrent as rec
    q = torch.randn(10, 300, 256, device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    o = flash_attention_grad(q, q, q, window=64)
    assert o.grad_fn is not None
    for arch, layer in (("recurrentgemma-2b", "rec"),
                        ("qwen3-moe-30b-a3b", "moe")):
        cfg = smoke_config(arch)
        model = get_model(cfg, device=cuda).init(0).train_mode()
        blk = next(p for p, kind in zip(model.layers, model.kinds)
                   if kind == layer)
        x = torch.randn(2, 24, cfg.d_model, device=cuda, requires_grad=True)
        y = rec.rglru_forward(cfg, blk["rec"], x) if layer == "rec" \
            else moe.moe_local(cfg, blk["moe"], x)
        assert y.grad_fn is not None, arch
        g, = torch.autograd.grad(y.sum(), x)
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
