"""The gradients the moe, hybrid and audio families train through, held
against `jax.vjp` of the JAX package's own functions on the CPU.

* The flash backward within a window at hd 256 (recurrentgemma-2b's
  lattn): `flash_attention_bwd_plain` and the Function through the
  models' `attention_core` against the reference's `attention_core`
  (`src/repro/models/attention.py`, which slices a query chunk's key
  span for a window), with GQA, ragged lengths and S past the window;
  whisper's non-causal Sq != Sk and Sq = Sk forms at hd 64.
* The scan's (a, bx) backward at N = 1: `selective_scan_bwd_plain` (the
  kernel's chunk order) and `selective_scan_bwd_sequential` (one reverse
  walk) against the vjp of a sequential `lax.scan` of h_t = a_t·h_{t-1}
  + bx_t, over lengths that span several chunks with the RG-LRU's a
  near 1, and the whole RG-LRU layer (`rglru_forward` with h0, the final
  state's gradient dh_last) against the reference's (`associative_scan`
  in chunks).
* The MoE combine's backward: the port's `moe_local` under autograd (the
  router's top-k, the padded expert pass, `SegmentAdd`) against the
  reference's `moe_local`, with rows dropped by capacity.
* `Whisper.loss` and its gradients against the reference's.

Inputs come from numpy seeds; the kernels run their plain versions here.
Tolerance: max |got − want| / max |want| ≤ 1e-5 per gradient, float32
(the same math summed in another order); the RG-LRU layer's 1e-4 (the
reference scans in chunks, the port in order, through float32 gate
products); Whisper's loss and gradients 1e-4 (train-step tolerance).
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import attention as jax_attn
from repro.models import get_model as jax_get_model
from repro.models import moe as jax_moe
from repro.models import recurrent as jax_rec
from repro_torch.configs import smoke_config
from repro_torch.convert import (whisper_params_from_numpy,
                                 whisper_tree_to_numpy)
from repro_torch.data import SyntheticLMData
from repro_torch.kernels.flash_attention import (flash_attention_bwd_plain,
                                                 flash_attention_plain)
from repro_torch.kernels.selective_scan import (SelectiveScan, _n1_chunk,
                                                selective_scan_bwd,
                                                selective_scan_bwd_plain,
                                                selective_scan_bwd_sequential,
                                                selective_scan_grad)
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import recurrent as rec

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_hybrid import _rec_params  # noqa: E402
from test_torch_moe import _drops_of, _moe_case  # noqa: E402

TOL = 1e-5
LAYER_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _err(got, want):
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# ---------------------------------------------------------------------------
# the flash backward within a window, at hd 256; whisper's shapes
# ---------------------------------------------------------------------------

def _qkv(seed, b, sq, sk, hq, hkv, hd):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, sq, hq, hd)).astype(np.float32)
    k, v = (r.standard_normal((b, sk, hkv, hd)).astype(np.float32)
            for _ in range(2))
    do = r.standard_normal((b, sq, hq, hd)).astype(np.float32)
    return q, k, v, do


def _jax_core_vjp(q, k, v, do, causal, window, chunk_q):
    out, vjp = jax.vjp(
        lambda a, c, e: jax_attn.attention_core(
            a, c, e, causal=causal, window=window, chunk_q=chunk_q),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("s,window,chunk", [(48, 16, 16), (37, 16, 1024),
                                            (40, 7, 8), (9, 16, 1024)])
def test_windowed_hd256_backward_matches_reference(s, window, chunk):
    """The plain backward with the window, at hd 256, on [B·Hq, S, hd]
    against the vjp of the reference's attention_core (GQA 2 on 1 head,
    as recurrentgemma-2b's 10 on 1; `chunk` < S takes the reference's
    sliced key spans)."""
    hd = 256
    q, k, v, do = _qkv(s + window, 2, s, s, 2, 1, hd)
    out, want = _jax_core_vjp(q, k, v, do, True, window, chunk)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    o = attn.attention_core(tq, tk, tv, causal=True, window=window)
    assert _err(o, out) <= TOL
    got = torch.autograd.grad(o, (tq, tk, tv), _t(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        assert _err(g, w) <= TOL, name
    # the plain backward itself, on the repeated heads
    def heads(x):
        x = torch.repeat_interleave(_t(x), 2 // x.shape[2], dim=2)
        return x.transpose(1, 2).reshape(-1, x.shape[1], hd)
    hq, hk, hv, hdo = heads(q), heads(k), heads(v), heads(do)
    o2, lse = flash_attention_plain(hq, hk, hv, window=window,
                                    return_lse=True)
    dq, dk, dv = flash_attention_bwd_plain(hq, hk, hv, o2, lse, hdo,
                                           window=window)
    assert _err(dq.reshape(2, 2, s, hd).transpose(1, 2), want[0]) <= TOL
    # the masked pairs take no gradient: from the last query alone, the
    # keys its window left behind get none
    if s > window:
        last = torch.zeros_like(hdo)
        last[:, -1] = hdo[:, -1]
        _, dk, dv = flash_attention_bwd_plain(hq, hk, hv, o2, lse, last,
                                              window=window)
        assert float(dk[:, :s - window].abs().max()) == 0.0
        assert float(dv[:, :s - window].abs().max()) == 0.0
        assert float(dv[:, s - window:].abs().max()) > 0.0


@pytest.mark.parametrize("sq,sk,causal", [(24, 37, False), (37, 37, False),
                                          (37, 37, True)])
def test_whisper_attention_backward_matches_reference(sq, sk, causal):
    """hd 64, 6 heads: the decoder's cross-attention (non-causal, Sq !=
    Sk), the encoder's (non-causal) and the decoder's self-attention
    (causal), through the Function, against the reference's vjp."""
    q, k, v, do = _qkv(sq * sk, 2, sq, sk, 6, 6, 64)
    out, want = _jax_core_vjp(q, k, v, do, causal, 0, 1024)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    o = attn.attention_core(tq, tk, tv, causal=causal)
    assert _err(o, out) <= TOL
    got = torch.autograd.grad(o, (tq, tk, tv), _t(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _err(g, w) <= TOL, name


# ---------------------------------------------------------------------------
# the scan's (a, bx) backward at N = 1: the RG-LRU
# ---------------------------------------------------------------------------

def _jax_seq_scan(a, bx, h0):
    """h_t = a_t·h_{t-1} + bx_t from h0, in order: (h [B, S, D], h_last)."""
    def body(h, ab):
        h = ab[0] * h + ab[1]
        return h, h
    h_last, hs = jax.lax.scan(body, h0, (jnp.swapaxes(a, 0, 1),
                                         jnp.swapaxes(bx, 0, 1)))
    return jnp.swapaxes(hs, 0, 1), h_last


@pytest.mark.parametrize("b,s,d", [(2, 13, 5), (1, 1, 7), (3, 40, 33)])
@pytest.mark.parametrize("with_h0", [True, False])
def test_abx_backward_matches_jax_vjp(b, s, d, with_h0):
    """selective_scan_bwd_plain (from a, the forward's states and h0) and
    the Function's wiring, with dh_last, against jax.vjp of the
    sequential recurrence."""
    r = np.random.default_rng(b * s + d)
    a = np.exp(-np.abs(r.standard_normal((b, s, d)))).astype(np.float32)
    bx, dy = (r.standard_normal((b, s, d)).astype(np.float32)
              for _ in range(2))
    h0 = r.standard_normal((b, d)).astype(np.float32) if with_h0 else \
        np.zeros((b, d), np.float32)
    dh = r.standard_normal((b, d)).astype(np.float32)
    (hs, h_last), vjp = jax.vjp(_jax_seq_scan, jnp.asarray(a),
                                jnp.asarray(bx), jnp.asarray(h0))
    want = [np.asarray(g) for g in vjp((jnp.asarray(dy), jnp.asarray(dh)))]
    th0 = _t(h0) if with_h0 else None
    got = selective_scan_bwd_plain(_t(a), _t(np.asarray(hs)), th0, _t(dy),
                                   _t(dh))
    for name, g, w in zip(("da", "dbx", "dh0"), got, want):
        assert g.shape == w.shape and _err(g, w) <= TOL, name
    # the wrapper takes the plain version on the CPU
    again = selective_scan_bwd(_t(a), _t(np.asarray(hs)), th0, _t(dy),
                               _t(dh))
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    # the Function: y is the state (c = 1), both outputs carry a gradient
    ins = [_t(a)[..., None].requires_grad_(),
           _t(bx)[..., None].requires_grad_()]
    ins.append(_t(h0)[..., None].requires_grad_() if with_h0 else None)
    y, hl = SelectiveScan.apply(*ins)
    assert _err(y, np.asarray(hs)) <= TOL and _err(hl[..., 0], h_last) <= TOL
    live = [t for t in ins if t is not None]
    fg = torch.autograd.grad((y, hl), live, (_t(dy), _t(dh)[..., None]))
    for name, g, w in zip(("da", "dbx", "dh0"), fg, want):
        assert _err(g[..., 0], w) <= TOL, name


@pytest.mark.parametrize("s", [1, 63, 64, 65, 300, 4097])
def test_abx_backward_chunk_order_matches_jax_vjp(s):
    """The plain backward in the kernel's chunk order (S cut into chunks
    of _n1_chunk(S), the carry into each folded through the later
    chunks' (Π a, carry) pairs) and the one reverse walk, with h0 and
    dh_last, against jax.vjp of the sequential recurrence, over S within
    one chunk, at a chunk's edge and across many, with a in [0.9, 0.999]
    as the RG-LRU's gates give (carries that fade slowly across chunks)."""
    b, d = 2, 6
    r = np.random.default_rng(s)
    a = r.uniform(0.9, 0.999, (b, s, d)).astype(np.float32)
    bx, dy = (r.standard_normal((b, s, d)).astype(np.float32)
              for _ in range(2))
    h0, dh = (r.standard_normal((b, d)).astype(np.float32)
              for _ in range(2))
    (hs, _), vjp = jax.vjp(_jax_seq_scan, jnp.asarray(a), jnp.asarray(bx),
                           jnp.asarray(h0))
    want = [np.asarray(g) for g in vjp((jnp.asarray(dy), jnp.asarray(dh)))]
    args = (_t(a), _t(np.asarray(hs)), _t(h0), _t(dy), _t(dh))
    for fn in (selective_scan_bwd_plain, selective_scan_bwd_sequential):
        for name, g, w in zip(("da", "dbx", "dh0"), fn(*args), want):
            assert g.shape == w.shape and _err(g, w) <= TOL, (fn, name)


def test_abx_backward_order_depends_on_s_alone():
    """_n1_chunk is a function of S alone (a multiple of 16, at least 64,
    at most 32 chunks), so one batch row's gradients do not depend on the
    rows or channels beside it: each row and channel alone gives the bits
    it gets in the whole call."""
    for s in (0, 1, 64, 65, 1000, 4096, 8192, 10 ** 6):
        c = _n1_chunk(s)
        assert c % 16 == 0 and c >= 64 and -(-s // c) <= 32
    r = np.random.default_rng(7)
    b, s, d = 3, 300, 5
    a = _t(r.uniform(0.9, 0.999, (b, s, d)).astype(np.float32))
    h, dy = (_t(r.standard_normal((b, s, d)).astype(np.float32))
             for _ in range(2))
    h0, dh = (_t(r.standard_normal((b, d)).astype(np.float32))
              for _ in range(2))
    whole = selective_scan_bwd_plain(a, h, h0, dy, dh)
    for i in range(b):
        for j in (0, d - 1):
            part = selective_scan_bwd_plain(
                a[i:i + 1, :, j:j + 1], h[i:i + 1, :, j:j + 1],
                h0[i:i + 1, j:j + 1], dy[i:i + 1, :, j:j + 1],
                dh[i:i + 1, j:j + 1])
            assert torch.equal(part[0], whole[0][i:i + 1, :, j:j + 1])
            assert torch.equal(part[1], whole[1][i:i + 1, :, j:j + 1])
            assert torch.equal(part[2], whole[2][i:i + 1, j:j + 1])


def test_scan_grad_refuses_what_the_backward_lacks():
    """A recorded call the (a, bx) backward does not take, N > 1, raises
    rather than return an output without a gradient; at N = 1 the output
    comes from the Function; under no_grad any N runs the forward."""
    r = np.random.default_rng(5)
    a = _t(np.exp(-np.abs(r.standard_normal((2, 9, 3, 4)))).astype(
        np.float32)).requires_grad_()
    bx = _t(r.standard_normal((2, 9, 3, 4)).astype(np.float32))
    with pytest.raises(NotImplementedError, match="N = 4"):
        selective_scan_grad(a, bx)
    a1, bx1 = a[..., :1].detach().requires_grad_(), bx[..., :1]
    y = selective_scan_grad(a1, bx1)
    assert type(y.grad_fn).__name__ == "SelectiveScanBackward"
    with torch.no_grad():
        assert torch.equal(y, selective_scan_grad(a1, bx1))
        assert selective_scan_grad(a, bx).shape == (2, 9, 3)


@pytest.mark.parametrize("s", [1, 13, 24])
def test_rglru_layer_grads_match_reference(s):
    """The RG-LRU layer with h0 and the final state's gradient: its
    parameters', input's and h0's gradients against the vjp of the
    reference's `rglru_forward` (chunks of `scan_chunk` through
    `associative_scan`)."""
    cfg, jcfg = smoke_config("recurrentgemma-2b"), \
        jax_smoke_config("recurrentgemma-2b")
    p = _rec_params(cfg, s)
    r = np.random.default_rng(s + 100)
    x = r.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    h0 = r.standard_normal((2, cfg.lru_width)).astype(np.float32)
    dout = r.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    dh = r.standard_normal((2, cfg.lru_width)).astype(np.float32)

    def ref(pp, xx, hh):
        out, c = jax_rec.rglru_forward(jcfg, pp, xx, h0=hh,
                                       return_state=True)
        return out, c["h"]
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    (out, h_last), vjp = jax.vjp(ref, jp, jnp.asarray(x), jnp.asarray(h0))
    gp, gx, gh = vjp((jnp.asarray(dout), jnp.asarray(dh)))
    tp = {k: _t(v).requires_grad_() for k, v in p.items()}
    tx, th = _t(x).requires_grad_(), _t(h0).requires_grad_()
    o, c = rec.rglru_forward(cfg, tp, tx, h0=th, return_state=True)
    assert _err(o, out) <= LAYER_TOL and _err(c["h"], h_last) <= LAYER_TOL
    names = list(tp)
    got = torch.autograd.grad((o, c["h"]), [tp[n] for n in names] + [tx, th],
                              (_t(dout), _t(dh)))
    for name, g in zip(names, got):
        assert _err(g, np.asarray(gp[name])) <= LAYER_TOL, name
    assert _err(got[-2], gx) <= LAYER_TOL
    assert _err(got[-1], gh) <= LAYER_TOL


# ---------------------------------------------------------------------------
# the MoE combine's backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_grads_match_reference_with_rows_dropped(cf):
    """moe_local under autograd (the router's top-k, the padded expert
    pass, the combine's `SegmentAdd`) against the vjp of the reference's
    moe_local, with the skewed router that drops rows at 1.25."""
    arch = "qwen3-moe-30b-a3b"
    cfg = smoke_config(arch).replace(capacity_factor=cf)
    jcfg = jax_smoke_config(arch).replace(capacity_factor=cf)
    p, x = _moe_case(cfg, 40, seed=9, router="skewed")
    dy = np.random.default_rng(10).standard_normal(x.shape).astype(
        np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    out, vjp = jax.vjp(lambda pp, xx: jax_moe.moe_local(jcfg, pp, xx), jp,
                       jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(dy))
    tp = {k: _t(v).requires_grad_() for k, v in p.items()}
    tx = _t(x).requires_grad_()
    o = moe.moe_local(cfg, tp, tx)
    assert _err(o, out) <= TOL
    names = list(tp)
    got = torch.autograd.grad(o, [tp[n] for n in names] + [tx], _t(dy))
    for name, g in zip(names, got):
        assert _err(g, np.asarray(gp[name])) <= TOL, name
    assert _err(got[-1], gx) <= TOL
    # rows dropped at 1.25, none at 8
    _, ge = moe._router(cfg, {"router": tp["router"]}, tx[0])
    flat = ge.reshape(-1).numpy()
    keep = _drops_of(flat, cfg.num_experts,
                     jax_moe._cap_e(flat.size, cfg.num_experts, cf))
    assert (~keep).any() == (cf == 1.25)


def test_segment_add_backward_is_the_gather():
    """SegmentAdd: float32 sums forward; backward dy[src] in the values'
    dtype (bf16 values get a bf16 gradient)."""
    r = np.random.default_rng(2)
    vals = _t(r.standard_normal((12, 5)).astype(np.float32)).to(
        torch.bfloat16).requires_grad_()
    ids = torch.tensor([0, 0, 3, 1, 3, 3, 2, 0, 1, 1, 2, 3])
    out = moe.segment_add(vals, ids, 4)
    assert out.dtype == torch.float32
    assert type(out.grad_fn).__name__ == "SegmentAddBackward"
    dy = _t(r.standard_normal((4, 5)).astype(np.float32))
    g, = torch.autograd.grad(out, vals, dy)
    assert g.dtype == torch.bfloat16
    assert torch.equal(g, dy[ids].to(torch.bfloat16))


# ---------------------------------------------------------------------------
# Whisper.loss
# ---------------------------------------------------------------------------

def test_whisper_loss_and_grads_match_reference():
    """Whisper.loss (encoder, the decoder's rematerialized layers,
    chunked_ce with ce_chunk 8 at S 16) and every gradient leaf against
    the reference's, within 1e-4 of max |ref|."""
    arch = "whisper-tiny"
    jcfg = jax_smoke_config(arch).replace(ce_chunk=8)
    cfg = smoke_config(arch).replace(ce_chunk=8)
    params = jax_get_model(jcfg).init(0)
    model = whisper_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                      device="cpu")
    batch = SyntheticLMData(cfg.vocab_size, 2, 16, seed=4,
                            with_frames=cfg.enc_seq,
                            d_model=cfg.d_model).next_batch()
    (jloss, _), jg = jax.value_and_grad(
        lambda p, b: jax_get_model(jcfg).loss(p, b), has_aux=True)(
        params, batch)
    model.train_mode()
    leaves = dict(model.named_leaves())
    loss, metrics = model.loss(batch)
    assert metrics["loss"] is loss and loss.dtype == torch.float32
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert _err(loss, float(jloss)) <= LAYER_TOL
    got = dict(_flat(whisper_tree_to_numpy(cfg, dict(zip(leaves, grads)))))
    want = dict(_flat(jax.tree.map(np.asarray, jg)))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert _err(got[k], w) <= LAYER_TOL, k
    # serving after training builds no graph
    with torch.no_grad():
        assert not model.encode(batch["frames"]).requires_grad
