"""The PyTorch port's hybrid family (recurrentgemma-2b: RG-LRU "rec" and
local-window "lattn" layers) against the JAX package's, on the CPU.

Float32 smoke configs (window 16, lru_width 64), numpy-seeded inputs and
the reference's `model.init(0)` weights carried across by the converter;
the kernels run their plain versions here.  Held within 1e-5: the RG-LRU
layer (its returned state, then decode steps), windowed `attention_core`
at S > window with ragged lengths and GQA, the ring-buffer prefill and
decode (the s % w != 0 case too), the LM's prefill logits and a chain of
decodes, and the serve engine's greedy tokens (identical).  Also the
reference's ring placement recorded as a limit (ROADMAP.md, 'Reference
limits'), training both families and the windowed hd-256 gradient, and
chip_smoke.py's depth cut in whole periods.
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
from repro.models import recurrent as jax_rec
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import (lm_cache_to_numpy, lm_params_from_numpy,
                                 lm_params_to_numpy)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_grad,
                                                 flash_attention_plain)
from repro_torch.models import attention as attn
from repro_torch.models import recurrent as rec
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import make_train_step

ROOT = Path(__file__).resolve().parents[1]
ARCH = "recurrentgemma-2b"
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return t.detach().numpy()


def _rec_params(cfg, seed):
    """Numpy parameters of one smoke RG-LRU layer (nonzero conv bias, a
    spread of decay rates)."""
    r = np.random.default_rng(seed)
    d, w, k = cfg.d_model, cfg.lru_width, cfg.ssm_conv
    p = {"in_x": r.standard_normal((d, w)) * d ** -0.5,
         "in_y": r.standard_normal((d, w)) * d ** -0.5,
         "conv_w": r.standard_normal((k, w)) * 0.5,
         "conv_b": r.standard_normal(w) * 0.1,
         "gate_a": r.standard_normal((w, w)) * w ** -0.5,
         "gate_x": r.standard_normal((w, w)) * w ** -0.5,
         "lam": r.uniform(-2.0, 2.0, w),
         "out": r.standard_normal((w, d)) * w ** -0.5}
    return {k_: v.astype(np.float32) for k_, v in p.items()}


@pytest.mark.parametrize("s", [1, 13, 24])
def test_rglru_forward_then_decode_matches_reference(s):
    cfg, jcfg = smoke_config(ARCH), jax_smoke_config(ARCH)
    p = _rec_params(cfg, s)
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    r = np.random.default_rng(100 + s)
    x = r.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    # a first chunk from zero, then a second from the first's state
    want, jc = jax_rec.rglru_forward(jcfg, pj, jnp.asarray(x),
                                     return_state=True)
    got, c = rec.rglru_forward(cfg, pt, torch.from_numpy(x),
                               return_state=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    for k in ("conv", "h"):
        np.testing.assert_allclose(_np(c[k]), np.asarray(jc[k]), **TOL)
    x2 = r.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    want2, jc2 = jax_rec.rglru_forward(jcfg, pj, jnp.asarray(x2),
                                       h0=jc["h"], conv0=jc["conv"],
                                       return_state=True)
    got2, c2 = rec.rglru_forward(cfg, pt, torch.from_numpy(x2), h0=c["h"],
                                 conv0=c["conv"], return_state=True)
    np.testing.assert_allclose(_np(got2), np.asarray(want2), **TOL)
    np.testing.assert_allclose(_np(c2["h"]), np.asarray(jc2["h"]), **TOL)
    for step in range(3):
        xt = r.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        want, jc2 = jax_rec.rglru_decode(jcfg, pj, jnp.asarray(xt), jc2)
        got, c2 = rec.rglru_decode(cfg, pt, torch.from_numpy(xt), c2)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL,
                                   err_msg=f"decode step {step}")
        np.testing.assert_allclose(_np(c2["h"]), np.asarray(jc2["h"]), **TOL)


def test_rglru_prefill_goes_through_the_scan_at_n1(monkeypatch):
    """The rec layer's recurrence is one call of the scan's (a, bx) entry
    at N = 1 with c = 1, from h0, returning the state: in serving and,
    through `selective_scan_grad`'s Function, in training."""
    import importlib
    scan_mod = importlib.import_module("repro_torch.kernels.selective_scan")
    cfg = smoke_config(ARCH)
    pt = {k: torch.from_numpy(v) for k, v in _rec_params(cfg, 3).items()}
    calls = []
    real = scan_mod.selective_scan

    def spy(a, bx, c, h0=None, *, return_state=False):
        calls.append((tuple(a.shape), bool((c == 1).all()),
                      None if h0 is None else tuple(h0.shape), return_state))
        return real(a, bx, c, h0, return_state=return_state)
    monkeypatch.setattr(scan_mod, "selective_scan", spy)
    x = torch.randn(2, 9, cfg.d_model)
    _, c = rec.rglru_forward(cfg, pt, x, return_state=True)
    rec.rglru_forward(cfg, pt, x, h0=c["h"], conv0=c["conv"])
    rec.rglru_forward(cfg, {k: v.requires_grad_() for k, v in pt.items()},
                      x).sum().backward()
    w = cfg.lru_width
    assert calls == [((2, 9, w, 1), True, None, True),
                     ((2, 9, w, 1), True, (2, w, 1), True),
                     ((2, 9, w, 1), True, None, True)]
    assert all(v.grad is not None for v in pt.values())


def _qkv(r, b, sq, sk, hq, hkv, hd):
    q = r.standard_normal((b, sq, hq, hd)).astype(np.float32)
    k, v = (r.standard_normal((b, sk, hkv, hd)).astype(np.float32)
            for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("s,window,chunk", [(40, 16, 1024), (37, 16, 1024),
                                            (64, 16, 16), (48, 7, 16),
                                            (9, 16, 1024)])
def test_windowed_attention_core_matches_reference(s, window, chunk):
    # the reference's chunked path (s a multiple of chunk_q, the key span
    # sliced per chunk) and its one-shot path; GQA 4 query heads on 1
    r = np.random.default_rng(s + window)
    q, k, v = _qkv(r, 2, s, s, 4, 1, 16)
    want = jax_attn.attention_core(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True,
                                   window=window, chunk_q=chunk)
    got = attn.attention_core(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True,
                              window=window)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("sq,sk", [(1, 23), (9, 23), (23, 23), (30, 7)])
def test_noncausal_attention_core_matches_reference(sq, sk):
    # the encoder (sq = sk) and cross-attention (sq != sk)
    r = np.random.default_rng(sq * 31 + sk)
    q, k, v = _qkv(r, 2, sq, sk, 4, 4, 16)
    want = jax_attn.attention_core(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=False)
    got = attn.attention_core(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=False)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def _attn_params(cfg, seed):
    r = np.random.default_rng(seed)
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    p = {"wq": r.standard_normal((d, hq * hd)) * d ** -0.5,
         "wk": r.standard_normal((d, hkv * hd)) * d ** -0.5,
         "wv": r.standard_normal((d, hkv * hd)) * d ** -0.5,
         "wo": r.standard_normal((hq * hd, d)) * (hq * hd) ** -0.5}
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("plen,max_seq", [(8, 48), (16, 48), (32, 48),
                                          (40, 48), (21, 12)])
def test_ring_prefill_then_decode_matches_reference(plen, max_seq):
    """attn_prefill fills the ring (min(window, max_seq) rows) with the
    reference's placement, attn_decode writes at pos % cap with its
    age / k_abs validity: outputs and caches within 1e-5 over six steps
    (a prompt the ring divides, one it does not, one shorter than it,
    and a ring cut to max_seq)."""
    cfg, jcfg = smoke_config(ARCH), jax_smoke_config(ARCH)
    w = cfg.window
    p = _attn_params(cfg, plen)
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    r = np.random.default_rng(plen)
    x = r.standard_normal((2, plen, cfg.d_model)).astype(np.float32)
    shapes = jax_attn.attn_cache_defs(jcfg, 2, max_seq, window=w)
    jc = {k: jnp.zeros(s.shape, s.dtype) for k, s in shapes.items()}
    want, jc = jax_attn.attn_prefill(jcfg, pj, jnp.asarray(x), jc, window=w)
    defs = attn.attn_cache_defs(cfg, 2, max_seq, window=w)
    assert {k: s for k, (s, _) in defs.items()} == \
        {k: s.shape for k, s in shapes.items()}
    c = {k: torch.zeros(s, dtype=dt) for k, (s, dt) in defs.items()}
    got, c = attn.attn_prefill(cfg, pt, torch.from_numpy(x), c, window=w)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    for step in range(6):
        pos = plen + step
        for k in ("k", "v"):
            np.testing.assert_allclose(_np(c[k]), np.asarray(jc[k]), **TOL)
        xt = r.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        want, jc = jax_attn.attn_decode(jcfg, pj, jnp.asarray(xt), jc,
                                        jnp.asarray(pos, jnp.int32),
                                        window=w)
        got, c = attn.attn_decode(cfg, pt, torch.from_numpy(xt), c, pos,
                                  window=w)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL,
                                   err_msg=f"decode step {step}")


def _pair():
    jcfg = jax_smoke_config(ARCH)
    jm = jax_get_model(jcfg)
    params = jm.init(0)
    cfg = smoke_config(ARCH)
    model = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    return cfg, jm, params, model


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("plen", [37, 48])
def test_lm_prefill_and_decode_chain_match_reference(pair, plen):
    """Prompts past the window (the s % w != 0 ring and a multiple of
    it): prefill logits, every cache leaf, then eight decode steps."""
    cfg, jm, params, model = pair
    rng = np.random.default_rng(plen)
    tokens = rng.integers(0, cfg.vocab_size, (2, plen)).astype(np.int32)
    jl, jc = jm.prefill(params, jnp.asarray(tokens), 64)
    pl, pc = model.prefill(torch.as_tensor(tokens), 64)
    np.testing.assert_allclose(_np(pl), np.asarray(jl), **TOL)
    ref_cache = dict(_flat(jax.tree.map(np.asarray, jc)))
    ours = dict(_flat(lm_cache_to_numpy(cfg, pc)))
    assert ours.keys() == ref_cache.keys()
    for k, v in ref_cache.items():
        np.testing.assert_allclose(ours[k], v, **TOL, err_msg=k)
    for step in range(8):
        tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = jm.decode(params, jc, jnp.asarray(tok),
                           jnp.asarray(plen + step, jnp.int32))
        pl, pc = model.decode(pc, torch.as_tensor(tok), plen + step)
        np.testing.assert_allclose(_np(pl), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {step}")


def test_converter_carries_rec_and_lattn_leaves_both_ways(pair):
    cfg, _, params, model = pair
    tree = jax.tree.map(np.asarray, params)
    back = dict(_flat(lm_params_to_numpy(cfg, model)))
    ref = dict(_flat(tree))
    assert back.keys() == ref.keys()
    assert any("_rec/rec/gate_a" in k for k in ref)
    assert any("_lattn/attn/wq" in k for k in ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("plen,agree", [(32, True), (40, False)])
def test_ring_placement_is_the_references(pair, plen, agree):
    """ROADMAP.md, 'Reference limits': the reference's prefill stores the
    last `cap` keys at ring slots 0..cap-1 while its decode reads position
    p at slot p % cap.  After a prompt the window divides (32) decode
    equals the windowed forward (a prefill of one more token); after one
    it does not divide (40), the port's decode equals the reference's and
    both differ from the windowed forward."""
    cfg, jm, params, model = pair
    rng = np.random.default_rng(plen)
    tokens = rng.integers(0, cfg.vocab_size, (1, plen + 1)).astype(np.int32)
    fwd, _ = model.prefill(torch.as_tensor(tokens), 64)
    jfwd, _ = jm.prefill(params, jnp.asarray(tokens), 64)
    np.testing.assert_allclose(_np(fwd), np.asarray(jfwd), **TOL)
    _, pc = model.prefill(torch.as_tensor(tokens[:, :plen]), 64)
    _, jc = jm.prefill(params, jnp.asarray(tokens[:, :plen]), 64)
    last = tokens[:, plen:]
    got, _ = model.decode(pc, torch.as_tensor(last), plen)
    want, _ = jm.decode(params, jc, jnp.asarray(last),
                        jnp.asarray(plen, jnp.int32))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    off = float(np.abs(_np(got) - _np(fwd)).max())
    if agree:
        assert off <= 1e-5
    else:
        assert off > 1e-3


def test_engine_matches_jax_engine_across_the_ring(pair):
    """Greedy tokens of the port's engine equal the JAX engine's, with
    prompts shorter than, equal to and longer than the window (16) and
    decodes that wrap the ring; 3 requests on 2 slots."""
    cfg, _, params, model = pair
    jcfg = jax_smoke_config(ARCH)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (9, 16, 21)]
    outs = []
    for eng in (JaxServeEngine(jcfg, params, slots=2, max_seq=48),
                ServeEngine(cfg, model, slots=2, max_seq=48)):
        reqs = [eng.submit(p, max_new=12) for p in prompts]
        eng.run()
        assert all(r.done and len(r.out) == 12 for r in reqs)
        outs.append([r.out for r in reqs])
    assert outs[1] == outs[0]


@pytest.mark.parametrize("arch", [ARCH, "whisper-tiny"])
def test_training_refuses_the_hybrid_and_audio_families(arch):
    """The hybrid and audio families train: make_train_step builds a step,
    and two steps on the reference launcher's data give a finite loss and
    move every parameter (no refusal is left)."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import get_model
    from repro_torch.optim import adamw_init
    cfg = smoke_config(arch)
    model = get_model(cfg, device="cpu").init(0)
    before = {n: t.detach().clone() for n, t in model.named_leaves()}
    step = make_train_step(cfg, compress_grads=False)
    opt = adamw_init(dict(model.named_leaves()))
    data = SyntheticLMData(cfg.vocab_size, 2, 20, seed=1,
                           with_frames=cfg.enc_seq if cfg.family == "audio"
                           else 0, d_model=cfg.d_model)
    for _ in range(2):
        model, opt, m = step(model, opt, data.next_batch())
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    moved = [n for n, t in model.named_leaves()
             if not torch.equal(t.detach(), before[n])]
    assert len(moved) == len(before)


@pytest.mark.parametrize("hd,window", [(16, 8), (256, 0)])
def test_flash_gradient_refuses_what_the_backward_lacks(hd, window):
    """A recorded call with a window or at hd 256 (what the backward
    once lacked) goes through the Function: its gradients are the plain
    backward's, with the window; a call under no_grad is the plain
    forward."""
    q = torch.randn(2, 30, hd, requires_grad=True)
    out = flash_attention_grad(q, q, q, causal=True, window=window)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    do = torch.randn(2, 30, hd)
    got, = torch.autograd.grad(out, q, do)
    qd = q.detach()
    o, lse = flash_attention_plain(qd, qd, qd, window=window,
                                   return_lse=True)
    dq, dk, dv = flash_attention_bwd_plain(qd, qd, qd, o, lse, do,
                                           window=window)
    torch.testing.assert_close(got, dq + dk + dv, rtol=1e-5, atol=1e-6)
    with torch.no_grad():
        plain = flash_attention_grad(q, q, q, causal=True, window=window)
    assert plain.grad_fn is None
    torch.testing.assert_close(plain, o)


@pytest.mark.parametrize("fn", ["kernel", "plain"])
def test_flash_refuses_a_window_without_causal(fn):
    # only local causal attention has a window; a non-causal windowed row
    # past Sk - 1 + window would keep no key, so the form is refused
    q = torch.randn(2, 30, 16)
    f = flash_attention if fn == "kernel" else flash_attention_plain
    with pytest.raises(ValueError, match="needs causal=True"):
        f(q, q[:, :8], q[:, :8], causal=False, window=4)
    with pytest.raises(ValueError, match="window -1 < 0"):
        f(q, q, q, causal=True, window=-1)


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


@pytest.mark.parametrize("arch,layers,kinds", [
    ("recurrentgemma-2b", 3, ("rec", "rec", "lattn")),
    ("recurrentgemma-2b", 2, ("rec", "rec", "lattn")),
    ("recurrentgemma-2b", 7, ("rec", "rec", "lattn") * 3),
    ("llama3-8b", 2, ("dense",) * 2),
    ("falcon-mamba-7b", 16, ("ssm",) * 16),
    ("qwen2-72b", 32, ("dense",) * 32)])
def test_chip_smoke_cuts_depth_in_whole_periods(arch, layers, kinds):
    """chip_smoke.py's depth cuts keep the layout's pattern: whole periods
    of the first group's kinds, at least `layers` layers."""
    cs = _chip_smoke()
    cfg = cs.cut_layout(get_config(arch), layers)
    from repro_torch.models.lm import layer_slots
    assert tuple(k for *_, k in layer_slots(cfg)) == kinds
    assert cs.serve_config(get_config, arch).num_layers == \
        cs.SERVE_DEPTH.get(arch, get_config(arch).num_layers)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "whisper-tiny",
                                  "llama3-8b", "qwen3-moe-30b-a3b",
                                  "falcon-mamba-7b"])
def test_chip_smoke_counts_the_flash_bwd_wgmma_route(arch):
    """chip_smoke.py's launches a training step: the flash backward's
    wgmma route (bf16 at hd 64, 128 and 256) takes every backward launch
    of the bf16 models (recurrentgemma-2b's windowed hd-256 ones too),
    and a model without attention has none."""
    cs = _chip_smoke()
    layers, _, seq = cs.TRAIN_ARCHS[arch]
    cfg = cs.train_config(get_config, arch, layers)
    per_step = cs.train_launches(cfg, seq)
    assert per_step.get("flash_attention_bwd[wg]", 0) == \
        per_step.get("flash_attention_bwd", 0)
    assert (arch == "falcon-mamba-7b") == ("flash_attention_bwd" not in
                                           per_step)
    if arch == "recurrentgemma-2b":      # 8 lattn layers, microbatches of 1
        assert per_step["flash_attention_bwd[wg]"] == 16


@pytest.mark.parametrize("arch,wg", [("recurrentgemma-2b", True),
                                     ("whisper-tiny", True),
                                     ("llama3-8b", False),
                                     ("qwen3-moe-30b-a3b", False),
                                     ("falcon-mamba-7b", False)])
def test_chip_smoke_counts_the_flash_wgmma_route(arch, wg):
    """chip_smoke.py's launches a training step: the flash forward's wgmma
    route (bf16 at hd 64 and 256) takes every forward launch of the hybrid
    and audio families (their rows are past its 64) and none of the
    others'."""
    cs = _chip_smoke()
    layers, _, seq = cs.TRAIN_ARCHS[arch]
    cfg = cs.train_config(get_config, arch, layers)
    per_step = cs.train_launches(cfg, seq)
    assert per_step.get("flash_attention[wg]", 0) == \
        (per_step["flash_attention"] if wg else 0)
