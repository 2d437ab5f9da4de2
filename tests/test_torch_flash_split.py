"""The flash backward's split route: bf16 at hd 64 without a causal mask
(whisper-tiny's encoder self-attention and its cross-attention).

The route (csrc/flash_attention_bwd.cu, `bwd_split_kernel`) forms dK/dV
and dQ in blocks of their own, so its scratch is D alone; the causal form
at hd 64 and every form at hd 128 keep the one-pass kernel and its dQ
workspace.  On the CPU: the route and scratch the wrapper picks, the plain
backward against `jax.vjp` of the reference's `flash_attention_ref` at
non-causal hd-64 shapes with ragged tails (max |got − want| / max |want|
≤ 1e-5 per gradient, float32: the same math summed in another order), and
the launches chip_smoke.py expects of the route in a training step.  The
tests marked `cuda` hold the kernel against the plain version on the card
(2e-2 of max|ref| per gradient: the kernel rounds P and dS to bf16 for the
tensor cores) and skip here.  They need no jax, so on the machine with the
card they run alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash_split.py
"""
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from repro.kernels.flash_attention_ref import flash_attention_ref
except ImportError:     # the card's machine: only the `cuda` tests run there
    pass
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_plain)

# the module (the package attribute `flash_attention` is the function)
flash_module = importlib.import_module("repro_torch.kernels.flash_attention")
ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
SPLIT = "flash_attention_bwd[full, hd 64]"


def _inputs(seed, bh, sq, sk, hd=64):
    r = np.random.default_rng(seed)
    q, k, v = (r.standard_normal((bh, s, hd)).astype(np.float32)
               for s in (sq, sk, sk))
    do = r.standard_normal((bh, sq, hd)).astype(np.float32)
    return q, k, v, do


def _err(got, want):
    got = np.asarray(got.float(), np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("dtype,hd,causal,route", [
    (torch.bfloat16, 64, False, "wgmma-split"),
    (torch.bfloat16, 64, True, "wgmma"),
    (torch.bfloat16, 128, False, "wgmma"),
    (torch.bfloat16, 128, True, "wgmma"),
    (torch.bfloat16, 256, False, "wgmma"),
    (torch.bfloat16, 32, False, "mma"),
    (torch.float32, 64, False, "f32"),
    (torch.float32, 64, True, "f32")])
def test_bwd_route_by_mask(dtype, hd, causal, route):
    # only bf16 hd 64 without a causal mask takes the split route; its
    # causal form and hd 128 (no model trains it non-causal) keep the
    # one-pass kernel, float32 its FMAs
    assert flash_module._bwd_route(dtype, hd, causal) == route
    assert (route in flash_module.WG_BWD_ROUTES) == route.startswith("wgmma")


@pytest.mark.parametrize("bh,sq,hd,causal,extra", [
    (24, 1500, 64, False, False),     # whisper-tiny's encoder: D alone
    (24, 448, 64, False, False),      # its cross-attention
    (24, 1500, 64, True, True),       # the one-pass kernel's workspace
    (3, 77, 128, False, True),
    (2, 300, 256, True, False),       # hd 256's blocks: D alone
    (2, 300, 32, True, False)])
def test_bwd_scratch_floats(bh, sq, hd, causal, extra):
    """The split route's scratch is D [BH, Sq]; the one-pass kernel's goes
    on with its sync words (1 + a flag a (bh, 64-row tile)) to a multiple
    of 4 floats, then a float32 dQ part of 64·hd a tile."""
    n = flash_module._bwd_scratch_floats(bh, sq, hd, torch.bfloat16, causal)
    tiles = bh * -(-sq // 64)
    want = -(-(bh * sq + 1 + tiles) // 4) * 4 + tiles * 64 * hd \
        if extra else bh * sq
    assert n == want
    assert flash_module._bwd_scratch_floats(bh, sq, hd, torch.float32,
                                            causal) == bh * sq


@pytest.mark.parametrize("bh,sq,sk", [(2, 45, 150), (2, 150, 150),
                                      (1, 1, 65), (2, 130, 63), (1, 64, 3)])
def test_flash_bwd_plain_matches_jax_vjp_full_hd64(bh, sq, sk):
    """Non-causal hd 64 with Sq != Sk and ragged tails (no multiple of the
    kernel's 64-row tiles or 128-key blocks): the plain backward, the
    reference on the card, against jax.vjp of flash_attention_ref."""
    q, k, v, do = _inputs(sq * 7 + sk, bh, sq, sk)
    out, vjp = jax.vjp(lambda a, b, c: flash_attention_ref(a, b, c, False),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    o, lse = flash_attention_plain(*t[:3], causal=False, return_lse=True)
    assert _err(o, np.asarray(out)) <= TOL
    got = flash_attention_bwd_plain(*t[:3], o, lse, t[3], causal=False)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _err(g, w) <= TOL, name


def test_cpu_backward_counts_no_split_launch():
    # the CPU takes the plain version: no launch, on any counter
    ops.reset_launch_counts()
    q = torch.ones(1, 70, 64, dtype=torch.bfloat16)
    o, lse = flash_attention(q, q, q, causal=False, return_lse=True)
    flash_attention_bwd(q, q, q, o, lse, q, causal=False)
    assert ops.launch_counts()[SPLIT] == 0
    assert ops.launch_counts()["flash_attention_bwd"] == 0


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


@pytest.mark.parametrize("arch,split", [("whisper-tiny", 16),
                                        ("recurrentgemma-2b", 0),
                                        ("llama3-8b", 0),
                                        ("qwen3-moe-30b-a3b", 0),
                                        ("falcon-mamba-7b", 0)])
def test_chip_smoke_counts_the_split_route(arch, split):
    """chip_smoke.py's launches a training step: whisper-tiny's 4 encoder
    self-attention and 4 cross-attention backwards a microbatch, 2
    microbatches, take the split route (within the wgmma count); its
    causal decoder self-attention and every other model's none."""
    cs = _chip_smoke()
    layers, _, seq = cs.TRAIN_ARCHS[arch]
    per_step = cs.train_launches(cs.train_config(get_config, arch, layers),
                                 seq)
    assert per_step.get(SPLIT, 0) == split
    assert per_step.get("flash_attention_bwd[wg]", 0) >= split


def test_chip_smoke_times_whisper_at_a_microbatch():
    # phase 2's whisper backwards run at the shapes a step launches: 8
    # requests in microbatches of 2, 6 heads: BH 24
    cs = _chip_smoke()
    cfg = get_config(cs.AUDIO_ARCH)
    assert cs.TRAIN_ARCHS[cs.AUDIO_ARCH][1] // cfg.microbatch \
        * cfg.num_heads == 24


# ---------------------------------------------------------------------------
# the kernel against its plain version (needs a card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    return torch.device("cuda")


def _card_check(cuda, seed, bh, sq, sk):
    """The split route against the plain version (2e-2 of max|ref|, an
    absolute floor of 1e-6 for a gradient that vanishes in exact
    arithmetic), a second launch bit-equal, and the route's counters."""
    q, k, v, do = (torch.from_numpy(a).to(cuda, torch.bfloat16)
                   for a in _inputs(seed, bh, sq, sk))
    o, lse = flash_attention(q, k, v, causal=False, return_lse=True)
    before = ops.launch_counts()
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    after = ops.launch_counts()
    for key in ("flash_attention_bwd", "flash_attention_bwd[wg]", SPLIT):
        assert after[key] == before[key] + 1, key
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        if sk == 1 and name != "dv":
            # one key: P = 1 and dS = dP − D = 0 in exact arithmetic, so dq
            # and dk are the rounding of that difference on both sides
            assert float(g.float().abs().max()) <= 1e-5, name
            assert float(w.float().abs().max()) <= 1e-5, name
            continue
        e = float((g.float() - w.float()).abs().max())
        assert e <= max(2e-2 * float(w.float().abs().max()), 1e-6), (name, e)
    again = flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    for g, h in zip(got, again):
        assert torch.equal(g, h)       # every sum in one block: the same bits


@pytest.mark.cuda
@pytest.mark.parametrize("sq", [1500, 448])
def test_cuda_split_whisper_step_shapes(cuda, sq):
    """A whisper-tiny microbatch's launches: the encoder [24, 1500, 64]
    and cross-attention [24, 448, 64] x [24, 1500, 64] (a half-full last
    128-row dQ block; the dQ blocks go first)."""
    _card_check(cuda, sq, 24, sq, 1500)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk", [(1, 1), (1, 1500), (45, 63), (63, 65),
                                   (65, 129), (200, 1500), (129, 1),
                                   (64, 128)])
def test_cuda_split_edges(cuda, sq, sk):
    """Sq = 1, Sk = 1, Sq < 64, Sk about the 64-key tile and the 128-key
    block (63, 65, 129), 1500 keys, whole tiles: the ragged tails TMA
    zero-fills and the last key tile's mask."""
    _card_check(cuda, sq * 3 + sk, 3, sq, sk)


@pytest.mark.cuda
def test_cuda_split_empty_queries(cuda):
    # Sq = 0: no query reaches a key, dK = dV = 0
    q = torch.empty(2, 0, 64, device=cuda, dtype=torch.bfloat16)
    k = torch.randn(2, 70, 64, device=cuda).to(torch.bfloat16)
    lse = torch.empty(2, 0, device=cuda)
    dq, dk, dv = flash_attention_bwd(q, k, k, q, lse, q, causal=False)
    assert dq.shape == (2, 0, 64)
    assert not dk.any() and not dv.any()
