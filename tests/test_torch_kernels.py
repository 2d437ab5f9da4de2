"""The PyTorch port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper of `repro_torch.kernels` runs its plain PyTorch
version; the JAX kernels run in interpret mode.  The sweeps and tolerances
are those of tests/test_kernels.py.  The CUDA kernels themselves need a
card: the tests marked `cuda` hold them against their plain versions and
skip here.  They need no jax, so on the machine with the card, which has
none, they run alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py
"""
import importlib

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from repro.kernels.flash_attention import flash_attention as jax_flash
    from repro.kernels.flash_attention_ref import flash_attention_ref
    from repro.kernels.segment_reduce import \
        segment_reduce as jax_segment_reduce
    from repro.kernels.segment_reduce import segment_sum as jax_segment_sum
    from repro.kernels.segment_reduce_ref import segment_reduce_ref
    from repro.kernels.selective_scan import selective_scan as jax_scan
    from repro.kernels.selective_scan_ref import selective_scan_ref
    from repro.kernels.tile_matmul import tile_matmul as jax_tile_matmul
except ImportError:     # the card's machine: only the `cuda` tests run there
    pass
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_plain)
from repro_torch.kernels.segment_reduce import (segment_reduce,
                                                segment_reduce_plain,
                                                segment_sum)
from repro_torch.kernels.selective_scan import (selective_scan,
                                                selective_scan_bwd,
                                                selective_scan_fused,
                                                selective_scan_fused_bwd,
                                                selective_scan_fused_plain,
                                                selective_scan_plain)
from repro_torch.core.tiles import pack
from repro_torch.kernels.tile_matmul import (tile_matmul, tile_matmul_packed,
                                             tile_matmul_packed_plain,
                                             tile_matmul_plain)

# the modules themselves (the package's names are the wrappers)
segment_module = importlib.import_module("repro_torch.kernels.segment_reduce")
flash_module = importlib.import_module("repro_torch.kernels.flash_attention")

rng = np.random.default_rng(0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n,d,k", [(64, 16, 8), (200, 33, 17), (128, 8, 128),
                                   (100, 24, 10)])
def test_segment_sum_shapes(n, d, k):
    ids = rng.integers(0, k, n).astype(np.int32)
    vals = rng.standard_normal((n, d)).astype(np.float32)
    a = segment_sum(_t(ids), _t(vals), k)
    b = jax_segment_sum(jnp.asarray(ids), jnp.asarray(vals), k, bn=32, bk=16,
                        bd=16)
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                               atol=1e-4)


def test_segment_sum_out_of_range_dropped():
    ids = np.array([0, 5, 99, -1, 2], np.int32)  # 99/-1 out of range
    vals = np.ones((5, 4), np.float32)
    a = segment_sum(_t(ids), _t(vals), 6)
    b = jax_segment_sum(jnp.asarray(ids), jnp.asarray(vals), 6)
    np.testing.assert_allclose(a.numpy(), np.asarray(b))


_SWEEP = [(int(r.integers(1, 60)), int(r.integers(1, 12)),
           int(r.integers(1, 20)), int(r.integers(0, 2 ** 31 - 1)))
          for r in [np.random.default_rng(2024)] for _ in range(20)]


@pytest.mark.parametrize("n,d,k,seed", _SWEEP)
def test_segment_sum_sweep(n, d, k, seed):
    r = np.random.default_rng(seed)
    ids = r.integers(0, k, n).astype(np.int32)
    vals = r.standard_normal((n, d)).astype(np.float32)
    a = segment_sum(_t(ids), _t(vals), k)
    b = jax_segment_sum(jnp.asarray(ids), jnp.asarray(vals), k, bn=16, bk=8,
                        bd=8)
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                               atol=1e-4)


def test_segment_reduce_1d_values():
    ids = rng.integers(0, 7, 50).astype(np.int32)
    vals = rng.standard_normal(50).astype(np.float32)
    a = segment_reduce(_t(ids), _t(vals), 7)
    b = jax_segment_reduce(jnp.asarray(ids), jnp.asarray(vals), 7, bn=16,
                           bk=4)
    assert tuple(a.shape) == (7,)
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("op", ["+", "min", "max"])
@pytest.mark.parametrize("n,d,k", [(100, 33, 17), (65, 1, 5), (31, 9, 13)])
def test_segment_reduce_ops(op, n, d, k):
    ids = rng.integers(0, k, n).astype(np.int32)
    vals = rng.standard_normal((n, d)).astype(np.float32)
    a = segment_reduce(_t(ids), _t(vals), k, op=op)
    b = jax_segment_reduce(jnp.asarray(ids), jnp.asarray(vals), k, op=op,
                           bn=16, bk=8, bd=8)
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("op", ["+", "min", "max"])
def test_segment_reduce_negative_and_oob_sentinel(op):
    ids = np.array([0, 3, -1, 99, 2, -7, 1], np.int32)  # -1/-7/99 drop
    vals = np.arange(1.0, 8.0, dtype=np.float32)
    a = segment_reduce(_t(ids), _t(vals), 5, op=op)
    b = jax_segment_reduce(jnp.asarray(ids), jnp.asarray(vals), 5, op=op,
                           bn=4, bk=4)
    np.testing.assert_allclose(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("op", ["+", "min", "max"])
def test_segment_reduce_nonfinite(op):
    # dropped rows carry inf/NaN and contribute nothing; a NaN in a kept
    # row propagates to its own segment.  min/max are held against the
    # JAX kernel (jnp.min/jnp.max propagate NaN); + against its scatter
    # oracle, because the kernel's one-hot product also spreads a kept NaN
    # to every segment of its block (0 × NaN)
    ids = np.array([0, 1, -1, 9, 2, 2, 3], np.int32)
    vals = np.array([1.0, np.nan, np.inf, np.nan, 4.0, -2.0, 5.0],
                    np.float32)
    a = segment_reduce(_t(ids), _t(vals), 4, op=op).numpy()
    if op == "+":
        b = np.asarray(segment_reduce_ref(jnp.asarray(ids),
                                          jnp.asarray(vals), 4))
    else:
        b = np.asarray(jax_segment_reduce(jnp.asarray(ids),
                                          jnp.asarray(vals), 4, op=op,
                                          bn=4, bk=4))
    assert np.isnan(a).sum() == 1
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a[~np.isnan(b)], b[~np.isnan(b)])


def test_segment_reduce_exact_int_accumulation():
    ids = _t(np.zeros(2, np.int32))
    vals = _t(np.array([2 ** 24 + 1, 1], np.int32))
    a = segment_reduce(ids, vals, 1)
    assert a.dtype == torch.int32 and int(a[0]) == 2 ** 24 + 2
    m = segment_reduce(ids, vals, 1, op="max")
    assert m.dtype == torch.int32 and int(m[0]) == 2 ** 24 + 1
    j = jax_segment_reduce(jnp.asarray(ids.numpy()),
                           jnp.asarray(vals.numpy()), 1)
    assert int(j[0]) == int(a[0])


@pytest.mark.parametrize("op", ["min", "max"])
def test_segment_reduce_int_empty_segment_identity(op):
    # empty segments hold the JAX kernel's integer identity (±INT_MAX)
    ids = np.array([0, 0], np.int32)
    vals = np.array([3, 5], np.int32)
    a = segment_reduce(_t(ids), _t(vals), 3, op=op).numpy()
    b = np.asarray(jax_segment_reduce(jnp.asarray(ids), jnp.asarray(vals), 3,
                                      op=op))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("m,k,n,bm", [(64, 32, 48, 32), (100, 70, 90, 32),
                                      (33, 17, 9, 16), (128, 128, 128, 128)])
def test_tile_matmul_shapes(m, k, n, bm):
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    c = tile_matmul(_t(a), _t(b), bm=bm, bk=bm)
    j = jax_tile_matmul(jnp.asarray(a), jnp.asarray(b), bm=bm, bn=bm, bk=bm)
    np.testing.assert_allclose(c.numpy(), np.asarray(j), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(c.numpy(), a @ b, rtol=1e-4, atol=1e-3)


def test_tile_matmul_bf16():
    a = rng.standard_normal((64, 64)).astype(np.float32)
    b = rng.standard_normal((64, 64)).astype(np.float32)
    c = tile_matmul(_t(a).to(torch.bfloat16), _t(b).to(torch.bfloat16),
                    bm=32, bk=32)
    assert c.dtype == torch.float32
    j = jax_tile_matmul(jnp.asarray(a, jnp.bfloat16),
                        jnp.asarray(b, jnp.bfloat16), bm=32, bn=32, bk=32)
    np.testing.assert_allclose(c.numpy(), np.asarray(j), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(c.numpy(), a @ b, rtol=5e-2, atol=5e-1)


@pytest.mark.parametrize("m,k,n,bm", [(96, 64, 80, 32), (100, 70, 90, 32)])
def test_tile_matmul_masked(m, k, n, bm):
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    mask = rng.integers(0, 2, (-(-m // bm), -(-k // bm))).astype(np.float32)
    mask[0, 0] = 0.0           # at least one absent tile with non-zero data
    c = tile_matmul(_t(a), _t(b), _t(mask), bm=bm, bk=bm)
    j = jax_tile_matmul(jnp.asarray(a), jnp.asarray(b),
                        tile_mask=jnp.asarray(mask), bm=bm, bn=bm, bk=bm)
    np.testing.assert_allclose(c.numpy(), np.asarray(j), rtol=1e-4,
                               atol=1e-3)
    # an absent tile contributes exactly zero: its rows of A do not matter
    a2 = a.copy()
    a2[:bm, :bm] = 1e6
    c2 = tile_matmul(_t(a2), _t(b), _t(mask), bm=bm, bk=bm)
    np.testing.assert_array_equal(c2.numpy(), c.numpy())


def test_tile_matmul_bad_mask_shape_raises():
    a = torch.zeros(64, 64)
    with pytest.raises(ValueError):
        tile_matmul(a, a, torch.ones(3, 3), bm=32, bk=32)


@pytest.mark.parametrize("m,k,n,bm", [(96, 64, 80, 32), (100, 70, 90, 32),
                                      (20, 50, 30, 32)])
def test_tile_matmul_packed_equals_masked_dense(m, k, n, bm):
    # the packed entry reads [Mt, Kt, bm, bk] tiles of a logical (M, K)
    # lhs; its product is the masked dense product of the same matrix
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    t = pack(_t(a), bm, bm, prune_zero=False)
    mask = _t(rng.integers(0, 2, tuple(t.mask.shape)).astype(np.float32))
    mask[0, 0] = 0.0
    c = tile_matmul_packed(t.tiles, mask, t.shape, _t(b))
    want = tile_matmul(_t(a), _t(b), mask, bm=bm, bk=bm)
    np.testing.assert_array_equal(c.numpy(), want.numpy())
    j = jax_tile_matmul(jnp.asarray(a), jnp.asarray(b),
                        tile_mask=jnp.asarray(mask.numpy()), bm=bm, bn=bm,
                        bk=bm)
    np.testing.assert_allclose(c.numpy(), np.asarray(j), rtol=1e-4,
                               atol=1e-3)


def test_tile_matmul_packed_bad_shapes_raise():
    t = pack(torch.ones(64, 48), 32, 32)
    with pytest.raises(ValueError):
        tile_matmul_packed(t.tiles, t.mask, (64, 48), torch.ones(40, 8))
    with pytest.raises(ValueError):
        tile_matmul_packed(t.tiles, t.mask, (64, 96), torch.ones(96, 8))


def test_tile_matmul_packed_ignores_nan_in_absent_tiles():
    # an absent tile contributes exactly zero, whatever it holds: NaN in
    # its packed storage must not reach the product (the JAX kernel
    # multiplies it out, 0·NaN, so the reference here is numpy)
    m, k, n, bm = 100, 70, 90, 32
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    t = pack(_t(a), bm, bm, prune_zero=False)
    mask = _t(rng.integers(0, 2, tuple(t.mask.shape)).astype(np.float32))
    mask[0, 0] = 0.0
    tiles = t.tiles.clone()
    tiles[mask == 0] = float("nan")
    c = tile_matmul_packed(tiles, mask, t.shape, _t(b)).numpy()
    me = np.kron(mask.numpy(), np.ones((bm, bm), np.float32))[:m, :k]
    assert np.isfinite(c).all()
    np.testing.assert_allclose(c, (a * me) @ b, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("packed", [False, True])
def test_tile_matmul_mask_values_scale_tiles(packed):
    # a mask value other than 0/1 scales its tile, as the JAX kernel's
    # `m * dot(a, b)` does
    m, k, n, bm = 96, 64, 80, 32
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    mask = np.array([[0.5, 2.0], [0.0, 1.0], [2.0, 0.5]], np.float32)
    if packed:
        t = pack(_t(a), bm, bm, prune_zero=False)
        c = tile_matmul_packed(t.tiles, _t(mask), t.shape, _t(b))
    else:
        c = tile_matmul(_t(a), _t(b), _t(mask), bm=bm, bk=bm)
    j = jax_tile_matmul(jnp.asarray(a), jnp.asarray(b),
                        tile_mask=jnp.asarray(mask), bm=bm, bn=bm, bk=bm)
    np.testing.assert_allclose(c.numpy(), np.asarray(j), rtol=1e-4,
                               atol=1e-3)


def test_tile_matmul_transposed_lhs():
    # a non-contiguous lhs (the transpose of a [K, M] matrix) is read
    # through its strides
    x = rng.standard_normal((70, 100)).astype(np.float32)
    b = rng.standard_normal((70, 90)).astype(np.float32)
    mask = rng.integers(0, 2, (4, 3)).astype(np.float32)
    a = _t(x).t()
    assert not a.is_contiguous()
    c = tile_matmul(a, _t(b), _t(mask), bm=32, bk=32)
    j = jax_tile_matmul(jnp.asarray(x.T), jnp.asarray(b),
                        tile_mask=jnp.asarray(mask), bm=32, bn=32, bk=32)
    np.testing.assert_allclose(c.numpy(), np.asarray(j), rtol=1e-4,
                               atol=1e-3)


def test_build_hash_covers_headers(tmp_path, monkeypatch):
    # a kernel that includes a csrc/*.cuh header is rebuilt when only the
    # header changes: the library's name hashes the headers too
    from repro_torch.kernels import _build
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._lib_path("k")
    assert _build._lib_path("k") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    second = _build._lib_path("k")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new header\n")
    assert _build._lib_path("k") not in (first, second)
    assert second.parent == first.parent == _build.BUILD_DIR


def test_build_from_another_csrc(tmp_path, monkeypatch):
    # an earlier version of the sources (to time against) builds from its
    # own directory and headers into a library of another name
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    (tmp_path / "flash_attention.cu").write_text("// earlier\n")
    own = _build._lib_path("flash_attention")
    other = _build._lib_path("flash_attention", tmp_path)
    assert other != own and other.parent == own.parent == _build.BUILD_DIR
    cmd = _build.nvcc_command("flash_attention", other, tmp_path,
                              ("-Xptxas", "-v"))
    assert cmd[-1] == str(tmp_path / "flash_attention.cu")
    assert cmd[cmd.index("-I") + 1] == str(tmp_path)
    assert "-Xptxas" in cmd and cmd[cmd.index("-o") + 1] == str(other)
    assert _build.nvcc_command("flash_attention", own)[-1] == \
        str(_build.CSRC / "flash_attention.cu")


def test_cpu_wrappers_count_no_launches():
    ops.reset_launch_counts()
    segment_reduce(_t(np.zeros(3, np.int32)), _t(np.ones(3, np.float32)), 2)
    tile_matmul(torch.ones(4, 4), torch.ones(4, 4))
    t = pack(torch.ones(4, 4), 2, 2)
    tile_matmul_packed(t.tiles, t.mask, t.shape, torch.ones(4, 4))
    q = torch.ones(2, 5, 16)
    flash_attention(q, q, q)
    # a bf16 shape of the wgmma route: the CPU takes the plain version
    qw = torch.ones(1, 64, 64, dtype=torch.bfloat16)
    flash_attention(qw, qw, qw, causal=False)
    a = torch.ones(1, 3, 4, 2)
    selective_scan(a, a, torch.ones(1, 3, 2), return_state=True)
    dt = torch.ones(1, 3, 4)
    selective_scan_fused(dt, -torch.ones(4, 2), torch.ones(1, 3, 2),
                         torch.ones(1, 3, 2), dt.bfloat16())
    # the backward kernels' wrappers
    o, lse = flash_attention(q, q, q, return_lse=True)
    flash_attention_bwd(q, q, q, o, lse, q)
    selective_scan_fused_bwd(dt, -torch.ones(4, 2), torch.ones(1, 3, 2),
                             torch.ones(1, 3, 2), dt, None, dt)
    selective_scan_bwd(dt, dt, None, dt)
    ops.adamw([torch.ones(3)], [torch.ones(3)], [torch.zeros(3)],
              [torch.zeros(3)],
              lr_t=torch.tensor(1e-3), b1t=torch.tensor(0.1),
              b2t=torch.tensor(0.05), b1=0.9, b2=0.95, eps=1e-8,
              weight_decay=0.1, max_norm=1.0)
    assert ops.launch_counts() == {"segment_reduce": 0, "tile_matmul": 0,
                                   "flash_attention": 0, "selective_scan": 0,
                                   "selective_scan_fused": 0,
                                   "flash_attention_bwd": 0,
                                   "selective_scan_bwd": 0,
                                   "selective_scan_bwd[a, bx]": 0,
                                   "segment_reduce[rows]": 0,
                                   "segment_reduce[lanes]": 0,
                                   "flash_attention[wg]": 0,
                                   "flash_attention_bwd[wg]": 0,
                                   "flash_attention_bwd[full, hd 64]": 0,
                                   "adamw": 0}


def test_every_source_has_its_ctypes_signatures():
    # the CPU never loads a library, so check here that each source's C
    # entry points are declared with as many arguments as the source has
    import re
    from repro_torch.kernels import _build
    assert set(_build.SOURCES) == set(_build.SIGNATURES) == set(ops.KERNELS)
    assert "flash_attention_wg_launch" in _build.SIGNATURES["flash_attention"]
    for name, fns in _build.SIGNATURES.items():
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert f'extern "C" const char* {name}_error_string(int code)' in src
        for fn, argtypes in fns.items():
            m = re.search(rf'extern "C" int {fn}\((.*?)\)\s*\{{', src,
                          re.S)
            assert m, fn
            params = [a for a in m.group(1).split(",") if a.strip()]
            assert len(params) == len(argtypes), fn


# ---------------------------------------------------------------------------
# flash_attention and selective_scan: the plain versions against the JAX
# Pallas kernels (interpret mode) and their jnp oracles, at the reference's
# shapes and tolerance (tests/test_kernels.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,sq,sk,hd,bq", [(2, 64, 64, 16, 32),
                                            (4, 128, 128, 32, 64),
                                            (1, 32, 32, 8, 32),
                                            (2, 64, 192, 64, 32),
                                            (1, 128, 128, 256, 64)])
def test_flash_attention_matches_jax(bh, sq, sk, hd, bq, causal):
    q = rng.standard_normal((bh, sq, hd)).astype(np.float32)
    k = rng.standard_normal((bh, sk, hd)).astype(np.float32)
    v = rng.standard_normal((bh, sk, hd)).astype(np.float32)
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    want = jax_flash(jq, jk, jv, bq=bq, bk=32, causal=causal)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-3, atol=2e-3)
    ref = flash_attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("sq,sk", [(13, 13), (77, 77), (20, 45)])
def test_flash_attention_ragged_lengths(sq, sk):
    # the TPU kernel needs Sq % bq == 0 and Sk % bk == 0; the port takes any
    # lengths, so these are held against the jnp oracle alone (causal
    # aligns query row i with key row i, as both packages do)
    q = rng.standard_normal((3, sq, 16)).astype(np.float32)
    k = rng.standard_normal((3, sk, 16)).astype(np.float32)
    v = rng.standard_normal((3, sk, 16)).astype(np.float32)
    for causal in (True, False):
        got = flash_attention(_t(q), _t(k), _t(v), causal=causal).numpy()
        ref = flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal)
        np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-3,
                                   atol=2e-3)


def test_flash_attention_bf16_keeps_dtype():
    q = _t(rng.standard_normal((2, 9, 16)).astype(np.float32))
    out = flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16())
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), flash_attention(q, q, q),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_ignores_nan_past_sk(causal):
    # k and v as contiguous [:, :Sk] views of buffers that hold NaN past
    # Sk: nothing past Sk may reach the output
    sq, sk, hd = 77, 77, 16
    q = rng.standard_normal((1, sq, hd)).astype(np.float32)
    kv = [rng.standard_normal((1, sk, hd)).astype(np.float32)
          for _ in range(2)]
    bufs = [torch.full((1, 128, hd), float("nan")) for _ in range(2)]
    for buf, x in zip(bufs, kv):
        buf[:, :sk] = _t(x)
    k, v = (buf[:, :sk] for buf in bufs)
    assert k.is_contiguous() and v.is_contiguous()
    got = flash_attention(_t(q), k, v, causal=causal).numpy()
    assert np.isfinite(got).all()
    ref = flash_attention_ref(jnp.asarray(q), jnp.asarray(kv[0]),
                              jnp.asarray(kv[1]), causal=causal)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dtype,hd,sq,route", [
    (torch.bfloat16, 64, 64, "wgmma"), (torch.bfloat16, 256, 64, "wgmma"),
    (torch.bfloat16, 64, 1500, "wgmma"), (torch.bfloat16, 256, 8192, "wgmma"),
    (torch.bfloat16, 64, 63, "mma"), (torch.bfloat16, 256, 1, "mma"),
    (torch.bfloat16, 128, 2048, "mma"), (torch.bfloat16, 16, 2048, "mma"),
    (torch.bfloat16, 32, 64, "mma"), (torch.float32, 64, 1500, "f32"),
    (torch.float32, 256, 2048, "f32"), (torch.float32, 128, 1, "f32")])
def test_flash_route(dtype, hd, sq, route):
    # the forward's kernel by (dtype, hd, Sq): the wgmma kernel takes bf16
    # at hd 64 and 256 from one warpgroup's 64 rows; hd 128, hd 16 and 32,
    # a decode tick's Sq = 1 and float32 keep their kernels
    assert flash_module._route(dtype, hd, sq) == route


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 16, "mma"), (torch.bfloat16, 32, "mma"),
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.float32, 64, "f32"),
    (torch.float32, 256, "f32")])
def test_flash_bwd_route(dtype, hd, route):
    # the backward's kernels by (dtype, hd): bf16 at hd 64 and 128 (the
    # one-pass kernel) and 256 (its dK/dV and dQ blocks) on wgmma, hd 16
    # and 32 on mma.sync, float32 on FMAs
    assert flash_module._bwd_route(dtype, hd) == route


def test_flash_attention_bad_shapes_raise():
    q = torch.ones(2, 8, 16)
    with pytest.raises(ValueError):
        flash_attention(q, torch.ones(3, 8, 16), torch.ones(3, 8, 16))
    with pytest.raises(ValueError):
        flash_attention(q, q.bfloat16(), q)


def _scan_inputs(r, b, s, d, n):
    a = np.exp(-np.abs(r.standard_normal((b, s, d, n)))).astype(np.float32)
    bx = (r.standard_normal((b, s, d, n)) * 0.1).astype(np.float32)
    c = r.standard_normal((b, s, n)).astype(np.float32)
    return a, bx, c


@pytest.mark.parametrize("b,s,d,n,bd,bk", [(2, 32, 16, 4, 8, 8),
                                           (1, 64, 32, 8, 16, 16)])
def test_selective_scan_matches_jax(b, s, d, n, bd, bk):
    a, bx, c = _scan_inputs(np.random.default_rng(0), b, s, d, n)
    got = selective_scan(_t(a), _t(bx), _t(c)).numpy()
    ja, jb, jc = jnp.asarray(a), jnp.asarray(bx), jnp.asarray(c)
    want = jax_scan(ja, jb, jc, bd=bd, bk=bk)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, np.asarray(selective_scan_ref(ja, jb, jc)),
                               rtol=2e-3, atol=2e-3)


def _scan_f64(a, bx, c, h0):
    h = h0.astype(np.float64)
    y = np.empty(a.shape[:3])
    for t in range(a.shape[1]):
        h = a[:, t] * h + bx[:, t]
        y[:, t] = np.einsum("bdn,bn->bd", h, c[:, t])
    return y, h


@pytest.mark.parametrize("b,s,d,n", [(2, 13, 16, 4), (1, 40, 24, 16),
                                     (3, 1, 5, 2)])
def test_selective_scan_state_in_and_out(b, s, d, n):
    r = np.random.default_rng(s)
    a, bx, c = _scan_inputs(r, b, s, d, n)
    h0 = r.standard_normal((b, d, n)).astype(np.float32)
    y, h = selective_scan(_t(a), _t(bx), _t(c), _t(h0), return_state=True)
    want_y, want_h = _scan_f64(a, bx, c, h0)
    np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), want_h, rtol=1e-5, atol=1e-5)
    # two chunks carried through the state are the whole sequence
    cut = s // 2
    y1, h1 = selective_scan(_t(a[:, :cut]), _t(bx[:, :cut]), _t(c[:, :cut]),
                            _t(h0), return_state=True)
    y2, h2 = selective_scan(_t(a[:, cut:]), _t(bx[:, cut:]), _t(c[:, cut:]),
                            h1, return_state=True)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), want_y,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h2.numpy(), want_h, rtol=1e-5, atol=1e-5)


def test_selective_scan_bad_shapes_raise():
    a = torch.ones(1, 3, 4, 2)
    with pytest.raises(ValueError):
        selective_scan(a, a, torch.ones(1, 3, 4))
    with pytest.raises(ValueError):
        selective_scan(a, a, torch.ones(1, 3, 2), torch.ones(1, 2, 4))


def _fused_inputs(r, b, s, d, n):
    """dt, A, Bm, Cm, x as the model hands them to the fused entry: dt
    after softplus, A = -exp(a_log)."""
    dt = np.log1p(np.exp(r.uniform(-5.0, -1.0, (b, s, d)))).astype(np.float32)
    a = -np.tile(np.arange(1, n + 1, dtype=np.float32), (d, 1)) \
        * r.uniform(0.5, 1.5, (d, 1)).astype(np.float32)
    bm, cm = (r.standard_normal((b, s, n)).astype(np.float32)
              for _ in range(2))
    x = r.standard_normal((b, s, d)).astype(np.float32)
    return dt, a, bm, cm, x


@pytest.mark.parametrize("b,s,d,n", [(2, 13, 16, 4), (1, 40, 24, 16),
                                     (3, 1, 5, 2)])
def test_selective_scan_fused_plain_is_the_recurrence(b, s, d, n):
    # a = exp(dt·A), bx = (dt·x)·B into the same recurrence, from h0, with
    # the final state; checked in float64
    r = np.random.default_rng(s)
    dt, a, bm, cm, x = _fused_inputs(r, b, s, d, n)
    h0 = r.standard_normal((b, d, n)).astype(np.float32)
    y, h = selective_scan_fused(*(_t(v) for v in (dt, a, bm, cm, x, h0)),
                                return_state=True)
    da = np.exp(dt[..., None].astype(np.float64) * a)
    dbx = (dt.astype(np.float64) * x)[..., None] * bm[:, :, None, :]
    want_y, want_h = _scan_f64(da, dbx, cm, h0)
    np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), want_h, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        selective_scan_fused(*(_t(v) for v in (dt, a, bm, cm, x))).numpy(),
        selective_scan_fused_plain(*(_t(v) for v in (dt, a, bm, cm,
                                                       x))).numpy())


def test_selective_scan_fused_bad_shapes_raise():
    dt = torch.ones(1, 3, 4)
    a, bm = -torch.ones(4, 2), torch.ones(1, 3, 2)
    with pytest.raises(ValueError):
        selective_scan_fused(dt, a, bm, bm, torch.ones(1, 3, 5))
    with pytest.raises(ValueError):
        selective_scan_fused(dt, -torch.ones(5, 2), bm, bm, dt)
    with pytest.raises(ValueError):
        selective_scan_fused(dt, a, torch.ones(1, 3, 4), bm, dt)
    with pytest.raises(ValueError):
        selective_scan_fused(dt, a, bm, bm, dt, torch.ones(1, 4, 3))


@pytest.mark.parametrize("op", ["+", "min", "max"])
def test_segment_reduce_plain_reads_int64_ids_as_int32(op):
    r = np.random.default_rng(3)
    ids = r.integers(-4, 40, 500)
    vals = _t(r.standard_normal((500, 3)).astype(np.float32))
    a = segment_reduce_plain(_t(ids.astype(np.int64)), vals, 37, op)
    b = segment_reduce_plain(_t(ids.astype(np.int32)), vals, 37, op)
    assert torch.equal(a, b)


@pytest.mark.parametrize("n,k,d,path", [
    (2 ** 24, 64, 1, "small"), (2 ** 26, 256, 1, "small"),
    (2 ** 26, 2 ** 17, 1, "staged"), (2 ** 26, 2 ** 20, 1, "staged"),
    (2 ** 26, 4_847_571, 1, "staged"), (1_884_909, 4_847_571, 1, "staged"),
    (2 ** 24, 4096, 8, "large"), (100_000, 9_000_000, 1, "large"),
    (100_000, 40_000_000, 1, "global"), (0, 300, 1, "small")])
def test_segment_plan(n, k, d, path):
    # one range's work split (the main paths' ranges, pagerank's last of
    # 1,884,909 rows among them) is a function of the sizes alone; buckets
    # fit a block's shared memory and pass 1's counters, there are enough
    # of them to fill the card where K allows, and few enough for the
    # scatter to stage its sectors at the main paths' shapes
    plan = segment_module._plan
    blocks, shift, scratch = plan(n, d, k, d)
    assert plan(n, d, k, d) == (blocks, shift, scratch) and blocks >= 1
    if path == "small":
        assert shift == -1 and k * d <= segment_module._SMALL_CELLS
        assert scratch == (blocks * k * d * 4 if blocks > 1 else 0)
        return
    nb = -(-k >> shift)
    assert nb <= segment_module._MAX_BUCKETS
    assert ((1 << shift) * d <= segment_module._SLICE_CELLS) == \
        (path != "global")
    if path == "staged":
        assert d == 1 and nb <= segment_module._STAGE_BUCKETS
    if path != "global":
        assert nb >= min(segment_module._MIN_BUCKETS, k * d // 2048)
    # the rows' ids and values and the counts fit the scratch
    assert scratch >= 4 * n + 4 * n * d + 4 * nb * blocks * 8
    assert plan(n, d, k, 0)[2] == scratch - 4 * n * d


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["+", "min", "max"])
@pytest.mark.parametrize("n,k,d", [(100_000, 256, 1), (100_000, 70_000, 1),
                                   (50_000, 300, 8)])
def test_cuda_segment_reduce_matches_plain(cuda, op, n, k, d):
    r = np.random.default_rng(n + k)
    ids = _t(r.integers(-3, k + 3, n).astype(np.int32)).to(cuda)
    vals = _t(r.standard_normal((n, d) if d > 1 else n)
              .astype(np.float32)).to(cuda)
    before = segment_reduce.launches
    got = segment_reduce(ids, vals, k, op=op)
    want = segment_reduce_plain(ids, vals, k, op)
    assert segment_reduce.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_tile_matmul_matches_plain(cuda, dtype):
    r = np.random.default_rng(5)
    a = _t(r.standard_normal((300, 260)).astype(np.float32)).to(cuda, dtype)
    b = _t(r.standard_normal((260, 140)).astype(np.float32)).to(cuda, dtype)
    mask = _t(r.integers(0, 2, (3, 3)).astype(np.float32)).to(cuda)
    got = tile_matmul(a, b, mask)
    want = tile_matmul_plain(a, b, mask)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,bm", [(300, 260, 140, 128),
                                      (100, 70, 90, 32)])
def test_cuda_tile_matmul_packed_matches_plain(cuda, dtype, m, k, n, bm):
    r = np.random.default_rng(m)
    a = _t(r.standard_normal((m, k)).astype(np.float32)).to(cuda, dtype)
    b = _t(r.standard_normal((k, n)).astype(np.float32)).to(cuda, dtype)
    t = pack(a, bm, bm, prune_zero=False)
    t.mask[0, 0] = 0.0
    before = tile_matmul.launches
    got = tile_matmul_packed(t.tiles, t.mask, t.shape, b)
    want = tile_matmul_packed_plain(t.tiles, t.mask, t.shape, b)
    assert tile_matmul.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,sq,sk,hd,causal", [(4, 128, 128, 128, True),
                                                (3, 77, 77, 64, True),
                                                (2, 50, 130, 32, False),
                                                (5, 1, 1, 16, True)])
def test_cuda_flash_attention_matches_plain(cuda, dtype, bh, sq, sk, hd,
                                            causal):
    r = np.random.default_rng(sq)
    q, k = (_t(r.standard_normal((bh, s_, hd)).astype(np.float32))
            .to(cuda, dtype) for s_ in (sq, sk))
    v = _t(r.standard_normal((bh, sk, hd)).astype(np.float32)).to(cuda, dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    want = flash_attention_plain(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype
    # bf16 output rounding and float32 sums in another order
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    assert _flash_row_err(got, want) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,s,d,n", [(1, 256, 512, 16), (2, 77, 300, 16),
                                     (1, 13, 64, 4)])
def test_cuda_selective_scan_matches_plain(cuda, with_h0, b, s, d, n):
    r = np.random.default_rng(s)
    a, bx, c = (_t(x).to(cuda) for x in _scan_inputs(r, b, s, d, n))
    h0 = _t(r.standard_normal((b, d, n)).astype(np.float32)).to(cuda) \
        if with_h0 else None
    before = selective_scan.launches
    y, h = selective_scan(a, bx, c, h0, return_state=True)
    assert selective_scan.launches == before + 1
    wy, wh = selective_scan_plain(a, bx, c, h0, return_state=True)
    for got, want in ((y, wy), (h, wh)):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-4 * scale
    torch.testing.assert_close(selective_scan(a, bx, c) if h0 is None
                               else y, wy, rtol=1e-4, atol=1e-4)


def _scan_err(got, want):
    """Largest error over the largest |value| of the plain version."""
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,s,d,n", [(1, 256, 512, 16), (2, 77, 300, 16),
                                     (1, 1, 64, 16), (1, 13, 40, 4),
                                     (1, 130, 96, 32)])
def test_cuda_selective_scan_fused_matches_plain(cuda, x_dtype, with_h0, b, s,
                                                 d, n):
    # ragged S (tiles of 64 steps) and D (blocks of 32 channels), S = 1,
    # h0 and h_last, bf16 x widened in registers; expf against torch.exp
    r = np.random.default_rng(s + d)
    dt, a, bm, cm, x = (_t(v).to(cuda) for v in _fused_inputs(r, b, s, d, n))
    x = x.to(x_dtype)
    h0 = _t(r.standard_normal((b, d, n)).astype(np.float32)).to(cuda) \
        if with_h0 else None
    before = ops.launch_counts()
    y, h = selective_scan_fused(dt, a, bm, cm, x, h0, return_state=True)
    after = ops.launch_counts()
    assert after["selective_scan"] == before["selective_scan"]
    assert after["selective_scan_fused"] == \
        before["selective_scan_fused"] + 1
    wy, wh = selective_scan_fused_plain(dt, a, bm, cm, x, h0,
                                        return_state=True)
    assert _scan_err(y, wy) <= 1e-4 and _scan_err(h, wh) <= 1e-4
    assert torch.equal(selective_scan_fused(dt, a, bm, cm, x, h0), y)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("fused", [False, True])
def test_cuda_selective_scan_every_state_count(cuda, n, fused):
    # each N takes its own template instance (two states a thread on N / 2
    # lanes; one state on one lane at N = 1): all give the plain scan
    r = np.random.default_rng(n)
    b, s, d = 1, 100, 200
    h0 = _t(r.standard_normal((b, d, n)).astype(np.float32)).to(cuda)
    if fused:
        ins = [_t(v).to(cuda) for v in _fused_inputs(r, b, s, d, n)]
        got = selective_scan_fused(*ins, h0, return_state=True)
        want = selective_scan_fused_plain(*ins, h0, return_state=True)
    else:
        ins = [_t(v).to(cuda) for v in _scan_inputs(r, b, s, d, n)]
        got = selective_scan(*ins, h0, return_state=True)
        want = selective_scan_plain(*ins, h0, return_state=True)
    for g_, w_ in zip(got, want):
        assert _scan_err(g_, w_) <= 1e-4


@pytest.mark.cuda
def test_cuda_mamba_prefill_allocates_nothing_n_wide(cuda):
    # one fused call per layer over the whole prompt: the prefill's peak
    # stays below one [B, S, d_inner, N] float32 tensor above its start
    # (discretising the prompt as one chunk would hold two), and its output
    # matches the CPU's plain path
    from repro_torch.configs import smoke_config
    from repro_torch.models.ssm import mamba_forward, ssm_defs
    cfg = smoke_config("falcon-mamba-7b").replace(d_model=512, ssm_state=16,
                                                  scan_chunk=1024)
    r = np.random.default_rng(0)
    defs = ssm_defs(cfg)
    p = {}
    for name, pd in defs.items():
        v = r.standard_normal(pd.shape) * (pd.shape[0] ** -0.5)
        if name == "a_log":
            v = np.log(np.tile(np.arange(1, cfg.ssm_state + 1),
                               (cfg.d_inner, 1)))
        elif name == "dt_bias":
            v = r.uniform(-4.0, -2.0, pd.shape)
        p[name] = _t(v.astype(np.float32))
    s = 1024
    x = _t(r.standard_normal((1, s, cfg.d_model)).astype(np.float32))
    pc = {k: v.to(cuda) for k, v in p.items()}
    xc = x.to(cuda)
    # cuBLAS allocates its workspace (32 MiB on an H100) through PyTorch's
    # allocator at a stream's first product, and keeps it: whether that
    # lands in the window below depends on what ran before in the process.
    # One product first, so that the window holds the prefill's own
    # allocations alone
    (xc[0, :8] @ pc["in_proj"][:, :8]).sum().item()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = selective_scan_fused.launches
    out, state = mamba_forward(cfg, pc, xc, return_state=True)
    torch.cuda.synchronize()
    n_wide = 4 * s * cfg.d_inner * cfg.ssm_state
    assert torch.cuda.max_memory_allocated() - base < n_wide
    assert selective_scan_fused.launches == before + 1
    ref, ref_state = mamba_forward(cfg, p, x, return_state=True)
    assert _scan_err(out.cpu(), ref) <= 1e-4
    assert _scan_err(state["h"].cpu(), ref_state["h"]) <= 1e-4


def _segment_inputs(cuda, n, k, d, id_dtype=torch.int32, seed=0):
    r = np.random.default_rng(seed)
    ids = _t(r.integers(-3, k + 3, n)).to(cuda, id_dtype)
    vals = _t(r.standard_normal((n, d) if d > 1 else n)
              .astype(np.float32)).to(cuda)
    return ids, vals


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,d", [(1 << 20, 256, 1), (1 << 20, 64, 1),
                                   (1 << 20, 70_000, 1), (300_000, 4096, 8),
                                   (1 << 20, (1 << 20) + 3, 1),
                                   (1 << 20, 4_847_571, 1)])
def test_cuda_segment_reduce_deterministic(cuda, n, k, d):
    # float + gives the same bits on three launches, small and large K
    ids, vals = _segment_inputs(cuda, n, k, d)
    runs = [segment_reduce(ids, vals, k) for _ in range(3)]
    assert all(torch.equal(runs[0], x) for x in runs[1:])
    want = segment_reduce_plain(ids, vals, k)
    scale = segment_reduce_plain(ids, vals.abs(), k)
    assert bool(((runs[0] - want).abs() <= 1e-4 * scale + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("t,k,d", [(96, 8, 256), (300, 2, 448), (4, 8, 2048)])
def test_cuda_moe_combine_matches_plain(cuda, t, k, d):
    # the MoE combine's shape at small widths: t tokens of k bf16 rows each
    # (ids in runs of k), widened to float32; the same bits on two
    # launches, the plain version's and the reshape-sum's values
    r = np.random.default_rng(t + k)
    ids = torch.arange(t, device=cuda).repeat_interleave(k)
    vals = _t(r.standard_normal((t * k, d)).astype(np.float32)) \
        .to(cuda, torch.bfloat16)
    before = segment_reduce.launches
    got = segment_reduce(ids, vals, t)
    again = segment_reduce(ids, vals, t)
    assert segment_reduce.launches == before + 2
    assert got.dtype == torch.float32 and torch.equal(got, again)
    want = segment_reduce_plain(ids, vals, t)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, vals.float().view(t, k, d).sum(1),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_moe_layer_matches_cpu_and_refuses_a_gradient(cuda):
    # the smoke qwen3-moe MoE layer on the card (the combine through the
    # kernel, one launch) against the CPU (its plain version), float32;
    # under autograd its output has a history (no refusal is left), and
    # the gradients of its input and weights are the CPU's
    from repro_torch.configs import smoke_config
    from repro_torch.models import moe
    cfg = smoke_config("qwen3-moe-30b-a3b")
    r = np.random.default_rng(3)
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {"router": r.standard_normal((d, e)) * d ** -0.5,
         "w_gate": r.standard_normal((e, d, ff)) * d ** -0.5,
         "w_in": r.standard_normal((e, d, ff)) * d ** -0.5,
         "w_out": r.standard_normal((e, ff, d)) * ff ** -0.5}
    p = {n: _t(v.astype(np.float32)) for n, v in p.items()}
    x = _t(r.standard_normal((2, 40, d)).astype(np.float32))
    want = moe.moe_local(cfg, p, x)
    pc = {n: v.to(cuda) for n, v in p.items()}
    before = segment_reduce.launches
    got = moe.moe_local(cfg, pc, x.to(cuda))
    assert segment_reduce.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    xg = x.to(cuda).requires_grad_(True)
    pg = {n: v.clone().requires_grad_() for n, v in pc.items()}
    out = moe.moe_local(cfg, pg, xg)
    assert out.grad_fn is not None
    dy = torch.randn(out.shape, generator=torch.Generator().manual_seed(4))
    got = torch.autograd.grad(out, [xg, *pg.values()], dy.to(cuda))
    xc = x.clone().requires_grad_(True)
    pcpu = {n: v.clone().requires_grad_() for n, v in p.items()}
    want = torch.autograd.grad(moe.moe_local(cfg, pcpu, xc),
                               [xc, *pcpu.values()], dy)
    for g, w in zip(got, want):
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * max(
            1.0, float(w.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("hot", [0.25, 1.0])
@pytest.mark.parametrize("k,d", [(64, 1), (70_000, 1), (4_847_571, 1),
                                 (4096, 8)])
def test_cuda_segment_reduce_hot_key(cuda, hot, k, d):
    # a share of the rows on one id crowds whole 32-row groups: the same
    # bits on two launches, and the plain version's sums within tolerance
    ids, vals = _segment_inputs(cuda, 1 << 20, k, d, seed=k)
    ids = torch.where(torch.rand(ids.shape, device=cuda) < hot, 7, ids)
    ids = ids.to(torch.int32)
    for op in ("+", "max"):
        got = segment_reduce(ids, vals, k, op=op)
        assert torch.equal(got, segment_reduce(ids, vals, k, op=op))
        want = segment_reduce_plain(ids, vals, k, op)
        if op == "+":
            scale = segment_reduce_plain(ids, vals.abs(), k)
            assert bool(((got - want).abs() <= 1e-4 * scale + 1e-6).all())
        else:
            assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["+", "min", "max"])
@pytest.mark.parametrize("n,k,d", [(100_000, 256, 1), (100_000, 70_001, 1),
                                   (50_000, 300, 8), (100_000, 9_000_000, 1),
                                   (100_000, 40_000_000, 1),
                                   (300_000, 4_847_571, 1)])
def test_cuda_segment_reduce_int64_ids(cuda, op, n, k, d):
    # int64 ids are read as they are, and give the int32 ids' bits; K not a
    # multiple of the bucket size, more buckets than the scatter can stage,
    # a K too large for shared memory, pagerank's K
    ids, vals = _segment_inputs(cuda, n, k, d, torch.int64, seed=k)
    got = segment_reduce(ids, vals, k, op=op)
    assert torch.equal(got, segment_reduce(ids.to(torch.int32), vals, k,
                                           op=op))
    want = segment_reduce_plain(ids, vals, k, op)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["+", "min", "max"])
@pytest.mark.parametrize("k", [5, 70_001])
def test_cuda_segment_reduce_edges(cuda, op, k):
    # no rows, every row dropped, no segments
    empty_ids = torch.zeros(0, dtype=torch.int32, device=cuda)
    got = segment_reduce(empty_ids, torch.zeros(0, device=cuda), k, op=op)
    assert torch.equal(got, segment_reduce_plain(empty_ids.cpu(),
                                                 torch.zeros(0), k, op)
                       .to(cuda))
    ids = torch.tensor([-1, k, k + 7, -9] * 1000, dtype=torch.int32,
                       device=cuda)
    vals = torch.full((4000, 2), float("nan"), device=cuda)
    got = segment_reduce(ids, vals, k, op=op)
    assert torch.equal(got, segment_reduce_plain(ids, vals, k, op))
    before = segment_reduce.launches
    none = segment_reduce(ids, vals, 0, op=op)
    assert tuple(none.shape) == (0, 2) and segment_reduce.launches == before
    ints = segment_reduce(ids, vals.to(torch.int32), k, op=op)
    assert torch.equal(ints, segment_reduce_plain(ids, vals.to(torch.int32),
                                                  k, op))


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["+", "min", "max"])
@pytest.mark.parametrize("k", [256, 70_000])
def test_cuda_segment_reduce_rows_in_parts(cuda, op, k):
    # rows are reduced a range of RANGE_ROWS at a time and the ranges
    # combined in row order, so a chunked run (range by range, folded in
    # order) gives the whole run's bits; the plain version's result, the
    # same bits twice
    rows = segment_module.RANGE_ROWS
    n = 2 * rows + 12_345
    ids, vals = _segment_inputs(cuda, n, k, 1, seed=3)
    before = segment_reduce.launches
    got = segment_reduce(ids, vals, k, op=op)
    assert segment_reduce.launches == before + 3
    assert torch.equal(got, segment_reduce(ids, vals, k, op=op))
    combine = {"+": torch.add, "min": torch.minimum, "max": torch.maximum}
    chunked = None
    for i in range(0, n, rows):
        part = segment_reduce(ids[i:i + rows], vals[i:i + rows], k, op=op)
        chunked = part if chunked is None else combine[op](chunked, part)
    assert torch.equal(got.view(torch.int32), chunked.view(torch.int32))
    if op != "+":
        assert torch.equal(got, segment_reduce_plain(ids, vals, k, op))
        return
    # float32 sums of ~n/k values each: against float64 sums, within 1e-5
    # of each segment's sum of |v|
    idx = torch.where((ids >= 0) & (ids < k), ids.long(), k)
    exact, scale = (torch.zeros(k + 1, dtype=torch.float64, device=cuda)
                    .index_add_(0, idx, v)[:k]
                    for v in (vals.double(), vals.double().abs()))
    assert bool(((got.double() - exact).abs() <= 1e-5 * scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [256, 70_000, 4_847_571])
def test_cuda_segment_reduce_broadcast_row(cuda, k):
    # a value expanded from one row (vstride 0) is read, never copied
    r = np.random.default_rng(k)
    ids = _t(r.integers(-2, k + 2, 200_000).astype(np.int32)).to(cuda)
    vals = torch.ones(1, device=cuda).expand(200_000)
    got = segment_reduce(ids, vals, k)
    assert torch.equal(got, segment_reduce_plain(ids, vals, k))


# the edges of the tensor-core flash kernel (64-row query tiles, 64-key
# tiles in a two-stage ring) and of the register-blocked tile kernel
# (128×128 output tiles, 16-deep k-tiles, k-ranges per packing tile)

def _flash_row_err(got, want):
    """The worst query row's largest error over that row's largest |value|
    in the plain version.  Per row, since a row that attends to i keys has
    outputs of about sqrt(e/i): a scale over the whole tensor is set by the
    first rows and would pass a dropped or stale key tile in long rows."""
    diff = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1).clamp_min(1e-30)
    return float((diff / scale).max())


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("sq,sk,causal", [(1, 1, True), (63, 63, True),
                                          (65, 65, True), (777, 777, True),
                                          (50, 130, False)])
def test_cuda_flash_attention_bf16_edges(cuda, hd, sq, sk, causal):
    r = np.random.default_rng(hd * 1000 + sq)
    q, k, v = (_t(r.standard_normal((2, s_, hd)).astype(np.float32))
               .to(cuda, torch.bfloat16) for s_ in (sq, sk, sk))
    got = flash_attention(q, k, v, causal=causal)
    want = flash_attention_plain(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _flash_row_err(got, want) <= 1e-2      # bf16 output rounding


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("s,window", [(1, 16), (63, 16), (200, 16),
                                      (200, 64), (333, 100), (130, 200)])
def test_cuda_flash_attention_window(cuda, dtype, hd, s, window):
    # a local window (recurrentgemma-2b's lattn layers): windows below,
    # at and above the tile sizes, prompts shorter and longer than the
    # window, ragged tiles; two launches give the same bits
    r = np.random.default_rng(s * 7 + window + hd)
    q, k, v = (_t(r.standard_normal((3, s, hd)).astype(np.float32))
               .to(cuda, dtype) for _ in range(3))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True, window=window)
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=True, window=window)
    assert got.dtype == dtype and got.shape == want.shape
    assert _flash_row_err(got, want) <= \
        (1e-2 if dtype == torch.bfloat16 else 1e-4)
    assert torch.equal(flash_attention(q, k, v, causal=True, window=window),
                       got)
    _, lse = flash_attention(q, k, v, causal=True, window=window,
                             return_lse=True)
    _, want_lse = flash_attention_plain(q, k, v, causal=True, window=window,
                                        return_lse=True)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,causal", [(1, 1, True), (65, 65, True),
                                          (777, 777, True), (50, 130, False),
                                          (1, 300, False)])
def test_cuda_flash_attention_hd256(cuda, dtype, sq, sk, causal):
    r = np.random.default_rng(sq + sk)
    q = _t(r.standard_normal((2, sq, 256)).astype(np.float32)).to(cuda, dtype)
    k, v = (_t(r.standard_normal((2, sk, 256)).astype(np.float32))
            .to(cuda, dtype) for _ in range(2))
    got = flash_attention(q, k, v, causal=causal)
    want = flash_attention_plain(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == want.shape
    assert _flash_row_err(got, want) <= \
        (1e-2 if dtype == torch.bfloat16 else 1e-4)


# the wgmma route of the bf16 forward (hd 64 and 256 from 64 query rows):
# 64-row warpgroup tiles, blocks of one or two warpgroups, 64- or 128-key
# tiles in a ring of two K and three V stages

def _bf16_qkv(cuda, seed, bh, sq, sk, hd):
    r = np.random.default_rng(seed)
    return [_t(r.standard_normal((bh, s_, hd)).astype(np.float32))
            .to(cuda, torch.bfloat16) for s_ in (sq, sk, sk)]


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 256])
@pytest.mark.parametrize("sq,sk,causal", [(64, 64, True), (65, 65, True),
                                          (63, 63, True), (200, 333, False),
                                          (333, 200, False), (777, 777, True),
                                          (130, 1500, False), (300, 130, True),
                                          (64, 1, False)])
def test_cuda_flash_wg_matches_plain(cuda, hd, sq, sk, causal):
    # ragged Sq and Sk on both sides of the route's edge (Sq = 63 stays on
    # mma.sync), causal with Sq > Sk, a single key
    q, k, v = _bf16_qkv(cuda, hd + sq * 3 + sk, 3, sq, sk, hd)
    before = ops.launch_counts()
    got = flash_attention(q, k, v, causal=causal)
    after = ops.launch_counts()
    wg = flash_module._route(q.dtype, hd, sq) == "wgmma"
    assert wg == (sq >= 64)
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["flash_attention[wg]"] == before["flash_attention[wg]"] + wg
    want = flash_attention_plain(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _flash_row_err(got, want) <= 1e-2      # bf16 output rounding


@pytest.mark.cuda
@pytest.mark.parametrize("s,window", [(64, 1), (64, 63), (200, 64),
                                      (300, 128), (513, 100), (1000, 256),
                                      (777, 700)])
def test_cuda_flash_wg_window_edges(cuda, s, window):
    # hd 256 within a window: windows below, at and above the 64-key tile
    # and the 128-row block, blocks whose second warpgroup starts tiles
    # after the first; the lse against the plain version's
    q, k, v = _bf16_qkv(cuda, s + window, 2, s, s, 256)
    before = ops.launch_counts()["flash_attention[wg]"]
    got, lse = flash_attention(q, k, v, causal=True, window=window,
                               return_lse=True)
    assert ops.launch_counts()["flash_attention[wg]"] == before + 1
    want, want_lse = flash_attention_plain(q, k, v, causal=True,
                                           window=window, return_lse=True)
    assert _flash_row_err(got, want) <= 1e-2
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_wg_ignores_nan_past_sk(cuda, hd, causal):
    # k and v as views of buffers that hold NaN past Sk: the staging rows
    # past Sk are zero-filled, so nothing there reaches the output
    sq, sk = 130, 77
    q, k0, v0 = _bf16_qkv(cuda, hd + causal, 2, sq, sk, hd)
    bufs = [torch.full((2, 192, hd), float("nan"), device=cuda,
                       dtype=torch.bfloat16) for _ in range(2)]
    bufs[0][:, :sk], bufs[1][:, :sk] = k0, v0
    k, v = (buf[:, :sk] for buf in bufs)
    got = flash_attention(q, k, v, causal=causal)
    assert bool(torch.isfinite(got).all())
    want = flash_attention_plain(q, k0, v0, causal=causal)
    assert _flash_row_err(got, want) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("hd,sq,sk,causal,window", [
    (64, 1500, 1500, False, 0), (64, 448, 1500, False, 0),
    (256, 1024, 1024, True, 0), (256, 700, 700, True, 256)])
def test_cuda_flash_wg_lse_entry_same_bits(cuda, hd, sq, sk, causal,
                                           window):
    # the training entry (with lse) gives the serving entry's output bit
    # for bit, and two launches of each give the same bits
    q, k, v = _bf16_qkv(cuda, sq + hd, 2, sq, sk, hd)
    kw = dict(causal=causal, window=window)
    got = flash_attention(q, k, v, **kw)
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, got)
    assert torch.equal(flash_attention(q, k, v, **kw), got)
    out2, lse2 = flash_attention(q, k, v, return_lse=True, **kw)
    assert torch.equal(out2, out) and torch.equal(lse2, lse)
    _, want_lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,window", [(64, 0), (256, 0), (64, 16)])
def test_cuda_flash_grad_refuses_what_the_backward_lacks(cuda, hd, window):
    # every form yields gradients with a history on the card, float32 with
    # a window at hd 64 too; bf16 refuses a window only at hd 64 and 128
    # (the one-pass wgmma kernel), with a ValueError from the backward
    from repro_torch.kernels.flash_attention import flash_attention_grad
    q = torch.randn(2, 32, hd, device=cuda, requires_grad=True)
    out = flash_attention_grad(q, q, q, window=window)
    assert out.grad_fn is not None
    g, = torch.autograd.grad(out.sum(), q)
    assert bool(torch.isfinite(g).all())
    if window:
        qb = q.detach().bfloat16().requires_grad_()
        ob = flash_attention_grad(qb, qb, qb, window=window)
        with pytest.raises(ValueError, match="no window in the bf16"):
            torch.autograd.grad(ob.sum(), qb)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d", [(1, 2048, 2560), (2, 77, 300),
                                   (3, 1, 40)])
def test_cuda_selective_scan_rglru(cuda, b, s, d):
    # the rec layer's call: N = 1, c = 1 (y is the state), h0 and h_last
    r = np.random.default_rng(d)
    a = _t(np.exp(-np.abs(r.standard_normal((b, s, d, 1)))).astype(
        np.float32)).to(cuda)
    bx = _t(r.standard_normal((b, s, d, 1)).astype(np.float32)).to(cuda)
    c = torch.ones(b, s, 1, device=cuda)
    h0 = _t(r.standard_normal((b, d, 1)).astype(np.float32)).to(cuda)
    before = selective_scan.launches
    y, h = selective_scan(a, bx, c, h0, return_state=True)
    assert selective_scan.launches == before + 1
    wy, wh = selective_scan_plain(a, bx, c, h0, return_state=True)
    assert _scan_err(y, wy) <= 1e-5 and _scan_err(h, wh) <= 1e-5
    torch.testing.assert_close(y[:, -1], h[..., 0], rtol=0, atol=0)
    y2, h2 = selective_scan(a, bx, c, h0, return_state=True)
    assert torch.equal(y, y2) and torch.equal(h, h2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_nan_past_sk(cuda, dtype, causal):
    # k and v are contiguous [:, :Sk] views of buffers holding NaN past Sk:
    # the kernel's staging of the ragged last key tile must not read them
    sq, sk, hd = 77, 77, 64
    r = np.random.default_rng(77)
    q = _t(r.standard_normal((1, sq, hd)).astype(np.float32)).to(cuda, dtype)
    bufs = [torch.full((1, 256, hd), float("nan"), device=cuda, dtype=dtype)
            for _ in range(2)]
    for buf in bufs:
        buf[:, :sk] = _t(r.standard_normal((1, sk, hd))
                         .astype(np.float32)).to(cuda, dtype)
    k, v = (buf[:, :sk] for buf in bufs)
    assert k.is_contiguous() and v.is_contiguous()
    got = flash_attention(q, k, v, causal=causal)
    want = flash_attention_plain(q, k, v, causal=causal)
    assert bool(torch.isfinite(got).all())
    assert _flash_row_err(got, want) <= \
        (1e-2 if dtype == torch.bfloat16 else 1e-4)


def _half_mask(r, mt, kt, cuda):
    mask = np.zeros(mt * kt, np.float32)
    mask[r.permutation(mt * kt)[: (mt * kt + 1) // 2]] = 1.0
    mask = mask.reshape(mt, kt)
    mask[0, 0] = 0.0
    return _t(mask).to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,bm", [(384, 512, 256, 128),
                                      (100, 70, 90, 32)])
@pytest.mark.parametrize("packed", [False, True])
def test_cuda_tile_matmul_half_masked(cuda, m, k, n, bm, packed):
    # bm = bk = 128: each block's rows and each k-range lie in one packing
    # tile (the main path); bm = 32: a block spans four tile rows and every
    # size is ragged
    r = np.random.default_rng(m + k)
    a = _t(r.standard_normal((m, k)).astype(np.float32)).to(cuda)
    b = _t(r.standard_normal((k, n)).astype(np.float32)).to(cuda)
    mask = _half_mask(r, -(-m // bm), -(-k // bm), cuda)
    before = tile_matmul.launches
    if packed:
        t = pack(a, bm, bm, prune_zero=False)
        got = tile_matmul_packed(t.tiles, mask, t.shape, b)
        want = tile_matmul_packed_plain(t.tiles, mask, t.shape, b)
    else:
        got = tile_matmul(a, b, mask, bm=bm, bk=bm)
        want = tile_matmul_plain(a, b, mask, bm=bm, bk=bm)
    assert tile_matmul.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,bm", [(384, 512, 256, 128),
                                      (100, 70, 90, 32)])
def test_cuda_tile_matmul_nan_in_absent_tiles(cuda, m, k, n, bm):
    r = np.random.default_rng(3 * m)
    a = _t(r.standard_normal((m, k)).astype(np.float32)).to(cuda)
    b = _t(r.standard_normal((k, n)).astype(np.float32)).to(cuda)
    t = pack(a, bm, bm, prune_zero=False)
    mask = _half_mask(r, *t.mask.shape, cuda)
    tiles = t.tiles.clone()
    tiles[mask == 0] = float("nan")
    got = tile_matmul_packed(tiles, mask, t.shape, b)
    want = tile_matmul_packed_plain(tiles, mask, t.shape, b)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,bm", [(384, 512, 256, 128),
                                      (100, 70, 90, 32)])
def test_cuda_tile_matmul_mask_values(cuda, m, k, n, bm):
    r = np.random.default_rng(5 * m)
    a = _t(r.standard_normal((m, k)).astype(np.float32)).to(cuda)
    b = _t(r.standard_normal((k, n)).astype(np.float32)).to(cuda)
    mt, kt = -(-m // bm), -(-k // bm)
    mask = _t(r.choice(np.array([0.0, 0.5, 1.0, 2.0], np.float32),
                       (mt, kt))).to(cuda)
    t = pack(a, bm, bm, prune_zero=False)
    torch.testing.assert_close(tile_matmul_packed(t.tiles, mask, t.shape, b),
                               tile_matmul_packed_plain(t.tiles, mask,
                                                        t.shape, b),
                               rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(tile_matmul(a, b, mask, bm=bm, bk=bm),
                               tile_matmul_plain(a, b, mask, bm=bm, bk=bm),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_cuda_tile_matmul_transposed_lhs(cuda, masked):
    # a [M, K] lhs with strides (1, M): no element of a k-quad is
    # contiguous, so every A load takes the scalar path
    r = np.random.default_rng(11)
    x = _t(r.standard_normal((260, 300)).astype(np.float32)).to(cuda)
    b = _t(r.standard_normal((260, 140)).astype(np.float32)).to(cuda)
    a = x.t()
    assert not a.is_contiguous()
    mask = _half_mask(r, 3, 3, cuda) if masked else None
    torch.testing.assert_close(tile_matmul(a, b, mask),
                               tile_matmul_plain(a, b, mask),
                               rtol=1e-4, atol=1e-3)
