"""The PyTorch port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper of `repro_torch.kernels` runs its plain PyTorch
version; the JAX kernels run in interpret mode.  The sweeps and tolerances
are those of tests/test_kernels.py.  The CUDA kernels themselves need a
card: the tests marked `cuda` hold them against their plain versions and
skip here.  They need no jax, so on the machine with the card, which has
none, they run alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py
"""
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
                                                 flash_attention_plain)
from repro_torch.kernels.segment_reduce import (segment_reduce,
                                                segment_reduce_plain,
                                                segment_sum)
from repro_torch.kernels.selective_scan import (selective_scan,
                                                selective_scan_plain)
from repro_torch.core.tiles import pack
from repro_torch.kernels.tile_matmul import (tile_matmul, tile_matmul_packed,
                                             tile_matmul_packed_plain,
                                             tile_matmul_plain)

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
    a = torch.ones(1, 3, 4, 2)
    selective_scan(a, a, torch.ones(1, 3, 2), return_state=True)
    assert ops.launch_counts() == {"segment_reduce": 0, "tile_matmul": 0,
                                   "flash_attention": 0, "selective_scan": 0}


def test_every_source_has_its_ctypes_signatures():
    # the CPU never loads a library, so check here that each source's C
    # entry points are declared with as many arguments as the source has
    import re
    from repro_torch.kernels import _build
    assert set(_build.SOURCES) == set(_build.SIGNATURES) == set(ops.KERNELS)
    for name, fns in _build.SIGNATURES.items():
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert f'extern "C" const char* {name}_error_string(int code)' in src
        for fn, argtypes in fns.items():
            m = re.search(rf'extern "C" int {fn}\((.*?)\)\s*\{{', src,
                          re.S)
            assert m, fn
            assert len(m.group(1).split(",")) == len(argtypes), fn


# ---------------------------------------------------------------------------
# flash_attention and selective_scan: the plain versions against the JAX
# Pallas kernels (interpret mode) and their jnp oracles, at the reference's
# shapes and tolerance (tests/test_kernels.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,sq,sk,hd,bq", [(2, 64, 64, 16, 32),
                                            (4, 128, 128, 32, 64),
                                            (1, 32, 32, 8, 32)])
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
