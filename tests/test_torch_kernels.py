"""The PyTorch port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper of `repro_torch.kernels` runs its plain PyTorch
version; the JAX kernels run in interpret mode.  The sweeps and tolerances
are those of tests/test_kernels.py.  The CUDA kernels themselves need a
card: the tests marked `cuda` hold them against their plain versions and
skip here."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_reduce import segment_reduce as jax_segment_reduce
from repro.kernels.segment_reduce import segment_sum as jax_segment_sum
from repro.kernels.segment_reduce_ref import segment_reduce_ref
from repro.kernels.tile_matmul import tile_matmul as jax_tile_matmul
from repro_torch.kernels import ops
from repro_torch.kernels.segment_reduce import (segment_reduce,
                                                segment_reduce_plain,
                                                segment_sum)
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


def test_cpu_wrappers_count_no_launches():
    ops.reset_launch_counts()
    segment_reduce(_t(np.zeros(3, np.int32)), _t(np.ones(3, np.float32)), 2)
    tile_matmul(torch.ones(4, 4), torch.ones(4, 4))
    t = pack(torch.ones(4, 4), 2, 2)
    tile_matmul_packed(t.tiles, t.mask, t.shape, torch.ones(4, 4))
    assert ops.launch_counts() == {"segment_reduce": 0, "tile_matmul": 0}


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
