"""§5 packed (tiled) matrices in the PyTorch port, against the JAX package:
pack/unpack, the block-sparse product on the tiles, and a packed lhs
through the matmul program at full extent (TiledMatmul) and at partial
extents (the guard fails and the einsum fallback runs)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compile_program as jax_compile
from repro.core import parse_program as jax_parse
from repro.core.programs import matrix_multiplication as jax_matmul
from repro.core.tiles import matmul_tiled as jax_matmul_tiled
from repro.core.tiles import pack as jax_pack
from repro.core.tiles import unpack as jax_unpack
from repro_torch.convert import tiled_from_arrays
from repro_torch.core import compile_program, parse_program
from repro_torch.core.programs import matrix_multiplication
from repro_torch.core.tiles import TiledMatrix, matmul_tiled, pack, unpack


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _sparse(rng, h, w, zero_rows):
    m = rng.standard_normal((h, w))
    m[:zero_rows] = 0.0
    return m


@pytest.mark.parametrize("h,w,bm,bn", [(50, 37, 16, 16), (64, 64, 32, 32),
                                       (40, 20, 16, 8)])
def test_pack_unpack_equal_reference(h, w, bm, bn):
    rng = np.random.default_rng(h + w)
    m = _sparse(rng, h, w, zero_rows=bm)
    ours = pack(_t(m), bm, bn)
    ref = jax_pack(jnp.asarray(m, jnp.float32), bm, bn)
    np.testing.assert_array_equal(ours.tiles.numpy(), np.asarray(ref.tiles))
    np.testing.assert_array_equal(ours.mask.numpy(), np.asarray(ref.mask))
    assert ours.shape == ref.shape and ours.tile_shape == ref.tile_shape
    np.testing.assert_array_equal(unpack(ours).numpy(),
                                  np.asarray(jax_unpack(ref)))
    np.testing.assert_allclose(unpack(ours).numpy(), m, rtol=1e-6)


def test_zero_tiles_pruned():
    m = np.zeros((64, 64), np.float32)
    m[40, 40] = 1.0
    t = pack(_t(m), bm=32, bn=32)
    assert float(t.mask.sum()) == 1.0
    np.testing.assert_array_equal(unpack(t).numpy(), m)


def test_tiled_from_arrays_rebuilds_the_reference_matrix():
    rng = np.random.default_rng(9)
    m = _sparse(rng, 40, 30, zero_rows=16)
    ref = jax_pack(jnp.asarray(m, jnp.float32), 16, 16)
    ours = tiled_from_arrays(np.asarray(ref.tiles), np.asarray(ref.mask),
                             ref.shape, "cpu")
    assert isinstance(ours, TiledMatrix)
    own = pack(_t(m), 16, 16)
    assert torch.equal(ours.tiles, own.tiles)
    assert torch.equal(ours.mask, own.mask)
    assert ours.shape == own.shape == (40, 30)


@pytest.mark.parametrize("n,l,m,bm", [(40, 20, 30, 16), (64, 64, 48, 32)])
def test_matmul_tiled_equals_reference(n, l, m, bm):
    rng = np.random.default_rng(n)
    a = _sparse(rng, n, l, zero_rows=bm)
    b = rng.standard_normal((l, m))
    ours = matmul_tiled(pack(_t(a), bm, bm), _t(b))
    ref = jax_matmul_tiled(jax_pack(jnp.asarray(a, jnp.float32), bm, bm),
                           jnp.asarray(b, jnp.float32))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(ours.numpy(), a @ b, rtol=1e-4, atol=1e-4)


def matmul_inner(M: matrix, N: matrix, R: matrix, n: dim, m: dim, l: dim):
    for i in range(1, n - 1):
        for j in range(0, m):
            for k in range(0, l):
                R[i, j] += M[i, k] * N[k, j]


def _packed_inputs(seed, n=40, m=30, l=20, bm=16):
    rng = np.random.default_rng(seed)
    M = _sparse(rng, n, l, zero_rows=bm)
    N = rng.standard_normal((l, m))
    return M, N, dict(N=N, R=np.zeros((n, m)), n=n, m=m, l=l)


@pytest.mark.parametrize("op_select", ["cost", "force:pallas-tiled",
                                       "force:unpack-einsum"])
def test_packed_lhs_full_extent(op_select):
    M, N, rest = _packed_inputs(3)
    cp = compile_program(matrix_multiplication, op_select=op_select,
                         device="cpu")
    ours = cp.run(dict(rest, M=pack(_t(M), 16, 16)))
    ref = jax_compile(jax_matmul, op_select=op_select).run(
        dict(rest, M=jax_pack(jnp.asarray(M, jnp.float32), 16, 16)))
    np.testing.assert_allclose(ours["R"].numpy(), np.asarray(ref["R"]),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(ours["R"].numpy(), M @ N, rtol=1e-3,
                               atol=1e-4)
    want = {"cost": "tiled:unpack-einsum[cost]",
            "force:pallas-tiled": "tiled:pallas-tiled[pinned]",
            "force:unpack-einsum": "tiled:unpack-einsum[pinned]"}[op_select]
    assert f"selected: {want}" in cp.explain(tiled={"M"})


def test_packed_lhs_partial_extent_falls_back_to_einsum():
    # rows range(1, n-1): the packed lhs is not used at full extent, so the
    # TiledMatmul guard fails and its einsum runs on the unpacked tiles
    M, N, rest = _packed_inputs(4)
    ours_p, ref_p = parse_program(matmul_inner), jax_parse(matmul_inner)
    cp = compile_program(ours_p, op_select="force:pallas-tiled",
                         device="cpu")
    ours = cp.run(dict(rest, M=pack(_t(M), 16, 16)))
    ref = jax_compile(ref_p, op_select="force:pallas-tiled").run(
        dict(rest, M=jax_pack(jnp.asarray(M, jnp.float32), 16, 16)))
    np.testing.assert_allclose(ours["R"].numpy(), np.asarray(ref["R"]),
                               rtol=1e-3, atol=1e-4)
    want = np.zeros_like(M @ N)
    want[1:-1] = (M @ N)[1:-1]
    np.testing.assert_allclose(ours["R"].numpy(), want, rtol=1e-3, atol=1e-4)
    assert "tiled:" not in cp.explain(tiled={"M"})


def test_packed_lhs_through_the_cuda_cost_row():
    # on the card the cost model sends the packed product to the tile
    # kernel; on CPU tensors the same choice runs its plain version
    M, N, rest = _packed_inputs(5)
    cp = compile_program(matrix_multiplication, device="cpu")
    cp.selector.platform = "cuda"
    ours = cp.run(dict(rest, M=pack(_t(M), 16, 16)))
    np.testing.assert_allclose(ours["R"].numpy(), M @ N, rtol=1e-3,
                               atol=1e-4)
    assert "selected: tiled:pallas-tiled[cost]" in cp.explain(tiled={"M"})
