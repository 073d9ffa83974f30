"""The port's tile-skipping score op and its plain kernel version
(src/repro_torch/kernels/knn_score) against the JAX package's, on the same
seeded inputs: the op against ``repro.kernels.knn_score.ops.knn_score``
(interpret mode) and ``knn_score_plain`` against ``knn_score_pallas``
(interpret mode) on the same active lists, within rtol=1e-5, atol=1e-6
(the two sum the tile products in different orders); ``densify`` and
``densify_tile`` byte for byte."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.knn_score.kernel import knn_score_pallas  # noqa: E402
from repro.kernels.knn_score.ops import knn_score as jax_knn_score  # noqa: E402
from repro.sparse.format import SparseBatch as JaxBatch  # noqa: E402
from repro.sparse.format import densify as jax_densify  # noqa: E402
from repro.sparse.format import densify_tile as jax_densify_tile  # noqa: E402
from repro_torch.kernels.knn_score.kernel import knn_score_cuda  # noqa: E402
from repro_torch.kernels.knn_score.ops import (  # noqa: E402
    _pad_rows,
    active_lists,
    dense_tiles_with_sentinel,
    knn_score,
)
from repro_torch.kernels.knn_score.ref import dense_oracle, knn_score_plain  # noqa: E402
from repro_torch.sparse.datagen import synthetic_sparse  # noqa: E402
from repro_torch.sparse.format import densify, densify_tile, from_arrays, tile_occupancy  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def _both(n, dim, seed, nnz_mean=15, nnz_std=4):
    """(JAX batch, port batch) made from the same numpy arrays."""
    b = synthetic_sparse(n, dim=dim, nnz_mean=nnz_mean, nnz_std=nnz_std, seed=seed)
    idx, val, nnz = b.indices.numpy(), b.values.numpy(), b.nnz.numpy()
    return (JaxBatch(jnp.asarray(idx), jnp.asarray(val), jnp.asarray(nnz), dim),
            from_arrays(idx, val, nnz, dim))


# the five shapes of tests/test_kernels.py::test_knn_score_shapes
SHAPES = [  # nr, ns, dim, tile, block_r, block_s
    (64, 64, 256, 128, 64, 64),
    (70, 90, 640, 128, 64, 64),      # padding rows
    (128, 64, 384, 128, 128, 32),    # uneven blocks
    (32, 32, 512, 256, 32, 32),      # wider tile
    (16, 200, 1024, 128, 16, 64),    # tall-thin
]


@pytest.mark.parametrize("nr,ns,dim,tile,br,bs", SHAPES)
def test_knn_score_op_matches_jax(nr, ns, dim, tile, br, bs):
    jr, pr = _both(nr, dim, seed=nr + ns)
    js, ps = _both(ns, dim, seed=nr * ns)
    want = np.asarray(jax_knn_score(jr, js, tile=tile, block_r=br, block_s=bs, interpret=True))
    before = knn_score_cuda.launches
    got = knn_score(pr, ps, tile=tile, block_r=br, block_s=bs, device="cpu")
    assert knn_score_cuda.launches == before   # the plain version ran
    assert got.shape == (nr, ns) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    dense = densify(pr) @ densify(ps).T
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("nr,ns,dim,tile,br,bs", [
    (64, 64, 512, 128, 32, 32),
    (200, 90, 640, 128, 104, 24),    # block 104, ragged S
    (48, 100, 1024, 256, 16, 32),    # tile 256, small blocks
])
def test_knn_score_plain_matches_pallas(nr, ns, dim, tile, br, bs):
    """The plain version and the Pallas kernel on the same tile arrays and
    active lists; both equal the dense oracle on the real rows."""
    _, pr = _both(nr, dim, seed=3 + nr)
    _, ps = _both(ns, dim, seed=4 + ns)
    r_tiles = _pad_rows(dense_tiles_with_sentinel(pr, tile), br)
    s_tiles = _pad_rows(dense_tiles_with_sentinel(ps, tile), bs)
    active = torch.from_numpy(active_lists(tile_occupancy(pr, tile).numpy(),
                                           tile_occupancy(ps, tile).numpy(), br, bs))
    got = knn_score_plain(r_tiles, s_tiles, active, block_r=br, block_s=bs)
    want = knn_score_pallas(jnp.asarray(r_tiles.numpy()), jnp.asarray(s_tiles.numpy()),
                            jnp.asarray(active.numpy()), block_r=br, block_s=bs,
                            interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), dense_oracle(r_tiles, s_tiles).numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,dim,seed", [(48, 512, 0), (70, 640, 160), (33, 1000, 7)])
def test_densify_byte_identical(n, dim, seed):
    jb, pb = _both(n, dim, seed=seed, nnz_mean=20, nnz_std=5)
    got, want = densify(pb).numpy(), np.asarray(jax_densify(jb))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    for start, tile in ((0, 128), (256, 128), (dim - 100, 128), (128, 256)):
        got = densify_tile(pb, start, tile).numpy()
        want = np.asarray(jax_densify_tile(jb, start, tile))
        assert got.shape == want.shape and got.tobytes() == want.tobytes()


def test_knn_score_cuda_rejects_other_devices():
    t = torch.zeros(2, 8, 4, device="meta")
    with pytest.raises(ValueError):
        knn_score_cuda(t, t, torch.zeros(1, 1, 8, dtype=torch.int32, device="meta"),
                       block_r=8, block_s=8)
