"""The port's CUDA kernel on the card: knn_topk_fused against its plain
version, and the fused-kernel join path in both modes.  Every test here
needs a CUDA device and skips without one.  The file imports neither jax
nor repro, so it runs on a machine with the card alone:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.blocknl import knn_join  # noqa: E402
from repro_torch.core.engine import JoinSpec, SparseKNNIndex  # noqa: E402
from repro_torch.core.topk import init_topk, min_prune_score  # noqa: E402
from repro_torch.kernels.knn_score.ops import (  # noqa: E402
    _pad_rows,
    active_lists,
    dense_tiles_with_sentinel,
)
from repro_torch.kernels.knn_topk.kernel import knn_topk_fused  # noqa: E402
from repro_torch.kernels.knn_topk.ops import column_meta, pad_state  # noqa: E402
from repro_torch.kernels.knn_topk.ref import knn_topk_plain  # noqa: E402
from repro_torch.sparse.datagen import synthetic_sparse  # noqa: E402
from repro_torch.sparse.format import tile_occupancy  # noqa: E402
from repro_torch.testing import assert_topk_close  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the knn_topk kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(dev, nr, ns, dim, br, bs, k, masked):
    R = synthetic_sparse(nr, dim=dim, nnz_mean=12, nnz_std=4, seed=nr + ns).to(dev)
    S = synthetic_sparse(ns, dim=dim, nnz_mean=12, nnz_std=4, seed=nr * ns).to(dev)
    r_tiles = _pad_rows(dense_tiles_with_sentinel(R, 128), br)
    s_tiles = _pad_rows(dense_tiles_with_sentinel(S, 128), bs)
    active = torch.as_tensor(active_lists(tile_occupancy(R, 128).cpu().numpy(),
                                          tile_occupancy(S, 128).cpu().numpy(), br, bs),
                             device=dev)
    s_valid = np.random.default_rng(ns).random(ns) > 0.3 if masked else None
    valid, ids = column_meta(ns, s_tiles.shape[1], s_valid=s_valid, device=dev)
    state = init_topk(nr, k, device=dev)
    init_s, init_i = pad_state(state, r_tiles.shape[1])
    args = (r_tiles, s_tiles, active, valid, ids, init_s, init_i)
    kwargs = dict(thr=min_prune_score(state).reshape(1, 1), block_r=br, block_s=bs,
                  nr_valid=torch.full((1,), nr, dtype=torch.int32, device=dev))
    return args, kwargs


@pytest.mark.parametrize("nr,ns,dim,br,bs,k,masked", [
    (70, 90, 640, 64, 64, 5, False),        # padded rows, ragged S block
    (48, 100, 512, 16, 32, 12, False),      # k % 8 != 0, small blocks
    (300, 1100, 512, 256, 256, 128, False),  # k = 128, ragged S block
    (40, 300, 512, 32, 96, 7, True),        # masked columns, chunk-ragged block_s
])
def test_kernel_matches_plain(cuda, nr, ns, dim, br, bs, k, masked):
    args, kwargs = _inputs(cuda, nr, ns, dim, br, bs, k, masked)
    before = knn_topk_fused.launches
    got = knn_topk_fused(*args, **kwargs)
    torch.cuda.synchronize()
    assert knn_topk_fused.launches == before + 1
    want = knn_topk_plain(*args, **kwargs)
    assert_topk_close(got[0].cpu().numpy(), got[1].cpu().numpy(), want[0].cpu().numpy(),
                      want[1].cpu().numpy(), RTOL, ATOL)
    np.testing.assert_allclose(got[2].cpu().numpy(), want[2].cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


def test_kernel_rejects_bad_inputs(cuda):
    args, kwargs = _inputs(cuda, 70, 90, 640, 64, 64, 5, False)
    with pytest.raises(TypeError):
        knn_topk_fused(args[0].double(), *args[1:], **kwargs)
    with pytest.raises(ValueError):
        knn_topk_fused(*args, **dict(kwargs, block_r=512))
    with pytest.raises(ValueError):
        knn_topk_fused(args[0], args[1].cpu(), *args[2:], **kwargs)


def test_join_modes_on_card_match_cpu(cuda):
    """Cached and streaming on the card: one launch per R block, one per
    (R block, S block) pair, and the CPU plain path's answer."""
    R = synthetic_sparse(300, dim=2000, nnz_mean=40, seed=0)
    S = synthetic_sparse(700, dim=2000, nnz_mean=40, seed=1)
    spec = JoinSpec(k=5, algorithm="iib", r_block=128, s_block=256, use_kernel=True)
    before = knn_topk_fused.launches
    res = SparseKNNIndex.build(S, spec).query(R)
    assert knn_topk_fused.launches == before + 3 == before + res.stats.device_dispatches
    out = knn_join(R, S, 5, algorithm="iib", r_block=128, s_block=256, use_kernel=True)
    assert knn_topk_fused.launches == before + 3 + 3 * 3
    cpu = SparseKNNIndex.build(S, spec, device="cpu").query(R)
    for got in (res.state, out):
        assert_topk_close(got.scores.cpu().numpy(), got.ids.cpu().numpy(),
                          cpu.scores.numpy(), cpu.ids.numpy(), RTOL, ATOL)
