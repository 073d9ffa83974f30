"""The port's CUDA kernels on the card: knn_topk_fused, knn_score_cuda,
topk_merge_cuda (k <= 128 and the large-k kernel), flash_attention_cuda
(f32 in 3xTF32 and bf16, both on the tensor cores, at every head width
up to 256) and wkv_cuda (chunks 8 to 128) against their plain versions,
merge_topk_states, the public ops, the wrappers' input checks, the
fused-kernel join path in both modes, with the k > 128 route and a tile
that is not a multiple of 4, and the paper's three drivers (BF, IIB
without the kernel, IIIB) in both modes, each block step merging through
topk_merge_cuda, and the datastore's lifecycle (extend, delete,
expire, compact, refreeze) and the approx tier on every path, with the
join kernels held to their plain versions on masked columns, and the
sharded store (4 shards, exact and approx, and 2 replicas through a
failover) against its CPU path, its merges counted on topk_merge_cuda,
and the multi-device join: the ring and the store over meshes that
repeat the card (and, where there are two cards, over distinct ones).
Every test here needs a CUDA device and skips without one.  The file imports neither jax
nor repro, so it runs on a machine with the card alone:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.blocknl import knn_join  # noqa: E402
from repro_torch.core.engine import JoinSpec, JoinStats, SparseKNNIndex  # noqa: E402
from repro_torch.core.topk import TopKState, init_topk, merge_topk_states, min_prune_score  # noqa: E402,E501
from repro_torch.kernels.flash_attn.kernel import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.flash_attn.ops import flash_sdpa  # noqa: E402
from repro_torch.kernels.flash_attn.ref import flash_attention_plain  # noqa: E402
from repro_torch.kernels.knn_score.kernel import knn_score_cuda  # noqa: E402
from repro_torch.kernels.knn_score.ops import (  # noqa: E402
    _pad_rows,
    active_lists,
    dense_tiles_with_sentinel,
    knn_score,
)
from repro_torch.kernels.knn_score.ref import knn_score_plain  # noqa: E402
from repro_torch.kernels.knn_topk.kernel import knn_topk_fused  # noqa: E402
from repro_torch.kernels.knn_topk.ops import column_meta, pad_state, score_then_merge  # noqa: E402,E501
from repro_torch.kernels.knn_topk.ref import knn_topk_plain  # noqa: E402
from repro_torch.kernels.topk_merge.kernel import insert_candidates, topk_merge_cuda  # noqa: E402
from repro_torch.kernels.topk_merge.ref import topk_merge_plain  # noqa: E402
from repro_torch.kernels.legacy import flash_attn_v1, topk_merge_v1, wkv_v1  # noqa: E402
from repro_torch.kernels.wkv.kernel import wkv_cuda  # noqa: E402
from repro_torch.kernels.wkv.ops import wkv  # noqa: E402
from repro_torch.kernels.wkv.ref import wkv_plain  # noqa: E402
from repro_torch.models.attention import _causal_mask, _sdpa  # noqa: E402
from repro_torch.models.rwkv6 import _chunked_wkv  # noqa: E402
from repro_torch.sparse.datagen import spectra_like, synthetic_sparse  # noqa: E402
from repro_torch.sparse.format import tile_occupancy  # noqa: E402
from repro_torch.testing import (  # noqa: E402
    assert_topk_close,
    doubled,
    flash_close,
    with_zero_rows,
    wkv_close,
)

RTOL, ATOL = 1e-5, 1e-6
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(dev, nr, ns, dim, br, bs, k, masked, variant=None):
    """A fused call's (args, kwargs).  ``variant``: "ties" (S's second half
    repeats its first: equal scores in two S ranges), "warm" (a warm state
    and its MinPruneScore from a first pass over other S rows), or
    "warm-no-offer" (that, with R block 1 zeroed: it offers nothing)."""
    R = synthetic_sparse(nr, dim=dim, nnz_mean=12, nnz_std=4, seed=nr + ns).to(dev)
    if variant == "ties":
        S = doubled(synthetic_sparse(ns // 2, dim=dim, nnz_mean=12, nnz_std=4, seed=7)).to(dev)
    else:
        S = synthetic_sparse(ns, dim=dim, nnz_mean=12, nnz_std=4, seed=nr * ns).to(dev)
    state = init_topk(nr, k, device=dev)
    if variant in ("warm", "warm-no-offer"):
        first = synthetic_sparse(ns, dim=dim, nnz_mean=12, nnz_std=4, seed=5).to(dev)
        f_tiles = _pad_rows(dense_tiles_with_sentinel(first, 128), bs)
        r_tiles = _pad_rows(dense_tiles_with_sentinel(R, 128), br)
        f_active = torch.as_tensor(active_lists(tile_occupancy(R, 128).cpu().numpy(),
                                                tile_occupancy(first, 128).cpu().numpy(), br, bs),
                                   device=dev)
        fv, fi = column_meta(ns, f_tiles.shape[1], s_offset=ns, device=dev)
        w_s, w_i, _ = knn_topk_plain(r_tiles, f_tiles, f_active, fv, fi,
                                     *pad_state(state, r_tiles.shape[1]), block_r=br, block_s=bs)
        state = TopKState(w_s[:nr], w_i[:nr])
        if variant == "warm-no-offer":
            R = with_zero_rows(R, br, 2 * br)
    r_tiles = _pad_rows(dense_tiles_with_sentinel(R, 128), br)
    s_tiles = _pad_rows(dense_tiles_with_sentinel(S, 128), bs)
    active = torch.as_tensor(active_lists(tile_occupancy(R, 128).cpu().numpy(),
                                          tile_occupancy(S, 128).cpu().numpy(), br, bs),
                             device=dev)
    s_valid = np.random.default_rng(ns).random(ns) > 0.3 if masked else None
    valid, ids = column_meta(ns, s_tiles.shape[1], s_valid=s_valid, device=dev)
    init_s, init_i = pad_state(state, r_tiles.shape[1])
    args = (r_tiles, s_tiles, active, valid, ids, init_s, init_i)
    kwargs = dict(thr=min_prune_score(state).reshape(1, 1), block_r=br, block_s=bs,
                  nr_valid=torch.full((1,), nr, dtype=torch.int32, device=dev))
    return args, kwargs


@pytest.mark.parametrize("nr,ns,dim,br,bs,k,masked,variant", [
    (70, 90, 640, 64, 64, 5, False, None),        # padded rows, ragged S block
    (48, 100, 512, 16, 32, 12, False, None),      # k % 8 != 0, small blocks
    (300, 1100, 512, 256, 256, 128, False, None),  # k = 128, ragged S block, 5 ranges
    (40, 300, 512, 32, 96, 7, True, None),        # masked columns, tile-ragged block_s
    (70, 256, 640, 64, 32, 7, False, "ties"),     # equal scores in two of 8 S ranges
    (300, 1024, 512, 256, 128, 128, False, "ties"),  # k = 128, ties, 8 ranges
    (100, 320, 1024, 32, 64, 5, False, "warm-no-offer"),  # R block 1 offers nothing
    (200, 600, 1024, 104, 256, 5, False, "warm"),  # block_r 104, a seeded warm state
])
def test_kernel_matches_plain(cuda, nr, ns, dim, br, bs, k, masked, variant):
    args, kwargs = _inputs(cuda, nr, ns, dim, br, bs, k, masked, variant)
    before = knn_topk_fused.launches
    got = knn_topk_fused(*args, **kwargs)
    torch.cuda.synchronize()
    assert knn_topk_fused.launches == before + 1
    want = knn_topk_plain(*args, **kwargs)
    assert_topk_close(got[0].cpu().numpy(), got[1].cpu().numpy(), want[0].cpu().numpy(),
                      want[1].cpu().numpy(), RTOL, ATOL)
    np.testing.assert_allclose(got[2].cpu().numpy(), want[2].cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    if variant == "warm-no-offer":   # block 1 kept the seed threshold
        assert float(got[2][1]) == float(kwargs["thr"])
        assert torch.equal(got[0][br:2 * br], args[5][br:2 * br])
        # its seed's k-th scores lie above thr: the case tells "no offer" apart
        assert float(args[5][br:2 * br, -1].min()) > float(kwargs["thr"])


def test_kernels_repeat_bit_for_bit(cuda):
    """Two launches of each join kernel give bit-equal outputs: no atomics,
    one summation order."""
    args, kwargs = _inputs(cuda, 300, 1100, 512, 256, 128, 16, False, "warm")
    a, b = knn_topk_fused(*args, **kwargs), knn_topk_fused(*args, **kwargs)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    r_tiles, s_tiles, active = args[:3]
    sa = knn_score_cuda(r_tiles, s_tiles, active, block_r=256, block_s=128)
    sb = knn_score_cuda(r_tiles, s_tiles, active, block_r=256, block_s=128)
    assert torch.equal(sa, sb)


def test_kernel_rejects_bad_inputs(cuda):
    args, kwargs = _inputs(cuda, 70, 90, 640, 64, 64, 5, False)
    with pytest.raises(TypeError):
        knn_topk_fused(args[0].double(), *args[1:], **kwargs)
    with pytest.raises(ValueError):
        knn_topk_fused(*args, **dict(kwargs, block_r=512))
    with pytest.raises(ValueError):
        knn_topk_fused(args[0], args[1].cpu(), *args[2:], **kwargs)
    with pytest.raises(ValueError, match="16 bytes"):   # tile 126: not a multiple of 4
        knn_topk_fused(args[0][..., :126].contiguous(), args[1][..., :126].contiguous(),
                       *args[2:], **kwargs)
    shifted = torch.empty(args[0].numel() + 1, device=cuda)[1:].view(args[0].shape)
    shifted.copy_(args[0])
    with pytest.raises(ValueError, match="16 bytes"):   # r_tiles not 16-byte aligned
        knn_topk_fused(shifted, *args[1:], **kwargs)


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


@pytest.mark.parametrize("k,tile", [(150, 128), (5, 126)])
def test_join_large_k_and_odd_tile_on_card_match_cpu(cuda, k, tile):
    """k 150 takes the score and merge kernels (score_then_merge), one of
    each per R block cached and per pair streaming, and never the fused
    kernel; tile 126 runs the fused kernel on tiles padded to 128.  Both
    give the CPU path's answer."""
    R = synthetic_sparse(300, dim=2000, nnz_mean=40, seed=0)
    S = synthetic_sparse(700, dim=2000, nnz_mean=40, seed=1)
    spec = JoinSpec(k=k, algorithm="iib", r_block=128, s_block=256, tile=tile, use_kernel=True)
    counters = (knn_topk_fused, knn_score_cuda, topk_merge_cuda)
    before = [fn.launches for fn in counters]
    res = SparseKNNIndex.build(S, spec).query(R)
    out = knn_join(R, S, k, algorithm="iib", r_block=128, s_block=256, tile=tile,
                   use_kernel=True)
    launched = [fn.launches - b for fn, b in zip(counters, before)]
    assert res.stats.device_dispatches == 3
    assert launched == ([0, 3 + 3 * 3, 3 + 3 * 3] if k > 128 else [3 + 3 * 3, 0, 0])
    cpu = SparseKNNIndex.build(S, spec, device="cpu").query(R)
    for got in (res.state, out):
        assert got.scores.shape == (300, k)
        assert_topk_close(got.scores.cpu().numpy(), got.ids.cpu().numpy(),
                          cpu.scores.numpy(), cpu.ids.numpy(), RTOL, ATOL)


DRIVERS = ("bf", "iib", "iiib")


def _driver_data():
    """R 300 and S 700 rows at dim 2000: with r_block 128 and s_block 256
    the last R block (44 rows) and the last S block (188) are ragged."""
    return (synthetic_sparse(300, dim=2000, nnz_mean=40, seed=0),
            synthetic_sparse(700, dim=2000, nnz_mean=40, seed=1))


COUNTS = ("blocks", "tiles_scored", "list_entries", "dense_pairs", "index_builds",
          "device_dispatches", "host_syncs")


@pytest.mark.parametrize("algorithm", DRIVERS)
def test_drivers_on_card_match_cpu_and_each_other(cuda, algorithm, monkeypatch):
    """BF, IIB without the fused kernel and IIIB on the card, cached and
    streaming (and knn_join): bit for bit each other, within tolerance of
    the CPU path, the same counters, and one topk_merge_cuda launch per
    block step; no plain merge, torch.sort or torch.topk on the way."""
    R, S = _driver_data()
    spec = JoinSpec(k=5, algorithm=algorithm, r_block=128, s_block=256)
    cached_index = SparseKNNIndex.build(S, spec)
    stream_index = SparseKNNIndex.build(S, spec, cache_device_blocks=False)

    def refuse(*args, **kwargs):
        raise AssertionError("a plain merge ran on the card")

    for where in ("repro_torch.kernels.topk_merge.kernel.topk_merge_plain",
                  "repro_torch.core.topk.topk_update", "torch.sort", "torch.topk"):
        monkeypatch.setattr(where, refuse)
    before = topk_merge_cuda.launches
    cached = cached_index.query(R)
    assert topk_merge_cuda.launches - before == 3 * 3          # R blocks x S blocks
    before = topk_merge_cuda.launches
    stream = stream_index.query(R)
    assert topk_merge_cuda.launches - before == 3 * 3
    joined = knn_join(R, S, 5, algorithm=algorithm, r_block=128, s_block=256)
    monkeypatch.undo()
    assert cached.scores.device.type == "cuda"
    for got in (stream, joined):
        assert torch.equal(got.scores, cached.scores) and torch.equal(got.ids, cached.ids)
    cpu_stats = {}
    for mode in (True, False):
        st = JoinStats()
        cpu = SparseKNNIndex.build(S, spec, cache_device_blocks=mode, device="cpu").query(
            R, stats=st)
        cpu_stats[mode] = st
        assert_topk_close(cached.scores.cpu().numpy(), cached.ids.cpu().numpy(),
                          cpu.scores.numpy(), cpu.ids.numpy(), RTOL, ATOL)
    for mode, res in ((True, cached), (False, stream)):
        assert ({c: getattr(res.stats, c) for c in COUNTS}
                == {c: getattr(cpu_stats[mode], c) for c in COUNTS})
    if algorithm == "iiib":
        for g, w in zip(cached.stats.min_prune_trace, cpu_stats[True].min_prune_trace):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_iiib_warm_start_on_card(cuda):
    """IIIB's warm-start pass merges through the kernel too: one more
    launch per R block; the CPU path's answer and kept entries."""
    R, S = _driver_data()
    spec = JoinSpec(k=5, algorithm="iiib", r_block=128, s_block=256, warm_start=0.1)
    index = SparseKNNIndex.build(S, spec)
    before = topk_merge_cuda.launches
    res = index.query(R)
    assert topk_merge_cuda.launches - before == 3 * (3 + 1)
    stream = SparseKNNIndex.build(S, spec, cache_device_blocks=False).query(R)
    assert torch.equal(res.scores, stream.scores) and torch.equal(res.ids, stream.ids)
    cpu = SparseKNNIndex.build(S, spec, device="cpu").query(R)
    assert_topk_close(res.scores.cpu().numpy(), res.ids.cpu().numpy(), cpu.scores.numpy(),
                      cpu.ids.numpy(), RTOL, ATOL)
    assert res.stats.list_entries == cpu.stats.list_entries
    assert all(t[0] > -np.inf for t in res.stats.min_prune_trace)


@pytest.mark.parametrize("algorithm", DRIVERS)
def test_drivers_on_spectra_on_card_match_cpu(cuda, algorithm):
    R, S = spectra_like(200, dim=20_000, seed=0), spectra_like(600, dim=20_000, seed=1)
    spec = JoinSpec(k=5, algorithm=algorithm, r_block=128, s_block=256)
    res = SparseKNNIndex.build(S, spec).query(R)
    stream = SparseKNNIndex.build(S, spec, cache_device_blocks=False).query(R)
    assert torch.equal(res.scores, stream.scores) and torch.equal(res.ids, stream.ids)
    cpu = SparseKNNIndex.build(S, spec, device="cpu").query(R)
    assert_topk_close(res.scores.cpu().numpy(), res.ids.cpu().numpy(), cpu.scores.numpy(),
                      cpu.ids.numpy(), RTOL, ATOL)
    assert res.stats.list_entries == cpu.stats.list_entries


def _score_inputs(dev, nr, ns, dim, tile, br, bs):
    R = synthetic_sparse(nr, dim=dim, nnz_mean=15, nnz_std=4, seed=nr + ns).to(dev)
    S = synthetic_sparse(ns, dim=dim, nnz_mean=15, nnz_std=4, seed=nr * ns).to(dev)
    r_tiles = _pad_rows(dense_tiles_with_sentinel(R, tile), br)
    s_tiles = _pad_rows(dense_tiles_with_sentinel(S, tile), bs)
    active = torch.as_tensor(active_lists(tile_occupancy(R, tile).cpu().numpy(),
                                          tile_occupancy(S, tile).cpu().numpy(), br, bs),
                             device=dev)
    return R, S, r_tiles, s_tiles, active


@pytest.mark.parametrize("nr,ns,dim,tile,br,bs", [
    (64, 64, 256, 128, 64, 64),
    (70, 90, 640, 128, 64, 64),      # padding rows
    (128, 64, 384, 128, 128, 32),    # uneven blocks
    (32, 32, 512, 256, 32, 32),      # tile 256
    (16, 200, 1024, 128, 16, 64),    # tall-thin
    (200, 300, 1024, 128, 104, 24),  # block 104, ragged S
    (130, 250, 1024, 128, 104, 96),  # block_r 104, block_s 96, NS not a multiple of 128
    (300, 700, 2000, 128, 256, 256),
])
def test_knn_score_kernel_matches_plain(cuda, nr, ns, dim, tile, br, bs):
    R, S, r_tiles, s_tiles, active = _score_inputs(cuda, nr, ns, dim, tile, br, bs)
    before = knn_score_cuda.launches
    got = knn_score_cuda(r_tiles, s_tiles, active, block_r=br, block_s=bs)
    torch.cuda.synchronize()
    assert knn_score_cuda.launches == before + 1
    want = knn_score_plain(r_tiles, s_tiles, active, block_r=br, block_s=bs)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    op = knn_score(R, S, tile=tile, block_r=br, block_s=bs)   # the op runs on CUDA
    assert op.device.type == "cuda" and knn_score_cuda.launches == before + 2
    torch.testing.assert_close(op, want[:nr, :ns], rtol=RTOL, atol=ATOL)


def _merge_inputs(dev, seed, n, k, m, shared_ids, ties=False):
    g = torch.Generator().manual_seed(seed)
    levels = torch.tensor([float("-inf"), 0.25, 0.5, 1.0])
    ss = levels[torch.randint(0, 4, (n, k), generator=g)].sort(dim=1, descending=True).values
    si = torch.where(torch.isfinite(ss), torch.randint(0, 1000, (n, k), generator=g), -1)
    cs = torch.where(torch.rand((n, m), generator=g) < 0.5,
                     levels[torch.randint(0, 4, (n, m), generator=g)],
                     torch.rand((n, m), generator=g))
    if ties:
        cs = torch.full((n, m), 0.5)
    ci = (torch.arange(m) if shared_ids else torch.randint(0, 10**6, (n, m), generator=g))
    return [x.to(device=dev, dtype=torch.int32 if x.dtype == torch.int64 else x.dtype)
            for x in (ss, si, cs, ci)]


@pytest.mark.parametrize("n,k,m,shared_ids,ties", [
    (64, 1, 64, False, False),
    (100, 5, 300, True, False),      # M not a multiple of 32, shared ids
    (33, 8, 64, False, True),        # all candidates equal: ties
    (256, 16, 50, False, False),
    (40, 128, 200, True, False),     # k = 128
    (2048, 5, 10_240, True, False),  # the unfused path's shapes
])
def test_topk_merge_kernel_matches_plain(cuda, n, k, m, shared_ids, ties):
    args = _merge_inputs(cuda, n + m, n, k, m, shared_ids, ties)
    before = topk_merge_cuda.launches
    got = topk_merge_cuda(*args)
    torch.cuda.synchronize()
    assert topk_merge_cuda.launches == before + 1
    want = topk_merge_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n,k,m,shared_ids,ties,offset", [
    (300, 5, 1001, True, False, 0),     # M not a multiple of 4: rows off the 16-byte grid
    (64, 5, 1001, False, True, 1),      # every candidate tied: ties across slices
    (100, 33, 512, True, True, 3),      # the smallest M of the split kernel
    (50, 128, 2000, False, False, 2),
    (2048, 5, 10_240, True, False, 0),  # the unfused path's shapes
    (2048, 5, 10_240, True, True, 0),
])
def test_topk_merge_split_kernel_matches_plain_and_first_design(cuda, n, k, m, shared_ids,
                                                                ties, offset):
    """M >= 512 takes the split kernel (a CTA of eight warps a row); it
    equals the plain version and the warp-a-row first design bit for bit.
    ``offset`` starts the candidate scores 4 * offset bytes past a 16-byte
    boundary."""
    args = _merge_inputs(cuda, n + k + m, n, k, m, shared_ids, ties)
    if offset:
        padded = torch.empty(n * m + offset, dtype=torch.float32, device=cuda)
        padded[offset:] = args[2].reshape(-1)
        args[2] = padded[offset:].view(n, m)
        assert args[2].data_ptr() % 16 == 4 * offset
    before = topk_merge_cuda.launches
    got = topk_merge_cuda(*args)
    old = topk_merge_v1(*args)
    torch.cuda.synchronize()
    assert topk_merge_cuda.launches == before + 1
    want = topk_merge_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(old[0], want[0]) and torch.equal(old[1], want[1])


@pytest.mark.parametrize("n,k,m,shared_ids,ties", [
    (64, 129, 300, True, False),     # the smallest k of the large-k kernel; shared (M,) ids
    (100, 150, 500, False, True),    # all candidates equal: ties
    (33, 256, 256, True, False),
    (20, 1000, 3000, False, False),
    (16, 200, 1, False, False),      # one candidate column
    (4, 5000, 6000, True, False),    # the state in global scratch
])
def test_topk_merge_large_k_matches_plain(cuda, n, k, m, shared_ids, ties):
    args = _merge_inputs(cuda, n + k + m, n, k, m, shared_ids, ties)
    before = topk_merge_cuda.launches
    got = topk_merge_cuda(*args)
    torch.cuda.synchronize()
    assert topk_merge_cuda.launches == before + 1
    want = topk_merge_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_merge_topk_states_large_k_on_card(cuda):
    a = _merge_inputs(cuda, 3, 500, 200, 200, False)
    b = _merge_inputs(cuda, 4, 500, 200, 200, False)
    b[0][::3] = a[0][::3]   # rows tied between the shards
    before = topk_merge_cuda.launches
    got = merge_topk_states(TopKState(a[0], a[1]), TopKState(b[0], b[1]))
    assert topk_merge_cuda.launches == before + 1
    want = insert_candidates(a[0], a[1], b[0], b[1])
    assert torch.equal(got.scores, want[0]) and torch.equal(got.ids, want[1])


@pytest.mark.parametrize("k", [7, 150])
def test_score_then_merge_windows_on_card(cuda, k):
    """score_then_merge on the card in windows of 1 and 3 S blocks (the
    score kernel reading each window in place from the stack) equals one
    window bit for bit, one score and one merge launch a window; at k 7
    it equals the fused kernel bit for bit."""
    args, kwargs = _inputs(cuda, 300, 700, 2000, 128, 64, k, True, "ties")
    blk = dict(block_r=128, block_s=64)
    one = score_then_merge(*args, **blk)
    pairs = args[0].shape[1] * 64
    for blocks in (1, 3):
        before = (knn_score_cuda.launches, topk_merge_cuda.launches)
        got = score_then_merge(*args, **blk, max_scores=blocks * pairs)
        windows = -(-args[1].shape[1] // (blocks * 64))
        assert (knn_score_cuda.launches - before[0], topk_merge_cuda.launches - before[1]) == (
            windows, windows)
        assert torch.equal(got[0], one[0]) and torch.equal(got[1], one[1])
    if k <= 128:
        fused = knn_topk_fused(*args, **kwargs)
        assert torch.equal(fused[0], one[0]) and torch.equal(fused[1], one[1])


def test_merge_topk_states_kernel_is_the_plain_body(cuda):
    a = _merge_inputs(cuda, 1, 500, 5, 5, False)
    b = _merge_inputs(cuda, 2, 500, 5, 5, False)
    b[0][::3] = a[0][::3]   # rows tied between the shards
    before = topk_merge_cuda.launches
    got = merge_topk_states(TopKState(a[0], a[1]), TopKState(b[0], b[1]))
    assert topk_merge_cuda.launches == before + 1
    want = insert_candidates(a[0], a[1], b[0], b[1])
    assert torch.equal(got.scores, want[0]) and torch.equal(got.ids, want[1])


def test_score_and_merge_wrappers_reject_bad_inputs(cuda):
    _, _, r_tiles, s_tiles, active = _score_inputs(cuda, 70, 90, 640, 128, 64, 64)
    kw = dict(block_r=64, block_s=64)
    with pytest.raises(ValueError):   # another device
        knn_score_cuda(r_tiles, s_tiles.cpu(), active, **kw)
    with pytest.raises(TypeError):    # dtype
        knn_score_cuda(r_tiles, s_tiles, active.long(), **kw)
    with pytest.raises(ValueError):   # shape: NR not a multiple of block_r
        knn_score_cuda(r_tiles, s_tiles, active, block_r=48, block_s=64)
    with pytest.raises(ValueError):   # contiguity
        knn_score_cuda(r_tiles, s_tiles.transpose(1, 2).contiguous().transpose(1, 2),
                       active, **kw)
    with pytest.raises(ValueError, match="16 bytes"):   # tile 126: not a multiple of 4
        knn_score_cuda(r_tiles[..., :126].contiguous(), s_tiles[..., :126].contiguous(),
                       active, **kw)
    ss, si, cs, ci = _merge_inputs(cuda, 0, 32, 5, 40, False)
    with pytest.raises(ValueError):
        topk_merge_cuda(ss, si, cs, ci.cpu())
    with pytest.raises(TypeError):
        topk_merge_cuda(ss, si.long(), cs, ci)
    with pytest.raises(ValueError):
        topk_merge_cuda(ss, si, cs[:, :39], ci)
    with pytest.raises(ValueError):
        topk_merge_cuda(ss, si, cs.t().contiguous().t(), ci)
    empty = torch.full((32, 0), float("-inf"), device=cuda)
    with pytest.raises(ValueError, match="k must be"):
        topk_merge_cuda(empty, empty.int(), cs, ci)


def _qkv(dev, bh, kvh, sq, skv, hd, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dev, dtype)
            for shape in ((bh, sq, hd), (kvh, skv, hd), (kvh, skv, hd))]


@pytest.mark.parametrize("bh,kvh,sq,skv,hd,causal,window,dtype", [
    (2, 2, 128, 128, 64, True, 0, torch.float32),
    (3, 3, 128, 256, 64, False, 0, torch.float32),    # Sq != Skv
    (2, 2, 256, 128, 32, True, 0, torch.float32),
    (4, 2, 96, 96, 64, False, 0, torch.float32),      # ragged, GQA g = 2
    (4, 2, 96, 100, 128, True, 0, torch.float32),     # ragged Sq != Skv
    (8, 1, 200, 200, 128, True, 64, torch.float32),   # window, GQA g = 8
    (2, 1, 130, 130, 256, True, 0, torch.float32),    # hd 256
    (2, 2, 128, 128, 64, True, 0, torch.bfloat16),
    (2, 1, 160, 160, 256, True, 48, torch.bfloat16),  # bf16, window, hd 256
    (2, 2, 128, 64, 32, True, 16, torch.float32),     # late rows see no key
])
def test_flash_kernel_matches_plain(cuda, bh, kvh, sq, skv, hd, causal, window, dtype):
    q, k, v = _qkv(cuda, bh, kvh, sq, skv, hd, dtype, seed=sq + skv + hd)
    before = flash_attention_cuda.launches
    got = flash_attention_cuda(q, k, v, causal=causal, sm_scale=hd ** -0.5, window=window)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_plain(q, k, v, causal=causal, sm_scale=hd ** -0.5, window=window)
    flash_close(got, want)


@pytest.mark.parametrize("bh,kvh,sq,skv,hd,causal,window", [
    (2, 2, 128, 128, 32, True, 0),     # hd 32
    (2, 1, 150, 150, 64, True, 0),     # hd 64, g 2
    (4, 2, 200, 200, 128, True, 0),    # hd 128
    (2, 1, 200, 200, 256, True, 0),    # hd 256: 32-key tiles, Q re-read per k-step
    (10, 1, 130, 130, 128, True, 0),   # g 10
    (4, 2, 100, 77, 64, False, 0),     # non-causal, Skv not a multiple of 8 or 16
    (3, 3, 9, 9, 128, True, 0),        # Sq < 16: a partial m16 tile
    (2, 2, 9, 25, 64, False, 0),       # Sq < 16, non-causal
    (2, 2, 128, 64, 64, True, 16),     # rows from 79 on see no key
    (2, 1, 200, 200, 128, True, 100),  # a window edge inside each q tile
    (2, 1, 300, 300, 256, True, 40),   # hd 256 with a window edge inside q tiles
])
def test_flash_bf16_tensor_core_kernel_matches_plain(cuda, bh, kvh, sq, skv, hd, causal,
                                                      window):
    q, k, v = _qkv(cuda, bh, kvh, sq, skv, hd, torch.bfloat16, seed=sq * skv + hd)
    before = (flash_attention_cuda.launches, flash_attention_cuda.bf16_launches)
    got = flash_attention_cuda(q, k, v, causal=causal, sm_scale=hd ** -0.5, window=window)
    torch.cuda.synchronize()
    assert (flash_attention_cuda.launches, flash_attention_cuda.bf16_launches) == (
        before[0] + 1, before[1] + 1)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    want = flash_attention_plain(q, k, v, causal=causal, sm_scale=hd ** -0.5, window=window)
    flash_close(got, want)
    if window == 16:   # no visible key: exactly 0
        assert not got[:, 79:].any()


@pytest.mark.parametrize("sm_scale", [-0.125, 0.0, 0.5])
def test_flash_bf16_kernel_takes_any_sm_scale(cuda, sm_scale):
    """The bf16 kernel scales the f32 accumulator before the row max, so a
    zero or negative scale softmaxes as the plain version does."""
    q, k, v = _qkv(cuda, 2, 2, 100, 100, 64, torch.bfloat16, seed=5)
    got = flash_attention_cuda(q, k, v, causal=True, sm_scale=sm_scale)
    flash_close(got, flash_attention_plain(q, k, v, causal=True, sm_scale=sm_scale))


@pytest.mark.parametrize("bh,kvh,sq,skv,hd,causal,window", [
    (4, 2, 64, 64, 16, True, 0),       # hd 16, the reduced configs' width
    (2, 2, 128, 128, 32, True, 0),     # hd 32
    (4, 2, 70, 70, 48, True, 0),       # hd 48: padded to 64
    (2, 1, 150, 150, 64, True, 0),     # hd 64, g 2
    (3, 3, 90, 90, 80, False, 0),      # hd 80: padded to 128
    (4, 2, 200, 200, 128, True, 0),    # hd 128
    (2, 1, 200, 200, 256, True, 0),    # hd 256: one m16 tile a warp
    (4, 2, 40, 40, 1, True, 0),        # hd 1: padded to 16
    (10, 1, 130, 130, 128, True, 0),   # g 10
    (16, 2, 96, 96, 64, True, 0),      # g 8
    (4, 2, 100, 77, 64, False, 0),     # non-causal, Skv not a multiple of 8
    (3, 3, 9, 9, 128, True, 0),        # Sq < 16: a partial m16 tile
    (2, 2, 9, 25, 16, False, 0),       # Sq < 16, non-causal, hd 16
    (2, 2, 128, 64, 64, True, 16),     # rows from 79 on see no key
    (2, 1, 200, 200, 128, True, 100),  # a window edge inside each q tile
    (2, 1, 300, 300, 256, True, 40),   # hd 256 with a window edge inside q tiles
    (4, 2, 50, 50, 16, True, 8),       # the reduced configs' window 8
])
def test_flash_f32_tensor_core_kernel_matches_plain(cuda, bh, kvh, sq, skv, hd, causal, window):
    """f32 goes to the 3xTF32 kernel, at f32's tolerance."""
    q, k, v = _qkv(cuda, bh, kvh, sq, skv, hd, torch.float32, seed=sq * skv + hd)
    before = (flash_attention_cuda.launches, flash_attention_cuda.f32_mma_launches,
              flash_attention_cuda.bf16_launches)
    got = flash_attention_cuda(q, k, v, causal=causal, sm_scale=hd ** -0.5, window=window)
    torch.cuda.synchronize()
    assert (flash_attention_cuda.launches, flash_attention_cuda.f32_mma_launches,
            flash_attention_cuda.bf16_launches) == (before[0] + 1, before[1] + 1, before[2])
    assert got.dtype == torch.float32 and got.shape == q.shape and got.is_contiguous()
    assert bool(torch.isfinite(got).all())
    want = flash_attention_plain(q, k, v, causal=causal, sm_scale=hd ** -0.5, window=window)
    flash_close(got, want)
    if window == 16:   # no visible key: exactly 0
        assert not got[:, 79:].any()


@pytest.mark.parametrize("hd", [16, 48, 80])
def test_flash_bf16_kernel_takes_any_head_width(cuda, hd):
    """hd 16 runs natively, 48 and 80 zero-padded to 64 and 128."""
    q, k, v = _qkv(cuda, 4, 2, 100, 100, hd, torch.bfloat16, seed=hd)
    before = flash_attention_cuda.bf16_launches
    got = flash_attention_cuda(q, k, v, causal=True, sm_scale=hd ** -0.5)
    assert flash_attention_cuda.bf16_launches == before + 1 and got.shape == q.shape
    flash_close(got, flash_attention_plain(q, k, v, causal=True, sm_scale=hd ** -0.5))


@pytest.mark.parametrize("sm_scale", [-0.125, 0.0, 0.5])
def test_flash_f32_kernel_takes_any_sm_scale(cuda, sm_scale):
    q, k, v = _qkv(cuda, 2, 2, 100, 100, 64, torch.float32, seed=5)
    got = flash_attention_cuda(q, k, v, causal=True, sm_scale=sm_scale)
    flash_close(got, flash_attention_plain(q, k, v, causal=True, sm_scale=sm_scale))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_repeat_bit_for_bit(cuda, dtype):
    q, k, v = _qkv(cuda, 8, 2, 300, 300, 128, dtype, seed=9)
    first = flash_attention_cuda(q, k, v, causal=True, sm_scale=0.125, window=100)
    again = flash_attention_cuda(q, k, v, causal=True, sm_scale=0.125, window=100)
    assert torch.equal(first, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_first_design_matches_plain(cuda, dtype):
    """The fp32-FMA first design (csrc/legacy/) in both types, as chip_smoke.py times it."""
    q, k, v = _qkv(cuda, 4, 2, 150, 150, 128, dtype, seed=11)
    got = flash_attn_v1(q, k, v, causal=True, sm_scale=128 ** -0.5, window=64)
    flash_close(got, flash_attention_plain(q, k, v, causal=True, sm_scale=128 ** -0.5,
                                           window=64))


def test_flash_f32_check_catches_one_tf32_product(cuda):
    """At qwen3-0.6b's width, the plain version with its matmuls in TF32
    (one TF32 product, not three) fails the f32 check that the 3xTF32
    kernel passes."""
    b, s, h, kvh, hd = 2, 4096, 16, 8, 128
    q, k, v = _qkv(cuda, b * h, b * kvh, s, s, hd, torch.float32, seed=1)
    kw = dict(causal=True, sm_scale=hd ** -0.5)
    want = flash_attention_plain(q, k, v, **kw)
    flash_close(flash_attention_cuda(q, k, v, **kw), want)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        planted = flash_attention_plain(q, k, v, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    with pytest.raises(AssertionError):
        flash_close(planted, want)


def test_flash_sdpa_op_matches_model_sdpa(cuda):
    b, s, h, kvh, hd = 2, 200, 8, 2, 128
    g = torch.Generator().manual_seed(3)
    q = torch.randn((b, s, h, hd), generator=g)
    k, v = (torch.randn((b, s, kvh, hd), generator=g) for _ in range(2))
    before = flash_attention_cuda.launches
    got = flash_sdpa(q, k, v, causal=True, window=64)     # CPU inputs, run on the card
    assert got.device.type == "cuda" and flash_attention_cuda.launches == before + 1
    want = _sdpa(q.to(cuda), k.to(cuda), v.to(cuda), _causal_mask(s, s, 0, 64, device=cuda))
    flash_close(got, want)


def test_flash_wrapper_rejects_bad_inputs(cuda):
    q, k, v = _qkv(cuda, 4, 2, 64, 64, 64, torch.float32)
    with pytest.raises(TypeError):    # dtype
        flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):    # k in another dtype than q
        flash_attention_cuda(q, k.bfloat16(), v)
    with pytest.raises(ValueError):   # another device
        flash_attention_cuda(q, k.cpu(), v)
    with pytest.raises(ValueError):   # contiguity
        flash_attention_cuda(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="head width"):
        qq, kk, vv = _qkv(cuda, 4, 2, 64, 64, 320, torch.float32)
        flash_attention_cuda(qq, kk, vv)
    with pytest.raises(ValueError):   # 4 query heads over 3 kv heads
        flash_attention_cuda(q, k[:1].repeat(3, 1, 1), v[:1].repeat(3, 1, 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_takes_bh_past_65535(cuda, dtype):
    """B·H = 65,536 heads (gridDim.x, whose limit is 2^31 - 1) at Sq 16,
    hd 16: the wrapper used to refuse BH > 65,535, the limit of gridDim.y.
    Held to the plain version, every head."""
    q, k, v = _qkv(cuda, 65_536, 65_536, 16, 16, 16, dtype)
    before = flash_attention_cuda.launches
    got = flash_attention_cuda(q, k, v, causal=True, sm_scale=0.25)
    assert flash_attention_cuda.launches == before + 1
    flash_close(got, flash_attention_plain(q, k, v, causal=True, sm_scale=0.25))


def test_flash_refuses_query_tiles_past_grid_y_naming_the_limit(cuda):
    """ceil(Sq / 128) > 65,535 query tiles (gridDim.y) is refused before
    any launch, and the message names the limit; one query tile fewer runs."""
    from repro_torch.kernels.flash_attn.kernel import MAX_GRID_Y, query_tile

    sq = MAX_GRID_Y * query_tile(16, torch.float32) + 1
    q = torch.zeros((1, sq, 16), device=cuda)
    k = v = torch.zeros((1, 8, 16), device=cuda)
    before = flash_attention_cuda.launches
    with pytest.raises(ValueError, match="gridDim.y limit \\(65,535\\)"):
        flash_attention_cuda(q, k, v, causal=False)
    assert flash_attention_cuda.launches == before
    out = flash_attention_cuda(q[:, : sq - 1], k, v, causal=False)
    assert out.shape == (1, sq - 1, 16) and bool(torch.isfinite(out).all())


def _wkv_inputs(dev, shape, u_shape, shift, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    r, k, v = (0.5 * torch.randn(shape, generator=g) for _ in range(3))
    lw = -torch.exp(torch.randn(shape, generator=g) + shift)
    u = 0.1 * torch.randn(u_shape, generator=g)
    return [x.to(dev, dtype) for x in (r, k, v, lw)] + [u.to(dev)]


WKV_CASES = [  # bh, t, head size, chunk, decay shift, dtype
    (2, 64, 32, 16, -4.0, torch.float32),
    (3, 128, 64, 32, -4.0, torch.float32),
    (1, 256, 64, 128, -4.0, torch.float32),
    (2, 128, 16, 128, -4.0, torch.float32),
    (2, 96, 64, 64, -4.0, torch.float32),      # ragged T
    (2, 128, 64, 32, -1.0, torch.float32),     # strong decay: the clamps bite
    (2, 300, 64, 128, -6.0, torch.bfloat16),   # bf16, ragged
]


@pytest.mark.parametrize("bh,t,kk,chunk,shift,dtype", WKV_CASES + [
    (2, 64, 16, 8, -4.0, torch.float32),       # chunk 8, head size 16: the reduced configs
    (3, 100, 16, 8, -1.0, torch.bfloat16),     # chunk 8, ragged, strong decay
    (2, 72, 32, 8, -4.0, torch.float32),
    (2, 60, 64, 8, -1.0, torch.float32),       # chunk 8, K 64: threads past column 8 idle
    (2, 90, 64, 8, -6.0, torch.bfloat16),
])
def test_wkv_kernel_matches_plain(cuda, bh, t, kk, chunk, shift, dtype):
    r, k, v, lw, u = _wkv_inputs(cuda, (bh, t, kk), (bh, kk), shift, dtype, seed=t + kk)
    before = wkv_cuda.launches
    got = wkv_cuda(r, k, v, lw, u, chunk=chunk)
    torch.cuda.synchronize()
    assert wkv_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == r.shape
    want = wkv_plain(r, k, v, lw, u, chunk=chunk)
    wkv_close(got, want)


@pytest.mark.parametrize("bh,t,kk,chunk,shift,dtype", WKV_CASES + [
    (300, 260, 64, 128, -1.0, torch.float32),   # several waves of CTAs for both designs
    (40, 2048, 64, 128, -6.0, torch.bfloat16),  # 640 output CTAs, ~5 waves on 132 SMs
    (5, 200, 32, 16, -1.0, torch.bfloat16),
])
def test_wkv_kernel_is_the_first_design_bit_for_bit(cuda, bh, t, kk, chunk, shift, dtype):
    """The chunk-parallel kernels keep the first design's arithmetic order."""
    r, k, v, lw, u = _wkv_inputs(cuda, (bh, t, kk), (bh, kk), shift, dtype, seed=t + kk + bh)
    got = wkv_cuda(r, k, v, lw, u, chunk=chunk)
    old = wkv_v1(r, k, v, lw, u, chunk=chunk)
    torch.cuda.synchronize()
    assert got.dtype == old.dtype == dtype
    assert torch.equal(got, old), float((got.float() - old.float()).abs().max())


@pytest.mark.parametrize("shift", [-4.0, -1.0])
def test_wkv_op_matches_model_chunked_wkv(cuda, shift):
    r, k, v, lw, u = _wkv_inputs("cpu", (2, 96, 4, 64), (4, 64), shift, torch.float32)
    before = wkv_cuda.launches
    got = wkv(r, k, v, lw, u, chunk=32)          # CPU inputs, run on the card
    assert got.device.type == "cuda" and wkv_cuda.launches == before + 1
    want = _chunked_wkv(*(x.to(cuda) for x in (r, k, v, lw, u)), chunk=32)
    wkv_close(got, want)


def test_wkv_wrapper_rejects_bad_inputs(cuda):
    r, k, v, lw, u = _wkv_inputs(cuda, (2, 64, 64), (2, 64), -4.0, torch.float32)
    with pytest.raises(TypeError):    # dtype
        wkv_cuda(r.half(), k.half(), v.half(), lw.half(), u)
    with pytest.raises(TypeError):    # lw in another dtype than r
        wkv_cuda(r, k, v, lw.bfloat16(), u)
    with pytest.raises(TypeError):    # u must be f32
        wkv_cuda(r, k, v, lw, u.bfloat16())
    with pytest.raises(ValueError):   # another device
        wkv_cuda(r, k.cpu(), v, lw, u)
    with pytest.raises(ValueError):   # contiguity
        wkv_cuda(r, k, v.transpose(1, 2).contiguous().transpose(1, 2), lw, u)
    with pytest.raises(ValueError, match="head size"):
        rr, kk_, vv, ll, uu = _wkv_inputs(cuda, (2, 64, 48), (2, 48), -4.0, torch.float32)
        wkv_cuda(rr, kk_, vv, ll, uu)
    with pytest.raises(ValueError, match="chunk"):
        wkv_cuda(r, k, v, lw, u, chunk=48)
    with pytest.raises(ValueError, match="chunk"):
        wkv_cuda(r, k, v, lw, u, chunk=4)


# ---------------------------------------------------------------------------
# the datastore's lifecycle and the approx tier on the card: the join
# kernels on masked columns, and every path against the CPU path
# ---------------------------------------------------------------------------

def _holes(valid, kind):
    """``valid`` (1, NS) int32 with columns masked out: scattered holes in
    the middle of S, whole 256-column tiles dead, or every column dead."""
    v = valid.clone()
    n = v.shape[1]
    if kind == "holes":
        rng = np.random.default_rng(n)
        cols = rng.choice(np.arange(n // 8, n - n // 8), size=n // 3, replace=False)
        v[0, torch.as_tensor(cols, device=v.device)] = 0
    elif kind == "dead-tiles":
        for lo in range(256, n - 256, 512):
            v[0, lo:lo + 256] = 0
    else:
        v.zero_()
    return v


@pytest.mark.parametrize("kind", ["holes", "dead-tiles", "all-dead"])
@pytest.mark.parametrize("k,variant", [(16, None), (5, "warm"), (128, None)])
def test_kernel_with_masked_columns_matches_plain(cuda, kind, k, variant):
    """knn_topk_fused with col_valid holes inside S (tombstones, the band
    filter's candidate mask), whole dead 256-column tiles and an all-dead
    S against its plain version: no masked column is returned, and a
    walk that offers nothing keeps its init state and seed threshold."""
    args, kwargs = _inputs(cuda, 300, 1100, 1024, 256, 256, k, False, variant)
    args = args[:3] + (_holes(args[3], kind),) + args[4:]
    before = knn_topk_fused.launches
    got = knn_topk_fused(*args, **kwargs)
    torch.cuda.synchronize()
    assert knn_topk_fused.launches == before + 1
    want = knn_topk_plain(*args, **kwargs)
    assert_topk_close(got[0].cpu().numpy(), got[1].cpu().numpy(), want[0].cpu().numpy(),
                      want[1].cpu().numpy(), RTOL, ATOL)
    np.testing.assert_allclose(got[2].cpu().numpy(), want[2].cpu().numpy(), rtol=RTOL, atol=ATOL)
    # the warm state's ids are another S's (ns..2ns-1): every S id returned is live
    dead_ids = args[4][0][(args[3][0] == 0) & (args[4][0] >= 0)].cpu().numpy()
    assert not np.isin(got[1].cpu().numpy(), dead_ids).any()
    if kind == "all-dead":
        assert torch.equal(got[0], args[5]) and torch.equal(got[1], args[6])
        assert (got[2] == kwargs["thr"]).all()


@pytest.mark.parametrize("kind", ["holes", "dead-tiles", "all-dead"])
def test_score_then_merge_k150_on_masked_stack(cuda, kind):
    """The k > 128 route (knn_score_cuda, the mask, topk_merge_cuda) on a
    stack with masked columns: the plain fused walk's answer at k 150."""
    args, kwargs = _inputs(cuda, 300, 700, 2000, 128, 64, 150, False)
    args = args[:3] + (_holes(args[3], kind),) + args[4:]
    before = (knn_score_cuda.launches, topk_merge_cuda.launches)
    got = score_then_merge(*args, block_r=128, block_s=64)
    torch.cuda.synchronize()
    assert knn_score_cuda.launches > before[0] and topk_merge_cuda.launches > before[1]
    want = knn_topk_plain(*args, **kwargs)
    assert_topk_close(got[0].cpu().numpy(), got[1].cpu().numpy(), want[0].cpu().numpy(),
                      want[1].cpu().numpy(), RTOL, ATOL)
    if kind == "all-dead":
        assert (got[1] == -1).all()


@pytest.mark.parametrize("blocks,s_block,rb", [(5, 2048, 16), (1, 10_240, 2048), (3, 17, 1)])
def test_candidate_mask_on_card_equals_cpu(cuda, blocks, s_block, rb):
    """The torch band lookup on the card equals the CPU's and the host
    twin's, with padded and empty R rows excluded."""
    from repro_torch.core import lsh

    rng = np.random.default_rng(rb)
    n_bands = 30
    rk = rng.integers(0, 1 << 30, size=(rb, n_bands), dtype=np.int32)
    sk = rng.integers(0, 1 << 30, size=(blocks, s_block, n_bands), dtype=np.int32)
    flat = sk.reshape(-1, n_bands)                 # a view: plant collisions in band 3
    flat[::7, 3] = rk[rng.integers(0, rb, size=flat[::7].shape[0]), 3]
    sk[-1, -1] = rk[0]
    r_real = np.ones(rb, bool)
    r_real[max(1, rb // 2):] = False               # padded rows: their keys never hit
    s_valid = rng.random((blocks, s_block)) > 0.1
    args = (rk, r_real, sk, s_valid)
    mask, count = lsh.candidate_mask(*(torch.as_tensor(a, device=cuda) for a in args))
    cpu_mask, cpu_count = lsh.candidate_mask(*(torch.as_tensor(a) for a in args))
    assert mask.device.type == "cuda"
    assert torch.equal(mask.cpu(), cpu_mask) and int(count) == int(cpu_count)
    np.testing.assert_array_equal(cpu_mask.numpy(), lsh.candidate_mask_host(rk, r_real, sk))
    assert 0 < int(count) < s_valid.sum()


PATHS = [("bf", False), ("iib", False), ("iib", True), ("iiib", False)]


def _refuse_plain_merges(monkeypatch):
    """During a card query: no plain merge, torch.topk, or torch.sort of
    scores (the band lookup sorts int32 keys, which passes)."""
    real_sort = torch.sort

    def refuse(*args, **kwargs):
        raise AssertionError("a plain merge ran on the card")

    def keys_only_sort(x, *args, **kwargs):
        if x.is_floating_point():
            raise AssertionError("a float sort (a plain merge) ran on the card")
        return real_sort(x, *args, **kwargs)

    for where in ("repro_torch.kernels.topk_merge.kernel.topk_merge_plain",
                  "repro_torch.core.topk.topk_update", "torch.topk"):
        monkeypatch.setattr(where, refuse)
    monkeypatch.setattr("torch.sort", keys_only_sort)


def _lifecycle(S, extra, spec, cached, device, R, before_query=None, after_query=None):
    """Build on S's first 500 rows, then extend, delete, extend with a TTL,
    expire, compact, refreeze, querying R after each step; returns
    [(step output, result, index_builds, live rows)]."""
    idx = SparseKNNIndex.build(S.rows(0, 500), spec, cache_device_blocks=cached, device=device)
    steps = (lambda: idx.extend(S.rows(500, 700)), lambda: idx.delete(np.arange(3, 700, 7)),
             lambda: idx.extend(extra, deadline=5.0), lambda: idx.expire(5.0),
             lambda: idx.compact(), lambda: idx.refreeze())
    out = []
    for step in steps:
        got = step()
        if before_query:
            before_query()
        res = idx.query(R)
        if after_query:
            after_query()
        out.append((got if isinstance(got, int) else None, res, idx.stats.index_builds,
                    idx.live_rows))
    return out


@pytest.mark.parametrize("alg,kernel", PATHS, ids=["bf", "iib", "iib-kernel", "iiib"])
def test_lifecycle_on_card_matches_cpu(cuda, alg, kernel, monkeypatch):
    """Each path's extend / delete / TTL expire / compact / refreeze
    sequence on the card, cached and streaming: every step's result the
    CPU path's (ids equal outside tie groups), the same counters, index
    builds and live rows, cached equal to streaming bit for bit; the
    queries launch the kernels (fused path) or topk_merge (drivers) and no
    plain merge."""
    R, S = _driver_data()
    extra = synthetic_sparse(64, dim=2000, nnz_mean=40, seed=5)
    spec = JoinSpec(k=5, algorithm=alg, use_kernel=kernel, r_block=128, s_block=256)
    runs = {}
    for cached in (True, False):
        launches = []
        counter = knn_topk_fused if kernel else topk_merge_cuda
        runs[cached] = _lifecycle(
            S, extra, spec, cached, cuda, R,
            before_query=lambda: (_refuse_plain_merges(monkeypatch),
                                  launches.append(counter.launches)),
            after_query=lambda: (monkeypatch.undo(),
                                 launches.append(counter.launches - launches.pop())))
        assert all(n > 0 for n in launches), launches
        cpu = _lifecycle(S, extra, spec, cached, "cpu", R)
        for (g_out, g_res, g_builds, g_live), (c_out, c_res, c_builds, c_live) in zip(
                runs[cached], cpu):
            assert (g_out, g_builds, g_live) == (c_out, c_builds, c_live)
            assert g_res.scores.device.type == "cuda"
            assert_topk_close(g_res.scores.cpu().numpy(), g_res.ids.cpu().numpy(),
                              c_res.scores.numpy(), c_res.ids.numpy(), RTOL, ATOL)
            assert ({c: getattr(g_res.stats, c) for c in COUNTS}
                    == {c: getattr(c_res.stats, c) for c in COUNTS})
    for (_, a, _, _), (_, b, _, _) in zip(runs[True], runs[False]):
        assert torch.equal(a.scores, b.scores) and torch.equal(a.ids, b.ids)
    deleted = np.arange(3, 700, 7)
    assert not np.isin(runs[True][1][1].ids.cpu().numpy(), deleted).any()


@pytest.mark.parametrize("alg,kernel", PATHS, ids=["bf", "iib", "iib-kernel", "iiib"])
def test_approx_on_card_matches_cpu(cuda, alg, kernel, monkeypatch):
    """Each path's approx query on the card, cached and streaming, on a
    planted workload: the CPU path's ids and candidate counts, recall >=
    0.95 against the exact face with a candidate set smaller than S,
    cached equal to streaming bit for bit, no deleted row after a delete."""
    from repro_torch.core import lsh
    from repro_torch.sparse.datagen import gen_clustered

    R, S = gen_clustered(40, 8, dim=2000, nnz=40, seed=1)
    spec = JoinSpec(k=5, algorithm=alg, use_kernel=kernel, r_block=8, s_block=128,
                    target_recall=0.95)
    card = {}
    for cached in (True, False):
        idx = SparseKNNIndex.build(S, spec, cache_device_blocks=cached)
        cpu_idx = SparseKNNIndex.build(S, spec, cache_device_blocks=cached, device="cpu")
        for step in ("fresh", "deleted"):
            if step == "deleted":
                idx.delete(np.arange(0, 320, 9))
                cpu_idx.delete(np.arange(0, 320, 9))
            _refuse_plain_merges(monkeypatch)
            got = idx.query(R)
            monkeypatch.undo()
            want = cpu_idx.query(R)
            assert_topk_close(got.scores.cpu().numpy(), got.ids.cpu().numpy(),
                              want.scores.numpy(), want.ids.numpy(), RTOL, ATOL)
            for c in COUNTS + ("candidate_rows", "scanned_rows"):
                assert getattr(got.stats, c) == getattr(want.stats, c), c
            exact = idx.query(R, accuracy="exact")
            assert lsh.measured_recall(got.ids.cpu().numpy(), exact.ids.cpu().numpy()) >= 0.95
            assert 0 < got.stats.candidate_rows and got.stats.candidate_fraction < 1.0
            card[cached, step] = got
        assert not np.isin(card[cached, "deleted"].ids.cpu().numpy(),
                           np.arange(0, 320, 9)).any()
    for step in ("fresh", "deleted"):
        a, b = card[True, step], card[False, step]
        assert torch.equal(a.scores, b.scores) and torch.equal(a.ids, b.ids)


def _store_data():
    """R 300 and S 1,001 rows at dim 2000: 4 shards of 251/250/250/250,
    ragged in their last 256-row block."""
    return (synthetic_sparse(300, dim=2000, nnz_mean=40, seed=0),
            synthetic_sparse(1001, dim=2000, nnz_mean=40, seed=1))


STORE_COUNTS = COUNTS + ("candidate_rows", "scanned_rows")


@pytest.mark.parametrize("acc", ["exact", "approx"])
@pytest.mark.parametrize("alg", DRIVERS)
def test_store_on_card_matches_cpu(cuda, alg, acc, monkeypatch):
    """The sharded store, 4 shards on the card: the CPU path's result (ids
    equal outside tie groups), every counter and the thresholds equal,
    one dispatch and one host sync per R block, each shard block step and
    each tree merge a topk_merge_cuda launch, no plain merge."""
    from repro_torch.store import ShardedKNNStore

    R, S = _store_data()
    kw = {"target_recall": 0.9} if acc == "approx" else {}
    spec = JoinSpec(k=5, algorithm=alg, r_block=128, s_block=256, **kw)
    card = ShardedKNNStore.build(S, spec, num_shards=4)
    cpu = ShardedKNNStore.build(S, spec, num_shards=4, device="cpu")
    assert all(t.device.type == cuda.type for t in card._stacks[0]["ids"])
    before = topk_merge_cuda.launches
    _refuse_plain_merges(monkeypatch)
    got = card.query(R)
    monkeypatch.undo()
    merges = topk_merge_cuda.launches - before
    want = cpu.query(R)
    r_blocks = 3
    assert merges == r_blocks * (4 * card._num_blocks_stacked + 3), merges
    assert got.scores.device.type == cuda.type
    assert_topk_close(got.scores.cpu().numpy(), got.ids.cpu().numpy(), want.scores.numpy(),
                      want.ids.numpy(), RTOL, ATOL)
    for c in STORE_COUNTS:
        assert getattr(got.stats, c) == getattr(want.stats, c), c
    assert got.stats.device_dispatches == got.stats.host_syncs == r_blocks
    for g, w in zip(got.stats.min_prune_trace, want.stats.min_prune_trace):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    if acc == "exact":
        single = SparseKNNIndex.build(S, spec).query(R)
        assert_topk_close(got.scores.cpu().numpy(), got.ids.cpu().numpy(),
                          single.scores.cpu().numpy(), single.ids.cpu().numpy(), RTOL, ATOL)


def test_store_failover_on_card(cuda):
    """2 replicas x 4 shards on the card: a replica kill mid-query fails
    over (the clean result, bit for bit), writes while it is dead queue it
    dirty, resync + verify_replicas, and the half-open probe re-admits it."""
    from repro_torch.runtime.fault import FaultPlan, FaultSpec, ReplicaHealth
    from repro_torch.store import ShardedKNNStore

    R, S = _store_data()
    spec = JoinSpec(k=5, algorithm="iib", r_block=128, s_block=256)
    store = ShardedKNNStore.build(S, spec, num_shards=4, replicas=2)
    assert all(a.data_ptr() != b.data_ptr()
               for k in store._stacks[0] for a, b in zip(store._stacks[0][k], store._stacks[1][k]))
    clean = store.query(R)
    store.fault_plan = FaultPlan([FaultSpec("replica_error", replica=1)])
    res = store.query(R)
    store.fault_plan = None
    assert torch.equal(res.scores, clean.scores) and torch.equal(res.ids, clean.ids)
    assert store.stats.replica_failovers == 1 and store.dead_replicas == (1,)
    store.add(synthetic_sparse(40, dim=2000, nnz_mean=40, seed=9))
    store.delete(np.arange(0, 1001, 11))
    assert store._replica_dirty[1]
    assert store.resync_replicas() == (1,)
    assert store.health.state(1) == ReplicaHealth.HALF_OPEN
    assert store.verify_replicas()
    after = store.query(R)
    assert store.health.state(1) == ReplicaHealth.LIVE
    cpu = ShardedKNNStore.build(S, spec, num_shards=4, device="cpu")
    cpu.add(synthetic_sparse(40, dim=2000, nnz_mean=40, seed=9))
    cpu.delete(np.arange(0, 1001, 11))
    want = cpu.query(R)
    assert_topk_close(after.scores.cpu().numpy(), after.ids.cpu().numpy(), want.scores.numpy(),
                      want.ids.numpy(), RTOL, ATOL)



@pytest.mark.parametrize("alg", DRIVERS)
def test_store_save_load_recover_on_card(cuda, alg, tmp_path):
    """The store's checkpoints on the card: after add (TTL), delete and
    expire, save → load answers bit for bit the store before the save (and
    its query-time index builds stay 0); mark_lost → recover rebuilds the
    shard on the card, bit for bit again; save_dirty links the clean shards."""
    import json
    import os

    from repro_torch.store import ShardedKNNStore

    R, S = _store_data()
    spec = JoinSpec(k=5, algorithm=alg, r_block=128, s_block=256)
    store = ShardedKNNStore.build(S, spec, num_shards=4)
    store.add(synthetic_sparse(40, dim=2000, nnz_mean=40, seed=9), ttl=5.0, now=0.0)
    store.delete(np.arange(0, 1001, 13))
    store.expire(now=10.0)
    store.save(str(tmp_path))
    want = store.query(R)
    loaded = ShardedKNNStore.load(str(tmp_path))
    assert all(t.device.type == cuda.type for t in loaded._stacks[0]["ids"])
    builds = loaded.stats.index_builds
    got = loaded.query(R)
    assert loaded.stats.index_builds == builds and got.stats.index_builds == 0
    assert torch.equal(got.scores, want.scores) and torch.equal(got.ids, want.ids)
    store.mark_lost(2)
    lost = store.query(R, allow_partial=True)
    assert lost.missing_shards == (2,)
    assert store.recover(str(tmp_path)) == (2,) and store.lost_shards == ()
    back = store.query(R)
    assert torch.equal(back.scores, want.scores) and torch.equal(back.ids, want.ids)
    store.save(str(tmp_path))                 # a full commit: every file its own
    target = int(np.argmin(store.shard_rows))  # where the next add lands
    store.add(synthetic_sparse(8, dim=2000, nnz_mean=40, seed=10))
    path = store.save_dirty(str(tmp_path))
    with open(os.path.join(path, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    linked = {e["path"] for e in leaves if os.stat(os.path.join(path, e["file"])).st_nlink > 1}
    want = {e["path"] for e in leaves if not e["path"].startswith(f"['shard_{target:05d}']")}
    assert linked == want


def test_store_loads_a_cpu_checkpoint_on_card(cuda, tmp_path):
    """A checkpoint written by the CPU path loads on the card and answers
    within tolerance of the CPU store (ids equal outside tie groups)."""
    from repro_torch.store import ShardedKNNStore

    R, S = _store_data()
    spec = JoinSpec(k=5, algorithm="iiib", r_block=128, s_block=256)
    cpu = ShardedKNNStore.build(S, spec, num_shards=4, device="cpu")
    cpu.add(synthetic_sparse(40, dim=2000, nnz_mean=40, seed=9))
    cpu.delete(np.arange(0, 1001, 11))
    cpu.save(str(tmp_path))
    want = cpu.query(R)
    for shards in (4, 2):
        card = ShardedKNNStore.load(str(tmp_path), num_shards=shards)
        got = card.query(R)
        assert got.scores.device.type == cuda.type
        assert_topk_close(got.scores.cpu().numpy(), got.ids.cpu().numpy(), want.scores.numpy(),
                          want.ids.numpy(), RTOL, ATOL)


def _serve(store, reqs, ks, cfg, profile=None):
    """Submit every request concurrently through a KNNScheduler; returns
    (answers, [(request ids, assembled batch)], the scheduler's
    _assemble, the metrics)."""
    import asyncio

    from repro_torch.serve import KNNScheduler

    seen = []

    async def main():
        async with KNNScheduler(store, cfg, profile=profile) as sched:
            real = sched._assemble

            def assemble(pending):
                batch = real(pending)
                seen.append(([p.rid for p in pending], batch))
                return batch

            sched._assemble = assemble
            outs = await asyncio.gather(*[sched.submit(q, k=k) for q, k in zip(reqs, ks)])
            return outs, real, sched.metrics

    outs, real, metrics = asyncio.run(main())
    return outs, seen, real, metrics


def test_scheduler_on_card_store(cuda):
    """A KNNScheduler over a 4-shard store on the card: ragged requests with
    per-request k, every answer bit for bit its rows of a direct query of
    the same assembled batch (rebuilt with _assemble), within tolerance of
    its rows alone; no failure, no query-time index build, the merges on
    topk_merge_cuda."""
    import types

    from repro_torch.serve import ServeConfig
    from repro_torch.store import ShardedKNNStore

    R, S = _store_data()
    store = ShardedKNNStore.build(S, JoinSpec(k=5, algorithm="iib", r_block=128, s_block=256),
                                  num_shards=4)
    rng = np.random.default_rng(3)
    sizes = rng.integers(1, 17, size=40)
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    bounds = bounds[bounds <= R.num_vectors]
    reqs = [R.rows(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]
    ks = [int(k) for k in rng.integers(1, 6, size=len(reqs))]
    before = topk_merge_cuda.launches
    outs, seen, assemble, m = _serve(store, reqs, ks, ServeConfig(r_block=128, window_s=0.005))
    assert topk_merge_cuda.launches > before
    assert m.failed == 0 and m.completed == len(reqs) and m.query_index_builds == 0
    for rids, batch in seen:
        rebuilt = assemble([types.SimpleNamespace(idx=reqs[r].indices.numpy(),
                                                  val=reqs[r].values.numpy(),
                                                  nnz=reqs[r].nnz.numpy()) for r in rids])
        assert rebuilt.indices.device.type == "cpu" and torch.equal(rebuilt.values, batch.values)
        direct = store.query(rebuilt)
        off = 0
        for r in rids:
            n, k = reqs[r].num_vectors, ks[r]
            assert np.array_equal(outs[r][0], direct.ids[off:off + n, :k].cpu().numpy())
            assert np.array_equal(outs[r][1], direct.scores[off:off + n, :k].cpu().numpy())
            off += n
    for q, k, (ids, scores) in zip(reqs, ks, outs):
        alone = store.query(q)
        assert_topk_close(scores, ids, alone.scores[:, :k].cpu().numpy(),
                          alone.ids[:, :k].cpu().numpy(), RTOL, ATOL)


def test_profile_capture_holds_topk_merge(cuda, tmp_path):
    """ProfileCapture, armed by the scheduler on its event-loop thread,
    traces the dispatch worker's kernels: the Chrome trace holds
    topk_merge kernels; fanout_report counts them too."""
    import json

    from repro_torch.obs.profile import ProfileCapture, fanout_report
    from repro_torch.serve import ServeConfig
    from repro_torch.store import ShardedKNNStore

    R, S = _store_data()
    store = ShardedKNNStore.build(S, JoinSpec(k=5, algorithm="iib", r_block=128, s_block=256),
                                  num_shards=4)
    cap = ProfileCapture(str(tmp_path / "prof"), n_batches=2)
    reqs = [R.rows(i, i + 64) for i in range(0, 256, 64)]
    _, _, _, m = _serve(store, reqs, [5] * 4, ServeConfig(r_block=128, window_s=0.001),
                        profile=cap)
    assert m.failed == 0
    s = cap.summary()
    assert s["error"] is None and s["done"] and s["batches"] == 2
    with open(s["trace"]) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"]
    assert any("topk_merge" in n for n in names), sorted(set(names))[:20]
    rep = fanout_report(store, R.rows(0, 128))
    merges = sum(v["launches"] for k, v in rep["kernels"].items() if "topk_merge" in k)
    assert merges == 4 * store._num_blocks_stacked + 3
    assert rep["device_ms"] > 0 and rep["device"] == torch.cuda.get_device_name(0)


# -- the multi-device join: meshes of the card ---------------------------------

def _ring_runs(mesh, R, S):
    """Each ring route of a (4, 2) mesh: the ring driver for each driver,
    dim_axis='model' for bf and iib, and distributed_join's store route."""
    from repro_torch.core.engine import distributed_join
    from repro_torch.core.ring import _ring_join_impl, pad_to_ring, ring_knn_join

    Rp, nr = pad_to_ring(R, 4)
    Sp, ns = pad_to_ring(S, 4)
    kw = dict(n_r_valid=nr, n_s_valid=ns)
    runs = {f"ring-{a}": lambda a=a: _ring_join_impl(Rp, Sp, 5, mesh, algorithm=a, **kw)
            for a in DRIVERS}
    runs.update({f"dim-{a}": lambda a=a: ring_knn_join(Rp, Sp, 5, mesh, algorithm=a,
                                                       dim_axis="model", **kw)
                 for a in ("bf", "iib")})
    runs["store-iiib"] = lambda: distributed_join(
        Rp, Sp, JoinSpec(k=5, algorithm="iiib", r_block=128, s_block=256), mesh, **kw)
    return runs


def _ring_on(devices, monkeypatch):
    """Every ring route on a (4, 2) mesh of ``devices`` against a mesh of
    CPU entries (ids equal outside tie groups): each ring step and store
    merge a topk_merge_cuda launch, no plain merge."""
    from repro_torch.launch.mesh import make_host_mesh

    R, S = synthetic_sparse(301, dim=2000, nnz_mean=40, seed=0), _store_data()[1]
    card = _ring_runs(make_host_mesh(4, 2, devices=devices), R, S)
    cpu = _ring_runs(make_host_mesh(4, 2, devices="cpu"), R, S)
    for name, fn in card.items():
        before = topk_merge_cuda.launches
        _refuse_plain_merges(monkeypatch)
        got = fn()
        monkeypatch.undo()
        merges = topk_merge_cuda.launches - before
        want = cpu[name]()
        # the store: 3 R blocks x (4 shards x 2 blocks (251 rows in blocks of
        # 250, the smallest shard's) + 3 tree merges); the ring: 4 x 4 steps
        assert merges == (3 * (4 * 2 + 3) if name.startswith("store") else 16), (name, merges)
        assert got.scores.device == torch.device(devices[0])
        assert_topk_close(got.scores.cpu().numpy(), got.ids.cpu().numpy(), want.scores.numpy(),
                          want.ids.numpy(), RTOL, ATOL)


def _mesh_store_on(devices):
    """The store over a mesh of ``devices`` (4 shards; and 2 replicas x 2
    shards through a failover) against the num_shards= store on the first
    device: bit for bit, every counter equal."""
    from repro_torch.launch.mesh import make_store_mesh
    from repro_torch.runtime.fault import FaultPlan, FaultSpec
    from repro_torch.store import ShardedKNNStore

    R, S = _store_data()
    for alg in DRIVERS:
        spec = JoinSpec(k=5, algorithm=alg, r_block=128, s_block=256)
        flat = ShardedKNNStore.build(S, spec, num_shards=4, device=devices[0])
        meshed = ShardedKNNStore.build(S, spec, mesh=make_store_mesh(4, devices=devices))
        for t, dev in zip(meshed._stacks[0]["ids"], devices):
            assert t.device == torch.device(dev)
        got, want = meshed.query(R), flat.query(R)
        assert torch.equal(got.scores, want.scores) and torch.equal(got.ids, want.ids), alg
        for c in STORE_COUNTS:
            assert getattr(got.stats, c) == getattr(want.stats, c), c
        for f in ("index_builds", "placed_shards", "placed_bytes", "stack_uploads"):
            assert getattr(meshed.stats, f) == getattr(flat.stats, f), f
    spec = JoinSpec(k=5, algorithm="iib", r_block=128, s_block=256)
    flat = ShardedKNNStore.build(S, spec, num_shards=2, replicas=2, device=devices[0])
    meshed = ShardedKNNStore.build(S, spec, mesh=make_store_mesh(2, replicas=2, devices=devices))
    want = flat.query(R)
    meshed.fault_plan = FaultPlan([FaultSpec("replica_error", replica=1, at_dispatch=1)])
    got = meshed.query(R)
    assert torch.equal(got.scores, want.scores) and torch.equal(got.ids, want.ids)
    assert meshed.stats.replica_failovers == 1 and meshed.dead_replicas == (1,)
    meshed.fault_plan = None
    assert meshed.resync_replicas() == (1,) and meshed.verify_replicas()
    assert torch.equal(meshed.query(R).scores, want.scores)


def test_ring_on_card_mesh_matches_cpu(cuda, monkeypatch):
    """The ring join on a (4, 2) mesh repeating the card."""
    _ring_on([torch.device("cuda", 0)] * 8, monkeypatch)


def test_store_on_card_mesh_equals_num_shards_store(cuda):
    """ShardedKNNStore over [cuda:0] * 4 is the num_shards=4 store."""
    _mesh_store_on([torch.device("cuda", 0)] * 4)


def test_ring_and_mesh_store_over_two_cards(cuda, monkeypatch):
    """The same over distinct cards (devices alternating)."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices")
    devices = [torch.device("cuda", i % n) for i in range(8)]
    _ring_on(devices, monkeypatch)
    _mesh_store_on(devices[:4])
