"""The work counts of ``join_mfu`` and the rooflines, on hand-made inputs."""
import numpy as np
import pytest

from portbench import work

D = 10


def test_join_flops_counts_shared_dimensions():
    # R: row0 {1, 2}, row1 {2}; S: row0 {2, 3}, row1 {1, 2, 9}
    r = np.array([[1, 2], [2, D]])
    s = np.array([[2, 3, D], [1, 2, 9]])
    # dim 1: 1 x 1, dim 2: 2 x 2 -> 5 multiply-adds
    assert work.join_flops(r, s, D) == 10.0


def test_join_bytes_and_merge_bytes():
    assert work.join_bytes(3, 5, 2, 4) == 8 * 8 + 8 * 2 * 4
    assert work.merge_bytes(2048, 2048, 5) == 4 * 2048 * 2048 + 16 * 2048 * 5


def test_bound_names_the_limiting_side():
    t, side = work.bound_s(67e12, 1.0, "NVIDIA H100 80GB HBM3")
    assert side == "flops" and t == pytest.approx(1.0)
    t, side = work.bound_s(1.0, 3.35e12, "NVIDIA H100 80GB HBM3")
    assert side == "bytes" and t == pytest.approx(1.0)


def test_block_bounds_sum_to_the_whole_join():
    rng = np.random.default_rng(0)
    r = np.sort(rng.integers(0, D, (7, 3)), axis=1)
    s = np.sort(rng.integers(0, D, (5, 3)), axis=1)
    rn, sn = np.full(7, 3), np.full(5, 3)
    blocks = work.block_bounds(r, rn, s, sn, D, 2, 3, "NVIDIA H100 80GB HBM3")
    assert len(blocks) == 3
    flops = sum(b * 67e12 for b, side in blocks if side == "flops")
    assert flops <= work.join_flops(r, s, D) + 1e-6
