"""The reference and the comparison that decides ``correct``."""
import numpy as np
import pytest
import torch

from portbench import reference


def _rows(dense_rows):
    """Padded CSR of dense float32 rows."""
    dense_rows = np.asarray(dense_rows, np.float32)
    n, d = dense_rows.shape
    f = max(int((dense_rows != 0).sum(1).max()), 1)
    idx = np.full((n, f), d, np.int32)
    val = np.zeros((n, f), np.float32)
    for i in range(n):
        (nz,) = np.nonzero(dense_rows[i])
        idx[i, : len(nz)] = nz
        val[i, : len(nz)] = dense_rows[i, nz]
    return idx, val


def _brute(q, s, k):
    sc = q.astype(np.float64) @ s.astype(np.float64).T
    order = np.argsort(-sc, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(sc, order, 1), order


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_matches_brute_force_with_ties(seed):
    rng = np.random.default_rng(seed)
    d, k = 40, 4
    s = rng.random((60, d)) * (rng.random((60, d)) < 0.2)
    s[30:40] = s[0:10]                      # duplicated rows: tied scores
    s[50] = 0.0                             # an empty row
    q = rng.random((25, d)) * (rng.random((25, d)) < 0.3)
    q[3] = 0.0                              # a row with no neighbour
    q, s = q.astype(np.float32).astype(np.float64), s.astype(np.float32).astype(np.float64)
    want_s, want_i = _brute(q, s, k)
    got_s, got_i = reference.topk(_rows(q), _rows(s), k, d, "cpu", s_block=16, q_block=7)
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-12)
    # under ties the ids may differ, but each holds the score of its rank
    np.testing.assert_allclose(np.take_along_axis(q @ s.T, got_i, 1), want_s, atol=1e-12)
    id_s = reference.pair_scores(_rows(q), _rows(s), got_i, d, "cpu")
    np.testing.assert_allclose(id_s, want_s, atol=1e-12)


def _case():
    rng = np.random.default_rng(7)
    d, k = 50, 5
    s = rng.random((80, d)) * (rng.random((80, d)) < 0.3)
    q = rng.random((20, d)) * (rng.random((20, d)) < 0.3)
    qs, ss = _rows(q), _rows(s)
    ref_s, ref_i = reference.topk(qs, ss, k, d, "cpu")
    return qs, ss, ref_s, ref_i, d, k


def test_compare_passes_exact_answers():
    qs, ss, ref_s, ref_i, d, k = _case()
    got = reference.judge(qs, ss, ref_i, ref_s.astype(np.float32), k, d, "cpu")
    assert got["bad_ids"] == 0 and got["score_gap"] < 1e-7 and got["id_gap"] < 1e-7


@pytest.mark.parametrize("fault", ["id", "score", "repeat", "missing", "outside"])
def test_compare_catches_a_wrong_answer(fault):
    qs, ss, ref_s, ref_i, d, k = _case()
    ids, scores = ref_i.copy(), ref_s.astype(np.float32).copy()
    if fault == "id":                      # another id under the right score
        ids[4, 0] = ref_i[4, k - 1] if ref_i[4, k - 1] != ids[4, 0] else ref_i[4, 1]
    elif fault == "score":
        scores[2, 1] *= 1.001
    elif fault == "repeat":
        ids[5, 2] = ids[5, 1]
    elif fault == "missing":
        ids[6, 0], scores[6, 0] = -1, -np.inf
    else:
        ids[7, 3] = len(ss[0])
    got = reference.judge(qs, ss, ids, scores, k, d, "cpu")
    assert got["bad_ids"] > 0 or got["score_gap"] > 1e-4 or got["id_gap"] > 1e-4, got


def test_empty_slots_where_nothing_scores_are_right():
    d, k = 10, 3
    s = np.zeros((4, d)); s[0, 1] = 1.0
    q = np.zeros((1, d)); q[0, 1] = 2.0
    qs, ss = _rows(q), _rows(s)
    ref_s, _ = reference.topk(qs, ss, k, d, "cpu")
    ids = np.array([[0, -1, -1]])
    scores = np.array([[2.0, -np.inf, -np.inf]], np.float32)
    got = reference.judge(qs, ss, ids, scores, k, d, "cpu")
    assert got == {"score_gap": 0.0, "id_gap": 0.0, "bad_ids": 0}


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0**-10, 1.0 + 2.0**-11 + 2.0**-12, 3.0], dtype=torch.float32)
    r = reference._tf32(x)
    assert r[0] == x[0] and r[2] == 3.0
    assert r[1] == 1.0 + 2.0**-10          # rounded to nearest
