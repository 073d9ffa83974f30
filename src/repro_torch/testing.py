"""The parity rule for top-k results (ROADMAP.md "Parity standard").

Scores agree within a tolerance; ids are equal, except inside a group of
positions whose reference scores tie within that tolerance, where the id
*sets* must be equal.  A tie group cut off by k at the tail is held to its
scores only: which of the tied candidates made the cut depends on the
last ulp.
"""
from __future__ import annotations

import numpy as np


def assert_topk_close(got_s, got_i, ref_s, ref_i, rtol=1e-5, atol=1e-6) -> float:
    """Raise AssertionError unless (got_s, got_i) matches (ref_s, ref_i);
    return the max |Δscore| over finite reference entries."""
    got_s, ref_s = np.asarray(got_s, np.float64), np.asarray(ref_s, np.float64)
    got_i, ref_i = np.asarray(got_i), np.asarray(ref_i)
    if got_s.shape != ref_s.shape or got_i.shape != ref_i.shape:
        raise AssertionError(f"shape {got_s.shape}/{got_i.shape} != {ref_s.shape}/{ref_i.shape}")
    np.testing.assert_allclose(got_s, ref_s, rtol=rtol, atol=atol)
    k = ref_s.shape[1]
    for r in np.nonzero((got_i != ref_i).any(axis=1))[0]:
        tol = atol + rtol * np.abs(ref_s[r, 1:])
        group = np.concatenate([[0], np.cumsum(~(np.abs(np.diff(ref_s[r])) <= tol))])
        for g in np.unique(group):
            pos = np.nonzero(group == g)[0]
            if pos[-1] == k - 1:
                continue
            if set(got_i[r, pos]) != set(ref_i[r, pos]):
                raise AssertionError(
                    f"row {r}: ids {got_i[r].tolist()} != {ref_i[r].tolist()} "
                    f"(scores {ref_s[r].tolist()})")
    finite = np.isfinite(ref_s)
    return float(np.abs(got_s[finite] - ref_s[finite]).max(initial=0.0))
