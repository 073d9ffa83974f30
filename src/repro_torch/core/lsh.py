"""SimHash LSH band index — the approximate pre-filter tier (the PyTorch
counterpart of ``repro.core.lsh``).

Every exact driver (BF, IIB, IIIB) is linear in |S|; the band index in
front of them is the sub-linear candidate generator (classic banding,
transplanted to SimHash because the paper's similarity is the sparse dot
product):

* **Signatures** — each row gets ``n_bands x rows_per_band`` sign bits of
  seeded Gaussian projections (Charikar SimHash).  Two rows at cosine
  similarity ``s`` agree on one bit with probability
  ``p(s) = 1 - arccos(s) / pi``.
* **Banding** — the bits split into ``n_bands`` bands of ``rows_per_band``
  bits, each packed into one int32 key.  A pair collides when ANY band's
  keys are equal: ``P[collide] = 1 - (1 - p(s)^r)^b``, the S-curve whose
  knee :func:`plan_bands` places from ``target_recall``.
* **Candidate mask** — per query R block, :func:`candidate_mask` sorts the
  block's real-row keys per band and membership-tests the S keys with
  ``torch.searchsorted`` (O(|S| log |R|), no hash tables), ORing over
  bands.  The mask ANDs into the same valid masks tombstones use, so the
  exact drivers re-rank just the candidates.

The planner, :class:`LSHConfig`, :class:`LSHBands` (the seeded projections
and ``keys_host``), :func:`candidate_mask_host` and
:func:`measured_recall` are plain Python and numpy, the reference's code:
the same seed gives the same projections and byte-identical keys.  Keys
are built on the host at build/extend time and persist per block; keys
computed on the card could differ in the sign of a near-zero projection
and would then no longer equal the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

# planning bounds: keys pack into int32 (rows_per_band <= 24 keeps the
# packed key well under 2^31) and the signature budget caps device memory
# (n_bits = n_bands * rows_per_band int32 keys per row is the footprint)
MAX_ROWS_PER_BAND = 24
MAX_SIG_BITS = 512
DEFAULT_SIM_THRESHOLD = 0.9


def collision_probability(sim: float, rows_per_band: int, n_bands: int) -> float:
    """P[some band collides] for a pair at cosine similarity ``sim``."""
    s = min(max(float(sim), -1.0), 1.0)
    p_bit = 1.0 - math.acos(s) / math.pi
    return 1.0 - (1.0 - p_bit ** rows_per_band) ** n_bands


def plan_bands(
    target_recall: float,
    sim_threshold: float = DEFAULT_SIM_THRESHOLD,
    max_bits: int = MAX_SIG_BITS,
    max_rows: int = MAX_ROWS_PER_BAND,
) -> Tuple[int, int]:
    """(n_bands, rows_per_band) meeting the recall bar with the most
    selective filter that fits the signature budget.

    For each band width r the smallest band count b with
    ``1 - (1 - p^r)^b >= target_recall`` (p = per-bit agreement at
    ``sim_threshold``) is closed-form; among the (b, r) that fit
    ``b * r <= max_bits`` the plan keeps the one minimizing the
    background collision bound ``b * 0.5^r`` (orthogonal pairs agree on a
    bit with p = 1/2).
    """
    if not 0.0 < target_recall < 1.0:
        raise ValueError(f"target_recall must be in (0, 1), got {target_recall}")
    s = min(max(float(sim_threshold), -1.0), 1.0)
    p_bit = 1.0 - math.acos(s) / math.pi
    best = None
    for r in range(1, max_rows + 1):
        p_band = p_bit ** r
        if p_band >= 1.0:
            b = 1
        else:
            b = math.ceil(math.log1p(-target_recall) / math.log1p(-p_band))
        if b < 1 or b * r > max_bits:
            continue
        fp = b * 0.5 ** r
        key = (fp, b * r)
        if best is None or key < best[0]:
            best = (key, (b, r))
    if best is None:
        # nothing fits the budget: fall back to the widest bands possible
        r = max(1, max_bits // max_rows)
        return max(1, max_bits // r), r
    return best[1]


@dataclasses.dataclass(frozen=True)
class LSHConfig:
    """Frozen band-index parameters: a pure function of the JoinSpec
    (``plan_lsh``) unless passed in, so every holder of one config hashes
    alike."""

    n_bands: int
    rows_per_band: int
    seed: int = 0
    sim_threshold: float = DEFAULT_SIM_THRESHOLD
    target_recall: float = 0.95

    def __post_init__(self):
        if self.n_bands < 1 or self.rows_per_band < 1:
            raise ValueError("n_bands and rows_per_band must be >= 1")
        if self.rows_per_band > 30:
            raise ValueError("rows_per_band > 30 overflows the int32 band key")

    @property
    def n_bits(self) -> int:
        return self.n_bands * self.rows_per_band

    def recall_at(self, sim: float) -> float:
        return collision_probability(sim, self.rows_per_band, self.n_bands)


def plan_lsh(
    target_recall: float,
    seed: int = 0,
    sim_threshold: float = DEFAULT_SIM_THRESHOLD,
) -> LSHConfig:
    """Resolve an LSHConfig from a JoinSpec's ``target_recall``."""
    b, r = plan_bands(target_recall, sim_threshold=sim_threshold)
    return LSHConfig(
        n_bands=b, rows_per_band=r, seed=seed,
        sim_threshold=sim_threshold, target_recall=target_recall,
    )


class LSHBands:
    """Per-datastore SimHash band hasher: one (dim+1, n_bits) projection
    matrix (row ``dim`` is the zero sentinel row, so padded features
    contribute nothing) shared by the R and S sides."""

    _KEY_CHUNK = 1024  # rows hashed per host chunk (bounds the gather temp)

    def __init__(self, cfg: LSHConfig, dim: int):
        self.cfg = cfg
        self.dim = int(dim)
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 0x15B]))
        proj = rng.standard_normal((self.dim + 1, cfg.n_bits)).astype(np.float32)
        proj[self.dim] = 0.0  # sentinel feature index hashes to nothing
        self._proj = proj
        self._pack = (1 << np.arange(cfg.rows_per_band, dtype=np.int64)).astype(np.int32)

    def keys_host(self, idx: np.ndarray, val: np.ndarray) -> np.ndarray:
        """(N, n_bands) int32 band keys of padded sparse rows (host numpy).

        Rows with no features (padding, empty queries) hash to all-zero
        projections and get key 0 in every band — the masks exclude them by
        the valid / real-row masks, never by key value.
        """
        idx = np.asarray(idx)
        val = np.asarray(val, np.float32)
        n = idx.shape[0]
        cfg = self.cfg
        out = np.empty((n, cfg.n_bands), np.int32)
        safe = np.minimum(idx, self.dim)
        for lo in range(0, n, self._KEY_CHUNK):
            hi = min(lo + self._KEY_CHUNK, n)
            # (chunk, F, n_bits) gather -> (chunk, n_bits) signed projections
            h = np.einsum("nf,nfb->nb", val[lo:hi], self._proj[safe[lo:hi]], optimize=True)
            bits = (h > 0.0).reshape(hi - lo, cfg.n_bands, cfg.rows_per_band)
            out[lo:hi] = bits @ self._pack
        return out


def band_hits(r_keys: torch.Tensor, r_real: torch.Tensor, s_keys: torch.Tensor) -> torch.Tensor:
    """(..., s_block) bool — does any real R row collide with the S row in
    any band?  Per band, the R block's keys are sorted (excluded rows get
    the int32 max, which no packed key reaches) and every S key is looked
    up with ``torch.searchsorted``, batched over the bands.

    ``r_keys`` (rb, n_bands) int32, ``r_real`` (rb,) bool (padded / empty R
    rows out of the union), ``s_keys`` (..., s_block, n_bands) int32.
    """
    sentinel = torch.iinfo(torch.int32).max
    rk = torch.where(r_real[:, None], r_keys, sentinel)
    rs = torch.sort(rk, dim=0).values.T.contiguous()          # (n_bands, rb)
    lead = s_keys.shape[:-1]
    n_bands = s_keys.shape[-1]
    sk = s_keys.reshape(-1, n_bands).T.contiguous()           # (n_bands, N)
    pos = torch.searchsorted(rs, sk).clamp_(max=rs.shape[1] - 1)
    hit = torch.gather(rs, 1, pos) == sk                      # (n_bands, N)
    return hit.any(dim=0).reshape(lead)


def candidate_mask(
    r_keys: torch.Tensor, r_real: torch.Tensor,
    s_keys: torch.Tensor, s_valid: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The band-lookup pass of a query R block: the candidate mask over the
    stacked S blocks plus its live-candidate count.

    Returns ``(mask, count)``: ``mask`` has ``s_keys``' leading shape,
    ``count`` is the number of live rows surviving the filter
    (``sum(mask & s_valid)``, the numerator of
    ``JoinStats.candidate_fraction``), a device tensor until the R block's
    result pull.
    """
    mask = band_hits(r_keys, r_real, s_keys)
    return mask, torch.logical_and(mask, s_valid).sum()


def candidate_mask_host(
    r_keys: np.ndarray, r_real: np.ndarray, s_keys: np.ndarray,
) -> np.ndarray:
    """Host (numpy) twin of :func:`band_hits` for the streaming drivers,
    which keep S blocks host-resident.  The same mask."""
    rk = np.asarray(r_keys)[np.asarray(r_real, bool)]
    s_keys = np.asarray(s_keys)
    out = np.zeros(s_keys.shape[:-1], bool)
    for band in range(s_keys.shape[-1]):
        out |= np.isin(s_keys[..., band], rk[:, band])
    return out


def measured_recall(approx_ids: np.ndarray, exact_ids: np.ndarray) -> float:
    """Mean per-query recall of an approximate top-k against the exact one:
    |approx ∩ exact| / |exact| per row, averaged (rows whose exact top-k is
    empty — all ids -1 — count as recall 1)."""
    approx_ids = np.asarray(approx_ids)
    exact_ids = np.asarray(exact_ids)
    if approx_ids.shape != exact_ids.shape:
        raise ValueError(f"shape mismatch: {approx_ids.shape} vs {exact_ids.shape}")
    recalls = []
    for a_row, e_row in zip(approx_ids, exact_ids):
        e = set(int(i) for i in e_row if i >= 0)
        if not e:
            recalls.append(1.0)
            continue
        a = set(int(i) for i in a_row if i >= 0)
        recalls.append(len(a & e) / len(e))
    return float(np.mean(recalls)) if recalls else 1.0
