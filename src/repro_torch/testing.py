"""How the port's results are held to their references.

The parity rule for top-k results (ROADMAP.md "Parity standard"): scores
agree within a tolerance; ids are equal, except inside a group of
positions whose reference scores tie within that tolerance, where the id
*sets* must be equal.  A tie group cut off by k at the tail is held to its
scores only: which of the tied candidates made the cut depends on the
last ulp.

``with_zero_rows`` and ``doubled`` make the fused join kernel's edge
cases: an R block that offers nothing, and equal scores in two S ranges.

The LM kernels (flash_attn, wkv) are held to their plain versions by
``flash_close`` and ``wkv_close``, one tolerance table for every caller;
``attention_calls`` is the flash_attn launches a model's prefill or decode
step must show.

The train step on the card is held to its CPU run by ``train_close``: the
metrics within TRAIN_METRIC_RTOL, the parameters within one Adam step a
step (the sum of the steps' ``lr``: a near-zero gradient may flip the sign
of its bias-corrected step on either device); ``train_batches`` and
``train_run`` give both runs the same batches and weights.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.sparse.format import SparseBatch


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


def with_zero_rows(batch: SparseBatch, lo: int, hi: int) -> SparseBatch:
    """A copy of ``batch`` whose rows [lo, hi) have all weights 0: they keep
    their tile occupancy but score 0 against everything, so no candidate
    is ever offered to them."""
    values = batch.values.clone()
    values[lo:hi] = 0.0
    return dataclasses.replace(batch, values=values)


def doubled(batch: SparseBatch) -> SparseBatch:
    """``batch`` followed by a copy of itself: row j + N ties row j."""
    return SparseBatch(indices=torch.cat([batch.indices] * 2),
                       values=torch.cat([batch.values] * 2),
                       nnz=torch.cat([batch.nnz] * 2), dim=batch.dim)


# The LM kernels against their plain versions (rtol, atol).  flash_attn f32
# and wkv f32: summation order only.  flash_attn bf16: the kernel rounds p to
# bf16 before PV, as the Pallas kernel does, and the plain version does not;
# that moves an output by a few 2^-9 of its row's RMS, so the absolute part
# is scaled by the row's RMS, and one bf16 ulp of the output's own rounding
# falls under rtol.  wkv: the kernel's cumsum is sequential, torch.cumsum's
# is not, and the exps amplify the difference; the outputs reach tens at
# T = 4096, so the absolute part is scaled by max(1, max|want|).  wkv bf16
# computes in f32 on the same rounded inputs: only the output's rounding is
# added, under rtol.
FLASH_TOL = {torch.float32: (1e-5, 2e-5), torch.bfloat16: (1.6e-2, 1.6e-2)}
WKV_TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (1.6e-2, 2e-4)}


def tolerance_used(got, want, rtol, atol, scale=1.0) -> tuple[float, float]:
    """(max |got - want|, the largest share of rtol·|want| + atol·scale that
    any element uses), compared in f32; ``scale`` broadcasts against
    ``want``.  A share above 1 fails; NaN reads as inf."""
    g, w = got.float(), want.float()
    if g.shape != w.shape or got.dtype != want.dtype:
        raise AssertionError(f"{got.dtype} {tuple(g.shape)} != {want.dtype} {tuple(w.shape)}")
    if not w.numel():
        return 0.0, 0.0
    diff = (g - w).abs()
    used = torch.where(diff == 0, 0.0, diff / (rtol * w.abs() + atol * scale))
    used = used.nan_to_num(nan=float("inf"), posinf=float("inf"))
    return float(diff.nan_to_num(nan=float("inf")).max()), float(used.max())


def close_within(got, want, rtol, atol, scale=1.0) -> tuple[float, float]:
    """Raise AssertionError unless |got - want| <= rtol·|want| + atol·scale
    everywhere; return ``tolerance_used``."""
    max_diff, used = tolerance_used(got, want, rtol, atol, scale)
    if used > 1.0:
        raise AssertionError(f"max |got - want| = {max_diff:.3e}; an element uses "
                             f"{used:.3g}x its tolerance (rtol {rtol}, atol {atol} x scale)")
    return max_diff, used


def flash_tolerance(want) -> tuple[float, float, object]:
    """(rtol, atol, scale) for flash_attn outputs: FLASH_TOL[want.dtype]; in
    bf16 the absolute part is scaled by each query row's RMS over hd."""
    rtol, atol = FLASH_TOL[want.dtype]
    if want.dtype != torch.bfloat16:
        return rtol, atol, 1.0
    return rtol, atol, want.float().pow(2).mean(dim=-1, keepdim=True).sqrt()


def flash_close(got, want) -> tuple[float, float]:
    """``close_within`` at ``flash_tolerance(want)``."""
    return close_within(got, want, *flash_tolerance(want))


def wkv_close(got, want) -> tuple[float, float]:
    """``close_within`` at WKV_TOL[want.dtype], the absolute part scaled by
    max(1, max|want|)."""
    rtol, atol = WKV_TOL[want.dtype]
    scale = max(1.0, float(want.float().abs().max())) if want.numel() else 1.0
    return close_within(got, want, rtol, atol, scale)


def attention_calls(cfg, prefill: bool) -> int:
    """The attention cores (so flash_attn launches) of one prefill, or of
    one decode step, of a model of ``cfg``: each self, local and cross
    attention layer once, and in an audio prefill each encoder layer."""
    if cfg.family in ("dense", "moe"):
        return cfg.num_layers
    if cfg.family == "vlm":   # units of cross_attn_every - 1 self layers and a cross layer
        return cfg.num_layers // cfg.cross_attn_every * cfg.cross_attn_every
    if cfg.family == "hybrid":
        pat = cfg.block_pattern
        n_units, n_tail = divmod(cfg.num_layers, len(pat))
        attn = [kind != "rglru" for kind in pat]
        return n_units * sum(attn) + sum(attn[:n_tail])
    if cfg.family == "audio":
        return 2 * cfg.num_layers + (cfg.num_encoder_layers if prefill else 0)
    return 0                  # ssm: attention-free


# ---------------------------------------------------------------------------
# the train step on the card against its CPU run
# ---------------------------------------------------------------------------

TRAIN_METRIC_RTOL = 1e-4
TRAIN_METRICS = ("loss", "ce", "aux", "grad_norm", "lr")


def train_batches(cfg, steps: int, batch: int, seq: int, seed: int = 0):
    """``make_lm_batch`` batches 0..steps-1 of the token stream, with seeded
    N(0, 1) frames (audio) or patches (vlm)."""
    from repro_torch.data.pipeline import make_lm_batch

    rng = np.random.default_rng(seed)
    out = []
    for i in range(steps):
        b = make_lm_batch(seed, i, batch, seq, cfg.vocab_size)
        if cfg.family == "audio":
            b["frames"] = rng.standard_normal((batch, cfg.encoder_seq, cfg.d_model),
                                              dtype=np.float32)
        if cfg.family == "vlm":
            b["patches"] = rng.standard_normal((batch, cfg.num_patches, cfg.d_model),
                                               dtype=np.float32)
        out.append(b)
    return out


def train_run(cfg, weights, device, batches, opts):
    """A model to train holding ``weights`` (a state dict) on ``device``,
    trained on ``batches``: (the model, [each step's metrics as floats])."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import adamw_init

    model = LM(cfg, device=device, kernels=False, master=True)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])
    opt = adamw_init(model)
    step = make_train_step(cfg, None, opts)
    metrics = []
    for b in batches:
        b = {k: torch.as_tensor(v).to(device) for k, v in b.items()}
        model, opt, m = step(model, opt, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return model, metrics


def _named(model) -> dict:
    return dict(model.named_parameters()) if hasattr(model, "named_parameters") else dict(model)


def train_close(got_model, got_metrics, want_model, want_metrics) -> dict:
    """Raise AssertionError unless a train run matches another (metrics and
    parameters, ``train_close``'s tolerances); return the largest share of
    each tolerance used: {"metrics": x, "params": y}.  A model is an ``LM``
    or a mapping of its parameters' names to tensors."""
    used = {"metrics": 0.0, "params": 0.0}
    for i, (g, w) in enumerate(zip(got_metrics, want_metrics, strict=True)):
        for key in TRAIN_METRICS:
            tol = TRAIN_METRIC_RTOL * abs(w[key]) + 1e-7
            share = abs(g[key] - w[key]) / tol
            assert share <= 1.0, (f"step {i} {key}", g[key], w[key])
            used["metrics"] = max(used["metrics"], share)
    bound = sum(m["lr"] for m in want_metrics)
    want = _named(want_model)
    for name, p in _named(got_model).items():
        err = float((p.detach().cpu() - want[name].detach().cpu()).abs().max())
        assert err <= bound, (name, err, bound)
        used["params"] = max(used["params"], err / bound)
    return used
