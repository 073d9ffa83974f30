"""Step builders: train_step / prefill_step / decode_step (the JAX
package's ``launch/steps.py``).

The training loss uses a **chunked cross-entropy**: hidden states are cut
into sequence chunks and each chunk's (B, chunk, V) logits are computed,
reduced (logsumexp + the gold logit), and discarded; each chunk is
checkpointed, as the reference's ``jax.checkpoint(body)``, so backward
recomputes it and the full (B, S, V) logits tensor never exists.

A mesh enters the reference through its parameter and activation
shardings (``launch/sharding.py``), which are not ported yet: here a mesh
must hold one device, and a larger one raises (ROADMAP item 11f-b).  The
train step runs the model's plain route (``kernels=False``), as the
reference differentiates its plain ``_sdpa`` and ``_chunked_wkv``: the
flash attention and WKV kernels have no backward and raise under autograd.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedule import warmup_cosine


@dataclasses.dataclass(frozen=True)
class StepOptions:
    """Knobs the perf loop turns (recorded per §Perf iteration)."""

    ce_chunk: int = 512            # sequence chunk of the chunked CE
    seq_shard_activations: bool = True   # Megatron-SP residual sharding
    sharding_mode: str = "2d"      # "2d" (TP+FSDP) | "fsdp" (pure DP/FSDP)
    grad_shard_constraint: bool = False  # pin grads to param sharding (RS > AR)
    microbatch: int = 0            # >0: grad-accumulation microbatches
    aux_weight: float = 0.01
    adamw: AdamWConfig = AdamWConfig()


def mesh_device(mesh) -> torch.device:
    """The one device of ``mesh``; raises for a larger mesh."""
    devices = mesh.devices.reshape(-1)
    if devices.size != 1:
        raise NotImplementedError(
            f"a {mesh.shape} mesh: the port runs on one device until launch/sharding.py's "
            "parameter and activation specs are ported (ROADMAP item 11f-b)")
    return devices[0]


# ---------------------------------------------------------------------------
# chunked cross-entropy
# ---------------------------------------------------------------------------

def _ce_chunk(h, w_unembed, lab):
    logits = (h @ w_unembed.to(h.dtype)).float()                 # (B, c, V)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, torch.clamp(lab, min=0).long()[..., None])[..., 0]
    valid = (lab >= 0).float()
    return torch.sum((lse - gold) * valid), torch.sum(valid)


def chunked_ce(hidden, w_unembed, labels, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over valid (label >= 0) positions, never materializing full logits.

    hidden (B, S, d); w_unembed (d, V); labels (B, S) integers.
    Returns (sum_nll, num_valid), f32.
    """
    b, s, d = hidden.shape
    chunk = min(chunk, s)
    assert s % chunk == 0, f"seq {s} % ce_chunk {chunk} != 0"
    labels = torch.as_tensor(labels, device=hidden.device)
    nll = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(s // chunk):
        part = (hidden[:, i * chunk:(i + 1) * chunk], w_unembed,
                labels[:, i * chunk:(i + 1) * chunk])
        if torch.is_grad_enabled():
            n, c = checkpoint(_ce_chunk, *part, use_reentrant=False)
        else:
            n, c = _ce_chunk(*part)
        nll = nll + n
        cnt = cnt + c
    return nll, cnt


def loss_fn(params, cfg, batch: Dict, opts: StepOptions):
    hidden, aux = M.train_hidden_states(params, cfg, batch)
    w = M.unembed_weight(params, cfg)
    nll, cnt = chunked_ce(hidden, w, batch["labels"], opts.ce_chunk)
    ce = nll / torch.clamp(cnt, min=1.0)
    loss = ce + opts.aux_weight * aux
    return loss, {"ce": ce, "aux": aux, "tokens": cnt}


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

def make_train_step(cfg, mesh=None, opts: StepOptions = StepOptions(), total_steps: int = 10_000):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params`` is a model built to train (``init_train_state``: f32 master
    weights that require grad); the step updates it and ``opt_state`` in
    place.  The metrics are 0-d tensors on the model's device (reading one
    waits for the step)."""
    if mesh is not None:
        mesh_device(mesh)

    def compute_grads(params, batch):
        leaves = dict(params.named_parameters())
        frozen = [n for n, p in leaves.items() if not p.requires_grad]
        if frozen:
            raise ValueError(f"{len(frozen)} parameters do not require grad ({frozen[0]}, ...): "
                             "train a model built with master=True (init_train_state)")
        with torch.enable_grad():
            loss, metrics = loss_fn(params, cfg, batch, opts)
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        # a leaf the loss does not reach (whisper's unused cross gate) gets 0, as in JAX
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(leaves.items(), grads)}
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(params, opt_state, batch):
        if opts.microbatch and opts.microbatch > 1:
            mb = opts.microbatch
            b = batch["tokens"].shape[0]
            assert b % mb == 0
            n = b // mb
            gsum, lsum = None, 0.0
            for i in range(mb):
                sub = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                loss, _, grads = compute_grads(params, sub)
                gsum = grads if gsum is None else {k: gsum[k] + g for k, g in grads.items()}
                lsum = lsum + loss
            grads = {k: g / mb for k, g in gsum.items()}
            loss = lsum / mb
            zero = torch.zeros((), dtype=torch.float32, device=loss.device)
            metrics = {"ce": loss, "aux": zero, "tokens": zero}
        else:
            loss, metrics, grads = compute_grads(params, batch)
        lr_scale = warmup_cosine(opt_state["step"], total=total_steps)
        params, opt_state, opt_metrics = adamw_update(params, grads, opt_state, opts.adamw,
                                                      lr_scale)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def init_train_state(cfg, generator: torch.Generator = None, device=None):
    """A model to train (f32 masters, the plain route) and its AdamW state,
    on ``device`` (CUDA unless named), drawn from ``generator`` (by default
    ``torch.Generator(device).manual_seed(0)``, as the reference's key 0)."""
    if generator is None:
        generator = torch.Generator(resolve_device(device)).manual_seed(0)
    params = M.init_params(generator, cfg, kernels=False, master=True)
    return params, adamw_init(params)


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------

def make_prefill_step(cfg, mesh=None, opts: StepOptions = StepOptions()):
    """(params, batch, cache) -> (last logits, filled cache)."""
    if mesh is not None:
        mesh_device(mesh)

    def prefill_step(params, batch, cache):
        return M.prefill(params, cfg, batch, cache)

    return prefill_step


def make_decode_step(cfg, mesh=None, opts: StepOptions = StepOptions()):
    """(params, token, cache, pos) -> (logits, new cache). One new token."""
    if mesh is not None:
        mesh_device(mesh)

    def decode_step(params, token, cache, pos):
        return M.decode_step(params, cfg, token, cache, pos)

    return decode_step
