"""Step builders: train_step / prefill_step / decode_step (the JAX
package's ``launch/steps.py``).

The training loss uses a **chunked cross-entropy**: hidden states are cut
into sequence chunks and each chunk's (B, chunk, V) logits are computed,
reduced (logsumexp + the gold logit), and discarded; each chunk is
checkpointed, as the reference's ``jax.checkpoint(body)``, so backward
recomputes it and the full (B, S, V) logits tensor never exists.  The
train step runs the model's plain route (``kernels=False``), as the
reference differentiates its plain ``_sdpa`` and ``_chunked_wkv``: the
flash attention and WKV kernels have no backward and raise under autograd.

**Over a mesh of more than one position.**  One process drives every
position (``launch/mesh.py::DeviceMesh``; no process group).  The
reference hands its mesh to GSPMD through parameter and activation
shardings; the port places storage by the same specs and computes each
batch slice whole on one device:

* Parameters and their AdamW ``m``/``v`` live as the blocks
  ``launch/sharding.py::param_spec`` gives each position, on its device
  (``launch/placement.py``): for every leaf, the ``'data'`` axis and, in
  ``"2d"``/``"2d_etp"``, the ``'model'`` axis split the leaf's storage as
  the spec says (TP axes: heads, d_ff, vocab, experts; FSDP axis: the
  largest other one); ``"fsdp"`` splits one axis over both; leaves below
  ``REPLICATE_BELOW`` elements, and every axis the spec leaves whole, are
  replicated, one copy a position.  ``opt["step"]`` is one int32 a
  position.
* The batch splits along axis 0 by ``batch_spec``: over the DP axes
  (``'pod'``, ``'data'``) in ``"2d"``, over ``'model'`` too in
  ``"fsdp"``; each slice runs forward and backward on the device of its
  position (the others' coordinates 0: in ``"2d"`` the data row's ``(d,
  0)``), on every leaf gathered from its blocks into that device's compute
  model.
* Gradients are summed over the slices in mesh order onto each block's
  owner; the global norm counts every distinct block once; AdamW updates
  each block on its owner, so replicated copies stay equal.

So the ``'model'`` axis shards **storage, not compute** (the counterpart
of GSPMD's TP + FSDP placement, and of ZeRO): splitting a matmul over it
would reorder its sums and needs collectives a one-process design does
not have.  ``grad_shard_constraint`` pins the reference's gradients to the
parameter shardings, a layout hint that changes no value: here every
gradient already lands on its block's owner, and the option changes
nothing.

The whole-batch semantics a split must keep:

* the CE mean divides by the whole batch's count of valid labels (each
  slice adds ``nll_d / C``, with ``C`` counted before the forward pass),
  never a mean of the slices' means;
* the MoE load-balance loss is a product of means over all tokens: the
  slices' ``frac_tokens`` (no gradient) are averaged into a constant, and
  slice ``d`` adds ``E·K·Σ_e frac_tokens_e · frac_probs_e^(d) / D`` a layer
  (``models/moe.py::record_balance``);
* MoE groups: the reference's group size depends on the whole batch's
  token count, so a slice must hold whole groups; a batch whose groups
  would straddle two slices raises, naming the limit;
* ``microbatch > 1`` splits the global batch first, and each microbatch
  runs over the mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.launch.placement import MeshParams, positions_along, unique_boxes
from repro_torch.launch.sharding import (
    batch_spec,
    make_activation_constraint,
    make_named_constraint,
)
from repro_torch.models import model as M
from repro_torch.models.moe import group_size, record_balance
from repro_torch.models.shardctx import activation_sharding
from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_leaf_update,
    adamw_scalars,
    adamw_update,
    clip_scale,
    decays,
)
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


TOTAL_STEPS = 10_000   # the learning-rate schedule's length unless a step is given one


def mesh_size(mesh) -> int:
    """The number of positions of ``mesh`` (1 for None)."""
    return 1 if mesh is None else int(mesh.devices.size)


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

def _require_grad(leaves):
    frozen = [n for n, p in leaves.items() if not p.requires_grad]
    if frozen:
        raise ValueError(f"{len(frozen)} parameters do not require grad ({frozen[0]}, ...): "
                         "train a model built with master=True (init_train_state)")


def _split_microbatches(batch, mb: int):
    b = batch["tokens"].shape[0]
    assert b % mb == 0
    n = b // mb
    return [{k: v[i * n:(i + 1) * n] for k, v in batch.items()} for i in range(mb)]


def make_train_step(cfg, mesh=None, opts: StepOptions = StepOptions(),
                    total_steps: int = TOTAL_STEPS):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params`` is a model built to train (``init_train_state``: f32 master
    weights that require grad); the step updates it and ``opt_state`` in
    place.  The metrics are 0-d tensors on the model's device (reading one
    waits for the step).  Over a mesh of more than one position the state
    is ``launch/placement.py::place_train_state``'s (the module doc says
    what the step does there)."""
    if mesh_size(mesh) > 1:
        return _make_mesh_train_step(cfg, mesh, opts, total_steps)

    def compute_grads(params, batch):
        leaves = dict(params.named_parameters())
        _require_grad(leaves)
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
            gsum, lsum = None, 0.0
            for sub in _split_microbatches(batch, mb):
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


# ---------------------------------------------------------------------------
# the train step over a mesh (the module doc)
# ---------------------------------------------------------------------------

def batch_slices(mesh, batch, mode: str = "2d") -> List[Tuple[int, int, int]]:
    """[(mesh position, first row, end row)]: the batch's axis 0 split by
    ``batch_spec``, slice i at the i-th position over its axes; the whole
    batch at position 0 where the spec leaves it whole."""
    b = batch["tokens"].shape[0]
    entry = batch_spec(tuple(batch["tokens"].shape), mesh, mode)[0]
    names = () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))
    pos = positions_along(mesh, names)
    n = b // len(pos)
    return [(p, i * n, (i + 1) * n) for i, p in enumerate(pos)]


def check_moe_groups(cfg, tokens: int, slices: int) -> None:
    """Raise unless each of ``slices`` equal slices of a batch of
    ``tokens`` tokens holds whole MoE groups of the whole batch's size."""
    if cfg.family != "moe" or slices == 1:
        return
    tg = group_size(tokens, cfg)
    if (tokens // slices) % tg:
        raise ValueError(
            f"MoE groups of {tg} tokens (the largest divisor of the batch's {tokens} tokens up "
            f"to moe_group_size {cfg.moe_group_size}) straddle its {slices} slices of "
            f"{tokens // slices} tokens: a batch split over a mesh must give each slice whole "
            "groups")


def slice_forward(cfg, mesh, opts: StepOptions, model, batch, device):
    """One batch slice's forward on its position's compute model ``model``
    (on ``device``, the batch slice there too), under the slice's activation
    constraints: (the slice's summed NLL, the MoE layers' balance records,
    ``models/moe.py::record_balance``'s), both still holding the graph."""
    _require_grad(dict(model.named_parameters()))
    hooks = (make_activation_constraint(mesh, opts.seq_shard_activations, opts.sharding_mode,
                                        device),
             make_named_constraint(mesh, opts.sharding_mode, device))
    with torch.enable_grad(), activation_sharding(*hooks), record_balance() as bal:
        hidden, _ = M.train_hidden_states(model, cfg, batch)
        nll, _ = chunked_ce(hidden, M.unembed_weight(model, cfg), batch["labels"],
                            opts.ce_chunk)
    return nll, bal


def balance_means(balances, device):
    """The MoE balance's frac_tokens and frac_probs (detached) averaged over
    the slices' records, a layer at a time, on ``device`` (the slices are of
    equal size: the mean of their means over all tokens)."""
    d = len(balances)
    layers = range(len(balances[0]))
    ft = [torch.stack([bal[i][0].to(device) for bal in balances]).sum(0) / d for i in layers]
    fp = [torch.stack([bal[i][1].detach().to(device) for bal in balances]).sum(0) / d
          for i in layers]
    return ft, fp


def slice_grads(cfg, opts: StepOptions, model, nll, bal, frac_tokens, count, slices: int):
    """{name: gradient} of one slice's share of the whole batch's loss:
    ``nll / C`` plus its balance term over ``slices`` slices (the module
    doc), taken on the slice's compute model."""
    dev = nll.device
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    part = nll / torch.clamp(count.to(dev), min=1.0)
    if bal:
        term = torch.zeros((), dtype=torch.float32, device=dev)
        for f_t, (_, f_p) in zip(frac_tokens, bal):
            term = term + e * torch.sum(f_t.to(dev) * f_p) * k
        part = part + opts.aux_weight * (term / slices)
    leaves = dict(model.named_parameters())
    with torch.enable_grad():
        grads = torch.autograd.grad(part, list(leaves.values()), allow_unused=True)
    # a leaf the loss does not reach gets 0, as in JAX
    return {name: torch.zeros_like(leaf) if g is None else g
            for (name, leaf), g in zip(leaves.items(), grads)}


def grad_norm(params: MeshParams, grads, positions=None) -> torch.Tensor:
    """The global gradient norm of a mesh step, on position 0's device:
    each distinct block once, squared and summed on the first position
    holding it.  ``positions`` keeps only the blocks those positions sum
    (one position's share of the work)."""
    dev0 = params.devices[0]
    sq = torch.zeros((), dtype=torch.float32, device=dev0)
    for name, boxes in params.boxes.items():
        for p, _ in unique_boxes(boxes):
            if positions is None or p in positions:
                sq = sq + torch.sum(torch.square(grads[name][p].float())).to(dev0)
    return torch.sqrt(sq)


def update_position(params: MeshParams, p: int, grads, opt, clip, cfg_a: AdamWConfig,
                    total_steps: int):
    """AdamW on position ``p``'s blocks, on its device, with the step's
    ``clip`` scale; advances its step count.  Returns the learning rate."""
    dev = params.devices[p]
    lr_scale = warmup_cosine(opt["step"][p], total=total_steps)
    step, b1t, b2t, lr = adamw_scalars(opt["step"][p], cfg_a, lr_scale)
    c = clip.to(dev)
    with torch.no_grad():
        for name in params.names():
            blk = params.blocks[name][p]
            if blk is not None:
                adamw_leaf_update(blk, grads[name][p], opt["m"][name][p], opt["v"][name][p], c,
                                  b1t, b2t, lr, cfg_a, decays(name, blk))
    opt["step"][p] = step
    return lr


def _make_mesh_train_step(cfg, mesh, opts: StepOptions, total_steps: int):
    mode = opts.sharding_mode
    e, k = cfg.num_experts, cfg.num_experts_per_tok

    def compute_grads(params: MeshParams, batch, stats):
        """(loss, metrics, {name: [the summed gradient block a position]})
        of the whole batch: every slice's forward first (the MoE balance
        needs all of them), then each slice's backward, its gradients added
        onto the blocks' owners in mesh order."""
        dev0 = params.devices[0]
        slices = batch_slices(mesh, batch, mode)
        b, s = batch["tokens"].shape[:2]
        check_moe_groups(cfg, b * s, len(slices))
        labels = torch.as_tensor(batch["labels"])
        count = (labels >= 0).sum().to(dev0, torch.float32)    # C, before the forward
        runs = []
        for p, lo, hi in slices:
            dev = params.devices[p]
            model, moved = params.gather(dev)
            stats["gathered"] += moved
            sub = {key: torch.as_tensor(v)[lo:hi].to(dev) for key, v in batch.items()}
            runs.append((model, *slice_forward(cfg, mesh, opts, model, sub, dev)))
        d = len(runs)
        ft, fp = balance_means([bal for *_, bal in runs], dev0)
        aux = torch.zeros((), dtype=torch.float32, device=dev0)
        for f_t, f_p in zip(ft, fp):
            aux = aux + e * torch.sum(f_t * f_p) * k
        nll_sum = torch.zeros((), dtype=torch.float32, device=dev0)
        for _, nll, _ in runs:
            nll_sum = nll_sum + nll.detach().to(dev0)
        ce = nll_sum / torch.clamp(count, min=1.0)
        loss = ce + opts.aux_weight * aux

        acc = {}     # (name, owner group) -> the gradient block summed so far
        for model, nll, bal in runs:
            for name, g in slice_grads(cfg, opts, model, nll, bal, ft, count, d).items():
                for i, (box, owner, _) in enumerate(params.owners[name]):
                    piece = g[box]
                    stats["reduced"] += piece.numel() * piece.element_size()
                    if (name, i) in acc:
                        acc[name, i].add_(piece.to(owner))
                    else:
                        acc[name, i] = piece.to(owner, copy=True)
        grads = {}
        for name, groups in params.owners.items():
            grads[name] = [None] * len(params.devices)
            for i, (_, _, held) in enumerate(groups):
                for p in held:
                    grads[name][p] = acc[name, i]
        metrics = {"ce": ce, "aux": aux, "tokens": count}
        return loss, metrics, grads

    def update(params: MeshParams, grads, opt):
        """AdamW on every block, on its owner; the norm counts each
        distinct block once."""
        gnorm = grad_norm(params, grads)
        clip = clip_scale(gnorm, opts.adamw)
        lrs = [update_position(params, p, grads, opt, clip, opts.adamw, total_steps)
               for p in range(len(params.devices))]
        params.updated()
        return {"grad_norm": gnorm, "lr": lrs[0]}

    def train_step(params, opt_state, batch):
        if not isinstance(params, MeshParams):
            raise TypeError(f"a step over the {mesh.shape} mesh takes the state placed on it "
                            "(launch/placement.py::place_train_state), not "
                            f"{type(params).__name__}")
        stats = train_step.stats = {"gathered": 0, "reduced": 0}
        if opts.microbatch and opts.microbatch > 1:
            mb = opts.microbatch
            gsum, lsum = None, 0.0
            for sub in _split_microbatches(batch, mb):
                loss, _, grads = compute_grads(params, sub, stats)
                gsum = grads if gsum is None else {
                    n: [None if a is None else a + g for a, g in zip(gsum[n], grads[n])]
                    for n in grads}
                lsum = lsum + loss
            grads = {n: [None if g is None else g / mb for g in gs] for n, gs in gsum.items()}
            loss = lsum / mb
            zero = torch.zeros((), dtype=torch.float32, device=loss.device)
            metrics = {"ce": loss, "aux": zero, "tokens": zero}
        else:
            loss, metrics, grads = compute_grads(params, batch, stats)
        opt_metrics = update(params, grads, opt_state)
        return params, opt_state, {"loss": loss.detach(), **metrics, **opt_metrics}

    train_step.stats = {"gathered": 0, "reduced": 0}
    return train_step


def init_train_state(cfg, generator: torch.Generator = None, device=None):
    """A model to train (f32 masters, the plain route) and its AdamW state,
    on ``device`` (CUDA unless named), drawn from ``generator`` (by default
    ``torch.Generator(device).manual_seed(0)``, as the reference's key 0)."""
    if generator is None:
        generator = torch.Generator(resolve_device(device)).manual_seed(0)
    params = M.init_params(generator, cfg, kernels=False, master=True)
    return params, adamw_init(params)


def abstract_train_state(cfg):
    """``init_train_state``'s model and AdamW state on the meta device:
    every leaf's shape and dtype, no data (the reference's ``jax.eval_shape``
    of ``init_train_state``; a meta device has no generator to draw from).
    The parameters are the f32 masters where the reference's leaf is in the
    compute dtype (bf16 for most archs): the masters are what the port
    stores and updates."""
    params = M.abstract_params(cfg, kernels=False, master=True)
    return params, adamw_init(params)


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------

def make_prefill_step(cfg, mesh=None, opts: StepOptions = StepOptions()):
    """(params, batch, cache) -> (last logits, filled cache).  With a mesh,
    the activation constraints are installed around the call (checks that
    every residual lies on the device of ``params``, the slot's row)."""

    def prefill_step(params, batch, cache):
        if mesh is None:
            return M.prefill(params, cfg, batch, cache)
        dev = params.device
        hooks = (make_activation_constraint(mesh, opts.seq_shard_activations,
                                            opts.sharding_mode, dev),
                 make_named_constraint(mesh, opts.sharding_mode, dev))
        with activation_sharding(*hooks):
            return M.prefill(params, cfg, batch, cache)

    return prefill_step


def make_decode_step(cfg, mesh=None, opts: StepOptions = StepOptions()):
    """(params, token, cache, pos) -> (logits, new cache). One new token."""

    def decode_step(params, token, cache, pos):
        return M.decode_step(params, cfg, token, cache, pos)

    return decode_step
