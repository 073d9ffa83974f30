"""The port's train step (src/repro_torch/launch/steps.py) against the JAX
package's ``make_train_step`` on the CPU, at the reduced config of one
arch of every family (f32; vlm and hybrid deepened to two units,
tests/util_lm.py), on the same weights (the JAX ``init_train_state``
tree, perturbed, through ``params_from_jax(master=True)``) and the same
``make_lm_batch`` batches:

* the first step's gradients, leaf by leaf, within GRAD_TOL of each
  leaf's largest gradient;
* ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr`` over 3 steps within
  METRIC_RTOL;
* the parameters after 3 steps within one Adam step a step (the sum of
  the steps' ``lr``: a near-zero gradient may flip the sign of its
  bias-corrected step), and no element past half of it;

then remat (on against off, ``"dots"`` against ``"full"``: the same
gradients bit for bit), the microbatch path's metrics, the f32 masters
behind a bf16 forward, and tests/test_models.py's
``test_arch_smoke_forward_and_train`` over every arch."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import all_arch_names  # noqa: E402
from repro.data.pipeline import make_lm_batch as jax_make_lm_batch  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import make_lm_batch  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import _flatten, _jax_path, params_from_jax  # noqa: E402
from repro_torch.testing import train_batches  # noqa: E402
from util_lm import np_tree, perturbed, reduced  # noqa: E402

FAMILIES = ["qwen3-0.6b", "olmoe-1b-7b", "rwkv6-3b", "recurrentgemma-2b",
            "llama-3.2-vision-11b", "whisper-medium"]
GRAD_TOL = 1e-4       # of each leaf's largest |gradient|
METRIC_RTOL = 1e-5
B, SEQ, CE_CHUNK, STEPS = 2, 16, 8, 3
METRICS = ("loss", "ce", "aux", "grad_norm", "lr")


def _batch(cfg, step):
    """Batch ``step`` of the token stream, plus N(0, 1) frames or patches."""
    return train_batches(cfg, STEPS, B, SEQ)[step]


def _jax_leaves(tree):
    return dict(_flatten(np_tree(tree)))


def _port_leaf(jax_leaves, name):
    path, index = _jax_path(name)
    return jax_leaves[path][index]


@functools.lru_cache(maxsize=None)
def reference(arch, microbatch=0):
    """The JAX train state (perturbed so that norm scales, biases and gates
    are not their constant inits), its first step's gradients, and 3 steps
    of metrics and the parameters after them."""
    jcfg = reduced(arch, jax_cfg=True)
    params, opt = JS.init_train_state(jcfg, jax.random.key(3))
    params = jax.tree.map(jnp.asarray, perturbed(np_tree(params), 7, scale=0.02))
    tree = np_tree(params)
    opts = JS.StepOptions(ce_chunk=CE_CHUNK, microbatch=microbatch)
    batches = [_batch(jcfg, i) for i in range(STEPS)]
    grads = jax.grad(lambda p: JS.loss_fn(p, jcfg, jax.tree.map(jnp.asarray, batches[0]),
                                          opts)[0])(params)
    step = jax.jit(JS.make_train_step(jcfg, None, opts))
    metrics = []
    for b in batches:
        params, opt, m = step(params, opt, jax.tree.map(jnp.asarray, b))
        metrics.append({k: float(v) for k, v in m.items()})
    return tree, _jax_leaves(grads), metrics, _jax_leaves(params)


def _model(arch, tree, **changes):
    return params_from_jax(tree, reduced(arch, **changes), device="cpu", kernels=False,
                           master=True)


def _grads(model, cfg, b):
    loss, _ = S.loss_fn(model, cfg, b, S.StepOptions(ce_chunk=CE_CHUNK))
    leaves = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return {n: (torch.zeros_like(p) if g is None else g)
            for (n, p), g in zip(leaves.items(), grads)}


@pytest.mark.parametrize("arch", FAMILIES)
def test_first_gradients_match_jax(arch):
    tree, jgrads, _, _ = reference(arch)
    cfg = reduced(arch)
    grads = _grads(_model(arch, tree), cfg, _batch(cfg, 0))
    assert {_jax_path(name)[0] for name in grads} == set(jgrads)
    for name, g in grads.items():
        want = _port_leaf(jgrads, name)
        assert g.dtype == torch.float32 and tuple(g.shape) == want.shape, name
        scale = max(float(np.abs(want).max()), 1e-12)
        err = float(np.abs(g.numpy() - want).max())
        assert err <= GRAD_TOL * scale, (name, err, scale)


@pytest.mark.parametrize("arch", FAMILIES)
def test_three_steps_match_jax(arch):
    tree, _, jmetrics, jparams = reference(arch)
    cfg = reduced(arch)
    model = _model(arch, tree)
    opt = S.adamw_init(model)
    step = S.make_train_step(cfg, None, S.StepOptions(ce_chunk=CE_CHUNK))
    for i, want in enumerate(jmetrics):
        model, opt, got = step(model, opt, _batch(cfg, i))
        assert sorted(got) == sorted(want)
        for key in METRICS:
            np.testing.assert_allclose(float(got[key]), want[key], rtol=METRIC_RTOL, atol=1e-7,
                                       err_msg=f"step {i} {key}")
    assert int(opt["step"]) == STEPS and opt["step"].dtype == torch.int32
    bound = sum(m["lr"] for m in jmetrics)      # one Adam step a step
    past_half = 0
    for name, p in model.named_parameters():
        d = np.abs(p.detach().numpy() - _port_leaf(jparams, name))
        assert float(d.max()) <= bound, (name, float(d.max()), bound)
        past_half += int((d > bound / 2).sum())
    assert past_half == 0, past_half


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_gives_the_same_gradients_bit_for_bit(arch):
    """The reference's ``_maybe_remat`` sites as torch.utils.checkpoint:
    on, off and the "dots" policy give the same gradients, bit for bit."""
    tree = reference(arch)[0]
    cfg = reduced(arch)
    b = _batch(cfg, 0)
    want = _grads(_model(arch, tree), cfg, b)
    for policy in ("full", "dots"):
        rcfg = reduced(arch, remat=True, remat_policy=policy)
        got = _grads(_model(arch, tree, remat=True, remat_policy=policy), rcfg, b)
        for name in want:
            assert torch.equal(got[name], want[name]), (policy, name)


def test_remat_recomputes_the_layers_in_backward():
    """Backward recomputes the checkpointed layers: with remat "full" it
    runs the forward's matmuls (aten.mm) again, with "dots" it keeps their
    outputs and recomputes only the rest, with remat off nothing."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = self.ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += 1
            self.mm += func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
            return func(*args, **(kwargs or {}))

    arch = "qwen3-0.6b"
    tree = reference(arch)[0]
    counts = {}
    for key, changes in (("off", {}), ("full", dict(remat=True)),
                         ("dots", dict(remat=True, remat_policy="dots"))):
        cfg = reduced(arch, **changes)
        model = _model(arch, tree, **changes)
        loss, _ = S.loss_fn(model, cfg, _batch(cfg, 0), S.StepOptions(ce_chunk=CE_CHUNK))
        with Count() as c:
            torch.autograd.grad(loss, list(model.parameters()))
        counts[key] = (c.mm, c.ops)
    assert counts["dots"][0] == counts["off"][0] < counts["full"][0], counts
    assert counts["off"][1] < counts["dots"][1] < counts["full"][1], counts


def test_microbatch_metrics_match_jax():
    """The microbatch path: the mean loss as ``ce``, ``aux`` and ``tokens``
    0 (the reference's metrics), the gradients averaged."""
    arch = "olmoe-1b-7b"
    tree, _, jmetrics, jparams = reference(arch, microbatch=2)
    cfg = reduced(arch)
    model = _model(arch, tree)
    opt = S.adamw_init(model)
    step = S.make_train_step(cfg, None, S.StepOptions(ce_chunk=CE_CHUNK, microbatch=2))
    for i, want in enumerate(jmetrics):
        model, opt, got = step(model, opt, _batch(cfg, i))
        assert float(got["aux"]) == want["aux"] == 0.0
        assert float(got["tokens"]) == want["tokens"] == 0.0
        assert float(got["ce"]) == float(got["loss"])
        for key in METRICS:
            np.testing.assert_allclose(float(got[key]), want[key], rtol=METRIC_RTOL, atol=1e-7,
                                       err_msg=f"step {i} {key}")
    bound = sum(m["lr"] for m in jmetrics)
    for name, p in model.named_parameters():
        assert float(np.abs(p.detach().numpy() - _port_leaf(jparams, name)).max()) <= bound


def test_chunked_ce_equals_the_full_cross_entropy():
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.standard_normal((2, 16, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 40)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(-1, 40, (2, 16)))
    for chunk in (4, 16, 64):
        nll, cnt = S.chunked_ce(h, w, labels, chunk)
        full = torch.nn.functional.cross_entropy((h @ w).reshape(-1, 40), labels.reshape(-1),
                                                 ignore_index=-1, reduction="sum")
        torch.testing.assert_close(nll, full, rtol=1e-5, atol=1e-5)
        assert float(cnt) == float((labels >= 0).sum())
    with pytest.raises(AssertionError, match="ce_chunk"):
        S.chunked_ce(h, w, labels, 5)


def test_master_weights_behind_a_bf16_forward():
    """``LM(master=True)`` keeps every parameter in f32 with requires_grad,
    and its forward computes in the config's dtype: on weights that bf16
    holds exactly, the serving model's logits."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(), dtype="bfloat16")
    master = M.init_params(torch.Generator().manual_seed(0), cfg, kernels=False, master=True)
    assert all(p.dtype == torch.float32 and p.requires_grad for p in master.parameters())
    serve = M.LM(cfg, device="cpu", kernels=False)
    assert all(not p.requires_grad for p in serve.parameters())
    with torch.no_grad():
        for (_, p), (_, q) in zip(master.named_parameters(), serve.named_parameters()):
            p.copy_(p.to(torch.bfloat16).float())
            q.copy_(p.to(q.dtype))
    b = make_lm_batch(0, 0, 2, 16, cfg.vocab_size)
    got, _ = M.forward(master, cfg, b)
    want, _ = M.forward(serve, cfg, b)
    assert torch.equal(got, want)
    # a tied embedding's two gradients (gather and unembed) meet in f32
    loss, _ = S.loss_fn(master, cfg, b, S.StepOptions(ce_chunk=8))
    (g,) = torch.autograd.grad(loss, [master.embed])
    assert g.dtype == torch.float32 and cfg.tie_embeddings


def test_the_step_refuses_a_serving_model_and_the_kernel_route():
    cfg = get_config("qwen3-0.6b").reduced()
    step = S.make_train_step(cfg, None, S.StepOptions(ce_chunk=8))
    b = make_lm_batch(0, 0, 2, 16, cfg.vocab_size)
    serve = M.init_params(torch.Generator().manual_seed(0), cfg, kernels=False)
    with pytest.raises(ValueError, match="master=True"):
        step(serve, S.adamw_init(serve), b)
    kern = M.init_params(torch.Generator().manual_seed(0), cfg, kernels=True, master=True)
    with pytest.raises(RuntimeError, match="no backward.*kernels=False"):
        step(kern, S.adamw_init(kern), b)
    # the kernel route still serves a master model under inference mode
    logits, _ = M.forward(kern, cfg, b)
    assert torch.isfinite(logits).all()


def test_the_kernel_wrappers_refuse_autograd():
    """flash_attention_cuda and wkv_cuda have no backward: with grad mode on
    and an input that requires grad they raise, naming the plain route; under
    no_grad, or with inputs that need no grad, they run."""
    from repro_torch.kernels.flash_attn.kernel import flash_attention_cuda
    from repro_torch.kernels.wkv.kernel import wkv_cuda

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(4, 16, 16, generator=g) for _ in range(3))
    r, kk, vv = (torch.randn(4, 16, 16, generator=g) for _ in range(3))
    lw, u = -torch.rand(4, 16, 16, generator=g), torch.randn(4, 16, generator=g)
    for i in range(3):
        args = [q, k, v]
        args[i] = args[i].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="flash_attention_cuda has no backward.*_sdpa"):
            flash_attention_cuda(*args, sm_scale=0.25)
        with torch.no_grad():
            flash_attention_cuda(*args, sm_scale=0.25)
    for i in range(5):
        args = [r, kk, vv, lw, u]
        args[i] = args[i].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="wkv_cuda has no backward.*_chunked_wkv"):
            wkv_cuda(*args, chunk=8)
        with torch.no_grad():
            wkv_cuda(*args, chunk=8)
    assert torch.equal(flash_attention_cuda(q, k, v, sm_scale=0.25),
                       flash_attention_cuda(q, k, v, sm_scale=0.25))


def test_a_model_with_no_device_asks_for_cuda():
    """``LM(cfg)`` with neither a generator nor a device builds on CUDA, as
    every entry point of the port does (``device.py::resolve_device``)."""
    cfg = get_config("qwen3-0.6b").reduced()
    if torch.cuda.is_available():
        assert M.LM(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            M.LM(cfg)
    assert M.LM(cfg, device="cpu").device == torch.device("cpu")


def test_init_train_state_builds_on_cuda_unless_named():
    cfg = get_config("qwen3-0.6b").reduced()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            S.init_train_state(cfg)
    params, opt = S.init_train_state(cfg, device="cpu")
    assert params.device == torch.device("cpu") and opt["step"].device == params.device
    assert not any(getattr(m, "kernels", False) for m in params.modules())
    again, _ = S.init_train_state(cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(params.parameters(), again.parameters()))


@pytest.mark.parametrize("arch", all_arch_names())
def test_arch_smoke_forward_and_train(arch):
    """tests/test_models.py's case on the port: one forward and one train
    step at the reduced config, the loss finite and positive, the
    parameters moved."""
    cfg = get_config(arch).reduced()
    params, opt = S.init_train_state(cfg, device="cpu")
    b = jax_make_lm_batch(0, 0, 2, 16, cfg.vocab_size)
    rng = np.random.default_rng(0)
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["patches"] = rng.standard_normal((2, cfg.num_patches, cfg.d_model)).astype(np.float32)
    logits, _ = M.forward(params, cfg, b)
    assert tuple(logits.shape) == (2, 16, cfg.vocab_size) and torch.isfinite(logits).all()
    before = [p.detach().clone() for p in params.parameters()]
    step = S.make_train_step(cfg, None, S.StepOptions(ce_chunk=8))
    params, opt, metrics = step(params, opt, b)
    assert np.isfinite(float(metrics["loss"])) and float(metrics["loss"]) > 0
    moved = sum(float((p.detach() - q).abs().sum()) for p, q in zip(params.parameters(), before))
    assert moved > 0
