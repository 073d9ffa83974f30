"""The port's optimizer, schedule, int8 compression (src/repro_torch/optim/)
and token pipeline (src/repro_torch/data/pipeline.py) against the JAX
package's on the same numpy inputs: tests/test_optim.py's cases that need
no mesh (``psum_int8`` comes with the compressed trainer, ROADMAP item
11f-c), tests/test_pipeline.py's cases with the batches equal to the JAX
``make_lm_batch``'s byte for byte, and the reference's weight decay of a
stacked per-layer norm scale."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.data.pipeline import TokenPipeline as JaxPipeline  # noqa: E402
from repro.data.pipeline import make_lm_batch as jax_make_lm_batch  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim import compress as jax_compress  # noqa: E402
from repro.optim.schedule import warmup_cosine as jax_warmup_cosine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline, make_lm_batch  # noqa: E402
from repro_torch.models.convert import _flatten, _jax_path, params_from_jax  # noqa: E402
from repro_torch.optim.adamw import (  # noqa: E402
    AdamWConfig,
    adamw_init,
    adamw_update,
    decays,
    global_norm,
)
from repro_torch.optim.compress import (  # noqa: E402
    compressed_bytes,
    dequantize_int8,
    quantize_int8,
)
from repro_torch.optim.schedule import warmup_cosine  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _same_as_jax(params, grads, cfg, lr_scale=1.0, steps=1):
    """``steps`` updates of the port and of the JAX AdamW from the same
    numpy params and grads; the parameters, state and metrics agree."""
    tp = {k: _t(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ts, js = adamw_init(tp), jax_adamw.adamw_init(jp)
    jcfg = jax_adamw.AdamWConfig(**cfg.__dict__)
    for _ in range(steps):
        tp, ts, tm = adamw_update(tp, {k: _t(v) for k, v in grads.items()}, ts, cfg, lr_scale)
        jp, js, jm = jax_adamw.adamw_update(jp, {k: jnp.asarray(v) for k, v in grads.items()},
                                            js, jcfg, lr_scale)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ts["m"][k].numpy(), np.asarray(js["m"][k]), rtol=1e-6)
        np.testing.assert_allclose(ts["v"][k].numpy(), np.asarray(js["v"][k]), rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) and ts["step"].dtype == torch.int32
    for key in ("grad_norm", "lr"):
        assert tm[key].dtype == torch.float32
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-6)
    return tp, ts, tm


# ---------------------------------------------------------------------------
# tests/test_optim.py's cases
# ---------------------------------------------------------------------------

def test_adamw_minimizes_quadratic():
    target = _t(np.random.default_rng(0).standard_normal(16))
    params = {"w": torch.zeros(16, requires_grad=True)}
    state = adamw_init(params)
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)

    def loss(p):
        return torch.sum((p["w"] - target) ** 2)

    l0 = float(loss(params).detach())
    for _ in range(200):
        (g,) = torch.autograd.grad(loss(params), [params["w"]])
        params, state, _ = adamw_update(params, {"w": g}, state, cfg)
    assert float(loss(params).detach()) < 1e-2 * l0


def test_adamw_matches_jax_over_steps():
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal((8, 4)), "b": rng.standard_normal(4),
              "s": rng.standard_normal(())}
    grads = {k: rng.standard_normal(np.shape(v)) for k, v in params.items()}
    _same_as_jax(params, grads, AdamWConfig(lr=1e-2), lr_scale=np.float32(0.5), steps=5)


def test_grad_clipping():
    params = {"w": np.ones((4, 8)) * 5}
    huge = {"w": np.full((4, 8), 1e6)}
    cfg = AdamWConfig(lr=1e-3, grad_clip=1.0, weight_decay=0.0)
    new, _, metrics = _same_as_jax(params, huge, cfg)
    assert float(metrics["grad_norm"]) > 1e6
    assert float((new["w"] - 5).abs().max()) < 1e-2  # clipped step is bounded by ~lr


def test_weight_decay_only_matrices():
    params = {"w": np.ones((4, 4)), "b": np.ones((4,))}
    zeros = {k: np.zeros_like(v) for k, v in params.items()}
    new, _, _ = _same_as_jax(params, zeros, AdamWConfig(lr=1.0, weight_decay=0.1))
    assert float(new["w"][0, 0]) < 1.0       # decayed
    assert float(new["b"][0]) == 1.0          # spared


def test_schedule_shape():
    s = [float(warmup_cosine(i, warmup=10, total=100)) for i in range(100)]
    assert 0.0 < s[0] <= 0.2                # warm but never zero
    assert abs(s[9] - 1.0) < 1e-6           # peak at end of warmup
    assert s[99] < s[50] < s[9]             # decays
    assert s[99] >= 0.1 - 1e-6              # floor


def test_schedule_matches_jax_in_f32():
    """f32 as the reference computes it: equal but for the last bits of
    the two libraries' cos."""
    for warmup, total in ((10, 100), (200, 10_000), (0, 50), (5, 5)):
        for step in list(range(0, 60)) + [199, 200, 201, 5_000, 9_999, 20_000]:
            got = warmup_cosine(torch.tensor(step, dtype=torch.int32), warmup, total)
            want = jax_warmup_cosine(jnp.int32(step), warmup, total)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), rtol=3e-7,
                                       err_msg=str((warmup, total, step)))
            if step < warmup:   # the warmup's ramp has no transcendental
                assert float(got) == float(want)


def test_int8_quantization_roundtrip():
    x = np.random.default_rng(0).standard_normal((64, 64)).astype(np.float32)
    q, scale = quantize_int8(_t(x))
    err = (dequantize_int8(q, scale) - _t(x)).abs().max()
    assert float(err) <= float(scale) / 2 + 1e-7
    jq, jscale = jax_compress.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)
    grads = {"a": x, "b": x[:3]}
    assert compressed_bytes({k: _t(v) for k, v in grads.items()}) == \
        jax_compress.compressed_bytes(grads)


def test_global_norm():
    t = {"a": torch.ones(3), "b": torch.ones(4)}
    np.testing.assert_allclose(float(global_norm(t)), np.sqrt(7.0), rtol=1e-6)
    np.testing.assert_allclose(float(global_norm(t)),
                               float(jax_adamw.global_norm({k: jnp.ones(v.shape)
                                                            for k, v in t.items()})), rtol=1e-7)


# ---------------------------------------------------------------------------
# the reference's weight decay on its stacked leaves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-0.6b", "recurrentgemma-2b", "llama-3.2-vision-11b",
                                  "whisper-medium", "rwkv6-3b"])
def test_decay_follows_the_rank_of_the_jax_leaf(arch):
    """The reference decays a leaf iff its ndim >= 2, and its stacks hold
    every layer's leaf along leading axes: a layer's norm scale, (L, d)
    there, is decayed; ``final_norm`` and a hybrid tail's scales, 1-D, are
    not.  The port decides by the JAX leaf's rank (ROADMAP's reference
    faults the port reproduces), and a step with zero gradients moves
    exactly the leaves the JAX step moves."""
    # hybrid: a unit and a tail; vlm: two units
    layers = {"hybrid": 5, "vlm": 10}.get(get_config(arch).family)
    jcfg = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    if layers:
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
        cfg = dataclasses.replace(cfg, num_layers=layers)
    tree = jax.tree.map(lambda a: np.asarray(a) + 0.5, JM.init_params(jax.random.key(0), jcfg))
    model = params_from_jax(tree, cfg, device="cpu", kernels=False, master=True)
    leaves = dict(_flatten(tree))
    names = dict(model.named_parameters())
    for name, p in names.items():
        path, _ = _jax_path(name)
        assert decays(name, p) == (np.ndim(leaves[path]) >= 2), name
    stacked_scale = next(n for n in names if n.startswith("stack.") and n.endswith("scale"))
    assert names[stacked_scale].dim() == 1 and decays(stacked_scale, names[stacked_scale])
    assert not decays("final_norm.scale", names["final_norm.scale"])

    cfg_opt = AdamWConfig(lr=1.0, weight_decay=0.1)
    zeros = {n: torch.zeros_like(p) for n, p in names.items()}
    before = {n: p.detach().clone() for n, p in names.items()}
    adamw_update(names, zeros, adamw_init(names), cfg_opt)
    jtree = jax.tree.map(jnp.asarray, tree)
    jnew, _, _ = jax_adamw.adamw_update(jtree, jax.tree.map(jnp.zeros_like, jtree),
                                        jax_adamw.adamw_init(jtree),
                                        jax_adamw.AdamWConfig(lr=1.0, weight_decay=0.1))
    jnew = dict(_flatten(jax.tree.map(np.asarray, jnew)))
    for name, p in names.items():
        path, index = _jax_path(name)
        np.testing.assert_allclose(p.detach().numpy(), jnew[path][index], rtol=1e-6,
                                   err_msg=name)
        assert torch.equal(p.detach(), before[name]) == (not decays(name, p)), name
    if cfg.family == "hybrid":
        tail = [n for n in names if n.startswith("stack.tail.") and n.endswith("scale")]
        assert tail and not any(decays(n, names[n]) for n in tail)


# ---------------------------------------------------------------------------
# tests/test_pipeline.py's cases, against the JAX make_lm_batch
# ---------------------------------------------------------------------------

def _same_batch(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].tobytes() == want[key].tobytes()


def test_batches_deterministic():
    a = make_lm_batch(7, 3, 4, 16, 1000)
    b = make_lm_batch(7, 3, 4, 16, 1000)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = make_lm_batch(7, 4, 4, 16, 1000)
    assert not np.array_equal(a["tokens"], c["tokens"])
    _same_batch(a, jax_make_lm_batch(7, 3, 4, 16, 1000))
    _same_batch(c, jax_make_lm_batch(7, 4, 4, 16, 1000))


def test_labels_are_next_tokens():
    b = make_lm_batch(0, 0, 2, 8, 50)
    assert b["tokens"].shape == b["labels"].shape == (2, 8)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    _same_batch(b, jax_make_lm_batch(0, 0, 2, 8, 50))


def test_host_slice_consistency():
    full = make_lm_batch(1, 5, 8, 16, 1000)
    lo = make_lm_batch(1, 5, 8, 16, 1000, lo=2, hi=5)
    np.testing.assert_array_equal(full["tokens"][2:5], lo["tokens"])
    _same_batch(lo, jax_make_lm_batch(1, 5, 8, 16, 1000, lo=2, hi=5))


def test_pipeline_restart_alignment():
    p1 = TokenPipeline(3, 2, 8, 100, start_step=0)
    batches = [next(p1) for _ in range(5)]
    p1.close()
    p2 = TokenPipeline(3, 2, 8, 100, start_step=3)
    b3 = next(p2)
    p2.close()
    np.testing.assert_array_equal(batches[3]["tokens"], b3["tokens"])
    j = JaxPipeline(3, 2, 8, 100, start_step=0)
    for got in batches:
        _same_batch(got, next(j))
    j.close()
    assert p2.step == 4


def test_vocab_bound():
    b = make_lm_batch(0, 0, 4, 64, 37)
    assert b["tokens"].max() < 37
    assert b["tokens"].min() >= 0
    _same_batch(b, jax_make_lm_batch(0, 0, 4, 64, 37))
