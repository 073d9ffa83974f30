"""Helpers shared by the LM parity tests of the port (tests/test_torch_moe.py,
test_torch_hybrid.py, test_torch_encdec.py, test_torch_lm_serve.py): the
reduced configs of the families, seeded inputs, JAX subtrees carried into
port modules, and the whole-model check against the JAX model."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models.convert import _jax_path, params_from_jax

FN_TOL = 2e-5
LOGIT_TOL = 1e-4
# the reduced configs, deepened where reduced() leaves a family's structure
# out: vlm's 2 layers hold no unit of cross_attn_every (5), so 10 layers (2
# units of 4 self layers and a cross layer); the hybrid's 3 are one unit, so
# 8 (2 units of (rglru, rglru, attn) and a tail of (rglru, rglru), as
# recurrentgemma-2b's 26 are 8 units and that tail)
DEPTH = {"vlm": 10, "hybrid": 8}


def reduced(arch, jax_cfg=False, **changes):
    """The reduced config of ``arch`` (the port's, or the JAX package's)."""
    cfg = (jax_get_config if jax_cfg else get_config)(arch).reduced()
    if cfg.family in DEPTH:
        changes = dict(dict(num_layers=DEPTH[cfg.family]), **changes)
    return dataclasses.replace(cfg, **changes)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def perturbed(tree, seed, scale=0.05):
    """``tree`` with N(0, scale) added to every leaf, so that biases, norm
    scales, the cross gate and the RG-LRU's constants are not their
    constant inits."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(np.shape(a))).astype(np.float32),
        tree)


def load(module, tree):
    """Copy a JAX subtree into a port module, leaf by leaf by name (a stacked
    layer's leaf is its slice of the JAX stack: ``models/convert.py``'s
    mapping)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            path, index = _jax_path(name)
            leaf = tree
            for part in path.split("/"):
                leaf = leaf[int(part)] if isinstance(leaf, (list, tuple)) else leaf[part]
            leaf = np.asarray(leaf)[index]
            assert tuple(np.shape(leaf)) == tuple(p.shape), name
            p.copy_(torch.from_numpy(np.array(leaf, np.float32)))
    return module


def normal(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal(s)).astype(np.float32) for s in shapes]


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def batch(cfg, b, s, seed):
    """tests/test_models.py's batch: tokens, plus N(0, 1) frames (audio) or
    patches (vlm)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal((b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return out


def _jax_batch(b):
    return {key: jnp.asarray(value) for key, value in b.items()}


def _prompt(b, n):
    return dict(b, tokens=b["tokens"][:, :n])


@functools.lru_cache(maxsize=None)
def reference_run(arch, **changes):
    """The JAX model on perturbed JAX ``init_params`` weights: forward,
    hidden states, a prefill of 5 tokens and 5 decode steps on a seeded
    batch, once an arch (both routes of the port are held to it)."""
    jcfg = reduced(arch, jax_cfg=True, **changes)
    tree = perturbed(np_tree(JM.init_params(jax.random.key(1), jcfg)), 101, scale=0.02)
    b = batch(jcfg, 2, 10, 90)
    jb = _jax_batch(b)
    out = {"forward": JM.forward(tree, jcfg, jb), "hidden": JM.hidden_states(tree, jcfg, jb)[0]}
    cache = JM.make_serve_cache(jcfg, 2, 32)
    logits, cache = JM.prefill(tree, jcfg, _prompt(jb, 5), cache)
    steps = [logits]
    for t in range(5, 10):
        logits, cache = JM.decode_step(tree, jcfg, jb["tokens"][:, t:t + 1], cache, jnp.int32(t))
        steps.append(logits)
    return tree, b, out, steps, np_tree(cache)


def assert_cache_close(got, want, tol, path="cache"):
    """The port's cache against the reference's, leaf by leaf (int leaves
    equal)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for key in want:
            assert_cache_close(got[key], want[key], tol, f"{path}/{key}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_cache_close(g, w, tol, f"{path}/{i}")
    else:
        assert tuple(got.shape) == np.shape(want), path
        if np.issubdtype(np.asarray(want).dtype, np.integer):
            np.testing.assert_array_equal(got.numpy(), want, err_msg=path)
        else:
            close(got, want, tol)


def check_model_against_reference(arch, kernels, **changes):
    """forward, hidden states, prefill and every decode step of the port's
    model on the JAX weights within LOGIT_TOL of the JAX model's, and the
    caches after them.  Returns the port's forward aux."""
    tree, b, ref, steps, jcache = reference_run(arch, **changes)
    cfg = reduced(arch, **changes)
    model = params_from_jax(tree, cfg, device="cpu", kernels=kernels)
    got, aux = M.forward(model, cfg, b)
    want, jaux = ref["forward"]
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 10, cfg.vocab_size)
    close(got, want, LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-6)
    hs, _ = M.hidden_states(model, cfg, b)
    close(hs, ref["hidden"], LOGIT_TOL)

    tcache = M.make_serve_cache(cfg, 2, 32, device="cpu")
    got, tcache = M.prefill(model, cfg, _prompt(b, 5), tcache)
    close(got, steps[0], LOGIT_TOL)
    for t in range(5, 10):
        got, tcache = M.decode_step(model, cfg, b["tokens"][:, t:t + 1], tcache, t)
        close(got, steps[t - 4], LOGIT_TOL)
    assert_cache_close(tcache, jcache, LOGIT_TOL)
    return float(aux)


def check_decode_matches_teacher_forcing(cfg, kernels, s=12, n_prompt=4, atol=2e-2, rtol=1e-2,
                                         gate=None):
    """tests/test_models.py's case on the port: prefill of ``n_prompt``
    tokens (0: none, decode from the empty cache) + step-by-step decode
    logits == the teacher-forced forward, at its tolerance.  ``gate``: the
    value of every cross-attention gate (their init is 0)."""
    model = M.init_params(torch.Generator().manual_seed(1), cfg, kernels=kernels)
    if gate is not None:
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith(".gate"):
                    p.fill_(gate)
    b = batch(cfg, 2, s, seed=2)
    full, _ = M.forward(model, cfg, b)
    cache = M.make_serve_cache(cfg, 2, 32, device="cpu")
    if n_prompt:
        logits, cache = M.prefill(model, cfg, _prompt(b, n_prompt), cache)
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, n_prompt - 1].numpy(),
                                   atol=atol, rtol=rtol)
    for t in range(n_prompt, s):
        logits, cache = M.decode_step(model, cfg, b["tokens"][:, t:t + 1], cache, t)
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, t].numpy(), atol=atol, rtol=rtol)
