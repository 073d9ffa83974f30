"""The port's LM substrate (src/repro_torch/models, configs) against the JAX
package's on the CPU, in f32 at the reduced configs: the same seeded numpy
inputs and the JAX ``init_params`` weights (carried over by
``models/convert.py::params_from_jax``) go through both packages.

Every model-level case runs twice: with the kernel routes
(``kernels=True``: on the CPU the flash attention and WKV ops run their
plain versions) and with the JAX package's own plain math
(``kernels=False``).  Tolerances: the layers at ``rtol=atol=1e-6``
(elementwise f32 work and one small product); the attention and rwkv
functions at 2e-5 (summation order of the products and softmax); the
models' logits at ``LOGIT_TOL`` (1e-4: several layers of those orders,
logits of magnitude ~1).  The moe, hybrid, vlm and audio models are held
to the JAX ones in tests/test_torch_moe.py, test_torch_hybrid.py and
test_torch_encdec.py; here every family's weights (names, dtypes,
distributions) and caches are."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.configs.base import all_arch_names as jax_arch_names  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import rwkv6 as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import REGISTRY, all_arch_names, get_config  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import rwkv6 as R  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.convert import _jax_path, params_from_jax  # noqa: E402
from util_lm import assert_cache_close, batch, reduced  # noqa: E402

CPU = torch.device("cpu")
LAYER_TOL = 1e-6
FN_TOL = 2e-5
LOGIT_TOL = 1e-4
MODEL_ARCHS = ["qwen3-0.6b", "qwen1.5-0.5b", "deepseek-7b", "qwen3-14b", "rwkv6-3b"]
# one arch of each family beside dense and ssm
FAMILY_ARCHS = ["olmoe-1b-7b", "recurrentgemma-2b", "llama-3.2-vision-11b", "whisper-medium"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _perturbed(tree, seed, scale=0.05):
    """``tree`` with N(0, scale) added to every leaf, so that biases, norm
    scales, token-shift factors, rwkv's bonus and the cross gate are not
    their constant inits."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(np.shape(a))).astype(np.float32),
        tree)


def _load(module, tree):
    """Copy a JAX subtree into a port module, leaf by leaf by name."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = tree
            for part in name.split("."):
                leaf = leaf[part]
            assert tuple(np.shape(leaf)) == tuple(p.shape), name
            p.copy_(torch.from_numpy(np.array(leaf, np.float32)))
    return module


def _normal(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal(s)).astype(np.float32) for s in shapes]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _jax_params(cfg, seed=1):
    return _np_tree(JM.init_params(jax.random.key(seed), cfg))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_registry_is_the_references():
    assert all_arch_names() == jax_arch_names()
    for name in all_arch_names():
        got, want = dataclasses.asdict(get_config(name)), dataclasses.asdict(jax_get_config(name))
        assert got == want, name
        assert dataclasses.asdict(get_config(name).reduced()) == \
            dataclasses.asdict(jax_get_config(name).reduced()), name
        assert get_config(name).param_count() == jax_get_config(name).param_count()
    assert sorted(REGISTRY) == sorted(JAX_REGISTRY)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm_layernorm():
    x, scale, bias = _normal(0, (2, 5, 64), (64,), (64,))
    p = L.RMSNorm(64)
    _load(p, {"scale": scale})
    _close(L.rmsnorm(p, torch.from_numpy(x), 1e-6),
           JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6), LAYER_TOL)
    q = _load(L.LayerNorm(64), {"scale": scale, "bias": bias})
    _close(L.layernorm(q, torch.from_numpy(x)),
           JL.layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                        jnp.asarray(x)), LAYER_TOL)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta):
    (x,) = _normal(1, (2, 7, 4, 16))
    pos = np.arange(3, 10, dtype=np.int32)[None, :]
    _close(L.rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           JL.rope(jnp.asarray(x), jnp.asarray(pos), theta), LAYER_TOL)


def test_sinusoidal_pos():
    _close(L.sinusoidal_pos(16, 64), JL.sinusoidal_pos(16, 64), LAYER_TOL)


def test_swiglu_and_gelu_mlp():
    (x,) = _normal(2, (2, 5, 64))
    tree = _perturbed(_np_tree(JL.swiglu_init(jax.random.key(0), 64, 128)), 3)
    p = _load(L.SwiGLU(None, 64, 128), tree)
    _close(L.swiglu(p, torch.from_numpy(x)), JL.swiglu(tree, jnp.asarray(x)), LAYER_TOL)
    tree = _perturbed(_np_tree(JL.gelu_mlp_init(jax.random.key(1), 64, 128)), 4)
    p = _load(L.GeluMLP(None, 64, 128), tree)
    _close(L.gelu_mlp(p, torch.from_numpy(x)), JL.gelu_mlp(tree, jnp.asarray(x)), LAYER_TOL)


def test_inits_draw_the_reference_distributions():
    g = torch.Generator().manual_seed(0)
    w = L.dense_init(g, (256, 512))
    e = L.embed_init(g, (512, 256))
    assert w.dtype == torch.float32 and not w.requires_grad
    assert abs(float(w.std()) - 1 / 16) < 2e-3 and abs(float(w.mean())) < 2e-3
    assert abs(float(e.std()) - 0.02) < 1e-3
    assert L.dense_init(g, (4, 4), dtype=torch.bfloat16).dtype == torch.bfloat16
    # every family's model: each JAX leaf against the port's slices of it,
    # constant and deterministic leaves (norms, biases, gates, the RG-LRU's
    # Λ) equal to f32 rounding, drawn ones with the reference's mean and std (the experts'
    # at 1/√E: dense_init's fan-in is the leading axis)
    for arch in FAMILY_ARCHS + ["rwkv6-3b"]:
        cfg = reduced(arch, d_model=128, d_ff=256)
        trees = [_np_tree(JM.init_params(jax.random.key(seed), cfg)) for seed in (0, 1)]
        model = M.init_params(torch.Generator().manual_seed(0), cfg)
        got = {}
        for name, p in model.named_parameters():
            path, index = _jax_path(name)
            got.setdefault(path, []).append(p.numpy().ravel())
        for path, leaf in _flat(trees[0]).items():
            mine = np.concatenate(got[path])
            assert mine.size == leaf.size, (arch, path)
            if np.array_equal(leaf, _flat(trees[1])[path]):        # not drawn
                # to f32 rounding: torch.linspace and jnp.linspace round Λ's
                # steps apart by an ulp
                np.testing.assert_allclose(np.sort(mine), np.sort(leaf.ravel()), rtol=2e-7,
                                           atol=0, err_msg=f"{arch} {path}")
            else:
                sd = float(leaf.std())
                tol = 4 * sd / np.sqrt(leaf.size) + 1e-7
                assert abs(float(mine.mean()) - float(leaf.mean())) < tol, (arch, path)
                assert abs(float(mine.std()) / sd - 1) < 0.15, (arch, path, mine.std(), sd)


def test_embed_and_unembed():
    cfg = get_config("qwen3-0.6b").reduced()
    tree = _perturbed(_jax_params(cfg), 5)
    model = params_from_jax(tree, cfg, device="cpu")
    tok = _tokens(cfg, 2, 6, 6)
    x = M._embed(model, cfg, torch.from_numpy(tok))
    _close(x, JM._embed(tree, cfg, jnp.asarray(tok)), LAYER_TOL)
    (h,) = _normal(7, (2, 6, cfg.d_model))
    _close(M._unembed(model, cfg, torch.from_numpy(h)),
           JM._unembed(tree, cfg, jnp.asarray(h)), LAYER_TOL)
    ucfg = get_config("deepseek-7b").reduced()   # an untied lm_head
    utree = _perturbed(_jax_params(ucfg), 8)
    umodel = params_from_jax(utree, ucfg, device="cpu")
    _close(M._unembed(umodel, ucfg, torch.from_numpy(h)),
           JM._unembed(utree, ucfg, jnp.asarray(h)), LAYER_TOL)
    assert torch.equal(M.unembed_weight(umodel, ucfg), umodel.lm_head)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _attn_pair(cfg, seed, kernels, cross=False):
    tree = _perturbed(_np_tree(JA.attn_init(jax.random.key(seed), cfg, cross=cross)), seed)
    return tree, _load(A.Attention(None, cfg, cross=cross, device=CPU, kernels=kernels), tree)


def _cache_pair(cfg, b, t, seed, slot_pos=None):
    k, v = _normal(seed, *[(b, t, cfg.num_kv_heads, cfg.resolved_head_dim)] * 2, scale=0.5)
    jc = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    tc = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    if slot_pos is not None:
        jc["slot_pos"] = jnp.asarray(slot_pos)
        tc["slot_pos"] = torch.from_numpy(slot_pos.copy())
    return jc, tc


def _cfgs():
    qwen = get_config("qwen3-0.6b").reduced()                  # qk-norm, GQA 4/2
    bias = get_config("qwen1.5-0.5b").reduced()                # qkv bias, MHA
    window = dataclasses.replace(qwen, sliding_window=5)
    return {"qk_norm": qwen, "qkv_bias": bias, "window": window}


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("name", ["qk_norm", "qkv_bias", "window"])
def test_self_attention_without_cache(name, kernels):
    cfg = _cfgs()[name]
    tree, p = _attn_pair(cfg, 10, kernels)
    (x,) = _normal(11, (2, 9, cfg.d_model))
    pos = np.arange(9, dtype=np.int32)[None, :]
    for mode in ("causal", "full"):
        got, gc = A.self_attention(p, cfg, torch.from_numpy(x), torch.from_numpy(pos), mode=mode)
        want, wc = JA.self_attention(tree, cfg, jnp.asarray(x), jnp.asarray(pos), mode=mode)
        assert gc is None and wc is None
        _close(got, want, FN_TOL)


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("name", ["qk_norm", "qkv_bias", "window"])
def test_self_attention_prefill_then_decode(name, kernels):
    """The prefill branch (causal over the prompt, cache zeroed then
    written) and the decode branch (one key appended at the position, the
    keys up to it attended) against the reference, cache included."""
    cfg = _cfgs()[name]
    tree, p = _attn_pair(cfg, 12, kernels)
    b, s_max, s = 2, 16, 7
    jc, tc = _cache_pair(cfg, b, s_max, 13)
    (x,) = _normal(14, (b, s, cfg.d_model))
    pos = np.arange(s, dtype=np.int32)[None, :]
    got, tc = A.self_attention(p, cfg, torch.from_numpy(x), torch.from_numpy(pos), cache=tc)
    want, jc = JA.self_attention(tree, cfg, jnp.asarray(x), jnp.asarray(pos), cache=jc)
    _close(got, want, FN_TOL)
    for key in ("k", "v"):
        _close(tc[key], jc[key], FN_TOL)
    for t in range(s, s + 4):
        (x1,) = _normal(15 + t, (b, 1, cfg.d_model))
        pos1 = np.full((1, 1), t, np.int32)
        got, tc = A.self_attention(p, cfg, torch.from_numpy(x1), torch.from_numpy(pos1),
                                   cache=tc, cache_pos=t)
        want, jc = JA.self_attention(tree, cfg, jnp.asarray(x1), jnp.asarray(pos1), cache=jc,
                                     cache_pos=jnp.int32(t))
        _close(got, want, FN_TOL)
        for key in ("k", "v"):
            _close(tc[key], jc[key], FN_TOL)


@pytest.mark.parametrize("kernels", [True, False])
def test_self_attention_rolling_window_cache(kernels):
    """The local-attention branch with a ``slot_pos`` cache of 6 slots:
    a prompt of 9 (the last 6 keys kept, wrapped) and decode steps that
    wrap around, window 4."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(), local_window=4)
    tree, p = _attn_pair(cfg, 20, kernels)
    b, w, s = 2, 6, 9
    jc, tc = _cache_pair(cfg, b, w, 21, slot_pos=np.full((w,), -1, np.int32))
    (x,) = _normal(22, (b, s, cfg.d_model))
    pos = np.arange(s, dtype=np.int32)[None, :]
    got, tc = A.self_attention(p, cfg, torch.from_numpy(x), torch.from_numpy(pos), mode="local",
                               cache=tc)
    want, jc = JA.self_attention(tree, cfg, jnp.asarray(x), jnp.asarray(pos), mode="local",
                                 cache=jc)
    _close(got, want, FN_TOL)
    for t in range(s, s + 8):
        (x1,) = _normal(23 + t, (b, 1, cfg.d_model))
        pos1 = np.full((1, 1), t, np.int32)
        got, tc = A.self_attention(p, cfg, torch.from_numpy(x1), torch.from_numpy(pos1),
                                   mode="local", cache=tc, cache_pos=t)
        want, jc = JA.self_attention(tree, cfg, jnp.asarray(x1), jnp.asarray(pos1), mode="local",
                                     cache=jc, cache_pos=jnp.int32(t))
        _close(got, want, FN_TOL)
        np.testing.assert_array_equal(tc["slot_pos"].numpy(), np.asarray(jc["slot_pos"]))
        for key in ("k", "v"):
            _close(tc[key], jc[key], FN_TOL)


@pytest.mark.parametrize("kernels", [True, False])
def test_sdpa_chunked(kernels):
    (q,) = _normal(30, (1, 16, 4, 16))
    k, v = _normal(31, (1, 16, 2, 16), (1, 16, 2, 16))
    for causal, window in ((True, 0), (True, 5), (False, 0)):
        got = A._sdpa_chunked(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              window=window, causal=causal, chunk=4)
        want = JA._sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
                                causal=causal, chunk=4)
        _close(got, want, FN_TOL)
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(), chunked_attn_min_seq=8)
    tree, p = _attn_pair(cfg, 32, kernels)
    (x,) = _normal(33, (1, 16, cfg.d_model))
    pos = np.arange(16, dtype=np.int32)[None, :]
    got, _ = A.self_attention(p, cfg, torch.from_numpy(x), torch.from_numpy(pos))
    want, _ = JA.self_attention(tree, cfg, jnp.asarray(x), jnp.asarray(pos))
    _close(got, want, FN_TOL)


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("name", ["qk_norm", "qkv_bias"])
def test_cross_attention_and_cross_kv(name, kernels):
    cfg = _cfgs()[name]
    tree, p = _attn_pair(cfg, 40, kernels, cross=True)
    x, kv_x = _normal(41, (2, 5, cfg.d_model), (2, 11, cfg.d_model))
    for gated in (False, True):
        got = A.cross_attention(p, cfg, torch.from_numpy(x), torch.from_numpy(kv_x), gated=gated)
        want = JA.cross_attention(tree, cfg, jnp.asarray(x), jnp.asarray(kv_x), gated=gated)
        _close(got, want, FN_TOL)
    gkv = A.cross_kv(p, cfg, torch.from_numpy(kv_x))
    wkv = JA.cross_kv(tree, cfg, jnp.asarray(kv_x))
    for key in ("k", "v"):
        _close(gkv[key], wkv[key], FN_TOL)
    got = A.cross_attention(p, cfg, torch.from_numpy(x), gkv, gated=True)
    want = JA.cross_attention(tree, cfg, jnp.asarray(x), wkv, gated=True)
    _close(got, want, FN_TOL)


def test_a_kernel_refusal_raises_through_self_attention(monkeypatch):
    """No fallback: whatever flash_attention_cuda raises reaches the caller
    of self_attention (on the card a refusal, here a stand-in)."""
    from repro_torch.kernels.flash_attn import ops

    def refuse(*args, **kwargs):
        raise ValueError("refused")

    monkeypatch.setattr(ops, "flash_attention_cuda", refuse)
    cfg = get_config("qwen3-0.6b").reduced()
    _, p = _attn_pair(cfg, 50, kernels=True)
    (x,) = _normal(51, (1, 4, cfg.d_model))
    pos = torch.arange(4)[None, :]
    with pytest.raises(ValueError, match="refused"):
        A.self_attention(p, cfg, torch.from_numpy(x), pos)
    p.kernels = False
    A.self_attention(p, cfg, torch.from_numpy(x), pos)   # the plain route never calls it


# ---------------------------------------------------------------------------
# rwkv6
# ---------------------------------------------------------------------------

def _rwkv_pair(cfg, seed, kernels):
    tree = _perturbed(_np_tree(JR.rwkv_layer_init(jax.random.key(seed), cfg)), seed)
    return tree, _load(R.RWKVLayer(None, cfg, device=CPU, kernels=kernels), tree)


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("t", [8, 13, 30])   # 13 and 30: not a multiple of the chunk (8)
def test_time_mix_chunked(t, kernels):
    cfg = get_config("rwkv6-3b").reduced()
    tree, p = _rwkv_pair(cfg, 60, kernels)
    (x,) = _normal(61 + t, (2, t, cfg.d_model))
    got, gs = R.time_mix(p, cfg, torch.from_numpy(x))
    want, ws = JR.time_mix(tree, cfg, jnp.asarray(x))
    assert gs is None and ws is None
    _close(got, want, FN_TOL)


def _state_pair(cfg, b, seed):
    h, hs = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
    s, lt, lc = _normal(seed, (b, h, hs, hs), (b, cfg.d_model), (b, cfg.d_model), scale=0.3)
    j = {"s": jnp.asarray(s), "last_t": jnp.asarray(lt), "last_c": jnp.asarray(lc)}
    t = {"s": torch.from_numpy(s), "last_t": torch.from_numpy(lt),
         "last_c": torch.from_numpy(lc)}
    return j, t


@pytest.mark.parametrize("kernels", [True, False])
def test_time_mix_decode_channel_mix_and_layer(kernels):
    cfg = get_config("rwkv6-3b").reduced()
    tree, p = _rwkv_pair(cfg, 70, kernels)
    js, ts = _state_pair(cfg, 2, 71)
    for step in range(3):
        (x,) = _normal(72 + step, (2, 1, cfg.d_model))
        got, gst = R.time_mix(p, cfg, torch.from_numpy(x), ts)
        want, wst = JR.time_mix(tree, cfg, jnp.asarray(x), js)
        _close(got, want, FN_TOL)
        for key in ("s", "last_t"):
            _close(gst[key], wst[key], FN_TOL)
        got, gc = R.channel_mix(p, cfg, torch.from_numpy(x), ts)
        want, wc = JR.channel_mix(tree, cfg, jnp.asarray(x), js)
        _close(got, want, FN_TOL)
        _close(gc["last_c"], wc["last_c"], FN_TOL)
        got, ts = R.rwkv_layer(p, cfg, torch.from_numpy(x), ts)
        want, js = JR.rwkv_layer(tree, cfg, jnp.asarray(x), js)
        _close(got, want, FN_TOL)
        for key in ("s", "last_t", "last_c"):
            _close(ts[key], js[key], FN_TOL)
    (x,) = _normal(80, (2, 11, cfg.d_model))
    got, _ = R.rwkv_layer(p, cfg, torch.from_numpy(x))
    want, _ = JR.rwkv_layer(tree, cfg, jnp.asarray(x))
    _close(got, want, FN_TOL)
    got, _ = R.channel_mix(p, cfg, torch.from_numpy(x))
    want, _ = JR.channel_mix(tree, cfg, jnp.asarray(x))
    _close(got, want, FN_TOL)
    with pytest.raises(NotImplementedError):     # the reference cannot hand a state over
        R.time_mix(p, cfg, torch.from_numpy(x), ts)


def test_rwkv_init_state_and_cache():
    cfg = get_config("rwkv6-3b").reduced()
    got, want = R.rwkv_init_state(cfg, 3), JR.rwkv_init_state(cfg, 3)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype)
    for arch in ("rwkv6-3b", "qwen3-0.6b"):
        c = get_config(arch).reduced()
        got, want = T.make_cache(c, 2, 16, device=CPU), JT.make_cache(c, 2, 16)
        assert sorted(got) == sorted(want)
        for key in want:
            assert tuple(got[key].shape) == want[key].shape and not got[key].any()
    # every family's serving cache: structure, shapes, dtypes and contents
    for arch in all_arch_names():
        c = reduced(arch)
        got, want = M.make_serve_cache(c, 2, 16, device="cpu"), JM.make_serve_cache(c, 2, 16)
        assert_cache_close(got, _np_tree(want), 0.0, path=arch)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert str(g.dtype).split(".")[-1] == str(w.dtype), arch


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_run(arch):
    """The JAX model's forward, hidden states, prefill of 5 tokens and 5
    decode steps on seeded tokens, once an arch (both routes of the port
    are held to it)."""
    cfg = get_config(arch).reduced()
    tree = _perturbed(_jax_params(cfg), 101, scale=0.02)
    tok = _tokens(cfg, 2, 10, 90)
    out = {"forward": JM.forward(tree, cfg, {"tokens": jnp.asarray(tok)}),
           "hidden": JM.hidden_states(tree, cfg, {"tokens": jnp.asarray(tok)})[0]}
    cache = JM.make_serve_cache(cfg, 2, 32)
    logits, cache = JM.prefill(tree, cfg, {"tokens": jnp.asarray(tok[:, :5])}, cache)
    steps = [logits]
    for t in range(5, 10):
        logits, cache = JM.decode_step(tree, cfg, jnp.asarray(tok[:, t:t + 1]), cache,
                                       jnp.int32(t))
        steps.append(logits)
    return cfg, tree, tok, out, steps, cache


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_forward_prefill_decode_match_the_reference(arch, kernels):
    cfg, tree, tok, ref, steps, jcache = _reference_run(arch)
    model = params_from_jax(tree, cfg, device="cpu", kernels=kernels)
    got, aux = M.forward(model, cfg, {"tokens": tok})
    want, jaux = ref["forward"]
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 10, cfg.vocab_size)
    _close(got, want, LOGIT_TOL)
    assert float(aux) == float(jaux) == 0.0
    hs, _ = M.hidden_states(model, cfg, {"tokens": tok})
    _close(hs, ref["hidden"], LOGIT_TOL)

    tcache = M.make_serve_cache(cfg, 2, 32, device="cpu")
    got, tcache = M.prefill(model, cfg, {"tokens": tok[:, :5]}, tcache)
    _close(got, steps[0], LOGIT_TOL)
    for t in range(5, 10):
        got, tcache = M.decode_step(model, cfg, tok[:, t:t + 1], tcache, t)
        _close(got, steps[t - 4], LOGIT_TOL)
    for key in jcache["kv"]:
        _close(tcache["kv"][key], jcache["kv"][key], LOGIT_TOL)


def _batch(cfg, b, s, seed):
    return {"tokens": _tokens(cfg, b, s, seed)}


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen1.5-0.5b", "deepseek-7b"])
def test_decode_matches_teacher_forcing(arch, kernels):
    """tests/test_models.py's case on the port: prefill + step-by-step
    decode logits == the teacher-forced forward, at its tolerance."""
    cfg = get_config(arch).reduced()
    model = M.init_params(torch.Generator().manual_seed(1), cfg, kernels=kernels)
    b, s = 2, 12
    tokens = _batch(cfg, b, s, seed=2)["tokens"]
    full_logits, _ = M.forward(model, cfg, {"tokens": tokens})
    cache = M.make_serve_cache(cfg, b, 32, device="cpu")
    logits, cache = M.prefill(model, cfg, {"tokens": tokens[:, :4]}, cache)
    np.testing.assert_allclose(logits[:, 0].numpy(), full_logits[:, 3].numpy(),
                               atol=2e-2, rtol=1e-2)
    for t in range(4, s):
        logits, cache = M.decode_step(model, cfg, tokens[:, t:t + 1], cache, t)
        np.testing.assert_allclose(logits[:, 0].numpy(), full_logits[:, t].numpy(),
                                   atol=2e-2, rtol=1e-2)


@pytest.mark.parametrize("kernels", [True, False])
def test_recurrent_decode_matches_teacher_forcing(kernels):
    """tests/test_models.py's ssm case on the port: stepwise decode from
    the zero state equals the chunked form."""
    cfg = get_config("rwkv6-3b").reduced()
    model = M.init_params(torch.Generator().manual_seed(1), cfg, kernels=kernels)
    b, s = 2, 12
    tokens = _batch(cfg, b, s, seed=3)["tokens"]
    full_logits, _ = M.forward(model, cfg, {"tokens": tokens})
    cache = M.make_serve_cache(cfg, b, 32, device="cpu")
    for t in range(s):
        logits, cache = M.decode_step(model, cfg, tokens[:, t:t + 1], cache, t)
        np.testing.assert_allclose(logits[:, 0].numpy(), full_logits[:, t].numpy(),
                                   atol=5e-2, rtol=2e-2)


F32_LEAVES = ("scale", "bias",                                   # norms (layernorm's bias)
              "decay_w0", "decay_a", "decay_b", "bonus_u",          # rwkv6's decay and bonus
              "lru_lambda", "lru_wa", "lru_ba", "lru_wi", "lru_bi",  # the RG-LRU recurrence
              "gate")                                               # the cross tanh gate


def test_models_keep_weights_in_the_dtype_of_their_use():
    for arch in ["qwen1.5-0.5b", "rwkv6-3b"] + FAMILY_ARCHS:
        cfg = reduced(arch, dtype="bfloat16")
        model = M.init_params(torch.Generator().manual_seed(0), cfg)
        f32 = {name for name, p in model.named_parameters() if p.dtype == torch.float32}
        assert all(not p.requires_grad for p in model.parameters())
        for name, p in model.named_parameters():
            used_in_f32 = name.split(".")[-1] in F32_LEAVES
            assert (name in f32) == used_in_f32, name
            assert p.dtype in (torch.float32, torch.bfloat16), name
        logits, _ = M.forward(model, cfg, batch(cfg, 1, 9, 4))
        assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())


def test_bf16_conversion_is_the_references_cast_at_use():
    """A bf16 model from the JAX tree: each weight rounded once, as the JAX
    model's ``.astype(x.dtype)`` rounds it at each use."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(), dtype="bfloat16")
    tree = _jax_params(cfg)
    model = params_from_jax(tree, cfg, device="cpu")
    want = np.asarray(jnp.asarray(tree["stack"]["attn"]["w_q"][1]).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    np.testing.assert_array_equal(model.stack[1].attn.w_q.float().numpy(), want)
    assert model.stack[1].attn.q_norm.scale.dtype == torch.float32


def test_params_from_jax_refuses_a_bad_tree():
    cfg = get_config("qwen3-0.6b").reduced()
    tree = _jax_params(cfg)
    params_from_jax(tree, cfg, device="cpu")

    missing = jax.tree.map(lambda a: a, tree)
    del missing["stack"]["attn"]["w_k"]
    with pytest.raises(KeyError, match="stack/attn/w_k"):
        params_from_jax(missing, cfg, device="cpu")

    extra = jax.tree.map(lambda a: a, tree)
    extra["lm_head"] = np.zeros((cfg.d_model, cfg.vocab_size), np.float32)   # tied: no head
    with pytest.raises(KeyError, match="lm_head"):
        params_from_jax(extra, cfg, device="cpu")

    bad = jax.tree.map(lambda a: a, tree)
    bad["stack"]["mlp"]["w_up"] = bad["stack"]["mlp"]["w_up"][:, :, :-1]
    with pytest.raises(ValueError, match="stack/mlp/w_up"):
        params_from_jax(bad, cfg, device="cpu")

    shallow = jax.tree.map(lambda a: a, tree)
    shallow["embed"] = shallow["embed"][None]
    with pytest.raises(ValueError, match="embed"):
        params_from_jax(shallow, cfg, device="cpu")

    # trees that are not one flat (L, ...) stack: each fault names its JAX path
    hybrid = reduced("recurrentgemma-2b")
    tree = _jax_params(hybrid)
    params_from_jax(tree, hybrid, device="cpu")
    missing = jax.tree.map(lambda a: a, tree)
    del missing["stack"]["units"]["mix"][0]["w_x"]
    with pytest.raises(KeyError, match="stack/units/mix/0/w_x"):
        params_from_jax(missing, hybrid, device="cpu")
    extra = jax.tree.map(lambda a: a, tree)
    extra["stack"]["tail"].append(extra["stack"]["tail"][0])
    with pytest.raises(KeyError, match="stack/tail/2/mix/w_x"):
        params_from_jax(extra, hybrid, device="cpu")
    shallow = jax.tree.map(lambda a: a, tree)
    shallow["stack"]["units"]["mix"][2]["w_q"] = shallow["stack"]["units"]["mix"][2]["w_q"][:1]
    with pytest.raises(ValueError, match="stack/units/mix/2/w_q"):
        params_from_jax(shallow, hybrid, device="cpu")
    bad = jax.tree.map(lambda a: a, tree)
    tail_mix = bad["stack"]["tail"][1]["mix"]
    tail_mix["lru_lambda"] = tail_mix["lru_lambda"][None]
    with pytest.raises(ValueError, match="stack/tail/1/mix/lru_lambda"):
        params_from_jax(bad, hybrid, device="cpu")

    vlm = reduced("llama-3.2-vision-11b")
    tree = _jax_params(vlm)
    bad = jax.tree.map(lambda a: a, tree)
    bad["stack"]["self"]["attn"]["w_q"] = bad["stack"]["self"]["attn"]["w_q"][:, :3]
    with pytest.raises(ValueError, match="stack/self/attn/w_q"):
        params_from_jax(bad, vlm, device="cpu")
    bad = jax.tree.map(lambda a: a, tree)
    bad["stack"]["cross"]["attn"]["gate"] = np.float32(0.0)       # unstacked
    with pytest.raises(ValueError, match="stack/cross/attn/gate"):
        params_from_jax(bad, vlm, device="cpu")

    audio = reduced("whisper-medium")
    tree = _jax_params(audio)
    missing = jax.tree.map(lambda a: a, tree)
    del missing["stack"]["enc_ln"]["bias"]
    with pytest.raises(KeyError, match="stack/enc_ln/bias"):
        params_from_jax(missing, audio, device="cpu")
    extra = jax.tree.map(lambda a: a, tree)
    extra["stack"]["decoder"]["self"]["gate"] = np.zeros((audio.num_layers,), np.float32)
    with pytest.raises(KeyError, match="stack/decoder/self/gate"):
        params_from_jax(extra, audio, device="cpu")


def _key(k):
    """A jax.tree_util path entry: a dict key, or a list index (the hybrid's
    lists)."""
    return str(k.key) if hasattr(k, "key") else str(k.idx)


def _flat(tree):
    return {"/".join(_key(k) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_model_state_dict_names_are_the_jax_paths():
    cfg = get_config("rwkv6-3b").reduced()
    tree = _jax_params(cfg)
    model = params_from_jax(tree, cfg, device="cpu")
    flat = {"/".join(str(k.key) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]}
    names = {n.replace(".", "/") for n in model.state_dict()}
    stacked = {n for n in names if n.startswith("stack/")}
    assert names - stacked == {f for f in flat if not f.startswith("stack/")}
    assert {"/".join(["stack"] + n.split("/")[2:]) for n in stacked} == \
        {f for f in flat if f.startswith("stack/")}
    assert len(model.stack) == cfg.num_layers
    # every family: each JAX leaf is the port's names with the stacked axes'
    # indices written in, one name per index of those axes, each name's
    # tensor that leaf's slice; list indices (the hybrid's) stay in the path
    for arch in FAMILY_ARCHS:
        cfg = reduced(arch)
        tree = _jax_params(cfg)
        flat = _flat(tree)
        model = params_from_jax(tree, cfg, device="cpu")
        seen = {}
        for name, p in model.state_dict().items():
            path, index = _jax_path(name)
            assert path in flat, (arch, name)
            leaf = flat[path]
            assert leaf.shape[len(index):] == tuple(p.shape), (arch, name)
            np.testing.assert_array_equal(p.numpy(), leaf[index], err_msg=name)
            seen.setdefault(path, set()).add(index)
        for path, leaf in flat.items():
            lead = leaf.shape[:leaf.ndim - model.state_dict()[
                next(n for n in model.state_dict() if _jax_path(n)[0] == path)].dim()]
            assert len(seen[path]) == int(np.prod(lead)), (arch, path)
    names = set(params_from_jax(_jax_params(reduced("recurrentgemma-2b")),
                                reduced("recurrentgemma-2b"), device="cpu").state_dict())
    assert {"stack.units.1.mix.0.w_x", "stack.units.1.mix.2.w_q", "stack.tail.1.mix.lru_wa",
            "stack.units.0.ln_mlp.2.scale"} <= names
    names = set(params_from_jax(_jax_params(reduced("llama-3.2-vision-11b")),
                                reduced("llama-3.2-vision-11b"), device="cpu").state_dict())
    assert {"stack.1.self.3.attn.w_q", "stack.1.cross.attn.gate"} <= names
