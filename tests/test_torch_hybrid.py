"""The port's RG-LRU block (src/repro_torch/models/rglru.py), the hybrid
stack with its tail (models/transformer.py) and recurrentgemma-2b against
the JAX package's on the CPU, in f32 at the reduced config (8 layers: two
units of (rglru, rglru, attn) and a tail of (rglru, rglru); local window
8), on the JAX ``init_params`` weights (perturbed): ``_conv1d``,
``_rglru`` (the scan and one step, with and without h0), the doubling
scan against a sequential loop, ``rglru_block``, the stack with and
without caches, the whole model at ``LOGIT_TOL`` with ``kernels=True`` and
``False``, and decode against teacher forcing past the 8-slot window."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import model as JM  # noqa: E402
from repro.models import rglru as JG  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import rglru as G  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from util_lm import (  # noqa: E402
    FN_TOL,
    assert_cache_close,
    check_decode_matches_teacher_forcing,
    check_model_against_reference,
    close,
    load,
    normal,
    np_tree,
    perturbed,
    reduced,
)

ARCH = "recurrentgemma-2b"


def _block_pair(cfg, seed):
    tree = perturbed(np_tree(JG.rglru_block_init(jax.random.key(seed), cfg)), seed)
    return tree, load(G.RGLRUBlock(None, cfg, device="cpu"), tree)


def _state(cfg, b, seed):
    w = cfg.lru_width or cfg.d_model
    conv, h = normal(seed, (b, cfg.conv_width - 1, w), (b, w), scale=0.5)
    return ({"conv": jnp.asarray(conv), "h": jnp.asarray(h)},
            {"conv": torch.from_numpy(conv.copy()), "h": torch.from_numpy(h.copy())})


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("t", [1, 7])
def test_conv1d(t, with_state):
    cfg = reduced(ARCH)
    tree, p = _block_pair(cfg, 1)
    (x,) = normal(2, (2, t, cfg.lru_width))
    jst, tst = _state(cfg, 2, 3) if with_state else ({"conv": None}, {"conv": None})
    got, gs = G._conv1d(p, torch.from_numpy(x), tst["conv"])
    want, ws = JG._conv1d(tree, jnp.asarray(x), jst["conv"])
    close(got, want, FN_TOL)
    close(gs, ws, FN_TOL)


@pytest.mark.parametrize("t", [1, 2, 5, 16, 37])
def test_linear_scan_is_the_sequential_recurrence(t):
    """The doubling scan against h_t = a_t·h_{t-1} + b_t run step by step
    in float64 (the reference for the scan's arithmetic)."""
    a, b = normal(4 + t, (2, t, 3), (2, t, 3))
    a = 1.0 / (1.0 + np.exp(-a))                      # decays in (0, 1)
    aa, hh = G.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    h, ps = np.zeros((2, 3)), np.ones((2, 3))
    for i in range(t):
        h = a[:, i].astype(np.float64) * h + b[:, i]
        ps = ps * a[:, i]
        np.testing.assert_allclose(hh[:, i].numpy(), h, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(aa[:, i].numpy(), ps, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("t", [1, 9, 33])
def test_rglru_scan_and_step(t, with_h0):
    """t = 1 with h0 is the decode step (the exact update), else the scan."""
    cfg = reduced(ARCH)
    tree, p = _block_pair(cfg, 5)
    (x,) = normal(6, (2, t, cfg.lru_width))
    jst, tst = _state(cfg, 2, 7)
    h0j, h0t = (jst["h"], tst["h"]) if with_h0 else (None, None)
    got, gh = G._rglru(p, torch.from_numpy(x), h0t)
    want, wh = JG._rglru(tree, jnp.asarray(x), h0j)
    close(got, want, FN_TOL)
    close(gh, wh, FN_TOL)


def test_rglru_block_prefill_then_decode():
    """rglru_block without a state, then with one through a prompt and
    three decode steps, each against the reference, states included."""
    cfg = reduced(ARCH)
    tree, p = _block_pair(cfg, 8)
    (x,) = normal(9, (2, 11, cfg.d_model))
    got, gs = G.rglru_block(p, cfg, torch.from_numpy(x))
    want, ws = JG.rglru_block(tree, cfg, jnp.asarray(x))
    assert gs is None and ws is None
    close(got, want, FN_TOL)
    jst, tst = _state(cfg, 2, 10)
    for step, t in enumerate((11, 1, 1, 1)):
        (x,) = normal(20 + step, (2, t, cfg.d_model))
        got, tst = G.rglru_block(p, cfg, torch.from_numpy(x), tst)
        want, jst = JG.rglru_block(tree, cfg, jnp.asarray(x), jst)
        close(got, want, FN_TOL)
        for key in ("conv", "h"):
            close(tst[key], jst[key], FN_TOL)
    assert tst["h"].dtype == torch.float32


def _stack_pair(cfg, seed):
    tree = perturbed(np_tree(JT.hybrid_stack_init(jax.random.key(seed), cfg)), seed, scale=0.02)
    return tree, load(T.HybridStack(None, cfg, device="cpu"), tree)


@pytest.mark.parametrize("kernels", [True, False])
def test_hybrid_stack_with_its_tail(kernels):
    """The stack of 2 units and a 2-block tail: without caches, then a
    prompt of 10 (past the 8-slot window) and decode steps through the
    units' and the tail's caches, against the reference."""
    cfg = reduced(ARCH)
    tree, p = _stack_pair(cfg, 30)
    assert len(p.units) == 2 and len(p.tail) == 2 and len(tree["tail"]) == 2
    for m in p.modules():
        if hasattr(m, "kernels"):
            m.kernels = kernels
    (x,) = normal(31, (2, 10, cfg.d_model), scale=0.5)
    pos = np.arange(10, dtype=np.int32)[None, :]
    got, gc, _ = T.hybrid_stack_apply(p, cfg, torch.from_numpy(x), torch.from_numpy(pos))
    want, wc, _ = JT.hybrid_stack_apply(tree, cfg, jnp.asarray(x), jnp.asarray(pos))
    assert gc is None and wc is None
    close(got, want, FN_TOL)
    tc, jc = T.make_cache(cfg, 2, 32, device="cpu"), JT.make_cache(cfg, 2, 32)
    got, tc, _ = T.hybrid_stack_apply(p, cfg, torch.from_numpy(x), torch.from_numpy(pos),
                                      caches=tc)
    want, jc, _ = JT.hybrid_stack_apply(tree, cfg, jnp.asarray(x), jnp.asarray(pos), caches=jc)
    close(got, want, FN_TOL)
    assert_cache_close(tc, np_tree(jc), FN_TOL)
    for t in range(10, 14):
        (x1,) = normal(40 + t, (2, 1, cfg.d_model), scale=0.5)
        pos1 = np.full((1, 1), t, np.int32)
        got, tc, _ = T.hybrid_stack_apply(p, cfg, torch.from_numpy(x1), torch.from_numpy(pos1),
                                          caches=tc, cache_pos=t)
        want, jc, _ = JT.hybrid_stack_apply(tree, cfg, jnp.asarray(x1), jnp.asarray(pos1),
                                            caches=jc, cache_pos=jnp.int32(t))
        close(got, want, FN_TOL)
        assert_cache_close(tc, np_tree(jc), FN_TOL)


def test_hybrid_cache_is_the_references():
    """make_serve_cache: units stacked (U, ...) per block of the pattern,
    the tail unstacked, slot_pos -1, RG-LRU h in f32 and conv in the
    compute dtype; the window is min(local_window, max_seq)."""
    for layers, max_seq in ((8, 32), (3, 6)):
        cfg = reduced(ARCH, num_layers=layers)
        got = M.make_serve_cache(cfg, 2, max_seq, device="cpu")
        want = np_tree(JM.make_serve_cache(cfg, 2, max_seq))
        assert_cache_close(got, want, 0.0)
        assert got["kv"]["units"][2]["slot_pos"].dtype == torch.int32
        assert got["kv"]["units"][0]["h"].dtype == torch.float32


@pytest.mark.parametrize("kernels", [True, False])
def test_recurrentgemma_matches_the_reference(kernels):
    check_model_against_reference(ARCH, kernels)


@pytest.mark.parametrize("kernels", [True, False])
def test_recurrentgemma_decode_matches_teacher_forcing(kernels):
    """tests/test_models.py's case: stepwise decode from the empty cache
    equals the parallel form, 20 steps past the 8-slot rolling window;
    then a prefill of 10 (the last 8 kept) and decode after it."""
    cfg = reduced(ARCH)
    check_decode_matches_teacher_forcing(cfg, kernels, s=20, n_prompt=0, atol=5e-2, rtol=2e-2)
    check_decode_matches_teacher_forcing(cfg, kernels, s=20, n_prompt=10)


def test_params_from_jax_fills_the_units_and_the_tail():
    """Each unit's list entry and each tail block receives its own slice."""
    cfg = reduced(ARCH)
    tree = np_tree(JM.init_params(jax.random.key(3), cfg))
    model = params_from_jax(tree, cfg, device="cpu")
    for u in range(2):
        for i in range(3):
            w = tree["stack"]["units"]["mix"][i]["w_x" if i < 2 else "w_q"][u]
            got = model.stack.units[u].mix[i].w_x if i < 2 else model.stack.units[u].mix[i].w_q
            np.testing.assert_array_equal(got.numpy(), w)
    for i in range(2):
        np.testing.assert_array_equal(model.stack.tail[i].mix.lru_wa.numpy(),
                                      tree["stack"]["tail"][i]["mix"]["lru_wa"])
