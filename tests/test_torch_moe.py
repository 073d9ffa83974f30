"""The port's MoE layer (src/repro_torch/models/moe.py) and the moe family
(olmoe-1b-7b, phi3.5-moe) against the JAX package's on the CPU, in f32 at
the reduced configs, on the JAX ``init_params`` weights (perturbed):
``moe_ffn``'s output and aux loss at 2e-5 with the expert ids equal
outside near ties, at the default capacity (tokens dropped) and at a
drop-free one; the router as a KNN join (the twin of
tests/test_models.py::test_moe_router_is_knn_join, on the port's
``core/topk``); the tie order on planted ties; the whole models at
``LOGIT_TOL`` with ``kernels=True`` and ``False``, and decode against
teacher forcing at drop-free capacity."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import moe as JMoE  # noqa: E402
from repro_torch.core.topk import init_topk, topk_update  # noqa: E402
from repro_torch.models import moe as MoE  # noqa: E402
from util_lm import (  # noqa: E402
    FN_TOL,
    check_decode_matches_teacher_forcing,
    check_model_against_reference,
    close,
    load,
    normal,
    np_tree,
    perturbed,
    reduced,
)

ARCHS = ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b"]


def _moe_pair(cfg, seed):
    tree = perturbed(np_tree(JMoE.moe_init(jax.random.key(seed), cfg)), seed)
    return tree, load(MoE.MoE(None, cfg, device="cpu"), tree)


def _jax_top_e(tree, cfg, x):
    """The reference's routing (src/repro/models/moe.py:53-56) on x (B, S, d):
    the group's top-k probabilities and expert ids."""
    t = x.shape[0] * x.shape[1]
    tg = MoE.group_size(t, cfg)
    xf = jnp.asarray(x).reshape(t // tg, tg, -1)
    probs = jax.nn.softmax((xf @ jnp.asarray(tree["router"])).astype(jnp.float32), axis=-1)
    _, top_e = jax.lax.top_k(probs, cfg.num_experts_per_tok + 1)
    sorted_p = jnp.sort(probs, axis=-1)[..., ::-1]
    return np.asarray(top_e), np.asarray(sorted_p)


@pytest.mark.parametrize("capacity", ["default", "drop-free"])
@pytest.mark.parametrize("shape", [(2, 16), (3, 10), (1, 1)])   # 32 tokens in 2 groups; 30 in
def test_moe_ffn_matches_the_reference(shape, capacity):           # 2 of 15; a decode step
    cfg = reduced("olmoe-1b-7b")
    if capacity == "drop-free":
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.num_experts_per_tok)
    tree, p = _moe_pair(cfg, 7)
    (x,) = normal(8, shape + (cfg.d_model,))
    # tokens leaning toward expert 0, which then takes every token of a
    # group: more than its capacity at the default factor
    lean = tree["router"][:, 0] / np.linalg.norm(tree["router"][:, 0])
    x = (x + 10.0 * lean).astype(np.float32)
    got, aux = MoE.moe_ffn(p, cfg, torch.from_numpy(x))
    want, jaux = JMoE.moe_ffn(tree, cfg, jnp.asarray(x))
    # the experts' weights draw at 1/√E (dense_init's fan-in is the leading
    # axis, E), so the outputs' RMS is ~1e2: FN_TOL holds them in that unit,
    # where f32 summation order shows
    scale = max(1.0, float(np.sqrt(np.mean(np.square(want)))))
    close(got.numpy() / scale, np.asarray(want) / scale, FN_TOL)
    close(aux, jaux, FN_TOL)

    k = cfg.num_experts_per_tok
    t = shape[0] * shape[1]
    tg = MoE.group_size(t, cfg)
    _, _, top_e = MoE.route(p, cfg, torch.from_numpy(x).reshape(t // tg, tg, -1))
    want_e, sorted_p = _jax_top_e(tree, cfg, x)
    # ids equal outside near ties: no two of the k + 1 largest within 1e-6
    apart = (np.abs(np.diff(sorted_p[..., :k + 1], axis=-1)) > 1e-6).all(-1)
    assert apart.mean() > 0.9
    np.testing.assert_array_equal(top_e.numpy()[apart], want_e[..., :k][apart])
    cap = max(int(tg * k / cfg.num_experts * cfg.capacity_factor), 1)
    load_per_expert = np.stack([(want_e[..., :k] == e).sum(1) for e in range(cfg.num_experts)], -1)
    dropped = (load_per_expert > cap).any()
    assert dropped == (capacity == "default" and t > 1)   # the drop path is exercised


def test_router_is_a_knn_join():
    """Top-k expert routing == a KNN join of tokens against router rows: the
    port's top_experts and route against core/topk's topk_update over one
    block of all experts (incumbents empty), and against lax.top_k."""
    cfg = reduced("olmoe-1b-7b")
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    (x,) = normal(0, (6, e))
    top_p, top_e = MoE.top_experts(torch.from_numpy(x), k)
    state = topk_update(init_topk(6, k, device="cpu"), torch.from_numpy(x),
                        torch.arange(e, dtype=torch.int32))
    np.testing.assert_allclose(top_p.numpy(), state.scores.numpy(), atol=1e-6)
    np.testing.assert_array_equal(top_e.numpy(), state.ids.numpy())
    want_p, want_e = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(top_p.numpy(), np.asarray(want_p))
    # route: the join on the router's probabilities, renormalised over the k
    tree, p = _moe_pair(cfg, 3)
    (xf,) = normal(4, (1, 8, cfg.d_model))
    probs, got_p, got_e = MoE.route(p, cfg, torch.from_numpy(xf))
    ref_p, ref_e = jax.lax.top_k(jax.nn.softmax(jnp.asarray(xf) @ jnp.asarray(tree["router"])), k)
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(ref_e))
    close(got_p, np.asarray(ref_p) / np.asarray(ref_p).sum(-1, keepdims=True), 1e-6)
    close(probs.sum(-1), np.ones((1, 8)), 1e-6)


def test_tie_order_on_planted_ties():
    """Equal router probabilities go to the lower expert id, as lax.top_k
    gives them; equal scores offered in one block to core/topk's
    topk_update go the same way (earliest offered wins)."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2],
                      [0.0, 0.5, 0.5, 0.0]], np.float32)
    for k in (1, 2, 3):
        got_p, got_e = MoE.top_experts(torch.from_numpy(probs), k)
        want_p, want_e = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
        np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
        state = topk_update(init_topk(4, k, device="cpu"), torch.from_numpy(probs),
                            torch.arange(4, dtype=torch.int32))
        np.testing.assert_array_equal(state.ids.numpy(), got_e.numpy())
    _, top2 = MoE.top_experts(torch.from_numpy(probs), 2)
    assert top2.tolist() == [[0, 1], [1, 3], [0, 2], [1, 2]]


def test_decode_capacity_is_one_and_routes_every_token():
    """At one token a group the capacity is 1, and every one of its k
    experts keeps it: a decode step never drops."""
    cfg = reduced("phi3.5-moe-42b-a6.6b")
    assert max(int(1 * cfg.num_experts_per_tok / cfg.num_experts * cfg.capacity_factor), 1) == 1
    tree, p = _moe_pair(cfg, 11)
    free = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.num_experts_per_tok)
    for x in normal(12, *[(1, 1, cfg.d_model)] * 3):
        got, _ = MoE.moe_ffn(p, cfg, torch.from_numpy(x))
        want, _ = MoE.moe_ffn(p, free, torch.from_numpy(x))
        assert torch.equal(got, want)
        dense = 0      # every expert's SwiGLU, weighted by the renormalised top-k gates
        _, top_p, top_e = MoE.route(p, cfg, torch.from_numpy(x).reshape(1, 1, -1))
        xt = torch.from_numpy(x).reshape(1, -1)
        for g, e in zip(top_p[0, 0], top_e[0, 0]):
            h = torch.nn.functional.silu(xt @ p.w_gate[e]) * (xt @ p.w_up[e])
            dense = dense + g * (h @ p.w_down[e])
        scale = max(1.0, float(dense.pow(2).mean().sqrt()))
        close(got.reshape(1, -1) / scale, dense / scale, 1e-6)


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_model_matches_the_reference(arch, kernels):
    aux = check_model_against_reference(arch, kernels)
    assert aux > 0          # the Switch loss, summed over the layers


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_decode_matches_teacher_forcing(arch, kernels):
    """tests/test_models.py's case: drop-free capacity (cf = E/k), since
    dropping depends on the batch's composition."""
    cfg = reduced(arch)
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.num_experts_per_tok)
    check_decode_matches_teacher_forcing(cfg, kernels)
