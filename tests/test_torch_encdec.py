"""The port's cross-attention families against the JAX package's on the CPU,
in f32 at the reduced configs, on the JAX ``init_params`` weights
(perturbed, so the cross gates are not tanh(0) = 0): the audio enc-dec
(src/repro_torch/models/encdec.py: ``encode``, ``decode_stack`` on the
encoder output and on the cross caches, ``decoder_cross_kv``), the vlm
stack (models/transformer.py: ``vlm_stack_apply`` over 2 units of 4 self
layers and a gated cross layer, ``vlm_patch_kv``, ``cross_layer_apply``),
and whisper-medium and llama-3.2-vision-11b whole, with seeded N(0, 1)
frames and patches, at ``LOGIT_TOL`` with ``kernels=True`` and ``False``,
and decode against teacher forcing."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import encdec as JE  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.models import encdec as E  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
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

AUDIO, VLM = "whisper-medium", "llama-3.2-vision-11b"


def _kernels(module, kernels):
    for m in module.modules():
        if hasattr(m, "kernels"):
            m.kernels = kernels
    return module


def _encdec_pair(cfg, seed, kernels):
    tree = perturbed(np_tree(JE.encdec_init(jax.random.key(seed), cfg)), seed, scale=0.02)
    return tree, _kernels(load(E.EncDec(None, cfg, device="cpu"), tree), kernels)


@pytest.mark.parametrize("kernels", [True, False])
def test_encode_and_decoder_cross_kv(kernels):
    cfg = reduced(AUDIO)
    tree, p = _encdec_pair(cfg, 1, kernels)
    (frames,) = normal(2, (2, cfg.encoder_seq, cfg.d_model))
    got = E.encode(p, cfg, torch.from_numpy(frames))
    want = JE.encode(tree, cfg, jnp.asarray(frames))
    close(got, want, FN_TOL)
    gkv = E.decoder_cross_kv(p, cfg, got)
    wkv = JE.decoder_cross_kv(tree, cfg, want)
    for key in ("k", "v"):
        assert tuple(gkv[key].shape) == wkv[key].shape == (
            cfg.num_layers, 2, cfg.encoder_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
        close(gkv[key], wkv[key], FN_TOL)


@pytest.mark.parametrize("kernels", [True, False])
def test_decode_stack_on_the_encoder_output_and_on_the_caches(kernels):
    """decode_stack without caches (the teacher-forced path), then a prompt
    and decode steps through the self caches and the cross caches, each
    against the reference, the self caches included."""
    cfg = reduced(AUDIO)
    tree, p = _encdec_pair(cfg, 3, kernels)
    frames, x = normal(4, (2, cfg.encoder_seq, cfg.d_model), (2, 7, cfg.d_model), scale=0.5)
    enc_t = E.encode(p, cfg, torch.from_numpy(frames))
    enc_j = JE.encode(tree, cfg, jnp.asarray(frames))
    pos = np.arange(7, dtype=np.int32)[None, :]
    got, gc = E.decode_stack(p, cfg, torch.from_numpy(x), torch.from_numpy(pos), enc_out=enc_t)
    want, wc = JE.decode_stack(tree, cfg, jnp.asarray(x), jnp.asarray(pos), enc_out=enc_j)
    assert gc is None and wc is None
    close(got, want, FN_TOL)
    ckv_t, ckv_j = E.decoder_cross_kv(p, cfg, enc_t), JE.decoder_cross_kv(tree, cfg, enc_j)
    tc = T.make_cache(cfg, 2, 16, device="cpu")
    jc = JT.make_cache(cfg, 2, 16)
    got, tc = E.decode_stack(p, cfg, torch.from_numpy(x), torch.from_numpy(pos),
                             cross_caches=ckv_t, self_caches=tc)
    want, jc = JE.decode_stack(tree, cfg, jnp.asarray(x), jnp.asarray(pos), cross_caches=ckv_j,
                               self_caches=jc)
    close(got, want, FN_TOL)
    for t in range(7, 10):
        (x1,) = normal(5 + t, (2, 1, cfg.d_model), scale=0.5)
        pos1 = np.full((1, 1), t, np.int32)
        got, tc = E.decode_stack(p, cfg, torch.from_numpy(x1), torch.from_numpy(pos1),
                                 cross_caches=ckv_t, self_caches=tc, cache_pos=t)
        want, jc = JE.decode_stack(tree, cfg, jnp.asarray(x1), jnp.asarray(pos1),
                                   cross_caches=ckv_j, self_caches=jc, cache_pos=jnp.int32(t))
        close(got, want, FN_TOL)
        assert_cache_close(tc, np_tree(jc), FN_TOL)


def _vlm_pair(cfg, seed, kernels):
    tree = perturbed(np_tree(JT.vlm_stack_init(jax.random.key(seed), cfg)), seed, scale=0.02)
    return tree, _kernels(load(T.vlm_stack_init(None, cfg, device="cpu"), tree), kernels)


@pytest.mark.parametrize("kernels", [True, False])
def test_vlm_stack_and_patch_kv(kernels):
    """2 units (4 self layers and a cross layer each, gates tanh(~0.5)):
    vlm_patch_kv, then the stack without caches, with a prompt's caches
    and with decode steps, against the reference."""
    cfg = reduced(VLM)
    tree, p = _vlm_pair(cfg, 10, kernels)
    with torch.no_grad():
        for u, unit in enumerate(p):
            unit.cross.attn.gate.fill_(0.5 + 0.1 * u)
    tree["cross"]["attn"]["gate"] = np.array([0.5, 0.6], np.float32)
    assert len(p) == 2 and len(p[0].self) == 4
    patches, x = normal(11, (2, cfg.num_patches, cfg.d_model), (2, 6, cfg.d_model), scale=0.5)
    gkv = T.vlm_patch_kv(p, cfg, torch.from_numpy(patches))
    wkv = JT.vlm_patch_kv(tree, cfg, jnp.asarray(patches))
    for key in ("k", "v"):
        assert tuple(gkv[key].shape) == wkv[key].shape
        close(gkv[key], wkv[key], FN_TOL)
    pos = np.arange(6, dtype=np.int32)[None, :]
    got, _, _ = T.vlm_stack_apply(p, cfg, torch.from_numpy(x), torch.from_numpy(pos), gkv)
    want, _, _ = JT.vlm_stack_apply(tree, cfg, jnp.asarray(x), jnp.asarray(pos), wkv)
    close(got, want, FN_TOL)
    tc, jc = T.make_cache(cfg, 2, 16, device="cpu"), JT.make_cache(cfg, 2, 16)
    assert tuple(tc["k"].shape) == jc["k"].shape == (2, 4, 2, 16, cfg.num_kv_heads,
                                                     cfg.resolved_head_dim)
    got, tc, _ = T.vlm_stack_apply(p, cfg, torch.from_numpy(x), torch.from_numpy(pos), gkv,
                                   caches=tc)
    want, jc, _ = JT.vlm_stack_apply(tree, cfg, jnp.asarray(x), jnp.asarray(pos), wkv, caches=jc)
    close(got, want, FN_TOL)
    for t in range(6, 9):
        (x1,) = normal(12 + t, (2, 1, cfg.d_model), scale=0.5)
        pos1 = np.full((1, 1), t, np.int32)
        got, tc, _ = T.vlm_stack_apply(p, cfg, torch.from_numpy(x1), torch.from_numpy(pos1), gkv,
                                       caches=tc, cache_pos=t)
        want, jc, _ = JT.vlm_stack_apply(tree, cfg, jnp.asarray(x1), jnp.asarray(pos1), wkv,
                                         caches=jc, cache_pos=jnp.int32(t))
        close(got, want, FN_TOL)
        assert_cache_close(tc, np_tree(jc), FN_TOL)


@pytest.mark.parametrize("kernels", [True, False])
def test_cross_layer_with_a_gate(kernels):
    """cross_layer_apply on patch embeddings and on their K/V, the gate
    tanh(0.7); at gate 0 the layer adds its MLP only."""
    cfg = reduced(VLM)
    tree = perturbed(np_tree(JT.cross_layer_init(jax.random.key(20), cfg)), 20)
    tree["attn"]["gate"] = np.float32(0.7)
    p = _kernels(load(T.cross_layer_init(None, cfg, device="cpu"), tree), kernels)
    x, kv = normal(21, (2, 5, cfg.d_model), (2, cfg.num_patches, cfg.d_model))
    for kv_in, jkv_in in ((torch.from_numpy(kv), jnp.asarray(kv)),
                          (T.cross_kv(p.attn, cfg, torch.from_numpy(kv)),
                           JT.cross_kv(tree["attn"], cfg, jnp.asarray(kv)))):
        got = T.cross_layer_apply(p, cfg, torch.from_numpy(x), kv_in)
        want = JT.cross_layer_apply(tree, cfg, jnp.asarray(x), jkv_in)
        close(got, want, FN_TOL)
    with torch.no_grad():
        p.attn.gate.zero_()
    tree["attn"]["gate"] = np.float32(0.0)
    close(T.cross_layer_apply(p, cfg, torch.from_numpy(x), torch.from_numpy(kv)),
          JT.cross_layer_apply(tree, cfg, jnp.asarray(x), jnp.asarray(kv)), FN_TOL)


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("arch", [AUDIO, VLM])
def test_cross_model_matches_the_reference(arch, kernels):
    check_model_against_reference(arch, kernels)


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("arch", [AUDIO, VLM])
def test_cross_decode_matches_teacher_forcing(arch, kernels):
    """tests/test_models.py's case with random frames or patches; the vlm
    gates set to 0.5, so the cross layers add to the stream."""
    cfg = reduced(arch)
    check_decode_matches_teacher_forcing(cfg, kernels, gate=0.5)


def test_serve_cache_holds_the_cross_caches():
    for arch, n, t in ((AUDIO, 2, 16), (VLM, 2, 16)):
        cfg = reduced(arch)
        got = M.make_serve_cache(cfg, 3, 24, device="cpu")
        want = np_tree(JM.make_serve_cache(cfg, 3, 24))
        assert_cache_close(got, want, 0.0)
        assert tuple(got["cross"]["k"].shape) == (n, 3, t, cfg.num_kv_heads,
                                                  cfg.resolved_head_dim)
