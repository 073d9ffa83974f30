"""The port's flash attention (src/repro_torch/kernels/flash_attn and
models/attention) against the JAX package's, on the same seeded numpy
inputs: the plain version against the Pallas kernel (interpret mode) and
its oracle, the op against the JAX op and the model's ``_sdpa``, and the
port's ``_sdpa``/``_causal_mask`` against the JAX ones.  The CUDA kernel
itself is held to the plain version in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attn.kernel import flash_attention_pallas  # noqa: E402
from repro.kernels.flash_attn.ops import flash_sdpa as jax_flash_sdpa  # noqa: E402
from repro.kernels.flash_attn.ref import attention_ref  # noqa: E402
from repro.models.attention import _causal_mask as jax_causal_mask  # noqa: E402
from repro.models.attention import _sdpa as jax_sdpa  # noqa: E402
from repro_torch.kernels.flash_attn.kernel import (  # noqa: E402
    KERNEL_WIDTHS,
    flash_attention_cuda,
    kernel_width,
    pad_head_width,
)
from repro_torch.kernels.flash_attn.ops import flash_sdpa  # noqa: E402
from repro_torch.kernels.flash_attn.ref import flash_attention_plain  # noqa: E402
from repro_torch.models.attention import _causal_mask, _sdpa  # noqa: E402
from repro_torch.testing import flash_close  # noqa: E402


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(arrays, dtype=np.float32):
    """The same arrays for both packages, rounded to ``dtype`` alike."""
    jx = [jnp.asarray(a, jnp.bfloat16 if dtype == "bf16" else jnp.float32) for a in arrays]
    tt = [torch.from_numpy(a).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
          for a in arrays]
    return jx, tt


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("bh,sq,skv,hd,bq,bk", [
    (2, 128, 128, 64, 64, 64),
    (1, 256, 256, 128, 128, 128),
    (3, 128, 256, 64, 64, 128),    # cross lengths
    (2, 256, 128, 32, 128, 64),
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_and_ref(bh, sq, skv, hd, bq, bk, causal):
    (q, k, v), (tq, tk, tv) = _both(_normal(sq + skv + hd, (bh, sq, hd), (bh, skv, hd),
                                            (bh, skv, hd)))
    scale = hd ** -0.5
    got = flash_attention_plain(tq, tk, tv, causal=causal, sm_scale=scale)
    pallas = flash_attention_pallas(q, k, v, bq=bq, bk=bk, causal=causal, sm_scale=scale)
    ref = attention_ref(q, k, v, causal=causal, sm_scale=scale)
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=2e-5)
    np.testing.assert_allclose(_f32(got), _f32(ref), atol=2e-5)


def test_plain_local_window():
    (q, k, v), (tq, tk, tv) = _both(_normal(64, (2, 256, 64), (2, 256, 64), (2, 256, 64)))
    got = flash_attention_plain(tq, tk, tv, causal=True, window=64, sm_scale=0.125)
    pallas = flash_attention_pallas(q, k, v, bq=64, bk=64, causal=True, window=64,
                                    sm_scale=0.125)
    ref = attention_ref(q, k, v, causal=True, window=64, sm_scale=0.125)
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=2e-5)
    np.testing.assert_allclose(_f32(got), _f32(ref), atol=2e-5)


@pytest.mark.parametrize("dtype,atol", [(np.float32, 2e-5), ("bf16", 3e-2)])
def test_plain_dtypes(dtype, atol):
    """bf16 inputs rounded alike in both packages; compared in f32."""
    (q, k, v), (tq, tk, tv) = _both(_normal(7, (2, 128, 64), (2, 128, 64), (2, 128, 64)),
                                    dtype)
    got = flash_attention_plain(tq, tk, tv, sm_scale=0.125)
    assert got.dtype == tq.dtype
    pallas = flash_attention_pallas(q, k, v, bq=64, bk=64, sm_scale=0.125)
    ref = attention_ref(q, k, v, sm_scale=0.125)
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=atol)
    np.testing.assert_allclose(_f32(got), _f32(ref), atol=atol)


def test_flash_sdpa_gqa_matches_jax_op_and_model_sdpa():
    """The op on the CPU == the JAX op and the JAX model's _sdpa (GQA, causal,
    S = 96, which the JAX op pads to 128)."""
    b, s, h, kvh, hd = 2, 96, 8, 2, 64
    (q, k, v), (tq, tk, tv) = _both(_normal(1, (b, s, h, hd), (b, s, kvh, hd),
                                            (b, s, kvh, hd)))
    got = flash_sdpa(tq, tk, tv, causal=True, device="cpu")
    assert got.shape == (b, s, h, hd) and got.device.type == "cpu"
    want_op = jax_flash_sdpa(q, k, v, causal=True, bq=64, bk=64)
    want_model = jax_sdpa(q, k, v, jax_causal_mask(s, s, 0))
    np.testing.assert_allclose(_f32(got), _f32(want_op), atol=3e-5)
    np.testing.assert_allclose(_f32(got), _f32(want_model), atol=3e-5)


@pytest.mark.parametrize("window", [0, 24])
def test_model_sdpa_and_mask_match_jax(window):
    b, s, t, h, kvh, hd = 2, 40, 56, 4, 2, 32
    (q, k, v), (tq, tk, tv) = _both(_normal(11, (b, s, h, hd), (b, t, kvh, hd),
                                            (b, t, kvh, hd)))
    mask = _causal_mask(s, t, 16, window=window)
    want_mask = jax_causal_mask(s, t, 16, window=window)
    assert mask.shape == (1, 1, s, t)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(_sdpa(tq, tk, tv, mask).numpy(),
                               np.asarray(jax_sdpa(q, k, v, want_mask)), atol=2e-6)
    np.testing.assert_allclose(_sdpa(tq, tk, tv, None).numpy(),
                               np.asarray(jax_sdpa(q, k, v, None)), atol=2e-6)


def test_ragged_non_causal_counts_no_padded_key():
    """S = 96, not a multiple of a block: the port's op equals attention over
    the 96 real keys only (the JAX op lets its zero padding keys into a
    non-causal softmax, so it is not the reference here)."""
    b, s, h, kvh, hd = 1, 96, 4, 2, 32
    (q, k, v), (tq, tk, tv) = _both(_normal(0, (b, s, h, hd), (b, s, kvh, hd),
                                            (b, s, kvh, hd)))
    got = flash_sdpa(tq, tk, tv, causal=False, device="cpu")
    np.testing.assert_allclose(_f32(got), _f32(jax_sdpa(q, k, v, None)), atol=3e-5)


@pytest.mark.parametrize("hd,window", [(64, 0), (128, 96)])
def test_bf16_check_passes_pallas_rounding_and_catches_planted_faults(hd, window):
    """``flash_close`` in bf16 against the plain version: the Pallas kernel,
    which rounds p to bf16 before PV as the CUDA kernel does, passes; outputs
    with the diagonal kv tile dropped, kv tile 0 dropped, or v's lanes 1 and
    2 swapped in each group of 4 (a bf16 load fault) do not."""
    b, s, h = 1, 256, 2
    (q, k, v), (tq, tk, tv) = _both(_normal(hd + window, (b, s, h, hd), (b, s, h, hd),
                                            (b, s, h, hd)), "bf16")
    flat = [x.transpose(1, 2).reshape(b * h, s, hd) for x in (tq, tk, tv)]
    want = flash_attention_plain(*flat, causal=True, sm_scale=hd ** -0.5, window=window)
    pallas = flash_attention_pallas(*(jnp.swapaxes(x, 1, 2).reshape(b * h, s, hd)
                                      for x in (q, k, v)),
                                    bq=64, bk=64, causal=True, sm_scale=hd ** -0.5,
                                    window=window)
    pallas = torch.from_numpy(np.asarray(pallas, np.float32)).bfloat16()
    _, used = flash_close(pallas, want)
    assert 0.0 < used <= 1.0

    vis = _causal_mask(s, s, 0, window)[0, 0]
    pos = torch.arange(s)
    same_tile = (pos[:, None] // 64) == (pos[None, :] // 64)
    first_tile = (pos[:, None] >= 64) & (pos[None, :] < 64)
    tf = [x.float() for x in (tq, tk, tv)]
    lanes = torch.arange(hd).view(-1, 4)[:, [0, 2, 1, 3]].reshape(-1)
    faults = {
        "diagonal tile dropped": _sdpa(*tf, (vis & ~same_tile)[None, None]),
        "tile 0 dropped": _sdpa(*tf, (vis & ~first_tile)[None, None]),
        "v lanes swapped": _sdpa(tf[0], tf[1], tf[2][..., lanes], vis[None, None]),
    }
    for out in faults.values():
        out = out.bfloat16().transpose(1, 2).reshape(b * h, s, hd)
        with pytest.raises(AssertionError):
            flash_close(out, want)


def test_row_with_no_visible_key_is_zero():
    """A window that leaves late rows no key (Sq > Skv): zero output, as the
    JAX oracle."""
    (q, k, v), (tq, tk, tv) = _both(_normal(5, (2, 128, 32), (2, 64, 32), (2, 64, 32)))
    got = flash_attention_plain(tq, tk, tv, causal=True, window=16, sm_scale=0.2)
    ref = attention_ref(q, k, v, causal=True, window=16, sm_scale=0.2)
    assert not got[:, 80:].any()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_flash_sdpa_needs_cuda_unless_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = torch.zeros(1, 8, 2, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flash_sdpa(q, q, q)


def test_cpu_tensors_launch_nothing():
    _, (tq, tk, tv) = _both(_normal(3, (2, 64, 32), (1, 64, 32), (1, 64, 32)))
    before = flash_attention_cuda.launches
    out = flash_attention_cuda(tq, tk, tv, causal=True, sm_scale=0.2)
    flash_sdpa(tq[None].transpose(1, 2), tk[None].transpose(1, 2), tv[None].transpose(1, 2),
               device="cpu")
    assert flash_attention_cuda.launches == before
    want = flash_attention_plain(tq, tk.repeat(2, 1, 1), tv.repeat(2, 1, 1), sm_scale=0.2)
    torch.testing.assert_close(out, want, rtol=0, atol=0)


@pytest.mark.parametrize("window", [0, 8])
def test_reduced_config_width_matches_jax_op_and_model_sdpa(window):
    """The reduced configs' attention (``ModelConfig.reduced``: hd 16, H 4,
    KVH 2, f32, window 8 where the model has one): the port's op on the
    CPU == the JAX op (Pallas kernel in interpret mode) and the JAX
    model's ``_sdpa``."""
    b, s, h, kvh, hd = 2, 48, 4, 2, 16
    (q, k, v), (tq, tk, tv) = _both(_normal(16 + window, (b, s, h, hd), (b, s, kvh, hd),
                                            (b, s, kvh, hd)))
    got = flash_sdpa(tq, tk, tv, causal=True, window=window, device="cpu")
    assert got.shape == (b, s, h, hd) and got.dtype == torch.float32
    want_op = jax_flash_sdpa(q, k, v, causal=True, window=window, bq=16, bk=16)
    want_model = jax_sdpa(q, k, v, jax_causal_mask(s, s, 0, window=window))
    np.testing.assert_allclose(_f32(got), _f32(want_op), atol=3e-5)
    np.testing.assert_allclose(_f32(got), _f32(want_model), atol=3e-5)


@pytest.mark.parametrize("hd,width", [(1, 16), (16, 16), (17, 32), (48, 64), (80, 128),
                                      (128, 128), (200, 256), (256, 256)])
def test_kernel_width_is_the_next_kernel_width(hd, width):
    assert kernel_width(hd) == width and width in KERNEL_WIDTHS


def test_kernel_width_above_256_raises():
    with pytest.raises(ValueError, match="256"):
        kernel_width(257)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,causal,window", [(48, True, 0), (80, False, 0), (1, True, 5),
                                              (100, True, 7)])
def test_pad_then_plain_then_cut_is_plain(hd, causal, window, dtype):
    """What the wrapper does on the card for a width the kernels lack, with
    the plain version in the kernel's place: zero columns in q, k and v,
    the caller's sm_scale (1/sqrt(hd), not 1/sqrt(width)), the padded
    columns cut off; equal bit for bit to the plain version at hd."""
    bh, kvh, sq, skv = 4, 2, 40, 33
    _, (q, k, v) = _both(_normal(hd, (bh, sq, hd), (kvh, skv, hd), (kvh, skv, hd)))
    q, k, v = (x.to(dtype) for x in (q, k, v))
    kw = dict(causal=causal, sm_scale=hd ** -0.5, window=window)
    width = kernel_width(hd)
    padded = [pad_head_width(x, width) for x in (q, k, v)]
    assert padded[0].shape == (bh, sq, width) and not padded[0][..., hd:].any()
    got = flash_attention_plain(*padded, **kw)
    assert not got[..., hd:].any()
    assert torch.equal(got[..., :hd], flash_attention_plain(q, k, v, **kw))
