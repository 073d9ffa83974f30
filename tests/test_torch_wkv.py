"""The port's WKV (src/repro_torch/kernels/wkv and models/rwkv6) against
the JAX package's, on the same seeded numpy inputs: the plain version
against the Pallas kernel (interpret mode) and the exact sequential
recurrence, the port's ``_chunked_wkv`` against the JAX model's, and the
op against the JAX op.  The CUDA kernel itself is held to the plain
version in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.wkv.kernel import wkv_pallas  # noqa: E402
from repro.kernels.wkv.ops import wkv as jax_wkv  # noqa: E402
from repro.kernels.wkv.ref import wkv_sequential  # noqa: E402
from repro.models.rwkv6 import _chunked_wkv as jax_chunked_wkv  # noqa: E402
from repro_torch.kernels.wkv.kernel import CHUNKS, wkv_cuda  # noqa: E402
from repro_torch.kernels.wkv.ops import wkv  # noqa: E402
from repro_torch.kernels.wkv.ref import wkv_plain  # noqa: E402
from repro_torch.models.rwkv6 import CLAMP, _chunked_wkv  # noqa: E402
from repro_torch.testing import wkv_close  # noqa: E402


def _inputs(shape, u_shape, seed=0, decay_shift=-4.0):
    """r, k, v ~ 0.5·N(0,1); lw = -exp(N(0,1) + shift) (the model's decay
    scale at -4 to -6; -1 makes the ±30 clamp bite); u ~ 0.1·N(0,1)."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal(shape) for _ in range(3))
    lw = -np.exp(rng.standard_normal(shape) + decay_shift)
    u = 0.1 * rng.standard_normal(u_shape)
    return [x.astype(np.float32) for x in (r, k, v, lw, u)]


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("bh,t,kk,chunk", [
    (2, 64, 32, 16),
    (3, 128, 64, 32),
    (1, 256, 64, 128),   # two chunks
    (2, 128, 16, 128),   # one chunk
])
def test_plain_matches_pallas_and_sequential(bh, t, kk, chunk):
    arrays = _inputs((bh, t, kk), (bh, kk), seed=t + kk)
    got = wkv_plain(*_torch(arrays), chunk=chunk).numpy()
    pallas = np.asarray(wkv_pallas(*_jax(arrays), chunk=chunk))
    seq = np.asarray(wkv_sequential(*_jax(arrays)))
    np.testing.assert_allclose(got, pallas, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got, seq, atol=2e-4, rtol=2e-4)


def test_plain_chunk_invariance():
    """The same result for any chunking (the carry composition is exact)."""
    arrays = _torch(_inputs((2, 128, 32), (2, 32), seed=3))
    o1 = wkv_plain(*arrays, chunk=16)
    o2 = wkv_plain(*arrays, chunk=64)
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), atol=2e-4)


@pytest.mark.parametrize("decay_shift", [-4.0, -1.0])
def test_model_chunked_wkv_matches_jax(decay_shift):
    """Under strong decay (-1.0) the ±30 clamp bites: both packages share it."""
    arrays = _inputs((2, 96, 4, 16), (4, 16), seed=5, decay_shift=decay_shift)
    got = _chunked_wkv(*_torch(arrays), chunk=32).numpy()
    want = np.asarray(jax_chunked_wkv(*_jax(arrays), chunk=32))
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=3e-4)


@pytest.mark.parametrize("decay_shift", [-4.0, -1.0])
@pytest.mark.parametrize("t,chunk", [(96, 32), (100, 32)])   # 100: ragged, the op pads
def test_op_matches_jax_op_and_model(decay_shift, t, chunk):
    b, h, kk = 2, 4, 16
    arrays = _inputs((b, t, h, kk), (h, kk), seed=t, decay_shift=decay_shift)
    got = wkv(*_torch(arrays), chunk=chunk, device="cpu")
    assert got.shape == (b, t, h, kk) and got.dtype == torch.float32
    want_op = np.asarray(jax_wkv(*_jax(arrays), chunk=chunk))
    np.testing.assert_allclose(got.numpy(), want_op, atol=3e-4, rtol=3e-4)
    if t % chunk == 0:
        want_model = np.asarray(jax_chunked_wkv(*_jax(arrays), chunk=chunk))
        np.testing.assert_allclose(got.numpy(), want_model, atol=3e-4, rtol=3e-4)


@pytest.mark.parametrize("t", [64, 60])   # 60: ragged, the JAX op pads to 64
def test_reduced_config_chunk_matches_jax_op(t):
    """The reduced configs' time mix (``ModelConfig.reduced``: head size
    16, chunk 8): the port's op on the CPU == the JAX op (Pallas kernel in
    interpret mode), and the kernel's wrapper takes chunk 8."""
    b, h, kk, chunk = 2, 4, 16, 8
    assert chunk in CHUNKS
    arrays = _inputs((b, t, h, kk), (h, kk), seed=t + 8, decay_shift=-1.0)
    got = wkv(*_torch(arrays), chunk=chunk, device="cpu")
    assert got.shape == (b, t, h, kk) and got.dtype == torch.float32
    want = np.asarray(jax_wkv(*_jax(arrays), chunk=chunk))
    wkv_close(got, torch.from_numpy(want.copy()))
    if t % chunk == 0:
        want_model = np.asarray(jax_chunked_wkv(*_jax(arrays), chunk=chunk))
        np.testing.assert_allclose(got.numpy(), want_model, atol=3e-4, rtol=3e-4)


def test_plain_bf16_rounds_inputs_only():
    """bf16 inputs are computed in f32 and the output rounded to bf16: the
    same as the f32 computation on the rounded inputs."""
    arrays = _torch(_inputs((2, 64, 32), (2, 32), seed=9))
    r, k, v, lw = (x.bfloat16() for x in arrays[:4])
    got = wkv_plain(r, k, v, lw, arrays[4], chunk=32)
    assert got.dtype == torch.bfloat16
    want = wkv_plain(r.float(), k.float(), v.float(), lw.float(), arrays[4], chunk=32)
    torch.testing.assert_close(got, want.bfloat16(), rtol=0, atol=0)


def test_wkv_needs_cuda_unless_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = torch.zeros(1, 16, 2, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wkv(x, x, x, x, torch.zeros(2, 16))


def test_cpu_tensors_launch_nothing():
    r, k, v, lw, u = _torch(_inputs((2, 48, 16), (2, 16), seed=1))
    before = wkv_cuda.launches
    out = wkv_cuda(r, k, v, lw, u, chunk=16)
    wkv(*(x[None].transpose(1, 2) for x in (r, k, v, lw)), u, chunk=16, device="cpu")
    assert wkv_cuda.launches == before
    torch.testing.assert_close(out, wkv_plain(r, k, v, lw, u, chunk=16), rtol=0, atol=0)


def _split_model(r, k, v, lw, u, chunk):
    """The CUDA kernel's three steps (csrc/wkv.cu) in plain torch, f32:
    every chunk's ltot and U_n = k_carry^T v; the carry as an elementwise
    scan over the chunks, S_{n+1} = S_n e^{ltot_n} (rows) + U_n from S_0 =
    0, keeping the state before each chunk; then every chunk's output from
    its own tiles and S_n."""
    bh, t, kk = r.shape
    pad = (-t) % chunk
    n = (t + pad) // chunk
    r, k, v, lw = (torch.nn.functional.pad(x.float(), (0, 0, 0, pad)).reshape(bh, n, chunk, kk)
                   for x in (r, k, v, lw))
    lcum_inc = torch.cumsum(lw, dim=2)
    ltot = lcum_inc[:, :, -1]                                          # (BH, N, K)
    k_carry = k * torch.exp(torch.clamp(ltot[:, :, None] - lcum_inc, max=CLAMP))
    upd = k_carry.transpose(-1, -2) @ v                                # (BH, N, K, K)
    states, s = [], torch.zeros((bh, kk, kk))
    for i in range(n):
        states.append(s)
        s = s * torch.exp(ltot[:, i])[:, :, None] + upd[:, i]
    states = torch.stack(states, dim=1)                                # S_n
    ri = r * torch.exp(lcum_inc - lw)
    kj = k * torch.exp(torch.clamp(-lcum_inc, -CLAMP, CLAMP))
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool), -1)
    scores = torch.where(mask, ri @ kj.transpose(-1, -2), 0.0)
    diag = torch.sum(r * (k * u.float()[:, None, None, :]), dim=3, keepdim=True)
    out = (scores @ v + diag * v) + ri @ states
    return out.reshape(bh, n * chunk, kk)[:, :t]


@pytest.mark.parametrize("bh,t,kk,chunk,shift", [
    (2, 64, 32, 16, -4.0),     # the reference tests' shapes
    (3, 128, 64, 32, -4.0),
    (1, 256, 64, 128, -4.0),
    (2, 128, 16, 128, -4.0),
    (2, 96, 64, 64, -4.0),     # ragged T
    (3, 100, 16, 32, -4.0),
    (2, 256, 32, 64, -1.0),    # strong decay: the ±30 clamps bite
    (2, 200, 64, 128, -1.0),   # ragged, strong decay
    (2, 512, 16, 16, -1.0),    # 32 chunks of 16
    (2, 100, 16, 8, -1.0),     # chunk 8, the reduced configs', ragged
])
def test_split_model_matches_plain_and_pallas(bh, t, kk, chunk, shift):
    arrays = _inputs((bh, t, kk), (bh, kk), seed=t * kk + chunk, decay_shift=shift)
    got = _split_model(*_torch(arrays), chunk=chunk)
    want = wkv_plain(*_torch(arrays), chunk=chunk)
    wkv_close(got, want)
    pad = (-t) % chunk
    padded = [np.pad(a, ((0, 0), (0, pad), (0, 0))) for a in arrays[:4]] + [arrays[4]]
    pallas = np.asarray(wkv_pallas(*_jax(padded), chunk=chunk))[:, :t]
    wkv_close(got, torch.from_numpy(pallas.copy()))
