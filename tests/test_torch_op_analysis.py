"""The port's ATen-op analysis (``repro_torch/launch/op_analysis.py``)
against analytic values and the JAX package's HLO analysis on the same
functions: ``tests/test_hlo_analysis.py``'s four cases, each with a Python
loop where the reference has ``lax.scan`` (the port runs eagerly, so a
loop dispatches every iteration); FLOPs exact against the analytic value
and within the JAX test's own margins of ``repro.launch.hlo_analysis``'s.
Then a reduced train step's matmul FLOPs against ``FlopCounterMode``,
composites under inference mode, the kernels' reports and the live-bytes
high-water mark."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch.hlo_analysis import analyze as jax_analyze  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attn.kernel import flash_attention_cuda, flash_work  # noqa: E402
from repro_torch.kernels.wkv.kernel import wkv_cuda, wkv_work  # noqa: E402
from repro_torch.launch.op_analysis import OpAnalysis, analyze  # noqa: E402
from repro_torch.launch.steps import StepOptions, init_train_state, make_train_step  # noqa: E402


def _compile_text(fn, *args):
    return jax.jit(fn).lower(*args).compile().as_text()


def _loop(x, w, trips):
    for _ in range(trips):
        x = x @ w
    return x


def test_loop_trip_count_scaling():
    """FLOPs of a looped matmul scale with the trip count (the reference's
    scan), exactly."""
    w = torch.ones((64, 64))
    x = torch.ones((64, 64))
    a8 = analyze(_loop, x, w, 8)[1]
    a16 = analyze(_loop, x, w, 16)[1]
    one_matmul = 2 * 64 * 64 * 64
    assert a8.flops == 8 * one_matmul
    assert a16.flops == 2 * a8.flops

    jw = jnp.ones((64, 64), jnp.float32)

    def f_scan(x, trips):
        def body(c, _):
            return c @ jw, None
        out, _ = jax.lax.scan(body, x, None, length=trips)
        return out

    j8 = jax_analyze(_compile_text(lambda x: f_scan(x, 8), jnp.ones((64, 64), jnp.float32)))
    assert a8.flops >= j8.flops * 0.9 and j8.flops >= a8.flops * 0.9


def test_plain_dot_flops():
    a, b = torch.ones((128, 256)), torch.ones((256, 64))
    out = analyze(lambda a, b: a @ b, a, b)[1]
    want = 2 * 128 * 64 * 256
    assert out.flops == want
    j = jax_analyze(_compile_text(lambda a, b: a @ b, jnp.ones((128, 256)), jnp.ones((256, 64))))
    assert abs(out.flops - j.flops) / j.flops < 0.05


def test_nested_loop_multiplies():
    w = torch.ones((32, 32))

    def f(x):
        for _ in range(3):
            for _ in range(4):
                x = x @ w
        return x

    out = analyze(f, torch.ones((32, 32)))[1]
    want = 12 * 2 * 32 ** 3
    assert out.flops == want
    jw = jnp.ones((32, 32), jnp.float32)

    def jf(x):
        def outer(c, _):
            def inner(ci, _):
                return ci @ jw, None
            c, _ = jax.lax.scan(inner, c, None, length=4)
            return c, None
        out, _ = jax.lax.scan(outer, x, None, length=3)
        return out

    j = jax_analyze(_compile_text(jf, jnp.ones((32, 32), jnp.float32)))
    assert out.flops >= j.flops * 0.9 and j.flops >= want * 0.9


def test_hbm_bytes_nonzero():
    a = torch.ones((256, 256))
    out = analyze(lambda a: torch.tanh(a) + 1.0, a)[1]
    assert out.hbm_bytes == 4 * 256 * 256 * 4    # tanh: read + write; add: read + write
    j = jax_analyze(_compile_text(lambda a: jnp.tanh(a) + 1.0, jnp.ones((256, 256))))
    assert j.hbm_bytes >= 2 * 256 * 256 * 4 and out.hbm_bytes >= j.hbm_bytes


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "olmoe-1b-7b", "rwkv6-3b"])
def test_train_step_matmul_flops_equal_flop_counter(arch):
    """A reduced train step (forward, backward with the CE chunks'
    recompute, AdamW): the analysis's matmul FLOPs are FlopCounterMode's."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = get_config(arch).reduced()
    params, opt = init_train_state(cfg, device="cpu")
    tok = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 32)),
                          dtype=torch.int32)
    batch = {"tokens": tok, "labels": tok}
    counter = FlopCounterMode(display=False)
    with counter, OpAnalysis() as mode:
        make_train_step(cfg, None, StepOptions(ce_chunk=16))(params, opt, batch)
    assert mode.result.aten_flops == mode.result.flops == counter.get_total_flops() > 0


def test_composites_under_inference_mode_are_counted():
    """Under inference mode matmul and einsum reach the mode whole; their
    products are counted as without it."""
    x, w = torch.ones((2, 3, 4)), torch.ones((4, 5))

    def f():
        return x @ w, torch.einsum("bsd,de->bse", x, w)

    want = 2 * (2 * 2 * 3 * 5 * 4)
    assert analyze(f)[1].flops == want
    with torch.inference_mode():
        assert analyze(f)[1].flops == want


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_kernels_report_their_work_and_hide_their_ops(device):
    """flash_attn and wkv count one launch each with their own FLOPs and
    bytes, on the CPU (the plain version runs unseen) and on meta, where
    nothing runs; the card's launch counters do not move."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g).to(device) for s in ((4, 40, 16), (2, 40, 16),
                                                               (2, 40, 16)))
    r, kk, vv = (torch.randn((2, 24, 16), generator=g).to(device) for _ in range(3))
    lw = -torch.rand((2, 24, 16), generator=g).to(device)
    u = torch.randn((2, 16), generator=g).to(device)
    before = (flash_attention_cuda.launches, wkv_cuda.launches)
    with OpAnalysis() as mode:
        out = flash_attention_cuda(q, k, v, causal=True, sm_scale=0.25, window=8)
        o2 = wkv_cuda(r, kk, vv, lw, u, chunk=8)
    a = mode.result
    assert out.shape == q.shape and out.dtype == q.dtype and out.device.type == device
    assert o2.shape == r.shape and o2.device.type == device
    assert a.kernel_launches == {"flash_attn": 1, "wkv": 1}
    assert a.kernel_flops["flash_attn"] == flash_work(q, k, True, 8)[0]
    assert a.kernel_flops["wkv"] == wkv_work(r, 8)[0]
    assert a.aten_flops == 0 and a.flops == sum(a.kernel_flops.values())
    assert a.ops == 0 and a.hbm_bytes == flash_work(q, k, True, 8)[1] + wkv_work(r, 8)[1]
    assert (flash_attention_cuda.launches, wkv_cuda.launches) == before


def test_peak_live_bytes_follows_the_results():
    """The high-water mark of the storage the call's results hold: views
    keep their base alive, freed results release theirs."""
    def f():
        a = torch.ones(1000)            # 4,000 B
        b = a * 2                       # 8,000
        c = b[:500]                     # a view: nothing new
        del b
        d = c * 3                       # 10,000 (b lives on through c)
        del c, d                        # back to 4,000
        e = a + 1                       # 8,000
        return a, e

    out, a = analyze(f)
    assert a.peak_live_bytes == 10_000
    del out


def test_analyses_do_not_nest_and_idle_wrappers_skip_the_count():
    """Entering an analysis inside another raises (the outer one would see
    the inner's ops and none of its kernels); with none listening a
    wrapper's context is the shared do-nothing one and its work is never
    computed."""
    from repro_torch.kernels import _build

    with OpAnalysis():
        with pytest.raises(RuntimeError, match="do not nest"):
            with OpAnalysis():
                pass
        torch.ones(4) @ torch.ones(4)          # the outer one still listens
    assert _build.RECORDERS == []

    def never(*_):
        raise AssertionError("work computed with no analysis listening")

    assert _build.analysed("flash_attn", True, never) is _build.analysed("wkv", True, never)
    with _build.analysed("flash_attn", True, never):
        pass
    with OpAnalysis() as mode:
        with _build.analysed("wkv", True, lambda n: (n, 2 * n), 8):
            torch.ones(4) * 2                  # unseen: the kernel's own op
    assert mode.result.kernel_launches == {"wkv": 1} and mode.result.ops == 0
    assert (mode.result.flops, mode.result.hbm_bytes) == (8, 16)
