"""The port's int8 compressed trainer (src/repro_torch/optim/compress.py
``psum_int8``, src/repro_torch/launch/compressed_train.py) against the JAX
package's on the CPU.

The JAX side runs once, in a subprocess with 4 forced host devices
(``tests/util_subproc.py::run_with_devices``): ``psum_int8`` under
``shard_map`` over 3 error-feedback steps on seeded per-shard gradients
(one leaf whose values sit on half-integer multiples of the scale, one
whose largest value is below the 1e-12 clamp), and
tests/test_compressed_train.py's run (qwen3-0.6b reduced, a (4, 1) mesh,
6 steps of batch 8 x 16) with and without compression.  The port must
give ``psum_int8``'s means and error buffers bit for bit; its compressed
trajectory must track its exact-sync one within 0.05 (the reference's
bound) and the JAX compressed trajectory within COMPRESSED_TOL; each
position keeps its own error buffer, and the JAX one read on the host is
shard 0's."""
import json
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.optim import compress as JC  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import make_lm_batch  # noqa: E402
from repro_torch.launch.compressed_train import (  # noqa: E402
    init_error,
    make_compressed_train_step,
)
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.steps import StepOptions  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.optim.adamw import adamw_init  # noqa: E402
from repro_torch.optim.compress import compressed_bytes, psum_int8  # noqa: E402
from util_lm import np_tree  # noqa: E402
from util_subproc import run_with_devices  # noqa: E402

SHARDS, EF_STEPS = 4, 3
# the JAX and the port's compressed runs start from the same weights and
# batches; their gradients differ by float rounding (~1e-6 relative), which
# can move an int8 code by one step where a value sits on a rounding
# boundary; error feedback carries that into the next step, so the losses
# differ by far less than one quantum of the loss's own change
COMPRESSED_TOL = 2e-4

JAX_RUN = """
import json
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.configs.base import get_config
from repro.data.pipeline import make_lm_batch
from repro.launch.compressed_train import make_compressed_train_step
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import StepOptions, init_train_state
from repro.optim.compress import psum_int8

mesh = make_host_mesh(4, 1)
grads = np.load(IN)
names = sorted({k.split("|")[1] for k in grads.files})

def f(g, e):
    g = jax.tree.map(lambda x: x[0], g)
    e = jax.tree.map(lambda x: x[0], e)
    red, ne = psum_int8(g, "data", e)
    return jax.tree.map(lambda x: x[None], red), jax.tree.map(lambda x: x[None], ne)

sm = jax.jit(compat.shard_map(f, mesh, in_specs=(P("data"), P("data")),
                              out_specs=(P("data"), P("data"))))
out = {}
err = {n: jnp.zeros(grads[f"0|{n}"].shape, jnp.float32) for n in names}
for step in range(EF_STEPS):
    g = {n: jnp.asarray(grads[f"{step}|{n}"]) for n in names}
    red, err = sm(g, err)
    for n in names:
        out[f"red|{step}|{n}"] = np.asarray(red[n])
        out[f"err|{step}|{n}"] = np.asarray(err[n])

cfg = get_config("qwen3-0.6b").reduced()
opts = StepOptions(ce_chunk=8)
traj = {}
for compress in (False, True):
    params, opt = init_train_state(cfg)
    e = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
    step = make_compressed_train_step(cfg, mesh, "data", opts, compress=compress)
    losses = []
    with mesh:
        for i in range(6):
            b = make_lm_batch(0, i, 8, 16, cfg.vocab_size)
            params, opt, e, m = step(params, opt, e, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
    traj[str(compress)] = losses
    if compress:
        leaf = e["embed"]
        shards = [np.asarray(s.data) for s in leaf.addressable_shards]
        out["err_host"] = np.asarray(leaf)
        out["err_shards"] = np.stack(shards)
np.savez(OUT, **out)
print("TRAJ" + json.dumps(traj))
"""


def _grads():
    """3 steps of per-shard gradients {name: (4, ...)}: "a" at scales 1 to
    1e-3 a shard, "b" below the 1e-12 clamp, "c" on half-integer multiples
    of its scale (amax 127: scale 1, round half to even), "d" plain."""
    rng = np.random.default_rng(0)
    out = {}
    for step in range(EF_STEPS):
        a = rng.standard_normal((SHARDS, 16, 8)) * np.array([1, 0.01, 3, 1e-3])[:, None, None]
        b = rng.standard_normal((SHARDS, 33)) * 1e-14
        c = rng.choice([0.5, 1.5, 2.5, -0.5, -2.5, 3.0, 126.5], size=(SHARDS, 4, 6))
        c[:, 0, 0] = 127.0
        d = rng.standard_normal((SHARDS, 2, 3, 5))
        for name, x in zip("abcd", (a, b, c, d)):
            out[f"{step}|{name}"] = x.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    d = tmp_path_factory.mktemp("compressed")
    grads = _grads()
    np.savez(d / "in.npz", **grads)
    code = (f"IN = {str(d / 'in.npz')!r}\nOUT = {str(d / 'out.npz')!r}\nEF_STEPS = {EF_STEPS}\n"
            + JAX_RUN)
    stdout = run_with_devices(code, n_devices=SHARDS)
    traj = json.loads(next(line for line in stdout.splitlines() if line.startswith("TRAJ"))[4:])
    return grads, dict(np.load(d / "out.npz")), traj


def test_psum_int8_is_the_references_bit_for_bit(jax_side):
    grads, out, _ = jax_side
    names = sorted({k.split("|")[1] for k in grads})
    err = None
    for step in range(EF_STEPS):
        per = [{n: torch.from_numpy(grads[f"{step}|{n}"][i].copy()) for n in names}
               for i in range(SHARDS)]
        red, err = psum_int8(per, err)
        for n in names:
            for i in range(SHARDS):
                assert np.array_equal(red[i][n].numpy(), out[f"red|{step}|{n}"][i]), (step, n, i)
                assert np.array_equal(err[i][n].numpy(), out[f"err|{step}|{n}"][i]), (step, n, i)
                assert red[i][n].dtype == err[i][n].dtype == torch.float32
    # the error buffers are one a shard: they differ
    assert not np.array_equal(err[0]["a"].numpy(), err[1]["a"].numpy())


def test_psum_int8_without_a_buffer_is_zeros():
    rng = np.random.default_rng(1)
    per = [{"x": torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))}
           for _ in range(2)]
    a, ea = psum_int8(per)
    b, eb = psum_int8(per, [{"x": torch.zeros(3, 5)} for _ in range(2)])
    for i in range(2):
        assert torch.equal(a[i]["x"], b[i]["x"]) and torch.equal(ea[i]["x"], eb[i]["x"])
    assert torch.equal(a[0]["x"], a[1]["x"])


def test_compressed_bytes_is_the_references():
    jcfg = jax_get_config("qwen3-0.6b").reduced()
    tree = jax.eval_shape(lambda: JS.init_train_state(jcfg)[0])
    model = params_from_jax(np_tree(JS.init_train_state(jcfg)[0]), get_config(
        "qwen3-0.6b").reduced(), device="cpu", kernels=False, master=True)
    want = JC.compressed_bytes(tree)
    assert compressed_bytes(dict(model.named_parameters())) == want
    assert compressed_bytes(list(model.parameters())) == want == sum(
        p.numel() for p in model.parameters())


def _port_run(compress):
    """tests/test_compressed_train.py's run on the port, from the JAX
    ``init_train_state`` weights: (losses, the last error buffers)."""
    jcfg, cfg = jax_get_config("qwen3-0.6b").reduced(), get_config("qwen3-0.6b").reduced()
    model = params_from_jax(np_tree(JS.init_train_state(jcfg)[0]), cfg, device="cpu",
                            kernels=False, master=True)
    opt = adamw_init(model)
    mesh = make_host_mesh(SHARDS, 1, devices="cpu")
    err = init_error(model, mesh)
    step = make_compressed_train_step(cfg, mesh, "data", StepOptions(ce_chunk=8),
                                      compress=compress)
    losses = []
    for i in range(6):
        model, opt, err, m = step(model, opt, err, make_lm_batch(0, i, 8, 16, cfg.vocab_size))
        assert sorted(m) == ["grad_norm", "loss", "lr"]
        losses.append(float(m["loss"]))
    return losses, err


def test_compressed_matches_exact_sync_and_the_jax_trajectory(jax_side):
    _, out, traj = jax_side
    exact, _ = _port_run(False)
    comp, err = _port_run(True)
    assert comp[-1] < comp[0], "compressed trainer must learn"
    assert all(abs(a - b) < 0.05 for a, b in zip(exact, comp)), (exact, comp)
    for got, key in ((exact, "False"), (comp, "True")):
        want = traj[key]
        assert max(abs(a - b) for a, b in zip(got, want)) <= COMPRESSED_TOL, (key, got, want)
    # the reference's err: one a device, its host read shard 0's
    assert np.array_equal(out["err_host"], out["err_shards"][0])
    assert not np.array_equal(out["err_shards"][0], out["err_shards"][1])
    assert len(err) == SHARDS
    assert not torch.equal(err[0]["embed"], err[1]["embed"])
    # the port's buffer i is JAX shard i's: where an int8 code moved by one
    # step (a value on a rounding boundary) the two differ by one quantum
    # (twice the largest |err|), elsewhere by float rounding
    quantum = 2.0 * float(np.abs(out["err_shards"]).max())
    for i in range(SHARDS):
        d = np.abs(err[i]["embed"].numpy() - out["err_shards"][i])
        assert float(d.max()) <= 1.01 * quantum, (i, float(d.max()), quantum)
        assert float((d > 1e-2 * quantum).mean()) < 1e-3, i
        other = np.abs(err[i]["embed"].numpy() - out["err_shards"][(i + 1) % SHARDS])
        assert float((other > 1e-2 * quantum).mean()) > 0.5, i


def test_the_compressed_step_refuses_a_mismatch():
    cfg = get_config("qwen3-0.6b").reduced()
    mesh = make_host_mesh(2, 1, devices="cpu")
    model = params_from_jax(np_tree(JS.init_train_state(jax_get_config(
        "qwen3-0.6b").reduced())[0]), cfg, device="cpu", kernels=False, master=True)
    step = make_compressed_train_step(cfg, mesh, "data", StepOptions(ce_chunk=8))
    b = make_lm_batch(0, 0, 3, 16, cfg.vocab_size)
    with pytest.raises(ValueError, match="does not split over 2 positions"):
        step(model, adamw_init(model), init_error(model, mesh), b)
    with pytest.raises(ValueError, match="1 error buffers for 2 positions"):
        step(model, adamw_init(model), init_error(model, mesh)[:1],
             make_lm_batch(0, 0, 4, 16, cfg.vocab_size))
    assert os.environ.get("XLA_FLAGS", "").count("device_count") == 0
