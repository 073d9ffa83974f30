"""The LM half of the port's ``launch/sharding.py`` against the JAX
package's on the CPU: every parameter's spec of every registered arch at
full width (the JAX leaves from ``jax.eval_shape`` of ``init_params``, the
port's from ``LM(cfg, device="meta")`` mapped back to the JAX paths and
stacked shapes), the batch and cache specs, and the activation and named
constraints' specs, on the meshes (2, 2), (4, 2), (16, 16) and, with a
``pod`` axis, (2, 16, 16), in the three modes.  The reference's spec
functions read only ``mesh.shape`` and ``mesh.axis_names``, so a stand-in
mesh object serves both packages; the JAX constraints are read by
catching the spec they pass to ``with_sharding_constraint``."""
import functools
import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import all_arch_names  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.launch import sharding as JSH  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.checkpoint.ckpt import leaf_paths  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import stacked_leaves  # noqa: E402

MESHES = {"2x2": {"data": 2, "model": 2}, "4x2": {"data": 4, "model": 2},
          "16x16": {"data": 16, "model": 16}, "pod2x16x16": {"pod": 2, "data": 16, "model": 16}}
MODES = ("2d", "fsdp", "2d_etp")


def _mesh(name):
    shape = MESHES[name]
    return types.SimpleNamespace(shape=dict(shape), axis_names=tuple(shape))


def _spec(p):
    return None if p is None else tuple(p)


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    """{keystr: shape} of the JAX ``init_params`` tree at full width."""
    tree = jax.eval_shape(lambda: JM.init_params(jax.random.key(0), jax_get_config(arch)))
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(kp): tuple(leaf.shape) for kp, leaf in flat}


@functools.lru_cache(maxsize=None)
def port_model(arch):
    return M.LM(get_config(arch), device="meta")


@pytest.mark.parametrize("arch", all_arch_names())
def test_the_ports_stacked_leaves_are_the_jax_trees(arch):
    named = dict(port_model(arch).named_parameters())
    got = {SH.keystr(path): shape for path, shape in stacked_leaves(named).items()}
    assert got == jax_params(arch)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", all_arch_names())
def test_param_specs_equal_the_references(arch, mesh):
    """Every leaf in every mode; the per-name specs (param_specs, what the
    placement reads) are their stacked leaf's."""
    m = _mesh(mesh)
    model = port_model(arch)
    sharded = 0
    for mode in MODES:
        want = {path: _spec(JSH.param_spec(path, shape, m, mode))
                for path, shape in jax_params(arch).items()}
        got = {SH.keystr(path): spec
               for path, spec in SH.param_shardings(model, m, mode).items()}
        assert got == want, mode
        for name, (spec, shape, index) in SH.param_specs(model, m, mode).items():
            path = SH.keystr(SH._jax_path(name)[0])
            assert spec == want[path] and shape == jax_params(arch)[path], (name, mode)
            assert len(index) <= len(shape)
        sharded += sum(any(e is not None for e in s) for s in want.values())
    assert sharded > 0


def test_param_spec_cases():
    """A few leaves by hand (the rules' branches), and the tuple form."""
    m = _mesh("2x2")
    cases = [("['embed']", (512, 256)), ("['lm_head']", (256, 512)),
             ("['stack']['attn']['w_o']", (2, 256, 256)), ("['stack']['mlp']['w_gate']", (2, 4, 64, 256)),
             ("['stack']['ln1']['scale']", (28, 1024)), ("['final_norm']['scale']", (1 << 17,)),
             ("['stack']['mlp']['w_up']", (2, 256, 512)), ("['pos_embed']", (32768, 1024))]
    for path, shape in cases:
        for mode in MODES:
            assert SH.param_spec(path, shape, m, mode) == _spec(JSH.param_spec(path, shape, m,
                                                                              mode)), (path, mode)
    assert SH.param_spec("['embed']", (512, 256), m) == ("model", "data")
    assert SH.param_spec("['x']", (255, 256), m) == (None, None)     # below REPLICATE_BELOW
    assert SH.REPLICATE_BELOW == JSH.REPLICATE_BELOW
    assert SH.opt_shardings({"a": ("data",)}, m) == {"m": {"a": ("data",)}, "v": {"a": ("data",)},
                                                      "step": ()}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_specs_equal_the_references(mesh):
    m = _mesh(mesh)
    for mode in MODES:
        for b in (1, 2, 3, 4, 6, 8, 16, 24, 32, 64, 256, 512, 1024):
            for shape in ((b,), (b, 128), (b, 16, 64)):
                assert SH.batch_spec(shape, m, mode) == _spec(JSH.batch_spec(shape, m, mode)), (
                    shape, mode)
        assert SH.batch_spec((), m, mode) == _spec(JSH.batch_spec((), m, mode)) == ()
    batch = {"tokens": np.zeros((32, 16), np.int32), "labels": np.zeros((32, 16), np.int32)}
    assert SH.batch_shardings(batch, m) == {k: SH.batch_spec((32, 16), m) for k in batch}


@pytest.mark.parametrize("arch", all_arch_names())
def test_cache_specs_equal_the_references(arch):
    """The serving cache of every arch at full width (batch 32, 1,024
    positions): the leaves' paths and shapes and each leaf's spec."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    for batch in (1, 32):
        tree = jax.eval_shape(lambda: JM.make_serve_cache(jcfg, batch, 1024))
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        want_leaves = {jax.tree_util.keystr(kp): tuple(leaf.shape) for kp, leaf in flat}
        cache = M.make_serve_cache(cfg, batch, 1024, device="meta")
        got_leaves = {path: tuple(leaf.shape) for path, leaf in leaf_paths(cache)}
        assert got_leaves == want_leaves
        for mesh in MESHES:
            m = _mesh(mesh)
            got = SH.cache_shardings(cache, m, batch)
            for path, shape in want_leaves.items():
                assert got[path] == _spec(JSH.cache_spec(path, shape, m, batch)), (path, mesh)
                assert SH.cache_spec(path, shape, m) == _spec(JSH.cache_spec(path, shape, m))


def _caught(monkeypatch, fn, *args):
    """The spec the JAX constraint ``fn`` passes to with_sharding_constraint
    on ``args``, or None if it passes the tensor through untouched."""
    seen = []
    monkeypatch.setattr(JSH, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", lambda x, s: seen.append(s) or x)
    fn(*args)
    assert len(seen) <= 1
    return _spec(seen[0]) if seen else None


def _tensor(shape):
    return np.broadcast_to(np.float32(0), shape)   # any shape, no memory


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_activation_constraints_give_the_references_specs(mesh, monkeypatch):
    m = _mesh(mesh)
    shapes = [(b, s, 64) for b in (1, 2, 4, 6, 16, 32, 512) for s in (1, 2, 8, 16, 24, 4096)]
    shapes += [(4, 16), (2, 4, 16, 64)]
    for mode in MODES:
        for seq_shard in (True, False):
            jfn = JSH.make_activation_constraint(m, seq_shard, mode)
            fn = SH.make_activation_constraint(m, seq_shard, mode)
            for shape in shapes:
                assert fn.spec(shape) == _caught(monkeypatch, jfn, _tensor(shape)), (
                    shape, mode, seq_shard)
        jfn, fn = JSH.make_named_constraint(m, mode), SH.make_named_constraint(m, mode)
        for kind in ("moe_dispatch", "moe_expert", "moe_out", "other"):
            for shape in ((2, 16, 4, 8), (32, 16, 64, 8), (32, 64, 8, 64), (16, 32, 64),
                          (512, 4, 4, 4), (3, 4, 32, 2)):
                assert fn.spec(shape, kind) == _caught(monkeypatch, jfn, _tensor(shape), kind), (
                    shape, kind, mode)


def test_the_installed_hooks_check_the_device_and_keep_the_values():
    mesh = make_host_mesh(2, 2, devices="cpu")
    x = torch.randn(4, 8, 16)
    act = SH.make_activation_constraint(mesh, device="cpu")
    named = SH.make_named_constraint(mesh, device="cpu")
    assert act(x) is x and named(x, "moe_out") is x
    assert act.spec(tuple(x.shape)) == ("data", "model", None)
    assert SH.make_activation_constraint(mesh)(x) is x          # no device: no check
    for hook in (SH.make_activation_constraint(mesh, device="meta"),
                 lambda t: SH.make_named_constraint(mesh, device="meta")(t, "moe_out")):
        with pytest.raises(RuntimeError, match="batch slice on meta"):
            hook(x)


def test_keystr_is_jax_keystr():
    tree = {"stack": {"units": {"mix": [{"w_x": 0}, {"w_x": 1}]}, "tail": [{"mix": {"w": 2}}]},
            "embed": 3}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    want = sorted(jax.tree_util.keystr(kp) for kp, _ in flat)
    got = sorted(SH.keystr(p) for p in ("stack/units/mix/0/w_x", "stack/units/mix/1/w_x",
                                        "stack/tail/0/mix/w", "embed"))
    assert got == want
