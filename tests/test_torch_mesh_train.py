"""The port's train step over a mesh (src/repro_torch/launch/steps.py,
placement.py) against the JAX package's single-device ``make_train_step``
on the CPU, on ``make_host_mesh(..., devices="cpu")`` meshes (every
position the CPU): 4 steps of batch 4 x 16 from the same weights (the
JAX ``init_train_state`` tree, perturbed, through ``params_from_jax``),
held by ``testing.train_close`` (the metrics within TRAIN_METRIC_RTOL,
the parameters within one Adam step a step).  Configs: qwen3-0.6b reduced
(every leaf below REPLICATE_BELOW: all replicated), a widened qwen3 (d
256, ff 512, vocab 512: the embedding and the stacked projections shard),
olmoe-1b-7b reduced (the global balance loss and whole groups; its expert
stacks shard), with "fsdp", "2d_etp", microbatch 2 and remat runs.  Then
each position's blocks against the JAX ``param_shardings`` placement on 8
forced host devices (a subprocess), a state carried across mesh shapes,
and the elastic restores of ``launch/train.py::main``."""
import contextlib
import dataclasses
import functools
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.sharding import keystr  # noqa: E402
from repro_torch.launch.placement import (  # noqa: E402
    MeshParams,
    gather_train_state,
    place_train_state,
    restore_train_state,
)
from repro_torch.launch.steps import StepOptions, make_train_step  # noqa: E402
from repro_torch.models.convert import _flatten, _jax_path, params_from_jax  # noqa: E402
from repro_torch.optim.adamw import adamw_init  # noqa: E402
from repro_torch.testing import train_batches, train_close  # noqa: E402
from util_lm import np_tree, perturbed  # noqa: E402
from util_subproc import run_with_devices  # noqa: E402

B, SEQ, CE_CHUNK, STEPS = 4, 16, 8, 4
VARIANTS = {   # name: (arch, changes to its reduced config)
    "qwen3": ("qwen3-0.6b", {}),
    "qwen3-wide": ("qwen3-0.6b", dict(d_model=256, d_ff=512, vocab_size=512)),
    "olmoe": ("olmoe-1b-7b", {}),
    "olmoe-remat": ("olmoe-1b-7b", dict(remat=True)),
}


def _cfg(variant, jax_cfg=False):
    arch, changes = VARIANTS[variant]
    return dataclasses.replace((jax_get_config if jax_cfg else get_config)(arch).reduced(),
                               **changes)


def _batches(cfg):
    return train_batches(cfg, STEPS, B, SEQ)


@functools.lru_cache(maxsize=None)
def reference(variant, microbatch=0):
    """The JAX state (perturbed), and 4 single-device steps' metrics and
    parameters."""
    jcfg = _cfg(variant, jax_cfg=True)
    params, opt = JS.init_train_state(jcfg, jax.random.key(3))
    tree = perturbed(np_tree(params), 7, scale=0.02)
    params = jax.tree.map(jnp.asarray, tree)
    step = jax.jit(JS.make_train_step(jcfg, None, JS.StepOptions(ce_chunk=CE_CHUNK,
                                                                 microbatch=microbatch)))
    metrics = []
    for b in _batches(jcfg):
        params, opt, m = step(params, opt, jax.tree.map(jnp.asarray, b))
        metrics.append({k: float(v) for k, v in m.items()})
    return tree, metrics, dict(_flatten(np_tree(params)))


def _by_port_name(names, leaves):
    out = {}
    for name in names:
        path, index = _jax_path(name)
        out[name] = torch.from_numpy(np.array(leaves[path][index]))
    return out


def mesh_run(variant, shape, mode="2d", microbatch=0):
    """The port's mesh step on the JAX state: (MeshParams, opt, metrics)."""
    tree = reference(variant, microbatch)[0]
    cfg = _cfg(variant)
    model = params_from_jax(tree, cfg, device="cpu", kernels=False, master=True)
    mesh = make_host_mesh(*shape, devices="cpu")
    params, opt = place_train_state(model, adamw_init(model), mesh, mode)
    step = make_train_step(cfg, mesh, StepOptions(ce_chunk=CE_CHUNK, microbatch=microbatch,
                                                  sharding_mode=mode))
    metrics = []
    for b in _batches(cfg):
        params, opt, m = step(params, opt, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return params, opt, metrics


CASES = [("qwen3", (2, 2), "2d", 0), ("qwen3", (4, 1), "2d", 0), ("qwen3", (1, 2), "2d", 0),
         ("qwen3-wide", (2, 2), "2d", 0), ("qwen3-wide", (4, 1), "2d", 0),
         ("qwen3-wide", (1, 2), "2d", 0), ("qwen3-wide", (2, 2), "fsdp", 0),
         ("olmoe", (2, 2), "2d", 0), ("olmoe", (4, 1), "2d", 0), ("olmoe", (1, 2), "2d", 0),
         ("olmoe", (2, 2), "2d_etp", 0), ("olmoe", (2, 2), "2d", 2), ("olmoe-remat", (4, 1), "2d", 0)]


@pytest.mark.parametrize("variant,shape,mode,microbatch", CASES,
                         ids=[f"{v}-{s[0]}x{s[1]}-{m}-mb{b}" for v, s, m, b in CASES])
def test_mesh_step_matches_the_jax_single_device_step(variant, shape, mode, microbatch):
    tree, want_metrics, want_leaves = reference(variant, microbatch)
    params, opt, got = mesh_run(variant, shape, mode, microbatch)
    whole, whole_opt = gather_train_state(params, opt)
    train_close(whole, got, _by_port_name(whole, want_leaves), want_metrics)
    assert int(whole_opt["step"]) == STEPS and all(int(s) == STEPS for s in opt["step"])
    if microbatch:
        assert all(m["aux"] == m["tokens"] == 0.0 for m in got)
    elif variant.startswith("olmoe"):
        assert all(m["aux"] > 0 for m in got)      # the balance loss is in
    # replicated copies stay equal: every position holding a box holds the same bits
    for name, boxes in params.boxes.items():
        seen = {}
        for p, box in enumerate(boxes):
            if box is not None:
                key = tuple((s.start, s.stop) for s in box)
                if key in seen:
                    assert torch.equal(params.blocks[name][p], seen[key]), name
                seen[key] = params.blocks[name][p]
    sharded = [n for n, bl in params.blocks.items()
               if any(b is not None and tuple(b.shape) != params.shapes[n] for b in bl)]
    if variant == "qwen3":
        assert sharded == []         # every leaf below REPLICATE_BELOW
    elif shape != (1, 1):
        assert sharded, "the sharded path ran on no leaf"


PLACEMENT = """
import dataclasses
import numpy as np, jax
from repro.configs.base import get_config
from repro.launch.mesh import make_host_mesh
from repro.launch.sharding import param_shardings
from repro.models import model as JM
cfg = dataclasses.replace(get_config('qwen3-0.6b').reduced(), d_model=256, d_ff=512,
                          vocab_size=512)
ecfg = get_config('olmoe-1b-7b').reduced()
out = {}
for tag, c, shape, mode in (("wide-2x2-2d", cfg, (2, 2), "2d"), ("wide-4x2-2d", cfg, (4, 2), "2d"),
                            ("wide-2x2-fsdp", cfg, (2, 2), "fsdp"),
                            ("olmoe-2x2-2d", ecfg, (2, 2), "2d"),
                            ("olmoe-4x2-2d_etp", ecfg, (4, 2), "2d_etp")):
    mesh = make_host_mesh(*shape)
    params = JM.init_params(jax.random.key(0), c)
    placed = jax.device_put(params, param_shardings(params, mesh, mode))
    flat, _ = jax.tree_util.tree_flatten_with_path(placed)
    devs = list(mesh.devices.reshape(-1))
    for kp, arr in flat:
        path = jax.tree_util.keystr(kp)
        for sh in arr.addressable_shards:
            pos = devs.index(sh.device)
            lo = [0 if s.start is None else s.start for s in sh.index]
            key = f"{tag}|{path}|{pos}"
            out[key + "|data"] = np.asarray(sh.data)
            out[key + "|lo"] = np.asarray(lo, np.int64)
np.savez(OUT, **out)
print("PLACED", len(out))
"""


def test_each_position_holds_exactly_its_block(tmp_path):
    """The JAX ``param_shardings`` placement on 8 forced host devices, shard
    by shard, against the port's blocks of the same weights: a position
    holds a per-layer piece's block iff the JAX shard's box holds that
    layer, and then the same values bit for bit."""
    out = str(tmp_path / "placed.npz")
    assert "PLACED" in run_with_devices(f"OUT = {out!r}\n" + PLACEMENT, n_devices=8)
    placed = np.load(out)
    checked = 0
    for tag, variant in (("wide-2x2-2d", "qwen3-wide"), ("wide-4x2-2d", "qwen3-wide"),
                         ("wide-2x2-fsdp", "qwen3-wide"), ("olmoe-2x2-2d", "olmoe"),
                         ("olmoe-4x2-2d_etp", "olmoe")):
        _, shape, mode = tag.split("-")
        shape = tuple(int(x) for x in shape.split("x"))
        jcfg, cfg = _cfg(variant, jax_cfg=True), _cfg(variant)
        tree = np_tree(JM.init_params(jax.random.key(0), jcfg))
        model = params_from_jax(tree, cfg, device="cpu", kernels=False, master=True)
        mp = MeshParams(model, make_host_mesh(*shape, devices="cpu"), mode)
        for name, blocks in mp.blocks.items():
            path, index = _jax_path(name)
            for pos, block in enumerate(blocks):
                key = f"{tag}|{keystr(path)}|{pos}"
                data, lo = placed[key + "|data"], placed[key + "|lo"]
                k = len(index)
                inside = all(lo[a] <= index[a] < lo[a] + data.shape[a] for a in range(k))
                if not inside:
                    assert block is None, (tag, name, pos)
                    continue
                want = data[tuple(i - lo[a] for a, i in enumerate(index))]
                assert block is not None and block.shape == want.shape, (tag, name, pos)
                assert np.array_equal(block.numpy(), want), (tag, name, pos)
                box = mp.boxes[name][pos]
                assert [s.start for s in box] == list(lo[k:]), (tag, name, pos)
                checked += 1
    assert checked > 0


def test_a_state_crosses_mesh_shapes_bit_for_bit():
    """Placed on (4, 2) after 2 steps, gathered, restored into a (2, 2)
    state and a (1, 1) model: the same whole leaves bit for bit; the next
    steps on (2, 2) and on one device then agree within train_close."""
    variant = "qwen3-wide"
    cfg = _cfg(variant)
    tree = reference(variant)[0]
    batches = _batches(cfg)
    opts = StepOptions(ce_chunk=CE_CHUNK)

    def fresh(shape):
        model = params_from_jax(tree, cfg, device="cpu", kernels=False, master=True)
        if shape == (1, 1):
            return model, adamw_init(model), make_train_step(cfg, None, opts)
        mesh = make_host_mesh(*shape, devices="cpu")
        return (*place_train_state(model, adamw_init(model), mesh), make_train_step(cfg, mesh,
                                                                                    opts))

    p42, o42, s42 = fresh((4, 2))
    for b in batches[:2]:
        p42, o42, _ = s42(p42, o42, b)
    whole, whole_opt = gather_train_state(p42, o42)
    p22, o22, s22 = fresh((2, 2))
    restore_train_state(p22, o22, whole, whole_opt)
    back, back_opt = gather_train_state(p22, o22)
    for n in whole:
        assert torch.equal(back[n], whole[n])
        assert torch.equal(back_opt["m"][n], whole_opt["m"][n])
        assert torch.equal(back_opt["v"][n], whole_opt["v"][n])
    assert int(back_opt["step"]) == 2
    p11, _, s11 = fresh((1, 1))
    with torch.no_grad():
        for n, p in p11.named_parameters():
            p.copy_(whole[n])
    o11 = {"m": {n: t.clone() for n, t in whole_opt["m"].items()},
           "v": {n: t.clone() for n, t in whole_opt["v"].items()}, "step": whole_opt["step"].clone()}
    got, want = [], []
    for b in batches[2:]:
        p22, o22, m = s22(p22, o22, b)
        got.append({k: float(v) for k, v in m.items()})
        p11, o11, m = s11(p11, o11, b)
        want.append({k: float(v) for k, v in m.items()})
    train_close(gather_train_state(p22, o22)[0], got, p11, want)


def test_moe_groups_that_straddle_slices_raise_and_so_does_an_unplaced_model():
    cfg = _cfg("olmoe")
    model = params_from_jax(reference("olmoe")[0], cfg, device="cpu", kernels=False, master=True)
    mesh = make_host_mesh(4, 1, devices="cpu")
    step = make_train_step(cfg, mesh, StepOptions(ce_chunk=6))
    # 4 x 6 = 24 tokens: groups of 12, slices of 6
    b = train_batches(cfg, 1, 4, 6)[0]
    with pytest.raises(TypeError, match="place_train_state"):
        step(model, adamw_init(model), b)
    params, opt = place_train_state(model, adamw_init(model), mesh)
    with pytest.raises(ValueError, match="MoE groups of 12 tokens.*slices of 6 tokens"):
        step(params, opt, b)
    # 4 x 8 = 32 tokens: groups of 16, slices of 8 on 4 positions (raise), of 16 on 2
    b = train_batches(cfg, 1, 4, 8)[0]
    with pytest.raises(ValueError, match="MoE groups of 16 tokens"):
        step(params, opt, b)
    mesh2 = make_host_mesh(2, 2, devices="cpu")
    params, opt = place_train_state(model, adamw_init(model), mesh2)
    _, _, m = make_train_step(cfg, mesh2, StepOptions(ce_chunk=8))(params, opt, b)
    assert np.isfinite(float(m["loss"]))


def _main(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert train.main(argv) == 0
    return buf.getvalue()


def _losses(out):
    got = {}
    for line in out.splitlines():
        if line.startswith("step "):
            parts = line.split()
            got[int(parts[1])] = float(parts[3])
    return got


@pytest.mark.parametrize("first", [("4", "2"), ("1", "1")])
def test_elastic_restore_across_mesh_sizes(first, tmp_path):
    """tests/test_distributed.py's case on the port: save on (4, 2) (or on
    one device), resume on (2, 2) in launch/train.py::main; the resumed
    steps' losses are the uninterrupted one-device run's (to the log's 4
    decimals, within 1e-4 of each other)."""
    base = ["--arch", "qwen1.5-0.5b", "--smoke", "--global-batch", "4", "--seq-len", "16",
            "--device", "cpu", "--log-every", "1"]
    ckpt = str(tmp_path / "ck")
    want = _losses(_main(base + ["--steps", "6"]))
    _main(base + ["--steps", "4", "--data-par", first[0], "--model-par", first[1],
                  "--ckpt-dir", ckpt, "--ckpt-every", "4"])
    out = _main(base + ["--steps", "6", "--data-par", "2", "--model-par", "2",
                        "--ckpt-dir", ckpt, "--resume", "auto"])
    assert "resumed from step 4" in out
    got = _losses(out)
    assert sorted(got) == [4, 5]
    for i in got:
        assert abs(got[i] - want[i]) <= 1.5e-4, (i, got[i], want[i])
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["steps"] == 6 and rec["failures"] == 0
    assert os.path.isdir(os.path.join(ckpt, "step_00000006"))
