"""The port's dry-run tools against the JAX package's on the CPU:
``launch/shapes.py`` (every cell, verdict, input spec and abstract cache
leaf of 10 archs × 4 shapes against ``jax.eval_shape``'s),
``abstract_params`` / ``abstract_train_state`` (every leaf against the
JAX tree's), ``make_production_mesh``, ``models/model.py::loss_fn``; then
the dry run's predictions (``launch/dryrun.py``): the per-position
argument bytes of ``tests/test_distributed.py``'s mini production setup
against the JAX compile's ``memory_analysis``, the traced matmul FLOPs
against ``repro.launch.hlo_analysis`` on a one-device JAX compile of the
same step (every family within 2%; the gap is the JAX step's global-norm
dot products, 32,768 FLOPs at these sizes), the copies, state bytes and
FLOPs against a real step on a (2, 2) CPU mesh (dense, MoE, two
microbatches, audio, vision), a serving trace against the
same calls on the CPU, ``dryrun_ring`` against the ring's own copies, the
CLI, and the kernels' meta branches refusing what the card path refuses."""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import all_arch_names  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.launch import shapes as JSH  # noqa: E402
from repro.launch import steps as JST  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.checkpoint.ckpt import leaf_paths  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.paper_knn import JoinConfig  # noqa: E402
from repro_torch.kernels._build import KernelRefusal  # noqa: E402
from repro_torch.kernels.flash_attn.kernel import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.wkv.kernel import wkv_cuda  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import shapes as SH  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh  # noqa: E402
from repro_torch.launch.op_analysis import OpAnalysis  # noqa: E402
from repro_torch.launch.sharding import keystr  # noqa: E402
from repro_torch.launch.steps import StepOptions, abstract_train_state  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.launch.join_job import dryrun_ring  # noqa: E402
from repro_torch.models.convert import _jax_path, params_from_jax, stacked_leaves  # noqa: E402
from tests.util_subproc import run_with_devices  # noqa: E402

FAMILY_ARCHS = ("qwen3-0.6b", "olmoe-1b-7b", "rwkv6-3b", "recurrentgemma-2b",
                "llama-3.2-vision-11b", "whisper-medium")


def _dt(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def _spec_leaves(tree):
    """{path: (shape, dtype name)} of a tree of tensors or ShapeDtypeStructs."""
    if isinstance(tree, dict) and tree and all(hasattr(v, "shape") for v in tree.values()):
        return {k: (tuple(v.shape), _dt(v)) for k, v in tree.items()}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(kp): (tuple(v.shape), _dt(v)) for kp, v in flat}


@pytest.mark.parametrize("arch", all_arch_names())
def test_cells_and_input_specs_equal_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert list(SH.SHAPES) == list(JSH.SHAPES)
    for name, cell in SH.SHAPES.items():
        jcell = JSH.SHAPES[name]
        assert dataclasses.asdict(cell) == dataclasses.asdict(jcell)
        assert SH.cell_supported(cfg, cell) == JSH.cell_supported(jcfg, jcell)
        got, want = SH.input_specs(cfg, cell), JSH.input_specs(jcfg, jcell)
        assert got.keys() == want.keys()
        if cell.kind == "decode":
            assert got["pos"] == cell.seq_len - 1
            assert tuple(want["pos"].shape) == () and _dt(want["pos"]) == "int32"
            cache = {p: (tuple(x.shape), _dt(x)) for p, x in leaf_paths(got["cache"])}
            assert cache == _spec_leaves(want["cache"])
            assert all(x.is_meta for _, x in leaf_paths(got["cache"]))
            got, want = {"token": got["token"]}, {"token": want["token"]}
        assert _spec_leaves(got) == _spec_leaves(want)
        assert all(x.is_meta for x in got.values())
        abstract = {p: (tuple(x.shape), _dt(x)) for p, x in
                    leaf_paths(SH.abstract_cache(cfg, cell))}
        assert abstract == _spec_leaves(JSH.abstract_cache(jcfg, jcell))


@functools.lru_cache(maxsize=None)
def _jax_train_state(arch):
    params, opt = JST.abstract_train_state(jax_get_config(arch))
    return _spec_leaves(params), _spec_leaves(opt)


def _stacked(named):
    """{JAX keystr: (stacked shape, dtype)} of port names -> tensors."""
    dts = {keystr(_jax_path(name)[0]): _dt(p) for name, p in named.items()}
    return {keystr(path): (shape, dts[keystr(path)])
            for path, shape in stacked_leaves(named).items()}


@pytest.mark.parametrize("arch", all_arch_names())
def test_abstract_params_and_train_state_equal_jax(arch):
    """Every leaf by its JAX path, of the same shape: the serving model's
    dtype the JAX leaf's, or the compute dtype where the JAX leaf is f32
    (the port stores each weight in the dtype of its use,
    ``models/layers.py``); the train state's parameters the f32 masters
    (f32 where the JAX leaf is bf16), m and v as the JAX ones, step int32."""
    cfg = get_config(arch)
    want = _spec_leaves(JM.abstract_params(jax_get_config(arch)))
    model = M.abstract_params(cfg)
    named = dict(model.named_parameters())
    assert all(p.is_meta for p in named.values())
    got = _stacked(named)
    assert {k: s for k, (s, _) in got.items()} == {k: s for k, (s, _) in want.items()}
    for path, (_, dt) in got.items():
        assert dt == want[path][1] or (dt, want[path][1]) == (cfg.dtype, "float32"), path
    params, opt = abstract_train_state(cfg)
    jparams, jopt = _jax_train_state(arch)
    got = _stacked(dict(params.named_parameters()))
    assert {k: s for k, (s, _) in got.items()} == {k: s for k, (s, _) in jparams.items()}
    for path, (_, dt) in got.items():
        assert dt == "float32" and jparams[path][1] in ("float32", "bfloat16"), path
    for key in ("m", "v"):
        mine = _stacked(opt[key])
        theirs = {k.removeprefix(f"['{key}']"): v for k, v in jopt.items()
                  if k.startswith(f"['{key}']")}
        assert mine == theirs
    assert jopt["['step']"] == ((), "int32") and opt["step"].dtype == torch.int32


def test_production_mesh():
    mesh = make_production_mesh()
    assert mesh.axis_names == ("data", "model") and mesh.shape == {"data": 16, "model": 16}
    assert all(d.type == "meta" for d in mesh.devices.reshape(-1))
    pod = make_production_mesh(multi_pod=True)
    assert pod.axis_names == ("pod", "data", "model")
    assert pod.shape == {"pod": 2, "data": 16, "model": 16}
    cpu = make_production_mesh(devices="cpu")
    assert {d.type for d in cpu.devices.reshape(-1)} == {"cpu"}
    listed = make_production_mesh(devices=[torch.device("cpu")] * 256)
    assert listed.devices.shape == (16, 16)
    with pytest.raises(ValueError, match="need 256 devices, have 4"):
        make_production_mesh(devices=["cpu"] * 4)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b"])
def test_loss_fn_matches_jax(arch):
    """The full-logits CE + 0.01·aux (a MoE: aux is not 0) on the JAX
    init, at 1e-6."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    tree = jax.tree.map(np.asarray, JM.init_params(jax.random.key(3), jcfg))
    model = params_from_jax(tree, cfg, device="cpu", kernels=False)
    rng = np.random.default_rng(4)
    tok = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    lab = np.where(rng.random((2, 16)) < 0.2, -1, np.roll(tok, -1, 1)).astype(np.int32)
    loss = jax.jit(JM.loss_fn, static_argnums=1)
    want, wm = loss(tree, jcfg, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)})
    with torch.no_grad():
        got, gm = M.loss_fn(model, cfg, {"tokens": torch.from_numpy(tok),
                                          "labels": torch.from_numpy(lab)})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)
    for key in ("ce", "aux", "tokens"):
        np.testing.assert_allclose(float(gm[key]), float(wm[key]), rtol=1e-6, atol=1e-6)


@pytest.mark.subproc
def test_argument_bytes_equal_the_jax_compile():
    """tests/test_distributed.py::test_mini_dryrun_production_shards's
    setup: reduced qwen3-0.6b on 4 × 4, batch 16 × 64, ce_chunk 16.  A
    position's blocks of parameters, m and v, the step count and its batch
    slice are the JAX program's arguments a device."""
    out = run_with_devices("""
import jax, jax.numpy as jnp
from repro import compat
from repro.configs.base import get_config
from repro.launch.sharding import batch_shardings, opt_shardings, param_shardings
from repro.launch.steps import StepOptions, abstract_train_state, make_train_step
mesh = compat.make_mesh((4, 4), ('data', 'model'))
cfg = get_config('qwen3-0.6b').reduced()
params_abs, opt_abs = abstract_train_state(cfg)
p_sh = param_shardings(params_abs, mesh)
o_sh = opt_shardings(opt_abs, p_sh, mesh)
batch_abs = {'tokens': jax.ShapeDtypeStruct((16, 64), jnp.int32),
             'labels': jax.ShapeDtypeStruct((16, 64), jnp.int32)}
b_sh = batch_shardings(batch_abs, mesh)
step = make_train_step(cfg, mesh, StepOptions(ce_chunk=16))
with mesh:
    compiled = jax.jit(step, in_shardings=(p_sh, o_sh, b_sh),
                       out_shardings=(p_sh, o_sh, None)).lower(params_abs, opt_abs,
                                                               batch_abs).compile()
print('ARGS', compiled.memory_analysis().argument_size_in_bytes)
""", n_devices=16)
    want = int(out.split("ARGS")[1].split()[0])
    rec = DR.trace_cell("qwen3-0.6b", SH.ShapeCell("mini", 64, 16, "train"),
                        opts=StepOptions(ce_chunk=16), mesh_shape=(4, 4),
                        cfg=get_config("qwen3-0.6b").reduced())
    assert rec["memory_analysis"]["argument_size_in_bytes"] == want


def _jax_train_batch(jcfg, b, s):
    batch = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32),
             "labels": jax.ShapeDtypeStruct((b, s), jnp.int32)}
    if jcfg.family == "audio":
        batch["frames"] = jax.ShapeDtypeStruct((b, jcfg.encoder_seq, jcfg.d_model), jnp.float32)
    if jcfg.family == "vlm":
        batch["patches"] = jax.ShapeDtypeStruct((b, jcfg.num_patches, jcfg.d_model),
                                                jnp.float32)
    return batch


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_traced_flops_within_two_percent_of_the_jax_compile(arch):
    from repro.launch.hlo_analysis import analyze

    jcfg = jax_get_config(arch).reduced()
    params, opt = JST.abstract_train_state(jcfg)
    step = JST.make_train_step(jcfg, None, JST.StepOptions(ce_chunk=16))
    text = jax.jit(step).lower(params, opt, _jax_train_batch(jcfg, 2, 32)).compile().as_text()
    want = analyze(text).flops
    rec = DR.trace_cell(arch, SH.ShapeCell("t", 32, 2, "train"), opts=StepOptions(ce_chunk=16),
                        mesh_shape=(1, 1), cfg=get_config(arch).reduced())
    assert rec["aten_flops"] == rec["cost_analysis"]["flops"] > 0
    assert abs(rec["aten_flops"] - want) <= 0.02 * want, (rec["aten_flops"], want)


WIDE = dict(d_model=256, d_ff=512, vocab_size=512)   # leaves past REPLICATE_BELOW: they shard


@pytest.mark.parametrize("arch,mode,microbatch", [
    pytest.param("qwen3-0.6b", "2d", 0, id="2d"),
    pytest.param("qwen3-0.6b", "fsdp", 0, id="fsdp"),
    pytest.param("olmoe-1b-7b", "2d", 0, id="moe-2d"),
    pytest.param("qwen3-0.6b", "2d", 2, id="microbatch2-2d"),
    pytest.param("whisper-medium", "fsdp", 0, id="audio-fsdp"),
    pytest.param("llama-3.2-vision-11b", "2d", 0, id="vlm-2d"),
])
def test_predictions_equal_a_real_cpu_mesh_step(arch, mode, microbatch):
    """Traced on meta for a (2, 2) mesh of the CPU: the step's gathered
    and reduced bytes equal ``train_step.stats`` after a real step, the
    state bytes the real masters, blocks, m, v and step counts, and the
    step's FLOPs the op analysis of the real step — for a dense model, a
    MoE one (the balance loss over the slices), two microbatches, and the
    audio and vision models' extra inputs."""
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.launch.placement import MeshParams
    from repro_torch.launch.train import add_stub_inputs, build

    cfg = dataclasses.replace(get_config(arch).reduced(), **WIDE)
    opts = StepOptions(ce_chunk=16, sharding_mode=mode, microbatch=microbatch)
    b, s = 8, 32
    rec = DR.trace_cell(arch, SH.ShapeCell("t", s, b, "train"), opts=opts,
                        mesh_shape=(2, 2), cfg=cfg, devices=["cpu"] * 4)
    mesh = make_host_mesh(2, 2, devices="cpu")
    params, opt, step, dev = build(cfg, mesh, opts, total_steps=4)
    assert isinstance(params, MeshParams)
    batch = add_stub_inputs(make_lm_batch(0, 0, b, s, cfg.vocab_size), cfg,
                            np.random.default_rng(0))
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    with OpAnalysis() as mode_:
        step(params, opt, batch)
    assert rec["stats"] == step.stats and step.stats["gathered"] > 0
    assert rec["step_flops"] == mode_.result.flops
    models = params.compute_model(dev)
    state = sum(p.numel() * p.element_size() for p in models.parameters())
    for blocks in (params.blocks, opt["m"], opt["v"]):
        state += sum(x.numel() * x.element_size() for bs in blocks.values() for x in bs
                     if x is not None)
    state += sum(x.numel() * x.element_size() for x in opt["step"])
    assert rec["state_bytes"] == state
    per_row = sum(v[:1].numel() * v.element_size() for v in batch.values())
    assert rec["memory_analysis"]["argument_size_in_bytes"] == max(
        3 * x + 4 for x in params.block_bytes()) + per_row * (b // max(microbatch, 1)
                                                             // rec["slices"])


@pytest.mark.parametrize("arch,pos", [("qwen3-0.6b", 12), ("rwkv6-3b", 12),
                                      ("recurrentgemma-2b", 12)])
def test_serving_trace_equals_the_cpu_calls(arch, pos):
    """A prefill of ``pos`` tokens and a decode at ``pos`` with the kernels
    on: the meta trace's kernel launches, kernel FLOPs and matmul FLOPs
    equal the op analysis of the same calls on the CPU (the kernels'
    plain versions), past recurrentgemma's 8-slot window."""
    cfg = get_config(arch).reduced()
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    tok = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (1, pos)),
                          dtype=torch.int32)
    cache = M.make_serve_cache(cfg, 1, pos + 1, device="cpu")
    with OpAnalysis() as pre:
        M.prefill(params, cfg, {"tokens": tok}, cache)
    with OpAnalysis() as dec:
        M.decode_step(params, cfg, tok[:, -1:], cache, pos)
    opts = StepOptions(sharding_mode="2d")
    for kind, seq, real in (("prefill", pos, pre.result), ("decode", pos + 1, dec.result)):
        rec = DR.trace_cell(arch, SH.ShapeCell(kind, seq, 1, kind), opts=opts, mesh_shape=(1, 1),
                            cfg=cfg)
        assert rec["kernel_launches"] == real.kernel_launches, kind
        assert rec["kernel_flops"] == real.kernel_flops, kind
        assert rec["aten_flops"] == real.aten_flops, kind
    assert pre.result.kernel_launches


def test_dryrun_ring_matches_the_rings_copies(monkeypatch):
    """On a 4-entry CPU mesh: the padded rows are ``pad_to_ring``'s, and
    the bytes the ring moves (the shards placed, then every S shard passed
    on at each step but the last) are the plan's."""
    from repro_torch.core import ring as RING
    from repro_torch.sparse.format import SparseBatch, from_arrays

    cfg = JoinConfig(name="t", n_r=30, n_s=50, dim=300, nnz_mean=6, k=3, algorithm="bf")
    mesh = make_host_mesh(4, 1, devices="cpu")
    plan = dryrun_ring(cfg, mesh=mesh)
    f = plan["features"]
    assert plan["n_ring"] == 4 and plan["steps"] == 4 and f == 12

    def batch(n, seed):
        rng = np.random.default_rng(seed)
        idx = np.sort(rng.choice(cfg.dim, (n, f)), axis=1).astype(np.int32)
        return from_arrays(idx, rng.random((n, f)).astype(np.float32),
                           np.full(n, f, np.int32), cfg.dim, device="cpu")

    R, n_r = RING.pad_to_ring(batch(cfg.n_r, 0), plan["n_ring"])
    S, n_s = RING.pad_to_ring(batch(cfg.n_s, 1), plan["n_ring"])
    assert (R.num_vectors, S.num_vectors, n_r, n_s) == (plan["nr"], plan["ns"], 30, 50)
    moved = []
    to = SparseBatch.to

    def counted(self, device):
        moved.append(sum(x.numel() * x.element_size() for x in (self.indices, self.values,
                                                                  self.nnz)))
        return to(self, device)

    monkeypatch.setattr(SparseBatch, "to", counted)
    RING._ring_join_impl(R, S, cfg.k, mesh, algorithm="bf", n_r_valid=n_r, n_s_valid=n_s)
    placed = plan["n_ring"] * (plan["r_shard_bytes"] + plan["s_shard_bytes"])
    assert sum(moved) == placed + plan["s_bytes_sent"]
    assert moved[-plan["n_ring"]:] == [plan["s_shard_bytes"]] * plan["n_ring"]


def test_dryrun_cli(tmp_path, monkeypatch, capsys):
    """``main`` over one arch's four cells (the reduced config, the cells
    cut to 64 tokens): a train, a prefill and a decode record with every
    key, and the long_500k skip."""
    monkeypatch.setattr(DR, "get_config", lambda arch: get_config(arch).reduced())
    monkeypatch.setattr(SH, "SHAPES", {
        name: dataclasses.replace(c, seq_len=min(c.seq_len, 64), global_batch=min(c.global_batch,
                                                                                  32))
        for name, c in SH.SHAPES.items()})
    assert DR.main(["--arch", "qwen3-0.6b", "--out", str(tmp_path), "--ce-chunk", "16"]) == 0
    out = capsys.readouterr().out
    assert out.count("  ok: trace") == 3 and "SKIP: full-attention" in out
    keys = {"arch", "shape", "mesh", "kind", "params", "sharding_mode", "n_chips", "trace_s",
            "memory_analysis", "cost_analysis", "collectives", "hlo_analysis",
            "gathered_model_bytes", "stats", "largest_position_bytes"}
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        rec = json.loads((tmp_path / f"qwen3-0.6b_{shape}_16x16.json").read_text())
        assert keys <= rec.keys(), shape
        assert set(rec["memory_analysis"]) == {"argument_size_in_bytes", "output_size_in_bytes",
                                               "temp_size_in_bytes"}
        assert set(rec["cost_analysis"]) == {"flops", "bytes accessed"}
        assert {"flops_per_chip", "hbm_bytes_per_chip",
                "collective_bytes_per_chip"} <= rec["hlo_analysis"].keys()
        assert rec["n_chips"] == 256 and rec["cost_analysis"]["flops"] > 0
    train = json.loads((tmp_path / "qwen3-0.6b_train_4k_16x16.json").read_text())
    assert train["collectives"]["gathered"]["bytes"] == train["gathered_model_bytes"] > 0
    skip = json.loads((tmp_path / "qwen3-0.6b_long_500k_16x16.json").read_text())
    assert "skipped" in skip


def test_meta_branches_refuse_what_the_card_refuses():
    """The meta branches run the card path's checks (``_checked``): a head
    width past 256, a grid past gridDim.y, a wkv head size or chunk the
    kernel lacks are ``KernelRefusal``s; GQA and dtype faults raise as on
    the card; no meta call moves a launch counter.  A refused kernel makes
    the dry run record the cell as refused, as does a MoE batch whose
    groups straddle the slices."""
    meta = torch.device("meta")
    q = torch.empty((4, 8, 300), device=meta)
    with pytest.raises(KernelRefusal, match="head width 300"):
        flash_attention_cuda(q, q, q)
    big = torch.empty((1, 65_536 * 128 + 1, 16), device=meta)
    with pytest.raises(KernelRefusal, match="gridDim.y"):
        flash_attention_cuda(big, big, big)
    q = torch.empty((6, 8, 16), device=meta)
    with pytest.raises(ValueError, match="not a multiple"):
        flash_attention_cuda(q, torch.empty((4, 8, 16), device=meta),
                             torch.empty((4, 8, 16), device=meta))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        h = q.half()
        flash_attention_cuda(h, h, h)
    r = torch.empty((2, 16, 48), device=meta)
    with pytest.raises(KernelRefusal, match="head size 48"):
        wkv_cuda(r, r, r, r, torch.empty((2, 48), device=meta))
    r = torch.empty((2, 16, 16), device=meta)
    with pytest.raises(KernelRefusal, match="chunk 7"):
        wkv_cuda(r, r, r, r, torch.empty((2, 16), device=meta), chunk=7)
    assert flash_attention_cuda.launches == 0 and wkv_cuda.launches == 0
    out = flash_attention_cuda(q, q[:2], q[:2])
    assert out.is_meta and out.shape == q.shape and flash_attention_cuda.launches == 0

    wide = dataclasses.replace(get_config("qwen3-0.6b").reduced(), head_dim=300)
    rec = DR.trace_cell("qwen3-0.6b", SH.ShapeCell("p", 16, 1, "prefill"), mesh_shape=(1, 1),
                        cfg=wide)
    assert "head width 300" in rec["refused"]
    moe = get_config("olmoe-1b-7b").reduced()          # groups of 16 tokens
    rec = DR.trace_cell("olmoe-1b-7b", SH.ShapeCell("t", 8, 2, "train"), mesh_shape=(2, 1),
                        opts=StepOptions(ce_chunk=8), cfg=moe)
    assert "MoE groups" in rec["refused"]
