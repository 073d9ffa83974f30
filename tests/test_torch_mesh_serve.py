"""The port's ``Server`` over a mesh (src/repro_torch/launch/serve.py) on
the CPU: on a (2, 1) mesh of CPU entries the slots split over the data
rows and every request's tokens are the one-device ``Server``'s and the
JAX ``Server``'s (on the JAX weights, up to the declared near ties of
tests/test_torch_lm_serve.py), for qwen3-0.6b and rwkv6-3b reduced; the
slots' devices on a mesh of distinct devices; the prefill step's
activation hook."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import serve as jax_serve  # noqa: E402
from repro_torch.launch.mesh import DeviceMesh, make_host_mesh  # noqa: E402
from repro_torch.launch.serve import Request, Server, slot_devices  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from util_lm import reduced  # noqa: E402

NEAR_TIE = 2e-4     # tests/test_torch_lm_serve.py's


def _serve(srv, reqs, log=None):
    """Drive ``srv`` over ``reqs``; with ``log``, each call's last-position
    logits by (request id, index of the token it gives)."""
    if log is not None:
        prefill, decode = srv.prefill, srv.decode
        admitting = [None]

        def rec_prefill(params, batch, cache):
            logits, cache = prefill(params, batch, cache)
            log[admitting[0].rid, 0] = np.asarray(logits[0, -1], np.float32)
            return logits, cache

        def rec_decode(params, token, cache, pos):
            s = next(i for i, c in enumerate(srv.slot_cache) if c is cache)
            req = srv.slot_req[s]
            logits, cache = decode(params, token, cache, pos)
            log[req.rid, len(req.out)] = np.asarray(logits[0, -1], np.float32)
            return logits, cache

        srv.prefill, srv.decode = rec_prefill, rec_decode
    pending = list(reqs)
    while pending or srv.occupancy():
        while pending:
            if log is not None:
                admitting[0] = pending[0]
            if not srv.admit(pending[0]):
                break
            pending.pop(0)
        srv.step()


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-3b"])
def test_a_mesh_server_gives_the_one_device_and_the_jax_servers_tokens(arch):
    jcfg, cfg = reduced(arch, jax_cfg=True), reduced(arch)
    jsrv = jax_serve.Server(jcfg, batch=4, max_seq=64, seed=0)
    tree = jax.tree.map(np.asarray, jsrv.params)
    mesh = make_host_mesh(2, 1, devices="cpu")
    srv = Server(cfg, batch=4, max_seq=64, mesh=mesh,
                 params=params_from_jax(tree, cfg, device="cpu"))
    one = Server(cfg, batch=4, max_seq=64, device="cpu",
                 params=params_from_jax(tree, cfg, device="cpu"))
    assert srv.mesh.shape == {"data": 2, "model": 1}
    assert len(srv.row_params) == 1       # one device: the rows share the one copy
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (8, 5, 12, 8, 3, 9, 8)]
    want = [jax_serve.Request(i, p, max_new=6) for i, p in enumerate(prompts)]
    got = [Request(i, p, max_new=6) for i, p in enumerate(prompts)]
    base = [Request(i, p, max_new=6) for i, p in enumerate(prompts)]
    log = {}
    _serve(jsrv, want, log)
    _serve(srv, got)
    _serve(one, base)
    assert [r.out for r in got] == [r.out for r in base]
    assert [r.rid for r in srv.finished] == [r.rid for r in one.finished]
    for g, w in zip(got, want):
        for i, (a, b) in enumerate(zip(g.out, w.out)):
            if a != b:
                top2 = np.sort(log[w.rid, i])[-2:]
                assert top2[1] - top2[0] <= NEAR_TIE * max(1.0, abs(top2[1])), (w.rid, i)
                break


def test_slots_split_over_the_data_rows_in_contiguous_blocks():
    cuda = [torch.device("cuda", i) for i in range(4)]
    mesh = DeviceMesh(np.array(cuda[:2], dtype=object).reshape(2, 1), ("data", "model"))
    assert slot_devices(mesh, 4) == [cuda[0], cuda[0], cuda[1], cuda[1]]
    assert slot_devices(mesh, 3) == [cuda[0]] * 3          # the spec leaves 3 whole
    mesh = DeviceMesh(np.array(cuda, dtype=object).reshape(2, 2), ("data", "model"))
    assert slot_devices(mesh, 6) == [cuda[0]] * 3 + [cuda[2]] * 3   # rows (0, 0), (1, 0)
    mesh = DeviceMesh(np.array(cuda, dtype=object).reshape(4, 1), ("data", "model"))
    assert slot_devices(mesh, 8) == [d for d in cuda for _ in range(2)]
    pod = DeviceMesh(np.array(cuda, dtype=object).reshape(2, 2, 1), ("pod", "data", "model"))
    assert slot_devices(pod, 4) == cuda
    assert slot_devices(pod, 2) == [cuda[0], cuda[1]]      # over 'data' alone, pod 0


def test_the_mesh_prefill_checks_the_slots_device():
    cfg = reduced("qwen3-0.6b")
    mesh = make_host_mesh(2, 1, devices="cpu")
    model = M.LM(cfg, torch.Generator().manual_seed(0))
    step = make_prefill_step(cfg, mesh)
    cache = M.make_serve_cache(cfg, 1, 16, device="cpu")
    logits, _ = step(model, {"tokens": torch.zeros((1, 4), dtype=torch.int32)}, cache)
    assert logits.shape == (1, 1, cfg.vocab_size)
    with pytest.raises(ValueError, match="params are on cpu, the server on meta"):
        Server(cfg, batch=2, max_seq=16, params=model,
               mesh=DeviceMesh(np.array([torch.device("meta")] * 2,
                                        dtype=object).reshape(2, 1), ("data", "model")))
