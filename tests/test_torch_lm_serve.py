"""The port's LM serving path (src/repro_torch/launch/serve.py, steps.py)
against the JAX package's on the CPU, at the reduced configs (f32):
tests/test_serve.py's cases on the port's ``Server`` (qwen3-0.6b); the
port's ``Server`` on the JAX ``Server``'s weights (``params_from_jax``)
giving the JAX ``Server``'s tokens on those request mixes, up to declared
near ties, for one arch of every family (vlm and audio with the stub
patches and frames, zeros, as the reference serves them); rwkv6's prefill
quirk (decode starts from the cache as it was, not from the prompt) in
both; and ``main`` against the JAX ``main``."""
import contextlib
import io
import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.serve import Request, Server  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    make_decode_step,
    make_prefill_step,
    make_train_step,
)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from util_lm import reduced  # noqa: E402

# the port's logits are within 1e-4 of the JAX model's (tests/test_torch_models.py):
# a greedy token may differ only where the JAX top two lie within twice that
NEAR_TIE = 2e-4


def _cfg(arch="qwen3-0.6b"):
    return reduced(arch)


def _drive(server, reqs):
    pending = list(reqs)
    steps = 0
    while pending or server.occupancy():
        while pending and server.admit(pending[0]):
            pending.pop(0)
        server.step()
        steps += 1
        assert steps < 500
    return steps


# ---------------------------------------------------------------------------
# tests/test_serve.py's cases on the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def server():
    return Server(_cfg(), batch=2, max_seq=64, device="cpu")


def test_requests_complete(server):
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, 256, 8).astype(np.int32), max_new=5) for i in range(5)]
    _drive(server, reqs)
    for r in reqs:
        assert len(r.out) == 5


def test_continuous_batching_reuses_slots(server):
    rng = np.random.default_rng(1)
    reqs = [Request(i, rng.integers(0, 256, 4).astype(np.int32), max_new=3) for i in range(6)]
    pending = list(reqs)
    admitted_over_time = 0
    while pending or server.occupancy():
        while pending and server.admit(pending[0]):
            pending.pop(0)
            admitted_over_time += 1
        server.step()
    assert admitted_over_time == 6


def test_deterministic_generation():
    cfg = _cfg()
    prompt = np.arange(8, dtype=np.int32) % cfg.vocab_size
    outs = []
    for _ in range(2):
        srv = Server(cfg, batch=1, max_seq=64, seed=3, device="cpu")
        r = Request(0, prompt, max_new=6)
        assert srv.admit(r)
        while srv.occupancy():
            srv.step()
        outs.append(tuple(r.out))
    assert outs[0] == outs[1]


def test_finished_requests_tracked():
    srv = Server(_cfg(), batch=2, max_seq=64, device="cpu")
    rng = np.random.default_rng(2)
    reqs = [Request(i, rng.integers(0, 256, 6).astype(np.int32), max_new=4) for i in range(5)]
    _drive(srv, reqs)
    assert sorted(r.rid for r in srv.finished) == [0, 1, 2, 3, 4]
    assert all(r.done and len(r.out) == 4 for r in srv.finished)


def test_latency_percentiles_reported():
    srv = Server(_cfg(), batch=2, max_seq=64, device="cpu")
    rng = np.random.default_rng(7)
    _drive(srv, [Request(i, rng.integers(0, 256, 6).astype(np.int32), max_new=3)
                 for i in range(4)])
    lat = srv.latency_summary()
    assert lat["p50_ms"] is not None and lat["p50_ms"] >= 0
    assert lat["p99_ms"] >= lat["p50_ms"]
    for r in srv.finished:
        assert r.t_finish >= r.t_admit


def test_server_keeps_the_references_surface():
    srv = Server(_cfg(), batch=2, max_seq=64, device="cpu")
    for name in ("params", "prefill", "decode", "slot_cache", "slot_req", "slot_pos",
                 "slot_tok", "finished", "mesh"):
        assert hasattr(srv, name), name
    assert srv.slot_pos.dtype == np.int32 and srv.slot_tok.shape == (2, 1)
    assert srv.params.device == torch.device("cpu")
    assert srv.mesh.shape == {"data": 1, "model": 1}


def test_a_larger_mesh_raises_and_so_do_foreign_params():
    """A mesh of more than one position now serves and trains; what still
    raises: params on another device than the server's, a mesh train step
    given a model that is not placed on it, and an MoE batch whose groups
    would straddle the mesh's batch slices."""
    from repro_torch.launch.placement import place_train_state
    from repro_torch.launch.steps import StepOptions, init_train_state

    cfg = _cfg()
    mesh = make_host_mesh(2, 1, devices="cpu")
    for build in (make_prefill_step, make_decode_step, make_train_step):
        assert callable(build(cfg, mesh))
    srv = Server(cfg, batch=2, max_seq=16, mesh=mesh)
    assert srv.device == torch.device("cpu") and srv.mesh is mesh
    assert [c["kv"]["k"].device for c in srv.slot_cache] == [torch.device("cpu")] * 2
    srv = Server(cfg, batch=1, max_seq=16, mesh=make_host_mesh(1, 1, devices="cpu"))
    assert srv.device == torch.device("cpu")
    with pytest.raises(ValueError, match="params are on"):
        Server(cfg, batch=1, max_seq=16, device="cpu", params=M.LM(cfg, device="meta"))
    params, opt = init_train_state(cfg, device="cpu")
    with pytest.raises(TypeError, match="place_train_state"):
        make_train_step(cfg, mesh)(params, opt, {"tokens": np.zeros((2, 8), np.int32),
                                                 "labels": np.zeros((2, 8), np.int32)})
    moe = _cfg("olmoe-1b-7b")
    params, opt = place_train_state(*init_train_state(moe, device="cpu"), mesh)
    batch = {"tokens": np.zeros((2, 6), np.int32), "labels": np.zeros((2, 6), np.int32)}
    with pytest.raises(ValueError, match="straddle"):     # groups of 12, slices of 6
        make_train_step(moe, mesh, StepOptions(ce_chunk=6))(params, opt, batch)


# ---------------------------------------------------------------------------
# the port's Server against the JAX Server, on the JAX weights
# ---------------------------------------------------------------------------

def _recording(srv, log, admitting):
    """Wrap ``srv``'s prefill/decode so that each call's last-position
    logits are logged under (request id, index of the token it gives)."""
    prefill, decode = srv.prefill, srv.decode

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


def _serve_recorded(srv, reqs):
    log, admitting = {}, [None]
    _recording(srv, log, admitting)
    pending = list(reqs)
    while pending or srv.occupancy():
        while pending:
            admitting[0] = pending[0]
            if not srv.admit(pending[0]):
                break
            pending.pop(0)
        srv.step()
    return log


def _assert_same_tokens(got_reqs, want_reqs, want_log):
    """Tokens equal for every request; where one differs, the JAX top two
    there must be a near tie, and that request is compared no further.
    Returns the number of near ties met."""
    ties = 0
    for got, want in zip(got_reqs, want_reqs):
        assert len(got.out) == len(want.out) == want.max_new
        for i, (a, b) in enumerate(zip(got.out, want.out)):
            if a != b:
                top2 = np.sort(want_log[want.rid, i])[-2:]
                assert top2[1] - top2[0] <= NEAR_TIE * max(1.0, abs(top2[1])), (
                    f"request {want.rid} token {i}: {a} != {b}, JAX top two {top2}")
                ties += 1
                break
    return ties


MIXES = {   # tests/test_serve.py's request mixes:
    # (batch, server seed, prompt rng seed or None for arange, prompt length, max_new, count)
    "complete": (2, 0, 0, 8, 5, 5),
    "slot_reuse": (2, 0, 1, 4, 3, 6),
    "finished": (2, 0, 2, 6, 4, 5),
    "latency": (2, 0, 7, 6, 3, 4),
    "deterministic": (1, 3, None, 8, 6, 1),
}


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-3b", "olmoe-1b-7b", "phi3.5-moe-42b-a6.6b",
                                  "recurrentgemma-2b", "llama-3.2-vision-11b", "whisper-medium"])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_server_gives_the_jax_servers_tokens(mix, arch):
    batch, seed, rng_seed, plen, max_new, n = MIXES[mix]
    jcfg, cfg = reduced(arch, jax_cfg=True), _cfg(arch)
    jsrv = jax_serve.Server(jcfg, batch=batch, max_seq=64, seed=seed)
    tree = jax.tree.map(np.asarray, jsrv.params)
    srv = Server(cfg, batch=batch, max_seq=64, device="cpu",
                 params=params_from_jax(tree, cfg, device="cpu"))
    if rng_seed is None:
        prompts = [np.arange(plen, dtype=np.int32) % cfg.vocab_size]
    else:
        rng = np.random.default_rng(rng_seed)
        prompts = [rng.integers(0, 256, plen).astype(np.int32) for _ in range(n)]
    want = [jax_serve.Request(i, p, max_new=max_new) for i, p in enumerate(prompts)]
    got = [Request(i, p, max_new=max_new) for i, p in enumerate(prompts)]
    want_log = _serve_recorded(jsrv, want)
    _serve_recorded(srv, got)
    _assert_same_tokens(got, want, want_log)
    assert [r.rid for r in srv.finished] == [r.rid for r in jsrv.finished]


# a prompt of exactly max_seq tokens: the first decode runs at position
# max_seq, where the reference's dynamic_update_slice clamps the write to the
# cache's last slot (ROADMAP fault 3.1); the JAX Server's tokens on the
# reduced configs, one arch of every family
FULL_PROMPT_TOKENS = {"qwen3-0.6b": [226, 147], "olmoe-1b-7b": [23, 239],
                      "llama-3.2-vision-11b": [11, 135], "whisper-medium": [84, 84],
                      "recurrentgemma-2b": [218, 116], "rwkv6-3b": [233, 174]}


@pytest.mark.parametrize("arch", sorted(FULL_PROMPT_TOKENS))
def test_a_prompt_of_max_seq_tokens_serves_the_jax_servers_tokens(arch):
    jcfg, cfg = reduced(arch, jax_cfg=True), _cfg(arch)
    jsrv = jax_serve.Server(jcfg, batch=1, max_seq=16, seed=0)
    srv = Server(cfg, batch=1, max_seq=16, device="cpu",
                 params=params_from_jax(jax.tree.map(np.asarray, jsrv.params), cfg,
                                        device="cpu"))
    prompt = (np.arange(16) * 7 % 200).astype(np.int32)
    for s, R in ((jsrv, jax_serve.Request), (srv, Request)):
        assert s.admit(R(0, prompt, max_new=4))
        while s.occupancy():
            s.step()
    assert srv.finished[0].out == jsrv.finished[0].out == FULL_PROMPT_TOKENS[arch]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-medium"])
def test_decode_past_the_caches_end_matches_jax(arch):
    """decode_step at positions max_seq and max_seq + 3 on a full cache:
    the write clamps to the last slot, every key stays visible, the logits
    and the cache are the JAX decode_step's."""
    from repro.models import model as JM
    from util_lm import LOGIT_TOL, assert_cache_close, batch as lm_batch, close, np_tree

    jcfg, cfg = reduced(arch, jax_cfg=True), _cfg(arch)
    tree = np_tree(JM.init_params(jax.random.key(2), jcfg))
    model = params_from_jax(tree, cfg, device="cpu")
    b = lm_batch(cfg, 1, 8, 3)
    jcache = JM.prefill(tree, jcfg, jax.tree.map(jax.numpy.asarray, b),
                        JM.make_serve_cache(jcfg, 1, 8))[1]
    tcache = M.prefill(model, cfg, b, M.make_serve_cache(cfg, 1, 8, device="cpu"))[1]
    for pos, tok in ((8, 5), (11, 9)):
        want, jcache = JM.decode_step(tree, jcfg, jax.numpy.full((1, 1), tok, jax.numpy.int32),
                                      jcache, jax.numpy.int32(pos))
        got, tcache = M.decode_step(model, cfg, np.full((1, 1), tok, np.int32), tcache, pos)
        close(got, want, LOGIT_TOL)
    assert_cache_close(tcache, np_tree(jcache), LOGIT_TOL)


def test_rwkv_decode_starts_from_the_cache_not_the_prompt():
    """The reference's ssm prefill runs the chunked form without a state
    and returns the cache untouched, so decode starts from the zero state
    (or a slot's previous request's) and not from the prompt.  The port
    does the same: pinned in both packages."""
    jcfg, cfg = jax_get_config("rwkv6-3b").reduced(), _cfg("rwkv6-3b")
    jsrv = jax_serve.Server(jcfg, batch=1, max_seq=64, seed=0)
    srv = Server(cfg, batch=1, max_seq=64, device="cpu",
                 params=params_from_jax(jax.tree.map(np.asarray, jsrv.params), cfg,
                                        device="cpu"))
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, 10).astype(np.int32)
    for s, R in ((jsrv, jax_serve.Request), (srv, Request)):
        assert s.admit(R(0, a, max_new=4))
        assert all(not np.asarray(x).any() for x in s.slot_cache[0]["kv"].values())
    while srv.occupancy():
        srv.step()
    while jsrv.occupancy():
        jsrv.step()
    assert srv.finished[0].out == jsrv.finished[0].out
    # the same tokens from a fresh cache fed the first token alone: the
    # prompt is not seen by decode
    cache = M.make_serve_cache(cfg, 1, 64, device="cpu")
    tok, outs = srv.finished[0].out[0], []
    for t in range(3):
        logits, cache = M.decode_step(srv.params, cfg, np.array([[tok]], np.int32), cache,
                                      len(a) + t)
        tok = int(torch.argmax(logits[0, -1]))
        outs.append(tok)
    assert outs == srv.finished[0].out[1:]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _json_of(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_main_prints_the_jax_mains_keys_and_counts():
    argv = ["--arch", "qwen3-0.6b", "--smoke", "--requests", "4", "--batch", "2",
            "--max-new", "5", "--prompt-len", "6"]
    got = _json_of(serve.main, argv + ["--device", "cpu"])
    want = _json_of(jax_serve.main, argv)
    assert sorted(got) == sorted(want)
    assert sorted(got["faults"]) == sorted(want["faults"])
    assert sorted(got["latency_ms"]) == sorted(want["latency_ms"])
    for key in ("arch", "requests", "completed", "decode_steps", "total_tokens",
                "tokens_per_request", "faults"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "recurrentgemma-2b", "llama-3.2-vision-11b",
                                  "whisper-medium"])
def test_main_serves_every_family(arch):
    """``main --smoke`` at the reduced config of each family the JAX
    ``main`` serves (vlm's reduced 2 layers hold no unit: embed and head
    alone, in both), with the JAX ``main``'s keys and counts."""
    argv = ["--arch", arch, "--smoke", "--requests", "3", "--batch", "2", "--max-new", "3",
            "--prompt-len", "5"]
    got = _json_of(serve.main, argv + ["--device", "cpu"])
    want = _json_of(jax_serve.main, argv)
    assert sorted(got) == sorted(want)
    for key in ("arch", "requests", "completed", "decode_steps", "total_tokens",
                "tokens_per_request", "faults"):
        assert got[key] == want[key], key


def test_main_with_the_step_watchdog():
    """--step-timeout runs each step on a watchdog thread."""
    got = _json_of(serve.main, ["--arch", "rwkv6-3b", "--smoke", "--requests", "3", "--batch",
                                "2", "--max-new", "3", "--prompt-len", "5", "--step-timeout",
                                "60", "--device", "cpu"])
    assert got["completed"] == 3 and got["tokens_per_request"] == {"0": 3, "1": 3, "2": 3}
    assert got["faults"]["timeouts"] == 0
