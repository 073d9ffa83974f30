"""The port's join job CLI (src/repro_torch/launch/join_job.py) against the
JAX package's (``repro.launch.join_job``) on the same small arguments, on
the CPU: the JSON summary's keys equal, its counters equal and
``mean_top1`` within 1e-6, for bf, iib and iiib on one device, and with
``--ring --data-par 4`` (the JAX CLI in a subprocess with 4 forced host
devices; the port's over a mesh of 4 CPU entries) for the CLI's default
algorithm, iiib, and for iib (the store itself is held per algorithm in
tests/test_torch_store.py).  ``python -m
repro_torch.launch.join_job`` runs as a module too."""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import join_job  # noqa: E402
from tests.util_subproc import REPO, run_with_devices  # noqa: E402

ARGS = ["--nr", "300", "--ns", "600", "--dim", "2000", "--k", "5", "--repeat", "2",
        "--r-block", "128", "--s-block", "256"]
ALGS = ("bf", "iib", "iiib")
RING_ALGS = ("iib", "iiib")
COUNTERS = ("algorithm", "nr", "ns", "k", "shards", "shard_rows", "s_blocks", "index_builds",
            "device_dispatches", "host_syncs")


def _port(capsys, argv):
    assert join_job.main(argv + ["--device", "cpu"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _hold(got, want):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for key in COUNTERS:
        assert got.get(key) == want.get(key), key
    assert len(got["query_s"]) == len(want["query_s"]) == 2
    assert abs(got["mean_top1"] - want["mean_top1"]) <= 1e-6, (got, want)


@pytest.fixture(scope="module")
def jax_ring():
    """The JAX CLI's --ring summaries, one per algorithm (4 host devices)."""
    code = ("from repro.launch.join_job import main\n"
            f"for alg in {RING_ALGS!r}:\n"
            f"    main({ARGS!r} + ['--algorithm', alg, '--ring', '--data-par', '4'])\n")
    lines = [ln for ln in run_with_devices(code, n_devices=4).splitlines() if ln.startswith("{")]
    return dict(zip(RING_ALGS, map(json.loads, lines)))


@pytest.mark.parametrize("alg", ALGS)
def test_host_mode_matches_jax_cli(capsys, alg):
    from repro.launch import join_job as jax_job

    argv = ARGS + ["--algorithm", alg]
    assert jax_job.main(argv) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    _hold(_port(capsys, argv), want)


@pytest.mark.subproc
@pytest.mark.parametrize("alg", RING_ALGS)
def test_ring_mode_matches_jax_cli(capsys, jax_ring, alg):
    got = _port(capsys, ARGS + ["--algorithm", alg, "--ring", "--data-par", "4"])
    assert got["shards"] == 4 and got["device_dispatches"] == got["host_syncs"] == 2 * 3
    _hold(got, jax_ring[alg])


@pytest.mark.subproc
def test_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.join_job", "--nr", "64", "--ns", "128",
         "--dim", "512", "--algorithm", "iib", "--ring", "--data-par", "2", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["shards"] == 2 and out["index_builds"] == out["s_blocks"]


def test_cuda_is_the_default_and_raises_without_it():
    """Without a CUDA device the default device raises; a ring over more
    CUDA devices than there are raises, naming the counts."""
    small = ["--nr", "8", "--ns", "16", "--dim", "256"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            join_job.main(small)
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"need {n + 1} CUDA devices, have {n}"):
        join_job.main(small + ["--ring", "--data-par", str(n + 1)])
