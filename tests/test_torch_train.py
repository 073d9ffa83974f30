"""The port's trainer (src/repro_torch/launch/train.py) on the CPU:
tests/test_distributed.py's failure injection and resume as processes of
their own (``--device cpu``), a resumed run's losses equal to an
uninterrupted run's, a mesh of more than one position (and its refusal of
an MoE batch whose groups straddle the slices), and the last JSON line's
keys against the JAX trainer's."""
import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import train  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = ["--arch", "qwen3-0.6b", "--smoke", "--global-batch", "4", "--seq-len", "32"]


def _run_module(args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                          capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-4000:])
    return proc.stdout


def _main(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn(argv) == 0
    return buf.getvalue()


def _losses(out):
    """{step: loss} of the trainer's log lines (the last one a step wins)."""
    got = {}
    for line in out.splitlines():
        if line.startswith("step "):
            parts = line.split()
            got[int(parts[1])] = float(parts[3])
    return got


def test_train_failure_injection_and_resume(tmp_path):
    """End-to-end: injected failure mid-run -> supervisor restores from the
    checkpoint and finishes; a fresh process resumes from disk."""
    ckpt = str(tmp_path / "ck")
    out1 = _run_module(SMOKE + ["--steps", "12", "--ckpt-dir", ckpt, "--ckpt-every", "4",
                                "--resume", "auto", "--fail-at-step", "6", "--log-every", "4",
                                "--device", "cpu"])
    assert "RESTORE after" in out1
    rec = json.loads(out1.strip().splitlines()[-1])
    assert rec["failures"] == 1
    assert np.isfinite(rec["final_loss"])

    # resume in a NEW process from the final checkpoint (elastic restart)
    out2 = _run_module(SMOKE + ["--steps", "14", "--ckpt-dir", ckpt, "--resume", "auto",
                                "--log-every", "2", "--device", "cpu"])
    assert "resumed from step 12" in out2
    rec2 = json.loads(out2.strip().splitlines()[-1])
    assert rec2["steps"] == 14 and rec2["failures"] == 0 and np.isfinite(rec2["final_loss"])


def test_a_resumed_run_logs_the_uninterrupted_runs_losses(tmp_path):
    """The restore puts back the parameters and the AdamW state bit for bit
    and the token stream at the restored step: after a failure, and in a
    new run from a checkpoint, every step's loss is the uninterrupted
    run's."""
    base = SMOKE + ["--log-every", "1", "--device", "cpu"]
    want = _losses(_main(train.main, base + ["--steps", "12"]))
    assert sorted(want) == list(range(12))

    ckpt = str(tmp_path / "a")
    out = _main(train.main, base + ["--steps", "12", "--ckpt-dir", ckpt, "--ckpt-every", "4",
                                    "--fail-at-step", "6"])
    assert "RESTORE after: RuntimeError: injected node failure" in out
    assert _losses(out) == want

    ckpt = str(tmp_path / "b")
    _main(train.main, base + ["--steps", "8", "--ckpt-dir", ckpt, "--ckpt-every", "4"])
    out = _main(train.main, base + ["--steps", "12", "--ckpt-dir", ckpt, "--resume", "auto"])
    assert "resumed from step 8" in out
    got = _losses(out)
    assert sorted(got) == list(range(8, 12))
    assert got == {i: want[i] for i in range(8, 12)}


def test_a_mesh_of_more_than_one_device_raises():
    """A mesh of more than one position trains (the state as blocks on it,
    the losses the one-device run's); it raises where the batch cannot
    split as the reference's whole batch: an MoE batch whose groups would
    straddle two slices."""
    base = SMOKE + ["--steps", "2", "--device", "cpu", "--log-every", "1"]
    want = _losses(_main(train.main, base))
    for flags in (["--data-par", "2"], ["--model-par", "2"], ["--data-par", "2", "--model-par",
                                                              "2"]):
        got = _losses(_main(train.main, base + flags))
        assert sorted(got) == [0, 1]
        assert all(abs(got[i] - want[i]) <= 1.5e-4 for i in got), (flags, got, want)
    with pytest.raises(RuntimeError, match="retries exhausted") as raised:
        _main(train.main, ["--arch", "olmoe-1b-7b", "--smoke", "--global-batch", "4",
                           "--seq-len", "6", "--steps", "1", "--device", "cpu", "--data-par", "4"])
    cause = raised.value.__cause__     # the supervisor retried, then gave up
    assert isinstance(cause, ValueError) and "MoE groups of 12 tokens" in str(cause)
    assert "straddle" in str(cause)


def test_the_last_line_has_the_jax_trainers_keys():
    from repro.launch import train as jax_train

    argv = SMOKE + ["--steps", "2", "--log-every", "1"]
    got = json.loads(_main(train.main, argv + ["--device", "cpu"]).strip().splitlines()[-1])
    want = json.loads(_main(jax_train.main, argv).strip().splitlines()[-1])
    assert sorted(got) == sorted(want)
    for key in ("arch", "steps", "failures"):
        assert got[key] == want[key], key
    assert np.isfinite(got["final_loss"]) and got["tokens_per_s"] > 0


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "rwkv6-3b", "recurrentgemma-2b",
                                  "llama-3.2-vision-11b", "whisper-medium"])
def test_main_trains_every_family(arch, tmp_path):
    """``main --smoke`` at the reduced config of each family, with the stub
    frames and patches, through a checkpoint and a restore."""
    out = _main(train.main, ["--arch", arch, "--smoke", "--global-batch", "2", "--seq-len", "16",
                             "--steps", "4", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                             "--fail-at-step", "3", "--log-every", "1", "--device", "cpu"])
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["failures"] == 1 and rec["steps"] == 4 and np.isfinite(rec["final_loss"])
    assert sorted(_losses(out)) == [0, 1, 2, 3]
