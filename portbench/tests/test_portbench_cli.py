"""The command: without a card it prints no result and exits non-zero."""
import os
import shutil
import subprocess
import sys

import pytest

from portbench.tests.small import BENCH, ROOT


def _cli(cwd, *args):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is here")
    cell = BENCH["workloads"][0]["name"]
    p = _cli(ROOT, "--workload", cell, "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout.strip() == "", p.stderr


def test_benchmark_files_alone_are_not_enough(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cell = BENCH["workloads"][0]["name"]
    p = _cli(tmp_path, "--workload", cell, "--seed", "5", "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout.strip() == "", p.stdout
