"""The port's public API (``repro_torch.core``, ``repro_torch.sparse``) and
its examples, on the CPU: the same exported names as the JAX package's,
the README quickstart through them, and ``examples/torch_*.py`` run with
``--device cpu`` (the quickstart asserts its oracle match)."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.util_subproc import REPO  # noqa: E402


def test_exports_equal_the_reference():
    import repro.core
    import repro.sparse
    import repro_torch.core
    import repro_torch.sparse

    assert repro_torch.core.__all__ == repro.core.__all__
    assert repro_torch.sparse.__all__ == repro.sparse.__all__
    for mod in (repro_torch.core, repro_torch.sparse):
        for name in mod.__all__:
            assert getattr(mod, name).__module__.startswith("repro_torch."), name


def test_quickstart_api():
    """The README quickstart through repro_torch.core: generate, join,
    verify (the counterpart of tests/test_system.py::test_quickstart_api)."""
    from repro_torch.core import JoinSpec, SparseKNNIndex, distributed_join, knn_join  # noqa: F401
    from repro_torch.core.reference import oracle_knn
    from repro_torch.sparse import densify, synthetic_sparse

    R = synthetic_sparse(40, dim=1000, nnz_mean=15, seed=0)
    S = synthetic_sparse(60, dim=1000, nnz_mean=15, seed=1)
    state = knn_join(R, S, k=5, algorithm="iiib", device="cpu")
    assert state.scores.shape == (40, 5)
    assert state.ids.shape == (40, 5)
    osc, _ = oracle_knn(densify(R).numpy(), densify(S).numpy(), 5)
    pos = osc > 0
    np.testing.assert_allclose(
        np.where(pos, state.scores.numpy(), 0), np.where(pos, osc, 0), atol=1e-4
    )


@pytest.mark.subproc
@pytest.mark.parametrize("example,args", [
    ("torch_quickstart.py", []),
    ("torch_peptide_search.py", ["--nr", "100", "--ns", "600"]),
])
def test_example_runs_on_the_cpu(example, args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", example), *args, "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    if example == "torch_quickstart.py":
        assert "matches dense oracle: True" in proc.stdout
    else:
        assert "spectrum 0:" in proc.stdout
