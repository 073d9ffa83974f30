"""The port's copy of the paper's literal algorithms
(src/repro_torch/core/reference.py) against the JAX package's: both are
numpy, so on the same inputs the results and the cost-model counters are
equal exactly; and against the dense oracle."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import reference as jax_reference  # noqa: E402
from repro.sparse.datagen import spectra_like as jax_spectra  # noqa: E402
from repro.sparse.format import densify  # noqa: E402
from repro_torch.core.reference import (  # noqa: E402
    HostCSR,
    WorkCounters,
    oracle_knn,
    reference_join,
)
from repro_torch.sparse.format import densify as port_densify  # noqa: E402
from repro_torch.sparse.format import from_arrays  # noqa: E402


def _host(batch, cls):
    return cls.from_padded(np.asarray(batch.indices), np.asarray(batch.values),
                           np.asarray(batch.nnz), batch.dim)


@pytest.mark.parametrize("algorithm", ["bf", "iib", "iiib"])
@pytest.mark.parametrize("blocks", [(None, None), (16, 32), (7, 13)])
def test_reference_join_equals_jax_package(small_rs, algorithm, blocks):
    R, S = small_rs
    work, jwork = WorkCounters(), jax_reference.WorkCounters()
    got = reference_join(_host(R, HostCSR), _host(S, HostCSR), 5, algorithm=algorithm,
                         r_block=blocks[0], s_block=blocks[1], work=work)
    want = jax_reference.reference_join(
        _host(R, jax_reference.HostCSR), _host(S, jax_reference.HostCSR), 5,
        algorithm=algorithm, r_block=blocks[0], s_block=blocks[1], work=jwork)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert vars(work) == vars(jwork)


@pytest.mark.parametrize("algorithm", ["bf", "iib", "iiib"])
def test_reference_join_on_spectra_matches_oracle(algorithm):
    """Spectra-shaped data (30 x 50 at dim 2000): the literal algorithms
    against the dense oracle on every positive-score slot."""
    R, S = jax_spectra(30, dim=2000, seed=0), jax_spectra(50, dim=2000, seed=1)
    sc, _ = reference_join(_host(R, HostCSR), _host(S, HostCSR), 5, algorithm=algorithm,
                           r_block=8, s_block=16)
    osc, _ = oracle_knn(np.asarray(densify(R), np.float64), np.asarray(densify(S), np.float64), 5)
    pos = osc > 0
    np.testing.assert_allclose(np.where(pos, sc, 0.0), np.where(pos, osc, 0.0), atol=1e-6)


def test_oracle_equals_jax_package(small_rs):
    R, S = small_rs
    pr = from_arrays(np.asarray(R.indices), np.asarray(R.values), np.asarray(R.nnz), R.dim)
    ps = from_arrays(np.asarray(S.indices), np.asarray(S.values), np.asarray(S.nnz), S.dim)
    got = oracle_knn(port_densify(pr).numpy(), port_densify(ps).numpy(), 7)
    want = jax_reference.oracle_knn(np.asarray(densify(R)), np.asarray(densify(S)), 7)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_host_csr_round_trip(small_rs):
    R, _ = small_rs
    h = _host(R, HostCSR)
    np.testing.assert_array_equal(h.to_dense(), np.asarray(densify(R), np.float64))
    part = h.slice_rows(5, 9)
    assert part.num_vectors == 4
    np.testing.assert_array_equal(part.to_dense(), h.to_dense()[5:9])
