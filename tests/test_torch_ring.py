"""The port's multi-device join (src/repro_torch/core/ring.py,
``core/engine.py::distributed_join``, ``core/iiib.py::
iiib_join_block_uniform``) against the JAX package on the same seeded
inputs, on the CPU.

The JAX ring needs one device a mesh position, so it runs once in a
subprocess with 8 forced host devices (``tests/util_subproc.py::
run_with_devices``) over the scenario code in ``SCENARIOS``; the port runs
the same code in-process on a ``DeviceMesh`` of 8 CPU entries.  Scenarios,
on a (4, 2) ``('data', 'model')`` mesh, for R 60 × S 90 (the reference's
``tests/test_distributed.py`` case): ``pad_to_ring``; ``_ring_join_impl``
for bf, iib and iiib over ``data``; bf and iib with ``dim_axis='model'``
(iiib with it raises ``ValueError`` in both); ``ring_knn_join`` through
the store route (iib; the store itself is held per algorithm in
tests/test_torch_store.py).  For ragged odd R 37 × S 53 (both
padded): ``pad_to_ring``, the bf ring, the iiib store route, and bf over
both axes (8 positions).  And
``distributed_join`` with an S of 3 valid rows (fewer than the 4 ring
positions: the ring route).  (Each JAX ring call compiles anew, 2–10 s on
the CPU, so the ragged case takes one call a route.)

Tolerances: scores within rtol=atol=1e-6 and ids equal outside tie groups
(``assert_topk_close``); ``pad_to_ring`` byte for byte.
``iiib_join_block_uniform`` is held in-process, one step against the JAX
function on the same index arrays, with a dense prefix below the crossing.
"""
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.engine import JoinSpec, distributed_join  # noqa: E402
from repro_torch.core.ring import _ring_join_impl, pad_to_ring, ring_knn_join  # noqa: E402
from repro_torch.launch.mesh import DeviceMesh  # noqa: E402
from repro_torch.sparse.datagen import synthetic_sparse  # noqa: E402
from repro_torch.sparse.format import from_arrays  # noqa: E402
from repro_torch.testing import assert_topk_close  # noqa: E402
from tests.util_subproc import run_with_devices  # noqa: E402

RTOL = ATOL = 1e-6
DIM, NNZ = 512, 20
# name -> (rows, seed) of the seeded inputs both packages read
INPUTS = {"R": (60, 0), "S": (90, 1), "R2": (37, 3), "S2": (53, 4), "S3": (3, 5)}
ALGS = ("bf", "iib", "iiib")

# The scenario code both packages run.  ``api`` adapts the package: its
# ``mesh(shape, names)``, ``data(name)``, ``ring``, ``ring_knn_join``,
# ``distributed_join``, ``pad_to_ring``, ``JoinSpec`` and ``asnp``.
SCENARIOS = r'''
ALGS = ("bf", "iib", "iiib")


def rec(out, tag, st, api):
    out[tag + "/scores"] = api.asnp(st.scores)
    out[tag + "/ids"] = api.asnp(st.ids)


def run_all(api):
    out = {}
    mesh = api.mesh((4, 2), ("data", "model"))
    # R 60 x S 90 (S pads to 92): every route and algorithm.  Ragged odd
    # R 37 x S 53 (both pad): one case of each route, each on another
    # algorithm.  ring8: over both axes, 8 positions.
    cases = {"RxS": ("R", "S", ALGS, ("bf", "iib", "iiib"), ("iib",)),
             "R2xS2": ("R2", "S2", ("bf",), (), ("iiib",))}
    for tag, (rn, sn, ring_algs, dim_algs, store_algs) in cases.items():
        p = tag + "/"
        R, S = api.data(rn), api.data(sn)
        Rp, nr = api.pad_to_ring(R, 4)
        Sp, ns = api.pad_to_ring(S, 4)
        for name, (b, n) in (("R", (Rp, nr)), ("S", (Sp, ns))):
            out[p + "pad/" + name] = (api.asnp(b.indices), api.asnp(b.values),
                                      api.asnp(b.nnz), int(b.dim), int(n))
        kw = dict(ring_axes=("data",), n_r_valid=nr, n_s_valid=ns)
        for alg in ring_algs:
            rec(out, p + "ring/" + alg, api.ring(Rp, Sp, 5, mesh, algorithm=alg, **kw), api)
        for alg in dim_algs:
            try:
                st = api.ring(Rp, Sp, 5, mesh, algorithm=alg, dim_axis="model", **kw)
                rec(out, p + "dim/" + alg, st, api)
            except ValueError:
                out[p + "dim/" + alg + "/raised"] = "ValueError"
        for alg in store_algs:
            rec(out, p + "store/" + alg, api.ring_knn_join(Rp, Sp, 5, mesh, algorithm=alg,
                                                           **kw), api)
    R8, nr8 = api.pad_to_ring(api.data("R2"), 8)
    S8, ns8 = api.pad_to_ring(api.data("S2"), 8)
    rec(out, "ring8/bf", api.ring(R8, S8, 5, mesh, algorithm="bf", ring_axes=("data", "model"),
                                  n_r_valid=nr8, n_s_valid=ns8), api)
    # S with fewer valid rows than ring positions: distributed_join's ring route
    Rp, nr = api.pad_to_ring(api.data("R"), 4)
    S3, n3 = api.pad_to_ring(api.data("S3"), 4)
    rec(out, "few/bf", api.distributed_join(Rp, S3, api.JoinSpec(k=5, algorithm="bf"), mesh,
                                            ring_axes=("data",), n_r_valid=nr, n_s_valid=n3),
        api)
    return out
'''

JAX_ADAPTER = r'''
import pickle, types
import numpy as np
import jax.numpy as jnp
from repro import compat
from repro.core.engine import JoinSpec, distributed_join
from repro.core.ring import _ring_join_impl, pad_to_ring, ring_knn_join
from repro.sparse.format import SparseBatch

inputs = np.load(INPUT_PATH)

def data(name):
    return SparseBatch(indices=jnp.asarray(inputs[name + "_idx"]),
                       values=jnp.asarray(inputs[name + "_val"]),
                       nnz=jnp.asarray(inputs[name + "_nnz"]), dim=int(inputs["dim"]))

api = types.SimpleNamespace(mesh=compat.make_mesh, data=data, ring=_ring_join_impl,
                            ring_knn_join=ring_knn_join, distributed_join=distributed_join,
                            pad_to_ring=pad_to_ring, JoinSpec=JoinSpec, asnp=np.asarray)
with open(OUTPUT_PATH, "wb") as f:
    pickle.dump(run_all(api), f)
print("JAX_RING_DONE")
'''


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The seeded inputs both packages read, as arrays and as an npz file."""
    arrays = {"dim": np.asarray(DIM)}
    for name, (rows, seed) in INPUTS.items():
        b = synthetic_sparse(rows, dim=DIM, nnz_mean=NNZ, seed=seed)
        arrays[name + "_idx"] = b.indices.numpy()
        arrays[name + "_val"] = b.values.numpy()
        arrays[name + "_nnz"] = b.nnz.numpy()
    path = tmp_path_factory.mktemp("ring_inputs") / "inputs.npz"
    np.savez(path, **arrays)
    return arrays, str(path)


@pytest.fixture(scope="module")
def jax_out(inputs, tmp_path_factory):
    """Every scenario's results from the JAX package (8 forced host devices)."""
    out_path = str(tmp_path_factory.mktemp("ring_jax") / "out.pkl")
    code = (f"INPUT_PATH = {inputs[1]!r}\nOUTPUT_PATH = {out_path!r}\n" + SCENARIOS
            + JAX_ADAPTER)
    assert "JAX_RING_DONE" in run_with_devices(code, n_devices=8)
    with open(out_path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def port_out(inputs):
    import types

    arrays = inputs[0]

    def data(name):
        return from_arrays(arrays[name + "_idx"], arrays[name + "_val"],
                           arrays[name + "_nnz"], DIM)

    def mesh(shape, names):
        return DeviceMesh(np.full(shape, "cpu", dtype=object), names)

    api = types.SimpleNamespace(mesh=mesh, data=data, ring=_ring_join_impl,
                                ring_knn_join=ring_knn_join, distributed_join=distributed_join,
                                pad_to_ring=pad_to_ring, JoinSpec=JoinSpec,
                                asnp=lambda t: t.numpy())
    ns = {}
    exec(compile(SCENARIOS, "<ring scenarios>", "exec"), ns)
    return ns["run_all"](api)


def _hold(port_out, jax_out, tag):
    assert_topk_close(port_out[tag + "/scores"], port_out[tag + "/ids"],
                      jax_out[tag + "/scores"], jax_out[tag + "/ids"], RTOL, ATOL)


RING = [("RxS", a) for a in ALGS] + [("R2xS2", "bf")]
DIM_AXIS = [("RxS", a) for a in ALGS]
STORE = [("RxS", "iib"), ("R2xS2", "iiib")]


@pytest.mark.subproc
@pytest.mark.parametrize("case", ["RxS", "R2xS2"])
def test_pad_to_ring_byte_identical(port_out, jax_out, case):
    for name in ("R", "S"):
        tag = f"{case}/pad/{name}"
        got, want = port_out[tag], jax_out[tag]
        assert got[3:] == want[3:], tag
        for g, w in zip(got[:3], want[:3]):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), tag


@pytest.mark.subproc
@pytest.mark.parametrize("case,alg", RING)
def test_ring_matches_jax_ring(port_out, jax_out, case, alg):
    """``_ring_join_impl`` over the data axis of a (4, 2) mesh."""
    _hold(port_out, jax_out, f"{case}/ring/{alg}")


@pytest.mark.subproc
@pytest.mark.parametrize("case,alg", DIM_AXIS)
def test_dim_axis_ring_matches_jax_ring(port_out, jax_out, case, alg):
    """``dim_axis='model'``: bf and iib sum each model position's partial
    scores; iiib raises ValueError in both packages."""
    tag = f"{case}/dim/{alg}"
    if alg == "iiib":
        assert port_out[tag + "/raised"] == jax_out[tag + "/raised"] == "ValueError"
    else:
        _hold(port_out, jax_out, tag)


@pytest.mark.subproc
def test_ring_over_two_axes_matches_jax_ring(port_out, jax_out):
    """bf over ('data', 'model'): 8 ring positions, flattened data-major."""
    _hold(port_out, jax_out, "ring8/bf")


@pytest.mark.subproc
@pytest.mark.parametrize("case,alg", STORE)
def test_ring_knn_join_store_route_matches_jax(port_out, jax_out, case, alg):
    """``ring_knn_join`` without ``dim_axis``: the store over the mesh."""
    _hold(port_out, jax_out, f"{case}/store/{alg}")


@pytest.mark.subproc
def test_distributed_join_few_s_rows_matches_jax(port_out, jax_out):
    """``distributed_join`` with 3 valid S rows on 4 ring positions."""
    _hold(port_out, jax_out, "few/bf")


# -- the port alone -----------------------------------------------------------

def _cpu_mesh(shape, names):
    return DeviceMesh(np.full(shape, "cpu", dtype=object), names)


@pytest.mark.parametrize("alg", ALGS)
def test_store_route_is_the_store_and_ring_agrees(alg):
    """The two routes of ``distributed_join`` agree with one index over S
    (ids equal outside tie groups on positive scores), and the store route
    equals a ``ShardedKNNStore`` over the mesh bit for bit; a ring driver
    with unpadded rows raises, naming the ring size."""
    from repro_torch.core.engine import SparseKNNIndex
    from repro_torch.store import ShardedKNNStore

    R = synthetic_sparse(40, dim=DIM, nnz_mean=NNZ, seed=0)
    S = synthetic_sparse(64, dim=DIM, nnz_mean=NNZ, seed=1)
    mesh = _cpu_mesh((4, 2), ("data", "model"))
    spec = JoinSpec(k=5, algorithm=alg)
    via_store = distributed_join(R, S, spec, mesh)
    store = ShardedKNNStore(S, spec, mesh=mesh, axes=("data",)).query(R)
    assert torch.equal(via_store.scores, store.scores) and torch.equal(via_store.ids, store.ids)
    ring = _ring_join_impl(R, S, 5, mesh, algorithm=alg)
    single = SparseKNNIndex.build(S, spec, device="cpu").query(R)
    pos = single.scores.numpy() > 0
    for got in (via_store, ring):
        s = got.scores.numpy()
        np.testing.assert_allclose(np.where(pos, s, 0), np.where(pos, single.scores.numpy(), 0),
                                   rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="ring size 4"):
        _ring_join_impl(R.rows(0, 39), S, 5, mesh, algorithm=alg)


def test_iiib_join_block_uniform_matches_jax():
    """One ring step of IIIB against the JAX function on the same inputs:
    a first step from an empty state (no prefix; R is the block's first
    rows, so each row finds itself), then a second step whose threshold
    (the self scores, k = 1) puts the block-uniform crossing above tile 0,
    so the dense prefix runs."""
    import jax
    import jax.numpy as jnp

    from repro.core import iiib as jax_iiib
    from repro.core.index import build_tile_index as jax_build
    from repro.core.topk import init_topk as jax_init_topk
    from repro.core.topk import min_prune_score as jax_mps
    from repro.sparse.format import SparseBatch as JaxBatch
    from repro_torch.core import iiib
    from repro_torch.core.index import build_tile_index
    from repro_torch.core.topk import init_topk, min_prune_score

    tile, k = 16, 1
    blocks = [synthetic_sparse(40, dim=256, nnz_mean=30, nnz_std=3, seed=s) for s in (4, 5)]
    Rt = blocks[0].rows(0, 24)

    def jb(b):
        return JaxBatch(indices=jnp.asarray(b.indices.numpy()),
                        values=jnp.asarray(b.values.numpy()),
                        nnz=jnp.asarray(b.nnz.numpy()), dim=b.dim)

    # one compiled builder (the eager builder compiles op by op)
    j_build = jax.jit(lambda b, rank, maxw, mps: jax_build(
        b, max_rows=40, tile=tile, rank=rank, maxw=maxw, min_prune_score=mps, uniform=True))
    rank, maxw, r_tiles = iiib.prepare_r_block(Rt, tile)
    j_rank, j_maxw, j_r_tiles = jax_iiib.prepare_r_block(jb(Rt), tile)
    np.testing.assert_array_equal(rank.numpy(), np.asarray(j_rank))
    state, j_state = init_topk(24, k, device="cpu"), jax_init_topk(24, k)
    valid = np.arange(40) < 37                    # a ragged block's padding rows
    crossings = []
    for step, S in enumerate(blocks):
        index = build_tile_index(S, max_rows=40, tile=tile, rank=rank, maxw=maxw,
                                 min_prune_score=min_prune_score(state), uniform=True)
        j_index = j_build(jb(S), j_rank, j_maxw, jax_mps(j_state))
        crossings.append(int(index.crossing[0]))
        assert crossings[-1] == int(j_index.crossing[0])
        state = iiib.iiib_join_block_uniform(state, Rt, r_tiles, rank, index, S, 40 * step,
                                             torch.as_tensor(valid), tile=tile)
        j_state = jax_iiib.iiib_join_block_uniform(
            j_state, jb(Rt), j_r_tiles, j_rank, j_index, jb(S), jnp.int32(40 * step),
            jnp.asarray(valid), tile=tile)
        assert_topk_close(state.scores.numpy(), state.ids.numpy(), np.asarray(j_state.scores),
                          np.asarray(j_state.ids), RTOL, ATOL)
    assert crossings[0] == 0 and crossings[1] > 0, crossings
