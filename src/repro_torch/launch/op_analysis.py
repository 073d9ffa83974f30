"""ATen-op analysis of one call (the counterpart of the JAX package's
``launch/hlo_analysis.py``).

The reference re-derives the roofline numerators from compiled HLO text,
walking ``while`` bodies by their trip counts.  The port runs eagerly, so
the counterpart watches the ATen operations a call dispatches
(``TorchDispatchMode``), on any device — meta tensors too, where nothing
runs and only shapes and dtypes flow.  Python loops over layers, chunks and
microbatches dispatch every iteration, so no trip count is needed.

* **flops**       — 2 · |result| · |contraction| per ``mm`` / ``bmm`` /
                    ``addmm`` / ``baddbmm`` (``einsum``, ``matmul`` and
                    ``@`` lower to these), plus the hand-written kernels'
                    own counts: their wrappers report one launch each, with
                    its FLOPs and bytes, and hide their own ATen ops
                    (``kernels/_build.py::analysed``);
* **hbm_bytes**   — Σ (operand + result bytes) of every ATen op but views
                    and bare allocations: in eager mode each op is a kernel
                    that reads its operands and writes its result (the
                    reference's "top-level ops, fusion internals excluded");
* **collectives** — what a mesh step copies between positions, keyed
                    ``gathered`` and ``reduced`` (``launch/steps.py``'s
                    ``train_step.stats``); the dry run adds them from the
                    placement (:meth:`Analysis.collective`), since a traced
                    slice copies nothing;
* **kernel_launches** — launches by kernel;
* **peak_live_bytes** — the high-water mark of the storage the call's
                    results hold alive (each result's storage tracked until
                    the last tensor on it is freed): an estimate of the
                    reference's ``memory_analysis`` temp size.

Counts are per call; the dry run (``launch/dryrun.py``) traces one mesh
position's step, so they are per position ("per chip").
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import _build

COLLECTIVES = ("gathered", "reduced")

_aten = torch.ops.aten
MATMULS = {_aten.mm: 0, _aten.bmm: 0, _aten.addmm: 1, _aten.baddbmm: 1}  # op -> lhs argument
_ALLOCS = {_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
           _aten.new_empty_strided}


@dataclasses.dataclass
class Analysis:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collectives: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=lambda: {k: {"count": 0.0, "bytes": 0.0} for k in COLLECTIVES})
    # bytes by group size: the number of positions a gathered leaf's
    # blocks, or a reduced gradient's owners, spread over
    collective_by_group: Dict[int, float] = dataclasses.field(default_factory=dict)
    aten_flops: float = 0.0
    kernel_flops: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    ops: int = 0
    peak_live_bytes: int = 0

    def total_collective_bytes(self) -> float:
        return sum(v["bytes"] for v in self.collectives.values())

    def collective(self, kind: str, count: float, nbytes: float, group: int) -> None:
        self.collectives[kind]["count"] += count
        self.collectives[kind]["bytes"] += nbytes
        self.collective_by_group[group] = self.collective_by_group.get(group, 0.0) + nbytes


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class OpAnalysis(TorchDispatchMode):
    """``with OpAnalysis() as a: fn()`` — ``a.result`` is the
    :class:`Analysis` of every ATen op ``fn`` dispatched (see the module
    doc).  Analyses do not nest: entering one while another listens raises."""

    def __init__(self):
        super().__init__()
        self.result = Analysis()
        self.paused = 0          # > 0 while a kernel wrapper's own ops run
        self._live = 0
        self._held: Dict[int, list] = {}   # storage -> [tensors alive on it, bytes]

    def __enter__(self):
        # the mode re-enters itself to decompose a composite op; another
        # analysis would see the ops of this one and none of its kernels
        if any(r is not self for r in _build.RECORDERS):
            raise RuntimeError("an op analysis is already listening: analyses do not nest")
        _build.RECORDERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _build.RECORDERS.remove(self)
        return super().__exit__(*exc)

    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        """Count one launch of a hand-written kernel (its wrapper calls this)."""
        a = self.result
        a.flops += flops
        a.hbm_bytes += nbytes
        a.kernel_flops[name] = a.kernel_flops.get(name, 0.0) + flops
        a.kernel_launches[name] = a.kernel_launches.get(name, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # under inference mode composite ops (matmul, einsum) reach the mode
        # whole: run their decomposition, whose ops come back through it
        with self:
            out = func.decompose(*args, **kwargs)
        if out is not NotImplemented:
            return out
        out = func(*args, **kwargs)
        if self.paused:
            return out
        a = self.result
        a.ops += 1
        ins = [x for x in tree_flatten((args, kwargs))[0] if isinstance(x, torch.Tensor)]
        outs = [x for x in tree_flatten(out)[0] if isinstance(x, torch.Tensor)]
        packet = func.overloadpacket
        if packet in MATMULS and outs:
            lhs = args[MATMULS[packet]]
            f = 2.0 * outs[0].numel() * lhs.shape[-1]
            a.flops += f
            a.aten_flops += f
        if not func.is_view and packet not in _ALLOCS:
            a.hbm_bytes += sum(_nbytes(x) for x in ins) + sum(_nbytes(x) for x in outs)
        self._track(func, ins, outs)
        return out

    def _track(self, func, ins, outs) -> None:
        """Hold each result's storage live until the last tensor on it dies."""
        in_keys = {_storage_key(x) for x in ins}
        for x in outs:
            key = _storage_key(x)
            if key in self._held:
                held = self._held[key]
            elif func.is_view or key in in_keys:
                continue            # a view or an in-place result of storage made elsewhere
            else:
                held = self._held[key] = [0, x.untyped_storage().nbytes()]
                self._live += held[1]
                self.result.peak_live_bytes = max(self.result.peak_live_bytes, self._live)
            held[0] += 1
            weakref.finalize(x, self._release, key)

    def _release(self, key: int) -> None:
        held = self._held[key]
        held[0] -= 1
        if held[0] == 0:
            self._live -= held[1]
            del self._held[key]


def analyze(fn, *args, **kwargs):
    """(``fn(*args, **kwargs)``, the :class:`Analysis` of the call)."""
    with OpAnalysis() as mode:
        out = fn(*args, **kwargs)
    return out, mode.result
