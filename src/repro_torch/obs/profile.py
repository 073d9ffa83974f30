"""Opt-in profiler hooks on ``torch.profiler`` (the PyTorch port's
counterpart of ``repro.obs.profile``).

Two independent tools, both off the hot path unless asked for:

* :class:`ProfileCapture` — a ``torch.profiler`` trace (CPU and, where a
  card is present, CUDA activities) around the next N scheduler batches,
  exported as a Chrome trace (``trace.json``) into ``logdir``.  The
  scheduler calls ``on_batch_start``/``on_batch_end`` unconditionally, on
  its event-loop thread; the queries themselves run on its dispatch
  worker, and the CUDA activities (CUPTI) are process-wide, so the
  worker's kernels (``topk_merge``, the products, the scatters) land in
  the trace.  The hook is inert until armed, and degrades to a no-op
  (``error`` set) where the profiler fails — it must never take serving
  down.

* :func:`fanout_report` — one store query of R under ``torch.profiler``:
  device time and launches by kernel name, and the FLOPs the profiler
  attributes to the ops it knows how to count (matrix products).  The
  reference's report compares an HLO walk of the compiled fan-out
  program with XLA's cost analysis; the port compiles no program and has
  no HLO, so ``compiled_report`` has no counterpart and this report is
  measured, not predicted.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Optional


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _device_us(evt) -> float:
    """An event's device time in µs (the attribute's name varies across
    PyTorch versions)."""
    return float(getattr(evt, "device_time_total", None)
                 or getattr(evt, "cuda_time_total", 0) or 0)


class ProfileCapture:
    """Capture a ``torch.profiler`` trace around the next ``n_batches``
    scheduler batches, writing ``trace.json`` to ``logdir``."""

    def __init__(self, logdir: str, n_batches: int = 3):
        if n_batches < 1:
            raise ValueError("n_batches must be >= 1")
        self.logdir = logdir
        self.n_batches = n_batches
        self.seen = 0
        self.active = False
        self.done = False
        self.error: Optional[str] = None
        self.trace_path: Optional[str] = None
        self._prof = None
        self._lock = threading.Lock()

    def on_batch_start(self) -> None:
        with self._lock:
            if self.done or self.active:
                return
            try:
                from torch.profiler import profile

                self._prof = profile(activities=_activities())
                self._prof.start()
                self.active = True
            except Exception as e:  # noqa: BLE001 — profiling is best-effort
                self.error = f"{type(e).__name__}: {e}"
                self.done = True

    def on_batch_end(self) -> None:
        with self._lock:
            if not self.active:
                return
            self.seen += 1
            if self.seen >= self.n_batches:
                self._stop_locked()

    def stop(self) -> None:
        """Stop early (scheduler shutdown with the capture still open)."""
        with self._lock:
            if self.active:
                self._stop_locked()

    def _stop_locked(self) -> None:
        try:
            self._prof.stop()
            os.makedirs(self.logdir, exist_ok=True)
            path = os.path.join(self.logdir, "trace.json")
            self._prof.export_chrome_trace(path)
            self.trace_path = path
        except Exception as e:  # noqa: BLE001 — see on_batch_start
            self.error = f"{type(e).__name__}: {e}"
        self._prof = None
        self.active = False
        self.done = True

    def summary(self) -> dict:
        return {"logdir": self.logdir, "batches": self.seen,
                "done": self.done, "error": self.error, "trace": self.trace_path}


def fanout_report(store, R, accuracy: Optional[str] = None) -> dict:
    """One ``store.query(R)`` under ``torch.profiler``: ``{"device",
    "wall_s", "device_ms", "launches", "kernels": {name: {"launches",
    "device_ms"}}, "flops"}``.  ``kernels`` holds every event with device
    time (the CUDA kernels; empty on the CPU), ``flops`` the sum the
    profiler records for the ops it counts (None when it records none).
    JSON-able."""
    import torch
    from torch.profiler import profile

    dev = getattr(store, "device", torch.device("cpu"))
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=_activities(), with_flops=True) as prof:
        t0 = time.perf_counter()
        store.query(R, accuracy=accuracy)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, flops = {}, 0
    for evt in prof.key_averages():
        flops += int(getattr(evt, "flops", 0) or 0)
        us = _device_us(evt)
        if us and evt.device_type.name == "CUDA":
            kernels[evt.key] = {"launches": int(evt.count), "device_ms": us / 1e3}
    return {
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "wall_s": wall,
        "device_ms": sum(k["device_ms"] for k in kernels.values()),
        "launches": sum(k["launches"] for k in kernels.values()),
        "kernels": kernels,
        "flops": flops or None,
    }
