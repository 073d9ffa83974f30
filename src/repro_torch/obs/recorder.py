"""Flight recorder: a bounded ring buffer of spans and fault events (a
copy of ``repro.obs.recorder``: plain Python, no backend).

The forensic half of the observability layer: every
finished span (request, batch, store dispatch, per-R-block fan-out,
mutation, recovery, resync, checkpoint) and every fault event (shard
loss, replica death, failover, half-open probe, retry, timeout, degraded
serve, injected faults) lands here as a plain dict.  The buffer is a
``deque(maxlen=capacity)`` — O(1) per event, oldest evicted first — so a
long-running server holds the *recent* record, which is the part that
explains the incident.

``dump()`` writes the buffer as JSONL on demand; a ``fault()`` event
additionally auto-dumps when ``auto_dump_path`` is set, so every
injected-fault bench/test run leaves an artifact without the caller
remembering to ask (the CI bench job uploads it next to the perf
record).

A process-global default recorder (:func:`get_recorder`) is what the
store, scheduler, and fault plan write to unless handed their own — one
timeline across layers is the point; tests isolate with
:func:`set_recorder`.
"""
from __future__ import annotations

import collections
import json
import threading
import time
from typing import Dict, List, Optional


class FlightRecorder:
    """Bounded event ring with JSONL dump-on-demand and dump-on-fault."""

    def __init__(self, capacity: int = 4096,
                 auto_dump_path: Optional[str] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.auto_dump_path = auto_dump_path
        self._events: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.recorded = 0           # lifetime events (ring is bounded)
        self.faults = 0             # lifetime fault events
        self.auto_dumps = 0

    # -- ingestion -----------------------------------------------------------

    def record(self, kind: str, **data) -> dict:
        """Append one event.  ``t_mono`` orders events on the span
        timeline; ``t_wall`` anchors them to the outside world."""
        ev = {"t_wall": time.time(), "t_mono": time.monotonic(),
              "kind": kind, **data}
        with self._lock:
            self._events.append(ev)
            self.recorded += 1
        return ev

    def record_span(self, span) -> dict:
        """A finished :class:`~repro_torch.obs.trace.Span` (duck-typed: anything
        with ``to_dict()``)."""
        ev = {"t_wall": time.time(), "kind": "span", **span.to_dict()}
        with self._lock:
            self._events.append(ev)
            self.recorded += 1
        return ev

    def fault(self, kind: str, **data) -> dict:
        """A fault event: recorded with ``fault: True`` and — when
        ``auto_dump_path`` is set — the whole ring dumps immediately, so
        the record survives whatever happens next."""
        ev = self.record(kind, fault=True, **data)
        self.faults += 1
        if self.auto_dump_path is not None:
            try:
                self.dump(self.auto_dump_path)
                self.auto_dumps += 1
            except OSError:
                pass            # a full disk must not take serving down
        return ev

    # -- inspection ----------------------------------------------------------

    def events(self, kind: Optional[str] = None) -> List[dict]:
        with self._lock:
            evs = list(self._events)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        return evs

    def summary(self) -> dict:
        """JSON-able shape for bench records: size, lifetime counts, and
        the per-kind census of what the ring currently holds."""
        with self._lock:
            evs = list(self._events)
        by_kind: Dict[str, int] = {}
        for e in evs:
            by_kind[e["kind"]] = by_kind.get(e["kind"], 0) + 1
        return {
            "events": len(evs),
            "capacity": self.capacity,
            "recorded": self.recorded,
            "evicted": self.recorded - len(evs),
            "faults": self.faults,
            "auto_dumps": self.auto_dumps,
            "by_kind": dict(sorted(by_kind.items())),
        }

    # -- dump ----------------------------------------------------------------

    def dump(self, path: Optional[str] = None) -> str:
        """Write the ring as JSONL (oldest first).  Returns the path."""
        path = path or self.auto_dump_path
        if path is None:
            raise ValueError("no dump path: pass one or set auto_dump_path")
        with self._lock:
            evs = list(self._events)
        with open(path, "w") as f:
            for ev in evs:
                f.write(json.dumps(ev, default=str) + "\n")
        return path

    def clear(self) -> None:
        with self._lock:
            self._events.clear()


_DEFAULT: Optional[FlightRecorder] = None
_DEFAULT_LOCK = threading.Lock()


def get_recorder() -> FlightRecorder:
    """The process-default recorder — the shared timeline the scheduler,
    store, engine spans, and fault plans all write to."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = FlightRecorder()
        return _DEFAULT


def set_recorder(recorder: Optional[FlightRecorder]) -> None:
    """Swap the process default (tests and benches isolate with this)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = recorder
