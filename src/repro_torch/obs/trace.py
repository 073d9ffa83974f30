"""Request tracing: span trees with monotonic timestamps across threads (a
copy of ``repro.obs.trace``: plain Python, no backend).

A :class:`Span` is one timed operation; its ``parent_id`` links it into a
tree: request → batch → store dispatch → per-R-block fan-out →
de-interleave, plus standalone trees for mutations, recovery, resync,
and checkpoint save/load.  Timestamps are ``time.monotonic()`` — spans
order and subtract correctly even if the wall clock steps.

Propagation is a per-thread context stack (``threading.local``): entering
``tracer.span(...)`` pushes the new span, so code *below* the caller —
the store inside the scheduler's dispatch, the engine inside the store —
parents its spans correctly without any signature threading.  The
scheduler's dispatch executor is a different thread from the event loop,
so the scheduler carries the batch span across explicitly with
``tracer.attach(span)`` (push a foreign span without owning it).

The module-level :func:`span` / :func:`start_span` helpers are what the
engine and store call: they use whatever tracer is active on the current
thread, falling back to the process-default tracer (which records into
the default flight recorder).  Cost when tracing is disabled: one
thread-local read and a None check.

``start_span``/``end_span`` are the non-pushing variant for leaf spans
wrapped around loop bodies where a ``with`` block would force a reindent
and nothing nests below them anyway.

A device trace from ``torch.profiler`` stamps its events on another
clock: Unix-epoch nanoseconds (kineto's ``start_ns()``).
:func:`profiler_ns` maps a span's monotonic timestamp onto it, so an
event of the trace can be put under the span that was running.  The
offset between the two clocks is read once per process, from the
tightest of a few back-to-back reads of both; a step of the wall clock
after that read is not followed.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Iterator, Optional

from repro_torch.obs import recorder as _recorder_mod

_ids = itertools.count(1)
_local = threading.local()


class Span:
    """One timed operation.  ``attrs`` is small JSON-able metadata."""

    __slots__ = ("name", "span_id", "parent_id", "t_start", "t_end", "attrs")

    def __init__(self, name: str, span_id: int, parent_id: Optional[int],
                 **attrs):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.t_start = time.monotonic()
        self.t_end: Optional[float] = None
        self.attrs = attrs

    @property
    def duration_s(self) -> Optional[float]:
        if self.t_end is None:
            return None
        return self.t_end - self.t_start

    def to_dict(self) -> dict:
        d = self.duration_s
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "t_start": self.t_start,
            "t_end": self.t_end,
            "dur_ms": None if d is None else round(d * 1e3, 4),
            "attrs": self.attrs,
        }

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.span_id}, "
                f"parent={self.parent_id}, dur={self.duration_s})")


_CLOCK_READS = 8
_profiler_offset_ns: Optional[int] = None


def _clock_offset_ns() -> int:
    """``time.time_ns()`` minus ``time.monotonic_ns()``, from the pair of
    reads that a wall-clock read fell between most tightly."""
    best = None
    for _ in range(_CLOCK_READS):
        m0 = time.monotonic_ns()
        wall = time.time_ns()
        m1 = time.monotonic_ns()
        if best is None or m1 - m0 < best[0]:
            best = (m1 - m0, wall - (m0 + m1) // 2)
    return best[1]


def profiler_ns(t_mono: float) -> int:
    """A span timestamp (``Span.t_start``/``t_end``, ``time.monotonic()``
    seconds) on the profiler's clock: Unix-epoch nanoseconds, as kineto's
    ``start_ns()`` reports an event."""
    global _profiler_offset_ns
    if _profiler_offset_ns is None:
        _profiler_offset_ns = _clock_offset_ns()
    return round(t_mono * 1e9) + _profiler_offset_ns


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def current_span() -> Optional[Span]:
    st = getattr(_local, "stack", None)
    return st[-1][1] if st else None


def current_tracer() -> Optional["Tracer"]:
    st = getattr(_local, "stack", None)
    return st[-1][0] if st else None


class Tracer:
    """Span factory bound to a flight recorder.

    ``enabled=False`` makes every call a no-op returning ``None`` spans —
    the bit-parity tests and the overhead gate compare against this.
    """

    def __init__(self, recorder=None, enabled: bool = True):
        self.recorder = recorder
        self.enabled = enabled

    def _recorder(self):
        return self.recorder or _recorder_mod.get_recorder()

    def begin(self, name: str, parent: Optional[Span] = None, **attrs
              ) -> Optional[Span]:
        """Start a span.  ``parent`` defaults to the thread's current
        span (None → a root).  Does NOT push context — pair with
        :meth:`end`, or use :meth:`span` for the pushing form."""
        if not self.enabled:
            return None
        if parent is None:
            parent = current_span()
        return Span(name, next(_ids),
                    None if parent is None else parent.span_id, **attrs)

    def end(self, span: Optional[Span], **attrs) -> Optional[Span]:
        """Finish a span and hand it to the recorder (idempotent on
        None / already-ended spans)."""
        if span is None or span.t_end is not None:
            return span
        span.t_end = time.monotonic()
        if attrs:
            span.attrs.update(attrs)
        self._recorder().record_span(span)
        return span

    @contextlib.contextmanager
    def span(self, name: str, parent: Optional[Span] = None, **attrs
             ) -> Iterator[Optional[Span]]:
        """``with tracer.span("store.dispatch"):`` — begin, push context
        (children on this thread parent here), end on exit (even on
        error, with ``error`` recorded)."""
        s = self.begin(name, parent=parent, **attrs)
        if s is None:
            yield None
            return
        _stack().append((self, s))
        try:
            yield s
        except BaseException as e:
            self.end(s, error=f"{type(e).__name__}: {e}")
            raise
        finally:
            _stack().pop()
            self.end(s)

    @contextlib.contextmanager
    def attach(self, span: Optional[Span]) -> Iterator[None]:
        """Adopt a span started on ANOTHER thread as this thread's
        current context (the scheduler carries the batch span onto the
        dispatch executor with this).  The span is not ended here —
        its owner ends it.  ``attach(None)`` is a no-op."""
        if span is None or not self.enabled:
            yield
            return
        _stack().append((self, span))
        try:
            yield
        finally:
            _stack().pop()


_default_tracer: Optional[Tracer] = None
_default_lock = threading.Lock()


def default_tracer() -> Tracer:
    """The process-default tracer (records to the default recorder).
    Store/engine spans outside any serving context land here."""
    global _default_tracer
    tracer = _default_tracer
    if tracer is not None:      # made once: read without the lock
        return tracer
    with _default_lock:
        if _default_tracer is None:
            _default_tracer = Tracer()
        return _default_tracer


def set_tracing(enabled: bool) -> None:
    """Globally enable/disable the default tracer (per-scheduler tracers
    carry their own flag)."""
    default_tracer().enabled = enabled


def _active() -> Tracer:
    return current_tracer() or default_tracer()


def span(name: str, **attrs):
    """Module-level ``with span("engine.r_block", r0=r0):`` — uses the
    thread's active tracer, else the process default."""
    return _active().span(name, **attrs)


def start_span(name: str, **attrs) -> Optional[Span]:
    """Non-pushing begin on the active tracer (leaf spans around loop
    bodies).  Pair with :func:`end_span`."""
    return _active().begin(name, **attrs)


def end_span(s: Optional[Span], **attrs) -> Optional[Span]:
    if s is None:
        return None
    return _active().end(s, **attrs)
