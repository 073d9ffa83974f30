"""Typed metric registry: Counter / Gauge / Histogram + OpenMetrics text
(a copy of ``repro.obs.registry``: plain Python, no backend).

One registry is the single backing store for a component's counters: a
stats object keeps its attribute API (``m.submitted``, ``m.retries += 1``)
while every one of those attributes resolves to a typed instrument
registered here, so a JSON summary and the text exposition can never
drift: they read the same cells.  The engine's own instrument is the
IIIB ``knn_min_prune_threshold`` histogram in the process registry.

Instruments:

* :class:`Counter` — monotone by convention; ``inc(n)`` on the hot path.
  ``set()`` exists as the attribute-assignment compatibility channel
  (``m.retries += 1`` lowers to get + set) — the registry does not police
  monotonicity, the callers that were correct before stay correct.
* :class:`Gauge` — a settable level (queue depth, inflight).
* :class:`Histogram` — FIXED buckets chosen at registration (cumulative
  ``le`` counts, OpenMetrics-style).  ``observe()`` is a bisect + two
  adds: O(log buckets), no sample retention — the bounded-window
  percentile view belongs to a rolling window beside it; the
  histogram is the lossless lifetime distribution.
* ``bind()`` — a read-only callback instrument for values owned
  elsewhere (a dataclass field, a property): the exposition pulls it at
  collect time.  This is how stats objects that must stay plain (the
  per-query ``JoinStats`` scratch) still appear in one exposition.

``expose()`` emits OpenMetrics-style text (``# TYPE`` / ``# HELP``
comment lines, ``_total`` counter samples, cumulative ``_bucket{le=...}``
histogram samples, ``# EOF`` terminator); :func:`parse_exposition` is the
inverse used by the round-trip tests.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

_NAME_OK = None


def _check_name(name: str) -> str:
    global _NAME_OK
    if _NAME_OK is None:
        import re

        _NAME_OK = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
    if not _NAME_OK.match(name):
        raise ValueError(f"invalid metric name {name!r}")
    return name


class Counter:
    """Monotone (by convention) cumulative count."""

    kind = "counter"
    __slots__ = ("name", "help", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = _check_name(name)
        self.help = help
        self._value: Union[int, float] = 0

    def inc(self, n: Union[int, float] = 1) -> None:
        self._value += n

    def set(self, v: Union[int, float]) -> None:
        """Attribute-assignment compatibility channel (``x += 1`` lowers
        to get + set); also the checkpoint/restore path."""
        self._value = v

    @property
    def value(self) -> Union[int, float]:
        return self._value


class Gauge:
    """A settable level."""

    kind = "gauge"
    __slots__ = ("name", "help", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = _check_name(name)
        self.help = help
        self._value: Union[int, float] = 0

    def set(self, v: Union[int, float]) -> None:
        self._value = v

    def inc(self, n: Union[int, float] = 1) -> None:
        self._value += n

    def dec(self, n: Union[int, float] = 1) -> None:
        self._value -= n

    @property
    def value(self) -> Union[int, float]:
        return self._value


# seconds-scale latency buckets (sub-ms to 10 s) — the serving default
DEFAULT_TIME_BUCKETS_S = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class Histogram:
    """Fixed-bucket distribution (cumulative ``le`` counts + sum/count)."""

    kind = "histogram"
    __slots__ = ("name", "help", "buckets", "counts", "sum", "count")

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_TIME_BUCKETS_S):
        self.name = _check_name(name)
        self.help = help
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError("histogram needs at least one finite bucket")
        self.buckets = bs                       # +Inf bucket is implicit
        self.counts = [0] * (len(bs) + 1)       # per-bucket (non-cumulative)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        if not math.isfinite(v):
            return                              # -inf seeds / NaN guards
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1

    def cumulative(self) -> List[Tuple[float, int]]:
        """[(le, cumulative_count), ..., (inf, total)] — exposition order."""
        out, acc = [], 0
        for b, c in zip(self.buckets, self.counts):
            acc += c
            out.append((b, acc))
        out.append((math.inf, acc + self.counts[-1]))
        return out


class _Bound:
    """Read-only callback instrument: the value lives elsewhere."""

    __slots__ = ("name", "help", "kind", "fn")

    def __init__(self, name: str, fn: Callable[[], Union[int, float]],
                 help: str = "", kind: str = "gauge"):
        if kind not in ("gauge", "counter"):
            raise ValueError(f"bind kind must be gauge|counter, got {kind!r}")
        self.name = _check_name(name)
        self.help = help
        self.kind = kind
        self.fn = fn

    @property
    def value(self) -> Union[int, float]:
        return self.fn()


def _fmt(v: Union[int, float]) -> str:
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if f == math.inf:
        return "+Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class MetricRegistry:
    """Ordered name → instrument map with idempotent registration.

    Re-registering a name returns the existing instrument (so a metrics
    object can be rebuilt over a shared registry); a kind clash raises.
    """

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _register(self, cls, name: str, help: str, **kw):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                want = kw.get("kind", cls.kind if cls is not _Bound else None)
                if (cls is not _Bound and type(existing) is not cls) or (
                        cls is _Bound and not isinstance(existing, _Bound)):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(existing).__name__}, wanted {want or cls.__name__}")
                return existing
            inst = cls(name, help=help, **kw) if cls is not _Bound else None
            if cls is _Bound:
                inst = _Bound(name, kw["fn"], help=help, kind=kw.get("kind", "gauge"))
            self._metrics[name] = inst
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS_S) -> Histogram:
        return self._register(Histogram, name, help, buckets=buckets)

    def bind(self, name: str, fn: Callable[[], Union[int, float]],
             help: str = "", kind: str = "gauge") -> _Bound:
        return self._register(_Bound, name, help, fn=fn, kind=kind)

    def get(self, name: str):
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return list(self._metrics)

    def collect(self) -> Dict[str, object]:
        """Point-in-time values: scalars for counters/gauges/bound, a
        ``{"sum", "count", "buckets": {le: cumulative}}`` dict for
        histograms."""
        out: Dict[str, object] = {}
        for name, m in self._metrics.items():
            if isinstance(m, Histogram):
                out[name] = {
                    "sum": m.sum, "count": m.count,
                    "buckets": {le: c for le, c in m.cumulative()},
                }
            else:
                out[name] = m.value
        return out

    def expose(self) -> str:
        """OpenMetrics-style text exposition of every instrument."""
        lines: List[str] = []
        for name, m in self._metrics.items():
            kind = m.kind
            lines.append(f"# TYPE {name} {kind}")
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            if isinstance(m, Histogram):
                for le, c in m.cumulative():
                    lines.append(f'{name}_bucket{{le="{_fmt(le)}"}} {c}')
                lines.append(f"{name}_sum {_fmt(m.sum)}")
                lines.append(f"{name}_count {m.count}")
            elif kind == "counter":
                lines.append(f"{name}_total {_fmt(m.value)}")
            else:
                lines.append(f"{name} {_fmt(m.value)}")
        lines.append("# EOF")
        return "\n".join(lines) + "\n"


def parse_exposition(text: str) -> Dict[str, dict]:
    """Inverse of :meth:`MetricRegistry.expose` (round-trip tests).

    Returns ``{name: {"type": ..., "value": ...}}`` with histograms as
    ``{"type": "histogram", "buckets": {le: cumulative}, "sum", "count"}``.
    """
    out: Dict[str, dict] = {}
    saw_eof = False
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line == "# EOF":
            saw_eof = True
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(None, 3)
            out[name] = {"type": kind}
            if kind == "histogram":
                out[name].update({"buckets": {}, "sum": None, "count": None})
            continue
        if line.startswith("#"):
            continue
        sample, val_s = line.rsplit(None, 1)
        val = math.inf if val_s == "+Inf" else (
            float(val_s) if ("." in val_s or "e" in val_s) else int(val_s))
        if "{" in sample:
            base, label = sample.split("{", 1)
            name = base[: base.rindex("_")] if base.endswith("_bucket") else base
            le_s = label[len('le="'):-len('"}')]
            le = math.inf if le_s == "+Inf" else float(le_s)
            out[name]["buckets"][le] = val
        elif sample.endswith("_sum") and sample[:-4] in out:
            out[sample[:-4]]["sum"] = val
        elif sample.endswith("_count") and sample[:-6] in out:
            out[sample[:-6]]["count"] = val
        elif sample.endswith("_total") and sample[:-6] in out:
            out[sample[:-6]]["value"] = val
        else:
            out.setdefault(sample, {"type": "untyped"})["value"] = val
    if not saw_eof:
        raise ValueError("exposition text is not terminated with # EOF")
    return out


_DEFAULT: Optional[MetricRegistry] = None
_DEFAULT_LOCK = threading.Lock()


def get_registry() -> MetricRegistry:
    """The process-default registry (engine-level instruments that have no
    natural owner object — e.g. the IIIB MinPruneScore histogram)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = MetricRegistry()
        return _DEFAULT


def set_registry(registry: Optional[MetricRegistry]) -> None:
    """Swap the process default (tests isolate themselves with this)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = registry
