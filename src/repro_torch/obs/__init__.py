"""Observability layer: copies of the JAX package's plain-Python
``repro.obs`` modules.

  registry — typed Counter/Gauge/Histogram instruments with
             OpenMetrics-style text exposition (`MetricRegistry.expose`).
  trace    — span trees with monotonic timestamps, propagated via a
             per-thread context stack (the engine's ``engine.r_block``).
  recorder — the flight recorder: a bounded ring of recent spans and
             fault events that dumps JSONL on demand and on fault.
  profile  — opt-in `torch.profiler` capture around N scheduler batches,
             and a measured report of one store query's device time by
             kernel (the reference's HLO report has no counterpart: the
             port compiles no program).
"""
from repro_torch.obs.recorder import FlightRecorder, get_recorder, set_recorder
from repro_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    get_registry,
    parse_exposition,
    set_registry,
)
from repro_torch.obs.trace import Span, Tracer, default_tracer, set_tracing
from repro_torch.obs.profile import ProfileCapture, fanout_report

__all__ = [
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "ProfileCapture",
    "Span",
    "Tracer",
    "default_tracer",
    "fanout_report",
    "get_recorder",
    "get_registry",
    "parse_exposition",
    "set_recorder",
    "set_registry",
    "set_tracing",
]
