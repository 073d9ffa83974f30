"""Observability layer: copies of the JAX package's plain-Python
``repro.obs`` modules.

  registry — typed Counter/Gauge/Histogram instruments with
             OpenMetrics-style text exposition (`MetricRegistry.expose`).
  trace    — span trees with monotonic timestamps, propagated via a
             per-thread context stack (the engine's ``engine.r_block``).
  recorder — the flight recorder: a bounded ring of recent spans and
             fault events that dumps JSONL on demand and on fault.

The reference's ``obs/profile.py`` (a ``jax.profiler`` capture and an
HLO report) has no counterpart here yet.
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

__all__ = [
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "Span",
    "Tracer",
    "default_tracer",
    "get_recorder",
    "get_registry",
    "parse_exposition",
    "set_recorder",
    "set_registry",
    "set_tracing",
]
