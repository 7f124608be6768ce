"""repro_torch.obs — zero-overhead-when-disabled observability.

Three pieces (docs/OBSERVABILITY.md):

* ``obs.trace``   — span/tracer over the offer phases and the serve,
  model and train paths, Chrome-trace JSON + per-phase aggregate table
  (``REPRO_TRACE=1``, ``SimEngine(trace=...)`` or a recording torch
  profiler session to enable; no-op singleton otherwise).
* ``obs.metrics`` — process-wide counter/gauge registry with
  Prometheus-style ``render()``; replaces scattered warn-once paths.
* ``obs.pd_gap``  — realized primal utility vs dual objective from the
  ``PriceTable`` tensors (duality gap / empirical competitive ratio).

Instrumentation is rng-free and never branches a decision path:
admission decisions are bit-identical with the layer on or off.
"""
from . import trace
from .metrics import (
    Counter,
    Gauge,
    MetricsRegistry,
    get_registry,
    warn_once_event,
)
from .pd_gap import PDGapTracker
from .trace import Span, Tracer

__all__ = [
    "trace",
    "Counter",
    "Gauge",
    "MetricsRegistry",
    "get_registry",
    "warn_once_event",
    "PDGapTracker",
    "Span",
    "Tracer",
]
