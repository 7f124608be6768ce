"""Process-wide counter/gauge registry with Prometheus-style
text exposition.

One named surface replaces the scattered warn-once ``warnings.warn``
calls and ad-hoc ``policy_health`` dicts: rare events (Pallas fallbacks,
replay-budget exhaustions, solver-fault retries) increment counters the
moment they happen; volume stats that live on hot objects
(``TemplateCache.hits``, jit retrace counts, ``SolverFaultInjector``
dispatch tallies, ``ResilientPolicy.health``) are *mirrored* into gauges
at natural sync points (end of an LP batch, engine summary) so the hot
loops stay untouched. Engine-scope gauges are set from state that the
engine checkpoints, which is what makes the registry deterministic under
``SimEngine.recover()`` — a recovered run ends with the same gauge
values as an uninterrupted one.

Instruments are cheap (a float add behind one dict hit) and always on;
``render()`` produces the Prometheus text format. Instrument catalog:
docs/OBSERVABILITY.md.
"""
from __future__ import annotations

import logging
import threading
from typing import Dict, List

_log = logging.getLogger("repro_torch.obs")


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


class Counter:
    """Monotonic event count."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Point-in-time value."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class MetricsRegistry:
    """Named-instrument registry: get-or-create by name, render as
    Prometheus text. Thread-safe registration (instrument updates are
    plain float ops — the GIL is enough for the counters we keep)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: Dict[str, object] = {}

    def _get(self, name: str, cls, help: str):
        inst = self._instruments.get(name)
        if inst is None:
            with self._lock:
                inst = self._instruments.get(name)
                if inst is None:
                    inst = cls(name, help)
                    self._instruments[name] = inst
        if not isinstance(inst, cls):
            raise TypeError(
                f"instrument {name!r} already registered as "
                f"{type(inst).__name__}, not {cls.__name__}")
        return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help)

    # ----------------------------------------------------------- export
    def render(self) -> str:
        """Prometheus text exposition format."""
        lines: List[str] = []
        for name in sorted(self._instruments):
            inst = self._instruments[name]
            kind = {"Counter": "counter",
                    "Gauge": "gauge"}[type(inst).__name__]
            if inst.help:  # type: ignore[attr-defined]
                lines.append(f"# HELP {name} {inst.help}")  # type: ignore
            lines.append(f"# TYPE {name} {kind}")
            lines.append(f"{name} {_fmt(inst.value)}")  # type: ignore
        return "\n".join(lines) + ("\n" if lines else "")


_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry."""
    return _registry


# -------------------------------------------------------------- helpers
_warned: set = set()


def warn_once_event(counter_name: str, key: str, message: str,
                    **fields: object) -> None:
    """Registry-backed replacement for the scattered warn-once paths.

    Always increments ``counter_name``; emits exactly ONE structured log
    record per ``key`` per process (``logging`` WARNING on
    ``repro_torch.obs`` with the fields attached), so a CPU-fallback bench can
    no longer run silent while the log stays readable.
    """
    _registry.counter(counter_name).inc()
    if key not in _warned:
        _warned.add(key)
        _log.warning("%s %s", message,
                     " ".join(f"{k}={v}" for k, v in sorted(fields.items())),
                     extra={"event_key": key, **fields})


def sync_template_cache(cache, prefix: str = "repro_template_cache") -> None:
    """Mirror a ``TemplateCache``'s hit/miss tallies into gauges (called
    at LP-batch sync points, never per lookup)."""
    _registry.gauge(f"{prefix}_hits",
                    "subset-template cache hits").set(cache.hits)
    _registry.gauge(f"{prefix}_misses",
                    "subset-template cache misses").set(cache.misses)
