"""Process-wide counter/gauge/histogram registry with Prometheus-style
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
``render()`` produces the Prometheus text format, ``snapshot()`` a flat
dict for JSON rows and tests. Instrument catalog: docs/OBSERVABILITY.md.
"""
from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Sequence, Tuple

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
    """Point-in-time value (set/inc/dec)."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n


_DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0)


class Histogram:
    """Fixed-bucket histogram (cumulative counts, Prometheus semantics)."""

    __slots__ = ("name", "help", "buckets", "counts", "sum", "count")

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = _DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.counts = [0] * (len(self.buckets) + 1)  # +Inf tail
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.sum += v
        self.count += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1


class MetricsRegistry:
    """Named-instrument registry: get-or-create by name, render as
    Prometheus text. Thread-safe registration (instrument updates are
    plain float ops — the GIL is enough for the counters we keep)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: Dict[str, object] = {}

    def _get(self, name: str, cls, help: str, **kw):
        inst = self._instruments.get(name)
        if inst is None:
            with self._lock:
                inst = self._instruments.get(name)
                if inst is None:
                    inst = cls(name, help, **kw)
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

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = _DEFAULT_BUCKETS) -> Histogram:
        return self._get(name, Histogram, help, buckets=buckets)

    # ----------------------------------------------------------- export
    def snapshot(self) -> Dict[str, float]:
        """Flat name -> value dict (histograms expose _sum/_count)."""
        out: Dict[str, float] = {}
        for name in sorted(self._instruments):
            inst = self._instruments[name]
            if isinstance(inst, Histogram):
                out[f"{name}_sum"] = inst.sum
                out[f"{name}_count"] = float(inst.count)
            else:
                out[name] = inst.value  # type: ignore[attr-defined]
        return out

    def render(self) -> str:
        """Prometheus text exposition format."""
        lines: List[str] = []
        for name in sorted(self._instruments):
            inst = self._instruments[name]
            kind = {"Counter": "counter", "Gauge": "gauge",
                    "Histogram": "histogram"}[type(inst).__name__]
            if inst.help:  # type: ignore[attr-defined]
                lines.append(f"# HELP {name} {inst.help}")  # type: ignore
            lines.append(f"# TYPE {name} {kind}")
            if isinstance(inst, Histogram):
                cum = 0
                for b, c in zip(inst.buckets, inst.counts):
                    cum += c
                    lines.append(f'{name}_bucket{{le="{_fmt(b)}"}} {cum}')
                cum += inst.counts[-1]
                lines.append(f'{name}_bucket{{le="+Inf"}} {cum}')
                lines.append(f"{name}_sum {_fmt(inst.sum)}")
                lines.append(f"{name}_count {inst.count}")
            else:
                lines.append(f"{name} {_fmt(inst.value)}")  # type: ignore
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        with self._lock:
            self._instruments.clear()

    def get(self, name: str) -> Optional[object]:
        return self._instruments.get(name)

    def value(self, name: str, default: float = 0.0) -> float:
        inst = self._instruments.get(name)
        if inst is None:
            return default
        if isinstance(inst, Histogram):
            return inst.sum
        return inst.value  # type: ignore[attr-defined]


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
