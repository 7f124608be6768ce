"""Span/tracer layer over the offer pipeline and the serve, model and train
paths — zero-overhead when off.

Design contract (docs/OBSERVABILITY.md; the serve, model and train
spans in README.md's port section):

* **Disabled is the default.** ``span(name)`` returns a shared no-op
  context manager when no tracer is installed and no torch profiler
  session records — two global reads, no allocation — so instrumented
  call sites cost nanoseconds in production paths. Enable with
  ``REPRO_TRACE=1`` (process-wide, read at import) or programmatically
  (``install(Tracer())`` / ``activate`` / ``SimEngine(trace=...)``).
* **A profiler session records spans too.** With no tracer installed,
  spans opened while a ``torch.profiler`` session records (the
  profiler's own module flag, ``_is_profiler_enabled``) go to a session
  tracer, which the first such span opens. ``session_spans()``, read
  once no session records, returns its spans (those of every session
  since the last such read) and closes it, so the next session's first
  span opens a new one: a process that runs several sessions reads after
  each to keep them apart.
* **One clock with the profiler.** Spans stamp their start and end in
  nanoseconds of ``time.time_ns()``: the clock (CLOCK_REALTIME) to which
  torch's profiler converts its CPU and device events, so a span and the
  kernel launches it encloses lie on one time line.
* **Nothing depends on tracing.** Spans record time and attributes
  only; they consume no rng, add no sync, record no CUDA event and
  reorder no computation. The bit-parity suite (tests/test_obs.py)
  asserts admission decisions are identical with tracing on vs off in
  both rng modes; tests/test_torch_spans.py asserts the same of served
  tokens and training losses.
* **Exception-safe span trees.** ``Span.__exit__`` always closes the
  span (recording the exception type in ``attrs["error"]``) and repairs
  the open-span stack even if an inner span leaked, so a ``SolverFault``
  or ``LedgerInvariantError`` unwinding through nested spans still
  yields a well-formed tree.

Span taxonomy (names are dotted phases; nesting gives the tree):
``offer`` > ``offer.schedule`` > {``plan.build`` > {``plan.bundle``,
``plan.classify``}, ``lp.solve`` > {``lp.replay``, ``lp.simplex``},
``plan.resolve`` > ``plan.finish``, ``dp.sweep``} and ``offer.commit``;
the simulator adds ``sim.advance``/``sim.arrivals``/``sim.checkpoint``/
``sim.recover`` around the engine loop and ``offer.batch`` per arrival
batch. Serving: ``serve.batch`` > {``serve.prefill``,
``serve.decode_step``}; training: ``train.step`` > {``train.forward``,
``train.backward``, ``train.adamw`` > ``train.adamw.slab``}; the model,
under either: ``model.block`` > {``model.attention`` >
``model.attention.core``, ``model.ffn``} and ``model.head``.

Exports: ``Tracer.chrome_trace()`` (Chrome ``chrome://tracing`` /
Perfetto JSON, "X" complete events in microseconds) and
``Tracer.phase_table()`` (per-name count/total/self/mean/max aggregate —
self-times partition wall exactly, so ``sum(self_s)`` over all phases is
the traced coverage of a run).
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

import torch.autograd.profiler as _profiler


class Span:
    """One timed phase. Context manager; returned by ``Tracer.span`` and
    the module-level ``span()`` when tracing is enabled. ``t0`` and ``t1``
    are ``time.time_ns()`` stamps (``t1`` None while open)."""

    __slots__ = ("name", "attrs", "t0", "t1", "depth", "parent", "index",
                 "child_dur", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.t0 = 0
        self.t1: Optional[int] = None
        self.depth = 0
        self.parent = -1          # index into tracer.spans, -1 = root
        self.index = -1
        self.child_dur = 0.0      # closed children's seconds, for self-time

    def set(self, **kv: Any) -> "Span":
        self.attrs.update(kv)
        return self

    def add(self, key: str, value: float) -> "Span":
        self.attrs[key] = self.attrs.get(key, 0) + value
        return self

    @property
    def dur(self) -> Optional[float]:
        """The span's seconds; None while open."""
        return None if self.t1 is None else (self.t1 - self.t0) * 1e-9

    def __enter__(self) -> "Span":
        tr = self._tracer
        stack = tr._stack
        self.depth = len(stack)
        self.parent = stack[-1].index if stack else -1
        self.index = len(tr.spans)
        tr.spans.append(self)
        stack.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, et, ev, tb) -> bool:
        end = time.time_ns()
        tr = self._tracer
        stack = tr._stack
        # close any children leaked by a non-context-managed path so the
        # tree stays well-formed even under surprise unwinds
        while stack and stack[-1] is not self:
            leaked = stack.pop()
            if leaked.t1 is None:
                leaked.t1 = end
                leaked.attrs["leaked"] = True
        if stack:
            stack.pop()
        self.t1 = end
        if et is not None:
            self.attrs["error"] = et.__name__
        if self.parent >= 0:
            tr.spans[self.parent].child_dur += self.dur
        return False


class _NullSpan:
    """Shared do-nothing span: the disabled-mode fast path."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, et, ev, tb) -> bool:
        return False

    def set(self, **kv: Any) -> "_NullSpan":
        return self

    def add(self, key: str, value: float) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


class Tracer:
    """Collects a span tree for one traced run.

    Spans are appended in start order; ``spans[i].parent`` indexes the
    enclosing span (-1 for roots). The tracer itself is cheap enough to
    deepcopy (plain lists), so a checkpointed engine can carry one.
    """

    def __init__(self) -> None:
        self.spans: List[Span] = []
        self._stack: List[Span] = []
        self.origin = time.time_ns()

    # -------------------------------------------------------------- API
    def span(self, name: str, **attrs: Any) -> Span:
        return Span(self, name, attrs)

    def well_formed(self) -> bool:
        """No open spans, every span closed, parents precede children."""
        if self._stack:
            return False
        for sp in self.spans:
            if sp.dur is None or sp.dur < 0:
                return False
            if sp.parent >= sp.index:
                return False
            if sp.parent >= 0 and self.spans[sp.parent].depth != sp.depth - 1:
                return False
        return True

    # ---------------------------------------------------------- exports
    def chrome_trace(self) -> Dict[str, Any]:
        """Chrome-trace/Perfetto JSON: "X" (complete) events, µs."""
        events = []
        for sp in self.spans:
            events.append({
                "name": sp.name,
                "ph": "X",
                "ts": (sp.t0 - self.origin) * 1e-3,
                "dur": (sp.dur or 0.0) * 1e6,
                "pid": 0,
                "tid": 0,
                "args": {k: v for k, v in sp.attrs.items()},
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def phase_table(self) -> Dict[str, Dict[str, float]]:
        """Per-phase aggregate keyed by span name.

        ``total_s`` is inclusive wall; ``self_s`` excludes closed
        children, so self-times across ALL phases partition the traced
        wall exactly (no double counting) — ``sum(self_s)`` over the
        table equals the summed duration of the root spans.
        """
        table: Dict[str, Dict[str, float]] = {}
        for sp in self.spans:
            if sp.dur is None:
                continue
            row = table.setdefault(sp.name, {
                "count": 0, "total_s": 0.0, "self_s": 0.0, "max_ms": 0.0,
            })
            row["count"] += 1
            row["total_s"] += sp.dur
            row["self_s"] += max(0.0, sp.dur - sp.child_dur)
            row["max_ms"] = max(row["max_ms"], sp.dur * 1e3)
        for row in table.values():
            row["mean_ms"] = row["total_s"] * 1e3 / row["count"]
        return table


# ---------------------------------------------------------------- global
_tracer: Optional[Tracer] = None
#: the spans recorded under profiler sessions with no tracer installed
#: since ``session_spans`` last closed it; None before the first such span
_session: Optional[Tracer] = None
_session_closed = False


def get_tracer() -> Optional[Tracer]:
    return _tracer


def install(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install ``tracer`` process-wide (None disables). Returns it."""
    global _tracer
    _tracer = tracer
    return tracer


@contextmanager
def activate(tracer: Optional[Tracer]):
    """Temporarily install ``tracer`` (restores the previous one on exit
    — exception-safe, used by ``SimEngine(trace=...)``)."""
    global _tracer
    prev = _tracer
    _tracer = tracer
    try:
        yield tracer
    finally:
        _tracer = prev


def _session_tracer() -> Tracer:
    """The session tracer, a new one if the last was closed."""
    global _session, _session_closed
    if _session is None or _session_closed:
        _session, _session_closed = Tracer(), False
    return _session


def session_spans() -> List[Span]:
    """The spans recorded with no tracer installed under every profiler
    session since the last read made while none recorded, in start order
    (empty if none). Such a read also closes their tracer: the next
    session's first span opens a new one, and until then each read
    returns the same spans."""
    global _session_closed
    if _session is None:
        return []
    if not _profiler._is_profiler_enabled:
        _session_closed = True
    return _session.spans


def span(name: str, **attrs: Any):
    """Open a span on the installed tracer, else on the session tracer
    while a profiler session records; no-op singleton when off."""
    tr = _tracer
    if tr is None:
        if not _profiler._is_profiler_enabled:
            return _NULL_SPAN
        tr = _session_tracer()
    return Span(tr, name, attrs)


def add(key: str, value: float) -> None:
    """Accumulate a numeric attribute on the innermost open span."""
    tr = _tracer
    if tr is None and _profiler._is_profiler_enabled:
        tr = _session
    if tr is not None and tr._stack:
        sp = tr._stack[-1]
        sp.attrs[key] = sp.attrs.get(key, 0) + value


# REPRO_TRACE=1 turns tracing on for the whole process at import time
# (benchmarks read the installed tracer back via get_tracer()).
if os.environ.get("REPRO_TRACE", "") not in ("", "0"):
    _tracer = Tracer()
