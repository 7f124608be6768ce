"""The program's spans in a traced run, and the device ops each holds.

A ``--trace 1`` run holds one profiler session over exactly its window,
and the port records its spans (``repro_torch.obs.trace``) while a
session records: ``session_spans()`` returns the window's spans once the
session has stopped. A span stamps its start and end on the clock the
profiler stamps its events with, the clock of ``trace.Trace.calls``.

Every device op of the window is put down to the innermost span open when
its host call started. Launch calls are paired in order with the window's
kernels, after dropping the pads' launches and counting a ``cu*`` launch
made inside a ``cuda*`` one once (as ``trace._launches`` counts them);
memcpy and memset calls in order with their ops. Where the trace is not
complete or the counts differ, nothing is read: every reader built on it
returns None. Nor is anything read where an op starts before its call,
held on the profiler's clocks as they are: its device stamps run off its
host stamps by up to ~8 ms in a 30 s window on an H100, drifting up to
~1.2 ms a second and jumping between stretches, so no one offset holds.
An op that starts on an idle card (``IDLE_S`` after the last op ended)
starts a launch latency after its call on the card's clock, so its offset
(op start less call start) is the clock's, give or take a few
microseconds. Each such op is held against its ``NEIGHBOURS`` on each
side among them, each neighbour's offset less ``DRIFT`` times the time
between: where it starts more than ``TOL_S`` earlier against its call
than the least of them allows, a call was paired with a later call's op.
Each idle gap of the window is put down alike, to the span open at the
call of the op that ended it.

This file and ``port.py`` are the only ones that touch the port. A
program without such spans (no ``session_spans``) gives nothing to read.

    python3 -m perfbench.spans --workload cmdr-chat --seed 7 --seconds 30

runs one traced run of a cell through the harness and prints, as one JSON
line, the harness's result and the host-side cost of a span site left
off; in a cell that a span metric reads (cmdr-chat, cmdr-train), also its
idle gaps by span and the device time and op counts under each span name.
"""
from __future__ import annotations

import bisect
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .trace import LAUNCH_CALLS, PAD_HEAD, PAD_TAIL

#: an op that starts this long after the card's last op ended started on
#: an idle card, a launch latency after its call
IDLE_S = 20e-6
#: the ops on each side, among those on an idle card, each is held against
NEIGHBOURS = 4
#: the fastest the profiler's device stamps may drift against its host
#: stamps, in seconds a second (up to 1.2e-3 seen on an H100)
DRIFT = 2e-3
#: how far an op on an idle card may start earlier against its call than
#: its neighbours allow: the spread of launch latencies (at most 8.9 us
#: seen in six 30 s windows on an H100)
TOL_S = 50e-6


@dataclass(frozen=True)
class SpanRec:
    """One closed span: its name, start and end (seconds of the profiler's
    clock), the index of its parent (-1 for a root) and its attrs."""
    name: str
    t0: float
    t1: float
    parent: int
    attrs: Dict


def program_spans() -> Optional[List[SpanRec]]:
    """The spans of the program's newest profiler session, in start
    order, or None where the program records none."""
    try:
        from repro_torch.obs import trace as obs_trace
    except ImportError:
        return None
    read = getattr(obs_trace, "session_spans", None)
    if read is None:
        return None
    spans = read()
    if not spans or any(sp.t1 is None for sp in spans):
        return None
    return [SpanRec(sp.name, sp.t0 * 1e-9, sp.t1 * 1e-9, sp.parent,
                    dict(sp.attrs)) for sp in spans]


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def _launch_calls(calls) -> List[Tuple[str, float, float]]:
    """The launch calls in order of start, a ``cu*`` launch made inside a
    ``cuda*`` launch left out (the profiler records both)."""
    runtime = [c for c in calls
               if c[0] in LAUNCH_CALLS and c[0].startswith("cuda")]
    starts = [c[1] for c in runtime]
    out = list(runtime)
    for c in calls:
        if c[0] in LAUNCH_CALLS and not c[0].startswith("cuda"):
            i = bisect.bisect_right(starts, c[1]) - 1
            if not (i >= 0 and c[2] <= runtime[i][2]):
                out.append(c)
    return sorted(out, key=lambda c: c[1])


def _pair(tr) -> Optional[List[float]]:
    """The start of each op's host call, in the order of ``tr.ops``; None
    where the trace is not complete or a count differs."""
    if tr is None or not tr.complete:
        return None
    launches = _launch_calls(tr.calls)
    if len(launches) < PAD_HEAD + PAD_TAIL:
        return None
    launches = launches[PAD_HEAD:len(launches) - PAD_TAIL]
    copies = [c for c in tr.calls if c[0] not in LAUNCH_CALLS]
    kernels = [i for i, op in enumerate(tr.ops) if not _is_copy(op[0])]
    moved = [i for i, op in enumerate(tr.ops) if _is_copy(op[0])]
    if len(kernels) != len(launches) or len(moved) != len(copies):
        return None
    at = [0.0] * len(tr.ops)
    for idx, calls in ((kernels, launches), (moved, copies)):
        for i, call in zip(idx, calls):
            at[i] = call[1]
    return at


def early_s(tr, at: Sequence[float]) -> float:
    """How much earlier against its call, at worst, an op on an idle card
    starts than its neighbours among such ops allow (negative where each
    starts later)."""
    end, idle = tr.window[0], []
    for (_, s, e), a in zip(tr.ops, at):
        if s - end >= IDLE_S:
            idle.append((s, s - a))
        end = max(end, e)
    worst = float("-inf")
    for k, (t, d) in enumerate(idle):
        near = idle[max(0, k - NEIGHBOURS):k] + idle[k + 1:k + 1 + NEIGHBOURS]
        if near:
            worst = max(worst, min(dn - DRIFT * abs(t - tn)
                                   for tn, dn in near) - d)
    return worst


def pair_calls(tr) -> Optional[List[float]]:
    """The start of each op's host call, in the order of ``tr.ops``; None
    where the trace is not complete, a count differs or an op on an idle
    card starts more than ``TOL_S`` earlier against its call than its
    neighbours allow."""
    at = _pair(tr)
    if at is None or early_s(tr, at) > TOL_S:
        return None
    return at


def innermost(spans: Sequence[SpanRec], times: Sequence[float]) -> List[int]:
    """The index of the innermost span open at each time (-1: none).
    Spans nest and come in start order."""
    order = sorted(range(len(times)), key=lambda k: times[k])
    out = [-1] * len(times)
    stack: List[int] = []
    nxt = 0
    for k in order:
        t = times[k]
        while nxt < len(spans) and spans[nxt].t0 <= t:
            while stack and spans[stack[-1]].t1 <= spans[nxt].t0:
                stack.pop()
            stack.append(nxt)
            nxt += 1
        while stack and spans[stack[-1]].t1 < t:
            stack.pop()
        out[k] = stack[-1] if stack else -1
    return out


@dataclass
class Placed:
    """The window's ops (``tr.ops``), each with the innermost span open at
    its call (``owner``, -1 for none), and the spans."""
    tr: object
    spans: List[SpanRec]
    owner: List[int]

    def under(self, name: str) -> List[int]:
        """For each span, the index of the nearest span named ``name``
        that holds it (itself included), else -1."""
        out = []
        for i, sp in enumerate(self.spans):
            out.append(i if sp.name == name
                       else out[sp.parent] if sp.parent >= 0 else -1)
        return out

    def ops_by(self, name: str) -> Dict[int, List[Tuple[str, float, float]]]:
        """The ops under each span named ``name``, by that span's index."""
        top = self.under(name)
        out: Dict[int, List[Tuple[str, float, float]]] = {
            i: [] for i, sp in enumerate(self.spans) if sp.name == name}
        for op, own in zip(self.tr.ops, self.owner):
            if own >= 0 and top[own] >= 0:
                out[top[own]].append(op)
        return out

    def busy_s(self, name: str, within: Optional[str] = None) -> float:
        """Device seconds of the ops under spans named ``name`` (and, with
        ``within``, under a span of that name too)."""
        top = self.under(name)
        inside = self.under(within) if within else top
        return sum(e - s for (_, s, e), own in zip(self.tr.ops, self.owner)
                   if own >= 0 and top[own] >= 0 and inside[own] >= 0)

    def path(self, i: int) -> str:
        names = []
        while i >= 0:
            names.append(self.spans[i].name)
            i = self.spans[i].parent
        return " > ".join(reversed(names)) or "no span"

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Idle time inside the window by the span open at the call of the
        op that ended each gap (its path of span names)."""
        lo, hi = self.tr.window
        tot: Dict[str, float] = {}
        end = lo
        for (_, s, e), own in zip(self.tr.ops, self.owner):
            s_in = min(max(s, lo), hi)
            if s_in > end:
                label = self.path(own)
                tot[label] = tot.get(label, 0.0) + (s_in - end)
            end = max(end, min(e, hi))
        if hi > end:
            tot["(window end)"] = tot.get("(window end)", 0.0) + (hi - end)
        return [[n, t] for n, t in sorted(tot.items(),
                                           key=lambda kv: -kv[1])[:top]]


def place(tr, spans: Optional[List[SpanRec]]) -> Optional[Placed]:
    """The trace's ops put down to ``spans``; None where either is
    missing or the calls do not pair with the ops."""
    if not spans:
        return None
    at = pair_calls(tr)
    if at is None:
        return None
    return Placed(tr, spans, innermost(spans, at))


_memo: List = [None, None]


def of_run(run) -> Optional[Placed]:
    """``place`` for a run's trace and the program's session spans, once
    a trace."""
    if _memo[0] is not run.trace:
        _memo[:] = [run.trace, place(run.trace, program_spans())]
    return _memo[1]


def share_pct(part_s: float, whole_s: float) -> Optional[float]:
    if part_s <= 0 or whole_s <= 0:
        return None
    return 100.0 * part_s / whole_s


# ------------------------------------------------------------ the report
def _null_span_ns(n: int = 200_000) -> Optional[float]:
    """Host ns of one span site with tracing off: ``with span(...)``."""
    import time
    try:
        from repro_torch.obs import trace as obs_trace
    except ImportError:
        return None
    span = obs_trace.span
    t = time.perf_counter_ns()
    for i in range(n):
        with span("model.block", layer=i):
            pass
    return (time.perf_counter_ns() - t) / n


def report(placed: Optional[Placed]) -> Dict:
    """What the command prints of a traced run besides the harness's
    result: the cost of a span site left off; with spans, each span name's
    count, op counts (each instance's, distinct) and device seconds, the
    ops in no span, the largest lead of an op over its call on the
    profiler's clocks, ``early_s`` and the idle gaps."""
    out: Dict = {"null_span_ns": _null_span_ns()}
    if placed is None:
        return out
    by_name: Dict[str, Dict] = {}
    for name in sorted({sp.name for sp in placed.spans}):
        each = placed.ops_by(name)
        by_name[name] = {"spans": len(each),
                         "ops_each": sorted({len(v) for v in each.values()}),
                         "device_s": placed.busy_s(name)}
    out["by_span"] = by_name
    out["ops_in_no_span"] = sum(own < 0 for own in placed.owner)
    at = _pair(placed.tr)
    out["op_before_call_us"] = max(
        [0.0] + [(a - s) * 1e6 for a, (_, s, _) in zip(at, placed.tr.ops)])
    early = early_s(placed.tr, at)
    out["early_us"] = early * 1e6 if math.isfinite(early) else None
    out["idle_gaps"] = placed.idle_gaps(10)
    return out


def main(argv=None) -> int:
    import argparse
    import json
    import sys
    import time
    t_start = time.perf_counter()
    # the readers' module, not ``__main__``: its memo holds the placed ops
    from . import harness, spans
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    harness.set_env()
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    files = harness.cell_files(spec, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, files, spec, args.seed,
                              args.seconds, True, "cuda", t_start)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules loaded that no run may hold: {bad}", file=sys.stderr)
        return 4
    line = {"workload": args.workload, "seed": args.seed,
            **harness.result_line(result), **report(spans._memo[1])}
    sys.stdout.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
