"""The device trace of a ``--trace 1`` run: a held profiler session over
the measured window, and what the per-layer readers take from it.

The session is held as ``chip_smoke.py`` holds its own (copied): 64
launches of a spin kernel with no work and a sync before the window,
16,384 after it, so that records a session may lose at its ends are pads.
The host's kernel-launch calls are counted against the kernels recorded;
where they differ the trace is marked incomplete, and the readers that
need it read nothing. Busy time is the union of the device's kernel,
copy and fill intervals (pads aside) inside the window.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

PAD_KERNEL = "spin_kernel"
PAD_HEAD, PAD_TAIL = 64, 16384
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
QUEUE_FULL = "Command Buffer Full"


def _pad(n: int) -> None:
    for _ in range(n):
        torch.cuda._sleep(0)
    torch.cuda.synchronize()


def start():
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    _pad(PAD_HEAD)
    return prof


def stop(prof):
    torch.cuda.synchronize()
    _pad(PAD_TAIL)
    prof.stop()
    return prof


@dataclass
class Trace:
    """Device events of the window as (name, start s, end s), sorted by
    start, pads and queue markers aside; the host's launch calls as
    (name, start s, end s); and whether every launch has its kernel."""
    ops: List[Tuple[str, float, float]]
    calls: List[Tuple[str, float, float]]
    launched: int
    ran: int
    window: Tuple[float, float]
    phases: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def complete(self) -> bool:
        return self.launched > 0 and self.launched == self.ran

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        """The union of device intervals inside the window."""
        lo, hi = self.window
        busy, end = 0.0, lo
        for _, s, e in self.ops:
            s, e = max(s, end), min(e, hi)
            if e > s:
                busy += e - s
                end = e
        return busy

    def kernels(self, part: str) -> List[Tuple[str, float, float]]:
        return [op for op in self.ops if part in op[0]]

    def by_name(self, top: int = 10) -> List[List]:
        tot: Dict[str, float] = {}
        for name, s, e in self.ops:
            tot[name] = tot.get(name, 0.0) + (e - s)
        return [[n, t] for n, t in sorted(tot.items(),
                                           key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Idle time inside the window by what the host was doing: the
        harness's phase at the gap's middle and the host call that issued
        the device op that ended the gap (its launch or copy call, else
        "host")."""
        lo, hi = self.window
        starts = [c[1] for c in self.calls]
        tot: Dict[str, float] = {}
        end = lo
        edges = [(s, e, n) for n, s, e in self.ops] + [(hi, hi, "")]
        for s, e, name in edges:
            s_in = min(max(s, lo), hi)
            if s_in > end:
                i = bisect.bisect_right(starts, s_in) - 1
                call = self.calls[i][0] if i >= 0 and \
                    self.calls[i][2] >= end else "host"
                label = f"{self.phase_at((end + s_in) / 2)}: {call}" + \
                    (f" before {name[:60]}" if name else " (window end)")
                tot[label] = tot.get(label, 0.0) + (s_in - end)
            end = max(end, min(e, hi))
        return [[n, t] for n, t in sorted(tot.items(),
                                           key=lambda kv: -kv[1])[:top]]

    def phase_at(self, t: float) -> str:
        for name, s, e in self.phases:
            if s <= t <= e:
                return name
        return "between calls"


def read(prof, t0: float, t1: float,
         phases: Optional[List[Tuple[str, float, float]]] = None) -> Trace:
    """The stopped session's events between its head and tail pads, in
    seconds of the profiler's clock. The window runs from the end of the
    last head pad to the start of the first tail pad; ``t0`` and ``t1``
    (host ``perf_counter`` seconds, taken after the head pads' sync and
    before the tail's) place the harness's ``phases`` on that clock."""
    from torch.autograd import DeviceType
    ops, calls, pads = [], [], []
    ran = 0
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        s = ev.start_ns() / 1e9
        e = s + ev.duration_ns() / 1e9
        if ev.device_type() == DeviceType.CPU:
            if name in LAUNCH_CALLS or name.startswith(("cudaMemcpy",
                                                        "cudaMemset")):
                calls.append((name, s, e))
        elif ev.device_type() == DeviceType.CUDA and name != QUEUE_FULL:
            if PAD_KERNEL in name:
                pads.append((s, e))
                continue
            ops.append((name, s, e))
            if not name.startswith(("Memcpy", "Memset")):
                ran += 1
    ops.sort(key=lambda o: o[1])
    calls.sort(key=lambda c: c[1])
    pads.sort()
    first = ops[0][1] if ops else 0.0
    head = [e for s, e in pads if s <= first]
    tail = [s for s, e in pads if s > first]
    lo = max(head) if head else first
    hi = min(tail) if tail else (ops[-1][2] if ops else lo)
    shift = lo - t0
    launched = _launches(calls) - PAD_HEAD - PAD_TAIL
    moved = [(n, s + shift, e + shift) for n, s, e in phases or []]
    return Trace(ops, calls, launched, ran, (lo, hi), moved)


def _launches(calls) -> int:
    """Launch calls, a ``cu*`` launch made inside a ``cuda*`` launch
    counted once (the profiler records both)."""
    runtime = [(s, e) for n, s, e in calls
               if n in LAUNCH_CALLS and n.startswith("cuda")]
    starts = [s for s, _ in runtime]
    n = len(runtime)
    for name, s, e in calls:
        if name in LAUNCH_CALLS and not name.startswith("cuda"):
            i = bisect.bisect_right(starts, s) - 1
            if not (i >= 0 and e <= runtime[i][1]):
                n += 1
    return n
