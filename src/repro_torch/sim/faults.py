"""Fault-domain chaos harness: machine incidents and solver-fault injection.

The paper's online setting assumes machines and solvers that never fail;
real clusters deliver neither. This module generates the fault side of the
simulation — everything the engine and policies must *survive*:

  * **Machine incidents** — ``FaultPlan`` draws crashes (capacity factor 0)
    and stragglers (factor in (0, 1)) per machine under derived
    per-(machine, incident) seeds, so any single incident is reproducible
    in isolation and plans compose with trace streams without sharing rng
    state. Incidents on one machine never overlap by construction;
    ``domains`` (rack groups) plus ``domain_correlation`` turn a single
    crash into a correlated failure-domain outage. ``events()`` renders
    the plan as a time-ordered MACHINE_DOWN/MACHINE_UP stream that
    ``merge_event_streams`` interleaves with a job trace.
  * **Solver faults** — ``SolverFaultInjector`` is a deterministic callable
    for ``SubproblemConfig.lp_fault_hook``: the k-th LP dispatch of the
    run faults iff the per-dispatch derived draw says so, raising
    ``SolverTimeout`` or ``SolverFault``. The counter lives on the
    injector, so checkpoint deep-copies replay the identical fault
    schedule (crash-consistent recovery stays bit-identical).

Determinism contract mirrors ``repro_torch.sim.traces``: machine h's incident k
is drawn from ``SeedSequence((seed, _TAG_FAULT, h, k))`` and dispatch k's
fault decision from ``SeedSequence((seed, _TAG_SOLVER_FAULT, k))`` —
generating a plan twice, partially, or inside a different harness yields
bit-identical streams. The tags are the JAX package's, so both packages
draw the same incidents and the same fault schedule from one seed.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..core.subproblem import SolverFault, SolverTimeout
from .events import Event, EventKind

_TAG_FAULT = 11         # per-(machine, incident) draws
_TAG_SOLVER_FAULT = 12  # per-dispatch solver-fault draws


@dataclass(frozen=True)
class FaultIncident:
    """One machine-level incident: ``machine`` is degraded to capacity
    share ``factor`` over slots [``down_at``, ``up_at``)."""

    machine: int
    incident: int          # unique id pairing the DOWN with its UP
    down_at: int
    up_at: int
    kind: str              # "crash" | "straggler"
    factor: float          # 0 for a crash, (0, 1) for a straggler

    @property
    def duration(self) -> int:
        return self.up_at - self.down_at


def _derived(seed: int, *keys: int) -> np.random.Generator:
    s = int(seed)
    s = s if s >= 0 else (1 << 63) - s  # injective for negatives
    return np.random.default_rng(np.random.SeedSequence((s, *keys)))


@dataclass
class FaultPlan:
    """Generator of a machine-fault schedule (and the matching solver-fault
    hook) for one simulated run.

    Rates are *per machine per slot*: each machine's incident starts form
    a renewal process with exponential gaps at rate ``crash_rate +
    straggler_rate`` (the incident's kind is then drawn by rate share), and
    the next gap starts only after the previous repair, so one machine's
    incidents never overlap. ``domains`` lists failure-domain groups (e.g.
    rack co-location); with probability ``domain_correlation`` a crash
    takes the rest of its group down for the same interval — correlated
    incidents get their own ids, so staggered repairs compose."""

    seed: int = 0
    until: int = 256                     # generate incidents in [0, until)
    crash_rate: float = 0.0              # machine crashes / machine / slot
    straggler_rate: float = 0.0          # degraded incidents / machine / slot
    downtime: Tuple[int, int] = (2, 12)  # repair time, inclusive slot range
    straggler_factor: Tuple[float, float] = (0.3, 0.7)
    domains: Optional[Sequence[Sequence[int]]] = None
    domain_correlation: float = 0.0
    # solver-fault side (rendered by solver_fault_hook())
    solver_fault_rate: float = 0.0       # P[fault] per LP dispatch
    solver_timeout_share: float = 0.5    # faults that are SolverTimeout

    # ------------------------------------------------------------------
    def incidents(self, num_machines: int) -> List[FaultIncident]:
        """The full incident list, sorted by (down_at, machine, id)."""
        total = self.crash_rate + self.straggler_rate
        out: List[FaultIncident] = []
        if total <= 0.0 or num_machines <= 0:
            return out
        peers = {}
        for grp in self.domains or ():
            for h in grp:
                peers[h] = [int(m) for m in grp if int(m) != int(h)]
        lo, hi = self.downtime
        uid = 0
        for h in range(num_machines):
            clock = 0.0
            k = 0
            while True:
                rng = _derived(self.seed, _TAG_FAULT, h, k)
                clock += rng.exponential(1.0 / total)
                down = int(clock)
                if down >= self.until:
                    break
                dur = int(rng.integers(lo, hi + 1))
                is_straggler = rng.random() < (self.straggler_rate / total)
                if is_straggler:
                    factor = float(rng.uniform(*self.straggler_factor))
                    kind = "straggler"
                else:
                    factor, kind = 0.0, "crash"
                out.append(FaultIncident(h, uid, down, down + dur, kind,
                                         factor))
                uid += 1
                if (kind == "crash" and peers.get(h)
                        and rng.random() < self.domain_correlation):
                    # the whole failure domain shares the outage interval
                    for p in peers[h]:
                        out.append(FaultIncident(p, uid, down, down + dur,
                                                 "crash", 0.0))
                        uid += 1
                clock = float(down + dur)  # renewal restarts after repair
                k += 1
        out.sort(key=lambda i: (i.down_at, i.machine, i.incident))
        return out

    def events(self, num_machines: int) -> List[Event]:
        """The plan as a time-ordered MACHINE_DOWN/MACHINE_UP stream."""
        evs: List[Event] = []
        for inc in self.incidents(num_machines):
            evs.append(Event(time=inc.down_at, kind=EventKind.MACHINE_DOWN,
                             machine=inc.machine, factor=inc.factor,
                             incident=inc.incident))
            evs.append(Event(time=inc.up_at, kind=EventKind.MACHINE_UP,
                             machine=inc.machine, factor=1.0,
                             incident=inc.incident))
        evs.sort(key=lambda e: e.time)  # stable: DOWN/UP pairs keep order
        return evs

    def solver_fault_hook(self) -> Optional["SolverFaultInjector"]:
        """The plan's LP-dispatch fault hook (None when the rate is 0)."""
        if self.solver_fault_rate <= 0.0:
            return None
        return SolverFaultInjector(
            rate=self.solver_fault_rate,
            seed=self.seed,
            timeout_share=self.solver_timeout_share,
        )


class SolverFaultInjector:
    """Deterministic injected-solver-fault schedule for
    ``SubproblemConfig.lp_fault_hook``.

    The k-th dispatch of the run faults iff the draw derived from
    ``(seed, _TAG_SOLVER_FAULT, k)`` falls under ``rate`` — the schedule
    depends only on the dispatch index, never on shared rng state, so a
    checkpointed (deep-copied) injector replays the identical faults.
    ``max_faults`` bounds the total raised (tests use 1 to exercise
    exactly one rung of the retry ladder)."""

    def __init__(self, rate: float, seed: int = 0, timeout_share: float = 0.5,
                 max_faults: Optional[int] = None):
        self.rate = float(rate)
        self.seed = int(seed)
        self.timeout_share = float(timeout_share)
        self.max_faults = max_faults
        self.calls = 0
        self.raised = 0

    def __call__(self, context: str) -> None:
        k = self.calls
        self.calls = k + 1
        if self.rate <= 0.0:
            return
        if self.max_faults is not None and self.raised >= self.max_faults:
            return
        rng = _derived(self.seed, _TAG_SOLVER_FAULT, k)
        if rng.random() >= self.rate:
            return
        self.raised += 1
        if rng.random() < self.timeout_share:
            raise SolverTimeout(
                f"injected LP timeout at dispatch {k} ({context})")
        raise SolverFault(
            f"injected LP failure at dispatch {k} ({context})")


def merge_event_streams(*streams: Iterable[Event]) -> Iterator[Event]:
    """Merge time-ordered event streams into one time-ordered stream.

    Stable: within a time tie, events from earlier-listed streams come
    first, so merge order is deterministic (the engine's same-slot kind
    priority does the semantic ordering anyway). Lazy — trace generators
    stay streaming."""
    return heapq.merge(*streams, key=lambda e: e.time)
