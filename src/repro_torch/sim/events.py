"""Discrete-event vocabulary and the heap-ordered clock for ``repro_torch.sim``.

These event kinds drive the simulation:

  ARRIVAL      — a job (or same-slot batch of jobs) enters the system and
                 is offered to the policy. Queue input (traces yield
                 these).
  FAILURE      — an exogenous fault kills a running job's allocation.
                 Queue input (the engine materializes it from an ARRIVAL's
                 ``fail_at``; tests may push it directly).
  DEPARTURE    — a job abandons before ever being served. Usually emitted
                 by the engine when patience expires; also accepted as
                 queue input for traces that model jobs leaving on their
                 own clock.
  MACHINE_DOWN — machine ``machine`` crashes (``factor`` 0) or degrades to
                 a straggler (``factor`` in (0, 1)); ``incident`` pairs it
                 with its MACHINE_UP. Queue input (a fault plan's event
                 stream).
  MACHINE_UP   — the incident's repair completes; the machine's capacity
                 share returns. Queue input.
  COMPLETION   — a job finished its workload V_i = E_i K_i. Engine-emitted
                 notification only (progress accounting crosses V_i) —
                 never valid queue input.
  PREEMPT      — the engine's response to a FAILURE of a running job (or a
                 machine-crash eviction): its commitments are released, it
                 sits out the failed slot, and admission-driven policies
                 get the residual re-offered. Engine-emitted notification
                 only.
  RESHAPE      — a running elastic job's quality dynamics crossed a
                 trigger (SLAQ marginal-loss floor or adadamp batch-size
                 damper): the engine releases its residual commitment
                 through the preempt-release machinery and re-enters it as
                 a re-offer with the *updated* demand signature.
                 Engine-emitted notification only.

The engine raises on queued kinds outside {ARRIVAL, FAILURE, DEPARTURE,
MACHINE_DOWN, MACHINE_UP}.

Determinism contract: the queue orders events by (time, kind-priority,
sequence number), with ties within a kind popping in insertion order.
Within one slot the engine processes machine recoveries first (so a
same-slot repair + crash of one machine nets to the crash), then machine
crashes/degradations (evictions cascade through PREEMPT), then job
failures, then the arrival batch, then exogenous departures (after the
batch, so a same-slot DEPARTURE + ARRIVAL pair departs instead of
dropping against a job state that does not exist yet), then the slot
tick. Nothing about processing depends on heap internals, so a replayed
trace produces the identical event log on every run.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from enum import IntEnum
from typing import Dict, Iterator, List, Optional, Tuple

from ..core.job import JobSpec


class EventKind(IntEnum):
    """Event kinds; the integer value is the same-slot processing priority
    (lower pops first)."""

    MACHINE_UP = 0
    MACHINE_DOWN = 1
    FAILURE = 2
    PREEMPT = 3
    DEPARTURE = 4
    COMPLETION = 5
    ARRIVAL = 6
    SLOT = 7          # the per-slot scheduling tick (slot-driven policies)
    RESHAPE = 8       # elastic demand change (engine-emitted notification)


@dataclass(frozen=True)
class Event:
    """One scheduled occurrence on the simulation clock.

    ``job`` is set for a single-job ARRIVAL (the arriving spec, possibly a
    residual re-offer after preemption); ``job_id`` identifies the subject
    of the other kinds. ``fail_at`` on an ARRIVAL is the trace's pre-drawn
    failure slot for this job (the engine materializes the FAILURE event
    from it, which keeps trace generators streaming — they never need to
    emit out-of-order events). ``requeue`` marks a residual re-offer.

    The engine-built events handed to policies carry extra payload:
    ``jobs`` — the same-slot arrival batch (ARRIVAL) or the active job set
    (SLOT), and ``progress`` — trained samples per active job (SLOT), which
    slot-driven policies like Dorm use for fairness ordering.

    MACHINE_DOWN/MACHINE_UP carry ``machine`` (index), ``factor`` (the
    machine's effective capacity share while the incident is active: 0 for
    a crash, (0, 1) for a straggler), and ``incident`` (a unique id that
    pairs the DOWN with its UP, so overlapping incidents on one machine
    compose instead of clobbering each other)."""

    time: int
    kind: EventKind
    job: Optional[JobSpec] = None
    job_id: int = -1
    fail_at: Optional[int] = None
    requeue: bool = False
    jobs: Tuple[JobSpec, ...] = ()
    progress: Optional[Dict[int, float]] = None
    machine: int = -1
    factor: float = 0.0
    incident: int = -1

    def subject(self) -> int:
        return self.job.job_id if self.job is not None else self.job_id


class EventQueue:
    """Heap-ordered clock: pop order is (time, kind priority, push order).

    The push counter is a plain int (not ``itertools.count``) so a queue
    snapshot deep-copies cleanly — the engine's crash-consistent
    checkpoints (``SimEngine.recover``) snapshot the queue mid-run."""

    def __init__(self) -> None:
        self._heap: List[tuple] = []
        self._seq = 0

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, ev: Event) -> None:
        seq = self._seq
        self._seq = seq + 1
        heapq.heappush(self._heap, (ev.time, int(ev.kind), seq, ev))

    def peek_time(self) -> Optional[int]:
        return self._heap[0][0] if self._heap else None

    def pop_until(self, t: int) -> Iterator[Event]:
        """Pop every event with time <= t, in deterministic order."""
        while self._heap and self._heap[0][0] <= t:
            yield heapq.heappop(self._heap)[3]

    def pop_slot(self, t: int) -> List[Event]:
        """Drain every event with time <= t in one pull, in the identical
        (time, kind priority, push order) sequence ``pop_until`` yields.
        The batched engine uses this to dispatch a slot's whole event group
        from a single list instead of re-entering the heap generator per
        event."""
        heap = self._heap
        out: List[Event] = []
        while heap and heap[0][0] <= t:
            out.append(heapq.heappop(heap)[3])
        return out
