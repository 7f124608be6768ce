"""The discrete-event simulation engine.

One slot of simulated time is processed as:

  1. take a crash-consistency checkpoint when due (``checkpoint_every``),
     then advance the rolling window to the slot (elapsed rows roll off);
  2. drain the event queue for the slot in deterministic order — machine
     recoveries, then machine crashes/degradations (the capacity mask
     shrinks and jobs holding rows the machine can no longer carry are
     evicted through the PREEMPT path, cascading re-offers), then job
     failures (running job -> PREEMPT: release held rows, notify the
     policy, sit the job out for the failed slot — a uniform one-slot
     minimum penalty across policy shapes — and for arrival-driven
     policies requeue the residual workload as a fresh arrival next slot),
     then the arrival batch, then exogenous departures (after the batch,
     so a same-slot DEPARTURE + ARRIVAL pair departs instead of being
     dropped);
  3. offer the slot's arrival *batch* to the policy in one call (the
     batched-offer path: one price-tensor prewarm amortizes across every
     same-slot job);
  4. slot-driven policies get the SLOT tick with the active set + progress;
  5. progress accounting: every job's committed allocation for this slot
     earns ``Allocation.samples_trained`` (Eq. 1 / Fact 1 — the same
     throughput model for every policy); jobs crossing V_i complete, their
     remaining rows are released, utility u_i(actual JCT) is realized;
  6. patience: queued-but-never-served jobs depart after ``patience``
     slots; then the elastic reshape scan — running quality-driven jobs
     whose SLAQ marginal-loss floor or adadamp batch damper tripped get
     their residual released and re-offered at the new demand level
     (RESHAPE) — and metrics record the slot's utilization/active/queued
     counts.

The engine owns ALL accounting (progress, completions, utility, metrics);
policies only decide allocations. That is what makes the per-policy
numbers in ``BENCH_sim.json`` apples-to-apples.

Crash-consistent recovery
-------------------------
With ``checkpoint_every=K`` the engine snapshots its entire mutable state
(window + ledger, policy, metrics, job states, event queue, fault mask,
in-flight stream head) every K slots, and journals every event pulled
from the trace stream since the snapshot. ``recover()`` restores the
snapshot and replays — from the journal alone, or from the original
stream (skipping the consumed prefix) — so a run killed mid-trace
(``SimKilled``, a crashed process, a chaos test's ``kill_at``) resumes
and finishes with the *bit-identical* summary of an uninterrupted run:
every random decision is drawn from derived seeds keyed on (job, attempt,
slot, …), never from shared stream position, so replayed slots redo
exactly what the lost slots did.

A ledger-invariant violation raises ``LedgerInvariantError`` carrying the
partial ``SimReport`` and the journal tail — a violated run is debuggable
instead of vaporized.
"""
from __future__ import annotations

import bisect
import copy
import heapq
import itertools
import math
import time as _time
from dataclasses import dataclass, field, replace
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from ..core.job import Allocation, JobSpec, QualityCurve
from ..obs import trace as _trace
from ..obs.metrics import get_registry
from .events import Event, EventKind, EventQueue
from .metrics import MetricsCollector, P2Quantile
from .policy import SchedulingPolicy, derived_rng
from .window import RollingWindow

_TAG_REFAIL = 13  # derived-seed tag for per-(job, attempt) failure redraws


@dataclass
class ElasticState:
    """Engine-owned quality accounting for one elastic job (SLAQ's online
    curve fit lives HERE, not on the frozen spec): observed (epochs, loss)
    points, the current refit, and the reshape damper state. Progress is
    read from the job's outcome (cumulative samples across attempts), so
    the epoch clock survives preempt/requeue cycles."""

    samples_per_epoch: float          # K_i of the original attempt-0 spec
    observations: List[Tuple[float, float]] = field(default_factory=list)
    fitted: Optional[QualityCurve] = None
    last_samples: float = 0.0         # progress watermark (new-point gate)
    reshapes: int = 0
    cooldown_until: int = -1          # no reshape before this slot


@dataclass
class JobState:
    """Engine-side state of one job across attempts (a preempted job's
    residual workload is a new attempt with a fresh, smaller spec)."""

    job: JobSpec                 # current attempt's spec
    orig_arrival: int
    attempt: int = 0
    progress: float = 0.0        # trained samples of the CURRENT attempt
    active: bool = False         # in the system (admitted or queued)
    finished: bool = False       # completed, departed, or rejected
    awaiting_requeue: bool = False
    down_at: int = -1            # slot a failure knocked this job out for


@dataclass
class SimReport:
    summary: Dict
    metrics: MetricsCollector
    states: Dict[int, JobState]
    slots_run: int
    # primal-dual telemetry snapshot (obs.pd_gap) when the policy tracks
    # it; kept OUT of ``summary`` so cross-policy summary comparisons
    # (e.g. pdors vs the frozen reference) stay telemetry-agnostic
    pd_gap: Optional[Dict] = None


class SimKilled(RuntimeError):
    """The engine was killed mid-trace (``kill_at`` — the chaos harness's
    stand-in for a crashed scheduler process). State up to the last
    checkpoint survives; ``SimEngine.recover()`` resumes from it."""


class LedgerInvariantError(AssertionError):
    """The allocation ledger exceeded capacity at some slot.

    Subclasses ``AssertionError`` for continuity with the bare assert it
    replaced, but carries the post-mortem: ``slot``, ``policy``, the
    partial ``report`` (metrics up to the violated slot), and
    ``journal_tail`` — the events pulled from the trace stream since the
    last checkpoint — so a violated run is debuggable, not vaporized."""

    def __init__(self, slot: int, policy: str, report: SimReport,
                 journal_tail: Tuple[Event, ...]):
        super().__init__(
            f"ledger oversubscribed at slot {slot} (policy {policy})"
        )
        self.slot = slot
        self.policy = policy
        self.report = report
        self.journal_tail = journal_tail


@dataclass
class Checkpoint:
    """One crash-consistency snapshot: the deep-copied engine state plus
    the stream position (events consumed) it corresponds to."""

    slot: int
    consumed: int
    state: tuple = field(repr=False)


class SimEngine:
    def __init__(
        self,
        window: RollingWindow,
        policy: SchedulingPolicy,
        seed: int = 0,
        max_slots: int = 100_000,
        patience: Optional[int] = None,
        check_ledger: bool = True,
        checkpoint_every: Optional[int] = None,
        kill_at: Optional[int] = None,
        refail_rate: float = 0.0,
        refail_delay: Tuple[int, int] = (1, 8),
        reshape_cooldown: int = 2,
        trace: Optional["_trace.Tracer"] = None,
        metrics_mode: str = "exact",
        engine_mode: str = "event",
    ):
        if engine_mode not in ("event", "batched"):
            raise ValueError(
                f"engine_mode must be event|batched, got {engine_mode!r}"
            )
        self.window = window
        self.policy = policy
        self.seed = seed
        self.max_slots = max_slots
        self.patience = patience
        self.check_ledger = check_ledger
        # "event" walks the heap one event at a time and scans the active
        # set per slot — the parity oracle. "batched" drains a slot's
        # events in one pull, groups completion/failure releases into one
        # ledger op, fast-forwards idle gaps, and keeps incremental
        # queued/patience/ordering indexes — bit-identical reports,
        # ledgers, and journals by construction (tests/test_sim_batch.py)
        self.engine_mode = engine_mode
        self._batched = engine_mode == "batched"
        # observability: an explicit Tracer is activated for the duration
        # of the run (run()/recover()) without touching the process-global
        # tracer installed via REPRO_TRACE; None leaves whatever is
        # globally installed (possibly nothing) in effect
        self._trace = trace
        # crash-consistency: snapshot every K slots (None = never) and
        # journal stream pulls between snapshots; kill_at injects a
        # SimKilled at the named slot (chaos tests / recovery drills)
        self.checkpoint_every = checkpoint_every
        self.kill_at = kill_at
        # requeued residual attempts draw a fresh failure with this
        # probability (per (job_id, attempt) derived seeds) — fixes the
        # failure-immunity of survivors; default 0 keeps recorded golden
        # traces reproducible
        self.refail_rate = float(refail_rate)
        self.refail_delay = refail_delay
        # elastic jobs: minimum slots between consecutive reshapes of one
        # job (damper against level flapping); per-job quality state
        self._reshape_cooldown = int(reshape_cooldown)
        self._elastic: Dict[int, ElasticState] = {}
        self.metrics = MetricsCollector(
            window.cluster.resources, window.cluster.num_machines,
            mode=metrics_mode,
        )
        self.states: Dict[int, JobState] = {}
        # incremental active-set index: the slot loop touches only jobs
        # that are live (active) or awaiting a requeue, so 1e4+-job
        # traces don't pay a full-state rescan per slot (the finished
        # majority never re-enters either set)
        self._active: set = set()
        self._awaiting: set = set()
        # batched-mode incremental indexes (mirrors of _active-derived
        # scans the oracle recomputes per slot):
        #   _never_served — active jobs with no first service yet (the
        #       per-slot "queued" count becomes len())
        #   _active_order — (arrival, job_id) keys kept sorted by bisect;
        #       the SLOT tick's active tuple without a per-slot sort
        #   _order_key    — job_id -> its key in _active_order
        #   _patience_heap — (orig_arrival + patience, job_id) min-heap;
        #       patience checks pop due entries instead of scanning
        self._never_served: set = set()
        self._active_order: List[Tuple[int, int]] = []
        self._order_key: Dict[int, Tuple[int, int]] = {}
        self._patience_heap: List[Tuple[int, int]] = []
        self._patience_seen: set = set()
        # admission-latency SLO accounting: wall-clock seconds spent in
        # the policy's ARRIVAL-batch offer, observed once per arriving job
        # (observational only — never folded into summary/report parity)
        self._adm_p50 = P2Quantile(0.50)
        self._adm_p99 = P2Quantile(0.99)
        self._adm_n = 0
        self._adm_sum = 0.0
        self.queue = EventQueue()
        # machine -> {incident id -> capacity factor} for active incidents
        self._incidents: Dict[int, Dict[int, float]] = {}
        # crash-consistency state
        self.journal: List[Event] = []
        self._checkpoint: Optional[Checkpoint] = None
        self._consumed = 0
        self._stream: Optional[Iterator[Event]] = None
        self._pending: Optional[Event] = None
        self._t = 0
        policy.bind(window, seed)

    # -- active-set index maintenance ----------------------------------
    def _set_active(self, js: JobState, active: bool) -> None:
        js.active = active
        jid = js.job.job_id
        if active:
            self._active.add(jid)
            if self._batched:
                if jid not in self._order_key:
                    key = (js.job.arrival, jid)
                    self._order_key[jid] = key
                    bisect.insort(self._active_order, key)
                if self.metrics.outcome(
                        jid, js.orig_arrival).first_service is None:
                    self._never_served.add(jid)
                if (self.patience is not None and js.attempt == 0
                        and jid not in self._patience_seen):
                    self._patience_seen.add(jid)
                    heapq.heappush(self._patience_heap,
                                   (js.orig_arrival + self.patience, jid))
        else:
            self._active.discard(jid)
            if self._batched:
                key = self._order_key.pop(jid, None)
                if key is not None:
                    i = bisect.bisect_left(self._active_order, key)
                    del self._active_order[i]
                self._never_served.discard(jid)

    def _set_awaiting(self, js: JobState, awaiting: bool) -> None:
        js.awaiting_requeue = awaiting
        if awaiting:
            self._awaiting.add(js.job.job_id)
        else:
            self._awaiting.discard(js.job.job_id)

    # ------------------------------------------------------------------
    def _notify(self, kind: EventKind, job_id: int, t: int) -> None:
        self.policy.offer(
            Event(time=t, kind=kind, job_id=job_id), self.window
        )

    def _residual(self, js: JobState, t: int) -> Optional[JobSpec]:
        """The preempted job's remaining workload as a next-slot re-offer."""
        remaining = js.job.total_workload() - js.progress
        if remaining <= 1e-6:
            return None
        return replace(
            js.job, epochs=1, num_samples=max(1, int(math.ceil(remaining))),
            arrival=t + 1,
        )

    def _fail(self, job_id: int, t: int) -> None:
        js = self.states.get(job_id)
        if js is None or js.finished or not js.active:
            return  # not running (never served / already done): fault is moot
        if js.down_at == t:
            # already knocked out this slot (duplicate FAILURE, or a
            # machine-crash eviction followed by the job's own failure):
            # one slot is lost once, not per fault
            return
        oc = self.metrics.outcome(job_id, js.orig_arrival)
        released = self.window.release_from(job_id, t)
        if released == 0 and js.progress <= 0:
            return  # never served: the fault hit a queued job, nothing to kill
        oc.preemptions += 1
        # the failed slot is lost for every policy shape: the job sits out
        # slot t's tick (slot-driven) / restarts no earlier than t+1
        # (arrival-driven), so a failure costs at least one service slot
        # uniformly — arrival-driven policies additionally lose their
        # committed forward schedule and must re-admit the residual
        js.down_at = t
        self.metrics.count("preempt")
        self._notify(EventKind.PREEMPT, job_id, t)
        if self.policy.reoffers_on_preempt:
            residual = self._residual(js, t)
            if residual is None:
                return
            self._set_active(js, False)
            self._set_awaiting(js, True)
            self.queue.push(Event(time=t + 1, kind=EventKind.ARRIVAL,
                                  job=residual, requeue=True))
        # slot-driven: the job stays active; the policy dropped any held
        # allocation in on_preempt and will re-place it next tick

    def _fail_group(self, job_ids: List[int], t: int) -> None:
        """Batched-mode fold of a slot's plain FAILURE events: eligibility
        is decided in event order with an explicit in-group duplicate
        check (the oracle's second same-slot failure of one job sees
        ``down_at == t``), the eligible jobs' rows come off in one grouped
        release (``release_many`` preserves the per-(job, slot) ledger op
        order), and the preempt notifications/requeues run in the same
        order afterwards. Machine-crash eviction cascades are NOT grouped
        — they interleave releases with overcommit checks and stay on the
        per-event ``_fail`` path in both modes."""
        elig: List[Tuple[int, JobState]] = []
        seen: set = set()
        for job_id in job_ids:
            js = self.states.get(job_id)
            if js is None or js.finished or not js.active:
                continue
            if js.down_at == t or job_id in seen:
                continue
            seen.add(job_id)
            elig.append((job_id, js))
        if not elig:
            return
        counts = self.window.release_many([(jid, t) for jid, _ in elig])
        for job_id, js in elig:
            if counts[job_id] == 0 and js.progress <= 0:
                continue  # never served: the fault hit a queued job
            oc = self.metrics.outcome(job_id, js.orig_arrival)
            oc.preemptions += 1
            js.down_at = t
            self.metrics.count("preempt")
            self._notify(EventKind.PREEMPT, job_id, t)
            if self.policy.reoffers_on_preempt:
                residual = self._residual(js, t)
                if residual is None:
                    continue
                self._set_active(js, False)
                self._set_awaiting(js, True)
                self.queue.push(Event(time=t + 1, kind=EventKind.ARRIVAL,
                                      job=residual, requeue=True))

    # -- machine fault domains -----------------------------------------
    def _apply_capacity_mask(self) -> None:
        """Fold the active incidents into the cluster's capacity mask
        (overlapping incidents on one machine compose by min)."""
        cl = self.window.cluster
        mask = np.ones(cl.num_machines)
        for h, incs in self._incidents.items():
            if incs:
                mask[h] = min(incs.values())
        cl.set_capacity_mask(mask)

    def _machine_down(self, ev: Event, t: int) -> None:
        """MACHINE_DOWN: shrink the machine's capacity share to
        ``ev.factor`` and evict committed holders the shrunk machine can
        no longer carry — each eviction runs the ordinary PREEMPT path
        (release, notify, requeue residual), so a crash is indirectly a
        cascade of re-offers. Eviction order is ascending job id: smallest
        ids first, deterministic across runs and replays."""
        h = ev.machine
        self._incidents.setdefault(h, {})[ev.incident] = float(ev.factor)
        self._apply_capacity_mask()
        kind = "crash" if ev.factor <= 0.0 else "straggler"
        self.metrics.record_incident(h, ev.incident, t, float(ev.factor),
                                     kind)
        self.metrics.count("machine_down")
        cl = self.window.cluster
        evicted = 0
        while cl.machine_overcommitted(h):
            holders = self.window.jobs_on_machine(h)
            if not holders:
                break  # sub-tolerance residue, nothing left to evict
            victim = holders[0]
            self._fail(victim, t)
            if victim in self.window.commitments:
                # the PREEMPT path declined (job unknown/finished): force
                # the rows off the dead machine so the loop progresses
                self.window.release_from(victim, t)
            evicted += 1
        self.metrics.record_cascade(evicted)

    def _machine_up(self, ev: Event, t: int) -> None:
        """MACHINE_UP: retire the incident; capacity restores when the
        machine's last overlapping incident clears (bit-identically to
        the pre-fault capacity matrix — see Cluster.set_capacity_mask)."""
        h = ev.machine
        incs = self._incidents.get(h)
        if incs is not None:
            incs.pop(ev.incident, None)
            if not incs:
                del self._incidents[h]
        self._apply_capacity_mask()
        self.metrics.record_recovery(h, ev.incident, t)
        self.metrics.count("machine_up")

    def _depart(self, job_id: int, t: int) -> None:
        js = self.states[job_id]
        self._set_active(js, False)
        js.finished = True
        self.window.release_from(job_id, t)  # same-slot admissions may hold rows
        oc = self.metrics.outcome(job_id, js.orig_arrival)
        oc.departed_at = t
        self.metrics.count("departure")
        self._finalize_quality(js, oc)
        self.metrics.job_closed(oc)
        self._notify(EventKind.DEPARTURE, job_id, t)

    def _handle_arrivals(self, batch: List[Event], t: int) -> None:
        jobs: List[JobSpec] = []
        for ev in batch:
            job = ev.job
            js = self.states.get(job.job_id)
            if ev.requeue:
                js.job = job
                js.attempt += 1
                js.progress = 0.0
                self._set_awaiting(js, False)
                if self.refail_rate > 0.0:
                    # failure-immunity fix: survivors are mortal again —
                    # each requeued attempt redraws its own failure from a
                    # per-(job, attempt) derived seed, so the draw depends
                    # on nothing but identity (replay/recovery safe)
                    rng = derived_rng(self.seed, _TAG_REFAIL,
                                      job.job_id, js.attempt)
                    if rng.random() < self.refail_rate:
                        lo, hi = self.refail_delay
                        self.queue.push(Event(
                            time=t + int(rng.integers(lo, hi + 1)),
                            kind=EventKind.FAILURE, job_id=job.job_id,
                        ))
            else:
                js = self.states[job.job_id] = JobState(
                    job=job, orig_arrival=job.arrival
                )
                oc = self.metrics.outcome(job.job_id, job.arrival)
                self.metrics.count("arrival")
                el = job.elastic
                if el is not None:
                    self._elastic[job.job_id] = ElasticState(
                        samples_per_epoch=float(max(1, job.num_samples))
                    )
                    if el.deadline is not None:
                        oc.deadline = job.arrival + int(el.deadline)
                    oc.loss_slo = el.loss_slo
                if ev.fail_at is not None and ev.fail_at > t:
                    self.queue.push(Event(time=ev.fail_at,
                                          kind=EventKind.FAILURE,
                                          job_id=job.job_id))
            jobs.append(job)
        jobs.sort(key=lambda j: j.job_id)
        t0 = _time.perf_counter()
        dec = self.policy.offer(
            Event(time=t, kind=EventKind.ARRIVAL, jobs=tuple(jobs)),
            self.window,
        )
        elapsed = _time.perf_counter() - t0
        # each job in the batch waited the whole batch offer: observe the
        # latency once per job so the SLO percentiles are job-weighted
        for _ in jobs:
            self._adm_p50.observe(elapsed)
            self._adm_p99.observe(elapsed)
        self._adm_n += len(jobs)
        self._adm_sum += elapsed * len(jobs)
        for job in jobs:
            js = self.states[job.job_id]
            oc = self.metrics.outcome(job.job_id, js.orig_arrival)
            if self.policy.slot_driven:
                self._set_active(js, True)  # implicit admission: queue
                continue
            admitted = dec.admitted.get(job.job_id, False)
            if js.attempt == 0:
                oc.admitted = admitted
            if admitted:
                self._set_active(js, True)
            elif js.attempt == 0:
                # rejected offers leave immediately (Algorithm 1 admits/drops)
                self._set_active(js, False)
                js.finished = True
                self.metrics.count("rejection")
                self._finalize_quality(js, oc)
                self.metrics.job_closed(oc)
            else:
                # a preempted job whose residual re-offer was rejected: it
                # WAS admitted, trained, and then left incomplete — surfaced
                # as an eviction so completion shortfalls stay attributable
                self._set_active(js, False)
                js.finished = True
                oc.evicted_at = t
                self.metrics.count("eviction")
                self._finalize_quality(js, oc)
                self.metrics.job_closed(oc)

    def _account_progress_batched(self, t: int) -> None:
        """Progress accounting over the window's per-slot holder index:
        only jobs committed at slot ``t`` are visited (jobs without an
        allocation are exact no-ops in the oracle's scan), in the same
        ascending-job-id order. Completions defer their tail release and
        COMPLETION notification past the loop: the releases fold into one
        grouped ledger op with per-(job, slot) order preserved, and
        nothing in the loop body reads the ledger, so the resulting state
        is bit-identical to the oracle's interleaved releases."""
        done: List[int] = []
        for job_id in sorted(self.window.holders_at(t)):
            js = self.states[job_id]
            if js.finished or not js.active:
                continue
            alloc = self.window.alloc_at(job_id, t)
            if alloc is None or alloc.empty():
                continue
            oc = self.metrics.outcome(job_id, js.orig_arrival)
            if oc.first_service is None:
                oc.first_service = t
                self._never_served.discard(job_id)
            earned = alloc.samples_trained(js.job)
            js.progress += earned
            oc.samples_trained += earned
            if js.progress >= js.job.total_workload() - 1e-6:
                self._set_active(js, False)
                js.finished = True
                done.append(job_id)
                oc.completed_at = t
                oc.utility = js.job.utility(t - js.orig_arrival)
                self.metrics.count("completion")
                self._finalize_quality(js, oc)
                self.metrics.job_done(oc)
        if done:
            self.window.release_many([(jid, t + 1) for jid in done])
            for job_id in done:
                self._notify(EventKind.COMPLETION, job_id, t)

    def _account_progress(self, t: int) -> None:
        # per-job accounting is independent (progress reads the job's own
        # commitments; a completion releases only its own rows), so the
        # sorted active set is both deterministic and equivalent to the
        # old full-state scan
        for job_id in sorted(self._active):
            js = self.states[job_id]
            if js.finished:
                continue
            alloc = self.window.alloc_at(job_id, t)
            if alloc is None or alloc.empty():
                continue
            oc = self.metrics.outcome(job_id, js.orig_arrival)
            if oc.first_service is None:
                oc.first_service = t
            earned = alloc.samples_trained(js.job)
            js.progress += earned
            oc.samples_trained += earned  # goodput/wasted-work basis
            if js.progress >= js.job.total_workload() - 1e-6:
                self._set_active(js, False)
                js.finished = True
                self.window.release_from(job_id, t + 1)
                oc.completed_at = t
                oc.utility = js.job.utility(t - js.orig_arrival)
                self.metrics.count("completion")
                self._finalize_quality(js, oc)
                self.metrics.job_done(oc)
                self._notify(EventKind.COMPLETION, job_id, t)

    def _check_patience_batched(self, t: int) -> None:
        """Pop due entries off the patience heap instead of scanning the
        active set. Every entry was pushed at first activation with
        due = orig_arrival + patience; a job still active and never
        served at its due slot departs exactly there (the oracle, which
        checks every slot, fires at the same slot), and due-slot ties pop
        in ascending job id — the oracle's sorted-scan order. Entries for
        jobs that were served, admitted (schedule contract), or already
        gone drop silently: those exemptions are permanent."""
        if self.patience is None:
            return
        heap = self._patience_heap
        while heap and heap[0][0] <= t:
            due, job_id = heapq.heappop(heap)
            js = self.states.get(job_id)
            if js is None or js.finished or not js.active:
                continue
            oc = self.metrics.outcome(job_id, js.orig_arrival)
            if oc.admitted is True or oc.first_service is not None:
                continue
            self._depart(job_id, t)

    def _check_patience(self, t: int) -> None:
        if self.patience is None:
            return
        for job_id in sorted(self._active):
            js = self.states[job_id]
            if js.finished:
                continue
            oc = self.metrics.outcome(job_id, js.orig_arrival)
            if oc.admitted is True:
                continue  # an admitted job holds a schedule contract
            if oc.first_service is None and t - js.orig_arrival >= self.patience:
                self._depart(job_id, t)

    # -- elastic / quality-driven jobs ---------------------------------
    def _finalize_quality(self, js: JobState, oc) -> None:
        """Stamp the job's final loss from its ground-truth curve at its
        cumulative epoch count. MUST run before the outcome is folded
        (``job_done``/``job_closed``): streaming metrics drop the row at
        the fold, so late writes would be lost. Never-served jobs keep
        ``final_loss=None`` — they trained nothing, so a loss claim would
        be fiction (and an automatic SLO miss keeps attribution honest)."""
        es = self._elastic.pop(js.job.job_id, None)
        el = js.job.elastic
        if es is None or el is None or el.curve is None:
            return
        if oc.samples_trained > 0:
            oc.final_loss = el.curve.loss(
                oc.samples_trained / es.samples_per_epoch
            )

    def _check_reshapes(self, t: int) -> None:
        """The RESHAPE trigger scan, shared verbatim by both engine modes
        (one code path = bit-identical decisions by construction). For
        every live elastic job with new progress this slot: observe the
        ground-truth loss at its cumulative epoch count, refresh the SLAQ
        online fit from the observation history, and — outside the
        per-job cooldown — fire the adadamp grow trigger (observed loss
        reached ``damper_loss``: larger batches are safe, scale demand up)
        or the SLAQ shrink trigger (predicted marginal loss improvement
        per epoch fell under ``marginal_floor``: free the excess for
        steeper jobs). Everything here derives from engine-owned progress
        accounting — no rng — so replay and recovery redo it exactly."""
        if not self._elastic:
            return
        for job_id in sorted(self._elastic):
            js = self.states.get(job_id)
            if js is None or js.finished:
                continue
            if not js.active or js.awaiting_requeue or js.down_at == t:
                continue
            el = js.job.elastic
            if el is None or el.curve is None:
                continue
            es = self._elastic[job_id]
            oc = self.metrics.outcome(job_id, js.orig_arrival)
            total = oc.samples_trained
            if total <= es.last_samples + 1e-9:
                continue  # no new progress this slot — no new observation
            es.last_samples = total
            epochs = total / es.samples_per_epoch
            obs_loss = el.curve.loss(epochs)
            es.observations.append((epochs, obs_loss))
            if len(es.observations) > 64:
                del es.observations[0]
            if len(es.observations) >= 3:
                fitted = QualityCurve.fit(es.observations)
                if fitted is not None:
                    es.fitted = fitted
            if t < es.cooldown_until:
                continue
            if (el.damper_loss > 0.0 and obs_loss <= el.damper_loss
                    and el.level < len(el.levels) - 1):
                self._reshape(js, oc, t, el.level + 1, es)
                continue
            pred = es.fitted if es.fitted is not None else el.curve
            if (el.marginal_floor > 0.0 and el.level > 0
                    and pred.marginal(epochs) < el.marginal_floor):
                self._reshape(js, oc, t, el.level - 1, es)

    def _reshape(self, js: JobState, oc, t: int, new_level: int,
                 es: ElasticState) -> None:
        """Mid-run demand change: release the job's residual commitment
        through the preempt-release machinery and re-enter it with the
        updated demand signature. Slot ``t``'s earnings stand (the release
        starts at ``t + 1`` — completion-style, unlike a failure's
        lost-slot release at ``t``). Arrival-driven policies get the
        reshaped residual as a next-slot re-offer; slot-driven policies get
        the spec swapped in place — arrival preserved, so the per-slot
        ordering key fixed at activation stays identical in both engine
        modes — and re-place the new demands at the next tick."""
        job_id = js.job.job_id
        residual = self._residual(js, t)
        if residual is None:
            return  # workload effectively done; completion will handle it
        reshaped = residual.at_level(new_level)
        self.window.release_from(job_id, t + 1)
        oc.reshapes += 1
        es.reshapes += 1
        es.cooldown_until = t + 1 + self._reshape_cooldown
        self.metrics.count("reshape")
        self._notify(EventKind.RESHAPE, job_id, t)
        if self.policy.reoffers_on_preempt:
            self._set_active(js, False)
            self._set_awaiting(js, True)
            self.queue.push(Event(time=t + 1, kind=EventKind.ARRIVAL,
                                  job=reshaped, requeue=True))
        else:
            js.job = replace(reshaped, arrival=js.job.arrival)
            js.attempt += 1
            js.progress = 0.0

    # -- crash consistency ---------------------------------------------
    def _pull(self) -> Optional[Event]:
        """Pull the next trace event, journaling it for recovery.

        Without checkpoints the journal only ever serves the debugging
        tail of ``LedgerInvariantError`` (its last 64 entries), so it is
        trimmed instead of retaining the whole trace — the stream-scale
        O(n) memory fix. With ``checkpoint_every`` set the journal IS the
        recovery log and is kept in full between snapshots (a snapshot
        resets it)."""
        ev = next(self._stream, None)
        if ev is not None:
            self._consumed += 1
            self.journal.append(ev)
            if self.checkpoint_every is None and len(self.journal) > 192:
                del self.journal[:128]
        return ev

    def _take_checkpoint(self, t: int) -> None:
        """Snapshot every piece of mutable engine state in ONE deepcopy
        (shared references — policy.view is the window, price tables hold
        the cluster — stay shared inside the snapshot) and reset the
        journal: recovery = snapshot + journal replay."""
        state = copy.deepcopy((
            self.window, self.policy, self.metrics, self.states,
            self.queue, self._active, self._awaiting, self._incidents,
            self._pending, self._elastic,
            (self._never_served, self._active_order, self._order_key,
             self._patience_heap, self._patience_seen),
        ))
        self._checkpoint = Checkpoint(slot=t, consumed=self._consumed,
                                      state=state)
        self.journal = []

    def recover(self, events: Optional[Iterable[Event]] = None) -> SimReport:
        """Resume a killed run from the last checkpoint, bit-identically.

        Restores the snapshot (the checkpoint itself stays pristine, so
        recovery can be repeated) and re-runs the slot loop. With
        ``events`` — the original trace, regenerated — the consumed prefix
        is skipped and the run continues to the end; with ``events=None``
        the journaled tail alone is replayed (enough to reach the kill
        point when the stream died with the process). Because every
        random decision derives from identity-keyed seeds, the recovered
        run's summary equals the uninterrupted run's bit-for-bit."""
        if self._trace is not None:
            with _trace.activate(self._trace):
                return self._recover_inner(events)
        return self._recover_inner(events)

    def _recover_inner(self, events: Optional[Iterable[Event]]) -> SimReport:
        ck = self._checkpoint
        if ck is None:
            raise RuntimeError(
                "no checkpoint to recover from (run with checkpoint_every)"
            )
        get_registry().counter(
            "repro_sim_recoveries_total",
            "checkpoint restores (SimEngine.recover)").inc()
        tail = list(self.journal)
        with _trace.span("sim.recover", slot=ck.slot, consumed=ck.consumed):
            (self.window, self.policy, self.metrics, self.states,
             self.queue, self._active, self._awaiting, self._incidents,
             self._pending, self._elastic,
             (self._never_served, self._active_order, self._order_key,
              self._patience_heap, self._patience_seen),
             ) = copy.deepcopy(ck.state)
        self.journal = []
        self._consumed = ck.consumed
        self._t = ck.slot
        self.kill_at = None  # the kill already happened; don't re-die
        if events is None:
            self._stream = iter(tail)
        else:
            self._stream = itertools.islice(iter(events), ck.consumed, None)
        return self._run_loop()

    # ------------------------------------------------------------------
    def run(self, events: Iterable[Event]) -> SimReport:
        self._stream = iter(events)
        self._pending = self._pull()
        self._t = 0
        return self._run_loop()

    def _run_loop(self) -> SimReport:
        if self._trace is not None:
            with _trace.activate(self._trace):
                return self._loop()
        return self._loop()

    def _loop(self) -> SimReport:
        while self._t < self.max_slots:
            t = self._t
            if (self.checkpoint_every is not None
                    and t % self.checkpoint_every == 0
                    and (self._checkpoint is None
                         or self._checkpoint.slot != t)):
                with _trace.span("sim.checkpoint", t=t):
                    self._take_checkpoint(t)
            if self.kill_at is not None and t == self.kill_at:
                raise SimKilled(f"engine killed at slot {t} (kill_at)")
            while self._pending is not None and self._pending.time <= t:
                self.queue.push(self._pending)
                self._pending = self._pull()
            busy = bool(self._active) or bool(self._awaiting)
            if not busy and not len(self.queue) and self._pending is None:
                break
            if self._batched and not busy and self.queue.peek_time() != t:
                # idle fast-forward: nothing is active or awaiting and the
                # next event lies beyond this slot, so every intervening
                # slot is an exact no-op except its metrics row (the
                # ledger is empty — completed/preempted/departed jobs all
                # released their rows — so utilization and the ledger
                # check are constant across the gap). Jump to the next
                # event, stopping at checkpoint boundaries and kill_at so
                # snapshot slots and the kill slot match the oracle.
                nt = self.queue.peek_time()
                if nt is None:
                    nt = self._pending.time  # pending exists or we broke
                elif self._pending is not None:
                    nt = min(nt, self._pending.time)
                target = min(nt, self.max_slots)
                if self.kill_at is not None and t < self.kill_at:
                    target = min(target, self.kill_at)
                if self.checkpoint_every is not None:
                    k = self.checkpoint_every
                    target = min(target, (t // k + 1) * k)
                if target > t:
                    with _trace.span("sim.advance", t=t):
                        self.window.advance_to(t)
                    util = self.window.utilization_now()
                    degraded = tuple(sorted(
                        h for h, incs in self._incidents.items() if incs
                    ))
                    for ts in range(t, target):
                        self.metrics.record_slot(ts, util, 0, 0,
                                                 degraded=degraded)
                    self._t = target
                    continue
            with _trace.span("sim.advance", t=t):
                self.window.advance_to(t)

            batch: List[Event] = []
            departures: List[int] = []
            failures: List[int] = []
            evs = (self.queue.pop_slot(t) if self._batched
                   else self.queue.pop_until(t))
            for ev in evs:
                if ev.kind == EventKind.MACHINE_UP:
                    self._machine_up(ev, t)
                elif ev.kind == EventKind.MACHINE_DOWN:
                    self._machine_down(ev, t)
                elif ev.kind == EventKind.FAILURE:
                    if self._batched:
                        failures.append(ev.subject())
                    else:
                        self._fail(ev.subject(), t)
                elif ev.kind == EventKind.ARRIVAL:
                    batch.append(ev)
                elif ev.kind == EventKind.DEPARTURE:
                    # exogenous departure (a trace may model jobs giving up
                    # on their own clock); applied after the slot's arrival
                    # batch so a same-slot DEPARTURE+ARRIVAL pair still
                    # departs instead of being dropped against a job state
                    # that does not exist yet
                    departures.append(ev.subject())
                else:
                    # COMPLETION/PREEMPT/SLOT are engine-emitted
                    # notifications, never queue input — fail loud rather
                    # than silently dropping a mis-routed event
                    raise ValueError(
                        f"unsupported queued event kind {ev.kind!r} at t={t}"
                    )
            if failures:
                # all of a slot's plain FAILUREs pop before its ARRIVALs
                # (kind priority), so the grouped fold sits exactly where
                # the oracle's per-event _fail calls were
                self._fail_group(failures, t)
            if batch:
                with _trace.span("sim.arrivals", t=t, jobs=len(batch)):
                    self._handle_arrivals(batch, t)
            for job_id in departures:
                js = self.states.get(job_id)
                if js is None or js.finished or not js.active \
                        or self.metrics.outcome(
                            job_id, js.orig_arrival).first_service is not None:
                    self.metrics.count("departure_moot")  # served/done/unknown
                    continue
                self._depart(job_id, t)
            if self.policy.slot_driven:
                sts = self.states
                if self._batched:
                    # _active_order is the oracle's sorted() result kept
                    # incrementally: keys are (arrival, job_id) fixed at
                    # activation, and a job's arrival only changes on a
                    # requeue, which happens while deactivated
                    actives = [
                        sts[jid].job for _, jid in self._active_order
                        if not sts[jid].finished and sts[jid].down_at != t
                    ]
                else:
                    actives = sorted(
                        (sts[jid].job for jid in self._active
                         if not sts[jid].finished
                         and sts[jid].down_at != t),
                        key=lambda j: (j.arrival, j.job_id),
                    )
                if actives:
                    # the progress payload is only read by fairness-aware
                    # slot policies (Dorm); the batched engine skips
                    # building it for policies that declare wants_progress
                    # False — the Event differs but no decision can
                    progress = None
                    if not self._batched or getattr(
                            self.policy, "wants_progress", True):
                        progress = {
                            j.job_id: sts[j.job_id].progress
                            for j in actives
                        }
                    self.policy.offer(
                        Event(
                            time=t, kind=EventKind.SLOT, jobs=tuple(actives),
                            progress=progress,
                        ),
                        self.window,
                    )
            if self.check_ledger and self.window.oversubscribed():
                raise LedgerInvariantError(
                    slot=t, policy=self.policy.name,
                    report=SimReport(
                        summary=self.metrics.summary(),
                        metrics=self.metrics,
                        states=self.states,
                        slots_run=t,
                    ),
                    journal_tail=tuple(self.journal[-64:]),
                )
            if self._batched:
                self._account_progress_batched(t)
                self._check_patience_batched(t)
            else:
                self._account_progress(t)
                self._check_patience(t)
            # elastic reshape triggers run AFTER progress/patience in both
            # modes, through the one shared scan — mode parity by
            # construction
            self._check_reshapes(t)
            active = len(self._active)
            if self._batched:
                queued = len(self._never_served)
            else:
                queued = sum(
                    1 for jid in self._active
                    if self.metrics.outcome(
                        jid, self.states[jid].orig_arrival,
                    ).first_service is None
                )
            degraded = tuple(sorted(
                h for h, incs in self._incidents.items() if incs
            ))
            self.metrics.record_slot(
                t, self.window.utilization_now(), active, queued,
                degraded=degraded,
            )
            self._t = t + 1
        summary = self.metrics.summary()
        health = getattr(self.policy, "health_stats", None)
        if callable(health):
            summary["policy_health"] = health()
        pd_snap = None
        pd = getattr(self.policy, "pd_gap_stats", None)
        if callable(pd):
            pd_snap = pd() or None
        faults = getattr(self.policy, "fault_stats", None)
        if callable(faults):
            fs = faults()
            if fs:
                summary["solver_faults"] = fs
        self._publish_registry(summary, pd_snap)
        return SimReport(
            summary=summary,
            metrics=self.metrics,
            states=self.states,
            slots_run=self._t,
            pd_gap=pd_snap,
        )

    def admission_latency(self) -> Dict[str, float]:
        """Wall-clock SLO accounting of the ARRIVAL-batch offer path:
        per-job admission latency count/mean/p50/p99 in milliseconds
        (P-squared estimates). Observational — never part of the report
        parity surface — and the basis of the stream-scale benchmark's
        SLO columns."""
        n = self._adm_n
        return {
            "count": float(n),
            "mean_ms": (self._adm_sum / n * 1e3) if n else 0.0,
            "p50_ms": self._adm_p50.value() * 1e3,
            "p99_ms": self._adm_p99.value() * 1e3,
        }

    def _publish_registry(self, summary: Dict,
                          pd_snap: Optional[Dict] = None) -> None:
        """Mirror engine-scope stats into the metrics registry at the run's
        ONE sync point. Gauges are SET from the summary — which is computed
        from checkpoint-restored state on a recovered run — so recovery
        publishes bit-identical values to an uninterrupted run."""
        reg = get_registry()
        ph = summary.get("policy_health")
        if isinstance(ph, dict):
            for k, v in ph.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    reg.gauge(
                        "repro_policy_health_" + k,
                        "ResilientPolicy health counter (summary view)",
                    ).set(float(v))
        fs = summary.get("solver_faults")
        if isinstance(fs, dict):
            for k, v in fs.items():
                reg.gauge(
                    "repro_" + k,
                    "solver-fault injector dispatch stat (summary view)",
                ).set(float(v))
        for k in ("pd_offers", "pd_admits", "pd_primal", "pd_dual",
                  "duality_gap", "empirical_ratio", "ratio_bound"):
            v = (pd_snap or {}).get(k)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                name = k if k.startswith("pd_") else "pd_" + k
                reg.gauge(
                    "repro_" + name,
                    "primal-dual telemetry (summary view)",
                ).set(float(v))
        for k in ("reshapes", "deadline_jobs", "deadline_attainment",
                  "slo_jobs", "slo_attainment", "final_loss_mean"):
            v = summary.get(k)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                reg.gauge(
                    "repro_quality_" + k,
                    "elastic-job quality/SLO stat (summary view)",
                ).set(float(v))
        if self._adm_n:
            adm = self.admission_latency()
            for k in ("p50_ms", "p99_ms", "mean_ms"):
                reg.gauge(
                    "repro_admission_latency_" + k,
                    "per-job ARRIVAL-offer wall latency (P-squared)",
                ).set(adm[k])


def simulate(
    window: RollingWindow,
    policy: SchedulingPolicy,
    events: Iterable[Event],
    seed: int = 0,
    max_slots: int = 100_000,
    patience: Optional[int] = None,
    **engine_kwargs,
) -> SimReport:
    """One-call convenience wrapper (extra kwargs — ``check_ledger``,
    ``checkpoint_every``, ``refail_rate``, … — pass through to
    ``SimEngine``)."""
    return SimEngine(
        window, policy, seed=seed, max_slots=max_slots, patience=patience,
        **engine_kwargs,
    ).run(events)
