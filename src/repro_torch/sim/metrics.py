"""Metrics pipeline for the event-driven simulator.

Per-slot series (utilization per resource, active/queued counts) are
recorded as the engine runs; per-job outcomes (admission, queueing delay,
JCT, utility, preemptions) are recorded as their events fire. ``summary()``
folds both into the flat dict that ``benchmarks/bench_sim.py`` writes to
``BENCH_sim.json``: JCT p50/p95/mean + CDF, queueing-delay percentiles,
admission/completion rates, mean utilization, and total realized utility
(u_i evaluated at the *actual* completion latency, per the engine's
accounting — never the policy's own estimate).

Conventions: JCT and utility are measured for completed jobs only;
``completion_rate``/``admission_rate`` put the censoring in plain sight.
Queueing delay is first-service slot minus arrival slot (0 for a job
served in its arrival slot). Utilization averages are reported both over
all simulated slots and over busy slots (>= 1 active job).

Two collection modes behind one API (``mode=``):

* ``"exact"`` (default) — every ``JobOutcome`` and per-slot row is
  retained; percentiles are computed on the full sample. Tests and the
  figure scripts read ``outcomes`` / ``per_slot`` / ``jct_cdf`` directly,
  so this stays the default.
* ``"streaming"`` — O(1) memory in trace length: the engine hands each
  completed outcome to ``job_done``, which folds it into running sums,
  P-squared quantile estimators (``P2Quantile``) and a deterministic
  fixed-size reservoir (for the JCT CDF), then DROPS the record; per-slot
  utilization keeps running sums instead of the row list. ``summary()``
  emits the same keys; JCT/queue-delay percentiles become estimates, and
  queue-delay percentiles cover completed jobs only (a still-running
  served job's delay is not folded in until it completes). Jobs that
  finish without completing (rejected/departed/evicted) are folded the
  same way through ``job_closed`` — their censoring columns become exact
  running counters and the rows drop, so ``outcomes`` holds only jobs
  still in flight: memory stays bounded by the concurrent-job count on a
  100k-job stream, not the stream length. (Censored float sums
  accumulate in close-event order, which can differ from exact mode's
  arrival-order summation by float rounding — count columns are exact.)
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


class P2Quantile:
    """Jain & Chlamtac's P-squared algorithm: one quantile, five markers,
    O(1) memory and O(1) per observation — no stored sample.

    Until five observations arrive the estimate is the exact percentile
    of what has been seen. Deterministic (no rng), deepcopy-safe, so a
    checkpointed estimator replays bit-identically under
    ``SimEngine.recover``."""

    __slots__ = ("p", "n", "q", "npos", "dnpos", "_init")

    def __init__(self, p: float):
        if not 0.0 < p < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {p}")
        self.p = float(p)
        self.n = 0
        self._init: List[float] = []
        self.q: List[float] = []            # marker heights
        self.npos: List[float] = []         # marker positions (1-based)
        self.dnpos = [0.0, p / 2.0, p, (1.0 + p) / 2.0, 1.0]

    def observe(self, x: float) -> None:
        x = float(x)
        self.n += 1
        if len(self._init) < 5:
            self._init.append(x)
            if len(self._init) == 5:
                self.q = sorted(self._init)
                self.npos = [1.0, 2.0, 3.0, 4.0, 5.0]
            return
        q, npos = self.q, self.npos
        if x < q[0]:
            q[0] = x
            k = 0
        elif x >= q[4]:
            q[4] = x
            k = 3
        else:
            k = 0
            while x >= q[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            npos[i] += 1.0
        desired = [1.0 + self.dnpos[i] * (self.n - 1) for i in range(5)]
        for i in (1, 2, 3):
            d = desired[i] - npos[i]
            if ((d >= 1.0 and npos[i + 1] - npos[i] > 1.0)
                    or (d <= -1.0 and npos[i - 1] - npos[i] < -1.0)):
                d = 1.0 if d > 0 else -1.0
                qp = self._parabolic(i, d)
                if q[i - 1] < qp < q[i + 1]:
                    q[i] = qp
                else:                        # parabolic left order: linear
                    q[i] = self._linear(i, d)
                npos[i] += d

    def _parabolic(self, i: int, d: float) -> float:
        q, n = self.q, self.npos
        return q[i] + d / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + d) * (q[i + 1] - q[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - d) * (q[i] - q[i - 1]) / (n[i] - n[i - 1])
        )

    def _linear(self, i: int, d: float) -> float:
        q, n = self.q, self.npos
        j = i + int(d)
        return q[i] + d * (q[j] - q[i]) / (n[j] - n[i])

    def value(self) -> float:
        if len(self._init) < 5:
            if not self._init:
                return 0.0
            return float(np.percentile(
                np.asarray(self._init, dtype=float), self.p * 100.0))
        return float(self.q[2])


class _Reservoir:
    """Fixed-size uniform sample (algorithm R) with a fixed-seed rng:
    the kept sample is a pure function of the observation sequence, so a
    deepcopied (checkpointed) reservoir replays bit-identically."""

    __slots__ = ("k", "seen", "sample", "_rng")

    def __init__(self, k: int = 512):
        self.k = int(k)
        self.seen = 0
        self.sample: List[float] = []
        self._rng = np.random.default_rng(0x5EED)

    def observe(self, x: float) -> None:
        self.seen += 1
        if len(self.sample) < self.k:
            self.sample.append(float(x))
            return
        j = int(self._rng.integers(0, self.seen))
        if j < self.k:
            self.sample[j] = float(x)


class _StreamState:
    """Running aggregates for ``mode="streaming"`` — everything
    ``summary()`` needs about completed jobs and elapsed slots, in O(1)
    memory (plus the fixed-size CDF reservoir)."""

    def __init__(self, resources: List[str]):
        self.n_completed = 0
        self.sum_jct = 0.0
        self.sum_utility = 0.0
        self.sum_goodput = 0.0
        self.sum_preempt = 0
        self.jct_p50 = P2Quantile(0.50)
        self.jct_p95 = P2Quantile(0.95)
        self.delay_p50 = P2Quantile(0.50)
        self.delay_p95 = P2Quantile(0.95)
        self.jct_sample = _Reservoir()
        self.slots = 0
        self.busy_slots = 0
        self.util_sum = {r: 0.0 for r in resources}
        self.util_busy_sum = {r: 0.0 for r in resources}
        # censored closures (rejected / departed / evicted) folded by
        # job_closed — exact counters, so summary() columns match the
        # retained-row accounting they replace
        self.n_closed = 0
        self.closed_rejected = 0
        self.closed_departed = 0
        self.closed_evicted = 0
        self.closed_admitted = 0
        self.closed_preempt = 0
        self.closed_wasted = 0.0
        self.closed_utility = 0.0
        # elastic / quality counters (exact; folded from BOTH hooks, so a
        # deadline job that departs still counts as a deadline miss)
        self.reshapes = 0
        self.deadline_jobs = 0
        self.deadline_hits = 0
        self.slo_jobs = 0
        self.slo_hits = 0
        self.final_loss_sum = 0.0
        self.final_loss_n = 0

    def _absorb_quality(self, oc: "JobOutcome") -> None:
        self.reshapes += int(oc.reshapes)
        if oc.deadline is not None:
            self.deadline_jobs += 1
            if oc.deadline_hit:
                self.deadline_hits += 1
        if oc.loss_slo is not None:
            self.slo_jobs += 1
            if oc.slo_hit:
                self.slo_hits += 1
        if oc.final_loss is not None:
            self.final_loss_sum += float(oc.final_loss)
            self.final_loss_n += 1

    def absorb_censored(self, oc: "JobOutcome") -> None:
        self.n_closed += 1
        if oc.admitted is False:
            self.closed_rejected += 1
        if oc.departed_at is not None:
            self.closed_departed += 1
        if oc.evicted_at is not None:
            self.closed_evicted += 1
        if oc.admitted is True or (oc.admitted is None
                                   and oc.first_service is not None):
            self.closed_admitted += 1
        self.closed_preempt += int(oc.preemptions)
        self.closed_wasted += float(oc.samples_trained)
        self.closed_utility += float(oc.utility)
        self._absorb_quality(oc)

    def absorb(self, oc: "JobOutcome") -> None:
        self.n_completed += 1
        jct = float(oc.jct)
        self.sum_jct += jct
        self.sum_utility += float(oc.utility)
        self.sum_goodput += float(oc.samples_trained)
        self.sum_preempt += int(oc.preemptions)
        self.jct_p50.observe(jct)
        self.jct_p95.observe(jct)
        self.jct_sample.observe(jct)
        if oc.queue_delay is not None:
            self.delay_p50.observe(float(oc.queue_delay))
            self.delay_p95.observe(float(oc.queue_delay))
        self._absorb_quality(oc)


@dataclass
class JobOutcome:
    job_id: int
    arrival: int
    admitted: Optional[bool] = None    # None: slot-driven (implicit)
    first_service: Optional[int] = None
    completed_at: Optional[int] = None
    departed_at: Optional[int] = None
    evicted_at: Optional[int] = None   # admitted, preempted, residual rejected
    preemptions: int = 0
    utility: float = 0.0
    samples_trained: float = 0.0       # across ALL attempts (goodput basis)
    # elastic / quality-driven columns (engine-written; every field is set
    # BEFORE the outcome is folded — streaming mode drops the row at fold)
    reshapes: int = 0                  # mid-run demand-level changes
    final_loss: Optional[float] = None  # ground-truth loss at close
    deadline: Optional[int] = None     # absolute completion-SLO slot
    loss_slo: Optional[float] = None   # final-loss SLO threshold

    @property
    def jct(self) -> Optional[int]:
        if self.completed_at is None:
            return None
        return self.completed_at - self.arrival

    @property
    def queue_delay(self) -> Optional[int]:
        if self.first_service is None:
            return None
        return self.first_service - self.arrival

    @property
    def deadline_hit(self) -> Optional[bool]:
        """None when no deadline; a non-completed deadline job is a miss."""
        if self.deadline is None:
            return None
        return self.completed_at is not None and self.completed_at <= self.deadline

    @property
    def slo_hit(self) -> Optional[bool]:
        """None when no loss SLO; a job that closed without a measured
        final loss (never served) is a miss."""
        if self.loss_slo is None:
            return None
        return self.final_loss is not None and self.final_loss <= self.loss_slo


def _pct(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs, dtype=float), q)) if xs else 0.0


class MetricsCollector:
    """Engine-owned recorder: per-job ``JobOutcome`` rows keyed by job_id
    (``outcome`` creates-or-returns; the engine writes admission, service,
    completion, preemption, and utility fields as events fire), per-slot
    utilization/active/queued series (``record_slot``), and raw event
    counters (``count``). ``summary()`` is the flat dict that becomes one
    ``BENCH_sim.json`` row; ``jct_cdf``/``to_json`` serve the figure
    scripts. Policies never touch this object — identical, engine-owned
    measurement is what keeps per-policy rows comparable."""

    def __init__(self, resources: List[str], num_machines: int = 0,
                 mode: str = "exact"):
        if mode not in ("exact", "streaming"):
            raise ValueError(f"mode must be exact|streaming, got {mode!r}")
        self.mode = mode
        self.resources = list(resources)
        self.num_machines = int(num_machines)
        self.outcomes: Dict[int, JobOutcome] = {}
        self.per_slot: List[Dict] = []
        self.event_counts: Dict[str, int] = {}
        self._stream = (_StreamState(self.resources)
                        if mode == "streaming" else None)
        # fault bookkeeping (machine incidents)
        self._down_slots: Dict[int, int] = {}      # machine -> degraded slots
        self._open_incidents: Dict[Tuple[int, int], Dict] = {}
        self.incident_log: List[Dict] = []         # closed incidents
        self.cascade_depths: List[int] = []        # evictions per incident

    # ------------------------------------------------------------ jobs
    def outcome(self, job_id: int, arrival: int) -> JobOutcome:
        oc = self.outcomes.get(job_id)
        if oc is None:
            oc = self.outcomes[job_id] = JobOutcome(job_id, arrival)
        return oc

    def job_done(self, oc: JobOutcome) -> None:
        """Completion hook (engine-called): a no-op in exact mode; in
        streaming mode the outcome is folded into the running aggregates
        and its record dropped — the engine never reads a completed job's
        outcome again (completed jobs leave the active set)."""
        if self._stream is None:
            return
        self._stream.absorb(oc)
        self.outcomes.pop(oc.job_id, None)

    def job_closed(self, oc: JobOutcome) -> None:
        """Censored-closure hook (engine-called when a job finishes
        without completing: rejection, patience/exogenous departure, or
        eviction of a residual re-offer). A no-op in exact mode; in
        streaming mode the outcome folds into exact running counters and
        the row drops, so ``outcomes`` stays bounded by the number of
        jobs still in flight — the stream-scale leak fix."""
        if self._stream is None:
            return
        self._stream.absorb_censored(oc)
        self.outcomes.pop(oc.job_id, None)

    def count(self, kind: str) -> None:
        self.event_counts[kind] = self.event_counts.get(kind, 0) + 1

    # ------------------------------------------------------------ faults
    def record_incident(self, machine: int, incident: int, t: int,
                        factor: float, kind: str) -> None:
        """A MACHINE_DOWN landed: open the incident for MTTR pairing."""
        self._open_incidents[(machine, incident)] = {
            "machine": machine, "incident": incident, "down_at": t,
            "factor": factor, "kind": kind,
        }

    def record_recovery(self, machine: int, incident: int, t: int) -> None:
        """The incident's MACHINE_UP landed: close it and log the repair."""
        rec = self._open_incidents.pop((machine, incident), None)
        if rec is None:
            return  # UP without a recorded DOWN (trace started mid-outage)
        rec["up_at"] = t
        rec["repair_slots"] = t - rec["down_at"]
        self.incident_log.append(rec)

    def record_cascade(self, depth: int) -> None:
        """Jobs evicted by one machine incident (preemption cascade)."""
        self.cascade_depths.append(int(depth))

    # ------------------------------------------------------------ slots
    def record_slot(
        self, t: int, utilization: Dict[str, float], active: int,
        queued: int, degraded: Tuple[int, ...] = (),
    ) -> None:
        st = self._stream
        if st is not None:
            st.slots += 1
            busy = active > 0
            if busy:
                st.busy_slots += 1
            for r in self.resources:
                v = utilization.get(r, 0.0)
                st.util_sum[r] += v
                if busy:
                    st.util_busy_sum[r] += v
        else:
            self.per_slot.append(
                {"t": t, "util": dict(utilization), "active": active,
                 "queued": queued}
            )
        for h in degraded:
            self._down_slots[h] = self._down_slots.get(h, 0) + 1

    @staticmethod
    def _quality_columns(reshapes: int, dl_jobs: int, dl_hits: int,
                         slo_jobs: int, slo_hits: int,
                         loss_sum: float, loss_n: int) -> Dict:
        """The elastic quality/SLO column block, shared by both summary
        paths so the exact and streaming schemas cannot drift. Attainment
        over zero SLO jobs is vacuously 1.0 (same convention as
        ``goodput_fraction`` with nothing trained)."""
        return {
            "reshapes": int(reshapes),
            "deadline_jobs": int(dl_jobs),
            "deadline_hits": int(dl_hits),
            "deadline_attainment": (dl_hits / dl_jobs if dl_jobs else 1.0),
            "slo_jobs": int(slo_jobs),
            "slo_hits": int(slo_hits),
            "slo_attainment": (slo_hits / slo_jobs if slo_jobs else 1.0),
            "final_loss_mean": (loss_sum / loss_n if loss_n else 0.0),
        }

    # ------------------------------------------------------------ report
    def jct_cdf(self) -> Tuple[List[float], List[float]]:
        """Empirical (JCT, P[JCT <= x]) over completed jobs (Fig. 12-13
        convention: censored jobs are excluded, not imputed). Streaming
        mode returns the CDF of the fixed-size reservoir sample."""
        if self._stream is not None:
            jcts = sorted(self._stream.jct_sample.sample)
        else:
            jcts = sorted(
                oc.jct for oc in self.outcomes.values() if oc.jct is not None
            )
        n = len(jcts)
        return [float(x) for x in jcts], [(i + 1) / n for i in range(n)]

    def summary(self) -> Dict:
        """Fold outcomes + per-slot series into one flat benchmark row
        (schema documented in docs/BENCHMARKS.md)."""
        if self._stream is not None:
            return self._summary_streaming()
        ocs = list(self.outcomes.values())
        offered = len(ocs)
        completed = [oc for oc in ocs if oc.completed_at is not None]
        departed = [oc for oc in ocs if oc.departed_at is not None]
        rejected = [oc for oc in ocs if oc.admitted is False]
        served = [oc for oc in ocs if oc.first_service is not None]
        jcts = [float(oc.jct) for oc in completed]
        delays = [float(oc.queue_delay) for oc in served]
        util_all: Dict[str, List[float]] = {r: [] for r in self.resources}
        util_busy: Dict[str, List[float]] = {r: [] for r in self.resources}
        for row in self.per_slot:
            for r in self.resources:
                v = row["util"].get(r, 0.0)
                util_all[r].append(v)
                if row["active"] > 0:
                    util_busy[r].append(v)
        mean = lambda xs: float(np.mean(xs)) if xs else 0.0
        # "admitted": explicit admission (arrival-driven policies) or ever
        # served (slot-driven policies have no admission control)
        admitted = [
            oc for oc in ocs
            if oc.admitted is True
            or (oc.admitted is None and oc.first_service is not None)
        ]
        # goodput vs wasted work: samples trained by jobs that completed
        # vs samples sunk into jobs that never did (evicted, departed,
        # censored) — the fault model's primary cost signal
        goodput = float(sum(oc.samples_trained for oc in completed))
        wasted = float(sum(oc.samples_trained for oc in ocs
                           if oc.completed_at is None))
        trained = goodput + wasted
        slots = len(self.per_slot)
        repairs = [rec["repair_slots"] for rec in self.incident_log]
        if self.num_machines > 0 and slots > 0:
            availability = 1.0 - (
                sum(self._down_slots.values())
                / float(self.num_machines * slots)
            )
        else:
            availability = 1.0
        return {
            "jobs_offered": offered,
            "jobs_admitted": len(admitted),
            "jobs_completed": len(completed),
            "jobs_rejected": len(rejected),
            "jobs_departed": len(departed),
            "jobs_evicted": sum(1 for oc in ocs if oc.evicted_at is not None),
            "preemptions": sum(oc.preemptions for oc in ocs),
            "admission_rate": len(admitted) / offered if offered else 0.0,
            "completion_rate": len(completed) / offered if offered else 0.0,
            "jct_p50": _pct(jcts, 50), "jct_p95": _pct(jcts, 95),
            "jct_mean": mean(jcts),
            "queue_delay_p50": _pct(delays, 50),
            "queue_delay_p95": _pct(delays, 95),
            "total_utility": float(sum(oc.utility for oc in ocs)),
            "utilization_mean": {r: mean(v) for r, v in util_all.items()},
            "utilization_busy_mean": {r: mean(v) for r, v in util_busy.items()},
            "goodput_samples": goodput,
            "wasted_samples": wasted,
            "goodput_fraction": goodput / trained if trained > 0 else 1.0,
            **self._quality_columns(
                sum(oc.reshapes for oc in ocs),
                sum(1 for oc in ocs if oc.deadline is not None),
                sum(1 for oc in ocs if oc.deadline_hit),
                sum(1 for oc in ocs if oc.loss_slo is not None),
                sum(1 for oc in ocs if oc.slo_hit),
                float(sum(oc.final_loss for oc in ocs
                          if oc.final_loss is not None)),
                sum(1 for oc in ocs if oc.final_loss is not None),
            ),
            "machine_incidents": (len(self.incident_log)
                                  + len(self._open_incidents)),
            "mttr": mean([float(x) for x in repairs]),
            "machine_availability": float(availability),
            "preempt_cascade_max": max(self.cascade_depths, default=0),
            "preempt_cascade_mean": mean(
                [float(x) for x in self.cascade_depths]),
            "slots": len(self.per_slot),
            "events": dict(sorted(self.event_counts.items())),
        }

    def _summary_streaming(self) -> Dict:
        """The exact-mode summary schema from the running aggregates.
        Completed jobs live in ``_StreamState``; every still-censored job
        (in flight, rejected, departed, evicted) is still a ``JobOutcome``
        row, so the censoring columns stay exact — only the JCT and
        queue-delay percentiles are P-squared estimates."""
        st = self._stream
        ocs = list(self.outcomes.values())   # in flight: not yet closed
        offered = st.n_completed + st.n_closed + len(ocs)
        departed = st.closed_departed + sum(
            1 for oc in ocs if oc.departed_at is not None)
        rejected = st.closed_rejected + sum(
            1 for oc in ocs if oc.admitted is False)
        # every completed job was admitted (explicitly, or implicitly by
        # being served under a slot-driven policy)
        admitted = st.n_completed + st.closed_admitted + sum(
            1 for oc in ocs
            if oc.admitted is True
            or (oc.admitted is None and oc.first_service is not None)
        )
        wasted = st.closed_wasted + float(
            sum(oc.samples_trained for oc in ocs))
        trained = st.sum_goodput + wasted
        slots = st.slots
        repairs = [rec["repair_slots"] for rec in self.incident_log]
        mean = lambda xs: float(np.mean(xs)) if xs else 0.0
        if self.num_machines > 0 and slots > 0:
            availability = 1.0 - (
                sum(self._down_slots.values())
                / float(self.num_machines * slots)
            )
        else:
            availability = 1.0
        nc = st.n_completed
        return {
            "jobs_offered": offered,
            "jobs_admitted": admitted,
            "jobs_completed": nc,
            "jobs_rejected": rejected,
            "jobs_departed": departed,
            "jobs_evicted": st.closed_evicted + sum(
                1 for oc in ocs if oc.evicted_at is not None),
            "preemptions": (st.sum_preempt + st.closed_preempt
                            + sum(oc.preemptions for oc in ocs)),
            "admission_rate": admitted / offered if offered else 0.0,
            "completion_rate": nc / offered if offered else 0.0,
            "jct_p50": st.jct_p50.value(), "jct_p95": st.jct_p95.value(),
            "jct_mean": st.sum_jct / nc if nc else 0.0,
            "queue_delay_p50": st.delay_p50.value(),
            "queue_delay_p95": st.delay_p95.value(),
            "total_utility": st.sum_utility + st.closed_utility + float(
                sum(oc.utility for oc in ocs)),
            "utilization_mean": {
                r: (st.util_sum[r] / slots if slots else 0.0)
                for r in self.resources
            },
            "utilization_busy_mean": {
                r: (st.util_busy_sum[r] / st.busy_slots
                    if st.busy_slots else 0.0)
                for r in self.resources
            },
            "goodput_samples": st.sum_goodput,
            "wasted_samples": wasted,
            "goodput_fraction": (st.sum_goodput / trained
                                 if trained > 0 else 1.0),
            **self._quality_columns(
                st.reshapes + sum(oc.reshapes for oc in ocs),
                st.deadline_jobs + sum(
                    1 for oc in ocs if oc.deadline is not None),
                st.deadline_hits + sum(1 for oc in ocs if oc.deadline_hit),
                st.slo_jobs + sum(
                    1 for oc in ocs if oc.loss_slo is not None),
                st.slo_hits + sum(1 for oc in ocs if oc.slo_hit),
                st.final_loss_sum + float(sum(
                    oc.final_loss for oc in ocs
                    if oc.final_loss is not None)),
                st.final_loss_n + sum(
                    1 for oc in ocs if oc.final_loss is not None),
            ),
            "machine_incidents": (len(self.incident_log)
                                  + len(self._open_incidents)),
            "mttr": mean([float(x) for x in repairs]),
            "machine_availability": float(availability),
            "preempt_cascade_max": max(self.cascade_depths, default=0),
            "preempt_cascade_mean": mean(
                [float(x) for x in self.cascade_depths]),
            "slots": slots,
            "events": dict(sorted(self.event_counts.items())),
        }

    def to_json(self, path: str, extra: Optional[Dict] = None) -> None:
        jcts, cdf = self.jct_cdf()
        doc = {**(extra or {}), "summary": self.summary(),
               "jct_cdf": {"jct": jcts, "cdf": cdf}}
        with open(path, "w") as f:
            json.dump(doc, f, indent=2)
