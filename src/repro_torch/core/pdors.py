"""Algorithm 1: Primal-Dual Online Resource Scheduling (PD-ORS).

Upon each job arrival: find pi_i^* (Algorithm 2); admit iff payoff
lambda_i > 0; commit the allocation to the cluster ledger, which updates
rho_h^r[t] and therefore the prices p_h^r[t] = Q_h^r(rho_h^r[t]).

The scheduling core under ``offer()`` is fully vectorized (dense ledger,
cached price matrices, min-plus DP step, structure-aware cover/packing
LP solve with a vectorized-simplex fallback — see cluster.py /
pricing.py / dp.py / cover_packing.py / lp.py / subproblem.py); commits
bump the cluster's ledger version, which is what invalidates those
caches between admissions (the subset-template cache is
content-addressed and survives them — ``docs/SOLVER.md``). The JAX
package's ``repro.core._reference.run_pdors_reference`` is the frozen
pre-vectorization implementation; the port's tests hold this module's
decisions to it and to the JAX package's numpy backend.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..obs import trace as _trace
from ..obs.pd_gap import PDGapTracker
from .cluster import Cluster
from .job import JobSpec
from .pricing import PriceParams, PriceTable, estimate_price_params
from .schedule import Schedule, find_best_schedule
from .solve_plan import SolvePlan, solve_plans
from .subproblem import SubproblemConfig


@dataclass
class AdmissionRecord:
    job: JobSpec
    admitted: bool
    schedule: Optional[Schedule]
    utility: float


@dataclass
class PDORSResult:
    records: List[AdmissionRecord]

    @property
    def total_utility(self) -> float:
        return sum(r.utility for r in self.records)

    @property
    def admitted(self) -> List[AdmissionRecord]:
        return [r for r in self.records if r.admitted]

    def training_times(self, horizon: int) -> List[float]:
        """Per-job actual training time; unfinished/rejected count as T
        (paper Fig. 9 convention)."""
        out = []
        for r in self.records:
            if r.admitted and r.schedule is not None:
                out.append(float(r.schedule.completion - r.job.arrival))
            else:
                out.append(float(horizon))
        return out


class PDORS:
    """Online scheduler object; feed jobs in arrival order via offer()."""

    def __init__(
        self,
        cluster: Cluster,
        price_params: PriceParams,
        cfg: Optional[SubproblemConfig] = None,
        quanta: int = 32,
        seed: int = 0,
    ):
        self.cluster = cluster
        self.prices = PriceTable(price_params, cluster)
        self.cfg = cfg or SubproblemConfig()
        self.quanta = quanta
        self.rng = np.random.default_rng(seed)
        self.records: List[AdmissionRecord] = []
        # weak-duality telemetry (obs.pd_gap): a few float adds per offer,
        # rng-free — decisions never read it
        self.pd_gap = PDGapTracker(self.prices)

    def offer(self, job: JobSpec, plan: Optional[SolvePlan] = None
              ) -> AdmissionRecord:
        with _trace.span("offer", job=int(job.job_id)) as osp:
            with _trace.span("offer.schedule"):
                sched = find_best_schedule(
                    job, self.cluster, self.prices, self.cluster.horizon,
                    cfg=self.cfg, quanta=self.quanta, rng=self.rng, plan=plan,
                )
            if sched is not None and sched.payoff > 0:
                # Step 3: admit; commit rho updates (prices react via Q_h^r)
                with _trace.span("offer.commit", slots=len(sched.slots)):
                    for t, alloc in sched.slots.items():
                        self.cluster.commit(t, job, alloc)
                rec = AdmissionRecord(job, True, sched, job.utility(sched.completion - job.arrival))
            else:
                rec = AdmissionRecord(job, False, None, 0.0)
            osp.set(admitted=rec.admitted)
        self.pd_gap.record_offer(
            rec.admitted, sched.payoff if sched is not None else 0.0,
            rec.utility)
        self.records.append(rec)
        return rec

    def _build_plan(self, job: JobSpec) -> Optional[SolvePlan]:
        if not self.cfg.use_plan or job.arrival >= self.cluster.horizon:
            return None
        return SolvePlan(
            job, self.cluster, self.prices, self.cfg,
            job.arrival, self.cluster.horizon - 1, quanta=self.quanta,
        )

    def offer_batch(self, jobs: List[JobSpec]) -> List[AdmissionRecord]:
        """Offer a same-slot arrival batch: one vectorized price-tensor
        prewarm amortizes the per-slot price builds across every job in the
        batch, one ``SolvePlan`` per job collects its (t, v) candidates
        (plan building is rng-free), and EVERY job's external LPs are
        stacked into a single structure-aware solve (``solve_plans`` ->
        ``cover_packing.solve_lp_batch``: exact Bland replay with
        stacked-simplex fallback, see ``docs/SOLVER.md``) — jobs in one
        batch share the ledger until an admission reprices.
        After an admission the remaining jobs' plans are stale (the
        ledger version moved); each is rebuilt per job inside its own
        offer's DP, without re-stacking across jobs.

        The cross-job stack is built ONCE per batch: after an admission
        invalidates the remaining pre-built plans, the rest of the batch
        falls back to per-job plans (each offer builds its own inside
        the DP) rather than re-stacking — re-stacking after every
        admission would do O(B^2) plan builds on an admit-heavy batch
        for a marginal LP-amortization gain, so each job's plan is built
        at most twice.

        ``prewarm`` fills the same per-slot cache ``price_matrix`` reads
        with bit-identical values, plan resolution consumes the shared
        rng stream in exactly the per-offer order, and stale plans are
        never consumed (``SolvePlan.fresh`` — the DP replaces them) — so
        decisions match one-at-a-time ``offer`` calls exactly; the
        event-driven simulator (``repro_torch.sim``) uses the same pattern
        per arrival batch."""
        out: List[AdmissionRecord] = []
        with _trace.span("offer.batch", jobs=len(jobs)):
            self.prices.prewarm()
            plans = {}
            if self.cfg.use_plan:
                plans = {j.job_id: self._build_plan(j) for j in jobs}
                solve_plans([p for p in plans.values() if p is not None])
            for job in jobs:
                rec = self.offer(job, plan=plans.get(job.job_id))
                out.append(rec)
                if rec.admitted:
                    self.prices.prewarm()
        return out

    def run(self, jobs: List[JobSpec]) -> PDORSResult:
        ordered = sorted(jobs, key=lambda j: (j.arrival, j.job_id))
        batch: List[JobSpec] = []
        for job in ordered:
            if batch and job.arrival != batch[0].arrival:
                self.offer_batch(batch)
                batch = []
            batch.append(job)
        if batch:
            self.offer_batch(batch)
        return PDORSResult(records=self.records)


def run_pdors(
    jobs: List[JobSpec],
    cluster: Cluster,
    cfg: Optional[SubproblemConfig] = None,
    quanta: int = 32,
    seed: int = 0,
    price_params: Optional[PriceParams] = None,
) -> PDORSResult:
    params = price_params or estimate_price_params(jobs, cluster, cluster.horizon)
    return PDORS(cluster, params, cfg=cfg, quanta=quanta, seed=seed).run(jobs)
