"""Baseline schedulers from the paper's §5 evaluation.

* FIFO  — Hadoop/Spark-style: arrival order, fixed worker count per job,
          round-robin first-fit placement, holds resources until done.
* DRF   — dominant-resource fairness (YARN/Mesos): every slot, repeatedly
          grant one worker-bundle to the active job with the smallest
          dominant share.
* Dorm  — utilization-maximizing with fairness + adjustment-overhead cap
          (greedy realization of the published MILP's behavior).
* OASiS — Bao et al. [6]: the same primal-dual machinery as PD-ORS but
          workers and PSs live on two strictly separated machine halves
          (implemented via machine-type pseudo-resources, so no co-location
          — and hence no internal-rate branch — is ever feasible).

All slot-simulators account trained samples with the same Eq. (1)/Fact 1
throughput model that PD-ORS uses, so comparisons are apples-to-apples.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .cluster import Cluster, Machine, make_cluster
from .job import Allocation, JobSpec
from .pdors import PDORSResult, AdmissionRecord, run_pdors
from .subproblem import SubproblemConfig


@dataclass
class SimOutcome:
    utilities: Dict[int, float]
    completions: Dict[int, int]          # job_id -> completion slot (or horizon)
    total_utility: float

    def training_times(self, jobs: List[JobSpec], horizon: int) -> List[float]:
        out = []
        for j in jobs:
            c = self.completions.get(j.job_id)
            out.append(float(c - j.arrival) if c is not None else float(horizon))
        return out


def place_round_robin_free(
    free: Dict[tuple, float],
    H: int,
    job: JobSpec,
    n_workers: int,
    n_ps: int,
    rng: np.random.Generator,
) -> Optional[Allocation]:
    """First-fit round-robin placement over a mutable free-capacity map
    ``{(h, resource): amount}``; mutates ``free`` as it places and returns
    None (with ``free`` partially drained) if the request doesn't fit.

    Shared between the static ``_SlotSim`` baselines and the event-driven
    adapters in ``repro_torch.sim.policy``, so both harnesses place fifo/drf/dorm
    bundles with the exact same scan order and tolerances."""
    alloc = Allocation()

    def fit(h: int, demand: Dict[str, float]) -> bool:
        return all(free[(h, r)] >= d - 1e-9 for r, d in demand.items() if d)

    def take(h: int, demand: Dict[str, float]) -> None:
        for r, d in demand.items():
            if d:
                free[(h, r)] -= d

    h = int(rng.integers(0, H))
    for kind, count in (("w", n_workers), ("s", n_ps)):
        demand = job.worker_demand if kind == "w" else job.ps_demand
        placed = 0
        scans = 0
        while placed < count and scans < H * count + H:
            if fit(h, demand):
                take(h, demand)
                d = alloc.workers if kind == "w" else alloc.ps
                d[h] = d.get(h, 0) + 1
                placed += 1
            else:
                scans += 1
            h = (h + 1) % H
        if placed < count:
            return None
    return alloc


def drf_grant_loop(
    actives: List[JobSpec],
    total: Dict[str, float],
    place_fn,
) -> Dict[int, Allocation]:
    """The DRF bundle-granting loop, shared verbatim between the static
    ``DRFScheduler`` and the event-driven ``repro_torch.sim.policy.DRFPolicy``.

    Repeatedly grants one worker-bundle (round(gamma) workers + 1 PS) to
    the active job with the smallest dominant share until nothing fits.
    ``place_fn(job, n_workers, n_ps) -> Optional[Allocation]`` must place
    AND update its accounting substrate (ledger commit / free-map drain) on
    success, so successive placements see each other. Returns the merged
    per-job allocations."""
    allocs = {j.job_id: Allocation() for j in actives}
    used: Dict[int, Dict[str, float]] = {}
    granted = True
    while granted:
        granted = False

        def dom(j: JobSpec) -> float:
            u = used.get(j.job_id, {})
            return max(
                (u.get(r, 0.0) / total[r]) for r in total if total[r] > 0
            ) if u else 0.0

        for j in sorted(actives, key=dom):
            a = allocs[j.job_id]
            if a.total_workers() >= j.batch_size:
                continue
            nw = max(1, int(round(j.gamma)))
            nw = min(nw, j.batch_size - a.total_workers())
            add = place_fn(j, nw, 1)
            if add is None:
                continue
            for h, w in add.workers.items():
                a.workers[h] = a.workers.get(h, 0) + w
            for h, s in add.ps.items():
                a.ps[h] = a.ps.get(h, 0) + s
            u = used.setdefault(j.job_id, {})
            for r in total:
                u[r] = u.get(r, 0.0) + j.worker_demand.get(r, 0.0) * nw \
                    + j.ps_demand.get(r, 0.0)
            granted = True
            break
    return allocs


def dorm_grant_loop(
    actives: List[JobSpec],
    progress: Dict[int, float],
    held_ids,
    adjust_cap: float,
    place_fn,
) -> List[Tuple[JobSpec, Allocation]]:
    """Dorm's placement pass, shared between the static ``DormScheduler``
    and ``repro_torch.sim.policy.DormPolicy``: least-progressed waiting jobs
    first, utilization-maximizing worker-count ladder, at most
    ``max(1, adjust_cap * len(actives))`` new placements per slot.
    ``place_fn`` has the same commit-on-success contract as in
    ``drf_grant_loop``. Returns the (job, allocation) pairs newly placed."""
    budget = max(1, int(adjust_cap * len(actives)))
    placed: List[Tuple[JobSpec, Allocation]] = []

    def frac_done(j: JobSpec) -> float:
        return progress.get(j.job_id, 0.0) / max(j.total_workload(), 1.0)

    for j in sorted(actives, key=frac_done):
        if len(placed) >= budget:
            break
        if j.job_id in held_ids:
            continue
        for nw in (j.batch_size, j.batch_size // 2, 8, 4, 2, 1):
            nw = int(max(1, min(nw, j.batch_size)))
            ns = max(1, int(math.ceil(nw / j.gamma)))
            alloc = place_fn(j, nw, ns)
            if alloc is not None:
                placed.append((j, alloc))
                break
    return placed


class _SlotSim:
    """Common slot-by-slot execution: subclasses decide allocations."""

    def __init__(self, jobs: List[JobSpec], cluster: Cluster, seed: int = 0):
        self.jobs = sorted(jobs, key=lambda j: (j.arrival, j.job_id))
        self.cluster = cluster
        self.rng = np.random.default_rng(seed)
        self.progress: Dict[int, float] = {j.job_id: 0.0 for j in jobs}
        self.done: Dict[int, int] = {}
        self.current: Dict[int, Allocation] = {}

    def active(self, t: int) -> List[JobSpec]:
        return [
            j for j in self.jobs
            if j.arrival <= t and j.job_id not in self.done
        ]

    def run(self) -> SimOutcome:
        T = self.cluster.horizon
        for t in range(T):
            self.step(t)
            # account training progress for this slot
            for j in self.active(t):
                alloc = self.current.get(j.job_id)
                if alloc is None or alloc.empty():
                    continue
                self.progress[j.job_id] += alloc.samples_trained(j)
                if self.progress[j.job_id] >= j.total_workload() - 1e-6:
                    self.done[j.job_id] = t
                    self.release_job(t, j)
            self.end_slot(t)
        utilities = {}
        for j in self.jobs:
            if j.job_id in self.done:
                utilities[j.job_id] = j.utility(self.done[j.job_id] - j.arrival)
            else:
                utilities[j.job_id] = 0.0
        return SimOutcome(
            utilities=utilities,
            completions=dict(self.done),
            total_utility=sum(utilities.values()),
        )

    # -- hooks ---------------------------------------------------------
    def step(self, t: int) -> None:
        raise NotImplementedError

    def release_job(self, t: int, job: JobSpec) -> None:
        alloc = self.current.pop(job.job_id, None)
        if alloc is not None:
            self.cluster.release(t, job, alloc)

    def end_slot(self, t: int) -> None:
        """Carry allocations to the next slot's ledger."""
        if t + 1 >= self.cluster.horizon:
            return
        for jid, alloc in self.current.items():
            job = next(j for j in self.jobs if j.job_id == jid)
            self.cluster.commit(t + 1, job, alloc)

    # -- placement helper ----------------------------------------------
    def place_round_robin(
        self, t: int, job: JobSpec, n_workers: int, n_ps: int
    ) -> Optional[Allocation]:
        """First-fit round-robin over machines; None if it doesn't fit."""
        H = self.cluster.num_machines
        free = {
            (h, r): self.cluster.free(t, h, r)
            for h in range(H) for r in self.cluster.resources
        }
        return place_round_robin_free(free, H, job, n_workers, n_ps, self.rng)


class FIFOScheduler(_SlotSim):
    """Fixed worker count in [1, 30] per job (paper §5 baseline 1)."""

    def __init__(self, jobs, cluster, seed: int = 0, max_workers: int = 30):
        super().__init__(jobs, cluster, seed)
        self.fixed = {
            j.job_id: int(min(j.batch_size, self.rng.integers(1, max_workers + 1)))
            for j in jobs
        }

    def step(self, t: int) -> None:
        for j in self.active(t):  # arrival order
            if j.job_id in self.current:
                continue
            nw = self.fixed[j.job_id]
            ns = max(1, int(math.ceil(nw / j.gamma)))
            alloc = self.place_round_robin(t, j, nw, ns)
            if alloc is not None:
                self.current[j.job_id] = alloc
                self.cluster.commit(t, j, alloc)
            else:
                break  # strict FIFO: later jobs wait behind the head


class DRFScheduler(_SlotSim):
    """Dominant-resource fairness, re-computed every slot (the grant loop
    itself lives in ``drf_grant_loop``, shared with the event-driven
    adapter)."""

    def step(self, t: int) -> None:
        # fresh allocation each slot
        for j in list(self.active(t)):
            if j.job_id in self.current:
                self.release_job(t, j)
        total = {
            r: sum(self.cluster.capacity(h, r) for h in range(self.cluster.num_machines))
            for r in self.cluster.resources
        }
        actives = self.active(t)
        if not actives:
            return

        def place_and_commit(j: JobSpec, nw: int, ns: int):
            add = self.place_round_robin(t, j, nw, ns)
            if add is not None:
                self.cluster.commit(t, j, add)
            return add

        allocs = drf_grant_loop(actives, total, place_and_commit)
        for j in actives:
            if not allocs[j.job_id].empty():
                self.current[j.job_id] = allocs[j.job_id]

    def end_slot(self, t: int) -> None:
        # DRF reallocates every slot: allocations do not carry over
        # (slot-t ledger entries are in the past; just drop the handles)
        self.current.clear()


class DormScheduler(_SlotSim):
    """Utilization-maximizing greedy with fairness + adjustment cap (the
    placement pass lives in ``dorm_grant_loop``, shared with the
    event-driven adapter)."""

    def __init__(self, jobs, cluster, seed: int = 0, adjust_cap: float = 0.5):
        super().__init__(jobs, cluster, seed)
        self.adjust_cap = adjust_cap  # fraction of jobs adjustable per slot

    def step(self, t: int) -> None:
        actives = self.active(t)
        if not actives:
            return

        def place_and_commit(j: JobSpec, nw: int, ns: int):
            alloc = self.place_round_robin(t, j, nw, ns)
            if alloc is not None:
                self.cluster.commit(t, j, alloc)
            return alloc

        for j, alloc in dorm_grant_loop(
            actives, self.progress, set(self.current), self.adjust_cap,
            place_and_commit,
        ):
            self.current[j.job_id] = alloc


# ----------------------------------------------------------------------
def run_oasis(
    jobs: List[JobSpec],
    cluster_template: Cluster,
    cfg: Optional[SubproblemConfig] = None,
    quanta: int = 32,
    seed: int = 0,
) -> PDORSResult:
    """OASiS [6]: PD-ORS machinery on a worker/PS-separated cluster.

    The first half of the machines may host only workers, the second half
    only PSs — enforced with pseudo-resources, which also removes the
    internal (co-located) branch exactly as in [6].
    """
    H = cluster_template.num_machines
    machines = []
    for h, m in enumerate(cluster_template.machines):
        cap = dict(m.capacity)
        if h < H // 2:
            cap["wslot"] = 1e9
            cap["pslot"] = 0.0
        else:
            cap["wslot"] = 0.0
            cap["pslot"] = 1e9
        machines.append(Machine(h, cap))
    # the template's backend: its device, not the default CUDA one
    cluster = Cluster(machines=machines, horizon=cluster_template.horizon,
                      backend=cluster_template.backend)
    jobs2 = []
    for j in jobs:
        wd = dict(j.worker_demand)
        wd["wslot"] = 1.0
        pd = dict(j.ps_demand)
        pd["pslot"] = 1.0
        jobs2.append(
            JobSpec(
                job_id=j.job_id, arrival=j.arrival, epochs=j.epochs,
                num_samples=j.num_samples, batch_size=j.batch_size, tau=j.tau,
                grad_size=j.grad_size, gamma=j.gamma,
                bw_internal=j.bw_internal, bw_external=j.bw_external,
                worker_demand=wd, ps_demand=pd, utility=j.utility, arch=j.arch,
            )
        )
    return run_pdors(jobs2, cluster, cfg=cfg, quanta=quanta, seed=seed)


def run_baseline(
    name: str,
    jobs: List[JobSpec],
    cluster: Cluster,
    seed: int = 0,
) -> SimOutcome:
    sims = {"fifo": FIFOScheduler, "drf": DRFScheduler, "dorm": DormScheduler}
    sim = sims[name](jobs, cluster, seed=seed)
    return sim.run()
