"""Brute-force offline optimum for tiny instances (paper Fig. 10).

Enumerates, per job, its full feasible-schedule set Pi_i (allocations
restricted to: per slot, either idle, all-co-located on one machine, or an
even split across machines — which covers the optima of the tiny instances
used here), then exactly solves the schedule-selection ILP (R-DMLRS) by
depth-first search with capacity checking and utility-bound pruning.

Use only with I <= ~6, T <= ~6, H <= ~3, F <= ~8.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .cluster import Cluster
from .job import Allocation, JobSpec


@dataclass
class OfflineResult:
    total_utility: float
    chosen: Dict[int, Optional[dict]]  # job_id -> {slot: Allocation} or None


def _slot_options(job: JobSpec, cluster: Cluster) -> List[Tuple[Allocation, float]]:
    """Candidate per-slot allocations with their sample throughput.

    For H <= 2 this enumerates EVERY integer split of workers and PSs
    across machines, so the option set is exhaustive; ordered by
    throughput (desc) so the DFS finds earliest-completing (highest
    utility) schedules first.  The trailing idle option lets schedules
    stall a slot."""
    opts: List[Tuple[Allocation, float]] = []
    H = cluster.num_machines
    F = job.batch_size

    def add(workers: Dict[int, int], ps: Dict[int, int]) -> None:
        a = Allocation(workers={h: w for h, w in workers.items() if w > 0},
                       ps={h: s for h, s in ps.items() if s > 0})
        if a.total_workers() == 0:
            return
        opts.append((a, a.samples_trained(job)))

    for w in range(1, F + 1):
        s = max(1, int(math.ceil(w / job.gamma)))
        if H == 1:
            add({0: w}, {0: s})
            continue
        # exhaustive splits over the first two machines
        for w0 in range(0, w + 1):
            for s0 in range(0, s + 1):
                add({0: w0, 1: w - w0}, {0: s0, 1: s - s0})
    # dedupe identical allocations
    seen = set()
    uniq = []
    for a, r in opts:
        key = (tuple(sorted(a.workers.items())), tuple(sorted(a.ps.items())))
        if key not in seen:
            seen.add(key)
            uniq.append((a, r))
    uniq.sort(key=lambda ar: -ar[1])
    uniq.append((Allocation(), 0.0))
    return uniq


def _feasible_schedules(
    job: JobSpec, cluster: Cluster, horizon: int, cap: int = 4000
) -> List[Dict[int, Allocation]]:
    """All schedules (slot -> alloc) reaching V_i, DFS with rate pruning."""
    V = job.total_workload()
    opts = _slot_options(job, cluster)
    max_rate = max(rate for _, rate in opts)
    if max_rate <= 0:
        return []
    out: List[Dict[int, Allocation]] = []

    def dfs(t: int, remaining: float, current: Dict[int, Allocation]) -> None:
        if len(out) >= cap:
            return
        if remaining <= 1e-9:
            out.append(dict(current))
            return
        if t >= horizon:
            return
        if remaining > max_rate * (horizon - t) + 1e-9:
            return  # cannot finish even at max rate
        for alloc, rate in opts:
            if rate <= 0 and remaining > max_rate * (horizon - t - 1) + 1e-9:
                continue  # idling now makes finish impossible
            if not alloc.empty():
                current[t] = alloc
            dfs(t + 1, remaining - rate, current)
            current.pop(t, None)

    dfs(job.arrival, V, {})
    # dedupe identical completion/footprint schedules: keep all (small caps)
    return out


def _footprint(job: JobSpec, sched: Dict[int, Allocation]) -> float:
    """Total resource-slots consumed (pruning key)."""
    tot = 0.0
    for alloc in sched.values():
        w = alloc.total_workers()
        s = alloc.total_ps()
        tot += sum(job.worker_demand.values()) * w + sum(job.ps_demand.values()) * s
    return tot


def offline_optimum(jobs: List[JobSpec], cluster: Cluster,
                    per_completion_keep: int = 8,
                    node_budget: int = 300_000) -> OfflineResult:
    """Near-exhaustive offline search.

    Utility depends only on a schedule's completion time, so per job we
    keep the ``per_completion_keep`` lightest-footprint schedules for each
    completion slot and DFS over the cross product with utility-bound
    pruning and a node budget.  The result is a LOWER bound on true OPT
    (combine with max(., online solution) for a valid ratio >= 1)."""
    horizon = cluster.horizon
    sched_sets: List[List[Tuple[Dict[int, Allocation], float]]] = []
    for j in jobs:
        by_comp: Dict[int, List[Tuple[Dict[int, Allocation], float]]] = {}
        for s in _feasible_schedules(j, cluster, horizon):
            comp = max(s) if s else j.arrival
            by_comp.setdefault(comp, []).append((s, _footprint(j, s)))
        cands = []
        for comp, lst in by_comp.items():
            lst.sort(key=lambda sf: sf[1])
            u = j.utility(comp - j.arrival)
            cands.extend((s, u) for s, _ in lst[:per_completion_keep])
        cands.sort(key=lambda cu: -cu[1])
        sched_sets.append(cands[:200])

    resources = cluster.resources
    H = cluster.num_machines
    used: Dict[Tuple[int, int, str], float] = {}

    def fits(job: JobSpec, sched: Dict[int, Allocation]) -> bool:
        for t, alloc in sched.items():
            for h in set(alloc.workers) | set(alloc.ps):
                w = alloc.workers.get(h, 0)
                s = alloc.ps.get(h, 0)
                for r in resources:
                    need = (
                        job.worker_demand.get(r, 0.0) * w
                        + job.ps_demand.get(r, 0.0) * s
                    )
                    if used.get((t, h, r), 0.0) + need > cluster.capacity(h, r) + 1e-9:
                        return False
        return True

    def apply(job: JobSpec, sched: Dict[int, Allocation], sign: float) -> None:
        for t, alloc in sched.items():
            for h in set(alloc.workers) | set(alloc.ps):
                w = alloc.workers.get(h, 0)
                s = alloc.ps.get(h, 0)
                for r in resources:
                    need = (
                        job.worker_demand.get(r, 0.0) * w
                        + job.ps_demand.get(r, 0.0) * s
                    )
                    if need:
                        used[(t, h, r)] = used.get((t, h, r), 0.0) + sign * need

    best = {"val": 0.0, "choice": {j.job_id: None for j in jobs}}
    suffix_max = [0.0] * (len(jobs) + 1)
    for i in range(len(jobs) - 1, -1, -1):
        best_u = max((u for _, u in sched_sets[i]), default=0.0)
        suffix_max[i] = suffix_max[i + 1] + best_u

    choice: Dict[int, Optional[Dict[int, Allocation]]] = {}
    nodes = {"n": 0}

    def dfs(i: int, val: float) -> None:
        nodes["n"] += 1
        if nodes["n"] > node_budget:
            return
        if val + suffix_max[i] <= best["val"] + 1e-12:
            return
        if i == len(jobs):
            if val > best["val"]:
                best["val"] = val
                best["choice"] = dict(choice)
            return
        job = jobs[i]
        for sched, u in sched_sets[i]:
            if u <= 0:
                continue
            if fits(job, sched):
                apply(job, sched, +1.0)
                choice[job.job_id] = sched
                dfs(i + 1, val + u)
                choice.pop(job.job_id)
                apply(job, sched, -1.0)
        # reject branch
        choice[job.job_id] = None
        dfs(i + 1, val)
        choice.pop(job.job_id)

    dfs(0, 0.0)
    return OfflineResult(total_utility=best["val"], chosen=best["choice"])
