"""Algorithm 2: determine the best schedule pi_i^* for an arriving job.

Enumerates candidate completion times t_tilde in [a_i, T-1], evaluates
payoff lambda' = u_i(t_tilde - a_i) - Theta(t_tilde, V_i) via the workload
DP (Algorithm 3), and keeps the maximizer.

Because utility is non-increasing in t_tilde, the forward DP prefix table is
computed once up to T-1 and each t_tilde reads row t_tilde — one DP pass for
all of Algorithm 2 (see dp.py docstring).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from .cluster import Cluster
from .dp import WorkloadDP
from .job import Allocation, JobSpec
from .pricing import PriceTable
from .subproblem import SubproblemConfig, ThetaResult


@dataclass
class Schedule:
    """pi_i: slot -> Allocation, with bookkeeping."""

    job: JobSpec
    slots: Dict[int, Allocation]
    cost: float
    payoff: float                 # lambda_i
    completion: int               # t_tilde (last active slot)
    modes: Dict[int, str] = field(default_factory=dict)

    def samples(self) -> float:
        return sum(a.samples_trained(self.job) for a in self.slots.values())


def find_best_schedule(
    job: JobSpec,
    cluster: Cluster,
    prices: PriceTable,
    horizon: int,
    cfg: Optional[SubproblemConfig] = None,
    quanta: int = 32,
    rng: Optional[np.random.Generator] = None,
    plan=None,
) -> Optional[Schedule]:
    """Algorithm 2 main loop.

    ``plan`` optionally injects a pre-built ``core.solve_plan.SolvePlan``
    whose LP batch was stacked across a same-slot job batch (the batched
    offer path); the DP verifies freshness/coverage and falls back to
    building its own plan if it does not apply."""
    if job.arrival >= horizon:
        return None
    dp = WorkloadDP(job, cluster, prices, cfg=cfg, quanta=quanta, rng=rng,
                    plan=plan)
    C = dp.solve_prefix(horizon - 1)

    best_payoff = 0.0
    best_t = -1
    a = job.arrival
    # column of full-workload completion costs, one row per candidate t_tilde
    costs = np.asarray(C)[1:, dp.quanta]
    for t_tilde in range(a, horizon):
        cost = costs[t_tilde - a]
        if cost == float("inf"):
            continue
        payoff = job.utility(t_tilde - a) - cost
        if payoff > best_payoff + 1e-12:
            best_payoff = payoff
            best_t = t_tilde
    if best_t < 0:
        return None

    res = dp.reconstruct(best_t, C)
    if res is None:
        return None
    slots = {t: th.alloc for t, th in res.slots.items()}
    modes = {t: th.mode for t, th in res.slots.items()}
    completion = max(slots) if slots else best_t
    # actual utility can only improve if the last slots ended up idle
    payoff = job.utility(completion - a) - res.cost
    return Schedule(
        job=job, slots=slots, cost=res.cost, payoff=payoff,
        completion=completion, modes=modes,
    )
