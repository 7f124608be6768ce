"""Theoretical guarantees (Theorems 3-6) computed for concrete instances.

The paper proves PD-ORS is (6 G_delta / delta) * max_r(1, ln U^r/L)
-competitive, achieved with probability
    (1 - (delta/3)^S)^(T K E)          (Thm 5, 0 < G_delta <= 1)
    (1 - (delta/3(HR+1))^S)^(T K E)    (Thm 6, G_delta > 1)

These functions evaluate the bounds for a given instance so experiments
can report empirical-vs-theoretical gaps (paper remark ii: the worst-case
bound is very conservative — our Fig. 10 ratios are ~1.0 against bounds
in the hundreds).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, List

from .cluster import Cluster
from .job import JobSpec
from .pricing import estimate_price_params
from .rounding import g_delta_cover, g_delta_packing


@dataclass
class CompetitiveBound:
    g_delta: float
    delta: float
    epsilon: float              # max_r(1, ln U^r/L)
    ratio: float                # 6 G_delta / delta * epsilon
    feasibility_prob: float     # probability the ratio holds (Thm 5/6)
    regime: str                 # "packing" (Thm 5) | "cover" (Thm 6)


def theorem5_bound(
    jobs: Iterable[JobSpec],
    cluster: Cluster,
    horizon: int,
    delta: float = 0.5,
    rounding_rounds: int = 50,
    favor: str = "packing",
) -> CompetitiveBound:
    """Evaluate the Theorem 5/6 competitive-ratio bound for an instance."""
    jobs = list(jobs)
    pp = estimate_price_params(jobs, cluster, horizon)
    eps = max(
        1.0, max(math.log(u / pp.L) for u in pp.U.values())
    )
    H = cluster.num_machines
    R = len(cluster.resources)

    # representative W1/W2 from the median job (instance-dependent constants)
    med = sorted(jobs, key=lambda j: j.total_workload())[len(jobs) // 2]
    W1 = med.total_workload() / horizon * med.time_per_sample(False)
    W2 = min(
        float(med.batch_size),
        min(
            cluster.capacity(0, r) / d
            for r in cluster.resources
            for d in (med.worker_demand.get(r, 0.0), med.ps_demand.get(r, 0.0))
            if d > 0
        ),
    )
    if favor == "packing":
        gd = g_delta_packing(delta, max(W2, 1e-6), num_packing_rows=R * H + 1)
        per_round_fail = delta / 3.0
        regime = "packing"
    else:
        gd = g_delta_cover(delta, max(W1, 1.0))
        per_round_fail = delta / (3.0 * (H * R + 1))
        regime = "cover"

    ratio = 6.0 * gd / delta * eps
    # probability over the T*K*E DP states (paper's exponent), using the
    # median job's K*E
    n_states = horizon * med.num_samples * med.epochs
    log_p = n_states * math.log1p(-(per_round_fail ** rounding_rounds))
    prob = math.exp(max(log_p, -745.0))
    return CompetitiveBound(
        g_delta=gd, delta=delta, epsilon=eps, ratio=ratio,
        feasibility_prob=prob, regime=regime,
    )
