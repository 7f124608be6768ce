"""Frozen pre-vectorization PD-ORS core (verbatim from the seed commit).

This module is the *measurement baseline and parity oracle* for the
vectorized scheduling core: the complete pre-PR implementation -- dict-keyed
ledger, per-element price snapshots, scalar two-phase simplex, pure-Python
min-plus DP inner loop, unit-at-a-time repair -- concatenated into one
self-contained module. Nothing here runs on the hot path; it exists so

  * benchmarks/bench_scheduler.py can report an honest "pre-PR core"
    jobs/sec + latency column and a speedup ratio, and
  * tests can assert bit-identical admission records, schedules, and total
    utility between ``run_pdors`` and ``run_pdors_reference`` at fixed
    seeds (the golden pre/post-vectorization regression).

Do not optimize or "clean up" this file -- its value is being frozen.
Only mechanical edits were made: module docstrings/imports were hoisted
into this header; class/function names are kept (the module namespace
provides isolation). job/workload/rounding definitions are shared with the
live code, which has not changed their semantics.
"""
# flake8: noqa
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .job import Allocation, JobSpec, Resource

# ======================================================================
# pre-PR src/repro/core/rounding.py
# ======================================================================
def g_delta_packing(delta: float, W2: float, num_packing_rows: int) -> float:
    """Eq. (29): G_delta in (0,1], resource (packing) feasibility favored.

    W2 = min{b_i / B_ij : B_ij > 0}; r = num_packing_rows (paper: RH+1).
    """
    if W2 <= 0:
        return 1.0
    ln = math.log(3.0 * num_packing_rows / delta)
    k = 3.0 * ln / (2.0 * W2)
    # Eq. (29): G = 1 + k - sqrt(k^2 + 3 ln / W2)
    g = 1.0 + k - math.sqrt(k * k + 3.0 * ln / W2)
    return float(min(max(g, 1e-6), 1.0))


def g_delta_cover(delta: float, W1: float) -> float:
    """Eq. (30): G_delta > 1, workload (cover) feasibility favored.

    W1 = min{a_i / A_ij : A_ij > 0} (paper: V_i[t](tau + 2 g gamma/(b_e F))).
    """
    if W1 <= 0:
        return 1.0
    ln = math.log(3.0 / delta)
    k = ln / W1
    return float(1.0 + k + math.sqrt(k * k + 2.0 * ln / W1))


def approximation_ratio(g_delta: float, delta: float) -> float:
    """3 G_delta / delta (Lemmas 1-2)."""
    return 3.0 * g_delta / delta


@dataclass
class RoundingResult:
    x: np.ndarray                # integer candidate
    feasible: bool
    cover_violation: float       # max relative shortfall of Ax >= a
    packing_violation: float     # max relative excess of Bx <= b
    attempts: int


def randomized_round(
    x_frac: np.ndarray,
    g_delta: float,
    rng: np.random.Generator,
) -> np.ndarray:
    """Eqs. (27)-(28): scale by G_delta then round up w.p. frac part."""
    xp = np.maximum(x_frac, 0.0) * g_delta
    lo = np.floor(xp)
    frac = xp - lo
    up = rng.random(xp.shape) < frac
    return (lo + up).astype(np.int64)


def round_until_feasible(
    x_frac: np.ndarray,
    A: Optional[np.ndarray],
    a: Optional[np.ndarray],
    B: Optional[np.ndarray],
    b: Optional[np.ndarray],
    g_delta: float,
    rng: np.random.Generator,
    max_rounds: int = 50,
    cover_slack: float = 0.0,
) -> RoundingResult:
    """Algorithm 4 steps 10-11: retry rounding until both constraint
    families hold (or attempts exhausted — return the least-violating).

    cover_slack allows accepting a small relative cover shortfall; the paper
    (§5, Fig. 11 discussion) notes cover violations are tolerable in practice
    because epoch counts are over-estimated. Default 0 = strict.
    """
    n = x_frac.size
    S = max_rounds
    # all S candidates in one batch (Eqs. 27-28 vectorized)
    xp = np.maximum(x_frac, 0.0) * g_delta
    lo = np.floor(xp)
    frac = xp - lo
    X = (lo[None, :] + (rng.random((S, n)) < frac[None, :])).astype(np.int64)

    cov_v = np.zeros(S)
    if A is not None and a is not None and len(a):
        lhs = X @ A.T                                  # (S, m)
        rel = np.where(a[None, :] > 0, (a[None, :] - lhs) / np.maximum(a[None, :], 1e-12), 0.0)
        cov_v = rel.max(axis=1)
    pack_v = np.zeros(S)
    if B is not None and b is not None and len(b):
        lhs = X @ B.T                                  # (S, r)
        rel = np.where(
            b[None, :] > 0,
            (lhs - b[None, :]) / np.maximum(b[None, :], 1e-12),
            np.where(lhs > 0, np.inf, 0.0),
        )
        pack_v = rel.max(axis=1)
    cov_v = np.maximum(cov_v, 0.0)
    pack_v = np.maximum(pack_v, 0.0)
    feas = (cov_v <= cover_slack + 1e-9) & (pack_v <= 1e-9)
    if feas.any():
        i = int(np.argmax(feas))  # first feasible draw
        return RoundingResult(X[i], True, float(cov_v[i]), float(pack_v[i]), i + 1)
    # least-violating candidate (packing first, then cover)
    order = np.lexsort((cov_v, pack_v))
    i = int(order[0])
    return RoundingResult(X[i], False, float(cov_v[i]), float(pack_v[i]), S)


# ======================================================================
# pre-PR src/repro/core/cluster.py
# ======================================================================
@dataclass(frozen=True)
class Machine:
    machine_id: int
    capacity: Dict[Resource, float]  # C_h^r


@dataclass
class Cluster:
    machines: List[Machine]
    horizon: int  # T

    def __post_init__(self) -> None:
        self.resources: List[Resource] = sorted(
            {r for m in self.machines for r in m.capacity}
        )
        # rho_h^r[t]: allocated amount per (t, h, r)
        self._used: Dict[Tuple[int, int, Resource], float] = {}

    # ------------------------------------------------------------------
    @property
    def num_machines(self) -> int:
        return len(self.machines)

    def capacity(self, h: int, r: Resource) -> float:
        return self.machines[h].capacity.get(r, 0.0)

    def used(self, t: int, h: int, r: Resource) -> float:
        return self._used.get((t, h, r), 0.0)

    def free(self, t: int, h: int, r: Resource) -> float:
        return self.capacity(h, r) - self.used(t, h, r)

    def total_capacity(self) -> float:
        """sum_h sum_r C_h^r (used by mu in pricing, Eq. 14)."""
        return sum(sum(m.capacity.values()) for m in self.machines)

    # ------------------------------------------------------------------
    def fits(self, t: int, job: JobSpec, alloc: Allocation) -> bool:
        """Capacity check for one slot (Eq. 5)."""
        for h in set(alloc.workers) | set(alloc.ps):
            w = alloc.workers.get(h, 0)
            s = alloc.ps.get(h, 0)
            for r in self.resources:
                need = job.worker_demand.get(r, 0.0) * w + job.ps_demand.get(r, 0.0) * s
                if need > self.free(t, h, r) + 1e-9:
                    return False
        return True

    def commit(self, t: int, job: JobSpec, alloc: Allocation) -> None:
        """rho update of Algorithm 1 step 3."""
        for h in set(alloc.workers) | set(alloc.ps):
            w = alloc.workers.get(h, 0)
            s = alloc.ps.get(h, 0)
            for r in self.resources:
                need = job.worker_demand.get(r, 0.0) * w + job.ps_demand.get(r, 0.0) * s
                if need:
                    self._used[(t, h, r)] = self.used(t, h, r) + need

    def release(self, t: int, job: JobSpec, alloc: Allocation) -> None:
        for h in set(alloc.workers) | set(alloc.ps):
            w = alloc.workers.get(h, 0)
            s = alloc.ps.get(h, 0)
            for r in self.resources:
                need = job.worker_demand.get(r, 0.0) * w + job.ps_demand.get(r, 0.0) * s
                if need:
                    self._used[(t, h, r)] = self.used(t, h, r) - need

    def utilization(self, t: int) -> Dict[Resource, float]:
        out = {}
        for r in self.resources:
            cap = sum(self.capacity(h, r) for h in range(self.num_machines))
            use = sum(self.used(t, h, r) for h in range(self.num_machines))
            out[r] = use / cap if cap else 0.0
        return out


# ----------------------------------------------------------------------
def make_cluster(
    num_machines: int,
    horizon: int,
    preset: str = "ethernet",
    capacity_scale: float = 1.0,
) -> Cluster:
    if preset == "ethernet":
        # paper §5: capacity ≈ 18x a worker/PS demand (EC2 C5n.18xlarge-like)
        cap = {
            "gpu": 72.0 * capacity_scale,      # 18 x up-to-4 GPUs
            "cpu": 180.0 * capacity_scale,     # 18 x up-to-10 vCPU
            "mem": 576.0 * capacity_scale,     # 18 x up-to-32 GB
            "storage": 180.0 * capacity_scale, # 18 x up-to-10 GB
        }
    elif preset == "tpu":
        # a "machine" = one v5e pod slice of 16 chips (DESIGN.md §3)
        cap = {
            "chips": 16.0 * capacity_scale,
            "hbm": 16.0 * 16.0 * capacity_scale,   # GB
            "host_cpu": 224.0 * capacity_scale,
            "host_mem": 512.0 * capacity_scale,
        }
    else:
        raise ValueError(f"unknown preset {preset!r}")
    machines = [Machine(h, dict(cap)) for h in range(num_machines)]
    return Cluster(machines=machines, horizon=horizon)


# ======================================================================
# pre-PR src/repro/core/pricing.py
# ======================================================================
@dataclass
class PriceParams:
    U: Dict[Resource, float]   # U^r
    L: float
    mu: float

    def price(self, rho: float, cap: float, r: Resource) -> float:
        """Q_h^r(rho) — Eq. (12). A zero-capacity resource is priced at its
        ceiling U^r (the 'exhausted' price); the capacity rows in the LP /
        feasibility checks are what actually forbid placement there."""
        u = max(self.U.get(r, self.L), self.L * (1.0 + 1e-9))
        if cap <= 0:
            return u
        frac = min(max(rho / cap, 0.0), 1.0)
        return self.L * (u / self.L) ** frac


def estimate_price_params(
    jobs: Iterable[JobSpec], cluster: Cluster, horizon: int
) -> PriceParams:
    """Compute U^r, L, mu from a (historical or actual) job population.

    The paper notes U^r and L "can usually be estimated empirically based on
    historical data"; in the simulator we pass either the true job set (for
    reproducing the paper's plots) or a calibration sample.
    """
    jobs = list(jobs)
    if not jobs:
        raise ValueError("need at least one job to calibrate prices")

    resources = cluster.resources

    # ---- mu: the largest value satisfying the paper's bound for all i ----
    total_cap = cluster.total_capacity()
    inv_mu = min(
        j.max_resource_slots()
        * sum(j.worker_demand.get(r, 0.0) + j.ps_demand.get(r, 0.0) for r in resources)
        / (horizon * total_cap)
        for j in jobs
    )
    inv_mu = max(inv_mu, 1e-12)
    mu = 1.0 / inv_mu

    # ---- U^r (Eq. 13) ----
    U: Dict[Resource, float] = {}
    for r in resources:
        best = 0.0
        for j in jobs:
            denom = j.worker_demand.get(r, 0.0) + j.ps_demand.get(r, 0.0)
            if denom <= 0:
                continue
            best_latency = max(j.min_completion_slots(), 1)
            best = max(best, j.utility(best_latency) / denom)
        U[r] = best if best > 0 else 1.0

    # ---- L (Eq. 14) ----
    L = float("inf")
    for j in jobs:
        worst_u = j.utility(horizon - j.arrival)
        denom = j.max_resource_slots() * sum(
            j.worker_demand.get(r, 0.0) + j.ps_demand.get(r, 0.0) for r in resources
        )
        if denom <= 0:
            continue
        L = min(L, (1.0 / (2.0 * mu)) * worst_u / denom)
    if not math.isfinite(L) or L <= 0:
        # degenerate utilities (e.g. all-zero at horizon): fall back to a
        # tiny positive floor so Q stays well-defined.
        L = 1e-9
    # keep U^r >= L so that U/L >= 1
    for r in resources:
        U[r] = max(U[r], L * math.e)
    return PriceParams(U=U, L=L, mu=mu)


class PriceTable:
    """p_h^r[t] = Q_h^r(rho_h^r[t]) maintained over the cluster ledger."""

    def __init__(self, params: PriceParams, cluster: Cluster):
        self.params = params
        self.cluster = cluster

    def price(self, t: int, h: int, r: Resource) -> float:
        return self.params.price(
            self.cluster.used(t, h, r), self.cluster.capacity(h, r), r
        )

    def worker_price(self, t: int, h: int, job: JobSpec) -> float:
        """p_h^w[t] = sum_r p_h^r[t] alpha_i^r (paper, below Eq. 26)."""
        return sum(
            self.price(t, h, r) * a for r, a in job.worker_demand.items() if a
        )

    def ps_price(self, t: int, h: int, job: JobSpec) -> float:
        """p_h^s[t] = sum_r p_h^r[t] beta_i^r."""
        return sum(self.price(t, h, r) * b for r, b in job.ps_demand.items() if b)

    def colocated_price(self, t: int, h: int, job: JobSpec) -> float:
        """sum_r p_h^r (alpha^r gamma + beta^r): cost of gamma workers + 1 PS
        on machine h (Algorithm 4, internal case sort key)."""
        out = 0.0
        for r in self.cluster.resources:
            p = self.price(t, h, r)
            out += p * (
                job.worker_demand.get(r, 0.0) * job.gamma + job.ps_demand.get(r, 0.0)
            )
        return out

    def competitive_ratio_bound(self) -> float:
        """max_r(1, ln U^r/L) — the epsilon of Theorems 5-6."""
        return max(
            1.0,
            max(math.log(u / self.params.L) for u in self.params.U.values()),
        )


# ======================================================================
# pre-PR src/repro/core/lp.py
# ======================================================================
@dataclass
class LPResult:
    status: str           # "optimal" | "infeasible" | "unbounded"
    x: Optional[np.ndarray]
    objective: float


def _pivot(T: np.ndarray, basis: np.ndarray, row: int, col: int) -> None:
    T[row] /= T[row, col]
    for i in range(T.shape[0]):
        if i != row and abs(T[i, col]) > 1e-12:
            T[i] -= T[i, col] * T[row]
    basis[row] = col


def _simplex_core(T: np.ndarray, basis: np.ndarray, n_total: int,
                  max_iter: int = 20000) -> str:
    """Minimize the objective encoded in the last row of tableau T.

    Last row = reduced costs (objective row, negated-cost convention:
    row holds c_bar; optimal when all c_bar >= -eps). Last column = RHS.
    """
    m = T.shape[0] - 1
    for _ in range(max_iter):
        cbar = T[-1, :n_total]
        # Bland's rule: smallest index with negative reduced cost
        col = -1
        for j in range(n_total):
            if cbar[j] < -1e-9:
                col = j
                break
        if col < 0:
            return "optimal"
        # ratio test (Bland: smallest basis index tie-break)
        best_ratio, row = np.inf, -1
        for i in range(m):
            a = T[i, col]
            if a > 1e-10:
                ratio = T[i, -1] / a
                if ratio < best_ratio - 1e-12 or (
                    abs(ratio - best_ratio) <= 1e-12
                    and (row < 0 or basis[i] < basis[row])
                ):
                    best_ratio, row = ratio, i
        if row < 0:
            return "unbounded"
        _pivot(T, basis, row, col)
    return "maxiter"


def linprog(
    c: np.ndarray,
    A_ub: Optional[np.ndarray] = None,
    b_ub: Optional[np.ndarray] = None,
    A_eq: Optional[np.ndarray] = None,
    b_eq: Optional[np.ndarray] = None,
) -> LPResult:
    c = np.asarray(c, dtype=np.float64)
    n = c.size
    A_ub = np.zeros((0, n)) if A_ub is None else np.asarray(A_ub, dtype=np.float64)
    b_ub = np.zeros((0,)) if b_ub is None else np.asarray(b_ub, dtype=np.float64)
    A_eq = np.zeros((0, n)) if A_eq is None else np.asarray(A_eq, dtype=np.float64)
    b_eq = np.zeros((0,)) if b_eq is None else np.asarray(b_eq, dtype=np.float64)

    m_ub, m_eq = A_ub.shape[0], A_eq.shape[0]
    m = m_ub + m_eq

    # rows: [A_ub | I_slack | RHS], [A_eq | 0 | RHS]; flip rows w/ negative RHS
    A = np.zeros((m, n + m_ub))
    b = np.zeros(m)
    A[:m_ub, :n] = A_ub
    A[:m_ub, n : n + m_ub] = np.eye(m_ub)
    b[:m_ub] = b_ub
    A[m_ub:, :n] = A_eq
    b[m_ub:] = b_eq
    neg = b < 0
    A[neg] *= -1.0
    b[neg] *= -1.0

    n_sx = n + m_ub  # structural + slack count

    # ---- Phase 1: add artificials where needed ----
    # a slack can serve as initial basis for a <= row only if it wasn't
    # flipped (coef +1) — flipped rows and eq rows get artificials.
    need_art = []
    basis = -np.ones(m, dtype=int)
    for i in range(m):
        if i < m_ub and not neg[i]:
            basis[i] = n + i  # its own slack
        else:
            need_art.append(i)
    n_art = len(need_art)
    n_total = n_sx + n_art
    T = np.zeros((m + 1, n_total + 1))
    T[:m, :n_sx] = A
    T[:m, -1] = b
    for k, i in enumerate(need_art):
        T[i, n_sx + k] = 1.0
        basis[i] = n_sx + k

    if n_art:
        # phase-1 objective: sum of artificials
        T[-1, n_sx:n_total] = 1.0
        for k, i in enumerate(need_art):
            T[-1] -= T[i]  # price out artificial basics
        status = _simplex_core(T, basis, n_total)
        if status != "optimal" or T[-1, -1] < -1e-7:
            return LPResult("infeasible", None, np.inf)
        if T[-1, -1] < -1e-7 or -T[-1, -1] > 1e-7:
            return LPResult("infeasible", None, np.inf)
        # drive artificials out of the basis if possible
        for i in range(m):
            if basis[i] >= n_sx:
                for j in range(n_sx):
                    if abs(T[i, j]) > 1e-9:
                        _pivot(T, basis, i, j)
                        break
        # drop artificial columns
        T = np.hstack([T[:, :n_sx], T[:, -1:]])
        n_total = n_sx

    # ---- Phase 2 ----
    T[-1, :] = 0.0
    T[-1, :n] = c
    for i in range(m):
        j = basis[i]
        if j < n_total and abs(T[-1, j]) > 1e-12:
            T[-1] -= T[-1, j] * T[i]
    status = _simplex_core(T, basis, n_total)
    if status == "unbounded":
        return LPResult("unbounded", None, -np.inf)
    if status != "optimal":
        return LPResult("infeasible", None, np.inf)

    x = np.zeros(n_total)
    for i in range(m):
        if basis[i] < n_total:
            x[basis[i]] = T[i, -1]
    xs = x[:n]
    return LPResult("optimal", xs, float(c @ xs))


# ======================================================================
# pre-PR src/repro/core/subproblem.py
# ======================================================================
@dataclass
class ThetaResult:
    cost: float
    alloc: Allocation
    mode: str                      # "internal" | "external" | "idle"
    lp_cost: float = 0.0           # fractional optimum (approx-ratio metric)
    rounding_attempts: int = 0


@dataclass
class SubproblemConfig:
    delta: float = 0.5             # probabilistic knob of Lemmas 1-2
    g_delta: Optional[float] = None  # override; None => derive via favor
    favor: str = "packing"         # "packing" (Thm 3) | "cover" (Thm 4)
    rounding_rounds: int = 50      # S in Algorithm 4
    cover_slack: float = 0.0
    seed: int = 0
    prune_margin: float = 2.0      # capacity head-room factor for pruning
    max_lp_machines: int = 48


class PriceSnapshot:
    """Vectorized prices + free capacities for one (job, slot)."""

    def __init__(self, job: JobSpec, cluster: Cluster, prices: PriceTable, t: int):
        H = cluster.num_machines
        self.t = t
        self.H = H
        self.resources = cluster.resources
        self.free: Dict[str, np.ndarray] = {}
        price: Dict[str, np.ndarray] = {}
        for r in self.resources:
            fr = np.empty(H)
            pr = np.empty(H)
            for h in range(H):
                fr[h] = cluster.free(t, h, r)
                pr[h] = prices.price(t, h, r)
            self.free[r] = fr
            price[r] = pr
        self.wprice = np.zeros(H)
        self.sprice = np.zeros(H)
        self.coloc = np.zeros(H)
        for r in self.resources:
            a = job.worker_demand.get(r, 0.0)
            b = job.ps_demand.get(r, 0.0)
            if a:
                self.wprice += price[r] * a
            if b:
                self.sprice += price[r] * b
            self.coloc += price[r] * (a * job.gamma + b)
        # max workers (alone) / PSs (alone) each machine could host
        self.max_w = np.full(H, np.inf)
        self.max_s = np.full(H, np.inf)
        for r in self.resources:
            a = job.worker_demand.get(r, 0.0)
            b = job.ps_demand.get(r, 0.0)
            if a > 0:
                self.max_w = np.minimum(self.max_w, self.free[r] / a)
            if b > 0:
                self.max_s = np.minimum(self.max_s, self.free[r] / b)
        self.max_w = np.floor(np.maximum(self.max_w, 0.0))
        self.max_s = np.floor(np.maximum(self.max_s, 0.0))
        self.job = job


def _alloc_cost(snap: PriceSnapshot, alloc: Allocation) -> float:
    c = 0.0
    for h, w in alloc.workers.items():
        if w:
            c += snap.wprice[h] * w
    for h, s in alloc.ps.items():
        if s:
            c += snap.sprice[h] * s
    return c


# ----------------------------------------------------------------------
def solve_theta_internal(
    job: JobSpec, snap: PriceSnapshot, v: float
) -> Optional[ThetaResult]:
    """Algorithm 4 steps 2-7 (internal case)."""
    tps = job.time_per_sample(internal=True)
    w_need = max(1, int(math.ceil(v * tps)))
    if w_need > job.batch_size:  # constraint (4)
        return None
    s_need = max(1, int(math.ceil(w_need / job.gamma)))

    # vectorized feasibility: machine must host w_need workers AND s_need PSs
    ok = np.ones(snap.H, dtype=bool)
    for r in snap.resources:
        a = job.worker_demand.get(r, 0.0)
        b = job.ps_demand.get(r, 0.0)
        if a or b:
            ok &= snap.free[r] >= a * w_need + b * s_need - 1e-9
    if not ok.any():
        return None
    idx = np.where(ok)[0]
    h = int(idx[np.argmin(snap.coloc[idx])])
    alloc = Allocation(workers={h: w_need}, ps={h: s_need})
    return ThetaResult(cost=_alloc_cost(snap, alloc), alloc=alloc, mode="internal")


# ----------------------------------------------------------------------
def _prune_machines(snap: PriceSnapshot, need_w: float, need_s: float,
                    cfg: SubproblemConfig) -> np.ndarray:
    """Cheapest machines covering prune_margin x the requirement."""
    sel = set()
    for price, cap, need in (
        (snap.wprice, snap.max_w, need_w),
        (snap.sprice, snap.max_s, need_s),
    ):
        order = np.argsort(price, kind="stable")
        acc = 0.0
        for h in order:
            if cap[h] <= 0:
                continue
            sel.add(int(h))
            acc += cap[h]
            if acc >= cfg.prune_margin * need or len(sel) >= cfg.max_lp_machines:
                break
    return np.array(sorted(sel), dtype=int)


def solve_theta_external(
    job: JobSpec,
    snap: PriceSnapshot,
    v: float,
    cfg: SubproblemConfig,
    rng: np.random.Generator,
) -> Optional[ThetaResult]:
    """Algorithm 4 steps 8-11 (external case): LP relax + randomized round.

    Variables x = [w_0..w_{M-1}, s_0..s_{M-1}] over the pruned machine set.
    """
    tps = job.time_per_sample(internal=False)
    W1 = v * tps  # cover requirement on sum of workers (Eq. 26 RHS)
    if W1 > job.batch_size + 1e-9:  # (25) vs (26) conflict: infeasible v
        return None
    S1 = W1 / job.gamma
    machines = _prune_machines(snap, W1, S1, cfg)
    M = len(machines)
    if M == 0 or snap.max_w[machines].sum() < W1 - 1e-9:
        return None
    n = 2 * M

    c = np.concatenate([snap.wprice[machines], snap.sprice[machines]])

    rows_ub: List[np.ndarray] = []
    rhs_ub: List[float] = []
    # capacity packing rows (24)
    for k, h in enumerate(machines):
        for r in snap.resources:
            a = job.worker_demand.get(r, 0.0)
            b = job.ps_demand.get(r, 0.0)
            if a == 0.0 and b == 0.0:
                continue
            row = np.zeros(n)
            row[k] = a
            row[M + k] = b
            rows_ub.append(row)
            rhs_ub.append(float(snap.free[r][h]))
    # worker cap (25)
    row = np.zeros(n)
    row[:M] = 1.0
    rows_ub.append(row)
    rhs_ub.append(float(job.batch_size))
    # workload cover (26): -sum w <= -W1
    row = np.zeros(n)
    row[:M] = -1.0
    rows_ub.append(row)
    rhs_ub.append(-W1)
    # worker:PS ratio (Eq. 2, covering form): sum w - gamma sum s <= 0
    row = np.zeros(n)
    row[:M] = 1.0
    row[M:] = -job.gamma
    rows_ub.append(row)
    rhs_ub.append(0.0)

    res = linprog(c, A_ub=np.vstack(rows_ub), b_ub=np.array(rhs_ub))
    if res.status != "optimal" or res.x is None:
        return None
    x_frac = res.x

    # ---- G_delta (Theorems 3-4) ----
    if cfg.g_delta is not None:
        gd = cfg.g_delta
    elif cfg.favor == "cover":
        gd = g_delta_cover(cfg.delta, max(W1, 1.0))
    else:
        # W2 = min over packing rows of rhs/coef (Theorem 3)
        w2 = float(job.batch_size)
        for r in snap.resources:
            for d in (job.worker_demand.get(r, 0.0), job.ps_demand.get(r, 0.0)):
                if d > 0:
                    fr = snap.free[r][machines]
                    pos = fr[fr > 0]
                    if pos.size:
                        w2 = min(w2, float(pos.min()) / d)
        gd = g_delta_packing(cfg.delta, max(w2, 1e-6), num_packing_rows=len(rhs_ub) - 1)

    # feasibility-check matrices for the rounding loop
    A_cov = np.zeros((1, n))
    A_cov[0, :M] = 1.0
    a_cov = np.array([W1])
    B_pack = np.vstack(rows_ub[:-2])  # capacity rows + worker cap
    b_pack = np.array(rhs_ub[:-2])

    rr = round_until_feasible(
        x_frac, A_cov, a_cov, B_pack, b_pack, gd, rng,
        max_rounds=cfg.rounding_rounds, cover_slack=cfg.cover_slack,
    )
    w_sub = rr.x[:M].astype(np.int64)
    s_sub = rr.x[M:].astype(np.int64)

    w = np.zeros(snap.H, dtype=np.int64)
    s = np.zeros(snap.H, dtype=np.int64)
    w[machines] = w_sub
    s[machines] = s_sub

    if not rr.feasible:
        w, s = _repair(job, snap, w, s, W1)
        if w is None:
            return None

    # ratio repair: ensure enough PSs for the rounded worker count
    s = _ensure_ratio(job, snap, w, s)
    if s is None:
        return None
    if int(w.sum()) == 0:
        return None

    alloc = Allocation(
        workers={int(h): int(w[h]) for h in range(snap.H) if w[h] > 0},
        ps={int(h): int(s[h]) for h in range(snap.H) if s[h] > 0},
    )
    return ThetaResult(
        cost=_alloc_cost(snap, alloc),
        alloc=alloc,
        mode="external",
        lp_cost=res.objective,
        rounding_attempts=rr.attempts,
    )


def _fits_machine(job: JobSpec, snap: PriceSnapshot, h: int, w: int, s: int) -> bool:
    for r in snap.resources:
        need = job.worker_demand.get(r, 0.0) * w + job.ps_demand.get(r, 0.0) * s
        if need > snap.free[r][h] + 1e-9:
            return False
    return True


def _repair(job, snap, w, s, W1):
    """Clip per-machine packing violations, then greedily add workers on the
    cheapest machines until the cover constraint holds."""
    H = snap.H
    for h in range(H):
        while (w[h] > 0 or s[h] > 0) and not _fits_machine(job, snap, h, int(w[h]), int(s[h])):
            if w[h] >= s[h] and w[h] > 0:
                w[h] -= 1
            elif s[h] > 0:
                s[h] -= 1
            else:
                break
    need = int(math.ceil(W1 - w.sum()))
    if need > 0:
        order = np.argsort(snap.wprice, kind="stable")
        for h in order:
            while need > 0 and w.sum() < job.batch_size and _fits_machine(
                job, snap, int(h), int(w[h]) + 1, int(s[h])
            ):
                w[h] += 1
                need -= 1
            if need <= 0:
                break
        if need > 0:
            return None, None
    if w.sum() > job.batch_size:
        order = np.argsort(-snap.wprice, kind="stable")
        excess = int(w.sum() - job.batch_size)
        for h in order:
            take = min(excess, int(w[h]))
            w[h] -= take
            excess -= take
            if excess <= 0:
                break
    return w, s


def _ensure_ratio(job, snap, w, s):
    """Ensure sum(s) >= ceil(sum(w)/gamma), adding PSs cheapest-first."""
    need = max(1, int(math.ceil(w.sum() / job.gamma))) - int(s.sum())
    if need <= 0:
        return s
    order = np.argsort(snap.sprice, kind="stable")
    for h in order:
        while need > 0 and _fits_machine(job, snap, int(h), int(w[h]), int(s[h]) + 1):
            s[h] += 1
            need -= 1
        if need <= 0:
            break
    return s if need <= 0 else None


# ----------------------------------------------------------------------
def solve_theta_snapshot(
    job: JobSpec,
    snap: PriceSnapshot,
    v: float,
    cfg: Optional[SubproblemConfig] = None,
    rng: Optional[np.random.Generator] = None,
) -> Optional[ThetaResult]:
    """Algorithm 4 (all steps): min over internal / external candidates."""
    if v <= 0:
        return ThetaResult(cost=0.0, alloc=Allocation(), mode="idle")
    cfg = cfg or SubproblemConfig()
    rng = rng if rng is not None else np.random.default_rng(cfg.seed)
    cands: List[ThetaResult] = []
    internal = solve_theta_internal(job, snap, v)
    if internal is not None:
        cands.append(internal)
    external = solve_theta_external(job, snap, v, cfg, rng)
    if external is not None:
        cands.append(external)
    if not cands:
        return None
    return min(cands, key=lambda r: r.cost)


def solve_theta(
    job: JobSpec,
    cluster: Cluster,
    prices: PriceTable,
    t: int,
    v: float,
    cfg: Optional[SubproblemConfig] = None,
    rng: Optional[np.random.Generator] = None,
) -> Optional[ThetaResult]:
    """Convenience wrapper building a fresh snapshot (tests, one-offs)."""
    if v <= 0:
        return ThetaResult(cost=0.0, alloc=Allocation(), mode="idle")
    snap = PriceSnapshot(job, cluster, prices, t)
    return solve_theta_snapshot(job, snap, v, cfg, rng)


# ======================================================================
# pre-PR src/repro/core/dp.py
# ======================================================================
@dataclass
class DPResult:
    cost: float
    # slot -> ThetaResult for the chosen workloads (only active slots)
    slots: Dict[int, ThetaResult]


class WorkloadDP:
    def __init__(
        self,
        job: JobSpec,
        cluster: Cluster,
        prices: PriceTable,
        cfg: Optional[SubproblemConfig] = None,
        quanta: int = 32,
        rng: Optional[np.random.Generator] = None,
    ):
        self.job = job
        self.cluster = cluster
        self.prices = prices
        self.cfg = cfg or SubproblemConfig()
        self.rng = rng if rng is not None else np.random.default_rng(self.cfg.seed)
        V = job.total_workload()
        self.quanta = max(1, min(quanta, int(math.ceil(V))))
        self.unit = V / self.quanta
        # theta cache: (t, units) -> Optional[ThetaResult]
        self._theta: Dict[Tuple[int, int], Optional[ThetaResult]] = {}
        # price snapshots are valid for the whole job (prices frozen until
        # admission): one per slot
        self._snaps: Dict[int, PriceSnapshot] = {}

    # ------------------------------------------------------------------
    def snapshot(self, t: int) -> PriceSnapshot:
        if t not in self._snaps:
            self._snaps[t] = PriceSnapshot(self.job, self.cluster, self.prices, t)
        return self._snaps[t]

    def theta(self, t: int, units: int) -> Optional[ThetaResult]:
        key = (t, units)
        if key not in self._theta:
            self._theta[key] = solve_theta_snapshot(
                self.job, self.snapshot(t), units * self.unit, self.cfg, self.rng,
            )
        return self._theta[key]

    # ------------------------------------------------------------------
    def solve_prefix(self, t_end: int) -> List[List[float]]:
        """Forward DP over slots [a_i, t_end]; returns cost table C where
        C[k][u] = min cost using the first k slots to finish u units."""
        a = self.job.arrival
        Q = self.quanta
        INF = float("inf")
        C: List[List[float]] = [[INF] * (Q + 1)]
        C[0][0] = 0.0
        choice: List[List[int]] = [[-1] * (Q + 1)]
        for t in range(a, t_end + 1):
            prev = C[-1]
            cur = [INF] * (Q + 1)
            ch = [-1] * (Q + 1)
            # precompute theta(t, v) for all v once
            tcost = [0.0] * (Q + 1)
            tok = [True] * (Q + 1)
            for v in range(1, Q + 1):
                th = self.theta(t, v)
                if th is None:
                    tok[v] = False
                else:
                    tcost[v] = th.cost
            for u in range(Q + 1):
                best, bestv = INF, -1
                for v in range(0, u + 1):
                    if not tok[v] or prev[u - v] == INF:
                        continue
                    val = prev[u - v] + tcost[v]
                    if val < best - 1e-12:
                        best, bestv = val, v
                cur[u] = best
                ch[u] = bestv
            C.append(cur)
            choice.append(ch)
        self._choice = choice
        return C

    def reconstruct(self, t_end: int, C: List[List[float]]) -> Optional[DPResult]:
        """Walk the choice table back from (t_end, Q)."""
        a = self.job.arrival
        Q = self.quanta
        k = t_end - a + 1
        if C[k][Q] == float("inf"):
            return None
        slots: Dict[int, ThetaResult] = {}
        u = Q
        total = 0.0
        for kk in range(k, 0, -1):
            v = self._choice[kk][u]
            if v is None or v < 0:
                return None
            if v > 0:
                t = a + kk - 1
                th = self.theta(t, v)
                assert th is not None
                slots[t] = th
                total += th.cost
            u -= v
        return DPResult(cost=total, slots=slots)


# ======================================================================
# pre-PR src/repro/core/schedule.py
# ======================================================================
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
) -> Optional[Schedule]:
    """Algorithm 2 main loop."""
    if job.arrival >= horizon:
        return None
    dp = WorkloadDP(job, cluster, prices, cfg=cfg, quanta=quanta, rng=rng)
    C = dp.solve_prefix(horizon - 1)

    best_payoff = 0.0
    best_t = -1
    a = job.arrival
    for t_tilde in range(a, horizon):
        k = t_tilde - a + 1
        cost = C[k][dp.quanta]
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


# ======================================================================
# pre-PR src/repro/core/pdors.py
# ======================================================================
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

    def offer(self, job: JobSpec) -> AdmissionRecord:
        sched = find_best_schedule(
            job, self.cluster, self.prices, self.cluster.horizon,
            cfg=self.cfg, quanta=self.quanta, rng=self.rng,
        )
        if sched is not None and sched.payoff > 0:
            # Step 3: admit; commit rho updates (prices react via Q_h^r)
            for t, alloc in sched.slots.items():
                self.cluster.commit(t, job, alloc)
            rec = AdmissionRecord(job, True, sched, job.utility(sched.completion - job.arrival))
        else:
            rec = AdmissionRecord(job, False, None, 0.0)
        self.records.append(rec)
        return rec

    def run(self, jobs: List[JobSpec]) -> PDORSResult:
        for job in sorted(jobs, key=lambda j: (j.arrival, j.job_id)):
            self.offer(job)
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


# ======================================================================
# public entry points (names suffixed to keep imports unambiguous)
# ======================================================================
run_pdors_reference = run_pdors
make_cluster_reference = make_cluster
PDORSReference = PDORS
