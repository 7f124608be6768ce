"""Exponential price function Q_h^r and its constants (paper Eqs. 12-14).

Q_h^r(rho) = L * (U^r / L) ** (rho / C_h^r)

U^r (Eq. 13): max over jobs of (best-case utility) / (alpha^r + beta^r) —
  the highest unit-resource utility any job could extract from type-r.
L (Eq. 14): min over jobs of (1/(2 mu)) u_i(T - a_i) /
  (worst-case total resource-slots) — the lowest unit-time unit-resource
  utility; resource-type independent by design (see paper's discussion).
mu: scaling factor satisfying
  1/mu <= ceil(EK (tau + 2 g gamma/(b_ext F))) * sum_r(alpha+beta)
          / (T * sum_h sum_r C_h^r)   for all i.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

import numpy as np

from ..obs import trace as _trace
from ..obs.metrics import get_registry
from .cluster import Cluster
from .job import JobSpec, Resource


@dataclass
class PriceParams:
    U: Dict[Resource, float]   # U^r
    L: float
    mu: float

    def _ceiling(self, r: Resource) -> float:
        return max(self.U.get(r, self.L), self.L * (1.0 + 1e-9))

    def price(self, rho: float, cap: float, r: Resource) -> float:
        """Q_h^r(rho) — Eq. (12). A zero-capacity resource is priced at its
        ceiling U^r (the 'exhausted' price); the capacity rows in the LP /
        feasibility checks are what actually forbid placement there."""
        u = self._ceiling(r)
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
    """p_h^r[t] = Q_h^r(rho_h^r[t]) maintained over the cluster ledger.

    ``price_matrix`` results are memoized against the cluster's ledger
    version: prices only move when rho moves (Algorithm 1 reprices after
    admission), so between commits every job offer hitting slot t reuses the
    same (H, R) table instead of recomputing H*R exponentials.

    The whole (T, H, R) tensor is computed on the cluster's device
    (``device_tensor``) and mirrored to the host in ONE sync per ledger
    version — the explicit host sync point at admission-decision time."""

    def __init__(self, params: PriceParams, cluster: Cluster):
        self.params = params
        self.cluster = cluster
        self._matrix_cache: Dict[int, tuple] = {}  # t -> (version, (H,R))
        self._ceil_vec: Optional[np.ndarray] = None
        self._device_tensor: Optional[tuple] = None  # (version, (T,H,R) dev)

    def price(self, t: int, h: int, r: Resource) -> float:
        return self.params.price(
            self.cluster.used(t, h, r), self.cluster.capacity(h, r), r
        )

    def ceiling_vector(self) -> np.ndarray:
        """U^r ceilings on the cluster's resource axis (params are frozen
        for the table's lifetime, so computed once)."""
        if self._ceil_vec is None:
            self._ceil_vec = np.array(
                [self.params._ceiling(r) for r in self.cluster.resources]
            )
        return self._ceil_vec

    def device_tensor(self):
        """The (T, H, R) price tensor on the cluster's device, version-
        cached. Repricing runs on the device with NO host copy;
        ``prewarm`` is the sync point that mirrors it."""
        cl = self.cluster
        ent = self._device_tensor
        if ent is None or ent[0] != cl.version:
            ent = (cl.version, cl.backend.price_tensor(
                cl._used, cl.capacity_matrix, self.ceiling_vector(),
                self.params.L,
            ))
            self._device_tensor = ent
        return ent[1]

    def price_column(self, t: int, r: Resource) -> np.ndarray:
        """All machines' p_h^r[t] as one (H,) vector (vectorized Eq. 12)."""
        return self.price_matrix(t)[:, self.cluster.res_index[r]]

    def price_matrix(self, t: int) -> np.ndarray:
        """(H, R) price table for slot t (a slice of the host mirror);
        cached until the next ledger mutation (do not write into it)."""
        ent = self._matrix_cache.get(t)
        if ent is None or ent[0] != self.cluster.version:
            self.prewarm()               # one sync fills every slot's cache
            ent = self._matrix_cache[t]
        return ent[1]

    def prewarm(self, t_end: Optional[int] = None) -> None:
        """Populate the per-slot price-matrix cache for slots [0, t_end)
        from ONE host mirror of the device repricing (``device_tensor``).

        Element-for-element the arithmetic is the clip/divide/pow of
        ``PriceParams.price`` over the whole ledger; torch's pow makes the prices tolerance-equal (not bit-equal) to the numpy
        expression. Used by the batched-offer path: one pass per arrival
        batch instead of one build per (job, slot)."""
        cl = self.cluster
        T = cl.horizon if t_end is None else min(t_end, cl.horizon)
        version = cl.version
        if all(
            (ent := self._matrix_cache.get(t)) is not None and ent[0] == version
            for t in range(T)
        ):
            return
        with _trace.span("price.prewarm", slots=T,
                         device=cl.backend.is_device):
            get_registry().counter(
                "repro_price_prewarm_total",
                "full (T,H,R) price-tensor rebuilds").inc()
            mats = cl.backend.to_host(self.device_tensor())
            for t in range(cl.horizon):
                self._matrix_cache[t] = (version, mats[t])

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
