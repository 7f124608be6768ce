"""Primal-dual telemetry: realized utility vs the dual objective.

PD-ORS is an online primal-dual algorithm: each admitted job i fixes a
dual payoff variable lambda_i = max(0, u_i - cost_i) (Eq. 10 / Alg. 1),
and the ledger fixes resource prices p_h^r(t) via the exponential
marginal-price function Q_h^r(rho) = L (U^r/L)^(rho / C_h^r)
(Eqs. 12-14). Weak duality makes the dual objective

    D = sum_i lambda_i + sum_{t,h,r} p_h^r(t) * C_h^r

an *online upper bound on the offline-optimal utility*, so with
P = sum of realized admitted utility,

    P  <=  OPT  <=  D        =>   OPT / P  <=  D / P.

``duality_gap = D - P`` and ``empirical_ratio = D / P`` therefore turn
the paper's Theorem-style guarantee into live telemetry: the empirical
ratio is a per-run certificate, always at least as tight as the
worst-case bound max_r(1, ln(U^r/L)) reported by
``PriceTable.competitive_ratio_bound()``.

The tracker is deliberately cheap (a few float adds per offer, price
term evaluated lazily at snapshot time from the cached price matrices)
and rng-free, so it can stay always-on without perturbing decisions.
It is plain-data (deepcopy-safe), which lets ``SimEngine`` checkpoints
carry it — a recovered run reports the same gap as an uninterrupted
one. In the rolling-window simulator the price term is evaluated over
the *live window* (the only slots carrying prices); lambda_i
accumulates across the whole run, and an optional ``window`` keeps a
bounded recent-offer view for rolling gap gauges.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Dict, Optional

import numpy as np

from .metrics import MetricsRegistry, get_registry


class PDGapTracker:
    """Accumulates per-offer primal/dual contributions against a
    ``PriceTable`` (duck-typed: needs ``price_matrix(t)``, ``cluster``
    with ``capacity_matrix`` and ``horizon``, and
    ``competitive_ratio_bound()``)."""

    def __init__(self, prices: Optional[Any] = None,
                 window: Optional[int] = None):
        self.prices = prices
        self.offers = 0
        self.admits = 0
        self.primal = 0.0        # realized admitted utility  sum u_i
        self.dual_payoff = 0.0   # admitted dual payoffs      sum lambda_i
        self._recent = deque(maxlen=window) if window else None

    # ------------------------------------------------------------ feed
    def bind(self, prices: Any) -> None:
        self.prices = prices

    def record_offer(self, admitted: bool, payoff: float,
                     utility: float) -> None:
        self.offers += 1
        if admitted:
            self.admits += 1
            self.primal += float(utility)
            self.dual_payoff += max(0.0, float(payoff))
        if self._recent is not None:
            self._recent.append(
                (float(utility), max(0.0, float(payoff))) if admitted
                else (0.0, 0.0))

    # ------------------------------------------------------------ read
    def dual_price_term(self) -> float:
        """sum_{t,h,r} p_h^r(t) C_h^r over the priced horizon (lazily,
        from the table's cached matrices — never in the offer path)."""
        pt = self.prices
        if pt is None:
            return 0.0
        cluster = pt.cluster
        cap = np.asarray(cluster.capacity_matrix, dtype=float)
        total = 0.0
        for t in range(int(cluster.horizon)):
            total += float(np.sum(np.asarray(pt.price_matrix(t)) * cap))
        return total

    def snapshot(self) -> Dict[str, Any]:
        price_term = self.dual_price_term()
        dual = self.dual_payoff + price_term
        gap = dual - self.primal
        ratio = (dual / self.primal) if self.primal > 0 else None
        bound = None
        if self.prices is not None:
            bound = float(self.prices.competitive_ratio_bound())
        out = {
            "pd_offers": self.offers,
            "pd_admits": self.admits,
            "pd_primal": self.primal,
            "pd_dual": dual,
            "pd_price_term": price_term,
            "duality_gap": gap,
            "empirical_ratio": ratio,
            "ratio_bound": bound,
        }
        if self._recent is not None and self._recent:
            w_primal = sum(u for u, _ in self._recent)
            w_dual = sum(l for _, l in self._recent)
            out["pd_window_primal"] = w_primal
            out["pd_window_dual_payoff"] = w_dual
        return out

    def publish(self, registry: Optional[MetricsRegistry] = None,
                prefix: str = "repro_pd") -> Dict[str, Any]:
        """Set the gap gauges from a fresh snapshot; returns it."""
        reg = registry or get_registry()
        snap = self.snapshot()
        reg.gauge(f"{prefix}_primal",
                  "realized admitted utility").set(snap["pd_primal"])
        reg.gauge(f"{prefix}_dual",
                  "dual objective (payoffs + price term)").set(snap["pd_dual"])
        reg.gauge(f"{prefix}_duality_gap",
                  "dual - primal (weak-duality slack)").set(
                      snap["duality_gap"])
        if snap["empirical_ratio"] is not None:
            reg.gauge(f"{prefix}_empirical_ratio",
                      "dual / primal upper bound on OPT/ALG").set(
                          snap["empirical_ratio"])
        if snap["ratio_bound"] is not None:
            reg.gauge(f"{prefix}_ratio_bound",
                      "worst-case bound max_r(1, ln U^r/L)").set(
                          snap["ratio_bound"])
        return snap
