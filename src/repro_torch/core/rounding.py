"""Randomized rounding for mixed cover/packing integer programs.

Implements the paper's scheme (Eqs. 27-28) and the two G_delta choices:
  * Eq. (29) / Lemma 1 / Theorem 3 — 0 < G_delta <= 1, packing feasibility
    favored (scale DOWN the fractional solution before rounding);
  * Eq. (30) / Lemma 2 / Theorem 4 — G_delta > 1, cover feasibility favored.

These are general: given a fractional x_bar for
  min c.x  s.t.  A x >= a (cover),  B x <= b (packing),  x in Z+^n
rounding returns an integer candidate; the caller retries up to S times
(Algorithm 4 steps 10-11) and keeps feasible ones.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np


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


def round_cover_packing_structured(
    x_frac: np.ndarray,
    W1: float,
    wdem_act: np.ndarray,      # (P,) worker demand, active resources only
    sdem_act: np.ndarray,      # (P,) PS demand, active resources only
    free_act: np.ndarray,      # (M, P) free capacity on the LP's machines
    batch_cap: float,          # worker-cap row RHS (constraint 25)
    g_delta: float,
    rng: np.random.Generator,
    max_rounds: int = 50,
    cover_slack: float = 0.0,
) -> RoundingResult:
    """``round_until_feasible`` specialized to program (23)'s structure.

    The generic path evaluates X @ B.T against a (M*P+1, 2M) matrix whose
    capacity rows hold exactly two nonzeros (w_kk alpha_r + s_kk beta_r).
    Here those rows are evaluated directly as a (S, M, P) broadcast — ~P x
    fewer multiply-adds — and the cover / worker-cap rows as integer sums.

    Bit-identical to the generic path: the all-ones rows sum integers
    (exact in any association below 2^53), and each capacity row reduces to
    fl(fl(w*alpha) + fl(s*beta)) plus exact zeros, which every summation
    order evaluates identically. The rng consumption (one (S, 2M) uniform
    block) is also identical, keeping downstream draws aligned.
    """
    n = x_frac.size
    M = n // 2
    S = max_rounds
    xp = np.maximum(x_frac, 0.0) * g_delta
    lo = np.floor(xp)
    frac = xp - lo
    X = (lo[None, :] + (rng.random((S, n)) < frac[None, :])).astype(np.int64)
    W = X[:, :M].astype(np.float64)
    Sx = X[:, M:].astype(np.float64)

    wsum = W.sum(axis=1)                               # integer-exact
    # cover row: -sum w <= -W1, relative shortfall (W1 - lhs)/max(W1, eps)
    if W1 > 0:
        cov_v = np.maximum((W1 - wsum) / max(W1, 1e-12), 0.0)
    else:
        cov_v = np.zeros(S)
    # capacity packing rows (24): lhs = w*alpha_r + s*beta_r per (machine, r)
    cap_lhs = (W[:, :, None] * wdem_act[None, None, :]
               + Sx[:, :, None] * sdem_act[None, None, :])   # (S, M, P)
    b = free_act[None, :, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.where(
            b > 0,
            (cap_lhs - b) / np.maximum(b, 1e-12),
            np.where(cap_lhs > 0, np.inf, 0.0),
        )
    pack_v = rel.reshape(S, -1).max(axis=1)
    # worker-cap row (25): sum w <= batch_cap (> 0 always)
    relw = (wsum - batch_cap) / max(batch_cap, 1e-12)
    pack_v = np.maximum(pack_v, relw)
    pack_v = np.maximum(pack_v, 0.0)

    feas = (cov_v <= cover_slack + 1e-9) & (pack_v <= 1e-9)
    if feas.any():
        i = int(np.argmax(feas))  # first feasible draw
        return RoundingResult(X[i], True, float(cov_v[i]), float(pack_v[i]), i + 1)
    order = np.lexsort((cov_v, pack_v))
    i = int(order[0])
    return RoundingResult(X[i], False, float(cov_v[i]), float(pack_v[i]), S)


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
