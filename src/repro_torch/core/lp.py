"""Dense two-phase simplex LP solver — scalar and batched stacked-tableau.

The container has no scipy; the paper's Algorithm 4 needs the LP relaxation
of the mixed cover/packing program (23). The LPs are small (~2H variables,
~RH + 3 rows), so a dense tableau simplex with Bland's anti-cycling rule is
exact and fast.

Solves:  min c^T x
         s.t. A_ub x <= b_ub
              A_eq x == b_eq
              x >= 0

The pivot core is vectorized: entering column via one comparison +
``argmax``, ratio test via one masked division, tableau update via one
buffered outer-product subtraction. The update zeroes coefficients with
|a| <= 1e-12 exactly like the scalar row loop of the frozen reference
(``repro.core._reference``) skipped them, and near-tied ratio tests replay
the scalar hysteresis logic, so the pivot trajectory — and therefore the
solution — is bit-identical to the pre-vectorization solver.

Batched solve (``linprog_batch``)
---------------------------------
Algorithm 3 probes ~Q workload levels per slot and each level in the
heavy-contention regime pays one external LP; the measured pivot counts
are tiny (median ~4, p95 ~19) over tiny tableaus, so the scalar path is
dominated by per-pivot Python dispatch, not flops. ``linprog_batch``
stacks B independent problems into padded ``(B, m, n)`` tableau arrays
and runs ONE masked pivot loop across the whole batch: every iteration
performs each still-active problem's next scalar pivot with the same
entering-column scan, the same masked ratio test (per-problem Bland
hysteresis replay on ties), and the same dense outer-product update, so
each problem's pivot TRAJECTORY — entering/leaving sequence, basis path,
iteration count, status — is identical to running ``linprog`` on it
alone. Problems are masked out of the batch as they terminate
(optimal/unbounded/maxiter at their own pivot counts — ragged
termination), and the final straggler drops to a single-problem loop so
a long tail never pays batch-width overhead.

Bit-level note: like the scalar solver, the batch picks between a
sparse update (touch only the (problem, row) pairs whose pivot-column
coefficient survives the |a| <= 1e-12 zeroing) and a dense outer-product
form ``T -= colv ⊗ T[row]`` by nonzero count. The two forms differ at
most in the sign of zero (``x - 0.0*y`` can turn ``-0.0`` into
``+0.0``), which no comparison, ratio test, or downstream decision
observes — the scalar solver itself already switches between the same
two forms by row count under the same equivalence. Pivot TRAJECTORIES
(entering/leaving sequences, statuses, iteration counts) are therefore
identical to per-problem ``linprog`` runs, and solutions compare equal
under ``==`` (byte-identical whenever both runs take the same branch).

Statuses: "optimal" | "infeasible" | "unbounded" | "maxiter". "maxiter"
(pivot budget exhausted — a solver failure, not a provably empty polytope)
is surfaced as its own status so callers can distinguish the two.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class LPResult:
    status: str           # "optimal" | "infeasible" | "unbounded" | "maxiter"
    x: Optional[np.ndarray]
    objective: float


# process-wide pivot tally (observability): every pivot loop adds its
# iterations here at batch granularity; ``consume_pivots`` reads-and-
# resets at a solve boundary (obs spans / registry counters). A bare
# int-in-list keeps the hot loops at one C-level add per pivot pass.
_pivot_tally = [0]


def consume_pivots() -> int:
    """Pivot count accumulated since the last call (then reset)."""
    n, _pivot_tally[0] = _pivot_tally[0], 0
    return n


def _pivot(T: np.ndarray, basis: np.ndarray, row: int, col: int) -> None:
    """Scalar pivot, used only on the cold drive-artificials-out path."""
    T[row] /= T[row, col]
    for i in range(T.shape[0]):
        if i != row and abs(T[i, col]) > 1e-12:
            T[i] -= T[i, col] * T[row]
    basis[row] = col


def _ratio_test_replay(
    basis: np.ndarray, rows: np.ndarray, ratios: np.ndarray
) -> int:
    """Bland ratio test with the original 1e-12 hysteresis, replayed over the
    candidate rows in ascending order (exact tie-break semantics)."""
    best_ratio, row = np.inf, -1
    for i, ratio in zip(rows, ratios):
        if ratio < best_ratio - 1e-12 or (
            abs(ratio - best_ratio) <= 1e-12
            and (row < 0 or basis[i] < basis[row])
        ):
            best_ratio, row = ratio, int(i)
    return row


def _simplex_core(T: np.ndarray, basis: np.ndarray, n_total: int,
                  max_iter: int = 20000) -> str:
    """Minimize the objective encoded in the last row of tableau T.

    Last row = reduced costs (objective row, negated-cost convention:
    row holds c_bar; optimal when all c_bar >= -eps). Last column = RHS.
    """
    m = T.shape[0] - 1
    buf = np.empty_like(T)
    for _ in range(max_iter):
        negmask = T[-1, :n_total] < -1e-9
        if not negmask.any():
            return "optimal"
        col = int(negmask.argmax())  # Bland: smallest index
        colvals = T[:m, col]
        mask = colvals > 1e-10
        if not mask.any():
            return "unbounded"
        ratios = np.where(mask, T[:m, -1], np.inf)
        np.divide(ratios, colvals, out=ratios, where=mask)
        rmin = ratios.min()
        cand = np.flatnonzero(ratios <= rmin + 1e-12)
        if cand.size == 1:
            # unique minimizer within the hysteresis window — the scalar
            # scan provably selects a row with ratio <= rmin + 1e-12
            row = int(cand[0])
        else:
            rows = np.flatnonzero(mask)
            row = _ratio_test_replay(basis, rows, ratios[rows])
        # outer-product pivot, bit-identical to the scalar row loop: rows
        # with |coef| <= 1e-12 are skipped there, and here either excluded
        # from the update set (sparse path) or zeroed (x - 0.0*y == x for
        # all finite x, dense path). Degenerate tableaus keep most column
        # entries at zero, so update only the touched rows when few.
        T[row] /= T[row, col]
        colv = T[:, col].copy()
        colv[row] = 0.0
        np.place(colv, np.abs(colv) <= 1e-12, 0.0)
        nz = np.flatnonzero(colv)
        if nz.size * 3 < T.shape[0]:
            T[nz] -= colv[nz, None] * T[row][None, :]
        else:
            np.multiply(colv[:, None], T[row][None, :], out=buf)
            np.subtract(T, buf, out=T)
        basis[row] = col
        _pivot_tally[0] += 1
    return "maxiter"


def _build_tableau(
    c: np.ndarray,
    A_ub: Optional[np.ndarray] = None,
    b_ub: Optional[np.ndarray] = None,
    A_eq: Optional[np.ndarray] = None,
    b_eq: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int, int]:
    """Phase-1-ready tableau shared by the scalar and batched solvers.

    Layout: [A | slacks | artificials | RHS]; negative-RHS <= rows are
    flipped so every RHS is nonnegative, flipped and eq rows get phase-1
    artificials, and (when any artificial exists) the last row already
    holds the priced-out phase-1 objective. Returns
    (c, T, basis, n, n_sx, n_art) — construction op-for-op the code the
    scalar ``linprog`` always ran, so tableaus are bit-identical."""
    c = np.asarray(c, dtype=np.float64)
    n = c.size
    A_ub = np.zeros((0, n)) if A_ub is None else np.asarray(A_ub, dtype=np.float64)
    b_ub = np.zeros((0,)) if b_ub is None else np.asarray(b_ub, dtype=np.float64)
    A_eq = np.zeros((0, n)) if A_eq is None else np.asarray(A_eq, dtype=np.float64)
    b_eq = np.zeros((0,)) if b_eq is None else np.asarray(b_eq, dtype=np.float64)

    m_ub, m_eq = A_ub.shape[0], A_eq.shape[0]
    m = m_ub + m_eq
    n_sx = n + m_ub  # structural + slack count

    # negative-RHS <= rows are flipped so every RHS is nonnegative; flipped
    # rows (slack coef -1) and eq rows then need phase-1 artificials
    neg = b_ub < 0
    need_art = np.concatenate(
        [np.flatnonzero(neg), np.arange(m_ub, m)]
    )
    n_art = need_art.size
    n_total = n_sx + n_art

    # tableau built in place: [A | slacks | artificials | RHS]
    T = np.zeros((m + 1, n_total + 1))
    T[:m_ub, :n] = A_ub
    T[:m_ub, -1] = b_ub
    idx = np.arange(m_ub)
    T[idx, n + idx] = 1.0
    T[m_ub:m, :n] = A_eq
    T[m_ub:m, -1] = b_eq
    flip = np.zeros(m, dtype=bool)
    flip[:m_ub] = neg
    flip[m_ub:] = T[m_ub:m, -1] < 0
    T[:m][flip] *= -1.0

    basis = np.empty(m, dtype=int)
    basis[:m_ub] = n + idx                    # own slack where unflipped
    art_cols = n_sx + np.arange(n_art)
    T[need_art, art_cols] = 1.0
    basis[need_art] = art_cols

    if n_art:
        # phase-1 objective: sum of artificials; price out artificial
        # basics row by row (sequential subtraction keeps the float result
        # bit-identical to the frozen reference)
        T[-1, n_sx:n_total] = 1.0
        for i in need_art:
            T[-1] -= T[i]
    return c, T, basis, n, n_sx, n_art


def _build_tableau_ub(
    c: np.ndarray, A_ub: np.ndarray, b_ub: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int, int]:
    """``_build_tableau`` specialized to pure <=-row problems with
    float64 operands (the Algorithm-4 template hot path): the same op
    sequence minus the empty-eq handling, so the tableau is
    bit-identical to the generic builder's."""
    n = c.size
    m = b_ub.size
    n_sx = n + m
    neg = b_ub < 0
    need_art = np.flatnonzero(neg)
    n_art = need_art.size
    T = np.zeros((m + 1, n_sx + n_art + 1))
    T[:m, :n] = A_ub
    T[:m, -1] = b_ub
    idx = np.arange(m)
    T[idx, n + idx] = 1.0
    T[:m][neg] *= -1.0
    basis = np.empty(m, dtype=int)
    basis[:] = n + idx
    art_cols = n_sx + np.arange(n_art)
    T[need_art, art_cols] = 1.0
    basis[need_art] = art_cols
    if n_art:
        T[-1, n_sx:n_sx + n_art] = 1.0
        for i in need_art:
            T[-1] -= T[i]
    return c, T, basis, n, n_sx, n_art


def linprog(
    c: np.ndarray,
    A_ub: Optional[np.ndarray] = None,
    b_ub: Optional[np.ndarray] = None,
    A_eq: Optional[np.ndarray] = None,
    b_eq: Optional[np.ndarray] = None,
) -> LPResult:
    c, T, basis, n, n_sx, n_art = _build_tableau(c, A_ub, b_ub, A_eq, b_eq)
    m = T.shape[0] - 1
    n_total = n_sx + n_art

    if n_art:
        status = _simplex_core(T, basis, n_total)
        if status == "maxiter":
            return LPResult("maxiter", None, np.inf)
        # phase-1 minimizes sum of artificials (>= 0), so with the negated-
        # cost convention T[-1,-1] == -opt: a strictly negative entry means
        # the artificials cannot be driven to zero — the polytope is empty.
        if status != "optimal" or T[-1, -1] < -1e-7:
            return LPResult("infeasible", None, np.inf)
        # drive artificials out of the basis if possible
        for i in range(m):
            if basis[i] >= n_sx:
                for j in range(n_sx):
                    if abs(T[i, j]) > 1e-9:
                        _pivot(T, basis, i, j)
                        break
        # drop artificial columns
        T = np.ascontiguousarray(np.hstack([T[:, :n_sx], T[:, -1:]]))
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
    if status == "maxiter":
        # pivot budget exhausted: solver failure, NOT proof of emptiness
        return LPResult("maxiter", None, np.inf)

    x = np.zeros(n_total)
    inb = basis < n_total  # a redundant row may keep a zero artificial basic
    x[basis[inb]] = T[np.flatnonzero(inb), -1]
    xs = x[:n]
    return LPResult("optimal", xs, float(c @ xs))


# ======================================================================
# Batched stacked-tableau solver
# ======================================================================
class _Prob:
    """One problem's stacked-batch bookkeeping."""

    __slots__ = ("c", "T", "basis", "n", "n_sx", "n_art", "m")

    def __init__(self, c, A_ub, b_ub, A_eq, b_eq):
        (self.c, self.T, self.basis, self.n,
         self.n_sx, self.n_art) = _build_tableau(c, A_ub, b_ub, A_eq, b_eq)
        self.m = self.T.shape[0] - 1


class TableauTemplate:
    """Shared phase-1 tableau for a family of LPs that differ only in ONE
    <=-row's RHS (Algorithm 4: for a fixed (slot, pruned-machine-set) the
    workload levels change only the cover row's -W1).

    Two instantiation forms exist: the single-cell ``instantiate`` /
    ``lazy`` below (one row's RHS varies — retained for direct callers
    and the lp test-suite's coverage) and the full-RHS ``lazy_rhs``
    (every RHS cell patched per instance — what the solve-plan layer's
    shared subset-template cache uses, ``cover_packing.TemplateCache``).

    The template is built once from a placeholder RHS carrying the SAME
    SIGN as every instance (the flip pattern, artificial structure, and
    basis are sign-determined); ``instantiate`` copies the tableau,
    patches the post-flip RHS cell with the exact op the full build would
    have applied (``b * -1.0`` on flipped rows), and re-prices the
    phase-1 objective row with the same sequential subtraction — so the
    instance tableau is bit-identical to ``_build_tableau`` on the full
    (c, A_ub, b_ub). Cuts per-candidate construction from O(m*n) row
    writes to one array copy."""

    __slots__ = ("c", "T0", "basis0", "n", "n_sx", "n_art", "m",
                 "need_art", "flip_sign")

    def __init__(self, c, A_ub, b_ub_placeholder):
        c = np.asarray(c, dtype=np.float64)
        A_ub = np.asarray(A_ub, dtype=np.float64)
        b = np.asarray(b_ub_placeholder, dtype=np.float64)
        (self.c, self.T0, self.basis0, self.n,
         self.n_sx, self.n_art) = _build_tableau_ub(c, A_ub, b)
        self.m = self.T0.shape[0] - 1
        neg = b < 0
        self.need_art = np.flatnonzero(neg)
        self.flip_sign = np.where(neg, -1.0, 1.0)

    def instantiate(self, row: int, value: float) -> _Prob:
        """A ``_Prob`` whose b_ub[row] is ``value`` (same sign as the
        placeholder — enforced, since a sign change would alter the flip
        pattern the template baked in)."""
        if (value < 0) != (self.flip_sign[row] < 0):
            raise ValueError(
                "RHS patch changes the row's sign; rebuild, don't patch"
            )
        p = _Prob.__new__(_Prob)
        p.c = self.c
        T = self.T0.copy()
        T[row, -1] = value * -1.0 if self.flip_sign[row] < 0 else value
        if self.n_art:
            # re-price the phase-1 objective against the patched rows —
            # the same zero-init + sequential subtraction as the builder
            T[-1, :] = 0.0
            T[-1, self.n_sx:self.n_sx + self.n_art] = 1.0
            for i in self.need_art:
                T[-1] -= T[i]
        p.T = T
        p.basis = self.basis0.copy()
        p.n, p.n_sx, p.n_art, p.m = self.n, self.n_sx, self.n_art, self.m
        return p

    def lazy(self, row: int, value: float) -> "_LazyProb":
        """An instance that defers the tableau copy to the batch stacker:
        ``_solve_group`` writes the shared T0 into the stack and applies
        the RHS patch + phase-1 re-pricing there (op-identical to
        ``instantiate``), skipping one full per-candidate copy."""
        if (value < 0) != (self.flip_sign[row] < 0):
            raise ValueError(
                "RHS patch changes the row's sign; rebuild, don't patch"
            )
        return _LazyProb(self, row, value)

    def lazy_rhs(self, b: np.ndarray, c: np.ndarray) -> "_LazyProbRHS":
        """A deferred instance patching the WHOLE RHS column and carrying
        its own objective: the form used by the content-addressed subset
        template cache (``cover_packing.TemplateCache``), where one
        template — built from a placeholder RHS with the instance sign
        pattern — serves every (slot, machine-subset) with the same
        constraint matrix and only ``(c, b)`` vary per instance.
        ``_solve_group`` writes the flipped cells as ``b * -1.0`` (the
        exact op the builder's row flip applies) and re-prices phase 1
        with the same sequential subtraction, so the stacked tableau is
        bit-identical to ``_build_tableau_ub(c, A_ub, b)``."""
        b = np.asarray(b, dtype=np.float64)
        if ((b < 0) != (self.flip_sign < 0)).any():
            raise ValueError(
                "RHS patch changes a row's sign; rebuild, don't patch"
            )
        return _LazyProbRHS(self, b, np.asarray(c, dtype=np.float64))


class _LazyProb:
    """A (template, RHS patch) pair quacking like ``_Prob`` for the
    batch solver's grouping and extraction."""

    __slots__ = ("tmpl", "row", "value")

    def __init__(self, tmpl: TableauTemplate, row: int, value: float):
        self.tmpl = tmpl
        self.row = row
        self.value = value

    @property
    def c(self):
        return self.tmpl.c

    @property
    def n(self):
        return self.tmpl.n

    @property
    def n_sx(self):
        return self.tmpl.n_sx

    @property
    def n_art(self):
        return self.tmpl.n_art

    @property
    def m(self):
        return self.tmpl.m

    @property
    def T(self):
        return self.tmpl.T0

    @property
    def basis(self):
        return self.tmpl.basis0


class _LazyProbRHS:
    """A (template, full-RHS patch, objective) triple quacking like
    ``_Prob``: the instantiation unit of the shared subset-template
    cache (see ``TableauTemplate.lazy_rhs``).  Unlike ``_LazyProb`` it
    owns its ``c`` — the cached template is price-free."""

    __slots__ = ("tmpl", "b", "c")

    def __init__(self, tmpl: TableauTemplate, b: np.ndarray, c: np.ndarray):
        self.tmpl = tmpl
        self.b = b
        self.c = c

    @property
    def n(self):
        return self.tmpl.n

    @property
    def n_sx(self):
        return self.tmpl.n_sx

    @property
    def n_art(self):
        return self.tmpl.n_art

    @property
    def m(self):
        return self.tmpl.m

    @property
    def T(self):
        return self.tmpl.T0

    @property
    def basis(self):
        return self.tmpl.basis0


def _pivot_rows(CON: np.ndarray, m: int, row: int, col: int) -> None:
    """The drive-artificials-out pivot on a padded constraint block:
    row-for-row the scalar ``_pivot`` over the m constraint rows (the
    phase-1 objective row is skipped — phase 2 rebuilds it from scratch,
    so its post-drive-out value is never read)."""
    CON[row] /= CON[row, col]
    for i in range(m):
        if i != row and abs(CON[i, col]) > 1e-12:
            CON[i] -= CON[i, col] * CON[row]


def _core_single(CON: np.ndarray, OBJ: np.ndarray, basis: np.ndarray,
                 m: int, n_total: int, budget: int) -> str:
    """Scalar-trajectory pivot loop on one problem's (CON, OBJ) views —
    the straggler fallback once a batch is down to a few active
    problems. Identical scan/ratio/update ops as ``_simplex_core``,
    including its sparse/dense update split (see the module
    docstring)."""
    ncol = OBJ.size - 1
    for _ in range(budget):
        negmask = OBJ[:n_total] < -1e-9
        if not negmask.any():
            return "optimal"
        col = int(negmask.argmax())
        colvals = CON[:m, col]
        mask = colvals > 1e-10
        if not mask.any():
            return "unbounded"
        ratios = np.where(mask, CON[:m, ncol], np.inf)
        np.divide(ratios, colvals, out=ratios, where=mask)
        rmin = ratios.min()
        cand = np.flatnonzero(ratios <= rmin + 1e-12)
        if cand.size == 1:
            row = int(cand[0])
        else:
            rows = np.flatnonzero(mask)
            row = _ratio_test_replay(basis, rows, ratios[rows])
        CON[row] /= CON[row, col]
        colv = CON[:m, col].copy()
        colv[row] = 0.0
        np.place(colv, np.abs(colv) <= 1e-12, 0.0)
        nz = np.flatnonzero(colv)
        if nz.size * 3 < m:
            CON[nz] -= colv[nz, None] * CON[row][None, :]
        else:
            CON[:m] -= colv[:, None] * CON[row][None, :]
        oc = OBJ[col]
        if abs(oc) > 1e-12:
            OBJ -= oc * CON[row]
        basis[row] = col
        _pivot_tally[0] += 1
    return "maxiter"


def _core_batch(CON: np.ndarray, OBJ: np.ndarray, basis: np.ndarray,
                ntot: int, act: np.ndarray, status: np.ndarray,
                max_iter: int) -> None:
    """One phase of the stacked-tableau pivot loop over a SHAPE-UNIFORM
    group (every problem shares (m, n_total), so the stack carries no
    padding and no per-problem masks — the entering-column scan is a
    plain slice and the pivot update touches exactly each problem's own
    cells).

    CON (B, m, w): constraint rows, RHS in the last column; OBJ (B, w):
    objective rows; ``ntot``: scan width (dropped-artificial columns are
    excluded by the slice, exactly as the scalar solver excludes them by
    physically dropping — pivot updates are column-local, so stale
    artificial-column values never feed back into kept columns, the ratio
    test, or the RHS). Each iteration advances every active problem by
    one scalar-identical pivot; problems leave ``act`` as they hit
    optimal/unbounded/maxiter at their own pivot counts (ragged
    termination), and a lone straggler drops to the single-problem loop.
    """
    B, m, w = CON.shape
    ncol = w - 1
    act = np.asarray(act, dtype=np.int64)
    # every active problem pivots on every loop pass, so one scalar
    # counter IS each problem's own pivot count for this phase
    it = 0
    while act.size:
        if act.size <= 3:
            # short tail: running the stragglers to completion one at a
            # time costs fewer array ops than batch-stepping them in
            # lockstep (their trajectories are independent either way)
            for b in act:
                b = int(b)
                status[b] = _core_single(
                    CON[b], OBJ[b], basis[b], m, ntot, max_iter - it,
                )
            return
        # entering column: Bland smallest-index negative reduced cost
        neg = OBJ[act, :ntot] < -1e-9
        hasneg = neg.any(axis=1)
        if not hasneg.all():
            for b in act[~hasneg]:
                status[b] = "optimal"
            act = act[hasneg]
            if not act.size:
                return
            if act.size == 1:
                continue
            neg = neg[hasneg]
        col = neg.argmax(axis=1)                           # (k,)
        cv = CON[act, :, col]                              # (k, m)
        mask = cv > 1e-10
        hasrow = mask.any(axis=1)
        if not hasrow.all():
            for b in act[~hasrow]:
                status[b] = "unbounded"
            act, col, cv, mask = (act[hasrow], col[hasrow], cv[hasrow],
                                  mask[hasrow])
            if not act.size:
                return
        k = act.size
        rhs = CON[act, :, ncol]                            # (k, m)
        ratios = np.where(mask, rhs, np.inf)
        np.divide(ratios, cv, out=ratios, where=mask)
        rmin = ratios.min(axis=1)
        cand = ratios <= (rmin + 1e-12)[:, None]
        row = cand.argmax(axis=1)                          # unique-cand fast path
        multi = cand.sum(axis=1) > 1
        if multi.any():
            for i in np.flatnonzero(multi):
                rows = np.flatnonzero(mask[i])
                row[i] = _ratio_test_replay(basis[act[i]], rows,
                                            ratios[i, rows])
        # pivot: rows with |coef| <= 1e-12 are zeroed exactly like the
        # scalar solver, then the update touches ONLY the nonzero
        # (problem, row) pairs — degenerate tableaus keep most column
        # entries at zero (and padded rows are always zero), so the
        # sparse scatter moves ~4x less memory than the dense outer
        # product; both forms are the scalar solver's own two
        # bit-equivalent update paths
        ar = np.arange(k)
        piv = cv[ar, row]                                  # pre-normalize col
        prow = CON[act, row] / piv[:, None]                # (k, w)
        CON[act, row] = prow
        colv = cv
        colv[ar, row] = 0.0
        colv[np.abs(colv) <= 1e-12] = 0.0
        pi, ri = np.nonzero(colv)
        if pi.size * 3 < k * m:
            api = act[pi]
            CON[api, ri] -= colv[pi, ri, None] * prow[pi]
        else:
            CON[act] -= colv[:, :, None] * prow[:, None, :]
        ocoef = OBJ[act, col]
        ocoef[np.abs(ocoef) <= 1e-12] = 0.0
        OBJ[act] -= ocoef[:, None] * prow
        basis[act, row] = col
        it += 1
        _pivot_tally[0] += k
        if it >= max_iter:
            for b in act:
                status[b] = "maxiter"
            return


def _solve_group(probs: List[_Prob], max_iter: int) -> List[LPResult]:
    """Solve one bucket of near-shape problems as a single padded stack.

    Problems are embedded into the bucket's max dimensions with
    trajectory-neutral padding:

      * column layout per problem:
        ``[struct | dummy | slacks | dummy | artificials | dummy | RHS]``
        — dummy columns are identically zero everywhere (objective
        included), so they can never carry a negative reduced cost and
        never enter; pivot updates are column-local, so they stay zero.
        The embedding map is strictly increasing and keeps the
        struct < slack < artificial class order, so Bland's
        smallest-index scans and the basis-index tie-breaks make exactly
        the decisions the unpadded layout makes.
      * dummy rows are all-zero with RHS 0 and a sentinel basis index
        past every real column: their pivot-column entries are 0, so the
        ratio test never selects them, and extraction masks them out.

    Each problem's pivot trajectory is therefore identical to its own
    ``linprog`` run, while the stack amortizes the per-pivot Python
    dispatch across the whole bucket."""
    B = len(probs)
    n_max = max(p.n for p in probs)
    mub_max = max(p.n_sx - p.n for p in probs)
    nart_max = max(p.n_art for p in probs)
    m_max = max(p.m for p in probs)
    art_start = n_max + mub_max
    ncol = art_start + nart_max          # total non-RHS columns
    width = ncol + 1
    sentinel = width                     # > every real column index

    CON = np.zeros((B, m_max, width))
    OBJ = np.zeros((B, width))
    basis = np.full((B, m_max), sentinel, dtype=np.int64)
    grids: dict = {}          # embedding index cache per exact shape
    for b, p in enumerate(probs):
        m_ub = p.n_sx - p.n
        nt = p.n_sx + p.n_art
        if p.n == n_max and m_ub == mub_max and p.n_art == nart_max:
            # max-shape member: the embedding is the identity — plain
            # slice writes, no index gymnastics
            CON[b, :p.m, :nt] = p.T[:p.m, :-1]
            CON[b, :p.m, -1] = p.T[:p.m, -1]
            OBJ[b, :nt] = p.T[-1, :-1]
            OBJ[b, -1] = p.T[-1, -1]
            basis[b, :p.m] = p.basis
        else:
            gk = (p.n, m_ub, p.n_art, p.m)
            hit = grids.get(gk)
            if hit is None:
                cm = np.concatenate([
                    np.arange(p.n),
                    n_max + np.arange(m_ub),
                    art_start + np.arange(p.n_art),
                ])
                hit = (cm, np.ix_(np.arange(p.m), cm))
                grids[gk] = hit
            cm, grid = hit
            CON[b][grid] = p.T[:p.m, :-1]
            CON[b, :p.m, -1] = p.T[:p.m, -1]
            OBJ[b, cm] = p.T[-1, :-1]
            OBJ[b, -1] = p.T[-1, -1]
            basis[b, :p.m] = cm[p.basis]
        if isinstance(p, _LazyProb):
            # deferred template patch: RHS cell + phase-1 re-pricing,
            # op-for-op TableauTemplate.instantiate on the padded rows
            # (dummy columns are zero on both sides of every subtraction)
            sign = p.tmpl.flip_sign[p.row]
            CON[b, p.row, -1] = p.value * -1.0 if sign < 0 else p.value
            if p.n_art:
                OBJ[b, :] = 0.0
                OBJ[b, art_start:art_start + p.n_art] = 1.0
                for i in p.tmpl.need_art:
                    OBJ[b] -= CON[b, i]
        elif isinstance(p, _LazyProbRHS):
            # full-RHS patch (shared subset template): flipped rows get
            # b * -1.0 — the very op the builder's row flip applies — and
            # phase 1 is re-priced with the same sequential subtraction,
            # so the stacked tableau is bit-identical to a fresh build
            CON[b, :p.m, -1] = np.where(
                p.tmpl.flip_sign < 0, p.b * -1.0, p.b
            )
            if p.n_art:
                OBJ[b, :] = 0.0
                OBJ[b, art_start:art_start + p.n_art] = 1.0
                for i in p.tmpl.need_art:
                    OBJ[b] -= CON[b, i]

    results: List[Optional[LPResult]] = [None] * B
    status = np.empty(B, dtype=object)
    status[:] = ""

    # ---- phase 1 (problems with artificials) ----
    ph1 = np.flatnonzero([p.n_art > 0 for p in probs])
    if ph1.size:
        _core_batch(CON, OBJ, basis, ncol, ph1, status, max_iter)
        for b in ph1:
            p = probs[b]
            if status[b] == "maxiter":
                results[b] = LPResult("maxiter", None, np.inf)
            elif status[b] != "optimal" or OBJ[b, -1] < -1e-7:
                results[b] = LPResult("infeasible", None, np.inf)
            else:
                # drive artificials out of the basis if possible (the
                # scalar cold path, replayed per problem; the dummy
                # columns are zero, so the first |a| > 1e-9 scan hits
                # the same real column the unpadded scan hits)
                for i in range(p.m):
                    if basis[b, i] >= art_start:
                        for j in range(art_start):
                            if abs(CON[b, i, j]) > 1e-9:
                                _pivot_rows(CON[b], p.m, i, j)
                                basis[b, i] = j
                                break
    # ---- phase 2 ----
    # artificial columns are excluded by the scan width (art_start),
    # exactly as the scalar solver excludes them by dropping: pivot
    # updates are column-local, so stale artificial values never feed
    # back into kept columns, the ratio test, or the RHS
    act2 = [b for b in range(B) if results[b] is None]
    for b in act2:
        p = probs[b]
        Ob = OBJ[b]
        Cb = CON[b]
        Ob[:] = 0.0
        Ob[:p.n] = p.c
        for i, j in enumerate(basis[b, :p.m].tolist()):
            if j < art_start and abs(Ob[j]) > 1e-12:
                Ob -= Ob[j] * Cb[i]
        status[b] = ""
    if act2:
        _core_batch(CON, OBJ, basis, art_start,
                    np.array(act2, dtype=np.int64), status, max_iter)
    for b in act2:
        p = probs[b]
        if status[b] == "unbounded":
            results[b] = LPResult("unbounded", None, -np.inf)
        elif status[b] == "maxiter":
            results[b] = LPResult("maxiter", None, np.inf)
        else:
            x = np.zeros(art_start)
            bs = basis[b]
            inb = bs < art_start
            x[bs[inb]] = CON[b, :, -1][inb]
            xs = x[:p.n]
            results[b] = LPResult("optimal", xs, float(p.c @ xs))
    return results  # type: ignore[return-value]


def linprog_batch(
    problems: Sequence[tuple],
    max_iter: int = 20000,
    chunk: int = 256,
) -> List[LPResult]:
    """Solve many independent LPs as stacked-tableau batches; returns one
    ``LPResult`` per input, in input order, each bit-trajectory-identical
    to ``linprog`` on that problem alone.

    ``problems``: sequence of ``(c, A_ub, b_ub)`` or
    ``(c, A_ub, b_ub, A_eq, b_eq)`` tuples (None entries allowed, as in
    ``linprog``). Problems are grouped by exact tableau shape
    (m, n, n_sx, n_art) — Algorithm 4's candidates collapse onto a
    handful of pruned-machine counts, so groups are large, carry ZERO
    padding, and need no per-problem masks; ``chunk`` caps a group's
    stack size to bound memory."""
    built = []
    for p in problems:
        c, A_ub, b_ub, A_eq, b_eq = (tuple(p) + (None,) * 5)[:5]
        built.append(_Prob(c, A_ub, b_ub, A_eq, b_eq))
    return linprog_batch_built(built, max_iter=max_iter, chunk=chunk)


def linprog_batch_built(
    built: List[_Prob],
    max_iter: int = 20000,
    chunk: int = 256,
) -> List[LPResult]:
    """``linprog_batch`` over pre-built tableaus: ``_Prob``s, or the
    deferred template instantiations ``_LazyProbRHS`` (the solve-plan
    layer's simplex-fallback path — full-RHS patches of the shared
    subset templates, see ``TableauTemplate.lazy_rhs``) and ``_LazyProb``
    (the single-RHS-cell variant, retained for direct callers and the
    lp test-suite's template coverage).

    Problems are bucketed by QUANTIZED shape (rows/cols rounded up to
    small multiples) and each bucket is solved as one padded stack — see
    ``_solve_group`` for why the padding is trajectory-neutral. Wider
    buckets amortize the per-pivot Python dispatch across more problems
    at a bounded (<~25%) padding overhead."""
    results: List[Optional[LPResult]] = [None] * len(built)
    groups: dict = {}
    for i, p in enumerate(built):
        key = ((p.m + 15) // 16, (p.n + 7) // 8,
               (p.n_sx - p.n + 15) // 16, (p.n_art + 3) // 4)
        groups.setdefault(key, []).append(i)
    for idx in groups.values():
        for lo in range(0, len(idx), chunk):
            sel = idx[lo:lo + chunk]
            out = _solve_group([built[i] for i in sel], max_iter)
            for i, r in zip(sel, out):
                results[i] = r
    return results  # type: ignore[return-value]
