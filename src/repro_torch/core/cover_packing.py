"""Structure-aware cover/packing solver for the Algorithm-4 subproblem LPs.

The external candidate of program (23) is a mixed packing/covering LP with
a very particular shape: per-(machine, resource) capacity packing rows
(24), the worker-cap packing row (25), the worker:PS ratio packing row
(Eq. 2), and exactly ONE covering row — the workload cover (26), the only
row with a negative RHS.  ``lp.linprog_batch`` solves these by stacking
general two-phase simplex tableaus; profiling the heavy-contention regime
(25x20x50@0.3) shows ~85-90% of those simplex runs never leave phase 1:
with a single artificial (the flipped cover row), Bland's smallest-index
rule degenerates into a *ratio-greedy fill* — workers and PSs are poured
machine-by-machine in index order until the cover row's artificial leaves
the basis — and the vertex it lands on is already phase-2 optimal because
the heavy-contention price surface is (near-)uniform across machines.
This is the closed form the primal-dual literature reaches analytically
(OASiS's dual-driven allocation, arXiv:1801.00936; the knapsack-style
decomposition of arXiv:2105.13855): the optimal basis of a one-cover/
many-packing LP is a greedy prefix of the machines plus one marginal
machine pinned by the cover row.

This module solves those instances WITHOUT building simplex tableaus,
while keeping every float bit-identical to the stacked-tableau solver
(and therefore to the frozen scalar core ``repro.core._reference``).
That is possible because of three exactness facts about the dense
tableau arithmetic (proofs in ``docs/SOLVER.md``, section "Why the
replay is exact"):

1. **The phase-1 objective row is exactly the negated cover row.**
   With one artificial, the builder prices out a single row:
   ``obj = e_art - cover``, so ``obj[c] = -cover[c]`` exactly (IEEE
   negation).  Every pivot update ``obj -= obj[e] * prow`` preserves
   this: ``obj[e] = -cover[e]`` makes the two updates sign-mirrored,
   and ``fl(x - y) = -fl(y - x)`` exactly.  The |coef| <= 1e-12 zeroing
   fires identically on both sides.  Hence Bland's entering column —
   smallest index with ``obj[c] < -1e-9`` — can be read off the cover
   row as the smallest index with ``cover[c] > 1e-9``, and phase-1
   infeasibility (``obj_rhs < -1e-7``) is ``cover_rhs > 1e-7``.
2. **Basic columns are exact unit vectors.** The pivot normalize gives
   ``x/x = 1`` exactly and the update gives ``a - a*1 = 0`` exactly, so
   a basic column never contaminates later arithmetic.
3. **A slack column stays an exact (signed) identity column until its
   own row first hosts a pivot.** Column ``sl_r`` only changes when a
   pivot row has a nonzero ``sl_r`` cell, and the first row to have one
   is row ``r`` itself.  So slack columns can be *lazily materialized*:
   the solver tracks only the slack columns of rows that have pivoted
   (one new column per pivot, bounded by the pivot count).  The one
   sign to respect: the builder's row flip negates the cover row's
   slack cell along with the rest of the row, so the cover row's slack
   column materializes as ``-e_cover``, every other as ``+e_r``.

Together these mean the whole phase-1 trajectory — entering scans, ratio
tests (with the scalar solver's Bland hysteresis replay on ties), pivot
updates — can be replayed on a compressed state of
``[struct columns | tracked slack columns | RHS]``, producing cells that
are bit-identical to the corresponding cells of the full dense tableau,
because every op is elementwise and sees identical operands.

When the cover row's artificial leaves the basis, the solver replays the
scalar pricing-out of the phase-2 objective (rows in ascending index
order; rows with slack basics contribute exactly zero and are skipped by
the same 1e-12 gate) and checks the phase-2 entering scan.  If no column
prices below -1e-9 — the common case — phase 2 performs ZERO pivots in
the dense solver too, so the replayed basis *is* the final basis and the
solution/objective are extracted with the dense solver's own ops.
Anything else — a phase-2 pivot, a slack column trying to enter during
phase 1, the drive-artificials-out cold path, artificial re-entry, or
more distinct pivot rows than the tracked-column arena holds — is
detected *during* the replay and the instance falls back to
``lp.linprog_batch_built`` untouched, so unsupported instances cost one
aborted replay and are solved by the very code path they would have used
before this module existed.  Decisions cannot drift: the fast path is
bit-exact and the slow path is the old solver.

Batch shape: instances are padded into one ``(B, m_max, width)`` stack
with the same trajectory-neutral embedding argument as
``lp._solve_group`` (all-zero dummy columns never enter; all-zero dummy
rows never pass the ratio test; sentinel basis indices lose every
tie-break), and all active instances advance one scalar-identical pivot
per iteration with ragged termination.

``TemplateCache`` hoists what little tableau construction remains: the
constraint matrix ``A`` of program (23) depends only on the job's
demand vectors, gamma, the batch cap, and the subset size — NOT on
which machines are in the subset (machines enter through prices ``c``
and free capacities ``b`` only) — so one cached template serves every
(job, slot, machine subset) with the same demand signature, across
plans and ledger versions, and instantiation patches the full RHS
column per instance (bit-identical to a fresh build; see
``lp.TableauTemplate.lazy_rhs``).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..obs import trace as _trace
from ..obs.metrics import get_registry, sync_template_cache
from .lp import (
    LPResult,
    TableauTemplate,
    _ratio_test_replay,
    consume_pivots,
    linprog_batch_built,
)

__all__ = [
    "CoverPackingLP",
    "TemplateCache",
    "detect_cover_packing",
    "solve_cover_packing_batch",
    "solve_lp_batch",
    "subset_template_cache",
]

_ARENA_CAP = 48                    # tracked slack columns per instance
_ARENA_INIT = 8                    # initial arena width (grows by doubling)
# Phase-1 pivot budget for the replay: accepted (zero-phase-2) instances
# terminate well under this (p99 ~ 21 pivots on the heavy-contention
# grid), while trajectories still running here are overwhelmingly the
# phase-2-bound ones that would fall back anyway — capping them saves the
# lockstep loop from dragging a shrinking straggler set through 70+
# iterations.  Capped instances fall back (exact), they are never
# mis-solved; instances whose budget `max_iter` is smaller still report
# "maxiter" at exactly the dense solver's pivot count.
_PH1_CAP = 32
_PH2_CAP = 32                      # same policy for the phase-2 continuation
_SENTINEL = np.int64(1) << 40      # basis marker for padded rows: larger
                                   # than every real column index, so it
                                   # loses every Bland basis tie-break


def detect_cover_packing(
    b_ub: np.ndarray,
    A_eq: Optional[np.ndarray] = None,
) -> Optional[int]:
    """Plan-time shape test: index of the single cover row, or None.

    The replay supports exactly the one-cover/many-packing shape: pure
    ``<=`` rows (no equalities) of which exactly ONE has a negative RHS
    (after the builder's sign flip that row carries the lone phase-1
    artificial).  Everything else — multiple negative rows, equality
    rows, empty programs — must take the general simplex."""
    if A_eq is not None and np.asarray(A_eq).size:
        return None
    b = np.asarray(b_ub, dtype=np.float64)
    if b.ndim != 1 or b.size == 0:
        return None
    neg = np.flatnonzero(b < 0)
    if neg.size != 1:
        return None
    return int(neg[0])


@dataclass
class CoverPackingLP:
    """One cover/packing instance in the solver's native, tableau-free
    form.  ``A_flip``/``b_base`` may be SHARED across instances (the
    solver never mutates them): within one machine subset the workload
    levels differ only in ``cover_value`` (the cover row's raw ``-W1``),
    and across subsets of equal size they differ only in ``c``/``b``.

    ``A_flip`` carries the cover row already sign-flipped (the exact
    ``row * -1.0`` the tableau builder applies); ``b_base``'s cover cell
    is a placeholder — the replay writes ``cover_value * -1.0`` over it,
    the same op ``lp._solve_group`` uses to patch a lazy template."""

    c: np.ndarray                  # (n,) objective (prices)
    A_flip: np.ndarray             # (m, n) rows, cover row pre-flipped
    b_base: np.ndarray             # (m,) RHS, cover cell ignored
    cover: int                     # cover row index
    cover_value: float             # raw RHS of the cover row (< 0)
    template: Optional[TableauTemplate] = None   # fallback tableau source
    #: False when the instance does NOT actually have the one-negative-row
    #: shape (e.g. a tolerance-committed ledger left a free-capacity cell
    #: epsilon-negative, giving the dense builder a SECOND artificial):
    #: the replay must never touch it — it goes straight to the general
    #: simplex via a fresh full build (shared templates bake the
    #: one-negative sign pattern and would reject the patch).
    shape_ok: bool = True

    @property
    def m(self) -> int:
        return self.A_flip.shape[0]

    @property
    def n(self) -> int:
        return self.A_flip.shape[1]

    @classmethod
    def from_ub(cls, c, A_ub, b_ub,
                template: Optional[TableauTemplate] = None,
                ) -> Optional["CoverPackingLP"]:
        """Wrap a raw ``(c, A_ub, b_ub)`` problem, or None if the shape
        doesn't match (the caller should send those to ``lp.linprog``)."""
        b = np.asarray(b_ub, dtype=np.float64)
        cover = detect_cover_packing(b)
        if cover is None:
            return None
        A = np.asarray(A_ub, dtype=np.float64)
        c = np.asarray(c, dtype=np.float64)
        if A.ndim != 2 or A.shape != (b.size, c.size) or c.size == 0:
            return None
        A_flip = A.copy()
        A_flip[cover] *= -1.0      # the builder's row flip, A part
        return cls(c=c, A_flip=A_flip, b_base=b, cover=cover,
                   cover_value=float(b[cover]), template=template)

    def materialize(self):
        """The instance as a pre-built tableau problem for
        ``lp.linprog_batch_built`` (the fallback path) — via the shared
        template when one is attached (a ``TableauTemplate`` or a
        ``SubsetTemplate`` cache entry that builds one lazily), else a
        fresh exact build."""
        b = self.b_base.copy()
        b[self.cover] = self.cover_value
        tmpl = self.template if self.shape_ok else None
        if tmpl is not None and not isinstance(tmpl, TableauTemplate):
            tmpl = tmpl.tableau()      # SubsetTemplate: lazy one-time build
        if tmpl is not None:
            return tmpl.lazy_rhs(b, self.c)
        A = self.A_flip.copy()
        A[self.cover] *= -1.0      # undo the pre-flip: builder reflips
        from .lp import _Prob
        return _Prob(self.c, A, b, None, None)


# ======================================================================
# The exact Bland replay
# ======================================================================
def _replay_group(
    probs: List[CoverPackingLP],
    results: List[Optional[LPResult]],
    out_index: List[int],
    max_iter: int,
) -> None:
    """Advance one near-shape bucket of instances through phase 1 in
    lockstep and certify the zero-pivot phase 2; fill
    ``results[out_index[b]]`` with an ``LPResult`` or leave it None to
    request fallback.  Every float op mirrors ``lp._core_batch`` /
    ``lp._solve_group`` cell-for-cell on the compressed
    ``[struct | tracked slacks | RHS]`` state — see the module docstring
    for why those cells are bit-identical to the dense tableau's.

    Instances are embedded into the bucket's (m_max, n_max) with the
    same trajectory-neutral padding ``lp._solve_group`` documents:
    dummy struct columns are identically zero (their cover-row cell is
    zero, so the entering scan never picks them), dummy rows are
    all-zero with sentinel basis indices (a zero pivot-column cell never
    passes the ratio test, and the sentinel loses every Bland
    tie-break), and padded cells of the pivot outer product subtract
    exact zeros.

    Bookkeeping mirrors the dense batch: all live instances advance one
    scalar-identical pivot per iteration (one loop pass == one pivot for
    every live instance, so the shared ``it`` counter IS each instance's
    own per-phase pivot count), instances leave the live set as they
    terminate (ragged), and the arrays are re-compacted to the live set
    once it shrinks past half capacity.  The tracked-slack arena starts
    narrow and doubles on demand (a pure width-growing copy — no cell
    changes value); an instance needing more than ``_ARENA_CAP`` distinct
    pivot rows falls back."""
    B = len(probs)
    m_a = np.array([p.m for p in probs], dtype=np.int64)
    n_a = np.array([p.n for p in probs], dtype=np.int64)
    cov_a = np.array([p.cover for p in probs], dtype=np.int64)
    m_max = int(m_a.max())
    n_max = int(n_a.max())
    K = min(_ARENA_INIT, m_max)
    W = n_max + K + 1              # [struct | arena | RHS]

    state = np.zeros((B, m_max, W))
    basis = np.full((B, m_max), _SENTINEL, dtype=np.int64)
    # instances of one machine subset alias the same (A_flip, b_base)
    # arrays — initialize whole subset slices with broadcast writes
    shared: dict = {}
    for b, p in enumerate(probs):
        shared.setdefault((id(p.A_flip), id(p.b_base)), []).append(b)
    for idx in shared.values():
        p0 = probs[idx[0]]
        ii = np.array(idx, dtype=np.int64)
        state[ii, :p0.m, :p0.n] = p0.A_flip
        state[ii, :p0.m, -1] = p0.b_base
        # the builder's RHS flip on the cover row, op-identical to the
        # lazy-template patch (value * -1.0)
        state[ii, p0.cover, -1] = np.array(
            [probs[int(b)].cover_value for b in ii]
        ) * -1.0
        basis[ii, :p0.m] = p0.n + np.arange(p0.m, dtype=np.int64)
        basis[ii, p0.cover] = p0.n + p0.m      # the lone artificial
    tracked = np.zeros((B, m_max), dtype=bool)
    cnt = np.zeros(B, dtype=np.int64)
    arena_row = np.full((B, K), -1, dtype=np.int64)   # arena col -> row
    # live bookkeeping: arrays hold `cap` slots of which `live` are still
    # pivoting and `ph2` await the phase-2 gate (their state is final but
    # still needed); `orig` maps array slots back to group positions.
    # Slots that are neither (terminal or fallback) are dropped at the
    # next compaction.
    orig = np.arange(B, dtype=np.int64)
    live = np.ones(B, dtype=bool)
    ph2 = np.zeros(B, dtype=bool)
    it = 0
    while live.any():
        if (live | ph2).sum() * 2 <= orig.size:
            keepers = live | ph2
            state = state[keepers]
            basis = basis[keepers]
            tracked = tracked[keepers]
            cnt = cnt[keepers]
            arena_row = arena_row[keepers]
            orig = orig[keepers]
            live = live[keepers]
            ph2 = ph2[keepers]
            # m_a / n_a / cov_a stay group-indexed: reads go through orig
        act = np.flatnonzero(live)

        # ---- entering column: Bland via the obj = -cover invariant ----
        covrow = cov_a[orig[act]]
        covS = state[act, covrow, :n_max]                  # (k, n_max)
        cand = covS > 1e-9
        has = cand.any(axis=1)
        if not has.all():
            for b in act[~has]:
                b = int(b)
                g = int(orig[b])
                kc = int(cnt[b])
                if not (kc and (state[b, cov_a[g],
                                      n_max:n_max + kc] > 1e-9).any()):
                    # (a tracked slack would enter: unsupported, fall
                    # back by leaving the result None)
                    if -state[b, cov_a[g], -1] < -1e-7:
                        results[out_index[g]] = LPResult(
                            "infeasible", None, np.inf)
                    # else: artificial basic at ~0 — the dense solver's
                    # drive-out cold path; leave None (fallback)
                live[b] = False
            act = act[has]
            if not act.size:
                continue
            cand = cand[has]
            covrow = covrow[has]
        e = cand.argmax(axis=1)                            # (k,)
        colv = state[act, :, e]                            # (k, m_max)
        mask = colv > 1e-10
        # the cover row itself has colv = cover[e] > 1e-9 > 1e-10, so
        # phase 1 can never be ratio-unbounded here; keep the dense
        # solver's mapping anyway (phase-1 non-optimal => infeasible)
        hasrow = mask.any(axis=1)
        if not hasrow.all():
            for b in act[~hasrow]:
                results[out_index[orig[int(b)]]] = LPResult(
                    "infeasible", None, np.inf)
                live[int(b)] = False
            act, e, colv, mask, covrow = (
                act[hasrow], e[hasrow], colv[hasrow], mask[hasrow],
                covrow[hasrow],
            )
            if not act.size:
                continue
        k = act.size
        rhs = state[act, :, -1]
        ratios = np.where(mask, rhs, np.inf)
        np.divide(ratios, colv, out=ratios, where=mask)
        rmin = ratios.min(axis=1)
        cand2 = ratios <= (rmin + 1e-12)[:, None]
        row = cand2.argmax(axis=1)
        multi = cand2.sum(axis=1) > 1
        if multi.any():
            for i in np.flatnonzero(multi):
                rows = np.flatnonzero(mask[i])
                row[i] = _ratio_test_replay(basis[act[i]], rows,
                                            ratios[i, rows])

        # ---- lazy slack-column materialization (pre-pivot) ------------
        nt = ~tracked[act, row]
        if nt.any():
            need = int(cnt[act[nt]].max()) + 1
            while need > K and K < min(_ARENA_CAP, m_max):
                grow = min(max(K * 2, _ARENA_INIT), _ARENA_CAP, m_max)
                pad = np.zeros((state.shape[0], m_max, grow - K))
                state = np.concatenate(
                    [state[:, :, :n_max + K], pad, state[:, :, -1:]],
                    axis=2,
                )
                arena_row = np.concatenate([
                    arena_row,
                    np.full((arena_row.shape[0], grow - K), -1,
                            dtype=np.int64),
                ], axis=1)
                K = grow
                W = n_max + K + 1
            over = nt & (cnt[act] >= K)
            if over.any():         # arena at cap: fallback before pivoting
                live[act[over]] = False
                keep = ~over
                act, e, colv, row, nt, covrow = (
                    act[keep], e[keep], colv[keep], row[keep], nt[keep],
                    covrow[keep],
                )
                k = act.size
                if not k:
                    continue
            sub, rsub = act[nt], row[nt]
            csub = cnt[sub]
            state[sub, :, n_max + csub] = 0.0
            # the untouched slack column is an exact identity column —
            # EXCEPT the cover row's own: the builder's row flip negated
            # its slack cell, so that column starts as -e_cover
            state[sub, rsub, n_max + csub] = np.where(
                rsub == cov_a[orig[sub]], -1.0, 1.0
            )
            arena_row[sub, csub] = rsub
            tracked[sub, rsub] = True
            cnt[sub] += 1

        # ---- the pivot, cell-for-cell lp._core_batch ------------------
        ar = np.arange(k)
        piv = colv[ar, row]
        artlv = row == covrow
        if artlv.any():
            pre = state[act[artlv], row[artlv], :n_max + K].copy()
        prow = state[act, row] / piv[:, None]
        state[act, row] = prow
        cv = colv
        cv[ar, row] = 0.0
        cv[np.abs(cv) <= 1e-12] = 0.0
        # the dense solver's sparse/dense update forms are documented
        # bit-equivalent (sign-of-zero only), so the replay is free to
        # pick by ITS cost model: the compressed rows are narrow, making
        # the row-scatter win until the column is nearly dense
        pi, ri = np.nonzero(cv)
        if pi.size * 3 < 2 * k * m_max:
            api = act[pi]
            state[api, ri] -= cv[pi, ri, None] * prow[pi]
        elif k == state.shape[0]:
            # all slots live: in-place, no gather/scatter round trip
            state -= cv[:, :, None] * prow[:, None, :]
        else:
            state[act] -= cv[:, :, None] * prow[:, None, :]
        basis[act, row] = e
        it += 1

        if it >= max_iter:
            # the dense batch marks EVERY still-active problem maxiter
            # after the budget-exhausting pivot — including one whose
            # artificial just left (it only leaves the active set at the
            # NEXT iteration's scan), so the art-leaving instances get
            # maxiter here too, never a phase-2 pass
            for b in act:
                results[out_index[orig[int(b)]]] = LPResult(
                    "maxiter", None, np.inf)
            live[act] = False
            break
        if artlv.any():
            # artificial left: replay the exact post-pivot phase-1
            # objective (obj_pre = -cover_pre; ocoef = obj_pre[e] = -piv,
            # never inside the 1e-12 zeroing since piv > 1e-10) and check
            # the dense solver's termination scan.  Untracked slack cells
            # are exactly -ocoef * 0 = +-0, never < -1e-9.
            ids = np.flatnonzero(artlv)
            ocoef = -piv[ids]
            o1 = np.negative(pre) - ocoef[:, None] * prow[ids, :n_max + K]
            bad = (o1 < -1e-9).any(axis=1)
            left = act[ids]
            ph2[left[~bad]] = True
            # bad: phase 1 continues past the artificial — fallback
            live[left] = False
        if it >= _PH1_CAP:
            # replay budget (not the solver's): leave None -> fallback
            get_registry().counter(
                "repro_lp_replay_budget_exhausted_total",
                "replay groups that hit the _PH1/_PH2 pivot budget",
            ).inc()
            break

    _trace.add("ph1_pivots", int(it))
    if not ph2.any():
        return
    # ---- phase-2 rebuild + zero-pivot certificate ---------------------
    # Replay of lp._solve_group's pricing-out: obj2 starts [c | 0]; rows
    # are processed in ascending index order; rows whose basic variable
    # is a slack contribute exactly zero (their obj2 cell is exactly 0 —
    # untouched slack columns are exact identity columns) and are skipped
    # by the same |coef| > 1e-12 gate, so only tracked (pivoted) rows
    # subtract.  obj2[basis_i] reads c[basis_i] exactly (basic columns
    # are exact unit vectors), so batching instances per row-rank is
    # order-safe; the per-instance subtraction ORDER (ascending row)
    # matches the scalar loop.
    done = np.flatnonzero(ph2)
    D = done.size
    o2 = np.zeros((D, n_max + K))
    byc: dict = {}
    for i, b in enumerate(done):
        byc.setdefault(id(probs[int(orig[b])].c), []).append(i)
    for idx in byc.values():
        g0 = int(orig[done[idx[0]]])
        o2[np.array(idx, dtype=np.int64), :n_a[g0]] = probs[g0].c
    P_max = int(cnt[done].max()) if D else 0
    rowmat = np.full((D, P_max), -1, dtype=np.int64)
    # np.nonzero enumerates (instance, row) pairs row-ascending within
    # each instance — exactly the per-instance flatnonzero order
    ti, tr = np.nonzero(tracked[done])
    counts = cnt[done]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rowmat[ti, np.arange(ti.size) - starts[ti]] = tr
    di = np.arange(D)
    for p in range(P_max):
        rp = rowmat[:, p]
        valid = rp >= 0
        if not valid.any():
            break
        sel = di[valid]
        rb = rp[valid]
        bj = basis[done[sel], rb]                  # struct columns only
        oj = o2[sel, bj]
        use = np.abs(oj) > 1e-12
        if use.any():
            s2, r2 = sel[use], rb[use]
            o2[s2] -= oj[use, None] * state[done[s2], r2, :n_max + K]
    good = ~(o2 < -1e-9).any(axis=1)

    # ---- extraction (the dense solver's own ops, batched scatter) -----
    gi = np.flatnonzero(good)
    if gi.size:
        gslots = done[gi]
        bsg = basis[gslots]                        # (G, m_max)
        rhsg = state[gslots, :, -1]
        artcol = (n_a + m_a)[orig[gslots]]
        inb = bsg < artcol[:, None]                # sentinel/art excluded
        xfull = np.zeros((gi.size, n_max + m_max))
        rr, cc2 = np.nonzero(inb)
        xfull[rr, bsg[rr, cc2]] = rhsg[rr, cc2]
        for a, b in enumerate(gslots):
            g = int(orig[b])
            p = probs[g]
            xs = xfull[a, :p.n]
            results[out_index[g]] = LPResult(
                "optimal", xs, float(p.c @ xs))
    # not good: phase 2 pivots — continue the replay through them
    rest = np.flatnonzero(~good)
    if rest.size:
        _replay_phase2(
            probs, results, out_index, orig, n_a, cov_a, state, basis,
            tracked, cnt, arena_row, K, n_max, m_max, done[rest],
            o2[rest], max_iter,
        )


def _extract(p: CoverPackingLP, basis_b: np.ndarray,
             state_b: np.ndarray) -> LPResult:
    """Solution extraction with the dense solver's own ops: scatter the
    RHS of rows whose basic variable is real (the artificial and padded
    sentinels excluded), slice the struct prefix, dot the objective."""
    bs = basis_b[:p.m]
    x = np.zeros(p.n + p.m)
    inb = bs < p.n + p.m
    x[bs[inb]] = state_b[:p.m, -1][inb]
    xs = x[:p.n]
    return LPResult("optimal", xs, float(p.c @ xs))


def _replay_phase2(
    probs: List[CoverPackingLP],
    results: List[Optional[LPResult]],
    out_index: List[int],
    orig: np.ndarray,
    n_a: np.ndarray,
    cov_a: np.ndarray,
    state: np.ndarray,
    basis: np.ndarray,
    tracked: np.ndarray,
    cnt: np.ndarray,
    arena_row: np.ndarray,
    K: int,
    n_max: int,
    m_max: int,
    slots: np.ndarray,
    obj2: np.ndarray,
    max_iter: int,
) -> None:
    """Continue the exact replay through phase-2 pivots for instances
    whose zero-pivot certificate found negative reduced costs.

    The machinery is the phase-1 loop's with one change: the reduced
    costs are the explicit ``obj2`` rows (rebuilt by the certificate
    pass with the scalar pricing-out's own op order) maintained through
    every pivot with the dense solver's update, instead of the
    obj = -cover invariant.  Slack columns may now ENTER: a tracked
    arena column's values are exact tableau cells, and an untracked
    slack's reduced cost is exactly zero (its column is an exact
    identity column), so Bland's smallest-original-index scan is
    complete — struct indices precede every slack index, and among
    negative arena cells the smallest original index (n + row) wins.
    Everything else is unchanged: ratio test with hysteresis replay,
    sparse/dense update split, lazy arena materialization, per-phase
    pivot budget (phase 2 gets a fresh ``max_iter`` in the dense solver
    too).  Trajectories that exhaust the replay budget ``_PH2_CAP``
    leave their result None — the caller re-solves them from scratch on
    the dense path, so nothing is ever half-solved."""
    L = slots.size
    live = np.ones(L, dtype=bool)
    it = 0
    while live.any():
        act = np.flatnonzero(live)
        sl = slots[act]
        neg = obj2[act] < -1e-9                    # (k, n_max + K)
        hasneg = neg.any(axis=1)
        if not hasneg.all():
            for li in act[~hasneg]:
                b = int(slots[li])
                g = int(orig[b])
                results[out_index[g]] = _extract(probs[g], basis[b],
                                                 state[b])
                live[li] = False
            act = act[hasneg]
            if not act.size:
                continue
            neg = neg[hasneg]
            sl = slots[act]
        # entering: struct columns carry the smallest original indices;
        # among arena columns the smallest n + row wins
        negs = neg[:, :n_max]
        has_s = negs.any(axis=1)
        e_struct = negs.argmax(axis=1)
        arow = arena_row[sl]                       # (k, K)
        aorig = np.where(neg[:, n_max:n_max + K] & (arow >= 0),
                         n_a[orig[sl]][:, None] + arow, _SENTINEL)
        apos = aorig.argmin(axis=1)
        colpos = np.where(has_s, e_struct, n_max + apos)
        colorig = np.where(
            has_s, e_struct,
            np.take_along_axis(aorig, apos[:, None], 1)[:, 0],
        )
        colv = state[sl, :, colpos]                # (k, m_max)
        mask = colv > 1e-10
        hasrow = mask.any(axis=1)
        if not hasrow.all():
            for li in act[~hasrow]:
                g = int(orig[slots[li]])
                results[out_index[g]] = LPResult("unbounded", None,
                                                 -np.inf)
                live[li] = False
            keep = hasrow
            act, sl, colv, mask, colpos, colorig = (
                act[keep], sl[keep], colv[keep], mask[keep],
                colpos[keep], colorig[keep],
            )
            if not act.size:
                continue
        k = act.size
        rhs = state[sl, :, -1]
        ratios = np.where(mask, rhs, np.inf)
        np.divide(ratios, colv, out=ratios, where=mask)
        rmin = ratios.min(axis=1)
        cand2 = ratios <= (rmin + 1e-12)[:, None]
        row = cand2.argmax(axis=1)
        multi = cand2.sum(axis=1) > 1
        if multi.any():
            for i in np.flatnonzero(multi):
                rows = np.flatnonzero(mask[i])
                row[i] = _ratio_test_replay(basis[sl[i]], rows,
                                            ratios[i, rows])
        # lazy slack materialization (pre-pivot), as in phase 1
        nt = ~tracked[sl, row]
        if nt.any():
            need = int(cnt[sl[nt]].max()) + 1
            while need > K and K < min(_ARENA_CAP, m_max):
                grow = min(max(K * 2, _ARENA_INIT), _ARENA_CAP, m_max)
                pad = np.zeros((state.shape[0], m_max, grow - K))
                state = np.concatenate(
                    [state[:, :, :n_max + K], pad, state[:, :, -1:]],
                    axis=2,
                )
                arena_row = np.concatenate([
                    arena_row,
                    np.full((arena_row.shape[0], grow - K), -1,
                            dtype=np.int64),
                ], axis=1)
                obj2 = np.concatenate([
                    obj2, np.zeros((L, grow - K)),
                ], axis=1)
                K = grow
            over = nt & (cnt[sl] >= K)
            if over.any():         # arena at cap: fallback before pivoting
                live[act[over]] = False
                keep = ~over
                act, sl, colv, row, nt, colpos, colorig = (
                    act[keep], sl[keep], colv[keep], row[keep], nt[keep],
                    colpos[keep], colorig[keep],
                )
                k = act.size
                if not k:
                    continue
            sub, rsub = sl[nt], row[nt]
            csub = cnt[sub]
            state[sub, :, n_max + csub] = 0.0
            # -e_cover for the cover row's flipped slack (see phase 1)
            state[sub, rsub, n_max + csub] = np.where(
                rsub == cov_a[orig[sub]], -1.0, 1.0
            )
            arena_row[sub, csub] = rsub
            tracked[sub, rsub] = True
            cnt[sub] += 1

        ar = np.arange(k)
        piv = colv[ar, row]
        prow = state[sl, row] / piv[:, None]
        state[sl, row] = prow
        cv = colv
        cv[ar, row] = 0.0
        cv[np.abs(cv) <= 1e-12] = 0.0
        pi, ri = np.nonzero(cv)
        if pi.size * 3 < k * m_max:
            api = sl[pi]
            state[api, ri] -= cv[pi, ri, None] * prow[pi]
        else:
            state[sl] -= cv[:, :, None] * prow[:, None, :]
        # (phase-2 sets are small; the all-live in-place variant of the
        # phase-1 loop is not worth a second branch here)
        # the dense solver's objective-row update (zeroed small coefs)
        ocoef = obj2[act, colpos].copy()
        ocoef[np.abs(ocoef) <= 1e-12] = 0.0
        obj2[act] -= ocoef[:, None] * prow[:, :n_max + K]
        basis[sl, row] = colorig
        it += 1
        if it >= max_iter:
            for li in np.flatnonzero(live):
                g = int(orig[slots[li]])
                results[out_index[g]] = LPResult("maxiter", None, np.inf)
            break
        if it >= _PH2_CAP:
            # replay budget (not the solver's): leave None -> fallback
            get_registry().counter(
                "repro_lp_replay_budget_exhausted_total",
                "replay groups that hit the _PH1/_PH2 pivot budget",
            ).inc()
            break
    _trace.add("ph2_pivots", int(it))


def solve_cover_packing_batch(
    probs: Sequence[CoverPackingLP],
    max_iter: int = 20000,
    chunk: int = 1024,
) -> List[Optional[LPResult]]:
    """Solve a batch of cover/packing instances by exact Bland replay.

    Instances are bucketed by quantized shape, but buckets too small to
    amortize the per-pivot Python dispatch are coalesced into one mixed
    stack — at per-plan batch sizes (tens of LPs) the replay is
    dispatch-bound and one wide group wins, while a cross-job stack of
    hundreds is flop-bound and tight padding wins.  Both embeddings are
    trajectory-neutral (see ``_replay_group``).  Returns one entry per
    instance: an ``LPResult`` bit-identical to what ``lp.linprog_batch``
    would produce (same status, same solution floats up to the sign of
    zero, same objective), or ``None`` when the instance's trajectory
    left the replayable class and the caller must fall back to the
    stacked-tableau simplex."""
    results: List[Optional[LPResult]] = [None] * len(probs)
    groups: dict = {}
    for i, p in enumerate(probs):
        if not p.shape_ok:
            continue               # not the shape: stays None -> fallback
        groups.setdefault(((p.m + 15) // 16, (p.n + 7) // 8), []).append(i)
    mixed: List[int] = []
    batches: List[List[int]] = []
    for idx in groups.values():
        if len(idx) >= 48:
            batches.append(idx)
        else:
            mixed.extend(idx)
    if mixed:
        batches.append(mixed)
    for idx in batches:
        for lo in range(0, len(idx), chunk):
            sel = idx[lo:lo + chunk]
            _replay_group([probs[i] for i in sel], results, sel, max_iter)
    return results


def solve_lp_batch(
    probs: Sequence[CoverPackingLP],
    max_iter: int = 20000,
    force_simplex: bool = False,
) -> List[LPResult]:
    """The full structure-aware dispatch: replay every instance, then
    solve the fallbacks (and everything, when ``force_simplex`` — the
    parity/debug mode of ``SubproblemConfig.lp_solver="simplex"``) with
    ``lp.linprog_batch_built`` via their shared templates.  Output is
    positionally aligned with the input and bit-identical either way."""
    with _trace.span("lp.solve", n=len(probs),
                     force_simplex=force_simplex) as sp:
        if force_simplex:
            results: List[Optional[LPResult]] = [None] * len(probs)
        else:
            with _trace.span("lp.replay", n=len(probs)):
                results = solve_cover_packing_batch(probs, max_iter=max_iter)
        todo = [i for i, r in enumerate(results) if r is None]
        if todo:
            with _trace.span("lp.simplex", n=len(todo)) as ssp:
                built = [probs[i].materialize() for i in todo]
                out = linprog_batch_built(built, max_iter=max_iter)
                ssp.set(pivots=consume_pivots())
                for i, r in zip(todo, out):
                    results[i] = r
        # batch-granular instrument sync: hot loops above stay untouched
        reg = get_registry()
        reg.counter("repro_lp_replay_solved_total",
                    "instances solved by exact Bland replay").inc(
                        len(probs) - len(todo))
        if not force_simplex:
            reg.counter("repro_lp_simplex_fallback_total",
                        "instances that fell back to the stacked "
                        "simplex").inc(len(todo))
        sync_template_cache(subset_template_cache())
        sp.set(replay_solved=len(probs) - len(todo), fallback=len(todo))
    return results  # type: ignore[return-value]


# ======================================================================
# Shared subset-template cache
# ======================================================================
class TemplateCache:
    """Content-addressed LRU for the per-subset LP structure.

    The constraint matrix of program (23) is a pure function of
    ``(M, wdem[act], sdem[act], gamma, batch_size)`` — which machines
    are in the subset affects only prices and free capacities, i.e. the
    ``c`` and ``b`` vectors patched per instance.  Keying on that
    content means one entry serves every (job, slot, subset, plan,
    ledger version) with the same demand signature; nothing
    ledger-dependent is cached, so a version bump can never stale an
    entry (covered by ``tests/test_cover_packing.py``).

    Each entry lazily builds its ``TableauTemplate`` (placeholder RHS:
    +1 everywhere, -1 on the cover row — the sign pattern of every real
    instance) the first time some instance needs the simplex fallback;
    pure-replay workloads never build a tableau at all."""

    def __init__(self, maxsize: int = 256):
        self.maxsize = maxsize
        self._data: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def clear(self) -> None:
        self._data.clear()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key, build):
        """The cached entry for ``key``, calling ``build()`` on a miss."""
        hit = self._data.get(key)
        if hit is not None:
            self.hits += 1
            self._data.move_to_end(key)
            return hit
        self.misses += 1
        entry = build()
        self._data[key] = entry
        if len(self._data) > self.maxsize:
            self._data.popitem(last=False)
        return entry


class SubsetTemplate:
    """One cache entry: the shared A matrix (cover row pre-flipped for
    the replay, raw for the tableau) + the lazily-built tableau template
    for the fallback path."""

    __slots__ = ("A", "A_flip", "cover", "n_cap", "_tableau")

    def __init__(self, A: np.ndarray, cover: int, n_cap: int):
        self.A = A
        self.cover = cover
        self.n_cap = n_cap
        self.A_flip = A.copy()
        self.A_flip[cover] *= -1.0
        self._tableau: Optional[TableauTemplate] = None

    def tableau(self) -> TableauTemplate:
        if self._tableau is None:
            m, n = self.A.shape
            b_ph = np.ones(m)
            b_ph[self.cover] = -1.0
            self._tableau = TableauTemplate(np.zeros(n), self.A, b_ph)
        return self._tableau


_subset_cache = TemplateCache(maxsize=256)


def subset_template_cache() -> TemplateCache:
    """The process-wide subset-template LRU shared across jobs, slots,
    and plans (see ``TemplateCache``)."""
    return _subset_cache
