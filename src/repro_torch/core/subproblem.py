"""Algorithm 4: solve theta(t, v) — the per-slot min-cost allocation
(Problem (19)) for training v samples of job i in slot t.

Two locality cases, per Fact 1:
  * internal — all workers + all PSs co-located on ONE machine; workload
    constraint uses b^(i).  Closed form + sort by co-located price.
  * external — workers/PSs spread; workload uses b^(e).  LP relaxation of
    the mixed cover/packing program (23) + randomized rounding (27)-(28).

Returns the cheaper feasible of the two (Algorithm 4, final step).

Implementation notes (beyond the paper, exactness preserved):
  * prices are frozen while one job is being scheduled (Algorithm 1 only
    reprices after admission), so per-(job, t) price vectors are computed
    once into a ``PriceSnapshot`` and reused across all workload levels v
    that Algorithm 3's DP probes;
  * the external LP is solved over a cost-pruned machine subset — the
    cheapest machines whose combined capacity covers 2x the worker (resp.
    PS) requirement; machines more expensive than that can never enter an
    optimal basis of this min-cost covering LP in practice;
  * every hot loop operates on whole machine vectors: the snapshot is built
    from the cluster's dense ledger + one cached price-matrix evaluation,
    the LP constraint matrix is written with strided assignments, and the
    repair passes (``_repair``/``_ensure_ratio``) compute per-machine unit
    head-room in closed form instead of unit-at-a-time ``while`` loops;
  * ``solve_theta_snapshot`` skips the external LP entirely when the
    internal candidate's cost provably lower-bounds every external
    allocation (see ``_external_dominated``) — decisions are unchanged
    because ties between the candidates already resolve internal-first;
  * the external path is split into rng-free phases (``_dominance_class``
    classification, ``_external_candidate`` pre-LP gates + rows,
    ``_external_finish`` post-LP rounding/repair) so the plan layer
    (``core.solve_plan``) can classify whole (t, v) grids
    vectorized and dispatch every surviving LP to the batched
    stacked-tableau simplex (``lp.linprog_batch``) in one call.

The pre-vectorization implementation survives verbatim in the JAX
package's ``repro.core._reference``, the parity oracle of the port's tests.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..obs import trace as _trace
from ..obs.metrics import get_registry
from .cluster import Cluster
from .job import Allocation, JobSpec
from .lp import linprog
from .pricing import PriceTable
from .rounding import (
    g_delta_cover,
    g_delta_packing,
    round_cover_packing_structured,
    round_until_feasible,
)


class SolverFault(RuntimeError):
    """The external-LP solve path failed (or was made to fail).

    Raised by ``SubproblemConfig.lp_fault_hook`` at an LP dispatch site to
    model a crashed/misbehaving solver. Lives in core (not ``repro.sim``)
    so the dispatch sites can raise it without a core -> sim import;
    ``repro.sim.faults`` injects it and ``ResilientPolicy`` contains it
    with a retry-then-fallback ladder."""


class SolverTimeout(SolverFault):
    """Deadline-shaped solver fault (the LP ran out of its pivot budget)."""


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
    # rounding-rng discipline:
    #   "compat"  — one sequential stream shared with the scheduler, kept
    #               bit-aligned with core/_reference.py via the burn
    #               accounting in _external_dominated (golden-parity mode);
    #   "derived" — each theta(t, v) evaluation draws from a fresh
    #               np.random.Generator seeded per (cfg.seed, job_id, t,
    #               units), so results are independent of evaluation order
    #               and no burn accounting is needed (the mode the
    #               event-driven simulator uses; see repro/sim).
    # THE COMPAT-BURN CONTRACT (load-bearing for every "compat" caller):
    # the reference consumes exactly ONE (rounding_rounds, 2M) uniform
    # block per external solve that reaches rounding, and nothing on any
    # earlier-returning path; every optimization that skips or reorders
    # solves must burn/draw precisely those blocks in the reference's
    # (t asc, v asc) evaluation order (_burn_rounding_block,
    # SolvePlan.resolve_into). If the rounding scheme itself ever changes
    # shape — different draw count, different block layout — this burn
    # accounting must be re-derived from the new scheme, or "compat"
    # retired; there is no partial credit, one desynced draw shifts every
    # later decision.
    rng_mode: str = "compat"
    # external-LP dispatch: None resolves via the cluster backend's
    # ArrayBackend.lp_solver_default() — "cover_packing" routes plan-time
    # shape-matched instances through the structure-aware exact-replay
    # solver (core.cover_packing; bit-identical results, simplex fallback
    # for trajectories it cannot certify), "simplex" forces every
    # instance through the stacked-tableau lp.linprog_batch path
    # (parity tests / debugging).
    lp_solver: Optional[str] = None
    # plan-then-solve pipeline (core.solve_plan): collect every pending
    # (t, v) candidate up front, build the per-machine decision vectors
    # for all slots in one fused (W, H) bundle pass, and dispatch the
    # surviving external candidates to the batched stacked-tableau
    # simplex (lp.linprog_batch). Decisions are bit-identical to the
    # per-(t, v) loop in both rng modes; False forces the loop (parity
    # tests / debugging).
    use_plan: bool = True
    # chaos-harness fault injection (repro.sim.faults): when set, the hook
    # is invoked with a context string ("lp" lazy per-candidate, "lp_batch"
    # plan-time batched dispatch) immediately before each external-LP
    # solve, and may raise SolverFault/SolverTimeout to simulate a solver
    # failure. None (the default) costs nothing and changes nothing.
    lp_fault_hook: Optional[Callable[[str], None]] = None


class PriceSnapshot:
    """Vectorized prices + free capacities for one (job, slot).

    ``free`` maps resource -> (H,) free-capacity vector; ``free_mat`` is the
    same data as an (H, R) matrix on the cluster's resource axis. The build
    slices the dense ledger and reuses the ledger-versioned cached price
    matrix; only the per-job combinations (worker/PS/co-located price
    vectors, per-machine unit capacities) are computed here, with the same
    per-resource accumulation order as the frozen reference so every float
    is bit-identical.

    The five per-machine decision vectors are reduced on the device from
    the version-cached price/free tensors (``ArrayBackend.snapshot_bundle``
    -> ``repro_torch.kernels.pricing``) and synced here — the snapshot
    build IS the admission-decision host sync point. The reduction is
    bit-identical to the reference's per-resource accumulation on equal
    inputs."""

    def __init__(self, job: JobSpec, cluster: Cluster, prices: PriceTable,
                 t: int, bundle: Optional[tuple] = None):
        H = cluster.num_machines
        self.t = t
        self.H = H
        self.resources = cluster.resources
        self.free_mat = cluster.free_matrix(t)          # (H, R), shared
        self.free: Dict[str, np.ndarray] = {
            r: self.free_mat[:, k] for k, r in enumerate(self.resources)
        }
        self.wdem, self.sdem = cluster.demand_vectors(job)
        if bundle is not None:
            # precomputed row of a fused multi-slot bundle pass
            # (ArrayBackend.snapshot_bundle_batch via core.solve_plan):
            # the same kernel arithmetic as the per-slot call below
            (self.wprice, self.sprice, self.coloc,
             self.max_w, self.max_s) = bundle
        else:
            # device operands stay on device; the bundle call is the sync
            price_op = prices.device_tensor()[t]
            free_op = cluster.device_free_tensor()[t]
            (self.wprice, self.sprice, self.coloc,
             self.max_w, self.max_s) = cluster.backend.snapshot_bundle(
                price_op, free_op, self.wdem, self.sdem, job.gamma,
            )
        self.job = job
        self._bundle_units: Optional[np.ndarray] = None
        self._worder: Optional[np.ndarray] = None
        self._sorder: Optional[np.ndarray] = None
        self._worder_desc: Optional[np.ndarray] = None
        self._wlb = None
        self._slb = None
        self._head_aux: Dict[str, tuple] = {}
        self._internal_cache: Dict[Tuple[int, int], Optional[ThetaResult]] = {}
        self._prune_aux: Optional[tuple] = None
        self._prune_cache: Dict[Tuple[int, int], tuple] = {}
        self._bound_cache: Dict[Tuple[int, int], float] = {}
        self._act: Optional[np.ndarray] = None
        self._free_act: Optional[np.ndarray] = None
    def precompute_internal(self, pairs) -> None:
        """Batch-solve the internal case for many (w_need, s_need) pairs in
        one (K, H, P) comparison — Algorithm 3 probes Q workload levels per
        slot, and evaluating their internal candidates together amortizes
        the per-call numpy overhead ~Q-fold. Element-wise the comparison,
        the masked-argmin machine choice, and the cost accumulation are the
        ones ``solve_theta_internal`` performs, so cached results are
        bit-identical to per-query evaluation."""
        todo = [p for p in dict.fromkeys(pairs)
                if p not in self._internal_cache]
        if not todo:
            return
        _trace.add("theta_internal_batch", len(todo))
        arr = np.array(todo, dtype=np.float64)            # (K, 2)
        wdem_a = self.wdem[self.act]
        sdem_a = self.sdem[self.act]
        need = (arr[:, :1] * wdem_a[None, :]
                + arr[:, 1:2] * sdem_a[None, :]) - 1e-9   # (K, P)
        ok = (self.free_act[None, :, :] >= need[:, None, :]).all(axis=2)
        masked = np.where(ok, self.coloc[None, :], np.inf)
        hs = masked.argmin(axis=1)
        feas = ok[np.arange(len(todo)), hs]
        for i, (w, s) in enumerate(todo):
            if not feas[i]:
                self._internal_cache[(w, s)] = None
                continue
            h = int(hs[i])
            alloc = Allocation(workers={h: w}, ps={h: s})
            c = 0.0
            c += self.wprice[h] * w
            c += self.sprice[h] * s
            self._internal_cache[(w, s)] = ThetaResult(
                cost=c, alloc=alloc, mode="internal"
            )

    @property
    def act(self) -> np.ndarray:
        """Indices of resources with nonzero worker or PS demand."""
        if self._act is None:
            self._act = np.flatnonzero((self.wdem != 0.0) | (self.sdem != 0.0))
        return self._act

    @property
    def free_act(self) -> np.ndarray:
        """(H, P) free capacity restricted to the active resources."""
        if self._free_act is None:
            self._free_act = self.free_mat[:, self.act]
        return self._free_act

    # ---- cached sort orders (argsort is stable, so caching is exact) ----
    @property
    def wprice_order(self) -> np.ndarray:
        if self._worder is None:
            self._worder = np.argsort(self.wprice, kind="stable")
        return self._worder

    @property
    def sprice_order(self) -> np.ndarray:
        if self._sorder is None:
            self._sorder = np.argsort(self.sprice, kind="stable")
        return self._sorder

    @property
    def wprice_order_desc(self) -> np.ndarray:
        if self._worder_desc is None:
            self._worder_desc = np.argsort(-self.wprice, kind="stable")
        return self._worder_desc

    # ---- lazy aggregates for the external-dominance bound --------------
    @staticmethod
    def _greedy_fill_lb(prefix: tuple, X: float) -> float:
        """min cost to place X fractional units given (cumulative units,
        cumulative cost, unit price) prefixes sorted cheapest-first."""
        cu, cc, p = prefix
        j = int(cu.searchsorted(X, side="left"))
        if j >= cu.size:
            return float("inf")
        prev_u = cu[j - 1] if j else 0.0
        prev_c = cc[j - 1] if j else 0.0
        return float(prev_c + (X - prev_u) * p[j])

    def greedy_lb_workers(self, X: float) -> float:
        """Tight lower bound on sum_h w_h p_h^w over {0 <= w <= max_w,
        sum w >= X}: fill the cheapest machines fractionally. Every
        repaired integer allocation satisfies w_h <= max_w_h (workers-alone
        cap), so this bounds any external candidate's worker cost."""
        if X <= 0:
            return 0.0
        if self._wlb is None:
            o = self.wprice_order
            units = self.max_w[o]
            p = self.wprice[o]
            self._wlb = (np.cumsum(units), np.cumsum(units * p), p)
        return self._greedy_fill_lb(self._wlb, X)

    def greedy_lb_ps(self, X: float) -> float:
        """Same bound for PSs against max_s and p^s."""
        if X <= 0:
            return 0.0
        if self._slb is None:
            o = self.sprice_order
            units = self.max_s[o]
            p = self.sprice[o]
            self._slb = (np.cumsum(units), np.cumsum(units * p), p)
        return self._greedy_fill_lb(self._slb, X)

    def greedy_lb_vec(self, Xw: np.ndarray, Xs: np.ndarray) -> np.ndarray:
        """``greedy_lb_workers(Xw[i]) + greedy_lb_ps(Xs[i])`` for whole
        level vectors at once — one searchsorted per family instead of one
        Python call per (level, family). Element-for-element the fill is
        the arithmetic of ``_greedy_fill_lb`` (same searchsorted side, same
        prefix reads, same multiply-add), so each entry is bit-identical to
        the scalar bound the dominance check would have computed."""
        self.greedy_lb_workers(1.0)       # force prefix builds (cheap,
        self.greedy_lb_ps(1.0)            # cached for the snapshot's life)

        def fill(prefix, X):
            cu, cc, p = prefix
            out = np.zeros(X.shape)
            pos = X > 0
            if not pos.any():
                return out
            j = cu.searchsorted(X[pos], side="left")
            ok = j < cu.size
            jj = np.minimum(j, cu.size - 1)
            prev_u = np.where(j > 0, cu[np.maximum(j - 1, 0)], 0.0)
            prev_c = np.where(j > 0, cc[np.maximum(j - 1, 0)], 0.0)
            val = prev_c + (X[pos] - prev_u) * p[jj]
            out[pos] = np.where(ok, val, np.inf)
            return out

        return fill(self._wlb, np.asarray(Xw, dtype=np.float64)) + \
            fill(self._slb, np.asarray(Xs, dtype=np.float64))

    def head_aux(self, kind: str) -> tuple:
        """Precomputed operands for ``_headroom_one``: demand-positive
        column subsets of the demand vectors and tolerance-shifted free
        matrix, plus the zero-demand columns needed for the current-load
        guard."""
        aux = self._head_aux.get(kind)
        if aux is None:
            dem = self.wdem if kind == "w" else self.sdem
            pos = dem > 0
            nonpos = ~pos
            aux = (
                pos,
                dem[pos][None, :],                      # dpos (1, P)
                self.free_mat[:, pos] + 1e-9,           # fpos (H, P)
                self.wdem[pos],
                self.sdem[pos],
                self.wdem[nonpos],
                self.sdem[nonpos],
                (self.free_mat[:, nonpos] + 1e-9) if nonpos.any() else None,
            )
            self._head_aux[kind] = aux
        return aux

    @property
    def bundle_units(self) -> np.ndarray:
        """(H,) fractional capacity for the worker+PS/gamma bundle: the
        number of workers machine h can host when each carries its 1/gamma
        share of PS demand. Used as an LP-feasibility certificate."""
        if self._bundle_units is None:
            bun = self.wdem + self.sdem / self.job.gamma
            pos = bun > 0
            if not pos.any():
                self._bundle_units = np.full(self.H, np.inf)
            else:
                units = (self.free_mat[:, pos] / bun[pos][None, :]).min(axis=1)
                self._bundle_units = np.maximum(units, 0.0)
        return self._bundle_units


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
    """Algorithm 4 steps 2-7 (internal case).

    Distinct workload levels v frequently collapse onto the same
    (w_need, s_need) pair under the ceil, so results are memoized per
    snapshot (prices are frozen for the snapshot's lifetime)."""
    tps = job.time_per_sample(internal=True)
    w_need = max(1, int(math.ceil(v * tps)))
    if w_need > job.batch_size:  # constraint (4)
        return None
    s_need = max(1, int(math.ceil(w_need / job.gamma)))
    key = (w_need, s_need)
    cached = snap._internal_cache.get(key, False)
    if cached is not False:
        return cached

    # one shared evaluation path with the Algorithm-3 batch precompute
    snap.precompute_internal([key])
    return snap._internal_cache[key]


# ----------------------------------------------------------------------
def _prune_stats(snap: PriceSnapshot, need_w: float, need_s: float,
                 cfg: SubproblemConfig) -> tuple:
    """(machines, sum max_w, sum bundle_units) for the cheapest machines
    covering prune_margin x the requirement.

    The zero-capacity filter and the running capacity sums are precomputed
    per snapshot (np.cumsum is sequential, so the partial sums — and
    therefore the break points — are bit-identical to the reference's
    Python accumulation). The walk's break points are two searchsorted
    probes into those sums, so results memoize on the break-index pair:
    Algorithm 3's Q workload levels usually collapse onto a handful of
    distinct machine subsets."""
    i_w, j_s = _prune_keys(snap, np.float64(need_w), np.float64(need_s), cfg)
    return _prune_fill(snap, (int(i_w), int(j_s)), cfg)


def _prune_keys(snap: PriceSnapshot, need_w, need_s,
                cfg: SubproblemConfig) -> tuple:
    """The (i_w, j_s) break-index pair of ``_prune_stats`` — vectorized:
    ``need_w``/``need_s`` may be scalars or whole level vectors, and the
    searchsorted probes are the scalar walk's exact crossings."""
    if snap._prune_aux is None:
        wo = snap.wprice_order
        wp = wo[snap.max_w[wo] > 0]
        so = snap.sprice_order
        sp = so[snap.max_s[so] > 0]
        snap._prune_aux = (
            wp, np.cumsum(snap.max_w[wp]),
            sp, np.cumsum(snap.max_s[sp]),
        )
    wp, cw, sp, cs = snap._prune_aux
    cap = cfg.max_lp_machines
    margin = cfg.prune_margin
    # break index of each phase: first cumulative-capacity crossing
    # (cum[i] >= margin*need  <=>  i >= searchsorted), capped by the
    # max_lp_machines budget and the array end
    i_w = np.minimum(cw.searchsorted(margin * need_w, side="left"),
                     min(cap - 1, wp.size - 1))
    if sp.size:
        j_s = np.minimum(cs.searchsorted(margin * need_s, side="left"),
                         sp.size - 1)
    else:
        j_s = np.full_like(np.asarray(i_w), -1)
    return i_w, j_s


def _prune_fill(snap: PriceSnapshot, key: tuple,
                cfg: SubproblemConfig) -> tuple:
    """Memoized machine subset + capacity sums for one (i_w, j_s) key."""
    hit = snap._prune_cache.get(key)
    if hit is None:
        i_w, j_s = key
        wp, cw, sp, cs = snap._prune_aux
        cap = cfg.max_lp_machines
        machines = None
        if sp.size:
            # fast path: when the whole union stays strictly under the
            # machine cap, the incremental loop's cap-break can never
            # fire and the result is exactly the sorted union of the two
            # prefixes (at == cap the loop may stop one element short)
            uni = np.union1d(wp[:i_w + 1], sp[:j_s + 1])
            if uni.size < cap:
                machines = uni.astype(int)
        if machines is None:
            sel = {int(h) for h in wp[:i_w + 1]}
            for i in range(sp.size):
                sel.add(int(sp[i]))
                if i >= j_s or len(sel) >= cap:
                    break
            machines = np.array(sorted(sel), dtype=int)
        hit = (
            machines,
            float(snap.max_w[machines].sum()) if machines.size else 0.0,
            float(snap.bundle_units[machines].sum()) if machines.size else 0.0,
        )
        snap._prune_cache[key] = hit
    return hit


def _external_rows_A(
    job: JobSpec, wdem_act: np.ndarray, sdem_act: np.ndarray, M: int,
) -> Tuple[np.ndarray, int]:
    """The constraint MATRIX of program (23) for an M-machine subset:
    per-(machine, resource) capacity packing rows (24), worker cap (25),
    workload cover (26), ratio (Eq. 2).  Returns (A_ub, n_capacity_rows).

    Note what is absent: which machines are in the subset.  A is a pure
    function of the job's demand vectors, gamma, the batch cap, and M —
    machines enter the LP only through prices (``c``) and free
    capacities (``b``) — which is what lets the shared subset-template
    cache (``cover_packing.TemplateCache``) serve every (job, slot,
    subset) with one build.  Rows are machine-major with resources
    inner, the frozen reference's ordering, written with strided
    assignments instead of per-row np.zeros."""
    n = 2 * M
    nact = len(wdem_act)
    n_cap = M * nact
    A = np.zeros((n_cap + 3, n))
    # capacity block as two diagonal writes on the (M, nact, n) view:
    # cell (i*nact + j, i) = alpha[act[j]] and (i*nact + j, M+i) =
    # beta[act[j]] — the same cells the per-resource strided writes fill
    A3 = A[:n_cap].reshape(M, nact, n)
    ar = np.arange(M)
    A3[ar, :, ar] = wdem_act
    A3[ar, :, M + ar] = sdem_act
    # worker cap (25)
    A[n_cap, :M] = 1.0
    # workload cover (26): -sum w <= -W1
    A[n_cap + 1, :M] = -1.0
    # worker:PS ratio (Eq. 2, covering form): sum w - gamma sum s <= 0
    A[n_cap + 2, :M] = 1.0
    A[n_cap + 2, M:] = -job.gamma
    return A, n_cap


def _external_rows_b(
    job: JobSpec, snap: PriceSnapshot, machines: np.ndarray, W1: float,
    n_cap: int,
) -> np.ndarray:
    """The RHS of program (23) for one (slot, machine subset, workload
    level): the only part of the constraint system that reads the ledger
    (free capacities) or the level (the cover row's -W1)."""
    b = np.empty(n_cap + 3)
    # machine-major/resource-inner RHS block in one raveled write
    b[:n_cap] = snap.free_mat[machines][:, snap.act].ravel()
    b[n_cap] = float(job.batch_size)
    b[n_cap + 1] = -W1
    b[n_cap + 2] = 0.0
    return b


def _build_external_rows(
    job: JobSpec, snap: PriceSnapshot, machines: np.ndarray, W1: float,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Constraint rows of program (23) — the (A_ub, b_ub, n_capacity_rows)
    composition of ``_external_rows_A`` + ``_external_rows_b`` (cells and
    ordering bit-identical to the pre-split builder)."""
    act = snap.act                     # demand-positive resource columns
    A, n_cap = _external_rows_A(
        job, snap.wdem[act], snap.sdem[act], len(machines)
    )
    b = _external_rows_b(job, snap, machines, W1, n_cap)
    return A, b, n_cap


# dominance classification codes (see _dominance_class)
_DOM_SOLVE = 0      # cannot certify: the external LP must be solved
_DOM_SKIP = 1       # skip; the reference bails before rounding (no rng)
_DOM_SKIP_BURN = 2  # skip; the reference WOULD round — burn the block


def _dominance_class(
    job: JobSpec,
    snap: PriceSnapshot,
    v: float,
    cfg: SubproblemConfig,
    internal_cost: float,
) -> Tuple[int, int]:
    """Pure (rng-free) core of ``_external_dominated``: classify one
    workload level as solve / skip / skip-with-burn, returning
    ``(code, M)`` with M the pruned machine count (the burn width).
    Branch-for-branch the decision logic documented on
    ``_external_dominated``; kept separate so ``core.solve_plan`` can
    classify whole candidate grids without touching the rng stream and
    apply the burns later, in reference evaluation order."""
    tps = job.time_per_sample(internal=False)
    W1 = v * tps
    if W1 > job.batch_size + 1e-9:
        return _DOM_SKIP, 0               # external infeasible; no rng used
    if W1 > job.batch_size:
        # ambiguous band (batch, batch + 1e-9]: the reference's LP may
        # resolve either way within its phase-1 tolerance, so whether it
        # reaches the rounding draw is not certifiable — solve for real
        return _DOM_SOLVE, 0
    S1 = W1 / job.gamma
    # Integer counts every surviving external candidate satisfies:
    #   sum w >= ceil(W1 (1 - slack - 1e-9))   (cover row / repair target)
    #   sum s >= max(1, ceil(sum w / gamma))   (_ensure_ratio guarantee)
    # so the greedy fractional fills at those integer totals bound its cost
    # from below with no extra tolerance. On exact ties the candidate list
    # [internal, external] already resolves internal-first, so <= is safe.
    wsum_min = max(0, math.ceil(W1 * (1.0 - cfg.cover_slack - 1e-9) - 1e-12))
    s_min = max(1, math.ceil(wsum_min / job.gamma))
    bkey = (wsum_min, s_min)
    bound = snap._bound_cache.get(bkey)
    if bound is None:
        bound = snap.greedy_lb_workers(wsum_min) + snap.greedy_lb_ps(s_min)
        snap._bound_cache[bkey] = bound
    if internal_cost > bound:
        return _DOM_SOLVE, 0              # internal might lose: solve LP
    machines, maxw_sum, bundle_sum = _prune_stats(snap, W1, S1, cfg)
    M = len(machines)
    if M == 0 or maxw_sum < W1 - 1e-9:
        return _DOM_SKIP, M               # reference bails pre-rounding
    if bundle_sum < W1 + 1e-6:
        return _DOM_SOLVE, M              # can't certify LP feasibility
    return _DOM_SKIP_BURN, M


def _burn_rounding_block(cfg: SubproblemConfig, rng: np.random.Generator,
                         M: int) -> None:
    """Burn the (S, 2M) uniform block the reference's rounding would draw.
    Generator.random consumes one PCG64 step per double, so advancing the
    bit generator is stream-equivalent to drawing and discarding (covered
    by the golden parity tests); non-advanceable generators fall back.
    No-op in "derived" mode: per-(job, t, v) derived rngs mean skipping a
    solve cannot desync any other draw."""
    if cfg.rng_mode == "derived":
        return
    try:
        rng.bit_generator.advance(cfg.rounding_rounds * 2 * M)
    except (AttributeError, NotImplementedError):
        rng.random((cfg.rounding_rounds, 2 * M))


def _external_dominated(
    job: JobSpec,
    snap: PriceSnapshot,
    v: float,
    cfg: SubproblemConfig,
    internal_cost: float,
    rng: np.random.Generator,
) -> bool:
    """True iff the external candidate provably cannot beat internal_cost,
    so Algorithm 4's final min is the internal result without solving the
    LP. Decision-preserving by construction:

      every external allocation that survives rounding/repair is integer-
      feasible for the (unpruned) program (23), so its cost is bounded
      below by W1 * min_h p_h^w + (W1/gamma) * min_h p_h^s (cover row +
      ratio row + nonnegative prices). If internal_cost <= that bound, the
      candidate ordering [internal, external] already picks internal even
      on exact ties.

    rng-stream discipline: the frozen reference consumes exactly one
    (S, 2M) uniform block per external solve that reaches rounding. When we
    skip such a solve we draw-and-discard the same block, keeping every
    subsequent random decision bit-aligned with the reference. Paths on
    which the reference returns before rounding (workload over batch cap,
    empty/insufficient pruned set) consume nothing, and we skip without
    burning. If LP feasibility cannot be certified cheaply (bundle
    capacity below W1, or W1 inside the batch-cap tolerance band where
    the cover and cap rows conflict) we return False and solve for real.
    The one uncertifiable case is a reference LP exhausting its
    20000-pivot budget ("maxiter", returning before rounding): it cannot
    occur on these <=~200-row programs in practice, and the golden parity
    tests would surface it.

    The bound itself is tightened to integer totals — see the inline
    comment in ``_dominance_class`` — and the dominance comparison uses
    the DP cost values, which are bit-identical to the reference's
    (minplus_numpy replays the scalar hysteresis in near-tie rows)."""
    code, M = _dominance_class(job, snap, v, cfg, internal_cost)
    if code == _DOM_SOLVE:
        return False
    if code == _DOM_SKIP_BURN:
        _burn_rounding_block(cfg, rng, M)
    return True


@dataclass
class ExternalCandidate:
    """Everything ``solve_theta_external`` computes before its LP call —
    the unit of work the plan layer stacks into ``linprog_batch``."""

    W1: float
    machines: np.ndarray
    c: np.ndarray
    A_ub: np.ndarray
    b_ub: np.ndarray


def _external_candidate(
    job: JobSpec,
    snap: PriceSnapshot,
    v: float,
    cfg: SubproblemConfig,
) -> Optional[ExternalCandidate]:
    """Pre-LP half of ``solve_theta_external``: workload/prune feasibility
    gates and constraint-row construction. Returns None exactly when the
    reference returns None before reaching its LP (no rng consumed on any
    such path)."""
    tps = job.time_per_sample(internal=False)
    W1 = v * tps  # cover requirement on sum of workers (Eq. 26 RHS)
    if W1 > job.batch_size + 1e-9:  # (25) vs (26) conflict: infeasible v
        return None
    S1 = W1 / job.gamma
    machines, maxw_sum, _ = _prune_stats(snap, W1, S1, cfg)
    M = len(machines)
    if M == 0 or maxw_sum < W1 - 1e-9:
        return None
    c = np.concatenate([snap.wprice[machines], snap.sprice[machines]])
    A_ub, b_ub, _ = _build_external_rows(job, snap, machines, W1)
    return ExternalCandidate(W1=W1, machines=machines, c=c,
                             A_ub=A_ub, b_ub=b_ub)


def _packing_w2(job: JobSpec, snap: PriceSnapshot,
                machines: np.ndarray) -> float:
    """W2 = min over packing rows of rhs/coef (Theorem 3). Depends only
    on the machine subset and the frozen free capacities — NOT on the
    workload level — so the plan layer caches it per (slot, subset).

    One masked column-min replaces the per-(resource, demand) scan; the
    running min accumulates the same candidate set (min is exact, so the
    value is bit-identical to the scalar double loop)."""
    fr = snap.free_mat[machines]                       # (M, R)
    with np.errstate(invalid="ignore"):
        colmin = np.where(fr > 0, fr, np.inf).min(axis=0) if fr.size \
            else np.full(fr.shape[1], np.inf)
    # min over the same candidate set as the scalar (resource, demand)
    # double loop — min is exact, so the value is bit-identical; the
    # demand operands are snapshot constants, hoisted per snapshot
    aux = getattr(snap, "_w2_aux", None)
    if aux is None:
        dems = np.stack([snap.wdem, snap.sdem], axis=1)  # (R, 2)
        aux = snap._w2_aux = (dems, dems > 0)
    dems, dpos = aux
    ok = dpos & np.isfinite(colmin)[:, None]
    if ok.any():
        with np.errstate(divide="ignore"):
            cand = np.where(ok, colmin[:, None] / dems, np.inf)
        return float(min(float(job.batch_size), float(cand.min())))
    return float(job.batch_size)


def _external_finish(
    job: JobSpec,
    snap: PriceSnapshot,
    cand: ExternalCandidate,
    res,
    cfg: SubproblemConfig,
    rng: np.random.Generator,
    w2: Optional[float] = None,
) -> Optional[ThetaResult]:
    """Post-LP half of ``solve_theta_external``: G_delta, the randomized
    rounding (the ONLY rng consumer — reached iff the LP is optimal),
    repair, and the ratio guarantee. ``res`` is the candidate's
    ``LPResult`` from either ``linprog`` or ``linprog_batch``; ``w2``
    optionally injects the cached ``_packing_w2`` value (bit-identical —
    it is a pure function of the candidate's machine subset)."""
    W1, machines = cand.W1, cand.machines
    b_ub = cand.b_ub
    M = len(machines)
    if res.status != "optimal" or res.x is None:
        return None
    x_frac = res.x

    # ---- G_delta (Theorems 3-4) ----
    if cfg.g_delta is not None:
        gd = cfg.g_delta
    elif cfg.favor == "cover":
        gd = g_delta_cover(cfg.delta, max(W1, 1.0))
    else:
        if w2 is None:
            w2 = _packing_w2(job, snap, machines)
        gd = g_delta_packing(cfg.delta, max(w2, 1e-6),
                             num_packing_rows=len(b_ub) - 1)

    # rounding loop against the same cover/packing rows the LP used,
    # evaluated through the structured fast path (bit-identical results)
    act = snap.act
    rr = round_cover_packing_structured(
        x_frac, W1, snap.wdem[act], snap.sdem[act],
        snap.free_act[machines], float(job.batch_size), gd, rng,
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


def solve_theta_external(
    job: JobSpec,
    snap: PriceSnapshot,
    v: float,
    cfg: SubproblemConfig,
    rng: np.random.Generator,
) -> Optional[ThetaResult]:
    """Algorithm 4 steps 8-11 (external case): LP relax + randomized round.

    Variables x = [w_0..w_{M-1}, s_0..s_{M-1}] over the pruned machine set.
    Composition of the candidate/LP/finish phases — the plan layer
    (``core.solve_plan``) runs the same three phases with the LP step
    batched across every pending (t, v) candidate."""
    cand = _external_candidate(job, snap, v, cfg)
    if cand is None:
        return None
    # scalar (non-plan) LP dispatch — the lazy fallback path; counted so
    # the batched-vs-lazy split is visible in the registry
    get_registry().counter(
        "repro_lp_scalar_dispatch_total",
        "external-case LPs solved one-at-a-time (non-plan lazy path)").inc()
    with _trace.span("lp.scalar"):
        if cfg.lp_fault_hook is not None:
            cfg.lp_fault_hook("lp")
        res = linprog(cand.c, A_ub=cand.A_ub, b_ub=cand.b_ub)
    return _external_finish(job, snap, cand, res, cfg, rng)


# ------------------------------------------------------------- repair ops
def _fits_machine(job: JobSpec, snap: PriceSnapshot, h: int, w: int, s: int) -> bool:
    """Whole-vector feasibility for one machine's (w, s) load."""
    need = snap.wdem * w + snap.sdem * s
    return bool((need <= snap.free_mat[h] + 1e-9).all())


def _headroom_one(snap: PriceSnapshot, kind: str, h: int,
                  w_h: int, s_h: int) -> int:
    """Max extra units of worker (kind="w") or PS (kind="s") demand
    machine h can take on top of its current (w_h, s_h) load, under the
    same 1e-9 tolerance as ``_fits_machine``: closed-form floor of the
    slack/demand ratio, pinned by a one-ulp fix-up against the
    multiplicative per-unit check of the frozen reference. The repair
    paths use the whole-vector ``_headroom_all``; this per-machine form
    is kept as its parity oracle (tests/test_solve_plan.py)."""
    pos, dpos, fpos, wdp, sdp, wdn, sdn, fnon = snap.head_aux(kind)
    P = dpos.shape[1]
    if P == 0:
        return np.iinfo(np.int64).max // 2
    if fnon is not None:
        for j in range(wdn.size):
            if w_h * wdn[j] + s_h * sdn[j] > fnon[h, j]:
                return 0
    frow = fpos[h]
    k = math.inf
    for j in range(P):
        need = w_h * wdp[j] + s_h * sdp[j]
        k = min(k, math.floor((frow[j] - need) / dpos[0, j]))
    k = max(int(k), 0)

    # the fix-up predicate must be the reference's _fits_machine form —
    # a SINGLE multiply of the grown unit count, (w+kk)*alpha + s*beta,
    # not the additive w*alpha + kk*alpha (one-ulp different at exact-
    # capacity boundaries)
    if kind == "w":
        def fits(kk: int) -> bool:
            for j in range(P):
                if (w_h + kk) * wdp[j] + s_h * sdp[j] > frow[j]:
                    return False
            return True
    else:
        def fits(kk: int) -> bool:
            for j in range(P):
                if w_h * wdp[j] + (s_h + kk) * sdp[j] > frow[j]:
                    return False
            return True

    while k > 0 and not fits(k):
        k -= 1
    while fits(k + 1):
        k += 1
    return k


def _headroom_all(snap: PriceSnapshot, kind: str, w: np.ndarray,
                  s: np.ndarray) -> np.ndarray:
    """``_headroom_one`` for every machine in one vectorized pass —
    accepts one (H,) load pair or a stacked (C, H) batch of candidates'
    loads (the plan layer's grouped repair; the machine axis is always
    last and every candidate row is independent).

    The greedy repair loops visit machines in price order and each
    machine's (w_h, s_h) load only changes at its own visit, so the whole
    head-room vector can be precomputed from the entry loads. Per machine
    the arithmetic is ``_headroom_one``'s exactly: the nonpos-column
    guard short-circuits to 0 (skipping the grow fix-up, like the scalar
    early return), the closed form is the same floor of the same float
    ratios, and the one-ulp fix-up loops apply the same single-multiply
    predicate — so every entry is bit-identical to the lazy scalar call."""
    return _headroom_from_aux(snap.head_aux(kind), kind, w, s)


def _headroom_from_aux(aux: tuple, kind: str, w: np.ndarray,
                       s: np.ndarray) -> np.ndarray:
    """Head-room core over explicit aux operands.  ``fpos``/``fnon`` may
    carry a leading candidate axis ((C, H, P) instead of (H, P)) — the
    plan layer's fused finish stacks per-candidate SLOT free matrices
    this way, so candidates of different slots batch in one call.  Every
    op is elementwise over the broadcast cells, so each (candidate,
    machine) entry is bit-identical to the per-slot call."""
    pos, dpos, fpos, wdp, sdp, wdn, sdn, fnon = aux
    P = dpos.shape[1]
    if P == 0:
        return np.full(np.shape(w), np.iinfo(np.int64).max // 2,
                       dtype=np.int64)
    wf = w.astype(np.float64)
    sf = s.astype(np.float64)
    if fnon is not None:
        guard = ((wf[..., :, None] * wdn + sf[..., :, None] * sdn)
                 > fnon).any(axis=-1)
    else:
        guard = np.zeros(np.shape(w), dtype=bool)
    need = wf[..., :, None] * wdp + sf[..., :, None] * sdp
    k = np.floor((fpos - need) / dpos[0]).min(axis=-1)
    k = np.maximum(k.astype(np.int64), 0)

    # fix-up against the multiplicative predicate (see _headroom_one):
    # grown-count single multiply, never the additive form
    if kind == "w":
        def fits_at(kk):
            lhs = ((wf + kk)[..., :, None] * wdp
                   + sf[..., :, None] * sdp)
            return (lhs <= fpos).all(axis=-1)
    else:
        def fits_at(kk):
            lhs = (wf[..., :, None] * wdp
                   + (sf + kk)[..., :, None] * sdp)
            return (lhs <= fpos).all(axis=-1)

    live = ~guard
    while True:
        shrink = live & (k > 0) & ~fits_at(k)
        if not shrink.any():
            break
        k[shrink] -= 1
    while True:
        grow = live & fits_at(k + 1)
        if not grow.any():
            break
        k[grow] += 1
    k[guard] = 0
    return k


def _repair(job, snap, w, s, W1, heads=None):
    """Clip per-machine packing violations, then greedily add workers on the
    cheapest machines until the cover constraint holds.

    Vectorized: one mask over the loaded machines finds packing violations
    (usually none), whole-vector head-room + a closed-form prefix fill
    replace the per-unit while loops; identical greedy order and outcomes
    as the frozen scalar reference. ``heads`` optionally injects the
    (H,) worker head-room row (the plan layer computes it for a whole
    candidate batch at once); only valid when the clip phase left the
    loads untouched, so callers pass it for clip-free candidates only."""
    loaded = np.flatnonzero((w > 0) | (s > 0))
    if loaded.size:
        need_mat = (w[loaded, None] * snap.wdem[None, :]
                    + s[loaded, None] * snap.sdem[None, :])
        okrow = (need_mat <= snap.free_mat[loaded] + 1e-9).all(axis=1)
        bad = loaded[~okrow]
    else:
        bad = loaded
    if bad.size:
        for h in bad:
            while (w[h] > 0 or s[h] > 0) and not _fits_machine(
                job, snap, h, int(w[h]), int(s[h])
            ):
                if w[h] >= s[h] and w[h] > 0:
                    w[h] -= 1
                elif s[h] > 0:
                    s[h] -= 1
                else:
                    break
        heads = None   # loads changed: injected head-room is stale
    need = int(math.ceil(W1 - w.sum()))
    if need > 0:
        budget = int(job.batch_size - w.sum())  # cap (25)
        filled = 0
        if budget > 0:
            # whole-vector head-room: each machine is visited once and its
            # load only changes at that visit, so the entry-load vector is
            # exactly what the lazy per-machine calls would have seen —
            # and the greedy walk itself collapses to a closed-form
            # prefix fill: take_h = min(head_h, X - taken_before), X the
            # binding of cover need and batch budget (both shrink by the
            # same takes, so min(need_rem, budget_rem) = X - prefix).
            # Integer arithmetic throughout — takes identical to the loop.
            if heads is None:
                heads = _headroom_all(snap, "w", w, s)
            X = min(need, budget)
            # heads clip at X first: a take never exceeds the remaining
            # fill, so takes are unchanged — and the no-demand sentinel
            # (iinfo.max // 2) cannot overflow the prefix sums
            hv = np.minimum(heads[snap.wprice_order], X)
            prefix = np.cumsum(hv) - hv
            takes = np.clip(X - prefix, 0, hv)
            w[snap.wprice_order] += takes
            filled = int(takes.sum())
        if need - filled > 0:
            return None, None
    if w.sum() > job.batch_size:
        # same closed form along the descending price order
        excess = int(w.sum() - job.batch_size)
        wv = w[snap.wprice_order_desc]
        prefix = np.cumsum(wv) - wv
        takes = np.clip(excess - prefix, 0, wv)
        w[snap.wprice_order_desc] -= takes
    return w, s


def _ensure_ratio(job, snap, w, s, heads=None):
    """Ensure sum(s) >= ceil(sum(w)/gamma), adding PSs cheapest-first —
    whole-vector head-room + closed-form prefix fill instead of
    unit-at-a-time. ``heads`` optionally injects the (H,) PS head-room
    row computed for a whole candidate batch (must match the CURRENT
    (w, s) loads — the plan layer recomputes after any repair)."""
    need = max(1, int(math.ceil(w.sum() / job.gamma))) - int(s.sum())
    if need <= 0:
        return s
    if heads is None:
        heads = _headroom_all(snap, "s", w, s)
    hv = np.minimum(heads[snap.sprice_order], need)  # sentinel-safe cumsum
    prefix = np.cumsum(hv) - hv
    takes = np.clip(need - prefix, 0, hv)
    s[snap.sprice_order] += takes
    return s if need - int(takes.sum()) <= 0 else None


# ----------------------------------------------------------------------
def solve_theta_snapshot(
    job: JobSpec,
    snap: PriceSnapshot,
    v: float,
    cfg: Optional[SubproblemConfig] = None,
    rng: Optional[np.random.Generator] = None,
) -> Optional[ThetaResult]:
    """Algorithm 4 (all steps): min over internal / external candidates.

    When the internal candidate exists and provably dominates (see
    ``_external_dominated``) the external LP+rounding is skipped — the
    scheduler's hottest branch at low-to-medium load."""
    if v <= 0:
        return ThetaResult(cost=0.0, alloc=Allocation(), mode="idle")
    cfg = cfg or SubproblemConfig()
    rng = rng if rng is not None else np.random.default_rng(cfg.seed)
    internal = solve_theta_internal(job, snap, v)
    if internal is not None and _external_dominated(
        job, snap, v, cfg, internal.cost, rng
    ):
        return internal
    cands: List[ThetaResult] = []
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
    cfg = cfg or SubproblemConfig()
    snap = PriceSnapshot(job, cluster, prices, t)
    return solve_theta_snapshot(job, snap, v, cfg, rng)
