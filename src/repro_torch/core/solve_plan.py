"""Plan-then-solve pipeline for Algorithm 3/4's (slot, workload-level) grid.

The paper's Algorithm 2+3 probes theta(t, v) for every slot t in the
job's window and every quantized workload level v — and in the
heavy-contention regime nearly every probe pays an external cover/packing
LP (program 23). The per-(t, v) loop solves them one at a time; this
module restructures that into four phases over the WHOLE grid:

  1. **Collect** — enumerate every pending (t, v) candidate for the job
     (``WorkloadDP`` injects already-memoized keys so lazily pre-solved
     thetas are skipped exactly as the reference skips them).
  2. **Fuse** — build all slots' ``PriceSnapshot`` decision vectors in one
     (W, H) bundle pass (``ArrayBackend.snapshot_bundle_batch``): the
     whole stack reduces in a single kernel launch and host copy (no
     per-slot bundle round trips), in the reference's per-slot
     accumulation order. Internal
     candidates for every level batch-solve per slot through the
     snapshot's (K, H, P) precompute.
  3. **Classify + batch-solve** — the dominance / feasibility gates of
     ``solve_theta_snapshot`` are evaluated as whole level vectors
     (``_dominance_class`` branch-for-branch, vectorized); the surviving
     external candidates are dispatched to the structure-aware
     cover/packing solver (``core.cover_packing``): instances matching
     the one-cover-row shape are solved by exact Bland replay — no
     tableau is ever built for them — and the rest go to the batched
     stacked-tableau simplex (``lp.linprog_batch``) via the shared
     subset-template cache (one template per demand signature serves
     every job, slot, and machine subset).  Either path produces
     bit-identical pivot trajectories per problem.
     ``SubproblemConfig.lp_solver`` (default: the backend's
     ``lp_solver_default`` hint) forces one path for parity testing.
  4. **Resolve** — walk the grid in the reference's evaluation order
     (t ascending, v ascending) consuming the rng exactly as the
     per-(t, v) loop would: dominated levels burn their (S, 2M) block,
     LP levels draw for rounding iff their LP was optimal. LPs consume no
     rng, which is what makes hoisting them out of the loop
     stream-equivalent.

Admission decisions are therefore bit-identical to the un-planned path in
BOTH rng modes (``tests/test_solve_plan.py``): in "compat" the stream
position after every theta matches the reference's; in "derived" each
(job, t, v) already has its own generator so order never mattered.

Cross-job batching: ``PDORS.offer_batch`` / the simulator's arrival
batches build one plan per job of a same-slot batch (jobs share the
ledger until an admission reprices) and stack EVERY job's LP candidates
into one ``linprog_batch`` call via ``solve_plans``; an admission bumps
the ledger version, the stale plans are detected (``fresh``) and rebuilt
for the remaining jobs.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..obs import trace as _trace
from ..obs.metrics import get_registry
from .cluster import Cluster
from .cover_packing import (
    CoverPackingLP,
    SubsetTemplate,
    solve_lp_batch,
    subset_template_cache,
)
from .job import Allocation, JobSpec
from .lp import LPResult
from .pricing import PriceTable
from .rounding import g_delta_cover, g_delta_packing
from .subproblem import (
    _DOM_SKIP,
    _DOM_SKIP_BURN,
    _DOM_SOLVE,
    ExternalCandidate,
    PriceSnapshot,
    SubproblemConfig,
    ThetaResult,
    _alloc_cost,
    _burn_rounding_block,
    _external_rows_A,
    _external_rows_b,
    _headroom_from_aux,
    _packing_w2,
    _prune_fill,
    _prune_keys,
    _repair,
)


def _resolve_lp_solver(cfg: SubproblemConfig, cluster: Cluster) -> str:
    """The external-LP dispatch for one plan: ``cfg.lp_solver`` if set,
    else the backend's ``ArrayBackend.lp_solver_default`` hint.  Unknown
    names fail loudly — a typo in a config whose purpose is forcing the
    parity oracle must not silently run the fast path instead."""
    solver = cfg.lp_solver or cluster.backend.lp_solver_default()
    if solver not in ("cover_packing", "simplex"):
        raise ValueError(
            f"unknown lp_solver {solver!r}; expected 'cover_packing' "
            "or 'simplex'"
        )
    return solver

def _ext_subset(job: JobSpec, wd_act: np.ndarray, sd_act: np.ndarray,
                M: int) -> tuple:
    """(A, cover_row, n_cap) builder for a subset-template cache miss."""
    A, n_cap = _external_rows_A(job, wd_act, sd_act, M)
    return A, n_cap + 1, n_cap


# per-(t, v) resolution actions for entries that must stay in the
# ORDERED resolve walk; rng-free order-free entries (no candidate, or an
# uncontested internal-only result) bypass _Pending via SolvePlan.trivial
_A_INT_BURN = 2   # internal wins by dominance; burn the rounding block
_A_LP = 3         # external LP candidate pending in the batch


@dataclass(slots=True)
class _Pending:
    t: int
    v: int                               # workload level (units)
    action: int
    internal: Optional[ThetaResult]
    burn_M: int = 0                      # _A_INT_BURN: burn width
    cand: Optional[ExternalCandidate] = None
    lp_index: int = -1                   # index into the plan's LP list
    w2: float = 0.0                      # cached _packing_w2 (per subset)


def infeasible_levels(job: JobSpec, quanta: int, unit: float) -> frozenset:
    """Workload levels v where BOTH theta candidates fail their workload
    cap before touching prices or rng: the internal worker need exceeds
    the batch size (constraint (4)) and the external cover requirement
    exceeds it past the tolerance band ((25) vs (26)). A pure function of
    the job, so ``WorkloadDP`` memoizes theta(t, v) = None for these
    levels without building a snapshot — and a rolling window's repeated
    ``solve_prefix`` calls re-derive nothing."""
    tps_i = job.time_per_sample(internal=True)
    tps_e = job.time_per_sample(internal=False)
    out = []
    for v in range(1, quanta + 1):
        w_need = max(1, int(math.ceil((v * unit) * tps_i)))
        W1 = (v * unit) * tps_e
        if w_need > job.batch_size and W1 > job.batch_size + 1e-9:
            out.append(v)
    return frozenset(out)


class SolvePlan:
    """One job's collected, fused, batch-solvable theta grid.

    Lifecycle contract (what each phase may and may not touch):

    * **Build** (``__init__`` / ``_collect``) is rng-free and
      ledger-read-only: it snapshots prices/free capacities for every
      slot in ``[t_lo, t_hi]``, classifies all (slot, level) candidates,
      and materializes the surviving external LPs as tableau-free
      ``CoverPackingLP`` instances via the shared subset-template cache.
      The plan records ``cluster.version``; any later ledger mutation
      makes it stale (``fresh()`` -> False) and it must be rebuilt, never
      partially reused.
    * **Solve** (``solve`` / ``solve_plans``) is also rng-free: the LP
      batch goes through the structure-aware dispatch
      (``cover_packing.solve_lp_batch`` — exact Bland replay with
      stacked-simplex fallback; ``cfg.lp_solver`` forces a path).
      ``solve_plans`` stacks several plans' instances into one call (the
      cross-job batched-offer path).
    * **Resolve** (``resolve_into``) is the ONLY rng consumer: it walks
      the grid in the reference's (t asc, v asc) order, burning/drawing
      exactly the blocks the lazy per-(t, v) loop would (see the
      compat-burn contract on ``SubproblemConfig.rng_mode``), then runs
      the rng-free rounding/repair finish in one stacked pass.

    Decisions are bit-identical to the lazy loop in both rng modes
    (``tests/test_solve_plan.py``) and independent of the LP dispatch
    choice (``tests/test_cover_packing.py``)."""

    def __init__(
        self,
        job: JobSpec,
        cluster: Cluster,
        prices: PriceTable,
        cfg: SubproblemConfig,
        t_lo: int,
        t_hi: int,
        quanta: int = 32,
        skip: Optional[set] = None,
    ):
        self.job = job
        self.cluster = cluster
        self.prices = prices
        self.cfg = cfg
        self.t_lo = t_lo
        self.t_hi = t_hi
        V = job.total_workload()
        self.quanta = max(1, min(quanta, int(math.ceil(V))))
        self.unit = V / self.quanta
        self.version = cluster.version   # staleness guard (see ``fresh``)
        # per-slot staleness bookkeeping for ``patch``: the stamp of each
        # slot's last ledger mutation at build time, and the window-slide
        # counter (a slide shifts what relative index t means, so a
        # patched plan would splice rows from the wrong slots)
        self.advances = cluster.advances
        self.slot_versions: Dict[int, int] = {}
        self.snaps: Dict[int, PriceSnapshot] = {}
        self.pending: List[_Pending] = []
        # (t, v) -> ThetaResult|None for grid entries whose resolution
        # neither consumes rng nor depends on order (no candidate, or an
        # uncontested internal-only result): resolve_into setdefaults
        # them into the memo wholesale instead of walking ~Q*T pending
        # objects
        self.trivial: Dict[Tuple[int, int], Optional[ThetaResult]] = {}
        self.lp_built: List = []         # pre-built tableaus (lp._Prob)
        self.lp_results: Optional[List[LPResult]] = None
        with _trace.span("plan.build", job=int(job.job_id),
                         slots=t_hi - t_lo + 1, quanta=self.quanta) as sp:
            self._collect(prices, skip or set())
            sp.set(n_lp=len(self.lp_built), n_pending=len(self.pending),
                   n_trivial=len(self.trivial))

    # ------------------------------------------------------------------
    def fresh(self) -> bool:
        """True while no ledger mutation has invalidated the plan."""
        return self.version == self.cluster.version

    def covers(self, t_lo: int, t_hi: int) -> bool:
        return self.t_lo <= t_lo and t_hi <= self.t_hi

    # ------------------------------------------------------------------
    def patch(self, skip: Optional[set] = None) -> bool:
        """Reconcile a stale plan against the current ledger instead of
        rebuilding it, slot by slot. Returns True when the plan is fresh
        again; False when patching is impossible (the window slid —
        relative indices changed meaning — so the caller must rebuild).

        Per-slot version stamps (``Cluster.slot_version``) identify
        exactly the slots whose ledger rows mutated since build. Clean
        slots keep their snapshots, classified grid entries, and SOLVED
        LP results (prices and free capacities are pure functions of the
        slot's own row, and each LP's pivot trajectory is independent of
        batch composition); dirty slots are dropped and re-collected
        against the current ledger with the caller's ``skip`` set —
        byte-for-byte what a cold rebuild would produce for them. The
        pending walk is re-sorted to the reference's (t asc, v asc)
        order, so ``resolve_into`` consumes the rng exactly as a rebuilt
        plan would in both rng modes. Decision-identity to the cold
        rebuild is property-tested in ``tests/test_solve_plan.py``."""
        cluster = self.cluster
        if self.fresh():
            return True
        if cluster.advances != self.advances:
            return False
        ts = range(self.t_lo, self.t_hi + 1)
        dirty = [t for t in ts
                 if cluster.slot_version(t) != self.slot_versions.get(t)]
        with _trace.span("plan.patch", job=int(self.job.job_id),
                         dirty=len(dirty)) as sp:
            get_registry().counter(
                "repro_plan_patches_total",
                "stale SolvePlans reconciled in place (vs rebuilt)").inc()
            dirty_set = set(dirty)
            for t in dirty:
                self.snaps.pop(t, None)
            if dirty_set:
                self.trivial = {k: v for k, v in self.trivial.items()
                                if k[0] not in dirty_set}
            keep = [p for p in self.pending if p.t not in dirty_set]
            new_built: List = []
            old_results = self.lp_results
            kept_results: List[LPResult] = []
            for p in keep:
                if p.action == _A_LP:
                    old_idx = p.lp_index
                    if old_results is not None:
                        kept_results.append(old_results[old_idx])
                    p.lp_index = len(new_built)
                    new_built.append(self.lp_built[old_idx])
            self.pending = keep
            self.lp_built = new_built
            self.lp_results = None
            solved_n = len(new_built)
            if dirty:
                self._collect(self.prices, skip or set(), ts=dirty)
                self.pending.sort(key=lambda p: (p.t, p.v))
            if old_results is not None:
                # the clean entries keep their solved results; only the
                # re-collected tail is solved — per-problem results are
                # independent of batch composition, so this equals a
                # full re-solve of the rebuilt plan
                tail = self.lp_built[solved_n:]
                if tail:
                    if self.cfg.lp_fault_hook is not None:
                        self.cfg.lp_fault_hook("lp_batch")
                    force = (_resolve_lp_solver(self.cfg, cluster)
                             == "simplex")
                    tail_res = solve_lp_batch(tail, force_simplex=force)
                else:
                    tail_res = []
                self.lp_results = kept_results + tail_res
            self.version = cluster.version
            sp.set(n_lp=len(self.lp_built), kept=len(keep))
        return True

    # ------------------------------------------------------------------
    def _collect(self, prices: PriceTable, skip: set,
                 ts: Optional[List[int]] = None) -> None:
        """Collect + classify the (slot, level) grid for slots ``ts``
        (default: the plan's full [t_lo, t_hi] range — ``patch`` passes
        just the dirty subset)."""
        job, cluster, cfg = self.job, self.cluster, self.cfg
        Q = self.quanta
        if ts is None:
            ts = list(range(self.t_lo, self.t_hi + 1))
        if not ts:
            return
        wdem, sdem = cluster.demand_vectors(job)

        # ---- phase 2: fused (W, H) bundle pass over every slot --------
        with _trace.span("plan.bundle", slots=len(ts),
                         backend=cluster.backend.device.type):
            # the full-horizon operands are the version-cached device
            # tensors as they stand (no per-plan slice copy); rows outside
            # ts are reduced and ignored
            price_op = prices.device_tensor()
            free_op = cluster.device_free_tensor()
            wp, sp, co, mw, ms = cluster.backend.snapshot_bundle_batch(
                price_op, free_op, wdem, sdem, job.gamma,
            )
            bundles = {t: (wp[t], sp[t], co[t], mw[t], ms[t]) for t in ts}
            for t in ts:
                self.slot_versions[t] = cluster.slot_version(t)
                self.snaps[t] = PriceSnapshot(
                    job, cluster, prices, t, bundle=bundles[t],
                )

        # ---- per-level constants (independent of t) -------------------
        vs = np.arange(1, Q + 1, dtype=np.float64) * self.unit
        tps_i = job.time_per_sample(internal=True)
        tps_e = job.time_per_sample(internal=False)
        batch = float(job.batch_size)
        w_need = np.maximum(1, np.ceil(vs * tps_i)).astype(np.int64)
        s_need = np.maximum(1, np.ceil(w_need / job.gamma)).astype(np.int64)
        int_ok = w_need <= job.batch_size          # constraint (4)
        W1 = vs * tps_e
        S1 = W1 / job.gamma
        hard_inf = W1 > batch + 1e-9               # (25) vs (26) conflict
        ambiguous = ~hard_inf & (W1 > batch)       # tolerance band: solve
        wsum_min = np.maximum(
            0, np.ceil(W1 * (1.0 - cfg.cover_slack - 1e-9) - 1e-12)
        ).astype(np.int64)
        s_min = np.maximum(1, np.ceil(wsum_min / job.gamma)).astype(np.int64)

        pairs = [(int(w_need[i]), int(s_need[i]))
                 for i in range(Q) if int_ok[i]]

        # shared subset-template cache: the constraint matrix A depends
        # only on (M, demand signature, gamma, batch cap) — see
        # cover_packing.TemplateCache — so the per-(slot, subset) work
        # left below is the b/c vectors and the W2 scalar
        cache = subset_template_cache()
        act0 = self.snaps[ts[0]].act
        wd_act, sd_act = wdem[act0], sdem[act0]
        dem_sig = (len(act0), wd_act.tobytes(), sd_act.tobytes(),
                   float(job.gamma), float(job.batch_size))

        for t in ts:
            snap = self.snaps[t]
            todo = [i for i in range(Q) if (t, i + 1) not in skip]
            if not todo:
                continue
            # per-(slot, pruned-subset) LP pieces: prices (c), free
            # capacities (b), W2 — everything the shared template can't
            # carry — shared by all workload levels of one machine subset
            templates: Dict[Tuple[int, int], tuple] = {}
            # batch the internal case across every pending level (the
            # (K, H, P) comparison of precompute_internal)
            if pairs:
                snap.precompute_internal(pairs)
            internal: List[Optional[ThetaResult]] = [None] * Q
            icost = np.full(Q, np.inf)
            for i in todo:
                if int_ok[i]:
                    th = snap._internal_cache.get(
                        (int(w_need[i]), int(s_need[i]))
                    )
                    internal[i] = th
                    if th is not None:
                        icost[i] = th.cost
            # vectorized dominance bound + prune stats over all levels
            with _trace.span("plan.classify", t=t, levels=len(todo)):
                bound = snap.greedy_lb_vec(wsum_min, s_min)
                i_w, j_s = _prune_keys(snap, W1, S1, cfg)
                Ms = np.empty(Q, dtype=np.int64)
                maxw_sum = np.empty(Q)
                bundle_sum = np.empty(Q)
                stats_by_key: Dict[Tuple[int, int], tuple] = {}
                for i in todo:
                    key = (int(i_w[i]), int(j_s[i]))
                    hit = stats_by_key.get(key)
                    if hit is None:
                        hit = _prune_fill(snap, key, cfg)
                        stats_by_key[key] = hit
                    Ms[i] = len(hit[0])
                    maxw_sum[i] = hit[1]
                    bundle_sum[i] = hit[2]
                # branch-for-branch _dominance_class as level vectors:
                # np.select takes the FIRST matching condition, which is
                # the scalar early-return chain verbatim
                prune_dead = (Ms == 0) | (maxw_sum < W1 - 1e-9)
                dom_code = np.select(
                    [hard_inf,                  # external infeasible: skip
                     ambiguous,                 # tolerance band: solve
                     icost > bound,             # internal might lose: solve
                     prune_dead,                # reference bails pre-round
                     bundle_sum < W1 + 1e-6],   # can't certify: solve
                    [_DOM_SKIP, _DOM_SOLVE, _DOM_SOLVE, _DOM_SKIP,
                     _DOM_SOLVE],
                    default=_DOM_SKIP_BURN,
                )

            for i in todo:
                v = i + 1
                has_int = internal[i] is not None
                code = int(dom_code[i])
                if has_int and code != _DOM_SOLVE:
                    if code == _DOM_SKIP_BURN:
                        # burns consume rng: must stay in the ordered walk
                        self.pending.append(_Pending(
                            t, v, _A_INT_BURN, internal[i],
                            burn_M=int(Ms[i]),
                        ))
                    else:
                        # rng-free and order-free: straight to the memo
                        self.trivial[(t, v)] = internal[i]
                    continue
                # external path (internal missing, or dominance failed):
                # a candidate exists iff the reference's pre-LP gates pass
                if hard_inf[i] or prune_dead[i]:
                    self.trivial[(t, v)] = internal[i] if has_int else None
                    continue
                key = (int(i_w[i]), int(j_s[i]))
                tmpl = templates.get(key)
                if tmpl is None:
                    machines = stats_by_key[key][0]
                    M = len(machines)
                    c = np.concatenate(
                        [snap.wprice[machines], snap.sprice[machines]]
                    )
                    sub = cache.get(
                        dem_sig + (M,),
                        lambda: SubsetTemplate(
                            *_ext_subset(job, wd_act, sd_act, M)
                        ),
                    )
                    # W1=1.0 placeholder: b[cover] = -1.0 carries the sign
                    # of every instance's -W1 (W1 > 0 for all v >= 1)
                    b_base = _external_rows_b(
                        job, snap, machines, 1.0, sub.n_cap
                    )
                    # a tolerance-committed ledger can leave a free cell
                    # epsilon-negative: then the instances do NOT have
                    # the one-negative-row shape (the dense builder adds
                    # a second artificial) — such subsets bypass both
                    # the replay and the shared template and are solved
                    # by the general simplex from fresh full builds
                    shape_ok = not bool(
                        (np.delete(b_base, sub.n_cap + 1) < 0).any()
                    )
                    tmpl = (sub, machines, b_base, sub.n_cap + 1, c,
                            _packing_w2(job, snap, machines), shape_ok)
                    templates[key] = tmpl
                sub, machines, b_base, cover_row, c, w2, shape_ok = tmpl
                W1f = float(W1[i])
                b = b_base.copy()
                b[cover_row] = -W1f
                cand = ExternalCandidate(W1=W1f, machines=machines,
                                         c=c, A_ub=sub.A, b_ub=b)
                self.pending.append(_Pending(
                    t, v, _A_LP, internal[i], cand=cand,
                    lp_index=len(self.lp_built), w2=w2,
                ))
                # b_base is the SHARED per-subset RHS (the replay never
                # reads its cover cell — cover_value carries the level),
                # so the whole subset's instances alias two arrays and
                # the solver's init can broadcast instead of copying
                ok = shape_ok and -W1f < 0
                self.lp_built.append(CoverPackingLP(
                    c=c, A_flip=sub.A_flip, b_base=b_base, cover=cover_row,
                    cover_value=-W1f, template=sub if ok else None,
                    shape_ok=ok,
                ))

    # ------------------------------------------------------------------
    def install_lp_results(self, results: List[LPResult]) -> None:
        assert len(results) == len(self.lp_built)
        self.lp_results = results

    def solve(self) -> "SolvePlan":
        """Run this plan's own LP batch (the single-job path) through the
        structure-aware dispatch: exact-replay cover/packing solve with
        stacked-simplex fallback, or pure simplex when
        ``cfg.lp_solver="simplex"`` — bit-identical results either way
        (``tests/test_cover_packing.py``)."""
        if self.lp_results is None:
            if self.cfg.lp_fault_hook is not None and self.lp_built:
                self.cfg.lp_fault_hook("lp_batch")
            force = _resolve_lp_solver(self.cfg, self.cluster) == "simplex"
            self.install_lp_results(
                solve_lp_batch(self.lp_built, force_simplex=force)
            )
        return self

    # ------------------------------------------------------------------
    def resolve_into(
        self,
        memo: Dict[Tuple[int, int], Optional[ThetaResult]],
        rng_for: Callable[[int, int], np.random.Generator],
    ) -> None:
        """Fill ``memo[(t, v)]`` for every pending candidate, consuming
        the rng in the reference's (t asc, v asc) evaluation order
        exactly as the per-(t, v) loop would (see module docstring) —
        the ordered pass below draws every rounding block / burn in
        sequence, then the rng-free finish (rounding selection, repair,
        ratio guarantee) runs batched across all candidates.
        ``rng_for(t, units)`` returns the stream for one evaluation —
        the shared sequential stream in "compat" mode, a per-(job, t, v)
        derived generator in "derived" mode."""
        if self.lp_results is None:
            self.solve()
        with _trace.span("plan.resolve", pending=len(self.pending)) as rsp:
            cfg, job = self.cfg, self.job
            S = cfg.rounding_rounds
            # rng-free prep hoisted out of the ordered loop: Eqs.
            # (27)-(28)'s scale/floor/frac per optimal-LP candidate,
            # op-for-op the block round_cover_packing_structured computes
            # before its draw
            prep: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
            for p in self.pending:
                if p.action != _A_LP:
                    continue
                res = self.lp_results[p.lp_index]
                if res.status != "optimal" or res.x is None:
                    continue
                xp = np.maximum(res.x, 0.0) * self._g_delta(p)
                lo = np.floor(xp)
                prep[p.lp_index] = (lo, xp - lo)
            # rng-free grid entries first (order-free; setdefault preserves
            # the "lazily pre-solved outside the plan" precedence)
            for key, val in self.trivial.items():
                memo.setdefault(key, val)
            work: List[Tuple[_Pending, np.ndarray]] = []
            keys: List[Tuple[int, int]] = []
            for p in self.pending:
                key = (p.t, p.v)
                if key in memo:        # lazily pre-solved outside the plan
                    continue
                if p.action == _A_INT_BURN:
                    _burn_rounding_block(cfg, rng_for(p.t, p.v), p.burn_M)
                    memo[key] = p.internal
                else:
                    hit = prep.get(p.lp_index)
                    if hit is None:
                        # external died pre-rounding: no draw, internal only
                        memo[key] = p.internal
                        continue
                    lo, frac = hit
                    X = (lo[None, :]
                         + (rng_for(p.t, p.v).random((S, lo.size))
                            < frac[None, :])).astype(np.int64)
                    work.append((p, X))
                    keys.append(key)
            rsp.set(rounded=len(work))
            with _trace.span("plan.finish", candidates=len(work)):
                self._finish_batched(work, keys, memo)

    def _g_delta(self, p: _Pending) -> float:
        """G_delta for one candidate (Theorems 3-4) — the branch
        ``_external_finish`` evaluates, with the W2 term read from the
        per-subset cache."""
        cfg = self.cfg
        if cfg.g_delta is not None:
            return cfg.g_delta
        if cfg.favor == "cover":
            return g_delta_cover(cfg.delta, max(p.cand.W1, 1.0))
        return g_delta_packing(cfg.delta, max(p.w2, 1e-6),
                               num_packing_rows=len(p.cand.b_ub) - 1)

    def _aux_stacked(self, kind: str, F_rows: np.ndarray) -> tuple:
        """Stacked-slot head-room operands: the demand-derived components
        of ``PriceSnapshot.head_aux`` (shared — demands don't vary by
        slot) combined with per-candidate SLOT free matrices ``F_rows``
        ((C, H, R)).  Each candidate's cells are the exact per-slot aux
        values (same gather + the same ``+ 1e-9`` shift), so
        ``_headroom_from_aux`` over the stack is bit-identical to
        per-slot ``_headroom_all`` calls."""
        snap0 = next(iter(self.snaps.values()))
        pos, dpos, _fp, wdp, sdp, wdn, sdn, _fn = snap0.head_aux(kind)
        nonpos = ~pos
        fpos = F_rows[:, :, pos] + 1e-9
        fnon = (F_rows[:, :, nonpos] + 1e-9) if nonpos.any() else None
        return (pos, dpos, fpos, wdp, sdp, wdn, sdn, fnon)

    def _finish_batched(
        self,
        work: List[Tuple[_Pending, np.ndarray]],
        keys: List[Tuple[int, int]],
        memo: Dict[Tuple[int, int], Optional[ThetaResult]],
    ) -> None:
        """The rng-free tail of ``_external_finish`` over every candidate
        in ONE stacked pass: rounding feasibility for all candidates of
        all subset sizes and slots together (machine-padded — padding is
        neutral because the padded packing cells evaluate to 0 and
        ``pack_v`` is clamped at 0 anyway, and padded worker cells add
        exact zeros to the integer-exact sums), head-room rows from
        per-candidate stacked slot operands (``_aux_stacked``), and the
        cover/ratio prefix fills over the whole candidate set with
        per-candidate price orders gathered row-wise.  Only candidates
        whose clip phase actually fires (rare) fall back to the scalar
        ``_repair``.  Results are bit-identical to the per-candidate
        finish — covered by the plan-vs-loop parity tests."""
        if not work:
            return
        cfg, job = self.cfg, self.job
        S = cfg.rounding_rounds
        batch_cap = float(job.batch_size)
        H = self.cluster.num_machines
        snap0 = next(iter(self.snaps.values()))
        act = snap0.act
        wdem_act = snap0.wdem[act]
        sdem_act = snap0.sdem[act]
        n_work = len(work)

        # ---- stacked per-slot operands (one gather per unique slot) ----
        uniq_ts = sorted({p.t for p, _ in work})
        tpos = {t: u for u, t in enumerate(uniq_ts)}
        F = np.stack([self.snaps[t].free_mat for t in uniq_ts])
        WO = np.stack([self.snaps[t].wprice_order for t in uniq_ts])
        WOD = np.stack([self.snaps[t].wprice_order_desc for t in uniq_ts])
        SO = np.stack([self.snaps[t].sprice_order for t in uniq_ts])
        si = np.array([tpos[p.t] for p, _ in work], dtype=np.int64)

        # ---- rounding selection, fused across subset sizes -------------
        # every round's feasibility is independent of the other rounds,
        # so the evaluation is windowed: a short first window settles the
        # common case (round 1-2 feasible) at a fraction of the (C, S,
        # M, P) tensor, and only the stragglers pay the full-S pass
        # (recomputing a round gives the identical floats)
        Ms = np.array([len(p.cand.machines) for p, _ in work])
        M_max = int(Ms.max())
        P = wdem_act.size
        Fa = np.zeros((n_work, M_max, P))
        W1s = np.empty(n_work)
        for i, (p, _) in enumerate(work):
            Fa[i, :Ms[i]] = self.snaps[p.t].free_act[p.cand.machines]
            W1s[i] = p.cand.W1

        def _eval_rounds(sel: np.ndarray, r0: int, r1: int):
            """(feas, cov_v, pack_v) for candidates ``sel`` over rounds
            [r0, r1) — cell-for-cell the structured scalar evaluation
            (padded machine slots contribute rel = 0, absorbed exactly
            by the >= 0 clamp, and exact zeros to the integer sums).
            Rounds are mutually independent, so any window partition
            evaluates to the same floats as one full pass."""
            nR = r1 - r0
            Wp = np.zeros((sel.size, nR, M_max))
            Sp = np.zeros((sel.size, nR, M_max))
            for a, i in enumerate(sel):
                _, X = work[int(i)]
                M = Ms[i]
                Wp[a, :, :M] = X[r0:r1, :M]
                Sp[a, :, :M] = X[r0:r1, M:]
            wsum = Wp.sum(axis=2)                        # integer-exact
            Wf = W1s[sel]
            cov_v = np.where(
                (Wf > 0)[:, None],
                np.maximum(
                    (Wf[:, None] - wsum)
                    / np.maximum(Wf, 1e-12)[:, None], 0.0,
                ),
                0.0,
            )
            cap_lhs = (Wp[:, :, :, None] * wdem_act
                       + Sp[:, :, :, None] * sdem_act)   # (C, r, M, P)
            b = Fa[sel][:, None, :, :]
            with np.errstate(divide="ignore", invalid="ignore"):
                rel = np.where(
                    b > 0,
                    (cap_lhs - b) / np.maximum(b, 1e-12),
                    np.where(cap_lhs > 0, np.inf, 0.0),
                )
            pack_v = rel.reshape(sel.size, nR, -1).max(axis=2)
            relw = (wsum - batch_cap) / max(batch_cap, 1e-12)
            pack_v = np.maximum(pack_v, relw)
            pack_v = np.maximum(pack_v, 0.0)
            feas = (cov_v <= cfg.cover_slack + 1e-9) & (pack_v <= 1e-9)
            return feas, cov_v, pack_v

        R0 = min(4, S)
        all_c = np.arange(n_work)
        feas0, cov0, pack0 = _eval_rounds(all_c, 0, R0)
        rfeas = feas0.any(axis=1)
        pick = np.zeros(n_work, dtype=np.int64)
        pick[rfeas] = feas0[rfeas].argmax(axis=1)  # global first feasible
        rest = np.flatnonzero(~rfeas)
        if rest.size and S > R0:
            # evaluate ONLY the remaining rounds and splice the windows —
            # no round is ever evaluated twice
            feas1, cov1, pack1 = _eval_rounds(rest, R0, S)
            got = feas1.any(axis=1)
            first = R0 + feas1.argmax(axis=1)
            # infeasible rows replay np.lexsort((cov, pack))[0] exactly:
            # smallest pack_v, ties by smallest cov_v, ties by index
            cov_v = np.concatenate([cov0[rest], cov1], axis=1)
            pack_v = np.concatenate([pack0[rest], pack1], axis=1)
            pmin = pack_v.min(axis=1, keepdims=True)
            t1 = pack_v == pmin
            covm = np.where(t1, cov_v, np.inf)
            t2 = t1 & (covm == covm.min(axis=1, keepdims=True))
            pick[rest] = np.where(got, first, t2.argmax(axis=1))
            rfeas[rest] = got
        elif rest.size:
            # S <= R0: the first window was already the whole range
            cov_v, pack_v = cov0[rest], pack0[rest]
            pmin = pack_v.min(axis=1, keepdims=True)
            t1 = pack_v == pmin
            covm = np.where(t1, cov_v, np.inf)
            t2 = t1 & (covm == covm.min(axis=1, keepdims=True))
            pick[rest] = t2.argmax(axis=1)
        attempts = np.where(rfeas, pick + 1, S).astype(np.int64)

        # ---- scatter picks onto the full machine axis ------------------
        Wall = np.zeros((n_work, H), dtype=np.int64)
        Sall = np.zeros((n_work, H), dtype=np.int64)
        ws: List[Optional[np.ndarray]] = [None] * n_work
        ss: List[Optional[np.ndarray]] = [None] * n_work
        for i, (p, X) in enumerate(work):
            machines = p.cand.machines
            M = Ms[i]
            j = int(pick[i])
            Wall[i, machines] = X[j, :M]
            Sall[i, machines] = X[j, M:]
            ws[i], ss[i] = Wall[i], Sall[i]

        # ---- repair (infeasible roundings), one stacked pass -----------
        # the whole greedy repair collapses to: clip detection (batched
        # over every candidate of every slot at once), head-room rows
        # (stacked slot operands), and the closed-form prefix fill; only
        # candidates whose clip phase actually fires (rare) fall back to
        # the scalar ``_repair``, which re-derives everything after
        # clipping
        need_repair = np.flatnonzero(~rfeas)
        if need_repair.size:
            ti = need_repair
            Wst = Wall[ti].copy()                        # (C, H)
            Sst = Sall[ti].copy()
            Fr = F[si[ti]]                               # (C, H, R)
            need_mat = (Wst[:, :, None] * snap0.wdem
                        + Sst[:, :, None] * snap0.sdem)  # (C, H, R)
            okrow = (need_mat <= Fr + 1e-9).all(axis=2)
            clip = (((Wst > 0) | (Sst > 0)) & ~okrow).any(axis=1)
            for c in np.flatnonzero(clip):
                i = int(ti[c])
                snap = self.snaps[work[i][0].t]
                w, s = _repair(job, snap, ws[i], ss[i], work[i][0].cand.W1)
                ws[i], ss[i] = w, (s if w is not None else None)
            clean = np.flatnonzero(~clip)
            if clean.size:
                idx = ti[clean]
                Wc, Sc = Wst[clean], Sst[clean]
                W1c = W1s[idx]
                wsum1 = Wc.sum(axis=1)
                need = np.ceil(W1c - wsum1).astype(np.int64)
                budget = (job.batch_size - wsum1).astype(np.int64)
                heads = _headroom_from_aux(
                    self._aux_stacked("w", F[si[idx]]), "w", Wc, Sc
                )
                X = np.minimum(need, budget)
                order = WO[si[idx]]                      # (C, H) per-slot
                hv = np.minimum(np.take_along_axis(heads, order, 1),
                                np.maximum(X, 0)[:, None])
                prefix = np.cumsum(hv, axis=1) - hv
                takes = np.clip(X[:, None] - prefix, 0, hv)
                takes[need <= 0] = 0              # cover already satisfied
                ci = np.arange(clean.size)
                Wc[ci[:, None], order] += takes
                fail = (need > 0) & (need - takes.sum(axis=1) > 0)
                for c, i in enumerate(idx):
                    i = int(i)
                    if fail[c]:
                        ws[i] = ss[i] = None
                        continue
                    w = Wc[c]
                    ws[i], ss[i] = w, Sc[c]
                    if w.sum() > job.batch_size:  # rounding overshoot: trim
                        excess = int(w.sum() - job.batch_size)
                        od = WOD[si[i]]
                        wv = w[od]
                        pre = np.cumsum(wv) - wv
                        tk = np.clip(excess - pre, 0, wv)
                        w[od] -= tk

        # ---- ratio guarantee (all surviving candidates), one pass ------
        alive = np.array([i for i in range(n_work) if ws[i] is not None],
                         dtype=np.int64)
        if alive.size:
            Wst = np.stack([ws[i] for i in alive])
            Sst = np.stack([ss[i] for i in alive])
            need = (np.maximum(
                1, np.ceil(Wst.sum(axis=1) / job.gamma)
            ).astype(np.int64) - Sst.sum(axis=1))
            todo = np.flatnonzero(need > 0)
            if todo.size:
                idx = alive[todo]
                Wc, Sc, needc = Wst[todo], Sst[todo], need[todo]
                heads = _headroom_from_aux(
                    self._aux_stacked("s", F[si[idx]]), "s", Wc, Sc
                )
                order = SO[si[idx]]
                hv = np.minimum(np.take_along_axis(heads, order, 1),
                                needc[:, None])
                prefix = np.cumsum(hv, axis=1) - hv
                takes = np.clip(needc[:, None] - prefix, 0, hv)
                ci = np.arange(todo.size)
                Sc[ci[:, None], order] += takes
                fail = needc - takes.sum(axis=1) > 0
                for c, i in enumerate(idx):
                    ss[int(i)] = None if fail[c] else Sc[c]

        # ---- assemble results ------------------------------------------
        for i, (p, _) in enumerate(work):
            ext = None
            w, s = ws[i], ss[i]
            if w is not None and s is not None and int(w.sum()) != 0:
                snap = self.snaps[p.t]
                alloc = Allocation(
                    workers={int(h): int(w[h]) for h in np.flatnonzero(w > 0)},
                    ps={int(h): int(s[h]) for h in np.flatnonzero(s > 0)},
                )
                ext = ThetaResult(
                    cost=_alloc_cost(snap, alloc),
                    alloc=alloc,
                    mode="external",
                    lp_cost=self.lp_results[p.lp_index].objective,
                    rounding_attempts=int(attempts[i]),
                )
            cands = [c for c in (p.internal, ext) if c is not None]
            memo[keys[i]] = (min(cands, key=lambda r: r.cost)
                             if cands else None)


def solve_plans(plans: List[SolvePlan]) -> None:
    """Stack EVERY plan's LP candidates into one structure-aware solve —
    the cross-job half of the batched offer path (same-slot jobs share
    the ledger until an admission reprices, so their instances coexist
    in one batch; the exact-replay groups and the simplex-fallback
    stacks both span jobs). Plans that already have results are skipped;
    plans forcing ``lp_solver="simplex"`` batch separately so the parity
    mode never mixes into the fast path."""
    todo = [p for p in plans if p.lp_results is None]
    for p in todo:
        # chaos-harness dispatch hook: fire per plan that actually built
        # LPs, BEFORE any solve, so a raised SolverFault leaves every
        # plan unresolved (no partial batch to reconcile)
        if p.cfg.lp_fault_hook is not None and p.lp_built:
            p.cfg.lp_fault_hook("lp_batch")
    by_mode: Dict[bool, List[SolvePlan]] = {}
    for p in todo:
        force = _resolve_lp_solver(p.cfg, p.cluster) == "simplex"
        by_mode.setdefault(force, []).append(p)
    for force, group in by_mode.items():
        probs: List = []
        offsets = []
        for p in group:
            offsets.append(len(probs))
            probs.extend(p.lp_built)
        if not probs:
            for p in group:
                p.install_lp_results([])
            continue
        results = solve_lp_batch(probs, force_simplex=force)
        for p, off in zip(group, offsets):
            p.install_lp_results(results[off:off + len(p.lp_built)])
