"""Algorithm 3: dynamic program over per-slot workload (Eq. 21).

Theta(t_tilde, V) = min_{v in [0, V]} { theta(t_tilde, v) + Theta(t_tilde-1, V-v) }

The paper enumerates v at sample granularity — O(T K^2 E^2) states, which is
exact but astronomically slow for realistic K*E (~1e7).  We quantize the
workload into ``quanta`` equal units (default 32): v ranges over multiples of
V/quanta.  This preserves the DP structure (Eq. 21) at bounded granularity;
quanta can be raised for exactness on small instances (the competitive-ratio
benchmark uses the exact setting).

Min-plus formulation
--------------------
With C[k] the cost row over finished units after k slots, one forward step is
the min-plus (tropical) convolution

    C[k][u] = min_{0 <= v <= u} C[k-1][u - v] + theta_k[v],

i.e. a tropical vector-matrix product against the lower-triangular Toeplitz
operand built from C[k-1] (see ``repro_torch.kernels.minplus``). The whole
sweep over a job's slots runs as ONE call: the fused CUDA kernel on a CUDA
ledger, its plain torch version on a CPU one — both bit-identical to the
scalar double loop, so decisions never depend on where it ran. The cost
table is a dense ``(k+1, Q+1)`` float64 ndarray on the host; the choice
(backtracking) table mirrors it.

The forward table C[t][u] = min cost to finish u units within [a_i, t]
is shared across all completion-time candidates of Algorithm 2, which
turns Algorithm 2+3 from O(T^2) DP runs into one pass.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..kernels.minplus import minplus_sweep_host
from ..obs import trace as _trace
from .cluster import Cluster
from .job import Allocation, JobSpec
from .pricing import PriceTable
from .solve_plan import SolvePlan, infeasible_levels
from .subproblem import (
    PriceSnapshot,
    SubproblemConfig,
    ThetaResult,
    solve_theta_snapshot,
)


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
        plan: Optional[SolvePlan] = None,
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
        # levels whose workload caps fail on BOTH theta paths — a pure
        # function of the job, memoized once so neither the plan nor a
        # rolling window's repeated solve_prefix calls re-derive them
        # (no snapshot, no LP, no rng on these levels in the reference)
        self._infeasible_v = infeasible_levels(job, self.quanta, self.unit)
        # optional pre-built solve plan (PDORS.offer_batch / sim arrival
        # batches build one per job and stack their LP candidates); when
        # None and cfg.use_plan, solve_prefix builds its own
        self._plan = plan

    # ------------------------------------------------------------------
    def snapshot(self, t: int) -> PriceSnapshot:
        if t not in self._snaps:
            self._snaps[t] = PriceSnapshot(self.job, self.cluster, self.prices, t)
        return self._snaps[t]

    def _theta_rng(self, t: int, units: int) -> np.random.Generator:
        """rng for one theta(t, units) evaluation.

        In "compat" mode this is the scheduler's sequential stream (kept
        bit-aligned with core/_reference.py). In "derived" mode each
        (job, t, v) gets its own generator seeded from
        (cfg.seed, job_id, t, units), so the result is a pure function of
        the ledger state — independent of the order in which the simulator
        (or a batched offer path) happens to evaluate thetas."""
        if self.cfg.rng_mode != "derived":
            return self.rng
        # negative seeds map above 2**63 (not onto their positive twins),
        # keeping the key path injective
        s = int(self.cfg.seed)
        s = s if s >= 0 else (1 << 63) - s
        return np.random.default_rng(
            np.random.SeedSequence(
                (s, int(self.job.job_id), int(t), int(units))
            )
        )

    def theta(self, t: int, units: int) -> Optional[ThetaResult]:
        key = (t, units)
        if key not in self._theta:
            if units in self._infeasible_v:
                # both candidate paths fail their workload cap (constraint
                # (4) internally, (25)-vs-(26) externally) before touching
                # prices or rng — memoize without building anything
                self._theta[key] = None
            else:
                self._theta[key] = solve_theta_snapshot(
                    self.job, self.snapshot(t), units * self.unit, self.cfg,
                    self._theta_rng(t, units),
                )
        return self._theta[key]

    # ------------------------------------------------------------------
    def _theta_costs(self, t: int) -> np.ndarray:
        """theta(t, v) cost for v = 0..Q as one vector (+inf = infeasible).

        With the solve plan active (the default) every level is already
        memoized by ``_ensure_plan`` and this is a pure memo read. On the
        lazy path the internal candidates for every uncached workload
        level are batch-solved up front (one (K, H, R) comparison instead
        of K per-level passes); results land in the snapshot's memo that
        ``solve_theta_internal`` reads, so values are unchanged. Levels
        in ``_infeasible_v`` never reach the solve path at all."""
        Q = self.quanta
        job = self.job
        snap = self.snapshot(t)
        tps = job.time_per_sample(internal=True)
        pairs = []
        for v in range(1, Q + 1):
            if (t, v) in self._theta:
                continue
            w_need = max(1, int(math.ceil((v * self.unit) * tps)))
            if w_need <= job.batch_size:
                pairs.append(
                    (w_need, max(1, int(math.ceil(w_need / job.gamma))))
                )
        if pairs:
            snap.precompute_internal(pairs)
        tcost = np.zeros(Q + 1)
        for v in range(1, Q + 1):
            th = self.theta(t, v)
            tcost[v] = np.inf if th is None else th.cost
        return tcost

    def _ensure_plan(self, t_end: int) -> None:
        """Build (or adopt) the solve plan covering [a_i, t_end] and
        resolve every pending theta into the memo.

        Plan building and the batched LP solve are rng-free;
        ``resolve_into`` then consumes the rng in the exact (t asc,
        v asc) order the lazy per-(t, v) loop would, so both rng modes
        stay bit-aligned (see core.solve_plan). A plan is only adopted
        while it is fresh (no ledger mutation since build) and covers the
        requested range; otherwise the lazy path takes over seamlessly —
        theta() falls back per (t, v)."""
        a = self.job.arrival
        if self._plan is not None and (
            self._plan.quanta != self.quanta
            or not self._plan.covers(a, t_end)
        ):
            self._plan = None           # wrong shape: fall back
        if self._plan is not None and not self._plan.fresh():
            # stale plan (the ledger moved since build — e.g. an earlier
            # admission in a batched offer): reconcile it in place. Only
            # the slots whose rows actually changed are re-collected and
            # re-solved; decision-identical to a cold rebuild
            # (tests/test_solve_plan.py). Falls back to the rebuild when
            # the window slid underneath the plan.
            skip = set(self._theta) | {
                (t, v) for t in range(a, t_end + 1)
                for v in self._infeasible_v
            }
            if not self._plan.patch(skip=skip):
                self._plan = None       # window slid: rebuild from scratch
        if self._plan is None:
            if not self.cfg.use_plan:
                return
            skip = set(self._theta) | {
                (t, v) for t in range(a, t_end + 1)
                for v in self._infeasible_v
            }
            self._plan = SolvePlan(
                self.job, self.cluster, self.prices, self.cfg,
                a, t_end, quanta=self.quanta, skip=skip,
            )
        # share the fused snapshots so reconstruct()/tests see one cache
        for t, s in self._plan.snaps.items():
            self._snaps.setdefault(t, s)
        self._plan.resolve_into(self._theta, self._theta_rng)

    def solve_prefix(self, t_end: int) -> np.ndarray:
        """Forward DP over slots [a_i, t_end]; returns cost table C where
        C[k][u] = min cost using the first k slots to finish u units.

        The theta grid is solved through the plan-then-solve pipeline
        first (``core.solve_plan``: fused snapshot bundles + one batched
        stacked-tableau LP solve + reference-order resolution), so the
        slot loop below is a pure consumer — ``_theta_costs`` reads the
        memo. ``cfg.use_plan=False`` restores the lazy per-(t, v) loop
        (bit-identical results, slower in the LP-bound regime).

        All ``tcost`` rows are gathered first and the k min-plus steps run
        as ONE sweep (see module docstring). Gathering first keeps the rng
        order: ``_theta_costs`` is the only rng consumer and is still
        called in t-ascending order, and the sweep consumes no rng. The
        sweep runs on the ledger's device: the CUDA kernel on a CUDA
        ledger (one copy in, one launch, one copy back, one sync), the
        plain torch version on a CPU one."""
        a = self.job.arrival
        Q = self.quanta
        device = self.cluster.backend.device
        self._ensure_plan(t_end)
        k = t_end - a + 1
        with _trace.span("dp.sweep", slots=k, quanta=Q,
                         backend=device.type):
            tcost = np.stack([self._theta_costs(t)
                              for t in range(a, t_end + 1)])
            C, self._choice = minplus_sweep_host(tcost, device)
        return C

    def reconstruct(self, t_end: int, C: np.ndarray) -> Optional[DPResult]:
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
            v = int(self._choice[kk][u])
            if v < 0:
                return None
            if v > 0:
                t = a + kk - 1
                th = self.theta(t, v)
                assert th is not None
                slots[t] = th
                total += th.cost
            u -= v
        return DPResult(cost=total, slots=slots)
