"""Unified policy protocol + registry for the event-driven simulator.

Every scheduler — PD-ORS (vectorized), the frozen pre-vectorization
reference core, and the fifo/drf/dorm baselines — is wrapped behind one
protocol::

    decision = policy.offer(event, view)   # view: RollingWindow

so all of them run under *identical accounting*: every ledger mutation
flows through ``RollingWindow.commit``/``release_from``, progress is
accrued by the engine from the committed allocation of the current slot
via the same Eq. (1)/Fact 1 throughput model, and completions/JCTs/utility
are measured by the engine, never by the policy. (The static harnesses —
``run_pdors`` and ``_SlotSim`` — keep their own accounting and remain
bit-compatible with ``core/_reference.py``; this module never touches
them.)

Two policy shapes exist behind the same protocol:

  * arrival-driven (``pdors``, ``pdors_ref``): react to ARRIVAL events by
    committing a full forward schedule into the window (and to PREEMPT by
    having the engine re-offer the residual workload);
  * slot-driven (``fifo``, ``drf``, ``dorm``): react to the per-slot SLOT
    tick by committing current-slot grants; nothing persists in the ledger
    across slots, so "holding" a machine means re-granting the same
    allocation every slot (fifo/dorm) while drf re-solves from scratch.

rng discipline: adapters never share a sequential stream. Every random
decision is drawn from a generator derived from
``SeedSequence((base_seed, policy_tag, ...))`` — per job for fifo's fixed
worker count, per slot for placement scan starts, per (job, attempt) for
PD-ORS offers — so replaying a trace, or reordering policy runs, can never
shift another decision's draws.

Registry: ``@register_policy(name)`` + ``make_policy(name, **kw)`` +
``available_policies()``. ``repro_torch.launch.sim`` and the tests only
go through the registry.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core import _reference as _ref
from ..core.baselines import (
    dorm_grant_loop,
    drf_grant_loop,
    place_round_robin_free,
)
from ..core.job import Allocation, JobSpec
from ..core.pricing import PriceParams, PriceTable
from ..core.schedule import find_best_schedule
from ..core.solve_plan import SolvePlan, solve_plans
from ..core.subproblem import SolverFault, SubproblemConfig
from ..obs import trace as _trace
from ..obs.metrics import warn_once_event
from ..obs.pd_gap import PDGapTracker
from .events import Event, EventKind
from .window import RollingWindow

# policy tags folded into derived seeds so no two policies (or purposes)
# ever share a stream. NOTE: pdors_ref deliberately has no tag of its own —
# it reuses _TAG_PDORS per (job, attempt), which is exactly what makes its
# decisions bit-identical to PDORSPolicy(rng_mode="compat") on a trace.
_TAG_PDORS, _TAG_FIFO, _TAG_DRF, _TAG_DORM = 1, 2, 3, 4
_TAG_RESILIENT = 5  # ResilientPolicy's greedy-fallback placement draws


def _nonneg(k: int) -> int:
    """Injective map into SeedSequence's non-negative domain: negatives land
    above 2**63 instead of folding onto their positive twins, so seed -1
    and seed 1 really are different streams."""
    k = int(k)
    return k if k >= 0 else (1 << 63) - k


def derived_rng(*keys: int) -> np.random.Generator:
    """Generator seeded from an integer key path (order-independent of any
    other draw in the simulation)."""
    return np.random.default_rng(
        np.random.SeedSequence(tuple(_nonneg(k) for k in keys))
    )


@dataclass
class Decision:
    """What a policy did with an event (bookkeeping for the engine; the
    ledger itself was already updated through the view).

    ``admitted``  — job_id -> bool for ARRIVAL offers (arrival-driven).
    ``schedules`` — job_id -> {absolute slot -> Allocation} committed.
    ``grants``    — job_id -> current-slot Allocation (slot-driven)."""

    admitted: Dict[int, bool] = field(default_factory=dict)
    schedules: Dict[int, Dict[int, Allocation]] = field(default_factory=dict)
    grants: Dict[int, Allocation] = field(default_factory=dict)


class SchedulingPolicy:
    """Base adapter: dispatches ``offer(event, view)`` to per-kind hooks."""

    name: str = "base"
    slot_driven: bool = False
    # arrival-driven policies get the residual workload of a preempted job
    # re-offered as a fresh ARRIVAL; slot-driven ones just keep the job in
    # the active set and re-place it on the next tick
    reoffers_on_preempt: bool = False
    # whether the SLOT tick's per-job progress payload is read (Dorm's
    # fairness order). Policies that never read it declare False so the
    # batched engine can skip building the dict each slot — the Event
    # payload differs, decisions cannot
    wants_progress: bool = True

    def bind(self, view: RollingWindow, seed: int) -> None:
        self.view = view
        self.seed = int(seed)

    # -- protocol ------------------------------------------------------
    def offer(self, event: Event, view: RollingWindow) -> Decision:
        """The one entry point through which the engine talks to a policy.

        What the view exposes
        ---------------------
        ``view`` is the live ``RollingWindow``: ``view.now`` (current
        absolute slot), ``view.lookahead`` (window width W),
        ``view.cluster`` (the dense ledger + capacity matrices, for
        price-table/snapshot machinery), ``view.free_map()`` (current-slot
        free capacity as a mutable {(h, r): amount} map),
        ``view.rel_job(job)`` (the job as the window-relative scheduler
        sees it), and ``view.alloc_at(job_id, t_abs)`` (what a job holds).
        The view is shared, not a copy — policies may *read* anything, but
        every mutation MUST go through ``view.commit`` /
        ``view.commit_schedule`` / ``view.release_from`` so per-job
        commitments stay consistent with the ledger.

        What a legal grant is
        ---------------------
        A grant is an ``Allocation`` committed at an absolute slot inside
        the window, `now <= t_abs < now + W`, that keeps every ledger cell
        within machine capacity (the engine asserts
        ``view.oversubscribed()`` is False after every slot when
        ``check_ledger`` is on). Arrival-driven policies commit a full
        forward schedule during ARRIVAL and report it in
        ``Decision.admitted`` / ``Decision.schedules``; slot-driven
        policies commit current-slot allocations during SLOT and report
        them in ``Decision.grants``. Committing nothing (and
        ``admitted[job_id] = False``) is a rejection. A slot-driven
        "held" resource must be re-granted every slot — rolling ledger
        rows do not persist across ``advance_to``.

        Engine-owned accounting invariants
        ----------------------------------
        The engine — never the policy — accrues progress (the committed
        allocation of the current slot earns ``samples_trained`` under
        Eq. (1)/Fact 1), detects completion (progress >= V_i), releases
        remaining rows, realizes utility u_i(actual JCT), applies
        patience departures, and records every metric. Policies are pure
        deciders: identical accounting is what makes per-policy rows in
        ``BENCH_sim.json`` comparable. COMPLETION / PREEMPT / DEPARTURE
        offers are notifications (return value ignored) — policies use
        them to drop internal state (e.g. held allocations), not to
        mutate the ledger: the engine has already released the rows.
        """
        if event.kind == EventKind.ARRIVAL:
            return self.on_arrivals(event, view)
        if event.kind == EventKind.SLOT:
            return self.on_slot(event, view)
        if event.kind == EventKind.COMPLETION:
            self.on_complete(event.subject(), event.time, view)
        elif event.kind == EventKind.PREEMPT:
            self.on_preempt(event.subject(), event.time, view)
        elif event.kind == EventKind.RESHAPE:
            self.on_reshape(event.subject(), event.time, view)
        elif event.kind == EventKind.DEPARTURE:
            self.on_depart(event.subject(), event.time, view)
        return Decision()

    # -- hooks (default no-ops) ----------------------------------------
    def on_arrivals(self, event: Event, view: RollingWindow) -> Decision:
        return Decision()

    def on_slot(self, event: Event, view: RollingWindow) -> Decision:
        return Decision()

    def on_complete(self, job_id: int, t: int, view: RollingWindow) -> None:
        pass

    def on_preempt(self, job_id: int, t: int, view: RollingWindow) -> None:
        pass

    def on_reshape(self, job_id: int, t: int, view: RollingWindow) -> None:
        """An elastic job's demand level changed mid-run: the engine has
        already released its residual rows, exactly like a preemption, so
        by default policies drop internal state the same way (slot-driven
        policies discard the held allocation and re-place the job's NEW
        demands next tick; arrival-driven policies see the reshaped spec
        as a requeued ARRIVAL)."""
        self.on_preempt(job_id, t, view)

    def on_depart(self, job_id: int, t: int, view: RollingWindow) -> None:
        pass


# ----------------------------------------------------------------------
_REGISTRY: Dict[str, type] = {}


def register_policy(name: str) -> Callable[[type], type]:
    def deco(cls: type) -> type:
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def make_policy(name: str, **kwargs) -> SchedulingPolicy:
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown policy {name!r}; available: {available_policies()}"
        ) from None
    return cls(**kwargs)


def available_policies() -> List[str]:
    return sorted(_REGISTRY)


# ======================================================================
# PD-ORS (vectorized core) over the rolling window
# ======================================================================
@register_policy("pdors")
class PDORSPolicy(SchedulingPolicy):
    """Algorithm 1 reacting to arrival events on the rolling window.

    Each arriving job is offered with window-relative arrival 0 against the
    window's ledger + price table; admission (payoff > 0) commits the full
    forward schedule. Same-slot batches amortize pricing: the (W, H, R)
    price tensor is prewarmed in ONE vectorized pass per batch (and once
    more after each admission reprices), instead of W lazy per-slot builds
    per job — the ROADMAP's batched multi-job offer path.

    ``rng_mode``:
      * "derived" (default) — per-(job, t, v) rounding rngs
        (SubproblemConfig.rng_mode="derived"), fully order-robust;
      * "compat"  — one fresh sequential stream per offer, seeded per
        (job, attempt), with the reference-aligned burn accounting; this is
        the mode under which ``pdors`` and ``pdors_ref`` produce
        bit-identical decisions on the same trace.

    ``use_warm_bundles`` is accepted and does nothing: the reference keeps
    a warm bundle store for re-offers on host ledgers only, and the port's
    ledger is always a device tensor, whose bundle pass is one fused
    kernel launch per plan either way.
    """

    reoffers_on_preempt = True

    def __init__(
        self,
        price_params: PriceParams,
        quanta: int = 16,
        cfg: Optional[SubproblemConfig] = None,
        rng_mode: str = "derived",
        use_warm_bundles: bool = True,
    ):
        if rng_mode not in ("derived", "compat"):
            raise ValueError(f"rng_mode must be derived|compat, got {rng_mode!r}")
        self.params = price_params
        self.quanta = quanta
        self.base_cfg = cfg or SubproblemConfig()
        self.rng_mode = rng_mode
        self.use_warm_bundles = bool(use_warm_bundles)
        self.attempts: Dict[int, int] = {}

    def bind(self, view: RollingWindow, seed: int) -> None:
        super().bind(view, seed)
        self.prices = PriceTable(self.params, view.cluster)
        # weak-duality telemetry (obs.pd_gap): rng-free float accumulation
        # per offer; decisions never read it. Rebinding (a fresh window)
        # restarts the accumulators with the fresh price table.
        self.pd_gap = PDGapTracker(self.prices)

    def pd_gap_stats(self) -> Optional[Dict[str, object]]:
        """Primal-dual telemetry snapshot (engine folds it into the
        summary; ``None`` before the first bind)."""
        gap = getattr(self, "pd_gap", None)
        return gap.snapshot() if gap is not None else None

    def fault_stats(self) -> Optional[Dict[str, int]]:
        """Solver-fault-injector dispatch counters, when a hook with
        injector-shaped stats is attached (``sim.faults``)."""
        hook = self.base_cfg.lp_fault_hook
        if hook is None or not hasattr(hook, "calls"):
            return None
        return {
            "solver_hook_calls": int(hook.calls),
            "solver_hook_raised": int(getattr(hook, "raised", 0)),
        }

    def _offer_cfg(self, job: JobSpec) -> tuple:
        """(cfg, rng) for one offer — peeks the attempt counter without
        consuming it (``_offer_one`` advances it)."""
        attempt = self.attempts.get(job.job_id, 0)
        key = (self.seed, _TAG_PDORS, job.job_id, attempt)
        if self.rng_mode == "derived":
            offer_seed = int(
                np.random.SeedSequence(
                    tuple(_nonneg(k) for k in key)
                ).generate_state(1)[0]
            )
            return replace(self.base_cfg, rng_mode="derived",
                           seed=offer_seed), None
        return replace(self.base_cfg, rng_mode="compat"), derived_rng(*key)

    def _offer_one(self, job: JobSpec, view: RollingWindow,
                   plan: Optional[SolvePlan] = None,
                   cfg: Optional[SubproblemConfig] = None,
                   rng: Optional[np.random.Generator] = None,
                   ) -> Optional[Dict[int, Allocation]]:
        if cfg is None:
            cfg, rng = self._offer_cfg(job)
        self.attempts[job.job_id] = self.attempts.get(job.job_id, 0) + 1
        rel = view.rel_job(job)
        with _trace.span("offer", job=int(job.job_id)) as osp:
            with _trace.span("offer.schedule"):
                sched = find_best_schedule(
                    rel, view.cluster, self.prices, view.lookahead,
                    cfg=cfg, quanta=self.quanta, rng=rng, plan=plan,
                )
            admitted = sched is not None and sched.payoff > 0
            osp.set(admitted=admitted)
        self.pd_gap.record_offer(
            admitted,
            sched.payoff if sched is not None else 0.0,
            rel.utility(sched.completion - rel.arrival) if admitted else 0.0,
        )
        if not admitted:
            return None
        return {view.now + t: a for t, a in sched.slots.items()}

    def on_arrivals(self, event: Event, view: RollingWindow) -> Decision:
        """Batched arrival offers: one price-tensor prewarm, one
        ``SolvePlan`` per job (rng-free; per-job cfg — the derived-mode
        seed differs per job), and every job's external LPs stacked into
        one structure-aware solve (``solve_plans``: the cover/packing
        exact-replay solver with stacked-simplex fallback — decisions
        identical either way). An admission reprices the window's
        ledger, invalidating the remaining pre-built plans; the rest of
        the batch falls back to per-job plans built inside the DP
        (``SolvePlan.fresh`` guards against a stale plan ever being
        consumed) — re-stacking after every admission would cost O(B^2)
        plan builds on admit-heavy batches."""
        dec = Decision()
        with _trace.span("offer.batch", jobs=len(event.jobs)):
            self.prices.prewarm()
            plans: Dict[int, Optional[SolvePlan]] = {}
            offer_env = {}
            if self.base_cfg.use_plan:
                for job in event.jobs:
                    cfg, rng = self._offer_cfg(job)
                    offer_env[job.job_id] = (cfg, rng)
                    rel = view.rel_job(job)
                    if rel.arrival < view.lookahead:
                        plan = SolvePlan(rel, view.cluster, self.prices,
                                         cfg, rel.arrival,
                                         view.lookahead - 1,
                                         quanta=self.quanta)
                    else:
                        plan = None
                    plans[job.job_id] = plan
                solve_plans([p for p in plans.values() if p is not None])
            for job in event.jobs:
                cfg, rng = offer_env.get(job.job_id, (None, None))
                schedule = self._offer_one(
                    job, view, plan=plans.get(job.job_id), cfg=cfg, rng=rng,
                )
                if schedule is None:
                    dec.admitted[job.job_id] = False
                    continue
                with _trace.span("offer.commit", job=int(job.job_id),
                                 slots=len(schedule)):
                    view.commit_schedule(job, schedule)
                dec.admitted[job.job_id] = True
                dec.schedules[job.job_id] = schedule
                # admission repriced every committed slot: rebuild the
                # price tensor once for the remaining jobs of the batch
                self.prices.prewarm()
        return dec


# ======================================================================
# Frozen pre-vectorization core (parity oracle) over the same window
# ======================================================================
@register_policy("pdors_ref")
class PDORSReferencePolicy(SchedulingPolicy):
    """The verbatim pre-PR scalar core (``core/_reference.py``) driven
    through the same window accounting.

    Each offer mirrors the window's dense ledger into the reference's
    dict-based ``Cluster`` (floats copied bit-for-bit), runs the frozen
    ``find_best_schedule``, and commits the result back through the view.
    With ``pdors`` in rng_mode="compat" and the same seed, the two policies
    make bit-identical decisions on any trace — the rolling-horizon
    generalization of the static golden-parity tests."""

    reoffers_on_preempt = True

    def __init__(
        self,
        price_params: PriceParams,
        quanta: int = 16,
        cfg: Optional[_ref.SubproblemConfig] = None,
    ):
        self.params = price_params
        self.quanta = quanta
        self.base_cfg = cfg or _ref.SubproblemConfig()
        self.attempts: Dict[int, int] = {}

    def bind(self, view: RollingWindow, seed: int) -> None:
        super().bind(view, seed)
        cl = view.cluster
        self._ref_machines = [
            _ref.Machine(h, dict(m.capacity)) for h, m in enumerate(cl.machines)
        ]
        self._ref_params = _ref.PriceParams(
            U=dict(self.params.U), L=self.params.L, mu=self.params.mu
        )

    def _mirror(self) -> _ref.Cluster:
        cl = self.view.cluster
        if cl._capacity_mask is None:
            machines = self._ref_machines  # clean cluster: bit-parity path
        else:
            # fault-degraded capacities: mirror the masked matrix so the
            # frozen core sees the same effective cluster as pdors
            machines = [
                _ref.Machine(h, {
                    r: float(cl.capacity_matrix[h, k])
                    for r, k in cl.res_index.items()
                })
                for h in range(cl.num_machines)
            ]
        ref = _ref.Cluster(machines=machines, horizon=cl.horizon)
        used = cl.backend.to_host(cl._used)
        for t, h, k in zip(*np.nonzero(used)):
            ref._used[(int(t), int(h), cl.resources[int(k)])] = float(
                used[t, h, k]
            )
        return ref

    def on_arrivals(self, event: Event, view: RollingWindow) -> Decision:
        dec = Decision()
        for job in event.jobs:
            attempt = self.attempts.get(job.job_id, 0)
            self.attempts[job.job_id] = attempt + 1
            rng = derived_rng(self.seed, _TAG_PDORS, job.job_id, attempt)
            refcl = self._mirror()
            prices = _ref.PriceTable(self._ref_params, refcl)
            sched = _ref.find_best_schedule(
                view.rel_job(job), refcl, prices, view.lookahead,
                cfg=self.base_cfg, quanta=self.quanta, rng=rng,
            )
            if sched is None or sched.payoff <= 0:
                dec.admitted[job.job_id] = False
                continue
            schedule = {view.now + t: a for t, a in sched.slots.items()}
            view.commit_schedule(job, schedule)
            dec.admitted[job.job_id] = True
            dec.schedules[job.job_id] = schedule
        return dec


# ======================================================================
# Slot-driven baselines
# ======================================================================
class _SlotPolicy(SchedulingPolicy):
    """Shared helpers for the slot-driven adapters."""

    slot_driven = True

    def _place(
        self,
        view: RollingWindow,
        job: JobSpec,
        n_workers: int,
        n_ps: int,
        rng: np.random.Generator,
        free: Optional[Dict[Tuple[int, str], float]] = None,
    ) -> Optional[Allocation]:
        """Round-robin placement against the current slot's free capacity
        (the exact ``_SlotSim`` scan), on a throwaway copy when a master
        free map is supplied — a failed partial placement must not drain
        it."""
        master = free if free is not None else view.free_map()
        trial = dict(master)
        alloc = place_round_robin_free(
            trial, view.cluster.num_machines, job, n_workers, n_ps, rng
        )
        if alloc is not None and free is not None:
            master.clear()
            master.update(trial)
        return alloc


@register_policy("fifo")
class FIFOPolicy(_SlotPolicy):
    """Hadoop/Spark-style FIFO: fixed worker count per job (drawn once from
    the job's derived rng), strict head-of-line blocking, resources held
    until completion (the held allocation is re-granted every slot)."""

    wants_progress = False

    def __init__(self, max_workers: int = 30):
        self.max_workers = max_workers
        self.fixed: Dict[int, int] = {}
        self.held: Dict[int, Allocation] = {}

    def _fixed_workers(self, job: JobSpec) -> int:
        nw = self.fixed.get(job.job_id)
        if nw is None:
            rng = derived_rng(self.seed, _TAG_FIFO, job.job_id)
            nw = int(min(job.batch_size, rng.integers(1, self.max_workers + 1)))
            self.fixed[job.job_id] = nw
        return nw

    def on_slot(self, event: Event, view: RollingWindow) -> Decision:
        dec = Decision()
        rng = derived_rng(self.seed, _TAG_FIFO, 10_000_019, event.time)
        # phase 1: every held allocation re-grants into the fresh slot row
        # BEFORE any new placement — a job "holding" its machines must never
        # lose them to a queue-mate placed into a stale free map, and the
        # head-of-line break below must not skip later held jobs
        for job in event.jobs:  # engine supplies (arrival, job_id) order
            held = self.held.get(job.job_id)
            if held is not None:
                # regrant = the fits(0,...)+commit(now,...) pair fused
                # (bit-identical decision and ledger; see RollingWindow)
                if view.regrant(job, held):
                    dec.grants[job.job_id] = held
                else:
                    # a fault shrank capacity under the lease (machine
                    # crash/straggler): drop it; the job re-places below.
                    # Clean runs never hit this — the same re-grant fit
                    # last slot against the same capacity.
                    del self.held[job.job_id]
        # phase 2: place waiting jobs in queue order against what remains
        for job in event.jobs:
            if job.job_id in self.held:
                continue
            nw = self._fixed_workers(job)
            ns = max(1, int(math.ceil(nw / job.gamma)))
            alloc = self._place(view, job, nw, ns, rng)
            if alloc is None:
                break  # strict FIFO: later jobs wait behind the head
            self.held[job.job_id] = alloc
            view.commit(view.now, job, alloc)
            dec.grants[job.job_id] = alloc
        return dec

    def on_complete(self, job_id: int, t: int, view: RollingWindow) -> None:
        self.held.pop(job_id, None)

    def on_preempt(self, job_id: int, t: int, view: RollingWindow) -> None:
        self.held.pop(job_id, None)   # re-placed from scratch next slot


@register_policy("drf")
class DRFPolicy(_SlotPolicy):
    """Dominant-resource fairness re-solved every slot, via the SAME
    ``drf_grant_loop`` the static ``DRFScheduler`` runs — only the
    placement substrate differs (a rolling-window free map instead of the
    fixed-horizon cluster)."""

    wants_progress = False

    def on_slot(self, event: Event, view: RollingWindow) -> Decision:
        actives = list(event.jobs)
        if not actives:
            return Decision()
        rng = derived_rng(self.seed, _TAG_DRF, event.time)
        cl = view.cluster
        total = {
            r: float(cl.capacity_matrix[:, k].sum())
            for r, k in cl.res_index.items()
        }
        free = view.free_map()
        allocs = drf_grant_loop(
            actives, total,
            lambda j, nw, ns: self._place(view, j, nw, ns, rng, free=free),
        )
        dec = Decision()
        for j in actives:
            a = allocs[j.job_id]
            if not a.empty():
                view.commit(view.now, j, a)
                dec.grants[j.job_id] = a
        return dec


@register_policy("dorm")
class DormPolicy(_SlotPolicy):
    """Utilization-maximizing greedy with a fairness order and an
    adjustment-overhead cap, via the SAME ``dorm_grant_loop`` the static
    ``DormScheduler`` runs; placed jobs hold their allocation (re-granted
    each slot, since rolling ledger rows do not persist)."""

    def __init__(self, adjust_cap: float = 0.5):
        self.adjust_cap = adjust_cap
        self.held: Dict[int, Allocation] = {}

    def on_slot(self, event: Event, view: RollingWindow) -> Decision:
        dec = Decision()
        actives = list(event.jobs)
        progress = event.progress or {}
        rng = derived_rng(self.seed, _TAG_DORM, event.time)
        for job in actives:          # re-grant held allocations first
            held = self.held.get(job.job_id)
            if held is not None:
                if view.regrant(job, held):
                    dec.grants[job.job_id] = held
                else:
                    # capacity shrank under the lease (fault domain):
                    # drop the hold; the grant loop may re-place the job
                    del self.held[job.job_id]
        if not actives:
            return dec

        def place_and_commit(j: JobSpec, nw: int, ns: int):
            alloc = self._place(view, j, nw, ns, rng)
            if alloc is not None:
                view.commit(view.now, j, alloc)
            return alloc

        for j, alloc in dorm_grant_loop(
            actives, progress, set(self.held), self.adjust_cap,
            place_and_commit,
        ):
            self.held[j.job_id] = alloc
            dec.grants[j.job_id] = alloc
        return dec

    def on_complete(self, job_id: int, t: int, view: RollingWindow) -> None:
        self.held.pop(job_id, None)

    def on_preempt(self, job_id: int, t: int, view: RollingWindow) -> None:
        self.held.pop(job_id, None)


# ======================================================================
# Degraded-mode wrapper: solver-fault containment
# ======================================================================
@register_policy("resilient")
class ResilientPolicy(SchedulingPolicy):
    """Wrap a policy so injected (or real) solver faults never lose an
    offer.

    Arrival batches are re-offered to the inner policy one job at a time
    (single-job sub-events), bounding a fault's blast radius to one job —
    the batch's other jobs still get their full solve. Per job the
    degradation ladder is:

      1. full inner offer;
      2. on ``SolverFault``: one retry with a tightened pivot budget
         (``max_lp_machines``/``rounding_rounds`` clamped to
         ``retry_budget``) — smaller LPs, same admission logic;
      3. on a second fault: greedy fallback — ``place_round_robin_free``
         packs the job slot-by-slot across the window and admits iff the
         whole workload fits, so the offer slot is *never* dropped, only
         decided with a cheaper mechanism.

    Health state (healthy/degraded/fallback) and per-rung counters are
    tracked in ``health_stats()`` (the engine folds them into the summary
    as ``policy_health``); each distinct fault category warns once. All
    other event kinds delegate straight to the inner policy, and fallback
    placement draws from per-(job, slot) derived seeds, so wrapping a
    policy changes nothing on a fault-free trace."""

    reoffers_on_preempt = True

    def __init__(
        self,
        inner="pdors",
        retry_budget: Tuple[int, int] = (8, 8),
        fallback_workers: int = 8,
        **inner_kwargs,
    ):
        self.inner = (inner if isinstance(inner, SchedulingPolicy)
                      else make_policy(inner, **inner_kwargs))
        # mirror the inner policy's shape so the engine drives us the way
        # it would drive the inner policy directly
        self.slot_driven = self.inner.slot_driven
        self.reoffers_on_preempt = self.inner.reoffers_on_preempt
        self.retry_budget = retry_budget
        self.fallback_workers = int(fallback_workers)
        self.health: Dict[str, object] = {
            "offers": 0, "solver_faults": 0, "retries": 0,
            "retry_recoveries": 0, "fallbacks": 0, "fallback_admits": 0,
            "state": "healthy",
        }

    def bind(self, view: RollingWindow, seed: int) -> None:
        super().bind(view, seed)
        self.inner.bind(view, seed)

    def health_stats(self) -> Dict[str, object]:
        return dict(self.health)

    def pd_gap_stats(self):
        f = getattr(self.inner, "pd_gap_stats", None)
        return f() if callable(f) else None

    def fault_stats(self):
        f = getattr(self.inner, "fault_stats", None)
        return f() if callable(f) else None

    def _warn_once(self, key: str, msg: str) -> None:
        # every containment increments the counter; the log record is
        # deduplicated per fault category per process (obs.metrics)
        warn_once_event(
            "repro_solver_fault_contained_total",
            f"resilient:{key}", msg, policy=self.inner.name, rung=key,
        )

    @contextmanager
    def _tightened(self):
        """Temporarily clamp the inner solver's budgets (retry rung)."""
        base = getattr(self.inner, "base_cfg", None)
        if base is None or not isinstance(base, SubproblemConfig):
            yield
            return
        lp_m, rounds = self.retry_budget
        self.inner.base_cfg = replace(
            base,
            max_lp_machines=min(base.max_lp_machines, int(lp_m)),
            rounding_rounds=min(base.rounding_rounds, int(rounds)),
        )
        try:
            yield
        finally:
            self.inner.base_cfg = base

    def offer(self, event: Event, view: RollingWindow) -> Decision:
        if event.kind != EventKind.ARRIVAL:
            return self.inner.offer(event, view)
        dec = Decision()
        for job in event.jobs:
            self.health["offers"] += 1
            sub = Event(time=event.time, kind=EventKind.ARRIVAL,
                        jobs=(job,))
            d = self._offer_laddered(sub, job, view)
            dec.admitted.update(d.admitted)
            dec.schedules.update(d.schedules)
            dec.grants.update(d.grants)
        return dec

    def _offer_laddered(self, sub: Event, job: JobSpec,
                        view: RollingWindow) -> Decision:
        try:
            d = self.inner.offer(sub, view)
            self.health["state"] = "healthy"
            return d
        except SolverFault as e:
            self.health["solver_faults"] += 1
            self.health["state"] = "degraded"
            self._warn_once(
                type(e).__name__,
                f"solver fault contained ({e}); retrying with a "
                f"tightened budget",
            )
        self.health["retries"] += 1
        try:
            with self._tightened():
                d = self.inner.offer(sub, view)
            self.health["retry_recoveries"] += 1
            return d
        except SolverFault as e:
            self.health["solver_faults"] += 1
            self._warn_once(
                "fallback",
                f"retry faulted too ({e}); greedy fallback engaged",
            )
        self.health["fallbacks"] += 1
        self.health["state"] = "fallback"
        d = self._fallback(job, view)
        if d.admitted.get(job.job_id):
            self.health["fallback_admits"] += 1
        return d

    def _fallback(self, job: JobSpec, view: RollingWindow) -> Decision:
        """Rung 3: pack the job's whole workload slot-by-slot with the
        shared round-robin greedy; admit iff it fits inside the window
        (a partial commit would strand an uncompletable job)."""
        dec = Decision()
        rng = derived_rng(self.seed, _TAG_RESILIENT, job.job_id, view.now)
        nw = max(1, min(int(job.batch_size), self.fallback_workers))
        ns = max(1, int(math.ceil(nw / job.gamma)))
        remaining = job.total_workload()
        schedule: Dict[int, Allocation] = {}
        trained = 0.0
        H = view.cluster.num_machines
        for k in range(view.lookahead):
            alloc = place_round_robin_free(
                view.free_map(k), H, job, nw, ns, rng
            )
            if alloc is None:
                continue
            schedule[view.now + k] = alloc
            trained += alloc.samples_trained(job)
            if trained >= remaining - 1e-9:
                break
        if trained < remaining - 1e-9:
            dec.admitted[job.job_id] = False
            return dec
        view.commit_schedule(job, schedule)
        dec.admitted[job.job_id] = True
        dec.schedules[job.job_id] = schedule
        return dec
