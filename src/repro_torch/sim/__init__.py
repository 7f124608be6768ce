"""repro_torch.sim — event-driven rolling-horizon cluster simulation.

The paper's experiments (§5, Figs. 9-17) evaluate PD-ORS *online*: jobs
arrive over a long trace, run, complete, fail, and free resources while the
scheduler keeps admitting. The repo's static path (``run_pdors``) instead
freezes one (T, H, R) ledger and offers each job exactly once — faithful to
the paper's fixed-T formulation, but unable to express completions,
preemption, or streams longer than T. This package is the discrete-event
substrate that closes that gap.

Event model
-----------
A heap-ordered clock (``events.EventQueue``) drives the event kinds:
ARRIVAL, COMPLETION, DEPARTURE, FAILURE, PREEMPT, MACHINE_DOWN,
MACHINE_UP, RESHAPE. Within one slot the processing order is fixed
(machine recoveries -> machine crashes/degradations -> job failures ->
arrival batch -> exogenous departures -> slot tick -> progress
accounting -> elastic reshape triggers), and
ties break by insertion order, so a trace replays to the identical event
log on every run. Same-slot arrivals are
offered to the policy as ONE batch, which lets the PD-ORS adapter amortize
its price-tensor construction across the burst (``PriceTable.prewarm``).

Fault model and recovery
------------------------
``faults.FaultPlan`` generates machine crash/straggler incidents (and an
LP-dispatch solver-fault hook) under derived per-(machine, incident)
seeds, the same seeds as the JAX package's; the engine folds active
incidents into the cluster's capacity mask and evicts displaced jobs
through the PREEMPT path. ``ResilientPolicy`` contains solver faults with
a retry-then-greedy-fallback ladder so an offer is never dropped; it
catches ``SolverFault`` only, so a kernel's launch error propagates. The
engine checkpoints its state every K slots (a deep copy, the device
ledger included) and journals stream pulls; ``SimEngine.recover()``
resumes a killed run bit-identically. A ledger violation raises
``LedgerInvariantError`` with the partial report and journal tail.

Rolling horizon vs the paper's fixed T
--------------------------------------
The paper prices a fixed horizon [0, T) up front; its competitive-ratio
analysis (Theorems 5-6) lives in that setting, and ``run_pdors`` keeps
reproducing it bit-for-bit against ``core/_reference.py``. The simulator
replaces the fixed T with a *sliding lookahead window* of W slots
(``window.RollingWindow``): ledger index k always means "wall-clock slot
now + k"; as a slot elapses its row rolls off the front (releasing every
commitment in it for free) and a zero row extends the pricing horizon at
the back. Arriving jobs are offered with window-relative arrival 0, so the
unmodified Algorithm 1-4 machinery — snapshots, cached price matrices,
min-plus DP, the LP + rounding subproblem — schedules against the window
exactly as it would against the paper's [0, T). The trade is explicit:
W bounds how far ahead a job may be scheduled (a job that cannot finish
within W is rejected), in exchange for streams of unbounded length with
completions, failures, and preemption.

Determinism contract
--------------------
Every random decision in the subsystem is drawn from a generator derived
via ``np.random.SeedSequence`` from an integer key path — per (trace seed,
job index) for job parameters/arrival gaps/failure slots (``traces``), per
(policy seed, tag, job, attempt) for PD-ORS offers, per (policy seed, tag,
slot) for baseline placement scans, and per (cfg.seed, job, t, v) for the
rounding rng when ``SubproblemConfig.rng_mode == "derived"``. No component
shares a sequential stream with any other, so skipping, reordering, or
replaying any part of a simulation never shifts another part's draws. The
one deliberate exception: ``rng_mode="compat"`` reproduces the frozen
reference core's sequential stream (with its burn accounting), which is
what lets the ``pdors`` and ``pdors_ref`` adapters make bit-identical
decisions on the same trace — the rolling-horizon extension of the static
golden-parity guarantee.

Public API
----------
    Event, EventKind, EventQueue          — events
    RollingWindow                         — sliding cluster view
    SchedulingPolicy, Decision,
    register_policy, make_policy,
    available_policies                    — unified policy registry
    TraceConfig, stream, sample_jobs,
    calibrate_prices                      — trace replay
    ResilientPolicy                       — degraded-mode wrapper
    FaultPlan, FaultIncident,
    SolverFaultInjector,
    merge_event_streams                   — chaos harness
    MetricsCollector                      — metrics pipeline
    SimEngine, simulate, SimReport,
    SimKilled, LedgerInvariantError       — the engine
    OfferService                          — asyncio offer-service boundary
"""
from .events import Event, EventKind, EventQueue
from .window import RollingWindow
from .policy import (
    Decision,
    ResilientPolicy,
    SchedulingPolicy,
    available_policies,
    make_policy,
    register_policy,
)
from .traces import TraceConfig, calibrate_prices, sample_jobs, stream
from .faults import (
    FaultIncident,
    FaultPlan,
    SolverFaultInjector,
    merge_event_streams,
)
from .metrics import MetricsCollector
from .engine import (
    LedgerInvariantError,
    SimEngine,
    SimKilled,
    SimReport,
    simulate,
)
from .service import OfferService

__all__ = [
    "Event", "EventKind", "EventQueue",
    "RollingWindow",
    "Decision", "SchedulingPolicy", "ResilientPolicy",
    "register_policy", "make_policy", "available_policies",
    "TraceConfig", "stream", "sample_jobs", "calibrate_prices",
    "FaultPlan", "FaultIncident", "SolverFaultInjector",
    "merge_event_streams",
    "MetricsCollector",
    "SimEngine", "SimReport", "simulate",
    "SimKilled", "LedgerInvariantError",
    "OfferService",
]
