"""The port's chaos harness (``repro_torch.sim.faults``) and the engine's
fault, recovery and resilient paths on ``TorchBackend(device="cpu")``,
each held to the JAX package's ``repro.sim`` on its numpy backend: the
same seeds give the same incidents, events and solver-fault schedule; the
capacity mask scales the torch ledger's free and price tensors as numpy's;
the resilient ladder, ``recover()`` and the chaos storms decide as
``repro`` does (identical decision logs and summaries, utility within rel
1e-9); and a kernel's launch error under ``ResilientPolicy`` propagates
instead of being taken for a solver fault. The counterpart of
``tests/test_faults.py``."""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import pytest

import repro.core as ref_core
import repro.sim as ref_sim
from repro.core.subproblem import SolverFault as RefSolverFault
from repro_torch import core, sim
from repro_torch.core import Allocation, SubproblemConfig
from repro_torch.core.subproblem import SolverFault, SolverTimeout
from repro_torch.kernels import pricing
from repro_torch.sim import (Event, EventKind, FaultPlan, SolverFaultInjector,
                             merge_event_streams)
from test_torch_sim import (assert_same_run, cluster_of, ledger,
                            outcome_rows, record_decisions, small_job)

CHAOS_PLAN = dict(crash_rate=0.02, straggler_rate=0.02, downtime=(2, 8),
                  domains=[(0, 1), (2, 3)], domain_correlation=0.5)
# (plan kwargs, machines) of every plan test_faults.py draws
PLANS = [
    (dict(seed=5, until=200, **CHAOS_PLAN), 4),
    (dict(seed=6, until=200, **CHAOS_PLAN), 4),
    (dict(seed=1, until=400, crash_rate=0.1, straggler_rate=0.1,
          downtime=(2, 12)), 3),
    (dict(seed=2, until=600, crash_rate=0.02, domains=[(0, 1, 2)],
          domain_correlation=1.0), 3),
    (dict(seed=3, until=150, crash_rate=0.05), 2),
    (dict(seed=0, until=256, crash_rate=0.01, straggler_rate=0.01,
          downtime=(2, 8), domains=[(h, h + 1) for h in range(0, 15, 2)],
          domain_correlation=0.5, solver_fault_rate=0.2), 16),
    (dict(seed=-4, until=64, crash_rate=0.05, straggler_rate=0.05), 5),
]


def _incidents(plan, H):
    return [dataclasses.astuple(i) for i in plan.incidents(H)]


def _events(evs):
    return [(e.time, e.kind.name, e.machine, e.factor, e.incident)
            for e in evs]


# ------------------------------------------------------------- FaultPlan
@pytest.mark.parametrize("kw,H", PLANS)
def test_fault_plan_matches_repro(kw, H):
    """Incidents and the DOWN/UP stream equal ``repro``'s for the seed."""
    port, ref = FaultPlan(**kw), ref_sim.FaultPlan(**kw)
    assert _incidents(port, H) == _incidents(ref, H)
    assert _events(port.events(H)) == _events(ref.events(H))
    assert port.incidents(H), "plan generated no incidents"


def test_fault_plan_deterministic_and_seed_sensitive():
    plan = FaultPlan(seed=5, until=200, **CHAOS_PLAN)
    a = plan.incidents(4)
    assert a == plan.incidents(4)
    assert a
    assert a != FaultPlan(seed=6, until=200, **CHAOS_PLAN).incidents(4)


def test_fault_plan_incidents_never_self_overlap():
    incs = FaultPlan(seed=1, until=400, crash_rate=0.1, straggler_rate=0.1,
                     downtime=(2, 12)).incidents(3)
    ids = [i.incident for i in incs]
    assert len(ids) == len(set(ids))
    by_machine = {}
    for inc in incs:
        by_machine.setdefault(inc.machine, []).append(inc)
    for machine_incs in by_machine.values():
        machine_incs.sort(key=lambda i: i.down_at)
        for prev, nxt in zip(machine_incs, machine_incs[1:]):
            assert nxt.down_at >= prev.up_at
    for inc in incs:
        assert inc.duration >= 2
        if inc.kind == "crash":
            assert inc.factor == 0.0
        else:
            assert 0.3 <= inc.factor <= 0.7


def test_fault_plan_domain_correlation_spawns_peer_outages():
    incs = FaultPlan(seed=2, until=600, crash_rate=0.02,
                     domains=[(0, 1, 2)], domain_correlation=1.0).incidents(3)
    intervals = {}
    for i in incs:
        if i.kind == "crash":
            intervals.setdefault((i.down_at, i.up_at), set()).add(i.machine)
    assert any(ms == {0, 1, 2} for ms in intervals.values())


def test_fault_plan_events_pair_down_with_up():
    plan = FaultPlan(seed=3, until=150, crash_rate=0.05)
    incs, evs = plan.incidents(2), plan.events(2)
    downs = [e for e in evs if e.kind == EventKind.MACHINE_DOWN]
    ups = [e for e in evs if e.kind == EventKind.MACHINE_UP]
    assert len(downs) == len(ups) == len(incs)
    assert {e.incident for e in downs} == {i.incident for i in incs}
    assert [e.time for e in evs] == sorted(e.time for e in evs)


def test_merge_event_streams_matches_repro_and_is_stable():
    a = [Event(time=0, kind=EventKind.ARRIVAL, job=small_job(0)),
         Event(time=4, kind=EventKind.ARRIVAL, job=small_job(1))]
    b = [Event(time=0, kind=EventKind.MACHINE_DOWN, machine=0, incident=0),
         Event(time=2, kind=EventKind.MACHINE_UP, machine=0, incident=0)]
    merged = list(merge_event_streams(a, b))
    assert [e.time for e in merged] == [0, 0, 2, 4]
    assert merged[0].kind == EventKind.ARRIVAL      # stream a first
    # a trace merged with a plan: the same order as repro's merge
    tkw = dict(num_jobs=30, seed=4, arrival_rate=2.0, failure_rate=0.2)
    pkw = dict(seed=4, until=40, **CHAOS_PLAN)
    got = merge_event_streams(sim.stream(sim.TraceConfig(**tkw)),
                              FaultPlan(**pkw).events(4))
    want = ref_sim.merge_event_streams(
        ref_sim.stream(ref_sim.TraceConfig(**tkw)),
        ref_sim.FaultPlan(**pkw).events(4))
    key = [(e.time, e.kind.name, e.machine, e.incident,
            None if e.job is None else e.job.job_id) for e in got]
    assert key == [(e.time, e.kind.name, e.machine, e.incident,
                    None if e.job is None else e.job.job_id) for e in want]


# -------------------------------------------------------- capacity mask
def test_capacity_mask_masks_and_restores_bit_identically():
    cl = core.make_cluster(3, 6, device="cpu")
    base = cl.capacity_matrix
    v0 = cl.version
    mask = np.array([1.0, 0.0, 0.5])
    cl.set_capacity_mask(mask)
    assert cl.version == v0 + 1
    assert np.array_equal(cl.capacity_matrix[1], np.zeros(base.shape[1]))
    assert np.allclose(cl.capacity_matrix[2], 0.5 * base[2])
    cl.set_capacity_mask(mask.copy())               # unchanged: no bump
    assert cl.version == v0 + 1
    cl.set_capacity_mask(np.ones(3))
    assert cl.capacity_matrix is base
    assert cl._capacity_mask is None
    assert cl.version == v0 + 2
    cl2 = core.make_cluster(3, 6, device="cpu")
    v = cl2.version
    cl2.set_capacity_mask(np.ones(3))
    assert cl2.version == v


def test_capacity_mask_validation():
    cl = core.make_cluster(3, 6, device="cpu")
    with pytest.raises(ValueError):
        cl.set_capacity_mask(np.ones(4))
    with pytest.raises(ValueError):
        cl.set_capacity_mask(np.array([1.0, -0.1, 1.0]))


@pytest.mark.parametrize("mask", [[1.0, 0.0, 0.5, 1.0],
                                  [0.3124, 0.6981, 1.0, 0.0],
                                  [0.45, 0.5, 0.55, 0.7]])
def test_capacity_mask_on_the_torch_ledger_matches_numpy(mask):
    """Crashed and straggler factors over a committed ledger: capacities,
    free rows and the overcommit test equal numpy's; the priced tensor
    (zeroed rows at the ceiling, fractional capacities through ``pow``)
    is within rel 1e-12."""
    job = small_job()
    alloc = Allocation(workers={0: 2, 1: 1, 3: 1}, ps={2: 1})
    cl, ref = cluster_of(sim, 4, 6), cluster_of(ref_sim, 4, 6)
    ref_job = ref_core.JobSpec(**{f.name: getattr(job, f.name)
                                  for f in dataclasses.fields(job)})
    for t in (0, 2, 5):
        cl.commit(t, job, alloc)
        ref.commit(t, ref_job, ref_core.Allocation(
            workers=dict(alloc.workers), ps=dict(alloc.ps)))
    for c in (cl, ref):
        c.set_capacity_mask(np.array(mask))
    assert np.array_equal(cl.capacity_matrix, ref.capacity_matrix)
    for t in range(6):
        assert np.array_equal(cl.free_matrix(t), ref.free_matrix(t))
    for h in range(4):
        assert cl.machine_overcommitted(h) == ref.machine_overcommitted(h)
    u = np.array([5.0, 7.0, 11.0, 13.0])[:len(cl.resources)]
    got = cl.backend.to_host(cl.backend.price_tensor(
        cl._used, cl.capacity_matrix, u, 0.25))
    want = ref.backend.to_host(ref.backend.price_tensor(
        ref._used, ref.capacity_matrix, u, 0.25))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert np.isfinite(got).all()


def test_machine_overcommitted_tracks_mask():
    cl = core.make_cluster(2, 6, device="cpu")
    cl.commit(0, small_job(), Allocation(workers={0: 2}, ps={0: 1}))
    assert not cl.machine_overcommitted(0)
    cl.set_capacity_mask(np.array([0.0, 1.0]))
    assert cl.machine_overcommitted(0)
    assert not cl.machine_overcommitted(1)
    cl.set_capacity_mask(np.ones(2))
    assert not cl.machine_overcommitted(0)


# ------------------------------------------------------- solver faults
def _pattern(inj, n, faults):
    out = []
    for _ in range(n):
        try:
            inj("lp")
            out.append(None)
        except faults as e:
            out.append(type(e).__name__)
    return out


@pytest.mark.parametrize("rate,seed", [(0.5, 9), (0.2, 0), (0.3, 1),
                                       (1.0, 3)])
def test_solver_fault_schedule_matches_repro(rate, seed):
    got = _pattern(SolverFaultInjector(rate=rate, seed=seed), 200,
                   SolverFault)
    want = _pattern(ref_sim.SolverFaultInjector(rate=rate, seed=seed), 200,
                    RefSolverFault)
    assert got == want
    assert "SolverTimeout" in got and "SolverFault" in got


def test_solver_fault_injector_is_deterministic_by_dispatch_index():
    a = _pattern(SolverFaultInjector(rate=0.5, seed=9), 40, SolverFault)
    assert a == _pattern(SolverFaultInjector(rate=0.5, seed=9), 40,
                         SolverFault)
    inj = SolverFaultInjector(rate=0.5, seed=9)
    _pattern(inj, 10, SolverFault)
    clone = copy.deepcopy(inj)                  # a checkpoint's copy
    assert _pattern(inj, 30, SolverFault) == _pattern(clone, 30, SolverFault)


def test_solver_fault_injector_max_faults_bound():
    inj = SolverFaultInjector(rate=1.0, seed=0, max_faults=2)
    assert sum(p is not None for p in _pattern(inj, 20, SolverFault)) == 2
    assert inj.raised == 2


def test_fault_plan_solver_hook_gated_by_rate():
    assert FaultPlan(solver_fault_rate=0.0).solver_fault_hook() is None
    hook = FaultPlan(solver_fault_rate=0.4, seed=7).solver_fault_hook()
    assert isinstance(hook, SolverFaultInjector)
    assert hook.rate == 0.4
    assert issubclass(SolverTimeout, SolverFault)


# -------------------------------------------------- degradation ladder
def _chaos_trace(pkg, num_jobs=10, seed=3, failure_rate=0.2):
    return pkg.TraceConfig(num_jobs=num_jobs, seed=seed, arrival_rate=0.6,
                           failure_rate=failure_rate)


def _resilient_run(pkg, hook, H=5, W=12, **eng_kw):
    """test_faults.py's resilient engine in ``pkg``: (report, policy,
    (log, rows))."""
    tcfg = _chaos_trace(pkg)
    cl = cluster_of(pkg, H, W)
    cfg = (SubproblemConfig if pkg is sim else ref_core.SubproblemConfig)(
        lp_fault_hook=hook)
    pol = pkg.ResilientPolicy(
        inner="pdors", price_params=pkg.calibrate_prices(tcfg, cl, n=16),
        quanta=8, cfg=cfg)
    eng = pkg.SimEngine(pkg.RollingWindow(cl), pol, max_slots=600,
                        patience=tcfg.patience, **eng_kw)
    log = record_decisions(pol)
    rep = eng.run(pkg.stream(tcfg))
    return rep, pol, (log, outcome_rows(eng))


def _resilient_pair(make_hook):
    got = _resilient_run(sim, make_hook(sim))
    want = _resilient_run(ref_sim, make_hook(ref_sim))
    assert_same_run((got[0], got[2]), (want[0], want[2]))
    return got[0].summary


def test_resilient_retry_recovers_single_fault():
    s = _resilient_pair(lambda pkg: pkg.SolverFaultInjector(
        rate=1.0, seed=0, max_faults=1))
    health = s["policy_health"]
    assert health["solver_faults"] == 1
    assert health["retries"] == 1
    assert health["retry_recoveries"] == 1
    assert health["fallbacks"] == 0
    assert s["jobs_offered"] == 10


def test_resilient_fallback_never_drops_an_offer():
    s = _resilient_pair(lambda pkg: pkg.SolverFaultInjector(rate=1.0,
                                                            seed=0))
    health = s["policy_health"]
    assert health["fallbacks"] > 0
    assert health["solver_faults"] >= 2 * health["fallbacks"]
    assert health["retries"] >= health["fallbacks"]
    assert s["jobs_offered"] == 10
    assert s["jobs_admitted"] + s["jobs_rejected"] == 10
    assert health["fallback_admits"] <= s["jobs_admitted"]


def test_resilient_is_transparent_without_faults():
    tcfg = _chaos_trace(sim)
    params = sim.calibrate_prices(tcfg, cluster_of(sim, 5, 12), n=16)

    def run(policy):
        eng = sim.SimEngine(sim.RollingWindow(cluster_of(sim, 5, 12)),
                            policy, max_slots=600, patience=tcfg.patience)
        log = record_decisions(policy)
        return eng.run(sim.stream(tcfg)), log

    base, base_log = run(sim.make_policy("pdors", price_params=params,
                                         quanta=8))
    wrapped, wrapped_log = run(sim.ResilientPolicy(
        inner="pdors", price_params=params, quanta=8))
    ws = dict(wrapped.summary)
    health = ws.pop("policy_health")
    assert ws == base.summary
    assert wrapped_log == base_log
    assert health["solver_faults"] == 0
    assert health["state"] == "healthy"
    # and the wrapped run decides as repro's wrapped run
    s = _resilient_pair(lambda pkg: None)
    assert s["policy_health"]["solver_faults"] == 0


def test_unwrapped_policy_propagates_solver_fault():
    tcfg = _chaos_trace(sim)
    cl = cluster_of(sim, 5, 12)
    pol = sim.make_policy(
        "pdors", price_params=sim.calibrate_prices(tcfg, cl, n=16),
        quanta=8, cfg=SubproblemConfig(
            lp_fault_hook=SolverFaultInjector(rate=1.0, seed=0)))
    eng = sim.SimEngine(sim.RollingWindow(cl), pol, max_slots=600,
                        patience=tcfg.patience)
    with pytest.raises(SolverFault):
        eng.run(sim.stream(tcfg))


def test_kernel_error_under_resilient_policy_propagates(monkeypatch):
    """A kernel's host call that raises (a launch error is a plain
    ``RuntimeError``, as ``SolverFault``'s base is) must not be taken for
    a solver fault: it propagates, and no rung of the ladder counts it."""
    calls = []

    def failing(*args, **kw):
        calls.append(args[0].shape)
        raise RuntimeError("price_bundle kernel: CUDA error 700 at launch")

    monkeypatch.setattr(pricing, "price_bundle_batch", failing)
    monkeypatch.setattr(pricing, "price_bundle", failing)
    tcfg = _chaos_trace(sim)
    cl = cluster_of(sim, 5, 12)
    pol = sim.ResilientPolicy(
        inner="pdors", price_params=sim.calibrate_prices(tcfg, cl, n=16),
        quanta=8, cfg=SubproblemConfig(
            lp_fault_hook=SolverFaultInjector(rate=1.0, seed=0)))
    eng = sim.SimEngine(sim.RollingWindow(cl), pol, max_slots=600,
                        patience=tcfg.patience)
    with pytest.raises(RuntimeError, match="CUDA error 700") as err:
        eng.run(sim.stream(tcfg))
    assert not isinstance(err.value, SolverFault)
    assert calls
    health = pol.health_stats()
    assert health["offers"] == 1
    assert health["solver_faults"] == 0
    assert health["retries"] == 0
    assert health["fallbacks"] == 0
    assert health["fallback_admits"] == 0


# ----------------------------------------------------------- recovery
def _chaos_engine(pkg, policy_name="pdors", seed=0, **eng_kw):
    """test_faults.py's ``_build_chaos_engine`` in ``pkg``."""
    tcfg = _chaos_trace(pkg, num_jobs=12, seed=seed)
    plan = pkg.FaultPlan(seed=seed, until=200, **CHAOS_PLAN)
    kw = {}
    if policy_name in ("pdors", "pdors_ref"):
        kw = dict(price_params=pkg.calibrate_prices(
            tcfg, cluster_of(pkg, 4, 12), n=16), quanta=8)
    eng = pkg.SimEngine(pkg.RollingWindow(cluster_of(pkg, 4, 12)),
                        pkg.make_policy(policy_name, **kw), seed=seed,
                        max_slots=600, patience=tcfg.patience, **eng_kw)
    return eng, lambda: pkg.merge_event_streams(pkg.stream(tcfg),
                                                plan.events(4))


def assert_cluster_caches_fresh(cl, device="cpu"):
    """The ledger lives on ``device``, and every version-keyed cache that
    claims the current version agrees with a fresh read of the ledger."""
    assert cl._used.device.type == device
    used = cl.backend.to_host(cl._used)
    free = cl.capacity_matrix[None] - used
    for name, want in (("_used_host", used), ("_free_host", free)):
        ent = getattr(cl, name)
        if ent is not None and ent[0] == cl.version:
            assert np.array_equal(ent[1], want), name
    if cl._free_dev is not None and cl._free_dev[0] == cl.version:
        assert np.array_equal(cl.backend.to_host(cl._free_dev[1]), free)
    for t in range(cl.horizon):
        assert np.array_equal(cl.used_matrix(t), used[t])
        assert np.array_equal(cl.free_matrix(t), free[t])


def test_recover_is_bit_identical_to_uninterrupted_run():
    base_eng, ev = _chaos_engine(sim)
    base = base_eng.run(ev())
    eng, ev = _chaos_engine(sim, checkpoint_every=10, kill_at=27)
    with pytest.raises(sim.SimKilled):
        eng.run(ev())
    snap = eng._checkpoint.state[0].cluster
    assert snap is not eng.window.cluster
    assert_cluster_caches_fresh(snap)
    rep = eng.recover(ev())
    assert rep.summary == base.summary
    assert rep.slots_run == base.slots_run
    assert np.array_equal(ledger(eng), ledger(base_eng))
    assert eng.metrics.outcomes == base_eng.metrics.outcomes
    assert_cluster_caches_fresh(eng.window.cluster)
    # and the uninterrupted run is repro's
    ref_eng, ref_ev = _chaos_engine(ref_sim)
    ref = ref_eng.run(ref_ev())
    assert {k: v for k, v in rep.summary.items() if k != "total_utility"} \
        == {k: v for k, v in ref.summary.items() if k != "total_utility"}
    assert rep.summary["total_utility"] == pytest.approx(
        ref.summary["total_utility"], rel=1e-9)
    assert rep.summary["machine_incidents"] > 0


def test_recover_from_journal_alone_when_stream_drained():
    plan_kw = dict(seed=4, until=16, crash_rate=0.04, straggler_rate=0.02,
                   downtime=(2, 6), domains=[(0, 1), (2, 3)],
                   domain_correlation=0.5)
    runs = {}
    for pkg in (sim, ref_sim):
        tcfg = _chaos_trace(pkg, num_jobs=10, seed=4, failure_rate=0.25)
        plan = pkg.FaultPlan(**plan_kw)
        params = pkg.calibrate_prices(tcfg, cluster_of(pkg, 4, 12), n=16)

        def build(**kw):
            return pkg.SimEngine(
                pkg.RollingWindow(cluster_of(pkg, 4, 12)),
                pkg.make_policy("pdors", price_params=params, quanta=8),
                max_slots=600, patience=tcfg.patience, **kw)

        def ev():
            return pkg.merge_event_streams(pkg.stream(tcfg), plan.events(4))

        assert max(e.time for e in ev()) < 28
        runs[pkg] = build().run(ev()).summary
        if pkg is sim:
            eng = build(checkpoint_every=10, kill_at=28)
            with pytest.raises(sim.SimKilled):
                eng.run(ev())
            assert eng.recover().summary == runs[sim]
    a, b = runs[sim], runs[ref_sim]
    assert a["total_utility"] == pytest.approx(b["total_utility"], rel=1e-9)
    a.pop("total_utility"), b.pop("total_utility")
    assert a == b


def test_recover_without_checkpoint_raises():
    eng, ev = _chaos_engine(sim)
    eng.run(ev())
    with pytest.raises(RuntimeError):
        eng.recover()


# -------------------------------------------------------- chaos storms
STORM_POLICIES = ["pdors", "pdors_ref", "fifo", "drf", "dorm", "resilient"]


def _storm(pkg, policy, seed):
    tcfg = _chaos_trace(pkg, num_jobs=10, seed=seed, failure_rate=0.25)
    plan = pkg.FaultPlan(seed=seed, until=200, solver_fault_rate=0.3,
                         **CHAOS_PLAN)
    cl = cluster_of(pkg, 4, 12)
    kw = {}
    if policy in ("pdors", "pdors_ref"):
        kw = dict(price_params=pkg.calibrate_prices(tcfg, cl, n=16),
                  quanta=8)
    elif policy == "resilient":
        cfg = SubproblemConfig if pkg is sim else ref_core.SubproblemConfig
        kw = dict(inner="pdors",
                  price_params=pkg.calibrate_prices(tcfg, cl, n=16),
                  quanta=8,
                  cfg=cfg(lp_fault_hook=plan.solver_fault_hook()))
    eng = pkg.SimEngine(pkg.RollingWindow(cluster_of(pkg, 4, 12)),
                        pkg.make_policy(policy, **kw), seed=seed,
                        max_slots=600, patience=tcfg.patience,
                        check_ledger=True)
    log = record_decisions(eng.policy)
    rep = eng.run(pkg.merge_event_streams(pkg.stream(tcfg),
                                          plan.events(4)))
    return rep, (log, outcome_rows(eng))


@pytest.mark.parametrize("policy", STORM_POLICIES)
@pytest.mark.parametrize("seed", [0, 1])
def test_chaos_storm_matches_repro_and_replays(policy, seed):
    """Correlated crashes, stragglers, job failures and (resilient)
    injected solver faults: the port decides as ``repro`` does, a replay
    is bit-identical, and the ledger invariant holds throughout."""
    got = _storm(sim, policy, seed)
    assert_same_run(got, _storm(ref_sim, policy, seed))
    again = _storm(sim, policy, seed)
    assert again[0].summary == got[0].summary and again[1] == got[1]
    a = got[0].summary
    assert a["jobs_offered"] == 10
    assert a["machine_incidents"] > 0
    assert 0.0 < a["machine_availability"] < 1.0
    assert 0.0 <= a["goodput_fraction"] <= 1.0
    if a["jobs_completed"] > 0:
        assert a["goodput_samples"] > 0.0


def test_chaos_storm_goodput_accounting_closes():
    tcfg = _chaos_trace(sim, num_jobs=10, seed=4, failure_rate=0.25)
    plan = FaultPlan(seed=4, until=200, **CHAOS_PLAN)
    params = sim.calibrate_prices(tcfg, cluster_of(sim, 4, 12), n=16)

    def run(with_faults):
        eng = sim.SimEngine(
            sim.RollingWindow(cluster_of(sim, 4, 12)),
            sim.make_policy("pdors", price_params=params, quanta=8),
            max_slots=600, patience=tcfg.patience)
        events = (merge_event_streams(sim.stream(tcfg), plan.events(4))
                  if with_faults else sim.stream(tcfg))
        return eng.run(events).summary

    faulted, clean = run(True), run(False)
    for s in (faulted, clean):
        assert s["goodput_samples"] >= 0.0
        assert s["wasted_samples"] >= 0.0
    assert faulted["machine_incidents"] > 0
    assert clean["machine_incidents"] == 0
    assert clean["machine_availability"] == 1.0
