"""The port's online simulator (``repro_torch.sim`` on
``TorchBackend(device="cpu")``) against the JAX package's ``repro.sim`` on
its numpy backend: the same trace, made from the same seed by each
package's own ``stream``, must give an identical per-job decision log
(every offer's admission and committed schedule, every slot grant, and
each job's outcome row), an identical summary, and total utility within
rel 1e-9. Also the rolling window's release-clamp invariants on the torch
ledger, the event queue's ordering, patience departures, the preemption
requeue, ``pdors`` against the frozen-core ``pdors_ref`` policy, and the
``launch.sim`` command line, whose chaos, elastic and service tiers print
the rows ``benchmarks/bench_sim.py`` gives on the numpy backend. The
runners the other ``test_torch_sim*`` and chaos test files share live
here."""
from __future__ import annotations

import dataclasses
import importlib
import re
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.core as ref_core
import repro.sim as ref_sim
from repro_torch import core, sim
from repro_torch.backend.torch_backend import TorchBackend
from repro_torch.core import Allocation, JobSpec, SigmoidUtility
from repro_torch.launch import sim as launch_sim

# bench_sim.py's smoke point (quanta 12, 48 calibration jobs)
SMOKE = dict(machines=6, lookahead=12, preset="google", jobs=60, rate=3.0,
             failure_rate=0.1, seed=0, quanta=12, calib_jobs=48)
# the 15-job trace of test_backend.py's sim-trace equivalence check
TRACE15 = dict(machines=4, lookahead=8, preset="google", jobs=15, rate=4.0,
               failure_rate=0.1, seed=1, quanta=8, calib_jobs=64)


# ------------------------------------------------------------- runners
def _alloc(a) -> tuple:
    return (tuple(sorted(a.workers.items())), tuple(sorted(a.ps.items())))


def record_decisions(policy) -> list:
    """Log every decision ``policy`` returns to the engine: each ARRIVAL
    batch's admissions and committed schedules, each SLOT tick's grants."""
    log = []
    inner = policy.offer

    def offer(event, view):
        dec = inner(event, view)
        if event.kind.name in ("ARRIVAL", "SLOT"):
            log.append((
                event.time, event.kind.name,
                tuple(sorted(dec.admitted.items())),
                tuple((jid, tuple((t, _alloc(a)) for t, a in sorted(s.items())))
                      for jid, s in sorted(dec.schedules.items())),
                tuple((jid, _alloc(a)) for jid, a in sorted(dec.grants.items())),
            ))
        return dec

    policy.offer = offer
    return log


def outcome_rows(engine) -> list:
    return [tuple(sorted(dataclasses.asdict(oc).items()))
            for _, oc in sorted(engine.metrics.outcomes.items())]


def make_port_engine(name, *, machines, lookahead, preset="google", jobs=60,
                     rate=3.0, failure_rate=0.1, seed=0, quanta=12,
                     calib_jobs=48, max_slots=4000, device="cpu",
                     engine_mode="event", metrics_mode="exact",
                     refail_rate=0.0, **policy_kw):
    tcfg = sim.TraceConfig(preset=preset, num_jobs=jobs, seed=seed,
                           arrival_rate=rate, failure_rate=failure_rate)
    cl = core.make_cluster(machines, lookahead, device=device)
    return _engine(sim, tcfg, cl, name, seed, quanta, calib_jobs, max_slots,
                   engine_mode, metrics_mode, refail_rate, policy_kw)


def make_ref_engine(name, *, machines, lookahead, preset="google", jobs=60,
                    rate=3.0, failure_rate=0.1, seed=0, quanta=12,
                    calib_jobs=48, max_slots=4000, engine_mode="event",
                    metrics_mode="exact", refail_rate=0.0, **policy_kw):
    tcfg = ref_sim.TraceConfig(preset=preset, num_jobs=jobs, seed=seed,
                               arrival_rate=rate, failure_rate=failure_rate)
    cl = ref_core.make_cluster(machines, lookahead, backend="numpy")
    return _engine(ref_sim, tcfg, cl, name, seed, quanta, calib_jobs,
                   max_slots, engine_mode, metrics_mode, refail_rate,
                   policy_kw)


def _engine(pkg, tcfg, cl, name, seed, quanta, calib_jobs, max_slots,
            engine_mode, metrics_mode, refail_rate, policy_kw):
    if name.startswith("pdors"):
        policy = pkg.make_policy(
            name, price_params=pkg.calibrate_prices(tcfg, cl, n=calib_jobs),
            quanta=quanta, **policy_kw)
    else:
        policy = pkg.make_policy(name, **policy_kw)
    engine = pkg.SimEngine(pkg.RollingWindow(cl), policy, seed=seed,
                           max_slots=max_slots, patience=tcfg.patience,
                           engine_mode=engine_mode,
                           metrics_mode=metrics_mode,
                           refail_rate=refail_rate)
    return engine, pkg.stream(tcfg)


def run_logged(engine, events):
    """(report, decision log) of one replay."""
    log = record_decisions(engine.policy)
    rep = engine.run(events)
    return rep, (log, outcome_rows(engine))


# the reshape storm of tests/strategies.py (elastic triggers armed)
STORM = dict(elastic_frac=0.7, elastic_levels=(0.5, 1.0, 1.5),
             marginal_floor=0.15, damper_loss=0.6, deadline_frac=0.5,
             slo_frac=0.5)


def trace_cfg(pkg, seed, *, num_jobs=60, rate=3.0, failure_rate=0.1,
              storm=False, **overrides):
    """tests/strategies.py's ``make_trace`` (``storm``: its
    ``reshape_storm``) in package ``pkg`` (``sim`` or ``repro.sim``)."""
    kw = dict(STORM) if storm else {}
    kw.update(overrides)
    return pkg.TraceConfig(num_jobs=num_jobs, seed=seed, arrival_rate=rate,
                           failure_rate=failure_rate, **kw)


def soup_plan(pkg, seed, H):
    """tests/strategies.py's ``chaos_plan``: crashes and stragglers over
    correlated fault domains."""
    return pkg.FaultPlan(
        seed=seed, until=200, crash_rate=0.02, straggler_rate=0.02,
        downtime=(2, 6), domains=[(h, h + 1) for h in range(0, H - 1, 2)],
        domain_correlation=0.5)


def cluster_of(pkg, H, W, device="cpu"):
    """A fresh (H, W) cluster: the port's torch ledger on ``device``, or
    the JAX package's numpy ledger."""
    if pkg is sim:
        return core.make_cluster(H, W, device=device)
    return ref_core.make_cluster(H, W, backend="numpy")


def ledger(engine) -> np.ndarray:
    cl = engine.window.cluster
    return np.asarray(cl.backend.to_host(cl._used))


def run_sim(pkg, policy_name, mode, seed, *, num_jobs=60, rate=3.0,
            faults=False, metrics_mode="exact", refail=0.1, H=6, W=12,
            checkpoint_every=None, kill_at=None, max_slots=2500, trace=None,
            policy_kwargs=None, events=None, device="cpu"):
    """tests/strategies.py's ``run_sim`` in package ``pkg``, with the
    decision log kept: (report, engine, (log, outcome rows))."""
    tcfg = trace if trace is not None else trace_cfg(
        pkg, seed, num_jobs=num_jobs, rate=rate)
    cl = cluster_of(pkg, H, W, device)
    pkw = dict(policy_kwargs or {})
    if policy_name == "pdors":
        pol = pkg.make_policy(
            "pdors", price_params=pkg.calibrate_prices(tcfg, cl, n=16),
            quanta=8, **pkw)
    else:
        pol = pkg.make_policy(policy_name, **pkw)
    eng = pkg.SimEngine(pkg.RollingWindow(cl), pol, seed=seed,
                        max_slots=max_slots, patience=tcfg.patience,
                        metrics_mode=metrics_mode, engine_mode=mode,
                        refail_rate=refail,
                        checkpoint_every=checkpoint_every, kill_at=kill_at)
    ev = pkg.stream(tcfg) if events is None else events
    if faults:
        ev = pkg.merge_event_streams(ev, soup_plan(pkg, seed, H).events(H))
    log = record_decisions(eng.policy)
    rep = eng.run(ev)
    return rep, eng, (log, outcome_rows(eng))


def assert_engines_identical(a, b, *, exact_outcomes=True):
    """Two finished port runs (``run_sim``'s triples) bit-identical:
    summary, slots, ledger, journal and, in exact mode, every outcome
    row."""
    (r1, e1, _), (r2, e2, _) = a, b
    assert r1.summary == r2.summary
    assert r1.slots_run == r2.slots_run
    assert np.array_equal(ledger(e1), ledger(e2))
    assert e1.journal == e2.journal
    if exact_outcomes:
        assert e1.metrics.outcomes == e2.metrics.outcomes


def assert_port_matches_repro(policy, seed, mode="batched", **kw):
    """The port's run equals ``repro.sim``'s on the numpy backend
    (decision logs, summaries, utility rel 1e-9, ledger); returns the
    port's triple."""
    got = run_sim(sim, policy, mode, seed, **kw)
    ref_kw = dict(kw)
    if "trace" in kw:
        ref_kw["trace"] = ref_sim.TraceConfig(
            **dataclasses.asdict(kw["trace"]))
    want = run_sim(ref_sim, policy, mode, seed, **ref_kw)
    assert_same_run((got[0], got[2]), (want[0], want[2]))
    assert np.allclose(ledger(got[1]), ledger(want[1]), rtol=0, atol=1e-9)
    return got


def assert_same_run(got, want):
    """Identical decision logs and summaries; utility within rel 1e-9."""
    (rg, lg), (rw, lw) = got, want
    assert lg[0] == lw[0]                       # offers and grants
    assert lg[1] == lw[1]                       # per-job outcome rows
    assert rg.slots_run == rw.slots_run
    a = {k: v for k, v in rg.summary.items() if k != "total_utility"}
    b = {k: v for k, v in rw.summary.items() if k != "total_utility"}
    assert a == b
    assert rg.summary["total_utility"] == pytest.approx(
        rw.summary["total_utility"], rel=1e-9)


def small_job(job_id=0, arrival=0, V=2000, F=16, gamma=2.0, **kw):
    defaults = dict(
        epochs=1, num_samples=V, batch_size=F, tau=1e-3, grad_size=100.0,
        gamma=gamma, bw_internal=1e6, bw_external=2e5,
        worker_demand={"gpu": 1.0, "cpu": 2.0, "mem": 4.0, "storage": 1.0},
        ps_demand={"gpu": 0.0, "cpu": 2.0, "mem": 4.0, "storage": 1.0},
        utility=SigmoidUtility(theta1=50.0, theta2=0.5, theta3=5.0),
    )
    defaults.update(kw)
    return JobSpec(job_id=job_id, arrival=arrival, **defaults)


# --------------------------------------------- port against repro.sim
def test_sim_trace_matches_numpy_backend():
    """The 15-job google trace (failures on), pdors: the port on the CPU
    decides as ``repro.sim`` on the numpy backend does."""
    got = run_logged(*make_port_engine("pdors", **TRACE15))
    want = run_logged(*make_ref_engine("pdors", **TRACE15))
    assert_same_run(got, want)
    assert got[0].summary["jobs_completed"] > 0


@pytest.mark.parametrize("name", ["pdors", "fifo", "drf", "dorm"])
def test_smoke_grid_matches_numpy_backend(name):
    got = run_logged(*make_port_engine(name, **SMOKE))
    want = run_logged(*make_ref_engine(name, **SMOKE))
    assert_same_run(got, want)
    assert got[0].summary["jobs_completed"] > 0


def test_pdors_matches_frozen_reference_policy_on_trace():
    """The port's ``pdors`` (compat rng) and its ``pdors_ref`` (the frozen
    scalar core over the same window) decide identically on a trace with
    completions and preemption, as in the JAX package."""
    point = dict(machines=4, lookahead=10, preset="google", jobs=12,
                 rate=1.5, failure_rate=0.2, seed=3, quanta=8, calib_jobs=16)
    vec = run_logged(*make_port_engine("pdors", rng_mode="compat", **point))
    ref = run_logged(*make_port_engine("pdors_ref", **point))
    assert vec[1] == ref[1]
    assert vec[0].summary == ref[0].summary
    assert vec[0].summary["preemptions"] > 0


# -------------------------------------------------------- the window
def test_rolling_window_release_clamp_invariants():
    """Commit a forward schedule, slide the window, release the tail: the
    torch ledger never goes negative, never oversubscribes, fully
    releasing a job restores its rows' free capacity, and every step
    leaves the ledger equal to the numpy backend's."""
    job = small_job()
    alloc = Allocation(workers={0: 2, 1: 1}, ps={2: 1})
    cl = core.make_cluster(3, 6, device="cpu")
    assert isinstance(cl.backend, TorchBackend)
    ref_cl = ref_core.make_cluster(3, 6, backend="numpy")
    win, ref_win = sim.RollingWindow(cl), ref_sim.RollingWindow(ref_cl)
    ref_job = ref_core.JobSpec(**{f.name: getattr(job, f.name)
                                  for f in dataclasses.fields(job)})
    ref_alloc = ref_core.Allocation(workers=dict(alloc.workers),
                                    ps=dict(alloc.ps))

    def same_ledger():
        assert np.array_equal(cl.backend.to_host(cl._used), ref_cl._used)

    win.commit_schedule(job, {0: alloc, 2: alloc, 4: alloc})
    ref_win.commit_schedule(ref_job, {0: ref_alloc, 2: ref_alloc,
                                      4: ref_alloc})
    same_ledger()
    assert not win.oversubscribed()
    win.advance_to(1)
    ref_win.advance_to(1)
    same_ledger()
    assert win.alloc_at(job.job_id, 0) is None
    assert win.alloc_at(job.job_id, 2) is not None
    free_before = cl.free_matrix(win.rel(2)).copy()
    assert win.release_from(job.job_id, 2) == 2
    assert ref_win.release_from(job.job_id, 2) == 2
    same_ledger()
    u = cl.backend.to_host(cl._used)
    assert (u >= -1e-9).all()
    assert u.sum() == pytest.approx(0.0, abs=1e-9)
    assert not win.oversubscribed()
    assert (cl.free_matrix(win.rel(2)) >= free_before - 1e-9).all()
    assert win.release_from(job.job_id, 0) == 0
    assert cl.backend.to_host(cl._used).sum() == pytest.approx(0.0, abs=1e-9)


def test_rolling_window_commit_and_release():
    cl = core.make_cluster(3, 8, device="cpu")
    win = sim.RollingWindow(cl)
    j = small_job()
    win.commit_schedule(j, {2: Allocation(workers={0: 2}, ps={0: 1}),
                            4: Allocation(workers={1: 1}, ps={1: 1})})
    assert win.alloc_at(j.job_id, 2) is not None
    win.advance_to(3)
    assert win.alloc_at(j.job_id, 2) is None
    assert cl.used(1, 1, "cpu") > 0
    assert win.release_from(j.job_id, 3) == 1
    assert float(cl._used.sum()) == 0.0
    assert not win.oversubscribed()
    with pytest.raises(ValueError):
        win.advance_to(2)                   # the window never moves back


def test_rolling_window_rejects_out_of_window_commit():
    win = sim.RollingWindow(core.make_cluster(2, 4, device="cpu"))
    with pytest.raises(ValueError):
        win.commit(7, small_job(), Allocation(workers={0: 1}, ps={0: 1}))
    win.advance_to(5)
    with pytest.raises(ValueError):
        win.commit(4, small_job(), Allocation(workers={0: 1}, ps={0: 1}))


def test_window_same_slot_grants_merge_and_regrant():
    cl = core.make_cluster(2, 4, device="cpu")
    win = sim.RollingWindow(cl)
    j = small_job()
    win.commit(0, j, Allocation(workers={0: 1}, ps={0: 1}))
    win.commit(0, j, Allocation(workers={0: 2}, ps={}))
    merged = win.alloc_at(j.job_id, 0)
    assert merged.workers == {0: 3} and merged.ps == {0: 1}
    win.release_from(j.job_id, 0)
    assert float(cl._used.sum()) == 0.0
    # the fused re-grant commits exactly what commit would, and refuses
    # what does not fit
    held = Allocation(workers={1: 4}, ps={1: 1})
    assert win.regrant(j, held)
    want = core.make_cluster(2, 4, device="cpu")
    want.commit(0, j, held)
    assert np.array_equal(cl.backend.to_host(cl._used),
                          want.backend.to_host(want._used))
    assert not win.regrant(j, Allocation(workers={1: 1000}, ps={}))


# ------------------------------------------------------------ events
def test_event_queue_same_slot_ordering():
    q = sim.EventQueue()
    Ev, K = sim.Event, sim.EventKind
    q.push(Ev(time=3, kind=K.ARRIVAL, job=small_job(1)))
    q.push(Ev(time=3, kind=K.FAILURE, job_id=7))
    q.push(Ev(time=2, kind=K.ARRIVAL, job=small_job(2)))
    q.push(Ev(time=3, kind=K.DEPARTURE, job_id=9))
    q.push(Ev(time=3, kind=K.MACHINE_DOWN, machine=0, incident=1))
    q.push(Ev(time=3, kind=K.MACHINE_UP, machine=1, incident=0))
    order = [(e.time, e.kind) for e in q.pop_until(3)]
    assert order == [
        (2, K.ARRIVAL),
        (3, K.MACHINE_UP),
        (3, K.MACHINE_DOWN),
        (3, K.FAILURE),
        (3, K.DEPARTURE),
        (3, K.ARRIVAL),
    ]
    assert len(q) == 0


def test_event_queue_insertion_order_ties():
    q = sim.EventQueue()
    for i in range(5):
        q.push(sim.Event(time=1, kind=sim.EventKind.ARRIVAL,
                         job=small_job(i)))
    assert [e.job.job_id for e in q.pop_until(1)] == [0, 1, 2, 3, 4]


def test_trace_stream_matches_repro():
    """The port's trace generator yields the JAX package's events."""
    kw = dict(preset="google", num_jobs=30, seed=5, failure_rate=0.3)
    a = list(sim.stream(sim.TraceConfig(**kw)))
    b = list(ref_sim.stream(ref_sim.TraceConfig(**kw)))
    assert [(e.time, e.fail_at, dataclasses.asdict(e.job)) for e in a] == \
        [(e.time, e.fail_at, dataclasses.asdict(e.job)) for e in b]
    assert any(e.fail_at is not None for e in a)


def test_registry_lists_the_policies():
    names = sim.available_policies()
    for expected in ("pdors", "pdors_ref", "fifo", "drf", "dorm"):
        assert expected in names
    with pytest.raises(KeyError):
        sim.make_policy("nonexistent")


# --------------------------------------------- engine accounting paths
def test_patience_departure():
    """A monster job blocks FIFO's head; patience expires the queue."""
    blocker = small_job(job_id=0, V=500000, F=4)
    waiter = small_job(job_id=1, V=1000, F=4,
                       worker_demand={"gpu": 80.0, "cpu": 2.0, "mem": 4.0,
                                      "storage": 1.0})     # never fits
    events = [sim.Event(time=0, kind=sim.EventKind.ARRIVAL, job=blocker),
              sim.Event(time=0, kind=sim.EventKind.ARRIVAL, job=waiter)]
    win = sim.RollingWindow(core.make_cluster(1, 8, device="cpu"))
    rep = sim.SimEngine(win, sim.make_policy("fifo"), max_slots=400,
                        patience=10).run(events)
    assert rep.summary["jobs_departed"] >= 1
    oc = rep.metrics.outcomes[1]
    assert oc.departed_at == 10 and oc.first_service is None


def test_preemption_requeues_pdors_and_keeps_slot_policies():
    job = small_job(V=40000, F=8)
    events = [sim.Event(time=0, kind=sim.EventKind.ARRIVAL, job=job,
                        fail_at=2)]
    cl = core.make_cluster(4, 12, device="cpu")
    params = core.estimate_price_params([job], cl, 12)
    rep = sim.SimEngine(
        sim.RollingWindow(cl),
        sim.make_policy("pdors", price_params=params, quanta=8),
        max_slots=60,
    ).run(list(events))
    assert rep.summary["preemptions"] == 1
    oc = rep.metrics.outcomes[job.job_id]
    assert oc.completed_at is not None and oc.completed_at > 2
    assert rep.states[job.job_id].attempt == 1      # the requeued residual

    rep2 = sim.SimEngine(
        sim.RollingWindow(core.make_cluster(4, 12, device="cpu")),
        sim.make_policy("fifo"), max_slots=120, patience=40,
    ).run(list(events))
    assert rep2.summary["preemptions"] == 1
    assert rep2.summary["jobs_completed"] == 1
    assert rep2.states[job.job_id].attempt == 0     # kept in place


def test_engine_mode_validated():
    with pytest.raises(ValueError):
        sim.SimEngine(sim.RollingWindow(core.make_cluster(4, 8,
                                                          device="cpu")),
                      sim.make_policy("fifo"), engine_mode="vectorized")


# ---------------------------------------------------------- launcher
def test_launch_sim_on_cpu(capsys):
    args = ["--device", "cpu", "--machines", "4", "--lookahead", "8",
            "--jobs", "15", "--rate", "4.0", "--seed", "1",
            "--policies", "pdors,fifo"]
    assert launch_sim.main(args) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("H=4 W=8 google jobs=15")
    rows = {ln.split(":")[0].strip(): ln for ln in lines[1:]}
    assert set(rows) == {"pdors", "fifo"}
    engine, events = launch_sim.make_engine(
        "pdors", machines=4, lookahead=8, jobs=15, rate=4.0, seed=1,
        device="cpu")
    rep, wall = launch_sim.run_engine(engine, events)
    s = rep.summary
    assert f"admitted={s['jobs_admitted']} " in rows["pdors"]
    assert f"done={s['jobs_completed']}/15 " in rows["pdors"]
    assert f"util={s['total_utility']:.1f} " in rows["pdors"]
    assert wall > 0 and engine.admission_latency()["count"] > 0


def test_launch_sim_default_device_is_the_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        launch_sim.make_engine("fifo", machines=2, lookahead=4)


# ------------------------------------------- launcher: bench_sim's tiers
LAUNCH_POINT = dict(machines=6, lookahead=12, preset="google", jobs=60,
                    rate=3.0, failure_rate=0.1, seed=0)
# columns that are times or name the backend
TIMED = {"wall_s", "jobs_per_sec", "backend", "peak_rss_mb",
         "admission_p50_ms", "admission_p99_ms", "admission_mean_ms"}


def _bench_sim():
    """The JAX package's ``benchmarks/bench_sim.py``, imported as is."""
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("benchmarks.bench_sim")


def _untimed_lines(text: str) -> list:
    """The printed rows with their rate and latency columns masked."""
    out = []
    for line in text.splitlines():
        if not line.startswith("  "):
            continue
        line = re.sub(r" *[\d.]+ (jobs|offers)/s", r" RATE \1/s", line)
        out.append(re.sub(r"p(50|99)=[\d.]+ms", r"p\1=MS", line))
    return out


def assert_rows_match(got: list, want: list):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) - {"peak_rss_mb"} == set(w) - {"peak_rss_mb"}
        assert g["backend"] == "torch:cpu"
        keep = set(g) - TIMED - {"total_utility"}
        assert {k: g[k] for k in keep} == {k: w[k] for k in keep}
        if "total_utility" in g:
            assert g["total_utility"] == pytest.approx(w["total_utility"],
                                                       rel=1e-9)


def test_launch_sim_faults_rows_match_bench_sim(capsys):
    """``--faults``: the chaos leg's rows (pdors resilient-wrapped with
    the plan's solver-fault hook) equal bench_sim's ``run_point(faults=
    True)`` on the numpy backend, and so do the printed lines."""
    policies = ["pdors", "fifo", "drf", "dorm"]
    p = LAUNCH_POINT
    want = _bench_sim().run_point(
        p["machines"], p["lookahead"], p["preset"], p["jobs"], p["rate"],
        p["failure_rate"], policies, p["seed"], launch_sim.MAX_SLOTS,
        faults=True)
    want_out = capsys.readouterr().out
    got = launch_sim.chaos_rows(policies, device="cpu", **p)
    assert_rows_match(got, want)
    assert _untimed_lines(capsys.readouterr().out) == \
        _untimed_lines(want_out)
    health = got[0]["policy_health"]
    assert health["solver_faults"] > 0 and health["fallbacks"] > 0
    assert all(r["machine_incidents"] > 0 for r in got)


def test_launch_sim_elastic_rows_match_bench_sim(capsys):
    """``--elastic``: the reshape storm's rows, with both engine modes'
    parity, equal bench_sim's ``run_elastic_point``."""
    policies = ["pdors", "fifo"]
    p = LAUNCH_POINT
    want = _bench_sim().run_elastic_point(
        p["machines"], p["lookahead"], p["preset"], p["jobs"], p["rate"],
        p["failure_rate"], policies, p["seed"], launch_sim.MAX_SLOTS)
    want_out = capsys.readouterr().out
    got = launch_sim.elastic_rows(policies, device="cpu", **p)
    assert_rows_match(got, want)
    assert _untimed_lines(capsys.readouterr().out) == \
        _untimed_lines(want_out)
    assert all(r["engine_parity"] and r["reshapes"] > 0 for r in got)


@pytest.mark.parametrize("jobs", [60, 150])
def test_launch_sim_service_row_matches_bench_sim(capsys, jobs):
    """``--service``: the service row (admissions, grants, batches) equals
    bench_sim's ``run_service_point``."""
    p = dict(LAUNCH_POINT, jobs=jobs)
    want = _bench_sim().run_service_point(
        p["machines"], p["lookahead"], p["preset"], p["jobs"], p["rate"],
        p["seed"])
    want_out = capsys.readouterr().out
    got = launch_sim.service_row(device="cpu", **p)
    assert_rows_match([got], [want])
    assert _untimed_lines(capsys.readouterr().out) == \
        _untimed_lines(want_out)
    assert got["batches"] == -(-jobs // launch_sim.SERVICE_CHUNK)
    assert got["grants_polled"] == got["jobs_admitted"] > 0


def test_launch_sim_tiers_on_the_command_line(capsys):
    small = ["--device", "cpu", "--machines", "4", "--lookahead", "8",
             "--jobs", "15", "--rate", "4.0", "--seed", "1",
             "--policies", "fifo"]
    assert launch_sim.main(small + ["--faults"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].endswith(" faults")
    assert lines[1].split(":")[0].strip() == "fifo" and "avail=" in lines[1]
    assert launch_sim.main(small + ["--elastic"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert "fifo [elastic]" in lines[1] and "parity=OK" in lines[1]
    assert launch_sim.main(small + ["--service"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert "pdors [service]" in lines[1] and "batches=1" in lines[1]
    with pytest.raises(SystemExit):
        launch_sim.main(small + ["--faults", "--service"])


def test_launch_sim_service_default_device_is_the_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        launch_sim.make_service_point(machines=2, lookahead=4)
    with pytest.raises(RuntimeError):
        launch_sim.make_engine("pdors", machines=2, lookahead=4, faults=True)
