"""The port's elastic quality-driven jobs and the engine's reshape /
re-offer path on ``TorchBackend(device="cpu")``: the job model (quality
curves, ``at_level``) equal to the JAX package's; a reshape-free elastic
trace scheduled exactly as its static twin; reshape storms that decide as
``repro.sim`` does on the numpy backend, with the batched and per-event
engines bit-identical and the ledger invariant held throughout; the
``use_warm_bundles`` switch changing nothing; and ``recover()`` replaying
in-flight reshapes bit-identically. The counterpart of
``tests/test_elastic.py``."""
from __future__ import annotations

import dataclasses
from dataclasses import replace

import numpy as np
import pytest
from hypothesis import given, settings

import repro.core as ref_core
import repro.sim as ref_sim
from repro_torch import core, sim
from repro_torch.core import QualityCurve
from strategies import ALL_POLICIES, QUALITY_KEYS, policies, seeds
from test_torch_sim import (assert_engines_identical,
                            assert_port_matches_repro,
                            ledger, run_sim, trace_cfg)


def _storm(pkg, seed, **kw):
    return trace_cfg(pkg, seed, storm=True, **kw)


def _modes(policy, seed, **kw):
    """The port's batched engine and per-event oracle, bit-identical;
    returns the batched run."""
    event = run_sim(sim, policy, "event", seed, **kw)
    batched = run_sim(sim, policy, "batched", seed, **kw)
    assert_engines_identical(
        event, batched,
        exact_outcomes=kw.get("metrics_mode", "exact") == "exact")
    return batched


# ------------------------------------------------------------ job model
def test_quality_curve_fit_matches_repro():
    truth = QualityCurve(a=0.8, b=1.2, c=0.1)
    pts = [(float(e), truth.loss(float(e))) for e in range(1, 9)]
    fit = QualityCurve.fit(pts)
    assert fit is not None and fit == QualityCurve.fit(list(pts))
    ref = ref_core.QualityCurve.fit(pts)
    assert dataclasses.astuple(fit) == dataclasses.astuple(ref)
    for e in (1.0, 3.0, 6.0):
        assert fit.marginal(e) == pytest.approx(truth.marginal(e), rel=0.35)
    assert fit.marginal(1.0) > fit.marginal(6.0)


def test_quality_curve_fit_degenerate_inputs():
    assert QualityCurve.fit([]) is None
    assert QualityCurve.fit([(1.0, 0.5), (2.0, 0.4)]) is None
    assert QualityCurve.fit([(2.0, 0.5), (2.0, 0.5), (2.0, 0.5)]) is None
    assert QualityCurve.fit([(1.0, 0.3), (2.0, 0.4), (3.0, 0.5)]) is None


def _elastic_job(pkg, core_pkg, level=1):
    job = pkg.sample_jobs(trace_cfg(pkg, 3), 1)[0]
    return replace(job, elastic=core_pkg.ElasticProfile(
        levels=(0.5, 1.0, 1.5), level=level,
        curve=core_pkg.QualityCurve(a=0.8, b=1.0, c=0.1)))


def test_at_level_scales_demands_as_repro():
    job = _elastic_job(sim, core)
    ref = _elastic_job(ref_sim, ref_core)
    for lvl in (0, 1, 2):
        a, b = job.at_level(lvl), ref.at_level(lvl)
        assert (a.worker_demand, a.ps_demand, a.batch_size, a.gamma) == \
            (b.worker_demand, b.ps_demand, b.batch_size, b.gamma)
    up, down = job.at_level(2), job.at_level(0)
    assert up.elastic.level == 2
    for r, v in job.worker_demand.items():
        assert up.worker_demand[r] == pytest.approx(v * 1.5)
        assert down.worker_demand[r] == pytest.approx(v * 0.5)
    assert up.batch_size == max(1, int(round(job.batch_size * 1.5)))
    assert up.ps_demand == job.ps_demand and up.gamma == job.gamma
    with pytest.raises(ValueError):
        job.at_level(3)
    with pytest.raises(ValueError):
        replace(job, elastic=None).at_level(1)


def test_elastic_defaults_leave_stream_untouched():
    base = sim.sample_jobs(trace_cfg(sim, 11), 40)
    knobbed = sim.sample_jobs(trace_cfg(sim, 11, marginal_floor=0.5,
                                        damper_loss=0.9, deadline_frac=1.0,
                                        slo_frac=1.0), 40)
    assert base == knobbed
    assert all(j.elastic is None for j in base)
    annotated = sim.sample_jobs(_storm(sim, 11), 40)
    assert [replace(j, elastic=None) for j in annotated] == base
    assert any(j.elastic is not None for j in annotated)
    ref = ref_sim.sample_jobs(_storm(ref_sim, 11), 40)
    assert [dataclasses.asdict(j) for j in annotated] == \
        [dataclasses.asdict(j) for j in ref]


# -------------------------------------------- reshape-free bit-identity
def _strip_elastic(events):
    for ev in events:
        if ev.job is not None and ev.job.elastic is not None:
            ev = replace(ev, job=replace(ev.job, elastic=None))
        yield ev


def _strip_quality(summary):
    return {k: v for k, v in summary.items() if k not in QUALITY_KEYS}


@pytest.mark.parametrize("policy", ALL_POLICIES)
def test_reshape_free_elastic_matches_static_run(policy):
    cfg = _storm(sim, 17, num_jobs=40, marginal_floor=0.0, damper_loss=0.0)
    r1, e1, _ = run_sim(sim, policy, "batched", 17, trace=cfg)
    r2, e2, _ = run_sim(sim, policy, "batched", 17, trace=cfg,
                        events=_strip_elastic(sim.stream(cfg)))
    assert _strip_quality(r1.summary) == _strip_quality(r2.summary)
    assert r1.slots_run == r2.slots_run
    assert np.array_equal(ledger(e1), ledger(e2))
    assert list(_strip_elastic(e1.journal)) == e2.journal
    assert r1.summary["reshapes"] == 0 == r2.summary["reshapes"]
    assert r1.summary["deadline_jobs"] > 0 and r1.summary["slo_jobs"] > 0
    assert r2.summary["deadline_jobs"] == 0 and r2.summary["slo_jobs"] == 0


# ---------------------------------------- reshape storms: conservation
@settings(max_examples=3, deadline=None)
@given(seeds(), policies(("fifo", "drf", "dorm")))
def test_storm_ledger_conserved_and_engines_agree(seed, policy):
    """On reshape-heavy traces the batched and per-event engines agree
    bit for bit; ``check_ledger`` (always on) raises on any
    oversubscription."""
    _modes(policy, seed, num_jobs=40, trace=_storm(sim, seed, num_jobs=40))


@pytest.mark.parametrize("policy", ALL_POLICIES)
def test_storm_matches_repro(policy):
    """A 40-job reshape storm through the batched engine decides as
    ``repro``'s batched engine on the numpy backend, and the port's
    per-event oracle agrees with it."""
    kw = dict(num_jobs=40, trace=_storm(sim, 23, num_jobs=40))
    got = assert_port_matches_repro(policy, 23, **kw)
    assert got[0].summary["reshapes"] > 0
    assert_engines_identical(run_sim(sim, policy, "event", 23, **kw), got)


def test_storm_actually_reshapes():
    for policy in ("pdors", "fifo"):
        rep, eng, _ = run_sim(sim, policy, "batched", 23,
                              trace=_storm(sim, 23))
        s = rep.summary
        assert s["reshapes"] > 0, policy
        assert s["events"].get("reshape", 0) == s["reshapes"]
        assert sum(oc.reshapes for oc in eng.metrics.outcomes.values()) \
            == s["reshapes"]


def test_storm_chaos_engines_agree():
    """Reshapes, machine incidents and re-fail cascades in one soup: both
    engine modes agree, and the port decides as ``repro``."""
    _modes("fifo", 29, trace=_storm(sim, 29), faults=True)
    assert_port_matches_repro("fifo", 29, trace=_storm(sim, 29),
                              faults=True)


def test_storm_quality_exact_vs_streaming():
    storm = _storm(sim, 23, num_jobs=40)
    r1, _, _ = run_sim(sim, "pdors", "batched", 23, trace=storm,
                       metrics_mode="exact")
    r2, _, _ = run_sim(sim, "pdors", "batched", 23, trace=storm,
                       metrics_mode="streaming")
    assert r1.summary["reshapes"] > 0
    for k in ("reshapes", "deadline_jobs", "deadline_hits", "slo_jobs",
              "slo_hits", "deadline_attainment", "slo_attainment"):
        assert r1.summary[k] == r2.summary[k], k
    assert r1.summary["final_loss_mean"] == pytest.approx(
        r2.summary["final_loss_mean"])


def test_elastic_on_the_torch_ledger():
    """``test_elastic_jax_backend``'s counterpart: the 30-job storm on the
    torch ledger, both engine modes, against ``repro`` on numpy."""
    _modes("fifo", 2, num_jobs=30, trace=_storm(sim, 2, num_jobs=30))
    assert_port_matches_repro("fifo", 2, num_jobs=30,
                              trace=_storm(sim, 2, num_jobs=30))


# ------------------------------------------------ warm-vs-cold parity
def test_warm_vs_cold_decision_parity_under_signature_churn():
    """The port keeps no warm bundle store: ``use_warm_bundles`` True and
    False decide identically, and both as ``repro``'s warm run."""
    storm = _storm(sim, 31, num_jobs=40)
    warm = assert_port_matches_repro(
        "pdors", 31, trace=storm, policy_kwargs={"use_warm_bundles": True})
    cold = run_sim(sim, "pdors", "batched", 31, trace=storm,
                   policy_kwargs={"use_warm_bundles": False})
    assert_engines_identical(warm, cold)
    assert warm[2] == cold[2]
    assert warm[1].policy.use_warm_bundles
    assert not cold[1].policy.use_warm_bundles
    assert warm[0].summary["reshapes"] > 0


# --------------------------------------------------- recovery parity
@pytest.mark.parametrize("mode", ["event", "batched"])
def test_recover_replays_inflight_reshapes_bit_identically(mode):
    """Kill mid-storm (elastic state, requeued re-offers and cooldowns in
    flight) and recover from the checkpoint: the finished run equals the
    uninterrupted one bit for bit."""
    storm = _storm(sim, 37)
    ref, ref_eng, _ = run_sim(sim, "pdors", mode, 37, trace=storm)
    assert ref.summary["reshapes"] > 0
    kill = ref.slots_run // 2
    win = sim.RollingWindow(core.make_cluster(6, 12, device="cpu"))
    pol = sim.make_policy("pdors", price_params=sim.calibrate_prices(
        storm, win.cluster, n=16), quanta=8)
    eng = sim.SimEngine(win, pol, seed=37, max_slots=2500,
                        patience=storm.patience, engine_mode=mode,
                        refail_rate=0.1, checkpoint_every=8, kill_at=kill)
    with pytest.raises(sim.SimKilled):
        eng.run(sim.stream(storm))
    rec = eng.recover(sim.stream(storm))
    assert rec.summary == ref.summary
    assert rec.slots_run == ref.slots_run
    assert np.array_equal(ledger(eng), ledger(ref_eng))
    assert eng.metrics.outcomes == ref_eng.metrics.outcomes


def test_storm_with_faults_and_checkpoints_matches_repro():
    """pdors through a storm with machine incidents and checkpoints on:
    the port decides as ``repro``, and both engine modes agree."""
    kw = dict(num_jobs=40, trace=_storm(sim, 41, num_jobs=40), faults=True,
              checkpoint_every=16)
    got = assert_port_matches_repro("pdors", 41, **kw)
    assert got[0].summary["reshapes"] > 0
    assert got[0].summary["machine_incidents"] > 0
    assert_engines_identical(run_sim(sim, "pdors", "event", 41, **kw), got)
