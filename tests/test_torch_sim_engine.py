"""The port's two engine modes on the torch ledger: ``engine_mode=
"batched"`` must be bit-identical to the per-event oracle (``"event"``)
— same summary dict, slot count, ledger tensor, journal and per-job
outcome rows — on clean streams, for pdors and for fifo/drf/dorm, as
``tests/test_sim_batch.py`` holds the JAX package's engine; and the
batched port must decide as the JAX package's batched engine does."""
from __future__ import annotations

import numpy as np
import pytest
from hypothesis import given, settings

from strategies import SLOT_POLICIES, policies, seeds
from test_torch_sim import (
    assert_same_run,
    make_port_engine,
    make_ref_engine,
    run_logged,
)

# the suite's standard short google stream (strategies.make_trace), with
# failures and re-failing requeued attempts on
POINT = dict(machines=6, lookahead=12, preset="google", jobs=60, rate=3.0,
             failure_rate=0.1, quanta=8, calib_jobs=16, refail_rate=0.1,
             max_slots=2500)


def _modes(name, seed, **kw):
    point = dict(POINT, seed=seed, **kw)
    runs = {}
    for mode in ("event", "batched"):
        engine, events = make_port_engine(name, engine_mode=mode, **point)
        runs[mode] = (engine.run(events), engine)
    return runs


def assert_modes_identical(name, seed, **kw):
    runs = _modes(name, seed, **kw)
    (r1, e1), (r2, e2) = runs["event"], runs["batched"]
    assert r1.summary == r2.summary
    assert r1.slots_run == r2.slots_run
    assert np.array_equal(e1.window.cluster.backend.to_host(
        e1.window.cluster._used), e2.window.cluster.backend.to_host(
        e2.window.cluster._used))
    assert e1.journal == e2.journal
    if kw.get("metrics_mode", "exact") == "exact":
        assert e1.metrics.outcomes == e2.metrics.outcomes
    return r1, e1


@settings(max_examples=3, deadline=None)
@given(seeds(), policies(SLOT_POLICIES))
def test_batched_equiv_clean_streams(seed, policy):
    """Randomized clean streams, slot-driven policies."""
    assert_modes_identical(policy, seed)


@pytest.mark.parametrize("name", SLOT_POLICIES)
def test_batched_equiv_slot_policies(name):
    rep, _ = assert_modes_identical(name, 11)
    assert rep.summary["jobs_completed"] > 0


@pytest.mark.parametrize("metrics_mode", ["exact", "streaming"])
def test_batched_equiv_pdors(metrics_mode):
    rep, _ = assert_modes_identical("pdors", 3, jobs=40,
                                    metrics_mode=metrics_mode)
    assert rep.summary["preemptions"] > 0


def test_batched_port_matches_batched_numpy_backend():
    """The batched port decides as the JAX package's batched engine on its
    numpy backend."""
    point = dict(POINT, seed=3, jobs=40, engine_mode="batched")
    got = run_logged(*make_port_engine("pdors", **point))
    want = run_logged(*make_ref_engine("pdors", **point))
    assert_same_run(got, want)


def test_batched_reports_admission_latency():
    runs = _modes("fifo", 0)
    lat = runs["batched"][1].admission_latency()
    assert lat["count"] > 0
    assert lat["p99_ms"] >= lat["p50_ms"] >= 0.0
    assert lat["mean_ms"] > 0.0


def test_streaming_outcomes_bounded_by_in_flight():
    """Streaming metrics drop closed jobs' rows and keep exact counts."""
    runs = {}
    for mode in ("exact", "streaming"):
        engine, events = make_port_engine(
            "pdors", engine_mode="batched", metrics_mode=mode,
            **dict(POINT, seed=5, jobs=120, rate=6.0))
        runs[mode] = (engine.run(events).summary, engine)
    s, eng = runs["streaming"]
    closed = (s["jobs_completed"] + s["jobs_rejected"]
              + s["jobs_departed"] + s["jobs_evicted"])
    assert closed > 0
    assert len(eng.metrics.outcomes) <= s["jobs_offered"] - closed
    for k in ("jobs_offered", "jobs_completed", "jobs_rejected",
              "jobs_departed", "jobs_evicted", "preemptions"):
        assert s[k] == runs["exact"][0][k], k
