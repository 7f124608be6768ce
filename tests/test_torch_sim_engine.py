"""The port's two engine modes on the torch ledger: ``engine_mode=
"batched"`` must be bit-identical to the per-event oracle (``"event"``)
— same summary dict, slot count, ledger tensor, journal and per-job
outcome rows — on clean streams and on chaos soups (machine incidents,
job failures and re-fail cascades, same-slot collisions, checkpoints),
for pdors and for fifo/drf/dorm, as ``tests/test_sim_batch.py`` holds
the JAX package's engine; and the batched port must decide as the JAX
package's batched engine does, faults included."""
from __future__ import annotations

import numpy as np
import pytest
from hypothesis import given, settings

from strategies import SLOT_POLICIES, policies, seeds
from repro_torch import sim
from test_torch_sim import (
    assert_engines_identical,
    assert_port_matches_repro,
    assert_same_run,
    make_port_engine,
    make_ref_engine,
    run_logged,
    run_sim,
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


# ------------------------------------------------------- chaos soups
def assert_chaos_modes_identical(policy, seed, **kw):
    """tests/strategies.py's ``assert_equivalent`` on the torch ledger:
    the batched engine equals the per-event oracle bit for bit."""
    event = run_sim(sim, policy, "event", seed, **kw)
    batched = run_sim(sim, policy, "batched", seed, **kw)
    assert_engines_identical(
        event, batched,
        exact_outcomes=kw.get("metrics_mode", "exact") == "exact")
    return batched


@settings(max_examples=3, deadline=None)
@given(seeds(), policies(SLOT_POLICIES))
def test_batched_equiv_chaos_event_soup(seed, policy):
    """Chaos soups (machine incidents, failures, re-fail cascades) force
    same-slot collisions across every event kind."""
    rep = assert_chaos_modes_identical(policy, seed, faults=True)[0]
    assert rep.summary["machine_incidents"] > 0


@settings(max_examples=2, deadline=None)
@given(seeds())
def test_batched_equiv_same_slot_collisions(seed):
    """A high arrival rate: most slots carry multi-event groups."""
    assert_chaos_modes_identical("fifo", seed, rate=8.0, num_jobs=80)


@pytest.mark.parametrize("metrics_mode", ["exact", "streaming"])
def test_batched_equiv_pdors_with_faults(metrics_mode):
    rep = assert_chaos_modes_identical("pdors", 3, num_jobs=40, faults=True,
                                       metrics_mode=metrics_mode)[0]
    assert rep.summary["machine_incidents"] > 0


@pytest.mark.parametrize("policy", ["fifo", "dorm"])
def test_batched_equiv_streaming_metrics_with_faults(policy):
    assert_chaos_modes_identical(policy, 11, metrics_mode="streaming",
                                 faults=True)


def test_batched_equiv_with_checkpoints():
    """Checkpoints keep the whole journal and snapshot the batched mode's
    state; the recovery bookkeeping must not perturb parity."""
    assert_chaos_modes_identical("fifo", 7, faults=True, checkpoint_every=16)


@pytest.mark.parametrize("policy", ["pdors", "fifo", "drf", "dorm"])
def test_batched_chaos_port_matches_batched_numpy_backend(policy):
    """The chaos soup through the batched engine decides as the JAX
    package's batched engine on its numpy backend."""
    rep = assert_port_matches_repro(policy, 3, num_jobs=40, faults=True)[0]
    assert rep.summary["machine_incidents"] > 0
