"""The port's PD-ORS offer path (``repro_torch.run_pdors`` on
``device="cpu"``) against the JAX package's numpy backend and its frozen
pre-vectorization core: identical admissions and per-slot allocations,
total utility at rel=1e-9 (the port's prices are tolerance-equal, its
kernels bit-identical)."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import PDORS as RefPDORS
from repro.core import SubproblemConfig as RefSubproblemConfig
from repro.core import WorkloadConfig as RefWorkloadConfig
from repro.core import estimate_price_params, run_pdors as ref_run_pdors
from repro.core import make_cluster as ref_make_cluster
from repro.core import synthetic_jobs as ref_synthetic_jobs
from repro.core._reference import make_cluster_reference, run_pdors_reference
from repro.core.job import ElasticProfile as RefElasticProfile
from repro.core.job import QualityCurve as RefQualityCurve
import repro_torch as rt
from repro_torch.convert import (
    cluster_from_arrays,
    jobs_from_records,
    price_params_from_dict,
)
from repro_torch.core import PDORS, SubproblemConfig
from repro_torch.kernels import minplus, pricing
from repro_torch.obs import trace

GOLDEN = [(0.1, 3), (0.05, 11), (0.3, 7), (0.003, 0)]


def decision_trace(res):
    out = []
    for r in res.records:
        slots = None
        if r.schedule is not None:
            slots = {t: (sorted(a.workers.items()), sorted(a.ps.items()))
                     for t, a in r.schedule.slots.items()}
        out.append((r.job.job_id, r.admitted, slots))
    return out


def _jobs(scale, seed, n=8, horizon=10):
    ref = ref_synthetic_jobs(RefWorkloadConfig(
        num_jobs=n, horizon=horizon, seed=seed, batch=(30, 150),
        workload_scale=scale))
    return ref, jobs_from_records([dataclasses.asdict(j) for j in ref])


@pytest.mark.parametrize("rng_mode", ["compat", "derived"])
@pytest.mark.parametrize("scale,seed", GOLDEN)
def test_golden_admissions_match_numpy_backend(scale, seed, rng_mode):
    ref_jobs, jobs = _jobs(scale, seed)
    ref = ref_run_pdors(ref_jobs, ref_make_cluster(6, 10, backend="numpy"),
                        cfg=RefSubproblemConfig(rng_mode=rng_mode),
                        quanta=8, seed=0)
    got = rt.run_pdors(jobs, rt.make_cluster(6, 10, device="cpu"),
                       cfg=SubproblemConfig(rng_mode=rng_mode),
                       quanta=8, seed=0)
    assert decision_trace(got) == decision_trace(ref)
    assert got.total_utility == pytest.approx(ref.total_utility, rel=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("rng_mode", ["compat", "derived"])
@pytest.mark.parametrize("scale,seed", GOLDEN)
def test_golden_admissions_on_the_card_match_numpy_backend(scale, seed,
                                                           rng_mode):
    """The seed sweep on the card: a CUDA ledger (both offer kernels, the
    card's repricing) decides as the JAX package's numpy backend does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ref_jobs, jobs = _jobs(scale, seed)
    ref = ref_run_pdors(ref_jobs, ref_make_cluster(6, 10, backend="numpy"),
                        cfg=RefSubproblemConfig(rng_mode=rng_mode),
                        quanta=8, seed=0)
    pricing.LAUNCHES = 0
    minplus.LAUNCHES = 0
    got = rt.run_pdors(jobs, rt.make_cluster(6, 10, device="cuda"),
                       cfg=SubproblemConfig(rng_mode=rng_mode),
                       quanta=8, seed=0)
    assert pricing.LAUNCHES > 0 and minplus.LAUNCHES > 0
    assert decision_trace(got) == decision_trace(ref)
    assert got.total_utility == pytest.approx(ref.total_utility, rel=1e-9)


@pytest.mark.parametrize("scale,seed", GOLDEN)
def test_golden_admissions_match_frozen_core(scale, seed):
    ref_jobs, jobs = _jobs(scale, seed)
    ref = run_pdors_reference(ref_jobs, make_cluster_reference(6, 10),
                              quanta=8, seed=0)
    got = rt.run_pdors(jobs, rt.make_cluster(6, 10, device="cpu"),
                       quanta=8, seed=0)
    assert decision_trace(got) == decision_trace(ref)
    assert got.total_utility == pytest.approx(ref.total_utility, rel=1e-9)


@pytest.mark.parametrize("kw", [
    dict(num_jobs=8, horizon=10, seed=3, batch=(30, 150),
         workload_scale=0.1),
    dict(num_jobs=50, horizon=20, seed=0, batch=(50, 200),
         workload_scale=0.3),
    dict(num_jobs=12, horizon=16, seed=9, arrival_pattern="trace"),
])
def test_synthetic_jobs_are_the_same(kw):
    ref = ref_synthetic_jobs(RefWorkloadConfig(**kw))
    got = rt.synthetic_jobs(rt.WorkloadConfig(**kw))
    assert [dataclasses.asdict(j) for j in got] == \
        [dataclasses.asdict(j) for j in ref]


def test_job_records_round_trip_with_elastic_profile():
    ref_jobs, _ = _jobs(0.1, 3)
    el = RefElasticProfile(levels=(0.5, 1.0, 2.0), level=1,
                           curve=RefQualityCurve(a=0.3, b=1.2, c=0.05),
                           marginal_floor=0.01, deadline=7)
    ref = dataclasses.replace(ref_jobs[0], elastic=el)
    got = jobs_from_records([dataclasses.asdict(ref)])[0]
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.elastic.curve.loss(2.0) == ref.elastic.curve.loss(2.0)
    assert got.at_level(2).batch_size == ref.at_level(2).batch_size


@pytest.mark.parametrize("scale,seed", [(0.1, 3), (0.05, 11)])
def test_mid_run_handover(scale, seed):
    """Run the reference over the first half of the jobs, carry its ledger
    and prices across, then continue both: same decisions."""
    ref_jobs, jobs = _jobs(scale, seed, n=10)
    half = len(ref_jobs) // 2
    cl_ref = ref_make_cluster(6, 10, backend="numpy")
    params = estimate_price_params(ref_jobs, cl_ref, cl_ref.horizon)
    RefPDORS(cl_ref, params, quanta=8, seed=0).run(ref_jobs[:half])
    assert cl_ref.version > 0

    used = cl_ref.backend.to_host(cl_ref._used)
    caps = [dict(m.capacity) for m in cl_ref.machines]
    cl = cluster_from_arrays(caps, cl_ref.horizon, used, device="cpu")
    np.testing.assert_array_equal(cl.backend.to_host(cl._used), used)
    for t in range(cl.horizon):
        np.testing.assert_array_equal(cl.free_matrix(t),
                                      cl_ref.free_matrix(t))

    rest_ref = RefPDORS(cl_ref, params, quanta=8, seed=1).run(
        ref_jobs[half:])
    rest = PDORS(cl, price_params_from_dict(dataclasses.asdict(params)),
                 quanta=8, seed=1).run(jobs[half:])
    assert decision_trace(rest) == decision_trace(rest_ref)
    assert rest.total_utility == pytest.approx(rest_ref.total_utility,
                                               rel=1e-9)


def test_cpu_run_takes_the_plain_versions_and_spans_say_so():
    """On a CPU ledger no kernel launches, and the bundle and sweep spans
    record the cpu route."""
    _, jobs = _jobs(0.05, 11)
    pricing.LAUNCHES = 0
    minplus.LAUNCHES = 0
    tracer = trace.Tracer()
    with trace.activate(tracer):
        res = rt.run_pdors(jobs, rt.make_cluster(6, 10, device="cpu"),
                           quanta=8, seed=0)
    assert res.admitted
    assert pricing.LAUNCHES == 0 and minplus.LAUNCHES == 0
    routes = {(sp.name, sp.attrs.get("backend")) for sp in tracer.spans
              if sp.name in ("plan.bundle", "dp.sweep")}
    assert routes == {("plan.bundle", "cpu"), ("dp.sweep", "cpu")}
    assert tracer.well_formed()

