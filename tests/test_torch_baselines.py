"""The rest of the port's ``core``: the §5 baselines (fifo/drf/dorm and
OASiS), the shared round-robin placement, the Fig. 10 offline optimum and
Theorem 5's bound, on ``device="cpu"``, against the JAX package on the
same jobs (carried across with ``convert.jobs_from_records``) at the
seeds of ``tests/test_baselines.py``, ``tests/test_scheduler.py`` and
``tests/test_workload_and_pricing.py``."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import repro.core as ref
from repro.core.baselines import place_round_robin_free as ref_place
from repro_torch import core
from repro_torch.convert import jobs_from_records
from repro_torch.core.baselines import place_round_robin_free
from repro_torch.obs import trace


def _jobs(seed, n, scale, horizon=12, **kw):
    kw.setdefault("batch", (20, 100))
    ref_jobs = ref.synthetic_jobs(ref.WorkloadConfig(
        num_jobs=n, horizon=horizon, seed=seed, workload_scale=scale, **kw))
    return ref_jobs, jobs_from_records([dataclasses.asdict(j)
                                        for j in ref_jobs])


def _small_jobs():
    """test_scheduler.py's offline-optimum instance, in both packages."""
    out = []
    for pkg in (ref, core):
        out.append([
            pkg.JobSpec(
                job_id=i, arrival=i % 2, epochs=1, num_samples=800 + 200 * i,
                batch_size=6, tau=1e-3, grad_size=100.0, gamma=2.0,
                bw_internal=1e6, bw_external=2e5,
                worker_demand={"gpu": 1.0, "cpu": 2.0, "mem": 4.0,
                               "storage": 1.0},
                ps_demand={"gpu": 0.0, "cpu": 2.0, "mem": 4.0,
                           "storage": 1.0},
                utility=pkg.SigmoidUtility(40.0 - 5 * i, 0.5, 3.0))
            for i in range(4)])
    return out


def decision_trace(res):
    out = []
    for r in res.records:
        slots = None
        if r.schedule is not None:
            slots = {t: (sorted(a.workers.items()), sorted(a.ps.items()))
                     for t, a in r.schedule.slots.items()}
        out.append((r.job.job_id, r.admitted, slots))
    return out


# (workload seed, jobs, scale, machines, scheduler seed): test_baselines'
# golden seed and its determinism seed, test_scheduler's accounting seed
BASELINE_POINTS = [(42, 12, 0.05, 6, 0), (7, 12, 0.05, 5, 3),
                   (7, 10, 0.05, 8, 0)]


@pytest.mark.parametrize("name", ["fifo", "drf", "dorm"])
@pytest.mark.parametrize("seed,n,scale,H,sched_seed", BASELINE_POINTS)
def test_baseline_outcomes_match_repro(name, seed, n, scale, H, sched_seed):
    ref_jobs, jobs = _jobs(seed, n, scale)
    want = ref.run_baseline(name, ref_jobs, ref.make_cluster(H, 12),
                            seed=sched_seed)
    got = core.run_baseline(name, jobs, core.make_cluster(H, 12,
                                                          device="cpu"),
                            seed=sched_seed)
    assert got.completions == want.completions
    assert got.utilities == want.utilities
    assert got.total_utility == want.total_utility


# (workload seed, jobs, scale, machines): test_baselines' OASiS smoke point
# and test_scheduler's no-co-location point
@pytest.mark.parametrize("seed,n,scale,H", [(6, 8, 0.05, 6), (6, 10, 0.1, 8)])
def test_run_oasis_matches_repro(seed, n, scale, H):
    ref_jobs, jobs = _jobs(seed, n, scale)
    want = ref.run_oasis(ref_jobs, ref.make_cluster(H, 12), quanta=12)
    tracer = trace.Tracer()
    with trace.activate(tracer):
        got = core.run_oasis(jobs, core.make_cluster(H, 12, device="cpu"),
                             quanta=12)
    assert decision_trace(got) == decision_trace(want)
    assert got.total_utility == pytest.approx(want.total_utility, rel=1e-9)
    assert len(got.admitted) >= 1
    # a cpu template gives a cpu OASiS cluster: every bundle and sweep ran
    # there, at R = 6 (the two pseudo-resources)
    routes = {(sp.name, sp.attrs.get("backend")) for sp in tracer.spans
              if sp.name in ("plan.bundle", "dp.sweep")}
    assert routes == {("plan.bundle", "cpu"), ("dp.sweep", "cpu")}
    for rec in got.admitted:
        for alloc in rec.schedule.slots.values():
            w = {h for h, k in alloc.workers.items() if k > 0}
            p = {h for h, k in alloc.ps.items() if k > 0}
            assert not (w & p)


def test_run_oasis_keeps_the_template_backend(monkeypatch):
    """The OASiS cluster is built on the template's backend: with a cpu
    template it never asks for the card."""
    seen = []
    real = core.Cluster.__post_init__

    def spy(self):
        real(self)
        seen.append((self.backend, len(self.resources)))

    monkeypatch.setattr(core.Cluster, "__post_init__", spy)
    _, jobs = _jobs(6, 3, 0.05)
    tmpl = core.make_cluster(4, 6, device="cpu")
    core.run_oasis(jobs, tmpl, quanta=6)
    assert seen[-1] == (tmpl.backend, 6)


@pytest.mark.parametrize("seed", range(6))
def test_place_round_robin_free_matches_repro(seed):
    rng = np.random.default_rng(seed)
    ref_jobs, jobs = _jobs(seed, 3, 0.05)
    H = 5
    free = {(h, r): float(rng.uniform(0.0, 40.0)) for h in range(H)
            for r in ("gpu", "cpu", "mem", "storage")}
    for rj, j in zip(ref_jobs, jobs):
        nw, ns = int(rng.integers(1, 12)), int(rng.integers(1, 4))
        f_ref, f_got = dict(free), dict(free)
        want = ref_place(f_ref, H, rj, nw, ns, np.random.default_rng(seed))
        got = place_round_robin_free(f_got, H, j, nw, ns,
                                     np.random.default_rng(seed))
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.workers, got.ps) == (want.workers, want.ps)
        assert f_got == f_ref


def test_offline_optimum_matches_repro():
    ref_jobs, jobs = _small_jobs()
    want = ref.offline_optimum(ref_jobs, ref.make_cluster(2, 6))
    got = core.offline_optimum(jobs, core.make_cluster(2, 6, device="cpu"))
    assert got.total_utility == want.total_utility

    def chosen(res):
        return {jid: None if s is None else
                {t: (sorted(a.workers.items()), sorted(a.ps.items()))
                 for t, a in s.items()}
                for jid, s in res.chosen.items()}

    assert chosen(got) == chosen(want)
    pd = core.run_pdors(jobs, core.make_cluster(2, 6, device="cpu"),
                        quanta=6)
    assert got.total_utility >= pd.total_utility - 1e-6


@pytest.mark.parametrize("favor", ["packing", "cover"])
def test_theorem5_bound_matches_repro(favor):
    # test_workload_and_pricing.py's point: the generator's defaults
    cfg = ref.WorkloadConfig(num_jobs=30, horizon=20, seed=9)
    ref_jobs = ref.synthetic_jobs(cfg)
    jobs = jobs_from_records([dataclasses.asdict(j) for j in ref_jobs])
    want = ref.theorem5_bound(ref_jobs, ref.make_cluster(10, 20), 20,
                              delta=0.5, favor=favor)
    got = core.theorem5_bound(jobs, core.make_cluster(10, 20, device="cpu"),
                              20, delta=0.5, favor=favor)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert isinstance(got, core.CompetitiveBound)


def test_core_exports_match_repro():
    assert sorted(core.__all__) == sorted(ref.__all__)
    for name, args in (("g_delta_packing", (0.5, 2.0, 9)),
                       ("g_delta_cover", (0.5, 3.0)),
                       ("approximation_ratio", (0.8, 0.5))):
        assert getattr(core, name)(*args) == getattr(ref, name)(*args)
