"""The port's scheduler-driven training runtime
(``repro_torch.launch.cluster``) against the JAX package's
``examples/cluster_sim.py`` default mode on the CPU.

The scheduler half is held to ``repro.core`` on the numpy backend at the
example's defaults (8 slots, 6 jobs), at ``tests/test_examples.py``'s
point (4 slots, 4 jobs) and over Gemma-7B and Qwen3-32B alone: the
admitted set, every slot's worker and PS placement and the utility are
identical. The runtime is held to the example's loop (reproduced here
step for step with the reference's ``make_train_state``, jitted
``make_train_step`` and ``concrete_batch``) at the (4, 4) point, at the
example's 3 steps a slot: each job's ``model.init(PRNGKey(job_id))`` tree
is carried across with ``convert`` and both sides train on the
reference's batches; each slot's loss agrees within 1e-5 (float32, the
frameworks sum in other orders). The warm-up keeps the early steps'
learning rate small (step k's is 5e-6 k), so each job's state is also
held directly: its step counter and its params module carry from slot to
slot."""
from __future__ import annotations

import gc
import weakref

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_config
from repro.configs.base import InputShape as JInputShape
from repro.core import arch_jobs as jax_arch_jobs
from repro.core import make_cluster as jax_make_cluster
from repro.core import run_pdors as jax_run_pdors
from repro.models import build_model as jax_build
from repro.models import concrete_batch as jax_concrete_batch
from repro.optim import AdamWConfig as JAdamWConfig
from repro.train import make_train_state as jax_train_state
from repro.train import make_train_step as jax_train_step
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import cluster
from repro_torch.models import build_model, concrete_batch
from repro_torch.optim import AdamWConfig
from repro_torch.train import make_train_state, make_train_step

#: (arch ids or None for all ten, slots, jobs)
POINTS = {"defaults": (None, 8, 6), "examples_test": (None, 4, 4),
          "gemma_qwen3": (["gemma-7b", "qwen3-32b"], 8, 6)}


def _reference_schedule(ids, slots, jobs):
    """The example's scheduler half (``cluster_sim.py:88-102``) on the
    numpy backend."""
    stats = {}
    for aid in (JAX_ARCH_IDS if ids is None else ids):
        cfg = jax_config(aid)
        stats[aid] = {"flops_per_token": 2.0 * cfg.active_param_count(),
                      "param_bytes": cfg.param_count() * 2.0,
                      "seq_len": 512.0}
    offered = jax_arch_jobs(stats, num_jobs=jobs, horizon=slots, seed=0,
                            samples_range=(60, 300), epochs_range=(1, 2))
    cl = jax_make_cluster(8, slots, preset="tpu", capacity_scale=4.0,
                          backend="numpy")
    return stats, jax_run_pdors(offered, cl, quanta=slots)


def _decisions(res):
    """(job id, arch, admitted, slot -> (workers, PSs) by machine)."""
    out = []
    for r in res.records:
        slots = None
        if r.schedule is not None:
            slots = {t: (sorted(a.workers.items()), sorted(a.ps.items()))
                     for t, a in r.schedule.slots.items()}
        out.append((r.job.job_id, r.job.arch, r.admitted, slots))
    return out


@pytest.mark.parametrize("point", list(POINTS))
def test_schedule_matches_the_reference(point):
    ids, slots, jobs = POINTS[point]
    stats, want = _reference_schedule(ids, slots, jobs)
    assert cluster.arch_stats(ids) == stats
    got = cluster.schedule(ids, slots, jobs, device="cpu")
    assert _decisions(got) == _decisions(want)
    assert got.total_utility == want.total_utility
    assert [r.job.job_id for r in got.admitted] == \
        [r.job.job_id for r in want.admitted]


def test_schedule_admits_what_the_example_admits():
    """The counts and utilities the example prints at the three points."""
    got = {name: cluster.schedule(ids, slots, jobs, device="cpu")
           for name, (ids, slots, jobs) in POINTS.items()}
    assert {name: (len(r.admitted), len(r.records),
                   round(r.total_utility, 2))
            for name, r in got.items()} == {
        "defaults": (6, 6, 368.90), "examples_test": (3, 4, 191.16),
        "gemma_qwen3": (4, 6, 261.12)}


def _reference_runtime(res, slots, steps_per_slot):
    """``cluster_sim.py:105-147`` with the reference's own functions: each
    job's initial params tree, and its losses and batches a slot."""
    opt = JAdamWConfig(lr=1e-3)
    trees, losses, batches, runs = {}, {}, {}, {}
    for rec in res.admitted:
        cfg = jax_config(rec.job.arch, reduced=True)
        model = jax_build(cfg)
        state = jax_train_state(model, jax.random.PRNGKey(rec.job.job_id),
                                opt)
        trees[rec.job.job_id] = jax.tree.map(np.asarray, state["params"])
        runs[rec.job.job_id] = [cfg, state,
                                jax.jit(jax_train_step(model, opt))]
        losses[rec.job.job_id] = []
    for t in range(slots):
        for rec in res.admitted:
            if t not in rec.schedule.slots:
                continue
            run = runs[rec.job.job_id]
            n_workers = rec.schedule.slots[t].total_workers()
            shape = JInputShape("sim", 64, max(4, min(16, n_workers)),
                                "train")
            for k in range(steps_per_slot):
                seed = rec.job.job_id * 1000 + t * 10 + k
                batch = jax_concrete_batch(run[0], shape, seed=seed)
                batches[seed] = {n: np.array(v) for n, v in batch.items()}
                run[1], metrics = run[2](run[1], batch)
            losses[rec.job.job_id].append(float(metrics["loss"]))
    return trees, losses, batches


def test_run_jobs_matches_the_reference_runtime():
    slots, steps = 4, 3
    _, res = _reference_schedule(None, slots, 4)
    trees, want, batches = _reference_runtime(res, slots, steps)

    def init(job_id, model, device):
        to_port = convert.encdec_params_from_jax if model.is_encdec \
            else convert.lm_params_from_jax
        return to_port(model.cfg, trees[job_id], device)

    def batch_for(cfg, shape, seed, device):
        return {n: torch.from_numpy(v).to(device)
                for n, v in batches[seed].items()}

    got = cluster.run_jobs(cluster.schedule(None, slots, 4, device="cpu"),
                           lambda aid: get_config(aid, reduced=True),
                           slots, steps, device="cpu", init=init,
                           batch_for=batch_for)
    assert sorted(got) == sorted(want) == [0, 1, 3]
    for jid, losses in want.items():
        assert len(got[jid]) == len(losses)
        np.testing.assert_allclose(got[jid], losses, rtol=0, atol=1e-5,
                                   err_msg=f"job {jid}")


def test_run_jobs_carries_each_jobs_state_from_slot_to_slot():
    """A job's step counter runs on across its slots (steps_per_slot a
    slot) and its params module is the one built at its first slot."""
    slots, steps = 4, 2
    res = cluster.schedule(None, slots, 4, device="cpu")
    seen, params = {}, {}

    def on_slot(t, rec, workers, state, metrics):
        jid = rec.job.job_id
        seen[jid] = seen.get(jid, 0) + 1
        assert int(state["opt"]["step"]) == steps * seen[jid]
        assert params.setdefault(jid, state["params"]) is state["params"]

    cluster.run_jobs(res, lambda aid: get_config(aid, reduced=True), slots,
                     steps, device="cpu", on_slot=on_slot)
    assert seen == {r.job.job_id: len(r.schedule.slots)
                    for r in res.admitted}
    assert max(seen.values()) >= 2


def test_run_jobs_equals_an_eager_build_and_frees_each_job_after_its_last_slot():
    """Building a job's state at its first slot changes no number: the
    losses are those of every state built before slot 0 (the
    reference's order), to float32 noise (1e-5: the CPU's products are
    not bitwise repeatable within a process under load; a job drawn
    from another seed is off by 1e-3 or more). A job's params are gone
    once its last slot has passed."""
    slots, steps = 4, 2
    res = cluster.schedule(None, slots, 4, device="cpu")
    cfg_for = lambda aid: get_config(aid, reduced=True)  # noqa: E731
    alive, first_slot = {}, {}

    def init(job_id, model, device):
        params = model.init(job_id, device)
        alive[job_id] = weakref.ref(params)
        return params

    def on_slot(t, rec, workers, state, metrics):
        first_slot.setdefault(rec.job.job_id, t)
        gc.collect()
        for r in res.admitted:
            jid = r.job.job_id
            if jid in alive:
                assert (alive[jid]() is None) == (max(r.schedule.slots) < t)

    got = cluster.run_jobs(res, cfg_for, slots, steps, device="cpu",
                           init=init, on_slot=on_slot)
    assert first_slot == {r.job.job_id: min(r.schedule.slots)
                          for r in res.admitted}
    gc.collect()
    assert all(ref() is None for ref in alive.values())

    opt = AdamWConfig(lr=1e-3)
    eager = {}
    for r in res.admitted:
        model = build_model(cfg_for(r.job.arch))
        eager[r.job.job_id] = (model, make_train_state(model, r.job.job_id,
                                                       opt, "cpu"),
                               make_train_step(model, opt), [])
    for t in range(slots):
        for r in res.admitted:
            if t not in r.schedule.slots:
                continue
            model, state, step, losses = eager[r.job.job_id]
            shape = InputShape("sim", 64, cluster.global_batch(
                r.schedule.slots[t].total_workers()), "train")
            for k in range(steps):
                batch = concrete_batch(
                    model.cfg, shape, seed=r.job.job_id * 1000 + t * 10 + k,
                    device="cpu")
                state, metrics = step(state, batch)
            eager[r.job.job_id] = (model, state, step, losses)
            losses.append(float(metrics["loss"]))
    assert sorted(got) == sorted(eager)
    for jid, (_, _, _, losses) in eager.items():
        np.testing.assert_allclose(got[jid], losses, rtol=0, atol=1e-5,
                                   err_msg=f"job {jid}")


@pytest.mark.parametrize("workers,batch", [(1, 4), (3, 4), (4, 4), (11, 11),
                                           (16, 16), (241, 16)])
def test_global_batch_follows_the_workers(workers, batch):
    assert cluster.global_batch(workers) == batch


def test_main_on_the_cpu_prints_the_examples_lines(capsys):
    assert cluster.main(["--device", "cpu", "--slots", "4", "--jobs", "4",
                         "--steps-per-slot", "1"]) == 0
    out = capsys.readouterr().out
    assert "[scheduler] admitted 3/4 jobs, total utility 191.2" in out
    assert "[slot 0] running 2 jobs" in out
    assert "job 3 (mamba2-780m): workers=3 loss=" in out
    assert "[summary]" in out
    assert "job 0 (deepseek-v2-236b): loss " in out


def test_without_a_card_run_jobs_and_main_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    res = cluster.schedule(None, 4, 4, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        cluster.run_jobs(res, lambda aid: get_config(aid, reduced=True), 4,
                         1, device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        cluster.main([])
