"""Job generators reproducing the paper's experimental setup (§5).

Synthetic generator: E in [50,200], K in [20000,500000], g in [30,575] MB,
tau in [1e-5,1e-4] slots, gamma in [1,10], F in [1,200]; worker demand
0-4 GPU / 1-10 vCPU / 2-32 GB mem / 5-10 GB storage; PS demand the same
minus GPU; sigmoid utility with the (10%, 55%, 35%) insensitive/sensitive/
critical mix; arrivals alternate 1/3, 2/3 per slot (Google-trace-derived).

A Google-trace-like generator reproduces Figs. 12-17: bursty arrivals and
the (30%, 69%, 1%) scheduling-class mix measured in the trace analysis [44].

An architecture-aware generator maps the 10 assigned model configs to job
parameters (tau_i from FLOPs/sample at assumed chip throughput, g_i from
parameter bytes) so scheduler experiments run over realistic DNN jobs.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .job import JobSpec, SigmoidUtility


@dataclass
class WorkloadConfig:
    num_jobs: int = 50
    horizon: int = 20
    seed: int = 0
    # job-parameter ranges (paper §5)
    epochs: Tuple[int, int] = (50, 200)
    samples: Tuple[int, int] = (20_000, 500_000)
    grad_mb: Tuple[float, float] = (30.0, 575.0)
    tau: Tuple[float, float] = (1e-5, 1e-4)
    gamma: Tuple[float, float] = (1.0, 10.0)
    batch: Tuple[int, int] = (1, 200)
    # bandwidth (MB/slot); the paper never states b values — only that
    # b_ext << b_int.  Calibrated so the median job's comm time per sample
    # is comparable to tau (paper jobs complete within theta3 in [1,15]).
    bw_internal: Tuple[float, float] = (5e6, 2e7)
    ext_over_int: float = 0.2
    # utility mix: (insensitive, sensitive, critical) fractions
    mix: Tuple[float, float, float] = (0.10, 0.55, 0.35)
    theta1: Tuple[float, float] = (1.0, 100.0)
    theta3: Tuple[float, float] = (1.0, 15.0)
    arrival_pattern: str = "alternating"  # "alternating" | "trace"
    # scale down workload so jobs are completable within short horizons
    workload_scale: float = 1.0


def _utility(rng: np.random.Generator, cfg: WorkloadConfig) -> SigmoidUtility:
    u = rng.random()
    t1 = rng.uniform(*cfg.theta1)
    t3 = rng.uniform(*cfg.theta3)
    if u < cfg.mix[0]:
        t2 = 0.0
    elif u < cfg.mix[0] + cfg.mix[1]:
        t2 = rng.uniform(0.01, 1.0)
    else:
        t2 = rng.uniform(4.0, 6.0)
    return SigmoidUtility(theta1=t1, theta2=t2, theta3=t3)


def _arrivals(rng: np.random.Generator, cfg: WorkloadConfig) -> List[int]:
    """Alternating 1/3 and 2/3 rates (paper §5) or bursty trace-like."""
    T, n = cfg.horizon, cfg.num_jobs
    if cfg.arrival_pattern == "alternating":
        weights = np.array([1.0 if t % 2 == 0 else 2.0 for t in range(T)])
    else:  # trace: diurnal-ish burst profile
        tt = np.arange(T)
        weights = 1.0 + 2.0 * np.exp(-((tt - T * 0.3) ** 2) / (0.02 * T * T)) \
            + 1.5 * np.exp(-((tt - T * 0.7) ** 2) / (0.03 * T * T))
    weights = weights / weights.sum()
    return sorted(rng.choice(T, size=n, p=weights).tolist())


def draw_job(
    rng: np.random.Generator, cfg: WorkloadConfig, job_id: int, arrival: int
) -> JobSpec:
    """Draw one job's parameters from ``rng`` (the §5 synthetic ranges).

    This is the loop body of ``synthetic_jobs`` factored out so streaming
    generators (``repro_torch.sim.traces``) can call it with a per-job
    *derived* generator — every (job_id, parameter) pair is then
    reproducible without replaying the whole sequential stream. The draw order is frozen: E, K,
    F, g, tau, gamma, b_int, worker demands, PS demands, utility."""
    E = int(rng.integers(cfg.epochs[0], cfg.epochs[1] + 1))
    K = int(rng.integers(cfg.samples[0], cfg.samples[1] + 1))
    if cfg.workload_scale != 1.0:
        K = max(1, int(K * cfg.workload_scale))
    F = int(rng.integers(cfg.batch[0], cfg.batch[1] + 1))
    g = rng.uniform(*cfg.grad_mb)
    tau = rng.uniform(*cfg.tau)
    gamma = rng.uniform(*cfg.gamma)
    b_int = rng.uniform(*cfg.bw_internal)
    worker = {
        "gpu": float(rng.integers(0, 5)),
        "cpu": float(rng.integers(1, 11)),
        "mem": float(rng.integers(2, 33)),
        "storage": float(rng.integers(5, 11)),
    }
    ps = {
        "gpu": 0.0,
        "cpu": float(rng.integers(1, 11)),
        "mem": float(rng.integers(2, 33)),
        "storage": float(rng.integers(5, 11)),
    }
    return JobSpec(
        job_id=job_id, arrival=int(arrival), epochs=E, num_samples=K,
        batch_size=F, tau=tau, grad_size=g, gamma=gamma,
        bw_internal=b_int, bw_external=b_int * cfg.ext_over_int,
        worker_demand=worker, ps_demand=ps,
        utility=_utility(rng, cfg),
    )


def synthetic_jobs(cfg: WorkloadConfig) -> List[JobSpec]:
    rng = np.random.default_rng(cfg.seed)
    arrivals = _arrivals(rng, cfg)
    return [draw_job(rng, cfg, i, a) for i, a in enumerate(arrivals)]


def trace_jobs(cfg: WorkloadConfig) -> List[JobSpec]:
    """Google-trace-like: bursty arrivals + (30%, 69%, 1%) class mix."""
    cfg2 = WorkloadConfig(**{**cfg.__dict__})
    cfg2.arrival_pattern = "trace"
    cfg2.mix = (0.30, 0.69, 0.01)
    return synthetic_jobs(cfg2)


# ----------------------------------------------------------------------
# Architecture-aware jobs: map the assigned model configs to (tau, g).
# ----------------------------------------------------------------------
def arch_jobs(
    arch_stats: Dict[str, Dict[str, float]],
    num_jobs: int,
    horizon: int,
    seed: int = 0,
    chip_flops: float = 197e12,
    samples_range: Tuple[int, int] = (2_000, 20_000),
    epochs_range: Tuple[int, int] = (2, 8),
) -> List[JobSpec]:
    """arch_stats: id -> {flops_per_token, param_bytes, seq_len}.

    tau_i = seq_len * flops_per_token * 3 / chip_flops  (fwd+bwd ~ 3x fwd)
    g_i   = param_bytes (MB)
    """
    rng = np.random.default_rng(seed)
    ids = sorted(arch_stats)
    cfg = WorkloadConfig(num_jobs=num_jobs, horizon=horizon, seed=seed)
    arrivals = _arrivals(rng, cfg)
    jobs = []
    for i, a in enumerate(arrivals):
        aid = ids[int(rng.integers(0, len(ids)))]
        st = arch_stats[aid]
        tau = st["flops_per_token"] * st.get("seq_len", 4096.0) * 3.0 / chip_flops
        g_mb = st["param_bytes"] / 1e6
        K = int(rng.integers(*samples_range))
        E = int(rng.integers(*epochs_range))
        F = int(rng.integers(16, 257))
        jobs.append(
            JobSpec(
                job_id=i, arrival=int(a), epochs=E, num_samples=K,
                batch_size=F, tau=tau, grad_size=g_mb, gamma=float(rng.uniform(1, 8)),
                bw_internal=50e3, bw_external=6.25e3,  # MB/slot-ish (ICI vs DCI)
                worker_demand={"chips": 1.0, "hbm": 16.0, "host_cpu": 4.0, "host_mem": 16.0},
                ps_demand={"chips": 0.0, "hbm": 4.0, "host_cpu": 2.0, "host_mem": 8.0},
                utility=_utility(rng, cfg),
                arch=aid,
            )
        )
    return jobs
