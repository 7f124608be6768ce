"""Streaming trace generators for the event-driven simulator.

Three presets:

  * ``google``      — bursty diurnal arrivals with the (30%, 69%, 1%)
                      scheduling-class mix measured in the Google trace
                      analysis [44] (the repo's ``trace_jobs`` regime,
                      unrolled into an unbounded stream);
  * ``philly``      — Microsoft-Philly-style heavy tail: job sizes get a
                      lognormal multiplier (most jobs tiny, a fat tail of
                      monsters), GPU-heavy worker demands, a mostly
                      best-effort utility mix;
  * ``alternating`` — the paper §5 synthetic arrival pattern (1/3 vs 2/3
                      per slot), for continuity with the static harness.

Streaming + determinism contract: ``stream()`` is a true generator — it
never materializes the trace. Job i's parameters, its interarrival gap,
and its optional failure slot are all drawn from a generator derived from
``SeedSequence((seed, _TAG_TRACE, i))``, so any (job, event) is
reproducible in isolation: consuming the stream twice, partially, or in a
different harness yields bit-identical jobs. Failure times ride on the
arrival event (``fail_at``) so the stream stays time-ordered; the engine
materializes the FAILURE events.

Parameter draws reuse ``repro_torch.core.workload.draw_job`` — the frozen §5
draw order — so trace jobs are distribution-identical to the static
generators at equal configs.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..core.cluster import Cluster
from ..core.job import ElasticProfile, JobSpec, QualityCurve
from ..core.pricing import PriceParams, estimate_price_params
from ..core.workload import WorkloadConfig, draw_job
from .events import Event, EventKind

_TAG_TRACE = 7
_TAG_ELASTIC = 14  # separate per-job stream for elastic annotations
PRESETS = ("google", "philly", "alternating")


@dataclass
class TraceConfig:
    preset: str = "google"
    num_jobs: int = 500
    seed: int = 0
    arrival_rate: float = 4.0        # mean arrivals per slot (pre-modulation)
    failure_rate: float = 0.0        # fraction of jobs hit by a failure
    failure_delay: Tuple[int, int] = (1, 8)   # slots after arrival
    patience: int = 48               # queued-unserved jobs depart after this
    # sized so the median job runs a handful of slots on one machine-ish
    # worker group: streams show completions, queueing AND rejections
    workload_scale: float = 0.05
    batch: Tuple[int, int] = (8, 64)
    # philly heavy-tail knobs
    tail_sigma: float = 1.2          # lognormal sigma on job size
    tail_cap: float = 40.0           # cap on the size multiplier
    # elastic / quality-driven scenario band. All fractions default 0 and
    # all annotation draws come from a SEPARATE per-job derived stream
    # ((seed, _TAG_ELASTIC, i)), so the base trace — arrivals, job
    # parameters, failure slots — is byte-identical to a non-elastic
    # config at equal knobs.
    elastic_frac: float = 0.0        # fraction of jobs given a profile
    elastic_levels: Tuple[float, ...] = (0.5, 1.0, 1.5)
    marginal_floor: float = 0.0      # SLAQ shrink trigger (0 = off)
    damper_loss: float = 0.0         # adadamp grow trigger (0 = off)
    deadline_frac: float = 0.0       # elastic jobs ALSO given a deadline
    deadline_slack: Tuple[float, float] = (1.5, 4.0)  # x min_completion
    slo_frac: float = 0.0            # elastic jobs ALSO given a loss SLO

    def workload_config(self) -> WorkloadConfig:
        """The per-job parameter ranges backing this preset."""
        if self.preset not in PRESETS:
            raise ValueError(f"unknown preset {self.preset!r}; use {PRESETS}")
        mix = {
            "google": (0.30, 0.69, 0.01),
            "philly": (0.60, 0.35, 0.05),
            "alternating": (0.10, 0.55, 0.35),
        }[self.preset]
        return WorkloadConfig(
            num_jobs=self.num_jobs, horizon=1, seed=self.seed,
            batch=self.batch, workload_scale=self.workload_scale, mix=mix,
        )


def _burst_factor(preset: str, t: float) -> float:
    """Arrival-rate modulation at (fractional) slot t: a diurnal-ish
    double burst for google (period 48 slots), mild sinusoid for philly,
    the paper's 1/3-vs-2/3 alternation otherwise."""
    if preset == "google":
        phase = (t % 48.0) / 48.0
        return (1.0 + 2.0 * math.exp(-((phase - 0.3) ** 2) / 0.02)
                + 1.5 * math.exp(-((phase - 0.7) ** 2) / 0.03)) / 1.9
    if preset == "philly":
        return 1.0 + 0.3 * math.sin(2.0 * math.pi * (t % 64.0) / 64.0)
    return (1.0 / 1.5) if int(t) % 2 == 0 else (2.0 / 1.5)


def _philly_tail(job: JobSpec, rng: np.random.Generator,
                 cfg: TraceConfig) -> JobSpec:
    """Heavy-tail the job size and skew demands GPU-ward."""
    mult = min(float(rng.lognormal(mean=-cfg.tail_sigma ** 2 / 2.0,
                                   sigma=cfg.tail_sigma)), cfg.tail_cap)
    wd = dict(job.worker_demand)
    wd["gpu"] = max(1.0, wd.get("gpu", 0.0))
    return replace(
        job,
        num_samples=max(1, int(job.num_samples * mult)),
        worker_demand=wd,
    )


def _annotate_elastic(job: JobSpec, rng: np.random.Generator,
                      cfg: TraceConfig) -> JobSpec:
    """Attach an ElasticProfile drawn from the job's dedicated elastic
    stream. Draw order is frozen (curve a, b, c; start level; deadline
    gate + slack; SLO gate + epoch fraction) — append-only, like
    ``draw_job``, so recorded elastic traces stay reproducible."""
    a = float(rng.uniform(0.3, 1.5))
    b = float(rng.uniform(0.5, 2.0))
    c = float(rng.uniform(0.02, 0.2))
    curve = QualityCurve(a=a, b=b, c=c)
    level = int(rng.integers(0, len(cfg.elastic_levels)))
    deadline: Optional[int] = None
    if cfg.deadline_frac > 0 and rng.random() < cfg.deadline_frac:
        lo, hi = cfg.deadline_slack
        deadline = max(1, int(math.ceil(
            job.min_completion_slots() * float(rng.uniform(lo, hi)))))
    loss_slo: Optional[float] = None
    if cfg.slo_frac > 0 and rng.random() < cfg.slo_frac:
        # achievable iff the job trains most of its epochs: the SLO is the
        # true curve's loss at a drawn fraction of the full epoch budget
        frac = float(rng.uniform(0.5, 1.0))
        loss_slo = curve.loss(frac * job.epochs)
    profile = ElasticProfile(
        levels=tuple(cfg.elastic_levels),
        level=level,
        curve=curve,
        marginal_floor=float(cfg.marginal_floor),
        damper_loss=float(cfg.damper_loss),
        deadline=deadline,
        loss_slo=loss_slo,
    )
    # the drawn spec IS the start level's shape: later level changes scale
    # relative to it (JobSpec.at_level is ratio-based)
    return replace(job, elastic=profile)


def job_stream(cfg: TraceConfig) -> Iterator[Tuple[JobSpec, Optional[int]]]:
    """Yield (job, fail_at) pairs in arrival order."""
    wcfg = cfg.workload_config()
    clock = 0.0
    seed = int(cfg.seed)
    seed = seed if seed >= 0 else (1 << 63) - seed  # injective for negatives
    for i in range(cfg.num_jobs):
        rng = np.random.default_rng(
            np.random.SeedSequence((seed, _TAG_TRACE, i))
        )
        gap = rng.exponential(1.0 / cfg.arrival_rate) \
            / max(_burst_factor(cfg.preset, clock), 1e-6)
        clock += gap
        arrival = int(clock)
        job = draw_job(rng, wcfg, i, arrival)
        if cfg.preset == "philly":
            job = _philly_tail(job, rng, cfg)
        fail_at: Optional[int] = None
        if cfg.failure_rate > 0 and rng.random() < cfg.failure_rate:
            lo, hi = cfg.failure_delay
            fail_at = arrival + int(rng.integers(lo, hi + 1))
        if cfg.elastic_frac > 0:
            ern = np.random.default_rng(
                np.random.SeedSequence((seed, _TAG_ELASTIC, i))
            )
            if ern.random() < cfg.elastic_frac:
                job = _annotate_elastic(job, ern, cfg)
        yield job, fail_at


def stream(cfg: TraceConfig) -> Iterator[Event]:
    """The trace as a time-ordered stream of ARRIVAL events (failure slots
    attached as ``fail_at``; the engine turns them into FAILURE events)."""
    for job, fail_at in job_stream(cfg):
        yield Event(time=job.arrival, kind=EventKind.ARRIVAL, job=job,
                    fail_at=fail_at)


def sample_jobs(cfg: TraceConfig, n: int) -> List[JobSpec]:
    """Materialize the first ``n`` jobs (price calibration, tests)."""
    out = []
    for job, _ in job_stream(cfg):
        out.append(job)
        if len(out) >= n:
            break
    return out


def calibrate_prices(
    cfg: TraceConfig, cluster: Cluster, n: int = 64
) -> PriceParams:
    """U^r / L / mu from a calibration prefix of the trace, priced over the
    window's lookahead (the paper notes the constants are estimated from
    historical data; the prefix plays that role here). Arrivals are shifted
    to 0 because the window always offers jobs at relative slot 0."""
    sample = [replace(j, arrival=0) for j in sample_jobs(cfg, n)]
    return estimate_price_params(sample, cluster, cluster.horizon)
