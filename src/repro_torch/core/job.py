"""Job model for PD-ORS (paper §3.2).

A training job is described exactly by the paper's tuple:
  (a_i, E_i, K_i, F_i, tau_i, g_i, gamma_i, b_int, b_ext, alpha, beta, u_i).

Units are abstract but consistent: time in "slots", bandwidth in
"parameter-units per slot", g_i in "parameter-units".
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Sequence, Tuple

Resource = str  # e.g. "gpu", "cpu", "mem", "storage" | "chips", "hbm", ...


@dataclass(frozen=True)
class QualityCurve:
    """SLAQ-style predicted-loss curve: l(e) = c + 1 / (a * e + b).

    ``e`` counts epochs trained (fractional epochs allowed). ``c`` is the
    asymptotic floor, ``a`` the convergence rate, ``b`` the intercept
    (l(0) = c + 1/b). The simulator uses one instance as a job's ground
    truth and refits a second one online from observed (epoch, loss)
    points — the fit is closed-form least squares on the linearised
    1/(l - c_hat) = a*e + b, so it is deterministic and rng-free."""

    a: float
    b: float
    c: float = 0.0

    def loss(self, epochs: float) -> float:
        return self.c + 1.0 / max(1e-9, self.a * max(0.0, epochs) + self.b)

    def marginal(self, epochs: float) -> float:
        """Predicted loss improvement from one more epoch at ``epochs``."""
        return self.loss(epochs) - self.loss(epochs + 1.0)

    @classmethod
    def fit(cls, points: Sequence[Tuple[float, float]]) -> Optional["QualityCurve"]:
        """Least-squares refit from >= 3 observed (epochs, loss) points.

        The floor c is profiled out over a fixed candidate grid (fractions
        of the observed loss span below the smallest observation — the
        transform 1/(l - c_hat) must stay finite); each candidate gets a
        closed-form linear fit of 1/(l - c_hat) = a*e + b, and the
        candidate with the smallest squared error in the ORIGINAL loss
        space wins. Fully deterministic. Degenerate point sets (no epoch
        spread, no loss spread, non-improving losses) return None and the
        caller keeps its previous fit."""
        if len(points) < 3:
            return None
        es = [float(e) for e, _ in points]
        ls = [float(l) for _, l in points]
        if max(es) - min(es) <= 1e-9:
            return None
        l_min = min(ls)
        span = max(ls) - l_min
        if span <= 1e-12:
            return None
        n = float(len(es))
        se, sy_e = sum(es), sum(e * e for e in es)
        denom = n * sy_e - se * se
        if abs(denom) <= 1e-12:
            return None
        best: Optional[Tuple[float, float, float, float]] = None
        for frac in (0.02, 0.05, 0.1, 0.2, 0.4, 0.8, 1.6, 3.2):
            c_hat = l_min - max(1e-4, frac * span)
            ys = [1.0 / max(1e-9, l - c_hat) for l in ls]
            sy = sum(ys)
            sey = sum(e * y for e, y in zip(es, ys))
            a = (n * sey - se * sy) / denom
            b = (sy - a * se) / n
            if a <= 1e-9 or b <= 1e-9:
                continue  # non-improving fit — useless for marginal decisions
            sse = sum(
                (c_hat + 1.0 / (a * e + b) - l) ** 2
                for e, l in zip(es, ls)
            )
            if best is None or sse < best[0]:
                best = (sse, a, b, c_hat)
        if best is None:
            return None
        return cls(a=best[1], b=best[2], c=best[3])


@dataclass(frozen=True)
class ElasticProfile:
    """Elastic / quality-driven annotations for a :class:`JobSpec`.

    ``levels`` are demand multipliers (applied to per-worker demands and
    the global batch size via :meth:`JobSpec.at_level`); ``level`` indexes
    the current one. ``curve`` is the job's ground-truth loss curve.
    ``marginal_floor`` > 0 arms the SLAQ shrink trigger (reshape down when
    the fitted marginal loss improvement per epoch drops below it);
    ``damper_loss`` > 0 arms the adadamp grow trigger (reshape up — larger
    batch — once observed loss falls to the damper threshold). ``deadline``
    is a completion SLO in slots after arrival; ``loss_slo`` a final-loss
    SLO. All triggers default off, so attaching a profile without arming
    them is metadata-only and cannot change scheduling decisions."""

    levels: Tuple[float, ...] = (1.0,)
    level: int = 0
    curve: Optional[QualityCurve] = None
    marginal_floor: float = 0.0
    damper_loss: float = 0.0
    deadline: Optional[int] = None
    loss_slo: Optional[float] = None


@dataclass(frozen=True)
class SigmoidUtility:
    """Paper §5: u_i(t) = theta1 / (1 + exp(theta2 * (t - theta3))).

    theta1: priority scale; theta2: time criticality (0 => flat);
    theta3: target completion time.
    """

    theta1: float
    theta2: float
    theta3: float

    def __call__(self, latency: float) -> float:
        z = self.theta2 * (latency - self.theta3)
        # numerically safe sigmoid
        if z >= 0:
            return self.theta1 * math.exp(-z) / (1.0 + math.exp(-z)) if z < 50 else 0.0
        return self.theta1 / (1.0 + math.exp(z))


@dataclass(frozen=True)
class JobSpec:
    """One ML training job (paper Table 1)."""

    job_id: int
    arrival: int                      # a_i (slot index)
    epochs: int                       # E_i
    num_samples: int                  # K_i
    batch_size: int                   # F_i (fixed global batch size)
    tau: float                        # time to train one sample (slots)
    grad_size: float                  # g_i (params+grads pushed/pulled)
    gamma: float                      # worker:PS ratio  sum w / sum s
    bw_internal: float                # b_i^(i)
    bw_external: float                # b_i^(e)
    worker_demand: Dict[Resource, float]   # alpha_i^r
    ps_demand: Dict[Resource, float]       # beta_i^r
    utility: SigmoidUtility
    arch: str = "generic"             # architecture tag (configs registry id)
    elastic: Optional[ElasticProfile] = None  # quality/elastic annotations

    # ---- paper Eq. (1)-(3) helpers -------------------------------------
    def total_workload(self) -> float:
        """V_i = E_i * K_i: total samples that must be trained."""
        return float(self.epochs) * float(self.num_samples)

    def comm_time_per_sample(self, internal: bool) -> float:
        """(gamma_i / F_i) * 2 g_i / b  — communication slot-cost per sample."""
        b = self.bw_internal if internal else self.bw_external
        return (self.gamma / self.batch_size) * (2.0 * self.grad_size / b)

    def time_per_sample(self, internal: bool) -> float:
        """tau_i + comm (denominator of Eq. (1) given locality case)."""
        return self.tau + self.comm_time_per_sample(internal)

    def throughput_per_worker(self, internal: bool) -> float:
        """Samples/slot one worker contributes (Eq. (1) numerator=1)."""
        return 1.0 / self.time_per_sample(internal)

    def min_completion_slots(self) -> int:
        """ceil(E K / F * (tau + 2 g gamma/(b_int F))): all-internal, max
        workers (= F_i). Used in U^r (Eq. 13)."""
        return int(
            math.ceil(
                self.total_workload()
                / self.batch_size
                * self.time_per_sample(internal=True)
            )
        )

    def max_resource_slots(self) -> float:
        """ceil(E K (tau + 2 g gamma/(b_ext F))): single worker at external
        rate — the slowest-possible completion, used in L (Eq. 14)."""
        return math.ceil(self.total_workload() * self.time_per_sample(internal=False))

    def at_level(self, level: int) -> "JobSpec":
        """Reshaped copy of this spec at elastic demand level ``level``.

        The new level's multiplier is applied *relative to the current
        level* (ratio-based), scaling per-worker demands and the global
        batch size; PS demands and gamma are untouched so the paper's
        worker:PS coupling survives. Raises if the job is not elastic."""
        el = self.elastic
        if el is None:
            raise ValueError(f"job {self.job_id} has no elastic profile")
        if not (0 <= level < len(el.levels)):
            raise ValueError(f"level {level} out of range for {el.levels}")
        if level == el.level:
            return replace(self, elastic=replace(el, level=level))
        ratio = el.levels[level] / el.levels[el.level]
        wdem = {r: a * ratio for r, a in self.worker_demand.items()}
        return replace(
            self,
            worker_demand=wdem,
            batch_size=max(1, int(round(self.batch_size * ratio))),
            elastic=replace(el, level=level),
        )

    def demand(self, n_workers: float, n_ps: float) -> Dict[Resource, float]:
        out: Dict[Resource, float] = {}
        for r, a in self.worker_demand.items():
            out[r] = out.get(r, 0.0) + a * n_workers
        for r, b in self.ps_demand.items():
            out[r] = out.get(r, 0.0) + b * n_ps
        return out


@dataclass
class Allocation:
    """One job's placement in one time-slot: machine -> (workers, ps)."""

    workers: Dict[int, int] = field(default_factory=dict)  # h -> w_ih[t]
    ps: Dict[int, int] = field(default_factory=dict)       # h -> s_ih[t]

    def total_workers(self) -> int:
        return sum(self.workers.values())

    def total_ps(self) -> int:
        return sum(self.ps.values())

    def is_internal(self) -> bool:
        """Fact 1: internal rate iff |P| = |W| = 1 and P == W."""
        wm = [h for h, w in self.workers.items() if w > 0]
        pm = [h for h, s in self.ps.items() if s > 0]
        return len(wm) == 1 and len(pm) == 1 and wm[0] == pm[0]

    def empty(self) -> bool:
        return self.total_workers() == 0 and self.total_ps() == 0

    def samples_trained(self, job: JobSpec) -> float:
        """Eq. (1) summed over machines, with Fact 1 locality resolution."""
        w = self.total_workers()
        if w == 0:
            return 0.0
        return w * job.throughput_per_worker(internal=self.is_internal())
