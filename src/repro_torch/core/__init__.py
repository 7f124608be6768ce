"""PD-ORS on torch: the paper's online primal-dual scheduler (Algorithms
1-4) with the ledger, repricing and both kernels on a torch device.

Public API:
    JobSpec, SigmoidUtility, Allocation      — job model (paper §3)
    QualityCurve, ElasticProfile             — elastic/quality annotations
    Cluster, Machine, make_cluster           — cluster model (device ledger)
    PriceParams, PriceTable, estimate_price_params — Q_h^r pricing (Eq. 12)
    solve_theta                              — Algorithm 4
    WorkloadDP                               — Algorithm 3
    find_best_schedule, Schedule             — Algorithm 2
    PDORS, run_pdors, PDORSResult            — Algorithm 1
    SolvePlan, solve_plans, linprog_batch    — plan-then-solve pipeline
    synthetic_jobs, trace_jobs, arch_jobs    — §5 workload generators
"""
from .job import (
    Allocation,
    ElasticProfile,
    JobSpec,
    QualityCurve,
    SigmoidUtility,
)
from .cluster import Cluster, Machine, make_cluster
from .pricing import PriceParams, PriceTable, estimate_price_params
from .subproblem import SubproblemConfig, ThetaResult, solve_theta
from .dp import WorkloadDP
from .schedule import Schedule, find_best_schedule
from .pdors import PDORS, PDORSResult, run_pdors
from .workload import WorkloadConfig, synthetic_jobs, trace_jobs, arch_jobs
from .lp import linprog, linprog_batch, LPResult
from .solve_plan import SolvePlan, solve_plans

__all__ = [
    "JobSpec", "SigmoidUtility", "Allocation",
    "QualityCurve", "ElasticProfile",
    "Cluster", "Machine", "make_cluster",
    "PriceParams", "PriceTable", "estimate_price_params",
    "SubproblemConfig", "ThetaResult", "solve_theta",
    "WorkloadDP", "Schedule", "find_best_schedule",
    "PDORS", "PDORSResult", "run_pdors",
    "WorkloadConfig", "synthetic_jobs", "trace_jobs", "arch_jobs",
    "linprog", "linprog_batch", "LPResult",
    "SolvePlan", "solve_plans",
]
