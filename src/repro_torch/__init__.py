"""repro_torch: the PD-ORS online scheduler ported to PyTorch and CUDA.

The port of the JAX package ``repro`` (which stays the reference). The
(T, H, R) ledger, the Eq. 12 repricing and the two kernels of the offer
path — the snapshot price bundle and the min-plus DP sweep, each a
hand-written CUDA kernel for Hopper — run on a torch device; the LP,
rounding and decision logic stay on the host in float64.

Entry points run on the CUDA card by default and raise when there is
none; pass ``device="cpu"`` to ``make_cluster`` to run on the CPU, where
every kernel is replaced by its plain torch version.

Subpackages:
    core      the scheduler (Algorithms 1-4), job model, workloads
    backend   the ``ArrayBackend`` contract and ``TorchBackend``
    kernels   CUDA sources, their build, wrappers and plain versions
    obs       spans, metrics and the primal-dual gap tracker
    convert   carry jobs, ledgers and price parameters across packages
"""
from .core import (
    PDORS,
    WorkloadConfig,
    make_cluster,
    run_pdors,
    synthetic_jobs,
)

__all__ = ["make_cluster", "run_pdors", "PDORS", "WorkloadConfig",
           "synthetic_jobs"]
