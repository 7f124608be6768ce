"""repro_torch: the PD-ORS online scheduler and its model-serving
substrate, ported to PyTorch and CUDA.

The port of the JAX package ``repro`` (which stays the reference). The
(T, H, R) ledger, the Eq. 12 repricing and the two kernels of the offer
path — the snapshot price bundle and the min-plus DP sweep, each a
hand-written CUDA kernel for Hopper — run on a torch device; the LP,
rounding and decision logic stay on the host in float64. The serving
path (``serve.ServeEngine`` over the dense decoder in ``models``) runs
its RMSNorm and prefill attention through two more hand-written kernels.

Entry points run on the CUDA card by default and raise when there is
none; pass ``device="cpu"`` (to ``make_cluster``, ``Model.init``) to run
on the CPU, where every kernel is replaced by its plain torch version.

Subpackages:
    core      the scheduler (Algorithms 1-4), job model, workloads
    backend   the ``ArrayBackend`` contract and ``TorchBackend``
    kernels   CUDA sources, their build, wrappers and plain versions
    obs       spans, metrics and the primal-dual gap tracker
    configs   the architecture registry (``get_config``)
    models    the dense decoder's serving path (``build_model``)
    serve     the batched serving engine
    launch    ``python -m repro_torch.launch.serve``
    convert   carry jobs, ledgers, price parameters and model weights
              across packages
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
