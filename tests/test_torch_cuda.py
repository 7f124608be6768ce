"""The port's CUDA kernels on the card: each against its plain torch
version bit for bit, and the offer path on a CUDA ledger launching both
and deciding as the CPU run does. Skipped where there is no card; on one,
run ``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch.kernels import minplus, pricing

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _equal(a, b):
    np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


@pytest.mark.parametrize("W,H,R", [(20, 100, 4), (1, 100, 4), (37, 1000, 7)])
def test_price_bundle_kernel_matches_plain(cuda, W, H, R):
    gen = torch.Generator().manual_seed(W * H + R)
    price = (torch.rand((W, H, R), generator=gen, dtype=torch.float64) * 8
             + 0.1).to(cuda)
    free = (torch.rand((W, H, R), generator=gen, dtype=torch.float64) * 33
            - 3).to(cuda)
    wdem = np.linspace(0.0, 3.0, R)
    sdem = np.linspace(2.0, 0.0, R)
    dem = pricing.demand_operand(wdem, sdem, 4.0, cuda)
    _equal(pricing.price_bundle_batch_cuda(price, free, dem),
           pricing.price_bundle_batch_torch(price, free, dem))


@pytest.mark.parametrize("k,Q1", [(20, 21), (20, 33), (3, 2)])
def test_minplus_sweep_kernel_matches_plain(cuda, k, Q1):
    gen = torch.Generator().manual_seed(k * Q1)
    tcost = torch.rand((k, Q1), generator=gen, dtype=torch.float64) * 100
    tcost[torch.rand((k, Q1), generator=gen) < 0.2] = float("inf")
    tcost[:, 0] = 0.0
    tcost = tcost.to(cuda)
    got = minplus.minplus_sweep_cuda(tcost)
    want = minplus.minplus_sweep_torch(tcost)
    _equal(got[0], want[0])
    _equal(got[1], want[1])


def test_offer_path_launches_both_kernels_and_matches_cpu(cuda):
    cfg = rt.WorkloadConfig(num_jobs=8, horizon=10, seed=3, batch=(30, 150),
                            workload_scale=0.1)
    pricing.LAUNCHES = 0
    minplus.LAUNCHES = 0
    gpu = rt.run_pdors(rt.synthetic_jobs(cfg), rt.make_cluster(6, 10),
                       quanta=8, seed=0)
    assert pricing.LAUNCHES > 0 and minplus.LAUNCHES > 0
    cpu = rt.run_pdors(rt.synthetic_jobs(cfg),
                       rt.make_cluster(6, 10, device="cpu"), quanta=8, seed=0)
    assert [r.admitted for r in gpu.records] == \
        [r.admitted for r in cpu.records]
    assert gpu.total_utility == pytest.approx(cpu.total_utility, rel=1e-9)
