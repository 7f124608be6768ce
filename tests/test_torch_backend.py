"""The port's ``TorchBackend`` on ``device="cpu"`` against the JAX
package's ``NumpyBackend``: ledger ops and the free tensor exact, the
price tensor at rtol=1e-12 (``torch.pow`` differs from numpy's ``**`` by
up to 1 ulp), and the default device raising where there is no card."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import WorkloadConfig, synthetic_jobs
from repro.core import make_cluster as ref_make_cluster
from repro.core.job import Allocation as RefAllocation
from repro.core.pricing import PriceTable as RefPriceTable
from repro.core.pricing import estimate_price_params
import repro_torch
from repro_torch.backend import get_backend
from repro_torch.backend.torch_backend import TorchBackend
from repro_torch.convert import jobs_from_records, price_params_from_dict
from repro_torch.core.job import Allocation
from repro_torch.core.pricing import PriceTable


def _jobs():
    ref = synthetic_jobs(WorkloadConfig(num_jobs=8, horizon=10, seed=3,
                                        batch=(30, 150), workload_scale=0.1))
    return ref, jobs_from_records([dataclasses.asdict(j) for j in ref])


def _pair(H, T):
    return ref_make_cluster(H, T), repro_torch.make_cluster(H, T,
                                                             device="cpu")


def _apply(cl, jobs, alloc_cls, ops):
    for op, t, j, w, s in ops:
        a = alloc_cls(workers=dict(w), ps=dict(s))
        getattr(cl, op)(t, jobs[j], a)


OPS = [
    ("commit", 0, 0, {0: 2, 2: 1}, {1: 1}),
    ("commit", 2, 1, {3: 4}, {3: 1}),
    ("commit", 5, 2, {0: 2, 2: 1}, {1: 1}),
    ("commit", 2, 3, {1: 1, 3: 2}, {0: 2}),
    ("release", 2, 1, {3: 4}, {3: 1}),
]


@pytest.mark.parametrize("steps", [0, 2, 5, 6, 10])
def test_ledger_ops_match_numpy(steps):
    ref_jobs, jobs = _jobs()
    cln, clt = _pair(4, 6)
    _apply(cln, ref_jobs, RefAllocation, OPS)
    _apply(clt, jobs, Allocation, OPS)
    cln.advance(steps)
    clt.advance(steps)
    un = cln.backend.to_host(cln._used)
    ut = clt.backend.to_host(clt._used)
    np.testing.assert_array_equal(ut, un)
    assert clt._used.dtype == torch.float64
    assert clt._slot_versions.tolist() == cln._slot_versions.tolist()
    if steps >= 6:
        assert ut.sum() == 0.0


def test_release_clamps_at_zero():
    _, jobs = _jobs()
    cl = repro_torch.make_cluster(2, 3, device="cpu")
    alloc = Allocation(workers={0: 1}, ps={0: 1})
    cl.commit(1, jobs[0], alloc)
    cl.release(1, jobs[0], alloc)
    cl.release(1, jobs[0], alloc)          # double release: clamped
    u = cl.backend.to_host(cl._used)
    assert (u >= 0).all() and u.sum() == 0.0
    assert not cl.oversubscribed()


def test_host_mirror_does_not_alias_the_ledger():
    _, jobs = _jobs()
    cl = repro_torch.make_cluster(2, 3, device="cpu")
    before = cl.used_matrix(1).copy()
    mirror = cl.used_matrix(1)
    cl.commit(1, jobs[0], Allocation(workers={0: 1}, ps={1: 1}))
    np.testing.assert_array_equal(mirror, before)   # in-place update safe
    assert cl.used_matrix(1).sum() > before.sum()


def test_free_tensor_and_matrix_match_numpy():
    ref_jobs, jobs = _jobs()
    cln, clt = _pair(3, 5)
    _apply(cln, ref_jobs, RefAllocation, OPS[:1] + [("commit", 2, 0,
                                                     {1: 2}, {2: 1})])
    _apply(clt, jobs, Allocation, OPS[:1] + [("commit", 2, 0,
                                             {1: 2}, {2: 1})])
    free = clt.backend.to_host(clt.device_free_tensor())
    for t in range(5):
        np.testing.assert_array_equal(clt.free_matrix(t), cln.free_matrix(t))
        np.testing.assert_array_equal(free[t], cln.free_matrix(t))


def test_price_tensor_matches_numpy():
    ref_jobs, jobs = _jobs()
    cln, clt = _pair(4, 6)
    ops = [("commit", 1, 0, {0: 3, 1: 1}, {2: 2}),
           ("commit", 4, 1, {0: 3, 1: 1}, {2: 2}),
           ("commit", 4, 2, {0: 9, 3: 9}, {0: 4, 3: 4})]
    _apply(cln, ref_jobs, RefAllocation, ops)
    _apply(clt, jobs, Allocation, ops)
    params = estimate_price_params(ref_jobs, cln, cln.horizon)
    ptn = RefPriceTable(params, cln)
    ptt = PriceTable(price_params_from_dict(dataclasses.asdict(params)), clt)
    ptn.prewarm()
    ptt.prewarm()
    for t in range(cln.horizon):
        np.testing.assert_allclose(ptt.price_matrix(t), ptn.price_matrix(t),
                                   rtol=1e-12)
    dev = clt.backend.to_host(ptt.device_tensor())
    np.testing.assert_array_equal(dev[4], ptt.price_matrix(4))
    assert ptt.device_tensor() is ptt.device_tensor()   # version-cached


def test_zero_capacity_prices_at_ceiling():
    be = TorchBackend("cpu")
    used = be.zeros((2, 2, 3))
    cap = np.array([[1.0, 0.0, 2.0], [0.0, 0.0, 1.0]])
    u = np.array([5.0, 7.0, 9.0])
    p = be.price_tensor(used, cap, u, 0.5).numpy()
    assert (p[:, cap == 0] == np.broadcast_to(u, (2, 2, 3))[:, cap == 0]).all()
    np.testing.assert_allclose(p[:, cap > 0], 0.5)


def test_default_device_is_the_card_or_raises():
    """No silent CPU fallback: without a card the defaults raise."""
    if torch.cuda.is_available():
        assert TorchBackend().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchBackend()
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.make_cluster(2, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_backend(None)


def test_backend_resolution_and_hints():
    be = TorchBackend("cpu")
    assert get_backend(be) is be
    assert get_backend(None, "cpu").device == torch.device("cpu")
    with pytest.raises(TypeError, match="ArrayBackend"):
        get_backend("numpy")
    assert be.is_device
    assert be.lp_solver_default() == "cover_packing"
