"""The port's min-plus DP sweep (``repro_torch.kernels.minplus``) against
the JAX package's references on the CPU.

``minplus_sweep_torch`` — what the CUDA kernel is held to on the card —
must be bit-identical in values and ``choice`` to k chained calls of the
scalar reference ``minplus_scalar``. Against the Pallas kernel in
interpret mode only values are compared, at rtol=1e-6 (float32 sums of
two rounded operands); its ``choice`` has no 1e-12 hysteresis."""
from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import minplus as ref_minplus
from repro.kernels.minplus import minplus_pallas, minplus_scalar
from repro_torch.kernels.minplus import (
    minplus_step_torch,
    minplus_sweep,
    minplus_sweep_cuda,
    minplus_sweep_torch,
)


def _random_instance(rng, n, inf_frac=0.2):
    prev = rng.uniform(0.0, 100.0, n)
    tcost = rng.uniform(0.0, 100.0, n)
    prev[rng.random(n) < inf_frac] = np.inf
    tcost[rng.random(n) < inf_frac] = np.inf
    prev[0] = 0.0 if rng.random() < 0.5 else prev[0]
    tcost[0] = 0.0  # v=0 always costs nothing in the DP
    return prev, tcost


def _scalar_sweep(tcost):
    k, Q1 = tcost.shape
    C = np.full((k + 1, Q1), np.inf)
    C[0, 0] = 0.0
    choice = np.full((k + 1, Q1), -1, dtype=np.int64)
    for s in range(k):
        C[s + 1], choice[s + 1] = minplus_scalar(C[s], tcost[s])
    return C, choice


def _tcost_rows(rng, k, Q1, inf_frac=0.2):
    return np.stack([_random_instance(rng, Q1, inf_frac)[1]
                     for _ in range(k)])


def _assert_sweep_matches_scalar(tcost):
    C, ch = minplus_sweep(torch.from_numpy(tcost))
    Cs, chs = _scalar_sweep(tcost)
    np.testing.assert_array_equal(C.numpy(), Cs)
    np.testing.assert_array_equal(ch.numpy(), chs)
    assert ch.dtype == torch.int64


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 10_000), st.integers(2, 48))
def test_property_step_matches_scalar(seed, n):
    rng = np.random.default_rng(seed)
    prev, tcost = _random_instance(rng, n)
    cur, ch = minplus_step_torch(torch.from_numpy(prev),
                                 torch.from_numpy(tcost))
    cs, chs = minplus_scalar(prev, tcost)
    np.testing.assert_array_equal(cur.numpy(), cs)
    np.testing.assert_array_equal(ch.numpy(), chs)


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 10_000), st.integers(1, 12), st.integers(2, 48))
def test_property_sweep_matches_scalar(seed, k, n):
    _assert_sweep_matches_scalar(_tcost_rows(np.random.default_rng(seed),
                                             k, n))


@pytest.mark.parametrize("Q1", [2, 21, 33, 49])
def test_sweep_shapes_match_scalar(Q1):
    rng = np.random.default_rng(Q1)
    _assert_sweep_matches_scalar(_tcost_rows(rng, 20, Q1))
    _assert_sweep_matches_scalar(_tcost_rows(rng, 7, Q1, inf_frac=0.0))


def test_near_ties_keep_scalar_hysteresis():
    """A later candidate less than 1e-12 better does not replace the first
    (tests/test_minplus.py's near-tie instance, as a two-step sweep)."""
    tcost = np.array([[0.0, 0.3, 0.6000000000000001],
                      [0.0, 0.30000000000000004, 0.6]])
    _assert_sweep_matches_scalar(tcost)
    C, _ = minplus_sweep_torch(torch.from_numpy(tcost))
    assert C[2, 2].item() == 0.6000000000000001
    # ties and near-ties at every level
    rng = np.random.default_rng(4)
    base = np.round(rng.uniform(0.0, 5.0, (6, 21)), 1)
    base[:, 0] = 0.0
    jitter = rng.choice([0.0, 4e-13, -4e-13, 1.5e-12], size=base.shape)
    _assert_sweep_matches_scalar(base + jitter)


def test_all_unreachable_rows():
    tcost = np.full((3, 5), np.inf)
    C, ch = minplus_sweep_torch(torch.from_numpy(tcost))
    assert C[0, 0] == 0 and torch.isinf(C[1:]).all()
    assert (ch == -1).all()
    _assert_sweep_matches_scalar(tcost)
    step_prev = np.full(5, np.inf)
    cur, ch1 = minplus_step_torch(torch.from_numpy(step_prev),
                                  torch.zeros(5, dtype=torch.float64))
    assert torch.isinf(cur).all() and (ch1 == -1).all()


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10_000))
def test_property_against_pallas_interpret(seed):
    tcost = _tcost_rows(np.random.default_rng(seed), 5, 33)
    C, _ = minplus_sweep_torch(torch.from_numpy(tcost))
    C = C.numpy()
    for s in range(tcost.shape[0]):
        cp, _ = minplus_pallas(C[s], tcost[s], interpret=True)
        assert ref_minplus._pallas_broken is None  # the kernel really ran
        finite = np.isfinite(C[s + 1])
        assert (np.isfinite(cp) == finite).all()
        np.testing.assert_allclose(cp[finite], C[s + 1][finite], rtol=1e-6)


def test_sweep_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        minplus_sweep(torch.zeros((2, 3), dtype=torch.float32))
    with pytest.raises(ValueError):
        minplus_sweep(torch.zeros(3, dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA"):
        minplus_sweep_cuda(torch.zeros((2, 3), dtype=torch.float64))
