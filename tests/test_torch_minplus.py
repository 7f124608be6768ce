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
    GROUP_CANDIDATES,
    GROUP_MAX_Q1,
    MAX_Q1,
    RING,
    SMEM_BUDGET,
    minplus_step_torch,
    minplus_sweep_cuda,
    minplus_sweep_host,
    minplus_sweep_torch,
    sweep_layout,
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
    C, ch = minplus_sweep_host(tcost, "cpu")
    Cs, chs = _scalar_sweep(tcost)
    np.testing.assert_array_equal(C, Cs)
    np.testing.assert_array_equal(ch, chs)
    assert ch.dtype == np.int64


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
        minplus_sweep_torch(torch.zeros((2, 3), dtype=torch.float32))
    with pytest.raises(ValueError):
        minplus_sweep_torch(torch.zeros(3, dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA"):
        minplus_sweep_cuda(torch.zeros((2, 3), dtype=torch.float64))


def _near_tie_row(rng, n, mag):
    """A row on a 0.1 * mag grid with absolute offsets of 0.5e-12 to
    3e-12 and a few +inf entries: sums prev[u-v] + tcost[v] of different
    decompositions tie exactly, to an ulp, or within a few 1e-12 on both
    sides of the hysteresis."""
    row = np.round(rng.uniform(0.0, 5.0, n), 1) * mag
    row += rng.choice([0.0, 5e-13, -5e-13, 1e-12, -1e-12, 1.5e-12, 2e-12,
                       -2e-12, 3e-12], size=n)
    row[rng.random(n) < 0.1] = np.inf
    return row


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 10_000), st.integers(2, 48),
       st.sampled_from([1.0, 1e3, 1e6]))
def test_property_replay_predicate_matches_scalar_on_near_ties(seed, n, mag):
    """The plain step's replay predicate (a candidate in (m, m + 2e-12])
    hands exactly the rows where the first hit within m + 1e-12 is not
    the scalar scan's answer to that scan: values and choice equal the
    scalar reference on adversarial near-ties at magnitudes 1 to 1e6."""
    rng = np.random.default_rng(seed)
    prev = _near_tie_row(rng, n, mag)
    prev[0] = 0.0 if rng.random() < 0.5 else prev[0]
    tcost = _near_tie_row(rng, n, mag)
    tcost[0] = 0.0
    cur, ch = minplus_step_torch(torch.from_numpy(prev),
                                 torch.from_numpy(tcost))
    cs, chs = minplus_scalar(prev, tcost)
    np.testing.assert_array_equal(cur.numpy(), cs)
    np.testing.assert_array_equal(ch.numpy(), chs)


@pytest.mark.parametrize("mag", [1.0, 1e3, 1e6])
def test_near_tie_sweeps_match_scalar(mag):
    rng = np.random.default_rng(int(mag))
    tcost = np.stack([_near_tie_row(rng, 21, mag) for _ in range(20)])
    tcost[:, 0] = 0.0
    _assert_sweep_matches_scalar(tcost)


@pytest.mark.parametrize("k,Q1", [(20, 21), (1, 1), (3, 2), (12, 33),
                                  (0, 5)])
def test_host_sweep_on_cpu_matches_scalar(k, Q1):
    """The DP's host-level call on ``device="cpu"``: numpy tables equal
    to k chained scalar steps."""
    tcost = _tcost_rows(np.random.default_rng(k + Q1), k, Q1) if k \
        else np.empty((0, Q1))
    C, ch = minplus_sweep_host(tcost, "cpu")
    assert isinstance(C, np.ndarray) and isinstance(ch, np.ndarray)
    assert C.shape == ch.shape == (k + 1, Q1) and ch.dtype == np.int64
    Cs, chs = _scalar_sweep(tcost)
    np.testing.assert_array_equal(C, Cs)
    np.testing.assert_array_equal(ch, chs)


def test_host_sweep_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        minplus_sweep_host(np.zeros((2, 3), dtype=np.float32), "cpu")
    with pytest.raises(ValueError, match="cpu or cuda"):
        minplus_sweep_host(np.zeros((2, 3)), "meta")


@pytest.mark.parametrize("k,Q1,lanes,warps,ring", [
    (20, 21, 8, 6, False),     # the main path: 4 rows a warp, tables fit
    (0, 1, 1, 1, False), (1, 2, 1, 1, False), (5, 4, 1, 1, False),
    (5, 5, 2, 1, False), (3, 32, 8, 8, False),
    (20, 33, 16, 17, False),   # quanta=32: 2 rows a warp
    (20, 49, 16, 25, False), (20, 65, 32, 32, False),
    (20, 128, 32, 32, True),   # the widest group row
    (20, 129, 0, 5, True),     # the scan, a lane a row
    (116, 21, 8, 6, False),    # the deepest sweep whose tables fit 48 KB
    (117, 21, 8, 6, True), (200, 33, 16, 17, True),
    (1, 1024, 0, 32, False), (2, 1024, 0, 32, True),
    (200, 1024, 0, 32, True), (10**6, 3, 1, 1, True),
])
def test_sweep_layout(k, Q1, lanes, warps, ring):
    lay = sweep_layout(k, Q1)
    assert (lay.lanes, lay.warps, lay.ring) == (lanes, warps, ring)
    rows, tc_rows = (2, RING) if ring else (k + 1, k)
    cells = rows * Q1           # C in float64, choices in int32
    assert lay.smem == (cells + (cells + 1) // 2 + tc_rows * Q1) * 8
    assert lay.smem <= SMEM_BUDGET
    if lanes:                  # every candidate of every row has a lane
        assert lanes * GROUP_CANDIDATES >= Q1 and warps <= 32
        assert lanes == 1 or (lanes // 2) * GROUP_CANDIDATES < Q1
    else:
        assert Q1 > GROUP_MAX_Q1 and warps * 32 >= Q1


@pytest.mark.parametrize("k,Q1", [(3, 0), (3, MAX_Q1 + 1), (-1, 5)])
def test_sweep_layout_refuses_what_the_kernel_does_not_take(k, Q1):
    with pytest.raises(ValueError):
        sweep_layout(k, Q1)
