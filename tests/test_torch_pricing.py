"""The port's snapshot bundle (``repro_torch.kernels.pricing``) against the
JAX package's references on the CPU.

The plain torch version — what the CUDA kernel is held to on the card —
and the backend's ``snapshot_bundle(_batch)`` on ``device="cpu"`` must be
bit-identical to ``price_bundle_batch_numpy`` / ``price_bundle_numpy``.
Against the Pallas kernel in interpret mode the price rows agree to
rtol=1e-6 (it sums R <= 8 float32 products, error about R * 2**-24) and
the head-room rows exactly (its wrapper keeps them in float64)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.kernels import pricing as ref_pricing
from repro.kernels.pricing import (
    price_bundle_batch_numpy,
    price_bundle_batch_pallas,
    price_bundle_numpy,
)
from repro_torch.backend.torch_backend import TorchBackend
from repro_torch.kernels import pricing
from repro_torch.kernels.pricing import (
    R_MAX,
    bundle_vec,
    pack_demand,
    price_bundle_batch,
    price_bundle_batch_cuda,
    price_bundle_batch_torch,
)


def _instance(seed, W, H, R, zero_cols=False):
    rng = np.random.default_rng(seed)
    price = rng.uniform(0.1, 8.0, (W, H, R))
    free = rng.uniform(-3.0, 30.0, (W, H, R))   # < 0: over-committed
    wdem = rng.uniform(0.0, 3.0, R)
    sdem = rng.uniform(0.0, 3.0, R)
    if zero_cols:
        wdem *= rng.random(R) > 0.4
        sdem *= rng.random(R) > 0.4
        wdem[0] = 0.0
        sdem[R - 1] = 0.0
    return price, free, wdem, sdem, float(rng.uniform(1.0, 10.0))


def _plain(price, free, wdem, sdem, gamma):
    rows = price_bundle_batch_torch(torch.from_numpy(price),
                                    torch.from_numpy(free), wdem, sdem, gamma)
    return tuple(rows.numpy())


def _assert_bundles_equal(got, want):
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("R", [4, 7])
@pytest.mark.parametrize("zero_cols", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_bit_identical_to_numpy(seed, R, zero_cols):
    price, free, wdem, sdem, gamma = _instance(seed, 6, 23, R, zero_cols)
    want = price_bundle_batch_numpy(price, free, wdem, sdem, gamma)
    _assert_bundles_equal(_plain(price, free, wdem, sdem, gamma), want)
    be = TorchBackend("cpu")
    got = be.snapshot_bundle_batch(torch.from_numpy(price),
                                   torch.from_numpy(free), wdem, sdem, gamma)
    _assert_bundles_equal(got, want)


@pytest.mark.parametrize("R", [4, 7])
def test_per_slot_bit_identical_to_numpy(R):
    price, free, wdem, sdem, gamma = _instance(5, 3, 17, R, zero_cols=True)
    be = TorchBackend("cpu")
    for t in range(3):
        want = price_bundle_numpy(price[t], free[t], wdem, sdem, gamma)
        got = be.snapshot_bundle(torch.from_numpy(price[t]),
                                 torch.from_numpy(free[t]), wdem, sdem, gamma)
        _assert_bundles_equal(got, want)


def test_all_zero_demand_headroom_is_inf():
    price, free, _, _, gamma = _instance(3, 2, 5, 4)
    z = np.zeros(4)
    got = _plain(price, free, z, z, gamma)
    _assert_bundles_equal(got, price_bundle_batch_numpy(price, free, z, z,
                                                        gamma))
    assert np.isinf(got[3]).all() and np.isinf(got[4]).all()
    assert (got[0] == 0).all() and (got[1] == 0).all()


def test_exact_capacity_edge():
    """free=9 and demand=3 give head-room 3 (a float32 ratio would risk a
    whole unit either way); free just under 9 gives 2."""
    price = np.ones((1, 2, 1))
    free = np.array([[[9.0], [8.9999999]]])
    dem = np.array([3.0])
    got = _plain(price, free, dem, dem, 1.0)
    _assert_bundles_equal(got, price_bundle_batch_numpy(price, free, dem,
                                                        dem, 1.0))
    assert got[3].tolist() == [[3.0, 2.0]]
    assert got[4].tolist() == [[3.0, 2.0]]


@pytest.mark.parametrize("R", [4, 7])
def test_against_pallas_interpret(R):
    price, free, wdem, sdem, gamma = _instance(11, 4, 37, R, zero_cols=True)
    got = _plain(price, free, wdem, sdem, gamma)
    pal = price_bundle_batch_pallas(price, free, wdem, sdem, gamma,
                                    interpret=True)
    assert ref_pricing._pallas_broken is None    # the kernel really ran
    for g, p in zip(got[:3], pal[:3]):
        np.testing.assert_allclose(g, p, rtol=1e-6)
    for g, p in zip(got[3:], pal[3:]):
        np.testing.assert_array_equal(g, p)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    price, free, wdem, sdem, gamma = _instance(0, 2, 3, 4)
    p32 = torch.from_numpy(price).float()
    with pytest.raises(TypeError):
        price_bundle_batch(p32, torch.from_numpy(free), wdem, sdem, gamma)
    with pytest.raises(ValueError):
        price_bundle_batch(torch.from_numpy(price),
                           torch.from_numpy(free[:, :, :3]), wdem, sdem,
                           gamma)
    # a CPU tensor never reaches the kernel, and the kernel path does not
    # fall back to the plain version
    with pytest.raises(ValueError, match="CUDA"):
        price_bundle_batch_cuda(torch.from_numpy(price),
                                torch.from_numpy(free), wdem, sdem, gamma)


@pytest.mark.parametrize("R", [1, 4, 7, 8])
def test_batch_edges_bit_identical_to_numpy(R):
    """NaN, -inf, negative and exactly divisible free values beside
    zero-demand columns, at the kernel's narrowest and widest R and odd
    R: the plain version and the backend agree with numpy bit for bit."""
    price, free, wdem, sdem, gamma = _instance(20 + R, 5, 31, R,
                                               zero_cols=R > 1)
    free.reshape(-1)[::7] = np.nan
    free.reshape(-1)[3::11] = -np.inf
    free[..., R - 1] = 3.0 * wdem[R - 1]
    want = price_bundle_batch_numpy(price, free, wdem, sdem, gamma)
    _assert_bundles_equal(_plain(price, free, wdem, sdem, gamma), want)
    got = TorchBackend("cpu").snapshot_bundle_batch(
        torch.from_numpy(price), torch.from_numpy(free), wdem, sdem, gamma)
    _assert_bundles_equal(got, want)


@pytest.mark.parametrize("R,ok", [(1, True), (4, True), (8, True),
                                  (9, False), (16, False)])
def test_pack_demand_takes_at_most_r_max(R, ok):
    """The kernel's demand parameter holds R_MAX resources: wdem then sdem
    are staged where its entries read them, and a wider R is refused, by
    the kernel path too, before it looks at the device."""
    wdem = np.arange(1.0, R + 1)
    sdem = -np.arange(1.0, R + 1)
    if ok:
        ptr = pack_demand(wdem, sdem)
        buf, staged_ptr = pricing._LOCAL.demand
        assert ptr == staged_ptr == buf.ctypes.data
        np.testing.assert_array_equal(buf[:R], wdem)
        np.testing.assert_array_equal(buf[R:2 * R], sdem)
        return
    with pytest.raises(ValueError, match=f"R <= {R_MAX}"):
        pack_demand(wdem, sdem)
    ones = torch.ones((1, 2, R), dtype=torch.float64)
    with pytest.raises(ValueError, match=f"R <= {R_MAX}"):
        price_bundle_batch_cuda(ones, ones, wdem, sdem, 2.0)


def test_pack_demand_refuses_unequal_rows():
    with pytest.raises(ValueError, match="sdem of 3"):
        pack_demand(np.ones(4), np.ones(3))
    with pytest.raises(ValueError, match="R <= "):
        pack_demand(np.ones(0), np.ones(0))


def test_plain_version_checks_its_operands():
    price, free, wdem, sdem, gamma = _instance(0, 2, 3, 4)
    with pytest.raises(ValueError, match="R=4"):
        price_bundle_batch_torch(torch.from_numpy(price),
                                 torch.from_numpy(free), wdem[:3], sdem,
                                 gamma)


@pytest.mark.parametrize("R,aligned,vec", [
    (4, True, 2), (8, True, 2), (2, True, 2), (4, False, 1), (7, True, 1),
    (1, True, 1), (3, False, 1),
])
def test_bundle_vec(R, aligned, vec):
    assert bundle_vec(R, aligned) == vec
