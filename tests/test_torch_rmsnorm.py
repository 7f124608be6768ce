"""The port's RMSNorm (``repro_torch.kernels.rmsnorm``, routed by
``repro_torch.kernels.ops.rmsnorm``) against the JAX package's Pallas
kernel in interpret mode, on the CPU.

``rmsnorm_torch`` is what the CUDA kernel is held to on the card. Inputs
are made with numpy from a seed and handed to both packages. Tolerances
are those of the JAX package's own kernel tests: float32 2e-5, bfloat16
2e-2 (the two frameworks round the bfloat16 output at the same point,
but their float32 reductions differ in order)."""
from __future__ import annotations

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels.rmsnorm import rmsnorm_cuda, rmsnorm_torch

_DTYPES = {"float32": (jnp.float32, torch.float32, np.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16, ml_dtypes.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, shape, np_dtype):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 3.0).astype(np.float32).astype(np_dtype)
    scale = (rng.normal(size=shape[-1]) + 1.0).astype(np.float32)
    return x, scale


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,d", [(8, 64), (256, 128), (512, 96), (96, 512)])
def test_rmsnorm_matches_pallas(N, d, name):
    jdt, tdt, ndt = _DTYPES[name]
    x, scale = _inputs(N * d, (N, d), ndt)
    want = jops.rmsnorm(jnp.asarray(x), jnp.asarray(scale), interpret=True)
    got = ops.rmsnorm(_torch(x), torch.from_numpy(scale))
    assert got.dtype == tdt and got.shape == (N, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(name))


@pytest.mark.parametrize("shape", [(2, 8, 16, 64), (3, 5, 128)])
def test_rmsnorm_leading_dims(shape):
    x, scale = _inputs(7, shape, np.float32)
    want = jops.rmsnorm(jnp.asarray(x), jnp.asarray(scale), interpret=True)
    got = ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale))
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_plain_version_is_the_reference_math():
    """bf16 x with a float32 scale: the reference casts the scale to
    float32 and rounds once at the end."""
    x, scale = _inputs(3, (64, 96), ml_dtypes.bfloat16)
    want = jref.reference_rmsnorm(jnp.asarray(x), jnp.asarray(scale))
    got = rmsnorm_torch(_torch(x), torch.from_numpy(scale))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


def test_unit_rms_with_unit_scale():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=(64, 128)) * 5).astype(np.float32))
    out = ops.rmsnorm(x, torch.ones(128))
    rms = out.square().mean(-1).sqrt()
    torch.testing.assert_close(rms, torch.ones(64), rtol=1e-4, atol=1e-4)


def test_kernel_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_cuda(torch.ones((4, 8)), torch.ones(8))
    with pytest.raises(TypeError):
        rmsnorm_cuda(torch.ones((4, 8), dtype=torch.float64), torch.ones(8))
