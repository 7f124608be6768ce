"""The port's attention (``repro_torch.kernels.flash_attention``, routed by
``repro_torch.kernels.ops.flash_attention``) against the JAX package on
the CPU: its Pallas flash kernel in interpret mode, ``ref.
reference_attention`` and the model's ``grouped_attention``.

``flash_attention_torch`` is what the CUDA kernel is held to on the card.
Inputs are made with numpy from a seed and handed to both packages.
Tolerances are the JAX package's own kernel tests': float32 2e-5,
bfloat16 2e-2, and 2e-4 against the model's chunked softmax."""
from __future__ import annotations

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.attention import grouped_attention as j_grouped
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (
    allowed,
    flash_attention_cuda,
    flash_attention_torch,
)

_NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, B, S_q, S_k, H, KV, D, name="float32", scale=1.0):
    rng = np.random.default_rng(seed)
    out = []
    for shape in ((B, S_q, H, D), (B, S_k, KV, D), (B, S_k, KV, D)):
        a = (rng.normal(size=shape) * scale).astype(np.float32)
        out.append(a.astype(_NP[name]))
    return out


def _t(a, name="float32"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(_TORCH[name])


def _bh(a):
    """(B, S, H, D) -> (B*H, S, D), the Pallas kernel's layout."""
    B, S, H, D = a.shape
    return a.transpose(0, 2, 1, 3).reshape(B * H, S, D)


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,S,D", [(1, 1, 128, 64), (2, 2, 256, 64),
                                     (1, 4, 256, 128), (2, 1, 512, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_pallas(B, H, S, D, causal, name):
    q, k, v = _qkv(B * S + D, B, S, S, H, H, D, name)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, interpret=True)
    got = ops.flash_attention(_t(q, name), _t(k, name), _t(v, name),
                              causal=causal)
    assert got.dtype == _TORCH[name] and got.shape == (B, S, H, D)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(name))


@pytest.mark.parametrize("window", [32, 64, 128])
def test_window_matches_grouped_attention(window):
    q, k, v = _qkv(5, 1, 256, 256, 2, 2, 32)
    pos = jnp.arange(256)
    want = j_grouped(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos, pos,
                     causal=True, window=window)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("window", [32, 128])
def test_window_matches_pallas(window):
    q, k, v = _qkv(9, 1, 256, 256, 2, 2, 32)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, window=window,
                                block_q=64, block_k=64, interpret=True)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_cross_lengths_match_reference():
    """S_q != S_k, non-causal (a chunk attending to a longer prefix)."""
    q, k, v = _qkv(2, 1, 128, 256, 2, 2, 32)
    want = jref.reference_attention(jnp.asarray(_bh(q)), jnp.asarray(_bh(k)),
                                    jnp.asarray(_bh(v)), causal=False)
    want = np.asarray(want).reshape(1, 2, 128, 32).transpose(0, 2, 1, 3)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_gqa_matches_pallas_on_repeated_kv(causal):
    """KV < H: the port reads kv head h // G; the JAX wrapper takes the kv
    heads pre-broadcast (``jnp.repeat(k, G, axis=2)``)."""
    B, S, H, KV, D = 2, 128, 8, 2, 32
    q, k, v = _qkv(11, B, S, S, H, KV, D)
    G = H // KV
    want = jops.flash_attention(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), G, axis=2),
        jnp.repeat(jnp.asarray(v), G, axis=2), causal=causal, interpret=True)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_ragged_length_matches_reference():
    """S = 200 is no multiple of any tile; the Pallas wrapper refuses it,
    so the oracle is ``reference_attention``."""
    B, S, H, D = 2, 200, 2, 64
    q, k, v = _qkv(13, B, S, S, H, H, D)
    want = jref.reference_attention(jnp.asarray(_bh(q)), jnp.asarray(_bh(k)),
                                    jnp.asarray(_bh(v)), causal=True)
    want = np.asarray(want).reshape(B, H, S, D).transpose(0, 2, 1, 3)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_window_one_attends_to_itself():
    q, k, v = _qkv(6, 1, 128, 128, 1, 1, 16, scale=3.0)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True, window=1)
    np.testing.assert_allclose(got.numpy(), v, rtol=1e-5, atol=1e-5)


def test_constant_values_give_constant_rows():
    q, k, _ = _qkv(4, 1, 128, 128, 1, 1, 32, scale=10.0)
    got = ops.flash_attention(_t(q), _t(k), torch.ones((1, 128, 1, 32)))
    np.testing.assert_allclose(got.numpy(), 1.0, rtol=1e-5, atol=1e-5)


def test_allowed_pairs():
    ok = allowed(4, 4, causal=True, window=2).numpy()
    assert ok.tolist() == [[True, False, False, False],
                           [True, True, False, False],
                           [False, True, True, False],
                           [False, False, True, True]]
    assert allowed(3, 5, causal=False, window=0).all()


def test_kernel_refuses_what_it_does_not_take():
    q = torch.ones((1, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="pair"):
        flash_attention_torch(q, torch.ones((1, 8, 3, 16)),
                              torch.ones((1, 8, 3, 16)))
    with pytest.raises(TypeError):
        flash_attention_cuda(q.double(), q.double(), q.double())
