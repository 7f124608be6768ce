"""The port's attention (``repro_torch.kernels.flash_attention``, routed by
``repro_torch.kernels.ops.flash_attention``) against the JAX package on
the CPU: its Pallas flash kernel in interpret mode, ``ref.
reference_attention`` and the model's ``grouped_attention``.

``flash_attention_torch`` is what the CUDA kernel is held to on the card.
Inputs are made with numpy from a seed and handed to both packages.
Tolerances are the JAX package's own kernel tests': float32 2e-5,
bfloat16 2e-2, and 2e-4 against the model's chunked softmax."""
from __future__ import annotations

import types

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.attention import grouped_attention as j_grouped
from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.flash_attention import (
    allowed,
    flash_attention_cuda,
    flash_attention_torch,
    padded_head_dim,
    vector_loads,
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


def _bf16(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16) \
        .astype(np.float32)


def _tc_arithmetic(q, k, v, BK):
    """The tensor-core kernel's arithmetic on (BH, S, D) bf16 values,
    causal: float32 scores in 64-row query tiles and BK-key tiles, the
    online softmax in the log2 domain, p rounded to bf16 before p.v, the
    output rounded once to bf16."""
    BH, S, D = q.shape
    scale_log2 = np.float32(np.log2(np.e) / np.sqrt(D))
    out = np.empty_like(q)
    for q0 in range(0, S, 64):
        qs = q[:, q0:q0 + 64]
        rows = np.arange(q0, q0 + qs.shape[1])[:, None]
        m = np.full(qs.shape[:2], -1e30, np.float32)
        l = np.zeros(qs.shape[:2], np.float32)
        acc = np.zeros(qs.shape, np.float32)
        for kt in range(0, min(S, q0 + 64), BK):
            s = np.einsum("bqd,bkd->bqk", qs, k[:, kt:kt + BK]) * scale_log2
            keys = np.arange(kt, min(kt + BK, S))[None, :]
            s = np.where(keys <= rows, s, np.float32(-1e30))
            m_new = np.maximum(m, s.max(-1))
            alpha = np.exp2(m - m_new)
            p = np.exp2(s - m_new[..., None])
            l = alpha * l + p.sum(-1)
            acc = alpha[..., None] * acc + np.einsum(
                "bqk,bkd->bqd", _bf16(p), v[:, kt:kt + BK])
            m = m_new
        out[:, q0:q0 + 64] = _bf16(acc / np.maximum(l, 1e-30)[..., None])
    return out


@pytest.mark.parametrize("H,D,BK", [(2, 256, 32), (4, 128, 64)])
def test_tensor_core_rounding_matches_pallas(H, D, BK):
    """The bf16 route rounds p to bf16 before p.v, as the MXU's one bf16
    pass does; that arithmetic stays within the bf16 tolerance of the
    Pallas kernel on the same inputs."""
    q, k, v = _qkv(17 + D, 1, 512, 512, H, H, D, "bfloat16")
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, interpret=True)
    got = _tc_arithmetic(*(_bh(np.asarray(a, np.float32)) for a in (q, k, v)),
                         BK)
    got = got.reshape(1, H, 512, D).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **_tol("bfloat16"))


def test_padded_head_dim_buckets():
    for D in range(1, 257):
        want = 64 if D <= 64 else 128 if D <= 128 else 256
        assert padded_head_dim(D) == want, D
    for D in (0, 257):
        with pytest.raises(ValueError, match="head_dim"):
            padded_head_dim(D)


def test_vector_loads_need_whole_chunks_and_alignment():
    buf = torch.zeros(4096, dtype=torch.bfloat16)
    assert buf.data_ptr() % 16 == 0
    aligned, off = buf[:1024], buf[1:1025]
    assert vector_loads(256, aligned, aligned, aligned)
    assert vector_loads(8, aligned)
    assert not vector_loads(20, aligned)        # rows of 40 bytes
    assert not vector_loads(80 + 4, aligned)
    assert not vector_loads(256, aligned, off)  # one pointer 2 bytes off
    assert vector_loads(256, buf[8:1032])       # 16 bytes in


@pytest.mark.parametrize("dtype,source", [
    (torch.bfloat16, "flash_attention_tc"),
    (torch.float32, "flash_attention"),
])
def test_each_dtype_has_one_kernel_and_no_other(monkeypatch, dtype, source):
    """A route whose source fails to build raises; the wrapper asks for no
    other source, so neither kernel nor the plain version stands in."""
    asked = []

    def failing_load(name):
        asked.append(name)
        raise RuntimeError(f"nvcc failed for {name}.cu")

    monkeypatch.setattr(_build, "load", failing_load)
    with pytest.raises(RuntimeError, match=source):
        fa._entry(dtype)
    assert asked == [source]
    assert fa.ROUTES[dtype][0] == source
    assert source in _build.SOURCES


def test_bf16_wrapper_refuses_what_it_does_not_take():
    """bf16 on the CPU, mixed dtypes and float16 raise before any launch;
    none is handed to the plain version or the float32 kernel."""
    q = torch.ones((1, 8, 2, 16), dtype=torch.bfloat16)
    launches = fa.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q)
    with pytest.raises(TypeError):
        flash_attention_cuda(q, q.float(), q)
    with pytest.raises(TypeError):
        flash_attention_cuda(q.half(), q.half(), q.half())
    assert fa.LAUNCHES == launches


def test_float32_vector_loads_need_whole_chunks_and_alignment():
    """The float32 kernel copies 4 values to 16 bytes: D % 4 == 0 and
    every pointer 16-byte aligned, else the element-wise loader."""
    buf = torch.zeros(8192, dtype=torch.float32)
    assert buf.data_ptr() % 16 == 0
    aligned, off = buf[:2048], buf[1:2049]
    for D in (4, 20, 80, 128, 256):
        assert vector_loads(D, aligned, aligned, aligned, aligned), D
    for D in (1, 18, 50, 254):
        assert not vector_loads(D, aligned), D
    assert not vector_loads(256, aligned, off)   # one pointer 4 bytes off
    assert not vector_loads(256, buf[2:2050])    # 8 bytes off
    assert vector_loads(256, buf[4:2052])        # 16 bytes in
    # the bf16 rule is unchanged: 20 bf16 values are 40 bytes
    assert not vector_loads(20, aligned.to(torch.bfloat16))
    assert vector_loads(24, aligned.to(torch.bfloat16))


def test_entry_is_resolved_once_per_dtype(monkeypatch):
    loads = []

    def load(name):
        loads.append(name)
        return types.SimpleNamespace(
            flash_attention_f32_launch=types.SimpleNamespace(),
            flash_attention_bf16_launch=types.SimpleNamespace())

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(fa, "_FNS", {})
    for _ in range(50):
        for dtype in (torch.float32, torch.bfloat16):
            fa._entry(dtype)
    assert loads == ["flash_attention", "flash_attention_tc"]
    assert fa._entry(torch.float32).argtypes == fa._ARGTYPES


def _f32_arithmetic(q, k, v, BK):
    """The float32 kernel's arithmetic on (BH, S, D) values, causal:
    64-row query tiles, BK-key tiles, the online softmax with exp, each
    of a row's 16 threads summing its own keys (cg + 16j) and the 16
    shares added at the end."""
    BH, S, D = q.shape
    sm = np.float32(1 / np.sqrt(D))
    out = np.empty_like(q)
    for q0 in range(0, S, 64):
        qs = q[:, q0:q0 + 64]
        rows = np.arange(q0, q0 + qs.shape[1])[:, None]
        m = np.full(qs.shape[:2], -1e30, np.float32)
        l = np.zeros(qs.shape[:2] + (16,), np.float32)
        acc = np.zeros(qs.shape, np.float32)
        for kt in range(0, min(S, q0 + 64), BK):
            s = np.einsum("bqd,bkd->bqk", qs, k[:, kt:kt + BK]) * sm
            keys = np.arange(kt, min(kt + BK, S))[None, :]
            s = np.where(keys <= rows, s, np.float32(-1e30))
            m_new = np.maximum(m, s.max(-1))
            alpha = np.exp(m - m_new)
            p = np.exp(s - m_new[..., None])
            share = np.zeros_like(l)
            for c in range(p.shape[-1]):
                share[..., c % 16] += p[..., c]
            l = alpha[..., None] * l + share
            acc = alpha[..., None] * acc + np.einsum(
                "bqk,bkd->bqd", p, v[:, kt:kt + BK])
            m = m_new
        out[:, q0:q0 + 64] = acc / np.maximum(l.sum(-1), 1e-30)[..., None]
    return out


@pytest.mark.parametrize("H,D", [(2, 256), (4, 80)])
def test_float32_tiling_matches_reference(H, D):
    """The float32 route's 64-key tiles and per-thread shares of the row
    sum stay within the float32 tolerance of ``reference_attention``
    (S = 320 is no multiple of the Pallas wrapper's tiles)."""
    q, k, v = _qkv(29 + D, 1, 320, 320, H, H, D)
    want = jref.reference_attention(jnp.asarray(_bh(q)), jnp.asarray(_bh(k)),
                                    jnp.asarray(_bh(v)), causal=True)
    got = _f32_arithmetic(*(_bh(a) for a in (q, k, v)), 64)
    np.testing.assert_allclose(got, np.asarray(want), **_tol("float32"))
