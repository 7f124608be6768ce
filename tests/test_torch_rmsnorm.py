"""The port's RMSNorm (``repro_torch.kernels.rmsnorm``, routed by
``repro_torch.kernels.ops.rmsnorm``) against the JAX package's Pallas
kernel in interpret mode, on the CPU; its gradient ``rmsnorm_bwd_torch``
against ``jax.vjp`` of the reference's ``layers.rmsnorm`` (the same
tolerances) and finite differences in float64 (``gradcheck``).

``rmsnorm_torch`` is what the CUDA kernel is held to on the card. Inputs
are made with numpy from a seed and handed to both packages. Tolerances
are those of the JAX package's own kernel tests: float32 2e-5, bfloat16
2e-2 (the two frameworks round the bfloat16 output at the same point,
but their float32 reductions differ in order)."""
from __future__ import annotations

import inspect
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro_torch.kernels import _build, ops
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels.rmsnorm import (
    CHUNKS_PER_THREAD,
    MAX_D,
    MAX_THREADS,
    rmsnorm_cuda,
    rmsnorm_layout,
    rmsnorm_torch,
)

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


# (d, dtype) -> the layout with aligned pointers: (threads, tpr, nch, width)
_LAYOUTS = {
    (1, torch.float32): (256, 1, 1, 1),
    (1, torch.bfloat16): (256, 1, 1, 1),
    (50, torch.float32): (64, 64, 1, 1),      # 50 % 4 != 0
    (50, torch.bfloat16): (64, 64, 1, 1),     # 50 % 8 != 0
    (128, torch.float32): (256, 32, 1, 4),    # a warp per row, 8 rows
    (128, torch.bfloat16): (256, 16, 1, 8),   # half a warp, 16 rows
    (3072, torch.float32): (768, 768, 1, 4),
    (3072, torch.bfloat16): (384, 384, 1, 8),  # 12 warps, one load each
    (12288, torch.float32): (768, 768, 4, 4),
    (12288, torch.bfloat16): (768, 768, 2, 8),
}


@pytest.mark.parametrize("d,dtype", list(_LAYOUTS))
def test_layout_choice(d, dtype):
    lay = rmsnorm_layout(d, dtype, True)
    assert tuple(lay) == _LAYOUTS[d, dtype]
    # every chunk of the row has a thread; a row is a power-of-two share
    # of a warp or a block of its own in whole warps
    assert lay.tpr * lay.nch * lay.width >= d
    assert lay.nch in CHUNKS_PER_THREAD[lay.width]
    assert lay.threads <= MAX_THREADS and lay.threads % 32 == 0
    if lay.tpr <= 32:
        assert lay.tpr & (lay.tpr - 1) == 0 and lay.threads % lay.tpr == 0
    else:
        assert lay.threads == lay.tpr
    # a pointer off a 16-byte boundary takes the element-wise path
    lay = rmsnorm_layout(d, dtype, False)
    assert lay.width == 1 and lay.tpr * lay.nch >= d


def test_layout_covers_every_width_up_to_the_widest():
    for dtype in (torch.float32, torch.bfloat16):
        for aligned in (True, False):
            for d in list(range(1, 300)) + [1535, 1536, 4095, 4096, 4104,
                                            8192, 8200, 12288, MAX_D]:
                lay = rmsnorm_layout(d, dtype, aligned)
                assert lay.tpr * lay.nch * lay.width >= d, (d, lay)
                assert lay.width == 1 or d % lay.width == 0


def test_wrapper_refuses_what_the_kernel_does_not_take():
    for d in (0, MAX_D + 1):
        with pytest.raises(ValueError, match="rmsnorm kernel takes"):
            rmsnorm_layout(d, torch.float32, True)
    with pytest.raises(ValueError, match=r"\(N, d\)"):
        rmsnorm_cuda(torch.ones((2, 3, 8)), torch.ones(8))
    with pytest.raises(ValueError, match=r"\(N, d\)"):
        rmsnorm_cuda(torch.ones((4, 8)), torch.ones(7))
    with pytest.raises(TypeError):
        rmsnorm_cuda(torch.ones((4, 8), dtype=torch.float16), torch.ones(8))


class _Lib:
    """Stands in for the loaded library: one attribute per entry point."""

    def __init__(self):
        self.rmsnorm_f32_launch = types.SimpleNamespace()
        self.rmsnorm_bf16_launch = types.SimpleNamespace()


def test_entry_is_loaded_once_per_dtype(monkeypatch):
    loads = []

    def load(name):
        loads.append(name)
        return _Lib()

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(rn, "_FNS", {})
    first = {dt: rn._entry(dt) for dt in (torch.float32, torch.bfloat16)}
    for _ in range(100):
        for dt in (torch.float32, torch.bfloat16):
            assert rn._entry(dt) is first[dt]
    assert loads == ["rmsnorm", "rmsnorm"]
    assert first[torch.float32].argtypes == rn._ARGTYPES


def test_failed_build_raises_every_time(monkeypatch):
    def failing_load(name):
        raise RuntimeError(f"nvcc failed for {name}.cu")

    monkeypatch.setattr(_build, "load", failing_load)
    monkeypatch.setattr(rn, "_FNS", {})
    for _ in range(2):
        with pytest.raises(RuntimeError, match="rmsnorm"):
            rn._entry(torch.bfloat16)
    assert rn._FNS == {}


# ---------------------------------------------------------------- backward
def _jax_grads(x, scale, dy):
    """(dx, dscale) of the reference's ``layers.rmsnorm`` by ``jax.vjp``."""
    _, vjp = jax.vjp(lambda xx, ss: jlayers.rmsnorm({"scale": ss}, xx),
                     jnp.asarray(x), jnp.asarray(scale))
    return vjp(jnp.asarray(dy))


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 64), (96, 512), (5, 50), (3, 7, 128),
                                   (300, 1)])
def test_rmsnorm_bwd_matches_jax_grad(shape, name):
    """The hand-written gradient against ``jax.vjp`` of the reference's
    norm through its casts: dx in x's dtype, dscale summed over every
    leading row in scale's (float32) dtype."""
    _, tdt, ndt = _DTYPES[name]
    x, scale = _inputs(sum(shape), shape, ndt)
    dy = np.random.default_rng(1).normal(size=shape).astype(
        np.float32).astype(ndt)
    want_dx, want_ds = _jax_grads(x, scale, dy)
    dx, ds = rn.rmsnorm_bwd_torch(_torch(x), torch.from_numpy(scale),
                                  _torch(dy))
    assert dx.dtype == tdt and dx.shape == shape
    assert ds.dtype == torch.float32 and ds.shape == (shape[-1],)
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(want_dx, np.float32), **_tol(name))
    np.testing.assert_allclose(ds.numpy(), np.asarray(want_ds, np.float32),
                               **_tol(name))


def test_rmsnorm_bwd_keeps_a_bf16_scale_dtype():
    """A bf16 scale (DeepSeek-V2's params) gets its gradient in bf16, the
    float32 sum rounded once, as ``jax.vjp`` gives it."""
    x, scale = _inputs(11, (16, 96), ml_dtypes.bfloat16)
    scale = scale.astype(ml_dtypes.bfloat16)
    dy = np.random.default_rng(2).normal(size=(16, 96)).astype(
        ml_dtypes.bfloat16)
    _, want_ds = _jax_grads(x, scale, dy)
    _, ds = rn.rmsnorm_bwd_torch(_torch(x), _torch(scale), _torch(dy))
    assert ds.dtype == torch.bfloat16
    np.testing.assert_allclose(ds.float().numpy(),
                               np.asarray(want_ds, np.float32), rtol=2e-2,
                               atol=2e-2)


class _PlainFn(torch.autograd.Function):
    """rmsnorm_torch forward, the hand-written rmsnorm_bwd_torch backward:
    what ``gradcheck`` holds to finite differences."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.save_for_backward(x, scale)
        return rmsnorm_torch(x, scale)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        return rn.rmsnorm_bwd_torch(x, scale, dy)


@pytest.mark.parametrize("shape", [(4, 6), (2, 3, 5), (7, 1)])
def test_rmsnorm_bwd_passes_gradcheck(shape):
    gen = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(shape, dtype=torch.float64, generator=gen)
    scale = torch.randn(shape[-1], dtype=torch.float64, generator=gen) + 1
    x.requires_grad_()
    scale.requires_grad_()
    assert torch.autograd.gradcheck(_PlainFn.apply, (x, scale))


def test_rmsnorm_bwd_is_autograds_gradient_of_the_plain_version():
    x, scale = _inputs(5, (32, 80), np.float32)
    tx = torch.from_numpy(x).requires_grad_()
    ts = torch.from_numpy(scale).requires_grad_()
    dy = torch.randn((32, 80), generator=torch.Generator().manual_seed(5))
    dx, ds = torch.autograd.grad(rmsnorm_torch(tx, ts), (tx, ts), dy)
    got_dx, got_ds = rn.rmsnorm_bwd_torch(tx.detach(), ts.detach(), dy)
    torch.testing.assert_close(got_dx, dx, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got_ds, ds, rtol=1e-5, atol=1e-5)


def test_rmsnorm_on_cpu_is_differentiable_through_ops():
    """``ops.rmsnorm`` on a CPU tensor is the plain version under
    autograd: the gradient reaches x and the scale parameter."""
    x, scale = _inputs(6, (3, 4, 32), np.float32)
    tx = torch.from_numpy(x).requires_grad_()
    ts = torch.nn.Parameter(torch.from_numpy(scale))
    ops.rmsnorm(tx, ts).sum().backward()
    want_dx, want_ds = rn.rmsnorm_bwd_torch(tx.detach(), ts.detach(),
                                            torch.ones((3, 4, 32)))
    torch.testing.assert_close(tx.grad, want_dx, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ts.grad, want_ds, rtol=1e-5, atol=1e-5)


_BF16, _F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("rows,d,dtype,aligned", [
    # Qwen3-32B's QK-norm rows, Gemma-7B's training and decode rows, the
    # widest row, Qwen3-32B's and Command R+'s d_model at 1024 tokens, the
    # cluster's reduced rows
    (65536, 128, _BF16, True), (8192, 128, _BF16, True),
    (8192, 3072, _BF16, True), (4, 3072, _BF16, True),
    (16, 16384, _BF16, True), (1024, 5120, _BF16, True),
    (1024, 12288, _BF16, True), (1024, 256, _BF16, True),
    (4096, 32, _BF16, True),
    # no row, one row, fewer rows than one block's lanes, and rows that
    # leave the last block part full
    (0, 128, _BF16, True), (0, 3072, _F32, True), (1, 128, _BF16, True),
    (1, 3072, _BF16, True), (5, 128, _BF16, True), (8191, 128, _BF16, True),
    (65535, 128, _BF16, True), (8191, 3072, _BF16, True),
    # float32, the element-wise path, rows whose ring does not fit
    (1000, 128, _F32, True), (16, 16384, _F32, True),
    (33, 77, _BF16, False), (300, 1, _F32, False), (40, 3072, _F32, False),
])
def test_bwd_slabs(rows, d, dtype, aligned, monkeypatch):
    """The backward's partition: every row lies in exactly one lane, each
    block has a row (the partial has one row a block), the plan is a
    function of (rows, d, dtype, aligned) alone, and the layout under it
    covers the row, at d up to ``MAX_D``."""
    s = rn.rmsnorm_bwd_slabs(rows, d, dtype, aligned)
    lay = rmsnorm_layout(d, dtype, aligned)
    # the kernel's map: lane j of block b takes b L S + j + k L, k < S
    b, j, k = np.meshgrid(np.arange(s.blocks), np.arange(s.lanes),
                          np.arange(s.slab), indexing="ij")
    got = b * s.lanes * s.slab + j + k * s.lanes
    assert np.array_equal(np.sort(got[got < rows]), np.arange(rows))
    owner = np.full(rows, -1)
    owner[got[got < rows]] = b[got < rows]
    assert np.array_equal(np.unique(owner), np.arange(s.blocks))
    assert s.lanes == (lay.threads // lay.tpr if lay.tpr <= 32 else 1)
    # (rows, d, dtype, aligned) alone: no card is asked, and the call
    # gives the same plan again
    assert list(inspect.signature(rn.rmsnorm_bwd_slabs.__wrapped__)
                .parameters) == ["rows", "d", "dtype", "aligned"]

    def asked(*a, **k):
        raise AssertionError("the partition asked the card")

    for name in ("is_available", "device_count", "get_device_properties",
                 "current_device"):
        monkeypatch.setattr(torch.cuda, name, asked)
    rn.rmsnorm_bwd_slabs.cache_clear()
    assert rn.rmsnorm_bwd_slabs(rows, d, dtype, aligned) == s
    # the layout covers the row; the ring fits where it is taken
    for width in (d, MAX_D):
        lay = rmsnorm_layout(width, dtype, aligned)
        assert lay.tpr * lay.nch * lay.width >= width
        plan = rn.rmsnorm_bwd_slabs(rows, width, dtype, aligned)
        if plan.stages:
            assert 2 <= plan.stages <= rn.BWD_RING_STAGES
            assert lay.tpr > 32 and lay.width > 1
            assert plan.stages * 2 * width * dtype.itemsize \
                <= rn.BWD_RING_BYTES_PER_SM


@pytest.mark.parametrize("rows,d,dtype", [(65536, 128, _BF16),
                                          (8192, 3072, _BF16),
                                          (0, 3072, _F32)])
def test_bwd_wrapper_hands_the_kernel_its_partition(rows, d, dtype,
                                                    monkeypatch):
    """``rmsnorm_bwd_cuda`` passes the plan of ``rmsnorm_bwd_slabs`` and
    the layout of ``rmsnorm_layout`` to the kernel, with a (blocks, d)
    float32 partial; counted once a call (the entry is stood in for:
    this box has no card)."""
    seen, sizes = [], []
    real_empty = torch.empty

    def empty(*shape, **kw):
        sizes.append((tuple(shape[0]) if len(shape) == 1 else shape,
                      kw.get("dtype")))
        return real_empty(*shape, **kw)

    monkeypatch.setattr(rn, "_check", lambda x, scale: None)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "entry", lambda name, sym, argtypes:
                        lambda *a: seen.append(a) or 0)
    monkeypatch.setattr(torch, "empty", empty)
    x = torch.ones((rows, d), dtype=dtype)
    before = rn.LAUNCHES_BWD
    rn.rmsnorm_bwd_cuda(x, torch.ones(d), torch.ones((rows, d), dtype=dtype))
    assert rn.LAUNCHES_BWD == before + 1
    (args,) = seen
    aligned = all(p % 16 == 0 for p in args[:4])
    lay = rmsnorm_layout(d, dtype, aligned)
    s = rn.rmsnorm_bwd_slabs(rows, d, dtype, aligned)
    assert args[6:8] == (rows, d)
    assert args[10:] == (lay.threads, lay.tpr, lay.nch, int(lay.width > 1),
                         s.slab, s.lanes, s.blocks, s.stages)
    assert ((s.blocks, d), torch.float32) in sizes


def test_bwd_kernel_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="CUDA"):
        rn.rmsnorm_bwd_cuda(torch.ones((4, 8)), torch.ones(8),
                            torch.ones((4, 8)))
    with pytest.raises(ValueError, match=r"\(N, d\)"):
        rn.rmsnorm_bwd_cuda(torch.ones((4, 8)), torch.ones(7),
                            torch.ones((4, 8)))
    with pytest.raises(TypeError):
        rn.rmsnorm_bwd_cuda(torch.ones((4, 8), dtype=torch.float16),
                            torch.ones(8), torch.ones((4, 8)))


def test_bwd_failed_build_raises_every_time(monkeypatch):
    """The backward's entry is built on first use; a failed build raises
    on every call and nothing is cached."""
    def failing_load(name):
        raise RuntimeError(f"nvcc failed for {name}.cu")

    monkeypatch.setattr(_build, "load", failing_load)
    monkeypatch.setattr(_build, "_ENTRIES", {})
    for _ in range(2):
        with pytest.raises(RuntimeError, match="rmsnorm_bwd"):
            _build.entry("rmsnorm_bwd", rn._BWD_ENTRIES[torch.bfloat16],
                         rn._BWD_ARGTYPES)
    assert _build._ENTRIES == {}
    assert "rmsnorm_bwd" in _build.SOURCES and \
        _build.SOURCES["rmsnorm_bwd"] == ()
