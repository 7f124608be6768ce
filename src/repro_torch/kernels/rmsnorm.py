"""Fused RMSNorm over the last axis of a (N, d) tensor:

    y = x * rsqrt(mean(x**2, -1) + eps) * scale

in float32, rounded once into x's dtype; ``scale`` (d,) is read as
float32 whatever its dtype (the model keeps it in the float32 parameter
dtype while it computes in bfloat16). Two implementations:

  * ``rmsnorm_cuda``  — the hand-written CUDA kernel
    (``csrc/rmsnorm.cu``: each row read once in 16-byte chunks held in
    registers, a block per row wider than 32 chunks), replacing the JAX
    package's Pallas ``_rmsnorm_kernel``;
  * ``rmsnorm_torch`` — its plain torch version, the reference's
    (``reference_rmsnorm``) arithmetic op for op.

and its gradient, ``(dx, dscale)`` for an upstream ``dy``:

    dx = r * (g - x * r**2 * mean(g * x)),  g = dy * scale,
    dscale = sum over rows of dy * x * r,    r = rsqrt(mean(x**2) + eps)

in float32, dx rounded once into x's dtype and dscale into scale's:

  * ``rmsnorm_bwd_cuda``  — the hand-written CUDA kernel
    (``csrc/rmsnorm_bwd.cu``: the forward's row layout over a grid that
    follows the rows (``rmsnorm_bwd_slabs``), the next row in flight
    while one is reduced, dscale from one partial row a block added in a
    fixed order, no atomics);
  * ``rmsnorm_bwd_torch`` — its plain torch version, written out by hand
    (what ``jax.grad`` of the reference's ``layers.rmsnorm`` computes).

``RMSNormFn`` is the autograd function over the two kernels.
``repro_torch.kernels.ops.rmsnorm`` routes by the tensor's device: the
plain version for a CPU tensor (autograd differentiates it), ``RMSNormFn``
for a CUDA tensor (its kernels, or it raises). ``LAUNCHES`` and
``LAUNCHES_BWD`` count the two kernels' launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

#: kernel launches made by ``rmsnorm_cuda`` in this process
LAUNCHES = 0
#: kernel launches made by ``rmsnorm_bwd_cuda`` in this process
LAUNCHES_BWD = 0

_ENTRIES = {torch.float32: "rmsnorm_f32_launch",
            torch.bfloat16: "rmsnorm_bf16_launch"}
_ARGTYPES = ([ctypes.c_void_p] * 3
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                ctypes.c_void_p] + [ctypes.c_int] * 4)
#: C entry points resolved so far, by dtype
_FNS: dict = {}
_BWD_ENTRIES = {torch.float32: "rmsnorm_bwd_f32_launch",
                torch.bfloat16: "rmsnorm_bwd_bf16_launch"}
_BWD_ARGTYPES = ([ctypes.c_void_p] * 6
                 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                    ctypes.c_void_p] + [ctypes.c_int] * 6
                 + [ctypes.c_longlong, ctypes.c_int])

#: the widest row the kernel takes, on every path
MAX_D = 16384
MAX_THREADS = 1024
#: block size when a row takes at most a warp
NARROW_THREADS = 256
#: the H100's streaming multiprocessors. The backward sizes its grid for
#: them as a named constant, never from the card it runs on, so its
#: partition (and the order dscale is summed in) is a function of the
#: shape alone
H100_SMS = 132
#: blocks of ``NARROW_THREADS`` the backward gives an SM on narrow rows:
#: the narrow kernel takes 76 registers a thread, so an SM holds 3 at
#: once: the grid is one wave
BWD_NARROW_BLOCKS_PER_SM = 3
#: threads the backward gives an SM on the block-per-row path: the kernel
#: is built for 1024-thread blocks, so it takes at most 64 registers a
#: thread, and an SM surely holds 1024 of them at once
BWD_WIDE_THREADS_PER_SM = 1024
#: the most rows the block-per-row path's shared-memory ring holds, and
#: the shared memory an SM gives the rings of its blocks
#: (csrc/rmsnorm_bwd.cu: kMaxStages, kRingBytes)
BWD_RING_STAGES = 3
BWD_RING_BYTES_PER_SM = 224 * 1024
#: chunks a thread may hold, by elements per chunk (the kernel's
#: instantiations: 16-byte chunks of 8 bf16 or 4 float32, or single
#: elements); each path covers rows up to ``MAX_D``
CHUNKS_PER_THREAD = {8: (1, 2), 4: (1, 2, 4), 1: (1, 2, 4, 8, 16)}


class Layout(NamedTuple):
    """How the kernel lays a row out: block size, threads per row,
    chunks per thread and elements per chunk (16 bytes' worth, or 1)."""
    threads: int
    tpr: int
    nch: int
    width: int


@functools.lru_cache(maxsize=None)
def rmsnorm_layout(d: int, dtype: torch.dtype, aligned: bool) -> Layout:
    """The kernel's layout for rows of d ``dtype`` values. 16-byte chunks
    when a row is a whole number of them and every pointer is 16-byte
    aligned (``aligned``), else one element per chunk. A thread takes
    the fewest chunks that let at most 1024 threads cover the row; a row
    of at most 32 threads' work takes a power-of-two share of a warp in a
    256-thread block, a wider row a block of its own in whole warps."""
    if not 1 <= d <= MAX_D:
        raise ValueError(f"the rmsnorm kernel takes 1 <= d <= {MAX_D}, "
                         f"got {d}")
    vec = 16 // dtype.itemsize
    width = vec if aligned and d % vec == 0 else 1
    chunks = d // width
    nch = next(n for n in CHUNKS_PER_THREAD[width]
               if n * MAX_THREADS >= chunks)
    need = -(-chunks // nch)               # threads the row needs
    if need <= 32:
        tpr = 1 << (need - 1).bit_length()
        return Layout(NARROW_THREADS, tpr, nch, width)
    tpr = -(-need // 32) * 32
    return Layout(tpr, tpr, nch, width)


def _math_dtype(x: torch.Tensor) -> torch.dtype:
    """float32, the reference's; float64 stays float64 (gradcheck)."""
    return torch.promote_types(x.dtype, torch.float32)


def rmsnorm_torch(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Plain torch version: float32 math, output in x's dtype."""
    x32 = x.to(_math_dtype(x))
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.to(x32.dtype)).to(x.dtype)


def _check(x: torch.Tensor, scale: torch.Tensor) -> None:
    if x.dim() != 2 or scale.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm takes x (N, d) and scale (d,), got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    if x.dtype not in _ENTRIES:
        raise TypeError(f"rmsnorm kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if not x.is_cuda or scale.device != x.device:
        raise ValueError(f"the CUDA kernel needs x and scale on one CUDA "
                         f"device, got {x.device} and {scale.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """Launch the kernel on the current stream; returns y without
    synchronizing."""
    global LAUNCHES
    _check(x, scale)
    if scale.dtype != torch.float32 or not scale.is_contiguous():
        scale = scale.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    N, d = x.shape
    xp, sp, yp = x.data_ptr(), scale.data_ptr(), y.data_ptr()
    lay = rmsnorm_layout(d, x.dtype, (xp | sp | yp) % 16 == 0)
    status = _entry(x.dtype)(xp, sp, yp, N, d, eps, _build.stream_of(x),
                             lay.threads, lay.tpr, lay.nch,
                             int(lay.width > 1))
    _build.check(status, "rmsnorm kernel")
    LAUNCHES += 1
    return y


def _entry(dtype: torch.dtype):
    """The C entry point for ``dtype``, resolved once; raises if the
    source does not build or load."""
    fn = _FNS.get(dtype)
    if fn is None:
        fn = getattr(_build.load("rmsnorm"), _ENTRIES[dtype])
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FNS[dtype] = fn
    return fn


class Slabs(NamedTuple):
    """How the backward splits N rows. Each of ``blocks`` blocks holds
    ``lanes`` lanes (a row's threads), and each lane takes ``slab`` rows:
    lane j of block b the rows ``b * lanes * slab + j + k * lanes``,
    k < ``slab``, that exist. Block b writes row b of the (blocks, d)
    dscale partial. ``stages``: rows of the block-per-row path's
    shared-memory ring, ``stages - 1`` of them in flight ahead of the
    one reduced (0: plain loads)."""
    slab: int
    lanes: int
    blocks: int
    stages: int


@functools.lru_cache(maxsize=None)
def rmsnorm_bwd_slabs(rows: int, d: int, dtype: torch.dtype,
                      aligned: bool) -> Slabs:
    """The backward's partition of ``rows`` rows of width d, a function of
    (rows, d, dtype, aligned) alone, so the order in which dscale is
    summed is fixed for a shape. The grid aims at
    ``BWD_NARROW_BLOCKS_PER_SM`` narrow blocks, or
    ``BWD_WIDE_THREADS_PER_SM`` threads of block-per-row blocks, on each
    of ``H100_SMS`` SMs: one wave, every block resident from the start.
    A lane takes the fewest rows that keep the grid within that, so every
    SM has rows in flight and the partial stays a few hundred rows. The
    ring takes as many rows as fit, up to ``BWD_RING_STAGES``, in its
    block's share of ``BWD_RING_BYTES_PER_SM``, where the chunks are 16
    bytes; fewer than 2 rows is no ring."""
    lay = rmsnorm_layout(d, dtype, aligned)
    narrow = lay.tpr <= 32
    if narrow:
        lanes, per_sm = lay.threads // lay.tpr, BWD_NARROW_BLOCKS_PER_SM
    else:
        lanes = 1
        per_sm = max(1, BWD_WIDE_THREADS_PER_SM // lay.threads)
    slab = max(1, -(-rows // (H100_SMS * per_sm * lanes)))
    blocks = -(-rows // (lanes * slab))
    stages = 0
    if not narrow and lay.width > 1:
        fit = BWD_RING_BYTES_PER_SM // per_sm // (2 * d * dtype.itemsize)
        stages = min(BWD_RING_STAGES, fit) if fit >= 2 else 0
    return Slabs(slab, lanes, blocks, stages)


def rmsnorm_bwd_torch(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                      eps: float = 1e-6):
    """Plain torch version of the gradient: float32 math, dx in x's dtype,
    dscale (summed over every leading row) in scale's."""
    x32 = x.to(_math_dtype(x))
    dy32 = dy.to(x32.dtype)
    r = torch.rsqrt(torch.mean(torch.square(x32), dim=-1, keepdim=True)
                    + eps)
    g = dy32 * scale.to(x32.dtype)
    mean_gx = torch.mean(g * x32, dim=-1, keepdim=True)
    dx = r * (g - x32 * (r * r) * mean_gx)
    dscale = (dy32 * (x32 * r)).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


def rmsnorm_bwd_cuda(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                     eps: float = 1e-6):
    """Launch the backward's two passes on the current stream; returns
    (dx, dscale) without synchronizing."""
    global LAUNCHES_BWD
    _check(x, scale)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or not dy.is_contiguous():
        raise ValueError(f"dy must be a contiguous {x.dtype} tensor of x's "
                         f"shape {tuple(x.shape)} on {x.device}")
    s32 = scale.to(torch.float32).contiguous()
    dx = torch.empty_like(x)
    N, d = x.shape
    xp, sp, gp, dp = x.data_ptr(), s32.data_ptr(), dy.data_ptr(), \
        dx.data_ptr()
    aligned = (xp | sp | gp | dp) % 16 == 0
    lay = rmsnorm_layout(d, x.dtype, aligned)
    slabs = rmsnorm_bwd_slabs(N, d, x.dtype, aligned)
    partial = torch.empty((slabs.blocks, d), dtype=torch.float32,
                          device=x.device)
    dscale = torch.empty((d,), dtype=torch.float32, device=x.device)
    status = _build.entry("rmsnorm_bwd", _BWD_ENTRIES[x.dtype],
                          _BWD_ARGTYPES)(
        xp, sp, gp, dp, partial.data_ptr(), dscale.data_ptr(), N, d, eps,
        _build.stream_of(x), lay.threads, lay.tpr, lay.nch,
        int(lay.width > 1), slabs.slab, slabs.lanes, slabs.blocks,
        slabs.stages)
    _build.check(status, "rmsnorm backward kernel")
    LAUNCHES_BWD += 1
    return dx, dscale.to(scale.dtype)


class RMSNormFn(torch.autograd.Function):
    """RMSNorm of x (N, d) on the card with its gradient: the forward is
    ``rmsnorm_cuda``, the backward ``rmsnorm_bwd_cuda``. ``scale`` is the
    parameter itself, in its own dtype: the kernels read a float32 copy,
    and the gradient comes back in scale's dtype to the parameter. Under
    ``torch.utils.checkpoint`` the forward runs again in the backward, and
    each run counts in ``LAUNCHES``."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm_cuda(x, scale, eps)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd_cuda(x, scale, dy.contiguous(), ctx.eps)
        return dx, dscale, None
