"""Fused RMSNorm over the last axis of a (N, d) tensor:

    y = x * rsqrt(mean(x**2, -1) + eps) * scale

in float32, rounded once into x's dtype; ``scale`` (d,) is read as
float32 whatever its dtype (the model keeps it in the float32 parameter
dtype while it computes in bfloat16). Two implementations:

  * ``rmsnorm_cuda``  — the hand-written CUDA kernel
    (``csrc/rmsnorm.cu``, one warp per row), replacing the JAX package's
    Pallas ``_rmsnorm_kernel``;
  * ``rmsnorm_torch`` — its plain torch version, the reference's
    (``reference_rmsnorm``) arithmetic op for op.

``repro_torch.kernels.ops.rmsnorm`` routes by the tensor's device: the
plain version for a CPU tensor, the kernel for a CUDA tensor (or it
raises). ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: kernel launches made by ``rmsnorm_cuda`` in this process
LAUNCHES = 0

_ENTRIES = {torch.float32: "rmsnorm_f32_launch",
            torch.bfloat16: "rmsnorm_bf16_launch"}


def rmsnorm_torch(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Plain torch version: float32 math, output in x's dtype."""
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def _check(x: torch.Tensor, scale: torch.Tensor) -> None:
    if x.dim() != 2 or scale.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm takes x (N, d) and scale (d,), got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    if x.dtype not in _ENTRIES:
        raise TypeError(f"rmsnorm kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.device.type != "cuda" or scale.device != x.device:
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
    scale = scale.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    fn = _entry(x.dtype)
    status = fn(x.data_ptr(), scale.data_ptr(), y.data_ptr(), x.shape[0],
                x.shape[1], eps,
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "rmsnorm kernel")
    LAUNCHES += 1
    return y


def _entry(dtype: torch.dtype):
    fn = getattr(_build.load("rmsnorm"), _ENTRIES[dtype])
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
