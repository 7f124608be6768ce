"""AdamW's step on the card, in the two hand-written kernels of
``csrc/adamw.cu``:

  * ``global_norm_cuda`` — the global norm: each gradient read once, its
    float32 squares summed in float64 in a fixed order (one partial a
    block, no atomics), then one block over every partial writes the
    float32 norm to the device;
  * ``adamw_cuda`` — one param tensor's update in place over its flat
    view: p, g, m and v read once, p, m and v written once, the arithmetic
    of ``optim.adamw``'s module docstring in float32 operation for
    operation, so that given the same norm it writes the plain route's
    params and moments bit for bit.

Their plain version is ``optim.adamw``'s torch route (``_square_sum``,
``_update_slabs``), which CPU and meta tensors take; ``optim.adamw.route``
picks the route from the tensors alone. Unlike the package's other
wrappers these take CUDA tensors only: given anything the kernels do not
take (CPU tensors included) they raise, and nothing falls back. The
launchers work out how to walk each flat tensor (16-byte chunks from the
first element at which every pointer aligns, else single elements) from
its pointers and size.
``LAUNCHES`` counts the kernels' launches: a step over T param tensors
makes 2T + 1 (T sums of squares, the norm's last pass, T updates).
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _build

#: kernel launches made by this module in this process
LAUNCHES = 0

#: dtype codes of the C entries
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: (param dtype, moment dtype) the update takes; gradients have the
#: param's dtype
PAIRS = ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
         (torch.float32, torch.float32))

_BLOCKS_ARGTYPES = [ctypes.c_longlong, ctypes.c_int]
_SUMSQ_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p]
_FINISH_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                    ctypes.c_void_p]
_UPDATE_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                    + [ctypes.c_longlong] + [ctypes.c_void_p] * 4
                    + [ctypes.c_float] * 6 + [ctypes.c_void_p])


def supported(p: torch.dtype, g: torch.dtype, m: torch.dtype,
              v: torch.dtype) -> bool:
    """Whether the update takes params, gradients and moments of these
    dtypes."""
    return g == p and v == m and (p, m) in PAIRS


def _check_flat(what: str, *tensors: torch.Tensor) -> None:
    t0 = tensors[0]
    for t in tensors:
        if not t.is_cuda or t.device != t0.device:
            raise ValueError(f"the AdamW kernels take {what} on one CUDA "
                             f"device, got {[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{what} of shape {tuple(t.shape)} is not "
                             f"contiguous: AdamW updates its flat view in "
                             f"place")


def global_norm_cuda(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every element's square over ``grads`` (float32
    or bf16 CUDA tensors, contiguous), a float32 0-d tensor on their
    device; launched on the current stream, nothing synced."""
    global LAUNCHES
    grads = list(grads)
    if not grads:
        raise ValueError("the global norm needs a gradient")
    _check_flat("gradients", *grads)
    for g in grads:
        if g.dtype not in DTYPES:
            raise ValueError(f"the norm kernel takes float32 or bfloat16 "
                             f"gradients, got {g.dtype}")
    count = _build.entry("adamw", "adamw_sumsq_blocks", _BLOCKS_ARGTYPES)
    blocks = [count(g.numel(), DTYPES[g.dtype]) for g in grads]
    partial = torch.empty(sum(blocks), dtype=torch.float64,
                          device=grads[0].device)
    out = torch.empty((), dtype=torch.float32, device=grads[0].device)
    stream = _build.stream_of(out)
    fn = _build.entry("adamw", "adamw_sumsq_launch", _SUMSQ_ARGTYPES)
    at = partial.data_ptr()
    for g, b in zip(grads, blocks):
        _build.check(fn(g.data_ptr(), DTYPES[g.dtype], g.numel(), at,
                        stream), "adamw sum-of-squares kernel")
        LAUNCHES += 1
        at += b * 8
    finish = _build.entry("adamw", "adamw_norm_finish_launch",
                          _FINISH_ARGTYPES)
    _build.check(finish(partial.data_ptr(), partial.numel(), out.data_ptr(),
                        stream), "adamw norm kernel")
    LAUNCHES += 1
    return out


def adamw_cuda(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
               v: torch.Tensor, clip: torch.Tensor, bc1: torch.Tensor,
               bc2: torch.Tensor, lr: torch.Tensor, b1: float, b2: float,
               eps: float, weight_decay: float) -> None:
    """One AdamW step of one param tensor, in place: ``p`` and its
    gradient ``g`` of one dtype, the moments ``m`` and ``v`` of a dtype of
    ``PAIRS``; ``clip``, ``bc1``, ``bc2`` and ``lr`` 0-d float32 tensors
    on their device. Launched on the current stream, nothing synced."""
    global LAUNCHES
    _check_flat("a param, its gradient and moments", p, g, m, v)
    if len({t.numel() for t in (p, g, m, v)}) > 1:
        raise ValueError(f"a param, its gradient and moments differ in size: "
                         f"{[tuple(t.shape) for t in (p, g, m, v)]}")
    for s in (clip, bc1, bc2, lr):
        if s.shape != () or s.dtype != torch.float32 or s.device != p.device:
            raise ValueError(f"clip, bc1, bc2 and lr must be 0-d float32 "
                             f"tensors on {p.device}, got {s.dtype} "
                             f"{tuple(s.shape)} on {s.device}")
    if not supported(p.dtype, g.dtype, m.dtype, v.dtype):
        raise ValueError(f"the AdamW kernel takes (param, moment) dtypes "
                         f"{PAIRS} with gradients of the param's, got "
                         f"{p.dtype}, {g.dtype}, {m.dtype}, {v.dtype}")
    if p.numel() == 0:
        return
    fn = _build.entry("adamw", "adamw_update_launch", _UPDATE_ARGTYPES)
    _build.check(fn(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                    DTYPES[p.dtype], DTYPES[m.dtype], p.numel(),
                    clip.data_ptr(),
                    bc1.data_ptr(), bc2.data_ptr(), lr.data_ptr(), b1,
                    1 - b1, b2, 1 - b2, eps, weight_decay,
                    _build.stream_of(p)), "adamw update kernel")
    LAUNCHES += 1
