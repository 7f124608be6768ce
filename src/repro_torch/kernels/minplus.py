"""Min-plus (tropical) DP sweep for the Algorithm-3 workload DP.

One forward step of the DP (Eq. 21) is a min-plus convolution

    cur[u] = min_{0 <= v <= u} prev[u - v] + tcost[v],

and a sweep over k slots chains k of them from C[0] = [0, inf, ...]:
C[s+1] = step(C[s], tcost[s]). Besides the values every implementation
returns the DP ``choice`` table (-1 for an unreachable state):
choice[s+1][u] is the v the scalar reference's scan settles on — the
first candidate, unless a later one is better by more than 1e-12 (the
acceptance hysteresis). Backtracking reads it as it is.

Two implementations of the sweep, both float64 and bit-identical in
values and ``choice`` to k calls of the JAX package's ``minplus_scalar``:

  * ``minplus_sweep_cuda``  — the hand-written CUDA kernel
    (``csrc/minplus_sweep.cu``): the whole sweep in one launch, one
    thread per row u running the scalar scan;
  * ``minplus_sweep_torch`` — its plain torch version, built on
    ``minplus_step_torch``: a Toeplitz row-min with the hysteresis choice,
    replaying through the sequential scan the rows whose values hold a
    near-tie within 2e-12 of the minimum (as ``minplus_numpy`` does).

``minplus_sweep`` is the wrapper the DP calls: the plain version only for
CPU tensors, the kernel for CUDA tensors (or it raises). ``LAUNCHES``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

_INF = float("inf")
#: the largest row the one-block kernel takes (one thread per state)
MAX_Q1 = 1024

#: kernel launches made by ``minplus_sweep_cuda`` in this process
LAUNCHES = 0


def _scan(row, u: int) -> Tuple[float, int]:
    """The scalar reference's scan over one row of candidate values."""
    best, bestv = _INF, -1
    for v in range(u + 1):
        val = row[v]
        if val == _INF:
            continue
        if val < best - 1e-12:
            best, bestv = val, v
    return best, bestv


def minplus_step_torch(prev: torch.Tensor, tcost: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step: (cur (Q1,) float64, choice (Q1,) int64)."""
    Q1 = prev.numel()
    idx = torch.arange(Q1, device=prev.device)
    diff = idx[:, None] - idx[None, :]
    vals = torch.where(diff >= 0, prev[diff.abs()], _INF) + tcost[None, :]
    best = vals.amin(dim=1)
    # smallest v within the hysteresis of the row minimum
    hit = vals <= best[:, None] + 1e-12
    choice = hit.to(torch.uint8).argmax(dim=1)
    finite = torch.isfinite(best)
    choice[~finite] = -1
    near = (vals <= best[:, None] + 2e-12) & (vals > best[:, None])
    replay = torch.nonzero(finite & near.any(dim=1)).flatten().tolist()
    for u in replay:
        b, bv = _scan(vals[u].tolist(), u)
        best[u] = b
        choice[u] = bv
    return best, choice


def _check(tcost: torch.Tensor) -> None:
    if tcost.dim() != 2 or tcost.shape[1] < 1:
        raise ValueError(f"tcost must be (k, Q1) with Q1 >= 1, got "
                         f"{tuple(tcost.shape)}")
    if tcost.dtype != torch.float64:
        raise TypeError(f"tcost must be float64, got {tcost.dtype}")


def _tables(k: int, Q1: int, device):
    C = torch.empty((k + 1, Q1), dtype=torch.float64, device=device)
    choice = torch.empty((k + 1, Q1), dtype=torch.int64, device=device)
    return C, choice


def minplus_sweep_torch(tcost: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the sweep: (C (k+1, Q1), choice (k+1, Q1))."""
    _check(tcost)
    k, Q1 = tcost.shape
    C, choice = _tables(k, Q1, tcost.device)
    C.fill_(_INF)
    C[0, 0] = 0.0
    choice.fill_(-1)
    for s in range(k):
        C[s + 1], choice[s + 1] = minplus_step_torch(C[s], tcost[s])
    return C, choice


def minplus_sweep_cuda(tcost: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the fused sweep kernel on the current stream; returns the
    device tables without synchronizing."""
    global LAUNCHES
    _check(tcost)
    if tcost.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got "
                         f"{tcost.device}")
    if not tcost.is_contiguous():
        raise ValueError("tcost must be contiguous")
    k, Q1 = tcost.shape
    if Q1 > MAX_Q1:
        raise ValueError(f"Q1={Q1} exceeds the one-block kernel's {MAX_Q1}")
    C, choice = _tables(k, Q1, tcost.device)
    fn = _entry()
    status = fn(tcost.data_ptr(), C.data_ptr(), choice.data_ptr(), k, Q1,
                torch.cuda.current_stream(tcost.device).cuda_stream)
    _build.check(status, "minplus_sweep kernel")
    LAUNCHES += 1
    return C, choice


def _entry():
    lib = _build.load("minplus_sweep")
    fn = lib.minplus_sweep_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def minplus_sweep(tcost: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The DP's sweep: the plain version for a CPU tensor, the kernel for
    a CUDA tensor. Tables come back on the input's device."""
    if tcost.device.type == "cpu":
        return minplus_sweep_torch(tcost)
    return minplus_sweep_cuda(tcost)
