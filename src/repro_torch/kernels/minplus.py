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
    (``csrc/minplus_sweep.cu``): the whole sweep in one launch of one
    block, tcost staged in shared memory, one barrier a step; a row up to
    128 wide is solved by a group of lanes taking its candidates in
    parallel (shuffle min, ballot choice, the near-tie rows replayed
    through the scalar scan), a wider row by one lane's scalar scan;
  * ``minplus_sweep_torch`` — its plain torch version, built on
    ``minplus_step_torch``: a Toeplitz row-min with the hysteresis choice,
    replaying through the sequential scan the rows whose values hold a
    near-tie within 2e-12 of the minimum (as ``minplus_numpy`` does).

``minplus_sweep_host`` is the DP's one call, numpy in and numpy out: the
plain version on ``cpu``; on a card one copy in, one launch, one copy
back into reused pinned memory and one stream sync (the kernel or it
raises).
``sweep_layout`` picks the kernel's row solver, lanes a row, warps and
whether tcost streams through a ring. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import _build

_INF = float("inf")
#: the largest row the one-block kernel takes
MAX_Q1 = 1024
#: shared memory the kernel may use without an opt-in (bytes)
SMEM_BUDGET = 48 * 1024
#: tcost rows the kernel keeps in shared memory when the table does not fit
RING = 2
#: the widest row solved by a group of lanes; wider rows take the scan
GROUP_MAX_Q1 = 128
#: candidates a lane of a group holds
GROUP_CANDIDATES = 4

#: kernel launches made by ``minplus_sweep_cuda`` and
#: ``minplus_sweep_host`` in this process
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


class SweepLayout(NamedTuple):
    """How the kernel runs a sweep in its one block: ``lanes`` a row (a
    power of two; 0 for the scan, a lane a row), ``warps``, whether tcost
    streams through a ring of ``RING`` rows (beside two running rows), and
    the dynamic shared memory in bytes."""
    lanes: int
    warps: int
    ring: bool
    smem: int


def _smem(rows: int, tc_rows: int, Q1: int) -> int:
    """Bytes of shared memory for ``rows`` rows of C (float64) and of
    choices (int32) and ``tc_rows`` rows of tcost."""
    cells = rows * Q1
    return (cells + (cells + 1) // 2 + tc_rows * Q1) * 8


@functools.lru_cache(maxsize=None)
def sweep_layout(k: int, Q1: int) -> SweepLayout:
    """The kernel's layout for a (k, Q1) tcost. Rows up to
    ``GROUP_MAX_Q1`` wide go to groups of the fewest lanes (a power of
    two) that hold ``GROUP_CANDIDATES`` candidates each, 32 / lanes rows a
    warp, at most 32 warps; wider rows to the scan, a lane a row. Every
    row of C and choice and all of tcost stay in shared memory when they
    fit ``SMEM_BUDGET``; else two running rows and a ring of ``RING``
    tcost rows."""
    if not 1 <= Q1 <= MAX_Q1 or k < 0:
        raise ValueError(f"the sweep kernel takes k >= 0 and 1 <= Q1 <= "
                         f"{MAX_Q1}, got k={k}, Q1={Q1}")
    if Q1 <= GROUP_MAX_Q1:
        lanes = 1
        while lanes * GROUP_CANDIDATES < Q1:
            lanes *= 2
        warps = min(32, -(-Q1 // (32 // lanes)))
    else:
        lanes, warps = 0, -(-Q1 // 32)
    whole = _smem(k + 1, k, Q1)
    if whole <= SMEM_BUDGET:
        return SweepLayout(lanes, warps, False, whole)
    return SweepLayout(lanes, warps, True, _smem(2, RING, Q1))


def minplus_sweep_torch(tcost: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the sweep: (C (k+1, Q1), choice (k+1, Q1))."""
    _check(tcost)
    k, Q1 = tcost.shape
    C = torch.full((k + 1, Q1), _INF, dtype=torch.float64,
                   device=tcost.device)
    C[0, 0] = 0.0
    choice = torch.full((k + 1, Q1), -1, dtype=torch.int64,
                        device=tcost.device)
    for s in range(k):
        C[s + 1], choice[s + 1] = minplus_step_torch(C[s], tcost[s])
    return C, choice


_LAUNCH_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_HOST_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def minplus_sweep_cuda(tcost: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the sweep kernel on the current stream; returns the device
    tables (views of one buffer) without synchronizing."""
    global LAUNCHES
    _check(tcost)
    if not tcost.is_cuda:
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got "
                         f"{tcost.device}")
    if not tcost.is_contiguous():
        raise ValueError("tcost must be contiguous")
    k, Q1 = tcost.shape
    lay = sweep_layout(k, Q1)
    out = torch.empty((2, k + 1, Q1), dtype=torch.float64,
                      device=tcost.device)
    fn = _build.entry("minplus_sweep", "minplus_sweep_launch", _LAUNCH_ARGS)
    status = fn(tcost.data_ptr(), out.data_ptr(), k, Q1, lay.lanes,
                lay.warps, int(lay.ring), _build.stream_of(tcost))
    _build.check(status, "minplus_sweep kernel")
    LAUNCHES += 1
    C, choice = out.unbind(0)
    return C, choice.view(torch.int64)


def minplus_sweep_host(tcost: np.ndarray, device
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """The DP's sweep, host to host: numpy (k, Q1) float64 ``tcost`` in,
    numpy ``C`` and ``choice`` out. On ``cpu`` the plain version; on a
    card one host-to-device copy from a reused pinned buffer, one launch,
    one device-to-host copy into another and one stream sync, all in one
    C call."""
    global LAUNCHES
    device = torch.device(device)
    if device.type == "cpu":
        C, choice = minplus_sweep_torch(torch.from_numpy(tcost))
        return C.numpy(), choice.numpy()
    if device.type != "cuda":
        raise ValueError(f"the sweep runs on cpu or cuda, not {device}")
    if tcost.ndim != 2 or tcost.shape[1] < 1:
        raise ValueError(f"tcost must be (k, Q1) with Q1 >= 1, got "
                         f"{tcost.shape}")
    if tcost.dtype != np.float64:
        raise TypeError(f"tcost must be float64, got {tcost.dtype}")
    k, Q1 = tcost.shape
    lay = sweep_layout(k, Q1)
    n = (k + 1) * Q1
    in_host, in_dev = _build.staging("minplus.in", device, k * Q1)
    out_host, out_dev = _build.staging("minplus.out", device, 2 * n)
    in_host.numpy()[:k * Q1].reshape(k, Q1)[...] = tcost
    fn = _build.entry("minplus_sweep", "minplus_sweep_host", _HOST_ARGS)
    status = fn(in_host.data_ptr(), in_dev.data_ptr(), out_dev.data_ptr(),
                out_host.data_ptr(), k, Q1, lay.lanes, lay.warps,
                int(lay.ring), _build.stream_of(out_dev))
    _build.check(status, "minplus_sweep kernel")
    LAUNCHES += 1
    host = out_host.numpy()
    return (host[:n].reshape(k + 1, Q1).copy(),
            host[n:2 * n].view(np.int64).reshape(k + 1, Q1).copy())
