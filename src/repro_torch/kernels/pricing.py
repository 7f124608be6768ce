"""Masked price-matrix reduction for Algorithm 4's per-(job, slot) snapshot.

A ``PriceSnapshot`` reduces one slot's (H, R) price and free-capacity
matrices into the five per-machine vectors every Algorithm-3/4 decision
reads:

    wprice[h] = sum_r p_h^r alpha_i^r          (worker price, below Eq. 26)
    sprice[h] = sum_r p_h^r beta_i^r           (PS price)
    coloc[h]  = sum_r p_h^r (alpha^r gamma + beta^r)   (internal sort key)
    max_w[h]  = floor(min_{r: alpha^r > 0} free_h^r / alpha^r)  (head-room)
    max_s[h]  = floor(min_{r: beta^r  > 0} free_h^r / beta^r)

Here over a whole (W, H, R) slot stack at once. Two implementations of
the same function, both float64 and both bit-identical to the JAX
package's numpy reference (``price_bundle_batch_numpy``):

  * ``price_bundle_batch_cuda``  — the hand-written CUDA kernel
    (``csrc/price_bundle.cu``), one thread per (slot, machine); wdem and
    sdem travel by value (R <= ``R_MAX``), the C entry forms coef from
    them with the reference's two roundings, and a row is read as double2
    where ``bundle_vec`` allows it;
  * ``price_bundle_batch_torch`` — its plain torch version, with the same
    per-resource accumulation order and zero-demand skips.

``price_bundle_batch`` is the wrapper the backend calls: it takes the
plain version only for CPU tensors; for CUDA tensors one C call launches
the kernel, copies the five rows into reused pinned memory and syncs the
stream (the admission decision's one sync point), or it raises.
``price_bundle`` is the per-slot form: the same call with W = 1.
``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import numpy as np
import torch

from . import _build

Bundle = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]

#: kernel launches made by ``price_bundle_batch_cuda`` and
#: ``price_bundle_batch`` in this process
LAUNCHES = 0
#: the most resources the kernel takes (its demand parameter's width)
R_MAX = 8

#: per thread, the host buffer the C entries read the demand from
#: (wdem[:R], then sdem[:R]) and its address
_LOCAL = threading.local()

_LAUNCH_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_double, ctypes.c_void_p]
                + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_HOST_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_double]
              + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
              + [ctypes.c_void_p])


def pack_demand(wdem, sdem) -> int:
    """Stage wdem and sdem where the kernel's entries read them (into
    their by-value parameter, before they return): a buffer of the
    calling thread. Returns its host address; raises unless
    1 <= R <= ``R_MAX``."""
    R = len(wdem)
    if not 1 <= R <= R_MAX or len(sdem) != R:
        raise ValueError(f"the kernel takes 1 <= R <= {R_MAX} resources, "
                         f"got wdem of {R} and sdem of {len(sdem)}")
    staged = getattr(_LOCAL, "demand", None)
    if staged is None:
        buf = np.zeros(2 * R_MAX)
        staged = _LOCAL.demand = (buf, buf.ctypes.data)
    buf, ptr = staged
    buf[:R] = wdem
    buf[R:2 * R] = sdem
    return ptr


def bundle_vec(R: int, aligned: bool) -> int:
    """Doubles a load takes: 2 (one double2) when a row is a whole number
    of them and both operands are 16-byte aligned (``aligned``), else 1."""
    return 2 if aligned and R % 2 == 0 else 1


def _check(price: torch.Tensor, free: torch.Tensor, wdem, sdem) -> None:
    if price.dim() != 3 or free.shape != price.shape:
        raise ValueError(f"price/free must be equal (W, H, R) stacks, got "
                         f"{tuple(price.shape)} and {tuple(free.shape)}")
    if price.dtype is not torch.float64 or free.dtype is not torch.float64:
        raise TypeError(f"price and free must be float64, got {price.dtype}"
                        f" and {free.dtype}")
    if len(wdem) != price.shape[2] or len(sdem) != price.shape[2]:
        raise ValueError(f"demand rows must have R={price.shape[2]} "
                         f"entries, got {len(wdem)} and {len(sdem)}")
    if free.get_device() != price.get_device():
        raise ValueError(f"free is on {free.device}, price on "
                         f"{price.device}")


def _kernel_args(price: torch.Tensor, free: torch.Tensor, wdem,
                 sdem) -> Tuple[int, int, int, int]:
    """What the kernel's entries take beyond gamma and the output: (host
    address of the staged demand, WH, R, vec); raises on what they do not
    take."""
    _check(price, free, wdem, sdem)
    dem_ptr = pack_demand(wdem, sdem)
    if not price.is_cuda:
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                         f"{price.device}")
    if not (price.is_contiguous() and free.is_contiguous()):
        raise ValueError("price and free must be contiguous")
    W, H, R = price.shape
    aligned = (price.data_ptr() | free.data_ptr()) % 16 == 0
    return dem_ptr, W * H, R, bundle_vec(R, aligned)


def price_bundle_batch_torch(price: torch.Tensor, free: torch.Tensor,
                             wdem, sdem, gamma: float) -> torch.Tensor:
    """Plain torch version: the (5, W, H) rows (wprice, sprice, coloc,
    max_w, max_s), accumulated in the reference's per-resource order."""
    _check(price, free, wdem, sdem)
    W, H, R = price.shape
    wdem = np.asarray(wdem, dtype=np.float64)
    sdem = np.asarray(sdem, dtype=np.float64)
    coef = (wdem * gamma + sdem).tolist()
    out = torch.zeros((5, W, H), dtype=torch.float64, device=price.device)
    for k in range(R):
        pcol = price[:, :, k]
        if wdem[k]:
            out[0] += pcol * float(wdem[k])
        if sdem[k]:
            out[1] += pcol * float(sdem[k])
        out[2] += pcol * coef[k]
    for row, d in ((3, wdem), (4, sdem)):
        pos = np.flatnonzero(d > 0)
        if pos.size == 0:
            out[row] = float("inf")
            continue
        ratio = (free[:, :, torch.as_tensor(pos, device=price.device)]
                 / torch.as_tensor(d[pos], device=price.device)).amin(dim=2)
        out[row] = torch.floor(ratio.clamp_min(0.0))
    return out


def price_bundle_batch_cuda(price: torch.Tensor, free: torch.Tensor,
                            wdem, sdem, gamma: float) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; returns the (5, W, H)
    rows on the device without synchronizing."""
    global LAUNCHES
    dem_ptr, WH, R, vec = _kernel_args(price, free, wdem, sdem)
    out = torch.empty((5,) + price.shape[:2], dtype=torch.float64,
                      device=price.device)
    fn = _build.entry("price_bundle", "price_bundle_launch", _LAUNCH_ARGS)
    status = fn(price.data_ptr(), free.data_ptr(), dem_ptr, gamma,
                out.data_ptr(), WH, R, vec, _build.stream_of(price))
    _build.check(status, "price_bundle kernel")
    LAUNCHES += 1
    return out


def _bundle_host(price: torch.Tensor, free: torch.Tensor, wdem, sdem,
                 gamma: float) -> np.ndarray:
    """The kernel's round trip in one C call: launch, one copy of the
    five rows into reused pinned memory, one stream sync; returns them
    as a (5, W, H) host array of its own."""
    global LAUNCHES
    dem_ptr, WH, R, vec = _kernel_args(price, free, wdem, sdem)
    host, dev = _build.staging("price_bundle.out", price.device, 5 * WH)
    fn = _build.entry("price_bundle", "price_bundle_host", _HOST_ARGS)
    status = fn(price.data_ptr(), free.data_ptr(), dem_ptr, gamma,
                dev.data_ptr(), host.data_ptr(), WH, R, vec,
                _build.stream_of(price))
    _build.check(status, "price_bundle kernel")
    LAUNCHES += 1
    return host.numpy()[:5 * WH].reshape((5,) + price.shape[:2]).copy()


def price_bundle_batch(price: torch.Tensor, free: torch.Tensor,
                       wdem: np.ndarray, sdem: np.ndarray,
                       gamma: float) -> Bundle:
    """Fused multi-slot snapshot reduction: five (W, H) host float64
    arrays from one reduction and one device-to-host copy. CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    if price.device.type == "cpu":
        host = price_bundle_batch_torch(price, free, wdem, sdem,
                                        gamma).numpy()
    else:
        host = _bundle_host(price, free, wdem, sdem, gamma)
    return host[0], host[1], host[2], host[3], host[4]


def price_bundle(price: torch.Tensor, free: torch.Tensor,
                 wdem: np.ndarray, sdem: np.ndarray, gamma: float) -> Bundle:
    """Per-slot form over (H, R) operands: ``price_bundle_batch`` with
    W = 1, returning five (H,) host arrays."""
    rows = price_bundle_batch(price.unsqueeze(0), free.unsqueeze(0),
                              wdem, sdem, gamma)
    return tuple(r[0] for r in rows)
