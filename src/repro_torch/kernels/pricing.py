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
    (``csrc/price_bundle.cu``), one thread per (slot, machine);
  * ``price_bundle_batch_torch`` — its plain torch version, with the same
    per-resource accumulation order and zero-demand skips.

``price_bundle_batch`` is the wrapper the backend calls: it takes the
plain version only for CPU tensors, launches the kernel for CUDA tensors
(and raises if it cannot), and copies the five rows to the host in one
copy — the admission decision's sync point. ``price_bundle`` is the
per-slot form: the same call with W = 1. ``LAUNCHES`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import _build

Bundle = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]

#: kernel launches made by ``price_bundle_batch_cuda`` in this process
LAUNCHES = 0


def demand_operand(wdem: np.ndarray, sdem: np.ndarray, gamma: float,
                   device) -> torch.Tensor:
    """The kernel's (3, R) float64 demand rows: wdem, sdem and the
    co-location coefficient wdem*gamma + sdem, computed on the host with
    the reference's arithmetic."""
    wdem = np.asarray(wdem, dtype=np.float64)
    sdem = np.asarray(sdem, dtype=np.float64)
    dem = np.stack([wdem, sdem, wdem * gamma + sdem])
    return torch.as_tensor(dem, device=device)


def _check(price: torch.Tensor, free: torch.Tensor,
           dem: torch.Tensor) -> None:
    if price.dim() != 3 or free.shape != price.shape:
        raise ValueError(f"price/free must be equal (W, H, R) stacks, got "
                         f"{tuple(price.shape)} and {tuple(free.shape)}")
    if dem.shape != (3, price.shape[2]):
        raise ValueError(f"demand rows must be (3, {price.shape[2]}), "
                         f"got {tuple(dem.shape)}")
    for name, x in (("price", price), ("free", free), ("dem", dem)):
        if x.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {x.dtype}")
        if x.device != price.device:
            raise ValueError(f"{name} is on {x.device}, price on "
                             f"{price.device}")


def price_bundle_batch_torch(price: torch.Tensor, free: torch.Tensor,
                             dem: torch.Tensor) -> torch.Tensor:
    """Plain torch version: the (5, W, H) rows (wprice, sprice, coloc,
    max_w, max_s), accumulated in the reference's per-resource order."""
    _check(price, free, dem)
    W, H, R = price.shape
    wdem, sdem, coef = dem.tolist()
    out = torch.zeros((5, W, H), dtype=torch.float64, device=price.device)
    for k in range(R):
        pcol = price[:, :, k]
        if wdem[k]:
            out[0] += pcol * wdem[k]
        if sdem[k]:
            out[1] += pcol * sdem[k]
        out[2] += pcol * coef[k]
    for row, d in ((3, dem[0]), (4, dem[1])):
        pos = torch.nonzero(d > 0).flatten()
        if pos.numel() == 0:
            out[row] = float("inf")
            continue
        ratio = (free[:, :, pos] / d[pos]).amin(dim=2)
        out[row] = torch.floor(ratio.clamp_min(0.0))
    return out


def price_bundle_batch_cuda(price: torch.Tensor, free: torch.Tensor,
                            dem: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; returns the (5, W, H)
    rows on the device without synchronizing."""
    global LAUNCHES
    _check(price, free, dem)
    if price.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                         f"{price.device}")
    if not (price.is_contiguous() and free.is_contiguous()
            and dem.is_contiguous()):
        raise ValueError("price, free and dem must be contiguous")
    W, H, R = price.shape
    out = torch.empty((5, W, H), dtype=torch.float64, device=price.device)
    fn = _entry()
    status = fn(price.data_ptr(), free.data_ptr(), dem.data_ptr(),
                out.data_ptr(), W * H, R,
                torch.cuda.current_stream(price.device).cuda_stream)
    _build.check(status, "price_bundle kernel")
    LAUNCHES += 1
    return out


def _entry():
    lib = _build.load("price_bundle")
    fn = lib.price_bundle_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def price_bundle_batch(price: torch.Tensor, free: torch.Tensor,
                       wdem: np.ndarray, sdem: np.ndarray,
                       gamma: float) -> Bundle:
    """Fused multi-slot snapshot reduction: five (W, H) host float64
    arrays from one reduction and one device-to-host copy. CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    dem = demand_operand(wdem, sdem, gamma, price.device)
    if price.device.type == "cpu":
        rows = price_bundle_batch_torch(price, free, dem)
    else:
        rows = price_bundle_batch_cuda(price, free, dem)
    host = rows.cpu().numpy()
    return host[0], host[1], host[2], host[3], host[4]


def price_bundle(price: torch.Tensor, free: torch.Tensor,
                 wdem: np.ndarray, sdem: np.ndarray, gamma: float) -> Bundle:
    """Per-slot form over (H, R) operands: ``price_bundle_batch`` with
    W = 1, returning five (H,) host arrays."""
    rows = price_bundle_batch(price.unsqueeze(0), free.unsqueeze(0),
                              wdem, sdem, gamma)
    return tuple(r[0] for r in rows)
