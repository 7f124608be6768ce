"""Torch backend: the (T, H, R) ledger as a float64 tensor on one device.

The counterpart of the JAX package's device backend. Differences that
follow from torch rather than from the algorithm:

  * the device is explicit: ``TorchBackend(device=None)`` means the CUDA
    card and raises ``RuntimeError`` when there is none; ``"cpu"`` must
    be asked for by name (the tests do);
  * torch tensors are mutable, so the ledger scatters update the ledger
    IN PLACE and return the same tensor (``ledger_add`` is one
    ``index_put_(..., accumulate=True)`` on slot ``t``; the release is
    gather, subtract, ``clamp_min(0)``, scatter). Every derived tensor
    (free, price) is a fresh tensor, so the version-cached mirrors in
    ``Cluster``/``PriceTable`` never alias the ledger;
  * eager torch needs no retrace workaround, so scatters take the exact
    machine count (no power-of-two padding).

``free_tensor``/``price_tensor`` are plain torch ops with the numpy
backend's clip/divide/pow sequence. ``torch.pow`` is not correctly
rounded (on the CPU it differs from numpy's ``**`` by 1 ulp on a few
percent of elements), so prices are tolerance-equal to the numpy
reference and decisions are held equal. The two reductions that follow
(``snapshot_bundle(_batch)``) go to ``repro_torch.kernels.pricing``:
the hand-written CUDA kernel on the card, its plain torch version on
the CPU; both are bit-identical to the numpy reference on equal inputs.
The release never asserts on the clamp (that would sync per release).
"""
from __future__ import annotations

import numpy as np
import torch

from . import ArrayBackend


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA card, and
    raises when there is none (no silent CPU fallback)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class TorchBackend(ArrayBackend):
    name = "torch"
    is_device = True

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def _t(self, arr) -> torch.Tensor:
        return torch.as_tensor(arr, dtype=torch.float64, device=self.device)

    # ---- array lifecycle ------------------------------------------------
    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float64, device=self.device)

    def to_host(self, arr) -> np.ndarray:
        # copy=True: a CPU tensor's .numpy() would share the ledger memory
        return arr.to("cpu", copy=True).numpy()

    # ---- ledger mutations (in place) -------------------------------------
    def _scatter_operands(self, needs):
        hs = torch.tensor([h for h, _ in needs], dtype=torch.int64,
                          device=self.device)
        vecs = self._t(np.stack([need for _, need in needs]))
        return hs, vecs

    def ledger_add(self, used, t: int, needs):
        # _alloc_need yields each machine once, so every cell gets exactly
        # one add: the same rounding as the numpy backend's per-row +=
        if needs:
            hs, vecs = self._scatter_operands(needs)
            used[t].index_put_((hs,), vecs, accumulate=True)
        return used

    def ledger_sub_clamped(self, used, t: int, needs):
        if needs:
            hs, vecs = self._scatter_operands(needs)
            row = used[t].index_select(0, hs) - vecs
            used[t].index_put_((hs,), row.clamp_min(0.0))
        return used

    def ledger_advance(self, used, steps: int):
        k = min(steps, used.shape[0])
        if k >= used.shape[0]:
            used.zero_()
        else:
            used[:-k] = used[k:].clone()   # overlapping rows: copy first
            used[-k:] = 0.0
        return used

    # ---- derived tensors ------------------------------------------------
    def free_tensor(self, used, cap: np.ndarray) -> torch.Tensor:
        return self._t(cap)[None, :, :] - used

    def price_tensor(self, used, cap: np.ndarray, u: np.ndarray,
                     L: float) -> torch.Tensor:
        # the numpy backend's clip/divide/pow sequence, op for op
        capb = self._t(cap)[None, :, :]
        pos = capb > 0
        frac = torch.where(pos, used / torch.where(pos, capb, 1.0), 0.0)
        frac = frac.clamp(0.0, 1.0)
        ub = self._t(u)[None, None, :]
        out = L * torch.pow(ub / L, frac)
        return torch.where(pos, out, ub)

    def oversubscribed(self, used, cap: np.ndarray, tol: float) -> bool:
        return bool(((used - self._t(cap)[None, :, :]) > tol).any())

    def snapshot_bundle(self, price_row, free_row, wdem, sdem, gamma):
        from ..kernels.pricing import price_bundle
        return price_bundle(price_row, free_row, wdem, sdem, gamma)

    def snapshot_bundle_batch(self, price_ops, free_ops, wdem, sdem, gamma):
        from ..kernels.pricing import price_bundle_batch
        return price_bundle_batch(price_ops, free_ops, wdem, sdem, gamma)

    # ---- policy hints ---------------------------------------------------
    def lp_solver_default(self) -> str:
        # the LP solve stays host-side float64 (branch-heavy pivot control
        # flow that decides admissions)
        return "cover_packing"
