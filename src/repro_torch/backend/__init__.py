"""Array backend contract for the (T, H, R) ledger and Q_h^r pricing.

The scheduler's per-admission array work — repricing the whole ledger
(Eq. 12), the per-machine free-capacity and head-room vectors, the
ledger scatters of commit/release — runs behind this contract, so the
host decision logic (LP pivots, rounding draws, greedy repair) is the
same code whatever holds the ledger.

The port has one implementation, ``TorchBackend``: the ledger is a
float64 ``torch.Tensor`` on an explicit ``torch.device``. There is no
silent fallback: ``get_backend(None)`` resolves to the CUDA card and
raises ``RuntimeError`` when there is none; only a caller that asks for
``device="cpu"`` gets the CPU (the tests do).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class ArrayBackend:
    """Contract for ledger/pricing array operations.

    The ledger array itself is owned by ``Cluster`` and passed in/out of
    every mutating op; a backend holds only where the arrays live."""

    name = "abstract"
    #: True when the ledger array lives off-host (callers must route host
    #: reads through ``to_host`` / the version-cached host mirrors).
    is_device = False

    # ---- array lifecycle ------------------------------------------------
    def zeros(self, shape):
        """A fresh all-zero ledger array of the backend's native type."""
        raise NotImplementedError

    def to_host(self, arr) -> np.ndarray:
        """The array as a host ``np.ndarray`` (a device sync: call only at
        the documented sync points)."""
        raise NotImplementedError

    # ---- ledger mutations (Algorithm 1 step 3 and its inverses) ---------
    def ledger_add(self, used, t: int, needs):
        """rho[t, h] += need for every (h, need (R,)) pair in ``needs``."""
        raise NotImplementedError

    def ledger_sub_clamped(self, used, t: int, needs):
        """rho[t, h] -= need, clamped at zero (double-release guard)."""
        raise NotImplementedError

    def ledger_advance(self, used, steps: int):
        """Slide the ledger ``steps`` rows toward t=0, zero-filling the
        tail (rolling-horizon mode; see ``Cluster.advance``)."""
        raise NotImplementedError

    # ---- derived tensors ------------------------------------------------
    def free_tensor(self, used, cap: np.ndarray):
        """C - rho as a full (T, H, R) tensor on the backend's device."""
        raise NotImplementedError

    def price_tensor(self, used, cap: np.ndarray, u: np.ndarray, L: float):
        """Q_h^r over the whole ledger: the (T, H, R) price tensor of
        Eq. (12), ``L * (U^r/L) ** clip(rho/C, 0, 1)`` with zero-capacity
        resources pinned at their ceiling U^r."""
        raise NotImplementedError

    def oversubscribed(self, used, cap: np.ndarray, tol: float) -> bool:
        """True if any ledger cell exceeds capacity by more than tol."""
        raise NotImplementedError

    def snapshot_bundle(self, price_row, free_row, wdem: np.ndarray,
                        sdem: np.ndarray, gamma: float):
        """The five per-machine decision vectors a ``PriceSnapshot``
        needs, reduced from one slot's (H, R) price/free matrices:
        (wprice, sprice, coloc, max_w, max_s) as host float64 arrays."""
        raise NotImplementedError

    def snapshot_bundle_batch(self, price_ops, free_ops, wdem: np.ndarray,
                              sdem: np.ndarray, gamma: float):
        """Fused form of ``snapshot_bundle`` over a (W, H, R) slot stack:
        five (W, H) host float64 arrays, one row per slot, from one
        reduction and one host copy."""
        raise NotImplementedError

    # ---- policy hints ---------------------------------------------------
    def lp_solver_default(self) -> str:
        """Preferred external-LP dispatch when ``SubproblemConfig.lp_solver``
        is None: "cover_packing" (the structure-aware exact-replay solver,
        bit-identical to the stacked simplex) or "simplex". The LP solve is
        host-side float64 control flow."""
        return "cover_packing"


def get_backend(spec: Optional[ArrayBackend] = None,
                device=None) -> ArrayBackend:
    """Resolve a backend: an instance passes through; None builds a
    ``TorchBackend`` on ``device`` (None means the CUDA card, and raises
    when there is none)."""
    if isinstance(spec, ArrayBackend):
        return spec
    if spec is not None:
        raise TypeError(f"backend must be an ArrayBackend or None, "
                        f"got {spec!r}")
    from .torch_backend import TorchBackend
    return TorchBackend(device)


__all__ = ["ArrayBackend", "get_backend"]
