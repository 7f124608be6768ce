"""The model's entry points to the two model kernels, routed by device.

A wrapper given CPU tensors runs the kernel's plain torch version; given
CUDA tensors it launches the hand-written kernel or raises. Nothing falls
back from the card to the plain version. Meta tensors (the dry run's
trace, ``launch.dryrun``) carry no data and never reach a card: they go
to the plain version too, which computes the kernel's output shape (and,
for attention, holds the (S_q, S_k) scores that the kernel never does).
``rmsnorm`` is differentiable on both: on the CPU autograd
differentiates the plain version, on the card
``rmsnorm.RMSNormFn`` runs the backward kernel (which raises in turn). The
flash kernel has no backward: the training forward attends through
``models.attention.grouped_attention``, as the reference's does.

    rmsnorm(x (..., d), scale (d,))                 -> (..., d)
    flash_attention(q (B,S_q,H,D), k, v (B,S_k,KV,D)) -> (B,S_q,H,D)

The counterparts of the JAX package's ``repro.kernels.ops`` wrappers. The
attention kernel reads the model's layout and maps each query head to its
kv head itself, so unlike the JAX wrapper no (B*H, S, D) transpose and no
broadcast of the kv heads is made, and any sequence length is taken.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import flash_attention as _fa
from . import rmsnorm as _rn

#: device types that take the plain versions
_PLAIN = ("cpu", "meta")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis of x, any leading dims."""
    if x.device.type == "meta":
        # row by row, x's leading dims kept: the dry run's DTensors cannot
        # always merge them (a batch and a head split)
        return _rn.rmsnorm_torch(x, scale, eps)
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    if x2.device.type == "cpu":
        out = _rn.rmsnorm_torch(x2, scale, eps)
    else:
        out = _rn.RMSNormFn.apply(x2.contiguous(), scale, eps)
    return out.reshape(x.shape)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Attention with index-based causal/window masks (see
    ``repro_torch.kernels.flash_attention``)."""
    if q.device.type in _PLAIN:
        return _fa.flash_attention_torch(q, k, v, causal, window, sm_scale)
    return _fa.flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal, window, sm_scale)
