"""AdamW, the port of the JAX package's ``optim/adamw.py``: the
reference's arithmetic over tensors.

    g32   = g * clip,  clip = min(1, grad_clip / (global_norm(g) + 1e-9))
    m32   = m * b1 + (1 - b1) * g32
    v32   = v * b2 + (1 - b2) * g32**2
    delta = (m32 / bc1) / (sqrt(v32 / bc2) + eps) + weight_decay * p
    p     = p - lr * lr_scale * delta,   bc = 1 - b ** step  (float32)

in float32, the moments stored back in their dtype: the params' unless
``fp32_moments``. ``torch.optim.AdamW`` computes the same update up to
rounding (it decays the params before the step and divides by
``sqrt(bc2)`` apart), but it has no global-norm clip and rounds at other
points; this writes the reference's operations in its order.

Params, grads and moments are flat dicts of tensors by parameter name
(``dict(module.named_parameters())``). Where the reference returns new
trees, ``adamw_update`` writes the params and moments IN PLACE (the
values are the same): a full-width model's state does not fit twice.

Two routes, picked by ``route`` from the tensors alone (no option):

  * **kernel**: plain CUDA tensors, params bf16 or float32, gradients of
    the params' dtype, moments of the params' dtype or float32. The norm
    and each tensor's update run in the hand-written kernels of
    ``kernels.adamw`` (``csrc/adamw.cu``): each tensor read and written
    once, no float32 temporaries. Given the same norm they write the
    plain route's params and moments bit for bit; the norm sums the
    squares in float64, so it may differ from the plain route's by
    float32 rounding.
  * **plain**: CPU and meta tensors (the dry run's meta DTensors too), in
    torch:
    the kernels' plain version. The update runs over slabs of
    ``UPDATE_CHUNK`` elements of each tensor's flat view, and the global
    norm sums each tensor's squares in the same slabs, so no float32 copy
    of a whole tensor is made (a 256,000 x 12,288 table would need
    12.6 GB for each). The update is elementwise, so its params and
    moments are bit for bit those of one piece; a tensor of at most one
    slab sums its squares as one piece, a larger one in slab order.

Any other mix (a float16 param, a gradient of another dtype than its
param, tensors on two devices, a DTensor on the card) raises. The update
records the span ``train.adamw`` (``route``; ``elements`` and ``slabs``,
the update launches or slabs; the global norm included), and each launch
or slab ``train.adamw.slab`` (``obs.trace``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Tuple, Union

import torch

from ..kernels import adamw as _kernels
from ..obs import trace as _trace

Tensors = Mapping[str, torch.Tensor]

#: elements of a tensor updated (and squared for the norm) at a time
UPDATE_CHUNK = 1 << 26


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    fp32_moments: bool = False


def adamw_init(params: Tensors, cfg: AdamWConfig) -> Dict:
    """Zero moments beside each param, and the step counter: an int32
    0-d tensor on the params' device."""
    def mom(p):
        dt = torch.float32 if cfg.fp32_moments else p.dtype
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    device = next(iter(params.values())).device
    return {
        "m": {name: mom(p) for name, p in params.items()},
        "v": {name: mom(p) for name, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def _slabs(t: torch.Tensor, what: str) -> tuple:
    """``t``'s flat view in slabs of ``UPDATE_CHUNK`` elements. A tensor
    of at most one slab is one slab as it is, and so is a DTensor of the
    dry run's plan (its shards do not flatten; it holds no memory). A
    copy would cost the memory the slabs save, so a larger tensor that is
    not contiguous raises."""
    from torch.distributed.tensor import DTensor
    if t.numel() <= UPDATE_CHUNK or isinstance(t, DTensor):
        return (t,)
    if not t.is_contiguous():
        raise ValueError(f"{what} of shape {tuple(t.shape)} is not "
                         f"contiguous: AdamW updates its flat view in place")
    return t.view(-1).split(UPDATE_CHUNK)


def _square_sum(g: torch.Tensor) -> torch.Tensor:
    """The float32 sum of ``g``'s squares, slab by slab in order
    (``_slabs``): a tensor of one slab in one piece."""
    return sum(torch.sum(torch.square(part.to(torch.float32)))
               for part in _slabs(g, "a gradient"))


def _plain(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the plain route: a CPU or meta tensor, the dry
    run's meta DTensors among them."""
    return t.device.type in ("cpu", "meta")


def global_norm(tensors: Tensors) -> torch.Tensor:
    """sqrt of the sum of every element's square, in float32: in torch
    where every tensor takes the plain route, else in the norm kernels
    (which raise on what they do not take)."""
    if all(_plain(g) for g in tensors.values()):
        return torch.sqrt(sum(_square_sum(g) for g in tensors.values()))
    return _kernels.global_norm_cuda(tensors.values())


def route(params: Tensors, grads: Tensors, state: Dict) -> str:
    """``"plain"`` where every param, gradient and moment takes the plain
    route, ``"kernel"`` where each is a plain (not a DTensor) tensor on one
    CUDA device of dtypes the kernels take (``kernels.adamw.supported``);
    raises on any other mix."""
    from torch.distributed.tensor import DTensor
    quads = {name: (p, grads[name], state["m"][name], state["v"][name])
             for name, p in params.items()}
    if all(_plain(t) for ts in quads.values() for t in ts):
        return "plain"
    device = next(iter(params.values())).device
    for name, ts in quads.items():
        if any(isinstance(t, DTensor) for t in ts):
            raise ValueError(
                f"the AdamW kernels take plain CUDA tensors; {name!r} has a "
                f"DTensor on {device}")
        if any(_plain(t) or t.device != device for t in ts):
            raise ValueError(
                f"AdamW takes every param, gradient and moment on one CUDA "
                f"device or none; {name!r} has them on "
                f"{[str(t.device) for t in ts]}, the first param on {device}")
        if not _kernels.supported(*(t.dtype for t in ts)):
            raise ValueError(
                f"the AdamW kernel takes (param, moment) dtypes "
                f"{_kernels.PAIRS} with gradients of the param's; "
                f"{name!r} has {[t.dtype for t in ts]}")
    return "kernel"


def _update_slabs(name: str, p: torch.Tensor, g: torch.Tensor,
                  m: torch.Tensor, v: torch.Tensor, clip: torch.Tensor,
                  bc1: torch.Tensor, bc2: torch.Tensor, lr: torch.Tensor,
                  cfg: AdamWConfig) -> None:
    """The plain route's update of one param, slab by slab in place: the
    kernel's plain version."""
    b1, b2 = cfg.b1, cfg.b2
    slabs = zip(*(_slabs(x, f"{what} {name!r}")
                  for what, x in (("param", p), ("gradient", g), ("m", m),
                                  ("v", v))))
    for p_, g, m, v in slabs:
        _trace.add("elements", p_.numel())
        _trace.add("slabs", 1)
        with _trace.span("train.adamw.slab", elements=p_.numel()):
            g32 = g.to(torch.float32) * clip
            m32 = m.to(torch.float32) * b1
            m32.add_((1 - b1) * g32)
            v32 = v.to(torch.float32) * b2
            v32.add_((1 - b2) * torch.square(g32))
            del g32
            delta = (m32 / bc1).div_((v32 / bc2).sqrt_().add_(cfg.eps))
            m.copy_(m32)
            v.copy_(v32)
            del m32, v32
            delta.add_(cfg.weight_decay * p_.to(torch.float32))
            p_.copy_(p_.to(torch.float32) - lr * delta)


@torch.no_grad()
def adamw_update(params: Tensors, grads: Tensors, state: Dict,
                 cfg: AdamWConfig,
                 lr_scale: Union[float, torch.Tensor] = 1.0
                 ) -> Tuple[Tensors, Dict, Dict]:
    """One AdamW step over every param of ``params`` (``grads`` has the
    same names). Updates ``params`` and the state's moments in place and
    returns (params, {"m", "v", "step"}, {"grad_norm", "lr"})."""
    how = route(params, grads, state)
    with _trace.span("train.adamw", route=how) as sp:
        step = state["step"] + 1
        gnorm = global_norm(grads)
        clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)

        b1, b2 = cfg.b1, cfg.b2
        t = step.to(torch.float32)
        bc1 = 1.0 - torch.full((), b1, dtype=torch.float32,
                               device=t.device) ** t
        bc2 = 1.0 - torch.full((), b2, dtype=torch.float32,
                               device=t.device) ** t
        lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                      device=t.device)

        for name, p in params.items():
            g, m, v = grads[name], state["m"][name], state["v"][name]
            if how == "plain":
                _update_slabs(name, p, g, m, v, clip, bc1, bc2, lr, cfg)
                continue
            sp.add("elements", p.numel()).add("slabs", 1)
            with _trace.span("train.adamw.slab", elements=p.numel()):
                _kernels.adamw_cuda(p, g, m, v, clip, bc1, bc2, lr, b1, b2,
                                    cfg.eps, cfg.weight_decay)
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
