"""Core layers: RMSNorm, RoPE, gated MLP, embeddings, and their init.

The port of the JAX package's ``models/layers.py`` as ``nn.Module``s. A
module's parameters keep the JAX tree's names and layouts (``scale``,
``w_gate``/``w_up``/``w_down``, ``table``), so ``repro_torch.convert``
maps a JAX param tree onto them name for name. Weights are stored in the
parameter dtype and read as ``w.to(x.dtype)`` (``x @ w.astype(x.dtype)``
in the reference); ``repro_torch.models.lm.compute_params`` keeps a cast
copy so serving does not cast on every call. RMSNorm goes through
``repro_torch.kernels.ops.rmsnorm``: the CUDA kernel on the card, its
plain version on the CPU.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from ..parallel.context import rows_of

EMBED_STD = 0.02


# ---------------------------------------------------------------- init utils
def trunc_normal_(t: torch.Tensor, std: float,
                  gen: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place with a normal truncated at +-2 (in units of the
    standard normal), times ``std``: ``jax.random.truncated_normal(-2, 2)
    * std``, on ``t``'s device."""
    return nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                 generator=gen).mul_(std)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------- rmsnorm
class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype=torch.float32, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones((d,), dtype=dtype, device=device))

    def forward(self, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        return ops.rmsnorm(x, self.scale, eps)


# ---------------------------------------------------------------- rope
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)             # (hd/2,)
    angles = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., :, None, :]                   # (.., S, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- gated mlp
ACTIVATIONS = ("silu", "geglu", "gelu")


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, activation: str,
                 dtype=torch.float32, device=None):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(activation)
        self.activation = activation
        self.w_gate = _param((d_model, d_ff), dtype, device)
        self.w_up = _param((d_model, d_ff), dtype, device)
        self.w_down = _param((d_ff, d_model), dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = x @ self.w_gate.to(x.dtype)
        up = x @ self.w_up.to(x.dtype)
        if self.activation == "silu":
            act = F.silu(gate)
        else:                      # geglu and gelu: tanh-approximate gelu
            act = F.gelu(gate, approximate="tanh")
        return (act * up) @ self.w_down.to(x.dtype)


# ---------------------------------------------------------------- embedding
class Embedding(nn.Module):
    def __init__(self, vocab: int, d_model: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.table = _param((vocab, d_model), dtype, device)

    def embed(self, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
        return rows_of(self.table.to(compute_dtype), tokens)

    def unembed(self, x: torch.Tensor,
                softcap: Optional[float] = None) -> torch.Tensor:
        logits = x @ self.table.to(x.dtype).T
        if softcap is not None:
            logits = softcap * torch.tanh(logits / softcap)
        return logits


def init_params_(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Fill every parameter of ``module`` in place with the reference's
    distributions, drawn in float32: norm scales 1, embedding tables
    truncated normal x 0.02, every other weight truncated normal x
    1/sqrt(fan-in). The fan-in is the weight's first axis (the
    reference's ``dense_init(..., in_axis=0)``) unless its module's
    ``fan_in_axis`` names another: the experts' ``in_axis=1``. A param
    that its module's ``constant_init`` names is filled with that value
    (the SSM's ``conv_b``, ``A_log``, ``D``, ``dt_bias``)."""
    with torch.no_grad():
        for mod in module.modules():
            axes = getattr(mod, "fan_in_axis", {})
            consts = getattr(mod, "constant_init", {})
            for name, p in mod.named_parameters(recurse=False):
                if name in consts:
                    p.fill_(consts[name])
                elif name == "scale":
                    p.fill_(1.0)
                elif name == "table":
                    _fill(p, EMBED_STD, gen)
                else:
                    fan_in = p.shape[axes.get(name, 0)]
                    _fill(p, 1.0 / math.sqrt(fan_in), gen)
    return module


#: elements drawn at a time for a param stored below float32
DRAW_CHUNK = 1 << 26


def _fill(p: torch.Tensor, std: float, gen: torch.Generator) -> None:
    """``trunc_normal_`` in float32; a param stored in another dtype is
    drawn in float32 and cast, as the reference's ``dense_init`` casts,
    ``DRAW_CHUNK`` elements at a time so the float32 draw of a large
    bf16 expert stack needs no float32 copy of it."""
    if p.dtype == torch.float32:
        trunc_normal_(p, std, gen)
        return
    for part in p.view(-1).split(DRAW_CHUNK):
        part.copy_(trunc_normal_(torch.empty(part.shape, dtype=torch.float32,
                                             device=part.device), std, gen))
