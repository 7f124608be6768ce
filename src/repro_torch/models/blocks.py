"""Transformer block and layer stack for the attention decoder.

The port of the JAX package's ``models/blocks.py`` for the dense, MoE,
MLA and vision-language families: attn (GQA or MLA) -> mlp, or attn ->
moe (+ shared experts); pre-norm, residual. The reference stacks every
layer's params on a leading L axis and scans one block over them; here
the stack is an ``nn.ModuleList`` walked by a Python loop, and each
layer's cache is its own dict (a list of them for the stack). Per-layer windows are a list of ints (or None).
Each block returns its router aux loss and the stack sums them, as the
reference's scan does.

SSM (Mamba-2), hybrid (Hymba) and cross-attention (enc-dec) blocks and
the audio frontend are ported in later slices and raise
``NotImplementedError`` here; the vision frontend is ``lm.Projector``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
from torch import nn

from ..configs.base import ArchConfig
from .attention import Cache, init_attention_cache, make_attention
from .layers import MLP, RMSNorm
from .moe import MoE

BIG_WINDOW = 2**30  # "global" sentinel for per-layer windows
#: a router aux loss: a float32 0-d tensor, or 0.0 where no layer has
#: experts (so the dense stack launches nothing to sum it)
Aux = Union[float, torch.Tensor]


def has_attention(cfg: ArchConfig) -> bool:
    return cfg.attention != "none"


def has_mlp(cfg: ArchConfig) -> bool:
    return cfg.d_ff > 0 and cfg.moe is None


def require_ported(cfg: ArchConfig) -> None:
    """Raise for the block families the port does not have yet."""
    missing = []
    if cfg.ssm is not None or cfg.hybrid or not has_attention(cfg):
        missing.append("SSM/hybrid")
    if cfg.encoder_layers:
        missing.append("encoder-decoder cross-attention")
    if cfg.frontend not in (None, "vision"):
        missing.append(f"the {cfg.frontend} frontend")
    if missing:
        raise NotImplementedError(
            f"{cfg.arch_id}: {', '.join(missing)} is ported in a later slice "
            f"of repro_torch")


# ---------------------------------------------------------------- one block
class Block(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        require_ported(cfg)
        dt = cfg.dtype("param")
        self.attn_norm = RMSNorm(cfg.d_model, dt, device)
        self.attn = make_attention(cfg, device)
        if cfg.moe is not None:
            self.ffn_norm = RMSNorm(cfg.d_model, dt, device)
            self.moe = MoE(cfg, device)
        elif has_mlp(cfg):
            self.ffn_norm = RMSNorm(cfg.d_model, dt, device)
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.activation, dt, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                window: Optional[int], cache: Optional[Cache] = None,
                prefill: bool = False
                ) -> Tuple[torch.Tensor, Aux, Optional[Cache]]:
        """Returns (x, the layer's router aux loss, cache); the aux loss
        is 0.0 in a block without experts."""
        a_out, cache = self.attn(self.attn_norm(x), positions, window=window,
                                 cache=cache, prefill=prefill)
        x = x + a_out
        aux: Aux = 0.0
        if hasattr(self, "moe"):
            m_out, aux = self.moe(self.ffn_norm(x))
            x = x + m_out
        elif hasattr(self, "mlp"):
            x = x + self.mlp(self.ffn_norm(x))
        return x, aux, cache


# ---------------------------------------------------------------- stack
def layer_windows(cfg: ArchConfig, num_layers: int,
                  override_window: Optional[int] = None
                  ) -> Optional[List[int]]:
    """Per-layer sliding windows (or None = all full)."""
    if override_window is not None:
        base = override_window
    elif cfg.sliding_window is not None:
        base = cfg.sliding_window
    else:
        return None
    w = [base] * num_layers
    if cfg.global_attn_every:
        for i in range(num_layers):
            if i % cfg.global_attn_every == 0 or i == num_layers - 1:
                w[i] = BIG_WINDOW
    return w


def init_stack_cache(cfg: ArchConfig, num_layers: int, batch: int,
                     cache_len: int, dtype, device=None) -> List[Cache]:
    return [init_attention_cache(cfg, batch, cache_len, dtype, device)
            for _ in range(num_layers)]


def apply_stack(
    layers: nn.ModuleList,
    x: torch.Tensor,
    positions: torch.Tensor,
    windows: Optional[List[int]],
    cache: Optional[List[Cache]] = None,
    prefill: bool = False,
) -> Tuple[torch.Tensor, Aux, Optional[List[Cache]]]:
    """Run the blocks in order over x. Returns (x, the layers' summed
    router aux loss, cache)."""
    aux: Aux = 0.0
    for i, block in enumerate(layers):
        x, a, _ = block(x, positions, None if windows is None else windows[i],
                        cache=None if cache is None else cache[i],
                        prefill=prefill)
        aux = aux + a
    return x, aux, cache
