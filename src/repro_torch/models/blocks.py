"""Unified block and layer stack.

The port of the JAX package's ``models/blocks.py``. One block covers
every family:
    dense / vlm / audio : attn -> mlp (GQA or MLA)
    moe                 : attn -> moe (+ shared experts)
    ssm (mamba2)        : ssd mixer only
    hybrid (hymba)      : parallel attn + ssd heads (mean-fused) -> mlp
and, in the enc-dec decoder, cross-attention to the encoder's output
after the self-attention. Pre-norm, residual. The reference stacks every
layer's params on a leading L axis and scans one block over them; here
the stack is an ``nn.ModuleList`` walked by a Python loop, and each
layer's cache is its own dict, ``{"attn": ..., "ssm": ...}`` as the
family has them (a list of them for the stack). Per-layer windows are a
list of ints (or None). Each block returns its router aux loss and the
stack sums them, as the reference's scan does. Without a cache each
block runs under ``cfg.remat`` (``torch.utils.checkpoint``), as the
reference wraps its scanned block in ``jax.checkpoint``.

The frontends are stubs in both packages: vision is ``lm.Projector`` over
patch embeddings, audio ``encdec.FrontendProj`` over frame embeddings.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..configs.base import ArchConfig
from ..obs import trace as _trace
from ..parallel.context import constrain_batch
from .attention import GQA, init_attention_cache, make_attention
from .layers import MLP, RMSNorm
from .moe import MoE
from .ssm import SSM, init_ssm_cache

BIG_WINDOW = 2**30  # "global" sentinel for per-layer windows
#: a router aux loss: a float32 0-d tensor, or 0.0 where no layer has
#: experts (so the dense stack launches nothing to sum it)
Aux = Union[float, torch.Tensor]
#: one layer's cache: {"attn": attention cache, "ssm": SSM cache}, the
#: keys its family has
LayerCache = dict


def has_attention(cfg: ArchConfig) -> bool:
    return cfg.attention != "none"


def has_ssm(cfg: ArchConfig) -> bool:
    return cfg.ssm is not None


def has_mlp(cfg: ArchConfig) -> bool:
    return cfg.d_ff > 0 and cfg.moe is None


# ---------------------------------------------------------------- one block
class Block(nn.Module):
    """Params, named as the reference's ``init_block`` tree:
    ``attn_norm``/``attn`` with attention, ``ssm_norm``/``ssm`` with an
    SSM, ``attn_out_norm``/``ssm_out_norm`` in a hybrid (whose ``ssm_norm``
    the reference creates and never reads: it is held so every leaf
    carries), ``cross_norm``/``cross_attn`` with cross-attention, and
    ``ffn_norm`` with ``moe`` or ``mlp``."""

    def __init__(self, cfg: ArchConfig, device=None,
                 cross_attention: bool = False):
        super().__init__()
        self.hybrid = cfg.hybrid
        dt = cfg.dtype("param")
        if has_attention(cfg):
            self.attn_norm = RMSNorm(cfg.d_model, dt, device)
            self.attn = make_attention(cfg, device)
        if has_ssm(cfg):
            self.ssm_norm = RMSNorm(cfg.d_model, dt, device)
            self.ssm = SSM(cfg, device)
        if cfg.hybrid:
            # per-branch output norms for mean fusion (Hymba)
            self.attn_out_norm = RMSNorm(cfg.d_model, dt, device)
            self.ssm_out_norm = RMSNorm(cfg.d_model, dt, device)
        if cross_attention:
            self.cross_norm = RMSNorm(cfg.d_model, dt, device)
            self.cross_attn = GQA(cfg, device)
        if cfg.moe is not None:
            self.ffn_norm = RMSNorm(cfg.d_model, dt, device)
            self.moe = MoE(cfg, device)
        elif has_mlp(cfg):
            self.ffn_norm = RMSNorm(cfg.d_model, dt, device)
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.activation, dt, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                window: Optional[int], cache: Optional[LayerCache] = None,
                prefill: bool = False, causal: bool = True,
                encoder_out: Optional[torch.Tensor] = None,
                encoder_positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Aux, Optional[LayerCache]]:
        """Returns (x, the layer's router aux loss, cache); the aux loss
        is 0.0 in a block without experts. ``prefill`` routes the
        self-attention and, with ``encoder_out``, the cross-attention
        through the flash kernel (``attention`` module docstring). Each
        branch's output is pinned batch-sharded before it joins the
        residual (``parallel.context.constrain_batch``: the identity but
        under the dry run's context, where it makes DTensor reduce a
        tensor-parallel partial sum there rather than carry it into the
        next norm)."""
        a_cache = None if cache is None else cache.get("attn")
        s_cache = None if cache is None else cache.get("ssm")
        if self.hybrid:
            h = self.attn_norm(x)
            with _trace.span("model.attention"):
                a_out, _ = self.attn(h, positions, window=window,
                                     cache=a_cache, prefill=prefill,
                                     causal=causal)
            s_out, _ = self.ssm(h, cache=s_cache)
            x = x + 0.5 * (self.attn_out_norm(constrain_batch(a_out))
                           + self.ssm_out_norm(constrain_batch(s_out)))
        else:
            if hasattr(self, "attn"):
                with _trace.span("model.attention"):
                    a_out, _ = self.attn(self.attn_norm(x), positions,
                                         window=window, cache=a_cache,
                                         prefill=prefill, causal=causal)
                x = x + constrain_batch(a_out)
            if hasattr(self, "ssm"):
                s_out, _ = self.ssm(self.ssm_norm(x), cache=s_cache)
                x = x + constrain_batch(s_out)

        if encoder_out is not None and hasattr(self, "cross_attn"):
            c_out, _ = self.cross_attn(
                self.cross_norm(x), positions, window=None, prefill=prefill,
                causal=False, kv_source=encoder_out,
                kv_positions=encoder_positions, use_rope=False)
            x = x + constrain_batch(c_out)

        aux: Aux = 0.0
        if hasattr(self, "moe"):
            with _trace.span("model.ffn"):
                m_out, aux = self.moe(self.ffn_norm(x))
            x = x + constrain_batch(m_out)
        elif hasattr(self, "mlp"):
            with _trace.span("model.ffn"):
                m_out = self.mlp(self.ffn_norm(x))
            x = x + constrain_batch(m_out)
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


def init_block_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype,
                     device=None) -> LayerCache:
    c: LayerCache = {}
    if has_attention(cfg):
        c["attn"] = init_attention_cache(cfg, batch, cache_len, dtype, device)
    if has_ssm(cfg):
        c["ssm"] = init_ssm_cache(cfg, batch, dtype, device)
    return c


def init_stack_cache(cfg: ArchConfig, num_layers: int, batch: int,
                     cache_len: int, dtype, device=None) -> List[LayerCache]:
    return [init_block_cache(cfg, batch, cache_len, dtype, device)
            for _ in range(num_layers)]


#: the ops whose outputs ``remat="dots"`` keeps: the 2-D matrix products
#: a ``x @ w`` dispatches to (``jax.checkpoint_policies.
#: checkpoint_dots_with_no_batch_dims``); batched products (attention's
#: einsums, the experts') are recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(block: nn.Module, policy: str):
    """``block`` under the reference's ``_remat`` policy: "none" as it is;
    "full" checkpointed (its activations dropped after the forward and
    recomputed in the backward); "dots" checkpointed keeping the outputs
    of its matrix products (``_DOTS``)."""
    if policy == "none":
        return block
    if policy == "full":
        return functools.partial(checkpoint, block, use_reentrant=False,
                                 preserve_rng_state=False)
    if policy == "dots":
        return functools.partial(
            checkpoint, block, use_reentrant=False, preserve_rng_state=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _dots_policy))
    raise ValueError(f"remat must be none, dots or full, got {policy!r}")


def apply_stack(
    layers: nn.ModuleList,
    x: torch.Tensor,
    positions: torch.Tensor,
    windows: Optional[List[int]],
    cache: Optional[List[LayerCache]] = None,
    prefill: bool = False,
    causal: bool = True,
    encoder_out: Optional[torch.Tensor] = None,
    encoder_positions: Optional[torch.Tensor] = None,
    remat: str = "none",
) -> Tuple[torch.Tensor, Aux, Optional[List[LayerCache]]]:
    """Run the blocks in order over x. Returns (x, the layers' summed
    router aux loss, cache). Without a cache each block runs under the
    ``remat`` policy (the training forward passes ``cfg.remat``; with a
    cache the reference takes "none" too). Each block's output is pinned
    batch-sharded under an activation-sharding context
    (``parallel.context.constrain_batch``; the identity otherwise)."""
    aux: Aux = 0.0
    for i, block in enumerate(layers):
        run = _remat(block, remat if cache is None else "none")
        with _trace.span("model.block", layer=i):
            x, a, _ = run(x, positions,
                          None if windows is None else windows[i],
                          cache=None if cache is None else cache[i],
                          prefill=prefill, causal=causal,
                          encoder_out=encoder_out,
                          encoder_positions=encoder_positions)
        x = constrain_batch(x)  # keep the residual stream batch-sharded
        aux = aux + a
    return x, aux, cache
