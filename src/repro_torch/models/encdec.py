"""Encoder-decoder model (SeamlessM4T backbone), serving half.

The port of the JAX package's ``models/encdec.py``:

    init(cfg, seed, device)                        -> params (an ``EncDec``)
    encode(cfg, params, frames, prefill)           -> enc (B, S_src, d)
    forward(cfg, params, batch)                    -> (loss, metrics) [train]
    init_cache(cfg, batch, cache_len, device)      -> decoder caches
    prefill(cfg, params, batch, cache)             -> (logits, cache, enc)
    decode_step(cfg, params, tokens, pos, cache, enc) -> (logits, cache)

Encoder: bidirectional self-attention over stub frame embeddings (the
speech frontend supplies (B, S_src, frontend_dim)), through the flash
kernel with ``causal=False`` when serving. Decoder: causal
self-attention, then cross-attention to the encoder's output (no RoPE,
nothing masked): in the prefill through the flash kernel, S_q = S_tgt
against S_k = S_src; in a decode step through ``grouped_attention``, with
K and V projected from the encoder's output again every step, as the
reference does. The training forward (``forward``, the loss) attends
through ``grouped_attention`` everywhere, encoder included: the flash
kernel has no backward.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..backend.torch_backend import resolve_device
from ..configs.base import ArchConfig
from .blocks import Block, LayerCache, apply_stack, init_stack_cache, \
    layer_windows
from .layers import Embedding, RMSNorm, _param, init_params_
from .lm import next_token_ce


class FrontendProj(nn.Module):
    """The stub frontend's projection ``w`` (frontend_dim, d_model)."""

    def __init__(self, frontend_dim: int, d_model: int, dtype, device=None):
        super().__init__()
        self.w = _param((frontend_dim, d_model), dtype, device)

    def forward(self, frames: torch.Tensor, compute_dtype) -> torch.Tensor:
        """Frames cast to the compute dtype, then ``@ w``."""
        return frames.to(compute_dtype) @ self.w.to(compute_dtype)


class EncDec(nn.Module):
    """Params, named as the reference's ``encdec.init`` tree:
    ``embed.table``, ``frontend_proj.w``, ``encoder.{i}.*`` (self-attention
    blocks), ``enc_norm.scale``, ``decoder.{i}.*`` (blocks with
    ``cross_norm``/``cross_attn``), ``final_norm.scale`` and the untied
    ``unembed.table``."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        if cfg.encoder_layers < 1:
            raise ValueError(f"{cfg.arch_id} has no encoder layers")
        dt = cfg.dtype("param")
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, dt, device)
        self.frontend_proj = FrontendProj(cfg.frontend_dim, cfg.d_model, dt,
                                          device)
        self.encoder = nn.ModuleList(Block(cfg, device)
                                     for _ in range(cfg.encoder_layers))
        self.enc_norm = RMSNorm(cfg.d_model, dt, device)
        self.decoder = nn.ModuleList(Block(cfg, device, cross_attention=True)
                                     for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.d_model, dt, device)
        self.unembed = Embedding(cfg.vocab_size, cfg.d_model, dt, device)


def init(cfg: ArchConfig, seed: int = 0, device=None) -> EncDec:
    """Random params on ``device`` (None = the CUDA card), from a
    generator on that device seeded with ``seed``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_params_(EncDec(cfg, device), gen)


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def encode(cfg: ArchConfig, params: EncDec, frames: torch.Tensor,
           prefill: bool = True) -> torch.Tensor:
    """(B, S_src, frontend_dim) frames -> (B, S_src, d) in the compute
    dtype: the projection, the encoder stack (non-causal, RoPE at
    0..S_src-1), the final encoder norm. ``prefill`` (serving) attends
    through the flash kernel; the training forward passes False and
    attends through ``grouped_attention`` with every block under
    ``cfg.remat``."""
    x = params.frontend_proj(frames, cfg.dtype("compute"))
    positions = _arange(x.shape[1], x.device)
    x, _, _ = apply_stack(params.encoder, x, positions, None,
                          prefill=prefill, causal=False,
                          remat="none" if prefill else cfg.remat)
    return params.enc_norm(x)


def forward(cfg: ArchConfig, params: EncDec,
            batch: Dict) -> Tuple[torch.Tensor, Dict]:
    """Training forward over {"frames": (B, S_src, fdim), "tokens",
    "labels": (B, S_tgt)}: the mean next-token cross-entropy of the
    decoder (no aux weight: the reference returns ``ce`` as the loss).
    Returns (loss, {"ce", "aux", "tokens"})."""
    enc = encode(cfg, params, batch["frames"], prefill=False)
    x = params.embed.embed(batch["tokens"], cfg.dtype("compute"))
    positions = _arange(x.shape[1], x.device)
    x, aux, _ = apply_stack(
        params.decoder, x, positions, None, encoder_out=enc,
        encoder_positions=_arange(enc.shape[1], enc.device),
        remat=cfg.remat)
    logits = params.unembed.unembed(params.final_norm(x))
    ce, denom = next_token_ce(logits, batch["labels"])
    aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
    return ce, {"ce": ce, "aux": aux, "tokens": denom}


def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               device=None) -> List[LayerCache]:
    return init_stack_cache(cfg, cfg.num_layers, batch, cache_len,
                            cfg.dtype("compute"), resolve_device(device))


def prefill(
    cfg: ArchConfig,
    params: EncDec,
    batch: Dict,
    cache: List[LayerCache],
    window_override: Optional[int] = None,
) -> Tuple[torch.Tensor, List[LayerCache], torch.Tensor]:
    """Encode ``batch["frames"]``, then run the target prompt
    ``batch["tokens"]`` through the decoder, filling the (empty) cache.
    Returns (last-position logits (B, 1, V), cache, enc)."""
    enc = encode(cfg, params, batch["frames"])
    x = params.embed.embed(batch["tokens"], cfg.dtype("compute"))
    positions = _arange(x.shape[1], x.device)
    x, _, cache = apply_stack(
        params.decoder, x, positions,
        layer_windows(cfg, cfg.num_layers, window_override), cache=cache,
        prefill=True, encoder_out=enc,
        encoder_positions=_arange(enc.shape[1], enc.device))
    x = params.final_norm(x[:, -1:])
    return params.unembed.unembed(x), cache, enc


def decode_step(
    cfg: ArchConfig,
    params: EncDec,
    tokens: torch.Tensor,           # (B, 1)
    pos: int,                       # absolute target position
    cache: List[LayerCache],
    enc: torch.Tensor,              # (B, S_src, d)
    window_override: Optional[int] = None,
) -> Tuple[torch.Tensor, List[LayerCache]]:
    """One decode step: (B, 1) tokens -> (B, 1, V) logits, cache updated
    in place."""
    x = params.embed.embed(tokens, cfg.dtype("compute"))
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    x, _, cache = apply_stack(
        params.decoder, x, positions,
        layer_windows(cfg, cfg.num_layers, window_override), cache=cache,
        encoder_out=enc, encoder_positions=_arange(enc.shape[1], enc.device))
    x = params.final_norm(x)
    return params.unembed.unembed(x), cache
