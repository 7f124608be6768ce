"""Decoder-only language model: init, the training loss, cache, prefill,
decode.

The port of the JAX package's ``models/lm.py`` for every decoder-only
family (dense, MoE, MLA, SSM, hybrid, vision-language):

    init(cfg, seed, device)                    -> params (an ``LM`` module)
    forward(cfg, params, batch)                -> (loss, metrics)  [train]
    init_cache(cfg, batch, cache_len, device)  -> per-layer caches
    prefill(cfg, params, batch, cache)         -> (last logits, cache)
    decode_step(cfg, params, tokens, pos, cache) -> (logits, cache)
    compute_params(cfg, params)                -> params for the forward

``batch`` is a dict {"tokens": (B, S) integer tensor}, plus
{"image_embeds": (B, N, frontend_dim)} for the vision configs: the
frontend is a stub over precomputed patch embeddings, and the projector
maps them to N image tokens that go before the text. The training batch
adds {"labels": (B, S)}, with ``IGNORE`` (-100) as the ignore index.

``init`` allocates every parameter on the requested device and fills it
there with an explicit generator: a full-width model never passes
through host memory. The final norm and the logits record the span
``model.head`` (``obs.trace``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..backend.torch_backend import resolve_device
from ..configs.base import ArchConfig
from ..obs import trace as _trace
from ..parallel.context import constrain_batch, gather_last
from .blocks import Block, LayerCache, apply_stack, init_stack_cache, \
    layer_windows
from .layers import Embedding, RMSNorm, _param, init_params_

#: the labels' ignore index
IGNORE = -100

class Projector(nn.Module):
    """LLaVA's 2-layer projector from the vision hidden to d_model:
    ``gelu(img @ w1) @ w2`` in the compute dtype, with the tanh-approximate
    gelu (``jax.nn.gelu``'s default)."""

    def __init__(self, frontend_dim: int, d_model: int, dtype, device=None):
        super().__init__()
        self.w1 = _param((frontend_dim, d_model), dtype, device)
        self.w2 = _param((d_model, d_model), dtype, device)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        h = F.gelu(img @ self.w1.to(img.dtype), approximate="tanh")
        return h @ self.w2.to(img.dtype)


class LM(nn.Module):
    """Params, named as the reference's tree: ``embed.table``,
    ``layers.{i}.{attn_norm,attn,ffn_norm,mlp}.*`` (MoE:
    ``layers.{i}.moe.{router,w_gate,w_up,w_down,shared.*}`` in place of
    ``mlp``; MLA: ``layers.{i}.attn.{w_dq,q_norm,w_uq,w_dkv,kv_norm,w_uk,
    w_uv,wo}``; SSM: ``layers.{i}.{ssm_norm,ssm}.*`` in place of the
    attention, and a hybrid has both plus ``attn_out_norm`` and
    ``ssm_out_norm``), ``final_norm.scale``, untied ``unembed.table``, and
    for the vision frontend ``projector.{w1,w2}``."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        dt = cfg.dtype("param")
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, dt, device)
        self.layers = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.d_model, dt, device)
        if not cfg.tie_embeddings:
            self.unembed = Embedding(cfg.vocab_size, cfg.d_model, dt, device)
        if cfg.frontend == "vision":
            self.projector = Projector(cfg.frontend_dim, cfg.d_model, dt,
                                       device)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        table = self.embed if self.cfg.tie_embeddings else self.unembed
        return table.unembed(x, self.cfg.attn_logit_softcap)


def param_device(params: nn.Module) -> torch.device:
    return next(params.parameters()).device


def init(cfg: ArchConfig, seed: int = 0, device=None) -> LM:
    """Random params on ``device`` (None = the CUDA card), from a
    generator on that device seeded with ``seed``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_params_(LM(cfg, device), gen)


#: params the forward reads as they are stored, by the leaf name after the
#: last ".": norm scales (the norm reads them in float32), the float32
#: router (the reference computes ``xg.astype(f32) @ router``; a cast
#: router would route otherwise) and the SSM's float32 ``A_log``, ``D``
#: and ``dt_bias`` (never cast in the reference)
UNCAST = frozenset({"scale", "router", "A_log", "D", "dt_bias"})


def compute_params(cfg: ArchConfig, params: nn.Module) -> nn.Module:
    """``params`` (an ``LM`` or an ``encdec.EncDec``) with every matrix
    and embedding table cast once to the compute dtype; the ``UNCAST``
    params stay as they are. The forward computes ``x @ w.to(x.dtype)``
    either way, so the numbers are the same; the copy saves a cast of
    every weight on every step. Returns ``params`` itself when nothing
    needs a cast."""
    cdt = cfg.dtype("compute")
    state = params.state_dict()
    cast = {name for name, t in state.items()
            if name.rsplit(".", 1)[-1] not in UNCAST and t.dtype != cdt}
    if not cast:
        return params
    out = type(params)(cfg, device="meta")
    out.load_state_dict({name: t.to(cdt) if name in cast else t
                         for name, t in state.items()}, assign=True)
    return out


def _embed_inputs(cfg: ArchConfig, params: LM, batch: Dict) -> torch.Tensor:
    """The tokens' embeddings (B, S, d), with the projected image tokens
    first where the batch carries ``image_embeds``."""
    cdt = cfg.dtype("compute")
    x = params.embed.embed(batch["tokens"], cdt)
    if cfg.frontend == "vision" and "image_embeds" in batch:
        img_tok = params.projector(batch["image_embeds"].to(cdt))
        x = torch.cat([img_tok, x], dim=1)
    return x


def next_token_ce(logits: torch.Tensor, labels: torch.Tensor):
    """The mean next-token cross-entropy over the labels that are not
    ``IGNORE``, in float32: (ce, tokens counted, at least 1).

    The reference computes the negative log-likelihood as a one-hot
    contraction (``ce_impl="onehot"``, so that a vocab-sharded TPU mesh
    need not gather the logits) or by ``take_along_axis`` ("gather").
    Both are a gather here: the one-hot sum is V - 1 exact zeros and one
    finite term, which is that term bit for bit, and at Gemma's vocabulary
    the one-hot would be an 8.4 GB float32 tensor of its own."""
    logp = torch.log_softmax(logits.to(torch.float32)[:, :-1], dim=-1)
    targets = labels[:, 1:]
    mask = targets != IGNORE
    tgt = torch.where(mask, targets, 0).to(torch.int64)
    # pinned batch-sharded under the dry run's context, so the gradient
    # coming back from the sum is split by batch before it is scattered
    nll = constrain_batch(-gather_last(logp, tgt[..., None])[..., 0])
    denom = torch.clamp(mask.sum(), min=1)
    ce = torch.where(mask, nll, 0.0).sum() / denom
    return ce, denom


def forward(cfg: ArchConfig, params: LM,
            batch: Dict) -> Tuple[torch.Tensor, Dict]:
    """Training forward: the mean next-token cross-entropy plus the MoE
    aux loss, ``ce + router_aux_weight * aux / num_layers``. Returns
    (loss, {"ce", "aux", "tokens"}). Image tokens go first, their labels
    ``IGNORE``. Every block runs under ``cfg.remat`` and attends through
    ``grouped_attention`` (no flash: the kernel has no backward), as the
    reference's training forward does. The embedding and the logits are
    pinned batch-sharded under an activation-sharding context
    (``parallel.context``; the identity otherwise)."""
    x = constrain_batch(_embed_inputs(cfg, params, batch))
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    windows = layer_windows(cfg, cfg.num_layers)
    x, aux, _ = apply_stack(params.layers, x, positions, windows,
                            remat=cfg.remat)
    with _trace.span("model.head"):
        logits = constrain_batch(params.logits(params.final_norm(x)))

    labels = batch["labels"]
    if cfg.frontend == "vision" and "image_embeds" in batch:
        n_img = batch["image_embeds"].shape[1]
        pad = torch.full((labels.shape[0], n_img), IGNORE,
                         dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    ce, denom = next_token_ce(logits, labels)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
    aux_w = cfg.moe.router_aux_weight if cfg.moe is not None else 0.0
    loss = ce + aux_w * aux / max(cfg.num_layers, 1)
    return loss, {"ce": ce, "aux": aux, "tokens": denom}


def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               device=None) -> List[LayerCache]:
    return init_stack_cache(cfg, cfg.num_layers, batch, cache_len,
                            cfg.dtype("compute"), resolve_device(device))


def prefill(
    cfg: ArchConfig,
    params: LM,
    batch: Dict,
    cache: List[LayerCache],
    window_override: Optional[int] = None,
) -> Tuple[torch.Tensor, List[LayerCache]]:
    """Run the prompt (image tokens first, where given) through the stack,
    filling the (empty) cache at positions 0..S-1; GQA attends through the
    flash kernel, MLA over its latent cache, the SSM through the chunked
    SSD from a zero state. Returns (last-position logits (B, 1, V),
    cache)."""
    x = _embed_inputs(cfg, params, batch)
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    windows = layer_windows(cfg, cfg.num_layers, window_override)
    x, _, cache = apply_stack(params.layers, x, positions, windows,
                              cache=cache, prefill=True)
    with _trace.span("model.head"):
        return params.logits(params.final_norm(x[:, -1:])), cache


def decode_step(
    cfg: ArchConfig,
    params: LM,
    tokens: torch.Tensor,           # (B, 1)
    pos: int,                       # absolute position
    cache: List[LayerCache],
    window_override: Optional[int] = None,
) -> Tuple[torch.Tensor, List[LayerCache]]:
    """One decode step: (B, 1) tokens -> (B, 1, V) logits, cache updated
    in place."""
    x = params.embed.embed(tokens, cfg.dtype("compute"))
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    windows = layer_windows(cfg, cfg.num_layers, window_override)
    x, _, cache = apply_stack(params.layers, x, positions, windows,
                              cache=cache)
    with _trace.span("model.head"):
        return params.logits(params.final_norm(x)), cache
