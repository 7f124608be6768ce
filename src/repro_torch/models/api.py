"""Unified model facade for training and serving.

The port of the JAX package's ``models/api.py``. ``Model`` wraps the
decoder-only LM and the enc-dec (SeamlessM4T) backbone behind one
interface:

    model = build_model(cfg)
    params = model.init(seed, device)            # an LM or EncDec module
    loss, metrics = model.train_loss(params, batch)
    logits, state = model.prefill(params, batch, cache_len)
    logits, state = model.decode(params, tokens, state)

``batch`` is {"tokens"} plus, for the vision configs, {"image_embeds"}
and, for the enc-dec config, {"frames"} (B, S_src, frontend_dim); a
training batch adds {"labels"}.
``state`` is {"cache": per-layer caches, "pos": host int} (enc-dec also
{"enc": the encoder's output}), where ``pos`` counts the image tokens
but not the frames; ``decode`` updates the caches in place. An
attention-free config (Mamba-2) keeps no KV cache, so its prompt is not
held to ``cache_len``. The dry-run spec helpers (``input_specs``,
``serve_state_specs``, ``concrete_batch``) come with a later slice.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..backend.torch_backend import resolve_device
from ..configs.base import ArchConfig
from . import encdec, lm
from .blocks import has_attention


class Model:
    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.is_encdec = cfg.encoder_layers > 0

    # ---------------- params ----------------
    def init(self, seed: int = 0, device=None) -> nn.Module:
        return (encdec.init if self.is_encdec else lm.init)(self.cfg, seed,
                                                            device)

    # ---------------- train ----------------
    def train_loss(self, params: nn.Module,
                   batch: Dict) -> Tuple[torch.Tensor, Dict]:
        """(loss, {"ce", "aux", "tokens"}) of ``lm.forward`` or
        ``encdec.forward``, differentiable on the card and on the CPU."""
        fwd = encdec.forward if self.is_encdec else lm.forward
        return fwd(self.cfg, params, batch)

    # ---------------- serve ----------------
    def init_serve_state(self, batch_size: int, cache_len: int,
                         src_len: int = 0, device=None) -> Dict:
        cfg = self.cfg
        if self.is_encdec:
            return {"cache": encdec.init_cache(cfg, batch_size, cache_len,
                                               device),
                    "enc": torch.zeros((batch_size, src_len, cfg.d_model),
                                       dtype=cfg.dtype("compute"),
                                       device=resolve_device(device)),
                    "pos": 0}
        return {"cache": lm.init_cache(cfg, batch_size, cache_len, device),
                "pos": 0}

    @torch.no_grad()
    def prefill(self, params: nn.Module, batch: Dict, cache_len: int,
                window_override: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict]:
        cfg = self.cfg
        B, S = batch["tokens"].shape
        if cfg.frontend == "vision" and "image_embeds" in batch:
            S += batch["image_embeds"].shape[1]
        if has_attention(cfg) and S > cache_len:
            raise ValueError(f"prompt of {S} tokens exceeds the cache of "
                             f"{cache_len}")
        device = lm.param_device(params)
        if self.is_encdec:
            state = self.init_serve_state(B, cache_len,
                                          batch["frames"].shape[1], device)
            logits, cache, enc = encdec.prefill(cfg, params, batch,
                                                state["cache"],
                                                window_override)
            return logits, {"cache": cache, "enc": enc, "pos": S}
        state = self.init_serve_state(B, cache_len, device=device)
        logits, cache = lm.prefill(cfg, params, batch, state["cache"],
                                   window_override)
        return logits, {"cache": cache, "pos": S}

    @torch.no_grad()
    def decode(self, params: nn.Module, tokens: torch.Tensor, state: Dict,
               window_override: Optional[int] = None
               ) -> Tuple[torch.Tensor, Dict]:
        if self.is_encdec:
            logits, cache = encdec.decode_step(
                self.cfg, params, tokens, state["pos"], state["cache"],
                state["enc"], window_override)
            return logits, {"cache": cache, "enc": state["enc"],
                            "pos": state["pos"] + 1}
        logits, cache = lm.decode_step(self.cfg, params, tokens,
                                       state["pos"], state["cache"],
                                       window_override)
        return logits, {"cache": cache, "pos": state["pos"] + 1}


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
