"""Unified model facade for serving.

The port of the JAX package's ``models/api.py``:

    model = build_model(cfg)
    params = model.init(seed, device)                   # an LM module
    logits, state = model.prefill(params, batch, cache_len)
    logits, state = model.decode(params, tokens, state)

``batch`` is {"tokens"} plus, for the vision configs, {"image_embeds"};
``state`` is {"cache": per-layer caches, "pos": host int}, where ``pos``
counts the image tokens; ``decode`` updates the caches in place. The
training loss (``train_loss``), the enc-dec backbone and the dry-run spec
helpers (``input_specs``, ``serve_state_specs``, ``concrete_batch``)
come with later slices.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from . import lm
from .blocks import require_ported


class Model:
    def __init__(self, cfg: ArchConfig):
        require_ported(cfg)
        self.cfg = cfg

    # ---------------- params ----------------
    def init(self, seed: int = 0, device=None) -> lm.LM:
        return lm.init(self.cfg, seed, device)

    # ---------------- serve ----------------
    def init_serve_state(self, batch_size: int, cache_len: int,
                         device=None) -> Dict:
        return {"cache": lm.init_cache(self.cfg, batch_size, cache_len,
                                       device),
                "pos": 0}

    @torch.no_grad()
    def prefill(self, params: lm.LM, batch: Dict, cache_len: int,
                window_override: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict]:
        B, S = batch["tokens"].shape
        if self.cfg.frontend == "vision" and "image_embeds" in batch:
            S += batch["image_embeds"].shape[1]
        if S > cache_len:
            raise ValueError(f"prompt of {S} tokens exceeds the cache of "
                             f"{cache_len}")
        state = self.init_serve_state(B, cache_len, lm.param_device(params))
        logits, cache = lm.prefill(self.cfg, params, batch, state["cache"],
                                   window_override)
        return logits, {"cache": cache, "pos": S}

    @torch.no_grad()
    def decode(self, params: lm.LM, tokens: torch.Tensor, state: Dict,
               window_override: Optional[int] = None
               ) -> Tuple[torch.Tensor, Dict]:
        logits, cache = lm.decode_step(self.cfg, params, tokens,
                                       state["pos"], state["cache"],
                                       window_override)
        return logits, {"cache": cache, "pos": state["pos"] + 1}


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
