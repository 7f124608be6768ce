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
held to ``cache_len``.

The dry run's spec helpers: ``Model.init_abstract()`` (the params on the
meta device), ``input_specs(cfg, shape)`` (the batch of an input shape
as meta tensors, the counterpart of ``ShapeDtypeStruct``),
``serve_state_specs(cfg, shape)`` (the decode-time serve state on meta),
``decode_window`` and ``concrete_batch`` (a random batch of those
shapes). Meta tensors carry shapes and dtypes and no storage, so a
full-size model is planned without allocating it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..backend.torch_backend import resolve_device
from ..configs.base import ArchConfig, InputShape
from . import encdec, lm
from .blocks import has_attention

META = torch.device("meta")


def _decode_window(cfg: ArchConfig, shape: InputShape) -> Optional[int]:
    """Effective window override for decode shapes: long_500k caps every
    layer (full-attention and hybrid global layers too) at the
    long-context window; other shapes take none."""
    if shape.name == "long_500k":
        return cfg.long_context_window
    return None


def _cache_len(cfg: ArchConfig, shape: InputShape) -> int:
    if cfg.ssm is not None and cfg.attention == "none":
        return 1  # attention-free: no KV cache
    w = _decode_window(cfg, shape)
    if w is not None:
        return min(shape.seq_len, w)
    return shape.seq_len


class Model:
    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.is_encdec = cfg.encoder_layers > 0

    # ---------------- params ----------------
    def init(self, seed: int = 0, device=None) -> nn.Module:
        return (encdec.init if self.is_encdec else lm.init)(self.cfg, seed,
                                                            device)

    def init_abstract(self) -> nn.Module:
        """The params module on the meta device: every name, shape and
        dtype, no storage and no draw (the dry run's)."""
        cls = encdec.EncDec if self.is_encdec else lm.LM
        return cls(self.cfg, device=META)

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
                window_override: Optional[int] = None,
                state: Optional[Dict] = None) -> Tuple[torch.Tensor, Dict]:
        """(last-position logits, serve state) of the prompt. ``state`` is
        an empty serve state of ``cache_len`` to fill (the dry run passes
        one placed on its mesh); None makes one on the params' device."""
        cfg = self.cfg
        B, S = batch["tokens"].shape
        if cfg.frontend == "vision" and "image_embeds" in batch:
            S += batch["image_embeds"].shape[1]
        if has_attention(cfg) and S > cache_len:
            raise ValueError(f"prompt of {S} tokens exceeds the cache of "
                             f"{cache_len}")
        device = lm.param_device(params)
        if self.is_encdec:
            if state is None:
                state = self.init_serve_state(B, cache_len,
                                              batch["frames"].shape[1],
                                              device)
            logits, cache, enc = encdec.prefill(cfg, params, batch,
                                                state["cache"],
                                                window_override)
            return logits, {"cache": cache, "enc": enc, "pos": S}
        if state is None:
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


# ====================================================================
# input specs (meta stand-ins; the dry run's contract)
# ====================================================================
def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ArchConfig, shape: InputShape) -> Dict:
    """The batch of a train / prefill shape as meta tensors; for a decode
    shape the (tokens,) of ONE decode step (pair it with
    ``serve_state_specs``). The enc-dec config splits S into S // 2
    frames and S // 2 target tokens; the vision config puts ``n_img =
    min(frontend_tokens, S - 1)`` image embeddings before S - n_img text
    tokens."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    f = cfg.dtype("compute")

    if shape.kind == "decode":
        return {"tokens": _spec((B, 1), i32)}

    if cfg.encoder_layers > 0:
        s_src, s_tgt = S // 2, S // 2
        spec = {"frames": _spec((B, s_src, cfg.frontend_dim), f),
                "tokens": _spec((B, s_tgt), i32)}
        if shape.kind == "train":
            spec["labels"] = _spec((B, s_tgt), i32)
        return spec

    if cfg.frontend == "vision":
        n_img = min(cfg.frontend_tokens, S - 1)
        s_text = S - n_img
        spec = {"tokens": _spec((B, s_text), i32),
                "image_embeds": _spec((B, n_img, cfg.frontend_dim), f)}
        if shape.kind == "train":
            spec["labels"] = _spec((B, s_text), i32)
        return spec

    spec = {"tokens": _spec((B, S), i32)}
    if shape.kind == "train":
        spec["labels"] = _spec((B, S), i32)
    return spec


def serve_state_specs(cfg: ArchConfig, shape: InputShape) -> Dict:
    """The decode-time serve state on meta (caches of ``_cache_len``; the
    enc-dec state also the encoder's output over S // 2 frames)."""
    src_len = shape.seq_len // 2 if cfg.encoder_layers > 0 else 0
    return build_model(cfg).init_serve_state(
        shape.global_batch, _cache_len(cfg, shape), src_len, device=META)


def decode_window(cfg: ArchConfig, shape: InputShape) -> Optional[int]:
    return _decode_window(cfg, shape)


def concrete_batch(cfg: ArchConfig, shape: InputShape, seed: int = 0,
                   device=None) -> Dict:
    """A random batch of ``input_specs``' shapes and dtypes on ``device``
    (None = the CUDA card), drawn in order from one generator seeded with
    ``seed``: token ids uniform in [0, vocab), embeddings standard normal
    drawn in float32 and cast."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, s in input_specs(cfg, shape).items():
        if s.dtype.is_floating_point:
            out[name] = torch.randn(s.shape, generator=gen, device=device,
                                    dtype=torch.float32).to(s.dtype)
        else:
            out[name] = torch.randint(0, cfg.vocab_size, s.shape,
                                      generator=gen, device=device,
                                      dtype=s.dtype)
    return out
