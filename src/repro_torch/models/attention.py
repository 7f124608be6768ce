"""Grouped-query attention (GQA/MQA, with qk-norm, RoPE, sliding window)
and its ring-buffer KV cache.

The port of the JAX package's ``models/attention.py`` for the dense GQA
path. Attention takes one of two routes, chosen by the caller:

  * **prefill** (``prefill=True``, from ``lm.prefill``): the prompt's own
    q, k, v go through ``repro_torch.kernels.ops.flash_attention`` — the
    CUDA flash kernel on the card, its plain version on the CPU — while k
    and v are written into the cache. The reference instead attends over
    the whole cache; the two agree exactly when the cache starts empty
    (``pos == 0``) and holds the prompt (``S <= cache_len``): empty slots
    have position -1 and add exp(-1e30 - m) = 0 to the softmax, and the
    prompt's positions are 0..S-1, so the kernel's index masks are the
    reference's position masks. Both conditions are checked.
  * **decode and no cache**: ``grouped_attention``, plain torch ops with
    the reference's position masks, over the cache. The JAX package
    computes this in jnp outside any Pallas kernel too; the kernel's
    index-causal contract cannot express ring-buffer positions.

The cache is a dict of tensors updated IN PLACE (k, v, positions) plus a
host integer ``pos``; the reference returns a new cache instead. Keeping
``pos`` on the host leaves the ring-buffer slot arithmetic off the
device, so a decode step never waits for the card.

MLA (DeepSeek-V2, MiniCPM3) is ported in a later slice.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..kernels import ops
from .layers import RMSNorm, _param, apply_rope

NEG_INF = -1e30
Cache = Dict[str, object]


# ---------------------------------------------------------------- masking
def _bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    """Additive mask bias: (S_q, S_k) float32."""
    q = q_pos[:, None]
    k = k_pos[None, :]
    ok = (k >= 0).expand(q.shape[0], k.shape[1])  # -1: empty cache slot
    if causal:
        ok = ok & (k <= q)
    if window is not None:
        ok = ok & (k > q - window)
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


# ---------------------------------------------------------------- core attn
def grouped_attention(
    q: torch.Tensor,          # (B, S_q, H, D)
    k: torch.Tensor,          # (B, S_k, KV, D)
    v: torch.Tensor,          # (B, S_k, KV, Dv)
    q_pos: torch.Tensor,      # (S_q,)
    k_pos: torch.Tensor,      # (S_k,)
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Grouped-query attention with position masks -> (B, S_q, H, Dv).

    The reference's chunked softmax in one piece: the chunking there only
    bounds memory, and this version serves decode (S_q = 1)."""
    B, S_q, H, D = q.shape
    KV = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, S_q, KV, H // KV, D).to(torch.float32)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = s + _bias(q_pos, k_pos, causal, window)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    return o.reshape(B, S_q, H, v.shape[-1]).to(q.dtype)


# ================================================================= GQA
class GQA(nn.Module):
    """Causal self-attention. Params ``wq`` (d,H,hd), ``wk``/``wv``
    (d,KV,hd), ``wo`` (H,hd,d), and ``q_norm``/``k_norm`` (hd,) with
    qk-norm."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        hd = cfg.resolved_head_dim()
        dt = cfg.dtype("param")
        self.wq = _param((d, cfg.num_heads, hd), dt, device)
        self.wk = _param((d, cfg.num_kv_heads, hd), dt, device)
        self.wv = _param((d, cfg.num_kv_heads, hd), dt, device)
        self.wo = _param((cfg.num_heads, hd, d), dt, device)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, dt, device)
            self.k_norm = RMSNorm(hd, dt, device)

    def _project(self, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """einsum("bsd,dhk->bshk") as one (B*S, d) x (d, h*k) product."""
        d, h, k = w.shape
        return (x @ w.reshape(d, h * k).to(x.dtype)).view(*x.shape[:-1], h, k)

    def forward(
        self,
        x: torch.Tensor,                 # (B, S, d)
        positions: torch.Tensor,         # (S,) int32
        window: Optional[int] = None,
        cache: Optional[Cache] = None,
        prefill: bool = False,
    ) -> Tuple[torch.Tensor, Optional[Cache]]:
        cfg = self.cfg
        B, S, _ = x.shape
        q = self._project(self.wq, x)
        k = self._project(self.wk, x)
        v = self._project(self.wv, x)
        if cfg.qk_norm:
            q = self.q_norm(q)
            k = self.k_norm(k)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

        if prefill:
            out = self._prefill_attention(q, k, v, positions, window, cache)
        elif cache is not None:
            _write(cache, k, v, positions)
            out = grouped_attention(q, cache["k"], cache["v"], positions,
                                    cache["positions"], window=window,
                                    softcap=cfg.attn_logit_softcap)
        else:
            out = grouped_attention(q, k, v, positions, positions,
                                    window=window,
                                    softcap=cfg.attn_logit_softcap)
        H, hd, d = self.wo.shape
        y = out.reshape(B, S, H * hd) @ self.wo.reshape(H * hd, d).to(x.dtype)
        return y, cache

    def _prefill_attention(self, q, k, v, positions, window, cache):
        if cache is None or cache["pos"] != 0:
            raise ValueError("the prefill route needs an empty cache "
                             "(pos == 0)")
        if q.shape[1] > cache["k"].shape[1]:
            raise ValueError(f"prompt of {q.shape[1]} tokens exceeds the "
                             f"cache of {cache['k'].shape[1]}")
        if self.cfg.attn_logit_softcap is not None:
            raise NotImplementedError("the flash route has no logit softcap")
        if window is not None and window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        _write(cache, k, v, positions)
        return ops.flash_attention(q, k, v, causal=True, window=window or 0)


def init_gqa_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype,
                   device=None) -> Cache:
    hd = cfg.resolved_head_dim()
    shape = (batch, cache_len, cfg.num_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "positions": torch.full((cache_len,), -1, dtype=torch.int32,
                                device=device),
        "pos": 0,
    }


def _write(cache: Cache, k: torch.Tensor, v: torch.Tensor,
           positions: torch.Tensor) -> None:
    """Ring-buffer write of S new entries at ``pos % cache_len``, in place.
    The start is clamped so the S entries fit, as
    ``jax.lax.dynamic_update_slice`` clamps it."""
    cache_len = cache["k"].shape[1]
    S = k.shape[1]
    start = min(cache["pos"] % cache_len, cache_len - S)
    cache["k"][:, start:start + S] = k.to(cache["k"].dtype)
    cache["v"][:, start:start + S] = v.to(cache["v"].dtype)
    cache["positions"][start:start + S] = positions.to(torch.int32)
    cache["pos"] += S


# ================================================================= dispatch
def make_attention(cfg: ArchConfig, device=None) -> nn.Module:
    if cfg.attention == "mla":
        raise NotImplementedError(
            "MLA attention (DeepSeek-V2, MiniCPM3) is ported in a later "
            "slice of repro_torch")
    return GQA(cfg, device)


def init_attention_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype,
                         device=None) -> Cache:
    if cfg.attention == "mla":
        raise NotImplementedError(
            "the MLA cache is ported in a later slice of repro_torch")
    return init_gqa_cache(cfg, batch, cache_len, dtype, device)
