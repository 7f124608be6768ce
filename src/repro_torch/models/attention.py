"""Attention: grouped-query attention (GQA/MQA, with qk-norm, RoPE,
sliding window), multi-head latent attention (MLA: DeepSeek-V2,
MiniCPM3), cross-attention for enc-dec, and their caches.

The port of the JAX package's ``models/attention.py``. GQA takes one of
two routes, chosen by the caller:

  * **prefill** (``prefill=True``, from ``lm.prefill`` and the enc-dec
    ``encode`` / ``prefill``): the fresh q, k, v go through
    ``repro_torch.kernels.ops.flash_attention`` — the CUDA flash kernel on
    the card, its plain version on the CPU. With a cache, k and v are
    also written into it. The reference instead attends over the whole
    cache; the two agree exactly when the cache starts empty (``pos ==
    0``) and holds the prompt (``S <= cache_len``): empty slots have
    position -1 and add exp(-1e30 - m) = 0 to the softmax, and the
    prompt's positions are 0..S-1, so the kernel's index masks are the
    reference's position masks. Both conditions are checked. Without a
    cache (the encoder's non-causal self-attention; the decoder's
    cross-attention over the encoder's frames, no RoPE) the caller
    passes ``positions = arange(S_q)`` and ``kv_positions =
    arange(S_k)``, as ``encdec`` does, and nothing is masked but by
    ``causal`` and ``window``, so again the index masks are the position
    masks.
  * **decode and no cache**: ``grouped_attention``, plain torch ops with
    the reference's position masks, over the cache (or over the fresh k,
    v: the decode's cross-attention re-projects the encoder's frames
    each step, as the reference does; and the training forward, whose
    autograd the flash kernel, a forward only, could not carry). The JAX
    package computes this in jnp outside any Pallas kernel too; the
    kernel's index-causal contract cannot express ring-buffer positions.

MLA follows the reference's two branches: with a cache (prefill and
decode alike) the **absorbed** form, which folds ``w_uk`` into the query
and attends over the whole latent cache as one shared kv head; without a
cache the **expanded** form, per-head K/V through ``grouped_attention``.
Neither goes through the flash kernel: the absorbed q·k width is
kv_lora + rope (288 for MiniCPM3, 576 for DeepSeek-V2) against a v width
of kv_lora, and the kernel takes only equal k and v widths of at most
256. The reference computes MLA in jnp outside any Pallas kernel too.

The attention product alone, projections and cache writes outside it,
records the span ``model.attention.core`` (``obs.trace``) with its
``route``: ``flash``, ``cache`` (over the cache: GQA's decode, MLA's
absorbed branch) or ``fresh`` (over the fresh k, v: no cache).

A cache is a dict of tensors updated IN PLACE (GQA: k, v; MLA: c_kv,
k_rope; both: positions) plus a host integer ``pos``; the reference
returns a new cache instead. Keeping ``pos`` on the host leaves the
ring-buffer slot arithmetic off the device, so a decode step never waits
for the card.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..kernels import ops
from ..obs import trace as _trace
from ..parallel.context import heads_parallel, split_evenly, unsplit, \
    write_slice_
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
    q_chunk: int = 1024,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Chunked-softmax grouped-query attention with position masks ->
    (B, S_q, H, Dv), the reference's: queries in chunks of ``q_chunk``
    (S_q must then be a multiple of it), each chunk's float32 scores over
    every key. Each query row's softmax is over all keys either way, so
    the chunks change no value; they bound the forward's peak to one
    chunk's (B, KV, G, q_chunk, S_k) scores. Under autograd each chunk's
    probabilities are saved for the backward, the same total as in one
    piece; ``torch.utils.checkpoint`` (``cfg.remat``) drops them."""
    B, S_q, H, D = q.shape
    KV = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, S_q, KV, H // KV, D)
    k32, v32 = k.to(torch.float32), v.to(torch.float32)

    def one_chunk(qc: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
        s = torch.einsum("bqhgd,bkhd->bhgqk", qc.to(torch.float32),
                         k32) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        s = s + _bias(qp, k_pos, causal, window)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhgqk,bkhd->bqhgd", p, v32)

    if S_q <= q_chunk:
        o = one_chunk(qg, q_pos)
    else:
        assert S_q % q_chunk == 0, "seq len must be divisible by q_chunk"
        o = torch.cat([one_chunk(qg[:, i:i + q_chunk], q_pos[i:i + q_chunk])
                       for i in range(0, S_q, q_chunk)], dim=1)
    return o.reshape(B, S_q, H, v.shape[-1]).to(q.dtype)


def _project(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one (B*S, d) x (d, h*k) product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k).to(x.dtype)).view(*x.shape[:-1], h, k)


# ================================================================= GQA
class GQA(nn.Module):
    """Self- or cross-attention. Params ``wq`` (d,H,hd), ``wk``/``wv``
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

    def forward(
        self,
        x: torch.Tensor,                 # (B, S, d)
        positions: torch.Tensor,         # (S,) int32
        window: Optional[int] = None,
        cache: Optional[Cache] = None,
        prefill: bool = False,
        causal: bool = True,
        kv_source: Optional[torch.Tensor] = None,   # cross-attn: (B, S_k, d)
        kv_positions: Optional[torch.Tensor] = None,
        use_rope: bool = True,
    ) -> Tuple[torch.Tensor, Optional[Cache]]:
        cfg = self.cfg
        B, S, _ = x.shape
        src = x if kv_source is None else kv_source
        q = _project(self.wq, x)
        k = _project(self.wk, src)
        v = _project(self.wv, src)
        if cfg.qk_norm:
            q = self.q_norm(q)
            k = self.k_norm(k)
        kp = kv_positions if kv_positions is not None else positions
        if use_rope:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, kp, cfg.rope_theta)

        if prefill:
            out = self._prefill_attention(q, k, v, positions, window, cache,
                                          causal)
        elif cache is not None:
            _write(cache, positions, k=k, v=v)
            # the query's heads whole against the length-split cache
            with _trace.span("model.attention.core", route="cache"):
                out = grouped_attention(unsplit(q, 2), cache["k"],
                                        cache["v"], positions,
                                        cache["positions"], causal=causal,
                                        window=window,
                                        softcap=cfg.attn_logit_softcap)
        else:
            with _trace.span("model.attention.core", route="fresh"):
                out = heads_parallel(functools.partial(
                    grouped_attention, causal=causal, window=window,
                    softcap=cfg.attn_logit_softcap), q, k, v, positions, kp)
        H, hd, d = self.wo.shape
        y = out.reshape(B, S, H * hd) @ self.wo.reshape(H * hd, d).to(x.dtype)
        return y, cache

    def _prefill_attention(self, q, k, v, positions, window, cache, causal):
        if cache is not None:
            if cache["pos"] != 0:
                raise ValueError("the prefill route needs an empty cache "
                                 "(pos == 0)")
            if q.shape[1] > cache["k"].shape[1]:
                raise ValueError(f"prompt of {q.shape[1]} tokens exceeds "
                                 f"the cache of {cache['k'].shape[1]}")
        if self.cfg.attn_logit_softcap is not None:
            raise NotImplementedError("the flash route has no logit softcap")
        if window is not None and window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if cache is not None:
            _write(cache, positions, k=k, v=v)
        with _trace.span("model.attention.core", route="flash"):
            return heads_parallel(functools.partial(
                ops.flash_attention, causal=causal, window=window or 0),
                q, k, v)


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


def _write(cache: Cache, positions: torch.Tensor,
           **new: torch.Tensor) -> None:
    """Ring-buffer write of S new entries of each named cache tensor
    (``k=..., v=...`` or ``c_kv=..., k_rope=...``, each (B, S, ...)) at
    ``pos % cache_len``, in place. The start is clamped so the S entries
    fit, as ``jax.lax.dynamic_update_slice`` clamps it; a cache sharded
    along its length (the dry run's) is written shard by shard
    (``parallel.context.write_slice_``)."""
    cache_len = cache["positions"].shape[0]
    S = positions.shape[0]
    start = min(cache["pos"] % cache_len, cache_len - S)
    for name, t in new.items():
        write_slice_(cache[name], 1, start, t.to(cache[name].dtype))
    write_slice_(cache["positions"], 0, start, positions.to(torch.int32))
    cache["pos"] += S


# ================================================================= MLA
class MLA(nn.Module):
    """Multi-head latent attention. Params ``w_dq`` (d, q_lora),
    ``q_norm``, ``w_uq`` (q_lora, H, nope+rope), ``w_dkv`` (d,
    kv_lora+rope), ``kv_norm``, ``w_uk`` (kv_lora, H, nope), ``w_uv``
    (kv_lora, H, v) and ``wo`` (H, v, d), named as the reference's."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.cfg = cfg
        m = cfg.mla
        d, H = cfg.d_model, cfg.num_heads
        dt = cfg.dtype("param")
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        self.w_dq = _param((d, m.q_lora_rank), dt, device)
        self.q_norm = RMSNorm(m.q_lora_rank, dt, device)
        self.w_uq = _param((m.q_lora_rank, H, qk), dt, device)
        self.w_dkv = _param((d, m.kv_lora_rank + m.qk_rope_head_dim), dt,
                            device)
        self.kv_norm = RMSNorm(m.kv_lora_rank, dt, device)
        self.w_uk = _param((m.kv_lora_rank, H, m.qk_nope_head_dim), dt,
                           device)
        self.w_uv = _param((m.kv_lora_rank, H, m.v_head_dim), dt, device)
        self.wo = _param((H, m.v_head_dim, d), dt, device)

    def _qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """The reference's ``_mla_qkv``: (q_nope, q_rope, c_kv, k_rope)."""
        m = self.cfg.mla
        theta = self.cfg.rope_theta
        cq = self.q_norm(x @ self.w_dq.to(x.dtype))
        q = _project(self.w_uq, cq)
        q_nope = q[..., :m.qk_nope_head_dim]
        q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions, theta)
        dkv = x @ self.w_dkv.to(x.dtype)
        c_kv = self.kv_norm(dkv[..., :m.kv_lora_rank])
        k_rope = apply_rope(dkv[..., m.kv_lora_rank:][:, :, None, :],
                            positions, theta)[:, :, 0, :]
        return q_nope, q_rope, c_kv, k_rope

    def forward(
        self,
        x: torch.Tensor,                 # (B, S, d)
        positions: torch.Tensor,         # (S,) int32
        window: Optional[int] = None,
        cache: Optional[Cache] = None,
        prefill: bool = False,
        causal: bool = True,
    ) -> Tuple[torch.Tensor, Optional[Cache]]:
        """With a cache, prefill (``prefill=True``) and decode alike take
        the absorbed branch over the whole cache, as the reference's
        ``lm.prefill`` does; the flag selects no other route."""
        m = self.cfg.mla
        B, S, _ = x.shape
        H = self.cfg.num_heads
        q_nope, q_rope, c_kv, k_rope = self._qkv(x, positions)
        if cache is not None:
            _write(cache, positions, c_kv=c_kv, k_rope=k_rope)
            with _trace.span("model.attention.core", route="cache"):
                out = self._absorbed(q_nope, q_rope, cache, positions,
                                     window, causal)
        else:
            k_nope = torch.einsum("btl,lhn->bthn", c_kv,
                                  self.w_uk.to(x.dtype))
            v = torch.einsum("btl,lhv->bthv", c_kv, self.w_uv.to(x.dtype))
            k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
                B, S, H, m.qk_rope_head_dim)], dim=-1)
            q = torch.cat([q_nope, q_rope], dim=-1)
            with _trace.span("model.attention.core", route="fresh"):
                out = heads_parallel(functools.partial(
                    grouped_attention, causal=causal, window=window,
                    scale=1.0 / math.sqrt(q.shape[-1])), q, k, v, positions,
                    positions)
        Hv = H * m.v_head_dim
        out = split_evenly(split_evenly(out, 2, H).reshape(B, S, Hv), 2, H)
        y = out @ self.wo.reshape(Hv, -1).to(x.dtype)
        return y, cache

    def _absorbed(self, q_nope, q_rope, cache, positions, window, causal):
        """``w_uk`` folded into the query: scores over the latent cache
        (B, H, S, T) in float32, context in the latent space, then
        ``w_uv``; the reference's rounding points."""
        m = self.cfg.mla
        dt = q_nope.dtype
        c_all = cache["c_kv"].to(torch.float32)
        r_all = cache["k_rope"].to(torch.float32)
        q_abs = torch.einsum("bshn,lhn->bshl", q_nope, self.w_uk.to(dt))
        scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
        s = (torch.einsum("bshl,btl->bhst", q_abs.to(torch.float32), c_all)
             + torch.einsum("bshr,btr->bhst", q_rope.to(torch.float32),
                            r_all)) * scale
        s = s + _bias(positions, cache["positions"], causal, window)
        p = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bhst,btl->bshl", p, c_all)
        return torch.einsum("bshl,lhv->bshv", ctx.to(dt), self.w_uv.to(dt))


def init_mla_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype,
                   device=None) -> Cache:
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, cache_len, m.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, cache_len, m.qk_rope_head_dim),
                              dtype=dtype, device=device),
        "positions": torch.full((cache_len,), -1, dtype=torch.int32,
                                device=device),
        "pos": 0,
    }


# ================================================================= dispatch
def make_attention(cfg: ArchConfig, device=None) -> nn.Module:
    return MLA(cfg, device) if cfg.attention == "mla" else GQA(cfg, device)


def init_attention_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype,
                         device=None) -> Cache:
    init = init_mla_cache if cfg.attention == "mla" else init_gqa_cache
    return init(cfg, batch, cache_len, dtype, device)
