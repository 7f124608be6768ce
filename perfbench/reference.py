"""The plain reference: the configurations' decoders in float32 PyTorch.

It imports nothing of the program. It reads its sizes from the
configuration file (``layout.dims``) and its weights from the benchmark's
generator (``weights``), one layer group at a time; each layer is its
block's ``layer`` (``blocks/<block>.py``), built from the helpers here
(``rmsnorm``, ``rope``, ``gqa``, ``mla``, ``mlp``, ``moe``). It works in
float32 with TF32 off. ``Precision`` says how its weight products round:
``FP32`` is the reference; ``FP8`` rounds both operands of every weight
product to float8 e4m3 (activations per row, weights per output column, each scaled
to the format's largest value), the control that a later change to lower
precision would resemble. The router and attention's own products stay
in float32 in both.

Serving: ``final_hidden`` runs the full causal forward over whole
sequences (prompt and served tokens), the MoE's capacity taken over the
groups the caller names, as the serving engine formed them.
``head_scores`` reads the logits of chosen rows block by block over the
vocabulary. Training: ``train_reference`` (``reference_train``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Sequence

import torch
import torch.nn.functional as F

from . import blocks
from .layout import Dims

#: a layer's weights by leaf name: float32 or bfloat16 tensors on one device
Weights = Dict[str, torch.Tensor]
E4M3_MAX = 448.0
VOCAB_BLOCK = 32768


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 and back, scaled per slice along
    ``dim`` so each slice's largest magnitude lands on 448."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    s = E4M3_MAX / amax
    return (t * s).to(torch.float8_e4m3fn).to(torch.float32) / s


@dataclass(frozen=True)
class Precision:
    name: str

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., k) @ w (k, n) in float32, both operands rounded first
        under FP8."""
        x = x.to(torch.float32)
        w = w.to(torch.float32)
        if self.name == "fp8":
            x = to_fp8(x, -1)
            w = to_fp8(w, 0)
        return x @ w


FP32 = Precision("fp32")
FP8 = Precision("fp8")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.to(torch.float32)
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
        * scale.to(torch.float32)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, ..., D): the two halves of the last axis rotated by
    pos * theta^(-2i/D)."""
    D = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                       device=x.device) / D)
    ang = pos.to(torch.float32)[:, None] * inv                 # (T, D/2)
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (D // 2,)
    cos, sin = torch.cos(ang).view(shape), torch.sin(ang).view(shape)
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _causal_softmax_av(s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """s (..., T, T) scores, v (..., T, Dv): causal softmax, then p @ v."""
    T = s.shape[-1]
    mask = torch.ones(T, T, dtype=torch.bool, device=s.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    return torch.softmax(s, dim=-1) @ v


def gqa(m: Dims, w: Weights, p: str, h: torch.Tensor,
        prec: Precision) -> torch.Tensor:
    """h (B, T, d) normed -> attention output (B, T, d); with QK-norm
    each head's q and k are normed before the rotation."""
    B, T, d = h.shape
    H, KV, hd = m.heads, m.kv_heads, m.head_dim
    pos = torch.arange(T, device=h.device)
    q = prec.mm(h, w[p + "wq"].reshape(d, H * hd)).view(B, T, H, hd)
    k = prec.mm(h, w[p + "wk"].reshape(d, KV * hd)).view(B, T, KV, hd)
    v = prec.mm(h, w[p + "wv"].reshape(d, KV * hd)).view(B, T, KV, hd)
    if m.qk_norm:
        q = rmsnorm(q, w[p + "q_norm.scale"], m.eps)
        k = rmsnorm(k, w[p + "k_norm.scale"], m.eps)
    out = torch.empty(B, T, H * hd, dtype=torch.float32, device=h.device)
    for b in range(B):
        qb = rope(q[b], pos, m.rope_theta) \
            .view(T, KV, H // KV, hd).permute(1, 2, 0, 3)      # KV, G, T, hd
        kb = rope(k[b], pos, m.rope_theta).permute(1, 0, 2)[:, None]
        vb = v[b].permute(1, 0, 2)[:, None]                     # KV, 1, T, hd
        o = _causal_softmax_av(qb @ kb.transpose(-1, -2) / math.sqrt(hd), vb)
        out[b] = o.permute(2, 0, 1, 3).reshape(T, H * hd)
    return prec.mm(out, w[p + "wo"].reshape(H * hd, d))


def mla(m: Dims, w: Weights, p: str, h: torch.Tensor,
        prec: Precision) -> torch.Tensor:
    """Latent attention in its expanded form: per-head keys and values
    from the normed latent, rope on the last ``rope`` dims of each query
    head and on one rope key shared by the heads."""
    B, T, d = h.shape
    H = m.heads
    pos = torch.arange(T, device=h.device)
    cq = rmsnorm(prec.mm(h, w[p + "w_dq"]), w[p + "q_norm.scale"], m.eps)
    q = prec.mm(cq, w[p + "w_uq"].reshape(m.q_lora, -1)) \
        .view(B, T, H, m.nope + m.rope)
    dkv = prec.mm(h, w[p + "w_dkv"])
    c = rmsnorm(dkv[..., :m.kv_lora], w[p + "kv_norm.scale"], m.eps)
    k_nope = prec.mm(c, w[p + "w_uk"].reshape(m.kv_lora, -1)) \
        .view(B, T, H, m.nope)
    v = prec.mm(c, w[p + "w_uv"].reshape(m.kv_lora, -1)) \
        .view(B, T, H, m.v_dim)
    out = torch.empty(B, T, H * m.v_dim, dtype=torch.float32, device=h.device)
    for b in range(B):
        q_rope = rope(q[b, :, :, m.nope:], pos, m.rope_theta)
        k_rope = rope(dkv[b, :, m.kv_lora:], pos, m.rope_theta)  # (T, rope)
        s = torch.einsum("qhn,khn->hqk", q[b, :, :, :m.nope], k_nope[b]) \
            + torch.einsum("qhr,kr->hqk", q_rope, k_rope)
        o = _causal_softmax_av(s / math.sqrt(m.nope + m.rope),
                               v[b].permute(1, 0, 2))          # H, T, v
        out[b] = o.permute(1, 0, 2).reshape(T, H * m.v_dim)
    return prec.mm(out, w[p + "wo"].reshape(H * m.v_dim, d))


def mlp(w_gate, w_up, w_down, h: torch.Tensor, prec: Precision
        ) -> torch.Tensor:
    return prec.mm(F.silu(prec.mm(h, w_gate)) * prec.mm(h, w_up), w_down)


def capacity(m: Dims, group: int) -> int:
    return max(int(math.ceil(group * m.top_k / m.experts
                             * m.capacity_factor)), 1)


def moe(m: Dims, w: Weights, p: str, h: torch.Tensor,
        groups: Sequence[torch.Tensor], prec: Precision) -> torch.Tensor:
    """h (N, d) normed tokens -> the MoE's output (N, d). ``groups`` are
    index tensors (G, g) of the tokens of each dispatch group in slot
    order; every token lies in one group. Each token's top-k experts by
    the float32 router's softmax (ties to the lower index), their
    probabilities renormalised over the k; a (token, k) slot is kept when
    fewer than C = ceil(g k / E cf) slots before it in (token, k) order
    of its group went to the same expert; the shared experts take every
    token."""
    N = h.shape[0]
    E, K = m.experts, m.top_k
    probs = torch.softmax(h @ w[p + "router"].to(torch.float32), dim=-1)
    top_p, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_idx = top_p[:, :K], top_idx[:, :K]
    top_p = top_p / top_p.sum(-1, keepdim=True)
    keep = torch.zeros(N, K, dtype=torch.bool, device=h.device)
    seen = torch.zeros(N, dtype=torch.int64, device=h.device)
    for idx in groups:
        G, g = idx.shape
        oh = F.one_hot(top_idx[idx], E).reshape(G, g * K, E)
        before = (torch.cumsum(oh, dim=1) - oh).reshape(G, g, K, E)
        slot = (before * oh.reshape(G, g, K, E)).sum(-1)        # (G, g, K)
        keep[idx] = slot < capacity(m, g)
        seen[idx.reshape(-1)] += 1
    if not bool((seen == 1).all()):
        raise ValueError("every token must lie in exactly one MoE group")
    y = torch.zeros(N, m.d, dtype=torch.float32, device=h.device)
    for e in range(E):
        rows, ks = torch.nonzero((top_idx == e) & keep, as_tuple=True)
        if rows.numel():
            out = mlp(w[p + "w_gate"][e], w[p + "w_up"][e],
                      w[p + "w_down"][e], h[rows], prec)
            y.index_add_(0, rows, out * top_p[rows, ks, None])
    if m.shared:
        y += mlp(w[p + "shared.w_gate"], w[p + "shared.w_up"],
                 w[p + "shared.w_down"], h, prec)
    return y


def block(m: Dims, w: Weights, i: int, x: torch.Tensor,
          groups: Sequence[torch.Tensor], prec: Precision) -> torch.Tensor:
    """Layer i over x (B, T, d), float32: its block's ``layer``."""
    return blocks.load(m.block).layer(m, w, i, x, groups, prec)


def final_hidden(m: Dims, layer_weights: Callable[[int], Weights],
                 embed: torch.Tensor, final_scale: torch.Tensor,
                 tokens: torch.Tensor, groups: Sequence[torch.Tensor],
                 prec: Precision = FP32) -> torch.Tensor:
    """tokens (B, T) -> the final norm's output (B, T, d), float32;
    ``layer_weights(i)`` gives layer i's weights (drawn anew each call,
    so one layer is held at a time)."""
    x = embed[tokens].to(torch.float32)
    for i in range(m.layers):
        w = layer_weights(i)
        x = block(m, w, i, x, groups, prec)
        del w
    return rmsnorm(x, final_scale, m.eps)


def head_scores(h: torch.Tensor, table: torch.Tensor, prec: Precision,
                want: Sequence[torch.Tensor] = ()) -> Dict[str, object]:
    """Logits of the rows h (R, d) against ``table`` (V, d), block by
    block over the vocabulary: each row's best logit and its first
    argmax, and the logit of each ``want`` column (R,) of token ids."""
    R = h.shape[0]
    best = torch.full((R,), float("-inf"), device=h.device)
    arg = torch.zeros(R, dtype=torch.int64, device=h.device)
    got = [torch.zeros(R, device=h.device) for _ in want]
    for lo in range(0, table.shape[0], VOCAB_BLOCK):
        blk = table[lo:lo + VOCAB_BLOCK]
        logits = prec.mm(h, blk.T)
        bmax, barg = logits.max(dim=-1)
        better = bmax > best
        best = torch.where(better, bmax, best)
        arg = torch.where(better, barg + lo, arg)
        for g, ids in zip(got, want):
            inside = (ids >= lo) & (ids < lo + blk.shape[0])
            col = (ids - lo).clamp(0, blk.shape[0] - 1)
            g += torch.where(inside, logits.gather(1, col[:, None])[:, 0],
                             0.0)
    return {"best": best, "argmax": arg, "want": got}
