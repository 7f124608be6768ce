"""Mixture-of-experts: top-k router (float32, load-balance aux loss),
shared experts, GShard-style capacity-based dispatch.

The port of the JAX package's ``models/moe.py``. Dispatch is grouped:
tokens are partitioned into groups of ``min(group_size, tokens)``; each
group builds a (S_g, E, C) combine tensor with per-expert capacity
C = ceil(S_g * top_k / E * capacity_factor). The expert FFNs then run as
batched products over the expert axis, every expert on its C slots
whether they are filled or not. Tokens over capacity are dropped
(standard GShard semantics), in the order of the (token, k) slots.

Routing is a plain function of the router and the grouped input
(``route``), so a caller can re-run it on a layer's input; the module
keeps no routing state. The masks are built with arithmetic on one-hots,
as the reference builds them: no step reads a value back to the host.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig, MoEConfig
from ..parallel.context import experts_parallel
from .layers import MLP, _param


def capacity(e: MoEConfig, group: int) -> int:
    """Slots per expert in a group of ``group`` tokens."""
    c = int(math.ceil(group * e.top_k / e.num_experts * e.capacity_factor))
    return max(c, 1)


def group_tokens(e: MoEConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) -> (G, S_g, d) with S_g = min(group_size, B*S); a
    token count the group does not divide raises (no padding)."""
    B, S, d = x.shape
    T = B * S
    g = min(e.group_size, T)
    if T % g:
        raise ValueError(f"tokens {T} not divisible by group {g}")
    return x.reshape(T // g, g, d)


class Routing(NamedTuple):
    top_p: torch.Tensor      # (G, S_g, K) float32, renormalised
    top_idx: torch.Tensor    # (G, S_g, K) int64, by falling probability
    probs: torch.Tensor      # (G, S_g, E) float32 router softmax
    keep: torch.Tensor       # (G, S_g, K, E) bool: the slot is within C
    combine: torch.Tensor    # (G, S_g, E, C) float32
    dispatch: torch.Tensor   # (G, S_g, E, C) in the input's dtype
    aux: torch.Tensor        # () float32 Switch load-balance loss


def route(cfg: ArchConfig, router: torch.Tensor,
          xg: torch.Tensor) -> Routing:
    """The router and the capacity dispatch of one layer for the grouped
    tokens ``xg`` (G, S_g, d); ``router`` (d, E) is float32."""
    e = cfg.moe
    E, K = e.num_experts, e.top_k
    G, g, _ = xg.shape
    logits = xg.to(torch.float32) @ router                   # (G, S_g, E)
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k orders ties by the lower index; a stable descending
    # sort does too, where torch.topk makes no promise
    top_p, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_idx = top_p[..., :K], top_idx[..., :K]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    f = F.one_hot(top_idx[..., 0], E).to(torch.float32).mean(dim=1)
    pbar = probs.mean(dim=1)
    aux = E * torch.mean(torch.sum(f * pbar, dim=-1))

    # capacity dispatch: the position of each (token, k) in its expert's
    # queue, counted over the group's slots in (token, k) order
    C = capacity(e, g)
    onehot = F.one_hot(top_idx, E).to(torch.float32)         # (G,S_g,K,E)
    pos_in_e = torch.cumsum(onehot.reshape(G, g * K, E), dim=1) \
        .reshape(G, g, K, E) - 1.0
    keep = (pos_in_e < C) & (onehot > 0)
    pos_clip = torch.clamp(pos_in_e, 0, C - 1).to(torch.int64)
    cap_oh = F.one_hot(pos_clip, C).to(torch.float32) * keep[..., None]
    # the reference's einsum("gske,gskec,gsk->gsec"): a token's k experts
    # differ, so each (e, c) entry takes at most one nonzero term
    combine = (onehot[..., None] * cap_oh
               * top_p[..., None, None]).sum(dim=2)          # (G,S_g,E,C)
    dispatch = (combine > 0).to(xg.dtype)
    return Routing(top_p, top_idx, probs, keep, combine, dispatch, aux)


class MoE(nn.Module):
    """Params as the reference's tree: ``router`` (d, E) float32,
    ``w_gate``/``w_up`` (E, d, f) and ``w_down`` (E, f, d) in the param
    dtype, and ``shared`` (an ``MLP``) when the config has shared
    experts."""

    #: the expert weights' fan-in is their second axis (the reference's
    #: ``dense_init(..., in_axis=1)``), read by ``layers.init_params_``
    fan_in_axis = {"w_gate": 1, "w_up": 1, "w_down": 1}

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        e = cfg.moe
        d, dt = cfg.d_model, cfg.dtype("param")
        self.cfg = cfg
        self.router = _param((d, e.num_experts), torch.float32, device)
        self.w_gate = _param((e.num_experts, d, e.expert_d_ff), dt, device)
        self.w_up = _param((e.num_experts, d, e.expert_d_ff), dt, device)
        self.w_down = _param((e.num_experts, e.expert_d_ff, d), dt, device)
        if e.num_shared_experts:
            self.shared = MLP(d, e.num_shared_experts * e.shared_d_ff,
                              cfg.activation, dt, device)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, S, d) -> (y, aux loss)."""
        xg = group_tokens(self.cfg.moe, x)
        r = route(self.cfg, self.router, xg)
        dt = x.dtype
        y = experts_parallel(
            functools.partial(_experts, self.cfg.activation), xg,
            r.dispatch, r.combine.to(dt), self.w_gate.to(dt),
            self.w_up.to(dt), self.w_down.to(dt))
        y = y.reshape(x.shape)
        if hasattr(self, "shared"):
            y = y + self.shared(x)
        return y, r.aux


def _experts(activation: str, xg, dispatch, combine, w_gate, w_up, w_down):
    """The expert FFNs of the dispatched tokens, combined back: (G, S_g,
    d), every expert on its C slots."""
    expert_in = torch.einsum("gsec,gsd->gecd", dispatch, xg)
    h_gate = torch.einsum("gecd,edf->gecf", expert_in, w_gate)
    h_up = torch.einsum("gecd,edf->gecf", expert_in, w_up)
    if activation == "silu":
        act = F.silu(h_gate)
    else:                          # the reference's gelu: tanh-approximate
        act = F.gelu(h_gate, approximate="tanh")
    h = torch.einsum("gecf,efd->gecd", act * h_up, w_down)
    return torch.einsum("gsec,gecd->gsd", combine, h)
