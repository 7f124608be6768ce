"""``mla_moe``: latent attention, then a mixture of experts with shared
experts (GShard capacity dispatch over groups of tokens); every layer
alike, pre-norm with residuals.

Configuration keys: ``num_hidden_layers``, ``hidden_size``,
``num_attention_heads``, ``num_key_value_heads``, ``q_lora_rank``,
``kv_lora_rank``, ``qk_nope_head_dim``, ``qk_rope_head_dim``,
``v_head_dim``, ``moe_intermediate_size``, ``n_routed_experts``,
``num_experts_per_tok``, ``n_shared_experts``, ``capacity_factor``,
``moe_group_size``, ``vocab_size``, ``rope_theta``, ``rms_norm_eps``,
``tie_word_embeddings``. The port's ``moe`` family with ``attention="mla"``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from perfbench import port
from perfbench import reference as ref
from perfbench.layout import NORMAL, SCALE, Dims, Leaf, matrix

#: capacity is taken over a batch's tokens together
JUDGED_WHOLE = True
TRAINABLE = False


@dataclass(frozen=True)
class MLAMoEDims(Dims):
    # latent attention
    q_lora: int
    kv_lora: int
    nope: int
    rope: int
    v_dim: int
    # experts
    experts: int
    top_k: int
    expert_ff: int
    shared: int
    capacity_factor: float
    group_size: int


def dims(cfg: Dict) -> MLAMoEDims:
    return MLAMoEDims(
        cfg["block"], cfg["num_hidden_layers"], cfg["hidden_size"],
        cfg["num_attention_heads"], cfg["num_key_value_heads"],
        cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"], cfg["vocab_size"],
        float(cfg["rope_theta"]), float(cfg["rms_norm_eps"]),
        tied=bool(cfg.get("tie_word_embeddings", False)),
        q_lora=cfg["q_lora_rank"], kv_lora=cfg["kv_lora_rank"],
        nope=cfg["qk_nope_head_dim"], rope=cfg["qk_rope_head_dim"],
        v_dim=cfg["v_head_dim"], experts=cfg["n_routed_experts"],
        top_k=cfg["num_experts_per_tok"],
        expert_ff=cfg["moe_intermediate_size"],
        shared=cfg["n_shared_experts"],
        capacity_factor=float(cfg["capacity_factor"]),
        group_size=cfg["moe_group_size"])


def layer_leaves(m: MLAMoEDims, i: int) -> List[Leaf]:
    p = f"layers.{i}."
    d, H = m.d, m.heads
    out = [Leaf(p + "attn_norm.scale", (d,), SCALE),
           matrix(p + "attn.w_dq", (d, m.q_lora), d),
           Leaf(p + "attn.q_norm.scale", (m.q_lora,), SCALE),
           matrix(p + "attn.w_uq", (m.q_lora, H, m.nope + m.rope), m.q_lora),
           matrix(p + "attn.w_dkv", (d, m.kv_lora + m.rope), d),
           Leaf(p + "attn.kv_norm.scale", (m.kv_lora,), SCALE),
           matrix(p + "attn.w_uk", (m.kv_lora, H, m.nope), m.kv_lora),
           matrix(p + "attn.w_uv", (m.kv_lora, H, m.v_dim), m.kv_lora),
           matrix(p + "attn.wo", (H, m.v_dim, d), H * m.v_dim),
           Leaf(p + "ffn_norm.scale", (d,), SCALE),
           Leaf(p + "moe.router", (d, m.experts), NORMAL,
                1.0 / math.sqrt(d), float32=True),
           matrix(p + "moe.w_gate", (m.experts, d, m.expert_ff), d),
           matrix(p + "moe.w_up", (m.experts, d, m.expert_ff), d),
           matrix(p + "moe.w_down", (m.experts, m.expert_ff, d), m.expert_ff)]
    if m.shared:
        f = m.shared * m.expert_ff
        out += [matrix(p + "moe.shared.w_gate", (d, f), d),
                matrix(p + "moe.shared.w_up", (d, f), d),
                matrix(p + "moe.shared.w_down", (f, d), f)]
    return out


def layer_norms(m: MLAMoEDims, i: int, rows: int) -> List[Tuple[int, int]]:
    """The pre-attention norm, the query's and the latent's norms, the
    pre-FFN norm."""
    return [(rows, m.d), (rows, m.q_lora), (rows, m.kv_lora), (rows, m.d)]


def layer(m: MLAMoEDims, w: ref.Weights, i: int, x: torch.Tensor,
          groups: Sequence[torch.Tensor], prec: ref.Precision
          ) -> torch.Tensor:
    """One pre-norm layer over x (B, T, d), float32; the MoE's capacity
    taken over ``groups``."""
    p = f"layers.{i}."
    h = ref.rmsnorm(x, w[p + "attn_norm.scale"], m.eps)
    x = x + ref.mla(m, w, p + "attn.", h, prec).view(x.shape)
    h = ref.rmsnorm(x, w[p + "ffn_norm.scale"], m.eps)
    f = ref.moe(m, w, p + "moe.", h.reshape(-1, m.d), groups, prec)
    return x + f.view(x.shape)


def layer_matrix_params(m: MLAMoEDims, i: int, active: bool) -> int:
    """Router included; only k routed experts with ``active``."""
    d, H = m.d, m.heads
    attn = (d * m.q_lora + m.q_lora * H * (m.nope + m.rope)
            + d * (m.kv_lora + m.rope) + m.kv_lora * H * (m.nope + m.v_dim)
            + H * m.v_dim * d)
    experts = m.top_k if active else m.experts
    ffn = d * m.experts + (experts + m.shared) * 3 * d * m.expert_ff
    return attn + ffn


def attn_width(m: MLAMoEDims, i: int) -> int:
    return m.nope + m.rope + m.v_dim


def keys_seen(m: MLAMoEDims, i: int, pos: np.ndarray) -> np.ndarray:
    """Causal over the whole sequence."""
    return pos + 1


def arch_config(m: MLAMoEDims, cfg: Dict, name: str, remat: str):
    c = port.configs()
    return c.ArchConfig(
        family="moe", num_kv_heads=m.kv_heads, d_ff=m.expert_ff,
        attention="mla",
        mla=c.MLAConfig(q_lora_rank=m.q_lora, kv_lora_rank=m.kv_lora,
                        qk_nope_head_dim=m.nope, qk_rope_head_dim=m.rope,
                        v_head_dim=m.v_dim),
        moe=c.MoEConfig(num_experts=m.experts, top_k=m.top_k,
                        expert_d_ff=m.expert_ff, num_shared_experts=m.shared,
                        shared_d_ff=m.expert_ff,
                        capacity_factor=m.capacity_factor,
                        group_size=m.group_size),
        **port.common(m, cfg, name, remat))


def dispatch_groups(m: MLAMoEDims, B: int, S: int, new: int, device
                    ) -> List[torch.Tensor]:
    """The dispatch groups of one served batch over the reference's
    (B, S + new - 1) token grid, flattened row-major: the prefill's B * S
    tokens in (request, position) order cut into groups of
    min(group_size, B S), then one group of the B rows at each decode
    position (cut into groups of min(group_size, B))."""
    T = S + new - 1
    b = torch.arange(B, device=device)
    pre = (b[:, None] * T + torch.arange(S, device=device)).reshape(-1)
    g = min(m.group_size, B * S)
    if pre.numel() % g:
        raise ValueError(f"{pre.numel()} prefill tokens in groups of {g}")
    out = [pre.view(-1, g)]
    if new > 1:
        dec = b[None, :] * T + torch.arange(S, T, device=device)[:, None]
        gd = min(m.group_size, B)
        if B % gd:
            raise ValueError(f"{B} decode rows in groups of {gd}")
        out.append(dec.reshape(-1, gd))
    return out
