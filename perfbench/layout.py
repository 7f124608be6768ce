"""The leaves of a configuration's weights, worked out from its file alone.

A configuration file (``configs/<name>.json``) holds the model's keys in
the published ``config.json`` form, plus ``block``: ``gqa_dense`` (grouped
query attention and a gated MLP) or ``mla_moe`` (latent attention and a
mixture of experts with shared experts). ``leaves(cfg)`` lists every
weight as a ``Leaf`` in a fixed order and in groups: the embedding, one
group a layer, and the head (final norm, and the output table unless the
head reads the embedding's). The weights
generator draws them group by group, the reference reads them by these
names, and the port receives them under the same names, which are the
port's parameter names; a name or shape the port does not have stops the
run.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

#: how a leaf is drawn: a normal times ``std``, or a norm scale
NORMAL, SCALE = "normal", "scale"


@dataclass(frozen=True)
class Leaf:
    name: str
    shape: Tuple[int, ...]
    kind: str            # NORMAL or SCALE
    std: float = 0.0
    float32: bool = False   # stored in float32 (the MoE router)

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


EMBED_STD = 0.02


@dataclass(frozen=True)
class Dims:
    """The sizes the harness reads from a configuration file."""
    block: str
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    rope_theta: float
    eps: float
    # latent attention
    q_lora: int = 0
    kv_lora: int = 0
    nope: int = 0
    rope: int = 0
    v_dim: int = 0
    # experts
    experts: int = 0
    top_k: int = 0
    expert_ff: int = 0
    shared: int = 0
    capacity_factor: float = 0.0
    group_size: int = 0
    # a per-head RMSNorm of q and k (one scale of head_dim each)
    qk_norm: bool = False
    # the output head reads the embedding table
    tied: bool = False


def dims(cfg: Dict) -> Dims:
    block = cfg["block"]
    if block == "gqa_dense":
        return Dims(block, cfg["num_hidden_layers"], cfg["hidden_size"],
                    cfg["num_attention_heads"], cfg["num_key_value_heads"],
                    cfg["head_dim"], cfg["intermediate_size"],
                    cfg["vocab_size"], float(cfg["rope_theta"]),
                    float(cfg["layer_norm_eps"]),
                    qk_norm=bool(cfg.get("use_qk_norm", False)),
                    tied=bool(cfg.get("tie_word_embeddings", False)))
    if block == "mla_moe":
        return Dims(block, cfg["num_hidden_layers"], cfg["hidden_size"],
                    cfg["num_attention_heads"], cfg["num_key_value_heads"],
                    cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"],
                    cfg["moe_intermediate_size"], cfg["vocab_size"],
                    float(cfg["rope_theta"]), float(cfg["rms_norm_eps"]),
                    q_lora=cfg["q_lora_rank"], kv_lora=cfg["kv_lora_rank"],
                    nope=cfg["qk_nope_head_dim"],
                    rope=cfg["qk_rope_head_dim"], v_dim=cfg["v_head_dim"],
                    experts=cfg["n_routed_experts"],
                    top_k=cfg["num_experts_per_tok"],
                    expert_ff=cfg["moe_intermediate_size"],
                    shared=cfg["n_shared_experts"],
                    capacity_factor=float(cfg["capacity_factor"]),
                    group_size=cfg["moe_group_size"],
                    tied=bool(cfg.get("tie_word_embeddings", False)))
    raise ValueError(f"unknown block {block!r}")


def _w(name: str, shape: Tuple[int, ...], fan_in: int) -> Leaf:
    return Leaf(name, shape, NORMAL, 1.0 / math.sqrt(fan_in))


def layer_leaves(m: Dims, i: int) -> List[Leaf]:
    p = f"layers.{i}."
    d = m.d
    out = [Leaf(p + "attn_norm.scale", (d,), SCALE)]
    if m.block == "gqa_dense":
        H, KV, hd = m.heads, m.kv_heads, m.head_dim
        out += [_w(p + "attn.wq", (d, H, hd), d),
                _w(p + "attn.wk", (d, KV, hd), d),
                _w(p + "attn.wv", (d, KV, hd), d),
                _w(p + "attn.wo", (H, hd, d), H * hd)]
        if m.qk_norm:
            out += [Leaf(p + "attn.q_norm.scale", (hd,), SCALE),
                    Leaf(p + "attn.k_norm.scale", (hd,), SCALE)]
        out += [Leaf(p + "ffn_norm.scale", (d,), SCALE),
                _w(p + "mlp.w_gate", (d, m.d_ff), d),
                _w(p + "mlp.w_up", (d, m.d_ff), d),
                _w(p + "mlp.w_down", (m.d_ff, d), m.d_ff)]
    else:
        H = m.heads
        out += [_w(p + "attn.w_dq", (d, m.q_lora), d),
                Leaf(p + "attn.q_norm.scale", (m.q_lora,), SCALE),
                _w(p + "attn.w_uq", (m.q_lora, H, m.nope + m.rope), m.q_lora),
                _w(p + "attn.w_dkv", (d, m.kv_lora + m.rope), d),
                Leaf(p + "attn.kv_norm.scale", (m.kv_lora,), SCALE),
                _w(p + "attn.w_uk", (m.kv_lora, H, m.nope), m.kv_lora),
                _w(p + "attn.w_uv", (m.kv_lora, H, m.v_dim), m.kv_lora),
                _w(p + "attn.wo", (H, m.v_dim, d), H * m.v_dim),
                Leaf(p + "ffn_norm.scale", (d,), SCALE),
                Leaf(p + "moe.router", (d, m.experts), NORMAL,
                     1.0 / math.sqrt(d), float32=True),
                _w(p + "moe.w_gate", (m.experts, d, m.expert_ff), d),
                _w(p + "moe.w_up", (m.experts, d, m.expert_ff), d),
                _w(p + "moe.w_down", (m.experts, m.expert_ff, d),
                   m.expert_ff)]
        if m.shared:
            f = m.shared * m.expert_ff
            out += [_w(p + "moe.shared.w_gate", (d, f), d),
                    _w(p + "moe.shared.w_up", (d, f), d),
                    _w(p + "moe.shared.w_down", (f, d), f)]
    return out


def groups(m: Dims) -> List[Tuple[str, List[Leaf]]]:
    """The leaves in their drawing groups, in order: ``embed``,
    ``layer.<i>`` for each layer, ``head`` (the final norm, and the
    output table unless it is the embedding's)."""
    out = [("embed", [Leaf("embed.table", (m.vocab, m.d), NORMAL,
                           EMBED_STD)])]
    out += [(f"layer.{i}", layer_leaves(m, i)) for i in range(m.layers)]
    head = [Leaf("final_norm.scale", (m.d,), SCALE)]
    if not m.tied:
        head.append(Leaf("unembed.table", (m.vocab, m.d), NORMAL, EMBED_STD))
    out.append(("head", head))
    return out


def head_table(m: Dims) -> str:
    """The name of the table the output head reads."""
    return "embed.table" if m.tied else "unembed.table"


def norm_plan(m: Dims, rows: int) -> List[Tuple[int, int]]:
    """(rows, width) of each RMSNorm launch of one forward over ``rows``
    tokens through the layers, in order, the final norm aside: a layer's
    pre-attention norm, attention's own (QK-norm over each head's rows;
    MLA's query and latent norms), then its pre-FFN norm."""
    inner: List[Tuple[int, int]] = []
    if m.block == "mla_moe":
        inner = [(rows, m.q_lora), (rows, m.kv_lora)]
    elif m.qk_norm:
        inner = [(rows * m.heads, m.head_dim), (rows * m.kv_heads,
                                                m.head_dim)]
    return ([(rows, m.d)] + inner + [(rows, m.d)]) * m.layers


def param_count(m: Dims) -> int:
    return sum(leaf.numel for _, g in groups(m) for leaf in g)
