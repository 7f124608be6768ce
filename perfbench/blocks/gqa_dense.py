"""``gqa_dense``: grouped-query attention (with QK-norm where the
configuration has ``use_qk_norm``), then a gated MLP; every layer alike,
pre-norm with residuals.

Configuration keys: ``num_hidden_layers``, ``hidden_size``,
``num_attention_heads``, ``num_key_value_heads``, ``head_dim``,
``intermediate_size``, ``vocab_size``, ``rope_theta``, ``layer_norm_eps``,
``use_qk_norm``, ``tie_word_embeddings``. The port's ``dense`` family.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from perfbench import port
from perfbench import reference as ref
from perfbench.layout import SCALE, Dims, Leaf, matrix

#: a served batch may be judged on a sample of its requests
JUDGED_WHOLE = False
TRAINABLE = True


@dataclass(frozen=True)
class GQADims(Dims):
    d_ff: int
    # a per-head RMSNorm of q and k (one scale of head_dim each)
    qk_norm: bool


def dims(cfg: Dict) -> GQADims:
    return GQADims(cfg["block"], cfg["num_hidden_layers"], cfg["hidden_size"],
                   cfg["num_attention_heads"], cfg["num_key_value_heads"],
                   cfg["head_dim"], cfg["vocab_size"],
                   float(cfg["rope_theta"]), float(cfg["layer_norm_eps"]),
                   tied=bool(cfg.get("tie_word_embeddings", False)),
                   d_ff=cfg["intermediate_size"],
                   qk_norm=bool(cfg.get("use_qk_norm", False)))


def layer_leaves(m: GQADims, i: int) -> List[Leaf]:
    p = f"layers.{i}."
    d, H, KV, hd = m.d, m.heads, m.kv_heads, m.head_dim
    out = [Leaf(p + "attn_norm.scale", (d,), SCALE),
           matrix(p + "attn.wq", (d, H, hd), d),
           matrix(p + "attn.wk", (d, KV, hd), d),
           matrix(p + "attn.wv", (d, KV, hd), d),
           matrix(p + "attn.wo", (H, hd, d), H * hd)]
    if m.qk_norm:
        out += [Leaf(p + "attn.q_norm.scale", (hd,), SCALE),
                Leaf(p + "attn.k_norm.scale", (hd,), SCALE)]
    return out + [Leaf(p + "ffn_norm.scale", (d,), SCALE),
                  matrix(p + "mlp.w_gate", (d, m.d_ff), d),
                  matrix(p + "mlp.w_up", (d, m.d_ff), d),
                  matrix(p + "mlp.w_down", (m.d_ff, d), m.d_ff)]


def layer_norms(m: GQADims, i: int, rows: int) -> List[Tuple[int, int]]:
    """The pre-attention norm, QK-norm over each head's rows, the pre-FFN
    norm."""
    inner = [(rows * m.heads, m.head_dim),
             (rows * m.kv_heads, m.head_dim)] if m.qk_norm else []
    return [(rows, m.d)] + inner + [(rows, m.d)]


def layer(m: GQADims, w: ref.Weights, i: int, x: torch.Tensor,
          groups: Sequence[torch.Tensor], prec: ref.Precision
          ) -> torch.Tensor:
    """One pre-norm layer over x (B, T, d), float32."""
    p = f"layers.{i}."
    h = ref.rmsnorm(x, w[p + "attn_norm.scale"], m.eps)
    x = x + ref.gqa(m, w, p + "attn.", h, prec).view(x.shape)
    h = ref.rmsnorm(x, w[p + "ffn_norm.scale"], m.eps)
    f = ref.mlp(w[p + "mlp.w_gate"], w[p + "mlp.w_up"], w[p + "mlp.w_down"],
                h, prec)
    return x + f.view(x.shape)


def layer_matrix_params(m: GQADims, i: int, active: bool) -> int:
    d, hd = m.d, m.head_dim
    attn = d * m.heads * hd * 2 + d * m.kv_heads * hd * 2
    return attn + 3 * d * m.d_ff


def attn_width(m: GQADims, i: int) -> int:
    return 2 * m.head_dim


def keys_seen(m: GQADims, i: int, pos: np.ndarray) -> np.ndarray:
    """Causal over the whole sequence."""
    return pos + 1


def arch_config(m: GQADims, cfg: Dict, name: str, remat: str):
    return port.configs().ArchConfig(
        family="dense", num_kv_heads=m.kv_heads, head_dim=m.head_dim,
        d_ff=m.d_ff, attention="gqa", qk_norm=m.qk_norm,
        **port.common(m, cfg, name, remat))


def dispatch_groups(m: GQADims, B: int, S: int, new: int, device
                    ) -> List[torch.Tensor]:
    return []
