"""The yardstick's arithmetic: operations and bytes from shapes alone, and
the card's published peaks.

Model FLOPs count what the model needs, not what the port computes:
2 FLOPs a multiply-add of every weight a token passes through (for a
mixture of experts the k routed experts and the shared ones, never all
of them), attention's two products over the keys a query may see, the
output head where logits are taken. Training is PaLM's count, 3 times
the forward's products and no recomputation (copied from
``chip_smoke.model_flops_per_step``). Kernel bytes count each input read
once and each output written once.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

from .layout import Dims

PEAKS: Dict = json.loads((Path(__file__).parent / "peaks.json").read_text())
BF16_FLOPS = PEAKS["bf16_flops_per_s"]
HBM_BYTES = PEAKS["hbm_bytes_per_s"]


def layer_matrix_params(m: Dims, active: bool = True) -> int:
    """Weights of one layer's matrix products a token passes through
    (router included; only k routed experts with ``active``)."""
    d = m.d
    if m.block == "gqa_dense":
        hd = m.head_dim
        attn = d * m.heads * hd * 2 + d * m.kv_heads * hd * 2
        return attn + 3 * d * m.d_ff
    H = m.heads
    attn = (d * m.q_lora + m.q_lora * H * (m.nope + m.rope)
            + d * (m.kv_lora + m.rope) + m.kv_lora * H * (m.nope + m.v_dim)
            + H * m.v_dim * d)
    experts = m.top_k if active else m.experts
    ffn = d * m.experts + (experts + m.shared) * 3 * d * m.expert_ff
    return attn + ffn


def attn_width(m: Dims) -> int:
    """q.k width plus p.v width of one head."""
    if m.block == "gqa_dense":
        return 2 * m.head_dim
    return m.nope + m.rope + m.v_dim


def forward_flops(m: Dims, tokens: int, keys_seen: float,
                  head_rows: int) -> float:
    """One forward: ``tokens`` tokens through every layer, attention over
    ``keys_seen`` (query, key) pairs a layer and head in all, the head
    over ``head_rows`` rows."""
    return (2.0 * m.layers * layer_matrix_params(m) * tokens
            + 2.0 * m.layers * m.heads * attn_width(m) * keys_seen
            + 2.0 * m.d * m.vocab * head_rows)


def causal_pairs(S: int) -> float:
    return S * (S + 1) / 2.0


def serve_batch_flops(m: Dims, B: int, S: int, new: int) -> float:
    """Model FLOPs of one served batch: the prefill of B prompts of S
    tokens (logits at the last position) and new - 1 decode steps, step j
    attending over S + j + 1 keys."""
    prefill = forward_flops(m, B * S, B * causal_pairs(S), B)
    decode = sum(forward_flops(m, B, B * (S + j + 1), B)
                 for j in range(new - 1))
    return prefill + decode


def prefill_flops(m: Dims, B: int, S: int) -> float:
    return forward_flops(m, B * S, B * causal_pairs(S), B)


def train_step_flops(m: Dims, n_matrix_params: int, tokens: int,
                     seq_len: int) -> float:
    """PaLM's count: 6 x the matrix params x tokens, plus 12 L H hd S a
    token for attention's two products over the whole S x S."""
    attn = 12 * m.layers * m.heads * m.head_dim * seq_len
    return tokens * (6 * n_matrix_params + attn)


def matrix_params(m: Dims) -> int:
    """Every parameter of two or more dimensions: the tables (one where
    the head reads the embedding's) and every layer's matrices (all
    experts)."""
    tables = 1 if m.tied else 2
    return tables * m.vocab * m.d \
        + m.layers * layer_matrix_params(m, active=False)


def flash_causal_flops(B: int, S: int, H: int, D: int) -> float:
    """q.k and p.v over the causal half: 4 B H D S (S + 1) / 2."""
    return 4.0 * B * H * D * causal_pairs(S)


def rmsnorm_bytes(N: int, d: int, itemsize: int = 2) -> float:
    """x read and y written once, the float32 scale read once."""
    return 2.0 * N * d * itemsize + 4.0 * d


def rmsnorm_bwd_bytes(N: int, d: int, itemsize: int = 2) -> float:
    """x and dy read and dx written once."""
    return 3.0 * N * d * itemsize
