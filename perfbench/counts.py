"""The yardstick's arithmetic: operations and bytes from shapes alone, and
the card's published peaks.

Model FLOPs count what the model needs, not what the port computes:
2 FLOPs a multiply-add of every weight a token passes through (for a
mixture of experts the k routed experts and the shared ones, never all
of them), attention's two products over the keys a query may see, the
output head where logits are taken. Training is PaLM's count, 3 times
the forward's products and no recomputation (copied from
``chip_smoke.model_flops_per_step``). Each count is summed layer by
layer from the layer's block (``blocks/<block>.py``: its matrices, its
attention's width, the keys a query sees at each position). Kernel bytes
count each input read once and each output written once.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

from . import blocks
from .layout import Dims

PEAKS: Dict = json.loads((Path(__file__).parent / "peaks.json").read_text())
BF16_FLOPS = PEAKS["bf16_flops_per_s"]
HBM_BYTES = PEAKS["hbm_bytes_per_s"]


def layer_matrix_params(m: Dims, active: bool = True, i: int = 0) -> int:
    """Weights of layer i's matrix products a token passes through
    (router included; only k routed experts with ``active``)."""
    return blocks.load(m.block).layer_matrix_params(m, i, active)


def attn_width(m: Dims, i: int = 0) -> int:
    """q.k width plus p.v width of one head of layer i."""
    return blocks.load(m.block).attn_width(m, i)


def layer_pairs(m: Dims, B: int, lo: int, hi: int) -> List[int]:
    """(query, key) pairs one head sees in each layer, in all, for B
    sequences' queries at positions lo .. hi - 1 (the block's
    ``keys_seen``)."""
    block = blocks.load(m.block)
    pos = np.arange(lo, hi, dtype=np.int64)
    return [B * int(block.keys_seen(m, i, pos).sum())
            for i in range(m.layers)]


def forward_flops(m: Dims, tokens: int, keys_seen: Sequence[int],
                  head_rows: int) -> float:
    """One forward: ``tokens`` tokens through every layer, attention over
    ``keys_seen[i]`` (query, key) pairs a head of layer i in all, the head
    over ``head_rows`` rows."""
    block = blocks.load(m.block)
    return (sum(2.0 * block.layer_matrix_params(m, i, True) * tokens
                for i in range(m.layers))
            + sum(2.0 * m.heads * block.attn_width(m, i) * keys_seen[i]
                  for i in range(m.layers))
            + 2.0 * m.d * m.vocab * head_rows)


def causal_pairs(S: int) -> float:
    return S * (S + 1) / 2.0


def serve_batch_flops(m: Dims, B: int, S: int, new: int) -> float:
    """Model FLOPs of one served batch: the prefill of B prompts of S
    tokens (logits at the last position) and new - 1 decode steps, step j
    a query at position S + j."""
    prefill = prefill_flops(m, B, S)
    decode = sum(forward_flops(m, B, layer_pairs(m, B, S + j, S + j + 1), B)
                 for j in range(new - 1))
    return prefill + decode


def prefill_flops(m: Dims, B: int, S: int) -> float:
    return forward_flops(m, B * S, layer_pairs(m, B, 0, S), B)


def train_step_flops(m: Dims, n_matrix_params: int, tokens: int,
                     seq_len: int) -> float:
    """PaLM's count: 6 x the matrix params x tokens, plus 12 H hd K a
    token and layer for attention's two products, K the keys the last
    position sees there (S, over the whole S x S, in a causal layer)."""
    block = blocks.load(m.block)
    last = np.array([seq_len - 1], dtype=np.int64)
    attn = sum(12 * m.heads * m.head_dim * int(block.keys_seen(m, i, last)[0])
               for i in range(m.layers))
    return tokens * (6 * n_matrix_params + attn)


def matrix_params(m: Dims) -> int:
    """Every parameter of two or more dimensions: the tables (one where
    the head reads the embedding's) and every layer's matrices (all
    experts)."""
    tables = 1 if m.tied else 2
    return tables * m.vocab * m.d + sum(
        layer_matrix_params(m, active=False, i=i) for i in range(m.layers))


def flash_causal_flops(B: int, S: int, H: int, D: int) -> float:
    """q.k and p.v over the causal half: 4 B H D S (S + 1) / 2."""
    return 4.0 * B * H * D * causal_pairs(S)


def rmsnorm_bytes(N: int, d: int, itemsize: int = 2) -> float:
    """x read and y written once, the float32 scale read once."""
    return 2.0 * N * d * itemsize + 4.0 * d


def rmsnorm_bwd_bytes(N: int, d: int, itemsize: int = 2) -> float:
    """x and dy read and dx written once."""
    return 3.0 * N * d * itemsize
