"""The leaves of a configuration's weights, worked out from its file alone.

A configuration file (``configs/<name>.json``) holds the model's keys in
the published ``config.json`` form, plus ``block``, the name of the file
in ``blocks/`` that knows its layers. ``groups(dims(cfg))`` lists every
weight as a ``Leaf`` in a fixed order and in groups: the embedding, one
group a layer (the block's ``layer_leaves``), and the head (final norm,
and the output table unless the head reads the embedding's). The weights
generator draws them group by group, the reference reads them by these
names, and the port receives them under the same names, which are the
port's parameter names; a name or shape the port does not have stops the
run.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

from . import blocks

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
    """The sizes the harness reads from a configuration file, those every
    block has; a block's ``dims`` adds its own fields."""
    block: str
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    vocab: int
    rope_theta: float
    eps: float
    # the output head reads the embedding table
    tied: bool


def dims(cfg: Dict) -> Dims:
    return blocks.load(cfg["block"]).dims(cfg)


def matrix(name: str, shape: Tuple[int, ...], fan_in: int) -> Leaf:
    """A weight matrix drawn with std 1 / sqrt(fan-in)."""
    return Leaf(name, shape, NORMAL, 1.0 / math.sqrt(fan_in))


def layer_leaves(m: Dims, i: int) -> List[Leaf]:
    return blocks.load(m.block).layer_leaves(m, i)


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
    tokens through the layers, in order, the final norm aside: each
    layer's launches as its block gives them (``layer_norms``: a layer's
    pre-attention norm, attention's own, then its pre-FFN norm)."""
    block = blocks.load(m.block)
    out: List[Tuple[int, int]] = []
    for i in range(m.layers):
        out += block.layer_norms(m, i, rows)
    return out


def param_count(m: Dims) -> int:
    return sum(leaf.numel for _, g in groups(m) for leaf in g)
