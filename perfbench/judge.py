"""How ``correct`` is decided: the program's outputs against the plain
reference (``reference``), each number beside its limit.

Serving: a sample of the window's finished batches, drawn from the seed,
is run through the reference once, each request's prompt followed by its
served tokens, the MoE's dispatch groups as the engine formed them (the
prefill's tokens in (request, position) order, then each decode step's
rows). ``token_gap`` is the widest gap by which a served token's logit
lies below the reference's best at its position. The control is the
same reference computed under ``reference.FP8`` put in the program's
place: at each position the token the float8 forward puts first is taken
as the served token and judged alike (``control_gap``), and ``verdict``
holds its numbers to the same limits. ``mean_gap`` is the mean of the gaps over
the judged tokens, for the cells whose widest gap swings with routing
(``limits/<cell>.json`` names the numbers a cell compares).

The weights are drawn again from the seed, one layer group at a time;
nothing of the program's state is read.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from . import blocks
from . import reference as ref
from .layout import Dims, groups, head_table, layer_leaves
from .weights import draw_group


def moe_groups(m: Dims, B: int, S: int, new: int, device) -> List[torch.Tensor]:
    """The groups of tokens over which one served batch's expert capacity
    is taken, over the reference's (B, S + new - 1) token grid flattened
    row-major: the block's ``dispatch_groups``, ``[]`` for none."""
    return blocks.load(m.block).dispatch_groups(m, B, S, new, device)


class Weights:
    """The benchmark's weights drawn again from the seed: the embedding
    and the head held, a layer drawn each time it is asked for."""

    def __init__(self, seed: int, m: Dims, device, dtype=torch.bfloat16):
        self.seed, self.m, self.device, self.dtype = seed, m, device, dtype
        gs = dict(groups(m))
        self.embed = draw_group(seed, "embed", gs["embed"], device, dtype)
        self.head = draw_group(seed, "head", gs["head"], device, dtype)
        self.table = dict(self.embed, **self.head)[head_table(m)]

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        return draw_group(self.seed, f"layer.{i}", layer_leaves(self.m, i),
                          self.device, self.dtype)


def serve_gaps(m: Dims, w: Weights, prompts: np.ndarray, served: np.ndarray,
               control: bool = False) -> Dict:
    """prompts (B, S), served (B, new): the served tokens' widest gap
    below the float32 reference's best, and with ``control`` the float8
    control's."""
    ref.no_tf32()
    device = w.device
    B, S = prompts.shape
    new = served.shape[1]
    seq = np.concatenate([prompts, served[:, :-1]], axis=1)
    tokens = torch.from_numpy(seq.astype(np.int64)).to(device)
    grp = moe_groups(m, B, S, new, device)
    rows = slice(S - 1, S - 1 + new)
    want = torch.from_numpy(served.astype(np.int64)).reshape(-1).to(device)
    table = w.table

    def hidden(prec):
        h = ref.final_hidden(m, w.layer, w.embed["embed.table"],
                             w.head["final_norm.scale"], tokens, grp, prec)
        return h[:, rows].reshape(-1, m.d)

    out = {}
    picks = [want]
    if control:
        hc = hidden(ref.FP8)
        picks.append(ref.head_scores(hc, table, ref.FP8)["argmax"])
        del hc
    sc = ref.head_scores(hidden(ref.FP32), table, ref.FP32, picks)
    gaps = sc["best"] - sc["want"][0]
    out["token_gap"] = float(gaps.max())
    out["gap_sum"] = float(gaps.sum())
    if control:
        cg = sc["best"] - sc["want"][1]
        out["control_gap"] = float(cg.max())
        out["control_gap_sum"] = float(cg.sum())
    out["tokens_judged"] = int(want.numel())
    return out


def check(value: Optional[float], limit: float) -> Dict:
    ok = value is not None and np.isfinite(value) and value <= limit
    return {"value": value, "limit": limit, "ok": bool(ok)}


def verdict(readings: Dict, limits: Dict, failed: Dict[str, int]) -> Dict:
    """One side's numbers against the cell's limits (``limits/<cell>.json``
    names the numbers compared), and the counts in ``failed`` against 0:
    the checks, and whether the side is correct."""
    checks = {key: check(readings.get(key), lim["limit"])
              for key, lim in limits.items()}
    for key, n in failed.items():
        checks[key] = check(float(n), 0.0)
    return {"checks": checks, "correct": all(c["ok"] for c in checks.values())}
