"""Helpers that the per-layer readers (``metrics/<name>.py``) share.

A reader takes a ``harness.Run`` and returns a number, or None where the
run has nothing for it to read: no trace, a trace that lost a launch, no
launch of its kernel. It never returns 0 for a share of a peak or a
roofline.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from . import counts
from .layout import norm_plan


def complete_trace(run):
    tr = run.trace
    return tr if tr is not None and tr.complete else None


def idle_pct(run) -> Optional[float]:
    tr = complete_trace(run)
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def share_pct(bound_s: float, measured_s: float) -> Optional[float]:
    if measured_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / measured_s


def kernel_times(run, part: str) -> List[float]:
    """Device seconds of each launch whose kernel name holds ``part``, in
    order of start; empty without a complete trace."""
    tr = complete_trace(run)
    if tr is None:
        return []
    return [e - s for _, s, e in tr.kernels(part)]


def norm_launches(run) -> List[Tuple[int, int]]:
    """(rows, width) of each rmsnorm launch of the window, in order
    (``layout.norm_plan`` a forward). Serving: a prefill's layers over
    B * S rows and the final norm over B, then each decode step's layers
    and final norm over B. Training: a step's forward and final norm over
    its batch's rows, then, under full remat, each layer's forward again
    in the backward."""
    m, tr = run.m, run.traffic
    out: List[Tuple[int, int]] = []
    if run.batches:
        S, new = tr["prompt_len"], tr["new_tokens"]
        for b in run.batches:
            B = len(b["ids"])
            out += norm_plan(m, B * S) + [(B, m.d)]
            out += (norm_plan(m, B) + [(B, m.d)]) * (new - 1)
        return out
    N = tr["batch"] * tr["seq_len"]
    again = norm_plan(m, N) if tr.get("remat") == "full" else []
    return (norm_plan(m, N) + [(N, m.d)] + again) * len(run.steps)


def rmsnorm_share(run, rows: int) -> Optional[float]:
    """rmsnorm's share of its bytes bound at ``rows`` x d, the launches at
    that shape picked out by matching the window's launches in order to
    its plan."""
    times = kernel_times(run, "rmsnorm_kernel")
    plan = norm_launches(run)
    if not times or len(times) != len(plan):
        return None
    at = [t for t, shape in zip(times, plan) if shape == (rows, run.m.d)]
    if not at:
        return None
    bound = counts.rmsnorm_bytes(rows, run.m.d) / counts.HBM_BYTES
    return share_pct(bound, sum(at) / len(at))


def rmsnorm_bwd_pairs(run, rows_pass: str) -> List[float]:
    """Device seconds of each ``rmsnorm_bwd`` call whose rows pass is the
    kernel ``rows_pass`` (``rmsnorm_bwd_wide`` or ``_narrow``): its rows
    pass and the column pass launched next after it, together; empty
    without a complete trace or where a rows pass lacks its column
    pass."""
    tr = complete_trace(run)
    if tr is None:
        return []
    ks = tr.kernels("rmsnorm_bwd")
    out = []
    for (name, s, e), nxt in zip(ks, ks[1:] + [None]):
        if "rmsnorm_bwd_cols" in name:
            continue
        if nxt is None or "rmsnorm_bwd_cols" not in nxt[0]:
            return []
        if rows_pass in name:
            out.append((e - s) + (nxt[2] - nxt[1]))
    return out
