"""A training cell: the port's train step (``make_train_step``) over one
train state, built once, driven from the seed.

Set-up draws the weights, builds the state and runs the first
``checked_steps`` steps through the same call and feed as the window, on
batches that all differ; those steps warm every kernel and cuBLAS plan.
The program's readings are taken on the way: its loss each step, each
leaf's first clipped gradient from AdamW's first moment after step 1
(m = (1 - b1) g), and each leaf's change after the last checked step
(its first value drawn again from the seed). Their time is not set-up.
The window then goes on with the same state, a step after another, each
ending in the loss's host read, as the trainer's steps do.
``train_tokens_per_s`` is every token trained in the window over the time
from its start to the end of its last step.

After the window the program's state is freed and the reference
(``reference_train``) follows the same first steps in float32. Numbers
compared, each a relative gap: the steps' losses; the worst leaf's first
gradient norm and its change norm, each gap measured against the
reference's norm of that leaf or of the median leaf, whichever is
larger. Leaves whose reference gradient is under a thousandth of the
median leaf's are left out of both. With the control on, the float8
control and a planted fault (half of each batch left out, the mean taken
over the rest) follow the same steps in the program's place, and their
numbers are held to the same limits (``sides``).
"""
from __future__ import annotations

import math
import statistics
import time
from typing import Dict

import torch

from . import port
from . import reference as ref
from . import trace as tracing
from . import traffic as traffic_gen
from .harness import Run, device_info, free_device
from .judge import verdict
from .layout import dims, groups
from .reference_train import FP8_TRAIN, FirstGrads, run_reference, \
    square_sum
from .weights import draw_all, dtype_of, group_pieces

#: a leaf whose reference gradient is under this share of the median
#: leaf's is nought to rounding, and is left out
NOUGHT = 1e-3


def change_norms(params, seed: int, m, device, dtype) -> Dict[str, float]:
    """Each leaf's norm of (now - first), its first value drawn again
    from the seed a chunk at a time (``weights.group_pieces``)."""
    named = {n: p.detach().reshape(-1)
             for n, p in params.named_parameters()}
    sq: Dict[str, float] = {n: 0.0 for n in named}
    for g, leaves in groups(m):
        for n, at, piece in group_pieces(seed, g, leaves, device, dtype):
            sq[n] += square_sum(named[n][at:at + piece.numel()], piece)
    return {n: math.sqrt(v) for n, v in sq.items()}


def _batch(tr: Dict, seed: int, k: int, vocab: int, device) -> Dict:
    t = torch.from_numpy(traffic_gen.train_batch(tr, seed, k, vocab)) \
        .to(device)
    return {"tokens": t, "labels": t}


def worst_gap(prog: Dict[str, float], refn: Dict[str, float],
              keep) -> tuple:
    """(the worst leaf's gap, that leaf)."""
    med = statistics.median(refn[k] for k in keep)
    return max((abs(prog[k] - refn[k]) / max(refn[k], med), k) for k in keep)


def compare(prog: Dict, refr: Dict, diffs: Dict[str, float]) -> Dict:
    """The numbers compared (loss_gap, grad_gap, grad_diff, change_gap)
    and the leaves that gave the worst of each. ``diffs`` are the side's
    squared first-gradient differences by leaf: ``grad_diff`` is the worst
    leaf's norm of (its gradient - the reference's), against the
    reference's norm of that leaf or of the median leaf."""
    g = refr["first_grads"]
    med = statistics.median(g.values())
    keep = [k for k, v in g.items() if v >= NOUGHT * med]
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], refr["losses"]))
    grad_gap, grad_leaf = worst_gap(prog["first_grads"], g, keep)
    change_gap, change_leaf = worst_gap(prog["changes"], refr["changes"],
                                        keep)
    diff_gap, diff_leaf = max((math.sqrt(diffs[k]) / max(g[k], med), k)
                              for k in keep)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "grad_diff": diff_gap, "change_gap": change_gap,
            "grad_leaf": grad_leaf, "diff_leaf": diff_leaf,
            "change_leaf": change_leaf,
            "left_out": sorted(set(g) - set(keep))}


def run(name: str, files: Dict, seed: int, seconds: float, trace_on: bool,
        device: str, t_start: float) -> Dict:
    cfg, tr, limits = files["config"], files["traffic"], files["limits"]
    m = dims(cfg)
    dtype = dtype_of(cfg)
    arch = port.arch_config(m, cfg, cfg.get("name", name), remat=tr["remat"])
    opt = tr["optimizer"]
    parts = {"imports_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    params = port.params_from(arch, draw_all(seed, m, device, dtype))
    state, step = port.train_step(arch, params, opt, tr["total_steps"],
                                  tr["warmup_steps"])
    parts["weights_s"] = time.perf_counter() - t
    n_check = tr["checked_steps"]
    prog = {"losses": [], "first_grads": {}, "changes": {}}
    reading_s = 0.0
    for k in range(n_check):
        batch = _batch(tr, seed, k, m.vocab, device)
        state, metrics = step(state, batch)
        prog["losses"].append(float(metrics["loss"]))
        t = time.perf_counter()
        if k == 0:
            prog["first_grads"] = {
                n: math.sqrt(square_sum(mo)) / (1 - opt["b1"])
                for n, mo in state["opt"]["m"].items()}
            first = FirstGrads.of_program(state["opt"]["m"], opt["b1"])
        if k == n_check - 1:
            prog["changes"] = change_norms(state["params"], seed, m, device,
                                           dtype)
        reading_s += time.perf_counter() - t
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start - reading_s
    parts["checked_steps_s"] = setup_s - parts["imports_s"] \
        - parts["weights_s"]

    prof = tracing.start() if trace_on else None
    steps, k = [], n_check
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        batch = _batch(tr, seed, k, m.vocab, device)
        s0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])
        steps.append({"start_s": s0 - t0,
                      "end_s": time.perf_counter() - t0, "loss": loss})
        k += 1
    t1 = time.perf_counter()
    trace = tracing.read(tracing.stop(prof), t0, t1,
                         [("train_step", t0 + s["start_s"], t0 + s["end_s"])
                          for s in steps]) if prof is not None else None
    dev = device_info(torch, device, files["cell"]["chips"])
    span = steps[-1]["end_s"]
    B, S = tr["batch"], tr["seq_len"]
    e2e = {"train_tokens_per_s": len(steps) * B * S / span,
           "setup_s": setup_s}
    failed = sum(not math.isfinite(s["loss"]) for s in steps)

    del state, step, params, metrics, batch
    free_device(torch, device)
    tj = time.perf_counter()
    ref.no_tf32()
    batches = [_batch(tr, seed, k, m.vocab, device)["tokens"].long()
               for k in range(n_check)]
    common = (m, seed, device, opt, tr["warmup_steps"], tr["total_steps"],
              batches)
    firsts = {"program": first}
    others = {}
    if files.get("control"):
        # the control, and a fault planted in the reference put in the
        # program's place: half of each batch left out, the mean taken
        # over the rest
        others["control"] = run_reference(*common, prec=FP8_TRAIN,
                                          dtype=dtype, keep_first=True)
        free_device(torch, device)
        others["half_batch"] = run_reference(
            *common[:-1], [b[:b.shape[0] // 2] for b in batches],
            dtype=dtype, keep_first=True)
        free_device(torch, device)
        firsts.update({k: v.pop("first") for k, v in others.items()})
    refr = run_reference(*common, dtype=dtype, firsts=firsts)
    free_device(torch, device)
    nums = compare(prog, refr, refr["first_diffs"]["program"])
    readings = dict(nums, judge_s=time.perf_counter() - tj,
                    setup_parts=parts, program_readings_s=reading_s)
    if device == "cuda":
        # the process's peak once the reference has run (the program's is
        # read before it)
        readings["peak_after_judge_bytes"] = torch.cuda.max_memory_allocated()
    side = verdict(nums, limits, {"failed_steps": failed})
    # the control and the fault in the program's place, held to the same
    # limits
    sides = {}
    for k, v in others.items():
        got = compare(v, refr, refr["first_diffs"][k])
        sides[k] = dict(verdict(got, limits, {}), readings=got)
    run_rec = Run(files["cell"], cfg, tr, m, span, steps=steps, trace=trace)
    return {"correct": side["correct"], "attempted": len(steps),
            "failed": failed, "device": dev, "e2e": e2e, "run": run_rec,
            "checks": side["checks"], "readings": readings, "sides": sides}
