"""A serving cell: the port's ``ServeEngine.run_batch`` driven by a
closed loop for ``--seconds``, then judged.

Set-up draws the weights on the device from the seed, builds the engine
and serves one warm-up batch at the window's batch size, prompt length
and number of new tokens (every kernel and cuBLAS plan of the window is
made there), then serves it again for the traffic's ``warmup_seconds``
(default 0): a card held at its power limit by a compute-bound batch
swings its clock for some seconds before it settles, and the window
starts once it has. The window's clients send a batch of ``max_batch`` requests
as soon as the last returns, until the window's end; the batch under way
then is served to its end. ``serve_tokens_per_s`` is every served token
over the time from the window's start to the return of its last batch;
``ttft_p95_ms`` the 95th percentile over all requests of the time from
the call that sends a request to its return, which with one new token
carries its first token.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np

from . import blocks, judge, port
from . import trace as tracing
from . import traffic as traffic_gen
from .harness import Run, device_info, free_device
from .layout import dims
from .weights import draw_all, dtype_of


def _sync(torch, device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def serve_metrics(batches) -> Dict[str, float]:
    """serve_tokens_per_s: every served token over the time from the
    window's start to the return of its last batch; ttft_p95_ms: the 95th
    percentile over every request of its call to its batch's return."""
    span = batches[-1]["return_s"]
    served = sum(int(b["tokens"].size) for b in batches)
    ttft = [(b["return_s"] - b["call_s"]) * 1e3 for b in batches
            for _ in b["ids"]]
    return {"serve_tokens_per_s": served / span,
            "ttft_p95_ms": float(np.percentile(ttft, 95))}


def judged_rows(m, tr: Dict, seed: int, k: int) -> np.ndarray:
    """The requests of judged batch k: ``judge_requests`` of its rows
    drawn from the seed, or all of them. A block whose ``JUDGED_WHOLE``
    is set (a mixture of experts, its capacity taken over the batch's
    tokens together) is judged whole."""
    B = tr["max_batch"]
    n = tr.get("judge_requests", B)
    if n >= B:
        return np.arange(B)
    if blocks.load(m.block).JUDGED_WHOLE:
        raise ValueError(f"block {m.block!r} is judged a whole batch at a "
                         "time: leave out judge_requests")
    pick = traffic_gen.rng(seed, "judge_rows", k).choice(B, size=n,
                                                         replace=False)
    return np.sort(pick)


def run(name: str, files: Dict, seed: int, seconds: float, trace_on: bool,
        device: str, t_start: float) -> Dict:
    import torch
    cfg, tr, limits = files["config"], files["traffic"], files["limits"]
    m = dims(cfg)
    B, new = tr["max_batch"], tr["new_tokens"]
    arch = port.arch_config(m, cfg, cfg.get("name", name))
    dtype = dtype_of(cfg)
    parts = {"imports_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    params = port.params_from(arch, draw_all(seed, m, device, dtype))
    _sync(torch, device)
    parts["weights_s"] = time.perf_counter() - t
    engine = port.serve_engine(arch, params, B, tr["cache_len"], seed)

    warm = traffic_gen.prompts(tr, seed, traffic_gen.WARMUP, m.vocab)
    warm = [port.request(-1 - i, p, new) for i, p in enumerate(warm)]
    engine.run_batch(warm)
    t = time.perf_counter()
    while time.perf_counter() - t < tr.get("warmup_seconds", 0):
        engine.run_batch(warm)
    _sync(torch, device)
    setup_s = time.perf_counter() - t_start
    parts["warm_up_s"] = setup_s - parts["imports_s"] - parts["weights_s"]

    prof = tracing.start() if trace_on else None
    batches, phases = [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        k = len(batches)
        prompts = traffic_gen.prompts(tr, seed, k, m.vocab)
        ids = list(range(k * B, (k + 1) * B))
        reqs = [port.request(i, p, new) for i, p in zip(ids, prompts)]
        tc = time.perf_counter()
        comps = engine.run_batch(reqs)
        tret = time.perf_counter()
        phases.append(("run_batch", tc, tret))
        batches.append({
            "ids": ids, "prompts": prompts,
            "tokens": np.stack([c.tokens for c in comps]),
            "done": [len(c.tokens) == new for c in comps],
            "call_s": tc - t0, "return_s": tret - t0,
            "prefill_ms": comps[0].prefill_ms,
            "decode_ms": comps[0].decode_ms})
    t1 = time.perf_counter()
    if prof is not None:
        trace = tracing.read(tracing.stop(prof), t0, t1, phases)
    else:
        trace = None
    dev = device_info(torch, device, files["cell"]["chips"])

    attempted = sum(len(b["ids"]) for b in batches)
    failed = sum(not ok for b in batches for ok in b["done"])
    span = batches[-1]["return_s"]
    e2e = dict(serve_metrics(batches), setup_s=setup_s)

    # judge a sample of the window's batches, drawn from the seed, once
    # the program's state is freed
    del engine, params
    free_device(torch, device)
    pick = traffic_gen.rng(seed, "judge", 0).choice(
        len(batches), size=min(tr["judge_batches"], len(batches)),
        replace=False)
    tj = time.perf_counter()
    w = judge.Weights(seed, m, device, dtype)
    control = files.get("control", False)
    sums: Dict[str, list] = {}
    for k in sorted(pick):
        rows = judged_rows(m, tr, seed, k)
        g = judge.serve_gaps(m, w, batches[k]["prompts"][rows],
                             batches[k]["tokens"][rows], control)
        for key, v in g.items():
            sums.setdefault(key, []).append(v)
    del w
    free_device(torch, device)
    judged = sum(sums["tokens_judged"])
    readings = {"token_gap": max(sums["token_gap"]),
                "mean_gap": sum(sums["gap_sum"]) / judged,
                "tokens_judged": judged}
    side = judge.verdict(readings, limits, {"failed_requests": failed})
    sides = {}
    if control:
        # the control in the program's place: its tokens judged alike
        ctl = {"token_gap": max(sums["control_gap"]),
               "mean_gap": sum(sums["control_gap_sum"]) / judged,
               "tokens_judged": judged}
        sides["control"] = dict(judge.verdict(ctl, limits, {}), readings=ctl)
    run_rec = Run(files["cell"], cfg, tr, m, span, batches=batches,
                  trace=trace)
    readings.update(judge_s=time.perf_counter() - tj, setup_parts=parts)
    if device == "cuda":
        # the process's peak once the reference has run (the program's is
        # read before it)
        readings["peak_after_judge_bytes"] = torch.cuda.max_memory_allocated()
    return {"correct": side["correct"], "attempted": attempted,
            "failed": failed, "device": dev, "e2e": e2e, "run": run_rec,
            "checks": side["checks"], "readings": readings, "sides": sides}
