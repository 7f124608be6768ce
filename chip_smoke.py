"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the five CUDA sources from ``src/repro_torch/kernels/csrc``
with nvcc, one nvcc per source in parallel, and drives the port's two
paths:

  * the PD-ORS offer path: both offer-path kernels and their host-level
    calls against their plain torch versions on the card (bit for bit;
    near-ties at three magnitudes, unreachable rows, Q1 up to 1024, k
    up to 200, R from 1 to 8, NaN and negative free), then the paper's
    largest Fig. 6 point (H=100 machines, T=20 slots, 50 jobs, ethernet preset,
    workload_scale=0.3, batch=(50,200), quanta=20, seed 0) on the card
    and on the CPU, requiring identical decisions;
  * the online simulator (``repro_torch.launch.sim``) at the JAX package's
    largest simulator benchmark point (``benchmarks/bench_sim.py``
    FULL_GRID row 2: 16 machines, a 16-slot lookahead window, the google
    preset, 500 jobs at 6.0 arrivals a slot, failure rate 0.05, seed 0,
    quanta 12, 48 calibration jobs): PD-ORS on the card after a warm-up
    run and on the CPU, requiring an identical per-job decision log (every
    offer's admission and schedule, every outcome) and utility within rel
    1e-9, both offer kernels launched inside the event engine on every
    plan and sweep; fifo, drf and dorm on the card and on the CPU with
    identical logs; OASiS (R = 6 pseudo-resources) at the Fig. 6 point on
    the card and on the CPU, identical decisions;
  * the simulator's other paths (``launch.sim``'s tiers), each on the card
    against the CPU with both offer kernels launched: the sim point with
    ``bench_sim.py``'s chaos leg (rack-pair crashes and stragglers in the
    capacity mask, injected LP faults, pdors wrapped in
    ``ResilientPolicy``), identical decision logs, summaries and policy
    health; the same run checkpointed every 16 slots, killed at slot 64
    and recovered (summary, outcomes and ledger equal the uninterrupted
    run's; the checkpoint's and the restored ledgers on the card);
    ``bench_sim.py``'s elastic tier (8 machines, W = 16, google, 300 jobs
    at 4.0, failure 0.05, its reshape storm), batched and per-event
    engines bit-identical on the card and the batched run identical on
    the CPU; its service row (8 machines, W = 16, google, 1500 jobs at 4.0
    submitted 64 at a time through the asyncio ``OfferService``), each
    formed batch offered again through ``PDORS.offer_batch`` on the CPU
    with identical admissions; and, last, one profiled chaos run (idle
    share, spans by self time);
  * the serving path: the rmsnorm and flash-attention kernels (bf16 on
    the tensor cores, float32 on the CUDA cores) against their plain
    versions on the card, then Gemma-7B at full width and
    full depth (28 layers, random weights from seed 0, float32 params,
    bfloat16 compute) serving 8 requests of 1024 prompt tokens and 32
    new tokens, max_batch 4, greedy, through ``ServeEngine.serve``, with
    exact launch counts of both kernels, every prefill's attention on
    the tensor-core kernel, and the profiled run's rmsnorm device time
    split into its prefill-shape and decode-shape launches; then a
    2-layer float32 cut of the full-width model served on the card and
    on the CPU from the same weights, requiring identical greedy tokens.

It prints each path's numbers, the card's name and power limit, one JSON
line with each kernel's launches, error, times and bound (the offer
kernels also with their host-level call's time, copies included;
rmsnorm at the prefill shape (4096, 3072) and, nested, the decode shape
(4, 3072); flash attention on both routes; the offer kernels' launches
on the sim path beside the static path's, and on each of the chaos,
recover, elastic and service paths), and as its last line
``{"ok": true, "device": {...}}``. Every phase raises on
failure; the script exits nonzero without a result line when there is
no card or no port next to it.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12          # float64 outside the tensor cores
FP32_OPS_PER_S = 67e12          # float32 outside the tensor cores
BF16_OPS_PER_S = 989e12         # bfloat16 tensor cores, dense

# the serving run: Gemma-7B at full width and depth
SERVE_POINT = dict(arch="gemma-7b", requests=8, prompt_len=1024,
                   max_new=32, max_batch=4, seed=0)
# the cuda-vs-cpu parity run: the full-width model cut to 2 layers, f32
PARITY_POINT = dict(arch="gemma-7b", layers=2, requests=2, prompt_len=128,
                    max_new=8, seed=1)

PAPER_POINT = dict(machines=100, horizon=20, jobs=50, preset="ethernet",
                   workload_scale=0.3, batch=(50, 200), quanta=20, seed=0)
# the online simulator: bench_sim.py's FULL_GRID row 2, not cut
# (quanta 12 and 48 calibration jobs are launch.sim's, as bench_sim's)
SIM_POINT = dict(machines=16, lookahead=16, preset="google", jobs=500,
                 rate=6.0, failure_rate=0.05, seed=0)
SIM_BASELINES = ("fifo", "drf", "dorm")
# the chaos and recover phases run the sim point with bench_sim's chaos
# leg; the recover phase checkpoints every 16 slots and is killed at 64
RECOVER = dict(checkpoint_every=16, kill_at=64)
# bench_sim.py's ELASTIC_GRID row and STREAM_GRID row (the service row
# takes min(jobs, 1500) of its trace), not cut
ELASTIC_POINT = dict(machines=8, lookahead=16, preset="google", jobs=300,
                     rate=4.0, failure_rate=0.05, seed=0)
SERVICE_POINT = dict(machines=8, lookahead=16, preset="google",
                     jobs=100_000, rate=4.0, seed=0)


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _equal(a: torch.Tensor, b: torch.Tensor, what: str) -> float:
    """Bit-for-bit equality (NaN == NaN, inf == inf); returns max |a-b|
    over finite entries (0.0 when equal)."""
    x, y = a.cpu().numpy(), b.cpu().numpy()
    np.testing.assert_array_equal(x, y, err_msg=what)
    fin = np.isfinite(x) & np.isfinite(y)
    return float(np.max(np.abs(x[fin] - y[fin]), initial=0.0))


def _time_ms(fn, reps: int = 200, warmup: int = 10) -> float:
    """Mean time per call on the card's clock: CUDA events around
    ``reps`` back-to-back calls, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, name: str, reps: int = 50) -> float:
    """Mean device time of the kernel whose name contains ``name``, from
    torch.profiler; None when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    tot, n = 0.0, 0
    for ev in prof.key_averages():
        if name in ev.key:
            dev = getattr(ev, "device_time_total", None)
            if dev is None:
                dev = getattr(ev, "cuda_time_total", 0.0)
            tot += dev
            n += ev.count
    return (tot / n / 1e3) if n and tot > 0 else None


# --------------------------------------------------------------- inputs
def _bundle_inputs(gen, W, H, R, zero_cols=(), edges=False):
    price = torch.rand((W, H, R), generator=gen, dtype=torch.float64) * 8
    price += 0.1
    free = torch.rand((W, H, R), generator=gen, dtype=torch.float64) * 33
    free -= 3.0                               # < 0: over-committed
    wdem = (torch.rand(R, generator=gen, dtype=torch.float64) * 3).numpy()
    sdem = (torch.rand(R, generator=gen, dtype=torch.float64) * 3).numpy()
    for k in zero_cols:
        wdem[k] = 0.0
        sdem[(k + 1) % R] = 0.0
    if edges:                  # NaN, -inf and exact multiples of a demand
        flat = free.view(-1)
        flat[::7] = float("nan")
        flat[3::11] = -float("inf")
        free[..., R - 1] = 3.0 * wdem[R - 1]
    return price, free, wdem, sdem


def _sweep_inputs(gen, k, Q1, inf_frac=0.2):
    tc = torch.rand((k, Q1), generator=gen, dtype=torch.float64) * 100
    tc[torch.rand((k, Q1), generator=gen) < inf_frac] = float("inf")
    tc[:, 0] = 0.0
    return tc


def _near_tie_inputs(gen, k, Q1, mag):
    """tcost on a 0.1 * mag grid plus absolute offsets of 0.5e-12 to
    3e-12: rows whose candidates tie exactly, to an ulp, or within a few
    1e-12 on both sides of the hysteresis, so the kernel's replay of the
    scalar scan runs."""
    tc = torch.round(torch.rand((k, Q1), generator=gen,
                                dtype=torch.float64) * 50) / 10 * mag
    offs = torch.tensor([0.0, 5e-13, -5e-13, 1e-12, -1e-12, 1.5e-12, 2e-12,
                         -2e-12, 3e-12], dtype=torch.float64)
    tc += offs[torch.randint(0, len(offs), (k, Q1), generator=gen)]
    tc[torch.rand((k, Q1), generator=gen) < 0.1] = float("inf")
    tc[:, 0] = 0.0
    return tc


def check_kernels(pricing, minplus) -> dict:
    """Each kernel against its plain version on the card; returns the
    max abs error per kernel (0.0: bit-identical)."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    err = {"price_bundle": 0.0, "minplus_sweep": 0.0}
    gamma = 8.789275684645638           # coef's product rounds
    cases = [
        _bundle_inputs(gen, 20, 100, 4),
        _bundle_inputs(gen, 1, 100, 4),
        _bundle_inputs(gen, 37, 1000, 7, zero_cols=(1, 4)),
    ]
    # the kernel's widths, zero-demand columns, NaN / -inf / negative free
    for R in (1, 4, 7, 8):
        cases.append(_bundle_inputs(gen, 20, 100, R,
                                    zero_cols=(0,) if R > 1 else (),
                                    edges=True))
    # exact capacity: free=9, demand=3 gives head-room 3, not 2 or 4
    cases.append((torch.ones((2, 3, 1), dtype=torch.float64),
                  torch.full((2, 3, 1), 9.0, dtype=torch.float64),
                  np.array([3.0]), np.array([3.0])))
    # no positive demand: head-room +inf
    cases.append((torch.ones((2, 3, 4), dtype=torch.float64),
                  torch.ones((2, 3, 4), dtype=torch.float64),
                  np.zeros(4), np.zeros(4)))
    for i, (price, free, wdem, sdem) in enumerate(cases):
        price, free = price.to(dev), free.to(dev)
        got = pricing.price_bundle_batch_cuda(price, free, wdem, sdem, gamma)
        want = pricing.price_bundle_batch_torch(price, free, wdem, sdem,
                                                gamma)
        torch.cuda.synchronize()
        err["price_bundle"] = max(err["price_bundle"], _equal(
            got, want, f"price_bundle case {i} {tuple(price.shape)}"))
    # operands one double off a 16-byte boundary: element loads
    price, free, wdem, sdem = _bundle_inputs(gen, 20, 100, 4, edges=True)
    price, free = (torch.cat([torch.zeros(1, dtype=torch.float64),
                              a.reshape(-1)]).to(dev)[1:].view(a.shape)
                   for a in (price, free))
    aligned = (price.data_ptr() | free.data_ptr()) % 16 == 0
    if aligned or pricing.bundle_vec(4, aligned) != 1:
        raise AssertionError("offset operands took double2 loads")
    err["price_bundle"] = max(err["price_bundle"], _equal(
        pricing.price_bundle_batch_cuda(price, free, wdem, sdem, gamma),
        pricing.price_bundle_batch_torch(price, free, wdem, sdem, gamma),
        "price_bundle element loads"))
    edge = pricing.price_bundle_batch_cuda(
        cases[-2][0].to(dev), cases[-2][1].to(dev), cases[-2][2],
        cases[-2][3], 1.0)
    if not (edge[3] == 3.0).all():
        raise AssertionError("exact-capacity head-room is not 3")
    # the backend's host-level call against the CPU's
    price, free, wdem, sdem = cases[0]
    for g, w in zip(pricing.price_bundle_batch(price.to(dev), free.to(dev),
                                               wdem, sdem, gamma),
                    pricing.price_bundle_batch(price, free, wdem, sdem,
                                               gamma)):
        np.testing.assert_array_equal(g, w, err_msg="price_bundle host call")

    # every width and depth (k*Q1 past shared memory streams through the
    # ring), near-ties at three magnitudes, unreachable rows
    sweeps = [_sweep_inputs(gen, k, Q1)
              for Q1 in (1, 2, 21, 32, 33, 49, 100, 129, 1024)
              for k in (1, 3, 20, 200)]
    sweeps.append(_sweep_inputs(gen, 5, 49, inf_frac=0.0))
    sweeps += [_near_tie_inputs(gen, k, Q1, mag) for mag in (1.0, 1e3, 1e6)
               for k, Q1 in ((20, 21), (20, 33), (200, 49), (20, 100),
                             (3, 1024))]
    tie = torch.tensor([[0.0, 0.30000000000000004, 0.6],
                        [0.0, 0.3, 0.6000000000000001]], dtype=torch.float64)
    sweeps.append(tie)
    unreach = torch.full((4, 21), float("inf"), dtype=torch.float64)
    unreach[:, 0] = 0.0
    sweeps.append(unreach)
    sweeps.append(torch.full((3, 2), float("inf"), dtype=torch.float64))
    sweeps.append(torch.full((200, 1024), float("inf"), dtype=torch.float64))
    ring = 0
    for i, tc in enumerate(sweeps):
        ring += minplus.sweep_layout(*tc.shape).ring
        tc = tc.to(dev)
        gc, gch = minplus.minplus_sweep_cuda(tc)
        wc, wch = minplus.minplus_sweep_torch(tc)
        torch.cuda.synchronize()
        err["minplus_sweep"] = max(err["minplus_sweep"], _equal(
            gc, wc, f"minplus_sweep values case {i} {tuple(tc.shape)}"))
        _equal(gch, wch, f"minplus_sweep choice case {i}")
    if ring < 3:
        raise AssertionError("too few sweeps streamed tcost through the ring")
    # the DP's host-level call against the CPU's
    tc = _near_tie_inputs(gen, 20, 21, 1.0).numpy()
    for g, w in zip(minplus.minplus_sweep_host(tc, dev),
                    minplus.minplus_sweep_host(tc, "cpu")):
        np.testing.assert_array_equal(g, w, err_msg="minplus_sweep host call")
    return err


# ------------------------------------------------------------ main path
def decision_trace(records) -> list:
    """(job id, admitted, slot -> (workers, PSs)) of each record."""
    out = []
    for r in records:
        slots = None
        if r.schedule is not None:
            slots = {t: (sorted(a.workers.items()), sorted(a.ps.items()))
                     for t, a in r.schedule.slots.items()}
        out.append((r.job.job_id, r.admitted, slots))
    return out


def run_main_path(rt, trace, device: str):
    p = PAPER_POINT
    jobs = rt.synthetic_jobs(rt.WorkloadConfig(
        num_jobs=p["jobs"], horizon=p["horizon"], seed=p["seed"],
        batch=p["batch"], workload_scale=p["workload_scale"]))
    cluster = rt.make_cluster(p["machines"], p["horizon"], preset=p["preset"],
                              device=device)
    tracer = trace.Tracer()
    with trace.activate(tracer):
        t0 = time.perf_counter()
        res = rt.run_pdors(jobs, cluster, quanta=p["quanta"], seed=p["seed"])
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return jobs, res, wall, tracer


def device_busy_share(rt, trace) -> tuple:
    """(wall s, device-busy s) of one main-path run under torch.profiler:
    busy is the summed self device time of every kernel and copy."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, wall, _ = run_main_path(rt, trace, "cuda")
    busy_us = sum(getattr(ev, "self_device_time_total",
                          getattr(ev, "self_cuda_time_total", 0.0))
                  for ev in prof.key_averages())
    return wall, busy_us / 1e6


# ----------------------------------------------------------- online sim
def _alloc(a) -> tuple:
    return (tuple(sorted(a.workers.items())), tuple(sorted(a.ps.items())))


def record_decisions(policy) -> list:
    """Log every decision ``policy`` returns to the engine: each ARRIVAL
    batch's admissions and committed schedules, each SLOT tick's grants."""
    log = []
    inner = policy.offer

    def offer(event, view):
        dec = inner(event, view)
        if event.kind.name in ("ARRIVAL", "SLOT"):
            log.append((
                event.time, event.kind.name,
                tuple(sorted(dec.admitted.items())),
                tuple((j, tuple((t, _alloc(a)) for t, a in sorted(s.items())))
                      for j, s in sorted(dec.schedules.items())),
                tuple((j, _alloc(a)) for j, a in sorted(dec.grants.items())),
            ))
        return dec

    policy.offer = offer
    return log


def outcome_rows(engine) -> list:
    return [tuple(sorted(dataclasses.asdict(oc).items()))
            for _, oc in sorted(engine.metrics.outcomes.items())]


def run_sim(launch_sim, name: str, device: str, tracer=None,
            point=SIM_POINT, **tier) -> dict:
    """One replay of ``point`` (default: the sim point) through
    ``launch.sim``'s engine, with the decision log and each job's outcome
    row kept; ``tier`` passes ``faults``, ``elastic`` or ``engine_mode``
    on to ``make_engine``."""
    engine, events = launch_sim.make_engine(name, device=device,
                                            tracer=tracer, **point, **tier)
    log = record_decisions(engine.policy)
    report, wall = launch_sim.run_engine(engine, events)
    return {"report": report, "engine": engine, "wall": wall,
            "log": log, "rows": outcome_rows(engine)}


def same_sim_run(a: dict, b: dict, what: str) -> None:
    """Identical decision logs, outcome rows and summaries; utility within
    rel 1e-9."""
    if a["log"] != b["log"]:
        i = next(i for i, (x, y) in enumerate(zip(a["log"], b["log"]))
                 if x != y) if len(a["log"]) == len(b["log"]) else None
        raise AssertionError(f"{what}: decision logs differ (first at "
                             f"{i}: {a['log'][i] if i is not None else ''}"
                             f" vs {b['log'][i] if i is not None else ''})")
    if a["rows"] != b["rows"]:
        raise AssertionError(f"{what}: per-job outcome rows differ")
    sa, sb = a["report"].summary, b["report"].summary
    ua, ub = sa["total_utility"], sb["total_utility"]
    if {k: v for k, v in sa.items() if k != "total_utility"} != \
            {k: v for k, v in sb.items() if k != "total_utility"} \
            or a["report"].slots_run != b["report"].slots_run:
        raise AssertionError(f"{what}: summaries differ")
    if not (np.isfinite(ua) and abs(ua - ub) <= 1e-9 * abs(ub)):
        raise AssertionError(f"{what}: utility {ua} != {ub}")


def sim_line(name: str, device: str, r: dict) -> str:
    s = r["report"].summary
    return (f"  {name} on {device}: wall {r['wall']:.4f} s = "
            f"{SIM_POINT['jobs'] / r['wall']:.2f} jobs/s, slots run "
            f"{r['report'].slots_run}, admitted {s['jobs_admitted']}, "
            f"completed {s['jobs_completed']}/{s['jobs_offered']}, "
            f"preemptions {s['preemptions']}, utility "
            f"{s['total_utility']!r}, JCT p50 {s['jct_p50']} p95 "
            f"{s['jct_p95']}")


def _launches(pricing, minplus) -> dict:
    return {"price_bundle": pricing.LAUNCHES,
            "minplus_sweep": minplus.LAUNCHES}


def _require_launches(launches: dict, what: str) -> None:
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} kernel never launched in {what}")


def _require_cuda_spans(tracer, what: str) -> dict:
    spans = {"plan.bundle": 0, "dp.sweep": 0}
    for sp in tracer.spans:
        if sp.name in spans:
            spans[sp.name] += 1
            if sp.attrs.get("backend") != "cuda":
                raise AssertionError(f"{what}: {sp.name} ran on {sp.attrs}")
    if not all(spans.values()):
        raise AssertionError(f"{what}: no offer spans {spans}")
    return spans


def online_sim(rt, launch_sim, trace, pricing, minplus) -> dict:
    """The online simulator on the card against the CPU: PD-ORS, the three
    slot-driven baselines, and OASiS at the Fig. 6 point."""
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.perf_counter()
    warm = run_sim(launch_sim, "pdors", "cuda")
    pricing.LAUNCHES = 0
    minplus.LAUNCHES = 0
    tracer = trace.Tracer()
    gpu = run_sim(launch_sim, "pdors", "cuda", tracer)
    launches = _launches(pricing, minplus)
    _require_launches(launches, "the online sim")
    spans = _require_cuda_spans(tracer, "online sim")
    cpu = run_sim(launch_sim, "pdors", "cpu")
    same_sim_run(gpu, cpu, "pdors cuda vs cpu")
    same_sim_run(warm, gpu, "pdors warm-up vs counted run")
    rows = [sim_line("pdors", "cuda", gpu), sim_line("pdors", "cpu", cpu)]
    table = tracer.phase_table()
    top = sorted(table.items(), key=lambda kv: -kv[1]["self_s"])[:10]
    adm = gpu["engine"].admission_latency()

    base = {}
    for name in SIM_BASELINES:
        g = run_sim(launch_sim, name, "cuda")
        c = run_sim(launch_sim, name, "cpu")
        same_sim_run(g, c, f"{name} cuda vs cpu")
        rows += [sim_line(name, "cuda", g), sim_line(name, "cpu", c)]
        base[name] = {"wall": g["wall"], "cpu_wall": c["wall"],
                      "jobs_per_s": SIM_POINT["jobs"] / g["wall"]}

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prof_run = run_sim(launch_sim, "pdors", "cuda")
    busy = sum(getattr(ev, "self_device_time_total",
                       getattr(ev, "self_cuda_time_total", 0.0))
               for ev in prof.key_averages()) / 1e6

    # OASiS at the Fig. 6 point: the bundle kernel at R = 6
    p = PAPER_POINT
    jobs = rt.synthetic_jobs(rt.WorkloadConfig(
        num_jobs=p["jobs"], horizon=p["horizon"], seed=p["seed"],
        batch=p["batch"], workload_scale=p["workload_scale"]))
    oasis = {}
    for device in ("cuda", "cpu"):
        pricing.LAUNCHES = 0
        t0 = time.perf_counter()
        res = rt.core.run_oasis(jobs, rt.make_cluster(
            p["machines"], p["horizon"], preset=p["preset"], device=device),
            quanta=p["quanta"], seed=p["seed"])
        oasis[device] = (res, time.perf_counter() - t0, pricing.LAUNCHES)
    if oasis["cuda"][2] <= 0:
        raise AssertionError("OASiS never launched the bundle kernel")
    if decision_trace(oasis["cuda"][0].records) != \
            decision_trace(oasis["cpu"][0].records):
        raise AssertionError("OASiS: cuda and cpu made different decisions")
    uo, uc = oasis["cuda"][0].total_utility, oasis["cpu"][0].total_utility
    if not (np.isfinite(uo) and abs(uo - uc) <= 1e-9 * abs(uc)):
        raise AssertionError(f"OASiS utility {uo} != {uc}")
    return {"gpu": gpu, "warm_wall": warm["wall"], "launches": launches,
            "spans": spans, "rows": rows, "top": top, "admission": adm,
            "baselines": base, "busy": busy, "prof_wall": prof_run["wall"],
            "oasis": oasis, "wall": time.perf_counter() - t_phase}


# ----------------------------------- chaos, recovery, elastic, service
def _ledger_on_card(cl, what: str, read: bool) -> None:
    """The cluster's ledger is a CUDA tensor, and every version-keyed
    cache that claims the current version agrees with a fresh read of it;
    ``read`` also reads every slot through the caches."""
    if cl._used.device.type != "cuda":
        raise AssertionError(f"{what}: ledger on {cl._used.device}")
    used = cl.backend.to_host(cl._used)
    free = cl.capacity_matrix[None] - used
    for name, want in (("_used_host", used), ("_free_host", free)):
        ent = getattr(cl, name)
        if ent is not None and ent[0] == cl.version and \
                not np.array_equal(ent[1], want):
            raise AssertionError(f"{what}: stale {name}")
    if read:
        for t in range(cl.horizon):
            if not (np.array_equal(cl.used_matrix(t), used[t]) and
                    np.array_equal(cl.free_matrix(t), free[t])):
                raise AssertionError(f"{what}: cached slot {t} is stale")


def chaos_sim(launch_sim, trace, pricing, minplus) -> dict:
    """The sim point with bench_sim's chaos leg (crashes and stragglers
    over rack pairs, injected LP faults, pdors resilient-wrapped) on the
    card and on the CPU: identical decision logs, outcomes, summaries and
    policy health; both kernels launched, every offer span on cuda; the
    capacity-mask overcommit checks (each a whole-ledger copy to the
    host) counted."""
    from repro_torch.core.cluster import Cluster
    t_phase = time.perf_counter()
    checks = [0]
    overcommitted = Cluster.machine_overcommitted

    def counted(self, h, tol=1e-6):
        checks[0] += 1
        return overcommitted(self, h, tol)

    pricing.LAUNCHES = 0
    minplus.LAUNCHES = 0
    tracer = trace.Tracer()
    Cluster.machine_overcommitted = counted
    try:
        gpu = run_sim(launch_sim, "pdors", "cuda", tracer, faults=True)
    finally:
        Cluster.machine_overcommitted = overcommitted
    launches = _launches(pricing, minplus)
    _require_launches(launches, "the chaos run")
    spans = _require_cuda_spans(tracer, "chaos")
    cpu = run_sim(launch_sim, "pdors", "cpu", faults=True)
    same_sim_run(gpu, cpu, "chaos pdors cuda vs cpu")
    return {"gpu": gpu, "cpu_wall": cpu["wall"], "launches": launches,
            "spans": spans, "overcommit_checks": checks[0],
            "admission": gpu["engine"].admission_latency(),
            "wall": time.perf_counter() - t_phase}


def recover_sim(launch_sim, pricing, minplus, want: dict) -> dict:
    """The chaos run on the card, checkpointed every 16 slots and killed
    at slot 64, then recovered from the regenerated stream: the snapshot
    and the restored ledger are on the card with fresh caches, and the
    recovered summary, slot count and outcome rows equal the
    uninterrupted cuda run's (``want``)."""
    from repro_torch.sim import SimKilled
    engine, events = launch_sim.make_engine("pdors", device="cuda",
                                            faults=True, **SIM_POINT,
                                            **RECOVER)
    taken = [0]
    take = engine._take_checkpoint

    def counted(t):
        taken[0] += 1
        take(t)

    engine._take_checkpoint = counted
    pricing.LAUNCHES = 0
    minplus.LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        engine.run(events)
    except SimKilled:
        pass
    else:
        raise AssertionError("the recover run was not killed")
    killed_wall = time.perf_counter() - t0
    snap = engine._checkpoint
    _ledger_on_card(snap.state[0].cluster, "checkpoint", read=False)
    t0 = time.perf_counter()
    report = engine.recover(launch_sim.make_events(faults=True, **SIM_POINT))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches(pricing, minplus)
    _require_launches(launches, "the recover run")
    _ledger_on_card(engine.window.cluster, "recovered ledger", read=True)
    if report.summary != want["report"].summary or \
            report.slots_run != want["report"].slots_run:
        raise AssertionError("recovered summary != uninterrupted summary")
    if outcome_rows(engine) != want["rows"]:
        raise AssertionError("recovered outcome rows differ")
    if not torch.equal(engine.window.cluster._used,
                       want["engine"].window.cluster._used):
        raise AssertionError("recovered ledger differs")
    return {"checkpoints": taken[0], "slot": snap.slot,
            "consumed": snap.consumed, "killed_wall": killed_wall,
            "wall": wall, "launches": launches}


def elastic_sim(launch_sim, trace, pricing, minplus) -> dict:
    """bench_sim's elastic tier, pdors: the reshape storm through the
    batched engine on the card (counted), the per-event oracle on the card
    (bit-identical: summary, slots, ledger, journal, outcomes) and the
    batched engine on the CPU (identical decision logs)."""
    t_phase = time.perf_counter()
    pricing.LAUNCHES = 0
    minplus.LAUNCHES = 0
    tracer = trace.Tracer()
    gb = run_sim(launch_sim, "pdors", "cuda", tracer, point=ELASTIC_POINT,
                 elastic=True, engine_mode="batched")
    launches = _launches(pricing, minplus)
    _require_launches(launches, "the elastic run")
    spans = _require_cuda_spans(tracer, "elastic")
    ge = run_sim(launch_sim, "pdors", "cuda", point=ELASTIC_POINT,
                 elastic=True, engine_mode="event")
    eb, ee = gb["engine"], ge["engine"]
    if gb["report"].summary != ge["report"].summary or \
            gb["report"].slots_run != ge["report"].slots_run or \
            not torch.equal(eb.window.cluster._used,
                            ee.window.cluster._used) or \
            eb.journal != ee.journal or \
            eb.metrics.outcomes != ee.metrics.outcomes:
        raise AssertionError("elastic: batched and event engines differ")
    cb = run_sim(launch_sim, "pdors", "cpu", point=ELASTIC_POINT,
                 elastic=True, engine_mode="batched")
    same_sim_run(gb, cb, "elastic pdors cuda vs cpu")
    return {"gpu": gb, "event_wall": ge["wall"], "cpu_wall": cb["wall"],
            "launches": launches, "spans": spans,
            "wall": time.perf_counter() - t_phase}


def service_sim(launch_sim, pricing, minplus) -> dict:
    """bench_sim's service row on the card: jobs submitted 64 at a time
    through the asyncio ``OfferService``; each batch it formed (how they
    form depends on timing) is offered again through ``PDORS.offer_batch``
    on the CPU, requiring the same admissions and schedules."""
    sched, jobs = launch_sim.make_service_point(device="cuda",
                                                **SERVICE_POINT)
    batches = []
    offer_batch = sched.offer_batch

    def recorded(batch):
        batches.append([j.job_id for j in batch])
        return offer_batch(batch)

    sched.offer_batch = recorded
    pricing.LAUNCHES = 0
    minplus.LAUNCHES = 0
    run = launch_sim.drive_service(sched, jobs, SERVICE_POINT["machines"])
    launches = _launches(pricing, minplus)
    _require_launches(launches, "the service run")
    if len(batches) != run["batches"] or \
            sorted(i for b in batches for i in b) != \
            sorted(j.job_id for j in jobs):
        raise AssertionError("service: batches do not cover the jobs")
    cpu, cpu_jobs = launch_sim.make_service_point(device="cpu",
                                                  **SERVICE_POINT)
    by_id = {j.job_id: j for j in cpu_jobs}
    t0 = time.perf_counter()
    want = [r for b in batches
            for r in cpu.offer_batch([by_id[i] for i in b])]
    cpu_wall = time.perf_counter() - t0
    got = sorted(decision_trace(run["records"]), key=lambda d: d[0])
    if got != sorted(decision_trace(want), key=lambda d: d[0]):
        raise AssertionError("service: cuda and cpu admissions differ")
    admitted = sum(1 for r in run["records"] if r.admitted)
    if run["grants"] != admitted:
        raise AssertionError(f"service: {run['grants']} grants polled for "
                             f"{admitted} admissions")
    return {"jobs": len(jobs), "admitted": admitted,
            "batches": run["batches"],
            "sizes": sorted({len(b) for b in batches}),
            "wall": run["wall"], "cpu_wall": cpu_wall,
            "latency": run["latency"], "launches": launches}


def chaos_profiled(launch_sim, trace) -> dict:
    """One cuda chaos run under torch.profiler and a tracer: the device's
    busy time (summed self device time of every kernel and copy) and the
    top spans by self time."""
    from torch.profiler import ProfilerActivity, profile
    tracer = trace.Tracer()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        r = run_sim(launch_sim, "pdors", "cuda", tracer, faults=True)
    busy = sum(getattr(ev, "self_device_time_total",
                       getattr(ev, "self_cuda_time_total", 0.0))
               for ev in prof.key_averages()) / 1e6
    top = sorted(tracer.phase_table().items(),
                 key=lambda kv: -kv[1]["self_s"])[:10]
    return {"wall": r["wall"], "busy": busy, "top": top}


# ---------------------------------------------------------------- times
def _host_ms(fn, reps: int = 500, warmup: int = 20) -> float:
    """Mean time per call on the host's clock, for a call that ends in a
    sync of its own (the host-level calls the offer path makes)."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def bundle_numbers(pricing, price, free, wdem, sdem, gamma) -> dict:
    W, H, R = price.shape
    nnz_w = int(np.count_nonzero(wdem))
    nnz_s = int(np.count_nonzero(sdem))
    pos = int((wdem > 0).sum() + (sdem > 0).sum())
    ops = W * H * (2 * nnz_w + 2 * nnz_s + 2 * R + 2 * pos)
    nbytes = 8 * (2 * W * H * R + 3 * R + 5 * W * H)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP64_OPS_PER_S * 1e3
    coef = torch.from_numpy(np.stack([wdem, sdem, wdem * gamma + sdem],
                                     axis=1)).to(price.device)   # (R, 3)
    flat = price.reshape(W * H, R)
    return {
        "ms": _time_ms(lambda: pricing.price_bundle_batch_cuda(
            price, free, wdem, sdem, gamma)),
        "device_ms": _device_ms(lambda: pricing.price_bundle_batch_cuda(
            price, free, wdem, sdem, gamma), "price_bundle"),
        # what a plan pays: launch, copy back, sync (plan.bundle's call)
        "host_ms": _host_ms(lambda: pricing.price_bundle_batch(
            price, free, wdem, sdem, gamma)),
        "plain_ms": _time_ms(lambda: pricing.price_bundle_batch_torch(
            price, free, wdem, sdem, gamma), reps=50),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": _time_ms(lambda: torch.matmul(flat, coef)),
    }


def sweep_numbers(minplus, tcost) -> dict:
    k, Q1 = tcost.shape
    # finite (prev, tcost) pairs the scan adds and compares, this input
    C, _ = minplus.minplus_sweep_torch(tcost)
    fin_c = torch.isfinite(C[:-1]).cpu().numpy()
    fin_t = torch.isfinite(tcost).cpu().numpy()
    pairs = 0
    for s in range(k):
        for u in range(Q1):
            pairs += int(np.sum(fin_c[s, u::-1][:u + 1] & fin_t[s, :u + 1]))
    ops = 2 * pairs
    nbytes = 8 * (k * Q1 + 2 * (k + 1) * Q1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP64_OPS_PER_S * 1e3
    host = tcost.cpu().numpy()
    return {
        "ms": _time_ms(lambda: minplus.minplus_sweep_cuda(tcost)),
        "device_ms": _device_ms(lambda: minplus.minplus_sweep_cuda(tcost),
                                "minplus_sweep"),
        # the DP's call: copy in, launch, copy back, sync (dp.sweep's)
        "host_ms": _host_ms(lambda: minplus.minplus_sweep_host(
            host, tcost.device)),
        "plain_ms": _time_ms(lambda: minplus.minplus_sweep_torch(tcost),
                             reps=10, warmup=2),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }


# ------------------------------------------------ serving path: kernels
def _max_err(got: torch.Tensor, want: torch.Tensor, what: str, **tol) -> float:
    """Hold ``got`` to ``want`` in float32 within ``tol``; returns the max
    abs difference."""
    g, w = got.float(), want.float()
    torch.testing.assert_close(g, w, msg=lambda m: f"{what}: {m}", **tol)
    return float((g - w).abs().max())


def check_model_kernels(rmsnorm, flash) -> dict:
    """rmsnorm and flash attention against their plain versions on the
    card, at the serving path's shapes and the edge cases; returns the
    max abs error per kernel."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2)
    err = {"rmsnorm": 0.0, "flash_attention": 0.0}
    for N, d in [(4096, 3072), (4, 3072), (1024 * 64, 128), (96, 512),
                 (16, 12288), (5, 50), (300, 1)]:
        for dt in (torch.float32, torch.bfloat16):
            x = (torch.randn((N, d), generator=gen) * 3).to(dt).to(dev)
            scale = (torch.randn((d,), generator=gen) + 1).to(dev)
            tol = dict(rtol=8e-3, atol=1e-6) if dt == torch.bfloat16 \
                else dict(rtol=1e-5, atol=1e-5)
            err["rmsnorm"] = max(err["rmsnorm"], _max_err(
                rmsnorm.rmsnorm_cuda(x, scale),
                rmsnorm.rmsnorm_torch(x, scale),
                f"rmsnorm ({N}, {d}) {dt}", **tol))
    cases = [  # B, S_q, S_k, H, KV, D, causal, window, dtypes
        (4, 1024, 1024, 16, 16, 256, True, 0, ("bf16", "f32")),
        (2, 512, 512, 64, 8, 128, True, 0, ("bf16", "f32")),
        (1, 200, 200, 4, 2, 256, True, 0, ("bf16", "f32")),
        (2, 128, 256, 4, 4, 64, False, 0, ("bf16", "f32")),
        (1, 512, 512, 4, 4, 128, True, 32, ("bf16", "f32")),
        (1, 512, 512, 4, 4, 128, True, 128, ("bf16", "f32")),
        (1, 200, 200, 4, 2, 80, True, 0, ("bf16", "f32")),  # D % 16 != 0
        (1, 64, 64, 2, 2, 20, True, 0, ("bf16", "f32")),    # D % 8 != 0
        (1, 130, 130, 2, 1, 50, True, 0, ("bf16", "f32")),  # D % 4 != 0
    ]
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    for B, S_q, S_k, H, KV, D, causal, window, names in cases:
        for name in names:
            dt = dts[name]
            q, k, v = (torch.randn(shape, generator=gen).to(dt).to(dev)
                       for shape in ((B, S_q, H, D), (B, S_k, KV, D),
                                     (B, S_k, KV, D)))
            tol = dict(rtol=2e-2, atol=2e-2) if name == "bf16" \
                else dict(rtol=2e-5, atol=2e-5)
            err["flash_attention"] = max(err["flash_attention"], _max_err(
                flash.flash_attention_cuda(q, k, v, causal, window),
                flash.flash_attention_torch(q, k, v, causal, window),
                f"flash {(B, S_q, S_k, H, KV, D)} causal={causal} "
                f"window={window} {name}", **tol))
    # float32 q, k, v 4 bytes off a 16-byte boundary: element-wise loader
    shape = (1, 160, 4, 256)
    n = int(np.prod(shape))
    q, k, v = (torch.randn((n + 1,), generator=gen).to(dev)[1:].view(shape)
               for _ in range(3))
    if flash.vector_loads(256, q, k, v):
        raise AssertionError("offset float32 inputs took 16-byte loads")
    err["flash_attention"] = max(err["flash_attention"], _max_err(
        flash.flash_attention_cuda(q, k, v),
        flash.flash_attention_torch(q, k, v), "flash f32 unaligned",
        rtol=2e-5, atol=2e-5))
    # window 1: every query attends to itself alone, so out == v
    q, k, v = (torch.randn((1, 128, 2, 64), generator=gen).to(dev) * 3
               for _ in range(3))
    err["flash_attention"] = max(err["flash_attention"], _max_err(
        flash.flash_attention_cuda(q, k, v, True, 1), v, "flash window=1",
        rtol=1e-5, atol=1e-5))
    torch.cuda.synchronize()
    return err


# ---------------------------------------------- serving path: main path
def _requests(Request, vocab: int, n: int, length: int, max_new: int,
              seed: int):
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, vocab, length).astype(np.int32),
                    max_new_tokens=max_new) for i in range(n)]


def serve_full_width(rmsnorm, flash) -> dict:
    """Gemma-7B, all 28 layers, on the card through ServeEngine.serve;
    raises unless every completion, the prefill logits and the launch
    counts are right. Returns the run's numbers."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServeEngine

    p = SERVE_POINT
    cfg = get_config(p["arch"])
    cache_len = p["prompt_len"] + p["max_new"] + 8
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = build_model(cfg).init(p["seed"], "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = ServeEngine(cfg, params, max_batch=p["max_batch"],
                         cache_len=cache_len)
    torch.cuda.synchronize()
    setup_peak = torch.cuda.max_memory_allocated()
    del params                  # the engine keeps the bf16 copy it reads
    reqs = _requests(Request, cfg.vocab_size, p["requests"],
                     p["prompt_len"], p["max_new"], p["seed"])

    # warm-up (first use of each cuBLAS shape), and the prefill logits
    first = torch.from_numpy(np.stack([r.prompt for r in reqs[:4]])).long()
    logits, _ = engine.model.prefill(engine.params,
                                     {"tokens": first.cuda()}, cache_len)
    if logits.shape != (4, 1, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} are "
                             f"not finite (4, 1, {cfg.vocab_size})")
    del logits
    engine.run_batch([dataclasses.replace(r, max_new_tokens=2)
                      for r in reqs[:4]])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rmsnorm.LAUNCHES = 0
    flash.LAUNCHES = 0
    t0 = time.perf_counter()
    done = engine.serve(reqs)
    wall = time.perf_counter() - t0
    launches = {"rmsnorm": rmsnorm.LAUNCHES,
                "flash_attention": flash.LAUNCHES}
    serve_peak = torch.cuda.max_memory_allocated()

    batches = -(-p["requests"] // p["max_batch"])
    forwards = batches * p["max_new"]            # 1 prefill + 31 decodes
    want = {"rmsnorm": forwards * (2 * cfg.num_layers + 1),
            "flash_attention": batches * cfg.num_layers}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if sorted(c.request_id for c in done) != list(range(p["requests"])):
        raise AssertionError("not every request was answered")
    for c in done:
        if c.tokens.shape != (p["max_new"],) or c.tokens.min() < 0 or \
                c.tokens.max() >= cfg.vocab_size:
            raise AssertionError(f"request {c.request_id}: bad tokens "
                                 f"{c.tokens}")

    # the same run under the profiler: device busy time by kernel
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        engine.serve(reqs)
        prof_wall = time.perf_counter() - t1
    norm_split = rmsnorm_by_shape(prof, batches, cfg.num_layers)
    by_kernel, flash_calls = {}, {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + dev_us / 1e6
        if "flash_fwd_kernel" in ev.key:
            flash_calls[ev.key] = flash_calls.get(ev.key, 0) + ev.count
    # every prefill's attention ran on the tensor-core kernel
    if len(flash_calls) != 1 or \
            "flash_fwd_kernel_tc" not in next(iter(flash_calls)) or \
            sum(flash_calls.values()) != want["flash_attention"]:
        raise AssertionError(f"profiled serving run's attention kernels "
                             f"{flash_calls}, want {want['flash_attention']}"
                             f" launches of flash_fwd_kernel_tc")
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]

    per_batch = sorted({(c.prefill_ms, c.decode_ms) for c in done})
    n_tok = sum(len(c.tokens) for c in done)
    out = dict(init_s=init_s, wall=wall, tokens=n_tok,
               tok_per_s=n_tok / wall, per_batch=per_batch,
               setup_peak_gb=setup_peak / 1e9, serve_peak_gb=serve_peak / 1e9,
               launches=launches, flash_calls=flash_calls,
               prof_wall=prof_wall, busy=busy,
               idle=1 - busy / prof_wall, top=top,
               rmsnorm_s=sum(t for k, t in by_kernel.items()
                             if "rmsnorm_kernel" in k),
               rmsnorm_split=norm_split,
               flash_s=sum(t for k, t in by_kernel.items()
                           if "flash_fwd_kernel" in k))
    del engine
    torch.cuda.empty_cache()
    return out


def rmsnorm_by_shape(prof, batches: int, layers: int):
    """The profiled serving run's rmsnorm device time split by launch
    shape. The engine fixes the order of the launches, and the exact
    launch count holds it: each batch's prefill runs 2 * layers norms at
    (max_batch * prompt_len, d), then its final norm and every decode
    forward run at (max_batch, d). The launches, in device order, are
    split so; None when the profiler lost a launch."""
    evs = sorted((ev for ev in prof.events()
                  if "rmsnorm_kernel" in ev.name),
                 key=lambda ev: ev.time_range.start)
    per_batch, rem = divmod(len(evs), batches)
    if rem or not evs:
        return None
    out = {"prefill_shape": [0, 0.0], "decode_shape": [0, 0.0]}
    for i, ev in enumerate(evs):
        side = out["prefill_shape" if i % per_batch < 2 * layers
                   else "decode_shape"]
        side[0] += 1
        side[1] += (ev.time_range.end - ev.time_range.start) / 1e6
    return {k: {"launches": n, "device_s": t, "us_per_launch": t / n * 1e6}
            for k, (n, t) in out.items()}


def parity_cuda_cpu() -> dict:
    """The full-width model cut to 2 layers in float32, served on the
    card and on the CPU from the same weights: identical greedy tokens,
    last-position prefill logits within rtol=atol 1e-3."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, lm
    from repro_torch.serve import Request, ServeEngine

    p = PARITY_POINT
    cfg = dataclasses.replace(get_config(p["arch"]), num_layers=p["layers"],
                              compute_dtype="float32")
    model = build_model(cfg)
    gpu = model.init(p["seed"], "cuda")
    cpu = lm.LM(cfg, "cpu")
    cpu.load_state_dict(gpu.state_dict())
    cache_len = p["prompt_len"] + p["max_new"] + 8
    reqs = _requests(Request, cfg.vocab_size, p["requests"], p["prompt_len"],
                     p["max_new"], p["seed"])
    tokens = torch.from_numpy(np.stack([r.prompt for r in reqs])).long()
    lg, _ = model.prefill(gpu, {"tokens": tokens.cuda()}, cache_len)
    lc, _ = model.prefill(cpu, {"tokens": tokens}, cache_len)
    err = _max_err(lg.cpu(), lc, "parity prefill logits", rtol=1e-3,
                   atol=1e-3)
    out = {}
    for name, params in (("cuda", gpu), ("cpu", cpu)):
        engine = ServeEngine(cfg, params, max_batch=p["requests"],
                             cache_len=cache_len)
        t0 = time.perf_counter()
        out[name] = engine.serve(reqs)
        out[name + "_s"] = time.perf_counter() - t0
    for g, c in zip(out["cuda"], out["cpu"]):
        if not np.array_equal(g.tokens, c.tokens):
            raise AssertionError(f"request {g.request_id}: cuda tokens "
                                 f"{g.tokens} != cpu {c.tokens}")
    del gpu
    torch.cuda.empty_cache()
    return dict(logits_err=err, tokens=[c.tokens.tolist()
                                        for c in out["cuda"]],
                cuda_s=out["cuda_s"], cpu_s=out["cpu_s"])


# ----------------------------------------------- serving path: times
def rmsnorm_numbers(rmsnorm, x, scale) -> dict:
    N, d = x.shape
    nbytes = 2 * N * d * x.element_size() + d * scale.element_size()
    ops = 4 * N * d                  # square, add; multiply twice
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    w = scale.to(x.dtype)
    return {
        "shape": [N, d], "dtype": str(x.dtype).replace("torch.", ""),
        "ms": _time_ms(lambda: rmsnorm.rmsnorm_cuda(x, scale)),
        "device_ms": _device_ms(lambda: rmsnorm.rmsnorm_cuda(x, scale),
                                "rmsnorm_kernel"),
        "plain_ms": _time_ms(lambda: rmsnorm.rmsnorm_torch(x, scale)),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": _time_ms(lambda: torch.nn.functional.rms_norm(
            x, (d,), w, 1e-6)),
    }


def flash_numbers(flash, q, k, v) -> dict:
    """The attention kernel's route for q's dtype at (B, S, H, D) causal
    with k.shape[2] kv heads: times, bound, and the achieved TFLOP/s and
    share of the bound on the kernel's device time."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    pairs = int(flash.allowed(S, S, True, 0).sum())
    ops = 4 * B * H * D * pairs
    nbytes = 2 * (q.numel() + k.numel()) * q.element_size()  # q,k,v,o
    peak = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else FP32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    bound = max(t_bytes, t_ops)
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    gqa = {"enable_gqa": True} if KV != H else {}
    device_ms = _device_ms(lambda: flash.flash_attention_cuda(q, k, v),
                           "flash_fwd_kernel", reps=10)
    return {
        "shape": [B, S, H, D], "kv_heads": KV,
        "dtype": str(q.dtype).replace("torch.", ""),
        "ms": _time_ms(lambda: flash.flash_attention_cuda(q, k, v),
                       reps=20, warmup=3),
        "device_ms": device_ms,
        "plain_ms": _time_ms(lambda: flash.flash_attention_torch(q, k, v),
                             reps=10, warmup=2),
        "bound_ms": bound,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "tflops": ops / device_ms / 1e9 if device_ms else None,
        "bound_share": bound / device_ms if device_ms else None,
        "library_ms": _time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, **gqa), reps=20, warmup=3),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch as rt
    from repro_torch.kernels import _build, minplus, pricing
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import rmsnorm
    from repro_torch.launch import sim as launch_sim
    from repro_torch.obs import trace

    # float32 products in full float32 on the card (the parity phase)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    kind = torch.cuda.get_device_name(0)
    card = _card_line()
    print(f"device: {kind} x{torch.cuda.device_count()}  torch "
          f"{torch.__version__} cuda {torch.version.cuda}  [{card}]")

    # 2. build (one nvcc per source, in parallel)
    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for name, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "entry")) \
                    or "error" in line.lower():
                print(f"  ptxas {name}: {line.strip()}")

    # 3. kernels against their plain versions on the card
    err = check_kernels(pricing, minplus)
    print(f"kernel checks: bit-identical to the plain versions "
          f"(max abs err {err})")

    # 4. main path on the card (a first run warms torch's CUDA ops, then
    # the counted run), then on the CPU
    _, _, wall_cold, _ = run_main_path(rt, trace, "cuda")
    pricing.LAUNCHES = 0
    minplus.LAUNCHES = 0
    jobs, res_gpu, wall_gpu, tr = run_main_path(rt, trace, "cuda")
    launches = _launches(pricing, minplus)
    _, res_cpu, wall_cpu, _ = run_main_path(rt, trace, "cpu")
    _require_launches(launches, "the main path")
    if decision_trace(res_gpu.records) != decision_trace(res_cpu.records):
        raise AssertionError("cuda and cpu runs made different decisions")
    u_gpu, u_cpu = res_gpu.total_utility, res_cpu.total_utility
    if not (np.isfinite(u_gpu) and abs(u_gpu - u_cpu) <= 1e-9 * abs(u_cpu)):
        raise AssertionError(f"utility {u_gpu} != {u_cpu}")
    if len(res_gpu.records) != len(jobs):
        raise AssertionError("not every job got a decision")
    for sp in tr.spans:
        if sp.name in ("dp.sweep", "plan.bundle") and \
                sp.attrs.get("backend") != "cuda":
            raise AssertionError(f"{sp.name} ran on {sp.attrs}")
    offer_ms = np.array([sp.dur * 1e3 for sp in tr.spans
                         if sp.name == "offer"])
    print(f"main path (H={PAPER_POINT['machines']} T={PAPER_POINT['horizon']}"
          f" jobs={len(jobs)} quanta={PAPER_POINT['quanta']}): admitted "
          f"{len(res_gpu.admitted)}/{len(jobs)} utility {u_gpu!r} "
          f"(cpu {u_cpu!r}); cuda wall {wall_gpu:.4f} s = "
          f"{len(jobs) / wall_gpu:.2f} jobs/s, offer p50 "
          f"{np.percentile(offer_ms, 50):.3f} ms p99 "
          f"{np.percentile(offer_ms, 99):.3f} ms; first cuda run "
          f"{wall_cold:.4f} s; cpu wall {wall_cpu:.4f} s; launches "
          f"{launches}")
    table = tr.phase_table()
    top = sorted(table.items(), key=lambda kv: -kv[1]["self_s"])[:8]
    print("phases by self time (cuda run): " + ", ".join(
        f"{name} {row['self_s']:.4f} s/{int(row['count'])}"
        for name, row in top))
    wall_prof, busy = device_busy_share(rt, trace)
    print(f"device busy {busy:.4f} s of a profiled {wall_prof:.4f} s run: "
          f"idle share {1 - busy / wall_prof:.4f}")

    # 5. serving path: its kernels against their plain versions
    merr = check_model_kernels(rmsnorm, flash)
    print(f"model kernel checks: within tolerance of the plain versions "
          f"(max abs err {merr})")

    # 6. serving path: Gemma-7B at full width and depth on the card
    sv = serve_full_width(rmsnorm, flash)
    p = SERVE_POINT
    print(f"serving ({p['arch']}, 28 layers, {p['requests']} requests x "
          f"{p['prompt_len']} prompt + {p['max_new']} new, max_batch "
          f"{p['max_batch']}, greedy): wall {sv['wall']:.4f} s, "
          f"{sv['tokens']} tokens, {sv['tok_per_s']:.2f} tok/s; per batch "
          f"(prefill ms, decode ms) "
          f"{[(round(a, 3), round(b, 3)) for a, b in sv['per_batch']]}; "
          f"launches {sv['launches']}; init {sv['init_s']:.2f} s; peak "
          f"memory {sv['setup_peak_gb']:.2f} GB at set-up (f32 params + "
          f"bf16 copy), {sv['serve_peak_gb']:.2f} GB while serving")
    print(f"serving device busy {sv['busy']:.4f} s of a profiled "
          f"{sv['prof_wall']:.4f} s run: idle share {sv['idle']:.4f}; "
          f"rmsnorm {sv['rmsnorm_s']:.4f} s, flash {sv['flash_s']:.4f} s "
          f"(calls {sv['flash_calls']}); "
          f"top kernels by device time: " + "; ".join(
              f"{name[:60]} {t:.4f} s" for name, t in sv["top"]))

    split = sv["rmsnorm_split"]
    rows = {"prefill_shape": p["max_batch"] * p["prompt_len"],
            "decode_shape": p["max_batch"]}
    print("serving rmsnorm device time by launch shape: " + (
        "; ".join(f"{k} ({rows[k]} rows) {v['launches']} launches "
                  f"{v['device_s']:.6f} s = {v['us_per_launch']:.4f} us each"
                  for k, v in split.items())
        if split else "not measured (the profiler lost launches)"))

    # 7. serving path: 2-layer float32 cut, cuda against cpu
    pa = parity_cuda_cpu()
    print(f"parity (2-layer full-width f32, cuda vs cpu): identical greedy "
          f"tokens {pa['tokens'][0]}..., prefill logits max abs err "
          f"{pa['logits_err']:.3e}; serve cuda {pa['cuda_s']:.4f} s, cpu "
          f"{pa['cpu_s']:.4f} s")

    # 8. times at the main paths' shapes
    gen = torch.Generator().manual_seed(1)
    price, free, wdem, sdem = _bundle_inputs(gen, 20, 100, 4, zero_cols=(0,))
    bnum = bundle_numbers(pricing, price.cuda(), free.cuda(), wdem, sdem, 4.0)
    snum = sweep_numbers(minplus, _sweep_inputs(gen, 20, 21).cuda())
    for name, f in (("price_bundle (20, 100, 4)", bnum),
                    ("minplus_sweep (k=20, Q1=21)", snum)):
        print(f"{name}: device {f['device_ms']} ms, events {f['ms']} ms, "
              f"host-level call {f['host_ms']} ms, {f['bound_ms']} ms "
              f"{f['bound_by']} bound; plain {f['plain_ms']} ms, library "
              f"{f['library_ms']} ms")
    x = (torch.randn((4096, 3072), generator=gen) * 3).to(torch.bfloat16)
    rnum = rmsnorm_numbers(rmsnorm, x.cuda(), torch.ones(3072).cuda())
    rdec = rmsnorm_numbers(rmsnorm, x[:4].cuda(), torch.ones(3072).cuda())
    for f in (rnum, rdec):
        print(f"rmsnorm {f['shape']} {f['dtype']}: device {f['device_ms']} "
              f"ms, events {f['ms']} ms, {f['bound_ms']} ms {f['bound_by']} "
              f"bound; plain {f['plain_ms']} ms, F.rms_norm "
              f"{f['library_ms']} ms")
    q, k, v = (torch.randn((4, 1024, 16, 256), generator=gen)
               .to(torch.bfloat16).cuda() for _ in range(3))
    fnum = flash_numbers(flash, q, k, v)       # Gemma-7B prefill, bf16
    fnum["float32"] = flash_numbers(flash, q.float(), k.float(), v.float())
    del q, k, v
    q, k, v = (torch.randn(shape, generator=gen).to(torch.bfloat16).cuda()
               for shape in ((2, 1024, 64, 128), (2, 1024, 8, 128),
                             (2, 1024, 8, 128)))
    fnum["qwen3_32b"] = flash_numbers(flash, q, k, v)
    for label, f in (("bf16, tensor cores", fnum),
                     ("float32, CUDA cores", fnum["float32"]),
                     ("bf16 at Qwen3-32B's heads", fnum["qwen3_32b"])):
        print(f"flash {f['shape']} kv_heads {f['kv_heads']} causal "
              f"({label}): device {f['device_ms']} ms, events {f['ms']} ms,"
              f" {f['tflops']} TFLOP/s, {f['bound_share']} of the "
              f"{f['bound_ms']} ms {f['bound_by']} bound; plain "
              f"{f['plain_ms']} ms, library {f['library_ms']} ms")
    # 9. the online simulator on the card (the offer kernels inside the
    # event engine), against the CPU; last, so its long profiled run
    # comes after every kernel timing
    on = online_sim(rt, launch_sim, trace, pricing, minplus)
    sp = SIM_POINT
    print(f"online sim (H={sp['machines']} W={sp['lookahead']} "
          f"{sp['preset']} jobs={sp['jobs']} rate={sp['rate']} "
          f"failure_rate={sp['failure_rate']} seed={sp['seed']} quanta="
          f"{launch_sim.QUANTA}): decisions identical on cuda and cpu for pdors "
          f"and {', '.join(SIM_BASELINES)}; phase wall {on['wall']:.2f} s; "
          f"pdors warm-up run {on['warm_wall']:.4f} s")
    for row in on["rows"]:
        print(row)
    adm = on["admission"]
    print(f"online sim pdors (cuda): admission latency p50 "
          f"{adm['p50_ms']:.3f} ms p99 {adm['p99_ms']:.3f} ms mean "
          f"{adm['mean_ms']:.3f} ms over {int(adm['count'])} offers; "
          f"launches {on['launches']}; spans {on['spans']} (all on cuda)")
    print("online sim phases by self time (cuda run): " + ", ".join(
        f"{name} {row['self_s']:.4f} s/{int(row['count'])}"
        for name, row in on["top"]))
    print(f"online sim device busy {on['busy']:.4f} s of a profiled "
          f"{on['prof_wall']:.4f} s pdors run: idle share "
          f"{1 - on['busy'] / on['prof_wall']:.4f}")
    (ores, owall, olaunch), (cres, cwall, _) = on["oasis"]["cuda"], \
        on["oasis"]["cpu"]
    print(f"OASiS (Fig. 6 point, R=6): admitted {len(ores.admitted)}/"
          f"{len(ores.records)} utility {ores.total_utility!r} (cpu "
          f"{cres.total_utility!r}), identical decisions; cuda wall "
          f"{owall:.4f} s, cpu {cwall:.4f} s; bundle launches {olaunch}")

    # 10. the chaos leg, a kill and recover, the elastic storm and the
    # offer service on the card, against the CPU; then one profiled chaos
    # run, last
    ch = chaos_sim(launch_sim, trace, pricing, minplus)
    s = ch["gpu"]["report"].summary
    hl = s["policy_health"]
    print(f"chaos (the sim point with bench_sim's chaos leg, pdors "
          f"resilient-wrapped): decisions, outcomes, summaries and policy "
          f"health identical on cuda and cpu; {s['machine_incidents']} "
          f"incidents, {ch['gpu']['report'].slots_run} slots, admitted "
          f"{s['jobs_admitted']}/{s['jobs_offered']}, completed "
          f"{s['jobs_completed']}, preemptions {s['preemptions']}, "
          f"evicted {s['jobs_evicted']}, utility {s['total_utility']!r}, "
          f"goodput {s['goodput_fraction']!r}, availability "
          f"{s['machine_availability']!r}, MTTR {s['mttr']!r}; resilient "
          f"offers {hl['offers']}, solver faults {hl['solver_faults']}, "
          f"retries {hl['retries']}, retry recoveries "
          f"{hl['retry_recoveries']}, fallbacks {hl['fallbacks']} "
          f"({hl['fallback_admits']} admitted)")
    adm = ch["admission"]
    print(f"chaos pdors: cuda wall {ch['gpu']['wall']:.4f} s = "
          f"{SIM_POINT['jobs'] / ch['gpu']['wall']:.2f} jobs/s, cpu wall "
          f"{ch['cpu_wall']:.4f} s; admission latency p50 "
          f"{adm['p50_ms']:.3f} ms p99 {adm['p99_ms']:.3f} ms; launches "
          f"{ch['launches']}; spans {ch['spans']} (all on cuda); "
          f"overcommit checks (whole-ledger host copies) "
          f"{ch['overcommit_checks']}; phase wall {ch['wall']:.2f} s")
    rc = recover_sim(launch_sim, pricing, minplus, ch["gpu"])
    print(f"recover (checkpoint every {RECOVER['checkpoint_every']} slots, "
          f"killed at slot {RECOVER['kill_at']}): {rc['checkpoints']} "
          f"checkpoints taken across the killed run and the recovery, "
          f"restored from slot {rc['slot']} ({rc['consumed']} events "
          f"consumed); killed run {rc['killed_wall']:.4f} s, "
          f"recovery {rc['wall']:.4f} s; summary, slots, outcomes and "
          f"ledger equal the uninterrupted cuda run's; checkpoint and "
          f"restored ledgers on the card; launches {rc['launches']}")
    el = elastic_sim(launch_sim, trace, pricing, minplus)
    s = el["gpu"]["report"].summary
    ep = ELASTIC_POINT
    print(f"elastic (H={ep['machines']} W={ep['lookahead']} {ep['preset']} "
          f"jobs={ep['jobs']} rate={ep['rate']} failure_rate="
          f"{ep['failure_rate']}, bench_sim's ELASTIC_KNOBS, pdors): "
          f"batched == event on cuda bit for bit, batched identical on cuda "
          f"and cpu; reshapes {s['reshapes']}, admitted "
          f"{s['jobs_admitted']}/{s['jobs_offered']}, deadlines "
          f"{s['deadline_hits']}/{s['deadline_jobs']}, SLOs "
          f"{s['slo_hits']}/{s['slo_jobs']}, utility "
          f"{s['total_utility']!r}; batched cuda {el['gpu']['wall']:.4f} "
          f"s, event cuda {el['event_wall']:.4f} s, batched cpu "
          f"{el['cpu_wall']:.4f} s; launches {el['launches']}; spans "
          f"{el['spans']} (all on cuda); phase wall {el['wall']:.2f} s")
    sv2 = service_sim(launch_sim, pricing, minplus)
    lat = sv2["latency"]
    print(f"service (H={SERVICE_POINT['machines']} W="
          f"{SERVICE_POINT['lookahead']} {SERVICE_POINT['preset']}, "
          f"{sv2['jobs']} jobs in chunks of {launch_sim.SERVICE_CHUNK}, "
          f"batch window {launch_sim.SERVICE_WINDOW * 1e3} ms): admitted "
          f"{sv2['admitted']}/{sv2['jobs']} in {sv2['batches']} batches "
          f"(sizes {sv2['sizes']}), identical to offer_batch on cpu per "
          f"batch; {sv2['jobs'] / sv2['wall']:.2f} offers/s (wall "
          f"{sv2['wall']:.4f} s, cpu replay {sv2['cpu_wall']:.4f} s), "
          f"admission latency p50 {lat['p50_ms']:.3f} ms p99 "
          f"{lat['p99_ms']:.3f} ms mean {lat['mean_ms']:.3f} ms; launches "
          f"{sv2['launches']}")
    cp = chaos_profiled(launch_sim, trace)
    print(f"chaos device busy {cp['busy']:.4f} s of a profiled "
          f"{cp['wall']:.4f} s pdors run: idle share "
          + (f"{1 - cp['busy'] / cp['wall']:.4f}" if cp["busy"] > 0 else
             "not measured (the profiler recorded no device time)"))
    print("chaos phases by self time (profiled cuda run): " + ", ".join(
        f"{name} {row['self_s']:.4f} s/{int(row['count'])}"
        for name, row in cp["top"]))
    paths = {"chaos": ch, "recover": rc, "elastic": el, "service": sv2}

    kernels = [
        {"name": "price_bundle", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/price_bundle.cu",
         "replaces": "src/repro/kernels/pricing.py:144",
         "launches": launches["price_bundle"],
         "sim_launches": on["launches"]["price_bundle"],
         **{f"{k}_launches": v["launches"]["price_bundle"]
            for k, v in paths.items()},
         "max_abs_err": err["price_bundle"], **bnum},
        {"name": "minplus_sweep", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/minplus_sweep.cu",
         "replaces": "src/repro/kernels/minplus.py:124",
         "launches": launches["minplus_sweep"],
         "sim_launches": on["launches"]["minplus_sweep"],
         **{f"{k}_launches": v["launches"]["minplus_sweep"]
            for k, v in paths.items()},
         "max_abs_err": err["minplus_sweep"], **snum},
        {"name": "rmsnorm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
         "replaces": "src/repro/kernels/rmsnorm.py:35",
         "launches": sv["launches"]["rmsnorm"],
         "max_abs_err": merr["rmsnorm"], **rnum, "decode_shape": rdec,
         "serving_split": sv["rmsnorm_split"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
         "float32_source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:94",
         "launches": sv["launches"]["flash_attention"],
         "max_abs_err": merr["flash_attention"], **fnum},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
