"""Online simulation launcher: one trace, one cluster, a list of policies,
each replayed through the event engine, on the CUDA card by default.

    PYTHONPATH=src python -m repro_torch.launch.sim --device cpu
    PYTHONPATH=src python -m repro_torch.launch.sim --machines 16 \\
        --lookahead 16 --jobs 500 --rate 6.0 --failure-rate 0.05

One grid point of the JAX package's simulator benchmark
(``benchmarks/bench_sim.py::run_point``; defaults: its smoke point): a
``preset`` stream of ``jobs`` arrivals at ``rate`` a slot, a fraction
``failure_rate`` of them failing once, on ``machines`` machines with a
lookahead window of ``lookahead`` slots; PD-ORS runs with 12 quanta and
prices calibrated from the trace's first 48 jobs, and queued jobs leave
after the trace's patience. Each policy prints the benchmark's summary
row plus the admission latency percentiles (``SimEngine
.admission_latency``). ``chip_smoke.py`` runs the benchmark's largest
point on the card.
"""
from __future__ import annotations

import argparse
import sys
import time

# bench_sim.py's fixed settings
QUANTA = 12
CALIB_JOBS = 48
MAX_SLOTS = 4000


def make_engine(name: str, *, machines: int, lookahead: int,
                preset: str = "google", jobs: int = 60, rate: float = 3.0,
                failure_rate: float = 0.1, seed: int = 0, device=None,
                tracer=None):
    """The point's engine for policy ``name`` on a fresh cluster whose
    ledger lives on ``device`` (None = the CUDA card), and the trace's
    event stream: ``engine.run(events)`` replays it."""
    from ..core import make_cluster
    from ..sim import (RollingWindow, SimEngine, TraceConfig,
                       calibrate_prices, make_policy, stream)

    tcfg = TraceConfig(preset=preset, num_jobs=jobs, seed=seed,
                       arrival_rate=rate, failure_rate=failure_rate)
    cluster = make_cluster(machines, lookahead, device=device)
    window = RollingWindow(cluster)
    if name.startswith("pdors"):
        params = calibrate_prices(tcfg, cluster, n=CALIB_JOBS)
        policy = make_policy(name, price_params=params, quanta=QUANTA)
    else:
        policy = make_policy(name)
    engine = SimEngine(window, policy, seed=seed, max_slots=MAX_SLOTS,
                       patience=tcfg.patience, trace=tracer)
    return engine, stream(tcfg)


def run_engine(engine, events):
    """(report, wall seconds) of one replay; the wall ends in a device
    sync."""
    import torch

    t0 = time.perf_counter()
    report = engine.run(events)
    device = engine.window.cluster.backend.device
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return report, time.perf_counter() - t0


def summary_line(name: str, jobs: int, report, engine, wall: float) -> str:
    s = report.summary
    adm = engine.admission_latency()
    return (f"  {name:>10}: {jobs / wall:8.1f} jobs/s "
            f"slots={report.slots_run} admitted={s['jobs_admitted']} "
            f"done={s['jobs_completed']}/{s['jobs_offered']} "
            f"pre={s['preemptions']} util={s['total_utility']:.1f} "
            f"jct p50={s['jct_p50']:.1f} p95={s['jct_p95']:.1f} "
            f"admission p50={adm['p50_ms']:.3f} ms "
            f"p99={adm['p99_ms']:.3f} ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--machines", type=int, default=6)
    ap.add_argument("--lookahead", type=int, default=12)
    ap.add_argument("--preset", default="google")
    ap.add_argument("--jobs", type=int, default=60)
    ap.add_argument("--rate", type=float, default=3.0)
    ap.add_argument("--failure-rate", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--policies", default="pdors,fifo,drf,dorm")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    print(f"H={args.machines} W={args.lookahead} {args.preset} "
          f"jobs={args.jobs} rate={args.rate} "
          f"failure_rate={args.failure_rate} seed={args.seed} "
          f"quanta={QUANTA}")
    for name in args.policies.split(","):
        engine, events = make_engine(
            name, machines=args.machines, lookahead=args.lookahead,
            preset=args.preset, jobs=args.jobs, rate=args.rate,
            failure_rate=args.failure_rate, seed=args.seed,
            device=args.device)
        report, wall = run_engine(engine, events)
        print(summary_line(name, args.jobs, report, engine, wall),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
