"""Online simulation launcher: one trace, one cluster, a list of policies,
each replayed through the event engine, on the CUDA card by default.

    PYTHONPATH=src python -m repro_torch.launch.sim --device cpu
    PYTHONPATH=src python -m repro_torch.launch.sim --machines 16 \\
        --lookahead 16 --jobs 500 --rate 6.0 --failure-rate 0.05
    PYTHONPATH=src python -m repro_torch.launch.sim --device cpu --faults
    PYTHONPATH=src python -m repro_torch.launch.sim --device cpu --elastic
    PYTHONPATH=src python -m repro_torch.launch.sim --device cpu --service

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

The benchmark's other tiers, each printing the row ``bench_sim.py``
prints for the same point:

* ``--faults``: the chaos leg (``chaos_plan``: correlated rack crashes and
  stragglers merged into the trace, injected LP faults); pdors runs
  wrapped in ``ResilientPolicy`` with the plan's solver-fault hook.
* ``--elastic``: the reshape storm (``ELASTIC_KNOBS``) through the batched
  engine and the per-event oracle, with their ``engine_parity``.
* ``--service``: pdors offers through the asyncio ``OfferService``
  (``min(jobs, 1500)`` jobs submitted 64 at a time, a 0.5 ms batch
  window), with offers/s, batches and the admission latency.
"""
from __future__ import annotations

import argparse
import sys
import time

# bench_sim.py's fixed settings
QUANTA = 12
CALIB_JOBS = 48
MAX_SLOTS = 4000
SERVICE_JOBS_CAP = 1500
SERVICE_WINDOW = 0.0005          # seconds a batch stays open
SERVICE_CHUNK = 64               # submissions gathered at a time
# the elastic tier's reshape storm: most jobs elastic, the SLAQ shrink and
# adadamp grow triggers armed, deadlines and loss SLOs riding along
ELASTIC_KNOBS = dict(
    elastic_frac=0.7, elastic_levels=(0.5, 1.0, 1.5),
    marginal_floor=0.15, damper_loss=0.6,
    deadline_frac=0.5, slo_frac=0.5,
)


def chaos_plan(seed: int, machines: int, max_slots: int = MAX_SLOTS):
    """The benchmark's fault grid: correlated rack crashes and stragglers
    plus injected LP faults (contained by the resilient wrapper)."""
    from ..sim import FaultPlan

    return FaultPlan(
        seed=seed, until=min(max_slots, 256),
        crash_rate=0.01, straggler_rate=0.01, downtime=(2, 8),
        domains=[(h, h + 1) for h in range(0, machines - 1, 2)],
        domain_correlation=0.5,
        solver_fault_rate=0.2,
    )


def trace_config(*, preset: str = "google", jobs: int = 60,
                 rate: float = 3.0, failure_rate: float = 0.1,
                 seed: int = 0, elastic: bool = False):
    from ..sim import TraceConfig

    return TraceConfig(preset=preset, num_jobs=jobs, seed=seed,
                       arrival_rate=rate, failure_rate=failure_rate,
                       **(ELASTIC_KNOBS if elastic else {}))


def make_events(*, machines: int, preset: str = "google", jobs: int = 60,
                rate: float = 3.0, failure_rate: float = 0.1, seed: int = 0,
                faults: bool = False, elastic: bool = False, **_):
    """The point's event stream, made anew from its seeds (a killed run's
    ``recover`` replays it): the trace, merged with the chaos plan's
    machine incidents when ``faults``."""
    from ..sim import merge_event_streams, stream

    events = stream(trace_config(preset=preset, jobs=jobs, rate=rate,
                                 failure_rate=failure_rate, seed=seed,
                                 elastic=elastic))
    if faults:
        events = merge_event_streams(
            events, chaos_plan(seed, machines).events(machines))
    return events


def make_engine(name: str, *, machines: int, lookahead: int,
                preset: str = "google", jobs: int = 60, rate: float = 3.0,
                failure_rate: float = 0.1, seed: int = 0, device=None,
                tracer=None, faults: bool = False, elastic: bool = False,
                engine_mode: str = "event", checkpoint_every=None,
                kill_at=None):
    """The point's engine for policy ``name`` on a fresh cluster whose
    ledger lives on ``device`` (None = the CUDA card), and the trace's
    event stream: ``engine.run(events)`` replays it. ``faults`` merges the
    chaos plan into the stream and wraps pdors in ``ResilientPolicy`` with
    the plan's solver-fault hook; ``elastic`` arms the reshape storm."""
    from ..core import SubproblemConfig, make_cluster
    from ..sim import (ResilientPolicy, RollingWindow, SimEngine,
                       calibrate_prices, make_policy)

    tcfg = trace_config(preset=preset, jobs=jobs, rate=rate,
                        failure_rate=failure_rate, seed=seed,
                        elastic=elastic)
    cluster = make_cluster(machines, lookahead, device=device)
    window = RollingWindow(cluster)
    if name.startswith("pdors"):
        params = calibrate_prices(tcfg, cluster, n=CALIB_JOBS)
        if faults:
            hook = chaos_plan(seed, machines).solver_fault_hook()
            policy = ResilientPolicy(
                inner=name, price_params=params, quanta=QUANTA,
                cfg=SubproblemConfig(lp_fault_hook=hook))
        else:
            policy = make_policy(name, price_params=params, quanta=QUANTA)
    else:
        policy = make_policy(name)
    engine = SimEngine(window, policy, seed=seed, max_slots=MAX_SLOTS,
                       patience=tcfg.patience, trace=tracer,
                       engine_mode=engine_mode,
                       checkpoint_every=checkpoint_every, kill_at=kill_at)
    events = make_events(machines=machines, preset=preset, jobs=jobs,
                         rate=rate, failure_rate=failure_rate, seed=seed,
                         faults=faults, elastic=elastic)
    return engine, events


def run_engine(engine, events):
    """(report, wall seconds) of one replay; the wall ends in a device
    sync."""
    t0 = time.perf_counter()
    report = engine.run(events)
    _sync(engine.window.cluster)
    return report, time.perf_counter() - t0


def _sync(cluster) -> None:
    import torch

    device = cluster.backend.device
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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


def _point(point: dict, device) -> dict:
    """bench_sim's row header for this point, the backend named as the
    port's ledger."""
    return {"H": point["machines"], "W": point["lookahead"],
            "preset": point["preset"], "num_jobs": point["jobs"],
            "arrival_rate": point["rate"],
            "failure_rate": point["failure_rate"], "seed": point["seed"],
            "quanta": QUANTA, "backend": f"torch:{device}"}


# ------------------------------------------------------------- --faults
def chaos_rows(policies, device=None, **point) -> list:
    """bench_sim's ``run_point(faults=True)`` rows for ``policies``, and
    its printed line for each."""
    rows = []
    for name in policies:
        engine, events = make_engine(name, device=device, faults=True,
                                     **point)
        report, wall = run_engine(engine, events)
        s = report.summary
        n = point["jobs"]
        rows.append({
            **_point(point, engine.window.cluster.backend.device),
            "patience": engine.patience, "faults": True, "policy": name,
            "wall_s": wall, "jobs_per_sec": n / wall,
            "slots_run": report.slots_run, **s,
        })
        if report.pd_gap is not None:
            for k in ("pd_primal", "pd_dual", "duality_gap",
                      "empirical_ratio", "ratio_bound"):
                rows[-1][k] = report.pd_gap[k]
        print(f"  {name:>10}: {n / wall:8.1f} jobs/s "
              f"done={s['jobs_completed']}/{s['jobs_offered']} "
              f"adm={s['admission_rate']:.2f} pre={s['preemptions']} "
              f"jct p50={s['jct_p50']:.1f} p95={s['jct_p95']:.1f} "
              f"util={s['total_utility']:.1f}"
              f" goodput={s['goodput_fraction']:.2f} "
              f"mttr={s['mttr']:.1f} "
              f"avail={s['machine_availability']:.3f}", flush=True)
    return rows


# ------------------------------------------------------------ --elastic
def elastic_rows(policies, device=None, **point) -> list:
    """bench_sim's ``run_elastic_point`` rows: each policy's reshape storm
    through the batched engine and the per-event oracle, with
    ``engine_parity`` (identical summaries and slot counts)."""
    rows = []
    for name in policies:
        reports = {}
        for mode in ("batched", "event"):
            engine, events = make_engine(name, device=device, elastic=True,
                                         engine_mode=mode, **point)
            reports[mode] = run_engine(engine, events)
        (rb, wall), (re_, _) = reports["batched"], reports["event"]
        parity = (rb.summary == re_.summary
                  and rb.slots_run == re_.slots_run)
        s = rb.summary
        n = point["jobs"]
        rows.append({
            "kind": "elastic",
            **_point(point, engine.window.cluster.backend.device),
            "faults": False, "policy": name, "engine_mode": "batched",
            "engine_parity": parity,
            **{f"elastic_{k}": (list(v) if isinstance(v, tuple) else v)
               for k, v in ELASTIC_KNOBS.items()},
            "wall_s": wall, "jobs_per_sec": n / wall,
            "slots_run": rb.slots_run, **s,
        })
        print(f"  {name:>10} [elastic]: {n / wall:8.1f} jobs/s "
              f"reshapes={s['reshapes']} "
              f"ddl={s['deadline_hits']}/{s['deadline_jobs']} "
              f"slo={s['slo_hits']}/{s['slo_jobs']} "
              f"loss={s['final_loss_mean']:.3f} "
              f"parity={'OK' if parity else 'BROKEN'}", flush=True)
    return rows


# ------------------------------------------------------------ --service
def make_service_point(*, machines: int, lookahead: int,
                       preset: str = "google", jobs: int = 60,
                       rate: float = 3.0, seed: int = 0, device=None, **_):
    """(scheduler, jobs) of bench_sim's service row: ``min(jobs, 1500)``
    jobs of the trace and a PD-ORS scheduler on a fresh cluster whose
    ledger lives on ``device``, prices calibrated from the trace."""
    from ..core import make_cluster
    from ..core.pdors import PDORS
    from ..sim import calibrate_prices, sample_jobs

    n = min(jobs, SERVICE_JOBS_CAP)
    tcfg = trace_config(preset=preset, jobs=n, rate=rate, failure_rate=0.0,
                        seed=seed)
    cluster = make_cluster(machines, lookahead, device=device)
    params = calibrate_prices(tcfg, cluster, n=CALIB_JOBS)
    return PDORS(cluster, params, quanta=QUANTA, seed=seed), \
        sample_jobs(tcfg, n)


def drive_service(sched, jobs, machines: int) -> dict:
    """Offer ``jobs`` through an ``OfferService`` over ``sched``,
    ``SERVICE_CHUNK`` concurrent submissions at a time, then long-poll
    every grant; returns the records, the wall (ending in a device sync),
    the admission latency, the grants polled and the batches formed."""
    import asyncio

    from ..sim import OfferService

    async def drive():
        svc = await OfferService(sched, batch_window=SERVICE_WINDOW).start()
        svc.register("bench-w0", cores=machines)
        t0 = time.perf_counter()
        recs = []
        for i in range(0, len(jobs), SERVICE_CHUNK):
            recs.extend(await asyncio.gather(
                *[svc.submit(j) for j in jobs[i:i + SERVICE_CHUNK]]))
        _sync(sched.cluster)
        wall = time.perf_counter() - t0
        grants = 0
        while True:
            more = await svc.poll("bench-w0", timeout=0.01, max_items=256)
            if not more:
                break
            grants += len(more)
        out = {"records": recs, "wall": wall,
               "latency": svc.admission_latency(), "grants": grants,
               "batches": svc.batches_total}
        await svc.close()
        return out

    return asyncio.run(drive())


def service_row(device=None, **point) -> dict:
    """bench_sim's ``run_service_point`` row, and its printed line."""
    sched, jobs = make_service_point(device=device, **point)
    run = drive_service(sched, jobs, point["machines"])
    recs, wall, lat = run["records"], run["wall"], run["latency"]
    n = len(jobs)
    admitted = sum(1 for r in recs if r.admitted)
    row = {
        "kind": "service", "H": point["machines"], "W": point["lookahead"],
        "preset": point["preset"], "num_jobs": n,
        "arrival_rate": point["rate"], "seed": point["seed"],
        "quanta": QUANTA, "backend": f"torch:{sched.cluster.backend.device}",
        "faults": False, "policy": "pdors", "wall_s": wall,
        "jobs_per_sec": n / wall, "jobs_offered": len(recs),
        "jobs_admitted": admitted, "grants_polled": run["grants"],
        "batches": run["batches"],
        "admission_p50_ms": lat["p50_ms"],
        "admission_p99_ms": lat["p99_ms"],
        "admission_mean_ms": lat["mean_ms"],
    }
    print(f"  {'pdors':>10} [service]: {row['jobs_per_sec']:8.1f} offers/s "
          f"adm={admitted}/{len(recs)} grants={run['grants']} "
          f"batches={run['batches']} "
          f"p50={lat['p50_ms']:.2f}ms p99={lat['p99_ms']:.2f}ms",
          flush=True)
    return row


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
    tier = ap.add_mutually_exclusive_group()
    tier.add_argument("--faults", action="store_true",
                      help="chaos leg: merge the fault plan into the trace "
                           "and inject LP faults (pdors runs resilient-"
                           "wrapped)")
    tier.add_argument("--elastic", action="store_true",
                      help="elastic tier: the reshape storm through both "
                           "engine modes, with their parity")
    tier.add_argument("--service", action="store_true",
                      help="service row: pdors offers through the asyncio "
                           "OfferService")
    args = ap.parse_args(argv)

    point = dict(machines=args.machines, lookahead=args.lookahead,
                 preset=args.preset, jobs=args.jobs, rate=args.rate,
                 failure_rate=args.failure_rate, seed=args.seed)
    policies = [p for p in args.policies.split(",") if p]
    print(f"H={args.machines} W={args.lookahead} {args.preset} "
          f"jobs={args.jobs} rate={args.rate} "
          f"failure_rate={args.failure_rate} seed={args.seed} "
          f"quanta={QUANTA}"
          + (" faults" if args.faults else "")
          + (" elastic" if args.elastic else "")
          + (" service" if args.service else ""))
    if args.faults:
        chaos_rows(policies, device=args.device, **point)
    elif args.elastic:
        elastic_rows(policies, device=args.device, **point)
    elif args.service:
        service_row(device=args.device, **point)
    else:
        for name in policies:
            engine, events = make_engine(name, device=args.device, **point)
            report, wall = run_engine(engine, events)
            print(summary_line(name, args.jobs, report, engine, wall),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
