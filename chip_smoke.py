"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds both CUDA kernels from ``src/repro_torch/kernels/csrc`` with
nvcc, holds each against its plain torch version on the card (bit for
bit), drives the port's PD-ORS offer path at the paper's largest Fig. 6
point (H=100 machines, T=20 slots, 50 jobs, ethernet preset,
workload_scale=0.3, batch=(50,200), quanta=20, seed 0) on the card and
then on the CPU, and requires identical decisions. It prints the main
path's numbers, the card's name and power limit, one JSON line with
each kernel's launches, error, times and bound, and as its last line
``{"ok": true, "device": {...}}``. Every phase raises on failure; the
script exits nonzero without a result line when there is no card or no
port next to it.
"""
from __future__ import annotations

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

PAPER_POINT = dict(machines=100, horizon=20, jobs=50, preset="ethernet",
                   workload_scale=0.3, batch=(50, 200), quanta=20, seed=0)


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
def _bundle_inputs(gen, W, H, R, zero_cols=()):
    price = torch.rand((W, H, R), generator=gen, dtype=torch.float64) * 8
    price += 0.1
    free = torch.rand((W, H, R), generator=gen, dtype=torch.float64) * 30
    wdem = (torch.rand(R, generator=gen, dtype=torch.float64) * 3).numpy()
    sdem = (torch.rand(R, generator=gen, dtype=torch.float64) * 3).numpy()
    for k in zero_cols:
        wdem[k] = 0.0
        sdem[(k + 1) % R] = 0.0
    return price, free, wdem, sdem


def _sweep_inputs(gen, k, Q1, inf_frac=0.2):
    tc = torch.rand((k, Q1), generator=gen, dtype=torch.float64) * 100
    tc[torch.rand((k, Q1), generator=gen) < inf_frac] = float("inf")
    tc[:, 0] = 0.0
    return tc


def check_kernels(pricing, minplus) -> dict:
    """Each kernel against its plain version on the card; returns the
    max abs error per kernel (0.0: bit-identical)."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    err = {"price_bundle": 0.0, "minplus_sweep": 0.0}
    cases = [
        _bundle_inputs(gen, 20, 100, 4),
        _bundle_inputs(gen, 1, 100, 4),
        _bundle_inputs(gen, 37, 1000, 7, zero_cols=(1, 4)),
    ]
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
        dem = pricing.demand_operand(wdem, sdem, 4.0, dev)
        got = pricing.price_bundle_batch_cuda(price, free, dem)
        want = pricing.price_bundle_batch_torch(price, free, dem)
        torch.cuda.synchronize()
        err["price_bundle"] = max(err["price_bundle"], _equal(
            got, want, f"price_bundle case {i} {tuple(price.shape)}"))
    edge = pricing.price_bundle_batch_cuda(
        cases[3][0].to(dev), cases[3][1].to(dev),
        pricing.demand_operand(cases[3][2], cases[3][3], 1.0, dev))
    if not (edge[3] == 3.0).all():
        raise AssertionError("exact-capacity head-room is not 3")

    sweeps = [_sweep_inputs(gen, 20, 21), _sweep_inputs(gen, 20, 33),
              _sweep_inputs(gen, 5, 49, inf_frac=0.0)]
    # near-ties inside the 1e-12 hysteresis
    tie = torch.tensor([[0.0, 0.30000000000000004, 0.6],
                        [0.0, 0.3, 0.6000000000000001]], dtype=torch.float64)
    sweeps.append(tie)
    # all-unreachable rows: every step but the first is +inf past v=0
    unreach = torch.full((4, 21), float("inf"), dtype=torch.float64)
    unreach[:, 0] = 0.0
    sweeps.append(unreach)
    sweeps.append(torch.full((3, 2), float("inf"), dtype=torch.float64))
    for i, tc in enumerate(sweeps):
        tc = tc.to(dev)
        gc, gch = minplus.minplus_sweep_cuda(tc)
        wc, wch = minplus.minplus_sweep_torch(tc)
        torch.cuda.synchronize()
        err["minplus_sweep"] = max(err["minplus_sweep"], _equal(
            gc, wc, f"minplus_sweep values case {i} {tuple(tc.shape)}"))
        _equal(gch, wch, f"minplus_sweep choice case {i}")
    return err


# ------------------------------------------------------------ main path
def decision_trace(res):
    out = []
    for r in res.records:
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


# ---------------------------------------------------------------- times
def bundle_numbers(pricing, price, free, wdem, sdem, gamma) -> dict:
    dev = price.device
    dem = pricing.demand_operand(wdem, sdem, gamma, dev)
    W, H, R = price.shape
    nnz_w = int(np.count_nonzero(wdem))
    nnz_s = int(np.count_nonzero(sdem))
    pos = int((wdem > 0).sum() + (sdem > 0).sum())
    ops = W * H * (2 * nnz_w + 2 * nnz_s + 2 * R + 2 * pos)
    nbytes = 8 * (2 * W * H * R + 3 * R + 5 * W * H)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP64_OPS_PER_S * 1e3
    coef = torch.stack([dem[0], dem[1], dem[2]], dim=1)   # (R, 3)
    flat = price.reshape(W * H, R)
    return {
        "ms": _time_ms(lambda: pricing.price_bundle_batch_cuda(
            price, free, dem)),
        "device_ms": _device_ms(lambda: pricing.price_bundle_batch_cuda(
            price, free, dem), "price_bundle"),
        "plain_ms": _time_ms(lambda: pricing.price_bundle_batch_torch(
            price, free, dem), reps=50),
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
    return {
        "ms": _time_ms(lambda: minplus.minplus_sweep_cuda(tcost)),
        "device_ms": _device_ms(lambda: minplus.minplus_sweep_cuda(tcost),
                                "minplus_sweep"),
        "plain_ms": _time_ms(lambda: minplus.minplus_sweep_torch(tcost),
                             reps=10, warmup=2),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch as rt
    from repro_torch.kernels import _build, minplus, pricing
    from repro_torch.obs import trace

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
            if "registers" in line or "error" in line.lower():
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
    launches = {"price_bundle": pricing.LAUNCHES,
                "minplus_sweep": minplus.LAUNCHES}
    _, res_cpu, wall_cpu, _ = run_main_path(rt, trace, "cpu")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} kernel never launched on the "
                                 f"main path")
    if decision_trace(res_gpu) != decision_trace(res_cpu):
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

    # 5. times at the main path's shapes
    gen = torch.Generator().manual_seed(1)
    price, free, wdem, sdem = _bundle_inputs(gen, 20, 100, 4, zero_cols=(0,))
    bnum = bundle_numbers(pricing, price.cuda(), free.cuda(), wdem, sdem, 4.0)
    snum = sweep_numbers(minplus, _sweep_inputs(gen, 20, 21).cuda())
    kernels = [
        {"name": "price_bundle", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/price_bundle.cu",
         "replaces": "src/repro/kernels/pricing.py:144",
         "launches": launches["price_bundle"],
         "max_abs_err": err["price_bundle"], **bnum},
        {"name": "minplus_sweep", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/minplus_sweep.cu",
         "replaces": "src/repro/kernels/minplus.py:124",
         "launches": launches["minplus_sweep"],
         "max_abs_err": err["minplus_sweep"], **snum},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
