"""Time the PD-ORS offer path's two CUDA kernels, and the offer path
itself, for one or two source trees of the PyTorch port, on one card.

    python3 scripts/offer_kernels_ab.py                # this tree's src/
    python3 scripts/offer_kernels_ab.py --src DIR      # DIR/repro_torch
    python3 scripts/offer_kernels_ab.py --ab OLD NEW [--out FILE]

``--ab`` measures two trees in turns (OLD, NEW, NEW, OLD), each in a
process of its own (two versions of ``repro_torch`` cannot share one),
and prints each turn's numbers and the card's name and power limit;
``--out`` also writes them as JSON. For one tree it prints one JSON
object:

  * ``price_bundle`` at (W, H, R) = (20, 100, 4) and ``minplus_sweep`` at
    (k, Q1) = (20, 21): device ms (torch.profiler), events ms (CUDA
    events around back-to-back launches, the host's launch cost
    included), and host ms: the host clock around the call the offer
    path makes, which ends in the copy back and a sync; each the median
    of five timings; and the sweep's device ms at (40, 21), (20, 33) and
    (40, 33);
  * the paper's Fig. 6 point (``chip_smoke.PAPER_POINT``) on the card:
    wall, jobs/s, offer p50/p99, the ``plan.bundle`` and ``dp.sweep``
    spans' self time, launches, and the device's idle share under the
    profiler.

The inputs are made from fixed seeds, the same for every tree. Needs a
CUDA card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def measure(src: Path) -> dict:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(src))
    import repro_torch as rt
    from repro_torch.kernels import _build, minplus, pricing
    from repro_torch.obs import trace

    _build.build(["price_bundle", "minplus_sweep"])
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    price = torch.from_numpy(rng.uniform(0.1, 8.1, (20, 100, 4))).to(dev)
    free = torch.from_numpy(rng.uniform(-3.0, 30.0, (20, 100, 4))).to(dev)
    wdem = rng.uniform(0.0, 3.0, 4)
    sdem = rng.uniform(0.0, 3.0, 4)
    wdem[0] = 0.0
    gamma = 4.0
    tcost = rng.uniform(0.0, 100.0, (20, 21))
    tcost[rng.random((20, 21)) < 0.2] = np.inf
    tcost[:, 0] = 0.0
    tdev = torch.from_numpy(tcost).to(dev)

    # the demand: one (3, R) device operand before the redesign, wdem,
    # sdem and gamma by value after it
    if hasattr(pricing, "demand_operand"):
        dem = (pricing.demand_operand(wdem, sdem, gamma, dev),)
    else:
        dem = (wdem, sdem, gamma)
    # the DP's call: one host-level call after the redesign, the tensor
    # sweep and two copies back before it
    if hasattr(minplus, "minplus_sweep_host"):
        def dp_sweep():
            return minplus.minplus_sweep_host(tcost, dev)
    else:
        def dp_sweep():
            C, ch = minplus.minplus_sweep(torch.from_numpy(tcost).to(dev))
            return C.cpu().numpy(), ch.cpu().numpy()

    def bundle():
        return pricing.price_bundle_batch_cuda(price, free, *dem)

    def sweep():
        return minplus.minplus_sweep_cuda(tdev)

    def median(timer, *args):
        # the median of five timings: one stall of the shared host moves
        # a mean of back-to-back calls by a multiple
        return float(np.median([timer(*args) for _ in range(5)]))

    def plan_bundle():
        return pricing.price_bundle_batch(price, free, wdem, sdem, gamma)

    out = {
        "price_bundle": {
            "device_ms": median(cs._device_ms, bundle, "price_bundle"),
            "ms": median(cs._time_ms, bundle),
            "host_ms": median(cs._host_ms, plan_bundle),
        },
        "minplus_sweep": {
            "device_ms": median(cs._device_ms, sweep, "minplus_sweep"),
            "ms": median(cs._time_ms, sweep),
            "host_ms": median(cs._host_ms, dp_sweep),
        },
    }
    # device time at other depths and widths: the slope over k is the
    # cost of one dependent step
    for k, Q1 in ((40, 21), (20, 33), (40, 33)):
        tc = rng.uniform(0.0, 100.0, (k, Q1))
        tc[rng.random((k, Q1)) < 0.2] = np.inf
        tc[:, 0] = 0.0
        tc = torch.from_numpy(tc).to(dev)
        out["minplus_sweep"][f"device_ms_k{k}_q{Q1}"] = median(
            cs._device_ms, lambda: minplus.minplus_sweep_cuda(tc),
            "minplus_sweep")

    cs.run_main_path(rt, trace, "cuda")                 # warm-up
    pricing.LAUNCHES = 0
    minplus.LAUNCHES = 0
    jobs, res, wall, tr = cs.run_main_path(rt, trace, "cuda")
    launches = {"price_bundle": pricing.LAUNCHES,
                "minplus_sweep": minplus.LAUNCHES}
    offer_ms = np.array([sp.dur * 1e3 for sp in tr.spans
                         if sp.name == "offer"])
    table = tr.phase_table()
    wall_prof, busy = cs.device_busy_share(rt, trace)
    out["offer_path"] = {
        "wall_s": wall, "jobs_per_s": len(jobs) / wall,
        "admitted": len(res.admitted), "utility": res.total_utility,
        "offer_p50_ms": float(np.percentile(offer_ms, 50)),
        "offer_p99_ms": float(np.percentile(offer_ms, 99)),
        "plan_bundle_self_s": table.get("plan.bundle", {}).get("self_s"),
        "dp_sweep_self_s": table.get("dp.sweep", {}).get("self_s"),
        "launches": launches,
        "profiled_wall_s": wall_prof, "idle_share": 1 - busy / wall_prof,
    }
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--ab", nargs=2, type=Path, metavar=("OLD", "NEW"))
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("offer_kernels_ab: no CUDA device available", file=sys.stderr)
        return 2
    if args.ab is None:
        print(json.dumps(measure(args.src.resolve())))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    old, new = (p.resolve() for p in args.ab)
    turns = []
    for label, src in (("old", old), ("new", new), ("new", new),
                       ("old", old)):
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, __file__, "--src", str(src)],
                             capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stdout, run.stderr, file=sys.stderr)
            raise RuntimeError(f"the {label} turn failed ({src})")
        turn = json.loads(run.stdout.strip().splitlines()[-1])
        turn.update(turn=label, src=str(src),
                    process_s=time.perf_counter() - t0)
        turns.append(turn)
        print(json.dumps(turn))
    print(card)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "turns": turns},
                                       indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
