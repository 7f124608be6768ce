"""Readings that set a cell's limits, on the chip: the program's numbers
compared and the control's, over many seeds in one process.

    python3 perfbench/control.py --workload cmdr-chat --seeds 1,2,3 --seconds 8

For each seed it makes one run of the cell (a short window at the cell's
own load) and judges the window's sample with the program in its place
and then with the control in the program's place (the reference computed
in float8; for training also half of each batch left out), each held to
the cell's limits. One JSON line a seed goes to standard output, and
with ``--out`` appended to that file: each side's readings, checks and
``correct``. The benchmark's own runs never run the control.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import harness  # noqa: E402


def sides_of(out) -> dict:
    """Each judged side's readings, checks and verdict, the program's
    first."""
    sides = {"program": {"readings": out["readings"],
                         "checks": out["checks"],
                         "correct": out["correct"]}}
    sides.update(out["sides"])
    return sides


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--out", default="", help="a file to append lines to")
    args = ap.parse_args()
    harness.set_env()
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    files = harness.cell_files(spec, args.workload)
    files["control"] = not args.no_control
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from perfbench import serve_cell, train_cell
    kind = {"serve": serve_cell, "train": train_cell}[
        files["traffic"]["kind"]]
    with open(args.out or os.devnull, "a") as f:
        for seed in [int(s) for s in args.seeds.split(",")]:
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            out = kind.run(args.workload, files, seed, args.seconds, False,
                           "cuda", t)
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "sides": sides_of(out), "e2e": out["e2e"],
                               "device": out["device"],
                               "wall_s": time.perf_counter() - t})
            print(line[:3000], flush=True)
            f.write(line + "\n")
            f.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
