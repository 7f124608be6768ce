"""Which kernel records a ``torch.profiler`` session loses on the card,
and whether the pads of ``chip_smoke.py``'s held sessions absorb the loss.

    python3 scripts/profiler_sessions.py [--layers 8] [--sessions 3]

It serves ``chip_smoke.py``'s Gemma-7B serving point (8 x 1024-token
prompts, 32 new tokens, max_batch 4) cut to ``--layers`` layers, warms
it up, then profiles the same serve ``--sessions`` times in turns: a bare
session (``profile(activities=[CUDA])`` around the serve and a sync) and
a held one (``chip_smoke.start_session`` / ``stop_session``: the serve
between a head and a tail of pad launches). For each session it exports
the Chrome trace and matches every launch call (``chip_smoke.
LAUNCH_CALLS``) to a kernel record by correlation id, then prints the
launch calls, the kernels recorded, the runs of launches (by ordinal, in
launch order) without a kernel and, for a held session, how many of the
serve's own launches (those between the pads) lack one, beside what
``chip_smoke._kernel_counts`` reads. The last line is one JSON object of
the same. Needs a CUDA card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def lost_launches(prof, cs, tmp: str) -> tuple:
    """(launch calls in launch order, the ordinals of those without a
    kernel record) of a session, from its Chrome trace."""
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    os.remove(path)
    launches = sorted((e for e in events
                       if e.get("cat") in ("cuda_runtime", "cuda_driver")
                       and e["name"] in cs.LAUNCH_CALLS),
                      key=lambda e: e["ts"])
    kernels = {e["args"].get("correlation") for e in events
               if e.get("cat") == "kernel"}
    return launches, [i for i, e in enumerate(launches)
                      if e["args"].get("correlation") not in kernels]


def runs(ordinals: list) -> list:
    """Consecutive ordinals as (first, last) runs."""
    out = []
    for i in ordinals:
        if out and out[-1][1] == i - 1:
            out[-1][1] = i
        else:
            out.append([i, i])
    return [tuple(r) for r in out]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--sessions", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profiler_sessions: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build

    cs = _chip_smoke()
    _build.build()
    p = dict(cs.SERVE_POINT, layers=args.layers)
    cfg, engine, reqs, _, _ = cs.serving_engine(p)
    cs.warm_up(engine, cfg, p, reqs)
    pads = cs.PAD_HEAD + cs.PAD_TAIL
    tmp = tempfile.mkdtemp(prefix="profiler_sessions_")
    rows = []
    for i in range(args.sessions):
        for kind in ("bare", "held"):
            if kind == "bare":
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    engine.serve(reqs)
                    torch.cuda.synchronize()
                counts = cs._kernel_counts(prof)[:2]
            else:
                prof = cs.start_session()
                engine.serve(reqs)
                cs.stop_session(prof)
                counts = cs._kernel_counts(prof, pads)[:2]
            launches, lost = lost_launches(prof, cs, tmp)
            row = {"session": 2 * i + (kind == "held"), "kind": kind,
                   "launch_calls": len(launches),
                   "kernels": len(launches) - len(lost),
                   "lost_runs": runs(lost)[:8],
                   "kernel_counts": list(counts)}
            if kind == "held":
                work = range(cs.PAD_HEAD, len(launches) - cs.PAD_TAIL)
                row["work_lost"] = sum(1 for j in lost if j in work)
            rows.append(row)
            print(json.dumps(row), flush=True)
    os.rmdir(tmp)
    card = cs._card_line()
    print(card)
    print(json.dumps({"card": card, "torch": torch.__version__,
                      "layers": args.layers, "sessions": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
