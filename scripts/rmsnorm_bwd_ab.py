"""Time the RMSNorm backward kernel (``rmsnorm_bwd_cuda``) of one or two
source trees of the PyTorch port, on one card, at the shapes the training
paths give it (bf16).

    python3 scripts/rmsnorm_bwd_ab.py                  # this tree's src/
    python3 scripts/rmsnorm_bwd_ab.py --src DIR        # DIR/repro_torch
    python3 scripts/rmsnorm_bwd_ab.py --ab OLD NEW [--out FILE]
    python3 scripts/rmsnorm_bwd_ab.py --sweep [--out FILE]

For one tree (``--shapes`` picks some of them) it prints one JSON
object: for each shape the device ms (the profiler's time of both passes,
``chip_smoke._busy_ms``), the events ms (CUDA events around back-to-back
calls, the host's launch cost included) and the device ms of the
library's backward (``torch.autograd.grad`` through ``F.rms_norm``), each
call on the next of enough input copies to pass the L2 ("rot.",
``chip_smoke._copies``), each the median of three timings, and the byte
bound (x, dy and dx once, the scale and dscale once, at 3.35 TB/s).
``chip_smoke.py`` takes its device times from such a process: a fresh
one, whose profiler sessions keep every launch. ``--ab`` measures two trees in turns (OLD, NEW, NEW, OLD), each in
a process of its own (two versions of ``repro_torch`` cannot share one),
and prints each turn and the card's name and power limit; ``--out`` also
writes them as JSON. ``--sweep`` times this tree's kernel under other
values of the partition's constants (``BWD_NARROW_BLOCKS_PER_SM``,
``BWD_WIDE_THREADS_PER_SM``, the ring's depth ``BWD_RING_STAGES``, 0 for
none) and with block-per-row layouts of half the threads, every value on
the same inputs.

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

#: (rows, d): Qwen3-32B's QK-norm rows (16 x 64 tokens x 64 query / 8 kv
#: heads), Gemma-7B's training rows and decode rows, the widest row, the
#: cluster phase's Qwen3-32B and Command R+ d_model at 1024 tokens and its
#: reduced rows
SHAPES = ((65536, 128), (8192, 128), (8192, 3072), (4, 3072), (16, 16384),
          (1024, 5120), (1024, 12288), (1024, 256), (4096, 32))
#: the partition constants ``--sweep`` tries
NARROW_PER_SM = (2, 3)
WIDE_THREADS = (1024,)
RING_STAGES = (4, 2, 0)
#: chunks a thread of a block-per-row layout takes (at least the
#: forward's): 2 halves the threads of a row
WIDE_NCH = (1, 2)


def _inputs(N: int, d: int) -> tuple:
    gen = torch.Generator().manual_seed(N + d)
    x = (torch.randn((N, d), generator=gen) * 3).to(torch.bfloat16)
    scale = torch.randn((d,), generator=gen) + 1
    dy = torch.randn((N, d), generator=gen).to(torch.bfloat16)
    return x.cuda(), scale.cuda(), dy.cuda()


def _median(values) -> float:
    values = [v for v in values if v is not None]
    return float(np.median(values)) if values else None


def _time(cs, rmsnorm, N: int, d: int, library: bool = False) -> dict:
    x, scale, dy = _inputs(N, d)
    nbytes = 3 * N * d * x.element_size() + 2 * d * 4
    sets = cs._copies(nbytes, x, scale, dy)
    kernel = cs._rotating(rmsnorm.rmsnorm_bwd_cuda, sets)
    out = {"device_ms": _median(cs._busy_ms(kernel, reps=20)
                                for _ in range(3)),
           "ms": _median(cs._time_ms(kernel) for _ in range(3)),
           "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3}
    if library:   # autograd's backward through F.rms_norm, on the device
        graphs = []
        for xi, si, dyi in sets:
            xr = xi.detach().clone().requires_grad_()
            w = si.to(xi.dtype).requires_grad_()
            graphs.append((torch.nn.functional.rms_norm(xr, (d,), w, 1e-6),
                           (xr, w), dyi))
        out["library_device_ms"] = _median(cs._busy_ms(cs._rotating(
            lambda y, inputs, dyi: torch.autograd.grad(
                y, inputs, dyi, retain_graph=True), graphs), reps=20)
            for _ in range(3))
        del graphs
    del sets
    torch.cuda.empty_cache()
    return out


def _load(src: Path):
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build, rmsnorm
    _build.build(["rmsnorm_bwd"])
    return cs, rmsnorm


def measure(src: Path, shapes=SHAPES) -> dict:
    cs, rmsnorm = _load(src)
    return {f"{N}x{d}": _time(cs, rmsnorm, N, d, library=True)
            for N, d in shapes}


def sweep(src: Path) -> dict:
    """Each shape under every value of the constant its path reads, with
    the ring and without it on the block-per-row path."""
    cs, rn = _load(src)
    out = {}
    for N, d in SHAPES:
        narrow = rn.rmsnorm_layout(d, torch.bfloat16, True).tpr <= 32
        if narrow:
            points = [dict(BWD_NARROW_BLOCKS_PER_SM=v) for v in NARROW_PER_SM]
        else:
            points = [dict(BWD_WIDE_THREADS_PER_SM=v, BWD_RING_STAGES=st,
                           nch=nch)
                      for v in WIDE_THREADS for st in RING_STAGES
                      for nch in WIDE_NCH]
        rows = []
        layout = rn.rmsnorm_layout
        for p in points:
            consts = {k: v for k, v in p.items() if k != "nch"}
            saved = {k: getattr(rn, k) for k in consts}
            for k, v in consts.items():
                setattr(rn, k, v)
            lay = layout(d, torch.bfloat16, True)
            nch = max(p.get("nch", 1), lay.nch)
            if nch != lay.nch:     # fewer threads a row, more chunks each
                tpr = -(-(-(-d // lay.width) // nch) // 32) * 32
                rn.rmsnorm_layout = lambda *a, _l=rn.Layout(
                    tpr, tpr, nch, lay.width): _l
            rn.rmsnorm_bwd_slabs.cache_clear()
            try:
                plan = rn.rmsnorm_bwd_slabs(N, d, torch.bfloat16, True)
                rows.append({**p, **plan._asdict(),
                             **rn.rmsnorm_layout(d, torch.bfloat16,
                                                 True)._asdict(),
                             **_time(cs, rn, N, d)})
            finally:
                for k, v in saved.items():
                    setattr(rn, k, v)
                rn.rmsnorm_layout = layout
                rn.rmsnorm_bwd_slabs.cache_clear()
        out[f"{N}x{d}"] = rows
    return out


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _write(path, obj) -> None:
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(obj, indent=1))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--ab", nargs=2, type=Path, metavar=("OLD", "NEW"))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--shapes", help="NxD,NxD,...: these shapes only")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    shapes = SHAPES if args.shapes is None else tuple(
        tuple(int(v) for v in shape.split("x"))
        for shape in args.shapes.split(","))
    if not torch.cuda.is_available():
        print("rmsnorm_bwd_ab: no CUDA device available", file=sys.stderr)
        return 2
    if args.sweep:
        res = {"card": _card(), "sweep": sweep(args.src.resolve())}
        print(json.dumps(res))
        _write(args.out, res)
        return 0
    if args.ab is None:
        print(json.dumps(measure(args.src.resolve(), shapes)))
        return 0
    old, new = (p.resolve() for p in args.ab)
    turns = []
    for label, src in (("old", old), ("new", new), ("new", new),
                       ("old", old)):
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, __file__, "--src", str(src),
                              *(["--shapes", args.shapes] if args.shapes
                                else [])],
                             capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stdout, run.stderr, file=sys.stderr)
            raise RuntimeError(f"the {label} turn failed ({src})")
        turn = json.loads(run.stdout.strip().splitlines()[-1])
        turn.update(turn=label, src=str(src),
                    process_s=time.perf_counter() - t0)
        turns.append(turn)
        print(json.dumps(turn))
    card = _card()
    print(card)
    _write(args.out, {"card": card, "turns": turns})
    return 0


if __name__ == "__main__":
    sys.exit(main())
