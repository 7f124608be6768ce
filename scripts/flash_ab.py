"""Time the bf16 flash-attention kernel (``flash_attention_cuda`` on bf16
inputs) of one or two source trees of the PyTorch port, on one card, at
every shape the serving paths give it (``chip_smoke.py``'s flash rows).

    python3 scripts/flash_ab.py                   # this tree's src/
    python3 scripts/flash_ab.py --src DIR         # DIR/repro_torch
    python3 scripts/flash_ab.py --ab OLD NEW [--out FILE]

For one tree (``--shapes`` picks some of them by name) it prints one
JSON object: for each shape the kernel's device ms (the profiler's time
of the ``flash_fwd_kernel`` launches, ``chip_smoke._device_ms``), its
events ms (CUDA events around back-to-back calls, the host's launch cost
included), each the median of three timings, the bound (each input and
output byte once at 3.35 TB/s, or 4·B·H·D·(allowed pairs) operations at
989 TFLOP/s, whichever is longer), the TFLOP/s and share of the bound on
the device time, and ``F.scaled_dot_product_attention`` on the same
inputs (head-major copies made first; causal by ``is_causal``, a window
as a boolean ``attn_mask``): its device ms (every kernel it launches,
``chip_smoke._busy_ms``), its events ms and the op its dispatcher took.
``--ab`` measures two trees in turns (OLD, NEW, NEW, OLD), each in a
process of its own (two versions of ``repro_torch`` cannot share one),
and prints each turn and the card's name and power limit; ``--out`` also
writes them as JSON.

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

#: name -> (B, S_q, S_k, H, KV, D, causal, window): the prefill shapes of
#: Gemma-7B, Phi-3.5-MoE, Qwen3-32B, Command R+ and LLaVA-NeXT, Hymba's
#: sliding and global layers, SeamlessM4T's encoder, cross-attention and
#: decoder
SHAPES = {
    "gemma_7b": (4, 1024, 1024, 16, 16, 256, True, 0),
    "phi35_moe": (4, 1024, 1024, 32, 8, 128, True, 0),
    "qwen3_32b": (4, 1024, 1024, 64, 8, 128, True, 0),
    "command_r_plus": (4, 1024, 1024, 96, 8, 128, True, 0),
    "llava_next": (4, 3008, 3008, 32, 8, 128, True, 0),
    "hymba_sliding": (4, 2048, 2048, 25, 5, 64, True, 1024),
    "hymba_global": (4, 2048, 2048, 25, 5, 64, True, 0),
    "seamless_encoder": (4, 1600, 1600, 16, 16, 64, False, 0),
    "seamless_cross": (4, 128, 1600, 16, 16, 64, False, 0),
    "seamless_decoder": (4, 128, 128, 16, 16, 64, True, 0),
}


def _median(values) -> float:
    values = [v for v in values if v is not None]
    return float(np.median(values)) if values else None


def _time(cs, flash, name: str) -> dict:
    B, S_q, S_k, H, KV, D, causal, window = SHAPES[name]
    gen = torch.Generator().manual_seed(S_q * H + D + window)
    q, k, v = (torch.randn(shape, generator=gen).to(torch.bfloat16).cuda()
               for shape in ((B, S_q, H, D), (B, S_k, KV, D),
                             (B, S_k, KV, D)))
    ok = flash.allowed(S_q, S_k, causal, window, q.device)
    ops = 4 * B * H * D * int(ok.sum())
    nbytes = 2 * (q.numel() + k.numel()) * q.element_size()  # q,k,v,o
    t_bytes = nbytes / cs.HBM_BYTES_PER_S * 1e3
    t_ops = ops / cs.BF16_OPS_PER_S * 1e3
    bound = max(t_bytes, t_ops)
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    sdpa = {"enable_gqa": True} if KV != H else {}
    if window:
        sdpa["attn_mask"] = ok
    else:
        sdpa["is_causal"] = causal

    def kernel():
        return flash.flash_attention_cuda(q, k, v, causal, window)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, **sdpa)

    device_ms = _median(cs._device_ms(kernel, "flash_fwd_kernel", reps=20)
                        for _ in range(3))
    out = {
        "shape": [B, S_q, H, D], "kv_heads": KV, "keys": S_k,
        "causal": causal, "window": window,
        "device_ms": device_ms,
        "ms": _median(cs._time_ms(kernel, reps=20, warmup=3)
                      for _ in range(3)),
        "bound_ms": bound,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "tflops": ops / device_ms / 1e9 if device_ms else None,
        "bound_share": bound / device_ms if device_ms else None,
        "sdpa_device_ms": _median(cs._busy_ms(library, reps=20)
                                  for _ in range(3)),
        "sdpa_ms": _median(cs._time_ms(library, reps=20, warmup=3)
                           for _ in range(3)),
        "sdpa_op": cs._sdpa_op(library),
    }
    if hasattr(flash, "tc_tiles"):
        out["tiles"] = flash.tc_tiles(B, S_q, H, D)._asdict()
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return out


def _load(src: Path):
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build, flash_attention
    _build.build(["flash_attention_tc"])
    return cs, flash_attention


def measure(src: Path, names=tuple(SHAPES)) -> dict:
    cs, flash = _load(src)
    return {name: _time(cs, flash, name) for name in names}


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
    ap.add_argument("--shapes", help="name,name,...: these shapes only")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    names = tuple(SHAPES) if args.shapes is None \
        else tuple(args.shapes.split(","))
    unknown = [n for n in names if n not in SHAPES]
    if unknown:
        ap.error(f"unknown shapes {unknown}; known: {list(SHAPES)}")
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device available", file=sys.stderr)
        return 2
    if args.ab is None:
        res = {"card": _card(), "shapes": measure(args.src.resolve(), names)}
        print(json.dumps(res))
        _write(args.out, res)
        return 0
    old, new = (p.resolve() for p in args.ab)
    turns = []
    for label, src in (("old", old), ("new", new), ("new", new),
                       ("old", old)):
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, __file__, "--src", str(src),
                              "--shapes", ",".join(names)],
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
