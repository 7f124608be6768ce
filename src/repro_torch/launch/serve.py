"""Serving launcher: batched prefill+decode over a request stream, on the
CUDA card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-7b \\
        --requests 8 --prompt-len 32 --max-new 16

The flags and defaults of the JAX package's launcher (the reduced config,
random weights from seed 0), plus ``--device`` (``cpu`` runs the kernels'
plain versions). ``--arch`` takes every decoder-only family: dense, MoE
(``phi3.5-moe-42b-a6.6b``), MLA (``minicpm3-4b``, ``deepseek-v2-236b``),
Mamba-2 (``mamba2-780m``), Hymba (``hymba-1.5b``) and vision
(``llava-next-mistral-7b``). The vision config is served text only, as
the JAX package's ``ServeEngine`` serves it: the engine takes tokens, so
no image embeddings go in. The enc-dec config (``seamless-m4t-medium``)
needs frames, which the engine does not take in either package: drive it
through ``Model.prefill`` / ``decode`` with ``{"frames", "tokens"}``.
``--ckpt-dir`` serves the latest checkpoint there (the reference's
layout, written by either package's trainer) in place of random weights.
``chip_smoke.py`` serves the full-width config.
"""
import argparse
import sys
import time

import numpy as np


def load_params(cfg, ckpt_dir: str, device=None):
    """The ``LM`` params of the latest checkpoint in ``ckpt_dir`` (a
    reference tree) on ``device``, and its step."""
    from ..checkpoint import load_checkpoint
    from ..convert import lm_params_from_jax

    tree, step = load_checkpoint(ckpt_dir, device=device)
    return lm_params_from_jax(cfg, tree, device), step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-7b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from ..configs import get_config
    from ..models import build_model
    from ..serve import Request, ServeEngine

    cfg = get_config(args.arch, reduced=True)
    if cfg.encoder_layers:
        raise ValueError(f"{args.arch} is an enc-dec model: the engine "
                         f"takes tokens only; serve it through "
                         f"Model.prefill / decode with frames")
    if args.ckpt_dir:
        params, step = load_params(cfg, args.ckpt_dir, args.device)
        print(f"restored checkpoint step {step}")
    else:
        params = build_model(cfg).init(0, args.device)
    engine = ServeEngine(cfg, params, max_batch=args.max_batch,
                         cache_len=args.prompt_len + args.max_new + 8)
    del params          # the engine keeps what the forward reads
    rng = np.random.default_rng(0)
    reqs = [
        Request(i, rng.integers(0, cfg.vocab_size,
                                args.prompt_len).astype(np.int32),
                max_new_tokens=args.max_new, temperature=args.temperature)
        for i in range(args.requests)
    ]
    t0 = time.perf_counter()
    done = engine.serve(reqs)
    wall = time.perf_counter() - t0
    n_tok = sum(len(c.tokens) for c in done)
    for c in sorted(done, key=lambda c: c.request_id)[:4]:
        print(f"req {c.request_id}: prefill {c.prefill_ms:.0f}ms "
              f"decode {c.decode_ms:.0f}ms -> {c.tokens[:6]}")
    print(f"{len(done)} requests, {n_tok} tokens, {n_tok / wall:.1f} tok/s "
          f"on {engine.device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
