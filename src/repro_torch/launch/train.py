"""Training launcher, the port of the JAX package's ``launch/train.py``
(its flags, plus ``--device``).

  * ``--local``  — real steps of the reduced config through ``Trainer``,
                   on the CUDA card by default or on the CPU with
                   ``--device cpu``;
  * default      — the production plan: ``launch.dryrun.dryrun_one``
                   traces the full config's train step on meta DTensors
                   over the 16x16 (``--multi-pod``: 2x16x16) mesh of a
                   fake process group, allocating nothing, and prints the
                   per-device FLOPs, bytes, collective traffic and the
                   roofline terms with the H100's constants. ``--device``
                   is the mesh's device type (the card by default).

    PYTHONPATH=src python -m repro_torch.launch.train --local \\
        --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-7b \\
        --shape train_4k --device cpu

``chip_smoke.py`` trains the full-width Gemma-7B on the card and holds
the one-card plan of that training point to the run.
"""
import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-32b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--local", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    if not args.local:
        from . import dryrun

        dryrun.dryrun_one(args.arch, args.shape, multi_pod=args.multi_pod,
                          device=args.device)
        print("planned OK: the step traced on the production mesh without "
              "allocating; deploy it on the real mesh.")
        return 0

    from ..configs import get_config
    from ..configs.base import InputShape
    from ..optim import AdamWConfig
    from ..train import Trainer, TrainerConfig

    cfg = get_config(args.arch, reduced=True)
    shape = InputShape("local", 128, 8, "train")
    tr = Trainer(cfg, shape, TrainerConfig(
        steps=args.steps, log_every=max(args.steps // 10, 1),
        checkpoint_dir=args.ckpt_dir,
        opt=AdamWConfig(lr=args.lr, weight_decay=0.01),
        device=args.device))
    hist = tr.run()
    for h in hist:
        print(f"step {h['step']:5d}  loss {h['loss']:.4f}")
    print(f"on {tr.device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
