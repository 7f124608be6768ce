"""Training launcher, the port of the JAX package's ``launch/train.py``
(its flags, plus ``--device``).

  * ``--local``  — real steps of the reduced config through ``Trainer``,
                   on the CUDA card by default or on the CPU with
                   ``--device cpu``;
  * default      — the reference's production lowering through its dry
                   run, which comes with the dry-run slice: it raises
                   ``NotImplementedError``.

    PYTHONPATH=src python -m repro_torch.launch.train --local \\
        --device cpu --steps 20

``chip_smoke.py`` trains the full-width Gemma-7B on the card.
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
        raise NotImplementedError(
            "the production lowering goes through the dry run "
            "(launch/dryrun.py), which comes with the dry-run slice of "
            "repro_torch; run --local")

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
