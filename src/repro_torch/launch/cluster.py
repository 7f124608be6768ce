"""Scheduler-driven training: PD-ORS admits jobs drawn from the ten
architectures, and each admitted job then trains, slot by slot, on its
scheduled worker count. The port of the JAX package's
``examples/cluster_sim.py`` default mode (:78-147): online admission ->
placement -> real SGD training -> completion accounting.

    PYTHONPATH=src python -m repro_torch.launch.cluster --device cpu \\
        [--slots 8] [--jobs 6] [--steps-per-slot 3]

  * ``schedule``  — ``arch_jobs`` over the architectures' own parameter
                    counts (``arch_stats``), drawn at seed 0 as the
                    example draws them, the example's cluster (8
                    ``tpu``-preset machines at 4x capacity) and
                    ``run_pdors`` with ``quanta = slots``. ``arch_jobs``'
                    default ``chip_flops`` and the ``tpu`` preset are the
                    reference's job-model constants (a v5e chip's bf16
                    peak, 16-chip pod slices), not the H100's: kept, so
                    that the decisions are the reference's.
  * ``run_jobs``  — each admitted job's reduced config trained in the
                    slots it was scheduled: ``steps_per_slot`` steps a
                    slot of ``max(4, min(16, workers))`` x 64 tokens. The
                    worker count sets the data-parallel batch and nothing
                    else, as in the example.

Where the reference builds every admitted job's train state before slot
0, ``run_jobs`` builds a job's model and state at its first scheduled
slot and drops them after its last: at full width the admitted jobs'
states do not fit on one card together (a 2-layer Qwen3-32B job is
40.5 GB of params, gradients and two float32 moments). Each job's init
is seeded by its ``job_id`` either way, so the numbers are the same.

The example's ``--sim`` mode (the event-driven simulator) is
``launch/sim.py``. ``chip_smoke.py`` drives this module on the card at
the example's settings (cuda against cpu) and with Gemma-7B and
Qwen3-32B jobs at full width.
"""
from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, Iterable, List, Optional

from ..backend.torch_backend import resolve_device
from ..configs import ARCH_IDS, ArchConfig, InputShape, get_config
from ..core import arch_jobs, make_cluster, run_pdors
from ..core.pdors import PDORSResult
from ..models import build_model, concrete_batch
from ..optim import AdamWConfig
from ..train import make_train_step, train_state

#: the reference's job model: the sequence length of a fine-tuning sample
SEQ_LEN = 512.0
#: tokens a training sample has at run time
RUN_SEQ_LEN = 64


def arch_stats(ids: Optional[Iterable[str]] = None) -> Dict[str, Dict]:
    """The example's per-architecture job stats (every arch by default):
    ``2 * active_param_count`` flops a token, ``2 * param_count`` bytes
    of gradient, ``SEQ_LEN`` tokens a sample; full configs."""
    out = {}
    for aid in (ARCH_IDS if ids is None else ids):
        cfg = get_config(aid)
        out[aid] = {"flops_per_token": 2.0 * cfg.active_param_count(),
                    "param_bytes": cfg.param_count() * 2.0,
                    "seq_len": SEQ_LEN}
    return out


def schedule(ids: Optional[Iterable[str]], slots: int, jobs: int,
             device=None) -> PDORSResult:
    """``jobs`` jobs over ``ids`` arriving in ``slots`` slots (drawn at
    seed 0, as the example draws them), offered to PD-ORS on a ledger on
    ``device`` (None = the CUDA card)."""
    offered = arch_jobs(arch_stats(ids), num_jobs=jobs, horizon=slots,
                        seed=0, samples_range=(60, 300),
                        epochs_range=(1, 2))
    cluster = make_cluster(8, slots, preset="tpu", capacity_scale=4.0,
                           device=device)
    return run_pdors(offered, cluster, quanta=slots)


def global_batch(workers: int) -> int:
    """The data-parallel batch of a slot: one sample a worker, at least 4
    and at most 16."""
    return max(4, min(16, workers))


def run_jobs(
    res: PDORSResult,
    config_for: Callable[[str], ArchConfig],
    slots: int,
    steps_per_slot: int,
    device=None,
    init: Optional[Callable] = None,
    batch_for: Optional[Callable] = None,
    on_slot: Optional[Callable] = None,
) -> Dict[int, List[float]]:
    """Train every admitted job of ``res`` in its scheduled slots, on
    ``device`` (None = the CUDA card). A job's model is
    ``build_model(config_for(arch))``, its params ``init(job_id, model,
    device)`` (default ``model.init(job_id, device)``), its optimizer
    AdamW at lr 1e-3 through ``make_train_step`` (the reference's 200-step
    warm-up: step 0's lr is 0). Step k of slot t trains on
    ``batch_for(cfg, shape, seed=job_id * 1000 + t * 10 + k,
    device=device)`` (default ``concrete_batch``). After a job's slot,
    ``on_slot(t, record, workers, state, metrics)`` is called. Returns
    each job's losses, one a slot: the last step's."""
    device = resolve_device(device)
    init = init or (lambda job_id, model, dev: model.init(job_id, dev))
    batch_for = batch_for or concrete_batch
    opt = AdamWConfig(lr=1e-3)
    last = {r.job.job_id: max(r.schedule.slots) for r in res.admitted}
    losses: Dict[int, List[float]] = {j: [] for j in last}
    live: Dict[int, tuple] = {}
    for t in range(slots):
        for rec in res.admitted:
            if t not in rec.schedule.slots:
                continue
            jid = rec.job.job_id
            if jid not in live:
                cfg = config_for(rec.job.arch)
                model = build_model(cfg)
                live[jid] = (cfg, make_train_step(model, opt), train_state(
                    init(jid, model, device), opt))
            cfg, step, state = live[jid]
            workers = rec.schedule.slots[t].total_workers()
            shape = InputShape("sim", RUN_SEQ_LEN, global_batch(workers),
                               "train")
            for k in range(steps_per_slot):
                batch = batch_for(cfg, shape, seed=jid * 1000 + t * 10 + k,
                                  device=device)
                state, metrics = step(state, batch)
            live[jid] = (cfg, step, state)
            losses[jid].append(float(metrics["loss"]))
            if on_slot is not None:
                on_slot(t, rec, workers, state, metrics)
            if t == last[jid]:
                # drop every reference now: the next job is built before
                # these names are bound again
                del live[jid], state, metrics
    return losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--steps-per-slot", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0,
                    help="the example's flag, used only by its --sim mode "
                         "(launch.sim here): jobs are drawn at seed 0")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    res = schedule(None, args.slots, args.jobs, device)
    print(f"[scheduler] admitted {len(res.admitted)}/{len(res.records)} "
          f"jobs, total utility {res.total_utility:.1f}")

    def on_slot(t, rec, workers, state, metrics):
        active = [r for r in res.admitted if t in r.schedule.slots]
        if rec is active[0]:
            print(f"[slot {t}] running {len(active)} jobs")
        print(f"    job {rec.job.job_id} ({rec.job.arch}): "
              f"workers={workers} loss={float(metrics['loss']):.3f}")

    losses = run_jobs(res, lambda aid: get_config(aid, reduced=True),
                      args.slots, args.steps_per_slot, device,
                      on_slot=on_slot)
    print("\n[summary]")
    for rec in res.admitted:
        ls = losses[rec.job.job_id]
        if len(ls) >= 2:
            print(f"  job {rec.job.job_id} ({rec.job.arch}): loss "
                  f"{ls[0]:.3f} -> {ls[-1]:.3f} over {len(ls)} scheduled "
                  f"slots")
    print(f"on {device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
