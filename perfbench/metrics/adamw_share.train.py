"""AdamW's share of the training step's device time: the device time of
the ops launched inside the program's ``train.adamw`` spans (the global
norm and every slab of the update) over that of the ops launched inside
its ``train.step`` spans (``perfbench/spans.py``). The numerator's ops
are a subset of the denominator's, so it cannot pass 100 %."""
from perfbench import spans


def read(run):
    placed = spans.of_run(run)
    if placed is None:
        return None
    return spans.share_pct(placed.busy_s("train.adamw"),
                           placed.busy_s("train.step"))
