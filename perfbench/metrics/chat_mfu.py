"""The served batches' model FLOPs (``counts.serve_batch_flops``: active
parameters only) over the window's wall time, as a share of the card's
bf16 peak."""
from perfbench import counts


def read(run):
    if not run.batches or run.window_s <= 0:
        return None
    S, new = run.traffic["prompt_len"], run.traffic["new_tokens"]
    flops = sum(counts.serve_batch_flops(run.m, len(b["ids"]), S, new)
                for b in run.batches)
    return 100.0 * flops / run.window_s / counts.BF16_FLOPS
