"""The window's prefill model FLOPs (``counts.prefill_flops``, logits at
the last position) over its wall time, as a share of the bf16 peak."""
from perfbench import counts


def read(run):
    if not run.batches or run.window_s <= 0:
        return None
    S = run.traffic["prompt_len"]
    flops = sum(counts.prefill_flops(run.m, len(b["ids"]), S)
                for b in run.batches)
    return 100.0 * flops / run.window_s / counts.BF16_FLOPS
