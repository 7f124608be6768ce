"""The window's training model FLOPs (PaLM's count, no recomputation:
``counts.train_step_flops``) over its wall time, as a share of the bf16
peak."""
from perfbench import counts


def read(run):
    if not run.steps or run.window_s <= 0:
        return None
    t = run.traffic
    flops = len(run.steps) * counts.train_step_flops(
        run.m, counts.matrix_params(run.m), t["batch"] * t["seq_len"],
        t["seq_len"])
    return 100.0 * flops / run.window_s / counts.BF16_FLOPS
