"""``rmsnorm_bwd``'s share of its bytes bound (x and dy read, dx written
once) on the training rows (batch x seq_len by d): its calls whose rows
pass is the block-a-row kernel, the width-d norms (QK-norm's 128-wide
rows take the narrow kernel), rows pass and column pass together a call;
every such call of a step is at that shape."""
from perfbench import counts, readers


def read(run):
    calls = readers.rmsnorm_bwd_pairs(run, "rmsnorm_bwd_wide")
    m, t = run.m, run.traffic
    if not calls or len(calls) != (2 * m.layers + 1) * len(run.steps):
        return None
    N = t["batch"] * t["seq_len"]
    bound = counts.rmsnorm_bwd_bytes(N, m.d) / counts.HBM_BYTES
    return readers.share_pct(bound, sum(calls) / len(calls))
