"""AdamW's share of its bytes bound: 14 bytes a param (bf16 param,
gradient and both moments read once; param and moments written once) at
the card's HBM bandwidth, over the mean device time a step of the ops
launched inside the program's ``train.adamw`` span. It counts only what
every correct update must move, fused or not, and reads nothing unless
each span's ``elements`` is the configuration's param count."""
from perfbench import counts, spans
from perfbench.layout import param_count

#: bytes an element of a bf16 AdamW step must move: p, g, m, v read and
#: p, m, v written, 2 bytes each
BYTES_PER_PARAM = 14


def read(run):
    placed = spans.of_run(run)
    if placed is None:
        return None
    n = param_count(run.m)
    steps = placed.ops_by("train.adamw")
    if not steps or any(placed.spans[i].attrs.get("elements") != n
                        for i in steps):
        return None
    mean_s = sum(e - s for ops in steps.values() for _, s, e in ops) \
        / len(steps)
    return spans.share_pct(BYTES_PER_PARAM * n / counts.HBM_BYTES, mean_s)
