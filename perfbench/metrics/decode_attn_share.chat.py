"""The decode attention's share of the decode steps' device time: the
device time of the ops launched inside the program's
``model.attention.core`` spans within its ``serve.decode_step`` spans
(the product over the cache, its float32 casts included; projections and
cache writes outside), over that of every op launched inside
``serve.decode_step`` (``perfbench/spans.py``)."""
from perfbench import spans


def read(run):
    placed = spans.of_run(run)
    if placed is None:
        return None
    return spans.share_pct(
        placed.busy_s("model.attention.core", within="serve.decode_step"),
        placed.busy_s("serve.decode_step"))
