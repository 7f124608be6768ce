"""The 95th percentile over every decode step of the window of its device
interval: from the start of the first op launched inside the program's
``serve.decode_step`` span to the end of its last (``perfbench/spans.py``)."""
import numpy as np

from perfbench import spans


def read(run):
    placed = spans.of_run(run)
    if placed is None:
        return None
    steps = [ops for ops in placed.ops_by("serve.decode_step").values()
             if ops]
    if not steps:
        return None
    ms = [(max(e for _, _, e in ops) - min(s for _, s, _ in ops)) * 1e3
          for ops in steps]
    return float(np.percentile(ms, 95))
