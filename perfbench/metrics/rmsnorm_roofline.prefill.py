"""``rmsnorm``'s share of its bytes bound on the prefill's rows (B x S by
d), its launches at that shape matched in order to the window's."""
from perfbench import readers


def read(run):
    if not run.batches:
        return None
    B = max(len(b["ids"]) for b in run.batches)
    return readers.rmsnorm_share(run, B * run.traffic["prompt_len"])
