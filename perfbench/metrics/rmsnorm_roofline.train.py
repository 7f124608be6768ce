"""``rmsnorm``'s share of its bytes bound on the training rows (batch x
seq_len by d), its launches at that shape matched in order to the
window's (QK-norm's launches aside)."""
from perfbench import readers


def read(run):
    if not run.steps:
        return None
    return readers.rmsnorm_share(run, run.traffic["batch"]
                                 * run.traffic["seq_len"])
