"""The engine's decode time a token step: the mean over the window's
batches of ``Completion.decode_ms / (new_tokens - 1)`` (device time,
taken after a sync)."""


def read(run):
    new = run.traffic["new_tokens"]
    if not run.batches or new < 2:
        return None
    return sum(b["decode_ms"] / (new - 1) for b in run.batches) \
        / len(run.batches)
