"""The engine's prefill time a batch: the mean of
``Completion.prefill_ms`` over the window's batches."""


def read(run):
    if not run.batches:
        return None
    return sum(b["prefill_ms"] for b in run.batches) / len(run.batches)
