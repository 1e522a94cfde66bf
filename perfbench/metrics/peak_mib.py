"""``torch.cuda.max_memory_allocated()`` over ingest, warm-up and the
window, in MiB (the data generator's sort on the card comes before)."""


def read(run):
    return run.peak_bytes / 2**20 if run.peak_bytes else None
