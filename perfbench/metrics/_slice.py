"""What the per-query readers of the profiled slice share."""


def answered(run):
    """Requests answered inside the profiled slice, or None."""
    if run.slice is None or run.slice_window is None:
        return None
    return run.done(run.slice_window) or None


def per_query(run, seconds_of):
    """``seconds_of(slice)`` in ms, over the requests answered in the
    slice."""
    done = answered(run)
    if done is None:
        return None
    return seconds_of(run.slice) * 1e3 / len(done)
