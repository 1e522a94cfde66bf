"""1 - (the union of device kernel, copy and memset intervals) / the
profiled slice's length."""


def read(run):
    if run.slice is None:
        return None
    return 1.0 - run.slice.busy_s / run.slice.window_s
