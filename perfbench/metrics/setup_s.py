"""Seconds from the process's start to the window's: imports, data
generation, ingest, the kernels' build where none is cached, warm-up."""


def read(run):
    return run.timings["setup_s"]
