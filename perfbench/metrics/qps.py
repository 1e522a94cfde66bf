"""Queries answered in the window over the window's length."""


def read(run):
    return len(run.done()) / run.seconds
