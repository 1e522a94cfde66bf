"""Tiny runs of the harness on the CPU, shared by the tests."""
import pytest

SCALE = 0.005  # TPC-H scale factor of a tiny run: about 30,000 LINEITEM rows
SEED = 3_000_000_019  # above 2**31, as the checks' seeds are
CELLS = ("resident_scan", "served_mix")
LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def run_cell(workload, traced=False, seconds=0.5, seed=SEED):
    from perfbench import harness
    return harness.run_cell(workload, seed, seconds, traced, "cpu",
                            scale=SCALE, slice_s=0.3)


@pytest.fixture
def quiet_warnings():
    """The tiny served table is smaller than the server's prefetch ring
    wants: its clamp warns, which says nothing about the harness."""
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        yield
