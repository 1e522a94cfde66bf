"""The metrics read from the program's own records (``metrics/_spans.py``
and the readers beside it): a tiny traced CPU run of each cell reports
them, and a reader returns None where the program kept no such record
or its ring lost part of the slice."""
import json
import time
import types
from pathlib import Path

import pytest

from perfbench import harness
from perfbench.metrics import _spans
from perfbench.tests._tiny import SCALE, SEED, quiet_warnings  # noqa: F401

ROOT = Path(__file__).resolve().parents[2]
SPANS = {"resident_scan": {"join_side_ms_per_query",
                           "program_host_ms_per_query"},
         "served_mix": {"join_side_ms_per_query.served",
                        "program_host_ms_per_query.served",
                        "queue_wait_ms_per_query"}}


@pytest.mark.parametrize("workload", sorted(SPANS))
def test_traced_cell_reports_the_program_spans(workload, quiet_warnings):  # noqa: F811
    line = harness.run_cell(workload, SEED, 0.5, True, "cpu", scale=SCALE,
                            slice_s=1.0)
    assert line["correct"] is True, line["checks"]
    want = {m["name"] for m in harness.metrics_of(
        json.loads((ROOT / "BENCHMARK.json").read_text()), workload, True)}
    assert SPANS[workload] <= want
    m = line["metrics"]
    assert SPANS[workload] <= set(m), sorted(m)
    for name in SPANS[workload]:
        assert m[name]["unit"] == "ms" and m[name]["value"] >= 0.0
    stem = "program_host_ms_per_query"
    assert m[stem if workload == "resident_scan" else stem + ".served"][
        "value"] > 0.0


def _fake_run(window, answered=None):
    """A run with the slice ``window``; with ``answered``, a device slice
    in which those many queries were answered."""
    if answered is None:
        return types.SimpleNamespace(slice_window=window, slice=None)
    return types.SimpleNamespace(
        slice_window=window, slice=object(),
        done=lambda w: [object()] * answered)


def _span(name, ms=1.0, qid=1):
    """A span of ``ms`` of query ``qid`` that ends now."""
    from repro_torch.core import telemetry
    telemetry.registry().record(name, time.perf_counter() - ms / 1e3,
                                ms / 1e3, qid=qid)


def test_readers_return_none_without_records_or_with_lost_ones():
    from repro_torch.core import telemetry
    from repro_torch.kernels import dispatch
    telemetry.reset()
    try:
        t0 = time.perf_counter()
        run = _fake_run((t0, t0 + 60.0))
        # a program that recorded nothing in the slice: nothing to read
        assert _spans.ms_per_query(run, ("plan.join_side",)) is None
        _span("plan.program", 2.0, qid=1)
        _span("plan.join_side", 0.5, qid=2)
        # no device slice: over the two queries the records name
        assert _spans.ms_per_query(run, ("plan.join_side",)) == \
            pytest.approx(0.25)
        assert _spans.ms_per_query(run, ("serve.program",)) == 0.0
        # a device slice: over the queries answered in it, as the device
        # metrics count them; none answered, nothing to divide by
        assert _spans.ms_per_query(_fake_run(run.slice_window, 5),
                                   ("plan.program",)) == pytest.approx(0.4)
        assert _spans.ms_per_query(_fake_run(run.slice_window, 0),
                                   ("plan.program",)) is None
        # the ring dropped events that ended inside the slice
        with dispatch.overrides(trace_buffer_events=2):
            _span("plan.program")
        assert telemetry.registry().dropped == 1
        assert _spans.ms_per_query(run, ("plan.program",)) is None
        # what it dropped ended before the slice: the slice is whole
        late = _fake_run((time.perf_counter(), time.perf_counter() + 60.0))
        with dispatch.overrides(trace_buffer_events=2):
            _span("plan.program", qid=3)
        assert _spans.ms_per_query(late, ("plan.program",)) == \
            pytest.approx(1.0)
    finally:
        telemetry.reset()


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", sorted(SPANS))
def test_program_spans_on_the_card_tiny(workload, card, quiet_warnings):  # noqa: F811
    line = harness.run_cell(workload, 13, 0.5, True, card, scale=0.05,
                            slice_s=1.0)
    assert line["correct"] is True, line["checks"]
    m = line["metrics"]
    assert SPANS[workload] <= set(m), sorted(m)
    assert all(m[n]["value"] > 0.0 for n in SPANS[workload]
               if not n.startswith("join_side")), m
