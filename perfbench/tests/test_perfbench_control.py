"""The check that decides ``correct`` fails where it must: the control
(the reference in bfloat16 in the program's place) on every cell's mix,
and a run whose timed path is broken underneath, once for each fault a
query cell can have: an answer altered where it is produced, and half of
the rows left out of the scan."""
import dataclasses

import numpy as np
import pytest
import torch

from perfbench import control
from perfbench.tests._tiny import CELLS, SCALE, SEED, quiet_warnings, run_cell  # noqa: F401


@pytest.mark.parametrize("workload", CELLS)
def test_control_comes_out_not_correct(workload):
    checks, ok = control.control_checks(workload, SEED, scale=SCALE)
    assert not ok
    rel = checks["float_rel_err"]
    assert rel["value"] >= 3 * rel["limit"], rel


def _off(v):
    """A float value off by 2^-8 of itself, an integer off by one."""
    floating = (v.is_floating_point() if isinstance(v, torch.Tensor)
                else np.issubdtype(np.asarray(v).dtype, np.floating))
    return v * (1 + 2.0 ** -8) if floating else v + 1


def _alter(res):
    """One answer altered: its aggregates off, or the first two ranked
    rows swapped."""
    from repro_torch.core.order import RankedTable
    if isinstance(res, RankedTable):
        pos = res.positions.copy()
        pos[[0, 1]] = pos[[1, 0]]
        return dataclasses.replace(res, positions=pos)
    if isinstance(res, dict):
        return {k: _off(v) for k, v in res.items()}
    return dataclasses.replace(res, aggs={k: _off(v)
                                          for k, v in res.aggs.items()})


@pytest.fixture(params=["altered", "half_rows"])
def broken(request, monkeypatch):
    from repro_torch.core import plan, serve
    from repro_torch.core.encodings import PlainMask
    if request.param == "altered":
        run = plan.Query.run
        monkeypatch.setattr(plan.Query, "run",
                            lambda self, *a, **k: _alter(run(self, *a, **k)))
        finish = serve.QueryServer._finish

        def finish_altered(self, ticket, result=None, **kw):
            if result is not None:
                result = _alter(result)
            return finish(self, ticket, result, **kw)
        monkeypatch.setattr(serve.QueryServer, "_finish", finish_altered)
    else:
        build = plan.Query.build

        def build_half(self, partial=False):
            prog = build(self, partial)
            if type(self) is not plan.Query:  # served: partitions, below
                return prog
            n = self.table.nrows
            half = PlainMask(values=torch.arange(n, device=self.table.device)
                             < n // 2, nrows=n)
            return lambda cols, key_sets, base_mask=None: prog(cols, key_sets,
                                                               half)
        monkeypatch.setattr(plan.Query, "build", build_half)
        prep = serve.QueryServer._prep

        def prep_half(self, ticket):
            item = prep(self, ticket)
            item.todo = item.todo[: len(item.todo) // 2]
            return item
        monkeypatch.setattr(serve.QueryServer, "_prep", prep_half)
    return request.param


@pytest.mark.parametrize("workload", CELLS)
def test_broken_timed_path_comes_out_not_correct(workload, broken,
                                                 quiet_warnings):  # noqa: F811
    line = run_cell(workload)
    assert line["correct"] is False, (broken, line["checks"])
    checks = line["checks"]
    assert (checks["exact_mismatches"]["value"] > 0
            or checks["float_rel_err"]["value"] > checks["float_rel_err"]["limit"])


def test_comparison_readings():
    from perfbench.reference.compare import compare
    want = {"num_groups": 2, "keys": {"k": np.array([0, 1])},
            "aggs": {"s": np.array([1.0, 2.0]), "c": np.array([3, 4])}}
    same = {"num_groups": 2, "keys": {"k": np.array([0, 1], np.int32)},
            "aggs": {"s": np.array([1.0, 2.0001], np.float32),
                     "c": np.array([3, 4], np.int32)}}
    bad, rel = compare(same, want)
    assert bad == 0 and 4e-5 < rel < 6e-5
    wrong = dict(same, keys={"k": np.array([1, 1])})
    assert compare(wrong, want)[0] == 1
    assert compare({"num_groups": 1, "keys": {}, "aggs": {}}, want)[0] >= 3
    ranked = {"positions": np.array([5, 2]), "n": 2,
              "columns": {"p": np.array([1.5, 0.5], np.float32)}}
    assert compare(ranked, ranked) == (0, 0.0)
    swapped = dict(ranked, positions=np.array([2, 5]))
    assert compare(swapped, ranked)[0] == 2
    assert compare({"x": np.float32(2.0)}, {"x": 1.0})[1] == 1.0
    assert compare(None, {"x": 1.0}) == (1, 0.0)
