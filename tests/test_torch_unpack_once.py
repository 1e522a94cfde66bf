"""Each packed leaf is unpacked once per query program (``dispatch.unpack_once``).

The reference runs a query as one jitted program, where XLA expands each
packed leaf once however many operators read it; the port runs the same
program eagerly and gets that from a scope around each program call. On
the CPU with ``use_kernels=True`` every packed read reaches the
``unpack_kernel`` wrapper (its plain version for CPU tensors), so the
wrapper's calls are the launches the card would see. These tests hold:

  1. inside one program each leaf reaches ``unpack_kernel`` once, fewer
     calls than without the scope, and the answers are the same bits;
  2. no reader writes into an unpacked leaf (each tensor's version counter
     is still 0 after the run);
  3. the scope ends with the program: no unpacked tensor outlives
     ``Query.run`` / ``PartitionedQuery.run``, and a resident packed
     table's ``nbytes`` and values are unchanged;
  4. after each streamed query every leaf unpacks to what it did before,
     and streamed answers are bit-identical across prefetch depths 0/1/2,
     to the resident (packed and unpacked) and to the unpacked streamed
     runs, each against the numpy oracle of ``chip_smoke.py``.
"""
import contextlib
import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch.core import compress as tc
from repro_torch.core import partition as TP
from repro_torch.core.encodings import PackedColumn
from repro_torch.core.table import Table as TTable
from repro_torch.kernels import dispatch, ref

from torch_twins import CPU

TCFG = tc.CompressionConfig(plain_threshold=1000)
QUERIES = ["Q1", "Q6", "Q17", "Q3"]


@pytest.fixture(scope="module")
def tpch():
    """name -> (lineitem arrays, oracle answer), the ORDERS table and the
    part keys, at 40,000 rows (5 partitions of 2^13 rows)."""
    rng = np.random.default_rng(2)
    n = 40_000
    part_keys = np.unique(rng.integers(0, n // 30, n // 600)).astype(np.int32)
    orders = chip_smoke.make_orders(rng, n // 4)
    orders_table = TTable.from_arrays(orders, cfg=TCFG, device=CPU)
    per_query = {}
    for name in QUERIES:
        data = chip_smoke.make_lineitem(rng, n,
                                        order=chip_smoke.SORT_ORDERS[name])
        per_query[name] = (data, chip_smoke.oracle(name, data, orders=orders,
                                                   part_keys=part_keys))
    return per_query, orders_table, part_keys


def _partitioned(data, pack=True):
    return TP.PartitionedTable.from_arrays(data, cfg=TCFG,
                                           partition_rows=1 << 13, pack=pack,
                                           device=CPU)


def _query(tpch, name, table, partitioned=True):
    _, orders_table, part_keys = tpch
    return chip_smoke.build_query(
        name, table, orders_table, part_keys,
        query_cls=TP.PartitionedQuery if partitioned else None)


def _packed_leaves(tree):
    """Every ``PackedColumn`` of an encoded column tree."""
    if isinstance(tree, PackedColumn):
        return [tree]
    if isinstance(tree, dict):
        return [p for v in tree.values() for p in _packed_leaves(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [p for f in dataclasses.fields(tree)
                for p in _packed_leaves(getattr(tree, f.name))]
    return []


def _in_scope():
    """Leaves held by this thread's ``unpack_once`` scope, None outside."""
    memo = getattr(dispatch._SCOPE, "memo", None)
    return None if memo is None else len(memo)


def _spy(monkeypatch):
    """Calls of the ``unpack_kernel`` wrapper that dispatch reaches: (the
    words it got, the tensor it returned)."""
    calls = []
    real = dispatch.unpack_kernel

    def wrapper(words, *args, **kw):
        out = real(words, *args, **kw)
        calls.append((words, out))
        return out

    monkeypatch.setattr(dispatch, "unpack_kernel", wrapper)
    return calls


def _run(q):
    with dispatch.overrides(use_kernels=True):
        return chip_smoke.host_result(q.run())


@pytest.mark.parametrize("name", QUERIES)
def test_each_leaf_unpacks_once_a_program(tpch, monkeypatch, name):
    """Streamed over packed partitions, every ``unpack_kernel`` call
    expands a leaf no other call of the run expanded; without the scope
    the same run expands leaves again, and its answer has the same bits.
    No unpacked tensor was written in place."""
    data, want = tpch[0][name]
    pt = _partitioned(data)
    calls = _spy(monkeypatch)
    got = _run(_query(tpch, name, pt))
    chip_smoke.check_answer(name, got, want)
    leaves = {id(w) for w, _ in calls}  # the words stay alive in `calls`
    assert calls and len(leaves) == len(calls), (len(leaves), len(calls))
    assert all(out._version == 0 for _, out in calls)
    once = len(calls)
    calls.clear()
    monkeypatch.setattr(dispatch, "unpack_once", contextlib.nullcontext)
    again = _run(_query(tpch, name, pt))
    assert chip_smoke._bits(again) == chip_smoke._bits(got)
    assert all(out._version == 0 for _, out in calls)
    if name in ("Q1", "Q6"):  # at this size their programs reread leaves
        assert len(calls) > once, (len(calls), once)


@pytest.mark.parametrize("name", QUERIES)
def test_scope_ends_with_the_program(tpch, monkeypatch, name):
    """After ``Query.run`` on a resident packed table and after
    ``PartitionedQuery.run``, no scope is open and every tensor the scope
    unpacked is gone; the resident table keeps its bytes and values."""
    data, want = tpch[0][name]
    resident = TTable.from_arrays(data, cfg=TCFG, pack=True, device=CPU)
    leaves = _packed_leaves(resident.columns)
    assert leaves
    before = [ref.ref_unpack(p.words, p.bit_width, p.offset, p.nrows)
              for p in leaves]
    nbytes = resident.nbytes()
    calls = _spy(monkeypatch)
    for table, partitioned in ((resident, False), (_partitioned(data), True)):
        got = _run(_query(tpch, name, table, partitioned))
        chip_smoke.check_answer(name, got, want)
        assert _in_scope() is None
        assert calls
        alive = [weakref.ref(out) for _, out in calls]
        calls.clear()
        gc.collect()
        assert not [r for r in alive if r() is not None]
    assert resident.nbytes() == nbytes
    for p, b in zip(leaves, before):
        assert torch.equal(ref.ref_unpack(p.words, p.bit_width, p.offset,
                                          p.nrows), b)


def test_nested_scopes_join_the_outer_one():
    """A program run inside another scope (the dimension filter of a join
    side) shares the outer memo, which ends with the outer scope only."""
    v = np.arange(100, dtype=np.int64)
    w = torch.from_numpy(tc.pack_array(v, 0, 7).view(np.int32))
    leaf = PackedColumn(words=w, nrows=100, bit_width=7, offset=0)
    assert _in_scope() is None
    with dispatch.unpack_once():
        first = dispatch.unpack(leaf)
        with dispatch.unpack_once():
            assert dispatch.unpack(leaf) is first
        assert _in_scope() == 1
        other = PackedColumn(words=w, nrows=100, bit_width=7, offset=0)
        assert dispatch.unpack(other) is not first  # keyed by identity
        assert _in_scope() == 2
    assert _in_scope() is None
    assert dispatch.unpack(leaf) is not first
    np.testing.assert_array_equal(first.numpy(), v)


@pytest.mark.parametrize("name", QUERIES)
def test_streamed_answers_unchanged_by_the_scope(tpch, name):
    """Every partition's leaves unpack to the same values after each
    streamed run; answers at depths 0/1/2 are bit-identical to each other,
    to the resident runs (packed and unpacked) and to the streamed run
    over unpacked partitions, and match the oracle."""
    data, want = tpch[0][name]
    pt = _partitioned(data)
    leaves = [p for part in pt.partitions
              for p in _packed_leaves(part.table.columns)]
    assert leaves
    before = [ref.ref_unpack(p.words, p.bit_width, p.offset, p.nrows)
              for p in leaves]
    got = {}
    for depth in (0, 1, 2):
        with dispatch.overrides(prefetch_depth=depth):
            got[depth] = _run(_query(tpch, name, pt))
        for p, b in zip(leaves, before):
            assert torch.equal(ref.ref_unpack(p.words, p.bit_width, p.offset,
                                              p.nrows), b)
    chip_smoke.check_answer(name, got[0], want)
    for depth in (1, 2):
        assert chip_smoke._bits(got[depth]) == chip_smoke._bits(got[0])
    others = [_run(_query(tpch, name, _partitioned(data, pack=False)))]
    for pack in (True, False):
        table = TTable.from_arrays(data, cfg=TCFG, pack=pack, device=CPU)
        others.append(_run(_query(tpch, name, table, partitioned=False)))
    for other in others:
        chip_smoke.check_same(name, got[0], other)
    assert chip_smoke._bits(others[0]) == chip_smoke._bits(got[0])
