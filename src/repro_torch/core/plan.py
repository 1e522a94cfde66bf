"""Query plan layer: composable relational operators over encoded tables.

PyTorch port of ``repro.core.plan``. A ``Query`` stages operators
(filter / semi-join / PK-FK join / map / group-by / aggregate) and runs
them as one program over the resident table. The reference traces that
program once with ``jax.jit``; the port runs it eagerly, op by op, on the
table's device. ``run(jit=...)`` keeps the reference's signature and is
eager either way. The program reads no device value on the host: counts
stay device tensors, and capacities are static, as in the reference.

Appendix D optimization rules implemented here:
  * predicates on RLE columns are applied before Plain columns,
  * composite predicates on one RLE column are fused on the value tensor,
  * semi-joins on RLE columns run before those on Plain columns,
  * for RLE group-by columns the filter mask is folded into alignment.

A terminal ``order_by`` ranks the surviving rows (or, staged after a
``groupby``, the group slots) through ``core/order.py``; ``run()`` then
returns a host-side ``RankedTable``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import arithmetic, compress, groupby, join as join_mod
from repro_torch.core import logical, order as order_mod, telemetry
from repro_torch.core.encodings import (
    IndexColumn,
    IndexMask,
    PlainColumn,
    PlainMask,
    RLEColumn,
    RLEIndexMask,
    RLEMask,
    decode_column,
    decode_mask,
)
from repro_torch.core.table import Table
from repro_torch.device import canonical_dtype, to_numpy
from repro_torch.kernels import dispatch


# --------------------------- predicate expressions -------------------------


@dataclasses.dataclass(frozen=True)
class Pred:
    """Leaf predicate: column <op> literal."""

    col: str
    op: str
    literal: object

    def __and__(self, other):
        return And(self, other)

    def __or__(self, other):
        return Or(self, other)

    def __invert__(self):
        return Not(self)


@dataclasses.dataclass(frozen=True)
class RangePred:
    col: str
    lo: object
    hi: object
    lo_incl: bool = True
    hi_incl: bool = True

    __and__ = Pred.__and__
    __or__ = Pred.__or__
    __invert__ = Pred.__invert__


@dataclasses.dataclass(frozen=True)
class And:
    a: object
    b: object
    __and__ = Pred.__and__
    __or__ = Pred.__or__
    __invert__ = Pred.__invert__


@dataclasses.dataclass(frozen=True)
class Or:
    a: object
    b: object
    __and__ = Pred.__and__
    __or__ = Pred.__or__
    __invert__ = Pred.__invert__


@dataclasses.dataclass(frozen=True)
class Not:
    a: object
    __and__ = Pred.__and__
    __or__ = Pred.__or__
    __invert__ = Pred.__invert__


class _ColRef:
    def __init__(self, name):
        self.name = name

    def __gt__(self, v):
        return Pred(self.name, "gt", v)

    def __ge__(self, v):
        return Pred(self.name, "ge", v)

    def __lt__(self, v):
        return Pred(self.name, "lt", v)

    def __le__(self, v):
        return Pred(self.name, "le", v)

    def __eq__(self, v):  # noqa: A003 - DSL
        return Pred(self.name, "eq", v)

    def __ne__(self, v):
        return Pred(self.name, "ne", v)

    def between(self, lo, hi, lo_incl=True, hi_incl=True):
        return RangePred(self.name, lo, hi, lo_incl, hi_incl)

    def isin(self, values):
        return Pred(self.name, "isin", tuple(values))


def col(name: str) -> _ColRef:
    return _ColRef(name)


# ------------------------------- evaluation --------------------------------


def _pred_cols(expr) -> List[str]:
    if isinstance(expr, (Pred, RangePred)):
        return [expr.col]
    if isinstance(expr, (And, Or)):
        return _pred_cols(expr.a) + _pred_cols(expr.b)
    if isinstance(expr, Not):
        return _pred_cols(expr.a)
    raise TypeError(type(expr))


def _rle_first(expr, table):
    """App. D rule 1: reorder AND children so RLE-column predicates come first."""
    if isinstance(expr, And):
        a, b = _rle_first(expr.a, table), _rle_first(expr.b, table)

        def score(e):
            encs = [table.encoding_of(c) for c in _pred_cols(e)]
            return 0 if any("RLE" in e for e in encs) else 1
        if score(b) < score(a):
            a, b = b, a
        return And(a, b)
    if isinstance(expr, Or):
        return Or(_rle_first(expr.a, table), _rle_first(expr.b, table))
    if isinstance(expr, Not):
        return Not(_rle_first(expr.a, table))
    return expr


def eval_predicate(expr, columns: Dict[str, object], table=None):
    """Evaluate a predicate tree to a MaskColumn (device-side). String
    literals push down as dictionary codes (``Table.code_for``)."""
    if isinstance(expr, Pred):
        c = columns[expr.col]
        lit = expr.literal
        if (table is not None and isinstance(lit, str)
                and expr.op in ("eq", "ne", "lt", "le", "gt", "ge")):
            lit = table.code_for(expr.col, lit, expr.op)
        if expr.op == "isin":
            lits = [table.code_for(expr.col, v)
                    if (table and isinstance(v, str)) else v for v in lit]
            m = arithmetic.compare(c, "eq", lits[0])
            for v in lits[1:]:
                m = logical.or_masks(m, arithmetic.compare(c, "eq", v))
            return m
        return arithmetic.compare(c, expr.op, lit)
    if isinstance(expr, RangePred):
        lo, hi = expr.lo, expr.hi
        if table is not None and isinstance(lo, str):
            lo = table.code_for(expr.col, lo, "ge" if expr.lo_incl else "gt")
        if table is not None and isinstance(hi, str):
            hi = table.code_for(expr.col, hi, "le" if expr.hi_incl else "lt")
        return arithmetic.compare_range(columns[expr.col], lo, hi,
                                        expr.lo_incl, expr.hi_incl)
    if isinstance(expr, And):
        return logical.and_masks(eval_predicate(expr.a, columns, table),
                                 eval_predicate(expr.b, columns, table))
    if isinstance(expr, Or):
        return logical.or_masks(eval_predicate(expr.a, columns, table),
                                eval_predicate(expr.b, columns, table))
    if isinstance(expr, Not):
        return logical.not_mask(eval_predicate(expr.a, columns, table))
    raise TypeError(type(expr))


# --------------------------------- query -----------------------------------


@dataclasses.dataclass
class _FilterOp:
    expr: object


@dataclasses.dataclass
class _SemiJoinOp:
    on: str
    keys: np.ndarray  # host-side key set (from a filtered dimension table)


@dataclasses.dataclass
class _JoinOp:
    """PK-FK join against a resident dimension table (DESIGN.md §6).
    ``host_keys`` is filled by ``Query._prepare_join_side``."""

    fk: str  # fact-side foreign-key column
    on: str  # dimension-side primary-key column
    cols: Tuple[str, ...]  # dimension columns to gather
    out: Tuple[str, ...]  # pipeline names the gathered columns bind to
    dim: object  # Table (resident dimension)
    where: object = None  # predicate evaluated eagerly on the dimension
    host_keys: Optional[np.ndarray] = None


@dataclasses.dataclass
class _GroupByOp:
    group: Tuple[str, ...]
    specs: Tuple[Tuple[str, str, Optional[str]], ...]
    num_groups_cap: int


@dataclasses.dataclass
class _AggOp:
    specs: Tuple[Tuple[str, str, Optional[str]], ...]


@dataclasses.dataclass
class _MapOp:
    out: str
    fn: object  # columns dict -> column


@dataclasses.dataclass
class _OrderByOp:
    """Terminal ranking: ORDER BY ``by`` (with per-key direction), keep the
    first ``limit`` rows/groups (DESIGN.md §10).

    As the pipeline's terminal over rows it ranks surviving rows and
    gathers ``cols`` (default: every pipeline column) at the winners;
    staged directly after a ``groupby`` it ranks the group slots by group
    keys and/or aggregate outputs instead.
    """

    by: Tuple[str, ...]
    descending: Tuple[bool, ...]
    limit: Optional[int]
    cols: Optional[Tuple[str, ...]] = None


def _expr_str(expr) -> str:
    """Compact one-line rendering of a predicate tree (EXPLAIN output)."""
    if isinstance(expr, Pred):
        return f"{expr.col} {expr.op} {expr.literal!r}"
    if isinstance(expr, RangePred):
        lo_b = "[" if expr.lo_incl else "("
        hi_b = "]" if expr.hi_incl else ")"
        return f"{expr.col} in {lo_b}{expr.lo!r}, {expr.hi!r}{hi_b}"
    if isinstance(expr, And):
        return f"({_expr_str(expr.a)}) & ({_expr_str(expr.b)})"
    if isinstance(expr, Or):
        return f"({_expr_str(expr.a)}) | ({_expr_str(expr.b)})"
    if isinstance(expr, Not):
        return f"~({_expr_str(expr.a)})"
    return repr(expr)


def _agg_str(specs) -> str:
    return ", ".join(f"{o}={a}({c})" if c else f"{o}={a}(*)"
                     for o, a, c in specs)


def _expr_signature(expr):
    """Hashable description of a predicate tree, literals included."""
    if expr is None:
        return None
    if isinstance(expr, Pred):
        lit = expr.literal
        if isinstance(lit, (list, np.ndarray)):  # isin literal sets
            lit = tuple(np.asarray(lit).tolist())
        return ("pred", expr.col, expr.op, lit)
    if isinstance(expr, RangePred):
        return ("range", expr.col, expr.lo, expr.hi, expr.lo_incl,
                expr.hi_incl)
    if isinstance(expr, And):
        return ("and", _expr_signature(expr.a), _expr_signature(expr.b))
    if isinstance(expr, Or):
        return ("or", _expr_signature(expr.a), _expr_signature(expr.b))
    if isinstance(expr, Not):
        return ("not", _expr_signature(expr.a))
    raise TypeError(f"unknown predicate node {type(expr).__name__}")


def plan_signature(ops) -> tuple:
    """Hashable key under which two staged pipelines are the same program:
    op structure, filter literal VALUES, semi-join key-set content hashes,
    and ``map`` callables / dimension tables by identity."""
    sig = []
    for op in ops:
        if isinstance(op, _FilterOp):
            sig.append(("filter", _expr_signature(op.expr)))
        elif isinstance(op, _SemiJoinOp):
            keys = np.asarray(op.keys)
            sig.append(("semi_join", op.on, str(keys.dtype), keys.shape,
                        hash(keys.tobytes())))
        elif isinstance(op, _JoinOp):
            sig.append(("join", op.fk, op.on, tuple(op.cols), tuple(op.out),
                        id(op.dim), _expr_signature(op.where)))
        elif isinstance(op, _MapOp):
            sig.append(("map", op.out, id(op.fn)))
        elif isinstance(op, _GroupByOp):
            sig.append(("groupby", tuple(op.group), tuple(op.specs),
                        op.num_groups_cap))
        elif isinstance(op, _AggOp):
            sig.append(("agg", tuple(op.specs)))
        elif isinstance(op, _OrderByOp):
            sig.append(("order_by", tuple(op.by), tuple(op.descending),
                        op.limit,
                        tuple(op.cols) if op.cols is not None else None))
        else:
            raise TypeError(f"unknown op {type(op).__name__}")
    return tuple(sig)


class _SchemaView:
    """Layered, POSITIONAL name resolution over a staged pipeline: filters
    may reference columns bound mid-pipeline by ``join`` (dictionary-coded
    in the DIMENSION's code space) or ``map`` (no ingest metadata)."""

    def __init__(self, table, ops=()):
        self._table = table
        self._joined: Dict[str, tuple] = {}  # out -> (dim, dim_col, fk)
        self._mapped = set()
        for op in ops:
            self.observe(op)

    def observe(self, op) -> None:
        if isinstance(op, _JoinOp):
            for out, c in zip(op.out, op.cols):
                self._joined[out] = (op.dim, c, op.fk)
                self._mapped.discard(out)
        elif isinstance(op, _MapOp):
            self._mapped.add(op.out)
            self._joined.pop(op.out, None)

    def snapshot(self) -> "_SchemaView":
        view = _SchemaView(self._table)
        view._joined = dict(self._joined)
        view._mapped = set(self._mapped)
        return view

    def encoding_of(self, name: str) -> str:
        if name in self._joined:
            _, _, fk = self._joined[name]  # gathered: the FK's encoding
            name = fk
        try:
            return self._table.encoding_of(name)
        except KeyError:
            return "PlainColumn"

    def code_for(self, name: str, value, op: str = "eq"):
        if name in self._joined:
            dim, dim_col, _ = self._joined[name]
            return dim.code_for(dim_col, value, op)
        if name in self._mapped:
            return value
        return self._table.code_for(name, value, op)


class Query:
    """Staged relational pipeline over one (fact) table.

    Dimension-table filtering for semi-joins and PK-FK joins happens
    eagerly on the host (dimension tables are small — paper §9.2); the
    fact-table pipeline runs as one program on the table's device."""

    def __init__(self, table: Table):
        self.table = table
        self.ops: List[object] = []
        # process-unique query id for telemetry attribution
        self.qid = telemetry.next_qid()

    def _schema(self) -> _SchemaView:
        return _SchemaView(self.table, self.ops)

    def filter(self, expr) -> "Query":
        self.ops.append(_FilterOp(_rle_first(expr, self._schema())))
        return self

    def semi_join(self, on: str, keys) -> "Query":
        self.ops.append(_SemiJoinOp(on=on, keys=np.asarray(keys)))
        return self

    def join(self, dim: Table, fk: str, cols: Sequence[str],
             on: Optional[str] = None, where=None, prefix: str = "") -> "Query":
        """Stage a PK-FK join: gather ``cols`` from ``dim`` onto the fact
        pipeline through the ``fk`` column (paper §8.1, DESIGN.md §6).
        ``where`` filters the dimension eagerly; fact entries whose key
        misses every surviving dimension row are dropped (inner join), at
        encoding granularity."""
        if not isinstance(dim, Table):
            raise TypeError("join: the dimension side must be a resident Table")
        on = on or fk
        if on not in dim.columns:
            raise KeyError(f"join: dimension has no key column {on!r}")
        missing = [c for c in cols if c not in dim.columns]
        if missing:
            raise KeyError(f"join: dimension has no column(s) {missing!r}")
        if isinstance(self.table, Table) and fk not in self.table.columns:
            raise KeyError(f"join: fact table has no FK column {fk!r}")
        out = tuple(prefix + c for c in cols)
        self.ops.append(_JoinOp(fk=fk, on=on, cols=tuple(cols), out=out,
                                dim=dim, where=where))
        return self

    def map(self, out: str, fn) -> "Query":
        self.ops.append(_MapOp(out=out, fn=fn))
        return self

    def groupby(self, group: Sequence[str],
                aggs: Dict[str, Tuple[str, Optional[str]]],
                num_groups_cap: int = 1024) -> "Query":
        specs = tuple((o, a, c) for o, (a, c) in aggs.items())
        self.ops.append(_GroupByOp(tuple(group), specs, num_groups_cap))
        return self

    def aggregate(self, aggs: Dict[str, Tuple[str, Optional[str]]]) -> "Query":
        specs = tuple((o, a, c) for o, (a, c) in aggs.items())
        self.ops.append(_AggOp(specs))
        return self

    def order_by(self, by, descending=False, limit: Optional[int] = None,
                 cols: Optional[Sequence[str]] = None) -> "Query":
        """Stage a terminal ORDER BY / TOP-K / LIMIT (DESIGN.md §10).

        ``by``: column name or sequence of names; ``descending``: bool or
        per-key sequence. Over rows, the result is the first ``limit``
        surviving rows in rank order with ``cols`` (default: all pipeline
        columns) gathered at them — ``run()`` returns a host-side
        ``RankedTable`` with dictionary codes decoded. Staged after
        ``groupby``, ``by`` names group keys and/or aggregate outputs and
        the group slots are ranked instead. Ties keep ascending row order
        and NaN keys rank last, matching pandas
        ``sort_values(kind="stable")``.
        """
        by = (by,) if isinstance(by, str) else tuple(by)
        if not by:
            raise ValueError("order_by: need at least one key")
        if isinstance(descending, bool):
            desc = (descending,) * len(by)
        else:
            desc = tuple(bool(d) for d in descending)
        if len(desc) != len(by):
            raise ValueError("order_by: descending must be a bool or match "
                             f"the {len(by)} keys")
        if limit is not None and int(limit) < 1:
            raise ValueError("order_by: limit must be >= 1")
        if any(isinstance(op, _OrderByOp) for op in self.ops):
            raise ValueError("order_by: already staged")
        if any(isinstance(op, _AggOp) for op in self.ops):
            raise ValueError("order_by: cannot order a scalar aggregate")
        gops = [op for op in self.ops if isinstance(op, _GroupByOp)]
        if gops:
            known = set(gops[-1].group) | {o for o, _, _ in gops[-1].specs}
            missing = [b for b in by if b not in known]
            if missing:
                raise KeyError(
                    f"order_by after groupby: {missing!r} neither group "
                    "keys nor aggregate outputs")
            if cols is not None:
                raise ValueError("order_by after groupby: the output is the "
                                 "ranked group table; cols= does not apply")
        self.ops.append(_OrderByOp(
            by=by, descending=desc,
            limit=None if limit is None else int(limit),
            cols=None if cols is None else tuple(cols)))
        return self

    # -- execution ----------------------------------------------------------

    def _reorder_semijoins(self):
        """App. D rule 3: semi-joins on RLE columns before Plain columns."""
        def key(op):
            return 0 if "RLE" in self.table.encoding_of(op.on) else 1
        out, block = [], []
        for op in self.ops:
            if isinstance(op, _SemiJoinOp):
                block.append(op)
            else:
                out.extend(sorted(block, key=key))
                block = []
                out.append(op)
        out.extend(sorted(block, key=key))
        self.ops = out

    def build(self, partial: bool = False):
        """Build the program: (columns, key_sets, base_mask) -> result.

        ``base_mask`` (optional MaskColumn) is ANDed in before any staged
        operator. ``partial=True`` rewrites terminal aggregates into
        decomposable partials (avg -> sum + count) via ``decompose_specs``.
        """
        self._reorder_semijoins()
        ops = list(self.ops)
        for i, op in enumerate(ops):
            if isinstance(op, _OrderByOp) and i != len(ops) - 1:
                raise ValueError("order_by must be the pipeline's last op")
        if partial:
            ops = [_decompose_op(op) for op in ops]
        table = self.table
        key_domains = _groupby_key_domains(ops, table)
        order_domains = _order_key_domains(ops, table)
        order_cols = _order_output_cols(ops, table)
        walk = _SchemaView(table)
        filter_schemas = {}
        for i, op in enumerate(ops):
            if isinstance(op, _FilterOp):
                filter_schemas[i] = walk.snapshot()
            else:
                walk.observe(op)

        def program(columns, key_sets, base_mask=None):
            # each packed leaf is unpacked once a program (the scope ends
            # with it, so nothing it unpacked outlives the run)
            with dispatch.unpack_once():
                return run_ops(columns, key_sets, base_mask)

        def run_ops(columns, key_sets, base_mask):
            mask = base_mask
            env = dict(columns)
            ks = list(key_sets)
            for i, op in enumerate(ops):
                if isinstance(op, _FilterOp):
                    m = eval_predicate(op.expr, env, filter_schemas[i])
                    mask = m if mask is None else logical.and_masks(mask, m)
                elif isinstance(op, _SemiJoinOp):
                    keys, n_keys = ks.pop(0)
                    m = join_mod.semi_join_mask(env[op.on], keys, n_keys)
                    mask = m if mask is None else logical.and_masks(mask, m)
                elif isinstance(op, _JoinOp):
                    keys, n_keys, payloads = ks.pop(0)
                    m, gathered = join_mod.pk_fk_join(env[op.fk], keys,
                                                      n_keys, payloads)
                    mask = m if mask is None else logical.and_masks(mask, m)
                    for out, c in zip(op.out, op.cols):
                        env[out] = gathered[c]
                elif isinstance(op, _MapOp):
                    env[op.out] = op.fn(env)
                elif isinstance(op, _GroupByOp):
                    needed = set(op.group) | {c for _, _, c in op.specs if c}
                    sub = {k: env[k] for k in needed}
                    res = groupby.groupby_aggregate(
                        sub, op.group, op.specs, op.num_groups_cap, mask=mask,
                        key_domains=key_domains)
                    nxt = ops[i + 1] if i + 1 < len(ops) else None
                    if isinstance(nxt, _OrderByOp) and not partial:
                        # rank the group slots; under partial (partitioned)
                        # execution ranking happens AFTER the host merge —
                        # per-partition partial aggregates have no rank yet
                        res = order_mod.rank_groupby(res, nxt.by,
                                                     nxt.descending, nxt.limit)
                    return res
                elif isinstance(op, _OrderByOp):
                    # terminal ranked query over rows: rank, then gather
                    # the output columns at the k winners only
                    nrows_here = next(iter(env.values())).nrows
                    limit = op.limit if op.limit is not None else nrows_here
                    positions, n = order_mod.top_k_rows(
                        {b: env[b] for b in op.by}, op.by, op.descending,
                        limit, mask=mask, key_domains=order_domains)
                    gathered = {name: order_mod.gather_at(env[name],
                                                          positions, n)
                                for name in order_cols}
                    return order_mod.OrderedRows(positions=positions, n=n,
                                                 columns=gathered)
                elif isinstance(op, _AggOp):
                    needed = {c for _, _, c in op.specs if c}
                    out = {}
                    val_specs = [s for s in op.specs if s[2]]
                    cnt_specs = [s for s in op.specs if not s[2]]
                    if needed:
                        sub = {k: env[k] for k in needed}
                        view = groupby.align_columns(sub, mask=mask)
                        gid = torch.zeros_like(view.lengths)
                        out.update(groupby.aggregate(
                            view, gid, val_specs + cnt_specs, 1))
                    elif cnt_specs:
                        # COUNT(*) is the mask's cardinality (run lengths for
                        # RLE — paper §7.2)
                        card = (_mask_cardinality(mask) if mask is not None
                                else torch.tensor(table.nrows,
                                                  dtype=torch.int32,
                                                  device=table.device))
                        for o, _, _ in cnt_specs:
                            out[o] = card.reshape(1)
                    return {k: v[0] for k, v in out.items()}
            return mask, env
        return program

    def terminal_op(self):
        """The query's terminal aggregate op (_AggOp / _GroupByOp), or None."""
        for op in self.ops:
            if isinstance(op, (_AggOp, _GroupByOp)):
                return op
        return None

    def order_op(self):
        """The staged _OrderByOp, or None."""
        for op in self.ops:
            if isinstance(op, _OrderByOp):
                return op
        return None

    # -- observability: EXPLAIN ---------------------------------------------

    def _group_path(self, op: "_GroupByOp") -> str:
        """The grouping implementation the current policy + ingest metadata
        select (the planner's estimate; the dtype check is at run time)."""
        pol = dispatch.policy()
        if not pol.enable_sort_free:
            return "argsort grouping (sort-free disabled)"
        doms = _groupby_key_domains(self.ops, self.table)
        if doms is None or any(g not in doms for g in op.group):
            return "argsort grouping (no ingest domain for every key)"
        prod = 1
        for g in op.group:
            prod *= int(doms[g][1])
        if prod > pol.sort_free_max_domain:
            return (f"argsort grouping (key domain {prod} > "
                    f"sort_free_max_domain={pol.sort_free_max_domain})")
        return f"sort-free scatter (key domain {prod})"

    def _order_path(self, oop: "_OrderByOp") -> str:
        """The ranking path the policy + encodings select (mirrors
        order.top_k_rows's entry/bounded gates)."""
        pol = dispatch.policy()
        if any(isinstance(o, _GroupByOp) for o in self.ops):
            return "rank group slots after merge"
        if not pol.enable_entry_order:
            return "row-level top-k (entry ordering disabled)"
        walk = _SchemaView(self.table, self.ops)
        encs = [walk.encoding_of(b) for b in oop.by]
        if not all(("RLE" in e or "Index" in e) for e in encs):
            return "row-level top-k (keys not entry-encoded)"
        doms = _order_key_domains(self.ops, self.table)
        if doms is not None and all(b in doms for b in oop.by):
            prod = 1
            for b in oop.by:
                prod *= int(doms[b][1])
            if prod <= pol.sort_free_max_domain:
                return f"bounded-histogram rank (key domain {prod})"
        return "entry-granularity sort"

    def _explain_lines(self) -> List[str]:
        """One line per staged op: the op, the referenced columns' stored
        encodings at that pipeline position, and the execution path the
        current dispatch policy selects."""
        table = self.table
        head = (f"{type(self).__name__} qid={self.qid}: "
                f"{type(table).__name__}, {getattr(table, 'nrows', '?')} rows")
        lines = [head]
        walk = _SchemaView(table)
        pad = "  "

        def enc(cols):
            uniq = list(dict.fromkeys(c for c in cols if c))
            return ", ".join(f"{c}:{walk.encoding_of(c)}" for c in uniq)

        for op in self.ops:
            if isinstance(op, _FilterOp):
                cols = _pred_cols(op.expr)
                lines.append(f"{pad}filter {_expr_str(op.expr)}"
                             f"  [{enc(cols)}]")
            elif isinstance(op, _SemiJoinOp):
                lines.append(f"{pad}semi_join on {op.on} "
                             f"({len(np.unique(op.keys))} keys)"
                             f"  [{enc([op.on])}]")
            elif isinstance(op, _JoinOp):
                lines.append(f"{pad}join {op.fk}->{op.on} "
                             f"gather {list(op.cols)}"
                             "  [path: entry-granularity PK-FK probe, "
                             f"FK zone-map pushdown; {enc([op.fk])}]")
            elif isinstance(op, _MapOp):
                lines.append(f"{pad}map -> {op.out}  [computed column: "
                             "zone maps / domains invalidated]")
            elif isinstance(op, _GroupByOp):
                cols = list(op.group) + [c for _, _, c in op.specs]
                lines.append(f"{pad}groupby[{', '.join(op.group)}] "
                             f"{_agg_str(op.specs)}"
                             f"  [path: {self._group_path(op)}; {enc(cols)}]")
            elif isinstance(op, _AggOp):
                cols = [c for _, _, c in op.specs]
                tail = f"; {enc(cols)}" if any(cols) else ""
                lines.append(f"{pad}aggregate {_agg_str(op.specs)}"
                             f"  [path: fused single-pass reduction{tail}]")
            elif isinstance(op, _OrderByOp):
                lines.append(f"{pad}order_by[{', '.join(op.by)}] "
                             f"limit={op.limit}"
                             f"  [path: {self._order_path(op)}; "
                             f"{enc(list(op.by))}]")
            walk.observe(op)
            pad += "  "
        return lines

    def explain(self) -> str:
        """Compressed-domain plan tree (EXPLAIN): per-op input encodings and
        the execution paths the current policy picks. Nothing executes."""
        return "\n".join(self._explain_lines())

    def explain_analyze(self, jit: bool = True) -> str:
        """EXPLAIN plus one measured execution (EXPLAIN ANALYZE): runs the
        query with tracing force-enabled and appends the wall time (to the
        device's completion). The partitioned override adds per-stage ms
        and partition visit/prune/transfer accounting
        (``PartitionedQuery.explain_analyze``)."""
        dev = getattr(self.table, "device", None)
        with dispatch.overrides(enable_trace=True):
            t0 = time.perf_counter()
            self.run(jit=jit)
            if dev is not None and dev.type == "cuda":
                torch.cuda.synchronize(dev)
            wall = (time.perf_counter() - t0) * 1e3
        self.last_analysis = {"wall_ms": round(wall, 3)}
        lines = self._explain_lines()
        lines.append(f"actual: wall {wall:.3f} ms, one eager program over "
                     "the resident table")
        return "\n".join(lines)

    def _ranked_dictionaries(self) -> Dict[str, np.ndarray]:
        """name -> dictionary for decoding a ranked result's columns: base
        columns use the (fact) table's dictionaries; join-gathered columns
        the DIMENSION's; map outputs none."""
        dicts = dict(getattr(self.table, "dictionaries", None) or {})
        for op in self.ops:
            if isinstance(op, _JoinOp):
                for out, c in zip(op.out, op.cols):
                    dicts.pop(out, None)
                    d = (getattr(op.dim, "dictionaries", None) or {}).get(c)
                    if d is not None:
                        dicts[out] = d
            elif isinstance(op, _MapOp):
                dicts.pop(op.out, None)
        return dicts

    def run(self, jit: bool = True):
        """Execute: eager key-set/dimension preparation + the fact pipeline.

        ``jit`` is kept for signature parity with the reference; the port
        runs eagerly either way (no trace, no compile cache). A
        row-terminal ``order_by`` finalizes host-side into a
        ``RankedTable`` (exact-size arrays, dictionary codes decoded)."""
        key_sets = tuple(self._prepare_inputs())
        program = self.build()
        # host time to launch the operators (and any wait for the device
        # inside them)
        with telemetry.span("plan.program", qid=self.qid):
            out = program(self.table.columns, key_sets)
        if isinstance(out, order_mod.OrderedRows):
            return order_mod.ranked_table_from_state(
                order_mod.host_block(out), self._ranked_dictionaries())
        return out

    def _prepare_inputs(self):
        """Eager host-side preparation, one entry per semi-join / join op in
        (reordered) pipeline order — the program pops them positionally."""
        self._reorder_semijoins()
        dev = self.table.device
        prepared = []
        for op in self.ops:
            if isinstance(op, _SemiJoinOp):
                keys = np.unique(op.keys)
                keys = keys.astype(canonical_dtype(keys.dtype), copy=False)
                arr = np.concatenate(
                    [keys, np.full((1,), _sentinel_for(keys.dtype), keys.dtype)])
                prepared.append((torch.from_numpy(arr).to(dev),
                                 torch.tensor(len(keys), dtype=torch.int32,
                                              device=dev)))
            elif isinstance(op, _JoinOp):
                with telemetry.span("plan.join_side", qid=self.qid):
                    prepared.append(self._prepare_join_side(op))
        return prepared

    def _prepare_join_side(self, op: _JoinOp):
        """Build the dimension side of a PK-FK join, once per execution:
        evaluate ``where`` on the dimension, bring keys + payloads into the
        dimension's sorted key order, translate surviving PKs into the fact
        FK's stored value space, pad to a pow2 capacity with sentinel keys.
        Returns ``(keys, n, payloads)`` tensors on the fact table's device
        and records the host key set on the op."""
        dim = op.dim
        keep = None
        if op.where is not None:
            mask, _ = Query(dim).filter(op.where).build()(dim.columns, ())
            keep = to_numpy(decode_mask(mask))
        order = dim.sorted_order(op.on)
        key_vals = to_numpy(decode_column(dim.columns[op.on]))
        if op.on in dim.dictionaries:
            key_vals = dim.dictionaries[op.on][key_vals]  # codes -> values
        payloads = {c: to_numpy(decode_column(dim.columns[c]))
                    for c in op.cols}
        if order is not None:
            key_vals = key_vals[order]
            payloads = {c: v[order] for c, v in payloads.items()}
            if keep is not None:
                keep = keep[order]
        if keep is not None:
            key_vals = key_vals[keep]
            payloads = {c: v[keep] for c, v in payloads.items()}
        fact_dicts = getattr(self.table, "dictionaries", None) or {}
        if op.fk in fact_dicts:
            d = fact_dicts[op.fk]
            if len(d) == 0:
                hit = np.zeros(len(key_vals), bool)
                keys = np.zeros((0,), np.int32)
            else:
                idx = np.searchsorted(d, key_vals)
                idx_c = np.minimum(idx, len(d) - 1)
                hit = d[idx_c] == key_vals
                keys = idx_c[hit].astype(np.int32)
            payloads = {c: v[hit] for c, v in payloads.items()}
        elif key_vals.dtype.kind in ("U", "S", "O"):
            raise ValueError(
                f"join: dimension key {op.on!r} is string-valued but fact "
                f"FK {op.fk!r} is not dictionary-encoded — the key spaces "
                "cannot be aligned")
        elif key_vals.dtype.kind in "iub":
            # keys outside the int32 device value domain cannot match any
            # fact FK value — DROP them
            i32 = np.iinfo(np.int32)
            in_range = (key_vals >= i32.min) & (key_vals <= i32.max)
            if not np.all(in_range):
                key_vals = key_vals[in_range]
                payloads = {c: v[in_range] for c, v in payloads.items()}
            keys = key_vals.astype(np.int32)
        else:
            keys = key_vals.astype(np.float32)
        if keys.size and np.any(keys[1:] == keys[:-1]):
            raise ValueError(
                f"join: dimension key {op.on!r} is not unique among "
                "surviving rows — PK-FK joins need a unique build side")
        op.host_keys = keys
        n = len(keys)
        cap = compress.next_pow2(n + 1, 8)
        sentinel = _sentinel_for(keys.dtype)
        keys_p = np.concatenate(
            [keys, np.full((cap - n,), sentinel, keys.dtype)])
        pay_p = {c: np.concatenate([v, np.zeros((cap - n,), v.dtype)])
                 for c, v in payloads.items()}
        dev = self.table.device
        return (torch.from_numpy(keys_p).to(dev),
                torch.tensor(n, dtype=torch.int32, device=dev),
                {c: torch.from_numpy(v.astype(canonical_dtype(v.dtype),
                                              copy=False)).to(dev)
                 for c, v in pay_p.items()})


def _live_domains_at(ops, table, stop_type):
    """Walk ``ops`` maintaining live ingest domains up to the first
    ``stop_type`` op: a ``map`` rebinding a name invalidates its domain;
    join-gathered attributes carry the DIMENSION's domain."""
    live = dict(getattr(table, "domains", None) or {})
    for op in ops:
        if isinstance(op, _MapOp):
            live.pop(op.out, None)
        elif isinstance(op, _JoinOp):
            for out, c in zip(op.out, op.cols):
                live.pop(out, None)
                dom = (getattr(op.dim, "domains", None) or {}).get(c)
                if dom is not None:
                    live[out] = dom
        elif isinstance(op, stop_type):
            return op, live
    return None, None


def _groupby_key_domains(ops, table):
    """Bounded-domain metadata (name -> (lo, size)) for the terminal
    group-by's key columns — the sort-free grouping contract."""
    op, live = _live_domains_at(ops, table, _GroupByOp)
    if op is None:
        return None
    doms = {g: live[g] for g in op.group if g in live}
    return doms or None


def _order_key_domains(ops, table):
    """Bounded-domain metadata for a row-terminal order_by's keys — the
    histogram-rank path's contract (order.top_k_rows), with the same
    pipeline-order invalidation as the group-by domains."""
    op, live = _live_domains_at(ops, table, _OrderByOp)
    if op is None or any(isinstance(o, _GroupByOp) for o in ops):
        return None
    doms = {b: live[b] for b in op.by if b in live}
    return doms or None


def _table_column_names(table) -> Tuple[str, ...]:
    cols = getattr(table, "columns", None)
    if cols is not None:
        return tuple(cols)
    return tuple(getattr(table, "col_dtypes", {}))  # PartitionedTable


def _order_output_cols(ops, table):
    """Output column set of a row-terminal order_by: the staged ``cols``
    or every name live in the pipeline at that point."""
    oop = next((op for op in ops if isinstance(op, _OrderByOp)), None)
    if oop is None or any(isinstance(op, _GroupByOp) for op in ops):
        return None
    if oop.cols is not None:
        return tuple(dict.fromkeys(oop.cols + oop.by))
    names = list(_table_column_names(table))
    for op in ops:
        if isinstance(op, _JoinOp):
            names.extend(n for n in op.out if n not in names)
        elif isinstance(op, _MapOp) and op.out not in names:
            names.append(op.out)
    return tuple(names)


# ----------------------- partial-aggregate decomposition -------------------

_COMBINE = {"sum": "add", "count": "add", "min": "min", "max": "max"}


def decompose_specs(specs: Sequence[Tuple[str, str, Optional[str]]]):
    """Rewrite agg specs into decomposable partials + finalize rules:
    (partial_specs, finalize) with finalize entries (out, kind, operands),
    kind "identity" or "div" (avg = sum / count)."""
    partial_specs, finalize = [], []
    for out, agg, c in specs:
        if agg in _COMBINE:
            partial_specs.append((out, agg, c))
            finalize.append((out, "identity", (out,)))
        elif agg == "avg":
            s, k = f"{out}@sum", f"{out}@cnt"
            partial_specs.append((s, "sum", c))
            partial_specs.append((k, "count", None))
            finalize.append((out, "div", (s, k)))
        else:
            raise NotImplementedError(
                f"aggregate {agg!r} is not decomposable for partitioned "
                "execution (supported: sum/count/min/max/avg)")
    seen, deduped = set(), []
    for spec in partial_specs:
        if spec[0] not in seen:
            seen.add(spec[0])
            deduped.append(spec)
    return tuple(deduped), tuple(finalize)


def _decompose_op(op):
    if isinstance(op, _AggOp):
        return _AggOp(specs=decompose_specs(op.specs)[0])
    if isinstance(op, _GroupByOp):
        return _GroupByOp(group=op.group, specs=decompose_specs(op.specs)[0],
                          num_groups_cap=op.num_groups_cap)
    return op


def _combine_partials(acc, new, agg):
    how = _COMBINE[agg]
    if how == "add":
        return acc + new
    return np.minimum(acc, new) if how == "min" else np.maximum(acc, new)


def _apply_finalize(partials: Dict[str, np.ndarray], finalize):
    out = {}
    for name, kind, operands in finalize:
        if kind == "identity":
            out[name] = partials[operands[0]]
        elif kind == "div":
            s, c = partials[operands[0]], partials[operands[1]]
            out[name] = s / np.maximum(c, 1)
        else:
            raise ValueError(kind)
    return out


def _identity_partial(agg: str, col: Optional[str], col_dtypes):
    """Identity element for an aggregate whose every partition was skipped;
    its dtype derives from the COLUMN's ingest dtype (float32 for unknown
    columns), so an integer SUM/MIN/MAX stays integer."""
    if agg == "count":
        return np.int64(0)
    dt = (col_dtypes or {}).get(col)
    if dt is not None and np.issubdtype(np.dtype(dt), np.integer):
        if agg == "sum":
            return np.int64(0)
        return (np.iinfo(np.int64).max if agg == "min"
                else np.iinfo(np.int64).min)
    return (np.float32(0) if agg == "sum"
            else np.float32(np.inf) if agg == "min"
            else np.float32(-np.inf))


def fold_scalar_partial(acc: Optional[Dict[str, np.ndarray]],
                        partial: Dict[str, object],
                        partial_specs) -> Dict[str, np.ndarray]:
    """Fold ONE partition's scalar-aggregate partial into the running
    accumulator (host side), so the streamed executor merges partial ``i``
    while partitions ``i+1..i+k`` transfer and compute. The host copy is
    where the host waits for the partition's device values. Folding in
    partition order matches the batch merge bit for bit."""
    block = {o: to_numpy(partial[o]) for o, _, _ in partial_specs}
    if acc is None:
        return block
    return {o: _combine_partials(acc[o], block[o], agg)
            for o, agg, _ in partial_specs}


def finalize_scalar_partials(acc: Optional[Dict[str, np.ndarray]],
                             specs: Sequence[Tuple[str, str, Optional[str]]],
                             col_dtypes: Optional[Dict[str, np.dtype]] = None):
    """Finalize a folded scalar accumulator: identity elements for
    aggregates with NO surviving partition (dtype from the column's ingest
    dtype), then the finalize rules (avg = sum / count)."""
    partial_specs, finalize = decompose_specs(specs)
    if acc is None:
        acc = {o: _identity_partial(agg, c, col_dtypes)
               for o, agg, c in partial_specs}
    return _apply_finalize(acc, finalize)


def merge_scalar_partials(partials: Sequence[Dict[str, object]],
                          specs: Sequence[Tuple[str, str, Optional[str]]],
                          col_dtypes: Optional[Dict[str, np.dtype]] = None):
    """Merge per-partition scalar-aggregate partials (host side): batch
    wrapper over ``fold_scalar_partial`` + ``finalize_scalar_partials``;
    ``specs`` are the ORIGINAL (pre-decomposition) specs."""
    partial_specs, _ = decompose_specs(specs)
    acc = None
    for p in partials:
        acc = fold_scalar_partial(acc, p, partial_specs)
    return finalize_scalar_partials(acc, specs, col_dtypes)


def _mask_cardinality(m):
    """Selected-row count without decoding (run lengths for RLE: §7.2)."""
    if isinstance(m, PlainMask):
        return m.values.sum(dtype=torch.int32)
    if isinstance(m, RLEMask):
        return m.lengths.sum(dtype=torch.int32)
    if isinstance(m, IndexMask):
        return m.n.to(torch.int32)
    if isinstance(m, RLEIndexMask):
        return _mask_cardinality(m.rle) + _mask_cardinality(m.idx)
    raise TypeError(type(m))


def _sentinel_for(dtype):
    if np.issubdtype(dtype, np.integer):
        return np.iinfo(dtype).max
    return np.inf


# ------------------------- PK-FK join helper -------------------------------


def pk_fk_gather(fact_key_col, dim_keys_sorted: torch.Tensor,
                 dim_payload: torch.Tensor, fill=0):
    """Star-schema PK-FK join: per fact *entry* (run / point / row), fetch
    the unique-key dimension payload; the fact key column is never
    decompressed. Returns a column in the fact key's encoding."""
    from repro_torch.core.encodings import fill_scalar, unpack_values

    def lookup(keys):
        # packed run/point keys go to the fused unpack->bisect kernel; the
        # hit test reads the unpacked codes
        slot = dispatch.bucketize(dim_keys_sorted, keys, right=False)
        slot_c = torch.clamp(slot, max=dim_keys_sorted.shape[0] - 1)
        hit = dim_keys_sorted[slot_c] == unpack_values(keys)
        vals = dim_payload[slot_c]
        return torch.where(hit, vals, fill_scalar(fill, vals.dtype,
                                                  vals.device))

    if isinstance(fact_key_col, PlainColumn):
        return PlainColumn(values=lookup(fact_key_col.decode()),
                           nrows=fact_key_col.nrows)
    if isinstance(fact_key_col, RLEColumn):
        return RLEColumn(values=lookup(fact_key_col.values),
                         starts=fact_key_col.starts, ends=fact_key_col.ends,
                         n=fact_key_col.n, nrows=fact_key_col.nrows)
    if isinstance(fact_key_col, IndexColumn):
        return IndexColumn(values=lookup(fact_key_col.values),
                           positions=fact_key_col.positions, n=fact_key_col.n,
                           nrows=fact_key_col.nrows)
    raise TypeError(type(fact_key_col))
