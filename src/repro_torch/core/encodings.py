"""Encoded column/mask representations (paper §3), PyTorch port.

Every encoding is a frozen dataclass over torch tensors with:
  * host metadata: ``nrows`` (logical row count of the column); the
    capacity (max number of runs / index points) is the buffers' length,
  * tensor fields: fixed-capacity buffers plus a 0-d int32 count ``n``
    that stays on the device.

Padding convention (the *sentinel invariant*): slots at positions >= n hold
``starts = ends = nrows`` (RLE) or ``positions = nrows`` (Index) and
``values = 0``. Because every valid position is < nrows, the sentinel keeps
the buffers sorted, which lets ``searchsorted``-based primitives operate on
the whole fixed-size buffer without masking the tail first.

The layout, dtypes (int32 positions, ``POS_DTYPE``) and capacities are the
reference's (``repro.core.encodings``), so buffers compare one-to-one.
Torch raises on out-of-range indices where JAX clamps (reads) or drops
(updates); ``take_clamped`` / ``take_fill`` / ``scatter_drop`` below give
the JAX semantics without a host synchronisation.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.device import as_tensor, resolve_device
from repro_torch.kernels.ref import SPARE_SLOTS, drop_slots

POS_DTYPE = torch.int32


# ---------------------------------------------------------------------------
# JAX indexing semantics on torch tensors
# ---------------------------------------------------------------------------


def _normalized(idx: torch.Tensor, size: int) -> torch.Tensor:
    idx = idx.to(torch.int64)
    return torch.where(idx < 0, idx + size, idx)


def take_clamped(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` with JAX's gather semantics: negative indices wrap once,
    then every index clamps into range."""
    size = x.shape[0]
    if size == 0:
        return torch.zeros(idx.shape, dtype=x.dtype, device=x.device)
    return x[_normalized(idx, size).clamp(0, size - 1)]


def take_fill(x: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """``x.at[idx].get(mode="fill", fill_value=fill)``."""
    size = x.shape[0]
    idx = _normalized(idx, size)
    ok = (idx >= 0) & (idx < size)
    if size == 0:
        return torch.full(idx.shape, fill, dtype=x.dtype, device=x.device)
    vals = x[idx.clamp(0, size - 1)]
    return torch.where(ok, vals, fill_scalar(fill, x.dtype))


def scatter_drop(out: torch.Tensor, idx: torch.Tensor, src,
                 how: str = "set") -> torch.Tensor:
    """``out.at[idx].<how>(src, mode="drop")`` as a new tensor.

    Out-of-range updates land in a block of spare slots, chosen by
    position (``ref.drop_slots``), that is sliced off. ``how`` is set /
    add / amin / amax."""
    size = out.shape[0]
    idx = drop_slots(_normalized(idx, size), size)
    if not isinstance(src, torch.Tensor):  # a fill kernel, not a host copy
        src = torch.full(idx.shape, fill_scalar(src, out.dtype),
                         dtype=out.dtype, device=out.device)
    elif src.dim() == 0:
        src = src.to(out.dtype).expand(idx.shape)
    else:
        src = src.to(out.dtype)
    ext = torch.cat([out, out.new_zeros((SPARE_SLOTS,))])
    if how == "set":
        ext.scatter_(0, idx, src)
    elif how == "add":
        ext.index_add_(0, idx, src)
    elif how in ("amin", "amax"):
        ext.scatter_reduce_(0, idx, src, how, include_self=True)
    else:
        raise ValueError(how)
    return ext[:size]


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """``jnp.cumsum`` dtypes (x64 off): bool and int32 sums are int32,
    narrower integers keep their dtype."""
    return torch.cumsum(x, 0, dtype=torch.int32 if x.dtype == torch.bool
                        else x.dtype)


def is_integer(dtype: torch.dtype) -> bool:
    """``jnp.issubdtype(dtype, jnp.integer)`` (bool is not an integer)."""
    return not dtype.is_floating_point and not dtype.is_complex \
        and dtype != torch.bool


def fill_scalar(fill, dtype: torch.dtype):
    """``jnp.asarray(fill, dtype)`` as a Python scalar, cast on the host.
    An operator takes it as an operand, so no device tensor is built from
    a host value: no copy to the device, nothing a CUDA graph cannot
    hold."""
    return torch.tensor(fill).to(dtype).item()


# ---------------------------------------------------------------------------
# Data columns
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PackedColumn:
    """Bit-packed integer buffer leaf (DESIGN.md §11).

    Stands in for a tensor in the buffer slots of the other encodings
    (plain values / dictionary codes, RLE values/starts/ends, index
    values/positions): unsigned ``bit_width``-bit codes densely packed into
    32-bit lanes, logical value = code + ``offset`` (int32 wrap-add).
    ``words`` is an int32 tensor holding the uint32 lanes' bit patterns
    (torch has no full uint32 arithmetic); ``offset`` is a host integer.
    Packing happens on the host at ingest (``compress.pack_array``).

    Unpacking is lazy and on the device: readers call ``unpack_values`` /
    ``.unpack()``, which routes through ``dispatch.unpack`` (the CUDA
    ``unpack_kernel`` on the card). ``nrows`` is the logical element count
    of the packed vector: rows for a plain payload, capacity for run/point
    buffers.
    """

    words: torch.Tensor
    nrows: int = 0
    bit_width: int = 32
    offset: Any = 0

    @property
    def shape(self):
        return (self.nrows,)

    @property
    def size(self) -> int:
        return self.nrows

    @property
    def dtype(self):
        return torch.int32  # logical (unpacked) dtype

    @property
    def device(self) -> torch.device:
        return self.words.device

    def unpack(self) -> torch.Tensor:
        from repro_torch.kernels import dispatch
        return dispatch.unpack(self)


def unpack_values(x):
    """Materialize a buffer slot: identity for tensors, routed unpack for
    ``PackedColumn`` leaves (the single choke point every buffer READ goes
    through)."""
    return x.unpack() if isinstance(x, PackedColumn) else x


@dataclasses.dataclass(frozen=True)
class PlainColumn:
    """Plain (uncompressed) column: 1:1 row-to-slot mapping (paper §3.1).

    ``offset`` implements the paper's §3.2 *centering* for bit-width
    reduction: logical value = values (widened to int32) + offset. It is a
    host scalar; 0 for uncentered columns.
    """

    values: torch.Tensor
    nrows: int = 0
    offset: Any = 0

    @property
    def capacity(self) -> int:
        return self.values.shape[0]

    def decode(self) -> torch.Tensor:
        """Materialize logical values; centering widens integers to int32."""
        v = unpack_values(self.values)
        if not offset_is_zero(self.offset):
            if is_integer(v.dtype):
                v = v.to(torch.int32)
            v = v + self.offset
        return v


def offset_is_zero(offset) -> bool:
    """True only for a HOST-side zero offset."""
    return isinstance(offset, (int, float)) and offset == 0


@dataclasses.dataclass(frozen=True)
class RLEColumn:
    """Run-length encoded column: (values, starts, ends, n) (paper §3.1).

    Runs are sorted by start, non-overlapping; slot i covers rows
    starts[i]..ends[i] inclusive. Gaps are allowed (post-filter columns).
    """

    values: torch.Tensor
    starts: torch.Tensor
    ends: torch.Tensor
    n: torch.Tensor  # 0-d int32: number of valid runs
    nrows: int = 0

    @property
    def capacity(self) -> int:
        return self.starts.shape[0]

    @property
    def lengths(self) -> torch.Tensor:
        """Run lengths (0 for padding slots)."""
        valid = valid_slots(self.n, self.capacity)
        ln = unpack_values(self.ends) - unpack_values(self.starts) + 1
        return torch.where(valid, ln, torch.zeros_like(ln))


@dataclasses.dataclass(frozen=True)
class IndexColumn:
    """Index-encoded column: (values, positions, n), sorted positions (§3.1)."""

    values: torch.Tensor
    positions: torch.Tensor
    n: torch.Tensor
    nrows: int = 0

    @property
    def capacity(self) -> int:
        return self.positions.shape[0]


@dataclasses.dataclass(frozen=True)
class PlainIndexColumn:
    """Composite Plain + Index (paper §3.2): narrow-dtype base + outliers."""

    base: PlainColumn
    outliers: IndexColumn
    nrows: int = 0


@dataclasses.dataclass(frozen=True)
class RLEIndexColumn:
    """Composite RLE + Index (paper §3.2): pure runs + impure singletons.
    Positions covered by ``rle`` and ``idx`` are disjoint."""

    rle: RLEColumn
    idx: IndexColumn
    nrows: int = 0


# ---------------------------------------------------------------------------
# Mask columns (paper §3.3)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlainMask:
    values: torch.Tensor  # bool[nrows]
    nrows: int = 0

    @property
    def capacity(self) -> int:
        return self.values.shape[0]


@dataclasses.dataclass(frozen=True)
class RLEMask:
    starts: torch.Tensor
    ends: torch.Tensor
    n: torch.Tensor
    nrows: int = 0

    @property
    def capacity(self) -> int:
        return self.starts.shape[0]

    @property
    def lengths(self) -> torch.Tensor:
        valid = valid_slots(self.n, self.capacity)
        ln = self.ends - self.starts + 1
        return torch.where(valid, ln, torch.zeros_like(ln))


@dataclasses.dataclass(frozen=True)
class IndexMask:
    positions: torch.Tensor
    n: torch.Tensor
    nrows: int = 0

    @property
    def capacity(self) -> int:
        return self.positions.shape[0]


@dataclasses.dataclass(frozen=True)
class RLEIndexMask:
    rle: RLEMask
    idx: IndexMask
    nrows: int = 0


DataColumn = (PlainColumn, RLEColumn, IndexColumn, PlainIndexColumn, RLEIndexColumn)
MaskColumn = (PlainMask, RLEMask, IndexMask, RLEIndexMask)


def map_tensors(fn, tree):
    """``tree`` with ``fn`` applied to every tensor in it: the fields of an
    encoded column (nested encodings and packed leaves included), or the
    values of a dict / list / tuple of them. Host scalars (``offset``)
    and static fields pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_tensors(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def tensor_leaves(tree, out: Optional[list] = None) -> list:
    """Every tensor of ``tree`` (see ``map_tensors``), in field order,
    appended to ``out``; the walk rebuilds nothing."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            tensor_leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            tensor_leaves(v, out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            tensor_leaves(getattr(tree, f.name), out)
    return out


# ---------------------------------------------------------------------------
# Constructors (host arrays go to ``device``; tensors keep theirs)
# ---------------------------------------------------------------------------


def _device_of(values, device):
    if isinstance(values, torch.Tensor) and device is None:
        return values.device
    return resolve_device(device)


def _count(k, device) -> torch.Tensor:
    return torch.as_tensor(k, dtype=torch.int32, device=device).reshape(())


def make_plain(values, nrows: Optional[int] = None, offset=0,
               device=None) -> PlainColumn:
    values = as_tensor(values, _device_of(values, device))
    return PlainColumn(values=values,
                       nrows=int(nrows if nrows is not None else values.shape[0]),
                       offset=offset)


def make_rle(values, starts, ends, nrows: int, n=None,
             capacity: Optional[int] = None, device=None) -> RLEColumn:
    """Build an RLEColumn from (possibly unpadded) host arrays or tensors."""
    dev = _device_of(values, device)
    values = as_tensor(values, dev)
    starts = as_tensor(starts, dev, POS_DTYPE)
    ends = as_tensor(ends, dev, POS_DTYPE)
    k = starts.shape[0]
    n = _count(k if n is None else n, dev)
    cap = capacity or k
    if cap > k:
        pad = cap - k
        values = torch.cat([values, torch.zeros((pad,), dtype=values.dtype,
                                                device=dev)])
        starts = torch.cat([starts, torch.full((pad,), nrows, dtype=POS_DTYPE,
                                               device=dev)])
        ends = torch.cat([ends, torch.full((pad,), nrows, dtype=POS_DTYPE,
                                           device=dev)])
    return RLEColumn(values=values, starts=starts, ends=ends, n=n, nrows=nrows)


def make_index(values, positions, nrows: int, n=None,
               capacity: Optional[int] = None, device=None) -> IndexColumn:
    dev = _device_of(values, device)
    values = as_tensor(values, dev)
    positions = as_tensor(positions, dev, POS_DTYPE)
    k = positions.shape[0]
    n = _count(k if n is None else n, dev)
    cap = capacity or k
    if cap > k:
        pad = cap - k
        values = torch.cat([values, torch.zeros((pad,), dtype=values.dtype,
                                                device=dev)])
        positions = torch.cat([positions, torch.full(
            (pad,), nrows, dtype=POS_DTYPE, device=dev)])
    return IndexColumn(values=values, positions=positions, n=n, nrows=nrows)


def make_rle_mask(starts, ends, nrows: int, n=None,
                  capacity: Optional[int] = None, device=None) -> RLEMask:
    dev = _device_of(starts, device)
    c = make_rle(torch.zeros((len(starts),), dtype=torch.int8, device=dev),
                 starts, ends, nrows, n, capacity)
    return RLEMask(starts=c.starts, ends=c.ends, n=c.n, nrows=nrows)


def make_index_mask(positions, nrows: int, n=None,
                    capacity: Optional[int] = None, device=None) -> IndexMask:
    dev = _device_of(positions, device)
    c = make_index(torch.zeros((len(positions),), dtype=torch.int8, device=dev),
                   positions, nrows, n, capacity)
    return IndexMask(positions=c.positions, n=c.n, nrows=nrows)


def make_plain_mask(values, nrows: Optional[int] = None,
                    device=None) -> PlainMask:
    values = as_tensor(values, _device_of(values, device), torch.bool)
    return PlainMask(values=values,
                     nrows=int(nrows if nrows is not None else values.shape[0]))


# ---------------------------------------------------------------------------
# Padding / slicing helpers used throughout the primitives
# ---------------------------------------------------------------------------


def valid_slots(n: torch.Tensor, capacity: int) -> torch.Tensor:
    """Boolean [capacity] mask of valid slots."""
    return torch.arange(capacity, dtype=torch.int32, device=n.device) < n


def pad_positions(pos: torch.Tensor, n: torch.Tensor, nrows: int) -> torch.Tensor:
    """Force sentinel on invalid tail slots (restores sorted invariant)."""
    return torch.where(valid_slots(n, pos.shape[0]), pos, nrows)


def with_capacity_1d(x: torch.Tensor, cap: int, fill) -> torch.Tensor:
    """Pad or truncate a 1-D tensor to ``cap`` with ``fill``."""
    k = x.shape[0]
    if k == cap:
        return x
    if k > cap:
        return x[:cap]
    return torch.cat([x, torch.full((cap - k,), fill, dtype=x.dtype,
                                    device=x.device)])


# ---------------------------------------------------------------------------
# Decoding to plain
# ---------------------------------------------------------------------------


def _run_id_per_row(starts, n, nrows: int) -> torch.Tensor:
    """run id covering-or-preceding each row: cumsum of start deltas, O(n).
    Sentinel starts (== nrows) drop out of range."""
    starts = unpack_values(starts)
    valid = valid_slots(n, starts.shape[0])
    delta = scatter_drop(
        torch.zeros((nrows + 1,), dtype=POS_DTYPE, device=starts.device),
        starts, valid.to(POS_DTYPE), "add")
    return cumsum(delta[:nrows]) - 1  # -1 before the first run


def decode_rle_values(col: RLEColumn, fill=0) -> torch.Tensor:
    """Expand RLE to a dense [nrows] value tensor (gaps -> fill).

    Dispatch-routed (DESIGN.md §5): the CUDA ``rle_decode`` kernel when the
    policy picks it, else the scatter+cumsum formulation below."""
    from repro_torch.kernels import dispatch
    starts, ends = unpack_values(col.starts), unpack_values(col.ends)
    routed = dispatch.maybe_rle_decode(col.values, starts, ends, col.n,
                                       col.nrows, fill)
    if routed is not None:
        return routed
    vals = unpack_values(col.values)
    if col.capacity == 0:
        return torch.full((col.nrows,), fill_scalar(fill, vals.dtype),
                          dtype=vals.dtype, device=vals.device)
    run_raw = _run_id_per_row(starts, col.n, col.nrows)
    run = torch.clamp(run_raw, 0, col.capacity - 1)
    rows = torch.arange(col.nrows, dtype=POS_DTYPE, device=vals.device)
    cov = (run_raw >= 0) & (rows <= ends[run]) & (run_raw < col.n)
    return torch.where(cov, vals[run], fill_scalar(fill, vals.dtype))


def decode_rle_coverage(starts, ends, n, nrows: int) -> torch.Tensor:
    """Boolean [nrows]: true where some run covers the row. O(n) sweep:
    +1 at run starts, -1 after run ends, prefix sum > 0."""
    starts, ends = unpack_values(starts), unpack_values(ends)
    valid = valid_slots(n, starts.shape[0])
    one = valid.to(POS_DTYPE)
    delta = torch.zeros((nrows + 1,), dtype=POS_DTYPE, device=starts.device)
    delta = scatter_drop(delta, starts, one, "add")
    delta = scatter_drop(delta, ends + 1, -one, "add")
    return cumsum(delta[:nrows]) > 0


def decode_index_values(col: IndexColumn, fill=0) -> torch.Tensor:
    vals = unpack_values(col.values)
    out = torch.full((col.nrows,), fill_scalar(fill, vals.dtype),
                     dtype=vals.dtype, device=vals.device)
    return scatter_drop(out, unpack_values(col.positions), vals, "set")


def decode_index_coverage(positions, n, nrows: int) -> torch.Tensor:
    positions = unpack_values(positions)
    out = torch.zeros((nrows,), dtype=torch.bool, device=positions.device)
    return scatter_drop(out, positions, valid_slots(n, positions.shape[0]),
                        "set")


def decode_mask(m) -> torch.Tensor:
    """Materialize any mask to bool[nrows]."""
    if isinstance(m, PlainMask):
        return m.values
    if isinstance(m, RLEMask):
        return decode_rle_coverage(m.starts, m.ends, m.n, m.nrows)
    if isinstance(m, IndexMask):
        return decode_index_coverage(m.positions, m.n, m.nrows)
    if isinstance(m, RLEIndexMask):
        return decode_mask(m.rle) | decode_mask(m.idx)
    raise TypeError(f"not a mask: {type(m)}")


def decode_column(c, fill=0) -> torch.Tensor:
    """Materialize any data column to dense [nrows] values (gaps -> fill)."""
    if isinstance(c, PlainColumn):
        return c.decode()
    if isinstance(c, RLEColumn):
        return decode_rle_values(c, fill)
    if isinstance(c, IndexColumn):
        return decode_index_values(c, fill)
    if isinstance(c, PlainIndexColumn):
        base = c.base.decode()
        cov = decode_index_coverage(c.outliers.positions, c.outliers.n, c.nrows)
        out_vals = decode_index_values(c.outliers, 0)
        return torch.where(cov, out_vals.to(base.dtype), base)
    if isinstance(c, RLEIndexColumn):
        rle_vals = decode_rle_values(c.rle, fill)
        rle_cov = decode_rle_coverage(c.rle.starts, c.rle.ends, c.rle.n,
                                      c.nrows)
        idx_cov = decode_index_coverage(c.idx.positions, c.idx.n, c.nrows)
        idx_vals = decode_index_values(c.idx, 0)
        out = torch.where(rle_cov, rle_vals, fill_scalar(fill, rle_vals.dtype))
        return torch.where(idx_cov, idx_vals.to(out.dtype), out)
    raise TypeError(f"not a data column: {type(c)}")


def coverage(c) -> torch.Tensor:
    """Boolean [nrows] of rows present in the (possibly gapped) column."""
    if isinstance(c, (PlainColumn, PlainIndexColumn)):
        dev = (c.values if isinstance(c, PlainColumn) else c.base.values).device
        return torch.ones((c.nrows,), dtype=torch.bool, device=dev)
    if isinstance(c, RLEColumn):
        return decode_rle_coverage(c.starts, c.ends, c.n, c.nrows)
    if isinstance(c, IndexColumn):
        return decode_index_coverage(c.positions, c.n, c.nrows)
    if isinstance(c, RLEIndexColumn):
        return coverage(c.rle) | coverage(c.idx)
    raise TypeError(f"not a data column: {type(c)}")
