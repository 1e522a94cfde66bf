"""Encoding selection & ingest-time compression (paper §9 heuristics + §3.2).

PyTorch port of ``repro.core.compress``. Conversion runs offline/at ingest
on the host (numpy), exactly as TQP does (§2.1); the encoded buffers are
then placed on the target device. The heuristics, capacities and buffer
contents are the reference's, bit for bit:

  * columns under ``plain_threshold`` rows  -> Plain
  * RLE compression ratio > ``rle_ratio``   -> RLE
  * many unit runs but long runs still give ratio > threshold -> RLE+Index
  * trimming top/bottom 5% permits a narrower dtype -> Plain+Index
  * else Plain (possibly centered for bit-width reduction)

Left for later port slices: bit packing (``pack=True`` raises
``NotImplementedError``) and ``validate_encoded`` (it waits for the
``faults`` port).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.encodings import (
    IndexColumn,
    PackedColumn,
    PlainColumn,
    PlainIndexColumn,
    RLEColumn,
    RLEIndexColumn,
    make_index,
    make_plain,
    make_rle,
)


@dataclasses.dataclass
class CompressionConfig:
    plain_threshold: int = 1_000_000  # paper: columns under 1M rows use Plain
    rle_ratio: float = 20.0  # paper: RLE if compression ratio > 20
    min_run: int = 4  # RLE+Index: runs >= min_run stay RLE
    outlier_frac: float = 0.05  # Plain+Index: trim top/bottom 5%
    capacity_slack: float = 1.0  # headroom multiplier on encoded capacities
    force: Optional[str] = None  # force an encoding (tests/benchmarks)
    # Round run/index capacities up to the next power of two (DESIGN.md §4).
    capacity_bucket: Optional[str] = None  # None | "pow2"
    min_bucket: int = 8  # floor for bucketed capacities
    # Sub-byte bit packing (DESIGN.md §11): not ported yet.
    pack: bool = False


def next_pow2(k: int, minimum: int = 1) -> int:
    """Smallest power of two >= max(k, minimum)."""
    return 1 << (max(int(k), minimum, 1) - 1).bit_length()


def _capacity(k: int, cfg: CompressionConfig) -> int:
    """Buffer capacity for k valid run/index entries under ``cfg``."""
    cap = max(int(k * cfg.capacity_slack), k, 1)
    if cfg.capacity_bucket == "pow2":
        cap = next_pow2(cap, cfg.min_bucket)
    return cap


def column_domain(values: np.ndarray,
                  dictionary: Optional[np.ndarray] = None
                  ) -> Optional[Tuple[int, int]]:
    """Dense bounded value domain ``(lo, size)`` of a column, or None.

      * dictionary-encoded columns: the code space [0, len(dict)),
      * integer/bool columns: [vmin, vmax] over the ingested values,
      * float / empty columns: None (unbounded — argsort path).
    """
    if dictionary is not None:
        return (0, int(len(dictionary)))
    values = np.asarray(values)
    if values.size == 0 or values.dtype.kind not in "iub":
        return None
    lo, hi = int(values.min()), int(values.max())
    return (lo, hi - lo + 1)


def column_is_sorted(values: np.ndarray) -> bool:
    """Host-side check: is the column non-decreasing?"""
    values = np.asarray(values)
    if values.size <= 1:
        return True
    return bool(np.all(values[1:] >= values[:-1]))


def column_minmax(values: np.ndarray) -> Tuple[float, float]:
    """Host-side zone-map entry (min, max) for a column slice (empty slices
    get an empty interval; NaN slices the unbounded one)."""
    values = np.asarray(values)
    if values.size == 0:
        return (1.0, 0.0)
    if values.dtype.kind == "f" and np.isnan(values).any():
        return (-np.inf, np.inf)
    return (float(values.min()), float(values.max()))


@dataclasses.dataclass
class ColumnStats:
    nrows: int
    n_runs: int
    rle_ratio: float
    n_long_runs: int
    long_run_rows: int
    dtype: np.dtype
    # EXACT Python ints for integer/bool columns, floats otherwise (a
    # float64 vmin/vmax rounds integers past 2**53).
    vmin: object
    vmax: object


def _run_bounds(values: np.ndarray):
    """Starts and inclusive ends of the runs of equal consecutive values."""
    n = len(values)
    change = np.empty(n, dtype=bool)
    change[0] = True
    np.not_equal(values[1:], values[:-1], out=change[1:])
    starts = np.flatnonzero(change)
    ends = np.concatenate([starts[1:] - 1, [n - 1]])
    return starts, ends


def analyze(values: np.ndarray, min_run: int = 4) -> ColumnStats:
    values = np.asarray(values)
    n = len(values)
    if n == 0:
        return ColumnStats(0, 0, 0.0, 0, 0, values.dtype, 0, 0)
    starts, ends = _run_bounds(values)
    lengths = ends - starts + 1
    long_mask = lengths >= min_run
    exact = values.dtype.kind in "iub"
    cast = int if exact else float
    return ColumnStats(
        nrows=n, n_runs=len(starts), rle_ratio=n / max(len(starts), 1),
        n_long_runs=int(long_mask.sum()), long_run_rows=int(lengths[long_mask].sum()),
        dtype=values.dtype, vmin=cast(values.min()), vmax=cast(values.max()),
    )


def _center_span(lo, hi):
    """Mid-range center + worst-case deviation, EXACT for integer bounds."""
    if isinstance(lo, (int, np.integer)) and isinstance(hi, (int, np.integer)):
        lo, hi = int(lo), int(hi)
        center = (lo + hi) // 2
        return center, max(abs(lo - center), abs(hi - center))
    center = (lo + hi) / 2
    return center, max(abs(lo - center), abs(hi - center))


def _narrow_int_dtype(lo, hi):
    """Smallest signed int dtype covering [lo, hi] after mid-range centering."""
    _, span = _center_span(lo, hi)
    for dt in (np.int8, np.int16, np.int32):
        if span <= np.iinfo(dt).max:
            return np.dtype(dt)
    return np.dtype(np.int64)


def choose_encoding(stats: ColumnStats, cfg: CompressionConfig) -> str:
    """Returns one of plain|rle|rle_index|plain_index (paper §9)."""
    if cfg.force:
        return cfg.force
    if stats.nrows < cfg.plain_threshold:
        return "plain"
    if stats.rle_ratio > cfg.rle_ratio:
        return "rle"
    if stats.n_long_runs > 0:
        impure_rows = stats.nrows - stats.long_run_rows
        approx_entries = stats.n_long_runs + impure_rows
        if approx_entries > 0 and stats.nrows / approx_entries > cfg.rle_ratio:
            return "rle_index"
    if np.issubdtype(stats.dtype, np.integer):
        wide = np.dtype(stats.dtype).itemsize
        narrow = _narrow_int_dtype(stats.vmin, stats.vmax).itemsize
        if narrow < wide:
            return "plain"  # centered plain (bit-width reduction, no outliers)
        return "plain_index_check"
    return "plain"


def _host_scalar(x):
    """Offsets stay host Python scalars (``PlainColumn.offset``)."""
    return x.item() if isinstance(x, np.generic) else x


def encode(values: np.ndarray, cfg: CompressionConfig = CompressionConfig(),
           encoding: Optional[str] = None,
           pack_domain: Optional[Tuple[int, int]] = None, device=None):
    """Encode a host array into an encoded column on ``device``.

    The device value domain is int32 / float32: integers outside int32 must
    be dictionary-encoded first (``Table.from_arrays`` does this); float64
    narrows to float32 as TQP narrows decimals (paper §2.1). ``device``
    None means the CUDA device.
    """
    if cfg.pack:
        raise NotImplementedError(
            "bit packing (pack=True) is not ported yet: it arrives with the "
            "out-of-core slice and the unpack kernels (ROADMAP queue B5-B7)")
    return _encode_unpacked(values, cfg, encoding, device)


def _long_short_split(values, cfg: CompressionConfig):
    starts, ends = _run_bounds(values)
    lengths = ends - starts + 1
    long = lengths >= cfg.min_run
    short_starts, short_lens = starts[~long], lengths[~long]
    # every row of the short runs, in order (the reference concatenates one
    # np.arange per run; this is the same int64 array without the loop)
    total = int(short_lens.sum())
    run_first = np.cumsum(short_lens) - short_lens
    pos = (np.repeat(short_starts - run_first, short_lens)
           + np.arange(total, dtype=np.int64))
    return starts, ends, long, pos


def _encode_unpacked(values: np.ndarray, cfg: CompressionConfig,
                     encoding: Optional[str] = None, device=None):
    values = np.asarray(values)
    if values.dtype.kind == "i" and (
            values.size and (values.min() < np.iinfo(np.int32).min
                             or values.max() > np.iinfo(np.int32).max)):
        raise ValueError(
            "integer column exceeds the int32 device value domain; "
            "dictionary-encode first (Table.from_arrays does this)")
    if values.dtype == np.float64:
        values = values.astype(np.float32)
    n = len(values)
    stats = analyze(values, cfg.min_run)
    enc = encoding or choose_encoding(stats, cfg)

    if enc == "plain_index_check":
        enc = _try_plain_index(values, stats, cfg)

    if enc == "plain":
        if np.issubdtype(values.dtype, np.integer):
            ndt = _narrow_int_dtype(stats.vmin, stats.vmax)
            if ndt.itemsize < values.dtype.itemsize:
                center = int(_center_span(stats.vmin, stats.vmax)[0])
                return make_plain((values.astype(np.int64) - center).astype(ndt),
                                  nrows=n, offset=center, device=device)
        return make_plain(values, nrows=n, device=device)

    if enc == "rle":
        starts, ends = _run_bounds(values)
        return make_rle(values[starts], starts, ends, nrows=n,
                        capacity=_capacity(len(starts), cfg), device=device)

    if enc == "index":
        return make_index(values, np.arange(n), nrows=n,
                          capacity=_capacity(n, cfg), device=device)

    if enc == "rle_index":
        starts, ends, long, pos = _long_short_split(values, cfg)
        rle = make_rle(values[starts[long]], starts[long], ends[long], nrows=n,
                       capacity=_capacity(int(long.sum()), cfg), device=device)
        idx = make_index(values[pos] if len(pos) else np.zeros((0,), values.dtype),
                         pos, nrows=n, capacity=_capacity(len(pos), cfg),
                         device=device)
        return RLEIndexColumn(rle=rle, idx=idx, nrows=n)

    if enc == "plain_index":
        lo = np.quantile(values, cfg.outlier_frac)
        hi = np.quantile(values, 1 - cfg.outlier_frac)
        if np.issubdtype(values.dtype, np.integer):
            lo, hi = int(np.floor(lo)), int(np.ceil(hi))
        inlier = (values >= lo) & (values <= hi)
        center = int((lo + hi) // 2) if np.issubdtype(values.dtype, np.integer) else (lo + hi) / 2
        ndt = _narrow_int_dtype(lo, hi) if np.issubdtype(values.dtype, np.integer) else values.dtype
        base = np.where(inlier, values - center, 0).astype(ndt)
        out_pos = np.flatnonzero(~inlier)
        outliers = make_index(values[out_pos], out_pos, nrows=n,
                              capacity=_capacity(len(out_pos), cfg),
                              device=device)
        return PlainIndexColumn(
            base=make_plain(base, nrows=n, offset=_host_scalar(center),
                            device=device),
            outliers=outliers, nrows=n)

    raise ValueError(f"unknown encoding {enc}")


def _try_plain_index(values, stats, cfg) -> str:
    lo = np.quantile(values, cfg.outlier_frac)
    hi = np.quantile(values, 1 - cfg.outlier_frac)
    narrow = _narrow_int_dtype(lo, hi)
    if narrow.itemsize < np.dtype(values.dtype).itemsize:
        return "plain_index"
    return "plain"


def dictionary_encode(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Value+dictionary encoding for strings/categoricals (paper §2.1)."""
    dictionary, codes = np.unique(values, return_inverse=True)
    return codes.astype(np.int32), dictionary


def _buf_nbytes(a) -> int:
    if isinstance(a, PackedColumn):
        return int(a.words.numel()) * 4
    return int(a.numel() * a.element_size())


def encoded_nbytes(col) -> int:
    """In-memory footprint of an encoded column (device bytes)."""
    if isinstance(col, PlainColumn):
        return _buf_nbytes(col.values)
    if isinstance(col, RLEColumn):
        return sum(_buf_nbytes(a) for a in (col.values, col.starts, col.ends))
    if isinstance(col, IndexColumn):
        return sum(_buf_nbytes(a) for a in (col.values, col.positions))
    if isinstance(col, PlainIndexColumn):
        return encoded_nbytes(col.base) + encoded_nbytes(col.outliers)
    if isinstance(col, RLEIndexColumn):
        return encoded_nbytes(col.rle) + encoded_nbytes(col.idx)
    raise TypeError(type(col))
