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

With ``pack=True`` the integer buffers are bit-packed on the host at
ingest (``pack_array``, DESIGN.md §11); ``validate_encoded`` audits an
encoded column's invariants (``Table.validate``, DESIGN.md §15).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

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
    map_tensors,
)
from repro_torch.device import resolve_device, to_numpy


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
    # Sub-byte bit packing (DESIGN.md §11): pack integer buffers at the
    # exact bit width of their (lo, hi) domain into 32-bit lanes. Gated by
    # the dispatch policy (enable_pack / pack_max_bits / REPRO_PACK*).
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

    With ``cfg.pack`` the integer buffers are bit-packed on the host
    (DESIGN.md §11) before they move to ``device``. ``pack_domain`` is the
    column's ``(lo, size)`` value domain: partitioned ingest passes the
    GLOBAL domain so every partition packs at the same bit width.
    """
    if not cfg.pack:
        return _encode_unpacked(values, cfg, encoding, device)
    # pack on the host, then place the packed buffers on ``device``
    col = pack_encoded(_encode_unpacked(values, cfg, encoding, "cpu"),
                       pack_domain=pack_domain)
    dev = resolve_device(device)
    return col if dev.type == "cpu" else map_tensors(lambda t: t.to(dev), col)


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


# ---------------------------------------------------------------------------
# Sub-byte bit packing (DESIGN.md §11): host-side pack of integer buffers
# into 32-bit lanes at the exact bit width of their (lo, hi) domain. The
# device-side inverse is kernels/unpack.py (CUDA) / ref.ref_unpack (plain),
# routed lazily at the readers. Packed words are what a partition transfer
# moves, so H2D bytes shrink by ~bit_width/32 on dict-heavy columns.
# ---------------------------------------------------------------------------


def pack_bit_width(lo: int, hi: int) -> int:
    """Bits needed for values in [lo, hi] stored as unsigned ``v - lo``."""
    span = int(hi) - int(lo)
    if span < 0:
        return 33  # empty domain: never packs
    return max(1, span.bit_length())


def pack_array(values: np.ndarray, offset: int, bit_width: int) -> np.ndarray:
    """Pack ``values`` as unsigned ``(v - offset) mod 2**bit_width`` codes,
    densely concatenated into uint32 lanes (value i occupies bit range
    [i*b, i*b+b) of the stream). Width 32 is an exact modular passthrough.
    """
    v = np.asarray(values).astype(np.int64)
    n, b = v.size, int(bit_width)
    nwords = (n * b + 31) // 32
    if n == 0:
        return np.zeros(nwords, np.uint32)
    # 32 consecutive codes fill exactly b lanes, and code k of every group
    # sits at the same lane and shift: one vectorised OR per k over all
    # groups (zero codes pad the last group and leave its bits clear)
    groups = -(-n // 32)
    codes = np.zeros(groups * 32, np.uint32)
    codes[:n] = (v - int(offset)) & ((1 << b) - 1)
    codes = np.ascontiguousarray(codes.reshape(groups, 32).T)
    lanes = np.zeros((b, groups), np.uint32)
    for k in range(32):
        w, s = divmod(k * b, 32)
        lanes[w] |= codes[k] << np.uint32(s)
        if s + b > 32:  # straddles: its high bits open lane w + 1
            lanes[w + 1] |= codes[k] >> np.uint32(32 - s)
    return lanes.T.ravel()[:nwords]


def unpack_array(words: np.ndarray, offset: int, bit_width: int,
                 n: int) -> np.ndarray:
    """Host-side inverse of ``pack_array``: int64 logical values (int32
    wrap-add of ``offset``). ``words`` may be the uint32 lanes or their
    int32 view."""
    b = int(bit_width)
    out_words = np.asarray(words).view(np.uint32).astype(np.uint64)
    if n == 0:
        return np.zeros(0, np.int64)
    bitpos = np.arange(int(n), dtype=np.int64) * b
    w = bitpos >> 5
    sh = (bitpos & 31).astype(np.uint64)
    lo = out_words[w] >> sh
    # straddling values continue into lane w+1; a lane past the end is
    # never needed (the last value does not straddle) and reads as 0
    nxt_ix = np.minimum(w + 1, len(out_words) - 1)
    nxt = np.where(w + 1 < len(out_words), out_words[nxt_ix], np.uint64(0))
    code = (lo | (nxt << (np.uint64(32) - sh))) & np.uint64((1 << b) - 1)
    v = code.astype(np.int64) + int(offset)
    return (((v + (1 << 31)) % (1 << 32)) - (1 << 31)).astype(np.int64)


def _pack_buf(buf, lo: int, hi: int, max_bits: int,
              logical_offset: int = 0,
              vs_bits: Optional[int] = None) -> Optional[PackedColumn]:
    """PackedColumn for a host buffer whose LOGICAL values (buf +
    ``logical_offset``) lie in [lo, hi], or None when packing does not
    shrink it (non-integer dtype, empty, or bit width too wide).

    ``vs_bits`` is the width packing competes against: the buffer's
    stored dtype by default, the logical int32 width (32) when packing
    against a GLOBAL cross-partition domain, so every partition of a
    column packs alike (``repro.core.compress._pack_buf``).
    """
    if isinstance(buf, PackedColumn):
        return None  # already packed
    a = to_numpy(buf)
    if a.size == 0 or a.dtype.kind not in "iu":
        return None
    b = pack_bit_width(lo, hi)
    if b > max_bits or b >= (a.dtype.itemsize * 8 if vs_bits is None
                             else vs_bits):
        return None  # no byte saving over the reference width
    logical = a.astype(np.int64) + int(logical_offset)
    words = pack_array(logical, int(lo), b)
    return PackedColumn(words=torch.from_numpy(words.view(np.int32)),
                        nrows=int(a.size), bit_width=b, offset=int(lo))


def _host_offset(offset) -> int:
    return int(offset) if isinstance(offset, (int, np.integer)) else 0


def _value_domain(buf, offset, pack_domain) -> Optional[Tuple[int, int]]:
    """(lo, hi) of a value buffer's logical content: the ingest-recorded
    global domain when given, else derived from the buffer itself."""
    if pack_domain is not None:
        lo, size = int(pack_domain[0]), int(pack_domain[1])
        return (lo, lo + size - 1)
    a = to_numpy(buf)
    if a.size == 0 or a.dtype.kind not in "iu":
        return None
    off = _host_offset(offset)
    return (int(a.min()) + off, int(a.max()) + off)


def pack_encoded(col, pack_domain: Optional[Tuple[int, int]] = None,
                 max_bits: Optional[int] = None):
    """Bit-pack an encoded column's integer buffers (host-side, at ingest).

    * plain values / dictionary codes pack at the value domain's width
      with the centering offset folded in (``PlainColumn.offset`` -> 0),
    * RLE/Index VALUE buffers pack at the value domain widened to include
      0 (capacity padding holds literal zeros, which must round-trip),
    * RLE starts/ends and Index positions pack at ``bits(nrows)`` — the
      sentinel ``nrows`` itself stays representable,
    * float/bool buffers and widths past the policy's ``pack_max_bits``
      stay raw.
    """
    from repro_torch.kernels import dispatch
    pol = dispatch.policy()
    if not pol.enable_pack:
        return col
    max_bits = pol.pack_max_bits if max_bits is None else max_bits

    def vals_domain(buf, offset=0, pad_zero=False):
        dom = _value_domain(buf, offset, pack_domain)
        if dom is None:
            return None
        lo, hi = dom
        if pad_zero:  # capacity-padding slots hold 0
            lo, hi = min(lo, 0), max(hi, 0)
        return lo, hi

    # against a GLOBAL domain the pack decision must not see the local
    # buffer dtype (see _pack_buf): compete with the logical int32 width
    vvs = 32 if pack_domain is not None else None

    if isinstance(col, PlainColumn):
        dom = vals_domain(col.values, col.offset)
        if dom is None:
            return col
        p = _pack_buf(col.values, dom[0], dom[1], max_bits,
                      logical_offset=_host_offset(col.offset), vs_bits=vvs)
        if p is None:
            return col
        return PlainColumn(values=p, nrows=col.nrows, offset=0)

    if isinstance(col, RLEColumn):
        dom = vals_domain(col.values, pad_zero=True)
        pv = (_pack_buf(col.values, dom[0], dom[1], max_bits, vs_bits=vvs)
              if dom else None)
        ps = _pack_buf(col.starts, 0, col.nrows, max_bits)
        pe = _pack_buf(col.ends, 0, col.nrows, max_bits)
        return RLEColumn(values=pv if pv is not None else col.values,
                         starts=ps if ps is not None else col.starts,
                         ends=pe if pe is not None else col.ends,
                         n=col.n, nrows=col.nrows)

    if isinstance(col, IndexColumn):
        dom = vals_domain(col.values, pad_zero=True)
        pv = (_pack_buf(col.values, dom[0], dom[1], max_bits, vs_bits=vvs)
              if dom else None)
        pp = _pack_buf(col.positions, 0, col.nrows, max_bits)
        return IndexColumn(values=pv if pv is not None else col.values,
                           positions=pp if pp is not None else col.positions,
                           n=col.n, nrows=col.nrows)

    if isinstance(col, PlainIndexColumn):
        # the base's domain is the INLIER range (per-partition quantiles),
        # never the column domain: derive it from the buffers
        return PlainIndexColumn(base=pack_encoded(col.base, None, max_bits),
                                outliers=pack_encoded(col.outliers, None,
                                                      max_bits),
                                nrows=col.nrows)

    if isinstance(col, RLEIndexColumn):
        return RLEIndexColumn(rle=pack_encoded(col.rle, pack_domain, max_bits),
                              idx=pack_encoded(col.idx, pack_domain, max_bits),
                              nrows=col.nrows)

    return col


def _buf_nbytes(a, unpacked: bool = False) -> int:
    if isinstance(a, PackedColumn):
        if unpacked:
            # what whole-dtype narrowing of the SAME domain would occupy
            # (the honest unpacked reference, not a flat int32)
            b = a.bit_width
            return int(a.nrows) * (1 if b <= 8 else 2 if b <= 16 else 4)
        return int(a.words.numel()) * 4
    return int(a.numel() * a.element_size())


def encoded_nbytes(col, unpacked: bool = False) -> int:
    """In-memory footprint of an encoded column (device bytes).

    ``unpacked=True`` counts bit-packed buffers at the whole-dtype width
    the §9 narrowing would have used for the same domain."""
    if isinstance(col, PlainColumn):
        return _buf_nbytes(col.values, unpacked)
    if isinstance(col, RLEColumn):
        return sum(_buf_nbytes(a, unpacked)
                   for a in (col.values, col.starts, col.ends))
    if isinstance(col, IndexColumn):
        return sum(_buf_nbytes(a, unpacked)
                   for a in (col.values, col.positions))
    if isinstance(col, PlainIndexColumn):
        return (encoded_nbytes(col.base, unpacked)
                + encoded_nbytes(col.outliers, unpacked))
    if isinstance(col, RLEIndexColumn):
        return (encoded_nbytes(col.rle, unpacked)
                + encoded_nbytes(col.idx, unpacked))
    raise TypeError(type(col))


# ---------------------------------------------------------------------------
# Integrity validation (DESIGN.md §15, Table.validate)
# ---------------------------------------------------------------------------


def _host_buf(buf) -> np.ndarray:
    """Logical host copy of one encoded-column buffer slot: packed slots
    decode through ``unpack_array``, raw slots copy out as they are."""
    if isinstance(buf, PackedColumn):
        return unpack_array(to_numpy(buf.words), int(buf.offset),
                            buf.bit_width, int(buf.nrows))
    return to_numpy(buf)


def _vfail(name: str, msg: str):
    from repro_torch.core.faults import ValidationError

    raise ValidationError(f"column {name!r}: {msg}")


def _check_packed_width(buf, name: str, what: str, lo_req: int,
                        hi_req: int) -> None:
    """A packed buffer must be able to represent [lo_req, hi_req] exactly:
    a too-narrow width silently aliases values modulo 2**b."""
    if not isinstance(buf, PackedColumn) or buf.bit_width >= 32:
        return  # width 32 is an exact modular passthrough
    lo = int(buf.offset)
    hi = lo + (1 << buf.bit_width) - 1
    if int(lo_req) < lo or int(hi_req) > hi:
        _vfail(name, f"{what} packed at {buf.bit_width} bits from offset "
                     f"{lo} cannot represent required range "
                     f"[{int(lo_req)}, {int(hi_req)}]")


def _check_runs(name: str, starts, ends, n: int, nrows: int) -> None:
    """RLE structural invariants: ``n`` in capacity, valid runs sorted,
    disjoint and inside [0, nrows), sentinel tail == nrows."""
    s = _host_buf(starts).astype(np.int64)
    e = _host_buf(ends).astype(np.int64)
    cap = s.shape[0]
    if e.shape[0] != cap:
        _vfail(name, f"starts/ends capacity mismatch ({cap} vs {e.shape[0]})")
    if not (0 <= n <= cap):
        _vfail(name, f"run count n={n} outside capacity {cap}")
    vs, ve = s[:n], e[:n]
    if n:
        if vs[0] < 0 or int(ve.max()) >= nrows:
            _vfail(name, f"runs escape [0, {nrows})")
        if (ve < vs).any():
            _vfail(name, "run end precedes start")
        if n > 1 and (vs[1:] <= ve[:-1]).any():
            _vfail(name, "runs overlap or are not sorted")
    if (s[n:] != nrows).any() or (e[n:] != nrows).any():
        _vfail(name, f"run sentinel tail != nrows ({nrows})")


def _check_positions(name: str, positions, n: int, nrows: int) -> None:
    """Index structural invariants: strictly increasing valid positions
    inside [0, nrows), sentinel tail == nrows."""
    p = _host_buf(positions).astype(np.int64)
    cap = p.shape[0]
    if not (0 <= n <= cap):
        _vfail(name, f"position count n={n} outside capacity {cap}")
    vp = p[:n]
    if n:
        if vp[0] < 0 or int(vp.max()) >= nrows:
            _vfail(name, f"positions escape [0, {nrows})")
        if n > 1 and (np.diff(vp) <= 0).any():
            _vfail(name, "positions not strictly increasing")
    if (p[n:] != nrows).any():
        _vfail(name, f"position sentinel tail != nrows ({nrows})")


def _widened(domain: Optional[Tuple[int, int]]) -> Optional[Tuple[int, int]]:
    """RLE/Index value buffers hold literal zeros in capacity padding, so
    their packed range is the domain widened to include 0."""
    if domain is None:
        return None
    lo, size = int(domain[0]), int(domain[1])
    return min(lo, 0), max(lo + size - 1, 0)


def validate_encoded(col, name: str, nrows: int, dictionary=None,
                     domain: Optional[Tuple[int, int]] = None,
                     rows: Optional[int] = None) -> np.ndarray:
    """Integrity-check one encoded column; returns its decoded host copy.

    Structural: RLE run lists sorted/disjoint/in-bounds with the sentinel
    tail intact; Index position lists strictly increasing with sentinels;
    RLE+Index runs and outlier positions disjoint. Packed: every
    bit-packed buffer wide enough for its required range. Semantic:
    dictionary codes inside the dictionary, decoded values inside the
    recorded domain. ``rows`` restricts the semantic checks to the real
    (unpadded) prefix. Raises ``faults.ValidationError`` on the first
    violated invariant.
    """
    from repro_torch.core.encodings import decode_column

    def check(c, what: str, dom) -> None:
        if isinstance(c, PlainColumn):
            vals = _host_buf(c.values)
            if vals.shape[0] != nrows:
                _vfail(name, f"{what} length {vals.shape[0]} != nrows "
                             f"{nrows}")
            if dom is not None:
                lo, size = int(dom[0]), int(dom[1])
                _check_packed_width(c.values, name, what, lo, lo + size - 1)
        elif isinstance(c, RLEColumn):
            _check_runs(name, c.starts, c.ends, int(c.n), nrows)
            _check_packed_width(c.starts, name, f"{what} starts", 0, nrows)
            _check_packed_width(c.ends, name, f"{what} ends", 0, nrows)
            wd = _widened(dom)
            if wd is not None:
                _check_packed_width(c.values, name, f"{what} values",
                                    wd[0], wd[1])
        elif isinstance(c, IndexColumn):
            _check_positions(name, c.positions, int(c.n), nrows)
            _check_packed_width(c.positions, name, f"{what} positions",
                                0, nrows)
            wd = _widened(dom)
            if wd is not None:
                _check_packed_width(c.values, name, f"{what} values",
                                    wd[0], wd[1])
        elif isinstance(c, PlainIndexColumn):
            base = _host_buf(c.base.values)
            if base.shape[0] != nrows:
                _vfail(name, f"{what} base length {base.shape[0]} != "
                             f"nrows {nrows}")
            # base and outlier buffers pack at buffer-derived ranges: only
            # the outlier index structure is width-checkable
            check(c.outliers, f"{what} outliers", None)
        elif isinstance(c, RLEIndexColumn):
            check(c.rle, f"{what} rle", dom)
            check(c.idx, f"{what} idx", dom)
            # runs and outlier positions must partition the row space
            # disjointly: a row covered by both has two values
            nr, ni = int(c.rle.n), int(c.idx.n)
            if nr and ni:
                vs = _host_buf(c.rle.starts).astype(np.int64)[:nr]
                ve = _host_buf(c.rle.ends).astype(np.int64)[:nr]
                vp = _host_buf(c.idx.positions).astype(np.int64)[:ni]
                j = np.searchsorted(vs, vp, side="right") - 1
                inside = (j >= 0) & (vp <= ve[np.maximum(j, 0)])
                if inside.any():
                    p = int(vp[inside][0])
                    _vfail(name, f"{what}: position {p} falls inside an "
                                 "RLE run (runs and outliers overlap)")
        else:
            _vfail(name, f"unknown column type {type(c).__name__}")

    check(col, "values", domain)
    decoded = to_numpy(decode_column(col))
    k = nrows if rows is None else min(int(rows), nrows)
    body = decoded[:k]
    if k and dictionary is not None:
        lo, hi = int(body.min()), int(body.max())
        if lo < 0 or hi >= len(dictionary):
            _vfail(name, f"dictionary codes [{lo}, {hi}] escape the "
                         f"{len(dictionary)}-entry dictionary")
    if k and domain is not None and decoded.dtype.kind in "iu":
        lo, size = int(domain[0]), int(domain[1])
        blo, bhi = int(body.min()), int(body.max())
        if blo < lo or bhi >= lo + size:
            _vfail(name, f"decoded values [{blo}, {bhi}] escape the "
                         f"recorded domain [{lo}, {lo + size})")
    return decoded
