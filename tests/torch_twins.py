"""Shared helpers of the PyTorch-port tests (tests/test_torch_*.py).

The port's tests hold ``repro_torch`` against ``repro`` on the CPU: the
same numpy inputs go through both packages, and outputs are compared as
host arrays — dtypes included, since the port keeps the reference's
int32 / float32 layout. The JAX side runs its Pallas kernels in interpret
mode where a test asks for the kernel route.
"""
import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import (PACKED_PATTERNS, RLE_DRAWS,  # noqa: F401
                        packed_queries, packed_values, rle_draw)

# JAX dtype names -> torch dtypes, for the dtype half of every comparison
_NP_OF_TORCH = {
    torch.bool: np.dtype(np.bool_), torch.int8: np.dtype(np.int8),
    torch.int16: np.dtype(np.int16), torch.int32: np.dtype(np.int32),
    torch.int64: np.dtype(np.int64), torch.uint8: np.dtype(np.uint8),
    torch.float32: np.dtype(np.float32), torch.float64: np.dtype(np.float64),
}

CPU = torch.device("cpu")

# Torch's CPU ops run on one intra-op thread in every test process that
# imports this module (pytest-xdist workers import every test module).
# With a thread a core in each of several worker processes the threads
# oversubscribe the cores, and on the twins' small tensors they spin: six
# concurrent copies of a slice of tests/test_torch_train.py took 250 s
# each, and 10 s on one thread each. Results compare within tolerances
# that do not depend on the reduction order a thread count picks.
torch.set_num_threads(1)
I32MAX = np.iinfo(np.int32).max
I32MIN = np.iinfo(np.int32).min


def bucketize_cases(rng):
    """name -> (sorted boundaries, queries): the edge cases of
    tests/test_pallas_kernels.py (cast to int32 / float32 by the caller)."""
    return {
        "empty_queries": (np.arange(10), np.zeros(0)),
        "empty_boundaries": (np.zeros(0), np.arange(5)),
        "one_boundary": (np.array([7]), rng.integers(0, 15, 9)),
        "dups_ragged": (np.sort(rng.integers(0, 10, 37)),
                        rng.integers(-2, 12, 1025)),
        "sentinel_padded": (np.concatenate([np.sort(rng.integers(0, 100, 20)),
                                            np.full(12, I32MAX)]),
                            rng.integers(-5, 200, 333)),
        "sweep_1023x512": (np.sort(rng.integers(0, 10230, 1023)),
                           rng.integers(-5, 10235, 512)),
        "sweep_5000x2048": (np.sort(rng.integers(0, 50000, 5000)),
                            rng.integers(-5, 50005, 2048)),
    }


BUCKETIZE_CASES = list(bucketize_cases(np.random.default_rng(0)))
RLE_CASES = ["zero_runs_full_capacity", "gaps_nonzero_fill",
             "capacity_padding_sentinels", "sweep_1x16", "sweep_300x5000",
             "ragged_2049"]


def rle_case(name):
    """(values, starts, ends, n, nrows, fill) of an RLE edge case."""
    if name == "zero_runs_full_capacity":
        nrows, cap = 500, 8
        return (np.zeros(cap, np.int32), np.full(cap, nrows, np.int32),
                np.full(cap, nrows, np.int32), 0, nrows, 7)
    if name == "gaps_nonzero_fill":
        return (np.array([1.5, -2.0, 3.25], np.float32),
                np.array([5, 2047, 2900], np.int32),
                np.array([90, 2500, 2999], np.int32), 3, 3000, -1)
    if name == "capacity_padding_sentinels":
        nrows, pad = 3000, 13
        return (np.concatenate([[3, 5, 7], np.zeros(pad)]).astype(np.int32),
                np.concatenate([[0, 500, 2900], np.full(pad, nrows)]).astype(np.int32),
                np.concatenate([[99, 999, 2999], np.full(pad, nrows)]).astype(np.int32),
                3, nrows, 0)
    rng = np.random.default_rng(len(name))
    n_runs, nrows = {"sweep_1x16": (1, 16), "sweep_300x5000": (300, 5000),
                     "ragged_2049": (64, 2049)}[name]
    starts = np.sort(rng.choice(nrows, n_runs, replace=False)).astype(np.int32)
    starts[0] = 0
    ends = np.concatenate([starts[1:] - 1, [nrows - 1]]).astype(np.int32)
    vals = rng.integers(1, 100, n_runs).astype(np.int32)
    return vals, starts, ends, n_runs, nrows, 0


def topk_case(name):
    """(values, ks) of a top-k edge case of ``chip_smoke.py``'s list."""
    rng = np.random.default_rng(len(name))
    ints = lambda n: rng.integers(-50, 50, n).astype(np.int32)  # noqa: E731
    floats = lambda n: rng.standard_normal(n).astype(np.float32)  # noqa: E731
    if name == "n0_int32":
        return ints(0), (8,)
    if name == "n1_float32":
        return floats(1), (1,)
    if name == "n7_below_k_int32":
        return ints(7), (8,)
    if name == "n2047_float32":
        return floats(2047), (128,)
    if name == "n2048_int32":
        return ints(2048), (1,)
    if name == "n2049_float32":
        return floats(2049), (37,)
    if name == "n20000_multi_tile_int32":
        return ints(20_000), (256,)
    if name == "all_equal_int32":
        return np.full(5000, 7, np.int32), (128,)
    if name == "int32_min_rows":
        x = ints(3000)
        x[rng.random(3000) < 0.9] = I32MIN  # fewer real rows than k
        return x, (256,)
    if name == "int32_min_below_k":
        return np.full(5, I32MIN, np.int32), (8,)  # real rows beat pads
    if name == "inf_float32":
        x = floats(4100)
        x[rng.choice(4100, 40, replace=False)] = np.inf
        x[rng.choice(4100, 40, replace=False)] = -np.inf
        return x, (64,)
    if name == "signed_zeros_float32":
        return rng.choice([0.0, -0.0, 1.0, -1.0], 300).astype(np.float32), (16,)
    raise ValueError(name)


TOPK_CASES = ["n0_int32", "n1_float32", "n7_below_k_int32", "n2047_float32",
              "n2048_int32", "n2049_float32", "n20000_multi_tile_int32",
              "all_equal_int32", "int32_min_rows", "int32_min_below_k",
              "inf_float32", "signed_zeros_float32"]


@pytest.fixture
def cuda_device():
    """The CUDA device; skips the test (at run time, never at collection)
    where there is none. Card-only tests also carry ``@pytest.mark.gpu``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with -m gpu")
    return torch.device("cuda")


def host(x):
    """numpy copy of a torch tensor, a JAX array or host data."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def dtype_of(x) -> np.dtype:
    if isinstance(x, torch.Tensor):
        return _NP_OF_TORCH[x.dtype]
    return np.asarray(x).dtype


def assert_same(want, got, what=""):
    """Equal dtype, shape and values (NaN == NaN)."""
    assert dtype_of(got) == dtype_of(want), \
        f"{what}: dtype {dtype_of(got)} != {dtype_of(want)}"
    np.testing.assert_array_equal(host(got), host(want), err_msg=what)


def assert_close(want, got, what="", rtol=1e-4, atol=1e-4):
    """Equal dtype and shape; values within the reference tests' tolerance."""
    assert dtype_of(got) == dtype_of(want), \
        f"{what}: dtype {dtype_of(got)} != {dtype_of(want)}"
    np.testing.assert_allclose(host(got), host(want), rtol=rtol, atol=atol,
                               err_msg=what)


def describe(col) -> dict:
    """Framework-free description of an encoded column or mask of either
    package (the ``repro_torch.core.convert`` format)."""
    fields = {}
    for f in dataclasses.fields(col):
        value = getattr(col, f.name)
        if dataclasses.is_dataclass(value):
            fields[f.name] = describe(value)
        elif f.name in ("nrows", "bit_width"):
            fields[f.name] = int(value)
        elif f.name == "words":  # packed lanes: the port holds int32 views
            fields[f.name] = host(value).view(np.uint32)
        else:
            fields[f.name] = host(value)
    return {"type": type(col).__name__, "fields": fields}


def describe_table(t) -> dict:
    """Description of a ``repro`` or ``repro_torch`` Table."""
    return {"nrows": t.nrows, "dictionaries": dict(t.dictionaries),
            "domains": dict(t.domains),
            "columns": {k: describe(c) for k, c in t.columns.items()}}


def assert_same_encoded(want, got, what="column"):
    """Two encoded columns/masks (either package) have the same encoding,
    static fields and buffers, dtypes included."""
    a = want if isinstance(want, dict) and "type" in want else describe(want)
    b = got if isinstance(got, dict) and "type" in got else describe(got)
    assert a["type"] == b["type"], f"{what}: {b['type']} != {a['type']}"
    assert a["fields"].keys() == b["fields"].keys(), what
    for name, va in a["fields"].items():
        vb = b["fields"][name]
        if isinstance(va, dict):
            assert_same_encoded(va, vb, f"{what}.{name}")
        elif isinstance(va, int):
            assert vb == va, f"{what}.{name}: {vb} != {va}"
        elif name == "offset":
            assert np.asarray(vb).item() == np.asarray(va).item(), \
                f"{what}.offset"
        else:
            assert_same(va, vb, f"{what}.{name}")


def encode_twins(values, cfg_kwargs=None, encoding=None):
    """(repro column, repro_torch column) of the same host array."""
    from repro.core import compress as jc
    from repro_torch.core import compress as tc
    kw = cfg_kwargs or {}
    j = jc.encode(np.asarray(values), jc.CompressionConfig(**kw), encoding=encoding)
    t = tc.encode(np.asarray(values), tc.CompressionConfig(**kw),
                  encoding=encoding, device=CPU)
    return j, t


def dense_to_rle_mask(d):
    """Dense bool -> (starts, ends) int32 run lists."""
    d = np.asarray(d, bool)
    if not d.any():
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    padded = np.concatenate([[False], d, [False]])
    edges = np.flatnonzero(padded[1:] != padded[:-1])
    return edges[0::2].astype(np.int32), (edges[1::2] - 1).astype(np.int32)


def mask_twins(kind, d, slack=4, cap=None):
    """(repro mask, repro_torch mask) of a dense bool array; ``cap`` fixes
    the capacity (fixed shapes keep the JAX side's compile cache warm)."""
    from repro.core import encodings as JE
    from repro_torch.core import encodings as TE
    d = np.asarray(d, bool)
    n = len(d)
    if kind == "plain":
        return JE.make_plain_mask(d), TE.make_plain_mask(d, device=CPU)
    if kind == "rle":
        s, e = dense_to_rle_mask(d)
        cap = cap or max(len(s), 1) + slack
        return (JE.make_rle_mask(s, e, n, capacity=cap),
                TE.make_rle_mask(s, e, n, capacity=cap, device=CPU))
    if kind == "index":
        pos = np.flatnonzero(d).astype(np.int32)
        cap = cap or max(len(pos), 1) + slack
        return (JE.make_index_mask(pos, n, capacity=cap),
                TE.make_index_mask(pos, n, capacity=cap, device=CPU))
    raise ValueError(kind)


def rle_col_twins(vals, slack=4, cap=None):
    """(repro RLEColumn, repro_torch RLEColumn) of full-coverage runs."""
    from repro.core import encodings as JE
    from repro_torch.core import encodings as TE
    vals = np.asarray(vals)
    n = len(vals)
    change = np.ones(n, bool)
    change[1:] = vals[1:] != vals[:-1]
    s = np.flatnonzero(change).astype(np.int32)
    e = np.concatenate([s[1:] - 1, [n - 1]]).astype(np.int32)
    cap = cap or len(s) + slack
    return (JE.make_rle(vals[s], s, e, n, capacity=cap),
            TE.make_rle(vals[s], s, e, n, capacity=cap, device=CPU))


def index_col_twins(vals, present, slack=4, cap=None):
    """(repro IndexColumn, repro_torch IndexColumn) of the rows in
    ``present`` (gapped column)."""
    from repro.core import encodings as JE
    from repro_torch.core import encodings as TE
    vals = np.asarray(vals)
    pos = np.flatnonzero(present).astype(np.int32)
    cap = cap or max(len(pos), 1) + slack
    n = len(vals)
    return (JE.make_index(vals[pos], pos, n, capacity=cap),
            TE.make_index(vals[pos], pos, n, capacity=cap, device=CPU))


SIX_ENCODINGS = ["plain", "plain_dict", "rle", "index", "rle_index",
                 "plain_index"]


def six_encoding_data(rng, enc, n=12_000):
    """(data, encodings) whose key ``k`` and value ``v`` columns take one
    of the six ingest encodings (``plain_dict``: a string key), plus a
    float measure ``f`` (the reference's partition/stream/fault tests)."""
    k = np.sort(rng.integers(0, 40, n)).astype(np.int32)
    v = rng.integers(0, 2000, n).astype(np.int32)
    f = rng.random(n).astype(np.float32)
    if enc == "plain_index":
        v = np.where(rng.random(n) < 0.002, 1_500_000_000, v).astype(np.int32)
    if enc == "plain_dict":
        vocab = np.array([f"key_{i:03d}" for i in range(40)])
        return {"k": vocab[k], "v": v, "f": f}, None
    return {"k": k, "v": v, "f": f}, {"k": enc, "v": enc}


def result_payload(r):
    """Comparable host payload of a query result of either package: a
    merged group-by, a scalar-aggregate dict, or a resident GroupByResult
    (trimmed to its live groups)."""
    if hasattr(r, "num_groups"):
        ng = int(host(r.num_groups)) if not isinstance(r.num_groups, int) \
            else r.num_groups
        return {**{f"k:{g}": host(r.keys[g])[:ng] for g in r.keys},
                **{f"a:{o}": host(r.aggs[o])[:ng] for o in r.aggs}}
    return {o: host(r[o]) for o in r}


def assert_payload_same(want, got, what=""):
    """Bit-identical payloads (same keys, dtypes and bytes)."""
    assert set(want) == set(got), what
    for k in want:
        assert_same(want[k], got[k], f"{what} {k}")


def assert_payload_close(want, got, what="", rtol=1e-4):
    """Payloads equal in dtype; integers exactly, floats within rtol."""
    assert set(want) == set(got), what
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        if w.dtype.kind == "f" or g.dtype.kind == "f":
            assert_close(w, g, f"{what} {k}", rtol=rtol, atol=1e-6)
        else:
            assert_same(w, g, f"{what} {k}")


# ---------------------------------------------------------------------------
# Numpy repeats of the redesigned kernels' plans (csrc/segment_reduce.cu,
# csrc/bucketize.cu's tiled route): the CPU tests check the plans, the
# card's tests hold the kernels to them.
# ---------------------------------------------------------------------------


def _butterfly_lane0(a):
    """Lane 0 of an xor-shuffle sum over the last axis (32 lanes)."""
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        a = a + a[..., lanes ^ off]
    return a[..., 0]


def _sum_in_order(parts, zero):
    s = zero
    for p in parts:
        s = s + p
    return s


def segment_sum_emulated(values, ids, g, grid=None):
    """``segment_sum_kernel``'s sums with its order of adds, in numpy:
    float32 values in float32, int32 values as uint32 (returned as int32).
    Chunks of ``segment_reduce.plan(g)``; a block of 256 threads takes a
    chunk in 1024-row steps, thread t rows 4t .. 4t + 3 of a step; the
    one, small and match routes' partials; the final pass per group
    (threads over chunks t, t + 256, ..., a butterfly, the 8 warps in
    order). ``grid`` blocks take the chunks grid-stride (default: one a
    chunk): the chunk -> block map changes no add."""
    from repro_torch.kernels import segment_reduce as ks
    route, chunk = ks.plan(g)
    is_float = values.dtype == np.float32
    acc_t = np.float32 if is_float else np.uint32
    v_all = (values.astype(np.float32) if is_float
             else values.astype(np.int64).astype(np.uint32))
    zero = acc_t(0)
    n = len(values)
    nchunks = -(-n // chunk)
    partial = np.zeros((g, nchunks), acc_t)
    grid = nchunks if grid is None else grid
    order = [c for b in range(grid) for c in range(b, nchunks, grid)]
    with np.errstate(over="ignore"):  # int32 sums wrap, as uint32
        return _segment_sum_chunks(v_all, ids, g, route, chunk, order,
                                   partial, zero, acc_t, is_float)


def _segment_sum_chunks(v_all, ids, g, route, chunk, order, partial, zero,
                        acc_t, is_float):
    from repro_torch.kernels import segment_reduce as ks
    n, nchunks = len(v_all), partial.shape[1]
    for c in order:
        lo, hi = c * chunk, min((c + 1) * chunk, n)
        steps = -(-(hi - lo) // ks.STEP)
        vv = np.zeros(steps * ks.STEP, acc_t)
        ii = np.full(steps * ks.STEP, -1, np.int64)
        vv[:hi - lo], ii[:hi - lo] = v_all[lo:hi], ids[lo:hi]
        vv = vv.reshape(steps, ks.THREADS, ks.PER_THREAD)
        ii = ii.reshape(steps, ks.THREADS, ks.PER_THREAD)
        if route == ks.ONE:
            acc = np.zeros(ks.THREADS, acc_t)
            for s in range(steps):
                for j in range(ks.PER_THREAD):
                    acc = np.where(ii[s, :, j] == 0, acc + vv[s, :, j], acc)
            warps = _butterfly_lane0(acc.reshape(8, 32))
            partial[0, c] = _sum_in_order(warps, zero)
        elif route == ks.SMALL:
            col = np.zeros((g, ks.THREADS), acc_t)
            t = np.arange(ks.THREADS)
            for s in range(steps):
                for j in range(ks.PER_THREAD):
                    live = (ii[s, :, j] >= 0) & (ii[s, :, j] < g)
                    k, tt = ii[s, live, j], t[live]
                    col[k, tt] = col[k, tt] + vv[s, live, j]
            lanes = _sum_in_order(col.reshape(g, 8, 32).transpose(1, 0, 2),
                                  np.zeros((g, 32), acc_t))
            partial[:, c] = _butterfly_lane0(lanes)
        else:
            wacc = np.zeros((8, g), acc_t)
            for s in range(steps):
                for j in range(ks.PER_THREAD):
                    for w in range(8):
                        wid = ii[s, 32 * w:32 * w + 32, j]
                        wv = vv[s, 32 * w:32 * w + 32, j]
                        for k in np.unique(wid[(wid >= 0) & (wid < g)]):
                            wacc[w, k] = wacc[w, k] + _sum_in_order(
                                wv[wid == k], zero)
            partial[:, c] = _sum_in_order(wacc, np.zeros(g, acc_t))
    tsum = np.zeros((g, ks.THREADS), acc_t)
    for i in range(-(-nchunks // ks.THREADS)):
        b = i * ks.THREADS + np.arange(ks.THREADS)
        inside = b < nchunks
        tsum = np.where(inside, tsum + partial[:, np.minimum(b, nchunks - 1)],
                        tsum)
    warps = _butterfly_lane0(tsum.reshape(g, 8, 32))
    out = _sum_in_order(warps.T, np.zeros(g, acc_t))
    return out if is_float else out.view(np.int32)


def bucketize_tiles_emulated(b, q, right=True, max_splitters=4096,
                             window=2048, tile=2048, bounds=None):
    """``bucketize_count_kernel``'s tiled route in numpy: counts and the
    route each tile took ("window" or "splitter"). Splitter s of the
    staged ones is b[s << shift]; a tile's min and max (NaN above every
    number) are counted by the splitters and rounds of 64 probes; the
    window route searches b[lo, hi), the splitter route finishes each
    query's last ``shift`` levels. A list ``bounds`` gets each tile's
    (lo, hi)."""
    b, q = np.asarray(b), np.asarray(q)
    nb = len(b)

    def counted(bv, qv):
        with np.errstate(invalid="ignore"):
            return ~(bv > qv) if right else ~(bv >= qv)

    shift = 0
    while ((nb - 1) >> shift) + 1 > max_splitters:
        shift += 1
    nsplit = ((nb - 1) >> shift) + 1
    split = b[np.arange(nsplit, dtype=np.int64) << shift]

    def block_of(qv):
        k = int(counted(split, qv).sum())
        if k == 0:
            return None
        base = ((k - 1) << shift) + 1
        return base, min(k << shift, nb) - base

    def count_warp(qv):
        found = block_of(qv)
        if found is None:
            return 0
        base, ln = found
        probes = np.arange(64, dtype=np.int64)
        while ln > 64:
            step = -(-ln // 64)
            p = base + (probes + 1) * step - 1
            ok = (p < base + ln) & counted(b[np.minimum(p, nb - 1)], qv)
            m = int(ok.sum())
            base, ln = base + m * step, min(ln - m * step, step)
        p = base + probes
        ok = (p < base + ln) & counted(b[np.minimum(p, nb - 1)], qv)
        return base + int(ok.sum())

    def splitter_count(qv):
        found = block_of(qv)
        if found is None:
            return 0
        base, ln = found
        rel = 0
        for lev in range(shift - 1, -1, -1):
            cand = rel + (1 << lev)
            if cand <= ln and counted(b[base + cand - 1], qv):
                rel = cand
        return base + rel

    out = np.zeros(len(q), np.int32)
    routes = []
    for t0 in range(0, len(q), tile):
        qt = q[t0:t0 + tile]
        nan = np.isnan(qt) if qt.dtype.kind == "f" else np.zeros(len(qt), bool)
        qmin = qt[~nan].min() if (~nan).any() else qt[0]
        qmax = qt[nan][0] if nan.any() else qt.max()
        lo, hi = count_warp(qmin), count_warp(qmax)
        if bounds is not None:
            bounds.append((lo, hi))
        if hi - lo <= window:
            routes.append("window")
            side = "right" if right else "left"
            out[t0:t0 + tile] = lo + np.searchsorted(b[lo:hi], qt, side=side)
        else:
            routes.append("splitter")
            out[t0:t0 + tile] = [splitter_count(x) for x in qt]
    return out, routes


def _codes4(x, s0, b, offset):
    """``packed.cuh``'s codes4: the four values at bit offsets s0 + j*b of
    the five lanes ``x`` (uint32), each from lanes k and k + 1 by a funnel
    shift, masked, plus ``offset`` as an int32 wrap-add."""
    x = [int(w) for w in x]
    mask = (1 << b) - 1
    out = []
    for j in range(4):
        o = s0 + j * b
        k = o >> 5
        assert k <= 3, (s0, b)
        window = x[k] | (x[k + 1] << 32)
        out.append(((window >> (o & 31)) & mask) + offset)
    return np.array(out, np.int64).astype(np.uint32).view(np.int32)


def _extract(words, i, b, offset):
    """``packed.cuh``'s extract(): value i from lanes w and w + 1 (0 past
    the stream's end)."""
    bit = i * b
    w, s = bit >> 5, bit & 31
    hi = int(words[w + 1]) if w + 1 < len(words) else 0
    code = ((int(words[w]) | (hi << 32)) >> s) & ((1 << b) - 1)
    return np.array([code + offset], np.int64).astype(np.uint32).view(
        np.int32)[0]


def extract4_emulated(words, i, b, offset):
    """``packed.cuh``'s extract4: values i .. i + 3 from the ``need`` lanes
    that cover them (at most five), lanes past the stream or past ``need``
    read as 0."""
    words = np.asarray(words).view(np.uint32)
    bit = i * b
    w, s0 = bit >> 5, bit & 31
    need = (s0 + 4 * b + 31) >> 5
    assert need <= 5
    x = [int(words[w + k]) if k < need and w + k < len(words) else 0
         for k in range(5)]
    return _codes4(x, s0, b, offset)


def unpack_groups_emulated(words, b, offset, n, aligned=True, group=128):
    """``unpack_kernel``'s walk in numpy: the output and each group's route.
    With ``aligned`` (words and output 16-byte aligned) every full group of
    ``group`` values stages its 4b lanes (from lane 4b*g: b 16-byte loads)
    and each of 32 lanes takes its four consecutive values from the lanes
    it needs of the staged row (``codes4``), asserting it reads no lane
    outside the row; the ragged last group, and every group when not
    ``aligned``, take extract() a value ("scalar")."""
    words = np.asarray(words).view(np.uint32)
    out = np.zeros(n, np.int32)
    groups = -(-n // group)
    full = n // group if aligned else 0
    routes = []
    assert group * b % 128 == 0  # a group is a whole number of 16-byte loads
    for g in range(groups):
        if g < full:
            routes.append("group")
            row = words[4 * b * g:4 * b * (g + 1)]
            assert len(row) == 4 * b
            for lane in range(group // 4):
                bit0 = 4 * lane * b
                w0, s0 = bit0 >> 5, bit0 & 31
                need = (s0 + 4 * b + 31) >> 5
                assert w0 + need <= len(row)  # only the group's own lanes
                x = [int(row[w0 + k]) if k < need else 0 for k in range(5)]
                out[g * group + 4 * lane:g * group + 4 * lane + 4] = _codes4(
                    x, s0, b, offset)
        else:
            routes.append("scalar")
            for i in range(g * group, min((g + 1) * group, n)):
                out[i] = _extract(words, i, b, offset)
    return out, routes


def bucketize_packed_tiles_emulated(boundaries, words, b, offset, n,
                                    right=True, max_splitters=4096,
                                    window=2048, tile=2048):
    """``bucketize_packed_kernel``'s tiled route in numpy: each thread's
    four consecutive queries by ``extract4_emulated`` (the ragged end by
    extract()), then the tile plan of ``bucketize_tiles_emulated``.
    Returns the counts, each tile's route and its (lo, hi)."""
    q = np.zeros(n, np.int32)
    for i in range(0, n - n % 4, 4):
        q[i:i + 4] = extract4_emulated(words, i, b, offset)
    for i in range(n - n % 4, n):
        q[i] = _extract(np.asarray(words).view(np.uint32), i, b, offset)
    bounds = []
    counts, routes = bucketize_tiles_emulated(
        np.asarray(boundaries), q, right, max_splitters, window, tile, bounds)
    return counts, routes, bounds


def _warp_count(ends, lb, x):
    """``rle_tile.cuh``'s warp search for one target: the count of ends < x
    over ``ends[lb:]`` plus lb, by a gallop round (lane j probes
    lb + 2^j - 1), rounds of 32 evenly spaced probes, and a last round of
    consecutive probes once at most 32 ends are left."""
    cap = len(ends)
    lanes = np.arange(32, dtype=np.int64)
    a, b, gallop = lb, cap, True
    while b > a:
        last = not gallop and b - a <= 32
        if last:
            p = a + lanes
        elif gallop:
            p = a + (np.int64(1) << lanes) - 1
        else:
            step = -(-(b - a) // 32)
            p = a + (lanes + 1) * step - 1
        ok = (p < b) & (ends[np.minimum(p, cap - 1)] < x)
        m = int(ok.sum())
        assert ok[:m].all(), "probes accepted out of order: ends not sorted"
        if last:
            a = b = a + m
        elif gallop:
            a, b = (a if m == 0 else a + (1 << (m - 1))), min(a + (1 << m) - 1, b)
        else:
            a, b = a + m * step, min(a + m * step + step - 1, b)
        gallop = False
    return a


def rle_tiles_emulated(values, starts, ends, n, nrows, fill, tile=256,
                       stage=256, warps=8):
    """``rle_decode_kernel`` / ``rle_decode_packed_kernel``'s tile walk in
    numpy: the output and, per tile, its route ("one", "window" or
    "large") and whether it searched (False where run lb, the count
    carried from the tile before, covers the tile's last row).
    ``warps`` warps take contiguous ranges of ``tile``-row tiles; each
    tile's runs are bounded by lo0 / lo1, the counts of ends < its first
    / last row; a window of at most ``stage`` runs counts each end at row
    end + 1 of the tile and gives a row the prefix sum up to it, its bounds
    relative to the tile's first row; a larger one bisects every row in
    ``ends``."""
    values = np.asarray(values)
    starts = np.asarray(starts).astype(np.int64)
    ends = np.asarray(ends).astype(np.int64)
    cap = len(ends)
    fill_v = np.asarray(fill).astype(values.dtype)
    out = np.full(nrows, fill_v, values.dtype)
    if nrows == 0 or cap == 0:
        return out, [], []
    tiles = -(-nrows // tile)
    per = -(-tiles // warps)
    routes, searched = [None] * tiles, [False] * tiles
    for w in range(warps):
        lb, cur, ce = 0, -1, 0
        for t in range(w * per, min(w * per + per, tiles)):
            r0 = t * tile
            rl = min(r0 + tile, nrows) - 1
            lo0 = lo1 = cap
            if lb < cap:
                eb = ce if cur == lb else ends[lb]
                if eb >= rl:
                    lo0 = lo1 = lb
                else:
                    lo0 = _warp_count(ends, lb, r0)
                    lo1 = _warp_count(ends, lb, rl)
                    searched[t] = True
            lb = lo1
            base, top = min(lo0, cap - 1), min(lo1, cap - 1)
            rows = np.arange(r0, rl + 1, dtype=np.int64)
            if base == top:
                routes[t] = "one"
                if cur != base:
                    cur, ce = base, ends[base]
                run = np.full(len(rows), base, np.int64)
                cov = (run < n) & (rows >= starts[run]) & (rows <= ends[run])
            elif top - base < stage:
                routes[t] = "window"
                m = top - base  # ends counted: those of runs base .. top - 1
                s_start = np.clip(starts[base:top + 1] - r0, -1, tile)
                s_end = np.clip(ends[base:top + 1] - r0, -1, tile)
                cnt = np.zeros(tile, np.int64)
                pos = s_end[:m] + 1
                np.add.at(cnt, pos[(pos >= 0) & (pos < tile)], 1)
                k = np.cumsum(cnt)[:len(rows)]  # inclusive prefix sums
                q = rows - r0
                kn = min(max(n - base, 0), m + 1)  # run < n: k < kn
                run = base + k
                cov = (k < kn) & (q >= s_start[k]) & (q <= s_end[k])
            else:
                routes[t] = "large"
                run = base + np.searchsorted(ends[base:top], rows, "left")
                cov = (run < n) & (rows >= starts[run]) & (rows <= ends[run])
            out[r0:rl + 1] = np.where(cov, values[run], fill_v)
    return out, routes, searched
