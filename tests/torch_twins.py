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

# JAX dtype names -> torch dtypes, for the dtype half of every comparison
_NP_OF_TORCH = {
    torch.bool: np.dtype(np.bool_), torch.int8: np.dtype(np.int8),
    torch.int16: np.dtype(np.int16), torch.int32: np.dtype(np.int32),
    torch.int64: np.dtype(np.int64), torch.uint8: np.dtype(np.uint8),
    torch.float32: np.dtype(np.float32), torch.float64: np.dtype(np.float64),
}

CPU = torch.device("cpu")
I32MAX = np.iinfo(np.int32).max


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
