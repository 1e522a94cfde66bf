"""Bit-packed columns of the port against the reference (DESIGN.md §11).

The twin of tests/test_packed.py. The same numpy inputs go through
``repro`` (Pallas kernels in interpret mode where its own tests use them)
and ``repro_torch`` on the CPU:

  1. ``pack_array`` words are bit for bit the reference's, and the plain
     ``ref_unpack`` / ``ref_bucketize_packed`` / ``ref_rle_decode_packed``
     equal the reference's kernels for every bit width 1..32, offset wrap
     included; the kernel wrappers on CPU tensors run those plain versions;
  2. dispatch routes packed reads, packed probes and packed run values to
     the three kernel wrappers when ``use_kernels=True``;
  3. packed encoded buffers equal the reference's through ``convert``,
     and packed queries give the reference's answers on the six encodings;
  4. footprint accounting (``nbytes_unpacked``) and the pack policy switch;
  5. ``unpack_kernel``'s group walk (``torch_twins.unpack_groups_emulated``:
     128 values a warp from 4b staged lanes, four a lane, the scalar tail
     and unaligned words) equals the reference kernel in interpret mode.

Integers compare exactly; float sums within rtol 1e-4, the reference
tests' tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compress as jc
from repro.core import encodings as JE
from repro.core.plan import Query as JQuery, col as jcol
from repro.core.table import Table as JTable
from repro.kernels import ref as jref
from repro.kernels import unpack as junpack
from repro_torch.core import compress as tc
from repro_torch.core import convert
from repro_torch.core import encodings as TE
from repro_torch.core.plan import Query as TQuery, col as tcol
from repro_torch.core.table import Table as TTable
from repro_torch.kernels import dispatch, ops, ref as tref
from repro_torch.kernels import unpack as tunpack

from torch_twins import (CPU, SIX_ENCODINGS, assert_payload_close, assert_same,
                         assert_same_encoded, describe_table, result_payload,
                         six_encoding_data, unpack_groups_emulated)


def _codes(rng, b, n, lo=None):
    """(values, offset) of ``n`` values spanning a ``b``-bit domain."""
    if b == 32:
        lo, hi = -(2**31), 2**31 - 1
    else:
        lo = -(1 << (b - 1)) if lo is None else lo
        hi = lo + (1 << b) - 1
    return rng.integers(lo, hi, n, endpoint=True).astype(np.int64), lo


def _words(v, lo, b):
    """(reference uint32 lanes, port int32 view) of the packed values."""
    w = jc.pack_array(v, lo, b)
    return w, torch.from_numpy(w.view(np.int32).copy())


# ---------------------------------------------------------------------------
# 1. pack / unpack and the plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b", list(range(1, 33)))
def test_pack_array_and_ref_unpack_match_reference(rng, b):
    for n, lo in ((0, 0), (1, -3), (37, None), (257, 5), (2049, None)):
        v, lo = _codes(rng, b, n, lo)
        want = jc.pack_array(v, lo, b)
        got = tc.pack_array(v, lo, b)
        assert got.dtype == want.dtype == np.uint32
        np.testing.assert_array_equal(got, want)
        w32 = torch.from_numpy(got.view(np.int32).copy())
        out = tref.ref_unpack(w32, b, lo, n)
        assert_same(jref.ref_unpack(jnp.asarray(want), b, lo, n), out,
                    f"b={b} n={n}")
        np.testing.assert_array_equal(out.numpy(), v.astype(np.int32))
        np.testing.assert_array_equal(tc.unpack_array(got, lo, b, n),
                                      jc.unpack_array(want, lo, b, n))


@pytest.mark.parametrize("b", [1, 5, 9, 13, 21, 24, 31, 32])
def test_unpack_kernel_route_matches_reference_kernel(rng, b):
    """The wrapper (plain version on CPU tensors) equals the reference's
    interpret-mode Pallas kernel on a ragged count with straddling lanes
    and a negative offset."""
    v, lo = _codes(rng, b, 2049)
    w, w32 = _words(v, lo, b)
    want = junpack.unpack_kernel(jnp.asarray(w), b, lo, 2049, interpret=True)
    assert_same(want, tunpack.unpack_kernel(w32, b, lo, 2049))
    assert_same(want, ops.unpack(w, b, lo, 2049, use_kernel=True, device=CPU))


def test_offset_wrap_at_width_32(rng):
    """Width 32 is a modular passthrough: (v - offset) mod 2**32 stored,
    the int32 wrap-add of ``offset`` restores every int32 v."""
    v = np.array([-(2**31), -1, 0, 1, 2**31 - 1], np.int64)
    for lo in (0, 7, -(2**31), 2**31 - 1):
        w, w32 = _words(v, lo, 32)
        assert_same(jref.ref_unpack(jnp.asarray(w), 32, lo, 5),
                    tref.ref_unpack(w32, 32, lo, 5), f"offset {lo}")
        np.testing.assert_array_equal(tref.ref_unpack(w32, 32, lo, 5).numpy(),
                                      v.astype(np.int32))


@pytest.mark.parametrize("case", ["sentinel_padded", "ragged_2049",
                                  "one_boundary", "beyond_smem_size"])
@pytest.mark.parametrize("right", [True, False])
def test_bucketize_packed_matches_reference_kernel(rng, case, right):
    b = {"sentinel_padded": 9, "ragged_2049": 21, "one_boundary": 3,
         "beyond_smem_size": 24}[case]
    n = 2049 if case == "ragged_2049" else 700
    v, lo = _codes(rng, b, n, lo=-5)
    dom = (lo, lo + (1 << b) - 1)
    if case == "sentinel_padded":
        bnd = np.concatenate([np.sort(rng.integers(*dom, 20)),
                              np.full(12, np.iinfo(np.int32).max)])
    elif case == "one_boundary":
        bnd = np.array([1])
    else:
        bnd = np.sort(rng.integers(*dom, 3000 if case == "ragged_2049"
                                   else 70_000))
    bnd = bnd.astype(np.int32)
    w, w32 = _words(v, lo, b)
    want = junpack.bucketize_packed_kernel(jnp.asarray(bnd), jnp.asarray(w),
                                           b, lo, n, right, interpret=True)
    got = tunpack.bucketize_packed_kernel(torch.from_numpy(bnd), w32, b, lo,
                                          n, right)
    assert_same(want, got, case)


@pytest.mark.parametrize("n_valid,fill", [(16, 0), (9, -4), (0, 7)])
def test_rle_decode_packed_matches_reference_kernel(rng, n_valid, fill):
    """A partially covered RLE with gaps, ``n < cap`` and a fill."""
    nrows, cap = 5000, 16
    starts = np.sort(rng.choice(nrows - 10, cap, replace=False)).astype(np.int32)
    ends = np.minimum(np.concatenate([starts[1:] - 3, [nrows - 40]]),
                      nrows - 1).astype(np.int32)
    vals, lo = _codes(rng, 5, cap, lo=-9)
    w, w32 = _words(vals, lo, 5)
    want = junpack.rle_decode_packed_kernel(
        jnp.asarray(w), 5, lo, cap, jnp.asarray(starts), jnp.asarray(ends),
        jnp.asarray(n_valid, jnp.int32), nrows, fill, interpret=True)
    n = torch.tensor(n_valid, dtype=torch.int32)
    got = tunpack.rle_decode_packed_kernel(
        w32, 5, lo, cap, torch.from_numpy(starts), torch.from_numpy(ends), n,
        nrows, fill)
    assert_same(want, got)
    plain = tref.ref_rle_decode(torch.from_numpy(vals.astype(np.int32)),
                                torch.from_numpy(starts),
                                torch.from_numpy(ends), n, nrows, fill)
    assert_same(plain, got)


def test_wrappers_check_their_inputs():
    w = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="cannot hold"):
        tunpack.unpack_kernel(w, 9, 0, 20)  # 20 x 9 bits need 6 lanes
    with pytest.raises(ValueError, match="outside 1..32"):
        tunpack.unpack_kernel(w, 33, 0, 1)
    with pytest.raises(TypeError, match="int32 lanes"):
        tunpack.unpack_kernel(w.to(torch.int64), 4, 0, 4)
    with pytest.raises(TypeError, match="boundaries must be int32"):
        tunpack.bucketize_packed_kernel(torch.zeros(2), w, 4, 0, 4)
    assert tunpack.unpack_kernel(torch.zeros(0, dtype=torch.int32), 7, 0,
                                 0).shape == (0,)


# ---------------------------------------------------------------------------
# 2. dispatch routing
# ---------------------------------------------------------------------------


def _count(monkeypatch, name):
    calls = []
    real = getattr(dispatch, name)

    def wrapper(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(dispatch, name, wrapper)
    return calls


def _packed(rng, n=100, b=5, lo=-7):
    v, lo = _codes(rng, b, n, lo)
    _, w32 = _words(v, lo, b)
    return v, TE.PackedColumn(words=w32, nrows=n, bit_width=b, offset=lo)


def test_dispatch_routes_packed_reads_to_the_kernels(rng, monkeypatch):
    un = _count(monkeypatch, "unpack_kernel")
    bp = _count(monkeypatch, "bucketize_packed_kernel")
    rp = _count(monkeypatch, "rle_decode_packed_kernel")
    v, pc = _packed(rng)
    np.testing.assert_array_equal(dispatch.unpack(pc).numpy(), v)
    assert not un  # CPU tensors, auto policy: the plain version
    with dispatch.overrides(use_kernels=True):
        np.testing.assert_array_equal(TE.unpack_values(pc).numpy(), v)
        with dispatch.overrides(unpack_min_vals=1000):
            dispatch.unpack(pc)  # below the size threshold
    assert len(un) == 1

    v9, pc9 = _packed(rng, n=200, b=9, lo=0)
    bnd = torch.from_numpy(np.sort(rng.integers(0, 512, 37)).astype(np.int32))
    want = np.searchsorted(bnd.numpy(), v9, side="right")
    np.testing.assert_array_equal(dispatch.bucketize(bnd, pc9).numpy(), want)
    assert not bp
    with dispatch.overrides(use_kernels=True):
        got = dispatch.bucketize(bnd, pc9, right=True)
    assert len(bp) == 1
    np.testing.assert_array_equal(got.numpy(), want)

    nrows = 8192
    starts = np.sort(rng.choice(nrows, 16, replace=False)).astype(np.int32)
    ends = np.concatenate([starts[1:] - 1, [nrows - 1]]).astype(np.int32)
    vals, lo = _codes(rng, 4, 16, lo=-5)
    _, w32 = _words(vals, lo, 4)
    rv = TE.PackedColumn(words=w32, nrows=16, bit_width=4, offset=lo)
    args = (rv, torch.from_numpy(starts), torch.from_numpy(ends),
            torch.tensor(16, dtype=torch.int32), nrows)
    assert dispatch.maybe_rle_decode(*args) is None
    with dispatch.overrides(use_kernels=True):
        got = dispatch.maybe_rle_decode(*args)
    assert len(rp) == 1
    want = jref.ref_rle_decode(jnp.asarray(vals.astype(np.int32)),
                               jnp.asarray(starts), jnp.asarray(ends),
                               jnp.asarray(16, jnp.int32), nrows)
    assert_same(want, got)


def test_policy_pack_env_knobs():
    pol = dispatch.policy_from_env({"REPRO_PACK": "0",
                                    "REPRO_PACK_MAX_BITS": "16",
                                    "REPRO_UNPACK_MIN_VALS": "64"})
    assert pol.enable_pack is False and pol.pack_max_bits == 16
    assert pol.unpack_min_vals == 64
    auto = dispatch.policy_from_env({})
    assert auto.enable_pack and auto.pack_max_bits == 24
    assert auto.unpack_min_vals == 0  # the port launches on every size


# ---------------------------------------------------------------------------
# 3. packed buffers and packed queries against the reference
# ---------------------------------------------------------------------------


def _tables(rng, enc, pack, n=12_000):
    cfg = dict(plain_threshold=1000)
    data, encs = six_encoding_data(rng, enc, n)
    j = JTable.from_arrays(data, cfg=jc.CompressionConfig(**cfg),
                           encodings=encs, pack=pack)
    t = TTable.from_arrays(data, cfg=tc.CompressionConfig(**cfg),
                           encodings=encs, pack=pack, device=CPU)
    return j, t


def _has_packed(col) -> bool:
    return any(isinstance(getattr(col, f), TE.PackedColumn)
               or (hasattr(getattr(col, f), "__dataclass_fields__")
                   and _has_packed(getattr(col, f)))
               for f in col.__dataclass_fields__)


@pytest.mark.parametrize("enc", SIX_ENCODINGS)
def test_packed_buffers_match_reference_through_convert(rng, enc):
    j, t = _tables(rng, enc, pack=True)
    assert any(_has_packed(c) for c in t.columns.values()), enc
    for name in j.columns:
        assert_same_encoded(j.columns[name], t.columns[name], name)
    loaded = convert.table_from_numpy(describe_table(j), device=CPU)
    for name in j.columns:
        assert_same_encoded(j.columns[name], loaded.columns[name], name)
        w = loaded.columns[name]
        leaf = getattr(w, "values", None)
        if isinstance(leaf, TE.PackedColumn):  # no widening on the way in
            assert leaf.words.dtype == torch.int32
    back = convert.table_to_numpy(loaded)
    for name in j.columns:
        assert_same_encoded(j.columns[name], back["columns"][name], name)
        np.testing.assert_array_equal(t.decode(name), np.asarray(j.decode(name)))


@pytest.mark.parametrize("enc", SIX_ENCODINGS)
def test_packed_queries_match_reference(rng, enc):
    j, t = _tables(rng, enc, pack=True)
    kf = "key_010" if enc == "plain_dict" else 10

    def q(Query, col, table):
        return (Query(table).filter((col("k") == kf) | (col("v") > 500))
                .groupby(["k"], {"s": ("sum", "v"), "a": ("avg", "f"),
                                 "c": ("count", None)}, num_groups_cap=64))

    want = result_payload(q(JQuery, jcol, j).run())
    got = result_payload(q(TQuery, tcol, t).run())
    assert_payload_close(want, got, enc)
    with dispatch.overrides(use_kernels=True):  # the kernel route, forced
        forced = result_payload(q(TQuery, tcol, t).run())
    assert_payload_close(want, forced, f"{enc} kernels")
    for name in t.columns:
        np.testing.assert_array_equal(t.decode(name), j.decode(name))


def test_packed_semi_join_and_join_match_reference(rng):
    n = 30_000
    data = {"store": rng.integers(0, 500, n).astype(np.int32),
            "units": rng.integers(0, 100, n).astype(np.int32)}
    dim = {"store": np.arange(500, dtype=np.int32),
           "tier": rng.integers(0, 5, 500).astype(np.int32)}
    whitelist = rng.choice(500, 40, replace=False).astype(np.int32)

    def run(Table, Query, cfg, extra, pack):
        d = Table.from_arrays(dim, pack=True, **extra)
        t = Table.from_arrays(data, cfg=cfg, pack=pack, **extra)
        return result_payload(
            Query(t).semi_join("store", whitelist)
            .join(d, fk="store", cols=["tier"])
            .groupby(["tier"], {"s": ("sum", "units"), "c": ("count", None)},
                     num_groups_cap=8).run())

    want = run(JTable, JQuery, jc.CompressionConfig(plain_threshold=1000), {},
               True)
    for pack in (False, True):
        for kernels in (None, True):
            with dispatch.overrides(use_kernels=kernels):
                got = run(TTable, TQuery,
                          tc.CompressionConfig(plain_threshold=1000),
                          {"device": CPU}, pack)
            assert_payload_close(want, got, f"pack={pack} kernels={kernels}")


def test_rle_packed_semi_join_reaches_the_fused_probe(rng, monkeypatch):
    """An RLE key with packed run values (Q17's ``partkey``) probes through
    ``bucketize_packed_kernel``, and its runs expand through
    ``rle_decode_packed_kernel``."""
    bp = _count(monkeypatch, "bucketize_packed_kernel")
    rp = _count(monkeypatch, "rle_decode_packed_kernel")
    n = 40_000
    data = {"pk": np.sort(rng.integers(0, 300, n)).astype(np.int32),
            "q": rng.integers(1, 51, n).astype(np.int32)}
    keys = np.unique(rng.integers(0, 300, 40)).astype(np.int32)
    cfg = dict(plain_threshold=1000)
    j = JTable.from_arrays(data, cfg=jc.CompressionConfig(**cfg), pack=True)
    t = TTable.from_arrays(data, cfg=tc.CompressionConfig(**cfg), pack=True,
                           device=CPU)
    assert isinstance(t.columns["pk"].values, TE.PackedColumn)

    def q(Query, col, table):
        return (Query(table).semi_join("pk", keys).filter(col("q") < 10)
                .aggregate({"c": ("count", None), "s": ("sum", "q")}))

    want = result_payload(q(JQuery, jcol, j).run())
    with dispatch.overrides(use_kernels=True):
        got = result_payload(q(TQuery, tcol, t).run())
        dense = TE.decode_column(t.columns["pk"])
    assert bp and rp
    assert_payload_close(want, got)
    np.testing.assert_array_equal(dense.numpy(), data["pk"])


# ---------------------------------------------------------------------------
# 4. footprint accounting and the pack policy
# ---------------------------------------------------------------------------


def _dict_heavy(rng, n):
    vocab = np.array([f"v{i:04d}" for i in range(500)])
    return {"a": vocab[rng.integers(0, 500, n)],
            "b": vocab[rng.integers(0, 500, n)],
            "units": rng.integers(0, 100, n).astype(np.int32)}


def test_nbytes_packed_vs_unpacked_match_reference(rng):
    data = _dict_heavy(rng, 20_000)
    for pack in (False, True):
        j = JTable.from_arrays(data, cfg=jc.CompressionConfig(
            plain_threshold=1000), pack=pack)
        t = TTable.from_arrays(data, cfg=tc.CompressionConfig(
            plain_threshold=1000), pack=pack, device=CPU)
        assert t.nbytes() == j.nbytes()
        assert t.nbytes_unpacked() == j.nbytes_unpacked()
        for name in data:
            assert (tc.encoded_nbytes(t.columns[name], unpacked=True)
                    == jc.encoded_nbytes(j.columns[name], unpacked=True))
    assert t.nbytes() < t.nbytes_unpacked()


def test_pack_disabled_by_policy(rng):
    data = {"k": rng.integers(0, 100, 5000).astype(np.int32)}
    with dispatch.overrides(enable_pack=False):
        t = TTable.from_arrays(data, pack=True, device=CPU)
    assert not _has_packed(t.columns["k"])
    t = TTable.from_arrays(data, pack=True, device=CPU)
    assert _has_packed(t.columns["k"])
    assert isinstance(t.columns["k"].values, TE.PackedColumn)
    assert t.columns["k"].values.words.dtype == torch.int32


def test_packed_column_metadata_probes():
    v = np.arange(10, dtype=np.int64)
    _, w32 = _words(v, 0, 4)
    pc = TE.PackedColumn(words=w32, nrows=10, bit_width=4, offset=0)
    assert pc.shape == (10,) and pc.size == 10 and pc.dtype == torch.int32
    assert pc.device == w32.device
    j = JE.PackedColumn(words=jnp.asarray(jc.pack_array(v, 0, 4)), nrows=10,
                        bit_width=4, offset=0)
    assert_same_encoded(j, pc)


# ---------------------------------------------------------------------------
# 5. unpack_kernel's group walk
# ---------------------------------------------------------------------------

PACK_WIDTHS = [1, 2, 3, 7, 8, 9, 16, 21, 24, 31, 32]
GROUP_NS = [0, 1, 127, 128, 129, 2047, 2048, 2049, 5003]


def _reference_unpack(w, b, lo, n):
    """The reference kernel in interpret mode; at n = 0, which its grid
    cannot take, the reference's plain version."""
    if n == 0:
        return np.asarray(jref.ref_unpack(jnp.asarray(w), b, lo, 0))
    return np.asarray(junpack.unpack_kernel(jnp.asarray(w), b, lo, n,
                                            interpret=True))


@pytest.mark.parametrize("b", PACK_WIDTHS)
@pytest.mark.parametrize("n", GROUP_NS)
def test_unpack_group_walk_matches_reference_kernel(rng, b, n):
    """Full groups of 128 values stage exactly their 4b lanes and each lane
    expands four values; the ragged tail (n % 128) takes the scalar path.
    Exact against the reference kernel and the plain version."""
    v, lo = _codes(rng, b, n)
    w, w32 = _words(v, lo, b)
    want = _reference_unpack(w, b, lo, n)
    got, routes = unpack_groups_emulated(w, b, lo, n)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, v.astype(np.int32))
    assert routes == ["group"] * (n // 128) + ["scalar"] * (n % 128 > 0)
    np.testing.assert_array_equal(tunpack.unpack_kernel(w32, b, lo, n).numpy(),
                                  want)


@pytest.mark.parametrize("b", PACK_WIDTHS)
def test_unpack_walk_on_unaligned_word_views(rng, b):
    """Words viewed at storage offsets 1-3 (4-12 bytes past a 16-byte
    boundary) take the scalar path for every group; offset 4 takes the
    group walk again. Same values either way."""
    for n in (2049, 777):
        v, lo = _codes(rng, b, n)
        w, _ = _words(v, lo, b)
        want = _reference_unpack(w, b, lo, n)
        for off in (1, 2, 3, 4):
            buf = np.concatenate([rng.integers(0, 2**32, off, dtype=np.uint32),
                                  w])
            view = torch.from_numpy(buf.view(np.int32))[off:]
            assert view.storage_offset() == off
            aligned = (4 * off) % 16 == 0
            got, routes = unpack_groups_emulated(view.numpy(), b, lo, n,
                                                 aligned=aligned)
            np.testing.assert_array_equal(got, want)
            assert ("group" in routes) == aligned, (off, routes)
            np.testing.assert_array_equal(
                tunpack.unpack_kernel(view, b, lo, n).numpy(), want)
