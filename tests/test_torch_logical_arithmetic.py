"""Twins of tests/test_logical.py and tests/test_arithmetic.py: AND / OR /
NOT over every mask-encoding pair (paper §5, Tables 2-5) and alignment,
binary ops, comparisons and selection (§6), held against repro on the same
seeded inputs. Output encodings and buffers must match exactly."""
import numpy as np
import pytest

from repro.core import arithmetic as JA, encodings as JE, logical as JL
from repro_torch.core import arithmetic as TA, encodings as TE, logical as TL
from repro_torch.kernels import dispatch as tdispatch

from torch_twins import (CPU, assert_same, assert_same_encoded,
                         index_col_twins, mask_twins, rle_col_twins)

KINDS = ["plain", "rle", "index"]
PAIRS = [(a, b) for a in KINDS for b in KINDS]
N = 48  # fixed shapes keep the JAX side's compile cache warm
CAP = N + 1


def _dense(rng, n=N):
    return rng.random(n) < rng.random()


def _twins(kind, d):
    return mask_twins(kind, d, cap=CAP)


@pytest.mark.parametrize("e1,e2", PAIRS)
@pytest.mark.parametrize("seed", range(2))
def test_and_or(e1, e2, seed):
    rng = np.random.default_rng(seed)
    d1, d2 = _dense(rng), _dense(rng)
    j1, t1 = _twins(e1, d1)
    j2, t2 = _twins(e2, d2)
    for jfn, tfn, want in ((JL.and_masks, TL.and_masks, d1 & d2),
                           (JL.or_masks, TL.or_masks, d1 | d2)):
        jm, tm = jfn(j1, j2), tfn(t1, t2)
        assert_same_encoded(jm, tm, f"{jfn.__name__} {e1} {e2}")
        np.testing.assert_array_equal(TE.decode_mask(tm).numpy(), want)


@pytest.mark.parametrize("enc", KINDS)
@pytest.mark.parametrize("seed", range(2))
def test_not(enc, seed):
    d = _dense(np.random.default_rng(seed))
    j, t = _twins(enc, d)
    jm, tm = JL.not_mask(j), TL.not_mask(t)
    assert_same_encoded(jm, tm, enc)
    np.testing.assert_array_equal(TE.decode_mask(tm).numpy(), ~d)


def test_and_with_index_cap_hint(rng):
    d1, d2 = _dense(rng), _dense(rng)
    jr, tr = _twins("rle", d1)
    jp, tp = _twins("plain", d2)
    assert_same_encoded(JL.and_masks(jr, jp, index_cap_hint=CAP),
                        TL.and_masks(tr, tp, index_cap_hint=CAP))


def test_composite_masks_demorgan(rng):
    """§5.4: composite masks behave as the OR of their parts."""
    d = rng.random(60) < 0.4
    dr = d.copy()
    dr[40:] = False
    di = d.copy()
    di[:40] = False
    jr, tr = mask_twins("rle", dr)
    ji, ti = mask_twins("index", di)
    jc = JE.RLEIndexMask(rle=jr, idx=ji, nrows=60)
    tc = TE.RLEIndexMask(rle=tr, idx=ti, nrows=60)
    other = rng.random(60) < 0.5
    jo, to = mask_twins("rle", other)
    assert_same_encoded(JL.and_masks(jc, jo), TL.and_masks(tc, to), "and")
    assert_same_encoded(JL.or_masks(jc, jo), TL.or_masks(tc, to), "or")
    assert_same_encoded(JL.not_mask(jc), TL.not_mask(tc), "not")
    jp, tp = mask_twins("plain", other)
    assert_same_encoded(JL.or_masks(jc, jp), TL.or_masks(tc, tp), "or plain")
    np.testing.assert_array_equal(TE.decode_mask(TL.not_mask(tc)).numpy(),
                                  ~(dr | di))


# ---------------------------------------------------------------------------
# Arithmetic (§6)
# ---------------------------------------------------------------------------


def _col_twins(kind, vals, rng):
    if kind == "plain":
        return JE.make_plain(vals), TE.make_plain(vals, device=CPU)
    if kind == "rle":
        return rle_col_twins(vals, cap=CAP)
    present = rng.random(len(vals)) < 0.6
    return index_col_twins(vals, present, cap=CAP)


COLS = ["plain", "rle", "index"]


@pytest.mark.parametrize("k1,k2", [(a, b) for a in COLS for b in COLS])
@pytest.mark.parametrize("op", ["add", "mul", "lt"])
def test_binary_op(k1, k2, op):
    rng = np.random.default_rng(len(k1) + 7 * len(k2))
    v1 = np.repeat(rng.integers(0, 5, N // 4), 4).astype(np.int32)
    v2 = rng.integers(0, 5, N).astype(np.int32)
    j1, t1 = _col_twins(k1, v1, rng)
    j2, t2 = _col_twins(k2, v2, rng)
    for route in (None, True):
        with tdispatch.overrides(use_kernels=route):
            got = TA.binary_op(t1, t2, op)
        assert_same_encoded(JA.binary_op(j1, j2, op), got, f"{k1} {op} {k2}")


@pytest.mark.parametrize("kind", COLS + ["plain_index", "rle_index"])
@pytest.mark.parametrize("op", ["gt", "ge", "lt", "le", "eq", "ne"])
def test_compare_literal(kind, op):
    rng = np.random.default_rng(3)
    v = np.repeat(rng.integers(0, 5, N // 4), 4).astype(np.int32)
    if kind in ("plain_index", "rle_index"):
        from torch_twins import encode_twins
        v = np.concatenate([v, [200, 3, 3, 3, 3, 1, 2]]).astype(np.int32)
        j, t = encode_twins(v, {"plain_threshold": 10}, encoding=kind)
    else:
        j, t = _col_twins(kind, v, rng)
    for lit in (0, 2, 4):
        assert_same_encoded(JA.compare(j, op, lit), TA.compare(t, op, lit),
                            f"{kind} {op} {lit}")


@pytest.mark.parametrize("kind", COLS)
@pytest.mark.parametrize("incl", [(True, True), (False, True), (True, False)])
def test_compare_range_fused(kind, incl):
    rng = np.random.default_rng(11)
    v = np.repeat(rng.integers(0, 9, N // 4), 4).astype(np.int32)
    j, t = _col_twins(kind, v, rng)
    assert_same_encoded(JA.compare_range(j, 2, 6, *incl),
                        TA.compare_range(t, 2, 6, *incl))


def test_narrow_column_out_of_range_literal():
    """torch would wrap 300 into int8; the port widens instead (JAX
    refuses such a literal outright)."""
    t = TE.make_plain(np.array([1, 100, -5], np.int8), device=CPU)
    assert TA.compare(t, "lt", 300).values.tolist() == [True, True, True]
    assert TA.compare(t, "eq", 356).values.tolist() == [False, False, False]
    r = TE.make_rle(np.array([100], np.int8), [0], [2], 3, device=CPU)
    assert int(TA.compare_range(r, 0, 1000).n) == 1


@pytest.mark.parametrize("kind", COLS + ["rle_index"])
def test_scalar_op(kind):
    rng = np.random.default_rng(5)
    v = np.repeat(rng.integers(0, 5, N // 4), 4).astype(np.int32)
    if kind == "rle_index":
        from torch_twins import encode_twins
        v = np.concatenate([v, [200, 3, 3, 3, 3, 1, 2]]).astype(np.int32)
        j, t = encode_twins(v, {"plain_threshold": 10}, encoding=kind)
    else:
        j, t = _col_twins(kind, v, rng)
    for op, s in (("mul", 3), ("add", -2), ("truediv", 2)):
        assert_same_encoded(JA.scalar_op(j, op, s), TA.scalar_op(t, op, s),
                            f"{kind} {op}")


@pytest.mark.parametrize("kind", COLS)
@pytest.mark.parametrize("menc", KINDS)
def test_apply_mask_selection(kind, menc):
    rng = np.random.default_rng(len(kind) * 3 + len(menc))
    v = np.repeat(rng.integers(1, 6, N // 4), 4).astype(np.int32)
    keep = _dense(rng)
    j, t = _col_twins(kind, v, rng)
    jm, tm = _twins(menc, keep)
    for route in (None, True):
        with tdispatch.overrides(use_kernels=route):
            got = TA.apply_mask(t, tm)
        want = JA.apply_mask(j, jm)
        assert_same_encoded(want, got, f"{kind} & {menc}")
        assert_same(JE.decode_column(want), TE.decode_column(got))


def test_apply_composite_mask(rng):
    v = np.repeat(rng.integers(1, 6, N // 4), 4).astype(np.int32)
    j, t = rle_col_twins(v, cap=CAP)
    dr = rng.random(N) < 0.5
    dr[N // 2:] = False
    di = rng.random(N) < 0.3
    di[:N // 2] = False
    jr, tr = mask_twins("rle", dr)
    ji, ti = mask_twins("index", di)
    want = JA.apply_mask(j, JE.RLEIndexMask(rle=jr, idx=ji, nrows=N))
    got = TA.apply_mask(t, TE.RLEIndexMask(rle=tr, idx=ti, nrows=N))
    assert_same_encoded(want, got)


def test_and_composite_with_plain_mask(rng):
    """AND of an RLE+Index mask with a Plain mask is the row-level AND. The
    reference returns an empty mask here (ROADMAP queue C); the port
    departs from it deliberately."""
    dr = rng.random(N) < 0.5
    dr[N // 2:] = False
    di = rng.random(N) < 0.3
    di[:N // 2] = False
    other = rng.random(N) < 0.5
    jr, tr = mask_twins("rle", dr)
    ji, ti = mask_twins("index", di)
    jp, tp = mask_twins("plain", other)
    tc = TE.RLEIndexMask(rle=tr, idx=ti, nrows=N)
    for got in (TL.and_masks(tc, tp), TL.and_masks(tp, tc)):
        np.testing.assert_array_equal(TE.decode_mask(got).numpy(),
                                      (dr | di) & other)
    jc = JE.RLEIndexMask(rle=jr, idx=ji, nrows=N)
    assert not np.asarray(JE.decode_mask(JL.and_masks(jc, jp))).any()
