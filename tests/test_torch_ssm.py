"""Twins of ``repro.models.ssm`` in ``repro_torch.models.ssm`` on the CPU.

The reference's parameters (its ``init_*`` with a fixed key) are carried
across as host arrays, and the same seeded numpy inputs go through both
packages' functions. The reference runs compiled with XLA's excess
precision off (``tests/test_torch_models.py``: its code as written, each
op rounding where the code casts). Tolerances, as max |delta| / max |want|:
  * float32: 1e-5 (the port's inter-chunk recurrence is a sequential loop
    where the reference's is an associative scan, and its three-operand
    einsums contract in another order: float32 rounding apart);
  * bfloat16: 2e-2 (``test_torch_models.py``'s whole-model bound; a bf16
    ulp is 2^-8 of a value);
  * recurrent states within the same bounds; shapes and dtypes equal.
The reference's and the port's parameter trees have the same leaves,
shapes and dtypes (``init_*`` on the meta device against
``jax.eval_shape``).
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as RS
from repro_torch.models import ssm as TS
from repro_torch.models.convert import _leaf_to_tensor

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
META = torch.device("meta")


def _strict(fn, *args):
    """``fn(*args)`` compiled with XLA's excess precision off."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_tree(tree):
    return jax.tree.map(lambda a: _leaf_to_tensor(np.asarray(a)), tree)


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(got, want):
    got, want = _host(got), _host(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.max(np.abs(want))
    return float(np.max(np.abs(got - want)) / (scale if scale else 1.0))


def _inputs(rng, shape, jdt, tdt, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _structure(tree):
    flat = jax.tree_util.tree_leaves_with_path(tree)
    return {jax.tree_util.keystr(p): (tuple(x.shape),
                                      str(x.dtype).replace("torch.", ""))
            for p, x in flat}


# dims of the zamba2 / xlstm smoke configs
D, NSTATE, HDIM, CHUNK = 64, 16, 16, 8
XD, XH = 48, 2


@functools.lru_cache(maxsize=None)
def _ref_params(kind, dtype_name):
    jdt = DTYPES[dtype_name][0]
    key = jax.random.PRNGKey(3)
    if kind == "mamba2":
        p = RS.init_mamba2(key, D, NSTATE, HDIM, dtype=jdt)
    elif kind == "mlstm":
        p = RS.init_mlstm(key, XD, XH, dtype=jdt)
    else:
        p = RS.init_slstm(key, XD, XH, dtype=jdt)
    return _np_tree(p)


def _params(kind, dtype_name):
    host = _ref_params(kind, dtype_name)
    return jax.tree.map(jnp.asarray, host), _torch_tree(host)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_init_trees_match_reference_structure(dtype_name):
    jdt, tdt, _ = DTYPES[dtype_name]
    key = jax.random.PRNGKey(0)
    pairs = [
        (jax.eval_shape(lambda: RS.init_mamba2(key, D, NSTATE, HDIM,
                                               dtype=jdt)),
         TS.init_mamba2(None, D, NSTATE, HDIM, dtype=tdt, device=META)),
        (jax.eval_shape(lambda: RS.init_mlstm(key, XD, XH, dtype=jdt)),
         TS.init_mlstm(None, XD, XH, dtype=tdt, device=META)),
        (jax.eval_shape(lambda: RS.init_slstm(key, XD, XH, dtype=jdt)),
         TS.init_slstm(None, XD, XH, dtype=tdt, device=META)),
    ]
    for want, got in pairs:
        assert _structure(got) == _structure(want)
    # the constant leaves equal the reference's
    gen = torch.Generator().manual_seed(0)
    cpu = torch.device("cpu")
    for kind, tp in (("mamba2", TS.init_mamba2(gen, D, NSTATE, HDIM,
                                               dtype=tdt, device=cpu)),
                     ("mlstm", TS.init_mlstm(gen, XD, XH, dtype=tdt,
                                             device=cpu)),
                     ("slstm", TS.init_slstm(gen, XD, XH, dtype=tdt,
                                             device=cpu))):
        ref = _ref_params(kind, dtype_name)
        for name in ("A_log", "D", "dt_bias", "conv_b", "b_if", "b"):
            if name in ref:
                np.testing.assert_allclose(_host(tp[name]), _host(ref[name]),
                                           rtol=1e-6, err_msg=name)
        np.testing.assert_array_equal(_host(tp["norm"]["scale"]),
                                      _host(ref["norm"]["scale"]))
    # a stacked init: one [stack, ...] leaf per name
    st = TS.init_mamba2(None, D, NSTATE, HDIM, dtype=tdt, device=META,
                        stack=(3, 2))
    assert st["in_proj"].shape[:2] == (3, 2)
    assert TS._mamba2_dims({k: v[0, 0] for k, v in st.items()
                            if k != "norm"}) == TS._mamba2_dims(
        TS.init_mamba2(None, D, NSTATE, HDIM, dtype=tdt, device=META))


def test_mamba2_dims_twin():
    ref, port = _params("mamba2", "float32")
    assert TS._mamba2_dims(port) == RS._mamba2_dims(ref) == (128, 16, 8, 16)


@pytest.mark.parametrize("l", [16, 24])
def test_ssd_chunked_twin(rng, l):
    b, h, p, n = 2, 4, 8, 6
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h)).astype(np.float32)
    B = rng.standard_normal((b, l, n)).astype(np.float32)
    C = rng.standard_normal((b, l, n)).astype(np.float32)
    args = [jnp.asarray(a) for a in (x, dt, A, B, C)]
    want_y, want_s = _strict(functools.partial(RS._ssd_chunked, chunk=8),
                             *args)
    got_y, got_s = TS._ssd_chunked(*[torch.from_numpy(a)
                                     for a in (x, dt, A, B, C)], chunk=8)
    assert got_y.dtype == torch.float32
    assert _rel(got_y, want_y) < 1e-5
    assert _rel(got_s, want_s) < 1e-5


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("l", [16, 13])
def test_mamba2_twin(rng, dtype_name, l):
    """l = 13 is not a multiple of the chunk: both pad to 16 and cut."""
    jdt, tdt, bound = DTYPES[dtype_name]
    rp, tp = _params("mamba2", dtype_name)
    jx, tx = _inputs(rng, (2, l, D), jdt, tdt)
    want = _strict(functools.partial(RS.mamba2, chunk=CHUNK), rp, jx)
    got = TS.mamba2(tp, tx, CHUNK)
    assert got.dtype == tdt
    assert _rel(got, want) < bound


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_mamba2_decode_twin(rng, dtype_name):
    """Three recurrent steps from the reference's initial state; the conv
    window stays bfloat16 whatever the dtype, in both packages."""
    jdt, tdt, bound = DTYPES[dtype_name]
    rp, tp = _params("mamba2", dtype_name)
    rst = RS.mamba2_init_state(rp, 2)
    tst = TS.mamba2_init_state(tp, 2)
    assert _structure(tst) == _structure(rst)
    assert tst["conv"].dtype == torch.bfloat16
    step = jax.jit(RS.mamba2_decode)
    for _ in range(3):
        jx, tx = _inputs(rng, (2, 1, D), jdt, tdt)
        want, rst = step(rp, jx, rst)
        got, tst = TS.mamba2_decode(tp, tx, tst)
        assert got.dtype == tdt
        assert _rel(got, want) < bound
    assert _rel(tst["ssm"], rst["ssm"]) < bound
    assert tst["conv"].dtype == torch.bfloat16
    assert _rel(tst["conv"], rst["conv"]) < 2e-2


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_mlstm_twin(rng, dtype_name):
    jdt, tdt, bound = DTYPES[dtype_name]
    rp, tp = _params("mlstm", dtype_name)
    jx, tx = _inputs(rng, (2, 16, XD), jdt, tdt)
    want = _strict(RS.mlstm, rp, jx)
    got = TS.mlstm(tp, tx)
    assert got.dtype == tdt
    assert _rel(got, want) < bound


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_mlstm_decode_twin(rng, dtype_name):
    jdt, tdt, bound = DTYPES[dtype_name]
    rp, tp = _params("mlstm", dtype_name)
    rst = RS.mlstm_init_state(rp, 2, XD)
    tst = TS.mlstm_init_state(tp, 2, XD)
    assert _structure(tst) == _structure(rst)
    assert torch.isneginf(tst["m"]).all()
    step = jax.jit(RS.mlstm_decode)
    for _ in range(3):
        jx, tx = _inputs(rng, (2, 1, XD), jdt, tdt)
        want, rst = step(rp, jx, rst)
        got, tst = TS.mlstm_decode(tp, tx, tst)
        assert _rel(got, want) < bound
    for k in ("C", "nvec", "m"):
        assert _rel(tst[k], rst[k]) < bound, k


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_slstm_twin(rng, dtype_name):
    jdt, tdt, bound = DTYPES[dtype_name]
    rp, tp = _params("slstm", dtype_name)
    jx, tx = _inputs(rng, (2, 16, XD), jdt, tdt)
    want = _strict(RS.slstm, rp, jx)
    got = TS.slstm(tp, tx)
    assert got.dtype == tdt
    assert _rel(got, want) < bound


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_slstm_cell_and_decode_twin(rng, dtype_name):
    jdt, tdt, bound = DTYPES[dtype_name]
    rp, tp = _params("slstm", dtype_name)
    rst = RS.slstm_init_state(rp, 2, XD)
    tst = TS.slstm_init_state(tp, 2, XD)
    assert _structure(tst) == _structure(rst)
    assert torch.isneginf(tst["m"]).all()
    # the cell on a pre-projected input
    jw, tw = _inputs(rng, (2, 4 * XD), jdt, tdt)
    want = jax.jit(RS._slstm_cell)(rp, rst, jw)
    got = TS._slstm_cell(tp, tst, tw)
    for k in ("c", "nvec", "h", "m"):
        assert _rel(got[k], want[k]) < bound, k
    step = jax.jit(RS.slstm_decode)
    for _ in range(3):
        jx, tx = _inputs(rng, (2, 1, XD), jdt, tdt)
        want, rst = step(rp, jx, rst)
        got, tst = TS.slstm_decode(tp, tx, tst)
        assert got.dtype == tdt
        assert _rel(got, want) < bound
    for k in ("c", "nvec", "h", "m"):
        assert _rel(tst[k], rst[k]) < bound, k


def test_ssd_chunked_and_mlstm_gradients_finite(rng):
    """Masks go in before ``exp``: the masked region is exp(-inf) = 0, so
    the backward pass meets no 0 * inf. Gradients are finite and equal to
    the reference's (float32)."""
    b, l, h, p, n = 2, 16, 4, 8, 6
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)) + 2)).astype(
        np.float32)
    A = -np.exp(rng.standard_normal(h) + 2).astype(np.float32)  # steep decay
    B = rng.standard_normal((b, l, n)).astype(np.float32)
    C = rng.standard_normal((b, l, n)).astype(np.float32)

    def ref_loss(*a):
        y, s = RS._ssd_chunked(*a, chunk=8)
        return jnp.sum(y ** 2) + jnp.sum(s)

    want = _strict(jax.grad(ref_loss, argnums=(0, 1, 2, 3, 4)),
                   *[jnp.asarray(a) for a in (x, dt, A, B, C)])
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, dt, A, B, C)]
    y, s = TS._ssd_chunked(*ts, chunk=8)
    (torch.sum(y ** 2) + torch.sum(s)).backward()
    for t, w in zip(ts, want):
        assert torch.isfinite(t.grad).all()
        assert _rel(t.grad, w) < 1e-4

    rp, tp = _params("mlstm", "float32")
    xs = rng.standard_normal((2, 16, XD)).astype(np.float32)
    want = _strict(jax.grad(lambda pp, xx: jnp.sum(RS.mlstm(pp, xx) ** 2),
                            argnums=(0, 1)), rp, jnp.asarray(xs))
    tp = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
    tx = torch.from_numpy(xs).requires_grad_(True)
    torch.sum(TS.mlstm(tp, tx) ** 2).backward()
    assert torch.isfinite(tx.grad).all()
    assert _rel(tx.grad, want[1]) < 1e-4
    for path, w in jax.tree_util.tree_leaves_with_path(want[0]):
        g = functools.reduce(lambda t, k: t[k.key], path, tp).grad
        assert torch.isfinite(g).all(), path
        assert _rel(g, w) < 1e-4, path
    assert math.isfinite(float(torch.sum(tx.grad)))
