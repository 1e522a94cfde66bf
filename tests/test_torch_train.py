"""Twins of ``repro.train`` and ``repro.distributed.compression`` in the
port (``repro_torch.train``, ``repro_torch.distributed.compression``) on
the CPU.

The reference's smoke parameters are carried across
(``models.convert.params_from_numpy``) and the same seeded numpy batches
go through both packages' train steps. Tolerances:
  * ``lr_at``: within 1e-6 relative (float32 arithmetic in both);
  * ``adamw_update`` on the same leaves: parameters and moments within
    rtol 1e-6 (one float32 update; the clipping norm's sum order differs);
  * ``make_train_step``, two float32 steps per LM smoke arch, ``grad_accum``
    1 and 2: the losses within rtol 2e-5, and every parameter within
    atol 2e-5 of the reference's after the steps (the gradients agree to
    float32 rounding; AdamW's first steps move each entry by about ``lr``
    = 1e-3 in the direction of its gradient's sign, so a gradient entry
    near zero may take another sign: at most a few entries, counted);
  * ``loss_fn``'s gradients per LM smoke arch, float32, leaf by leaf: each
    leaf's worst entry within 1e-4 of that leaf's largest gradient (the
    worst leaf of any arch sits near 9e-6: xLSTM's ``slstm/w_down``);
  * compression: ``topk_index`` positions and values equal, ``int8_centered``
    within one quantization step, the residuals alike; wire bytes equal;
  * checkpoints: written by one package and restored by the other, leaf
    for leaf bit-identical (float32 and bfloat16 leaves).
The port's own checks (the loss falls on the ten smoke archs, keep-N, the
tree mismatch, NaN quarantine, stragglers, remat) mirror
``tests/test_models.py`` and ``tests/test_train_data.py``.
"""
import dataclasses
import functools
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.train as RT
import repro_torch.train as TT
from repro import configs as RC
from repro.distributed import compression as RCOMP
from repro.models import model as RM
from repro.train.step import TrainState as RState
from repro_torch import configs as TC
from repro_torch.distributed import compression as TCOMP
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import pytree
from repro_torch.train.step import init_train_state, state_for

from chip_smoke import _tensor_bits
from torch_twins import CPU

LM_ARCHS = [a for a in TC.ARCHS
            if TC.get_smoke_config(a).family not in ("audio", "vlm")]


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _batch(cfg, rng, B=2, S=16):
    """The reference test's draws (``tests/test_models.py::_batch``) as
    numpy."""
    if cfg.family == "audio":
        return {"embeds": rng.standard_normal((B, S, cfg.d_model))
                .astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size,
                                       (B, S, cfg.n_codebooks))
                .astype(np.int32)}
    if cfg.family == "vlm":
        ni = cfg.n_image_tokens
        return {"tokens": rng.integers(0, cfg.vocab_size, (B, S - ni))
                .astype(np.int32),
                "patch_embeds": rng.standard_normal((B, ni, cfg.d_model))
                .astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (B, S))
                .astype(np.int32)}
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return {"tokens": tok, "labels": tok.copy()}


@functools.lru_cache(maxsize=None)
def _ref_tree(arch, dtype_name="float32"):
    rcfg = dataclasses.replace(RC.get_smoke_config(arch),
                               dtype=getattr(jnp, dtype_name))
    return jax.tree.map(np.asarray, jax.jit(
        lambda k: RM.init_params(rcfg, k))(jax.random.PRNGKey(0)))


def _configs(arch, dtype_name="float32"):
    rcfg = dataclasses.replace(RC.get_smoke_config(arch),
                               dtype=getattr(jnp, dtype_name))
    tcfg = dataclasses.replace(TC.get_smoke_config(arch),
                               dtype=getattr(torch, dtype_name))
    return rcfg, tcfg


def _states(arch, rt, tt, dtype_name="float32"):
    """The reference's init state and the port's, on the same parameters."""
    rcfg, tcfg = _configs(arch, dtype_name)
    tree = _ref_tree(arch, dtype_name)
    rparams = jax.tree.map(jnp.asarray, tree)
    rstate = RState(params=rparams,
                    opt_state=RT.adamw_init(rparams, rt.opt_state_dtype),
                    step=jnp.zeros((), jnp.int32))
    if rt.grad_compression != "none":
        rstate.comp_state = RCOMP.init_state(rparams)
    tparams = params_from_numpy(tcfg, tree, CPU).requires_grad_(True)
    return rcfg, tcfg, rstate, state_for(tparams, tt)


def _train_cfgs(**kw):
    adamw = dict(lr=1e-3, warmup_steps=2, total_steps=40)
    return (RT.TrainConfig(adamw=RT.AdamWConfig(**adamw), **kw),
            TT.TrainConfig(adamw=TT.AdamWConfig(**adamw), **kw))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [
    dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1),
    dict(lr=3e-4, warmup_steps=0, total_steps=7, min_lr_frac=0.0),
    dict(lr=2e-3, warmup_steps=2, total_steps=40)])
def test_lr_at_twin(cfg):
    rc, tc = RT.AdamWConfig(**cfg), TT.AdamWConfig(**cfg)
    for step in (0, 1, 2, 5, 10, 39, 40, 55, 100, 250):
        want = float(RT.lr_at(rc, jnp.asarray(step)))
        got = TT.lr_at(tc, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-6 * max(abs(want), 1e-30), step
    assert float(TT.lr_at(tc, 0)) == float(RT.lr_at(rc, jnp.asarray(0)))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_twin(rng, state_dtype):
    tree = {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "blk": {"b": rng.standard_normal(5).astype(np.float32),
                    "m": rng.standard_normal((3, 4, 2)).astype(np.float32)}}
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=10, grad_clip=0.5)
    rc, tc = RT.AdamWConfig(**cfg), TT.AdamWConfig(**cfg)
    rp = jax.tree.map(jnp.asarray, tree)
    tp = jax.tree.map(_t, tree)
    ro = RT.adamw_init(rp, getattr(jnp, state_dtype))
    to = TT.adamw_init(tp, getattr(torch, state_dtype))
    for step in range(3):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape)
                         .astype(np.float32), tree)
        rp, ro, rm = RT.adamw_update(rc, rp, jax.tree.map(jnp.asarray, g),
                                     ro, jnp.asarray(step, jnp.int32))
        tp2, to2, tm = TT.adamw_update(tc, tp, jax.tree.map(_t, g), to,
                                       torch.tensor(step, dtype=torch.int32))
        assert tp2 is tp and to2 is to  # in place
        assert abs(float(tm["grad_norm"]) - float(rm["grad_norm"])) <= \
            1e-6 * float(rm["grad_norm"])
        assert abs(float(tm["lr"]) - float(rm["lr"])) <= 1e-6 * cfg["lr"]
    for name, got, want in (("params", tp, rp), ("mu", to["mu"], ro["mu"]),
                            ("nu", to["nu"], ro["nu"])):
        for (path, leaf), w in zip(pytree.named_leaves(got),
                                   jax.tree.leaves(want)):
            assert str(leaf.dtype).endswith(str(w.dtype)), (name, path)
            rtol = 1e-6 if leaf.dtype == torch.float32 else 2.0 ** -8
            np.testing.assert_allclose(_host(leaf), _host(w), rtol=rtol,
                                       atol=1e-7, err_msg=f"{name} {path}")
    # a false ``apply`` keeps every leaf
    before = [x.clone() for x in pytree.leaves(tp) + pytree.leaves(to)]
    TT.adamw_update(tc, tp, jax.tree.map(_t, g), to, torch.tensor(3),
                    apply=torch.tensor(False))
    after = pytree.leaves(tp) + pytree.leaves(to)
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_global_norm_and_weight_decay_mask(rng):
    tree = {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal(3).astype(np.float32)}
    want = float(RT.optimizer.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = float(TT.optimizer.global_norm(jax.tree.map(_t, tree)))
    assert abs(got - want) <= 1e-6 * want
    # zero gradients: only the decay moves, and only the matrix
    tc = TT.AdamWConfig(lr=0.1, warmup_steps=0, weight_decay=0.5)
    tp = jax.tree.map(_t, tree)
    zeros = jax.tree.map(torch.zeros_like, tp)
    TT.adamw_update(tc, tp, zeros, TT.adamw_init(tp), torch.tensor(5))
    assert torch.equal(tp["b"], _t(tree["b"]))
    assert not torch.equal(tp["w"], _t(tree["w"]))


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_step_twin(arch, accum, rng):
    rt, tt = _train_cfgs(grad_accum=accum)
    rcfg, tcfg, rstate, tstate = _states(arch, rt, tt)
    rstep = jax.jit(RT.make_train_step(rcfg, rt))
    tstep = TT.make_train_step(tcfg, tt)
    B = 4 if accum > 1 else 2
    for _ in range(2):
        batch = _batch(rcfg, rng, B=B)
        rstate, rm = rstep(rstate, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tstep(tstate, {k: _t(v) for k, v in batch.items()})
        want = float(rm["loss"])
        assert abs(float(tm["loss"]) - want) <= 2e-5 * abs(want), arch
        assert abs(float(tm["grad_norm"]) - float(rm["grad_norm"])) <= \
            1e-4 * float(rm["grad_norm"])
    assert int(tstate.step) == int(rstate.step) == 2
    flipped = 0
    for (path, g), w in zip(pytree.named_leaves(tstate.params),
                            jax.tree.leaves(rstate.params)):
        d = np.abs(_host(g) - _host(w))
        flipped += int((d > 2e-5).sum())
        assert d.max() < 5e-3, (arch, path)  # at most 2 lr-sized moves
    n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(rstate.params))
    assert flipped <= max(4, n // 10_000), (arch, flipped, n)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_gradients_twin(arch, rng):
    """``torch.autograd.grad`` of the port's ``loss_fn`` against
    ``jax.grad`` of the reference's, leaf by leaf, float32, on the same
    parameters and batch. Each leaf's worst entry is held to 1e-4 of that
    leaf's largest gradient, so a mis-scaled leaf shows however small."""
    rcfg, tcfg = _configs(arch)
    tree = _ref_tree(arch)
    batch = _batch(rcfg, rng)
    rloss, rgrads = jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(p, rcfg, b)))(
            jax.tree.map(jnp.asarray, tree),
            jax.tree.map(jnp.asarray, batch))
    tparams = params_from_numpy(tcfg, tree, CPU).requires_grad_(True)
    named = pytree.named_leaves(tparams)
    tloss = TM.loss_fn(tparams, tcfg, {k: _t(v) for k, v in batch.items()})
    tgrads = torch.autograd.grad(tloss, [x for _, x in named],
                                 allow_unused=True)
    tloss = float(tloss.detach())
    assert abs(tloss - float(rloss)) <= 2e-5 * abs(float(rloss))
    rleaves = jax.tree.leaves(rgrads)
    assert len(rleaves) == len(named)
    for (path, _), g, w in zip(named, tgrads, rleaves):
        w = _host(w)
        g = np.zeros_like(w) if g is None else _host(g)
        assert g.shape == w.shape, (arch, path)
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= 1e-4 * scale + 1e-12, (arch, path, err, scale)


def test_train_step_skips_a_non_finite_loss(rng):
    _, tt = _train_cfgs()
    cfg = dataclasses.replace(TC.get_smoke_config("smollm_360m"),
                              dtype=torch.float32)
    state = init_train_state(cfg, tt, torch.Generator().manual_seed(0), CPU)
    step = TT.make_train_step(cfg, tt)
    bad = {k: _t(v) for k, v in _batch(cfg, rng).items()}
    with torch.no_grad():
        state.params["embed"][bad["tokens"][0, 0]] = float("nan")
    before = [x.detach().clone() for x in pytree.leaves(state)]
    state, m = step(state, bad)
    assert not torch.isfinite(m["loss"])
    assert int(state.step) == 0
    for a, b in zip(before, pytree.leaves(state)):
        torch.testing.assert_close(b.detach(), a, rtol=0, atol=0,
                                   equal_nan=True)


@pytest.mark.parametrize("arch", list(TC.ARCHS))
def test_smoke_train_step_reduces_loss(arch, rng):
    """``tests/test_models.py::test_smoke_train_step_reduces_loss`` on the
    port, every smoke arch, its optimizer settings: the loss on one batch
    falls within 4 steps (float32, to keep the CPU run short; the
    reference's test takes 15 bfloat16 steps)."""
    tcfg = dataclasses.replace(TC.get_smoke_config(arch),
                               dtype=torch.float32)
    tt = TT.TrainConfig(adamw=TT.AdamWConfig(lr=2e-3, warmup_steps=2,
                                             total_steps=40))
    state = init_train_state(tcfg, tt, torch.Generator().manual_seed(0), CPU)
    step = TT.make_train_step(tcfg, tt)
    batch = {k: _t(v) for k, v in _batch(tcfg, rng).items()}
    losses = []
    for _ in range(4):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], f"{arch}: {losses[:3]}...{losses[-3:]}"


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["smollm_360m", "granite_moe_3b_a800m",
                                  "zamba2_1p2b", "xlstm_350m"])
def test_remat_gives_the_same_gradients(arch, remat, rng):
    cfg = dataclasses.replace(TC.get_smoke_config(arch), dtype=torch.float32)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    params.requires_grad_(True)
    batch = {k: _t(v) for k, v in _batch(cfg, rng).items()}

    def grads(c):
        loss = TM.loss_fn(params, c, batch)
        return loss, torch.autograd.grad(loss, list(params.parameters()))

    loss0, g0 = grads(cfg)
    loss1, g1 = grads(dataclasses.replace(cfg, remat=remat))
    assert torch.equal(loss0, loss1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_layer_views_track_trainable_leaves():
    cfg = dataclasses.replace(TC.get_smoke_config("qwen2_1p5b"),
                              dtype=torch.float32)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    layers = params["layers"]
    assert layers.layer(1) is layers.layer(1)  # frozen: cached views
    params.requires_grad_(True)
    v1, v2 = layers.layer(1), layers.layer(1)
    assert v1 is not v2 and v1["attn"]["wq"].requires_grad  # fresh a call
    with torch.no_grad():
        cached = layers.layer(1)
        assert cached is layers.layer(1)
        params["layers"]["attn"]["wq"].add_(1.0)
    assert torch.equal(cached["attn"]["wq"], layers["attn"]["wq"][1])
    assert torch.equal(layers.layer(1)["attn"]["wq"],
                       params["layers"]["attn"]["wq"][1])


def test_eval_step_equals_loss_fn(rng):
    cfg = dataclasses.replace(TC.get_smoke_config("smollm_360m"),
                              dtype=torch.float32)
    _, tt = _train_cfgs()
    state = init_train_state(cfg, tt, torch.Generator().manual_seed(0), CPU)
    batch = {k: _t(v) for k, v in _batch(cfg, rng).items()}
    got = TT.make_eval_step(cfg)(state.params, batch)
    assert not got.requires_grad
    assert torch.equal(got, TM.loss_fn(state.params, cfg, batch).detach())


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["topk_index", "int8_centered"])
def test_compress_decompress_twin(rng, kind):
    tree = {"w": rng.standard_normal((40, 30)).astype(np.float32),
            "e": rng.standard_normal((3, 20, 10)).astype(np.float32),
            "b": rng.standard_normal(30).astype(np.float32)}
    res = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.1)
                       .astype(np.float32), tree)
    want, wst = RCOMP.compress_decompress(
        jax.tree.map(jnp.asarray, tree),
        {"residual": jax.tree.map(jnp.asarray, res)}, kind, topk_frac=0.05)
    got, gst = TCOMP.compress_decompress(
        jax.tree.map(_t, tree), {"residual": jax.tree.map(_t, res)}, kind,
        topk_frac=0.05)
    for k in tree:
        w, g = np.asarray(want[k]), got[k].numpy()
        wr, gr = np.asarray(wst["residual"][k]), gst["residual"][k].numpy()
        if kind == "topk_index" or tree[k].ndim < 2:
            np.testing.assert_array_equal(g, w, err_msg=k)
            np.testing.assert_array_equal(gr, wr, err_msg=k)
        else:
            g32 = tree[k] + res[k]
            step = (g32.max() - g32.min()) / 254.0
            np.testing.assert_allclose(g, w, rtol=0, atol=step * 1.001)
            np.testing.assert_allclose(gr, wr, rtol=0, atol=step * 1.001)
    if kind == "topk_index":
        assert int((got["w"] != 0).sum()) == 60  # 5% of 1,200


def test_estimated_wire_bytes_twin():
    tree = _ref_tree("smollm_360m")
    for kind, frac in (("none", 0.0), ("topk_index", 0.01),
                       ("int8_centered", 0.0), ("topk_index", 0.25)):
        assert TCOMP.estimated_wire_bytes(jax.tree.map(_t, tree), kind,
                                          frac) == \
            RCOMP.estimated_wire_bytes(tree, kind, frac)
    small = {"w": torch.zeros(1000, 100), "b": torch.zeros(100)}
    dense = TCOMP.estimated_wire_bytes(small, "none", 0)
    assert TCOMP.estimated_wire_bytes(small, "topk_index", 0.01) < dense / 10
    assert TCOMP.estimated_wire_bytes(small, "int8_centered", 0) < dense / 3


@pytest.mark.parametrize("kind", ["topk_index", "int8_centered"])
def test_train_step_with_compression_twin(rng, kind):
    rt, tt = _train_cfgs(grad_compression=kind, topk_frac=0.25)
    rcfg, tcfg, rstate, tstate = _states("smollm_360m", rt, tt)
    rstep = jax.jit(RT.make_train_step(rcfg, rt))
    tstep = TT.make_train_step(tcfg, tt)
    batch = _batch(rcfg, rng, B=4)
    losses = []
    for _ in range(8):
        rstate, rm = rstep(rstate, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tstep(tstate, {k: _t(v) for k, v in batch.items()})
        losses.append(float(tm["loss"]))
        assert abs(float(tm["loss"]) - float(rm["loss"])) <= \
            1e-3 * abs(float(rm["loss"]))
    assert losses[-1] < losses[0] - 0.3, (kind, losses)
    names = [n for n, _ in pytree.named_leaves(tstate)]
    assert any(n.startswith(".comp_state/residual/") for n in names)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _random_opt(tree, rng, dtype):
    return {"mu": jax.tree.map(lambda a: rng.standard_normal(a.shape)
                               .astype(np.float32), tree),
            "nu": jax.tree.map(lambda a: rng.random(a.shape)
                               .astype(np.float32), tree)}


def _both_states(rng, dtype_name):
    """A reference and a port ``TrainState`` with the same values: the
    carried smoke parameters (bfloat16 leaves when asked), random moments
    and residuals, step 5."""
    rt, tt = _train_cfgs(grad_compression="int8_centered")
    rcfg, tcfg, rstate, tstate = _states("smollm_360m", rt, tt, dtype_name)
    opt = _random_opt(_ref_tree("smollm_360m", dtype_name), rng, dtype_name)
    res = jax.tree.map(lambda a: rng.standard_normal(a.shape)
                       .astype(np.float32), _ref_tree("smollm_360m"))
    rstate = dataclasses.replace(
        rstate, opt_state=jax.tree.map(jnp.asarray, opt),
        step=jnp.asarray(5, jnp.int32),
        comp_state={"residual": jax.tree.map(jnp.asarray, res)})
    tstate = dataclasses.replace(
        tstate, opt_state=jax.tree.map(_t, opt),
        step=torch.tensor(5, dtype=torch.int32),
        comp_state={"residual": jax.tree.map(_t, res)})
    return rstate, tstate


def _assert_bits_equal(tstate, rstate):
    tl = pytree.named_leaves(tstate)
    rl = jax.tree.leaves(rstate)
    assert len(tl) == len(rl)
    for (name, t), r in zip(tl, rl):
        r = np.asarray(r)
        assert str(t.dtype).replace("torch.", "") == str(r.dtype), name
        if r.dtype.name == "bfloat16":
            np.testing.assert_array_equal(
                t.detach().view(torch.int16).numpy(), r.view(np.int16),
                err_msg=name)
        else:
            np.testing.assert_array_equal(t.detach().numpy(), r,
                                          err_msg=name)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_checkpoint_restores_across_packages(tmp_path, rng, writer,
                                             dtype_name):
    rstate, tstate = _both_states(rng, dtype_name)
    if writer == "repro":
        RT.CheckpointManager(str(tmp_path)).save(5, rstate, blocking=True,
                                                 extra={"data_cursor": 3})
    else:
        TT.CheckpointManager(str(tmp_path)).save(5, tstate, blocking=True,
                                                 extra={"data_cursor": 3})
    meta = json.loads((tmp_path / "step_0000000005" / "manifest.json")
                      .read_text())
    assert meta["names"] == [n for n, _ in pytree.named_leaves(tstate)]
    assert meta["extra"] == {"data_cursor": 3}
    # the port restores into its own structure
    like = dataclasses.replace(
        pytree.map_tree(lambda t: torch.empty_like(t, device="meta"), tstate),
        params=tstate.params)
    got, gmeta = TT.CheckpointManager(str(tmp_path)).restore(like)
    assert gmeta["step"] == 5 and isinstance(got.params, TM.ParamTree)
    assert all(p.requires_grad for p in got.params.parameters())
    _assert_bits_equal(got, rstate)
    # and the reference into its own
    rlike = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                         rstate)
    want, _ = RT.CheckpointManager(str(tmp_path)).restore(rlike)
    _assert_bits_equal(tstate, want)


def test_checkpoint_keep_n_async_and_mismatch(tmp_path):
    _, tt = _train_cfgs()
    cfg = TC.get_smoke_config("smollm_360m")
    state = init_train_state(cfg, tt, torch.Generator().manual_seed(0), CPU)
    ck = TT.CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        ck.save(s, state)  # async: each save waits on the previous one
    ck.wait()
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    assert not [d for d in os.listdir(tmp_path) if d.startswith("tmp.")]
    restored, meta = ck.restore(state)
    assert meta["step"] == 3
    assert all(torch.equal(a, b) for a, b in
               zip(pytree.leaves(state), pytree.leaves(restored)))
    with pytest.raises(ValueError, match="tree mismatch"):
        ck.restore({"something": torch.zeros(2)})
    assert TT.CheckpointManager(str(tmp_path / "empty")).restore(state) \
        is None


def test_async_checkpoint_holds_the_state_at_save_time(tmp_path, rng,
                                                      monkeypatch):
    """A non-blocking save of a CPU state, whose writer is held until the
    next step has updated that state in place, restores the state as it
    was when ``save`` was called, bit for bit (bfloat16 params, float32
    moments, the step)."""
    tt = TT.TrainConfig(adamw=TT.AdamWConfig(lr=1e-3, warmup_steps=0,
                                             total_steps=40))
    cfg = TC.get_smoke_config("smollm_360m")
    state = init_train_state(cfg, tt, torch.Generator().manual_seed(0), CPU)
    step = TT.make_train_step(cfg, tt)
    batch = {k: _t(v) for k, v in _batch(cfg, rng).items()}
    state, _ = step(state, batch)
    at_save = [x.detach().clone() for x in pytree.leaves(state)]
    go, savez = threading.Event(), np.savez

    def held_savez(*args, **kwargs):
        assert go.wait(60)
        return savez(*args, **kwargs)

    monkeypatch.setattr(np, "savez", held_savez)
    ck = TT.CheckpointManager(str(tmp_path))
    ck.save(1, state)
    state, _ = step(state, batch)  # in place, while the writer waits
    go.set()
    ck.wait()
    assert int(state.step) == 2
    assert not all(torch.equal(a, b) for a, b in
                   zip(at_save, pytree.leaves(state)))
    restored, meta = ck.restore(state)
    assert meta["step"] == 1
    for a, b in zip(at_save, pytree.leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(
            _tensor_bits(a), _tensor_bits(b))


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained():
    """``tests/test_train_data.py``'s ``trained`` fixture on the port:
    smollm smoke, grad_accum 2, 20 steps on one batch."""
    cfg = TC.get_smoke_config("smollm_360m")
    tt = TT.TrainConfig(adamw=TT.AdamWConfig(lr=1e-3, warmup_steps=2,
                                             total_steps=60), grad_accum=2)
    state = init_train_state(cfg, tt, torch.Generator().manual_seed(0), CPU)
    step = TT.make_train_step(cfg, tt)
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 16))
    batch = {"tokens": _t(tok.astype(np.int32)),
             "labels": _t(tok.astype(np.int32))}
    losses = []
    for _ in range(20):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return cfg, tt, state, step, batch, losses


def test_memorization(trained):
    *_, losses = trained
    assert losses[-1] < losses[0] - 0.5


def test_loop_nan_quarantine_and_reload(trained, tmp_path):
    cfg, tt, state, step, batch, _ = trained
    calls = {"n": 0}

    def data():
        while True:
            calls["n"] += 1
            yield ("POISON" if calls["n"] in (3, 4) else "OK"), batch

    def wrapped(st, tagged):
        tag, b = tagged
        s2, m = step(st, b)
        if tag == "POISON":
            m = dict(m)
            m["loss"] = torch.tensor(float("nan"))
        return s2, m

    start = int(state.step)
    loop = TT.TrainLoop(wrapped, state, data(),
                        ckpt=TT.CheckpointManager(str(tmp_path)),
                        cfg=TT.LoopConfig(total_steps=start + 10,
                                          checkpoint_every=3, max_strikes=2))
    stats = loop.run()
    assert stats.steps_skipped == 2
    assert stats.reloads == 1
    assert stats.steps_run == 8


def test_loop_straggler_detection(trained):
    cfg, tt, state, step, batch, _ = trained
    calls = {"n": 0}

    def data():
        while True:
            calls["n"] += 1
            yield calls["n"], batch

    def slow_step(st, tagged):
        i, b = tagged
        if i == 15:
            # injected straggler: 2 s, not the reference test's 1 s, as an
            # eager CPU step on a loaded host varies far more than a jitted
            # one and would widen the EMA's spread
            time.sleep(2.0)
        return step(st, b)

    loop = TT.TrainLoop(slow_step, state, data(), ckpt=None,
                        cfg=TT.LoopConfig(total_steps=int(state.step) + 20,
                                          straggler_z=3.0,
                                          straggler_warmup=3))
    stats = loop.run()
    assert len(stats.stragglers) >= 1
    assert max(s[1] for s in stats.stragglers) >= 2.0
