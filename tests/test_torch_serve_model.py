"""The port's model-serving launcher (``repro_torch.launch.serve_model``)
against the reference's (``repro.launch.serve_model``) on the CPU.

* ``main`` runs every smoke arch with ``--device cpu``, and raises
  without a card unless asked for the CPU.
* With the reference's float32 smoke weights carried across, the port's
  prefill + greedy loop (``generate``) gives the same ids as the
  reference's loop over ``repro.models.model.decode_step``.
* Greedy decode argmaxes over the padded-vocab columns in both packages
  (ROADMAP.md C5): ids at or above ``vocab_size`` come out of both alike.
* Every full config (the SSM families' two-level and pair stacks
  included) builds on the meta device with the leaf shapes and dtypes of
  ``jax.eval_shape`` of the reference's ``init_params``, and the same
  parameter counts.
* An unknown family raises ``ValueError``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import model as RM
from repro_torch import configs as TC
from repro_torch.launch import serve as serve_shim
from repro_torch.launch import serve_model
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy

PORTED = list(TC.ARCHS)


@pytest.mark.parametrize("arch", PORTED)
def test_main_runs_each_ported_smoke_arch(arch, capsys):
    gen = serve_model.main(["--arch", arch, "--smoke", "--device", "cpu",
                            "--batch", "2", "--prompt-len", "5", "--gen", "4"])
    assert gen.shape == (2, 4) and gen.dtype == np.int32
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=") and "tok/s" in out[1]
    assert out[3] == f"generated ids (first seq): {gen[0].tolist()}"


def test_main_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_model.main(["--arch", "qwen2_1p5b", "--smoke"])
    assert serve_shim.main is serve_model.main


def _reference_loop(rcfg, rparams, prompt, G, rng):
    """``repro.launch.serve_model.main``'s loop on given weights."""
    B, P = prompt.shape
    decode = jax.jit(lambda p, c, b, pos: RM.decode_step(p, rcfg, c, b, pos),
                     donate_argnums=(1,))
    cache = RM.init_cache(rcfg, B, P + G)
    if rcfg.family == "audio":
        def mk(tok):
            return {"embeds": jnp.asarray(
                rng.standard_normal((B, 1, rcfg.d_model)), rcfg.dtype)}
    else:
        def mk(tok):
            return {"tokens": jnp.asarray(tok[:, None], jnp.int32)}
    logits = None
    for i in range(P):
        logits, cache = decode(rparams, cache, mk(prompt[:, i]),
                               jnp.asarray(i, jnp.int32))
    outs = []
    for i in range(G):
        nxt = jnp.argmax(logits[:, -1].reshape(B, -1), axis=-1).astype(
            jnp.int32)
        outs.append(np.asarray(nxt))
        logits, cache = decode(rparams, cache, mk(np.asarray(nxt)),
                               jnp.asarray(P + i, jnp.int32))
    return np.stack(outs, axis=1)


def _carried(arch, scale_padded_head=0.0):
    rcfg = dataclasses.replace(RC.get_smoke_config(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(TC.get_smoke_config(arch), dtype=torch.float32)
    tree = jax.tree.map(np.array, jax.jit(
        lambda k: RM.init_params(rcfg, k))(jax.random.PRNGKey(0)))
    if scale_padded_head:
        head = tree["embed"] if rcfg.tie_embeddings else tree["lm_head"]
        head[rcfg.vocab_size:] *= scale_padded_head
    rparams = jax.tree.map(jnp.asarray, tree)
    return rcfg, tcfg, rparams, params_from_numpy(tcfg, tree, "cpu")


def _both_loops(arch, scale_padded_head=0.0, B=4, P=32, G=16, seed=0):
    rcfg, tcfg, rparams, tparams = _carried(arch, scale_padded_head)
    prompt = np.random.default_rng(seed).integers(
        0, rcfg.vocab_size, (B, P)).astype(np.int32)
    want = _reference_loop(rcfg, rparams, prompt, G,
                           np.random.default_rng(seed))
    got, logits, _ = serve_model.generate(
        tparams, tcfg, TM.init_cache(tcfg, B, P + G, "cpu"), prompt, G,
        np.random.default_rng(seed))
    assert not torch.isnan(logits).any()
    return rcfg, got, want


@pytest.mark.parametrize("arch", ["qwen2_1p5b", "granite_moe_3b_a800m",
                                  "zamba2_1p2b", "xlstm_350m"])
def test_generated_ids_equal_the_reference(arch):
    _, got, want = _both_loops(arch)
    np.testing.assert_array_equal(got, want)


def test_greedy_decode_argmaxes_over_padded_vocab_columns():
    """ROADMAP.md C5, kept as the reference has it: granite's vocab 130 pads
    to 144 and the padded head rows are random (here scaled up 4x), so
    greedy ids reach past ``vocab_size`` in both packages alike."""
    rcfg, got, want = _both_loops("granite_moe_3b_a800m", 4.0, B=2, P=4, G=8)
    assert rcfg.padded_vocab == 144 and rcfg.vocab_size == 130
    np.testing.assert_array_equal(got, want)
    assert (got >= rcfg.vocab_size).any() and (got < rcfg.padded_vocab).all()


def _dtype_name(dt):
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("arch", PORTED)
def test_full_config_meta_params_match_reference_shapes(arch):
    rcfg, tcfg = RC.get_config(arch), TC.get_config(arch)
    want = jax.eval_shape(lambda k: RM.init_params(rcfg, k),
                          jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(p, simple=True, separator="."):
            (tuple(s.shape), str(s.dtype))
            for p, s in jax.tree_util.tree_leaves_with_path(want)}
    params = TM.init_params(tcfg, device="meta")
    got = {name: (tuple(p.shape), _dtype_name(p.dtype))
           for name, p in params.named_parameters()}
    assert got == want
    n_ref = sum(int(np.prod(s)) for s, _ in want.values())
    assert TM.param_count(params) == n_ref > 1e8
    moe = [n for n in want if ".moe.w_" in n]
    expert = sum(int(np.prod(want[n][0])) for n in moe)
    if tcfg.family == "moe":
        assert TM.active_param_count(tcfg, params) == \
            n_ref - expert + int(expert * tcfg.top_k / tcfg.n_experts)
    else:
        assert TM.active_param_count(tcfg, params) == n_ref


def test_unknown_family_raises_value_error():
    cfg = dataclasses.replace(TC.get_smoke_config("qwen2_1p5b"),
                              family="rnn")
    for call in (lambda: TM.init_params(cfg, device="cpu"),
                 lambda: TM.init_cache(cfg, 2, 8, "cpu"),
                 lambda: TM.forward(None, cfg, {}),
                 lambda: TM.decode_step(None, cfg, {}, {}, 0)):
        with pytest.raises(ValueError, match="rnn"):
            call()
