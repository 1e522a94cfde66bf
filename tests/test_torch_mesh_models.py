"""Twins of the reference's mesh dataflow in the port, on the CPU.

One gloo world of four (``tests/torch_mesh_world.py``: four processes, a
file store, a (2, 2) ("data", "model") mesh) runs every scenario once a
file; one reference subprocess on four forced host devices computes the
same on a (2, 2) jax mesh. Weights are drawn by the port and carried
across as numpy (``models.convert``); inputs are seeded numpy.
Tolerances (float32): ``max |port - reference| / max(1, max |reference|)``
below 1e-5; slots equal exactly.
  * (i) ``moe``'s expert-parallel branch (the reference's
    ``test_moe_ep_parity_8dev`` shapes: d 16, d_ff 32, 6 experts padded to
    8, top 2) at capacity factor 100 and 1.25 (drops): slots, y and aux
    against the reference's ``shard_map``; at 100 also against the port's
    one-device ``moe``; ``moe_route(..., n_sub=2)`` gives the same slots.
  * (ii) gradients of ``sum(y * cot) + aux`` against ``jax.grad``.
  * (iii) 5 tokens, which the model axis does not divide: the local
    branch under the mesh, equal to one device.
  * (iv) the reference's mini dry-run config (``tests/test_sharding_dist.py
    ::test_mini_dryrun_cell_8dev``, in float32) on DTensor params and
    batch: the loss and every gradient leaf against the reference's
    ``jit`` on its mesh and against the port on one device.
  * (vi) ``causal_attention``'s mesh branch (split by heads, with the kv
    heads or their head_dim split, and by query rows; biases on two):
    y and the gradient of every leaf and of x against ``jax.grad`` of the
    reference on its mesh and against one device; each rank's score
    blocks hold half the heads (or, split by rows, half the rows).
  * (vii) ``attention_decode`` on caches split over the sequence, the kv
    heads and head_dim, two steps in two ranks' stripes: y and both
    caches against one device.
  * (viii) the recurrent layers: ``mamba2`` split by the sequence (the
    conv's halo and the SSD's state carried across ranks) and by heads,
    ``mlstm`` by query rows (3 heads, and 2), ``slstm`` by the state's d:
    y and the gradient of every leaf and of x against ``jax.grad`` of the
    reference on its mesh and against one device; each rank's mLSTM
    score block holds half the rows; the decodes of Mamba2, mLSTM (``C``
    split by key rows, and by heads) and sLSTM on states laid out by
    ``cache_shardings``, two steps: y and every state leaf against one
    device.
  * (v) granite-moe (``moe_expert_axis``), zamba2 (``ssm_head_axis``) and
    smollm (``act_seq_axis``, ``vocab_axis``; 3 heads on a model axis of
    2, the attention split by query rows) smoke forwards on DTensors
    against one device at capacity factor 100
    (without drops the expert-parallel ranking in sub-groups keeps every
    entry, as one device does); granite at 1.25 against the reference's
    forward on its mesh; two granite ``decode_step`` calls on a DTensor
    cache against one device.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_mesh_world as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
CFS = (W.NO_DROP, 1.25)

_REF = """
import dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs
from repro.distributed import sharding as Sh
from repro.launch.mesh import activate_mesh, make_mesh_compat
from repro.models import layers as L, model as M
sys.path.insert(0, sys.argv[3])
import torch_mesh_world as W
assert len(jax.devices()) == 4
inp, res = dict(np.load(sys.argv[1])), {}
mesh = make_mesh_compat((2, 2), ("data", "model"))
axes = dict(group_axes=("data",), expert_axis="model")


def tree(prefix):
    return jax.tree.map(jnp.asarray, W.nest(inp, prefix))


def slots(p, x, top_k, cf, n_sub):
    # the reference moe's ranking lines, which it does not return
    b, l, _ = x.shape
    n_experts, e_pad = p["router"].shape[-1], p["w_gate"].shape[0]
    logits = jnp.einsum("bld,de->ble", x, p["router"].astype(x.dtype),
                        preferred_element_type=jnp.float32)
    _, idx = lax.top_k(jax.nn.softmax(logits, axis=-1), top_k)
    l_sub = l // n_sub
    cap = max(1, int(l_sub * top_k * cf / n_experts))
    flat = idx.reshape(b * n_sub, l_sub * top_k)
    rank = L._expert_rank(flat)
    return jnp.where(rank < cap, flat * cap + rank, e_pad * cap).reshape(
        b, l * top_k)


def flat(prefix, t):
    for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]:
        res[prefix + "/" + Sh._path_str(path)] = np.asarray(leaf)


def shardings(params, batch):
    sh = jax.tree.map(lambda s: NamedSharding(mesh, s),
                      Sh.param_shardings(params, mesh))
    bsh = jax.tree.map(lambda s: NamedSharding(mesh, s),
                       Sh.batch_shardings(batch, mesh,
                                          next(iter(batch.values())).shape[0]))
    return sh, bsh


p, x = tree("moe"), jnp.asarray(inp["x"])
for cf in (W.NO_DROP, 1.25):
    with activate_mesh(mesh):
        y, aux = jax.jit(lambda p_, x_: L.moe(p_, x_, W.MOE_TOP_K, cf,
                                              **axes))(p, x)
    res[f"y/{cf}"], res[f"aux/{cf}"] = np.asarray(y), np.asarray(aux)
    res[f"slot/{cf}"] = np.asarray(slots(p, x, W.MOE_TOP_K, cf, 2))


def val(p_, x_):
    y, aux = L.moe(p_, x_, W.MOE_TOP_K, W.NO_DROP, **axes)
    return jnp.sum(y * inp["cot"]) + aux


with activate_mesh(mesh):
    v, (gp, gx) = jax.jit(jax.value_and_grad(val, argnums=(0, 1)))(p, x)
res["ii/val"], res["ii/x"] = np.asarray(v), np.asarray(gx)
flat("ii", gp)

cfg = W.mini_config(dataclasses.replace(configs.get_smoke_config(
    "qwen2_1p5b"), dtype=jnp.float32))
params = tree("mini/params")
batch = {k: jnp.asarray(inp["mini/" + k]) for k in ("tokens", "labels")}
with activate_mesh(mesh):
    loss, g = jax.jit(jax.value_and_grad(lambda p_, b_: M.loss_fn(p_, cfg, b_)),
                      in_shardings=shardings(params, batch))(params, batch)
res["iv/loss"] = np.asarray(loss)
flat("iv/g", g)

pos = jnp.arange(W.ATTN_L, dtype=jnp.int32)
for name, (*_, q_chunk) in W.ATTN.items():
    p = tree(f"attn/{name}/p")
    x, cot = (jnp.asarray(inp[f"attn/{name}/{k}"]) for k in ("x", "cot"))

    def val(p_, x_):
        y = L.causal_attention(p_, x_, pos, 10000.0, q_chunk)
        return jnp.sum(y * cot), y

    sh = jax.tree.map(lambda s: NamedSharding(mesh, s),
                      Sh.param_shardings({"attn": p}, mesh))["attn"]
    with activate_mesh(mesh):
        (_, y), (gp, gx) = jax.jit(
            jax.value_and_grad(val, argnums=(0, 1), has_aux=True),
            in_shardings=(sh, NamedSharding(mesh, P("data", "model", None)))
        )(p, x)
    res[f"vi/{name}/y"], res[f"vi/{name}/gx"] = np.asarray(y), np.asarray(gx)
    flat(f"vi/{name}/g", gp)

from repro.models import ssm as RS
for name, (kind, _, head_axis) in W.REC.items():
    p = tree(f"rec/{name}/p")
    x, cot = (jnp.asarray(inp[f"rec/{name}/{k}"]) for k in ("x", "cot"))
    if kind == "mamba2":
        f = lambda p_, x_: RS.mamba2(p_, x_, W.REC_CHUNK, ("data",), head_axis)
    else:
        f = getattr(RS, kind)

    def val(p_, x_):
        y = f(p_, x_)
        return jnp.sum(y * cot), y

    prefix = "mamba" if kind == "mamba2" else kind
    sh = jax.tree.map(lambda s: NamedSharding(mesh, s),
                      Sh.param_shardings({prefix: p}, mesh))[prefix]
    with activate_mesh(mesh):
        (_, y), (gp, gx) = jax.jit(
            jax.value_and_grad(val, argnums=(0, 1), has_aux=True),
            in_shardings=(sh, NamedSharding(mesh, P("data", "model", None)))
        )(p, x)
    res[f"viii/{name}/y"], res[f"viii/{name}/gx"] = np.asarray(y), np.asarray(gx)
    flat(f"viii/{name}/g", gp)

arch = "granite_moe_3b_a800m"
cfg = W.smoke_config(dataclasses.replace(configs.get_smoke_config(arch),
                                         dtype=jnp.float32), arch, 1.25)
params = tree(arch + "/params")
batch = {"tokens": jnp.asarray(inp[arch + "/tokens"])}
with activate_mesh(mesh):
    logits, _ = jax.jit(lambda p_, b_: M.forward(p_, cfg, b_),
                        in_shardings=shardings(params, batch))(params, batch)
res["v/granite/1.25"] = np.asarray(logits)
np.savez(sys.argv[2], **res)
"""


def _flat(prefix, tree, out):
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            _flat(f"{prefix}/{name}", leaf, out)
        else:
            out[f"{prefix}/{name}"] = np.asarray(leaf)


def _inputs(path):
    """Seeded weights (the port's draws, carried across as numpy by
    ``models.convert``) and numpy inputs of every scenario."""
    import dataclasses
    import torch
    from repro_torch import configs as TC
    from repro_torch.models import layers as TL
    from repro_torch.models import model as TM
    from repro_torch.models.convert import params_to_numpy
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    f32 = np.float32
    inp = {"x": rng.standard_normal((4, 16, 16)).astype(f32),
           "cot": rng.standard_normal((4, 16, 16)).astype(f32),
           "x_odd": rng.standard_normal((4, 5, 16)).astype(f32)}
    _flat("moe", {k: v.numpy() for k, v in TL.init_moe(
        gen, 16, 32, 6, torch.float32, torch.device("cpu"),
        n_padded=8).items()}, inp)
    for name, (d, h, kv, hd, bias, _) in W.ATTN.items():
        p = TL.init_attention(gen, d, h, kv, hd, bias, torch.float32,
                              torch.device("cpu"))
        _flat(f"attn/{name}/p", {k: rng.standard_normal(v.shape).astype(f32)
                                 * (0.1 if k[0] == "b" else 1.0)
                                 if k[0] == "b" else v.numpy()
                                 for k, v in p.items()}, inp)
        for k in ("x", "cot"):
            inp[f"attn/{name}/{k}"] = rng.standard_normal(
                (W.ATTN_B, W.ATTN_L, d)).astype(f32)
        for k in "kv":
            inp[f"dec/{name}/{k}"] = rng.standard_normal(
                (W.ATTN_B, W.DECODE_S, kv, hd)).astype(f32)
        inp[f"dec/{name}/x"] = rng.standard_normal(
            (len(W.DECODE_POS), W.ATTN_B, 1, d)).astype(f32)
    from repro_torch.models import ssm as TS
    for name, (kind, dims, _) in W.REC.items():
        p = getattr(TS, "init_" + kind)(gen, *dims, dtype=torch.float32,
                                        device=torch.device("cpu"))
        _flat(f"rec/{name}/p", {k: v.numpy() if isinstance(v, torch.Tensor)
                                else {kk: vv.numpy() for kk, vv in v.items()}
                                for k, v in p.items()}, inp)
        for k in ("x", "cot"):
            inp[f"rec/{name}/{k}"] = rng.standard_normal(
                (W.REC_B, W.REC_L, dims[0])).astype(f32)
        inp[f"rec/{name}/dec_x"] = rng.standard_normal(
            (2, W.REC_B, 1, dims[0])).astype(f32)
        st = getattr(TS, kind + "_init_state")(
            p, W.REC_B, *(() if kind == "mamba2" else (dims[0],)))
        for k, v in st.items():  # a state mid-sequence: finite, m too
            a = rng.standard_normal(tuple(v.shape)).astype(f32)
            inp[f"rec/{name}/st/{k}"] = np.abs(a) + 0.5 if k == "nvec" \
                else a
    models = [("mini", W.mini_config(TC.get_smoke_config("qwen2_1p5b")),
               (8, 64))]
    models += [(arch, TC.get_smoke_config(arch), (4, 16))
               for arch in W.SMOKE_AXES]
    for name, cfg, shape in models:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
        _flat(name + "/params", params_to_numpy(TM.init_params(cfg, gen,
                                                               "cpu")), inp)
        for k in ("tokens", "labels") if name == "mini" else ("tokens",):
            inp[f"{name}/{k}"] = rng.integers(0, cfg.vocab_size, shape
                                              ).astype(np.int32)
    np.savez(path, **inp)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the port's world-of-four results, the reference's)."""
    d = tmp_path_factory.mktemp("mesh_models")
    _inputs(d / "inputs.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    world = os.path.join(REPO, "tests", "torch_mesh_world.py")
    ranks = [subprocess.Popen(
        [sys.executable, world, str(r), str(d / "store"),
         str(d / "inputs.npz"), str(d / "port.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(W.WORLD)]
    ref_env = dict(env, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
    try:
        ref = subprocess.run(
            [sys.executable, "-c", _REF, str(d / "inputs.npz"),
             str(d / "ref.npz"), os.path.join(REPO, "tests")],
            env=ref_env, capture_output=True, text=True, timeout=600)
        outs = [p.communicate(timeout=600) for p in ranks]
    finally:
        for p in ranks:
            p.kill()
    for p, (_, err) in zip(ranks, outs):
        assert p.returncode == 0, err[-4000:]
    assert ref.returncode == 0, ref.stderr[-4000:]
    return dict(np.load(d / "port.npz")), dict(np.load(d / "ref.npz"))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want)))
    assert err < tol, err


@pytest.mark.parametrize("cf", CFS)
def test_expert_parallel_moe_equals_the_reference(runs, cf):
    port, ref = runs
    np.testing.assert_array_equal(port[f"i/slot/{cf}"], ref[f"slot/{cf}"])
    np.testing.assert_array_equal(port[f"i/route2/{cf}"], ref[f"slot/{cf}"])
    _close(port[f"i/y/{cf}"], ref[f"y/{cf}"])
    _close(port[f"i/aux/{cf}"], ref[f"aux/{cf}"])


def test_expert_parallel_moe_without_drops_equals_one_device(runs):
    port, _ = runs
    cf = W.NO_DROP
    _close(port[f"i/y/{cf}"], port[f"i/y1/{cf}"])
    _close(port[f"i/aux/{cf}"], port[f"i/aux1/{cf}"])


@pytest.mark.parametrize("leaf", ["val", "x", "router", "w_gate", "w_up",
                                  "w_down"])
def test_expert_parallel_moe_gradients_equal_the_reference(runs, leaf):
    port, ref = runs
    want = ref["ii/val"] if leaf == "val" else ref[
        "ii/x" if leaf == "x" else f"ii/{leaf}"]
    _close(port[f"ii/{leaf}"], want)


def test_local_branch_under_the_mesh_equals_one_device(runs):
    port, _ = runs
    _close(port["iii/y"], port["iii/y1"])
    _close(port["iii/aux"], port["iii/aux1"])


def test_mini_dryrun_loss_and_gradients_on_dtensors(runs):
    port, ref = runs
    assert str(port["iv/params_type"]) == "ParamTree"
    _close(port["iv/loss"], ref["iv/loss"])
    _close(port["iv/loss"], port["iv/loss1"])
    names = sorted(k[len("iv/g/"):] for k in ref if k.startswith("iv/g/"))
    assert names == sorted(k[len("iv/g/"):] for k in port
                           if k.startswith("iv/g/"))
    for name in names:
        _close(port["iv/g/" + name], ref["iv/g/" + name])
        _close(port["iv/g/" + name], port["iv/g1/" + name])


@pytest.mark.parametrize("arch", list(W.SMOKE_AXES))
def test_smoke_forward_on_the_mesh_equals_one_device(runs, arch):
    port, _ = runs
    _close(port[f"v/{arch}/{W.NO_DROP}"], port[f"v/{arch}/{W.NO_DROP}/one"])


def test_granite_forward_with_drops_equals_the_reference_mesh(runs):
    port, ref = runs
    _close(port["v/granite_moe_3b_a800m/1.25"], ref["v/granite/1.25"])


def test_granite_decode_on_a_dtensor_cache_equals_one_device(runs):
    port, _ = runs
    arch = "granite_moe_3b_a800m"
    _close(port[f"v/{arch}/decode"], port[f"v/{arch}/decode/one"])


@pytest.mark.parametrize("name", list(W.ATTN))
def test_attention_on_the_mesh_equals_the_reference(runs, name):
    """y, and the gradient of x and of every weight, against the
    reference's ``jit`` on its (2, 2) mesh and against one device."""
    port, ref = runs
    leaves = sorted(k[len(f"vi/{name}/g/"):] for k in ref
                    if k.startswith(f"vi/{name}/g/"))
    assert leaves == sorted(k[len(f"vi/{name}/g/"):] for k in port
                            if k.startswith(f"vi/{name}/g/"))
    for key in ["y", "gx"] + [f"g/{k}" for k in leaves]:
        got = port[f"vi/{name}/{key}"]
        _close(got, ref[f"vi/{name}/{key}"])
        one = key.replace("/", "1/") if "/" in key else key + "1"
        _close(got, port[f"vi/{name}/{one}"])


@pytest.mark.parametrize("name", list(W.ATTN))
def test_each_rank_scores_half_the_attention(runs, name):
    """A rank's score blocks [b, kv, rep, q, l]: its batch rows, every
    key, and n_heads / 2 heads (split by heads) or, split by rows, every
    head and half the query rows."""
    port, _ = runs
    _, n_heads, *_ = W.ATTN[name]
    blocks, one = port[f"vi/{name}/scores"], port[f"vi/{name}/scores1"]
    assert len(blocks) and (blocks[:, 0] == W.ATTN_B // 2).all()
    assert (blocks[:, 4] == W.ATTN_L).all()
    heads = blocks[:, 1] * blocks[:, 2]
    if n_heads % 2 == 0:
        assert (heads == n_heads // 2).all()
        assert blocks[:, 3].sum() == W.ATTN_L
    else:
        assert (heads == n_heads).all()
        assert blocks[:, 3].sum() == W.ATTN_L // 2
    assert (one[:, 1] * one[:, 2] == n_heads).all()
    assert one[:, 3].sum() == W.ATTN_L


@pytest.mark.parametrize("name,layout", W.DECODE)
def test_decode_on_a_split_cache_equals_one_device(runs, name, layout):
    port, _ = runs
    for i in range(len(W.DECODE_POS)):
        key = f"vii/{name}/{layout}/{i}"
        for part in ("y", "k", "v"):
            _close(port[f"{key}/{part}"], port[f"{key}/{part}/one"])


@pytest.mark.parametrize("name", list(W.REC))
def test_recurrent_layer_on_the_mesh_equals_the_reference(runs, name):
    """``mamba2`` split by the sequence and by heads, ``mlstm`` by query
    rows and ``slstm`` by the state's d: y and the gradient of x and of
    every weight against ``jax.grad`` of the reference on its (2, 2) mesh
    and against one device."""
    port, ref = runs
    pre = f"viii/{name}"
    leaves = sorted(k[len(pre + "/g/"):] for k in ref
                    if k.startswith(pre + "/g/"))
    assert leaves and leaves == sorted(k[len(pre + "/g/"):] for k in port
                                       if k.startswith(pre + "/g/"))
    for key in ["y", "gx"] + [f"g/{k}" for k in leaves]:
        got = port[f"{pre}/{key}"]
        _close(got, ref[f"{pre}/{key}"])
        one = key.replace("/", "1/", 1) if "/" in key else key + "1"
        _close(got, port[f"{pre}/{one}"])


@pytest.mark.parametrize("name", [n for n in W.REC if n.startswith("mlstm")])
def test_each_rank_mixes_half_the_mlstm_rows(runs, name):
    """A rank's mLSTM score blocks [b, l_q, l, h] (the stabiliser's max
    over them): its batch rows, every key and head, half the query rows."""
    port, _ = runs
    blocks, one = port[f"viii/{name}/scores"], port[f"viii/{name}/scores1"]
    heads = W.REC[name][1][1]
    assert blocks.tolist() == [[W.REC_B // 2, W.REC_L // 2, W.REC_L, heads]]
    assert one.tolist() == [[W.REC_B, W.REC_L, W.REC_L, heads]]


@pytest.mark.parametrize("name", W.REC_DECODE)
def test_recurrent_decode_on_a_split_state_equals_one_device(runs, name):
    """Two decode steps on a state laid out by ``cache_shardings`` (each
    rank writes its block in place): y and every state leaf."""
    port, _ = runs
    for i in range(2):
        key = f"viii/{name}/dec/{i}"
        parts = [k[len(key) + 1:-len("/one")] for k in port
                 if k.startswith(key + "/") and k.endswith("/one")]
        assert "y" in parts and len(parts) > 2
        for part in parts:
            _close(port[f"{key}/{part}"], port[f"{key}/{part}/one"])
