"""Twins of ``repro.distributed.sharding``, ``repro.configs.input_specs``,
``repro.launch.dryrun``'s cell configuration, ``allreduce_topk`` and the
elastic checkpoint restore in the port, on the CPU.

* The seven one-process tests of ``tests/test_sharding_dist.py`` on the
  port's rules, over the port's shape-only mesh.
* Partition specs equal to the reference's, entry for entry, for every leaf
  of all 10 archs on the (16, 16) and (2, 16, 16) production meshes
  (reference shapes from ``jax.eval_shape``, the port's from meta
  ``init_params``); batch and cache specs for every decode cell;
  ``input_specs`` equal in keys, shapes and dtypes for all 40 cells, cache
  leaves included; ``exec_config``'s fields and ``model_flops`` equal
  exactly for the 40 cells on both meshes.
* ``allreduce_topk`` exact in float32: a gloo world of one against the
  reference's one-device ``shard_map``, and a gloo world of two (two
  processes, a file store) against the reference on two forced host
  devices in a subprocess. ``torch.topk``'s tie order is unspecified, so
  each rank's leaf has distinct magnitudes.
* The elastic restore of a checkpoint the reference wrote, onto a (1, 1)
  gloo mesh, bit for bit.
"""
import dataclasses
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

from repro import configs as RC
from repro.distributed import compression as RComp
from repro.distributed import sharding as RSh
from repro.models import model as RM
from repro_torch import configs as TC
from repro_torch.distributed import compression as TComp
from repro_torch.distributed import sharding as Sh
from repro_torch.distributed.sharding import P
from repro_torch.launch import mesh as TMesh
from repro_torch.models import model as TM
from repro_torch.train import CheckpointManager, pytree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = TMesh.ShapeMesh((16, 16), ("data", "model"))
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
CELLS = [(a, s) for a in TC.ARCHS for s in TC.SHAPES]
DECODE_CELLS = [(a, s) for a, s in CELLS if TC.SHAPES[s][2] == "decode"]


class FakeMesh:
    """The reference tests' duck-typed mesh."""

    def __init__(self, shape_map):
        self.shape = shape_map
        self.axis_names = tuple(shape_map)


def _meshes(name):
    m = MESHES[name]
    return FakeMesh(m), TMesh.ShapeMesh(tuple(m.values()), tuple(m))


def _specs(arch, cfg=None):
    cfg = cfg or TC.get_config(arch)
    return cfg, Sh.param_shardings(TM.init_params(cfg, device="meta"), MESH)


def _flat_ref(tree):
    """{path: tuple(spec)} of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {RSh._path_str(p): tuple(s) for p, s in flat}


def _flat_port(tree):
    return {Sh._path_str(n): tuple(s) for n, s in
            pytree.named_leaves(tree, leaf_types=(Sh.PartitionSpec,))}


# ---- the reference's one-process tests, on the port -----------------------


def test_dense_rules_yi():
    _, specs = _specs("yi_9b")
    layer = specs["layers"]
    assert layer["attn"]["wq"] == P(None, "data", "model", None)
    assert layer["attn"]["wk"] == P(None, "data", None, "model")
    assert layer["mlp"]["w_gate"] == P(None, "data", "model")
    assert layer["mlp"]["w_down"] == P(None, "model", "data")
    assert specs["embed"] == P("model", "data")


def test_head_fallback_smollm():
    _, specs = _specs("smollm_360m")
    assert specs["layers"]["attn"]["wq"] == P(None, "data", None, "model")


def test_moe_ep_qwen3():
    _, specs = _specs("qwen3_moe_235b_a22b")
    assert specs["layers"]["moe"]["w_gate"] == P(None, "model", "data", None)
    assert specs["layers"]["moe"]["w_down"] == P(None, "model", None, "data")


def test_granite_expert_padding_makes_ep_shardable():
    cfg = dataclasses.replace(TC.get_config("granite_moe_3b_a800m"),
                              expert_pad_multiple=16)
    assert cfg.padded_experts == 48
    _, specs = _specs("granite_moe_3b_a800m", cfg)
    assert specs["layers"]["moe"]["w_gate"][1] == "model"


def test_vocab_padding():
    cfg = TC.get_config("granite_moe_3b_a800m")
    assert cfg.vocab_size == 49155
    assert cfg.padded_vocab % 16 == 0


def test_every_param_of_every_arch_gets_a_spec():
    for arch in TC.ARCHS:
        cfg = TC.get_config(arch)
        params = TM.init_params(cfg, device="meta")
        specs = Sh.param_shardings(params, MESH)
        flat = dict(pytree.named_leaves(specs,
                                        leaf_types=(Sh.PartitionSpec,)))
        for name, leaf in pytree.named_leaves(params):
            for ax, dim in zip(flat[name], leaf.shape):
                if ax is not None:
                    size = int(np.prod([MESH.shape[a] for a in
                                        (ax if isinstance(ax, tuple)
                                         else (ax,))]))
                    assert dim % size == 0, (arch, name, flat[name])


def test_batch_spec_fallback():
    assert Sh.batch_spec(MESH, 256) == P(("data",), None)
    m3 = TMesh.ShapeMesh((2, 16, 16), ("pod", "data", "model"))
    assert Sh.batch_spec(m3, 256) == P(("pod", "data"), None)
    assert Sh.batch_spec(m3, 1) == P(None, None)


# ---- the port against the reference, leaf for leaf ------------------------


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", TC.ARCHS)
def test_param_specs_equal_the_reference(arch, mesh):
    ref_mesh, port_mesh = _meshes(mesh)
    rcfg = RC.get_config(arch)
    shapes = jax.eval_shape(lambda k: RM.init_params(rcfg, k),
                            jax.random.PRNGKey(0))
    want = _flat_ref(RSh.param_shardings(shapes, ref_mesh))
    got = _flat_port(Sh.param_shardings(
        TM.init_params(TC.get_config(arch), device="meta"), port_mesh))
    assert got == want


def test_train_state_specs_equal_the_reference():
    """A train state's paths skip its dataclass fields, as the reference's
    ``_path_str`` skips ``GetAttrKey``: moments shard as their leaves."""
    from repro.train import step as RTS
    from repro_torch.train import step as TTS
    rcfg, tcfg = RC.get_smoke_config("qwen2_1p5b"), \
        TC.get_smoke_config("qwen2_1p5b")
    ref_mesh, port_mesh = _meshes("single")
    rstate = jax.eval_shape(
        lambda k: RTS.init_train_state(rcfg, RTS.TrainConfig(), k),
        jax.random.PRNGKey(0))
    tstate = TTS.init_train_state(tcfg, TTS.TrainConfig(), None, "meta")
    want = sorted(_flat_ref(RSh.param_shardings(rstate, ref_mesh)).items())
    got = sorted((Sh._path_str(n), tuple(s)) for n, s in pytree.named_leaves(
        Sh.param_shardings(tstate, port_mesh),
        leaf_types=(Sh.PartitionSpec,)))
    assert got == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", DECODE_CELLS)
def test_batch_and_cache_specs_equal_the_reference(arch, shape, mesh):
    ref_mesh, port_mesh = _meshes(mesh)
    gb = RC.SHAPES[shape][1]
    rbatch, rcache, _ = RC.input_specs(RC.get_config(arch), shape)
    tbatch, tcache, _ = TC.input_specs(TC.get_config(arch), shape)
    assert _flat_port(Sh.batch_shardings(tbatch, port_mesh, gb)) == \
        _flat_ref(RSh.batch_shardings(rbatch, ref_mesh, gb))
    assert _flat_port(Sh.cache_shardings(tcache, port_mesh, gb)) == \
        _flat_ref(RSh.cache_shardings(rcache, ref_mesh, gb))


def _sig_ref(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {RSh._path_str(p): (tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in flat}


def _sig_port(tree):
    return {Sh._path_str(n): (tuple(x.shape),
                              str(x.dtype).replace("torch.", ""))
            for n, x in pytree.named_leaves(tree)}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_the_reference(arch, shape):
    want = RC.input_specs(RC.get_config(arch), shape)
    got = TC.input_specs(TC.get_config(arch), shape)
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == 3
        for w, g in zip(want, got):
            assert _sig_port(g) == _sig_ref(w)
        assert all(x.device.type == "meta"
                   for x in pytree.leaves(got[:2]) + [got[2]])
    else:
        assert _sig_port(got) == _sig_ref(want)
        assert all(x.device.type == "meta" for x in got.values())


@pytest.fixture(scope="module")
def ref_dryrun():
    """``repro.launch.dryrun``, imported with ``os.environ`` restored: its
    first lines set XLA_FLAGS to 512 host devices, which would reach every
    later subprocess of this worker. jax's backend is up before the import,
    so this process keeps its one device."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    assert len(jax.devices()) == 1
    return dryrun


def _fields(cfg):
    return {f.name: (str(v).replace("torch.", "") if f.name == "dtype"
                     else v)
            for f in dataclasses.fields(cfg)
            for v in [getattr(cfg, f.name)]}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_exec_config_and_model_flops_equal_the_reference(ref_dryrun, arch,
                                                         shape, mesh):
    from repro_torch.launch import dryrun
    ref_mesh, port_mesh = _meshes(mesh)
    rcfg = ref_dryrun.exec_config(RC.get_config(arch), shape, ref_mesh, arch)
    tcfg = dryrun.exec_config(TC.get_config(arch), shape, port_mesh, arch)
    want, got = _fields(rcfg), _fields(tcfg)
    want["dtype"] = np.dtype(rcfg.dtype).name
    assert got == want
    assert dryrun.model_flops(tcfg, shape) == \
        ref_dryrun.model_flops(rcfg, shape)


# ---- allreduce_topk ---------------------------------------------------------


def _distinct(rng, shape):
    """float32 values of distinct magnitudes, random signs."""
    n = int(np.prod(shape))
    mag = (rng.permutation(n) + 1).astype(np.float32) * np.float32(2 ** -12)
    return (mag * rng.choice([-1, 1], n)).astype(np.float32).reshape(shape)


@pytest.fixture
def world_of_one():
    """A gloo world of one and its (1, 1) mesh, torn down after the test."""
    assert not dist.is_initialized()
    mesh = TMesh.make_host_mesh("cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("frac", [0.01, 0.3, 1.0])
def test_allreduce_topk_world_of_one_equals_the_reference(world_of_one,
                                                          frac):
    from repro.launch import mesh as RMesh
    g = _distinct(np.random.default_rng(3), (48, 40))
    rmesh = RMesh.make_host_mesh()
    want = np.asarray(RMesh.shard_map_compat(
        lambda x: RComp.allreduce_topk(x, "data", frac), rmesh,
        in_specs=JP("data"), out_specs=JP("data"))(jnp.asarray(g)))
    f = TMesh.shard_map_compat(
        lambda x: TComp.allreduce_topk(x, TMesh.axis_group("data"), frac),
        world_of_one, in_specs=P("data"), out_specs=P("data"))
    got = f(torch.from_numpy(g)).to_local().numpy()
    np.testing.assert_array_equal(got, want)
    # the plain single-device projection is the same function here
    np.testing.assert_array_equal(
        got, TComp._topk_project(torch.from_numpy(g), frac).numpy())


def test_allreduce_topk_keeps_dtype_and_shape(world_of_one):
    g = torch.from_numpy(_distinct(np.random.default_rng(4), (64, 33)))
    for dtype in (torch.float32, torch.bfloat16):
        out = TComp.allreduce_topk(g.to(dtype), None, 0.05)
        assert out.dtype == dtype and out.shape == g.shape
        assert torch.equal(out, TComp._topk_project(
            g.to(dtype).float(), 0.05).to(dtype))


_PORT_RANK = """
import sys, numpy as np, torch, torch.distributed as dist
from repro_torch.distributed import compression as C
from repro_torch.distributed.sharding import P
from repro_torch.launch import mesh as M
rank, store, inp, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank,
                        world_size=2)
mesh = M.make_mesh_compat((2,), ("data",), "cpu")
g = torch.from_numpy(np.load(inp)[rank])
res = {}
for frac in (0.05, 1.0):
    f = M.shard_map_compat(
        lambda x: C.allreduce_topk(x, M.axis_group("data"), frac), mesh,
        P("data"), P("data"))
    res[str(frac)] = f(g).to_local().numpy()
np.savez(out, **res)
dist.destroy_process_group()
"""

_REF_TWO = """
import sys, numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.distributed.compression import allreduce_topk
from repro.launch.mesh import make_mesh_compat, shard_map_compat
assert len(jax.devices()) == 2
inp, out = sys.argv[1], sys.argv[2]
g = jnp.asarray(np.load(inp).reshape(-1, np.load(inp).shape[-1]))
mesh = make_mesh_compat((2,), ("data",))
res = {}
for frac in (0.05, 1.0):
    f = shard_map_compat(lambda x: allreduce_topk(x, "data", frac), mesh,
                         in_specs=P("data"), out_specs=P("data"))
    res[str(frac)] = np.asarray(jax.jit(f)(g))
np.savez(out, **res)
"""


def test_allreduce_topk_world_of_two_equals_the_reference(tmp_path):
    """Two gloo ranks (a file store under ``tmp_path``) against the
    reference's ``shard_map`` on two forced host devices."""
    g = np.stack([_distinct(np.random.default_rng(10 + r), (24, 20))
                  for r in range(2)])  # [rank, 24, 20]
    inp = tmp_path / "g.npy"
    np.save(inp, g)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    ranks = [subprocess.Popen(
        [sys.executable, "-c", _PORT_RANK, str(r), str(tmp_path / "store"),
         str(inp), str(tmp_path / f"port{r}.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    ref_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=2",
                   JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, "-c", _REF_TWO, str(inp),
                          str(tmp_path / "ref.npz")], env=ref_env,
                         capture_output=True, text=True, timeout=300)
    try:
        outs = [p.communicate(timeout=300) for p in ranks]
    finally:
        for p in ranks:
            p.kill()
    for p, (_, err) in zip(ranks, outs):
        assert p.returncode == 0, err[-3000:]
    assert ref.returncode == 0, ref.stderr[-3000:]
    want = np.load(tmp_path / "ref.npz")
    for frac in ("0.05", "1.0"):
        got = np.concatenate([np.load(tmp_path / f"port{r}.npz")[frac]
                              for r in range(2)])
        np.testing.assert_array_equal(got, want[frac])
    # both ranks hold the mean of the two projections
    both = [TComp._topk_project(torch.from_numpy(g[r]), 0.05).numpy()
            for r in range(2)]
    np.testing.assert_array_equal(want["0.05"][:24],
                                  (both[0] + both[1]) / np.float32(2))


# ---- the elastic restore ----------------------------------------------------


def test_elastic_restore_onto_a_mesh_is_bit_exact(world_of_one):
    """A checkpoint the reference wrote on one device restores onto the
    port's (1, 1) mesh as DTensors laid out by ``named_shardings``, the same
    bits, float32 and bfloat16 leaves alike."""
    import repro.train as RT
    from torch.distributed.tensor import DTensor
    rcfg = RC.get_smoke_config("smollm_360m")
    state = RT.step.init_train_state(rcfg, RT.TrainConfig(),
                                     jax.random.PRNGKey(0))
    with tempfile.TemporaryDirectory() as d:
        RT.CheckpointManager(d).save(5, state.params, blocking=True)
        like = TM.init_params(TC.get_smoke_config("smollm_360m"),
                              device="meta")
        shardings = Sh.named_shardings(like, world_of_one)
        restored, meta = CheckpointManager(d).restore(like,
                                                      shardings=shardings)
    assert meta["step"] == 5
    want = {RSh._path_str(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(state.params)[0]}
    flat = dict(pytree.named_leaves(shardings,
                                    leaf_types=(Sh.NamedSharding,)))
    got = pytree.named_leaves(restored)
    assert sorted(n for n, _ in got) == sorted(want)
    for name, leaf in got:
        assert isinstance(leaf, DTensor)
        assert tuple(leaf.placements) == flat[name].placements
        full = leaf.full_tensor()
        w = want[name]
        if w.dtype.name == "bfloat16":
            assert full.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                full.view(torch.int16).numpy(), w.view(np.int16))
        else:
            np.testing.assert_array_equal(full.numpy(), w)


def test_named_shardings_place_spec_axes_on_mesh_dims(world_of_one):
    from torch.distributed.tensor import Replicate, Shard
    assert TMesh.placements(P("model", "data"), world_of_one) == \
        (Shard(1), Shard(0))
    assert TMesh.placements(P(("data",), None), world_of_one) == \
        (Shard(0), Replicate())
    assert TMesh.placements(P(), world_of_one) == (Replicate(), Replicate())
    assert TMesh.axis_sizes(world_of_one) == {"data": 1, "model": 1}
    assert TMesh.data_axes(TMesh.make_production_mesh(multi_pod=True)) == \
        ("pod", "data")
    with TMesh.activate_mesh(world_of_one):
        assert TMesh.abstract_mesh_compat() is world_of_one
    assert TMesh.abstract_mesh_compat() is None


def test_host_mesh_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TMesh.make_host_mesh()
    assert not dist.is_initialized()


# ---- the model's mesh dataflow on a world of one --------------------------


def _smoke_f32(arch="qwen2_1p5b", **kw):
    return dataclasses.replace(TC.get_smoke_config(arch),
                               dtype=torch.float32, **kw)


def test_distribute_keeps_the_param_tree(world_of_one):
    """``distribute`` of a ``ParamTree`` is a ``ParamTree`` of DTensors,
    so laid-out params enter ``forward`` as they are."""
    from torch.distributed.tensor import DTensor
    cfg = _smoke_f32()
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    laid = Sh.distribute(params, Sh.named_shardings(params, world_of_one))
    assert isinstance(laid, TM.ParamTree)
    assert all(isinstance(p, DTensor) and not p.requires_grad
               for p in laid.parameters())
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32))
    with torch.no_grad():
        got, _ = TM.forward(laid, cfg, {"tokens": tokens})
        want, _ = TM.forward(params, cfg, {"tokens": tokens})
    np.testing.assert_allclose(got.full_tensor().numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_loss_and_gradients_on_vocab_sharded_dtensors(world_of_one):
    """``loss_fn`` on params laid out by ``named_shardings`` (the vocab of
    the tied embedding over "model") and a DTensor batch: the loss and
    every gradient leaf within 1e-5 of one device."""
    from torch.distributed.tensor import distribute_tensor
    cfg = _smoke_f32(act_batch_axes=("data",), vocab_axis="model")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shardings = Sh.named_shardings(params, world_of_one)
    assert shardings["embed"].spec == P("model", "data")
    laid = TM.ParamTree(Sh.distribute(params.tree(), shardings))
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32))
        for k in ("tokens", "labels")}
    spec = Sh.batch_spec(world_of_one, 2)
    dbatch = {k: distribute_tensor(v, world_of_one,
                                   TMesh.placements(spec, world_of_one))
              for k, v in batch.items()}
    laid.requires_grad_()
    params.requires_grad_()
    with TMesh.activate_mesh(world_of_one):
        loss = TM.loss_fn(laid, cfg, dbatch)
    loss.backward()
    want = TM.loss_fn(params, cfg, batch)
    want.backward()
    assert abs(loss.full_tensor().item() - want.item()) < 1e-5
    grads = dict(params.named_parameters())
    for name, p in laid.named_parameters():
        np.testing.assert_allclose(p.grad.full_tensor().numpy(),
                                   grads[name].grad.numpy(), atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("spec", [P("data", None), P(None, "model"),
                                  P(("data", "model"), None), P(None, None)])
def test_with_sharding_constraint_lays_a_dtensor_out(world_of_one, spec):
    from torch.distributed.tensor import distribute_tensor, Replicate
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    d = distribute_tensor(x, world_of_one, (Replicate(), Replicate()))
    got = TMesh.with_sharding_constraint(d, spec)
    assert tuple(got.placements) == TMesh.placements(spec, world_of_one)
    assert torch.equal(got.full_tensor(), x)


def test_with_sharding_constraint_passes_plain_tensors():
    x = torch.ones(3, 4, requires_grad=True)
    assert TMesh.with_sharding_constraint(x, P("data", "model")) is x


def test_shard_map_under_an_ambient_mesh_takes_plain_tensors_whole(
        world_of_one):
    """A plain tensor under an ambient mesh is the global value, sliced by
    its in-spec; the caller gets a plain global tensor back, and the
    gradient flows through."""
    x = torch.arange(8, dtype=torch.float32).reshape(4, 2).requires_grad_()
    f = TMesh.shard_map_compat(lambda a: a * 2, world_of_one,
                               in_specs=P("data", None),
                               out_specs=P("data", None))
    with TMesh.activate_mesh(world_of_one):
        y = f(x)
    assert type(y) is torch.Tensor and torch.equal(y, x.detach() * 2)
    y.sum().backward()
    assert torch.equal(x.grad, torch.full_like(x, 2.0))
