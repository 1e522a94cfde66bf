"""The five twins of ``examples/`` (``examples/torch_*.py``) on the CPU,
each held against the same work done by ``repro`` on the same arrays.

* quickstart, production_star, serving_demo: each twin's ``main`` at a
  small row count with ``--cpu`` (it asserts its own numpy oracles), and
  the same queries built with ``repro`` on the twin's arrays: integers
  exact, float sums within the reference tests' rtol 1e-4; the served
  answers equal to the solo runs.
* serve_batched: the same greedy ids as ``repro.launch.serve_model.main``
  with the reference's smoke weights carried across
  (``models.convert.params_from_numpy``), in float32.
* train_lm: a few steps of the twin against ``repro.launch.train.main``
  on the same seed, the reference's initial weights carried across, in
  float32: the losses within ``tests/test_torch_train.py``'s rtol 2e-5.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import compress as rcompress
from repro.core import (PartitionedQuery as RPQuery,
                        PartitionedTable as RPTable)
from repro.core.encodings import decode_column as r_decode
from repro.core.plan import Query as RQuery, col as rcol, \
    pk_fk_gather as r_pk_fk
from repro.core.table import Table as RTable
from repro.models import model as RM
from repro_torch.models.convert import params_from_numpy

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
RTOL = 1e-4


def _load(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ok(capsys, line):
    assert line in capsys.readouterr().out.splitlines()


def test_quickstart_twin_equals_the_reference(capsys):
    qs = _load("torch_quickstart")
    n = 20_000
    got = qs.main(["--cpu", "--rows", str(n)])
    _ok(capsys, "quickstart OK")
    data, whitelist, dim_payload = qs.make_data(n)
    cfg = rcompress.CompressionConfig(plain_threshold=10_000)
    table = RTable.from_arrays(data, cfg=cfg)

    res = (RQuery(table)
           .filter((rcol("status") == "paid") & (rcol("units") > 2))
           .groupby(["region"], {"total_units": ("sum", "units"),
                                 "orders": ("count", None)},
                    num_groups_cap=16)).run()
    ng = int(res.num_groups)
    for k, v in (("region", res.keys["region"]),
                 ("total_units", res.aggs["total_units"]),
                 ("orders", res.aggs["orders"])):
        np.testing.assert_array_equal(got["q1"][k], np.asarray(v)[:ng])

    res2 = (RQuery(table).semi_join("store", whitelist)
            .aggregate({"revenue": ("sum", "revenue"),
                        "n": ("count", None)})).run()
    assert got["q2"] == {"n": int(res2["n"]),
                         "revenue": int(res2["revenue"])}

    tier = r_pk_fk(table.columns["store"],
                   jnp.asarray(np.arange(500, dtype=np.int32)),
                   jnp.asarray(dim_payload))
    np.testing.assert_array_equal(got["q3"], np.asarray(r_decode(tier)))

    ptable = RPTable.from_arrays(data, cfg=cfg, num_partitions=8)
    q4 = (RPQuery(ptable)
          .filter((rcol("region") == 2) & (rcol("status") == "paid"))
          .groupby(["store"], {"total_units": ("sum", "units"),
                               "orders": ("count", None)},
                   num_groups_cap=1024))
    res4 = q4.run()
    ng4 = int(res4.num_groups)
    np.testing.assert_array_equal(got["q4"]["store"],
                                  np.asarray(res4.keys["store"])[:ng4])
    for k in ("total_units", "orders"):
        np.testing.assert_array_equal(got["q4"][k],
                                      np.asarray(res4.aggs[k])[:ng4])
    assert (got["q4"]["skipped"], got["q4"]["executed"]) == \
        (q4.last_stats["skipped"], q4.last_stats["executed"])

    res5 = (RPQuery(ptable).filter(rcol("status") == "paid")
            .order_by("revenue", descending=True, limit=10,
                      cols=["region", "store"])).run()
    np.testing.assert_array_equal(got["q5"]["positions"], res5.positions)
    for k, v in res5.columns.items():
        np.testing.assert_array_equal(got["q5"][k], np.asarray(v))


def test_production_star_twin_equals_the_reference(capsys):
    ps = _load("torch_production_star")
    n = 30_000
    got = ps.main(["--cpu", "--rows", str(n)])
    _ok(capsys, "production star example OK")
    data = ps.make_star(np.random.default_rng(42), n)
    fact = RTable.from_arrays(
        data, cfg=rcompress.CompressionConfig(plain_threshold=1000))
    fact_plain = RTable.from_arrays(data, cfg=rcompress.CompressionConfig(),
                                    encodings={k: "plain" for k in data})
    dim_c6 = RTable.from_arrays(
        ps.dim_c6_arrays(),
        cfg=rcompress.CompressionConfig(plain_threshold=1000))
    for label, t in (("plain", fact_plain), ("compressed", fact)):
        rng2 = np.random.default_rng(7)
        q = RQuery(t)
        for cname, card in ps.DIMS.items():
            q = q.semi_join(cname, ps._semi_keys(rng2, card, 0.5))
        q = q.join(dim_c6, fk="c6", cols=["d6_cat"])
        res = q.groupby(["d6_cat"], {"revenue": ("sum", "measure"),
                                     "orders": ("count", None)},
                        num_groups_cap=128).run()
        ng = int(res.num_groups)
        assert ng > 0
        np.testing.assert_array_equal(got[label]["d6_cat"],
                                      np.asarray(res.keys["d6_cat"])[:ng])
        np.testing.assert_array_equal(got[label]["orders"],
                                      np.asarray(res.aggs["orders"])[:ng])
        np.testing.assert_allclose(got[label]["revenue"],
                                   np.asarray(res.aggs["revenue"])[:ng],
                                   rtol=RTOL)


def test_serving_demo_twin_equals_the_reference(capsys):
    sd = _load("torch_serving_demo")
    n = 20_000
    got = sd.main(["--cpu", "--rows", str(n)])
    _ok(capsys, "serving_demo OK")
    assert got["stats"]["completed"] == 18
    assert len(got["served"]) == 6
    assert all(sd.same(s, got["solo"]) for s in got["served"])

    pt = RPTable.from_arrays(sd.make_data(n), num_partitions=8, pack=True)
    agg, by_region, top = [q.run() for q in [
        (RPQuery(pt).filter(rcol("units") > 2)
         .aggregate({"revenue": ("sum", "price"),
                     "orders": ("count", None)})),
        (RPQuery(pt).filter(rcol("units") > 2)
         .groupby(["region"], {"revenue": ("sum", "price")})),
        (RPQuery(pt).groupby(["region"], {"units": ("sum", "units")})
         .order_by("units", descending=True, limit=5))]]
    solo = got["solo"]
    assert int(solo["rollup"]["orders"]) == int(agg["orders"])
    np.testing.assert_allclose(solo["rollup"]["revenue"],
                               np.asarray(agg["revenue"]), rtol=RTOL)
    np.testing.assert_allclose(solo["revenue"],
                               np.asarray(by_region.aggs["revenue"]),
                               rtol=RTOL)
    np.testing.assert_array_equal(solo["top_region"],
                                  np.asarray(top.keys["region"]))
    np.testing.assert_array_equal(solo["top_units"],
                                  np.asarray(top.aggs["units"]))


def _float32_smoke(monkeypatch, arch):
    """Both packages' smoke config of ``arch`` in float32."""
    import importlib
    for pkg, dtype in (("repro", jnp.float32), ("repro_torch",
                                               torch.float32)):
        mod = importlib.import_module(f"{pkg}.configs.{arch}")
        orig = mod.smoke_config
        monkeypatch.setattr(mod, "smoke_config",
                            lambda o=orig, d=dtype: dataclasses.replace(
                                o(), dtype=d))


def _reference_tree(arch):
    from repro import configs as RC
    cfg = RC.get_smoke_config(arch)
    return jax.tree.map(np.array, jax.jit(
        lambda k: RM.init_params(cfg, k))(jax.random.PRNGKey(0)))


def test_serve_batched_twin_equals_the_reference(monkeypatch, capsys):
    from repro.launch import serve_model as r_serve
    from repro_torch.launch import serve_model as t_serve
    _float32_smoke(monkeypatch, "qwen2_1p5b")
    tree = _reference_tree("qwen2_1p5b")
    monkeypatch.setattr(t_serve.M, "init_params",
                        lambda cfg, gen, dev: params_from_numpy(cfg, tree,
                                                                dev))
    got = _load("torch_serve_batched").main(["--cpu"])
    _ok(capsys, "serve_batched example OK")
    want = r_serve.main(["--arch", "qwen2_1p5b", "--smoke"])
    assert got.shape == (4, 16)
    np.testing.assert_array_equal(got, want)


def test_train_lm_twin_equals_the_reference(monkeypatch, capsys, tmp_path):
    from repro.launch import train as r_train
    from repro_torch.launch import train as t_train
    from repro_torch.train.step import state_for
    _float32_smoke(monkeypatch, "smollm_360m")
    tree = _reference_tree("smollm_360m")
    monkeypatch.setattr(
        t_train, "init_train_state",
        lambda cfg, tcfg, gen, dev: state_for(
            params_from_numpy(cfg, tree, dev).requires_grad_(True), tcfg))
    steps = 10
    got = _load("torch_train_lm").main(["--cpu", "--steps", str(steps)])
    _ok(capsys, "train_lm example OK")
    want = r_train.main([
        "--arch", "smollm_360m", "--smoke", "--steps", str(steps),
        "--batch", "8", "--seq", "128", "--lr", "1e-3", "--grad-accum", "2",
        "--ckpt-dir", str(tmp_path / "ref"), "--ckpt-every", "100"])
    assert got.steps_run == want.steps_run == steps
    np.testing.assert_allclose(got.losses, want.losses, rtol=2e-5)
