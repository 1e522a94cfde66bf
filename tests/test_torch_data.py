"""Twins of ``repro.data`` and ``repro.launch.train`` in the port
(``repro_torch.data``, ``repro_torch.launch.train``) on the CPU.

The same ``CorpusConfig`` builds both packages' corpora (the same numpy
draws), and the same selections run on both engines. Integers compare
exactly: the corpus columns (encoded buffers and static fields), their
encodings and footprint, the
selected positions, every batch's tokens and labels, ``corpus_stats``'
domains and counts. ``corpus_stats``' mean quality (a float32 average)
within rtol 1e-4, the engine twins' tolerance for float aggregates.
The reference's own pipeline checks (``tests/test_train_data.py``: numpy
oracles of the selection and the semi-join, disjoint shards, resume by
``seek``, shifted labels) are asserted on the port too.
"""
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import CorpusConfig as RCorpusConfig
from repro.data import DataPipeline as RPipeline
from repro.data import PipelineConfig as RPipelineConfig
from repro.data import build_synthetic_corpus as rbuild
from repro.data import corpus_stats as rstats
from repro.data.pipeline import select_token_mask as rselect
from repro.core.encodings import decode_mask as rdecode_mask
from repro_torch.core.encodings import decode_mask
from repro_torch.data import (CorpusConfig, DataPipeline, PipelineConfig,
                              build_synthetic_corpus, corpus_stats)
from repro_torch.data.pipeline import select_token_mask
from repro_torch.launch import train as train_launch

from torch_twins import CPU, assert_same_encoded

CORPUS = dict(n_docs=400, mean_doc_len=150)


@pytest.fixture(scope="module")
def corpora():
    return (rbuild(RCorpusConfig(**CORPUS)),
            build_synthetic_corpus(CorpusConfig(**CORPUS), CPU))


def test_corpus_columns_equal(corpora):
    (rfact, rdims), (fact, dims) = corpora
    assert fact.nrows == rfact.nrows
    assert fact.encodings() == rfact.encodings()
    assert fact.encoding_of("doc_id") == "RLEColumn"
    assert fact.nbytes() == rfact.nbytes()
    assert fact.nbytes() < 5 * 4 * fact.nrows / 5  # >5x, as the reference
    for name in ("tokens", "doc_id", "domain", "lang", "quality"):
        assert_same_encoded(rfact.column(name), fact.column(name), name)
    for k in rdims:
        np.testing.assert_array_equal(dims[k], rdims[k], err_msg=k)


def test_corpus_stats_twin(corpora):
    (rfact, rdims), (fact, dims) = corpora
    want, got = rstats(rfact), corpus_stats(fact)
    np.testing.assert_array_equal(got["domain"], want["domain"])
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_allclose(got["mean_quality"], want["mean_quality"],
                               rtol=1e-4)
    assert int(got["tokens"].sum()) == fact.nrows
    doc_domain = np.repeat(dims["doc_domain"], dims["doc_lens"])
    doc_quality = np.repeat(dims["doc_quality"], dims["doc_lens"])
    for dom, cnt, mq in zip(got["domain"], got["tokens"],
                            got["mean_quality"]):
        sel = doc_domain == dom
        assert int(cnt) == int(sel.sum())
        assert abs(float(mq) - doc_quality[sel].mean()) <= \
            1e-4 * doc_quality[sel].mean()


SELECTIONS = {
    "domains": dict(min_quality=55, domains=[0, 1, 2, 3, 4, 5]),
    "whitelist": dict(min_quality=0, doc_whitelist=np.arange(0, 400, 7)),
    "all": dict(min_quality=45, domains=[1, 3, 7, 11], langs=[1, 2],
                doc_whitelist=np.arange(3, 400, 3)),
}


@pytest.mark.parametrize("name", list(SELECTIONS))
def test_select_token_mask_twin(corpora, name):
    (rfact, rdims), (fact, _) = corpora
    kw = SELECTIONS[name]
    want = np.asarray(rdecode_mask(rselect(rfact, RPipelineConfig(**kw))))
    got = decode_mask(select_token_mask(fact, PipelineConfig(**kw))).numpy()
    np.testing.assert_array_equal(got, want)
    # the numpy oracle of ``tests/test_train_data.py``
    rep = {k: np.repeat(rdims[f"doc_{k}"], rdims["doc_lens"])
           for k in ("quality", "domain", "lang")}
    doc = np.repeat(np.arange(CORPUS["n_docs"]), rdims["doc_lens"])
    oracle = rep["quality"] >= kw["min_quality"]
    if "domains" in kw:
        oracle &= np.isin(rep["domain"], kw["domains"])
    if "langs" in kw:
        oracle &= np.isin(rep["lang"], kw["langs"])
    if "doc_whitelist" in kw:
        oracle &= np.isin(doc, kw["doc_whitelist"])
    np.testing.assert_array_equal(got[:fact.nrows], oracle)


@pytest.mark.parametrize("name", ["domains", "whitelist"])
def test_pipeline_batches_equal(corpora, name):
    (rfact, _), (fact, _) = corpora
    kw = dict(SELECTIONS[name], seq_len=32, batch_size=2, shuffle_seed=3)
    rp, tp = RPipeline(rfact, RPipelineConfig(**kw)), \
        DataPipeline(fact, PipelineConfig(**kw))
    np.testing.assert_array_equal(tp.selected_positions,
                                  rp.selected_positions)
    assert tp.n_windows == rp.n_windows
    steps = rp.n_windows // 2 + 2  # past an epoch: a reshuffle
    for _ in range(steps):
        want, got = next(rp), next(tp)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32 and got[k].device == CPU
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert tp.cursor() == rp.cursor() == steps


def test_shards_disjoint_resume_and_shifted_labels(corpora):
    _, (fact, _) = corpora

    def mk(r, size=2):
        return DataPipeline(fact, PipelineConfig(
            seq_len=32, batch_size=2, min_quality=40, dp_rank=r,
            dp_size=size))

    p0, p1 = mk(0), mk(1)
    b0, b1 = next(p0), next(p1)
    assert not torch.equal(b0["tokens"], b1["tokens"])
    # one step of both shards reads the windows of one dp_size=1 step of 4
    whole = DataPipeline(fact, PipelineConfig(seq_len=32, batch_size=4,
                                              min_quality=40))
    assert torch.equal(torch.cat([b0["tokens"], b1["tokens"]]),
                       next(whole)["tokens"])
    # resume: seek to the cursor and replay
    p2 = mk(0)
    next(p2)
    second = next(p2)
    p3 = mk(0)
    p3.seek(1)
    assert torch.equal(next(p3)["tokens"], second["tokens"])
    assert torch.equal(second["tokens"][:, 1:], second["labels"][:, :-1])
    with pytest.raises(ValueError, match="too small"):
        DataPipeline(fact, PipelineConfig(seq_len=32, batch_size=4096,
                                          min_quality=40))


def test_launch_train_main_runs_and_loss_falls(tmp_path, caplog):
    caplog.set_level(logging.INFO)
    stats = train_launch.main(
        ["--arch", "smollm_360m", "--smoke", "--device", "cpu", "--steps",
         "8", "--batch", "4", "--seq", "16", "--n-docs", "120", "--lr",
         "3e-3", "--ckpt-dir", str(tmp_path), "--ckpt-every", "4"])
    assert stats.steps_run == 8 and stats.steps_skipped == 0
    assert np.isfinite(stats.losses).all()
    assert stats.losses[-1] < stats.losses[0], stats.losses
    text = caplog.text
    for line in ("corpus: ", "per-domain token counts (engine group-by)",
                 "selection kept", "model smollm-smoke (dense)", "done: 8 "):
        assert line in text, line
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_0000000004", "step_0000000008"]


def test_launch_train_refuses_stub_frontends_and_needs_a_card(monkeypatch):
    for arch in ("musicgen_large", "llava_next_34b"):
        with pytest.raises(SystemExit, match="stubs"):
            train_launch.main(["--arch", arch, "--smoke", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_launch.main(["--arch", "smollm_360m", "--smoke"])


def test_negative_token_ids_wrap_like_the_reference():
    """The Plain token column is stored centered (value - offset, int8 at a
    128-token vocab); both pipelines hand out the stored values, so ids
    can be negative, and both models count a negative id from the end of
    the (padded) vocab, in the embedding and in the loss (ROADMAP.md C8):
    the same loss on the same weights."""
    import dataclasses

    import jax

    from repro import configs as RC
    from repro.models import model as RM
    from repro_torch import configs as TC
    from repro_torch.models import model as TM
    from repro_torch.models.convert import params_from_numpy
    rcfg = dataclasses.replace(RC.get_smoke_config("smollm_360m"),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(TC.get_smoke_config("smollm_360m"),
                               dtype=torch.float32)
    fact, _ = build_synthetic_corpus(CorpusConfig(
        n_docs=60, mean_doc_len=64, vocab_size=tcfg.vocab_size), CPU)
    assert fact.column("tokens").offset != 0
    batch = next(DataPipeline(fact, PipelineConfig(seq_len=16, batch_size=4,
                                                   min_quality=0)))
    assert int(batch["tokens"].min()) < 0 <= int(batch["tokens"].max())
    tree = jax.tree.map(np.asarray, RM.init_params(rcfg,
                                                   jax.random.PRNGKey(0)))
    want = float(jax.jit(lambda p, b: RM.loss_fn(p, rcfg, b))(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v.numpy()) for k, v in batch.items()}))
    got = float(TM.loss_fn(params_from_numpy(tcfg, tree, CPU), tcfg, batch))
    assert np.isfinite(want) and abs(got - want) <= 1e-5 * abs(want)
