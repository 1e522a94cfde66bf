"""Compressed columnar training corpus (the paper's engine as a data layer).

A tokenized corpus is a star schema over the token stream:

  fact table  — one row per token position:
      tokens    int32  Plain            (high entropy, incompressible)
      doc_id    int32  RLE              (one run per document)
      domain    int32  RLE              (constant within a document)
      lang      int32  RLE              (constant within a document)
      quality   int32  RLE              (constant within a document)

  dimension arrays — one row per document (host-side, small).

Per-token metadata is the paper's RLE sweet spot: every column is constant
over a document, so the encoded footprint is O(#docs) instead of
O(#tokens). The draws are the reference's, in its order, from the same
numpy generator, so every column equals ``repro.data.corpus``'s; the fact
table is ingested by ``repro_torch.core`` onto ``device``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from repro_torch.core import compress
from repro_torch.core.table import Table
from repro_torch.device import DeviceLike


@dataclasses.dataclass
class CorpusConfig:
    n_docs: int = 2_000
    mean_doc_len: int = 256
    vocab_size: int = 50_257
    n_domains: int = 12
    n_langs: int = 8
    quality_levels: int = 100
    seed: int = 0


def build_synthetic_corpus(cfg: CorpusConfig, device: DeviceLike = None
                           ) -> Tuple[Table, Dict[str, np.ndarray]]:
    """Returns (fact table over token positions on ``device``, the card
    when None; dimension arrays on the host)."""
    rng = np.random.default_rng(cfg.seed)
    doc_lens = np.maximum(
        rng.poisson(cfg.mean_doc_len, cfg.n_docs), 8).astype(np.int64)
    n_tokens = int(doc_lens.sum())

    doc_id = np.repeat(np.arange(cfg.n_docs, dtype=np.int32), doc_lens)
    doc_domain = rng.integers(0, cfg.n_domains, cfg.n_docs).astype(np.int32)
    doc_lang = (rng.zipf(1.6, cfg.n_docs) % cfg.n_langs).astype(np.int32)
    doc_quality = np.clip(rng.normal(60, 18, cfg.n_docs), 0,
                          cfg.quality_levels - 1).astype(np.int32)

    tokens = rng.integers(0, cfg.vocab_size, n_tokens).astype(np.int32)

    fact = Table.from_arrays(
        {
            "tokens": tokens,
            "doc_id": doc_id,
            "domain": np.repeat(doc_domain, doc_lens),
            "lang": np.repeat(doc_lang, doc_lens),
            "quality": np.repeat(doc_quality, doc_lens),
        },
        cfg=compress.CompressionConfig(plain_threshold=0),
        encodings={"tokens": "plain", "doc_id": "rle", "domain": "rle",
                   "lang": "rle", "quality": "rle"},
        device=device,
    )
    dims = {
        "doc_lens": doc_lens,
        "doc_domain": doc_domain,
        "doc_lang": doc_lang,
        "doc_quality": doc_quality,
    }
    return fact, dims
