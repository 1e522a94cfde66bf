"""SQL-style batch selection on the compressed corpus + batch iterator.

The selection step is the paper's workload: predicate filters on RLE
columns (quality / domain / lang) and a semi-join against a document
whitelist, evaluated on the device by ``repro_torch.core`` without
decompressing the metadata columns (``bucketize_kernel`` under the
semi-join, the RLE decoders under ``decode_mask``). The result is a mask
over the token stream; token windows are gathered from the Plain token
column only at selected positions.

Determinism / elasticity / resume, as the reference:
  * the pipeline is parameterized by (dp_rank, dp_size): shard r reads
    windows r, r+dp_size, r+2·dp_size, ... — disjoint and exhaustive;
  * ``cursor()`` / ``seek()`` round-trip through checkpoints (the train
    loop stores the cursor in the checkpoint manifest);
  * epoch reshuffles are seeded numpy permutations of window indices.
The compacted token stream is kept on the host, as the reference keeps
it; each batch is gathered there and moved to ``device`` as int32.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import arithmetic, join as join_mod, logical
from repro_torch.core.encodings import decode_mask
from repro_torch.core.groupby import groupby_aggregate
from repro_torch.core.table import Table
from repro_torch.device import DeviceLike, to_numpy


@dataclasses.dataclass
class PipelineConfig:
    seq_len: int = 128
    batch_size: int = 8          # per-shard batch
    min_quality: int = 50
    domains: Optional[Sequence[int]] = None   # None = all
    langs: Optional[Sequence[int]] = None
    doc_whitelist: Optional[np.ndarray] = None  # semi-join key set
    dp_rank: int = 0
    dp_size: int = 1
    shuffle_seed: int = 0


def select_token_mask(fact: Table, cfg: PipelineConfig):
    """Evaluate the selection predicate on compressed columns -> mask."""
    q = fact.column("quality")
    mask = arithmetic.compare(q, "ge", cfg.min_quality)
    if cfg.domains is not None:
        dm = arithmetic.compare(fact.column("domain"), "eq",
                                int(cfg.domains[0]))
        for d in cfg.domains[1:]:
            dm = logical.or_masks(
                dm, arithmetic.compare(fact.column("domain"), "eq", int(d)))
        mask = logical.and_masks(mask, dm)
    if cfg.langs is not None:
        lm = arithmetic.compare(fact.column("lang"), "eq", int(cfg.langs[0]))
        for lang in cfg.langs[1:]:
            lm = logical.or_masks(
                lm, arithmetic.compare(fact.column("lang"), "eq", int(lang)))
        mask = logical.and_masks(mask, lm)
    if cfg.doc_whitelist is not None:
        keys = np.unique(np.asarray(cfg.doc_whitelist)).astype(np.int32)
        arr = torch.from_numpy(np.concatenate(
            [keys, [np.iinfo(np.int32).max]]).astype(np.int32)).to(
                fact.device)
        sj = join_mod.semi_join_mask(
            fact.column("doc_id"), arr,
            torch.tensor(len(keys), dtype=torch.int32, device=fact.device))
        mask = logical.and_masks(mask, sj)
    return mask


class DataPipeline:
    """Iterator of {"tokens": [B,S], "labels": [B,S]} int32 batches on
    ``device`` (the fact table's device when None)."""

    def __init__(self, fact: Table, cfg: PipelineConfig,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.device = torch.device(device) if device is not None \
            else fact.device
        mask = select_token_mask(fact, cfg)
        sel = np.flatnonzero(to_numpy(decode_mask(mask))).astype(np.int64)
        self.selected_positions = sel
        tokens = to_numpy(fact.column("tokens").values)
        self.stream = tokens[sel]  # compacted selected-token stream
        self.n_windows = max(len(self.stream) - 1, 0) // cfg.seq_len
        if self.n_windows < cfg.batch_size * cfg.dp_size:
            raise ValueError(
                f"corpus too small after selection: {self.n_windows} windows")
        self._cursor = 0  # global step counter for this shard

    # -- resume ---------------------------------------------------------------

    def cursor(self) -> int:
        return self._cursor

    def seek(self, cursor: int):
        self._cursor = int(cursor)

    # -- iteration -------------------------------------------------------------

    def _window(self, widx: int) -> np.ndarray:
        s = widx * self.cfg.seq_len
        return self.stream[s: s + self.cfg.seq_len + 1]

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        per_step = cfg.batch_size * cfg.dp_size
        steps_per_epoch = self.n_windows // per_step
        step = self._cursor
        epoch = step // steps_per_epoch
        within = step % steps_per_epoch
        order = np.random.default_rng(cfg.shuffle_seed + epoch).permutation(
            self.n_windows)
        base = within * per_step + cfg.dp_rank * cfg.batch_size
        idxs = order[base: base + cfg.batch_size]
        rows = np.stack([self._window(int(w)) for w in idxs]).astype(
            np.int32)
        self._cursor += 1
        return {
            "tokens": torch.from_numpy(rows[:, :-1].copy()).to(self.device),
            "labels": torch.from_numpy(rows[:, 1:].copy()).to(self.device),
        }


def corpus_stats(fact: Table, num_domains_cap: int = 64):
    """Corpus analytics via the engine's group-by (paper §7): per-domain
    token counts and mean quality over the RLE columns
    (``segment_sum_kernel`` on the card)."""
    res = groupby_aggregate(
        {"domain": fact.column("domain"), "quality": fact.column("quality")},
        ["domain"],
        [("tokens", "count", None), ("mean_quality", "avg", "quality")],
        num_groups_cap=num_domains_cap,
    )
    ng = int(res.num_groups)
    return {
        "domain": to_numpy(res.keys["domain"])[:ng],
        "tokens": to_numpy(res.aggs["tokens"])[:ng],
        "mean_quality": to_numpy(res.aggs["mean_quality"])[:ng],
    }
