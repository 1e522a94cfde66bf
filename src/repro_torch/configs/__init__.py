"""Architecture registry and the assigned input-shape sets of the port.

Every assigned architecture is a module exposing ``CONFIG`` (the published
configuration, shapes only: no weights are downloaded) and
``smoke_config()`` (a reduced same-family config for CPU tests): copies of
``repro.configs``' modules, field for field. Every family is served
and trained. ``input_specs`` builds the dry run's stand-ins of every model
input of an (arch x shape) cell: tensors on the ``meta`` device, with the
keys, shapes and dtypes of the reference's ``ShapeDtypeStruct``s, so
nothing is allocated (``launch/dryrun.py``).
"""
from __future__ import annotations

import importlib
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.model import ModelConfig, init_cache

ARCHS = (
    "zamba2_1p2b",
    "smollm_360m",
    "chatglm3_6b",
    "yi_9b",
    "qwen2_1p5b",
    "granite_moe_3b_a800m",
    "qwen3_moe_235b_a22b",
    "xlstm_350m",
    "musicgen_large",
    "llava_next_34b",
)

# canonical shape set for the LM pool (seq_len, global_batch, kind)
SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def _module(name: str):
    return importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_')}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()


def shape_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """long_500k needs sub-quadratic attention."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k skipped: pure full-attention arch (O(S^2))"
    return True, ""


def input_specs(cfg: ModelConfig, shape: str,
                batch_override: Optional[int] = None):
    """Meta-device stand-ins for every model input of (arch x shape).

    Train and prefill cells return the batch dict; decode cells return
    (batch, cache, pos): the cache is ``init_cache`` on the meta device and
    ``pos`` a 0-d int32."""
    seq, gb, kind = SHAPES[shape]
    gb = batch_override or gb
    meta = torch.device("meta")

    def spec(shape_, dtype=torch.int32):
        return torch.empty(shape_, dtype=dtype, device=meta)

    if kind in ("train", "prefill"):
        if cfg.family == "audio":
            batch = {"embeds": spec((gb, seq, cfg.d_model), torch.bfloat16),
                     "labels": spec((gb, seq, cfg.n_codebooks))}
        elif cfg.family == "vlm":
            n_img = cfg.n_image_tokens
            batch = {"tokens": spec((gb, seq - n_img)),
                     "patch_embeds": spec((gb, n_img, cfg.d_model),
                                          torch.bfloat16),
                     "labels": spec((gb, seq))}
        else:
            batch = {"tokens": spec((gb, seq)), "labels": spec((gb, seq))}
        if kind == "prefill":
            batch.pop("labels")
        return batch

    # decode: one new token against a seq-length cache
    if cfg.family == "audio":
        batch = {"embeds": spec((gb, 1, cfg.d_model), torch.bfloat16)}
    else:
        batch = {"tokens": spec((gb, 1))}
    return batch, init_cache(cfg, gb, seq, meta), spec(())
