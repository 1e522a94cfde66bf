"""Architecture registry and the assigned input-shape sets of the port.

Every assigned architecture is a module exposing ``CONFIG`` (the published
configuration, shapes only: no weights are downloaded) and
``smoke_config()`` (a reduced same-family config for CPU tests): copies of
``repro.configs``' modules, field for field. Every family is served
and trained. The dry run's ``input_specs`` (ShapeDtypeStruct stand-ins
for the mesh launchers) is not ported yet (ROADMAP.md A16.4).
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.models.model import ModelConfig

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
