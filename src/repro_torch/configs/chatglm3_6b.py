"""chatglm3-6b [dense] — RoPE-2d, GQA kv=2.

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024 [arXiv:2406.12793; hf].
RoPE-2d is approximated with standard half-dim RoPE (positional-encoding
variant; no systems-behaviour difference — DESIGN.md §5).
"""
import dataclasses

from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab_size=65024, qkv_bias=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="chatglm3-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=128)
