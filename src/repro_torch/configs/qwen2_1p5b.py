"""qwen2-1.5b [dense] — GQA with QKV bias.

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936 [arXiv:2407.10671; hf].
12 heads % 16 != 0 -> TP attention fallback (DESIGN.md §6).
"""
import dataclasses

from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab_size=151936, qkv_bias=True, tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen2-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=128)
