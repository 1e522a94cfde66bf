"""yi-9b [dense] — llama-arch GQA.

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000 [arXiv:2403.04652; hf].
"""
import dataclasses

from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab_size=64000,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="yi-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=128)
