"""smollm-360m [dense] — llama-arch small.

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152
[hf:HuggingFaceTB/SmolLM-360M; hf]. 15 heads % 16 != 0 -> TP attention
fallback to replicated heads (DESIGN.md §6); FFN and vocab stay sharded.
"""
import dataclasses

from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab_size=49152, tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="smollm-smoke", n_layers=2, d_model=60, n_heads=3,
        n_kv_heads=1, d_ff=128, vocab_size=128)
