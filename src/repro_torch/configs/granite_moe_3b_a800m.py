"""granite-moe-3b-a800m [moe] — 40 experts top-8.

32L d_model=1536 24H (GQA kv=8) d_ff=512/expert vocab=49155, MoE 40e top-8
[hf:ibm-granite; hf]. 40 % 16 != 0 -> expert-TP (shard expert d_ff) instead
of EP (DESIGN.md §6 divisibility fallback); vocab 49155 padded to 49168.
"""
import dataclasses

from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab_size=49155, n_experts=40, top_k=8,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="granite-moe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=32, vocab_size=130, n_experts=8, top_k=2)
