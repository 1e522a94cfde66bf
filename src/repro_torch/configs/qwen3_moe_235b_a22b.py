"""qwen3-moe-235b-a22b [moe] — 128 experts top-8.

94L d_model=4096 64H (GQA kv=4) d_ff=1536/expert vocab=151936, MoE 128e top-8
[hf:Qwen/Qwen3-235B-A22B; hf]. 128 % 16 == 0 -> EP over the model axis
(8 experts/device on the 16-way production mesh).
"""
import dataclasses

from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab_size=151936, n_experts=128, top_k=8,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen3-moe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=32, vocab_size=128, n_experts=8, top_k=2)
