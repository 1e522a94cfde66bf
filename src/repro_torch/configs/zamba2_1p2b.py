"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks.

38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000, ssm_state=64
[arXiv:2411.15242; hf]. Zamba-style parameter sharing: ONE attention+MLP
block applied after every ``attn_every``=6 Mamba2 layers (6 applications,
2 tail Mamba layers). Sub-quadratic backbone -> runs long_500k.
"""
import dataclasses

from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid_mamba",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32000, ssm_state=64, attn_every=6,
    mamba_head_dim=64,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="zamba2-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab_size=128, ssm_state=16, attn_every=2,
        mamba_head_dim=16, ssd_chunk=8)
