"""musicgen-large [audio] — decoder-only over EnCodec tokens.

48L d_model=2048 32H (kv=32, MHA) d_ff=8192 vocab=2048 (per codebook),
4 codebooks [arXiv:2306.05284; hf]. The EnCodec frontend is a STUB:
input_specs() provides precomputed frame embeddings [b, l, d_model]
(sum of codebook embeddings + delay pattern applied upstream); the model
is the transformer BACKBONE + 4 codebook output heads.
"""
import dataclasses

from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=2048, n_codebooks=4,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="musicgen-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab_size=64, n_codebooks=2)
