"""llava-next-34b [vlm] — anyres tiling VLM backbone.

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000
[hf:llava-hf/llava-v1.6-34b-hf; unverified]. The anyres vision frontend is a
STUB: input_specs() provides precomputed patch embeddings [b, n_img, d_model]
prepended to the token embeddings; ``n_image_tokens``=1024 of the 4096-token
training window. 56 heads % 16 != 0 -> TP attention fallback (DESIGN.md §6;
head-padding to 64 evaluated as a §Perf iteration).
"""
import dataclasses

from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab_size=64000, n_image_tokens=1024,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="llava-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=128, n_image_tokens=8)
