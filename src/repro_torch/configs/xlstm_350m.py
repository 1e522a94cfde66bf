"""xlstm-350m [ssm] — alternating mLSTM / sLSTM blocks.

24L d_model=1024 4H d_ff=0 vocab=50304 [arXiv:2405.04517; unverified].
d_ff=0: blocks carry their own projections (mLSTM proj-factor 2; sLSTM
post-block gated MLP pf 4/3). 1:1 alternation (12 mLSTM/sLSTM pairs).
O(1)-state decode -> runs long_500k.
"""
import dataclasses

from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="xlstm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="xlstm-smoke", n_layers=4, d_model=48, n_heads=2,
        n_kv_heads=2, vocab_size=128)
