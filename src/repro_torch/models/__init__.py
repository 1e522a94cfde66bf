"""Model zoo of the port: every family of the reference's ``repro.models``
(dense GQA, MoE, the Mamba2 hybrid, xLSTM, audio and VLM backbones), in
PyTorch; the recurrent blocks are in ``models.ssm``.

Public API (the reference's names):
  ModelConfig             — architecture hyperparameters (configs/ builds these)
  init_params             — parameters (a ``ParamTree`` of stacked layer leaves)
  forward                 — full-sequence forward (prefill)
  loss_fn                 — causal-LM loss (+ MoE aux losses), differentiable
  init_cache, decode_step — single-token decode with a KV / SSM-state cache,
                            written in place
``convert.params_from_numpy`` loads the reference's parameter tree.
"""
from repro_torch.models.model import (  # noqa: F401
    ModelConfig,
    ParamTree,
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
)
