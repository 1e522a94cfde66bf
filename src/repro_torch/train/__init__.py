"""Training substrate of the port: AdamW, the train step with microbatches
and gradient compression, the fault-tolerant loop and checkpoints (the
reference's ``repro.train``, on one device)."""
from repro_torch.train.optimizer import (  # noqa: F401
    AdamWConfig, adamw_init, adamw_update, lr_at)
from repro_torch.train.step import (  # noqa: F401
    TrainConfig, TrainState, make_eval_step, make_train_step)
from repro_torch.train.checkpoint import CheckpointManager  # noqa: F401
from repro_torch.train.loop import LoopConfig, TrainLoop  # noqa: F401
