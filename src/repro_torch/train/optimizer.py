"""AdamW with decoupled weight decay, global-norm clipping and a
warmup + cosine schedule, in torch (the reference's pure-JAX optimizer).

Moments are float32 unless ``adamw_init`` is asked for another dtype; the
update runs in float32 and is cast back to each parameter's dtype (bf16
params + fp32 moments, the mixed-precision recipe). The reference returns
new trees; the port writes parameters and moments in place under
``torch.no_grad()``. ``apply`` (a 0-d bool tensor) keeps every leaf as it
was where it is false, with no host round trip: the train step passes
``isfinite(loss)``, so a step whose loss is not finite changes nothing
(``TrainLoop``'s quarantine keeps the state as it was).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.train import pytree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_frac·lr (float32, on
    ``step``'s device)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def adamw_init(params, state_dtype=torch.float32) -> Dict[str, Any]:
    """Zero moments beside each leaf. ``state_dtype=torch.bfloat16`` halves
    optimizer memory; the moment math still runs in float32."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=state_dtype, device=p.device)
    return {"mu": pytree.map_tree(zeros, params),
            "nu": pytree.map_tree(zeros, params)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(x.float() ** 2)
                          for x in pytree.leaves(tree)))


def adamw_update(cfg: AdamWConfig, params, grads, opt_state, step,
                 apply: Optional[torch.Tensor] = None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place. Returns (params, opt_state, metrics):
    the same trees, updated. Weight decay applies to leaves with ndim >= 2
    (matrices; norms, biases and gates are 1-d)."""
    with torch.no_grad():
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        lr = lr_at(cfg, step)
        t = torch.as_tensor(step).to(torch.float32) + 1.0
        bc1 = 1 - cfg.b1 ** t
        bc2 = 1 - cfg.b2 ** t
        for p, g, mu, nu in zip(pytree.leaves(params), pytree.leaves(grads),
                                pytree.leaves(opt_state["mu"]),
                                pytree.leaves(opt_state["nu"])):
            g32 = g.float() * scale
            mu32 = cfg.b1 * mu.float() + (1 - cfg.b1) * g32
            nu32 = cfg.b2 * nu.float() + (1 - cfg.b2) * g32 * g32
            upd = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + cfg.eps)
            if cfg.weight_decay and p.ndim >= 2:
                upd = upd + cfg.weight_decay * p.float()
            new_p = (p.float() - lr * upd).to(p.dtype)
            new_mu, new_nu = mu32.to(mu.dtype), nu32.to(nu.dtype)
            if apply is not None:
                new_p = torch.where(apply, new_p, p)
                new_mu = torch.where(apply, new_mu, mu)
                new_nu = torch.where(apply, new_nu, nu)
            p.copy_(new_p)
            mu.copy_(new_mu)
            nu.copy_(new_nu)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
