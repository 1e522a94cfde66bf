"""Train and eval steps of the port.

``make_train_step`` builds the reference's step: microbatch gradient
accumulation in ``accum_dtype``, optional gradient compression (the
paper's encodings on the data-parallel gradients,
``distributed.compression``), then the AdamW update. The reference jits
one functional program that returns a new state; the port runs eagerly and
updates the parameters, moments and step counter in place (the reference
donates its state, so the old one is dead there too). A step whose loss is
not finite applies no update (``optimizer.adamw_update``'s ``apply``), so
``TrainLoop`` can skip it and keep the state as it was.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as M
from repro_torch.train import optimizer as opt
from repro_torch.train import pytree


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: opt.AdamWConfig = opt.AdamWConfig()
    grad_accum: int = 1  # microbatches per step (batch dim must divide)
    grad_compression: str = "none"  # none | topk_index | int8_centered
    topk_frac: float = 0.01  # fraction of entries kept by topk_index
    opt_state_dtype: Any = torch.float32  # bf16 halves optimizer memory
    accum_dtype: Any = torch.float32  # microbatch grad accumulator dtype


@dataclasses.dataclass
class TrainState:
    params: Any  # a ParamTree with trainable leaves
    opt_state: Any  # {"mu": tree, "nu": tree}
    step: torch.Tensor  # 0-d int32 on the parameters' device
    comp_state: Any = None  # error-feedback residuals (grad compression)


def init_train_state(cfg: M.ModelConfig, tcfg: TrainConfig,
                     generator: Optional[torch.Generator] = None,
                     device: DeviceLike = None) -> TrainState:
    """Fresh parameters of ``cfg`` from ``generator`` on ``device`` (the
    card when None), made trainable, with zero moments and step 0."""
    device = resolve_device(device)
    params = M.init_params(cfg, generator, device).requires_grad_(True)
    return state_for(params, tcfg)


def state_for(params: M.ParamTree, tcfg: TrainConfig) -> TrainState:
    """A step-0 ``TrainState`` around given (trainable) parameters."""
    dev = next(params.parameters()).device
    state = TrainState(params=params,
                       opt_state=opt.adamw_init(params, tcfg.opt_state_dtype),
                       step=torch.zeros((), dtype=torch.int32, device=dev))
    if tcfg.grad_compression != "none":
        from repro_torch.distributed import compression as comp
        state.comp_state = comp.init_state(params)
    return state


def _split_microbatches(batch: Mapping[str, torch.Tensor], k: int):
    """[B, ...] -> k microbatches of [B/k, ...] per leaf: microbatch i is
    rows [i B/k, (i + 1) B/k), the reference's split. A DTensor leaf laid
    out over its batch rows is gathered whole first (DTensor cannot fold
    a split dim into two), and each microbatch is laid out as the leaf
    was."""
    from torch.distributed.tensor import DTensor, Replicate

    def sp(x):
        b = x.shape[0]
        if isinstance(x, DTensor):
            whole = x.redistribute(x.device_mesh, (Replicate(),) * len(
                x.placements)).reshape((k, b // k) + tuple(x.shape[1:]))
            return [whole[i].redistribute(x.device_mesh, x.placements)
                    for i in range(k)]
        return x.reshape((k, b // k) + tuple(x.shape[1:]))
    split = {name: sp(x) for name, x in batch.items()}
    return [{name: x[i] for name, x in split.items()} for i in range(k)]


def make_train_step(cfg: M.ModelConfig, tcfg: TrainConfig
                    ) -> Callable[[TrainState, Mapping[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Returns train_step(state, batch) -> (state, metrics)."""

    def value_and_grad(params: M.ParamTree, batch):
        leaves = pytree.leaves(params)
        with torch.enable_grad():
            loss = M.loss_fn(params, cfg, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss does not reach (audio's token embedding) gets
        # zeros, as ``jax.grad`` gives it
        it = iter(g if g is not None else torch.zeros_like(p)
                  for g, p in zip(grads, leaves))
        return loss.detach(), pytree.map_tree(lambda _: next(it), params)

    def accumulate(params, batch):
        if tcfg.grad_accum <= 1:
            return value_and_grad(params, batch)
        loss_sum, g_sum = 0.0, None
        for mb in _split_microbatches(batch, tcfg.grad_accum):
            loss, g = value_and_grad(params, mb)
            if g_sum is None:
                g_sum = pytree.map_tree(
                    lambda x: torch.zeros_like(x, dtype=tcfg.accum_dtype), g)
            loss_sum = loss_sum + loss
            g_sum = pytree.map_tree(lambda a, x: a + x.to(a.dtype), g_sum, g)
        inv = 1.0 / tcfg.grad_accum
        return loss_sum * inv, pytree.map_tree(lambda x: x * inv, g_sum)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        loss, grads = accumulate(state.params, batch)
        comp_state = state.comp_state
        ok = torch.isfinite(loss)
        if tcfg.grad_compression != "none":
            from repro_torch.distributed import compression as comp
            grads, new_comp = comp.compress_decompress(
                grads, comp_state, kind=tcfg.grad_compression,
                topk_frac=tcfg.topk_frac)
            comp_state = pytree.map_tree(lambda new, old: torch.where(
                ok, new, old), new_comp, comp_state)
        _, _, om = opt.adamw_update(tcfg.adamw, state.params, grads,
                                    state.opt_state, state.step, apply=ok)
        metrics = {"loss": loss, **om, "step": state.step.clone()}
        with torch.no_grad():
            state.step.add_(ok.to(state.step.dtype))
        return dataclasses.replace(state, comp_state=comp_state), metrics

    return train_step


def make_eval_step(cfg: M.ModelConfig):
    def eval_step(params, batch):
        with torch.no_grad():
            return M.loss_fn(params, cfg, batch)
    return eval_step
