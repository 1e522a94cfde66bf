"""Batched LLM serving launcher of the port: prefill + greedy decode with a
KV / SSM-state cache, on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve_model --arch qwen2_1p5b \\
        --smoke --batch 4 --prompt-len 32 --gen 16 [--device cpu]

The same work as ``repro.launch.serve_model``: seeded numpy prompts, a
token-by-token prefill through ``decode_step`` into the cache, then greedy
decode (``argmax`` over ``logits[:, -1].reshape(B, -1)``, padded-vocab
columns included, as the reference does: ROADMAP.md C5), the same printed
lines, and the generated ids returned. Parameters are drawn from a
``torch.Generator`` seeded with ``--seed``; the decode loop runs under
``torch.inference_mode()`` and writes the cache in place. ``generate`` is
the loop alone, for callers that bring their own weights and cache.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models import model as M


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_of(cache: Mapping[str, Any]) -> torch.device:
    """The device of a cache's buffers (KV, or SSM / xLSTM states)."""
    leaf: Any = cache
    while isinstance(leaf, Mapping):
        leaf = next(iter(leaf.values()))
    return leaf.device


def generate(params: M.ParamTree, cfg: M.ModelConfig,
             cache: Dict[str, Any], prompt: np.ndarray, gen: int,
             rng: Optional[np.random.Generator] = None
             ) -> Tuple[np.ndarray, torch.Tensor, Dict[str, float]]:
    """Prefill ``prompt`` ([B, P] int32 ids) token by token into ``cache``,
    then greedy-decode ``gen`` tokens. For the audio family each step's
    input is a frame embedding drawn from ``rng`` (``standard_normal((B, 1,
    d_model))``, P + gen draws in order) and the prompt ids are unused.
    Returns (ids [B, gen] int32, the last step's logits, {"prefill_s",
    "decode_s"} host seconds, each ending in a device synchronise)."""
    dev = _device_of(cache)
    B, P = prompt.shape
    tokens = torch.as_tensor(np.asarray(prompt, np.int32)).to(dev)

    def step_input(tok: torch.Tensor):
        if cfg.family == "audio":
            frame = torch.from_numpy(rng.standard_normal((B, 1, cfg.d_model)))
            return {"embeds": frame.to(cfg.dtype).to(dev)}
        return {"tokens": tok[:, None]}

    outs = []
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits = None
        for i in range(P):
            logits, cache = M.decode_step(params, cfg, cache,
                                          step_input(tokens[:, i]), i)
        _sync(dev)
        t1 = time.perf_counter()
        for i in range(gen):
            nxt = torch.argmax(logits[:, -1].reshape(B, -1), dim=-1)
            nxt = nxt.to(torch.int32)
            outs.append(nxt)
            logits, cache = M.decode_step(params, cfg, cache, step_input(nxt),
                                          P + i)
        _sync(dev)
        t2 = time.perf_counter()
    ids = (torch.stack(outs, dim=1).cpu().numpy() if outs
           else np.zeros((B, 0), np.int32))
    return ids, logits, {"prefill_s": t1 - t0, "decode_s": t2 - t1}


def main(argv=None) -> np.ndarray:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(configs.ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; raises "
                    "without one)")
    args = ap.parse_args(argv)

    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    params = M.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    B, P, G = args.batch, args.prompt_len, args.gen
    cache = M.init_cache(cfg, B, P + G, dev)
    if cfg.family == "audio":
        prompt = np.zeros((B, P), np.int32)
    else:
        prompt = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)

    gen, logits, t = generate(params, cfg, cache, prompt, G, rng)
    t_prefill, t_decode = t["prefill_s"], t["decode_s"]
    print(f"arch={cfg.name} family={cfg.family}")
    print(f"prefill {P} tokens x {B} seqs: {t_prefill:.2f}s "
          f"({B * P / max(t_prefill, 1e-9):.0f} tok/s)")
    print(f"decode  {G} tokens x {B} seqs: {t_decode:.2f}s "
          f"({B * G / max(t_decode, 1e-9):.0f} tok/s)")
    print(f"generated ids (first seq): {gen[0][:16].tolist()}")
    if torch.isnan(logits.float()).any():
        raise RuntimeError(f"{cfg.name}: NaN in the last decode logits")
    return gen


if __name__ == "__main__":
    main()
