"""End-to-end training driver of the port, on the card unless
``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_360m \\
        --smoke --steps 200 --batch 8 --seq 128 --ckpt-dir DIR [--device cpu]

Wires every subsystem together as ``repro.launch.train`` does: the
compressed columnar corpus (``data/``) on the device, engine-driven batch
selection, the train step (``train/step.py``) and the fault-tolerant loop
with async checkpoints (``train/loop.py``), with the reference's flags and
log lines. ``--smoke`` uses the reduced per-arch config. Parameters are
drawn from a ``torch.Generator`` seeded with ``--seed``; the corpus from
numpy's, as the reference draws it. The reference's mesh shardings have
no meaning on one device.
"""
from __future__ import annotations

import argparse
import logging
import time

import torch

from repro_torch import configs
from repro_torch.data import (CorpusConfig, DataPipeline, PipelineConfig,
                              build_synthetic_corpus, corpus_stats)
from repro_torch.device import resolve_device
from repro_torch.train import (AdamWConfig, CheckpointManager, LoopConfig,
                               TrainConfig, TrainLoop, make_train_step)
from repro_torch.train.step import init_train_state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(configs.ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "topk_index", "int8_centered"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--min-quality", type=int, default=40)
    ap.add_argument("--n-docs", type=int, default=3000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; raises "
                    "without one)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    log = logging.getLogger("train")

    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    if cfg.family in ("audio", "vlm"):
        raise SystemExit(
            f"{args.arch}: modality frontends are stubs — use the LM archs "
            "for the end-to-end text driver (examples/serve.py exercises "
            "the stub-frontend decode path).")
    dev = resolve_device(args.device)

    # --- data: compressed corpus + engine-side selection --------------------
    corpus_cfg = CorpusConfig(n_docs=args.n_docs, mean_doc_len=args.seq * 2,
                              vocab_size=cfg.vocab_size, seed=args.seed)
    fact, _dims = build_synthetic_corpus(corpus_cfg, dev)
    plain_bytes = 5 * 4 * fact.nrows
    log.info("corpus: %d tokens; encoded %.2f MiB vs plain %.2f MiB (%.1fx)",
             fact.nrows, fact.nbytes() / 2**20, plain_bytes / 2**20,
             plain_bytes / max(fact.nbytes(), 1))
    stats = corpus_stats(fact)
    log.info("per-domain token counts (engine group-by): %s",
             dict(zip(stats["domain"].tolist(),
                      stats["tokens"].astype(int).tolist())))
    pipe = DataPipeline(fact, PipelineConfig(
        seq_len=args.seq, batch_size=args.batch,
        min_quality=args.min_quality, shuffle_seed=args.seed))
    log.info("selection kept %d/%d tokens (%d windows)",
             len(pipe.selected_positions), fact.nrows, pipe.n_windows)

    # --- model + step ---------------------------------------------------------
    tcfg = TrainConfig(
        adamw=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                          total_steps=args.steps),
        grad_accum=args.grad_accum, grad_compression=args.grad_compression)
    state = init_train_state(
        cfg, tcfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    n_params = sum(int(p.numel()) for p in state.params.parameters())
    log.info("model %s (%s): %.2fM params", cfg.name, cfg.family,
             n_params / 1e6)
    step = make_train_step(cfg, tcfg)

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    loop = TrainLoop(step, state, pipe, ckpt=ckpt, cfg=LoopConfig(
        total_steps=args.steps, checkpoint_every=args.ckpt_every,
        log_every=max(args.steps // 20, 1), handle_sigterm=ckpt is not None))
    t0 = time.perf_counter()
    st = loop.run()
    dt = time.perf_counter() - t0
    tok_per_s = st.steps_run * args.batch * args.seq / max(dt, 1e-9)
    log.info("done: %d steps in %.1fs (%.0f tok/s); loss %.4f -> %.4f; "
             "skipped=%d reloads=%d stragglers=%d",
             st.steps_run, dt, tok_per_s,
             st.losses[0] if st.losses else float("nan"),
             st.losses[-1] if st.losses else float("nan"),
             st.steps_skipped, st.reloads, len(st.stragglers))
    return st


if __name__ == "__main__":
    main()
