"""End-to-end LM training on the compressed-corpus data pipeline, through
the PyTorch port on the card.

    PYTHONPATH=src python examples/torch_train_lm.py                 # quick
    PYTHONPATH=src python examples/torch_train_lm.py --medium        # ~25M params
    PYTHONPATH=src python examples/torch_train_lm.py --cpu --steps 6

The twin of ``examples/train_lm.py``: a synthetic corpus stored as
compressed columns on the device, engine-side selection (quality filter +
domain predicate), the train step with grad accumulation, async
checkpoints, NaN quarantine, all through ``repro_torch.launch.train``. The
loss must fall. Checkpoints go to ``--ckpt-dir``, by default a fresh
temporary directory removed at the end (the reference keeps a fixed one
under /tmp, which a second run resumes from).
"""
import argparse
import dataclasses
import shutil
import sys
import tempfile
import time

import repro_torch.configs.smollm_360m as sm
from repro_torch.launch.train import main as train_main


def run(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--medium", action="store_true",
                    help="~25M params, 300 steps")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    args, _ = ap.parse_known_args(argv)
    own_dir = args.ckpt_dir is None
    ckpt_dir = tempfile.mkdtemp(prefix="torch_train_lm_") if own_dir \
        else args.ckpt_dir

    orig = sm.smoke_config
    if args.medium:
        # the medium config rides the smollm family with a wider smoke
        # config, as the reference's example does
        sm.smoke_config = lambda: dataclasses.replace(
            orig(), name="smollm-25m", n_layers=8, d_model=384, n_heads=6,
            n_kv_heads=2, d_ff=1024, vocab_size=16384)
        steps = args.steps or 300
        seq, batch = 256, 8
    else:
        steps = args.steps or 60
        seq, batch = 128, 8
    try:
        return train_main([
            "--arch", "smollm_360m", "--smoke",
            "--steps", str(steps), "--batch", str(batch), "--seq", str(seq),
            "--lr", "1e-3", "--grad-accum", "2",
            "--ckpt-dir", ckpt_dir, "--ckpt-every", "100",
        ] + (["--device", "cpu"] if args.cpu else []))
    finally:
        sm.smoke_config = orig
        if own_dir:
            shutil.rmtree(ckpt_dir, ignore_errors=True)


def main(argv=None):
    t0 = time.perf_counter()
    stats = run(sys.argv[1:] if argv is None else argv)
    assert stats.losses and stats.losses[-1] < stats.losses[0], \
        "training did not reduce loss"
    print(f"wall {time.perf_counter() - t0:.2f}s")
    print("train_lm example OK")
    return stats


if __name__ == "__main__":
    main()
