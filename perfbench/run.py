#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on this machine's card.

    python3 perfbench/run.py --workload resident_scan --seed 7 --seconds 30 --trace 0

Prints the card's name and power limit, the set-up's stages, and last the
result line (one JSON object); the numbers the check compared, each with
its limit, are the last lines on standard error. Exits non-zero, with no
result line, without a card, with fewer cards than the cell asks for, or
outside a checkout of the repository (the program under ``src/``).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        out = f"nvidia-smi failed: {exc}"
    return out or "nvidia-smi printed nothing"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no program under {ROOT / 'src'}: run from a checkout of the "
              "repository", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import harness

    _, cell, _, _ = harness.cell_spec(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    print(f"card: {card_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    line = harness.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), "cuda:0", t_start=T_START)
    return harness.print_result(line)


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
