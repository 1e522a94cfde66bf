#!/usr/bin/env python3
"""The control of the check that decides ``correct``: the plain reference
computed in bfloat16 (the precision below the float32 that the
configurations state), put in the program's place. It must come out as
not correct. Run at a cell's own size:

    python3 perfbench/control.py --workload served_mix --seeds 11,12,13

prints, for each seed, the numbers the check compares (one answer a
shape of the cell's mix, compared as a run compares the program's) and
whether the check held. The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_checks(workload: str, seed: int, scale=None, device=None,
                   data=None):
    """``(checks, ok)`` with the control's answers in the program's place,
    one answer a shape of ``workload``'s mix."""
    from perfbench import generate, harness

    _, _, cfg, traffic = harness.cell_spec(workload)
    if data is None:
        data = generate.make(cfg, seed, device=device, scale=scale)
    run = harness.Run(workload=workload, seed=seed, seconds=0.0, traced=False,
                      cfg=cfg, traffic=traffic, device=device)
    for name in sorted(traffic["shapes"]):
        ref = harness.plugin("reference", name)
        run.requests.append(harness.Request(
            client=0, shape=name, t_call=0.0,
            answer=ref.answer(data, lower=True)))
    return harness.check_answers(run, data)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, action="append",
                    help="a cell; cells of one configuration share its data")
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench import generate, harness
    device = torch.device("cuda:0") if torch.cuda.is_available() else None
    for seed in (int(s) for s in args.seeds.split(",")):
        data = {}
        for workload in args.workload:
            _, _, cfg, _ = harness.cell_spec(workload)
            key = json.dumps({k: cfg[k] for k in (
                "scale_factor", "lineitem_columns", "part_columns",
                "sort_order")}, sort_keys=True)
            if key not in data:
                data = {key: generate.make(cfg, seed, device=device)}
            t = time.perf_counter()
            checks, ok = control_checks(workload, seed, data=data[key])
            print(json.dumps({"workload": workload, "seed": seed,
                              "control_correct": ok, "checks": checks,
                              "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
