"""The whole device's share of its memory-bandwidth roofline, in %: the
bytes that the inputs of the queries answered in the profiled slice need
(each shape's ``input_bytes``), over the card's published rate
(``perfbench/peaks.json``), over the slice's device busy time."""
import json
from pathlib import Path

from perfbench.metrics import _slice

PEAKS = json.loads((Path(__file__).resolve().parents[1] / "peaks.json")
                   .read_text())


def read(run):
    done = _slice.answered(run)
    if not done or run.device.type != "cuda":
        return None
    import torch
    peak = PEAKS.get(torch.cuda.get_device_name(run.device))
    if peak is None:
        return None
    need = sum(run.input_bytes[r.shape] for r in done)
    return 100.0 * need / peak["hbm_bytes_per_s"] / run.slice.busy_s
