"""Production star-schema workload (paper §9.2 shape) end to end, through
the PyTorch port on the card.

    PYTHONPATH=src python examples/torch_production_star.py            # 1.5M rows, CUDA
    PYTHONPATH=src python examples/torch_production_star.py --cpu --rows 30000

The twin of ``examples/production_star.py``: a fact table with 15 columns
of mixed encodings, a dimension table, bridge-table semi-joins; the
paper's Q1 template (7 semi-joins + a PK-FK join + a SUM group-by) on
compressed and on plain representations, with the footprint table and
each representation's warm time. The plain and compressed answers must
agree. ``make_star``, ``_semi_keys`` and ``rle_friendly`` are copies of
``benchmarks/bench_production.py``'s and ``benchmarks/common.py``'s (the
port does not import the benchmarks).
"""
import argparse
import time

import numpy as np

from repro_torch.core import compress
from repro_torch.core.plan import Query
from repro_torch.core.table import Table
from repro_torch.device import resolve_device, to_numpy

ROWS = 1_500_000
DIMS = {"c2": 64, "c3": 256, "c4": 1000, "c5": 4000, "c8": 50,
        "c9": 200, "c10": 2000}


def rle_friendly(rng, n: int, n_vals: int, mean_run: int) -> np.ndarray:
    """Values with geometric run lengths averaging ``mean_run``."""
    n_runs = max(n // mean_run, 1)
    lens = rng.geometric(1.0 / mean_run, n_runs)
    vals = rng.integers(0, n_vals, n_runs)
    out = np.repeat(vals, lens)[:n]
    if len(out) < n:
        out = np.concatenate([out, np.full(n - len(out), vals[-1])])
    return out.astype(np.int32)


def make_star(rng, n):
    cols = {}
    cards = [4, 16, 64, 256, 1000, 4000, 16000, 1, 50, 200, 2000, 30, 12, 8,
             400]
    for i, card in enumerate(cards):
        if card == 1:
            cols[f"c{i}"] = np.zeros(n, np.int32)  # the single-run column 7
        elif card <= 256:
            cols[f"c{i}"] = rle_friendly(rng, n, card,
                                         mean_run=max(2000 // card, 30))
        else:
            cols[f"c{i}"] = np.sort(rng.integers(0, card, n)).astype(np.int32)
    cols["measure"] = (rng.random(n) * 100).astype(np.float32)
    return cols


def _semi_keys(rng, card, frac):
    k = max(1, int(card * frac))
    return np.unique(rng.integers(0, card, k)).astype(np.int32)


def dim_c6_arrays():
    """The c6 dimension: 16k surrogate PKs and a category attribute."""
    keys = np.arange(16000, dtype=np.int32)
    return {"c6": keys, "d6_cat": (keys % 97).astype(np.int32)}


def q1_template(t, dim_c6):
    """7 semi-joins (paper Q1 shape), a PK-FK join and a SUM group-by."""
    rng2 = np.random.default_rng(7)
    q = Query(t)
    for cname, card in DIMS.items():
        q = q.semi_join(cname, _semi_keys(rng2, card, 0.5))
    q = q.join(dim_c6, fk="c6", cols=["d6_cat"])  # PK-FK join (§8)
    return q.groupby(["d6_cat"], {"revenue": ("sum", "measure"),
                                  "orders": ("count", None)},
                     num_groups_cap=128)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    ap.add_argument("--rows", type=int, default=ROWS)
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    t_start = time.perf_counter()
    N = args.rows
    rng = np.random.default_rng(42)

    print(f"building star schema ({N:,} fact rows, 15 columns)...")
    data = make_star(rng, N)
    fact = Table.from_arrays(
        data, cfg=compress.CompressionConfig(plain_threshold=1000),
        device=dev)
    fact_plain = Table.from_arrays(data, cfg=compress.CompressionConfig(),
                                   encodings={k: "plain" for k in data},
                                   device=dev)

    print("\nfact-table footprint (paper Fig. 10 analogue):")
    print(f"  plain      {fact_plain.nbytes()/2**20:8.2f} MiB")
    print(f"  compressed {fact.nbytes()/2**20:8.2f} MiB "
          f"({fact_plain.nbytes()/fact.nbytes():.1f}x)")
    encs = [fact.encoding_of(k)[0] for k in data]
    print(f"  encodings: {''.join(encs)}  (R=RLE, P=Plain, I/C=composite)")

    dim_c6 = Table.from_arrays(
        dim_c6_arrays(), cfg=compress.CompressionConfig(plain_threshold=1000),
        device=dev)

    out = {}
    for label, t in (("plain", fact_plain), ("compressed", fact)):
        q = q1_template(t, dim_c6)
        res = q.run()  # build
        t0 = time.perf_counter()
        for _ in range(3):
            res = q.run()
        dt = (time.perf_counter() - t0) / 3
        ng = int(res.num_groups)
        revenue = to_numpy(res.aggs["revenue"])[:ng]
        print(f"\n{label}: {dt*1e3:.1f} ms/query; {ng} groups; "
              f"total revenue {float(revenue.sum()):.4g}")
        out[label] = {"d6_cat": to_numpy(res.keys["d6_cat"])[:ng],
                      "revenue": revenue,
                      "orders": to_numpy(res.aggs["orders"])[:ng],
                      "ms": dt * 1e3}
    for k in ("d6_cat", "orders"):
        assert np.array_equal(out["plain"][k], out["compressed"][k]), \
            f"plain and compressed {k} differ"
    np.testing.assert_allclose(out["compressed"]["revenue"],
                               out["plain"]["revenue"], rtol=1e-4)
    out["wall_s"] = time.perf_counter() - t_start
    print("\nproduction star example OK")
    return out


if __name__ == "__main__":
    main()
