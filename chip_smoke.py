#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # TPC-H scale factor 10, ~60M LINEITEM rows
    python3 chip_smoke.py --sf 0.01  # a quick rehearsal at a small scale
    python3 chip_smoke.py --models   # only the model phase (step 8)
    python3 chip_smoke.py --train    # only the training phase (step 9)
    python3 chip_smoke.py --mesh     # only the mesh phase (step 10)
    python3 chip_smoke.py --examples # only the examples phase (step 11)

What it does, in order, failing (non-zero exit, no result line) on the
first error:

1. Prints the card's name and power limit (``nvidia-smi``), the torch and
   CUDA versions, and the time to build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel).
2. Kernel checks: each of the eight kernels against its plain PyTorch
   version on the card, on edge cases (empty inputs, ragged tails,
   duplicates, right=True/False, int32/float32, sentinel-padded
   boundaries, gaps with a non-zero fill, out-of-range ids; for the packed
   kernels every bit width of {1, 2, 3, 7, 8, 9, 16, 21, 24, 31, 32},
   values straddling lanes, N = 0 and 1, negative offsets, width-32 wrap,
   boundaries above the shared-memory route, a partially covered RLE with
   ``n < cap``; for both RLE decoders the draws of ``RLE_DRAWS`` (long
   runs, a run a row, short runs with gaps and a fill, ``n`` below the
   filled slots and 0, rows past every end, repeated ends, ragged row
   counts; int32 and float32 bit for bit, bit widths 1, 4, 13 and 32) at
   the resident grid and capped grids, and about 2^21 short runs over
   2^23 rows; for topk int32 and float32, n in {0, 1, 7, 2047, 2048,
   2049, 1_000_003} by k in {1, 8, 37, 128, 256}, all-equal inputs,
   INT32_MIN rows, +-inf, signed zeros, an input of a survivor pass,
   3M-key ascending, descending, tied and nearly-all-INT32_MIN inputs,
   three grid caps that must give the same bits, and views at offsets 1-3;
   for bucketize_kernel also query views at storage offset 1 with
   nq % 4 != 0; for bucketize_count_kernel sorted, random, clustered,
   all-equal, NaN and out-of-range queries at 58,113, 97,532 and 2^23
   boundaries, aligned and at offset 1, tiles at the window-or-splitter
   edge, grid caps and splitter counts; for segment_sum_kernel G in
   {1, 2, 16, 31, 32, 33, 512, 4096}, float32 and int32, ids in range,
   mostly or all dropped, negative, a ragged tail). Integer outputs, the
   decoders and topk must be equal (topk values and indices, and
   bit-identical across two launches); int32 segment sums equal to the
   plain version (wrapping ``index_add_``); float32 segment sums within
   rtol=1e-4 of a float64 host sum; every segment sum bit-identical across
   launches, grid caps and an offset view.
3. Resident query phase: TPC-H-shaped LINEITEM (each query sorted by its
   Table 7 order) and ORDERS at the chosen scale, seed 2, ingested with
   ``CompressionConfig(plain_threshold=1_000)`` onto the card; Q1, Q3,
   Q6, Q17 and Q19 run through ``repro_torch`` ``Query``. Every answer is
   checked against a numpy oracle (integers exact, float sums rtol=1e-4)
   and every re-run is bit-identical. Each query's line tallies the RLE
   decoders' launches by shape class (``decoder_shapes_per_run``, as the
   streamed and ranked lines do). Launch counts are zeroed just
   before this phase and read just after it; the run fails if any of the
   four resident-path kernels was not launched.
4. Out-of-core phase: the same LINEITEM arrays of Q1, Q6, Q17 and Q3 and
   the same ORDERS, ingested as ``PartitionedTable.from_arrays(...,
   partition_rows=1 << 23, pack=True, budget_bytes=1 << 30)`` (host
   partitions, pinned, bit-packed) and streamed through
   ``PartitionedQuery.run()``. Each answer must match its oracle and the
   resident answer, be bit-identical at prefetch depth 0, 1 and 2, and
   match the same query over ``pack=False`` partitions; Q6 also runs
   under a seeded fault plan (3 transient transfers, 1 OOM) that must fire
   in full and recover bit-identically. Per query it prints partitions
   visited and pruned, bytes moved packed and unpacked, the stage ms, warm
   wall ms at depth 0 and 2, ``unpack_kernel`` launches a run (each packed
   leaf once a partition's program), the device memory of a depth-2 run
   at its peak (``torch.cuda.max_memory_allocated``, and over what was
   held before it) beside the largest partition's unpacked bytes, and the
   H2D bound (bytes over the pinned
   bandwidth measured here with one 1 GiB copy). Launch counts are zeroed
   just before the phase and read just after; the run fails if any of the
   three packed kernels was not launched.
5. Ordering phase (ORDER BY / TOP-K): R1, a row-level top-100 by the
   Plain float ``price`` after ``shipdate <= 2400`` on the Q1-ordered
   table (``topk_kernel`` over the dense rank keys); R2, a top-1000 by
   (``quantity`` desc, ``shipdate`` asc) on the Q6-ordered table (RLE
   keys: the bounded-histogram path, no kernel); Q3r, Q3 ranked by
   (``revenue`` desc, ``orderdate`` asc), top 10 (group slots ranked after
   the join and group-by). Each runs on the resident table and streamed
   over the out-of-core phase's packed partitions at prefetch depth 0, 1
   and 2. Answers must equal a numpy oracle (``np.lexsort``, stable, over
   the candidates of an ``np.partition`` threshold; positions and integer
   columns exactly, Q3r's float sums within rtol=1e-4), re-runs and
   depths must be bit-identical, streamed R1 and R2 bit-identical to
   resident, and R2 must prune partitions by rank. Launch counts are zeroed
   just before the phase and read just after; the run fails if
   ``topk_kernel`` was not launched.
6. Serving phase (``core/serve.py``): a ``QueryServer`` over the
   Q1-ordered packed partitions of the ordering phase (ORDERS resident)
   answers a mix of 7 shapes: Q1, Q1s (Q1 cut at ``shipdate <= 2000``),
   Q6, Q17, Q3, Q3r and R1 (row terminal: the solo path). Each shape is
   first run alone (``PartitionedQuery.run()``, depth 2) and checked
   against its numpy oracle on this table's arrays. Server A holds the
   whole table (``budget_bytes=nbytes()`` plus the CUDA graphs' input
   slot, which the budget includes; ``max_batch=8``, drain
   thread): four client threads submit the mix in seeded orders, a cold
   round and a warm round; the warm round must hit the plan cache on
   every submission and move no H2D byte (``telemetry.h2d_listener``).
   Server B holds a third of the table: the mix queued once and stepped,
   which must evict and split into several batches. Every served answer
   must be bit-identical to its solo run and match the oracle; a failed
   ticket or a dead drain thread fails the run. One JSON line a round
   (QPS, p50/p99/mean latency, plan-cache and residency hits, misses and
   evictions, resident bytes, scan passes shared and solo, H2D bytes,
   launches a kernel), beside the card's name and power limit. Launch
   counts are zeroed after the solo runs and read after server B; the
   run fails if ``unpack_kernel``, ``segment_sum_kernel`` or
   ``topk_kernel`` was not launched.
7. Kernel timing at the largest inputs the main path gave each kernel:
   kernel, plain-version and (where one PyTorch call computes the same
   function) library times by CUDA events, beside the least time the card
   could take (bytes over 3.35 TB/s, or operations over 67 TFLOP/s,
   whichever is larger). Two times of the kernel and of the library
   call: per launch (``ms``: events around one call, so the host's
   dispatch of the call is inside the window; median of 10 after warm-up,
   of 30 each where a library call is timed in turns with the kernel) and
   back to back (``ms_back_to_back``: N calls between one pair of events,
   over N). ``topk_kernel`` is also timed at one streamed partition
   (2^23 keys), at R1's length in ascending order (its worst case), and
   back to back at grid caps of 1, 2 and 4 blocks an SM;
   ``bucketize_kernel`` and ``torch.searchsorted`` get their host time a
   call (host clock, no synchronisation inside a batch) and their device
   time a call (``torch.profiler``). ``segment_sum_kernel`` is also timed
   beside ``index_add_`` at G = 1 and 16 at 59,986,052 and 2^23 rows and
   at G = 512 at 59,986,052, float32 and int32; ``bucketize_count_kernel``
   beside ``torch.searchsorted`` at Q17's semi-join shape and at Q3's
   shape with random queries. The two RLE decoders add their device time
   a call (``device_ms``, ``torch.profiler``).
8. Model phase (the LLM serving path, ``repro_torch.models`` and
   ``launch/serve_model.py``; no kernel of its own: the reference computes
   it in plain ``jnp``). The query phases' tables are released first.
   qwen2-1.5b, granite-moe-3b-a800m, zamba2-1.2b and xlstm-350m at full
   width in bf16, weights drawn on the card from ``--seed``: two runs each
   of ``serve_model``'s
   loop (batch 4, a 32-token seeded prompt prefilled token by token, 16
   greedy tokens) that must give the same ids and no NaN, then
   teacher-forced ``decode_step`` logits against ``forward`` on the
   prompts' first 16 tokens, relative max error below 2e-2 (capacity
   factor 16, as ``tests/test_models.py``; xlstm's on float32 copies of the
   weights, its bf16 gap printed: ``MODEL_FLOAT32_CHECK``; zamba2's bf16
   and float32 gaps printed and not gated, as its decode keeps a bf16 conv
   window that parts it from forward at depth in the reference too:
   ``MODEL_UNGATED``). One JSON line a model:
   prefill and decode tokens/s of each run, the peak device memory of
   the serving runs (``torch.cuda.max_memory_allocated``), the error,
   and one decode step's profile (device busy ms, idle share, launches).
   Then every smoke arch in float32 on the card against the CPU with the
   same weights: forward and teacher-forced decode logits within a
   relative max error of 1e-3.
9. Training phase (``repro_torch.{data,train}``): a synthetic corpus of
   50,000 documents (about 12.8M tokens, RLE metadata) built on the card,
   selected by quality, domains, languages and a document whitelist and
   summarised by ``corpus_stats``; the selection must equal its oracle
   from the metadata decoded on the card and the same pipeline on the
   CPU. Launch counts are zeroed just before the pipeline and read just
   after it and the stats, before the oracle; the run fails if
   ``bucketize_kernel`` or ``segment_sum_kernel`` was not launched (the
   selection reaches no RLE value decoder: ``decode_mask`` of an RLE mask
   is a coverage sweep). Then smollm-360m at full
   width (bf16, float32 AdamW moments) trains 8 steps on the pipeline's
   first 4 x 128 batch, repeated, at ``grad_accum`` 2: every loss finite,
   the last below the first; one more step under ``torch.profiler``; a
   blocking checkpoint of the whole state, restored on the card bit for
   bit. One JSON line: step ms, tokens/s, peak memory, the step's idle
   share and launches, the checkpoint's bytes and seconds, the data
   path's ms and launches.
10. Mesh phase (``launch/mesh.py``, ``distributed/sharding.py``,
   ``compression.allreduce_topk``, the elastic restore,
   ``launch/dryrun.py``): a world of one on NCCL through an in-process
   store and its (1, 1) ``DeviceMesh`` on the card (gloo or the CPU fail
   the run); qwen2-1.5b's smoke params laid out by ``named_shardings`` as
   DTensors and gathered back (``full_tensor``) bit for bit;
   ``allreduce_topk`` over the mesh's data group on a float32 leaf of the
   full width (one layer's ``mlp/w_up``, 1536 x 8960) and a bfloat16 leaf,
   each of distinct magnitudes, equal bit for bit to the single-device
   projection (``compression._topk_project``), with its ms a call; a
   checkpoint restored onto the mesh (``restore(..., shardings=)``) bit
   for bit; (a) one MoE layer of qwen3-moe at full width (4.8 GB of bf16
   experts, 4 x 256 tokens) through the expert-parallel body
   (``layers.moe_on_mesh``: its all-gather and both all-to-alls on the
   mesh's NCCL groups) against the local ``moe``: the slots equal, y
   within ``MESH_EP_BOUND``, ms a call of each in turns; (b)
   granite-moe-3b-a800m's full-width forward on DTensor params and batch
   (``MESH_DT_AXES``) against the plain forward within ``MESH_DT_BOUND``,
   and a greedy ``decode_step`` loop on a DTensor cache with the same ids
   and logits, wall s of each; then (c) the dry run as one rank of the
   production mesh (``MESH_CELLS``: qwen3-moe-235b-a22b x train_4k on the
   fake world of 256 ranks, qwen2-1.5b x decode_32k on the fake world of
   512; the rank's memory, FLOPs, bytes and collectives, traced on the
   CPU), each record ``ok``, a MoE record with all-to-alls, its FLOPs and
   peak a device beside the reference's (``MESH_CELL_REFERENCE``) and
   within ``MESH_CELL_BOUNDS`` of them, and each equal but for its timings
   and the card's memory to the record the CPU tests hold for the same
   torch release (``MESH_CELL_RECORDS``). Five JSON lines.
11. Examples phase: the five twins of ``examples/`` (``torch_quickstart``,
   ``torch_production_star``, ``torch_serving_demo``,
   ``torch_serve_batched``, ``torch_train_lm``) at their reference sizes on
   the card, in this process, each asserting its own oracles; each one's
   output echoed, its line of OK required, and one JSON line of its wall
   time and kernel launches (zeroed just before it, read just after). The
   run fails if ``bucketize_kernel``, ``segment_sum_kernel``,
   ``unpack_kernel`` or ``topk_kernel`` was launched by none of them.
12. A ``launches`` line (per query phase: launches, and a tally by shape
   class, ``_build.SHAPES``), a ``{"kernels": [...]}`` summary line whose
   ``launches`` sum every phase's, the training data path's and the
   examples' included, then as the last line ``{"ok": true, "device":
   {"platform": "gpu", ...}}``.

Other modes, for measurements (they stop early and print no result
line): ``--kernel-bench`` times every kernel at the main path's shapes on
seeded inputs (and both RLE decoders at a short-run shape too: about 2^21
runs of 1-4 rows with gaps over 2^23 rows; ``unpack_kernel`` and
``bucketize_packed_kernel`` also at the streamed path's smaller launch
classes, the latter on Q17's sorted, code-0 padded run values and on
random ones), per launch, back to back and on the device; ``--models``
runs only the model phase; ``--train`` only the training phase;
``--mesh`` only the mesh phase; ``--examples`` only the examples phase;
``--queries Q3,Q17`` runs only those queries, resident
and streamed (with ``--profile``, their profiles); ``--src DIR`` imports
``repro_torch`` from another checkout's ``src`` (its kernels build
there), so one call can time a parent tree and this one in turns.

The script imports neither JAX nor the JAX package; the TPC-H generators
below are copies of ``benchmarks/bench_tpch.py``'s.
"""
from __future__ import annotations

import argparse
import atexit
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
LINEITEM_ROWS = {1.0: 6_001_215, 10.0: 59_986_052}  # TPC-H's own counts
SF1_ORDERS = 1_500_000
KERNEL_INFO = {
    "bucketize_kernel": ("src/repro_torch/kernels/csrc/bucketize.cu",
                         "src/repro/kernels/bucketize.py:60"),
    "bucketize_count_kernel": ("src/repro_torch/kernels/csrc/bucketize.cu",
                               "src/repro/kernels/bucketize.py:96"),
    "rle_decode_kernel": ("src/repro_torch/kernels/csrc/rle_decode.cu",
                          "src/repro/kernels/rle_decode.py:40"),
    "segment_sum_kernel": ("src/repro_torch/kernels/csrc/segment_reduce.cu",
                           "src/repro/kernels/segment_reduce.py:43"),
    "unpack_kernel": ("src/repro_torch/kernels/csrc/unpack.cu",
                      "src/repro/kernels/unpack.py:88"),
    "bucketize_packed_kernel": ("src/repro_torch/kernels/csrc/bucketize.cu",
                                "src/repro/kernels/unpack.py:122"),
    "rle_decode_packed_kernel": ("src/repro_torch/kernels/csrc/unpack.cu",
                                 "src/repro/kernels/unpack.py:169"),
    "topk_kernel": ("src/repro_torch/kernels/csrc/topk.cu",
                    "src/repro/kernels/topk.py:119"),
}
RESIDENT_KERNELS = ("bucketize_kernel", "bucketize_count_kernel",
                    "rle_decode_kernel", "segment_sum_kernel")
PACKED_KERNELS = ("unpack_kernel", "bucketize_packed_kernel",
                  "rle_decode_packed_kernel")
PACK_BITS = (1, 2, 3, 7, 8, 9, 16, 21, 24, 31, 32)
OOC_QUERIES = ("Q1", "Q6", "Q17", "Q3")  # the out-of-core phase's queries
# the ordering phase's queries and the LINEITEM sort order each reads
RANKED_SOURCE = {"R1": "Q1", "R2": "Q6", "Q3r": "Q3"}
ORDER_KERNELS = ("topk_kernel",)
# the serving phase's mix (7 shapes over one packed LINEITEM), the table
# it serves, and the kernels its run must launch
SERVE_MIX = ("Q1", "Q1s", "Q6", "Q17", "Q3", "Q3r", "R1")
SERVE_SOURCE = "Q1"
SERVE_KERNELS = ("unpack_kernel", "segment_sum_kernel", "topk_kernel")
SERVE_CLIENTS = 4
# the model phase: full-width archs (bf16), serving shape, and bounds
MODEL_FULL = ("qwen2_1p5b", "granite_moe_3b_a800m", "zamba2_1p2b",
              "xlstm_350m")
MODEL_BATCH, MODEL_PROMPT, MODEL_GEN = 4, 32, 16
MODEL_PREFIX = 16  # teacher-forced decode against forward on this prefix
MODEL_DECODE_BOUND = 2e-2  # tests/test_models.py::test_decode_matches_forward
MODEL_SMOKE_RTOL = 1e-3  # float32 smoke archs, card against CPU
# families whose decode-against-forward bound is checked on float32 copies
# of the weights, as tests/test_models.py checks it (the bfloat16 gap is
# printed, not gated; ROADMAP.md C9). At full depth the reference's own
# two forms part in bfloat16 by more than the bound (on the CPU, d_model
# cut to 256: zamba2's 38 layers 0.279, xlstm's 24 layers 0.589): a
# rounding difference grows layer by layer and step by step.
MODEL_FLOAT32_CHECK = ("hybrid_mamba", "xlstm")
# ... and of those, the families whose float32 gap is printed, not gated:
# Mamba2's decode keeps the window of its last three conv inputs in
# bfloat16 whatever the dtype (ssm.py:167), and that rounding alone parts
# the reference's own decode from its forward by about 0.1 at 38 layers
# (tests/test_torch_models.py::test_full_depth_decode_departs_as_the_reference
# holds the port's gap to the reference's there, on the CPU)
MODEL_UNGATED = ("hybrid_mamba",)
# the training phase: smollm-360m at full width (bf16, float32 AdamW
# moments), one repeated batch of TRAIN_BATCH x TRAIN_SEQ tokens drawn by
# the engine-backed pipeline from a synthetic corpus of about 12.8M tokens
TRAIN_ARCH = "smollm_360m"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM, TRAIN_STEPS = 4, 128, 2, 8
TRAIN_DOCS, TRAIN_DOC_LEN = 50_000, 256
# the kernels the training data path launches: the selection's semi-join
# and mask merges (bucketize) and corpus_stats (segment_sum). The RLE value
# decoder is not on it: decode_mask of an RLE mask is a coverage sweep
# (scatter + cumsum) in both packages, and the tokens are Plain.
TRAIN_KERNELS = ("bucketize_kernel", "segment_sum_kernel")
# the mesh phase: a world of one on NCCL, qwen2-1.5b's smoke params laid
# out as DTensors, the compressed all-reduce on a float32 leaf of the full
# width (one layer's mlp/w_up) and a bfloat16 leaf, and one dry-run cell
MESH_ARCH = "qwen2_1p5b"
MESH_TOPK_FRAC = 0.01
MESH_F32_LEAF = (1536, 8960)
MESH_BF16_LEAF = (128, 128)
# (c) the dry run (``launch/dryrun.py``) as rank 0 of a fake world of the
# production mesh's size, each cell traced by a child process on the CPU
# beside the phases that use the card: (arch, shape, mesh)
MESH_CELLS = (("qwen3_moe_235b_a22b", "train_4k", "single"),
              ("qwen2_1p5b", "decode_32k", "multi"),
              ("xlstm_350m", "train_4k", "single"),
              ("zamba2_1p2b", "train_4k", "single"))
# the records of MESH_CELLS without CELL_UNFROZEN, by the torch release
# that traced them (on the CPU; DTensor's redistributions differ between
# releases: 2.11 all-reduces a partial sum where 2.13 reduce-scatters it,
# and picks other layouts for a few products; PERF.md section 6)
MESH_CELL_RECORDS = {
    "2.11.0": (
        {
            "arch": "qwen3_moe_235b_a22b",
            "shape": "train_4k",
            "mesh": "single",
            "n_devices": 256,
            "status": "ok",
            "aten_ops": 1522990,
            "memory": {
                "argument_bytes": 5460099076,
                "output_bytes": 16,
                "temp_bytes": 11944473117,
                "peak_estimate_bytes": 17404572193},
            "cost": {
                "flops_per_device": 814933337462011.0,
                "bytes_accessed_per_device": 29340534993273.0},
            "collectives": {
                "bytes_by_type": {
                    "all-gather": 44397677568.0,
                    "all-reduce": 748906476.0,
                    "reduce-scatter": 411345354752.0,
                    "all-to-all": 189246996480.0,
                    "collective-permute": 0.0,
                    "collective-broadcast": 0.0},
                "count_by_type": {
                    "all-gather": 17389,
                    "all-reduce": 6875,
                    "reduce-scatter": 9816,
                    "all-to-all": 4512,
                    "collective-permute": 0,
                    "collective-broadcast": 0},
                "total_bytes": 645738935276.0},
            "model_flops_global": 1.1852782592065536e+17,
            "act_seq_axis": "model",
            "remat": "full",
            "fits_hbm": True},
        {
            "arch": "qwen2_1p5b",
            "shape": "decode_32k",
            "mesh": "multi",
            "n_devices": 512,
            "status": "ok",
            "aten_ops": 11894,
            "memory": {
                "argument_bytes": 247229972,
                "output_bytes": 1215488,
                "temp_bytes": 58343424,
                "peak_estimate_bytes": 305573396},
            "cost": {
                "flops_per_device": 2330666100.0,
                "bytes_accessed_per_device": 1193004644.0},
            "collectives": {
                "bytes_by_type": {
                    "all-gather": 4100608.0,
                    "all-reduce": 10516992.0,
                    "reduce-scatter": 0.0,
                    "all-to-all": 0.0,
                    "collective-permute": 0.0,
                    "collective-broadcast": 0.0},
                "count_by_type": {
                    "all-gather": 282,
                    "all-reduce": 337,
                    "reduce-scatter": 0,
                    "all-to-all": 0,
                    "collective-permute": 0,
                    "collective-broadcast": 0},
                "total_bytes": 14617600.0},
            "model_flops_global": 395190861824.0,
            "act_seq_axis": None,
            "remat": "none",
            "fits_hbm": True},
        {
            "arch": "xlstm_350m",
            "shape": "train_4k",
            "mesh": "single",
            "n_devices": 256,
            "status": "ok",
            "aten_ops": 30310,
            "memory": {
                "argument_bytes": 50140804,
                "output_bytes": 16,
                "temp_bytes": 7690534972,
                "peak_estimate_bytes": 7740675776},
            "cost": {
                "flops_per_device": 20182656105946.0,
                "bytes_accessed_per_device": 964547119563.0},
            "collectives": {
                "bytes_by_type": {
                    "all-gather": 1530020416.0,
                    "all-reduce": 34241884.0,
                    "reduce-scatter": 12395929600.0,
                    "all-to-all": 301989888.0,
                    "collective-permute": 0.0,
                    "collective-broadcast": 0.0},
                "count_by_type": {
                    "all-gather": 98838,
                    "all-reduce": 184,
                    "reduce-scatter": 49409,
                    "all-to-all": 36,
                    "collective-permute": 0,
                    "collective-broadcast": 0},
                "total_bytes": 14262181788.0},
            "model_flops_global": 3024969692872704.0,
            "act_seq_axis": "model",
            "remat": "full",
            "fits_hbm": True},
        {
            "arch": "zamba2_1p2b",
            "shape": "train_4k",
            "mesh": "single",
            "n_devices": 256,
            "status": "ok",
            "aten_ops": 161136,
            "memory": {
                "argument_bytes": 49190244,
                "output_bytes": 16,
                "temp_bytes": 9102326184,
                "peak_estimate_bytes": 9151516428},
            "cost": {
                "flops_per_device": 49902937152050.0,
                "bytes_accessed_per_device": 2679360556220.0},
            "collectives": {
                "bytes_by_type": {
                    "all-gather": 2431501120.0,
                    "all-reduce": 1672239152.0,
                    "reduce-scatter": 21601451008.0,
                    "all-to-all": 0.0,
                    "collective-permute": 0.0,
                    "collective-broadcast": 0.0},
                "count_by_type": {
                    "all-gather": 1610,
                    "all-reduce": 834,
                    "reduce-scatter": 786,
                    "all-to-all": 0,
                    "collective-permute": 0,
                    "collective-broadcast": 0},
                "total_bytes": 25705191280.0},
            "model_flops_global": 7363984764174336.0,
            "act_seq_axis": "model",
            "remat": "full",
            "fits_hbm": True}),
    "2.13.0": (
        {
            "arch": "qwen3_moe_235b_a22b",
            "shape": "train_4k",
            "mesh": "single",
            "n_devices": 256,
            "status": "ok",
            "aten_ops": 1523690,
            "memory": {
                "argument_bytes": 5460099076,
                "output_bytes": 16,
                "temp_bytes": 11944480797,
                "peak_estimate_bytes": 17404579873},
            "cost": {
                "flops_per_device": 814922503386141.0,
                "bytes_accessed_per_device": 29428812577621.0},
            "collectives": {
                "bytes_by_type": {
                    "all-gather": 44363513856.0,
                    "all-reduce": 283574352.0,
                    "reduce-scatter": 412017360896.0,
                    "all-to-all": 189246996480.0,
                    "collective-permute": 0.0,
                    "collective-broadcast": 0.0},
                "count_by_type": {
                    "all-gather": 17370,
                    "all-reduce": 2337,
                    "reduce-scatter": 11315,
                    "all-to-all": 4512,
                    "collective-permute": 0,
                    "collective-broadcast": 0},
                "total_bytes": 645911445584.0},
            "model_flops_global": 1.1852782592065536e+17,
            "act_seq_axis": "model",
            "remat": "full",
            "fits_hbm": True},
        {
            "arch": "qwen2_1p5b",
            "shape": "decode_32k",
            "mesh": "multi",
            "n_devices": 512,
            "status": "ok",
            "aten_ops": 12231,
            "memory": {
                "argument_bytes": 247229972,
                "output_bytes": 1215488,
                "temp_bytes": 58343424,
                "peak_estimate_bytes": 305573396},
            "cost": {
                "flops_per_device": 2324376180.0,
                "bytes_accessed_per_device": 1158334820.0},
            "collectives": {
                "bytes_by_type": {
                    "all-gather": 4226048.0,
                    "all-reduce": 1744256.0,
                    "reduce-scatter": 8773632.0,
                    "all-to-all": 0.0,
                    "collective-permute": 0.0,
                    "collective-broadcast": 0.0},
                "count_by_type": {
                    "all-gather": 310,
                    "all-reduce": 253,
                    "reduce-scatter": 140,
                    "all-to-all": 0,
                    "collective-permute": 0,
                    "collective-broadcast": 0},
                "total_bytes": 14743936.0},
            "model_flops_global": 395190861824.0,
            "act_seq_axis": None,
            "remat": "none",
            "fits_hbm": True},
        {
            "arch": "xlstm_350m",
            "shape": "train_4k",
            "mesh": "single",
            "n_devices": 256,
            "status": "ok",
            "aten_ops": 30514,
            "memory": {
                "argument_bytes": 50140804,
                "output_bytes": 16,
                "temp_bytes": 5007753272,
                "peak_estimate_bytes": 5057894076},
            "cost": {
                "flops_per_device": 20179147504109.0,
                "bytes_accessed_per_device": 960611156451.0},
            "collectives": {
                "bytes_by_type": {
                    "all-gather": 1529995264.0,
                    "all-reduce": 21671196.0,
                    "reduce-scatter": 12408807424.0,
                    "all-to-all": 301989888.0,
                    "collective-permute": 0.0,
                    "collective-broadcast": 0.0},
                "count_by_type": {
                    "all-gather": 98837,
                    "all-reduce": 179,
                    "reduce-scatter": 49410,
                    "all-to-all": 36,
                    "collective-permute": 0,
                    "collective-broadcast": 0},
                "total_bytes": 14262463772.0},
            "model_flops_global": 3024969692872704.0,
            "act_seq_axis": "model",
            "remat": "full",
            "fits_hbm": True},
        {
            "arch": "zamba2_1p2b",
            "shape": "train_4k",
            "mesh": "single",
            "n_devices": 256,
            "status": "ok",
            "aten_ops": 162123,
            "memory": {
                "argument_bytes": 49190244,
                "output_bytes": 16,
                "temp_bytes": 9102326184,
                "peak_estimate_bytes": 9151516428},
            "cost": {
                "flops_per_device": 49900702513746.0,
                "bytes_accessed_per_device": 2677007576352.0},
            "collectives": {
                "bytes_by_type": {
                    "all-gather": 2431469120.0,
                    "all-reduce": 1645623264.0,
                    "reduce-scatter": 21688351744.0,
                    "all-to-all": 0.0,
                    "collective-permute": 0.0,
                    "collective-broadcast": 0.0},
                "count_by_type": {
                    "all-gather": 1608,
                    "all-reduce": 850,
                    "reduce-scatter": 798,
                    "all-to-all": 0,
                    "collective-permute": 0,
                    "collective-broadcast": 0},
                "total_bytes": 25765444128.0},
            "model_flops_global": 7363984764174336.0,
            "act_seq_axis": "model",
            "remat": "full",
            "fits_hbm": True})}
# what a record of the same cell may change from run to run or card to card
CELL_UNFROZEN = ("build_s", "trace_s", "parse_s", "hbm")
# the reference's record of each of MESH_CELLS (``python -m
# repro.launch.dryrun``, XLA's CPU compile for 256 / 512 host devices, jax
# 0.9.0; tests/test_torch_dryrun.py holds them equal to it): FLOPs and peak
# a device; the port's must lie within MESH_CELL_BOUNDS of them
MESH_CELL_REFERENCE = (
    {"flops_per_device": 828962350794622.0,
     "peak_estimate_bytes": 17646056916},
    {"flops_per_device": 2443322182.0, "peak_estimate_bytes": 576903956},
    {"flops_per_device": 20222584719340.0,
     "peak_estimate_bytes": 4951237660},
    {"flops_per_device": 50671239955994.0,
     "peak_estimate_bytes": 8296205892})
MESH_CELL_BOUNDS = {"flops_per_device": (0.8, 1.25),
                    "peak_estimate_bytes": (0.0, 2.0)}
# (a) one MoE layer of qwen3-moe at full width (d_model 4,096, 128 experts,
# d_ff 1,536, top 8, bf16: 4.8 GB of expert weights) through the
# expert-parallel body on the mesh, against the local moe on the card
MESH_EP_ARCH = "qwen3_moe_235b_a22b"
MESH_EP_BATCH, MESH_EP_SEQ = 4, 256
# the EP body's experts read their queues from the all-to-all's contiguous
# buffer, the local path's from a view of the dispatch buffer, so cuBLAS
# may take another kernel: bf16 outputs may differ by a rounding of the
# expert products (one bfloat16 ulp, 2^-7 relative, of the largest)
MESH_EP_BOUND = 2.0 ** -7
# (b) full-width forwards and greedy decodes on DTensor params and a
# DTensor batch, against the plain ones on the card: arch -> (its mesh
# axes, the forward's tokens a sequence, a leaf whose placements are
# printed). zamba2's forward splits each Mamba2 layer's rows in SSD chunks
# of 64 over "model", so its sequence is a multiple of 64
MESH_DT = {
    "granite_moe_3b_a800m": ({"act_batch_axes": ("data",),
                              "moe_expert_axis": "model",
                              "vocab_axis": "model"}, 8,
                             ("layers", "moe", "w_gate")),
    "zamba2_1p2b": ({"act_batch_axes": ("data",), "act_seq_axis": "model",
                     "vocab_axis": "model"}, 64,
                    ("mamba_main", "mamba", "in_proj")),
    "xlstm_350m": ({"act_batch_axes": ("data",), "act_seq_axis": "model",
                    "vocab_axis": "model"}, 8, ("pairs", "slstm", "w_h")),
}
MESH_DT_PROMPT, MESH_DT_GEN = 8, 4  # the greedy decode's
MESH_DT_BOUND = 1e-3  # logits' rel err, DTensor against plain (bf16)
# the examples phase: the five twins of examples/ at their reference sizes,
# each ending in its line of OK; the kernels their runs must launch
EXAMPLES = {"torch_quickstart": "quickstart OK",
            "torch_production_star": "production star example OK",
            "torch_serving_demo": "serving_demo OK",
            "torch_serve_batched": "serve_batched example OK",
            "torch_train_lm": "train_lm example OK"}
EXAMPLE_KERNELS = ("bucketize_kernel", "segment_sum_kernel", "unpack_kernel",
                   "topk_kernel")
# bucketize_count_kernel's edge cases: boundary counts (just above the
# shared-memory route, Q17's semi-join, Q3's join probe) and query patterns
COUNT_NB = (58_113, 97_532, 1 << 23)
COUNT_PATTERNS = ("sorted", "random", "clustered", "all_equal", "nan",
                  "out_of_range")
SEGSUM_GROUPS = (1, 2, 16, 31, 32, 33, 512, 4096)
SEGSUM_PATTERNS = ("in_range", "mostly_dropped", "all_dropped", "negative",
                   "ragged")

# ---------------------------------------------------------------------------
# TPC-H-shaped data (copies of benchmarks/bench_tpch.py's generators)
# ---------------------------------------------------------------------------

# paper Table 7: query-specific multi-column sort orders
SORT_ORDERS = {
    "Q1": ("returnflag", "linestatus", "shipdate", "quantity"),
    "Q3": ("orderkey",),
    "Q6": ("quantity", "discount", "shipdate"),
    "Q17": ("partkey",),
    "Q19": ("partkey",),
}


def _sort_perm(cols, order, device=None):
    """``np.lexsort`` of the ``order`` columns (first most significant) as
    one stable argsort of a mixed-radix int64 composite key: the same
    permutation, sorted on ``device`` (a CUDA device: the card sorts 60M
    keys in milliseconds, where numpy takes tens of seconds)."""
    key = np.zeros(len(cols[order[0]]), np.int64)
    span_total = 1
    for c in order:
        v = cols[c].astype(np.int64)
        lo, span = int(v.min()), int(v.max()) - int(v.min()) + 1
        span_total *= span
        if span_total >= 2**62:
            raise ValueError("sort key domain too large for one int64 key")
        key = key * span + (v - lo)
    if device is None or getattr(device, "type", device) == "cpu":
        return np.argsort(key, kind="stable")
    import torch
    dev_key = torch.from_numpy(key).to(device)
    return torch.argsort(dev_key, stable=True).cpu().numpy()


def make_lineitem(rng, n, order=None, device=None):
    """LINEITEM-like columns, globally sorted by ``order`` (paper §9.1.1);
    ``device`` sorts on the card (the same permutation)."""
    cols = {
        "returnflag": rng.integers(0, 3, n).astype(np.int32),
        "linestatus": rng.integers(0, 2, n).astype(np.int32),
        "shipdate": rng.integers(0, 2557, n).astype(np.int32),
        "quantity": rng.integers(1, 51, n).astype(np.int32),
        "discount": rng.integers(0, 11, n).astype(np.int32),
        "price": (rng.random(n).astype(np.float32) * 1000),
        "tax": rng.integers(0, 9, n).astype(np.int32),
        "partkey": rng.integers(0, n // 30, n).astype(np.int32),
        "orderkey": rng.integers(0, n // 4, n).astype(np.int32),
    }
    if order:
        perm = _sort_perm(cols, order, device)
        cols = {k: v[perm] for k, v in cols.items()}
    return cols


def make_orders(rng, n_orders):
    """ORDERS-like dimension: surrogate PK (stored key-ordered) + filter /
    group attributes."""
    return {
        "orderkey": np.arange(n_orders, dtype=np.int32),
        "orderdate": rng.integers(0, 366, n_orders).astype(np.int32),
        "shippriority": rng.integers(0, 2, n_orders).astype(np.int32),
    }


# ---------------------------------------------------------------------------
# The five query pipelines (bench_tpch.py's, staged on repro_torch) and
# their numpy oracles
# ---------------------------------------------------------------------------


def rev(env):
    """Q6's and Q19's ``price * discount``: one function for every query,
    so that repeated submissions share a plan-cache signature (a ``map``
    is keyed by its callable)."""
    from repro_torch.core import arithmetic
    return arithmetic.binary_op(env["price"], env["discount"], "mul")


# Q1's shipdate cut; Q1s (a second plan of the serving mix) cuts earlier
Q1_CUTS = {"Q1": 2400, "Q1s": 2000}


def build_query(name, table, orders_table=None, part_keys=None,
                query_cls=None):
    """The query ``name`` staged on ``table`` with ``query_cls`` (``Query``
    by default; ``PartitionedQuery`` for a partitioned table)."""
    from repro_torch.core.plan import Query, col

    Query = query_cls or Query  # noqa: N806

    if name in Q1_CUTS:
        return (Query(table)
                .filter(col("shipdate") <= Q1_CUTS[name])
                .groupby(["returnflag", "linestatus"],
                         {"sum_qty": ("sum", "quantity"),
                          "sum_price": ("sum", "price"),
                          "avg_disc": ("avg", "discount"),
                          "cnt": ("count", None)}, num_groups_cap=16))
    if name == "Q3":
        return (Query(table)
                .filter(col("shipdate") > 1200)
                .join(orders_table, fk="orderkey",
                      cols=["orderdate", "shippriority"],
                      where=col("orderdate") < 180)
                .groupby(["orderdate", "shippriority"],
                         {"revenue": ("sum", "price"), "cnt": ("count", None)},
                         num_groups_cap=512))
    if name == "Q6":
        return (Query(table)
                .filter(col("shipdate").between(500, 864)
                        & col("discount").between(5, 7)
                        & (col("quantity") < 24))
                .map("rev", rev)
                .aggregate({"revenue": ("sum", "rev")}))
    if name == "Q17":
        return (Query(table)
                .semi_join("partkey", part_keys)
                .filter(col("quantity") < 10)
                .aggregate({"sum_price": ("sum", "price"), "c": ("count", None)}))
    if name == "Q19":
        return (Query(table)
                .semi_join("partkey", part_keys)
                .filter(col("quantity").between(5, 30) & (col("shipdate") > 100))
                .map("rev", rev)
                .aggregate({"revenue": ("sum", "rev")}))
    raise ValueError(name)


def build_ranked(name, table, orders_table=None, query_cls=None):
    """The ranked query ``name`` (R1, R2 or Q3r) staged on ``table``."""
    from repro_torch.core.plan import Query, col

    Query = query_cls or Query  # noqa: N806
    if name == "R1":
        return (Query(table).filter(col("shipdate") <= 2400)
                .order_by("price", descending=True, limit=100,
                          cols=["orderkey", "quantity"]))
    if name == "R2":
        return Query(table).order_by(["quantity", "shipdate"],
                                     descending=[True, False], limit=1000,
                                     cols=["price"])
    if name == "Q3r":
        return build_query("Q3", table, orders_table,
                           query_cls=query_cls).order_by(
            ["revenue", "orderdate"], descending=[True, False], limit=10)
    raise ValueError(name)


def _top_rows(keys, rows, limit):
    """Positions of the ``limit`` best rows by ``keys`` (primary first,
    smaller = better; ties to the lowest row): ``np.lexsort`` over the
    rows whose primary key is within the ``limit``-th best."""
    p = keys[0]
    if len(p) > limit:
        kth = np.partition(p, limit - 1)[limit - 1]
        cand = p <= kth
        keys, rows = tuple(k[cand] for k in keys), rows[cand]
    order = np.lexsort((rows,) + tuple(reversed(keys)))[:limit]
    return rows[order]


def ranked_oracle(name, d, q3_want=None):
    """The ranked query's answer with numpy: ``{"positions", "columns"}``
    for R1 and R2, Q3's oracle groups reordered for Q3r."""
    if name == "R1":
        rows = np.flatnonzero(d["shipdate"] <= 2400)
        pos = _top_rows((-d["price"][rows].astype(np.float64),), rows, 100)
        cols = ("orderkey", "quantity", "price")
    elif name == "R2":
        rows = np.arange(len(d["quantity"]))
        pos = _top_rows((-d["quantity"].astype(np.int64),
                         d["shipdate"].astype(np.int64)), rows, 1000)
        cols = ("price", "quantity", "shipdate")
    elif name == "Q3r":
        order = np.lexsort((q3_want["keys"]["orderdate"],
                            -q3_want["aggs"]["revenue"]))[:10]
        return {"num_groups": len(order),
                "keys": {k: v[order] for k, v in q3_want["keys"].items()},
                "aggs": {k: v[order] for k, v in q3_want["aggs"].items()}}
    else:
        raise ValueError(name)
    return {"positions": pos, "n": len(pos),
            "columns": {c: d[c][pos] for c in cols}}


def check_ranked(name, got, want):
    """A ranked answer against its oracle: positions and every gathered
    column exactly (they are stored values), group answers as
    ``check_answer``."""
    if "keys" in want:
        if got["num_groups"] != want["num_groups"]:
            raise AssertionError(f"{name}: {got['num_groups']} groups, "
                                 f"want {want['num_groups']}")
        check_answer(name, got, want)
        return
    if got["n"] != want["n"] or not np.array_equal(got["positions"],
                                                   want["positions"]):
        raise AssertionError(f"{name}: ranked positions differ")
    if set(got["columns"]) != set(want["columns"]):
        raise AssertionError(f"{name}: columns {sorted(got['columns'])}")
    for c, v in want["columns"].items():
        if not np.array_equal(got["columns"][c], v):
            raise AssertionError(f"{name}: column {c} differs")


def _grouped(keys, sel, weights, domain):
    """Group ids in lexicographic key order + float64 sums per group."""
    present = np.bincount(keys[sel], minlength=domain) > 0
    sums = {k: np.bincount(keys[sel], weights=w[sel].astype(np.float64),
                           minlength=domain)[present]
            for k, w in weights.items()}
    counts = np.bincount(keys[sel], minlength=domain)[present]
    return np.flatnonzero(present), sums, counts


def oracle(name, d, orders=None, part_keys=None):
    """The query's answer computed with numpy on the host (float64 sums).
    Group-by answers: {"keys": {name: int array}, "aggs": {...}} in
    lexicographic key order; scalar answers: {out: value}."""
    if name in Q1_CUTS:
        sel = d["shipdate"] <= Q1_CUTS[name]
        key = d["returnflag"] * 2 + d["linestatus"]
        gk, sums, cnt = _grouped(key, sel, {"q": d["quantity"], "p": d["price"],
                                            "d": d["discount"]}, 6)
        return {"keys": {"returnflag": gk // 2, "linestatus": gk % 2},
                "aggs": {"sum_qty": sums["q"], "sum_price": sums["p"],
                         "avg_disc": sums["d"] / np.maximum(cnt, 1),
                         "cnt": cnt}}
    if name == "Q3":
        od = orders["orderdate"][d["orderkey"]]
        sp = orders["shippriority"][d["orderkey"]]
        sel = (d["shipdate"] > 1200) & (od < 180)
        key = od * 2 + sp
        gk, sums, cnt = _grouped(key, sel, {"r": d["price"]}, 366 * 2)
        return {"keys": {"orderdate": gk // 2, "shippriority": gk % 2},
                "aggs": {"revenue": sums["r"], "cnt": cnt}}
    price = d["price"].astype(np.float64)
    if name == "Q6":
        sel = ((d["shipdate"] >= 500) & (d["shipdate"] <= 864)
               & (d["discount"] >= 5) & (d["discount"] <= 7)
               & (d["quantity"] < 24))
        return {"revenue": float((price * d["discount"])[sel].sum())}
    member = np.isin(d["partkey"], part_keys)
    if name == "Q17":
        sel = member & (d["quantity"] < 10)
        return {"sum_price": float(price[sel].sum()), "c": int(sel.sum())}
    if name == "Q19":
        sel = (member & (d["quantity"] >= 5) & (d["quantity"] <= 30)
               & (d["shipdate"] > 100))
        return {"revenue": float((price * d["discount"])[sel].sum())}
    raise ValueError(name)


def host_result(res):
    """A query result as host numpy arrays (trimmed to the live groups)."""
    from repro_torch.core.order import RankedTable
    from repro_torch.device import to_numpy
    if isinstance(res, RankedTable):
        return {"positions": res.positions, "n": res.n,
                "columns": dict(res.columns)}
    if isinstance(res, dict):
        return {k: to_numpy(v) for k, v in res.items()}
    ng = int(res.num_groups)
    return {"num_groups": ng,
            "keys": {k: to_numpy(v)[:ng] for k, v in res.keys.items()},
            "aggs": {k: to_numpy(v)[:ng] for k, v in res.aggs.items()}}


def check_same(name, got, want):
    """Two host results of one query (e.g. streamed and resident): group
    keys, integers and counts equal, float sums within rtol 1e-4."""
    if "keys" in want:
        if got["num_groups"] != want["num_groups"]:
            raise AssertionError(f"{name}: group counts differ")
        check_answer(name, got, {"keys": want["keys"], "aggs": {
            k: v if np.issubdtype(v.dtype, np.integer) else v.astype(np.float64)
            for k, v in want["aggs"].items()}})
        return
    for k, v in want.items():
        g = np.asarray(got[k])
        if np.issubdtype(g.dtype, np.integer) and int(g) != int(v):
            raise AssertionError(f"{name}: {k}={int(g)} != {int(v)}")
        np.testing.assert_allclose(float(g), float(v), rtol=1e-4,
                                   err_msg=f"{name}: {k}")


def _bits(tree):
    """Flatten a host result to (name, bytes) pairs for bit-identity."""
    if isinstance(tree, dict):
        return [(k + "/" + n, b) for k, v in sorted(tree.items())
                for n, b in _bits(v)]
    return [("", np.ascontiguousarray(np.asarray(tree)).tobytes())]


def check_answer(name, got, want):
    if "keys" in want:
        for k, v in want["keys"].items():
            if not np.array_equal(got["keys"][k], v):
                raise AssertionError(f"{name}: group keys {k} differ")
        for k, v in want["aggs"].items():
            g = got["aggs"][k]
            if np.issubdtype(g.dtype, np.integer):
                if not np.array_equal(g, v):
                    raise AssertionError(f"{name}: {k} differs")
            else:
                np.testing.assert_allclose(g, v, rtol=1e-4,
                                           err_msg=f"{name}: {k}")
        return
    for k, v in want.items():
        g = got[k]
        if isinstance(v, int):
            if int(g) != v:
                raise AssertionError(f"{name}: {k}={int(g)} != {v}")
        else:
            np.testing.assert_allclose(float(g), v, rtol=1e-4,
                                       err_msg=f"{name}: {k}")


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


def time_ms(fn, iters=10, warmup=2):
    """Median milliseconds of ``fn`` over ``iters`` launches (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_turns_ms(fn, other, iters=30, warmup=2):
    """``time_ms`` of ``fn`` and of ``other`` taken in turns (fn, other,
    other, fn, ...), so both meet the same clocks and host load: the
    medians of ``iters`` calls each."""
    import torch
    for _ in range(warmup):
        fn()
        other()
    times = ([], [])
    for i in range(iters):
        for j in ((0, 1) if i % 2 == 0 else (1, 0)):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            (fn, other)[j]()
            b.record()
            b.synchronize()
            times[j].append(a.elapsed_time(b))
    return statistics.median(times[0]), statistics.median(times[1])


def time_b2b_ms(fn, per_launch_ms, budget_ms=25.0):
    """Milliseconds a launch of ``fn`` takes back to back: N launches
    between one pair of CUDA events, over N (N sized to about
    ``budget_ms`` of work, 10 to 200), after warm-up. Unlike ``time_ms``,
    the host's dispatch of a launch overlaps the device work of the one
    before it."""
    import torch
    n = int(min(200, max(10, budget_ms / max(per_launch_ms, 1e-3))))
    fn()
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def host_us(fn, batch=20, reps=30):
    """Host microseconds one call of ``fn`` takes: the median over ``reps``
    batches of ``batch`` calls, timed on the host's clock with no
    synchronisation inside a batch (the card drains between batches)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        times.append((time.perf_counter() - t0) / batch * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def device_us(fn, key, reps=50):
    """Device microseconds one call of ``fn`` takes: the CUDA time
    ``torch.profiler`` books to kernels whose name holds ``key`` (every
    kernel for ``""``), over ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if key in e.key and not e.key.startswith("aten::"):
            t = getattr(e, "device_time_total", None)
            total += getattr(e, "cuda_time_total", 0) if t is None else t
    return total / reps if total else None


def topk_more_shapes(dev, k):
    """``topk_kernel`` beside ``torch.topk`` at one streamed partition
    (2^23 random int32 keys) and at R1's length in ascending order (every
    key beats the running threshold: the kernel's worst case), each held
    against ``ref.topk``: per-launch and back-to-back ms, and the bound."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import topk as kt
    rng = np.random.default_rng(11)
    out = []
    for what, n in (("streamed partition, random", 1 << 23),
                    ("R1 length, ascending", LINEITEM_ROWS[10.0])):
        if what.endswith("random"):
            x = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, n,
                                              dtype=np.int32)).to(dev)
        else:
            x = torch.arange(n, dtype=torch.int32, device=dev)
        got, want = kt.topk_kernel(x, k), ref.topk(x, k)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"topk_kernel disagrees: {what}")
        kern = lambda: kt.topk_kernel(x, k)  # noqa: E731
        lib = lambda: torch.topk(x, k)  # noqa: E731
        k_ms, lib_ms = time_turns_ms(kern, lib)
        out.append({"case": what, "values": n, "k": k,
                    "passes": kt.passes(n, k), "ms": k_ms,
                    "ms_back_to_back": time_b2b_ms(kern, k_ms),
                    "library_ms": lib_ms,
                    "library_ms_back_to_back": time_b2b_ms(lib, lib_ms),
                    "bound_ms": bound_ms(4 * n + 8 * k, n)[0]})
        del x, got, want
    return out


def segsum_more_shapes(dev):
    """``segment_sum_kernel`` beside ``index_add_`` at G = 1 and G = 16 at
    59,986,052 and 2^23 rows, and at G = 512 at 59,986,052 (Q3's group
    count), float32 and int32 (the COUNT sums): ids in range (at G = 1 all
    0, an ungrouped aggregate's), so one ``index_add_`` computes the same
    function. Each held against the plain version; per-launch and
    back-to-back ms, and the bound."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_reduce import segment_sum_kernel
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    out = []
    for n, groups in ((LINEITEM_ROWS[10.0], (1, 16, 512)), (1 << 23, (1, 16))):
        for g in groups:
            ids = (torch.zeros(n, dtype=torch.int32, device=dev) if g == 1
                   else torch.randint(0, g, (n,), dtype=torch.int32,
                                      device=dev, generator=gen))
            for dtype in (torch.float32, torch.int32):
                if dtype == torch.float32:
                    v = torch.rand(n, device=dev, generator=gen) * 10
                else:
                    v = torch.randint(-1000, 1000, (n,), dtype=torch.int32,
                                      device=dev, generator=gen)
                got = segment_sum_kernel(v, ids, g)
                if dtype == torch.int32:
                    if not torch.equal(got, ref.ref_segment_reduce(v, ids, g)):
                        raise AssertionError(f"segment_sum_kernel int32 G={g} "
                                             f"n={n} differs from plain")
                else:  # against the plain version in float64
                    np.testing.assert_allclose(
                        got.double().cpu().numpy(),
                        ref.ref_segment_reduce(v.double(), ids, g).cpu().numpy(),
                        rtol=1e-4, err_msg=f"segment_sum_kernel G={g} n={n}")
                kern = lambda: segment_sum_kernel(v, ids, g)  # noqa: E731
                lib = lambda: torch.zeros(  # noqa: E731
                    g, dtype=v.dtype, device=dev).index_add_(0, ids, v)
                k_ms, lib_ms = time_turns_ms(kern, lib)
                out.append({"values": n, "G": g, "dtype": str(dtype),
                            "ids": "all 0" if g == 1 else "random in range",
                            "ms": k_ms,
                            "ms_back_to_back": time_b2b_ms(kern, k_ms),
                            "library": "index_add_", "library_ms": lib_ms,
                            "library_ms_back_to_back": time_b2b_ms(lib, lib_ms),
                            "bound_ms": bound_ms(8 * n + 4 * g, n)[0]})
                del v, got
            del ids
    torch.cuda.empty_cache()
    return out


def count_more_shapes(dev, q3_boundaries, q3_queries, part_keys):
    """``bucketize_count_kernel`` beside ``torch.searchsorted`` at Q17's
    semi-join shape (the 97,532 part keys against 59,986,052 partkeys
    sorted, as the Q17-ordered table probes them) and at Q3's shape with
    random queries (the main path's boundaries, queries drawn uniformly
    over the range of its sorted ones). Each held against the plain
    version; per-launch and back-to-back ms, and the bound."""
    import torch
    from repro_torch.kernels import bucketize as kb, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    n = LINEITEM_ROWS[10.0]
    q17_b = torch.from_numpy(part_keys.astype(np.int32)).to(dev)
    q17_q = torch.sort(torch.randint(0, n // 30, (n,), dtype=torch.int32,
                                     device=dev, generator=gen)).values
    lo, hi = int(q3_queries.min()), int(q3_queries.max())
    q3_random = torch.randint(lo, hi + 1, (q3_queries.shape[0],),
                              dtype=q3_queries.dtype, device=dev,
                              generator=gen)
    out = []
    for what, b, q in (("Q17 semi-join, sorted", q17_b, q17_q),
                       ("Q3 join probe, random", q3_boundaries, q3_random)):
        for right in (True, False):
            if not torch.equal(kb.bucketize_count_kernel(b, q, right),
                               ref.ref_bucketize(b, q, right)):
                raise AssertionError(f"bucketize_count_kernel: {what}")
        kern = lambda: kb.bucketize_count_kernel(b, q, True)  # noqa: E731
        lib = lambda: torch.searchsorted(  # noqa: E731
            b, q, right=True, out_int32=True)
        k_ms, lib_ms = time_turns_ms(kern, lib)
        nb, nq = b.shape[0], q.shape[0]
        out.append({"case": what, "boundaries": nb, "queries": nq,
                    "plan": kb.count_plan(nb), "ms": k_ms,
                    "ms_back_to_back": time_b2b_ms(kern, k_ms),
                    "library": "torch.searchsorted", "library_ms": lib_ms,
                    "library_ms_back_to_back": time_b2b_ms(lib, lib_ms),
                    "bound_ms": bound_ms(4 * (nb + 2 * nq),
                                         nq * _steps(nb))[0]})
    del q17_b, q17_q, q3_random
    torch.cuda.empty_cache()
    return out


def bound_ms(nbytes, nops):
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = nops / FP32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def _steps(n):
    return max(1, int(n).bit_length())


RLE_DECODERS = ("rle_decode_kernel", "rle_decode_packed_kernel")


def decoder_tally():
    """A copy of the two RLE decoders' launch tallies by shape class."""
    from repro_torch.kernels import _build
    return {k: dict(_build.SHAPES[k]) for k in RLE_DECODERS}


def decoder_shapes(before, runs=1):
    """The two RLE decoders' launches by shape class since ``before`` (a
    ``decoder_tally()``), per run; decoders not launched are left out."""
    from repro_torch.kernels import _build
    out = {}
    for k in RLE_DECODERS:
        d = {c: (v - before[k].get(c, 0)) // runs
             for c, v in _build.SHAPES[k].items()}
        if any(d.values()):
            out[k] = {c: v for c, v in d.items() if v}
    return out


# ---------------------------------------------------------------------------
# Phase 2: kernel edge cases against the plain versions
# ---------------------------------------------------------------------------


def kernel_edge_cases(dev):
    import torch
    from repro_torch.kernels import bucketize as kb, ref
    from repro_torch.kernels.rle_decode import rle_decode_kernel
    from repro_torch.kernels.segment_reduce import segment_sum_kernel

    rng = np.random.default_rng(0)
    i32max = np.iinfo(np.int32).max
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    cases = 0

    def same(a, b, what):
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"kernel check failed: {what}")

    b_cases = [
        ("empty queries", np.arange(10), np.zeros(0)),
        ("empty boundaries", np.zeros(0), np.arange(5)),
        ("duplicates, ragged tail", np.sort(rng.integers(0, 10, 37)),
         rng.integers(-2, 12, 1025)),
        ("sentinel-padded boundaries",
         np.concatenate([np.sort(rng.integers(0, 100, 20)), np.full(12, i32max)]),
         rng.integers(-5, 200, 333)),
        ("one boundary", np.array([7]), rng.integers(0, 15, 77)),
        ("large", np.sort(rng.integers(0, 10**7, 50_000)),
         rng.integers(-5, 10**7 + 5, 300_001)),
        ("beyond shared memory", np.sort(rng.integers(0, 10**8, 300_000)),
         rng.integers(0, 10**8, 100_003)),
    ]
    for what, b, q in b_cases:
        for dtype in (np.int32, np.float32):
            bb, qq = t(b.astype(dtype)), t(q.astype(dtype))
            for right in (True, False):
                want = ref.ref_bucketize(bb, qq, right)
                if bb.shape[0] <= kb.MAX_SMEM_BOUNDARIES:
                    same(kb.bucketize_kernel(bb, qq, right), want,
                         f"bucketize_kernel {what} {dtype.__name__} {right}")
                same(kb.bucketize_count_kernel(bb, qq, right), want,
                     f"bucketize_count_kernel {what} {dtype.__name__} {right}")
                cases += 1
    # views at storage offset 1 (queries not 16-byte aligned: the scalar
    # loads), nq % 4 != 0, and the 16-byte route's ragged ends
    for nq in (1, 3, 5, 1023, 1025, 300_001):
        for dtype in (np.int32, np.float32):
            b = np.sort(rng.integers(-50, 50, 550)).astype(dtype)
            q = rng.integers(-60, 60, nq + 1).astype(dtype)
            for off in (0, 1):
                bb, qq = t(b), t(q)[off:off + nq]
                for right in (True, False):
                    same(kb.bucketize_kernel(bb, qq, right),
                         ref.ref_bucketize(bb, qq, right),
                         f"bucketize_kernel offset {off} nq={nq} "
                         f"{dtype.__name__} {right}")
                    cases += 1
    nanq = t(np.array([np.nan, 1.0, 5.0], np.float32))
    nanb = t(np.array([1.0, 2.0, 3.0], np.float32))
    for right in (True, False):
        want = ref.ref_bucketize(nanb, nanq, right)
        same(kb.bucketize_kernel(nanb, nanq, right), want, "NaN queries")
        same(kb.bucketize_count_kernel(nanb, nanq, right), want, "NaN queries")

    def rle_inputs(nrows, starts, ends, vals, cap):
        pad = cap - len(starts)
        return (np.concatenate([vals, np.zeros(pad, vals.dtype)]),
                np.concatenate([starts, np.full(pad, nrows)]).astype(np.int32),
                np.concatenate([ends, np.full(pad, nrows)]).astype(np.int32))

    starts = np.sort(rng.choice(5000, 300, replace=False)).astype(np.int32)
    ends = np.concatenate([starts[1:] - 1, [4999]]).astype(np.int32)
    r_cases = [
        ("zero runs at capacity", 500, np.zeros(0, np.int32),
         np.zeros(0, np.int32), np.zeros(0, np.int32), 8, 0, 7),
        ("zero rows", 0, np.array([0]), np.array([0]),
         np.array([3], np.int32), 1, 1, 0),
        ("gaps, non-zero fill, ragged", 3000, np.array([5, 2047, 2900]),
         np.array([90, 2500, 2999]), np.array([1.5, -2.0, 3.25], np.float32),
         3, 3, -1),
        ("sentinel padding", 3000, np.array([0, 500, 2900]),
         np.array([99, 999, 2999]), np.array([3, 5, 7], np.int32), 16, 3, 0),
        ("full cover", 5000, starts, ends,
         rng.integers(1, 100, 300).astype(np.int32), 300, 300, 0),
        ("n below the filled slots", 5000, starts, ends,
         rng.random(300).astype(np.float32), 300, 150, 2.5),
    ]
    for what, nrows, s, e, v, cap, n, fill in r_cases:
        vv, ss, ee = rle_inputs(nrows, s, e, v, cap)
        vv, ss, ee = t(vv), t(ss), t(ee)
        nn = torch.tensor(n, dtype=torch.int32, device=dev)
        same(rle_decode_kernel(vv, ss, ee, nn, nrows, fill),
             ref.ref_rle_decode(vv, ss, ee, nn, nrows, fill),
             f"rle_decode_kernel {what}")
        cases += 1
    # the tile walk's draws (csrc/rle_tile.cuh): one-run, window and L2
    # tiles, int32 and float32 bit for bit, at the resident grid and two
    # caps; then the short-run shape at full size
    for i, name in enumerate(RLE_DRAWS):
        vals, starts, ends, n, nrows, fill = rle_draw(
            name, np.random.default_rng(i))
        for v in (vals, (vals * np.float32(0.37)).astype(np.float32)):
            vv, ss, ee = t(v), t(starts), t(ends)
            nn = torch.tensor(n, dtype=torch.int32, device=dev)
            want = ref.ref_rle_decode(vv, ss, ee, nn, nrows, fill)
            for grid in (None, 1, 3):
                got = rle_decode_kernel(vv, ss, ee, nn, nrows, fill,
                                        max_blocks=grid)
                same(got.view(torch.int32), want.view(torch.int32),
                     f"rle_decode_kernel {name} {v.dtype} grid={grid}")
                cases += 1
    starts, ends = short_runs(rng, 1 << 23)
    vv, ss, ee = t(rng.integers(-99, 99, len(starts)).astype(np.int32)), \
        t(starts.astype(np.int32)), t(ends.astype(np.int32))
    nn = torch.tensor(len(starts), dtype=torch.int32, device=dev)
    want = ref.ref_rle_decode(vv, ss, ee, nn, 1 << 23, -1)
    for grid in (None, 5):
        same(rle_decode_kernel(vv, ss, ee, nn, 1 << 23, -1, max_blocks=grid),
             want, f"rle_decode_kernel short runs over 2^23 rows grid={grid}")
        cases += 1

    s_cases = [
        ("empty values", 0, 4, None),
        ("one group, ragged tail", 1025, 1, None),
        ("all ids out of range", 512, 8, "all_out"),
        ("every fifth id dropped", 2048, 8, "fifth"),
        ("sorted ids", 300_000, 16, "sorted"),
        ("random ids, G=4096", 200_001, 4096, None),
        ("negative ids", 4096, 32, "negative"),
    ]
    for what, n, g, how in s_cases:
        v = rng.random(n).astype(np.float32)
        ids = rng.integers(0, g, n).astype(np.int32)
        if how == "all_out":
            ids[:] = g
        elif how == "fifth":
            ids[::5] = g
        elif how == "sorted":
            ids = np.sort(ids)
        elif how == "negative":
            ids[::3] = -1
        vt, it = t(v), t(ids)
        got = segment_sum_kernel(vt, it, g)
        again = segment_sum_kernel(vt, it, g)
        if not torch.equal(got, again):
            raise AssertionError(f"segment_sum_kernel not deterministic: {what}")
        keep = (ids >= 0) & (ids < g)
        want = np.zeros(g, np.float64)
        np.add.at(want, ids[keep], v[keep].astype(np.float64))
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-4,
                                   atol=1e-5, err_msg=f"segment_sum {what}")
        plain = ref.ref_segment_reduce(vt, it, g)
        np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(),
                                   rtol=1e-4, atol=1e-5,
                                   err_msg=f"segment_sum vs plain {what}")
        cases += 1
    torch.cuda.synchronize()
    return cases


def packed_values(rng, b, n, lo):
    """``n`` values of a ``b``-bit domain from ``lo`` (the full int32 range
    at b = 32), their packed lanes as int32 (host), and the offset."""
    from repro_torch.core import compress
    if b == 32:
        lo, hi = -(2**31), 2**31 - 1
    else:
        hi = lo + (1 << b) - 1
    v = rng.integers(lo, hi, n, endpoint=True).astype(np.int64)
    return v, compress.pack_array(v, lo, b).view(np.int32), lo


PACKED_PATTERNS = ("sorted_padded", "random", "all_equal", "above_all")
UNPACK_CLASSES = (8, 4096, 1 << 17, 1 << 19, 1 << 23)  # main-path launch classes


def packed_queries(rng, b, pattern, n, nb, n_valid=None):
    """(int32 boundaries, values, packed lanes as int32, offset) of one
    ``bucketize_packed_kernel`` case at width ``b``: ``sorted_padded``
    sorts the first ``n_valid`` values (half by default) and sets the rest
    to code 0, the offset, as the streamed semi-join probes an RLE column's
    packed run values (tiles of padding only, one tile across n_valid);
    ``random``; ``all_equal``; ``above_all``, every value above every
    boundary."""
    from repro_torch.core import compress
    v, _, lo = packed_values(rng, b, n, -(1 << min(b, 31) - 1))
    top = lo + (1 << b) - 1 if b < 32 else 2**31 - 1
    if pattern == "sorted_padded":
        k = n // 2 if n_valid is None else n_valid
        v[:k] = np.sort(v[:k])
        v[k:] = lo
    elif pattern == "all_equal":
        v[:] = v[0]
    if pattern == "above_all":
        cut = lo + (top - lo) // 4
        bnd = rng.integers(lo, cut, nb, endpoint=True)
        v = np.maximum(v, cut + 1)
    else:
        bnd = rng.integers(lo, top, nb, endpoint=True)
    return (np.sort(bnd).astype(np.int32), v,
            compress.pack_array(v, lo, b).view(np.int32), lo)


def short_runs(rng, nrows, first=0):
    """(starts, ends) of runs of 1-4 rows after gaps of 0-3 rows, from row
    ``first`` to ``nrows``: about one run every 4 rows."""
    lens = rng.integers(1, 5, nrows)
    gaps = rng.integers(0, 4, nrows)
    starts = first + np.cumsum(gaps + np.concatenate([[0], lens[:-1]]))
    ends = starts + lens - 1
    keep = ends < nrows
    return starts[keep], ends[keep]


RLE_DRAWS = ["long_runs", "single_rows", "short_runs_gaps", "n_below",
             "n_zero", "past_ends", "repeated_ends", "ragged", "tiny_ragged",
             "mixed"]


def rle_draw(name, rng):
    """(values, starts, ends, n, nrows, fill) of a seeded RLE draw for the
    tile walk of ``csrc/rle_tile.cuh``: int32 values, int32 starts/ends
    sentinel-padded to the capacity (ends non-decreasing)."""
    def pad(starts, ends, cap, nrows):
        k = cap - len(starts)
        return (np.concatenate([starts, np.full(k, nrows)]).astype(np.int32),
                np.concatenate([ends, np.full(k, nrows)]).astype(np.int32))

    def cover(nrows, k):  # k runs covering every row
        starts = np.sort(rng.choice(np.arange(1, nrows), k - 1, replace=False))
        starts = np.concatenate([[0], starts])
        return starts, np.concatenate([starts[1:] - 1, [nrows - 1]])

    fill = 0
    if name == "long_runs":  # a few runs over many tiles
        nrows = 40_000
        starts, ends = cover(nrows, 12)
        cap, n = 16, 12
    elif name == "single_rows":  # a run a row: a window of 256 runs a tile
        nrows = 3_000
        starts = ends = np.arange(nrows)
        cap = n = nrows
    elif name in ("short_runs_gaps", "n_below", "n_zero"):
        nrows = 9_000
        starts, ends = short_runs(rng, nrows)
        cap = len(starts) + 5
        n = {"short_runs_gaps": len(starts), "n_below": len(starts) // 2,
             "n_zero": 0}[name]
        fill = -5
    elif name == "past_ends":  # no padding: rows past the last end clamp
        nrows = 6_000
        starts, ends = cover(2_000, 40)
        cap = n = 40
        fill = 3
    elif name == "repeated_ends":  # > 256 ends in a tile: the L2 route
        nrows = 4_096
        ends = np.sort(rng.integers(0, 1_024, 3_000))
        starts = ends - rng.integers(0, 3, 3_000)
        cap, n = 3_000, 2_900
        fill = 7
    elif name == "ragged":  # nrows a multiple of neither the tile nor 4
        nrows = 5_003
        starts, ends = cover(nrows, 300)
        ends[::7] -= 1  # gaps of one row
        cap, n = 310, 300
        fill = -1
    elif name == "tiny_ragged":
        nrows = 3
        starts, ends = np.array([0, 2]), np.array([0, 2])
        cap, n = 4, 2
        fill = 9
    elif name == "mixed":  # long runs, then a stretch of short ones
        nrows = 12_000
        ls, le = cover(6_000, 5)
        ss, se = short_runs(rng, nrows, 6_000)
        starts, ends = np.concatenate([ls, ss]), np.concatenate([le, se])
        cap = n = len(starts)
    else:
        raise ValueError(name)
    starts, ends = pad(np.asarray(starts), np.asarray(ends), cap, nrows)
    vals = rng.integers(-1000, 1000, cap).astype(np.int32)
    return vals, starts, ends, n, nrows, fill


def packed_edge_cases(dev):
    """The three packed kernels against their plain versions on the card."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import unpack as ku

    rng = np.random.default_rng(1)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    cases = 0

    def same(a, b, what):
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"kernel check failed: {what}")

    def view_at(w, off):  # the lanes as a view at storage offset ``off``
        junk = rng.integers(-(2**31), 2**31 - 1, off, dtype=np.int64)
        return t(np.concatenate([junk.astype(np.int32), w]))[off:]

    for b in PACK_BITS:
        # N = 0, N = 1, a few lanes (values straddle lanes for most b),
        # either side of a 128-value group and of a 2048-value tile, a
        # ragged tail; negative offsets, and the full range at b = 32
        for n in (0, 1, 33, 127, 128, 129, 2047, 2048, 2049, 100_003):
            for lo in (-(1 << min(b, 31) - 1), 12345):
                v, w, off = packed_values(rng, b, n, lo)
                ww = t(w)
                want = ref.ref_unpack(ww, b, off, n)
                got = ku.unpack_kernel(ww, b, off, n)
                same(got, want, f"unpack b={b} n={n}")
                if not np.array_equal(got.cpu().numpy(), v.astype(np.int32)):
                    raise AssertionError(f"unpack round trip b={b} n={n}")
                same(ku.unpack_kernel(ww, b, off, n, max_blocks=1), want,
                     f"unpack b={b} n={n} one block")
                cases += 2
            if n >= 2047:  # words views at offsets 1-3: the scalar path
                for voff in (1, 2, 3):
                    same(ku.unpack_kernel(view_at(w, voff), b, off, n), want,
                         f"unpack b={b} n={n} view at {voff}")
                    cases += 1
    for off in (0, 7, -(2**31), 2**31 - 1):  # width-32 wrap-add
        v = np.array([-(2**31), -1, 0, 1, 2**31 - 1], np.int64)
        from repro_torch.core import compress
        ww = t(compress.pack_array(v, off, 32).view(np.int32))
        got = ku.unpack_kernel(ww, 32, off, 5)
        if not np.array_equal(got.cpu().numpy(), v.astype(np.int32)):
            raise AssertionError(f"unpack width-32 wrap, offset {off}")
        cases += 1
    for n in UNPACK_CLASSES:  # every launch class of the main path, 24 bits
        v, w, off = packed_values(rng, 24, n, -(1 << 23))
        ww = t(w)
        want = ref.ref_unpack(ww, 24, off, n)
        for grid in (None, 1, 7):
            same(ku.unpack_kernel(ww, 24, off, n, max_blocks=grid), want,
                 f"unpack class {n} grid={grid}")
            cases += 1
        same(ku.unpack_kernel(view_at(w, 1), 24, off, n), want,
             f"unpack class {n} view at 1")
        cases += 1

    i32max = np.iinfo(np.int32).max
    for b, nb, how in ((3, 1, "one boundary"), (9, 32, "sentinel-padded"),
                       (21, 4096, "shared memory"),
                       (24, ku.MAX_SMEM_BOUNDARIES + 1000, "beyond shared"),
                       (32, 1000, "width 32"), (1, 2, "width 1")):
        for n in (0, 1, 77_777):
            v, w, off = packed_values(rng, b, n, -3)
            lo_b = int(v.min()) - 2 if n else -5
            hi_b = int(v.max()) + 2 if n else 5
            bnd = np.sort(rng.integers(lo_b, hi_b, nb, endpoint=True))
            if how == "sentinel-padded":
                bnd[-12:] = i32max
            bb, ww = t(np.clip(bnd, -(2**31), i32max).astype(np.int32)), t(w)
            for right in (True, False):
                want = ref.ref_bucketize_packed(bb, ww, b, off, n, right)
                same(ku.bucketize_packed_kernel(bb, ww, b, off, n, right), want,
                     f"bucketize_packed {how} n={n} right={right}")
                if nb <= ku.MAX_SMEM_BOUNDARIES:
                    same(ku.bucketize_packed_kernel(bb, ww, b, off, n, right,
                                                    tiled=True),
                         want, f"bucketize_packed tiled route {how} n={n}")
                cases += 1
    # the tiled route's tile bound: the streamed semi-join's shape (sorted
    # run values, then code-0 padding: tiles of padding only, one tile
    # across n_valid), random, all-equal and above-every-boundary queries;
    # the shared-memory route on the same queries; grid caps, few
    # splitters and words views at offsets 1-3 change no count
    for b in (9, 21, 32):
        for pattern in PACKED_PATTERNS:
            bnd, v, w, off = packed_queries(rng, b, pattern, 300_001, 97_533,
                                            n_valid=140_000)
            bb, ww = t(bnd), t(w)
            for right in (True, False):
                want = ref.ref_bucketize_packed(bb, ww, b, off, len(v), right)
                for kw in ({}, {"max_blocks": 1}, {"max_blocks": 7},
                           {"max_splitters": 64}):
                    same(ku.bucketize_packed_kernel(bb, ww, b, off, len(v),
                                                    right, **kw), want,
                         f"bucketize_packed {pattern} b={b} {kw}")
                    cases += 1
                for voff in (1, 2, 3):
                    same(ku.bucketize_packed_kernel(bb, view_at(w, voff), b,
                                                    off, len(v), right), want,
                         f"bucketize_packed {pattern} b={b} view at {voff}")
                    cases += 1
                small = bb[::24].contiguous()  # 4,064: shared memory
                want = ref.ref_bucketize_packed(small, ww, b, off, len(v),
                                                right)
                for tiled in (False, True):
                    same(ku.bucketize_packed_kernel(small, ww, b, off, len(v),
                                                    right, tiled=tiled), want,
                         f"bucketize_packed {pattern} b={b} 4,064 "
                         f"tiled={tiled}")
                    cases += 1

    def runs(nrows, k, cap, gap):
        starts = np.sort(rng.choice(nrows - gap, k, replace=False))
        ends = np.minimum(np.concatenate([starts[1:] - 1 - gap,
                                          [nrows - 1 - gap]]), nrows - 1)
        ends = np.maximum(ends, starts)
        pad = cap - k
        return (np.concatenate([starts, np.full(pad, nrows)]).astype(np.int32),
                np.concatenate([ends, np.full(pad, nrows)]).astype(np.int32))

    for what, nrows, k, cap, n_valid, gap, b, fill in (
            ("full cover", 50_000, 300, 300, 300, 0, 11, 0),
            ("gaps, n < cap, fill", 50_000, 300, 512, 150, 3, 13, -7),
            ("no valid runs", 5_000, 8, 16, 0, 1, 5, 9),
            ("one row", 1, 1, 1, 1, 0, 1, 0),
            ("width 32", 40_000, 64, 64, 64, 2, 32, 3)):
        starts, ends = runs(nrows, k, cap, gap)
        v, w, off = packed_values(rng, b, cap, -50)
        ww, ss, ee = t(w), t(starts), t(ends)
        nn = torch.tensor(n_valid, dtype=torch.int32, device=dev)
        same(ku.rle_decode_packed_kernel(ww, b, off, cap, ss, ee, nn, nrows,
                                         fill),
             ref.ref_rle_decode_packed(ww, b, off, cap, ss, ee, nn, nrows, fill),
             f"rle_decode_packed {what}")
        cases += 1
    for i, name in enumerate(RLE_DRAWS):  # the tile walk's draws
        _, starts, ends, n_valid, nrows, fill = rle_draw(
            name, np.random.default_rng(100 + i))
        cap = len(starts)
        ss, ee = t(starts), t(ends)
        nn = torch.tensor(n_valid, dtype=torch.int32, device=dev)
        for b in (1, 4, 13, 32):
            v, w, off = packed_values(rng, b, cap, -50)
            ww = t(w)
            want = ref.ref_rle_decode_packed(ww, b, off, cap, ss, ee, nn,
                                             nrows, fill)
            for grid in (None, 2):
                same(ku.rle_decode_packed_kernel(ww, b, off, cap, ss, ee, nn,
                                                 nrows, fill, max_blocks=grid),
                     want, f"rle_decode_packed {name} b={b} grid={grid}")
                cases += 1
    starts, ends = short_runs(rng, 1 << 23)
    cap = len(starts)
    v, w, off = packed_values(rng, 4, cap, 0)
    ww, ss, ee = t(w), t(starts.astype(np.int32)), t(ends.astype(np.int32))
    nn = torch.tensor(cap, dtype=torch.int32, device=dev)
    same(ku.rle_decode_packed_kernel(ww, 4, off, cap, ss, ee, nn, 1 << 23, 0),
         ref.ref_rle_decode_packed(ww, 4, off, cap, ss, ee, nn, 1 << 23, 0),
         "rle_decode_packed short runs over 2^23 rows")
    cases += 1
    torch.cuda.synchronize()
    return cases


def topk_edge_cases(dev):
    """``topk_kernel`` against ``ref.topk`` on the card: values and indices
    equal, and bit-identical across two launches."""
    import torch
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import topk as kt

    rng = np.random.default_rng(3)
    i32min = np.iinfo(np.int32).min
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    cases = 0

    def check(x, k, what):
        got, again = kt.topk_kernel(x, k), kt.topk_kernel(x, k)
        want = ref.topk(x, k)
        for a, b, part in ((got[0], want[0], "values"),
                           (got[1], want[1], "indices")):
            if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
                raise AssertionError(f"topk_kernel check failed: {what} "
                                     f"k={k} {part}")
        bits = [v.view(torch.int32) for v in (got[0], again[0])]
        if not (torch.equal(*bits) and torch.equal(got[1], again[1])):
            raise AssertionError(f"topk_kernel not bit-identical: {what}")

    for dtype in (np.int32, np.float32):
        for n in (0, 1, 7, 2047, 2048, 2049, 1_000_003):
            x = (rng.integers(-1000, 1000, n) if dtype == np.int32
                 else rng.standard_normal(n)).astype(dtype)
            for k in (1, 8, 37, 128, 256):
                check(t(x), k, f"{dtype.__name__} n={n}")
                cases += 1
    specials = {
        "all equal int32": np.full(100_000, 7, np.int32),
        "all equal float32": np.full(100_000, 0.5, np.float32),
        "INT32_MIN rows": np.where(rng.random(50_000) < 0.5, i32min,
                                   rng.integers(-5, 5, 50_000)).astype(np.int32),
        "only INT32_MIN, n < k": np.full(5, i32min, np.int32),
        "+-inf": np.where(rng.random(100_000) < 0.01, np.inf,
                          np.where(rng.random(100_000) < 0.01, -np.inf,
                                   rng.standard_normal(100_000))).astype(np.float32),
        "signed zeros": rng.choice([0.0, -0.0, 1.0, -1.0], 10_000).astype(np.float32),
    }
    for what, x in specials.items():
        for k in (1, 37, 256):
            check(t(x), k, what)
            cases += 1
    n = 3_000_000  # the range pass and one survivor pass at k = 256
    x = t(rng.integers(-(2**31), 2**31 - 1, n, endpoint=True).astype(np.int32))
    before = _build.LAUNCHES["topk_kernel"]
    check(x, 256, "a survivor pass")
    launched = (_build.LAUNCHES["topk_kernel"] - before) // 2
    if launched != kt.passes(n, 256) or launched < 2:
        raise AssertionError(f"topk_kernel: {launched} passes at n={n}")
    cases += 1
    # the inputs that stress the running threshold, at 3M keys
    ramp = np.arange(n, dtype=np.int64) - n // 2
    stress = {
        "ascending int32": ramp.astype(np.int32),
        "descending float32": (-ramp).astype(np.float32),
        # equal values in runs of 50,000 across the block ranges' edges
        "ties straddling ranges": (ramp // 50_000).astype(np.int32),
        "all INT32_MIN but a few": np.where(
            rng.random(n) < 0.99995, i32min, rng.integers(-3, 3, n)
        ).astype(np.int32),
    }
    for what, xs in stress.items():
        for k in (8, 100, 256):
            check(t(xs), k, what)
            cases += 1
    # the answer does not depend on the grid; misaligned starts are legal
    xs = t(stress["ties straddling ranges"])
    want = kt.topk_kernel(xs, 128)
    for cap in (2, 7, 100):
        got = kt.topk_kernel(xs, 128, max_blocks=cap)
        if not all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                   for g, w in zip(got, want)):
            raise AssertionError(f"topk_kernel: grid cap {cap} differs")
        cases += 1
    for dtype in (np.int32, np.float32):
        base = t(rng.integers(-1000, 1000, 1_000_003).astype(dtype))
        for off in (1, 2, 3):
            check(base[off:], 37, f"{dtype.__name__} view at offset {off}")
            cases += 1
    torch.cuda.synchronize()
    return cases


def count_kernel_queries(rng, b, pattern, nq=300_001):
    """Queries of one ``bucketize_count_kernel`` edge case over the sorted
    boundaries ``b`` (host arrays, the boundaries' dtype)."""
    hi = int(b[-1]) + 5
    if pattern == "sorted":
        q = np.sort(rng.integers(-5, hi, nq))
    elif pattern == "random":
        q = rng.integers(-5, hi, nq)
    elif pattern == "clustered":  # sorted bursts of equal keys, a few strays
        q = np.repeat(np.sort(rng.integers(0, hi, nq // 64 + 1)), 64)[:nq]
        q[::1009] = rng.integers(0, hi, len(q[::1009]))
    elif pattern == "all_equal":
        q = np.full(nq, b[len(b) // 2])
    elif pattern == "nan":  # a NaN-only tile and NaNs among numbers
        q = rng.random(nq) * hi
        q[rng.random(nq) < 0.01] = np.nan
        q[:2048] = np.nan
    elif pattern == "out_of_range":
        q = np.where(rng.random(nq) < 0.5, -10, hi + 10)
    else:
        raise ValueError(pattern)
    return q.astype(b.dtype)


def count_window_edge(window, tile):
    """Boundaries 0, 2, 4, ... and sorted queries whose first tile's min
    and max counts lie exactly ``window`` apart (the window route's
    largest staging), the second's ``window + 1`` (the splitter route),
    the third's ``window - 1``, then a ragged tile."""
    b = np.arange(100_000, dtype=np.int64) * 2
    tiles = []
    for t, span in enumerate((window, window + 1, window - 1, 7)):
        a = 1000 + 5000 * t
        q = np.sort(np.random.default_rng(t).integers(2 * a, 2 * (a + span),
                                                       tile))
        q[0], q[-1] = 2 * a, 2 * (a + span)
        tiles.append(q if span != 7 else q[:333])
    return b, np.concatenate(tiles)


def count_kernel_edge_cases(dev):
    """``bucketize_count_kernel`` (the tiled route) equal to
    ``ref.ref_bucketize`` on sorted, random, clustered, all-equal, NaN and
    out-of-range queries at each of ``COUNT_NB`` boundaries, as aligned
    tensors and as views at offset 1 (scalar loads); at the window-or-
    splitter edge; at grid caps and splitter counts that must not change
    a count."""
    import torch
    from repro_torch.kernels import bucketize as kb, ref

    rng = np.random.default_rng(4)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    cases = 0

    def same(b, q, what, **kw):
        for right in (True, False):
            got = kb.bucketize_count_kernel(b, q, right, **kw)
            if not torch.equal(got, ref.ref_bucketize(b, q, right)):
                raise AssertionError(f"bucketize_count_kernel: {what} "
                                     f"right={right} {kw}")

    for nb in COUNT_NB:
        for dtype in (np.int32, np.float32):
            b = np.sort(rng.integers(0, 4 * nb, nb)).astype(dtype)
            bb = t(b)
            for pattern in COUNT_PATTERNS:
                if pattern == "nan" and dtype == np.int32:
                    continue
                q = t(count_kernel_queries(rng, b, pattern))
                for off in (0, 1):
                    same(bb, q[off:], f"nb={nb} {dtype.__name__} {pattern} "
                         f"offset {off}")
                    cases += 1
    b, q = count_window_edge(kb.WINDOW, kb.COUNT_TILE)
    for dtype in (np.int32, np.float32):
        same(t(b.astype(dtype)), t(q.astype(dtype)), "window edge")
        cases += 1
    bb = t(np.sort(rng.integers(0, 1 << 26, 1 << 23)).astype(np.int32))
    for pattern in ("sorted", "random"):
        q = t(count_kernel_queries(rng, bb.cpu().numpy(), pattern, 2_000_003))
        for kw in ({"max_blocks": 1}, {"max_blocks": 7},
                   {"max_blocks": 1000}, {"max_splitters": 64},
                   {"max_splitters": 1 << 14}):
            same(bb, q, f"2^23 {pattern}", **kw)
            cases += 1
    torch.cuda.synchronize()
    return cases


def segsum_case(rng, g, dtype, pattern, n=200_003):
    """(values, ids) host arrays of one ``segment_sum_kernel`` edge case."""
    if pattern == "ragged":  # several chunks, a ragged step and row
        from repro_torch.kernels import segment_reduce as ks
        n = 3 * ks.plan(g)[1] + 1029
    ids = rng.integers(0, g, n).astype(np.int64)
    if pattern == "mostly_dropped":
        pick = rng.random(n)
        ids[pick < 0.92] = g
        ids[pick < 0.5] = rng.integers(-3 * g, 3 * g + 9,
                                       int((pick < 0.5).sum()))
    elif pattern == "all_dropped":
        ids = np.where(rng.random(n) < 0.5, g, -1)
    elif pattern == "negative":
        ids[::3] = -1
        ids[1::7] = -(2**31)
    if dtype == np.int32:  # sums that wrap
        v = rng.integers(-(2**31), 2**31 - 1, n, endpoint=True)
    else:
        v = rng.random(n) * 10
    return v.astype(dtype), ids.astype(np.int32)


def segsum_edge_cases(dev):
    """``segment_sum_kernel`` at every G of ``SEGSUM_GROUPS``, float32 and
    int32, on ``SEGSUM_PATTERNS``: int32 sums equal to the plain version
    (wrapping ``index_add_``), float32 within rtol 1e-4 of a float64 sum;
    bit-identical across two launches, two grid caps and a view at offset
    1 (scalar loads, the same rows a thread)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_reduce import segment_sum_kernel

    rng = np.random.default_rng(6)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    cases = 0
    for g in SEGSUM_GROUPS:
        for dtype in (np.float32, np.int32):
            for pattern in SEGSUM_PATTERNS:
                v, ids = segsum_case(rng, g, dtype, pattern)
                vt, it = t(v), t(ids)
                what = f"segment_sum_kernel G={g} {dtype.__name__} {pattern}"
                got = segment_sum_kernel(vt, it, g)
                runs = [segment_sum_kernel(vt, it, g),
                        segment_sum_kernel(vt, it, g, max_blocks=1),
                        segment_sum_kernel(vt, it, g, max_blocks=7)]
                # the same rows, from a buffer one element in: scalar loads
                vo = torch.empty(len(v) + 1, dtype=vt.dtype, device=dev)
                io = torch.empty(len(v) + 1, dtype=it.dtype, device=dev)
                vo[1:].copy_(vt)
                io[1:].copy_(it)
                runs.append(segment_sum_kernel(vo[1:], io[1:], g))
                bits = got.view(torch.int32)
                if not all(torch.equal(bits, r.view(torch.int32))
                           for r in runs):
                    raise AssertionError(f"{what}: not bit-identical")
                plain = ref.ref_segment_reduce(vt, it, g)
                if dtype == np.int32:
                    if not torch.equal(got, plain):
                        raise AssertionError(f"{what}: differs from plain")
                    if pattern == "in_range" and not torch.equal(
                            got, torch.zeros(g, dtype=torch.int32,
                                             device=dev).index_add_(0, it, vt)):
                        raise AssertionError(f"{what}: differs from "
                                             "index_add_")
                else:
                    keep = (ids >= 0) & (ids < g)
                    want = np.zeros(g, np.float64)
                    np.add.at(want, ids[keep], v[keep].astype(np.float64))
                    np.testing.assert_allclose(got.cpu().numpy(), want,
                                               rtol=1e-4, atol=1e-2,
                                               err_msg=what)
                cases += 1
    torch.cuda.synchronize()
    return cases


# ---------------------------------------------------------------------------
# Phase 6: every kernel at the main path's largest inputs
# ---------------------------------------------------------------------------


def kernel_timing(launches, largest, part_keys):
    import torch
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import bucketize as kb
    from repro_torch.kernels.rle_decode import rle_decode_kernel
    from repro_torch.kernels.segment_reduce import segment_sum_kernel
    from repro_torch.kernels import topk as kt
    from repro_torch.kernels import unpack as ku

    rows = []
    for name, (source, replaces) in KERNEL_INFO.items():
        rec = largest[name]
        lib_what, lib_fn = None, None
        if name in ("bucketize_kernel", "bucketize_count_kernel"):
            b, q, right = rec["boundaries"], rec["queries"], rec["right"]
            kern = (kb.bucketize_kernel if name == "bucketize_kernel"
                    else kb.bucketize_count_kernel)
            got = kern(b, q, right)
            want = ref.ref_bucketize(b, q, right)
            err = float((got.long() - want.long()).abs().max()) if got.numel() else 0.0
            if not torch.equal(got, want):
                raise AssertionError(f"{name} disagrees at the query shape")
            nb, nq = b.shape[0], q.shape[0]
            shape = {"boundaries": nb, "queries": nq, "dtype": str(q.dtype),
                     "right": right, "queries_offset": q.storage_offset()}
            nbytes, nops = 4 * (nb + 2 * nq), nq * _steps(nb)
            kern_fn = lambda: kern(b, q, right)  # noqa: E731
            plain_fn = lambda: ref.ref_bucketize(b, q, right)  # noqa: E731
            lib_fn = lambda: torch.searchsorted(  # noqa: E731
                b, q, right=right, out_int32=True)
            lib_what = "torch.searchsorted"
            if name == "bucketize_count_kernel":
                shape["plan"] = kb.count_plan(nb)
                shape["more_shapes"] = count_more_shapes(q.device, b, q,
                                                         part_keys)
            if name == "bucketize_kernel":  # where a launch's time goes
                shape["host_us"] = {"kernel": host_us(kern_fn),
                                    lib_what: host_us(lib_fn)}
                shape["device_us"] = {
                    "kernel": device_us(kern_fn, "bucketize_smem_kernel"),
                    lib_what: device_us(lib_fn, "searchsorted")}
        elif name == "rle_decode_kernel":
            v, s, e, n = rec["values"], rec["starts"], rec["ends"], rec["n"]
            nrows, fill = rec["nrows"], rec["fill"]
            got = rle_decode_kernel(v, s, e, n, nrows, fill)
            want = ref.ref_rle_decode(v, s, e, n, nrows, fill)
            if not torch.equal(got, want):
                raise AssertionError(f"{name} disagrees at the query shape")
            err = 0.0
            cap = v.shape[0]
            shape = {"capacity": cap, "nrows": nrows, "dtype": str(v.dtype)}
            nbytes, nops = 12 * cap + 4 + 4 * nrows, nrows * _steps(cap)
            kern_fn = lambda: rle_decode_kernel(  # noqa: E731
                v, s, e, n, nrows, fill)
            plain_fn = lambda: ref.ref_rle_decode(  # noqa: E731
                v, s, e, n, nrows, fill)
            shape["device_ms"] = device_us(kern_fn, "rle") / 1e3
        elif name == "unpack_kernel":
            w, b, off, n = (rec["words"], rec["bit_width"], rec["offset"],
                            rec["nvals"])
            got = ku.unpack_kernel(w, b, off, n)
            if not torch.equal(got, ref.ref_unpack(w, b, off, n)):
                raise AssertionError(f"{name} disagrees at the query shape")
            err = 0.0
            shape = {"values": n, "bit_width": b, "words": w.shape[0]}
            nbytes, nops = 4 * w.shape[0] + 4 * n, n
            kern_fn = lambda: ku.unpack_kernel(w, b, off, n)  # noqa: E731
            plain_fn = lambda: ref.ref_unpack(w, b, off, n)  # noqa: E731
            shape["device_ms"] = device_us(kern_fn, "unpack") / 1e3
        elif name == "bucketize_packed_kernel":
            bnd, w, b, off, n, right = (rec["boundaries"], rec["words"],
                                        rec["bit_width"], rec["offset"],
                                        rec["nvals"], rec["right"])
            got = ku.bucketize_packed_kernel(bnd, w, b, off, n, right)
            if not torch.equal(got, ref.ref_bucketize_packed(bnd, w, b, off, n,
                                                             right)):
                raise AssertionError(f"{name} disagrees at the query shape")
            err = 0.0
            nb = bnd.shape[0]
            shape = {"boundaries": nb, "queries": n, "bit_width": b,
                     "right": right}
            nbytes = 4 * (nb + w.shape[0] + n)
            nops = n * _steps(nb)
            kern_fn = lambda: ku.bucketize_packed_kernel(  # noqa: E731
                bnd, w, b, off, n, right)
            plain_fn = lambda: ref.ref_bucketize_packed(  # noqa: E731
                bnd, w, b, off, n, right)
            shape["route"] = ("tiled" if nb > ku.MAX_SMEM_BOUNDARIES
                              else "shared memory")
            shape["device_ms"] = device_us(kern_fn, "bucketize") / 1e3
            # no PyTorch call computes this function: torch.searchsorted
            # needs the queries unpacked first. Timed beside it, it is not
            # the library time of the kernel line.
            q = ref.ref_unpack(w, b, off, n)
            searched = lambda: torch.searchsorted(  # noqa: E731
                bnd, q, right=right, out_int32=True)
            shape["searchsorted_on_unpacked_ms"] = time_ms(searched)
            shape["searchsorted_on_unpacked_ms_back_to_back"] = time_b2b_ms(
                searched, shape["searchsorted_on_unpacked_ms"])
        elif name == "rle_decode_packed_kernel":
            w, b, off, cap = (rec["words"], rec["bit_width"], rec["offset"],
                              rec["cap"])
            st, en, nn, nrows, fill = (rec["starts"], rec["ends"], rec["n"],
                                       rec["nrows"], rec["fill"])

            def kern():
                return ku.rle_decode_packed_kernel(w, b, off, cap, st, en, nn,
                                                   nrows, fill)

            def plain():
                return ref.ref_rle_decode_packed(w, b, off, cap, st, en, nn,
                                                 nrows, fill)

            if not torch.equal(kern(), plain()):
                raise AssertionError(f"{name} disagrees at the query shape")
            err = 0.0
            shape = {"capacity": cap, "nrows": nrows, "bit_width": b}
            nbytes = 4 * w.shape[0] + 8 * cap + 4 + 4 * nrows
            nops = nrows * _steps(cap)
            kern_fn, plain_fn = kern, plain
            shape["device_ms"] = device_us(kern, "rle") / 1e3
        elif name == "topk_kernel":
            x, k = rec["values"], rec["k"]
            got, want = kt.topk_kernel(x, k), ref.topk(x, k)
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"{name} disagrees at the query shape")
            err = 0.0
            n = x.shape[0]
            shape = {"values": n, "dtype": str(x.dtype), "k": k,
                     "k_pow2": kt.k_pow2_of(k), "passes": kt.passes(n, k)}
            # keys read once, k (value, index) pairs written; at least one
            # comparison a key
            nbytes, nops = 4 * n + 8 * k, n
            kern_fn = lambda: kt.topk_kernel(x, k)  # noqa: E731
            plain_fn = lambda: ref.topk(x, k)  # noqa: E731
            # same values; its tie order is not documented
            lib_fn = lambda: torch.topk(x, k)  # noqa: E731
            lib_what = "torch.topk"
            shape["more_shapes"] = topk_more_shapes(x.device, k)
            # the whole call at other grid caps than the default
            sms = torch.cuda.get_device_properties(
                x.device).multi_processor_count
            shape["grid_caps"] = []
            for per_sm in (1, kt.BLOCKS_PER_SM, 4):
                cap = sms * per_sm
                capped = lambda: kt.topk_kernel(  # noqa: E731
                    x, k, max_blocks=cap)
                if not all(torch.equal(g, w) for g, w in zip(capped(), want)):
                    raise AssertionError(f"{name} disagrees at cap {cap}")
                shape["grid_caps"].append({
                    "blocks_per_sm": per_sm,
                    "grid": kt.plan(n, k, cap)[0].grid,
                    "ms_back_to_back": time_b2b_ms(capped, 0.2)})
        else:
            v, ids, g = rec["values"], rec["segment_ids"], rec["num_segments"]
            got = segment_sum_kernel(v, ids, g)
            if not torch.equal(got, segment_sum_kernel(v, ids, g)):
                raise AssertionError(f"{name} not deterministic")
            plain = ref.ref_segment_reduce(v, ids, g)
            ids_h = ids.cpu().numpy()
            keep = (ids_h >= 0) & (ids_h < g)
            if v.dtype == torch.int32:  # exact, wrapping as the plain sum
                if not torch.equal(got, plain):
                    raise AssertionError(f"{name} int32 differs from plain")
                err = 0.0
            else:
                v_h = v.cpu().numpy().astype(np.float64)
                want = np.zeros(g, np.float64)
                np.add.at(want, ids_h[keep], v_h[keep])
                np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-4,
                                           atol=1e-3, err_msg=name)
                # against the float64 sum: a float32 plain sum into few
                # slots stalls at 2^24
                err = float(np.abs(got.cpu().numpy() - want).max())
            n = v.shape[0]
            shape = {"values": n, "num_segments": g, "dtype": str(v.dtype),
                     "dropped_ids": int((~keep).sum())}
            nbytes, nops = 8 * n + 4 * g, n
            kern_fn = lambda: segment_sum_kernel(v, ids, g)  # noqa: E731
            plain_fn = lambda: ref.ref_segment_reduce(v, ids, g)  # noqa: E731
            if bool(keep.all()):  # one index_add_ computes the same function
                lib_fn = lambda: torch.zeros(  # noqa: E731
                    g, dtype=v.dtype, device=v.device).index_add_(0, ids, v)
                lib_what = "index_add_"
            shape["more_shapes"] = segsum_more_shapes(v.device)
        lib_ms = lib_b2b = None
        if lib_fn is not None:  # kernel and library call in turns
            k_ms, lib_ms = time_turns_ms(kern_fn, lib_fn)
            lib_b2b = time_b2b_ms(lib_fn, lib_ms)
        else:
            k_ms = time_ms(kern_fn)
        p_ms = time_ms(plain_fn)
        k_b2b = time_b2b_ms(kern_fn, k_ms)
        b_ms, b_by = bound_ms(nbytes, nops)
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
               "ms_back_to_back": k_b2b, "library_ms_back_to_back": lib_b2b}
        print(json.dumps({"kernel": name, "kernel_ms_per_launch": k_ms,
                          "kernel_ms_back_to_back": k_b2b, "plain_ms": p_ms,
                          "library_ms_per_launch": lib_ms,
                          "library_ms_back_to_back": lib_b2b,
                          "library": lib_what, "bound_ms": b_ms,
                          "bound_by": b_by, "shape": shape,
                          "launches": launches[name],
                          "max_abs_err": err}), flush=True)
        rows.append(row)
    return rows


def bench_inputs(dev):
    """Seeded inputs, made on the card, at the main path's shapes (SF10):
    ``[(kernel, label, call, plain, exact, bytes, ops)]``. Only calls that
    the wrappers of earlier trees take too (``--src``), plus the int32
    segment sums where the wrapper has them."""
    import torch
    from repro_torch.kernels import bucketize as kb, ref
    from repro_torch.kernels import segment_reduce as ks
    from repro_torch.kernels import topk as kt
    from repro_torch.kernels import unpack as ku
    from repro_torch.kernels.rle_decode import rle_decode_kernel

    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    n = LINEITEM_ROWS[10.0]
    i32 = torch.int32

    def ints(lo, hi, size):
        return torch.randint(lo, hi, (size,), dtype=i32, device=dev,
                             generator=gen)

    out = []
    b = torch.sort(ints(-50, 50, 550)).values
    q = ints(-60, 60, 1_406_900)
    out.append(("bucketize_kernel", "550 x 1,406,900", lambda: kb.bucketize_kernel(b, q), lambda: ref.ref_bucketize(b, q), True, 4 * (550 + 2 * q.shape[0]), q.shape[0] * _steps(550)))  # noqa: E501
    # Q3's join probe: ORDERS keys passing orderdate < 180 (about 49%),
    # sentinel-padded to 2^23; LINEITEM orderkeys sorted, and random
    keys = torch.arange(n // 4, dtype=i32, device=dev)
    keys = keys[torch.rand(n // 4, device=dev, generator=gen) < 180 / 366]
    q3_b = torch.full((1 << 23,), 2**31 - 1, dtype=i32, device=dev)
    q3_b[:keys.shape[0]] = keys
    q3_sorted = torch.sort(ints(0, n // 4, n)).values
    q3_random = ints(0, n // 4, n)
    q17_b = torch.unique(ints(0, n // 30, n // 600))
    q17_q = torch.sort(ints(0, n // 30, n)).values
    for label, bb, qq in (("Q3 2^23 x 59,986,052 sorted", q3_b, q3_sorted),
                          ("Q3 2^23 x 59,986,052 random", q3_b, q3_random),
                          (f"Q17 {q17_b.shape[0]:,} x 59,986,052 sorted",
                           q17_b, q17_q)):
        out.append(("bucketize_count_kernel", label,
                    lambda bb=bb, qq=qq: kb.bucketize_count_kernel(bb, qq),
                    lambda bb=bb, qq=qq: ref.ref_bucketize(bb, qq), True,
                    4 * (bb.shape[0] + 2 * qq.shape[0]),
                    qq.shape[0] * _steps(bb.shape[0])))
    starts = torch.sort(torch.randperm(n, device=dev, generator=gen)[:550]
                        ).values.to(i32)
    starts[0] = 0
    ends = torch.cat([starts[1:] - 1, torch.tensor([n - 1], device=dev,
                                                   dtype=i32)])
    vals = ints(0, 100, 550)
    cnt = torch.tensor(550, dtype=i32, device=dev)
    out.append(("rle_decode_kernel", "capacity 550 x 59,986,052", lambda: rle_decode_kernel(vals, starts, ends, cnt, n), lambda: ref.ref_rle_decode(vals, starts, ends, cnt, n), True, 12 * 550 + 4 + 4 * n, n * _steps(550)))  # noqa: E501
    # the short-run shape: about 2^21 runs of 1-4 rows with gaps, 2^23 rows
    srows = 1 << 23
    ss, se = short_runs(np.random.default_rng(21), srows)
    nsr = len(ss)
    sst, sen = (torch.from_numpy(a.astype(np.int32)).to(dev) for a in (ss, se))
    svals = ints(0, 100, nsr)
    scnt = torch.tensor(nsr, dtype=i32, device=dev)
    out.append(("rle_decode_kernel", f"{nsr:,} short runs x 2^23", lambda: rle_decode_kernel(svals, sst, sen, scnt, srows), lambda: ref.ref_rle_decode(svals, sst, sen, scnt, srows), True, 12 * nsr + 4 + 4 * srows, srows * _steps(nsr)))  # noqa: E501
    int32_sums = hasattr(ks, "plan")  # the int32 instantiation
    for rows, groups in ((n, (1, 16, 512)), (1 << 23, (1, 16))):
        for g in groups:
            ids = (torch.zeros(rows, dtype=i32, device=dev) if g == 1
                   else ints(0, g + 1, rows))  # id g: dropped
            for dtype in (torch.float32, torch.int32):
                if dtype == torch.int32 and not int32_sums:
                    continue
                v = (torch.rand(rows, device=dev, generator=gen)
                     if dtype == torch.float32 else ints(0, 2, rows))
                # float sums are held against the plain version in
                # float64 (a float32 index_add_ into one slot stalls at 2^24)
                out.append(("segment_sum_kernel",
                            f"{rows:,} x G={g} {str(dtype)[6:]}",
                            lambda v=v, ids=ids, g=g: ks.segment_sum_kernel(
                                v, ids, g),
                            lambda v=v, ids=ids, g=g: ref.ref_segment_reduce(
                                v if v.dtype == torch.int32 else v.double(),
                                ids, g), dtype == torch.int32,
                            8 * rows + 4 * g, rows))
    words24 = ints(-(2**31), 2**31 - 1, ku.nwords_for(1 << 23, 24))
    out.append(("unpack_kernel", "2^23 x 24 bits", lambda: ku.unpack_kernel(words24, 24, 0, 1 << 23), lambda: ref.ref_unpack(words24, 24, 0, 1 << 23), True, 4 * words24.shape[0] + 4 * (1 << 23), 1 << 23))  # noqa: E501
    # smaller launch classes of the streamed path (_build.SHAPES), so each
    # class is priced at its own time
    for nv in (8, 4096, 1 << 17, 1 << 19):
        wv = ints(-(2**31), 2**31 - 1, ku.nwords_for(nv, 24))
        out.append(("unpack_kernel", f"{nv:,} x 24 bits",
                    lambda wv=wv, nv=nv: ku.unpack_kernel(wv, 24, 0, nv),
                    lambda wv=wv, nv=nv: ref.ref_unpack(wv, 24, 0, nv), True,
                    4 * wv.shape[0] + 4 * nv, nv))
    # Q17's streamed semi-join: 97,533 part keys against a partition's
    # packed RLE run values of partkey, 21 bits (offset 0): the partition's
    # consecutive keys (280,000 of 2^23 rows; 44,000 in the short last
    # one), then code 0 up to the capacity; and random queries
    from repro_torch.core import compress
    pb = torch.sort(ints(0, 1 << 21, 97_533)).values
    for nq, n_valid in ((524_288, 280_000), (65_536, 44_000)):
        qv = np.zeros(nq, np.int64)
        qv[:n_valid] = 3 * n_valid + np.arange(n_valid)
        wq = torch.from_numpy(compress.pack_array(qv, 0, 21).view(
            np.int32)).to(dev)
        wr = ints(-(2**31), 2**31 - 1, ku.nwords_for(nq, 21))
        for label, ww in (("sorted + code-0 padding", wq), ("random", wr)):
            out.append(("bucketize_packed_kernel",
                        f"97,533 x {nq:,} x 21 bits, {label}",
                        lambda ww=ww, nq=nq: ku.bucketize_packed_kernel(
                            pb, ww, 21, 0, nq),
                        lambda ww=ww, nq=nq: ref.ref_bucketize_packed(
                            pb, ww, 21, 0, nq), True,
                        4 * (97_533 + ww.shape[0] + nq),
                        nq * _steps(97_533)))
    rows = 1 << 23
    pst = torch.sort(torch.randperm(rows, device=dev, generator=gen)[:128]
                     ).values.to(i32)
    pst[0] = 0
    pen = torch.cat([pst[1:] - 1, torch.tensor([rows - 1], device=dev,
                                               dtype=i32)])
    words4 = ints(-(2**31), 2**31 - 1, ku.nwords_for(128, 4))
    pcnt = torch.tensor(128, dtype=i32, device=dev)
    out.append(("rle_decode_packed_kernel", "capacity 128 x 4 bits x 2^23", lambda: ku.rle_decode_packed_kernel(words4, 4, 0, 128, pst, pen, pcnt, rows), lambda: ref.ref_rle_decode_packed(words4, 4, 0, 128, pst, pen, pcnt, rows), True, 4 * words4.shape[0] + 8 * 128 + 4 + 4 * rows, rows * _steps(128)))  # noqa: E501
    swords = ints(-(2**31), 2**31 - 1, ku.nwords_for(nsr, 4))
    out.append(("rle_decode_packed_kernel", f"{nsr:,} short runs x 4 bits x 2^23", lambda: ku.rle_decode_packed_kernel(swords, 4, 0, nsr, sst, sen, scnt, srows), lambda: ref.ref_rle_decode_packed(swords, 4, 0, nsr, sst, sen, scnt, srows), True, 4 * swords.shape[0] + 8 * nsr + 4 + 4 * srows, srows * _steps(nsr)))  # noqa: E501
    keys = ints(-(2**31), 2**31 - 1, n)
    out.append(("topk_kernel", "59,986,052 int32, k=128", lambda: kt.topk_kernel(keys, 128), lambda: ref.topk(keys, 128), True, 4 * n + 8 * 128, n))  # noqa: E501
    return out


def kernel_bench(dev):
    """Every kernel at the main path's shapes (``bench_inputs``): each
    call held against its plain version, then its per-launch ms (events
    around one call, median of 30), back-to-back ms and device ms (the
    kernels' time a call in ``torch.profiler``, without the host's
    dispatch), beside the bound. One JSON line a shape; the list is
    returned."""
    import torch
    rows = []
    for name, label, call, plain, exact, nbytes, nops in bench_inputs(dev):
        got, want = call(), plain()
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [
            (got, want)]
        for g, w in pairs:
            if exact and not torch.equal(g, w):
                raise AssertionError(f"{name} {label}: differs from plain")
            if not exact:
                np.testing.assert_allclose(g.double().cpu().numpy(),
                                           w.double().cpu().numpy(),
                                           rtol=1e-4, atol=1e-2,
                                           err_msg=f"{name} {label}")
        ms = time_ms(call, iters=30)
        dev_us = device_us(call, "")
        rec = {"bench": name, "shape": label, "ms": ms,
               "ms_back_to_back": time_b2b_ms(call, ms),
               "device_ms": dev_us / 1e3 if dev_us else None,
               "bound_ms": bound_ms(nbytes, nops)[0]}
        print(json.dumps(rec), flush=True)
        rows.append(rec)
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phase 3: the query path at TPC-H scale
# ---------------------------------------------------------------------------


def profile_call(fn):
    """``fn()`` once under ``torch.profiler``: the events, and the device
    busy time, its share of the wall time, the kernels launched and the
    ops that launched the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    ops = sorted(((e.key, e.self_device_time_total / 1e3) for e in events
                  if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda kv: -kv[1])
    return events, {
        "profiled_wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
        "device_idle_share": max(0.0, 1.0 - busy_us / 1e3 / wall_ms),
        "kernel_launches": sum(e.count for e in kernels),
        "top_ops_device_ms": ops[:6]}


def profile_run(name, q, out_dir):
    """One more warm run of ``q`` under ``torch.profiler`` (``profile_call``);
    writes the op table to ``out_dir/<name>.txt``."""
    events, rec = profile_call(q.run)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{name}.txt").write_text(events.table(
        sort_by="self_device_time_total", row_limit=40))
    return rec


def query_phase(sf, dev, runs, profile_dir=None,
                names=("Q1", "Q3", "Q6", "Q17", "Q19")):
    """The resident path. Returns its per-query records and what the
    later phases reuse: the LINEITEM arrays of ``OOC_QUERIES``, the oracles
    and resident answers, ORDERS and the semi-join keys, and the resident
    tables the ordering phase ranks."""
    import torch
    from repro_torch.core import compress
    from repro_torch.core.table import Table
    from repro_torch.kernels import _build

    n = LINEITEM_ROWS.get(sf, int(round(LINEITEM_ROWS[1.0] * sf)))
    # every LINEITEM orderkey (in [0, n // 4)) must name an ORDERS row
    n_orders = max(int(round(SF1_ORDERS * sf)), n // 4)
    rng = np.random.default_rng(2)
    part_keys = np.unique(rng.integers(0, n // 30, n // 600)).astype(np.int32)
    cfg = compress.CompressionConfig(plain_threshold=1_000)
    orders = make_orders(rng, n_orders)
    orders_table = Table.from_arrays(orders, cfg=cfg, device=dev)
    print(f"query phase: LINEITEM {n} rows, ORDERS {n_orders} rows "
          f"(scale factor {sf}), {len(part_keys)} semi-join part keys",
          flush=True)
    per_query = {}
    shared = {"orders": orders, "orders_table": orders_table,
              "part_keys": part_keys, "data": {}, "want": {}, "resident": {},
              "tables": {}, "packed": {}}
    for name in ("Q1", "Q3", "Q6", "Q17", "Q19"):
        t0 = time.perf_counter()
        data = make_lineitem(rng, n, order=SORT_ORDERS[name], device=dev)
        if name not in names:  # drawn all the same: the others' data stay
            continue
        gen_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        table = Table.from_arrays(data, cfg=cfg, device=dev)
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        want = oracle(name, data, orders=orders, part_keys=part_keys)
        plain_bytes = sum(v.shape[0] * 4 for v in data.values())
        if name in OOC_QUERIES:  # generated once, streamed again later
            shared["data"][name] = data
            shared["want"][name] = want
        del data
        q = build_query(name, table, orders_table, part_keys)
        before, tally = dict(_build.LAUNCHES), decoder_tally()
        results, times = [], []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = q.run()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            results.append(host_result(res))
            del res
        caused = {k: (_build.LAUNCHES[k] - before[k]) // runs
                  for k in _build.LAUNCHES}
        check_answer(name, results[0], want)
        first = _bits(results[0])
        for other in results[1:]:
            if _bits(other) != first:
                raise AssertionError(f"{name}: re-run is not bit-identical")
        shared["resident"][name] = results[0]
        rec = {"query": name, "encodings": table.encodings(),
               "device_MiB_encoded": table.nbytes() / 2**20,
               "device_MiB_plain": plain_bytes / 2**20,
               "generate_s": gen_s, "ingest_s": ingest_s,
               "cold_ms": times[0], "warm_median_ms":
               statistics.median(times[1:]) if runs > 1 else None,
               "launches_per_run": caused,
               "decoder_shapes_per_run": decoder_shapes(tally, runs),
               "oracle": "ok",
               "rerun_bit_identical": True}
        if profile_dir is not None:
            rec["profile"] = profile_run(name, q, profile_dir)
        print(json.dumps(rec), flush=True)
        per_query[name] = rec
        if name in RANKED_SOURCE.values():  # ranked again, resident
            shared["tables"][name] = table
        del q, table
        torch.cuda.empty_cache()
    return per_query, shared


# ---------------------------------------------------------------------------
# Phase 4: the out-of-core path (packed partitions streamed from the host)
# ---------------------------------------------------------------------------


def pinned_h2d_gbps(dev, nbytes=1 << 30, iters=5):
    """Host-to-device rate of one ``nbytes`` copy from pinned memory
    (median of ``iters`` CUDA-event timings), in GB/s."""
    import torch
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    ms = time_ms(lambda: dst.copy_(src, non_blocking=True), iters=iters,
                 warmup=1)
    del src, dst
    torch.cuda.empty_cache()
    return nbytes / (ms * 1e-3) / 1e9


def _timed_run(q):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = host_result(q.run())
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3


def chaos_plan(seed, visited):
    """``FaultPlan.seeded``'s schedule (transient transfer faults and one
    OOM in the program, each at attempt 0 of a distinct partition) drawn
    over the partitions the query visits: a fault placed on a partition
    that zone maps prune would never fire. Three transients and one OOM
    when at least four partitions are visited."""
    from repro_torch.core.faults import FaultPlan
    k = min(4, len(visited))
    chosen = np.random.default_rng(seed).choice(visited, size=k, replace=False)
    plan = FaultPlan()
    for p in chosen[:-1]:
        plan.transient(int(p))
    return plan.oom(int(chosen[-1]), site="compute")


def outofcore_phase(dev, shared, h2d_gbps, seed, profile_dir=None,
                    names=OOC_QUERIES):
    """Stream ``OOC_QUERIES`` over packed (and, for comparison, unpacked)
    host partitions; returns the per-query records. With ``profile_dir``,
    one more depth-2 run of each query goes under ``torch.profiler``."""
    import torch
    from repro_torch.core import compress, telemetry
    from repro_torch.core.partition import PartitionedQuery, PartitionedTable
    from repro_torch.kernels import _build, dispatch

    cfg = compress.CompressionConfig(plain_threshold=1_000)
    orders_table, part_keys = shared["orders_table"], shared["part_keys"]
    per_query = {}
    for name in (q for q in OOC_QUERIES if q in names):
        data = shared["data"][name]
        if name not in RANKED_SOURCE.values():
            del shared["data"][name]
        n = len(data["price"])
        # 8 partitions: 2**23 rows each at scale factor 10
        rows = 1 << max(8, (-(-n // 8) - 1).bit_length())
        tables, rec = {}, {"query": name, "partition_rows": rows}
        for pack in (True, False):
            t0 = time.perf_counter()
            tables[pack] = PartitionedTable.from_arrays(
                data, cfg=cfg, partition_rows=rows, pack=pack,
                budget_bytes=1 << 30, device=dev)
            rec[f"ingest_s_{'packed' if pack else 'unpacked'}"] = \
                time.perf_counter() - t0
        del data
        pt = tables[True]
        rec["partitions"] = len(pt.partitions)
        rec["padded_rows"] = sorted({p.padded_rows for p in pt.partitions})
        rec["host_MiB_packed"] = pt.nbytes() / 2**20
        rec["host_MiB_unpacked_partitions"] = tables[False].nbytes() / 2**20
        rec["MiB_unpacked_accounting"] = pt.nbytes_unpacked() / 2**20

        def query(table):
            return build_query(name, table, orders_table, part_keys,
                               query_cls=PartitionedQuery)

        results, times = {}, {0: [], 1: [], 2: []}
        moved = []
        for depth in (0, 1, 2, 0, 2, 0, 2):
            before, tally = dict(_build.LAUNCHES), decoder_tally()
            first2 = depth == 2 and "launches_per_run" not in rec
            if first2:  # the device memory one run adds at its peak
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            with dispatch.overrides(prefetch_depth=depth), \
                    telemetry.h2d_listener(lambda nb, tree: moved.append(nb)):
                q = query(pt)
                res, ms = _timed_run(q)
            if first2:
                rec["launches_per_run"] = {
                    k: _build.LAUNCHES[k] - before[k] for k in _build.KERNELS}
                rec["unpack_launches_per_run"] = \
                    rec["launches_per_run"]["unpack_kernel"]
                rec["decoder_shapes_per_run"] = decoder_shapes(tally)
                peak = torch.cuda.max_memory_allocated(dev)
                rec["max_memory_allocated_MiB_depth2"] = peak / 2**20
                rec["run_peak_over_baseline_MiB_depth2"] = (peak - base) / 2**20
                rec["partition_MiB_unpacked_max"] = max(
                    p.table.nbytes_unpacked() for p in pt.partitions) / 2**20
            times[depth].append(ms)
            if depth in results and _bits(res) != _bits(results[depth]):
                raise AssertionError(f"{name}: depth-{depth} re-run differs")
            results.setdefault(depth, res)
            stats = dict(q.last_stats)
            if depth == 2:
                rec["stats_depth2"] = {k: stats[k] for k in (
                    "partitions", "executed", "skipped", "transferred",
                    "h2d_ms", "compute_ms", "merge_ms", "inflight_bytes_max",
                    "prefetch_depth")}
        bytes_moved = sum(moved) // len(times[0] + times[1] + times[2])
        check_answer(name, results[0], shared["want"][name])
        for depth in (1, 2):
            if _bits(results[depth]) != _bits(results[0]):
                raise AssertionError(f"{name}: depth {depth} is not "
                                     "bit-identical to depth 0")
        check_same(name, results[0], shared["resident"][name])
        moved_unpacked = []
        with telemetry.h2d_listener(lambda nb, tree: moved_unpacked.append(nb)):
            unpacked, ms_unpacked = _timed_run(query(tables[False]))
        check_same(name, results[0], unpacked)
        rec.update({
            "visited": stats["executed"], "pruned": stats["skipped"],
            "bytes_moved_packed": bytes_moved,
            "bytes_moved_unpacked": sum(moved_unpacked),
            "pinned_h2d_GBps": h2d_gbps,
            "h2d_bound_ms_packed": bytes_moved / (h2d_gbps * 1e9) * 1e3,
            "h2d_bound_ms_unpacked":
                sum(moved_unpacked) / (h2d_gbps * 1e9) * 1e3,
            "cold_ms_depth0": times[0][0],
            "warm_ms_depth0": statistics.median(times[0][1:]),
            "warm_ms_depth1": times[1][0],
            "warm_ms_depth2": statistics.median(times[2]),
            "ms_unpacked_depth2": ms_unpacked,
            "oracle": "ok", "matches_resident": True,
            "depths_bit_identical": True, "matches_unpacked": True,
            "unpacked_bit_identical": _bits(unpacked) == _bits(results[0]),
        })
        if profile_dir is not None:
            with dispatch.overrides(prefetch_depth=2):
                rec["profile_depth2"] = profile_run(f"streamed_{name}",
                                                    query(pt), profile_dir)
        if name == "Q6":
            plan = chaos_plan(seed, [i for i, ok, _ in q.last_verdicts if ok])
            with plan:
                q = query(pt)
                chaos, ms = _timed_run(q)
            if len(plan.fired) != len(plan.scheduled()):
                raise AssertionError(f"chaos: {len(plan.fired)} of "
                                     f"{len(plan.scheduled())} faults fired")
            if _bits(chaos) != _bits(results[2]):
                raise AssertionError("chaos: recovered Q6 differs from the "
                                     "clean run")
            rec["chaos"] = {"fired": len(plan.fired), "ms": ms,
                            "retries": q.last_stats["retries"],
                            "degradations": q.last_stats["degradations"],
                            "final_depth": q.last_stats["prefetch_depth"],
                            "bit_identical": True}
        print(json.dumps(rec), flush=True)
        per_query[name] = rec
        if name in RANKED_SOURCE.values():  # streamed again, ranked
            shared["packed"][name] = pt
        del tables, pt
        torch.cuda.empty_cache()
    return per_query


# ---------------------------------------------------------------------------
# Phase 5: ORDER BY / TOP-K, resident and streamed
# ---------------------------------------------------------------------------


def ordering_phase(dev, shared, runs, profile_dir=None):
    """R1, R2 and Q3r on the resident tables of the query phase and over
    the packed partitions of the out-of-core phase (depth 0, 1, 2);
    returns the per-query records."""
    import torch
    from repro_torch.core import telemetry
    from repro_torch.core.partition import PartitionedQuery
    from repro_torch.kernels import _build, dispatch
    from repro_torch.kernels import topk as kt

    orders_table = shared["orders_table"]
    per_query = {}
    for name, src in RANKED_SOURCE.items():
        # the serving phase reads SERVE_SOURCE's arrays and partitions
        data = (shared["data"][src] if src == SERVE_SOURCE
                else shared["data"].pop(src))
        want = ranked_oracle(name, data, shared["want"].get(src))
        del data
        table = shared["tables"].pop(src)
        q = build_ranked(name, table, orders_table)
        rec = {"query": name, "table": f"LINEITEM sorted for {src}",
               "path": q._order_path(q.order_op())}
        results, times = [], []
        for i in range(runs):
            before, tally = dict(_build.LAUNCHES), decoder_tally()
            res, ms = _timed_run(q)
            if i == 0:
                rec["launches_per_run"] = {
                    k: _build.LAUNCHES[k] - before[k] for k in _build.KERNELS}
                rec["decoder_shapes_per_run"] = decoder_shapes(tally)
            results.append(res)
            times.append(ms)
        check_ranked(name, results[0], want)
        if name == "R1" and dev.type == "cuda":
            # every run launches topk.passes(rows, k) times
            n_keys = _build.LARGEST["topk_kernel"]["values"].shape[0]
            expect = kt.passes(n_keys, kt.k_pow2_of(100))
            got = rec["launches_per_run"]["topk_kernel"]
            if got != expect:
                raise AssertionError(f"R1: {got} topk launches a resident run, "
                                     f"want {expect}")
        for other in results[1:]:
            if _bits(other) != _bits(results[0]):
                raise AssertionError(f"{name}: re-run is not bit-identical")
        resident = results[0]
        rec.update({"cold_ms": times[0], "warm_median_ms":
                    statistics.median(times[1:]) if runs > 1 else None,
                    "oracle": "ok", "rerun_bit_identical": True})
        if profile_dir is not None:
            rec["profile"] = profile_run(name, q, profile_dir)
        del q, table

        pt = (shared["packed"][src] if src == SERVE_SOURCE
              else shared["packed"].pop(src))
        streamed, stimes, moved = {}, {0: [], 1: [], 2: []}, []
        for depth in (0, 1, 2, 0, 2):
            before, tally = dict(_build.LAUNCHES), decoder_tally()
            with dispatch.overrides(prefetch_depth=depth), \
                    telemetry.h2d_listener(lambda nb, tree: moved.append(nb)):
                sq = build_ranked(name, pt, orders_table,
                                  query_cls=PartitionedQuery)
                res, ms = _timed_run(sq)
            stimes[depth].append(ms)
            if depth in streamed and _bits(res) != _bits(streamed[depth]):
                raise AssertionError(f"{name}: streamed depth-{depth} re-run "
                                     "differs")
            streamed.setdefault(depth, res)
            if depth == 2 and "stats_depth2" not in rec:
                stats = dict(sq.last_stats)
                rec["stats_depth2"] = {k: stats.get(k, 0) for k in (
                    "partitions", "executed", "skipped", "ranked_skipped",
                    "prefetch_wasted", "transferred", "h2d_ms", "compute_ms",
                    "merge_ms", "prefetch_depth")}
                rec["streamed_launches_per_run"] = {
                    k: _build.LAUNCHES[k] - before[k] for k in _build.KERNELS}
                rec["streamed_decoder_shapes_per_run"] = decoder_shapes(tally)
        for depth in (1, 2):
            if _bits(streamed[depth]) != _bits(streamed[0]):
                raise AssertionError(f"{name}: depth {depth} is not "
                                     "bit-identical to depth 0")
        check_ranked(name, streamed[0], want)
        if name == "Q3r":  # float sums in another order than resident
            check_same(name, streamed[0], resident)
        elif _bits(streamed[0]) != _bits(resident):
            raise AssertionError(f"{name}: streamed differs from resident")
        st = rec["stats_depth2"]
        if name == "R2" and st["ranked_skipped"] == 0:
            raise AssertionError("R2: no partition was pruned by rank")
        if name == "R1" and dev.type == "cuda":
            # one call a visited partition, passes() launches a call
            kk = kt.k_pow2_of(100)
            visited = [p for p in pt.partitions if p.rows]
            expect = sum(kt.passes(p.padded_rows, kk) for p in visited)
            got = rec["streamed_launches_per_run"]["topk_kernel"]
            if st["executed"] == len(visited) and got != expect:
                raise AssertionError(f"R1: {got} topk launches, want {expect}")
            if got < st["executed"]:
                raise AssertionError("R1: a visited partition launched no "
                                     "topk_kernel")
        rec.update({
            "visited": st["executed"], "zone_pruned": st["skipped"],
            "ranked_pruned": st["ranked_skipped"],
            "bytes_moved": sum(moved) // 5,
            "cold_ms_depth0": stimes[0][0],
            "warm_ms_depth0": stimes[0][1],
            "warm_ms_depth1": stimes[1][0],
            "warm_ms_depth2": statistics.median(stimes[2]),
            "streamed_oracle": "ok", "depths_bit_identical": True,
            "streamed_equals_resident": "bit-identical" if name != "Q3r"
            else "keys and counts equal, sums within rtol 1e-4",
        })
        if profile_dir is not None:
            with dispatch.overrides(prefetch_depth=2):
                rec["profile_depth2"] = profile_run(
                    f"streamed_{name}", build_ranked(
                        name, pt, orders_table, query_cls=PartitionedQuery),
                    profile_dir)
        print(json.dumps(rec), flush=True)
        per_query[name] = rec
        del pt
        torch.cuda.empty_cache()
    return per_query


# ---------------------------------------------------------------------------
# Phase 6: the query server (core/serve.py) over the packed partitions
# ---------------------------------------------------------------------------


def build_served(name, table, orders_table, part_keys):
    """A query of ``SERVE_MIX`` staged on the partitioned ``table``."""
    from repro_torch.core.partition import PartitionedQuery
    if name in RANKED_SOURCE:
        return build_ranked(name, table, orders_table,
                            query_cls=PartitionedQuery)
    return build_query(name, table, orders_table, part_keys,
                       query_cls=PartitionedQuery)


def served_oracles(d, orders, part_keys):
    """The mix's answers on ``d`` with numpy: every aggregate by
    ``oracle``, R1 and Q3r by ``ranked_oracle``."""
    want = {name: oracle(name, d, orders=orders, part_keys=part_keys)
            for name in SERVE_MIX if name not in RANKED_SOURCE}
    want["R1"] = ranked_oracle("R1", d)
    want["Q3r"] = ranked_oracle("Q3r", d, want["Q3"])
    return want


def check_served(name, got, want):
    (check_ranked if name in RANKED_SOURCE else check_answer)(name, got,
                                                              want)


def _server_counters(srv):
    s = srv.stats()
    return {"plan_hits": s["plan_cache"]["hits"],
            "plan_misses": s["plan_cache"]["misses"],
            "lru_hits": s["residency"]["hits"],
            "lru_misses": s["residency"]["misses"],
            "evictions": s["residency"]["evictions"],
            "passes": s["scans"]["passes"],
            "shared_queries": s["scans"]["shared_queries"],
            "solo_queries": s["scans"]["solo_queries"]}


def _served_round(srv, make, plan, label, solo, want):
    """Submit ``plan`` (one list of mix names per client thread) to
    ``srv``, wait for every answer, and hold each to its solo run (bit
    for bit) and to the oracle. A server with a drain thread gets one
    client thread a list; one without (``start=False``) gets the whole
    plan queued first, then ``step()``s it batch by batch (its admission
    is then deterministic). Returns the round's JSON record: latency,
    counters moved, H2D bytes, launches, and the batch sizes of a
    stepped round."""
    import threading
    from repro_torch.core import telemetry
    from repro_torch.kernels import _build

    before = _server_counters(srv)
    launches0 = dict(_build.LAUNCHES)
    moved, done, errors, batches = [], [], [], []

    def client(names):
        try:
            tickets = [(n, srv.submit(make(n))) for n in names]
            if srv._worker is None:
                while True:
                    k = srv.step()
                    if not k:
                        break
                    batches.append(k)
            for n, t in tickets:
                srv.result(t, timeout=900)
                done.append((n, t))
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    with telemetry.h2d_listener(lambda nb, tree: moved.append(nb)):
        t0 = time.perf_counter()
        if srv._worker is None:
            client([n for names in plan for n in names])
        else:
            threads = [threading.Thread(target=client, args=(names,))
                       for names in plan]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        wall = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"{label}: a served query failed: {errors[0]!r}")
    if srv._fatal is not None or (srv._worker is not None
                                  and not srv._worker.is_alive()):
        raise AssertionError(f"{label}: the drain thread died: {srv._fatal!r}")
    if len(done) != sum(len(p) for p in plan):
        raise AssertionError(f"{label}: {len(done)} answers")
    for n, t in done:
        got = host_result(t.result)
        if _bits(got) != _bits(solo[n]):
            raise AssertionError(f"{label}: served {n} is not bit-identical "
                                 "to its solo run")
        check_served(n, got, want[n])
    after = _server_counters(srv)
    lat = np.array([t.latency_ms for _, t in done])
    return {"round": label, "submissions": len(done), "wall_s": wall,
            "qps": len(done) / wall,
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "mean_ms": float(lat.mean()),
            **{k: after[k] - before[k] for k in after},
            "plan_hit_submissions": sum(t.plan_hit for _, t in done),
            "resident_bytes": srv.lru.resident_bytes,
            "budget_bytes": srv.budget_bytes,
            "h2d_bytes": int(sum(moved)), "h2d_transfers": len(moved),
            "launches": {k: _build.LAUNCHES[k] - launches0[k]
                         for k in _build.KERNELS},
            "batches": batches,
            "answers": "bit-identical to solo runs, oracle ok"}


def serving_phase(dev, shared, seed, card):
    """The query server over the Q1-ordered packed partitions that the
    ordering phase streamed R1 over, ORDERS resident. Server A holds the
    whole table (``budget_bytes=nbytes()`` plus the CUDA graphs' input
    slot, which the budget includes; ``max_batch=8``):
    ``SERVE_CLIENTS`` threads submit the mix twice in seeded orders, a
    cold round and a warm one that must hit the plan cache on every
    submission and move no H2D byte. Server B holds a third of the table:
    the mix once, evicting, split into several passes. Every answer is
    bit-identical to the query's solo ``run()`` at depth 2 (taken before
    either server starts) and matches its numpy oracle. Launch counts are
    zeroed after the solo runs, just before server A; the caller reads
    them after this returns the records."""
    from repro_torch.core.graphs import ProgramGraphs
    from repro_torch.core.serve import QueryServer
    from repro_torch.kernels import _build, dispatch

    pt = shared["packed"].pop(SERVE_SOURCE)
    orders_table, part_keys = shared["orders_table"], shared["part_keys"]
    d = shared["data"].pop(SERVE_SOURCE)
    want = served_oracles(d, shared["orders"], part_keys)
    del d

    def make(name):
        return build_served(name, pt, orders_table, part_keys)

    solo, solo_rec = {}, {}
    with dispatch.overrides(prefetch_depth=2):
        for name in SERVE_MIX:
            before = dict(_build.LAUNCHES)
            solo[name], ms = _timed_run(make(name))
            check_served(name, solo[name], want[name])
            solo_rec[name] = {"ms": ms, "launches": {
                k: _build.LAUNCHES[k] - before[k] for k in _build.KERNELS}}
    # the solo runs are the comparison: the served path's counts start here
    _build.reset_launches()
    print(json.dumps({"serving_solo_depth2": solo_rec, "partitions":
                      len(pt.partitions), "table_bytes": pt.nbytes(),
                      "oracle": "ok", "card": card}), flush=True)
    rng = np.random.default_rng(seed)
    records = []
    whole = pt.nbytes() + ProgramGraphs(pt, dev).slot_nbytes
    with QueryServer(pt, budget_bytes=whole, max_batch=8) as srv:
        for label in ("A_cold", "A_warm"):
            plan = [[SERVE_MIX[i] for i in rng.permutation(len(SERVE_MIX))]
                    for _ in range(SERVE_CLIENTS)]
            rec = _served_round(srv, make, plan, label, solo, want)
            records.append(rec)
            print(json.dumps({**rec, "card": card}), flush=True)
    warm = records[-1]
    if warm["plan_misses"] or warm["plan_hit_submissions"] != \
            warm["submissions"]:
        raise AssertionError(f"A_warm: {warm['plan_misses']} plan-cache "
                             "misses; every submission must hit")
    if warm["h2d_bytes"] or warm["lru_misses"]:
        raise AssertionError(f"A_warm: {warm['h2d_bytes']} H2D bytes, "
                             f"{warm['lru_misses']} residency misses")
    # the whole mix queued, then stepped: with the budget of server A it
    # would be one batch (max_batch=8); a third of the table must split it
    with QueryServer(pt, budget_bytes=pt.nbytes() // 3, max_batch=8,
                     start=False) as srv:
        plan = [[SERVE_MIX[i] for i in rng.permutation(len(SERVE_MIX))]]
        rec = _served_round(srv, make, plan, "B_third", solo, want)
    records.append(rec)
    print(json.dumps({**rec, "card": card}), flush=True)
    if rec["evictions"] == 0:
        raise AssertionError("B_third: a third of the table evicted nothing")
    if len(rec["batches"]) <= 1:
        raise AssertionError("B_third: budget admission did not split the "
                             "mix into several passes")
    del pt
    return records


# ---------------------------------------------------------------------------
# Model phase: the LLM serving path (repro_torch.models / launch.serve_model)
# ---------------------------------------------------------------------------


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, in float32 on the host."""
    got = got.detach().float().cpu()
    want = want.detach().float().cpu()
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    return float((got - want).abs().max() / want.abs().max())


def _model_inputs(cfg, rng, B, S):
    """A seeded batch of S positions: token ids, or frame embeddings for
    the audio family (vlm: tokens after its image-patch prefix)."""
    import torch
    if cfg.family == "audio":
        return {"embeds": torch.from_numpy(
            rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))}
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))}
    if cfg.family == "vlm":
        ni = cfg.n_image_tokens
        batch["tokens"] = batch["tokens"][:, ni:]
        batch["patch_embeds"] = torch.from_numpy(
            rng.standard_normal((B, ni, cfg.d_model)).astype(np.float32))
    return batch


def teacher_forced(params, cfg, steps, device):
    """Decode logits [B, S, ...] of S teacher-forced ``decode_step`` calls
    (``steps``: the per-position input, ``tokens`` or ``embeds``)."""
    import torch
    from repro_torch.models import model as M
    key = "embeds" if cfg.family == "audio" else "tokens"
    B, S = steps[key].shape[:2]
    cache = M.init_cache(cfg, B, S, device)
    outs = []
    with torch.inference_mode():
        for i in range(S):
            lg, cache = M.decode_step(params, cfg, cache,
                                      {key: steps[key][:, i:i + 1]}, i)
            outs.append(lg[:, -1])
    return torch.stack(outs, dim=1)


def model_full(arch, dev, seed, card):
    """One full-width attention-family model, bf16 on the card, random
    weights from ``seed``: two serving runs of ``launch.serve_model``'s
    loop (``MODEL_BATCH`` prompts of ``MODEL_PROMPT`` seeded tokens, a
    token-by-token prefill, ``MODEL_GEN`` greedy tokens) that must give
    the same ids and no NaN, then teacher-forced ``decode_step`` logits
    against ``forward`` on the prompts' first ``MODEL_PREFIX`` tokens,
    relative max error below ``MODEL_DECODE_BOUND`` (with capacity factor
    16, as ``tests/test_models.py`` does: at the default factor forward
    drops tokens over an expert's capacity and one-token decode never
    does). Peak device memory is read after the weights are drawn; one
    more decode step runs under ``torch.profiler`` (device busy time, idle
    share, kernel launches), beside the time to read the weights once."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.launch.serve_model import generate
    from repro_torch.models import model as M
    cfg = configs.get_config(arch)
    B, P, G = MODEL_BATCH, MODEL_PROMPT, MODEL_GEN
    t0 = time.perf_counter()
    params = M.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    prompt = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)
    runs = []
    for _ in range(2):
        ids, logits, t = generate(params, cfg, M.init_cache(cfg, B, P + G, dev),
                                  prompt, G)
        if torch.isnan(logits.float()).any():
            raise AssertionError(f"{arch}: NaN in the decode logits")
        runs.append((ids, t))
    if not np.array_equal(runs[0][0], runs[1][0]):
        raise AssertionError(f"{arch}: two serving runs gave other ids")
    serve_peak = torch.cuda.max_memory_allocated()
    # one warm decode step (its work does not depend on the position: it
    # attends over the whole cache under a mask)
    cache = M.init_cache(cfg, B, P + G, dev)
    step_in = {"tokens": torch.from_numpy(prompt[:, :1]).to(dev)}
    with torch.inference_mode():
        _, step = profile_call(
            lambda: M.decode_step(params, cfg, cache, step_in, 0))
    del cache
    check = dataclasses.replace(cfg, capacity_factor=16.0)
    prefix = torch.from_numpy(prompt[:, :MODEL_PREFIX]).to(dev)
    with torch.inference_mode():
        fwd, _ = M.forward(params, check, {"tokens": prefix})
    if torch.isnan(fwd.float()).any():
        raise AssertionError(f"{arch}: NaN in the forward logits")
    rel = rel_err(teacher_forced(params, check, {"tokens": prefix}, dev), fwd)
    gated, rel32 = rel, None
    if cfg.family in MODEL_FLOAT32_CHECK:
        del fwd
        params.float()  # in place: the same weights, widened
        check = dataclasses.replace(check, dtype=torch.float32)
        with torch.inference_mode():
            fwd, _ = M.forward(params, check, {"tokens": prefix})
        rel32 = gated = rel_err(
            teacher_forced(params, check, {"tokens": prefix}, dev), fwd)
        if cfg.family in MODEL_UNGATED:
            gated = None
    if gated is not None and not gated < MODEL_DECODE_BOUND:
        raise AssertionError(f"{arch}: decode against forward rel err "
                             f"{gated} >= {MODEL_DECODE_BOUND}")
    rec = {"model": cfg.name, "family": cfg.family, "dtype": "bfloat16",
           "params": M.param_count(params),
           "active_params": M.active_param_count(cfg, params),
           "weight_bytes": weight_bytes, "batch": B, "prompt": P, "gen": G,
           "init_s": init_s,
           "prefill_tok_s": [B * P / t["prefill_s"] for _, t in runs],
           "decode_tok_s": [B * G / t["decode_s"] for _, t in runs],
           "prefill_s": [t["prefill_s"] for _, t in runs],
           "decode_s": [t["decode_s"] for _, t in runs],
           "max_memory_allocated_MiB": serve_peak / 2**20,
           "held_before_serving_MiB": held / 2**20,
           "decode_step_profile": step,
           "weights_read_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
           "decode_vs_forward_rel_err": rel,
           "decode_vs_forward_rel_err_float32": rel32,
           "decode_bound_checked_in": None if gated is None
           else "float32" if rel32 is not None else "bfloat16",
           "ids_first_seq": runs[0][0][0].tolist(),
           "ids_same_in_two_runs": True, "card": card}
    print(json.dumps(rec), flush=True)
    del params, fwd
    torch.cuda.empty_cache()
    return rec


def smoke_model_check(arch, dev, seed=0):
    """A smoke-width arch in float32 on ``dev`` against the CPU with the
    same weights (drawn on the CPU, carried by ``models.convert``):
    forward logits and a teacher-forced decode of every position, relative
    max error each. The caller holds them below ``MODEL_SMOKE_RTOL``."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.models.convert import params_from_numpy, params_to_numpy
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              dtype=torch.float32)
    cpu = torch.device("cpu")
    p_cpu = M.init_params(cfg, torch.Generator().manual_seed(seed), cpu)
    p_dev = params_from_numpy(cfg, params_to_numpy(p_cpu), dev)
    rng = np.random.default_rng(seed)
    batch = _model_inputs(cfg, rng, 2, 16)
    key = "embeds" if cfg.family == "audio" else "tokens"
    steps = {key: batch[key]} if cfg.family != "vlm" else \
        {key: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16))
                               .astype(np.int32))}
    out = {"arch": arch}
    with torch.inference_mode():
        want, _ = M.forward(p_cpu, cfg, batch)
        got, _ = M.forward(p_dev, cfg, {k: v.to(dev) for k, v in batch.items()})
    out["forward_rel"] = rel_err(got, want)
    out["decode_rel"] = rel_err(
        teacher_forced(p_dev, cfg, {key: steps[key].to(dev)}, dev),
        teacher_forced(p_cpu, cfg, steps, cpu))
    return out


def model_phase(dev, seed, card):
    """The LLM serving path: ``MODEL_FULL`` at full width, bf16, then every
    smoke arch in float32 on the card against the CPU."""
    from repro_torch import configs
    t0 = time.perf_counter()
    full = [model_full(arch, dev, seed, card) for arch in MODEL_FULL]
    smoke = []
    for arch in configs.ARCHS:
        rec = smoke_model_check(arch, dev, seed)
        smoke.append(rec)
        if not max(rec["forward_rel"], rec["decode_rel"]) < MODEL_SMOKE_RTOL:
            raise AssertionError(f"{arch} smoke: card against CPU {rec}")
    print(json.dumps({"model_smoke_card_vs_cpu": smoke,
                      "rtol": MODEL_SMOKE_RTOL, "card": card,
                      "model_phase_s": time.perf_counter() - t0}),
          flush=True)
    return full


# ---------------------------------------------------------------------------
# Training phase: the engine-backed data path and the train step
# ---------------------------------------------------------------------------


def train_data_path(dev, seed, vocab_size):
    """``repro_torch.data`` on the card: a synthetic corpus of
    ``TRAIN_DOCS`` documents (RLE metadata, Plain tokens), a selection by
    quality, domain, language and a whitelist of every other document
    (``bucketize_kernel`` under the semi-join and the RLE mask merges) and
    ``corpus_stats`` (``segment_sum_kernel``). Launch counts are zeroed
    just before the pipeline and read just after it and the stats, before
    the check's oracle (the metadata columns decoded on the card, which
    launches ``rle_decode_kernel``) runs. The same pipeline on the CPU
    must give the same positions, token stream and first batch, and the
    same stats (means within rtol 1e-4). Returns (pipeline, record,
    launches)."""
    import torch
    from repro_torch.core.encodings import decode_rle_values
    from repro_torch.data import (CorpusConfig, DataPipeline,
                                  PipelineConfig, build_synthetic_corpus,
                                  corpus_stats)
    from repro_torch.kernels import _build
    ccfg = CorpusConfig(n_docs=TRAIN_DOCS, mean_doc_len=TRAIN_DOC_LEN,
                        vocab_size=vocab_size, seed=seed)
    pcfg = PipelineConfig(seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH,
                          min_quality=40, domains=list(range(8)),
                          langs=[0, 1, 2, 3],
                          doc_whitelist=np.arange(0, TRAIN_DOCS, 2))
    t0 = time.perf_counter()
    fact, _ = build_synthetic_corpus(ccfg, dev)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    _build.reset_launches()
    t0 = time.perf_counter()
    pipe = DataPipeline(fact, pcfg)
    stats = corpus_stats(fact)
    torch.cuda.synchronize()
    select_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(_build.LAUNCHES)
    meta = {k: decode_rle_values(fact.column(k))[:fact.nrows]
            for k in ("quality", "domain", "lang", "doc_id")}

    def member(x, keys):
        return torch.isin(x, torch.as_tensor(np.asarray(keys, np.int32),
                                             device=dev))

    oracle = ((meta["quality"] >= pcfg.min_quality)
              & member(meta["domain"], pcfg.domains)
              & member(meta["lang"], pcfg.langs)
              & member(meta["doc_id"], pcfg.doc_whitelist))
    if not np.array_equal(np.flatnonzero(oracle.cpu().numpy()),
                          pipe.selected_positions):
        raise AssertionError("training data: selection != decoded oracle")
    missing = [k for k in TRAIN_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the training data "
                             f"path: {missing}")
    first = next(pipe)
    cpu_fact, _ = build_synthetic_corpus(ccfg, "cpu")
    cpu_pipe = DataPipeline(cpu_fact, pcfg)
    cpu_stats = corpus_stats(cpu_fact)
    cpu_first = next(cpu_pipe)
    if not (np.array_equal(pipe.selected_positions,
                           cpu_pipe.selected_positions)
            and np.array_equal(pipe.stream, cpu_pipe.stream)
            and all(torch.equal(first[k].cpu(), cpu_first[k])
                    for k in ("tokens", "labels"))):
        raise AssertionError("training data: card and CPU selections differ")
    for k in ("domain", "tokens"):
        if not np.array_equal(stats[k], cpu_stats[k]):
            raise AssertionError(f"training data: corpus_stats[{k}] differs")
    if not np.allclose(stats["mean_quality"], cpu_stats["mean_quality"],
                       rtol=1e-4, atol=0):
        raise AssertionError("training data: mean quality differs")
    pipe.seek(0)
    rec = {"tokens": fact.nrows, "docs": TRAIN_DOCS,
           "encoded_MiB": fact.nbytes() / 2**20,
           "plain_MiB": 5 * 4 * fact.nrows / 2**20, "ingest_s": ingest_s,
           "selection_and_stats_ms": select_ms,
           "selected_tokens": int(len(pipe.selected_positions)),
           "windows": pipe.n_windows, "domains": len(stats["domain"]),
           "launches": {k: launches[k] for k in TRAIN_KERNELS}}
    return pipe, rec, launches


def _tensor_bits(t):
    """A tensor's bits as an integer tensor of its width (exact compare)."""
    import torch
    width = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.detach().contiguous().view(width[t.element_size()])


def train_phase(dev, seed, card):
    """The training path: the data path (``train_data_path``), then
    ``TRAIN_ARCH`` at full width in bf16 with float32 AdamW moments,
    ``TRAIN_STEPS`` steps of ``make_train_step`` (``grad_accum``
    ``TRAIN_ACCUM``) on the pipeline's first batch, repeated: every loss
    finite and the last below the first (``tests/test_train_data.py``'s
    ``trained``). One more step runs under ``torch.profiler``. Then a
    blocking checkpoint of the whole ``TrainState`` (under the checkout's
    ignored ``build/``), restored on the card and compared bit for bit.
    Prints one JSON line; returns (record, the data path's launches)."""
    import dataclasses
    import shutil
    import torch
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.train import (AdamWConfig, CheckpointManager,
                                   TrainConfig, make_train_step, pytree)
    from repro_torch.train.step import init_train_state
    cfg = configs.get_config(TRAIN_ARCH)
    t0 = time.perf_counter()
    pipe, data_rec, launches = train_data_path(dev, seed, cfg.vocab_size)
    batch = next(pipe)
    tcfg = TrainConfig(adamw=AdamWConfig(lr=1e-3, warmup_steps=2,
                                         total_steps=60),
                       grad_accum=TRAIN_ACCUM)
    state = init_train_state(
        cfg, tcfg, torch.Generator(device=dev).manual_seed(seed), dev)
    step = make_train_step(cfg, tcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t1 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))  # waits for the step
        step_ms.append((time.perf_counter() - t1) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"{TRAIN_ARCH}: loss did not fall: {losses}")
    _, prof = profile_call(lambda: step(state, batch))
    ckdir = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    ck = CheckpointManager(str(ckdir), keep=1)
    t1 = time.perf_counter()
    ck.save(int(state.step), state, blocking=True,
            extra={"data_cursor": pipe.cursor()})
    save_s = time.perf_counter() - t1
    like = dataclasses.replace(
        pytree.map_tree(lambda t: torch.empty_like(t, device="meta"), state),
        params=M.init_params(cfg, device="meta").requires_grad_(True))
    t1 = time.perf_counter()
    restored, meta = ck.restore(like, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t1
    ckpt_bytes = sum(f.stat().st_size for f in ckdir.rglob("*")
                     if f.is_file())
    got, want = pytree.named_leaves(restored), pytree.named_leaves(state)
    if [n for n, _ in got] != [n for n, _ in want] or not all(
            a.dtype == b.dtype and a.device == b.device
            and torch.equal(_tensor_bits(a), _tensor_bits(b))
            for (_, a), (_, b) in zip(got, want)):
        raise AssertionError("training checkpoint: restore is not bit-exact")
    if meta["extra"]["data_cursor"] != pipe.cursor():
        raise AssertionError("training checkpoint: data cursor lost")
    shutil.rmtree(ckdir, ignore_errors=True)
    del restored
    last5 = statistics.median(step_ms[-5:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    rec = {"train": {
        "model": cfg.name, "dtype": "bfloat16", "moments": "float32",
        "params": M.param_count(state.params), "batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "grad_accum": TRAIN_ACCUM, "steps": TRAIN_STEPS,
        "losses": losses, "step_ms": step_ms, "step_ms_median_last5": last5,
        "tok_s": tokens / (last5 / 1e3),
        "max_memory_allocated_MiB": peak / 2**20,
        "step_profile": prof,
        "checkpoint": {"bytes": ckpt_bytes, "leaves": len(want),
                       "save_s": save_s, "restore_s": restore_s,
                       "bit_exact": True},
        "data": data_rec, "phase_s": time.perf_counter() - t0},
        "card": card}
    print(json.dumps(rec), flush=True)
    del state, step
    torch.cuda.empty_cache()
    return rec["train"], launches


# ---------------------------------------------------------------------------
# Mesh phase: the sharding and dry-run layer on the card
# ---------------------------------------------------------------------------


def distinct_leaf(shape, dtype, dev, seed):
    """A leaf whose magnitudes are all distinct, signs random
    (``torch.topk`` leaves the order of ties unspecified). float32: a
    permutation of 1..n times 2^-20; bfloat16: n consecutive positive bit
    patterns from 0x3000 (n below 0x4F80)."""
    import torch
    n = int(np.prod(shape))
    gen = torch.Generator().manual_seed(seed)
    if dtype == torch.bfloat16:
        mag = torch.arange(0x3000, 0x3000 + n, dtype=torch.int16).view(
            torch.bfloat16)
        mag = mag[torch.randperm(n, generator=gen)]
    else:
        mag = (torch.randperm(n, generator=gen) + 1).float() * 2.0 ** -20
    sign = torch.randint(0, 2, (n,), generator=gen).to(dtype) * 2 - 1
    return (mag * sign).reshape(shape).to(dev)


_DRYRUN = []  # (cell, child process, its record's path, its log's path)
# how long the mesh phase waits for the dry-run children, all told
DRYRUN_WAIT_S = 600


def start_dryrun_cells():
    """Start one child process a cell of ``MESH_CELLS``, ``python -m
    repro_torch.launch.dryrun --arch A --shape S --mesh M --out DIR``, on
    the CPU (no card visible, one thread each): the traces are host work
    that waits on nothing else, so they run beside the phases that use
    the card. Once a run; stopped at exit if still running."""
    import repro_torch
    if _DRYRUN:
        return
    out = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    path = [str(Path(repro_torch.__file__).resolve().parent.parent)]
    if os.environ.get("PYTHONPATH"):
        path.append(os.environ["PYTHONPATH"])
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(path))
    for arch, shape, mesh_name in MESH_CELLS:
        log = out / f"{arch}_{shape}_{mesh_name}.log"
        with open(log, "w") as f:
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--mesh", mesh_name, "--out",
                 str(out)], env=env, stdout=f, stderr=subprocess.STDOUT)
        _DRYRUN.append(((arch, shape, mesh_name), proc,
                        out / f"{arch}_{shape}_{mesh_name}.json", log))
    atexit.register(stop_dryrun_cells)


def stop_dryrun_cells():
    """Kill every dry-run child still running and remove their files."""
    for _, proc, path, _ in _DRYRUN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if _DRYRUN:
        shutil.rmtree(_DRYRUN[0][2].parent, ignore_errors=True)
    _DRYRUN.clear()


def join_dryrun_cells():
    """The records of ``MESH_CELLS`` from their children, in order, each
    with its child's wall s; a child that fails, or does not end within
    ``DRYRUN_WAIT_S`` of the call, fails the run."""
    t0 = time.perf_counter()
    try:
        recs = []
        for (arch, shape, mesh_name), proc, path, log in _DRYRUN:
            left = DRYRUN_WAIT_S - (time.perf_counter() - t0)
            try:
                rc = proc.wait(timeout=max(left, 1))
            except subprocess.TimeoutExpired:
                rc = None
            if rc != 0 or not path.exists():
                tail = log.read_text()[-3000:] if log.exists() else ""
                raise AssertionError(f"dry run {arch} x {shape} x "
                                     f"{mesh_name}: exit {rc}: {tail}")
            recs.append(json.loads(path.read_text()))
        return recs, time.perf_counter() - t0
    finally:
        stop_dryrun_cells()


def cell_fields(rec):
    """A dry-run record without its timings and the card's memory."""
    if isinstance(rec, dict):
        return {k: cell_fields(v) for k, v in rec.items()
                if k not in CELL_UNFROZEN}
    return rec


def mesh_moe_check(mesh, cfg, dev, seed, batch, seq):
    """(a) ``cfg``'s MoE layer (random bf16 weights and input from
    ``seed``) through the expert-parallel body (``moe_on_mesh(...,
    ep=True)``: the FSDP all-gather and both all-to-alls over ``mesh``'s
    groups) against the local ``moe`` on the same card: the slots must be
    equal, y within ``MESH_EP_BOUND`` of its largest value; ms a call of
    each, taken in turns."""
    import torch
    from repro_torch.launch.mesh import activate_mesh, axis_group
    from repro_torch.models import layers as L
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = L.init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.dtype,
                   dev, n_padded=cfg.padded_experts)
    x = torch.randn(batch, seq, cfg.d_model, generator=gen,
                    device=dev).to(cfg.dtype)
    e_pad = p["w_gate"].shape[0]
    sm = L.moe_on_mesh(mesh, True, cfg.top_k, cfg.capacity_factor, e_pad,
                       ("data",), "model")
    args = (x, p["router"], p["w_gate"], p["w_up"], p["w_down"])

    def ep():
        with activate_mesh(mesh):
            return sm(*args)

    def local():
        return L._moe(p, x, cfg.top_k, cfg.capacity_factor)

    with torch.inference_mode():
        y, slot, stats = ep()
        y1, aux1, slot1 = local()
        aux = L._aux_from_stats(stats, batch * seq, cfg.top_k)
        if not torch.equal(slot, slot1):
            raise AssertionError(f"{cfg.name} EP body: slots differ")
        err = float((y.float() - y1.float()).abs().max())
        top = float(y1.float().abs().max())
        if not (torch.isfinite(y).all() and err <= MESH_EP_BOUND * top):
            raise AssertionError(f"{cfg.name} EP body: y off by {err} "
                                 f"(largest {top})")
        ep_ms, local_ms = time_turns_ms(ep, local, iters=10)
        with activate_mesh(mesh):
            backends = {a: dist_backend(axis_group(a))
                        for a in ("data", "model")}
    weights = sum(p[k].numel() * p[k].element_size()
                  for k in ("w_gate", "w_up", "w_down"))
    capacity = max(1, int(seq * cfg.top_k * cfg.capacity_factor
                          / cfg.n_experts))
    return {"arch": cfg.name, "d_model": cfg.d_model, "experts": e_pad,
            "d_ff": cfg.d_ff, "top_k": cfg.top_k, "batch": batch,
            "seq": seq, "dtype": str(cfg.dtype).replace("torch.", ""),
            "expert_weight_bytes": weights, "capacity": capacity,
            "kept": int((slot < e_pad * capacity).sum()),
            "entries": int(slot.numel()),
            "slots_equal": True, "y_bit_equal": bool(torch.equal(y, y1)),
            "y_max_abs_err": err, "y_max_abs": top,
            "aux": float(aux), "aux_local": float(aux1),
            "group_backends": backends, "ep_ms": ep_ms,
            "local_ms": local_ms}


def dist_backend(group) -> str:
    import torch.distributed as dist
    return str(dist.get_backend(group))


def mesh_model_check(mesh, cfg, dev, seed, batch, prompt, gen_len, arch):
    """(b) ``cfg`` (random weights from ``seed``) on DTensors: params laid
    out by ``named_shardings``, the batch by ``batch_shardings``, a cache
    by ``cache_shardings``, with ``arch``'s axes of ``MESH_DT``; its
    forward on ``MESH_DT``'s tokens a sequence against the plain forward
    on the card (relative max error at most ``MESH_DT_BOUND``) and a
    greedy ``decode_step`` loop (``prompt`` teacher-forced tokens,
    ``gen_len`` greedy ones) that must give the plain loop's ids, every
    step's logits within the same bound. Wall s of each, first call and
    warm. Under ``no_grad`` (a DTensor's views cannot be made in inference
    mode)."""
    import dataclasses
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch.distributed import sharding as Sh
    from repro_torch.launch.mesh import activate_mesh, placements
    from repro_torch.models import model as M
    from repro_torch.train import pytree
    axes, fwd_len, leaf_path = MESH_DT[arch]
    params = M.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    mcfg = dataclasses.replace(cfg, **axes)
    t0 = time.perf_counter()
    dp = Sh.distribute(params, Sh.named_shardings(params, mesh))
    torch.cuda.synchronize()
    distribute_s = time.perf_counter() - t0
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, max(prompt, fwd_len))).astype(
            np.int32)).to(dev)

    def laid(t, spec):
        return distribute_tensor(t, mesh, placements(spec, mesh))

    dtok = laid(tokens[:, :fwd_len], Sh.batch_spec(mesh, batch))

    def timed(fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def fwd_mesh():
        with activate_mesh(mesh), torch.no_grad():
            return M.forward(dp, mcfg, {"tokens": dtok})[0]

    def fwd_plain():
        with torch.no_grad():
            return M.forward(params, cfg, {"tokens": tokens[:, :fwd_len]})[0]

    got, mesh_first = timed(fwd_mesh)
    got, mesh_warm = timed(fwd_mesh)
    want, plain_first = timed(fwd_plain)
    want, plain_warm = timed(fwd_plain)
    if not isinstance(got, DTensor):
        raise AssertionError(f"{cfg.name}: the mesh forward gave no DTensor")
    rel = rel_err(got.full_tensor(), want)
    if not rel <= MESH_DT_BOUND:
        raise AssertionError(f"{cfg.name}: DTensor forward rel err {rel}")

    def greedy(p, c, on_mesh):
        cache = M.init_cache(c, batch, prompt + gen_len, dev)
        if on_mesh:
            cache = pytree.map_tree(laid, cache, Sh.cache_shardings(
                cache, mesh, batch))
        ids, logits = [], []
        with activate_mesh(mesh if on_mesh else None), \
                torch.no_grad():
            nxt = tokens[:, :1]
            for i in range(prompt + gen_len - 1):
                step = tokens[:, i:i + 1] if i < prompt else nxt
                lg, _ = M.decode_step(p, c, cache, {"tokens": step}, i)
                if isinstance(lg, DTensor):
                    lg = lg.full_tensor()
                logits.append(lg[:, -1])
                nxt = lg[:, -1].float().argmax(-1, keepdim=True).to(
                    torch.int32)
                if i >= prompt - 1:
                    ids.append(nxt)
        return torch.cat(ids, dim=1).cpu(), torch.stack(logits, dim=1)

    (ids, lg), mesh_decode = timed(lambda: greedy(dp, mcfg, True))
    (ids1, lg1), plain_decode = timed(lambda: greedy(params, cfg, False))
    decode_rel = rel_err(lg, lg1)
    if not (torch.equal(ids, ids1) and decode_rel <= MESH_DT_BOUND):
        raise AssertionError(f"{cfg.name}: DTensor greedy ids {ids.tolist()}"
                             f" (decode logits rel err {decode_rel}) != "
                             f"plain {ids1.tolist()}")
    leaf, dleaf = params, dp
    for k in leaf_path:
        leaf, dleaf = leaf[k], dleaf[k]
    return {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
            "batch": batch, "forward_tokens": fwd_len, "prompt": prompt,
            "gen": gen_len,
            "axes": {k: list(v) if isinstance(v, tuple) else v
                     for k, v in axes.items()},
            "leaf": "/".join(leaf_path),
            "leaf_placements": [str(q) for q in dleaf.placements],
            "weight_bytes": sum(q.numel() * q.element_size()
                                for q in params.parameters()),
            "distribute_s": distribute_s,
            "forward_s": {"dtensor_first": mesh_first,
                          "dtensor_warm": mesh_warm,
                          "plain_first": plain_first,
                          "plain_warm": plain_warm},
            "logits_rel_err": rel, "bound": MESH_DT_BOUND,
            "decode_s": {"dtensor": mesh_decode, "plain": plain_decode},
            "decode_steps": prompt + gen_len - 1,
            "decode_logits_rel_err": decode_rel, "greedy_ids_equal": True, "greedy_ids_first_seq":
                ids[0].tolist(), "leaf_dtype": str(leaf.dtype)}


def mesh_phase(dev, seed, card):
    """``launch.mesh``, ``distributed.sharding``, ``allreduce_topk``, the
    elastic restore, the model's mesh dataflow and ``launch.dryrun`` on
    the card: a (1, 1) mesh of a world of one on NCCL (on the card: no
    gloo, no CPU; gloo only where ``dev`` is the CPU, for a rehearsal),
    ``MESH_ARCH``'s smoke params laid out by ``named_shardings`` as
    DTensors and gathered back bit for bit, ``allreduce_topk`` over the
    mesh's data group equal to the plain single-device form
    (``compression._topk_project``) on a float32 and a bfloat16 leaf, a
    checkpoint restored onto the mesh bit for bit, ``mesh_moe_check`` (a)
    and ``mesh_model_check`` of each arch of ``MESH_DT`` (b), then the
    dry-run records of ``MESH_CELLS`` on fake worlds of their meshes'
    sizes, joined from their child processes (``start_dryrun_cells``:
    started after the kernel timing, or here), which on the card must
    equal the torch release's ``MESH_CELL_RECORDS`` (c). Prints a JSON
    line for (a), each model of (b), each cell of (c) and the phase."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch import configs
    from repro_torch.distributed import compression as C
    from repro_torch.distributed import sharding as Sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.train import CheckpointManager, pytree
    t0 = time.perf_counter()
    rec = {}
    backend = "nccl" if dev.type == "cuda" else "gloo"
    mesh = make_host_mesh(dev)
    try:
        if dist.get_backend() != backend or mesh.device_type != dev.type:
            raise AssertionError(f"mesh phase: backend "
                                 f"{dist.get_backend()} on "
                                 f"{mesh.device_type}, not {backend} on "
                                 f"{dev.type}")
        rec["mesh"] = {"shape": list(mesh.shape),
                       "dims": list(mesh.mesh_dim_names),
                       "backend": dist.get_backend(),
                       "world": dist.get_world_size(),
                       "setup_s": time.perf_counter() - t0}

        def check_leaves(name, got_tree, want_tree, shardings):
            flat = dict(pytree.named_leaves(shardings,
                                            leaf_types=(Sh.NamedSharding,)))
            got, want = (pytree.named_leaves(got_tree),
                         pytree.named_leaves(want_tree))
            if [n for n, _ in got] != [n for n, _ in want]:
                raise AssertionError(f"{name}: leaf names differ")
            for (n, a), (_, b) in zip(got, want):
                if not (isinstance(a, DTensor) and a.device_mesh == mesh
                        and a.device.type == dev.type
                        and tuple(a.placements) == flat[n].placements
                        and torch.equal(_tensor_bits(a.full_tensor()),
                                        _tensor_bits(b))):
                    raise AssertionError(f"{name}: leaf {n} is not the "
                                         f"same bits laid out as its spec")
            return len(got)

        cfg = configs.get_smoke_config(MESH_ARCH)
        params = M.init_params(
            cfg, torch.Generator(device=dev).manual_seed(seed), dev)
        t1 = time.perf_counter()
        shardings = Sh.named_shardings(params, mesh)
        laid = Sh.distribute(params, shardings)
        torch.cuda.synchronize()
        n_leaves = check_leaves("distribute", laid, params, shardings)
        rec["distribute"] = {"arch": MESH_ARCH, "leaves": n_leaves,
                             "s": time.perf_counter() - t1,
                             "bit_exact": True}

        group = mesh.get_group("data")
        rec["allreduce_topk"] = []
        for i, (shape, dtype) in enumerate(((MESH_F32_LEAF, torch.float32),
                                            (MESH_BF16_LEAF,
                                             torch.bfloat16))):
            g = distinct_leaf(shape, dtype, dev, seed + i)
            got = C.allreduce_topk(g, group, MESH_TOPK_FRAC)
            want = C._topk_project(g.float(), MESH_TOPK_FRAC).to(dtype)
            if not (got.dtype == dtype and got.shape == g.shape
                    and torch.equal(_tensor_bits(got), _tensor_bits(want))):
                raise AssertionError(f"allreduce_topk {dtype}: differs from "
                                     f"the single-device projection")
            ms = time_ms(lambda: C.allreduce_topk(g, group, MESH_TOPK_FRAC))
            rec["allreduce_topk"].append({
                "dtype": str(dtype).replace("torch.", ""),
                "shape": list(shape), "frac": MESH_TOPK_FRAC,
                "k": max(1, int(round(g.numel() * MESH_TOPK_FRAC))),
                "ms": ms, "bit_exact": True})

        ckdir = Path(__file__).resolve().parent / "build" / "chip_smoke_mesh"
        shutil.rmtree(ckdir, ignore_errors=True)
        CheckpointManager(str(ckdir)).save(5, params, blocking=True)
        like = M.init_params(cfg, device="meta")
        t1 = time.perf_counter()
        restored, meta = CheckpointManager(str(ckdir)).restore(
            like, shardings=Sh.named_shardings(like, mesh))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
        if meta["step"] != 5:
            raise AssertionError("elastic restore: wrong step")
        check_leaves("elastic restore", restored, params,
                     Sh.named_shardings(like, mesh))
        shutil.rmtree(ckdir, ignore_errors=True)
        rec["elastic_restore"] = {"leaves": n_leaves, "s": restore_s,
                                  "bit_exact": True}
        del params, laid, restored
        rec["ep_body"] = mesh_moe_check(
            mesh, configs.get_config(MESH_EP_ARCH), dev, seed,
            MESH_EP_BATCH, MESH_EP_SEQ)
        print(json.dumps({"mesh_ep_body": rec["ep_body"], "card": card}),
              flush=True)
        torch.cuda.empty_cache()
        rec["dtensor_model"] = []
        for arch in MESH_DT:
            rec["dtensor_model"].append(mesh_model_check(
                mesh, configs.get_config(arch), dev, seed, MODEL_BATCH,
                MESH_DT_PROMPT, MESH_DT_GEN, arch))
            print(json.dumps({"mesh_dtensor_model":
                              rec["dtensor_model"][-1], "card": card}),
                  flush=True)
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    cells = []
    release = torch.__version__.split("+")[0]
    if dev.type == "cuda" and release not in MESH_CELL_RECORDS:
        raise AssertionError(f"no dry-run records for torch {release}")
    start_dryrun_cells()  # where the run started with this phase
    records, rec["dryrun_wait_s"] = join_dryrun_cells()
    for (arch, shape, mesh_name), cell, want, ref in zip(
            MESH_CELLS, records,
            MESH_CELL_RECORDS.get(release, (None,) * len(MESH_CELLS)),
            MESH_CELL_REFERENCE):
        name = f"dry run {arch} x {shape} x {mesh_name}"
        if cell["status"] != "ok":
            raise AssertionError(f"{name}: {cell}")
        got = {"flops_per_device": cell["cost"]["flops_per_device"],
               "peak_estimate_bytes":
                   cell["memory"]["peak_estimate_bytes"]}
        cell["reference"] = {k: {"port": got[k], "reference": ref[k],
                                 "ratio": got[k] / ref[k],
                                 "bound": MESH_CELL_BOUNDS[k]}
                             for k in ref}
        for k, r in cell["reference"].items():
            lo, hi = r["bound"]
            # on the CPU (a rehearsal on smoke configs) printed, not held
            if dev.type == "cuda" and not lo <= r["ratio"] <= hi:
                raise AssertionError(f"{name}: {k} {r['ratio']:.3f}x the "
                                     f"reference's, outside {lo}-{hi}x")
        if configs.get_config(arch).n_experts and \
                cell["collectives"]["count_by_type"]["all-to-all"] == 0:
            raise AssertionError(f"{name}: no all-to-all on the MoE cell")
        fields = cell_fields({k: v for k, v in cell.items()
                              if k != "reference"})
        cell["equal_to_record"] = fields == want
        if dev.type == "cuda" and not cell["equal_to_record"]:
            raise AssertionError(f"{name} differs from torch {release}'s "
                                 f"record: {fields}")
        print(json.dumps({"dryrun": cell, "card": card}), flush=True)
        cells.append(cell)
    rec["dryrun_trace_s"] = [c["trace_s"] for c in cells]
    rec["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"mesh_phase": rec, "card": card}), flush=True)
    return rec, cells


# ---------------------------------------------------------------------------
# Examples phase: the five twins of examples/ at their reference sizes
# ---------------------------------------------------------------------------


def examples_phase(card):
    """Each twin in ``examples/`` (``EXAMPLES``) at its reference size on
    the card, in this process: its output echoed, its last line of OK
    required, its wall time and kernel launches (zeroed just before it,
    read just after) on one JSON line. The run fails if a kernel of
    ``EXAMPLE_KERNELS`` was launched by none of them. Returns (records,
    the launches summed over the twins)."""
    import contextlib
    import importlib.util
    import io
    import torch
    from repro_torch.kernels import _build
    root = Path(__file__).resolve().parent / "examples"
    total = {k: 0 for k in _build.KERNELS}
    recs = []
    for name, ok_line in EXAMPLES.items():
        spec = importlib.util.spec_from_file_location(
            name, root / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        buf = io.StringIO()
        _build.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            mod.main([])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        text = buf.getvalue()
        print(text, end="", flush=True)
        if ok_line not in text.splitlines():
            raise AssertionError(f"{name}: no {ok_line!r} line")
        for k, v in launches.items():
            total[k] += v
        rec = {"example": name, "wall_s": wall,
               "launches": {k: v for k, v in launches.items() if v}}
        recs.append(rec)
        print(json.dumps({**rec, "card": card}), flush=True)
    missing = [k for k in EXAMPLE_KERNELS if total[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched by the examples: "
                             f"{missing}")
    return recs, total


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--sf", type=float, default=10.0,
                        help="TPC-H scale factor of the query phase")
    parser.add_argument("--runs", type=int, default=4,
                        help="runs of each resident query (first cold, rest "
                        "warm)")
    parser.add_argument("--seed", type=int, default=7,
                        help="seed of the out-of-core phase's fault plan")
    parser.add_argument("--profile", type=Path, default=None,
                        help="directory for a torch.profiler table of one "
                        "more warm run of each query, resident and streamed "
                        "(its launches are not counted in launches_per_run)")
    parser.add_argument("--queries", default=None,
                        help="comma-separated subset of Q1,Q3,Q6,Q17,Q19: "
                        "run only those, resident and streamed (with "
                        "--profile: their profiles), and stop")
    parser.add_argument("--ordering", action="store_true",
                        help="only run the ordering phase (R1, R2, Q3r "
                        "resident and streamed, on the query and "
                        "out-of-core phases' Q1, Q6 and Q3 tables), print "
                        "its streamed latencies and transfers, and stop")
    parser.add_argument("--kernel-bench", action="store_true",
                        help="only time every kernel at the main path's "
                        "shapes on seeded inputs, and stop")
    parser.add_argument("--models", action="store_true",
                        help="only run the model phase (the LLM serving "
                        "path, full width and smoke archs), and stop")
    parser.add_argument("--train", action="store_true",
                        help="only run the training phase (the engine-backed "
                        "data path and full-width train steps), and stop")
    parser.add_argument("--mesh", action="store_true",
                        help="only run the mesh phase (sharding, the "
                        "compressed all-reduce, the elastic restore and a "
                        "dry-run cell on NCCL), and stop")
    parser.add_argument("--examples", action="store_true",
                        help="only run the examples phase (the five twins "
                        "of examples/ at their reference sizes), and stop")
    parser.add_argument("--src", type=Path, default=None,
                        help="import repro_torch from this src directory "
                        "(another checkout's: its kernels build there)")
    args = parser.parse_args(argv)
    if args.src is not None:
        sys.path.insert(0, str(args.src.resolve()))

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({_build.BUILD_INFO['dir']})", flush=True)
    for src, log in sorted(_build.BUILD_INFO.get("logs", {}).items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}", flush=True)

    import repro_torch
    print(f"repro_torch from {Path(repro_torch.__file__).parent}", flush=True)
    if args.kernel_bench:
        kernel_bench(dev)
        print(card, flush=True)
        return 0
    if args.models:
        model_phase(dev, args.seed, card)
        print(card, flush=True)
        return 0
    if args.train:
        train_phase(dev, args.seed, card)
        print(card, flush=True)
        return 0
    if args.mesh:
        mesh_phase(dev, args.seed, card)
        print(card, flush=True)
        return 0
    if args.examples:
        examples_phase(card)
        print(card, flush=True)
        return 0
    if args.ordering:
        names = tuple(RANKED_SOURCE.values())
        _build.capture(True)  # the ordering phase reads topk's inputs
        _, shared = query_phase(args.sf, dev, args.runs, None, names)
        outofcore_phase(dev, shared, pinned_h2d_gbps(dev), args.seed, None,
                        names)
        ranked = ordering_phase(dev, shared, args.runs)
        print(json.dumps({"card": card, "ordering": {
            k: {"warm_ms_depth0": v["warm_ms_depth0"],
                "warm_ms_depth2": v["warm_ms_depth2"],
                "bytes_moved": v["bytes_moved"],
                **{s: v["stats_depth2"][s] for s in (
                    "executed", "ranked_skipped", "prefetch_wasted",
                    "transferred", "h2d_ms")}}
            for k, v in ranked.items()}}), flush=True)
        print(card, flush=True)
        return 0
    if args.queries:
        names = tuple(args.queries.split(","))
        per_query, shared = query_phase(args.sf, dev, args.runs, args.profile,
                                        names)
        outofcore_phase(dev, shared, pinned_h2d_gbps(dev), args.seed,
                        args.profile, names)
        print(card, flush=True)
        return 0

    cases = (kernel_edge_cases(dev) + count_kernel_edge_cases(dev)
             + segsum_edge_cases(dev) + packed_edge_cases(dev)
             + topk_edge_cases(dev))
    print(f"kernel checks: {cases} edge cases agree with the plain versions",
          flush=True)

    _build.capture(True)
    _build.reset_launches()
    per_query, shared = query_phase(args.sf, dev, args.runs, args.profile)
    resident = dict(_build.LAUNCHES)
    shapes = {"resident": {k: dict(v) for k, v in _build.SHAPES.items()}}
    missing = [k for k in RESIDENT_KERNELS if resident[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the resident path: "
                             f"{missing}")
    h2d_gbps = pinned_h2d_gbps(dev)
    print(f"pinned H2D: {h2d_gbps:.2f} GB/s (one 1 GiB copy, median of 5)",
          flush=True)
    _build.reset_launches()
    ooc = outofcore_phase(dev, shared, h2d_gbps, args.seed, args.profile)
    streamed = dict(_build.LAUNCHES)
    shapes["out_of_core"] = {k: dict(v) for k, v in _build.SHAPES.items()}
    missing = [k for k in PACKED_KERNELS if streamed[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the out-of-core "
                             f"path: {missing}")
    _build.reset_launches()
    ranked = ordering_phase(dev, shared, args.runs, args.profile)
    ordering = dict(_build.LAUNCHES)
    shapes["ordering"] = {k: dict(v) for k, v in _build.SHAPES.items()}
    missing = [k for k in ORDER_KERNELS if ordering[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the ordering path: "
                             f"{missing}")
    served = serving_phase(dev, shared, args.seed, card)
    serving = dict(_build.LAUNCHES)
    shapes["serving"] = {k: dict(v) for k, v in _build.SHAPES.items()}
    missing = [k for k in SERVE_KERNELS if serving[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the served path: "
                             f"{missing}")
    print(json.dumps({"launches": {"resident": resident,
                                   "out_of_core": streamed,
                                   "ordering": ordering,
                                   "serving": serving},
                      "launch_shapes": shapes}), flush=True)
    launches = {k: resident[k] + streamed[k] + ordering[k] + serving[k]
                for k in _build.KERNELS}
    # the inputs the main path gave each kernel; no capture while timing
    largest = dict(_build.LARGEST)
    _build.capture(False)
    rows = kernel_timing(launches, largest, shared["part_keys"])
    start_dryrun_cells()  # host work beside the phases that use the card
    # the query phases' tables and captured inputs go before the models
    del largest
    shared.clear()
    _build.LARGEST.clear()
    torch.cuda.empty_cache()
    models = model_phase(dev, args.seed, card)
    trained, train_launches = train_phase(dev, args.seed, card)
    meshed, cells = mesh_phase(dev, args.seed, card)
    examples, example_launches = examples_phase(card)
    for row in rows:  # the training data path and the examples are paths
        row["launches"] += (train_launches[row["name"]]
                            + example_launches[row["name"]])
    print(json.dumps({"card": card, "queries": {
        k: {"warm_median_ms": v["warm_median_ms"], "ingest_s": v["ingest_s"]}
        for k, v in per_query.items()}, "out_of_core": {
        k: {"warm_ms_depth0": v["warm_ms_depth0"],
            "warm_ms_depth2": v["warm_ms_depth2"],
            "h2d_bound_ms_packed": v["h2d_bound_ms_packed"],
            "bytes_moved_packed": v["bytes_moved_packed"],
            "bytes_moved_unpacked": v["bytes_moved_unpacked"],
            "unpack_launches_per_run": v["unpack_launches_per_run"],
            "max_memory_allocated_MiB_depth2":
                v["max_memory_allocated_MiB_depth2"]}
        for k, v in ooc.items()}, "ordering": {
        k: {"path": v["path"], "warm_median_ms": v["warm_median_ms"],
            "warm_ms_depth0": v["warm_ms_depth0"],
            "warm_ms_depth2": v["warm_ms_depth2"],
            "visited": v["visited"], "ranked_pruned": v["ranked_pruned"]}
        for k, v in ranked.items()}, "serving": {
        r["round"]: {k: r[k] for k in ("qps", "p50_ms", "p99_ms", "mean_ms",
                                       "plan_hits", "lru_hits", "evictions",
                                       "passes", "h2d_bytes")}
        for r in served}, "models": {
        r["model"]: {k: r[k] for k in ("prefill_tok_s", "decode_tok_s",
                                       "max_memory_allocated_MiB",
                                       "decode_vs_forward_rel_err")}
        for r in models}, "training": {
        k: trained[k] for k in ("step_ms_median_last5", "tok_s",
                                "max_memory_allocated_MiB", "losses")},
        "mesh": {"phase_s": meshed["phase_s"],
                 "allreduce_topk_ms": [r["ms"]
                                       for r in meshed["allreduce_topk"]],
                 "dryrun": [{k: c[k] for k in ("arch", "shape", "mesh",
                                               "memory", "fits_hbm")}
                            for c in cells]},
        "examples": {r["example"]: r["wall_s"] for r in examples}}),
        flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
