#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Builds the port's kernels from ``spark_rapids_jni_tpu_torch/csrc`` and drives
its paths, each through the entry points a user calls, with every kernel's
launch count set to 0 just before the path and read just after:

- fixed-width JCUDF row conversion at the reference benchmark's axes: 212
  fixed-width columns (``cycle_dtypes`` of INT64, FLOAT64, INT32, FLOAT32,
  INT16, INT8, BOOL8), 1M and 4M rows, both directions, and once at 10.24M
  rows of random planes, where the kernels' element indices pass 2^31;
- Spark hash partitioning of the decoded 4M rows: ``convert_from_rows_grouped``
  of each batch, then ``hash_partition_ids`` of its INT32 and INT16 columns
  into Spark's default 200 shuffle partitions;
- ``xxhash64`` and ``murmur3_hash`` over 8 INT64 key columns, and over a
  padded string column (lengths 0..64) and an INT64 column, at 4M rows;
  K7 also with the string read in place, K6 also with the string's whole
  tile staged (K7's route) beside the string read in place as its plan
  reads it, and K6 at each tile setting of its sweep over paths 1 to 3;
- the bloom probe ``might_contain_device`` of 4M INT64 rows against Spark's
  runtime-filter defaults: 8,388,608 bits with 1M build keys, the
  67,108,864-bit maximum with 4M build keys, and the 729,856 bits of a
  100,000-item filter, built on the host; each filter also by both of the
  kernel's routes where it fits a block, timed side by side, and the
  routes over a sweep of filter sizes;
- dense-padded string row conversion at the reference's mixed axis (130
  fixed-width columns and 25 STRING columns of lengths 0..32, 1% nulls):
  1M rows (one 1624-byte-row batch, decoded by one K2 launch at that
  stride, and ``compact_rows_host`` of a 100,000-row slice) and 2M rows
  (two batches of 1,000,000 rows);
- the same axis with Arrow-layout strings (``arrow_strings_1m``): 1M rows
  to compact JCUDF rows (one compact encode kernel launch, about 1.2 GB)
  and back (one K2 launch over the gathered fixed sections and one string
  gather kernel launch), a 100,000-row slice's blob against
  ``compact_rows_host`` of its padded encode, murmur3 and xxhash64 of the
  Arrow table against the padded table's, ``get_json_object`` over
  100,000 Arrow event-log documents against the padded column's answer;
  the two compact kernels' tile plans (rows a tile, stage bytes, the share
  of rows on the long-row route, as their launches mark it) and their
  times on every ring of ``ENCODE_RINGS`` and ``GATHER_RINGS`` and with
  every tile sent down the long-row route; and compact rows at edge shapes
  (``compact_edges``: fixed_end of every residue mod 8, lengths 0..67 at
  odd offsets, batches forced by ``size_limit``, zero rows, strings only,
  a 100,000-byte string among short rows), each against the CPU run, and
  33 and 128 string columns of raw kernel arguments;
- the two-stage encode: ``convert_to_rows`` of 6M rows of the 212-column
  schema, whose resident pack passes the 4 GiB cap, in six batches of one
  K3 launch each, every batch equal to K1's rows for the same rows;
- ``get_json_object`` over 1M event-log documents of 100 to 1,000 bytes
  (a 1024-byte window; about 1% each of escaped string values, container
  values, malformed documents and nulls) at ``$.a``, ``$.user.id`` and
  ``$.items[2].sku``, one K9 launch a call, a 100,000-row sample and every
  punted row against Python's ``json``; and over 4M compact documents
  ``{"a":N,"b":"x"}`` at ``$.a``; K9 also on documents whose stepped chars
  sit on its 16-char chunk boundaries (``gjo_quiet_edges``), with the
  share of each timed window's chars it skips (replayed over the plain
  carry) and its time at 64 and 256 threads a block;
- the word-plane engine, ``convert_to_rows``/``convert_from_rows`` with
  ``impl="pallas"`` (``runtime`` and ``ops.plane_rows``): 1M rows of the
  212-column schema in one batch, one pack (K4) and one unpack (K5)
  launch, byte-equal to the default route's batch; 4M rows in four
  batches of one K4 launch each;
- the per-column-block engine ``ops.row_kernels`` (K10 encode, K11 decode)
  at 1M rows of the 212-column schema, with ``bucket=None`` (one launch
  each way, rows byte-equal to K1's) and with the default ``"auto"``
  (padded to 1,048,576 rows), and ``to_rows_fixed_batch`` over the 4M
  table in four batches of one K10 launch each, every batch equal to K1's;
  the generic ``impl="xla"`` engine at 1M rows (no kernel, rows equal to
  K1's); and 1M rows of 56 ``cycle_dtypes`` columns and 8 decimal128
  columns (scales 0, 2, 10, 38, values up to +/-(10^38 - 1), 25% nulls)
  through every fixed-width engine (K1/K2, K4/K5, ``xla``, the gather
  oracle, K10/K11), every blob byte-equal;
- the serving runtime (``serve``): a ``Scheduler()`` on the card and four
  ``Client``s; one tick of 16 ``to_rows`` requests of 212 INT32 columns
  and 33,000 to 65,536 rows (one K4 launch over 16 x 65,536 rows), their
  round trip through ``from_rows`` (one K5 launch), a mixed tick of two
  groups (two K4 launches) and a threaded run of four clients, every
  answer against ``convert_to_rows`` of its own columns (K1), with the
  tick's time split into stacking, staging, kernel, fetch and slicing;
- the query operators (``models.pipeline``, torch ops, no kernel of their
  own): ``bench.py``'s grouped query on each 4M batch (``query_grouped_4m``:
  K2, then K6's partition ids, then ``hash_aggregate_table`` of COUNT(*)
  and SUM by the INT16 column into 256 groups where the id is under 100,
  each batch against the CPU run, the step's time split into decode, hash
  and aggregate, the aggregate also timed by the domain strategy, which
  the default leaves to larger inputs); ``flagship_query_step`` at TPC-DS
  SF10 (28,800,991 store_sales rows against 102,000 items, against a
  float64 numpy oracle, by the default domain strategy and by the sort,
  and timed with one lane a scatter slot);
  the q72/q95 join shapes at 4M probe rows (``joins_4m``: the duplicate,
  semi and left joins over 1M build rows, the table joins with 25% null
  INT32 and STRING keys, each against the CPU run); the aggregate's edges
  card against CPU (``agg_edges``: every fixed-width key type, DATE32 and a
  padded STRING key, three null modes, both strategies forced, capacities,
  an all-dead mask, zero rows, wrapping sums, decimal128 with a null AVG);
  and the serving runtime's ``agg`` and ``join`` ops (``serve_query``: a
  tick of 16 requests each, against the direct calls);
- Spark's casts and the decimal arithmetic (``ops.cast_string``,
  ``ops.decimal``, torch ops, no kernel of their own), each call on the
  card against the port's CPU run of the same input, bit for bit, with
  its CUDA-event time and busy share: ``casts_1m`` (string to INT8..INT64,
  FLOAT32/64, DECIMAL(38, 2) and (38, 18), DATE and TIMESTAMP over
  1,048,576 texts of each made on the card by ``utils.cast_strings``:
  about 10% null, 5% invalid, 1% overflowing and 0.5% past the parse
  windows, which punt to the host; the float casts' numpy conversion timed
  on its own), ``to_string_1m`` (the four integer types, days,
  microseconds and decimal128 at scales 0, 2, 38 and -3, 1,048,576 rows
  each), ``decimal_arith_1m`` (add, sub, mul, rescale by +4 and -4, div
  over 1,048,576 rows, about 1% overflowing) and ``cast_edges``
  (``utils.CAST_EDGE_STRINGS`` through every cast, ``ansi=True`` raising
  the same message on both sides, and the edge values of every type).

Every kernel is held against its plain PyTorch version on the card, bit for
bit, at every one of those shapes (the compact encode and the string
gather, which replace no TPU kernel, among them); then against 64-bit
offsets (a string
column of 24M rows of 96 bytes, a filter of 2^31 + 64 bits) and at edge
shapes, types and null patterns (K3 at odd starts, the padded decode at
string widths 0, 4 and 32, hash chains of 801 and 1600 columns, K9 over
600,000 rows of 4096 bytes, K4 and K5 over 10.24M rows of 856 and 1008
bytes, K10 and K11 at 1 to 1000 rows, odd starts, 910 1-byte columns and
over 10.24M rows of 1008 bytes). Row conversion round trips must give back
their input bit for bit, string lengths and chars included; partition ids
must equal those of the original columns; the bloom probe must equal the
host probe, keep every build key and give False for nulls. Each kernel is
timed, its bound being the larger of the bytes it must move over the card's
memory rate and the arithmetic instructions its work needs over the card's
issue rate; K4 and K5 also beside the one PyTorch call that computes the
same function, a transposing copy (``library_ms``); K10 and K11 also as
bare launches (``kernel_ms``), without their wrappers' host work, and at
three tile sizes.

Each phase prints one JSON line.  Near the end come the card's name and
power limit (``nvidia-smi``) and one ``{"kernels": [...]}`` line; the last
line is ``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero and does not print that line, as it does when no CUDA
card is present or the package is not beside it.  It needs no arguments,
one card and no network; its device memory peaks at about 43 GB (the 10.24M
row phase), which the timing line prints.
"""

import contextlib
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# H100 SXM device memory rate (NVIDIA data sheet): the bytes side of bound_ms
PEAK_BYTES_PER_S = 3.35e12
# Instructions a second the card can issue: 4 warp-instructions a clock on
# each SM (one per scheduler) of 32 threads, on 132 SMs at 1.98 GHz, the
# clock at which the data sheet's 67 TFLOP/s of float32 is 132 SMs x 128
# lanes x 2 flops.  A mixed stream of 32-bit integer instructions (IMAD on
# the FMA pipe beside IADD3, LOP3 and SHF on the ALU pipe) can reach it, so
# it is the instructions side of the hash kernels' bound_ms.
PEAK_INSTR_PER_S = 132 * 4 * 32 * 1.98e9
N_1M = 1_000_000
N_2M = 2_000_000
N_4M = 4_000_000
# rows of the two-stage phase: the 212-column table's resident pack passes
# the 4 GiB cap of convert_to_rows
N_6M = 6_000_000
# rows of the padded batch slice compacted on the host
N_COMPACT = 100_000
# a string longer than any stage of the compact kernels' plans
LONG_STRING = 100_000
# rows of the 64-bit offsets phase: 213 planes of this many words pass 2^31
N_WIDE = 10_240_000
# a padded string column whose chars pass 2^31 bytes
N_WIDE_STRINGS, W_WIDE_STRINGS = 24_000_000, 96
# Spark's spark.sql.shuffle.partitions default
NUM_PARTITIONS = 200
# Spark's runtime bloom filter: (numBits, expectedNumItems) of the default
# filter and of the maximum, spark.sql.optimizer.runtime.bloomFilter.*, and
# of BloomFilter.create(100_000) (a small join side: 729,856 bits, k = 5)
BLOOM_FILTERS = ((8_388_608, 1_000_000), (67_108_864, 4_000_000),
                 (729_856, 100_000))
# filter sizes in long words at which K8's routes are timed beside each
# other (k = 6, the 4M probe rows): a small filter, the 100,000-item one,
# and both sides of the block route's threshold
BLOOM_SWEEP_WORDS = (1_024, 11_404, 16_384, 16_385)
# one L2 sector: what a probe of the bitset in device memory moves
L2_SECTOR_BYTES = 32
TIMED_RUNS = 15
# the card every tensor of the script lies on
CARD = "cuda"

# Arithmetic instructions of the hash kernels' work, counted in the SASS of
# the built kernels (cuobjdump -sass build/torch_kernels/<source>-*.so,
# CUDA 12.8): only the instructions that compute a hash from its input,
# not the loads, the column walk, the branches or the moves, so that the
# count stays under what a kernel issues and bound_ms under its time.
MM3_WORD, MM3_FMIX = 6, 8     # mix one 32-bit word; finalise
MM3_TAIL_BYTE = 8             # extract, sign-extend and mix one tail byte
XX_VALUE = 41                 # one 8-byte block: seed, round, stripe, fmix
XX_CHUNK = 48                 # one 32-byte chunk: four rounds
XX_MERGE = 90                 # set up v1..v4, rotate, sum and merge them
XX_SEED, XX_LEN = 2, 2        # seed + P5 (strings under 32 bytes); + len
XX_STRIPE, XX_WORD = 22, 13   # one 8-byte stripe; the 4-byte block
XX_BYTE, XX_FMIX = 11, 15     # one tail byte; the avalanche
BLOOM_HASHES = 33             # two hashLong of a row
BLOOM_PROBE = 20              # one probe: index, remainder, address, bit
# K9's bound counts the least work the function needs for a char, not the
# step the kernel runs: a char inside a string (most of a document: the
# filler note) needs only a test for the closing quote and one for a
# backslash, a char after the value is found only what keeps `deep` up to
# date, and one SIMD byte compare (__vcmpeq4) tests four chars at once.
# Two instructions for four chars stay under every char's need, so the
# bytes side bounds K9.
GJO_LEAST_OPS_4_CHARS = 2
# Diagnostics, not the bound: instructions of the kernel's own loop,
# counted in the SASS of its 16-byte-chunk instance (cuobjdump -sass
# build/torch_kernels/gjo_scan-*.so, CUDA 12.8), branches and moves
# included.  GJO_STEP is an iteration that runs the whole step on its common
# path (no key byte read, no descent): 300 for the step and 52 for the loop
# itself (the chunk-position test, the quiet tests and the skip, the char
# and its class, the loop's end).  GJO_STEP_FOUND is an iteration that runs
# the step of a found row (59 + 52), GJO_CHUNK_TEST the load of a chunk
# with its SIMD compares.  The kernel steps only the chars that can change
# its carry (get_json.gjo_scan_walk counts them), but a warp issues the
# chunk's instructions in nearly every iteration: some lane is nearly
# always at a chunk boundary.
GJO_STEP = 352
GJO_STEP_FOUND = 111
GJO_CHUNK_TEST = 106

# get_json_object: 1M event-log documents in a 1024-byte window, the three
# paths users ask of them, the rows held against Python's json, Spark's
# compact documents (bench.py:725-731) at 4M rows, and a window whose rows
# pass 2^31 bytes
N_GJO, W_GJO = 1_000_000, 1024
GJO_PATHS = ("$.a", "$.user.id", "$.items[2].sku")
# the edge paths of tests/test_torch_kernels.py: 8 segments, a 254-byte key
GJO_EDGE_PATHS = ("$.p.q[1].r.s[0][1].t", "$." + "k" * 254)
# windows of the chunk-boundary documents (gjo_quiet_edges)
GJO_EDGE_WIDTHS = (1024, 4096)
N_GJO_SAMPLE = 100_000
N_GJO_WIDE, W_GJO_WIDE = 600_000, 4096
# the serve rows op at the reference benchmark's 212 columns (bench.py:2-6,
# 53), all-valid INT32 as the op takes them: 16 requests of 33,000 to
# 65,536 rows fill one group of 16 x 65,536 rows (880-byte rows, about
# 0.9 GB each way, near the 1 GiB batch of convert_to_rows); the mixed
# tick's second group is at most 16,384 rows a request; four client
# threads send 16 requests each of 2,000 to 8,000 rows
SERVE_COLS, SERVE_REQUESTS = 212, 16
SERVE_ROWS, SERVE_SMALL_ROWS = (33_000, 65_536), (9_000, 16_384)
SERVE_THREAD_REQUESTS, SERVE_THREAD_ROWS = 16, (2_000, 8_000)

# the rings (blocks an SM, stages a block) the compact encode's and the
# string gather's plans are timed on at the string axis, beside the
# wrappers' own (kernels.ENCODE_RING, GATHER_RING)
ENCODE_RINGS = ((1, 2), (1, 3), (2, 2), (2, 3))
GATHER_RINGS = ((2, 3), (2, 4), (3, 3), (1, 3))

# the query operators: bench.py's query_grouped capacity; TPC-DS SF10
# store_sales rows and items (q6's flagship step); the q72/q95 join shapes
# (4M probe rows against 1M build rows over 100,000 keys, string keys of
# up to 32 bytes, an output buffer above the about 36M matches); the edge
# sweep's rows, capacity and key types; the serve query requests' rows
QUERY_GROUPS = 256
Q6_ROWS, Q6_ITEMS = 28_800_991, 102_000
JOIN_BUILD, JOIN_KEYS, JOIN_STR_W = 1_000_000, 100_000, 32
JOIN_CAPACITY = 48_000_000
EDGE_ROWS, EDGE_GROUPS = 50_000, 8
EDGE_KEYS = ("int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
             "uint64", "bool8", "date32", "decimal32(scale=2)",
             "decimal64(scale=-1)", "timestamp_us")
SERVE_QUERY_ROWS = (2_000, 8_000)

KERNELS = (  # name, the TPU kernel it replaces
    ("grouped_encode", "spark_rapids_jni_tpu/ops/row_mxu.py:513"),
    ("decode_planes", "spark_rapids_jni_tpu/ops/row_mxu.py:954"),
    ("pack_planes", "spark_rapids_jni_tpu/ops/row_mxu.py:233"),
    ("murmur3_cols", "spark_rapids_jni_tpu/ops/pallas_kernels.py:535"),
    ("xxhash64_cols", "spark_rapids_jni_tpu/ops/pallas_kernels.py:671"),
    ("bloom_might_contain", "spark_rapids_jni_tpu/ops/pallas_kernels.py:830"),
    ("gjo_scan", "spark_rapids_jni_tpu/ops/pallas_kernels.py:742"),
    ("planes_to_rows", "spark_rapids_jni_tpu/ops/pallas_kernels.py:365"),
    ("rows_to_planes", "spark_rapids_jni_tpu/ops/pallas_kernels.py:210"),
    ("to_rows_cols", "spark_rapids_jni_tpu/ops/row_kernels.py:63"),
    ("from_rows_cols", "spark_rapids_jni_tpu/ops/row_kernels.py:149"),
    # no TPU counterpart: the JAX package does this work in XLA
    ("compact_encode", "none (XLA: spark_rapids_jni_tpu/ops/"
                       "row_conversion.py:1164)"),
    ("string_gather", "none (XLA: spark_rapids_jni_tpu/ops/"
                      "row_conversion.py:1419)"),
)


# the script's start on the host clock; each phase line carries its seconds
# since then ("t")
_T0 = []


def emit(**fields):
    if _T0 and "phase" in fields:
        fields["t"] = time.perf_counter() - _T0[0]
    print(json.dumps(fields), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


_L2_FLUSH = []


def median_ms(fn, runs=TIMED_RUNS, warmup=3, flush=False):
    """Median over ``runs`` of one call's device time, each call bracketed
    by its own CUDA events.  With ``flush``, 512 MiB are written before
    each call (outside the events): inputs smaller than the 50 MB L2 are
    read cold too, and the card stays busy while the host queues the call,
    so that the events time the card's work and not the host's."""
    if flush and not _L2_FLUSH:
        _L2_FLUSH.append(torch.empty(512 << 20, dtype=torch.uint8,
                                     device=CARD))
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(runs):
        if flush:
            _L2_FLUSH[0].zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def alternating_ms(fns, rounds=10, runs=10):
    """:func:`median_ms` of each of ``fns`` over ``rounds`` rounds, the
    order reversed every round (A B, B A, ...) so that no side always runs
    first.  Returns each side's median over its rounds and its rounds'
    medians."""
    per = [[] for _ in fns]
    for r in range(rounds):
        order = range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))
        for i in order:
            per[i].append(median_ms(fns[i], runs=runs))
    return [statistics.median(p) for p in per], per


def profile_breakdown(fn, top=8) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its wall time (host
    clock to a synchronize, the profiler's cost included), the summed time
    of the card's kernels, their share of the wall time, and the kernels
    that took most of it, by name."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            slot = by_name.setdefault(e.name, [0.0, 0])
            slot[0] += e.time_range.elapsed_us() / 1e3
            slot[1] += 1
    kernel_ms = sum(v[0] for v in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    # the torch ops that launched them, by the card's time under each
    ops = sorted(((k.key, k.self_device_time_total / 1e3, k.count)
                  for k in prof.key_averages()
                  if k.key.startswith("aten::")
                  and k.self_device_time_total > 0), key=lambda t: -t[1])
    return {"wall_ms": wall_ms, "kernel_ms": kernel_ms,
            "busy_share": kernel_ms / wall_ms,
            "launches": sum(v[1] for v in by_name.values()),
            "top_kernels": [[name[:60], ms, count]
                            for name, (ms, count) in ranked],
            "top_ops": [list(t) for t in ops[:top]]}


_PEAKS = [0]


def reset_peak():
    """Reset the card's peak-memory counter for a phase, keeping the peak
    so far for the script's own (printed with the timing line)."""
    _PEAKS[0] = max(_PEAKS[0], torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()


def copy_ms(nbytes: int) -> float:
    """Device-to-device copy moving ``nbytes`` in all (half read, half
    written): the card's own bandwidth anchor at the kernel's byte count."""
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device=CARD)
    dst = torch.empty_like(src)
    return median_ms(lambda: dst.copy_(src))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest absolute difference of two integer tensors, taken over
    slices of 2^26 elements so that a 10 GB blob needs no full-size
    widened copy."""
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"shapes {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
    a, b = a.reshape(-1), b.reshape(-1)
    worst = 0
    for i in range(0, a.numel(), 1 << 26):
        x = a[i:i + (1 << 26)].to(torch.int64)
        y = b[i:i + (1 << 26)].to(torch.int64)
        # a difference of two int64 hashes can leave int64: compare halves
        if a.dtype == torch.int64:
            x = torch.stack([x >> 32, x & 0xFFFFFFFF])
            y = torch.stack([y >> 32, y & 0xFFFFFFFF])
        worst = max(worst, int((x - y).abs().max()))
    return worst


# ---------------------------------------------------------------------------
# Bounds of the hash kernels: bytes and arithmetic instructions of the work
# these inputs need
# ---------------------------------------------------------------------------

def _valid_count(col) -> int:
    return int(col.valid_bools().sum())


def _col_bytes(col) -> int:
    """Bytes a kernel must read of a column: its values (a string's bytes up
    to each valid row's length and its lengths) and its mask."""
    mask = 0 if col.validity is None else (col.num_rows + 7) // 8
    if col.dtype.is_string:
        lens = col.lens.to(torch.int64)
        return int(lens[col.valid_bools()].sum()) + 4 * col.num_rows + mask
    return col.num_rows * col.dtype.itemsize + mask


def _valid_lens(col) -> torch.Tensor:
    return col.lens.to(torch.int64)[col.valid_bools()]


def _mm3_ops(col) -> int:
    valid = _valid_count(col)
    if col.dtype.is_string:
        lens = _valid_lens(col)
        return (int(((lens // 4) * MM3_WORD
                     + (lens % 4) * MM3_TAIL_BYTE).sum())
                + valid * MM3_FMIX)
    words = 2 if col.dtype.itemsize == 8 else 1
    return valid * (words * MM3_WORD + MM3_FMIX)


def _xx_ops(col) -> int:
    valid = _valid_count(col)
    if not col.dtype.is_string:
        return valid * XX_VALUE
    lens = _valid_lens(col)
    per = (torch.where(lens >= 32, XX_MERGE + (lens // 32) * XX_CHUNK,
                       XX_SEED)
           + XX_LEN + ((lens % 32) // 8) * XX_STRIPE
           + ((lens % 8) >= 4) * XX_WORD + (lens % 4) * XX_BYTE + XX_FMIX)
    return int(per.sum())


def _bloom_ops(col, k: int) -> int:
    return _valid_count(col) * (BLOOM_HASHES + k * BLOOM_PROBE)


def _bound(nbytes: int, instructions: int) -> dict:
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = instructions / PEAK_INSTR_PER_S * 1e3
    return {"bytes": nbytes, "instructions": instructions,
            "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _timed(fn, plain_fn, bound: dict, rows: int) -> dict:
    return {"rows": rows, "ms": median_ms(fn, flush=True),
            "plain_ms": median_ms(plain_fn, runs=5, warmup=1), **bound}


def _plan_record(plan) -> dict:
    return {"tile_rows": plan.tile_rows,
            "rows_per_thread": plan.rows_per_thread,
            "groups": len(plan.groups), "stage_bytes": plan.stage_bytes,
            "staged_columns": sum(s is not None for s in plan.slots)}


def _hash_timings(cols, label: str, out: dict):
    """Time both hash kernels over ``cols`` into ``out`` under ``label``,
    each with the plan it staged by."""
    from spark_rapids_jni_tpu_torch.ops import hash_kernels as hk
    n = cols[0].num_rows
    nbytes = sum(_col_bytes(c) for c in cols)
    out[f"murmur3_cols{label}"] = {
        **_timed(lambda: hk.murmur3_cols(cols, 42),
                 lambda: hk.murmur3_cols_plain(cols, 42),
                 _bound(nbytes + 4 * n, sum(_mm3_ops(c) for c in cols)), n),
        "plan": _plan_record(
            hk._stage_plan(cols, hk._STAGING["murmur3_cols"]))}
    out[f"xxhash64_cols{label}"] = {
        **_timed(lambda: hk.xxhash64_cols(cols, 42),
                 lambda: hk.xxhash64_cols_plain(cols, 42),
                 _bound(nbytes + 8 * n, sum(_xx_ops(c) for c in cols)), n),
        "plan": _plan_record(
            hk._stage_plan(cols, hk._STAGING["xxhash64_cols"]))}


def _hold_staged(name, cols, staging, errs, what, budget=None):
    """Hash kernel ``name`` over ``cols`` by the plan of ``staging`` (and
    ``budget``), held against its plain version; returns a call of it."""
    from spark_rapids_jni_tpu_torch.ops import hash_kernels as hk
    plan = hk._stage_plan(cols, staging, **(
        {} if budget is None else {"budget": budget}))
    dtype = torch.int32 if name == "murmur3_cols" else torch.int64
    out = torch.empty(cols[0].num_rows, dtype=dtype, device=CARD)
    hk._launch_hash(name, cols, 42, out, plan)
    _hold_hash(name, out, cols, 42, errs, what)
    return lambda: hk._launch_hash(name, cols, 42, out, plan)


def _staged_ms(name, cols, staging, errs, what, budget=None) -> float:
    """:func:`_hold_staged`, then the call timed."""
    return median_ms(_hold_staged(name, cols, staging, errs, what, budget),
                     flush=True)


# K6's tile sweep: (rows a tile, rows a consumer thread) for fixed-width
# chains and for chains with a string; the plan keeps one of each as a
# constant (hash_kernels._STAGING).  K6 takes at most 256 rows a tile at
# one row a thread (hash_stage.cuh's kStageOneRowConsumers).
MM3_FIXED_TILES = ((256, 1), (256, 2), (512, 2), (1024, 2))
MM3_STRING_TILES = ((128, 1), (256, 1), (256, 2), (512, 2))


def _mm3_tile_sweep(cols, field, tiles, errs, what) -> dict:
    """K6 over ``cols`` at each of ``tiles`` for its ``field`` of staging
    (``fixed`` or ``strings``), every result held against the plain
    version: {"rows x per_thread": ms}."""
    from spark_rapids_jni_tpu_torch.ops import hash_kernels as hk
    mm3 = hk._STAGING["murmur3_cols"]
    sweep = {}
    for tile in tiles:
        staging = dataclasses.replace(mm3, **{field: tile})
        plan = hk._stage_plan(cols, staging)
        check((plan.tile_rows, plan.rows_per_thread) == tile,
              f"sweep tile {tile} gave plan {plan}")
        sweep[f"{tile[0]}x{tile[1]}"] = _staged_ms(
            "murmur3_cols", cols, staging, errs, f"{what}, tile {tile}")
    return sweep


# ---------------------------------------------------------------------------
# The hash and bloom paths
# ---------------------------------------------------------------------------

def _read_path(kernels, run):
    """Run one path with every launch count set to 0 just before it, and
    return the counts read just after."""
    torch.cuda.synchronize()
    kernels.reset_launches()
    result = run()
    torch.cuda.synchronize()
    return result, dict(kernels.launches)


def _hold_hash(name, got, cols, seed, errs, what):
    """A hash kernel's result ``got`` over ``cols`` against its plain
    version."""
    from spark_rapids_jni_tpu_torch.ops import hash_kernels as hk
    plain = getattr(hk, f"{name}_plain")(cols, seed)
    errs[name] = max(errs[name], max_abs_err(got, plain))
    check(torch.equal(got, plain), f"{name} kernel != plain version: {what}")


def _hold_hashes(cols, seed, errs, what):
    """Both hash kernels against their plain versions over ``cols``."""
    from spark_rapids_jni_tpu_torch.ops import hash_kernels as hk
    for name in ("murmur3_cols", "xxhash64_cols"):
        _hold_hash(name, getattr(hk, name)(cols, seed), cols, seed, errs,
                   what)


def phase_hash_partition(table, batches, dtypes, errs, timing):
    """Path 1: decode each 4M batch to its backing (K2), then Spark's hash
    partition ids of its INT32 column 2 and INT16 column 4 (K6)."""
    from spark_rapids_jni_tpu_torch.ops import (
        DEFAULT_SEED, convert_from_rows_grouped, hash_partition_ids, pmod,
    )
    from spark_rapids_jni_tpu_torch.ops import hash_kernels as hk
    from spark_rapids_jni_tpu_torch.ops import kernels
    from spark_rapids_jni_tpu_torch.table import slice_table

    def run():
        out = []
        for b in batches:
            g = convert_from_rows_grouped(b, dtypes)
            keys = [g.column(2), g.column(4)]
            out.append((keys, hash_partition_ids(keys, NUM_PARTITIONS)))
        return out

    parts, launches = _read_path(kernels, run)
    check(launches["decode_planes"] == len(batches)
          and launches["murmur3_cols"] == len(batches),
          f"path 1 launches {launches}")
    start = 0
    for b, (keys, ids) in zip(batches, parts):
        plain = pmod(hk.murmur3_cols_plain(keys, DEFAULT_SEED),
                     NUM_PARTITIONS)
        errs["murmur3_cols"] = max(errs["murmur3_cols"],
                                   max_abs_err(ids, plain))
        check(torch.equal(ids, plain), f"partition ids != plain version at "
                                       f"batch start {start}")
        orig = slice_table(table, start, start + b.num_rows)
        want = hash_partition_ids([orig.column(2), orig.column(4)],
                                  NUM_PARTITIONS)
        check(torch.equal(ids, want), f"partition ids of the decoded keys "
                                      f"!= the original keys' at {start}")
        check(int(ids.min()) >= 0 and int(ids.max()) < NUM_PARTITIONS,
              "a partition id outside [0, 200)")
        start += b.num_rows
    counts = torch.bincount(torch.cat([ids for _, ids in parts]).long(),
                            minlength=NUM_PARTITIONS)
    _hash_timings(parts[0][0], "_partition_keys", timing)
    timing["murmur3_cols_partition_keys"]["tile_sweep"] = _mm3_tile_sweep(
        parts[0][0], "fixed", MM3_FIXED_TILES, errs, "path 1 keys")
    emit(phase="hash_partition_4m", rows=N_4M,
         batch_rows=[b.num_rows for b in batches],
         num_partitions=NUM_PARTITIONS, launches=launches,
         equal_plain=True, equal_original_keys=True,
         rows_per_partition_min_max=[int(counts.min()), int(counts.max())])
    return launches


def phase_hash_keys(errs, timing):
    """Path 2: xxhash64 and murmur3 over 8 INT64 keys, 25% nulls, 4M rows
    (the shape of the JAX package's bench.py:623-628)."""
    from spark_rapids_jni_tpu_torch import INT64
    from spark_rapids_jni_tpu_torch.ops import (
        DEFAULT_SEED, kernels, murmur3_hash, xxhash64,
    )
    from spark_rapids_jni_tpu_torch.utils import random_table
    keys = random_table([INT64] * 8, N_4M, seed=3, null_probability=0.25)
    (xx, mm3), launches = _read_path(kernels, lambda: (xxhash64(keys),
                                                       murmur3_hash(keys)))
    check(launches["xxhash64_cols"] == 1 and launches["murmur3_cols"] == 1,
          f"path 2 launches {launches}")
    for name, got in (("xxhash64_cols", xx), ("murmur3_cols", mm3)):
        _hold_hash(name, got, keys.columns, DEFAULT_SEED, errs,
                   "path 2, 8 INT64 keys")
    _hash_timings(keys.columns, "", timing)
    timing["murmur3_cols"]["tile_sweep"] = _mm3_tile_sweep(
        keys.columns, "fixed", MM3_FIXED_TILES, errs, "path 2 keys")
    emit(phase="hash_keys_4m", rows=N_4M, columns=8, launches=launches,
         equal_plain=True)
    return launches


def phase_hash_strings(errs, timing):
    """Path 3: murmur3 and xxhash64 over [padded string, INT64], 4M rows,
    lengths uniform in 0..64, 25% nulls (bench.py:693-706's shape)."""
    from spark_rapids_jni_tpu_torch import INT64
    from spark_rapids_jni_tpu_torch.ops import (
        DEFAULT_SEED, kernels, murmur3_hash, xxhash64,
    )
    from spark_rapids_jni_tpu_torch.ops import hash_kernels as hk
    from spark_rapids_jni_tpu_torch.utils import random_strings, random_table
    cols = [random_strings(N_4M, 64, seed=4, null_probability=0.25),
            random_table([INT64], N_4M, seed=5).columns[0]]
    high = int((cols[0].chars2d >= 0x80).sum())
    check(high > 0, "no string byte >= 0x80")
    (mm3, xx), launches = _read_path(kernels, lambda: (murmur3_hash(cols),
                                                       xxhash64(cols)))
    check(launches["xxhash64_cols"] == 1 and launches["murmur3_cols"] == 1,
          f"path 3 launches {launches}")
    for name, got in (("murmur3_cols", mm3), ("xxhash64_cols", xx)):
        _hold_hash(name, got, cols, DEFAULT_SEED, errs,
                   "path 3, strings + INT64")
    _hash_timings(cols, "_strings", timing)
    # K7 with the string read in place (a plan whose budget stages the
    # INT64 column only) beside the staged string of its own plan
    xx = hk._STAGING["xxhash64_cols"]
    plan = hk._stage_plan(cols, xx)
    # the INT64 column's slot is the size of the string's block before it
    direct = hk._stage_plan(cols, xx, budget=plan.slots[1] - 1)
    check(plan.slots[0] is not None and direct.slots[0] is None
          and direct.slots[1] is not None, f"plans {plan} {direct}")
    timing["xxhash64_cols_strings"]["direct_string_ms"] = _staged_ms(
        "xxhash64_cols", cols, xx, errs, "path 3, the string read in place",
        budget=plan.slots[1] - 1)
    # K6 with the string's whole tile bulk-copied (K7's route) beside the
    # string read in place by its own plan, and its string tiles swept
    mm3 = hk._STAGING["murmur3_cols"]
    whole_tile = dataclasses.replace(mm3, stage_strings=True)
    check(hk._stage_plan(cols, mm3).slots[0] is None
          and hk._stage_plan(cols, whole_tile).slots[0] is not None,
          "path 3's K6 plans")
    timing["murmur3_cols_strings"]["whole_tile_ms"] = _staged_ms(
        "murmur3_cols", cols, whole_tile, errs,
        "path 3, the string's whole tile staged")
    timing["murmur3_cols_strings"]["tile_sweep"] = _mm3_tile_sweep(
        cols, "strings", MM3_STRING_TILES, errs, "path 3")
    emit(phase="hash_strings_4m", rows=N_4M, width=cols[0].chars2d.shape[1],
         bytes_at_or_above_0x80=high, launches=launches, equal_plain=True)
    return launches


def _distinct_keys(n: int, salt: int) -> np.ndarray:
    """n distinct int64 keys: 1..n times an odd constant, modulo 2^64 (a
    bijection), plus a salt."""
    k = np.arange(1, n + 1, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    return (k + np.uint64(salt)).view(np.int64)


def _probe_rows(build: np.ndarray, n: int, seed: int):
    """n INT64 probe values, 25% null; half of the non-null ones from the
    build keys, the rest random."""
    rng = np.random.default_rng(seed)
    from_build = rng.random(n) < 0.5
    vals = np.where(from_build, build[rng.integers(0, len(build), n)],
                    rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64))
    return vals, rng.random(n) >= 0.25, from_build


def _hold_probe(bf, col, got, errs, what):
    """The probe kernel's answer against its plain version and the host
    probe."""
    from spark_rapids_jni_tpu_torch.ops import hash_kernels as hk
    words = torch.from_numpy(bf.words.view(np.int64)).to(CARD)
    plain = hk.bloom_might_contain_plain(words, col, bf.num_hash_functions)
    errs["bloom_might_contain"] = max(errs["bloom_might_contain"],
                                      max_abs_err(got.to(torch.uint8),
                                                  plain.to(torch.uint8)))
    check(torch.equal(got, plain), f"bloom kernel != plain version: {what}")
    host = torch.from_numpy(bf.might_contain(col)).to(CARD)
    check(torch.equal(got, host), f"bloom kernel != host probe: {what}")
    return words


def _route_name(route: int) -> str:
    return ("l2", "block")[route]


def _hold_routes(words, col, k, errs, what) -> dict:
    """K8 by every route it can take this filter by, forced through the
    private launch, against the plain version; returns, by route name, a
    call that launches it again (for timing)."""
    from spark_rapids_jni_tpu_torch.ops import hash_kernels as hk
    plain = hk.bloom_might_contain_plain(words, col, k)
    out = torch.empty(col.num_rows, dtype=torch.bool, device=CARD)
    runs = {}
    for route in hk._bloom_routes(words.shape[0]):
        hk._launch_bloom(words, col, k, route, out)
        errs["bloom_might_contain"] = max(errs["bloom_might_contain"],
                                          max_abs_err(out.to(torch.uint8),
                                                      plain.to(torch.uint8)))
        check(torch.equal(out, plain),
              f"bloom route {route} != plain version: {what}")
        runs[_route_name(route)] = (
            lambda r=route: hk._launch_bloom(words, col, k, r, out))
    return runs


def _bloom_route_sweep(col, errs) -> dict:
    """K8's routes timed beside each other at BLOOM_SWEEP_WORDS (k = 6,
    random bitsets), each held against the plain version first."""
    from spark_rapids_jni_tpu_torch.ops import hash_kernels as hk
    from spark_rapids_jni_tpu_torch.utils import random_bitset
    sweep = {}
    for num_words in BLOOM_SWEEP_WORDS:
        words = random_bitset(num_words, 0.5 ** (1 / 6), seed=num_words,
                              device=CARD)
        runs = _hold_routes(words, col, 6, errs, f"{num_words} words")
        sweep[num_words] = {
            "chosen": _route_name(hk._bloom_route(num_words)),
            **{name: median_ms(fn, flush=True) for name, fn in runs.items()}}
    return sweep


def phase_bloom_probe(errs, timing):
    """Path 4: Spark's runtime filter, built on the host from distinct
    INT64 keys, probed by 4M INT64 rows on the card; each filter also by
    every route K8 can take it by, and the routes timed beside each other
    over a sweep of filter sizes."""
    from spark_rapids_jni_tpu_torch import INT64
    from spark_rapids_jni_tpu_torch.ops import (
        SparkBloomFilter, kernels, might_contain_device,
    )
    from spark_rapids_jni_tpu_torch.ops import hash_kernels as hk
    from spark_rapids_jni_tpu_torch.table import Column
    total = {}
    small = SparkBloomFilter.optimal(100_000)
    check((small.num_bits, small.num_hash_functions) == (729_856, 5),
          f"optimal(100_000) gave {small.num_bits} bits, "
          f"k = {small.num_hash_functions}")
    for i, (num_bits, items) in enumerate(BLOOM_FILTERS):
        # Spark's optimalNumOfHashFunctions(expectedNumItems, numBits)
        k = max(1, round(num_bits / items * math.log(2)))
        bf = SparkBloomFilter(k, np.zeros(num_bits // 64, np.uint64))
        build = _distinct_keys(items, salt=i)
        t0 = time.perf_counter()
        bf.put(Column.from_numpy(build, INT64, device="cpu"))
        put_s = time.perf_counter() - t0
        vals, valid, from_build = _probe_rows(build, N_4M, seed=10 + i)
        col = Column.from_numpy(vals, INT64, valid, device=CARD)
        got, launches = _read_path(kernels,
                                   lambda: might_contain_device(bf, col))
        check(launches["bloom_might_contain"] == 1,
              f"path 4 launches {launches}")
        for name, v in launches.items():
            total[name] = total.get(name, 0) + v
        words = _hold_probe(bf, col, got, errs, f"{num_bits} bits")
        keep = torch.from_numpy(from_build & valid).to(CARD)
        check(bool(got[keep].all()), "a build key probed False")
        check(not bool(got[~torch.from_numpy(valid).to(CARD)].any()),
              "a null row probed True")
        others = torch.from_numpy(~from_build & valid).to(CARD)
        fpp = float(got[others].float().mean())
        label = "" if i == 0 else f"_{num_bits}_bits"
        routes = _hold_routes(words, col, k, errs, f"{num_bits} bits")
        tm = _timed(lambda: hk.bloom_might_contain(words, col, k),
                    lambda: hk.bloom_might_contain_plain(words, col, k),
                    _bound(_col_bytes(col) + N_4M + 8 * len(bf.words),
                           _bloom_ops(col, k)), N_4M)
        # diagnostic, not the bound: the L2 sectors the probes would move
        # with the bitset in device memory, and the rate that implies
        sectors = _valid_count(col) * k * L2_SECTOR_BYTES
        tm.update(route=_route_name(hk._bloom_route(len(bf.words))),
                  route_ms={name: median_ms(fn, flush=True)
                            for name, fn in routes.items()},
                  probe_sector_bytes=sectors,
                  probe_sector_rate_tb_s=sectors / tm["ms"] / 1e9)
        timing[f"bloom_might_contain{label}"] = tm
        emit(phase="bloom_probe_4m", rows=N_4M, num_bits=num_bits, k=k,
             build_keys=items, put_seconds=put_s, launches=launches,
             equal_plain=True, equal_host=True, build_keys_all_true=True,
             nulls_false=True, false_positive_rate=fpp, route=tm["route"],
             route_ms=tm["route_ms"])
    emit(phase="bloom_route_sweep", rows=N_4M, k=6,
         ms=_bloom_route_sweep(col, errs))
    return total


def phase_hash_offsets_64bit(errs):
    """64-bit offsets: a padded string column of 24M rows of 96 bytes
    (2.3 GB of chars, row offsets past 2^31 bytes) through both hash
    kernels, and a filter of 2^31 + 64 bits (which the JAX package sends to
    the host) through the bloom kernel."""
    from spark_rapids_jni_tpu_torch import INT64
    from spark_rapids_jni_tpu_torch.ops import (
        SparkBloomFilter, might_contain_device,
    )
    from spark_rapids_jni_tpu_torch.table import Column
    from spark_rapids_jni_tpu_torch.utils import random_strings
    reset_peak()
    strs = random_strings(N_WIDE_STRINGS, W_WIDE_STRINGS, seed=6)
    chars_bytes = strs.chars2d.numel()
    check(chars_bytes > 1 << 31, "the string phase does not pass 2^31")
    _hold_hashes([strs], 42, errs, "24M x 96 strings")
    del strs
    torch.cuda.empty_cache()
    bf = SparkBloomFilter(3, np.zeros((1 << 25) + 1, np.uint64))
    build = _distinct_keys(N_1M, salt=7)
    bf.put(Column.from_numpy(build, INT64, device="cpu"))
    vals, valid, from_build = _probe_rows(build, N_1M, seed=12)
    col = Column.from_numpy(vals, INT64, valid, device=CARD)
    got = might_contain_device(bf, col)
    _hold_probe(bf, col, got, errs, "2^31 + 64 bits")
    check(bool(got[torch.from_numpy(from_build & valid).to(CARD)].all()),
          "a build key probed False in the wide filter")
    emit(phase="hash_offsets_64bit", string_rows=N_WIDE_STRINGS,
         string_width=W_WIDE_STRINGS, chars_bytes=chars_bytes,
         bloom_num_bits=bf.num_bits, bloom_rows=N_1M, equal_plain=True,
         bloom_equal_host=True,
         peak_memory_bytes=torch.cuda.max_memory_allocated())


def phase_hash_edges(errs):
    """Each new kernel against its plain version at odd sizes, every null
    mode, every fixed type, special floats, every string length 0..W, two
    seeds, and bloom k in {1, 6, 12} over every long-castable type."""
    from spark_rapids_jni_tpu_torch import (
        BOOL8, DATE32, FLOAT32, FLOAT64, INT8, INT16, INT32, INT64,
        TIMESTAMP64, UINT8, UINT16, UINT32, UINT64, decimal32, decimal64,
    )
    from spark_rapids_jni_tpu_torch.ops import hash_kernels as hk
    from spark_rapids_jni_tpu_torch.utils import (
        random_bitset, random_table, special_floats, strings_with_lengths,
    )
    fixed = [INT64, FLOAT64, UINT64, INT32, UINT32, FLOAT32, INT16, UINT16,
             INT8, UINT8, BOOL8, decimal32(2), decimal64(-1), DATE32,
             TIMESTAMP64]
    bloom_types = [INT8, INT16, INT32, DATE32, TIMESTAMP64, INT64]
    bitsets = {k: random_bitset(131_072, 0.5 ** (1 / k), seed=k)
               for k in (1, 6, 12)}
    cases = 0
    for n in (1, 31, 6 * 1024 + 557):
        for nulls in (None, 0.0, 1.0, 0.25):
            t = random_table(fixed, n, seed=n, null_probability=nulls)
            strings = [strings_with_lengths(
                (torch.arange(n, device=CARD) % (W + 1)).to(torch.int32),
                W, seed=W, null_probability=nulls)
                for W in (0, 4, 12, 36, 68)]
            col_sets = ([[c] for c in t.columns] + [list(t.columns)]
                        + [[s] for s in strings]
                        + [strings + [t.columns[0]]]
                        + [list(special_floats(n).columns)])
            for seed in (42, 7):
                for cols in col_sets:
                    _hold_hashes(cols, seed, errs,
                                 f"n={n} nulls={nulls} seed={seed} "
                                 f"{[c.dtype for c in cols]}")
                    cases += 2
            for k, words in bitsets.items():
                for col in random_table(bloom_types, n, seed=n,
                                        null_probability=nulls).columns:
                    got = hk.bloom_might_contain(words, col, k)
                    plain = hk.bloom_might_contain_plain(words, col, k)
                    check(torch.equal(got, plain),
                          f"bloom n={n} nulls={nulls} k={k} {col.dtype}")
                    check(not bool(got[~col.valid_bools()].any()),
                          "a null row probed True")
                    cases += 1
    # K8 by both routes on both sides of the block route's threshold
    n = 6 * 1024 + 557
    S = hk._BLOOM_BLOCK_WORDS
    route_cases = 0
    for num_words in (1, S, S + 1):
        for k in (1, 5, 12):
            words = random_bitset(num_words, 0.5 ** (1 / k), seed=k)
            for col in random_table([INT8, INT64], n, seed=k,
                                    null_probability=0.25).columns:
                route_cases += len(_hold_routes(
                    words, col, k, errs,
                    f"{num_words} words, k={k}, {col.dtype}"))
    # K7 and K6 over views whose values, lengths, chars or masks start
    # inside a 16-byte chunk, with strings of every length 0..W on both
    # sides of the whole-tile staging limit (pitch 120 staged, 124 read in
    # place); K6 also by that route beside its own (strings in place)
    from spark_rapids_jni_tpu_torch.table import (
        Table, slice_table, slice_table_dynamic,
    )
    t = random_table(fixed, n + 11, seed=5, null_probability=0.25)
    strings = [strings_with_lengths(
        (torch.arange(n + 11, device=CARD) * 19 % (W + 1)).to(torch.int32),
        W, seed=W, null_probability=0.25) for W in (12, 68, 120, 124)]
    whole = Table(tuple(t.columns) + tuple(strings))
    mm3 = hk._STAGING["murmur3_cols"]
    whole_tile = dataclasses.replace(mm3, stage_strings=True)
    for cols in (slice_table(whole, 3, n + 3).columns,
                 slice_table_dynamic(whole, 8, n).columns):
        for staging in (hk._STAGING["xxhash64_cols"], whole_tile):
            slots = hk._stage_plan(cols, staging).slots
            check(slots[-2] is not None and slots[-1] is None,
                  f"pitch 120 not staged or 124 staged: {slots[-2:]}")
        check(all(s is None for c, s in
                  zip(cols, hk._stage_plan(cols, mm3).slots)
                  if c.dtype.is_string), "K6 staged a string")
        _hold_hashes(list(cols), 42, errs, "views at odd offsets")
        _hold_staged("murmur3_cols", list(cols), whole_tile, errs,
                     "views at odd offsets, strings staged whole")
        cases += 3
    # chains past MAX_HASH_COLS columns: ceil(ncols / 800) launches, each
    # seeded per row by the previous one's hashes; a string column in the
    # first and in the last launch
    from spark_rapids_jni_tpu_torch.ops import kernels
    from spark_rapids_jni_tpu_torch.utils import cycle_dtypes
    chains = {}
    for ncols in (801, 1600):
        t = random_table(cycle_dtypes(fixed, ncols - 2), n, seed=ncols,
                         null_probability=0.25)
        strings = [strings_with_lengths(
            (torch.arange(n, device=CARD) % (W + 1)).to(torch.int32), W,
            seed=W, null_probability=0.25) for W in (12, 68)]
        cols = [strings[0], *t.columns, strings[1]]
        for name in ("murmur3_cols", "xxhash64_cols"):
            kernels.reset_launches()
            got = getattr(hk, name)(cols, 42)
            torch.cuda.synchronize()
            chains[f"{name}_{ncols}"] = kernels.launches[name]
            check(kernels.launches[name] == -(-ncols // hk.MAX_HASH_COLS),
                  f"{name} over {ncols} columns: {kernels.launches}")
            _hold_hash(name, got, cols, 42, errs, f"{ncols}-column chain")
            cases += 1
    emit(phase="hash_edges", cases=cases, bloom_route_cases=route_cases,
         chain_launches=chains, equal_plain=True)


# ---------------------------------------------------------------------------
# Dense-padded strings and the two-stage encode
# ---------------------------------------------------------------------------

def _table_bytes(table) -> int:
    """Bytes of a table: each column's values (a padded string's chars and
    lengths) and its mask."""
    total = 0
    for c in table.columns:
        if c.validity is not None:
            total += c.validity.numel()
        if c.dtype.is_string:
            total += c.chars2d.numel() + 4 * c.num_rows
        else:
            total += c.data.numel() * c.data.element_size()
    return total


def _string_table(n: int, seed: int):
    """The reference's mixed axis (bench.py:412-431): 130 fixed-width
    columns cycling the benchmark types and 25 padded STRING columns,
    lengths uniform in 0..32, 1% nulls (the reference data_profile)."""
    from spark_rapids_jni_tpu_torch import (
        BOOL8, FLOAT32, FLOAT64, INT8, INT16, INT32, INT64, STRING,
    )
    from spark_rapids_jni_tpu_torch.utils import cycle_dtypes, random_table
    dtypes = cycle_dtypes([INT64, FLOAT64, INT32, FLOAT32, INT16, INT8,
                           BOOL8], 130) + [STRING] * 25
    return random_table(dtypes, n, seed=seed, null_probability=0.01,
                        string_lens=(0, 32))


def _check_strings_equal(want, got, what):
    """Round trip bit-exact: values and nulls by bits, and each string
    column's lengths and whole char matrix (zeros past each length on both
    sides)."""
    from spark_rapids_jni_tpu_torch.table import assert_tables_equivalent
    assert_tables_equivalent(want, got, check_nulls=False)
    for i, (a, b) in enumerate(zip(want.columns, got.columns)):
        if a.dtype.is_string:
            check(torch.equal(a.lens, b.lens)
                  and torch.equal(a.chars2d, b.chars2d),
                  f"{what}: string column {i} lengths or chars")


def _hold_decode(r2d, layout, errs, what):
    """K2 against its plain version on rows ``r2d``."""
    from spark_rapids_jni_tpu_torch.ops import kernels
    pk, vk = kernels.decode_planes(r2d, layout)
    pp, vp = kernels.decode_planes_plain(r2d, layout)
    errs["decode_planes"] = max(errs["decode_planes"], max_abs_err(pk, pp),
                                max_abs_err(vk, vp))
    check(torch.equal(pk, pp) and torch.equal(vk, vp),
          f"decode kernel != plain version: {what}")


def _check_compaction(rows, dtypes, layout):
    """compact_rows_host of a padded batch: offsets are the rows' rounded
    sizes cumulated, and sampled rows hold their padded rows' fixed bytes
    (the pairs' offsets rewritten) and chars."""
    from spark_rapids_jni_tpu_torch.ops import (
        compact_rows_host, padded_variable_layout,
    )
    t0 = time.perf_counter()
    compact = compact_rows_host(rows, dtypes)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    n, rs, fe = rows.num_rows, rows.row_size, layout.fixed_end
    padded = rows.rows2d(rs).cpu().numpy()
    blob, offs = compact.data.cpu().numpy(), compact.offsets.cpu().numpy()
    pairs = np.stack([padded[:, s:s + 8].copy().view(np.uint32)
                      for s in layout.variable_starts], axis=1)  # [n, k, 2]
    lens = pairs[:, :, 1].astype(np.int64)
    sizes = (fe + lens.sum(axis=1) + 7) // 8 * 8
    check(offs[0] == 0 and np.array_equal(offs[1:], np.cumsum(sizes)),
          "compact offsets != rounded row sizes cumulated")
    slots = padded_variable_layout(layout, rows.str_widths)[0]
    rng = np.random.default_rng(5)
    sample = rng.choice(n, 64, replace=False)
    for r in sample:
        row = blob[offs[r]:offs[r + 1]]
        fixed, want = row[:fe].copy(), padded[r, :fe].copy()
        for s in layout.variable_starts:
            fixed[s:s + 4] = want[s:s + 4] = 0
        check(np.array_equal(fixed, want),
              f"compact row {r}: fixed bytes != the padded row's")
        for si, s in enumerate(layout.variable_starts):
            off, ln = row[s:s + 8].copy().view(np.uint32)
            check(ln == lens[r, si], f"compact row {r}: length {si}")
            check(np.array_equal(row[off:off + ln],
                                 padded[r, slots[si]:slots[si] + ln]),
                  f"compact row {r}: chars of string column {si}")
    return {"rows": n, "seconds": seconds, "bytes": int(offs[-1]),
            "padded_bytes": n * rs, "sampled_rows": len(sample)}


def phase_strings_1m(errs, timing):
    """The padded string path at 1M rows of the 155-column axis: encode to
    one batch, decode it (K2 over the fixed sections at the padded stride),
    round trip bit-exact, K2 against its plain version, compaction of a
    100,000-row slice, and the entry points' times."""
    from spark_rapids_jni_tpu_torch.ops import (
        RowsColumn, compute_row_layout, convert_from_rows, convert_to_rows,
    )
    from spark_rapids_jni_tpu_torch.ops import kernels, row_mxu
    table = _string_table(N_1M, seed=42)
    dtypes = table.dtypes
    layout = compute_row_layout(dtypes)

    def run():
        b = convert_to_rows(table)
        return b, convert_from_rows(b[0], dtypes)

    (batches, decoded), launches = _read_path(kernels, run)
    check(launches["decode_planes"] == 1 and launches["grouped_encode"] == 0
          and launches["pack_planes"] == 0, f"strings launches {launches}")
    rows = batches[0]
    rs = rows.row_size
    check(len(batches) == 1 and rs == 1624
          and tuple(rows.data.shape) == (N_1M, rs)
          and rows.str_widths == (32,) * 25,
          f"strings encode gave {[tuple(b.data.shape) for b in batches]}, "
          f"row size {rs}")
    check(rs > layout.fixed_row_size, "the padded stride is not wider")
    _check_strings_equal(table, decoded, "strings 1M")
    r2d = rows.rows2d(rs)
    _hold_decode(r2d, layout, errs, "padded strings 1M")
    del decoded
    compaction = _check_compaction(
        RowsColumn(rows.data[:N_COMPACT], rows.offsets[:N_COMPACT + 1], rs,
                   rows.str_widths), dtypes, layout)
    nbytes = _table_bytes(table) + N_1M * rs
    bound = {"bytes": nbytes, "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
             "bound_by": "bytes"}
    timing["strings_encode_1m"] = {
        "rows": N_1M, "ms": median_ms(lambda: convert_to_rows(table),
                                      runs=10), **bound}
    timing["strings_decode_1m"] = {
        "rows": N_1M, "ms": median_ms(lambda: convert_from_rows(rows, dtypes),
                                      runs=10), **bound}
    k2_bytes = (N_1M * kernels._decode_load_bytes(layout)
                + 4 * row_mxu._inverse_plan(layout)[0].num_words * N_1M
                + layout.num_columns * N_1M // 8)
    timing["decode_planes_padded_1m"] = {
        "rows": N_1M, "row_stride": rs,
        "ms": median_ms(lambda: kernels.decode_planes(r2d, layout)),
        "bytes": k2_bytes, "bound_ms": k2_bytes / PEAK_BYTES_PER_S * 1e3,
        "bound_by": "bytes"}
    emit(phase="profile_strings_1m",
         encode=profile_breakdown(lambda: convert_to_rows(table)),
         decode=profile_breakdown(lambda: convert_from_rows(rows, dtypes)))
    emit(phase="strings_1m", rows=N_1M, columns=len(dtypes), row_size=rs,
         batch_bytes=rows.data.numel(), launches=launches,
         k2_row_stride=rs, roundtrip_bit_exact=True, equal_plain=True,
         compaction=compaction)
    return launches


def phase_strings_2m(errs):
    """The same axis at 2M rows: two equal batches of 1,000,000 rows, each
    decoded (K2 each), the round trip bit-exact."""
    from spark_rapids_jni_tpu_torch.ops import (
        compute_row_layout, convert_from_rows, convert_to_rows,
    )
    from spark_rapids_jni_tpu_torch.ops import kernels
    from spark_rapids_jni_tpu_torch.table import slice_table
    table = _string_table(N_2M, seed=43)
    dtypes = table.dtypes
    layout = compute_row_layout(dtypes)

    def run():
        b = convert_to_rows(table)
        return b, [convert_from_rows(x, dtypes) for x in b]

    (batches, parts), launches = _read_path(kernels, run)
    sizes = [b.num_rows for b in batches]
    check(sizes == [N_1M, N_1M], f"2M string batches {sizes}")
    check(launches["decode_planes"] == 2 and launches["grouped_encode"] == 0,
          f"2M strings launches {launches}")
    start = 0
    for b, part in zip(batches, parts):
        _check_strings_equal(slice_table(table, start, start + b.num_rows),
                             part, f"strings 2M at {start}")
        _hold_decode(b.rows2d(b.row_size), layout, errs,
                     f"padded strings 2M at {start}")
        start += b.num_rows
    emit(phase="strings_2m_multibatch", rows=N_2M, batch_rows=sizes,
         batch_bytes=[b.data.numel() for b in batches], launches=launches,
         roundtrip_bit_exact=True, equal_plain=True)
    return launches


# ---------------------------------------------------------------------------
# Arrow-layout strings and compact rows
# ---------------------------------------------------------------------------

def _arrow_of(table):
    """The same table with its string columns in Arrow layout."""
    from spark_rapids_jni_tpu_torch import Table
    return Table(tuple(c.to_arrow() for c in table.columns))


def _check_arrow_equal(want, got, what):
    """Round trip bit-exact: values and nulls by bits, and each Arrow string
    column's offsets (``want``'s rebased to 0) and chars exactly."""
    from spark_rapids_jni_tpu_torch.table import assert_tables_equivalent
    assert_tables_equivalent(want, got, check_nulls=False)
    for i, (a, b) in enumerate(zip(want.columns, got.columns)):
        if a.dtype.is_string:
            lo, hi = int(a.offsets[0]), int(a.offsets[-1])
            check(torch.equal(a.offsets - lo, b.offsets)
                  and torch.equal(a.chars[lo:hi], b.chars),
                  f"{what}: string column {i} offsets or chars")


def _encode_args(table, layout, start, end, plan):
    """The compact encode's arguments for table rows [start, end), with the
    table's (row sizes, column offsets) ``plan``."""
    from spark_rapids_jni_tpu_torch.ops import row_conversion as prc
    return prc._compact_batch_inputs(table, layout, start, end, *plan)


def _hold_compact(eargs, layout, errs, what):
    """The compact encode over ``eargs``, K2 over its rows' fixed sections
    and the string gather over its pairs, each against its plain version;
    returns the rows and the gather's arguments."""
    from spark_rapids_jni_tpu_torch.ops import kernels
    from spark_rapids_jni_tpu_torch.ops import row_conversion as prc
    blob = kernels.compact_encode(*eargs)
    plain = kernels.compact_encode_plain(*eargs)
    errs["compact_encode"] = max(errs["compact_encode"],
                                 max_abs_err(blob, plain))
    check(torch.equal(blob, plain), f"compact encode != plain: {what}")
    del plain
    gargs = prc._compact_decode(blob, eargs[2], layout)[2]
    _hold_decode(prc._compact_fixed_sections(blob, eargs[2], layout),
                 layout, errs, f"compact fixed sections: {what}")
    for got, want in zip(kernels.string_gather(*gargs),
                         kernels.string_gather_plain(*gargs)):
        errs["string_gather"] = max(errs["string_gather"],
                                    max_abs_err(got, want))
        check(torch.equal(got, want), f"string gather != plain: {what}")
    return blob, gargs


def _compact_bytes(eargs) -> int:
    """Bytes the compact encode must move: each row's fixed bytes, the row
    offsets and each column's offsets read, each char read, the rows
    written."""
    fixed, fe, row_offsets, total, strings = eargs
    n = fixed.shape[0]
    return (n * fe + 4 * (n + 1) * (1 + len(strings))
            + sum(s[0].numel() for s in strings) + total)


def _gather_bytes(gargs, lengths: bool = False) -> int:
    """Bytes the string gather must move: the row offsets and each
    column's pair offsets and output offsets read (its lengths are the
    output offsets' steps), each char read and written.  With ``lengths``,
    each column's int32 lengths too, which the kernel does not read (the
    older records' bound, kept beside it for comparison)."""
    _, row_offsets, pairs, totals = gargs
    n = row_offsets.shape[0] - 1
    per_row = 12 if lengths else 8
    return 4 * (n + 1) + len(pairs) * (per_row * n + 4) + 2 * sum(totals)


def _byte_bound(nbytes: int) -> dict:
    return {"bytes": nbytes, "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}


def _marked_launch(launch, args, plan, n: int):
    """A compact kernel's launch (``kernels._launch_compact_encode`` or
    ``_launch_string_gather``) over ``args`` by ``plan``, with the tiles it
    sends down the long-row route marked: (its output, bool [tiles])."""
    flags = torch.zeros(-(-n // plan.tile_rows), dtype=torch.uint8,
                        device=CARD)
    return launch(args, plan, flags), flags.bool()


def _tile_plan_record(plan, longs, n: int) -> dict:
    """A compact kernel's tile plan and the share of its rows that took the
    long-row route (``longs``: the tiles its launch marked long)."""
    idx = longs.nonzero().view(-1).to(torch.int64)
    long_rows = int(((idx + 1) * plan.tile_rows).clamp(max=n).sum()
                    - (idx * plan.tile_rows).sum())
    return {**dataclasses.asdict(plan), "smem_bytes": plan.smem_bytes,
            "long_tiles": int(idx.numel()), "long_row_share": long_rows / n}


def _ring_sweep(eargs, gargs, blob, chars, n: int) -> dict:
    """Each kernel on every ring of ENCODE_RINGS / GATHER_RINGS, and on its
    wrapper's plan with every tile sent down the long-row route
    (``TilePlan.long_route``, under ``"long_route"``): its plan, the tiles
    its launch marked long, its output against the wrapper's (``blob``,
    ``chars``) and its time."""
    from spark_rapids_jni_tpu_torch.ops import kernels
    out = {"compact_encode": {}, "string_gather": {}}
    enc = [(str(r), kernels.encode_plan(eargs, ring=r)) for r in ENCODE_RINGS]
    for ring, plan in enc + [("long_route",
                              kernels.encode_plan(eargs).long_route())]:
        got, longs = _marked_launch(kernels._launch_compact_encode, eargs,
                                    plan, n)
        check(max_abs_err(got, blob) == 0, f"compact encode on ring {ring}")
        del got
        out["compact_encode"][ring] = {
            **_tile_plan_record(plan, longs, n),
            "ms": median_ms(lambda: kernels._launch_compact_encode(eargs, plan),
                            flush=True)}
    gat = [(str(r), kernels.gather_plan(gargs, ring=r)) for r in GATHER_RINGS]
    for ring, plan in gat + [("long_route",
                              kernels.gather_plan(gargs).long_route())]:
        got, longs = _marked_launch(kernels._launch_string_gather, gargs,
                                    plan, n)
        for a, b in zip(got, chars):
            check(torch.equal(a, b), f"string gather on ring {ring}")
        del got
        out["string_gather"][ring] = {
            **_tile_plan_record(plan, longs, n),
            "ms": median_ms(lambda: kernels._launch_string_gather(gargs, plan),
                            flush=True)}
    for name in out:
        check(out[name]["long_route"]["long_row_share"] == 1.0,
              f"{name}: tiles off the long-row route under its long plan")
    return out


def phase_arrow_strings_1m(errs, timing):
    """The 155-column string axis at 1M rows with Arrow-layout strings:
    convert_to_rows to compact rows (one compact encode a batch) and
    convert_from_rows back (one K2 and one string gather a batch), bit for
    bit; the new kernels and K2 against their plain versions on a
    100,000-row slice and on the whole batch; that slice's blob against
    compact_rows_host of its padded encode; murmur3 and xxhash64 of the
    Arrow table against the padded table's; get_json_object over Arrow
    event-log documents against the padded column's answer; and the times
    of the entry points and the kernels."""
    from spark_rapids_jni_tpu_torch import Column
    from spark_rapids_jni_tpu_torch.ops import (
        compact_rows_host, compute_row_layout, convert_from_rows,
        convert_to_rows, get_json_object, murmur3_hash, xxhash64,
    )
    from spark_rapids_jni_tpu_torch.ops import kernels, row_mxu
    from spark_rapids_jni_tpu_torch.ops import row_conversion as prc
    from spark_rapids_jni_tpu_torch.table import slice_table
    from spark_rapids_jni_tpu_torch.utils import json_event_docs
    reset_peak()
    padded = _string_table(N_1M, seed=44)
    table = _arrow_of(padded)
    dtypes = table.dtypes
    layout = compute_row_layout(dtypes)

    def run():
        b = convert_to_rows(table)
        return b, [convert_from_rows(x, dtypes) for x in b]

    (batches, parts), launches = _read_path(kernels, run)
    nb = len(batches)
    check(launches["compact_encode"] == nb
          and launches["decode_planes"] == nb
          and launches["string_gather"] == nb
          and launches["grouped_encode"] == 0,
          f"arrow strings launches {launches} for {nb} batches")
    rows = batches[0]
    check(nb == 1 and not rows.is_padded and rows.data.dim() == 1,
          f"arrow encode gave {[b.data.shape for b in batches]}")
    _check_arrow_equal(table, parts[0], "arrow strings 1M")
    del parts
    blob_bytes = rows.data.numel()

    # the kernels on a 100,000-row slice that starts at an odd row, and its
    # blob against the padded encode of the same rows, compacted on the
    # host
    a = min(12_345, N_1M - N_COMPACT)
    b = a + N_COMPACT
    sub = slice_table(table, a, b)
    eargs = _encode_args(sub, layout, 0, N_COMPACT,
                         prc._compact_plan(sub, layout))
    sub_blob, _ = _hold_compact(eargs, layout, errs, "100,000-row slice")
    [sub_rows] = convert_to_rows(sub)
    check(torch.equal(sub_rows.data, sub_blob), "slice blob != the kernel's")
    t0 = time.perf_counter()
    [padded_rows] = convert_to_rows(slice_table(padded, a, b))
    host = compact_rows_host(padded_rows, dtypes)
    host_s = time.perf_counter() - t0
    check(torch.equal(host.data, sub_rows.data)
          and torch.equal(host.offsets, sub_rows.offsets),
          "compact encode != compact_rows_host of the padded encode")
    del sub, sub_blob, sub_rows, padded_rows, host, eargs

    # the kernels at the whole batch's shapes: held, then timed
    eargs = _encode_args(table, layout, 0, N_1M,
                         prc._compact_plan(table, layout))
    blob, gargs = _hold_compact(eargs, layout, errs, "1M batch")
    check(torch.equal(blob, rows.data), "1M blob != the entry point's")
    del blob
    # the tile plans the wrappers take, and every ring's, timed
    enc_plan, gat_plan = kernels.encode_plan(eargs), kernels.gather_plan(gargs)
    sweep = _ring_sweep(eargs, gargs, rows.data,
                        kernels.string_gather(*gargs), N_1M)
    fixed = prc._compact_fixed_sections(rows.data, rows.offsets, layout)
    timing["compact_encode"] = {
        "rows": N_1M, "ms": median_ms(lambda: kernels.compact_encode(*eargs),
                                      flush=True),
        "plain_ms": median_ms(lambda: kernels.compact_encode_plain(*eargs),
                              runs=3, warmup=1),
        **_byte_bound(_compact_bytes(eargs)),
        "plan": _tile_plan_record(enc_plan, _marked_launch(
            kernels._launch_compact_encode, eargs, enc_plan, N_1M)[1], N_1M),
        "rings": sweep["compact_encode"]}
    timing["string_gather"] = {
        "rows": N_1M, "ms": median_ms(lambda: kernels.string_gather(*gargs),
                                      flush=True),
        "plain_ms": median_ms(lambda: kernels.string_gather_plain(*gargs),
                              runs=3, warmup=1),
        **_byte_bound(_gather_bytes(gargs)),
        "bound_ms_with_lengths": _byte_bound(
            _gather_bytes(gargs, lengths=True))["bound_ms"],
        "plan": _tile_plan_record(gat_plan, _marked_launch(
            kernels._launch_string_gather, gargs, gat_plan, N_1M)[1], N_1M),
        "rings": sweep["string_gather"]}
    k2_bytes = (N_1M * kernels._decode_load_bytes(layout)
                + 4 * row_mxu._inverse_plan(layout)[0].num_words * N_1M
                + layout.num_columns * N_1M // 8)
    timing["decode_planes_compact_1m"] = {
        "rows": N_1M, "row_stride": fixed.shape[1],
        "ms": median_ms(lambda: kernels.decode_planes(fixed, layout),
                        flush=True), **_byte_bound(k2_bytes)}
    del fixed, eargs, gargs
    ends = _table_bytes(padded) - sum(
        c.chars2d.numel() - int(c.lens.to(torch.int64).sum())
        for c in padded.columns if c.dtype.is_string) + blob_bytes
    timing["arrow_strings_1m"] = {
        "rows": N_1M, "blob_bytes": blob_bytes,
        "convert_to_rows_ms": median_ms(lambda: convert_to_rows(table),
                                        runs=5, warmup=1),
        "convert_from_rows_ms": median_ms(
            lambda: convert_from_rows(rows, dtypes), runs=5, warmup=1),
        **_byte_bound(ends)}
    emit(phase="profile_arrow_strings_1m",
         encode=profile_breakdown(lambda: convert_to_rows(table)),
         decode=profile_breakdown(lambda: convert_from_rows(rows, dtypes)))
    del batches, rows

    # hashes: the Arrow table against the padded one
    total = dict.fromkeys(kernels.launches, 0)
    for fn in (murmur3_hash, xxhash64):
        got, counts = _read_path(kernels, lambda: fn(table))
        check(torch.equal(got, fn(padded)), f"{fn.__name__} of the Arrow "
                                            f"table != the padded table's")
        for name, v in counts.items():
            total[name] += v
        timing["arrow_strings_1m"][f"{fn.__name__}_ms"] = median_ms(
            lambda: fn(table), runs=5, warmup=1)
        timing["arrow_strings_1m"][f"{fn.__name__}_padded_ms"] = median_ms(
            lambda: fn(padded), runs=5, warmup=1)
    check(total["murmur3_cols"] == 1 and total["xxhash64_cols"] == 1,
          f"arrow hash launches {total}")
    del padded

    # get_json_object over Arrow documents against the padded column
    docs, _ = json_event_docs(N_COMPACT, seed=45)
    arrow_docs = Column.strings(docs, device=CARD)
    padded_docs = Column.strings_padded(docs, device=CARD)
    out, counts = _read_path(kernels,
                             lambda: get_json_object(arrow_docs, "$.user.id"))
    want = get_json_object(padded_docs, "$.user.id")
    check(counts["gjo_scan"] == 1, f"arrow get_json launches {counts}")
    check(torch.equal(out.chars2d, want.chars2d)
          and torch.equal(out.lens, want.lens)
          and torch.equal(out.validity, want.validity),
          "get_json_object of Arrow documents != the padded column's")
    for name, v in counts.items():
        total[name] += v
    timing["arrow_strings_1m"]["get_json_object_100k_ms"] = median_ms(
        lambda: get_json_object(arrow_docs, "$.user.id"), runs=5, warmup=1)
    for name, v in launches.items():
        total[name] += v
    emit(phase="arrow_strings_1m", rows=N_1M, columns=len(dtypes),
         fixed_end=layout.fixed_end, blob_bytes=blob_bytes, batches=nb,
         launches=launches, hash_and_get_json_launches=counts,
         roundtrip_bit_exact=True, equal_plain=True,
         equal_compact_rows_host=True, compact_rows_host_seconds=host_s,
         hashes_equal_padded=True, get_json_equal_padded=True,
         doc_rows=N_COMPACT, peak_memory_bytes=torch.cuda.max_memory_allocated())
    return total


def _edge_table(n, k, seed, int16=False, long_row=None):
    """Three Arrow string columns of lengths 0..67 whose chars start at odd
    offsets (each column's buffer has 1, 3 or 5 bytes before its first
    row's), an INT64 (and an INT16) and k INT8 columns (fixed_end 33 + k,
    or 35 + k with the INT16, and the validity bytes), 25% nulls; with
    ``long_row``, that row of the first string holds LONG_STRING bytes,
    past any stage of the compact kernels' plans."""
    from spark_rapids_jni_tpu_torch import INT8, INT16, INT64, Column, Table
    from spark_rapids_jni_tpu_torch.table import pack_bools
    from spark_rapids_jni_tpu_torch.utils import random_table
    fixed = random_table([INT64] + [INT16] * int16 + [INT8] * k, n,
                         seed=seed, null_probability=0.25, device=CARD)
    gen = torch.Generator(device=CARD)
    gen.manual_seed(seed)
    strs = []
    for j in range(3):
        lens = (torch.arange(n, device=CARD) * (7 + j) + j) % 68
        if j == 0 and long_row is not None:
            lens[long_row] = LONG_STRING
        offsets = torch.full((n + 1,), 2 * j + 1, dtype=torch.int64,
                             device=CARD)
        offsets[1:] += torch.cumsum(lens, 0)
        chars = torch.randint(0, 256, (int(offsets[-1]) + 3,),
                              dtype=torch.uint8, generator=gen, device=CARD)
        strs.append(Column.arrow_strings(
            offsets.to(torch.int32), chars,
            pack_bools(torch.rand(n, generator=gen, device=CARD) >= 0.25)))
    return Table((strs[0], strs[1], fixed.columns[0], strs[2],
                  *fixed.columns[1:]))


def _hold_many_columns(errs, k: int, n: int) -> dict:
    """Both compact kernels over raw arguments of ``k`` string columns
    (past what a JCUDF layout holds where k is 128), lengths 0..67, each
    column's chars at another residue mod 16, against their plain
    versions by the wrappers' plans."""
    from spark_rapids_jni_tpu_torch.ops import kernels
    from spark_rapids_jni_tpu_torch.utils import (
        compact_encode_args, compact_gather_args,
    )
    gen = torch.Generator(device=CARD)
    gen.manual_seed(k)
    lens = torch.randint(0, 68, (n, k), generator=gen, device=CARD)
    fe = 8 * k + (k + 7) // 8
    eargs = compact_encode_args(lens, fe, seed=k)
    blob = kernels.compact_encode(*eargs)
    err = max_abs_err(blob, kernels.compact_encode_plain(*eargs))
    errs["compact_encode"] = max(errs["compact_encode"], err)
    check(err == 0, f"compact encode != plain: {k} string columns")
    gargs = compact_gather_args(blob, eargs[2], fe, lens)
    for got, want in zip(kernels.string_gather(*gargs),
                         kernels.string_gather_plain(*gargs)):
        errs["string_gather"] = max(errs["string_gather"],
                                    max_abs_err(got, want))
        check(torch.equal(got, want), f"string gather != plain: {k} string "
                                      f"columns")
    return {"rows": n, "columns": k,
            "encode_tile_rows": kernels.encode_plan(eargs).tile_rows,
            "gather_tile_rows": kernels.gather_plan(gargs).tile_rows}


def phase_compact_edges(errs):
    """Compact rows at edge shapes, for correctness only: fixed_end of
    every residue mod 8 (33 to 41), lengths 0..67 at odd offsets on both
    sides, a slice from an odd row in batches forced by size_limit, zero
    rows, a table of strings only beside a padded column, a row past every
    stage of the kernels' plans among short rows (its tile on the long-row
    route); each batch byte-equal to the CPU run of the entry point, each
    kernel against its plain version, each decode bit-exact; then 33 and
    128 string columns of raw arguments, each kernel against its plain
    version."""
    from spark_rapids_jni_tpu_torch import Table
    from spark_rapids_jni_tpu_torch.ops import (
        compute_row_layout, convert_from_rows, convert_to_rows,
    )
    from spark_rapids_jni_tpu_torch.ops import row_conversion as prc
    from spark_rapids_jni_tpu_torch.table import slice_table
    from spark_rapids_jni_tpu_torch.utils import strings_with_lengths
    cases, batches_seen = 0, 0
    tables = []
    for k, int16 in [(k, False) for k in range(8)] + [(3, True)]:
        t = _edge_table(3001, k, seed=100 + k, int16=int16)
        tables += [(t, 1 << 30), (slice_table(t, 7, 3001), 64 * 240),
                   (slice_table(t, 9, 9), 1 << 30)]
    t = _edge_table(501, 0, seed=99)
    strings_only = Table((t.columns[0], t.columns[1], t.columns[3],
                          strings_with_lengths(
                              (torch.arange(501, device=CARD) % 61)
                              .to(torch.int32), 60, seed=3)))
    tables.append((strings_only, 32 * 320))
    long_table = _edge_table(3001, 2, seed=98, long_row=1500)
    tables.append((long_table, 1 << 30))
    for tt, limit in tables:
        layout = compute_row_layout(tt.dtypes)
        what = f"{tt.num_rows} rows, fixed_end {layout.fixed_end}"
        batches = convert_to_rows(tt, size_limit=limit)
        want = convert_to_rows(tt.to("cpu"), size_limit=limit, device="cpu")
        check([b.num_rows for b in batches] == [b.num_rows for b in want],
              f"compact batches differ from the CPU's: {what}")
        arrow = Table(tuple(c.to_arrow() for c in tt.columns))
        plan = prc._compact_plan(arrow, layout)
        start = 0
        for g, w in zip(batches, want):
            check(torch.equal(g.data.cpu(), w.data)
                  and torch.equal(g.offsets.cpu(), w.offsets),
                  f"compact blob != the CPU's: {what}, batch at {start}")
            end = start + g.num_rows
            blob, _ = _hold_compact(
                _encode_args(arrow, layout, start, end, plan), layout, errs,
                f"{what}, batch at {start}")
            check(torch.equal(blob, g.data), f"batch != its kernel: {what}")
            back = convert_from_rows(g, tt.dtypes)
            _check_arrow_equal(slice_table(arrow, start, end), back, what)
            start = end
            cases += 1
        batches_seen = max(batches_seen, len(batches))
    check(batches_seen > 2, f"no edge table took several batches")
    # the long row's tile goes the long-row route in both kernels
    from spark_rapids_jni_tpu_torch.ops import kernels
    arrow = Table(tuple(c.to_arrow() for c in long_table.columns))
    layout = compute_row_layout(arrow.dtypes)
    eargs = _encode_args(arrow, layout, 0, 3001,
                         prc._compact_plan(arrow, layout))
    gargs = prc._compact_decode(kernels.compact_encode(*eargs), eargs[2],
                                layout)[2]
    long_tiles = {
        "compact_encode": int(_marked_launch(
            kernels._launch_compact_encode, eargs, kernels.encode_plan(eargs),
            3001)[1].sum()),
        "string_gather": int(_marked_launch(
            kernels._launch_string_gather, gargs, kernels.gather_plan(gargs),
            3001)[1].sum())}
    check(long_tiles == {"compact_encode": 1, "string_gather": 1},
          f"long tiles of the long-row table: {long_tiles}")
    many = [_hold_many_columns(errs, k, n) for k, n in ((33, 6701),
                                                        (128, 997))]
    emit(phase="compact_edges", cases=cases, most_batches=batches_seen,
         long_row_bytes=LONG_STRING, long_tiles=long_tiles,
         many_columns=many, equal_cpu=True, equal_plain=True,
         roundtrip_bit_exact=True)


def _pack_bytes(table, layout, size: int) -> int:
    """Bytes K3 must move for ``size`` rows: each value and mask bit read
    once, each plane word written once."""
    from spark_rapids_jni_tpu_torch.ops import row_mxu
    masked = sum(c.validity is not None for c in table.columns)
    return (sum(layout.col_sizes) * size + masked * -(-size // 8)
            + 4 * row_mxu._forward_plan(layout)[0].num_words * size)


def phase_pack_planes_6m(dtypes, errs, timing):
    """The two-stage encode: 6M rows of the 212-column schema, 25% nulls,
    whose resident pack passes the 4 GiB cap, so convert_to_rows encodes
    batch by batch through K3.  Each batch against K1's rows for the same
    rows and K3 against its plain version on every batch; K3 timed over a
    1M-row batch, and the whole two-stage encode beside the grouped
    route."""
    from spark_rapids_jni_tpu_torch.ops import (
        compute_row_layout, convert_to_rows, convert_to_rows_grouped,
    )
    from spark_rapids_jni_tpu_torch.ops import kernels, row_mxu
    from spark_rapids_jni_tpu_torch.ops import row_conversion
    from spark_rapids_jni_tpu_torch.table import slice_table
    from spark_rapids_jni_tpu_torch.utils import random_table
    reset_peak()
    layout = compute_row_layout(dtypes)
    table = random_table(dtypes, N_6M, seed=6, null_probability=0.25)
    prep = (sum(c.data.numel() * c.data.element_size()
                for c in table.columns) + layout.num_columns * N_6M // 8)
    check(prep > row_conversion._FUSED_PREP_CAP,
          f"resident pack {prep} does not pass the cap")
    batches, launches = _read_path(kernels, lambda: convert_to_rows(table))
    sizes = [b.num_rows for b in batches]
    check(sizes == [N_1M] * 6, f"6M batches {sizes}")
    check(launches["pack_planes"] == 6 and launches["grouped_encode"] == 0,
          f"6M launches {launches}")
    start = 0
    for b in batches:
        k = kernels.pack_planes(table, layout, start, b.num_rows)
        p = kernels.pack_planes_plain(table, layout, start, b.num_rows)
        errs["pack_planes"] = max(errs["pack_planes"], max_abs_err(k, p))
        check(torch.equal(k, p), f"pack kernel != plain version at {start}")
        del k, p
        gc = row_mxu.table_to_grouped(
            slice_table(table, start, start + b.num_rows), layout)
        k1 = kernels.grouped_encode(gc.planes, gc.vmask, layout, 0,
                                    b.num_rows)
        check(torch.equal(b.data, k1),
              f"two-stage batch at {start} != K1's rows")
        del gc, k1
        start += b.num_rows
    peak = torch.cuda.max_memory_allocated()
    del batches
    torch.cuda.empty_cache()
    nbytes = _pack_bytes(table, layout, N_1M)
    timing["pack_planes"] = {
        "rows": N_1M, "start": 2 * N_1M,
        "ms": median_ms(lambda: kernels.pack_planes(table, layout, 2 * N_1M,
                                                    N_1M), flush=True),
        "plain_ms": median_ms(lambda: kernels.pack_planes_plain(
            table, layout, 2 * N_1M, N_1M), runs=5, warmup=1),
        "copy_ms": copy_ms(nbytes), "bytes": nbytes,
        "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    timing["two_stage_6m"] = {
        "rows": N_6M,
        "convert_to_rows_ms": median_ms(lambda: convert_to_rows(table),
                                        runs=3, warmup=1),
        "grouped_route_ms": median_ms(lambda: convert_to_rows_grouped(
            row_mxu.table_to_grouped(table, layout)), runs=3, warmup=1),
        "second_stage_ms": median_ms(lambda: row_mxu.forward_planes_to_rows(
            kernels.pack_planes(table, layout, 2 * N_1M, N_1M), layout),
            runs=5) - timing["pack_planes"]["ms"]}
    emit(phase="profile_two_stage_batch", rows=N_1M,
         to_rows_fixed=profile_breakdown(lambda: row_mxu.to_rows_fixed(
             table, layout, 2 * N_1M, N_1M)))
    emit(phase="pack_planes_6m", rows=N_6M, resident_pack_bytes=prep,
         batch_rows=sizes, launches=launches, equal_plain=True,
         equal_k1=True, peak_memory_bytes=peak)
    return launches


def phase_pack_edges(errs):
    """K3 at 1, 33, 257 and 2125 rows, odd starts, every null pattern, four
    schemas; the two-stage encode against K1; the padded decode with
    string widths 0, 4 and 32.  Every comparison exact."""
    from spark_rapids_jni_tpu_torch import (
        BOOL8, FLOAT32, FLOAT64, INT8, INT16, INT32, INT64, STRING, UINT8,
        UINT16, UINT32, UINT64, decimal32, decimal64,
    )
    from spark_rapids_jni_tpu_torch.ops import (
        compute_row_layout, convert_from_rows, convert_to_rows,
    )
    from spark_rapids_jni_tpu_torch.ops import kernels, row_mxu
    from spark_rapids_jni_tpu_torch.table import Table
    from spark_rapids_jni_tpu_torch.utils import (
        random_table, strings_with_lengths,
    )
    schemas = {
        "one_int8": [INT8], "int64_only": [INT64, INT64],
        "odd_int16": [INT16] * 3,
        "all_fixed": [INT64, FLOAT64, UINT64, INT32, UINT32, FLOAT32, INT16,
                      UINT16, INT8, UINT8, BOOL8, decimal32(2),
                      decimal64(-1)]}
    # None: no masks; then all, none, most and few rows valid
    null_modes = (None, 0.0, 1.0, 0.1, 0.9)
    cases = 0
    for name, dtypes in schemas.items():
        layout = compute_row_layout(dtypes)
        for n in (1, 33, 257, 2125):
            for nulls in null_modes:
                t = random_table(dtypes, n, seed=n, null_probability=nulls)
                for start in sorted({0, 1, 3, n // 3 | 1, n - 1} & set(
                        range(n))):
                    for size in sorted({n - start, (n - start) // 2}):
                        k = kernels.pack_planes(t, layout, start, size)
                        p = kernels.pack_planes_plain(t, layout, start, size)
                        errs["pack_planes"] = max(errs["pack_planes"],
                                                  max_abs_err(k, p))
                        check(torch.equal(k, p),
                              f"pack {name} n={n} nulls={nulls} "
                              f"start={start} size={size}")
                        cases += 1
                gc = row_mxu.table_to_grouped(t, layout)
                check(torch.equal(row_mxu.to_rows_fixed(t, layout),
                                  kernels.grouped_encode(
                                      gc.planes, gc.vmask, layout, 0, n)),
                      f"two-stage {name} n={n} nulls={nulls} != K1")
                cases += 1
    sdtypes = [INT64, STRING, INT16, STRING, INT8, STRING, BOOL8]
    slayout = compute_row_layout(sdtypes)
    for n in (1, 31, 2125):
        for nulls in null_modes:
            fixed = iter(random_table([d for d in sdtypes if not d.is_string],
                                      n, seed=n, null_probability=nulls)
                         .columns)
            cols = [next(fixed) if W is None else strings_with_lengths(
                (torch.arange(n, device=CARD) % (W + 1)).to(torch.int32), W,
                seed=W, null_probability=nulls)
                for W in (None, 0, None, 4, None, 32, None)]
            t = Table(tuple(cols))
            [rows] = convert_to_rows(t)
            check(rows.str_widths == (0, 4, 32), f"widths {rows.str_widths}")
            _hold_decode(rows.rows2d(rows.row_size), slayout, errs,
                         f"padded n={n} nulls={nulls}")
            _check_strings_equal(t, convert_from_rows(rows, sdtypes),
                                 f"padded n={n} nulls={nulls}")
            cases += 1
    emit(phase="pack_edges", cases=cases)


# ---------------------------------------------------------------------------
# get_json_object
# ---------------------------------------------------------------------------

def _json_oracle(doc, segs):
    """Spark's answer at ``segs`` from Python's ``json``, for documents
    without repeated keys and with integer numbers only: null for a null
    row, a malformed document or a missing path; a string's content; any
    other value in compact JSON."""
    if doc is None:
        return None
    try:
        obj = json.loads(doc)
    except ValueError:
        return None
    for seg in segs:
        if isinstance(seg, int):
            if not isinstance(obj, list) or seg >= len(obj):
                return None
        elif not isinstance(obj, dict) or seg not in obj:
            return None
        obj = obj[seg]
    if isinstance(obj, str):
        return obj
    return json.dumps(obj, separators=(",", ":"), ensure_ascii=False)


def _oracle_segs(path):
    """``$.a[2].b`` -> ["a", 2, "b"], independently of the port's parser."""
    return [int(p[1:-1]) if p.startswith("[") else p
            for p in re.findall(r"\[\d+\]|[^.\[\]$]+", path)]


def _hold_sample(out, docs, rows, path, what):
    """``out``'s values at ``rows`` (numpy) against the Python oracle."""
    idx = torch.from_numpy(rows).to(CARD)
    chars = out.chars2d[idx].cpu().numpy()
    lens = out.lens[idx].cpu().numpy()
    valid = out.valid_bools()[idx].cpu().numpy()
    segs = _oracle_segs(path)
    for j, r in enumerate(rows.tolist()):
        got = bytes(chars[j, :lens[j]]).decode() if valid[j] else None
        want = _json_oracle(docs[r], segs)
        check(got == want, f"{what} {path} row {r}: {got!r} != {want!r}")


def _gjo_segs(path):
    from spark_rapids_jni_tpu_torch.ops import get_json as gj
    segs = tuple(gj._parse_path(path))
    return segs, max((len(p) for p in segs if isinstance(p, bytes)),
                     default=1)


def _check_scan(got, plain, errs, what):
    errs["gjo_scan"] = max(errs["gjo_scan"], max_abs_err(got, plain))
    check(torch.equal(got, plain), f"gjo_scan kernel != plain version: "
                                   f"{what}")


def _hold_scan(ch, segs, mkl, errs, what, walk=False):
    """K9 against its plain version on ``ch``; returns K9's fields, and
    with ``walk`` also the walk's counts, replayed beside the plain version
    (``gjo_scan_walk``)."""
    from spark_rapids_jni_tpu_torch.ops import get_json as gj
    got = gj.gjo_scan(ch, segs, mkl)
    if not walk:
        _check_scan(got, gj.gjo_scan_plain(ch, segs, mkl), errs, what)
        return got
    plain, skipped, iters = gj.gjo_scan_walk(ch, segs, mkl)
    _check_scan(got, plain, errs, what)
    return got, skipped, iters


def _gjo_bound(ch, skipped, iters) -> dict:
    """K9's least time: each char read once and six words a row written,
    against GJO_LEAST_OPS_4_CHARS instructions for four chars of the
    window.  Beside it, as diagnostics, the kernel's walk replayed with
    torch ops over the plain carry (``skipped`` and ``iters`` of
    ``get_json.gjo_scan_walk``): the share of the window's chars it skips,
    its loop's iterations a row and a warp's (the most of its 32 rows), and
    the loop's instruction counts."""
    n, W = ch.shape
    warp = torch.nn.functional.pad(iters, (0, -n % 32)).view(-1, 32).amax(1)
    return {**_bound(n * W + 24 * n, -(-n * W // 4) * GJO_LEAST_OPS_4_CHARS),
            "quiet_share": float(skipped.sum()) / (n * W),
            "iterations_per_row": float(iters.double().mean()),
            "warp_iterations": float(warp.double().mean()),
            "loop_instructions": {"step": GJO_STEP,
                                  "step_found": GJO_STEP_FOUND,
                                  "chunk_test": GJO_CHUNK_TEST}}


def _gjo_call_split(col, path, runs=5) -> dict:
    """The parts of ``get_json_object(col, path)``, timed inside one pass:
    each pass runs the call's own steps in its order, the scan (K9), the
    torch tail with the one host read (``_gjo_finish``, ``any``), and the
    host fixup of the flagged rows, with a host-clock stamp at a
    synchronize after each, so that the parts of a pass add up to the
    pass.  Medians over ``runs`` passes, the total's range, and beside them
    the median and range of ``runs`` whole calls."""
    from spark_rapids_jni_tpu_torch.ops import get_json as gj
    from spark_rapids_jni_tpu_torch.ops import get_json_object
    segs, mkl = _gjo_segs(path)
    ch, valid = col.chars2d, col.valid_bools()
    parts, calls, punted = [], [], 0
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = gj.gjo_scan(ch, segs, mkl)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        chars, lens, strict, needs_host = gj._gjo_finish(ch, valid, st)
        any_punt = bool(needs_host.any())
        t2 = time.perf_counter()
        if any_punt:
            rows = torch.nonzero(needs_host)[:, 0]
            punted = int(rows.numel())
            gj._host_fixup(chars, lens, strict, col, segs, rows)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        parts.append([(t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3])
        del st, chars, lens, strict, needs_host
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        get_json_object(col, path)
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t0) * 1e3)
    totals = [sum(p) for p in parts]
    scan, tail, fixup = (statistics.median(v) for v in zip(*parts))
    return {"call_ms": statistics.median(calls),
            "call_ms_range": [min(calls), max(calls)],
            "parts_total_ms": statistics.median(totals),
            "parts_total_ms_range": [min(totals), max(totals)],
            "scan_ms": scan, "tail_ms": tail, "host_fixup_ms": fixup,
            "runs": runs, "punted_rows": punted}


def phase_get_json_1m(errs, timing):
    """get_json_object over 1M event-log documents (W = 1024) at three
    paths: one K9 launch a call, K9 against its plain version, a
    100,000-row sample and every punted row against Python's json."""
    from spark_rapids_jni_tpu_torch import Column
    from spark_rapids_jni_tpu_torch.ops import get_json_object, kernels
    from spark_rapids_jni_tpu_torch.ops import get_json as gj
    from spark_rapids_jni_tpu_torch.utils import datagen, json_event_docs
    t0 = time.perf_counter()
    docs, kinds = json_event_docs(N_GJO, seed=21)
    col = Column.strings_padded(docs, pad_to=W_GJO, device=CARD)
    setup_s = time.perf_counter() - t0
    check(tuple(col.chars2d.shape) == (N_GJO, W_GJO), "1M window")
    rng = np.random.default_rng(22)
    special = np.isin(kinds, (datagen.EVENT_ESCAPED, datagen.EVENT_CONTAINER,
                              datagen.EVENT_MALFORMED, datagen.EVENT_NULL))
    rows = np.union1d(rng.choice(N_GJO, N_GJO_SAMPLE, replace=False),
                      np.nonzero(special)[0])
    total, per_path = {}, {}
    reset_peak()
    for path in GJO_PATHS:
        out, launches = _read_path(kernels,
                                   lambda: get_json_object(col, path))
        check(launches["gjo_scan"] == 1 and sum(launches.values()) == 1,
              f"get_json {path} launches {launches}")
        for name, v in launches.items():
            total[name] = total.get(name, 0) + v
        segs, mkl = _gjo_segs(path)
        if path == GJO_PATHS[0]:
            st, skipped, iters = _hold_scan(col.chars2d, segs, mkl, errs,
                                            f"1M {path}", walk=True)
        else:
            st = _hold_scan(col.chars2d, segs, mkl, errs, f"1M {path}")
        _hold_sample(out, docs, rows, path, "1M")
        found = int(out.valid_bools().sum())
        del out
        per_path[path] = {"valid_rows": found, "found_rows": int(st[2].sum()),
                          "deep_rows": int(st[5].sum()),
                          **_gjo_call_split(col, path)}
    peak = torch.cuda.max_memory_allocated()
    segs, mkl = _gjo_segs(GJO_PATHS[0])
    timing["gjo_scan"] = {
        "rows": N_GJO, "width": W_GJO, "path": GJO_PATHS[0],
        "ms": median_ms(lambda: gj.gjo_scan(col.chars2d, segs, mkl),
                        flush=True),
        "plain_ms": median_ms(lambda: gj.gjo_scan_plain(col.chars2d, segs,
                                                        mkl),
                              runs=1, warmup=0),
        **_gjo_bound(col.chars2d, skipped, iters)}
    emit(phase="profile_get_json_1m", path=GJO_PATHS[0],
         call=profile_breakdown(lambda: get_json_object(col, GJO_PATHS[0])))
    emit(phase="get_json_1m", rows=N_GJO, width=W_GJO,
         doc_bytes=int(col.lens.to(torch.int64).sum()),
         kinds=np.bincount(kinds, minlength=5).tolist(),
         setup_seconds=setup_s, sampled_rows=len(rows), launches=total,
         equal_plain=True, equal_oracle=True, paths=per_path,
         peak_memory_bytes=peak)
    return total


def _compact_docs(n: int):
    """bench.py:725-731's documents {"a":N,"b":"x"} for N = row % 100, as a
    dense-padded column built on the host in bulk (W = 16)."""
    from spark_rapids_jni_tpu_torch import Column
    v = np.arange(n) % 100
    two = v >= 10
    chars = np.zeros((n, 16), np.uint8)
    chars[:, :5] = np.frombuffer(b'{"a":', np.uint8)
    chars[:, 5] = np.where(two, v // 10, v) + 48
    chars[two, 6] = v[two] % 10 + 48
    tail = np.frombuffer(b',"b":"x"}', np.uint8)
    chars[~two, 6:15] = tail
    chars[two, 7:16] = tail
    lens = np.where(two, 16, 15).astype(np.int32)
    return Column.padded_strings(torch.from_numpy(chars).to(CARD),
                                 torch.from_numpy(lens).to(CARD)), v


def phase_get_json_4m_compact(errs, timing):
    """bench.py's compact get_json documents at 4M rows (it caps them at
    200,000), path $.a: one K9 launch, K9 against its plain version, every
    row's value checked on the card, a 100,000-row sample against Python's
    json."""
    from spark_rapids_jni_tpu_torch.ops import get_json_object, kernels
    from spark_rapids_jni_tpu_torch.ops import get_json as gj
    col, v = _compact_docs(N_4M)
    reset_peak()
    out, launches = _read_path(kernels, lambda: get_json_object(col, "$.a"))
    peak = torch.cuda.max_memory_allocated()
    check(launches["gjo_scan"] == 1 and sum(launches.values()) == 1,
          f"compact launches {launches}")
    segs, mkl = _gjo_segs("$.a")
    _, skipped, iters = _hold_scan(col.chars2d, segs, mkl, errs,
                                   "4M compact", walk=True)
    want_lens = torch.from_numpy(np.where(v >= 10, 2, 1).astype(np.int32))
    check(bool(out.valid_bools().all())
          and torch.equal(out.lens.cpu(), want_lens), "compact lengths")
    digits = out.chars2d[:, :2].cpu().numpy().astype(np.int64)
    got = np.where(v >= 10, (digits[:, 0] - 48) * 10 + digits[:, 1] - 48,
                   digits[:, 0] - 48)
    check(np.array_equal(got, v) and not bool(out.chars2d[:, 2:].any()),
          "compact values")
    docs = [f'{{"a":{x},"b":"x"}}' for x in v[:N_GJO_SAMPLE].tolist()]
    _hold_sample(out, docs, np.arange(N_GJO_SAMPLE), "$.a", "4M compact")
    timing["gjo_scan_compact_4m"] = {
        "rows": N_4M, "width": 16,
        "ms": median_ms(lambda: gj.gjo_scan(col.chars2d, segs, mkl),
                        flush=True),
        "plain_ms": median_ms(lambda: gj.gjo_scan_plain(col.chars2d, segs,
                                                        mkl), runs=3),
        **_gjo_bound(col.chars2d, skipped, iters),
        **_gjo_call_split(col, "$.a")}
    emit(phase="get_json_4m_compact", rows=N_4M, width=16,
         launches=launches, equal_plain=True, equal_oracle=True,
         all_rows_checked=True, peak_memory_bytes=peak)
    return launches


def phase_gjo_offsets_64bit(errs):
    """K9 over 600,000 rows of a 4096-byte window (2.46e9 bytes: row
    offsets past 2^31) against its plain version: 20,000 event documents of
    100 to 4096 bytes, repeated in a random order on the card."""
    from spark_rapids_jni_tpu_torch import Column
    from spark_rapids_jni_tpu_torch.utils import json_event_docs
    reset_peak()
    docs, _ = json_event_docs(20_000, seed=23, lengths=(100, W_GJO_WIDE))
    base = Column.strings_padded(docs, pad_to=W_GJO_WIDE, device=CARD)
    gen = torch.Generator(device=CARD)
    gen.manual_seed(24)
    pick = torch.randint(0, 20_000, (N_GJO_WIDE,), generator=gen,
                         device=CARD)
    ch = base.chars2d[pick]
    del base
    check(ch.numel() > 1 << 31, "the window does not pass 2^31 bytes")
    finds = {}
    for path in GJO_PATHS:
        segs, mkl = _gjo_segs(path)
        st = _hold_scan(ch, segs, mkl, errs, f"600,000 x 4096 {path}")
        past = (1 << 31) // W_GJO_WIDE
        finds[path] = int(st[2, past:].sum())
        check(finds[path] > 0, f"no row past 2^31 bytes found {path}")
    emit(phase="gjo_offsets_64bit", rows=N_GJO_WIDE, width=W_GJO_WIDE,
         chars_bytes=ch.numel(), found_rows_past_2_31=finds,
         equal_plain=True,
         peak_memory_bytes=torch.cuda.max_memory_allocated())


def phase_gjo_quiet_edges(errs):
    """K9 against its plain version on the documents whose stepped chars
    sit on its 16-char chunk boundaries (``utils.json_boundary_docs``), in
    windows of 1024 and 4096 chars, at GJO_PATHS and GJO_EDGE_PATHS, the
    plain version run on the host (its small per-char ops would cost more
    in launches on the card); at W = 1024 also with rows 4 and 1 bytes
    apart (the kernel's word and byte chunk loads), against its result on
    the contiguous rows.  Prints each window's quiet share at ``$.a``."""
    from spark_rapids_jni_tpu_torch.ops import get_json as gj
    from spark_rapids_jni_tpu_torch.utils import (
        json_boundary_docs, json_window,
    )
    windows, cases = {}, 0
    for W in GJO_EDGE_WIDTHS:
        host = json_window(json_boundary_docs(W), W, device="cpu")
        ch = host.to(CARD)
        for path in GJO_PATHS + GJO_EDGE_PATHS:
            segs, mkl = _gjo_segs(path)
            got = gj.gjo_scan(ch, segs, mkl)
            if path == GJO_PATHS[0]:
                want, skipped, _ = gj.gjo_scan_walk(host, segs, mkl)
                windows[W] = {"rows": ch.shape[0],
                              "quiet_share": int(skipped.sum()) / ch.numel()}
            else:
                want = gj.gjo_scan_plain(host, segs, mkl)
            _check_scan(got, want.to(CARD), errs, f"boundary W={W} {path}")
            cases += 1
            if path == GJO_PATHS[0] and W == 1024:
                for extra in (4, 1):
                    buf = torch.zeros((ch.shape[0], W + extra),
                                      dtype=torch.uint8, device=CARD)
                    buf[:, :W] = ch
                    check(torch.equal(gj.gjo_scan(buf[:, :W], segs, mkl),
                                      got),
                          f"gjo_scan at pitch {W + extra}")
                    cases += 1
    emit(phase="gjo_quiet_edges", windows=windows, cases=cases,
         paths=[p if len(p) < 32 else p[:8] + "..."
                for p in GJO_PATHS + GJO_EDGE_PATHS], equal_plain=True)


# ---------------------------------------------------------------------------
# The word-plane engine (impl="pallas", K4 and K5) and the serving runtime
# ---------------------------------------------------------------------------

def _transpose_bound(n: int, row_size: int) -> dict:
    """K4's and K5's bound: each of the n rows' words read once and written
    once."""
    nbytes = 2 * n * row_size
    return {"bytes": nbytes, "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}


def _hold_transposes(planes, rows, errs, what):
    """K4 over ``planes`` and K5 over ``rows`` against their plain
    versions."""
    from spark_rapids_jni_tpu_torch.ops import kernels
    # max_abs_err compares in slices: torch.equal would allocate a bool the
    # size of the 10.24M-row phase's operands and raise its memory peak
    n = planes.shape[1]
    for name, k, p in (
            ("planes_to_rows", lambda: kernels.planes_to_rows(planes, 0, n),
             lambda: kernels.planes_to_rows_plain(planes, 0, n)),
            ("rows_to_planes", lambda: kernels.rows_to_planes(rows),
             lambda: kernels.rows_to_planes_plain(rows))):
        err = max_abs_err(k(), p())
        errs[name] = max(errs[name], err)
        check(err == 0, f"{name} kernel != plain version: {what}")


def phase_pallas_rows_1m(table, dtypes, blob, errs, timing):
    """convert_to_rows / convert_from_rows with impl="pallas" at 1M rows of
    the 212-column schema: one batch and one K4 launch, byte-equal to the
    default route's batch ``blob`` (K1); one K5 launch to decode, values
    and nulls equal to the input; K4 and K5 against their plain versions on
    the same planes and rows; the kernels, their glue and the whole calls
    timed."""
    from spark_rapids_jni_tpu_torch.ops import (
        compute_row_layout, convert_from_rows, convert_to_rows, kernels,
        plane_rows,
    )
    from spark_rapids_jni_tpu_torch.table import assert_tables_equivalent
    layout = compute_row_layout(dtypes)
    rs = layout.fixed_row_size
    batches, enc = _read_path(
        kernels, lambda: convert_to_rows(table, impl="pallas"))
    check(len(batches) == 1 and enc["planes_to_rows"] == 1
          and sum(enc.values()) == 1, f"impl=pallas encode launches {enc}")
    check(torch.equal(batches[0].data, blob),
          "impl=pallas rows != the default route's (K1)")
    decoded, dec = _read_path(kernels, lambda: convert_from_rows(
        batches[0], dtypes, impl="pallas"))
    check(dec["rows_to_planes"] == 1 and sum(dec.values()) == 1,
          f"impl=pallas decode launches {dec}")
    assert_tables_equivalent(table, decoded, check_nulls=False)
    del decoded
    planes = plane_rows._word_planes_from_table(table, layout)
    _hold_transposes(planes, blob, errs, "1M rows of 212 columns")
    check(torch.equal(kernels.rows_to_planes(blob), planes),
          "K5 of the rows != the assembled planes")
    library = {
        "planes_to_rows": lambda: planes.t().contiguous(),
        "rows_to_planes": lambda: blob.view(torch.int32).t().contiguous()}
    for name, fn, plain_fn in (
            ("planes_to_rows",
             lambda: kernels.planes_to_rows(planes, 0, N_1M),
             lambda: kernels.planes_to_rows_plain(planes, 0, N_1M)),
            ("rows_to_planes", lambda: kernels.rows_to_planes(blob),
             lambda: kernels.rows_to_planes_plain(blob))):
        timing[name] = {
            "rows": N_1M, "ms": median_ms(fn, flush=True),
            "plain_ms": median_ms(plain_fn, flush=True),
            "library_ms": median_ms(library[name], flush=True),
            **_transpose_bound(N_1M, rs)}
    k5 = kernels.rows_to_planes(blob)
    glue = {
        "plane_assembly_ms": median_ms(
            lambda: plane_rows._word_planes_from_table(table, layout),
            runs=10),
        "column_extraction_ms": median_ms(
            lambda: plane_rows._cols_from_word_planes(k5, layout), runs=10),
        "convert_to_rows_ms": median_ms(
            lambda: convert_to_rows(table, impl="pallas"), runs=10),
        "convert_from_rows_ms": median_ms(
            lambda: convert_from_rows(batches[0], dtypes, impl="pallas"),
            runs=10)}
    emit(phase="pallas_rows_1m", rows=N_1M, row_size=rs,
         batches=len(batches), encode_launches=enc, decode_launches=dec,
         equal_k1=True, roundtrip_bit_exact=True, equal_plain=True,
         **{name: timing[name] for name in library}, **glue)
    return {name: enc[name] + dec[name] for name in enc}


def phase_pallas_rows_4m(table, dtypes, gc, errs):
    """impl="pallas" at 4M rows: four equal batches, one K4 launch each,
    each equal to K1's rows of the same rows; each decoded by one K5 launch
    back to the table's rows."""
    from spark_rapids_jni_tpu_torch.ops import (
        compute_row_layout, convert_from_rows, convert_to_rows, kernels,
    )
    from spark_rapids_jni_tpu_torch.table import (
        assert_tables_equivalent, slice_table,
    )
    layout = compute_row_layout(dtypes)
    batches, enc = _read_path(
        kernels, lambda: convert_to_rows(table, impl="pallas"))
    sizes = [b.num_rows for b in batches]
    check(sizes == [N_1M] * 4 and enc["planes_to_rows"] == 4
          and sum(enc.values()) == 4,
          f"impl=pallas 4M batches {sizes}, launches {enc}")
    parts, dec = _read_path(kernels, lambda: [
        convert_from_rows(b, dtypes, impl="pallas") for b in batches])
    check(dec["rows_to_planes"] == 4 and sum(dec.values()) == 4,
          f"impl=pallas 4M decode launches {dec}")
    start = 0
    for b, part in zip(batches, parts):
        k1 = kernels.grouped_encode(gc.planes, gc.vmask, layout, start,
                                    b.num_rows)
        check(torch.equal(b.data, k1),
              f"impl=pallas batch at {start} != K1's rows")
        del k1
        assert_tables_equivalent(slice_table(table, start,
                                             start + b.num_rows),
                                 part, check_nulls=False)
        start += b.num_rows
    emit(phase="pallas_rows_4m", rows=N_4M, batch_rows=sizes,
         encode_launches=enc, decode_launches=dec, equal_k1=True,
         roundtrip_bit_exact=True)
    return {name: enc[name] + dec[name] for name in enc}


# ---------------------------------------------------------------------------
# The per-column-block engine (K10, K11), impl="xla" and decimal128
# ---------------------------------------------------------------------------

def _row_cols_bytes(table, layout, size: int) -> dict:
    """K10's bound for ``size`` rows of ``table`` (each value and the bytes
    of each mask read once, each row written once); K11's is the same
    bytes the other way, every column's mask written."""
    masked = sum(c.validity is not None for c in table.columns)
    values = sum(layout.col_sizes) * size
    rows = layout.fixed_row_size * size
    k10 = values + masked * -(-size // 8) + rows
    k11 = rows + values + layout.num_columns * -(-size // 8)
    return {name: {"bytes": b, "bound_ms": b / PEAK_BYTES_PER_S * 1e3,
                   "bound_by": "bytes"}
            for name, b in (("to_rows_cols", k10), ("from_rows_cols", k11))}


def _hold_row_cols(table, layout, start, size, errs, what, rows=None):
    """K10 over rows [start, start + size) of ``table`` and K11 over its
    rows against their plain versions, and K11's columns against the
    table's own rows; ``rows``: K10's rows, already made."""
    from spark_rapids_jni_tpu_torch.ops import kernels
    from spark_rapids_jni_tpu_torch.table import (
        bits_view, pack_bools, valid_bits,
    )
    if rows is None:
        rows = kernels.to_rows_cols(table, layout, start, size)
    err = max_abs_err(rows, kernels.to_rows_cols_plain(table, layout, start,
                                                       size))
    errs["to_rows_cols"] = max(errs["to_rows_cols"], err)
    check(err == 0, f"to_rows_cols kernel != plain version: {what}")
    datas, vmask = kernels.from_rows_cols(rows, layout)
    pdatas, pvmask = kernels.from_rows_cols_plain(rows, layout)
    # values compare by bits: NaN payloads are not equal to themselves
    err = max([max_abs_err(vmask, pvmask)]
              + [max_abs_err(bits_view(d), bits_view(p))
                 for d, p in zip(datas, pdatas)])
    errs["from_rows_cols"] = max(errs["from_rows_cols"], err)
    check(err == 0, f"from_rows_cols kernel != plain version: {what}")
    check(torch.equal(vmask, pack_bools(valid_bits(table.columns, start,
                                                   size)))
          and all(torch.equal(bits_view(d),
                              bits_view(c.data[start:start + size]))
                  for d, c in zip(datas, table.columns)),
          f"K11 of K10's rows != the table: {what}")


def _row_cols_launches(table, layout, rows, tile_rows=0) -> dict:
    """K10 over ``table`` and K11 over ``rows`` as bare launches, their
    arguments, outputs and the column structure made once beforehand: the
    kernels' own time, where a wrapper call also times the host work that
    the flush does not cover (the checks and the structure at 212 columns,
    K11's 212 output views)."""
    import ctypes
    from spark_rapids_jni_tpu_torch.ops import kernels
    dev = rows.device
    n = table.num_rows
    tile = kernels.tile_rows_for(layout, tile_rows)
    out = torch.empty_like(rows)
    datas = kernels._column_buffers(layout, n, dev)
    vmask = torch.empty((layout.num_columns, (n + 7) // 8),
                        dtype=torch.uint8, device=dev)
    enc = kernels._row_cols(layout, [c.data for c in table.columns],
                            [c.validity for c in table.columns])
    dec = kernels._row_cols(layout, datas)
    stream = kernels.stream_of(dev)

    def to_rows():
        kernels.launch("to_rows_cols", ctypes.addressof(enc), 0, n, tile,
                       out.data_ptr(), dev.index, stream)
        return enc, out

    def from_rows():
        kernels.launch("from_rows_cols", ctypes.addressof(dec),
                       rows.data_ptr(), n, tile, vmask.data_ptr(),
                       vmask.shape[1], dev.index, stream)
        return dec, datas, vmask

    return {"to_rows_cols": to_rows, "from_rows_cols": from_rows}


def phase_row_kernels_1m(table, dtypes, blob, errs, timing):
    """ops.row_kernels at 1M rows of the 212-column schema: with
    bucket=None one K10 launch, rows byte-equal to the default route's
    batch ``blob`` (K1), and one K11 launch that gives the table back bit
    for bit; then with the default bucket="auto", which pads to 1,048,576
    rows; K10 and K11 against their plain versions, timed beside their
    bounds, the whole calls timed and the pad's share of the auto call."""
    from spark_rapids_jni_tpu_torch.ops import (
        compute_row_layout, kernels, row_kernels,
    )
    from spark_rapids_jni_tpu_torch.runtime import shapes
    from spark_rapids_jni_tpu_torch.table import (
        Table, assert_tables_equivalent,
    )
    layout = compute_row_layout(dtypes)
    counts = dict.fromkeys(kernels.launches, 0)
    out = {}
    for bucket in (None, "auto"):
        rows, enc = _read_path(kernels, lambda: row_kernels.to_rows_fixed(
            table, layout, bucket=bucket))
        check(enc["to_rows_cols"] == 1 and sum(enc.values()) == 1,
              f"row_kernels encode launches {enc}, bucket={bucket}")
        check(torch.equal(rows, blob),
              f"row_kernels rows != the default route's (K1), "
              f"bucket={bucket}")
        cols, dec = _read_path(kernels, lambda: row_kernels.from_rows_fixed(
            rows, layout, bucket=bucket))
        check(dec["from_rows_cols"] == 1 and sum(dec.values()) == 1,
              f"row_kernels decode launches {dec}, bucket={bucket}")
        assert_tables_equivalent(table, Table(cols), check_nulls=False)
        del cols
        for name in counts:
            counts[name] += enc[name] + dec[name]
        out[str(bucket)] = {"encode": {k: v for k, v in enc.items() if v},
                            "decode": {k: v for k, v in dec.items() if v}}
    _hold_row_cols(table, layout, 0, N_1M, errs, "1M rows of 212 columns",
                   rows=blob)
    bounds = _row_cols_bytes(table, layout, N_1M)
    launch_only = _row_cols_launches(table, layout, blob)
    for name, fn, plain_fn in (
            ("to_rows_cols",
             lambda: kernels.to_rows_cols(table, layout, 0, N_1M),
             lambda: kernels.to_rows_cols_plain(table, layout, 0, N_1M)),
            ("from_rows_cols", lambda: kernels.from_rows_cols(blob, layout),
             lambda: kernels.from_rows_cols_plain(blob, layout))):
        timing[name] = {"rows": N_1M, "ms": median_ms(fn, flush=True),
                        "kernel_ms": median_ms(launch_only[name],
                                               flush=True),
                        "plain_ms": median_ms(plain_fn, runs=5, warmup=1,
                                              flush=True),
                        "library_ms": None, **bounds[name]}
    sweep = {f"{name}_tile{tile}_ms": median_ms(
        _row_cols_launches(table, layout, blob, tile)[name], flush=True)
        for tile in (32, 64, 128) for name in launch_only}
    b = shapes.bucket_rows(N_1M)
    calls = {
        "to_rows_fixed_ms": median_ms(lambda: row_kernels.to_rows_fixed(
            table, layout, bucket=None), runs=10),
        "to_rows_fixed_auto_ms": median_ms(lambda: row_kernels.to_rows_fixed(
            table, layout), runs=10),
        "pad_table_ms": median_ms(lambda: shapes.pad_table(table, b),
                                  runs=10),
        "from_rows_fixed_ms": median_ms(lambda: row_kernels.from_rows_fixed(
            blob, layout, bucket=None), runs=10),
        "from_rows_fixed_auto_ms": median_ms(
            lambda: row_kernels.from_rows_fixed(blob, layout), runs=10)}
    calls["pad_share_of_auto_call"] = (calls["pad_table_ms"]
                                       / calls["to_rows_fixed_auto_ms"])
    timing["row_kernels_1m"] = calls
    emit(phase="row_kernels_1m", rows=N_1M, bucket_rows=b, row_size=
         layout.fixed_row_size, launches=out, equal_k1=True,
         roundtrip_bit_exact=True, equal_plain=True,
         **{name: timing[name] for name in bounds}, tile_sweep=sweep,
         **calls)
    return counts


def phase_row_kernels_4m(table, dtypes, gc, errs):
    """to_rows_fixed_batch over the 4M table in the batches convert_to_rows
    plans for its batch-sliced engines (four of 1M rows under the 1 GiB
    chunk): one K10 launch a batch, each equal to K1's rows and to K10's
    plain version, each decoded by K11 back to the table's rows."""
    from spark_rapids_jni_tpu_torch.ops import (
        compute_row_layout, kernels, plan_equal_batches, row_conversion,
        row_kernels,
    )
    layout = compute_row_layout(dtypes)
    plan = plan_equal_batches(N_4M, layout.fixed_row_size,
                              row_conversion._XLA_CHUNK)
    check([size for _, size in plan] == [N_1M] * 4, f"4M plan {plan}")
    batches, enc = _read_path(kernels, lambda: [
        row_kernels.to_rows_fixed_batch(table, layout, start, size)
        for start, size in plan])
    check(enc["to_rows_cols"] == 4 and sum(enc.values()) == 4,
          f"to_rows_fixed_batch 4M launches {enc}")
    for (start, size), rows in zip(plan, batches):
        k1 = kernels.grouped_encode(gc.planes, gc.vmask, layout, start, size)
        check(torch.equal(rows, k1), f"K10 batch at {start} != K1's rows")
        del k1
        _hold_row_cols(table, layout, start, size, errs,
                       f"4M batch at {start}", rows=rows)
    emit(phase="row_kernels_4m", rows=N_4M, batch_rows=[s for _, s in plan],
         launches={k: v for k, v in enc.items() if v}, equal_k1=True,
         equal_plain=True,
         roundtrip_bit_exact=True)
    return enc


def phase_xla_rows_1m(table, dtypes, blob, timing):
    """convert_to_rows / convert_from_rows with impl="xla" at 1M rows of
    the 212-column schema: one batch byte-equal to the default route's
    (K1), the round trip bit-exact, no kernel launched; both calls timed
    beside K10's and K11's."""
    from spark_rapids_jni_tpu_torch.ops import (
        convert_from_rows, convert_to_rows, kernels,
    )
    from spark_rapids_jni_tpu_torch.table import assert_tables_equivalent
    batches, enc = _read_path(
        kernels, lambda: convert_to_rows(table, impl="xla"))
    check(len(batches) == 1 and torch.equal(batches[0].data, blob),
          "impl=xla rows != the default route's (K1)")
    decoded, dec = _read_path(kernels, lambda: convert_from_rows(
        batches[0], dtypes, impl="xla"))
    check(sum(enc.values()) == 0 and sum(dec.values()) == 0,
          f"impl=xla launched kernels: {enc} {dec}")
    assert_tables_equivalent(table, decoded, check_nulls=False)
    del decoded
    calls = {
        "convert_to_rows_ms": median_ms(
            lambda: convert_to_rows(table, impl="xla"), runs=10),
        "convert_from_rows_ms": median_ms(
            lambda: convert_from_rows(batches[0], dtypes, impl="xla"),
            runs=10),
        "to_rows_cols_ms": timing["to_rows_cols"]["ms"],
        "from_rows_cols_ms": timing["from_rows_cols"]["ms"]}
    timing["xla_rows_1m"] = calls
    emit(phase="xla_rows_1m", rows=N_1M, batches=len(batches),
         encode_launches=sum(enc.values()),
         decode_launches=sum(dec.values()), equal_k1=True,
         roundtrip_bit_exact=True, **calls)


# DECIMAL(38) values every decimal128 column of the decimal phase starts
# with: zero, one, minus one, the bounds and a 20-digit value
DEC_EDGES = [0, 1, -1, 10 ** 38 - 1, -(10 ** 38 - 1), 12345678901234567890]
DEC_SCALES = (0, 2, 10, 38)


def _decimal_table(n: int, seed: int):
    """The decimal phase's table: 56 columns of the cycle_dtypes schema,
    then 8 decimal128 columns at scales 0, 2, 10 and 38, each of random
    magnitudes below 2^126 (inside DECIMAL(38)) of either sign, its first
    rows DEC_EDGES; 25% nulls in every column."""
    from spark_rapids_jni_tpu_torch import (
        BOOL8, FLOAT32, FLOAT64, INT8, INT16, INT32, INT64, decimal128,
    )
    from spark_rapids_jni_tpu_torch.ops.decimal import decimal128_from_ints
    from spark_rapids_jni_tpu_torch.table import Column, Table, pack_bools
    from spark_rapids_jni_tpu_torch.utils import cycle_dtypes, random_table
    base = random_table(cycle_dtypes([INT64, FLOAT64, INT32, FLOAT32, INT16,
                                      INT8, BOOL8], 56), n, seed=seed,
                        null_probability=0.25)
    gen = torch.Generator(device=CARD)
    gen.manual_seed(seed + 1)
    edges = decimal128_from_ints(DEC_EDGES, 0, device=CARD).data
    cols = list(base.columns)
    for k in range(8):
        limbs = torch.randint(0, 1 << 32, (n, 4), dtype=torch.int64,
                              device=CARD, generator=gen)
        limbs[:, 3] &= (1 << 30) - 1
        neg = torch.rand(n, device=CARD, generator=gen) < 0.5
        # two's complement of the negative rows: invert, add one, carry
        flipped = limbs ^ 0xFFFFFFFF
        carry = torch.ones(n, dtype=torch.int64, device=CARD)
        for j in range(4):
            s = flipped[:, j] + carry
            flipped[:, j], carry = s & 0xFFFFFFFF, s >> 32
        limbs = torch.where(neg[:, None], flipped, limbs)
        data = (limbs - (limbs >= 1 << 31) * (1 << 32)).to(torch.int32)
        data[:len(DEC_EDGES)] = edges
        valid = torch.rand(n, device=CARD, generator=gen) >= 0.25
        cols.append(Column(decimal128(DEC_SCALES[k % 4]), data.contiguous(),
                           pack_bools(valid)))
    return Table(tuple(cols))


def phase_decimal128_rows_1m(errs):
    """1M rows of 56 cycle_dtypes columns and 8 decimal128 columns through
    every fixed-width engine: the default route (K1, K2), impl="pallas"
    (K4, K5), impl="xla", the gather oracle pair and row_kernels (K10,
    K11).  Every blob byte-equal, every round trip exact, K10 and K11
    against their plain versions."""
    from spark_rapids_jni_tpu_torch.ops import (
        compute_row_layout, convert_from_rows,
        convert_from_rows_fixed_width_optimized, convert_to_rows,
        convert_to_rows_fixed_width_optimized, kernels, row_kernels, row_mxu,
    )
    from spark_rapids_jni_tpu_torch.ops.decimal import decimal128_to_ints
    from spark_rapids_jni_tpu_torch.table import (
        Table, assert_tables_equivalent, slice_table,
    )
    reset_peak()
    table = _decimal_table(N_1M, seed=8)
    layout = compute_row_layout(table.dtypes)
    counts = dict.fromkeys(kernels.launches, 0)

    def run(name, encode, decode):
        rows, enc = _read_path(kernels, encode)
        back, dec = _read_path(kernels, lambda: decode(rows))
        assert_tables_equivalent(table, back, check_nulls=False)
        for k in counts:
            counts[k] += enc[k] + dec[k]
        return rows, {"encode": {k: v for k, v in enc.items() if v},
                      "decode": {k: v for k, v in dec.items() if v}}

    engines, launches = {}, {}
    for impl in ("mxu", "pallas", "xla"):
        rows, launches[impl] = run(
            impl, lambda: convert_to_rows(table, impl=impl),
            lambda r: convert_from_rows(r[0], table.dtypes, impl=impl))
        check(len(rows) == 1, f"decimal {impl} batches {len(rows)}")
        engines[impl] = rows[0].data
    rows, launches["oracle"] = run(
        "oracle", lambda: convert_to_rows_fixed_width_optimized(table),
        lambda r: convert_from_rows_fixed_width_optimized(r[0],
                                                          table.dtypes))
    engines["oracle"] = rows[0].data
    rows, launches["row_kernels"] = run(
        "row_kernels",
        lambda: row_kernels.to_rows_fixed(table, layout, bucket=None),
        lambda r: Table(row_kernels.from_rows_fixed(r, layout, bucket=None)))
    engines["row_kernels"] = rows
    for name, blob in engines.items():
        check(torch.equal(blob, engines["mxu"]),
              f"decimal128 blob of {name} != the default route's")
    want = {"mxu": ("grouped_encode", "decode_planes"),
            "pallas": ("planes_to_rows", "rows_to_planes"),
            "xla": (), "oracle": (),
            "row_kernels": ("to_rows_cols", "from_rows_cols")}
    for name, pair in want.items():
        got = launches[name]
        check(got["encode"] == ({pair[0]: 1} if pair else {})
              and got["decode"] == ({pair[1]: 1} if pair else {}),
              f"decimal128 {name} launches {got}")
    _hold_row_cols(table, layout, 0, N_1M, errs, "decimal128 1M",
                   rows=engines["mxu"])
    _hold_row_cols(table, layout, 3, N_1M - 3, errs, "decimal128 at 3")
    # the decoded decimal columns' first rows are the edges, where valid
    for col in Table(row_kernels.from_rows_fixed(
            engines["mxu"], layout, bucket=None)).columns[56:]:
        head = decimal128_to_ints(slice_table(Table((col,)), 0,
                                              len(DEC_EDGES)).columns[0])
        check(all(v is None or v == e for v, e in zip(head, DEC_EDGES)),
              f"decimal128 edge values {head}")
    # K1 at this schema: 392-byte rows (8-byte stores), a decimal128 slot
    # four whole words
    gc = row_mxu.table_to_grouped(table, layout)
    wmap = kernels.encode_word_map(layout)
    nbytes = (4 * row_mxu._data_words(layout) * N_1M + gc.vmask.numel()
              + N_1M * layout.fixed_row_size)
    k1 = {"ms": median_ms(lambda: kernels.grouped_encode(
              gc.planes, gc.vmask, layout, 0, N_1M)),
          "bytes": nbytes, "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
          "word_map": {"whole": int((wmap >= 0).sum()),
                       "zero": int((wmap == -1).sum()),
                       "mixed": int((wmap == -2).sum())}}
    del gc
    emit(phase="decimal128_rows_1m", rows=N_1M, columns=len(table.columns),
         row_size=layout.fixed_row_size, scales=list(DEC_SCALES),
         edge_values=[str(v) for v in DEC_EDGES], launches=launches,
         blobs_equal=sorted(engines), roundtrip_bit_exact=True,
         equal_plain=True, grouped_encode=k1,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    return counts


def phase_row_kernels_edges(dtypes, errs):
    """K10 and K11 at 1, 31, 33 and 1000 rows; one INT8 column, the
    all-fixed schema with decimal128, and 910 INT8 columns at the 1 KB row
    limit; columns without masks, all valid, all null and 25% null; K10 at
    an odd start and at one that is not a multiple of 8 (to_rows_fixed_
    batch); then K10 and K11 over 10.24M rows of the 212-column schema,
    10.3 GB of rows, compared in slices."""
    from spark_rapids_jni_tpu_torch import (
        BOOL8, FLOAT32, FLOAT64, INT8, INT16, INT32, INT64, UINT8, UINT16,
        UINT32, UINT64, decimal32, decimal64, decimal128,
    )
    from spark_rapids_jni_tpu_torch.ops import (
        compute_row_layout, kernels, row_kernels,
    )
    from spark_rapids_jni_tpu_torch.table import bits_view
    from spark_rapids_jni_tpu_torch.utils import random_table
    schemas = {
        "one_int8": [INT8], "one_decimal128": [decimal128(38)],
        "all_fixed_decimal": [INT64, FLOAT64, UINT64, INT32, UINT32,
                              FLOAT32, INT16, UINT16, INT8, UINT8, BOOL8,
                              decimal32(2), decimal64(-1), decimal128(10)],
        "int8_910": [INT8] * 910}
    cases = 0
    for name, sch in schemas.items():
        layout = compute_row_layout(sch)
        for n in (1, 31, 33, 1000):
            for nulls in (None, 0.0, 1.0, 0.25):
                t = random_table(sch, n, seed=n, null_probability=nulls)
                for start in sorted({0, min(3, n - 1), min(13, n - 1)}):
                    rows = row_kernels.to_rows_fixed_batch(t, layout, start,
                                                           n - start)
                    _hold_row_cols(t, layout, start, n - start, errs,
                                   f"{name} n={n} nulls={nulls} "
                                   f"start={start}", rows=rows)
                    cases += 1
    check(compute_row_layout(schemas["int8_910"]).fixed_row_size == 1024,
          "910 INT8 columns are not a 1 KB row")
    # 64-bit offsets: the rows pass 2^31 bytes
    reset_peak()
    layout = compute_row_layout(dtypes)
    t = random_table(dtypes, N_WIDE, seed=12, null_probability=0.25)
    rows = kernels.to_rows_cols(t, layout, 0, N_WIDE)
    check(rows.numel() > 1 << 31, "the wide rows do not pass 2^31 bytes")
    datas, vmask = kernels.from_rows_cols(rows, layout)
    for s in range(0, N_WIDE, N_1M):
        size = min(N_1M, N_WIDE - s)
        err = max_abs_err(rows[s:s + size], kernels.to_rows_cols_plain(
            t, layout, s, size))
        errs["to_rows_cols"] = max(errs["to_rows_cols"], err)
        check(err == 0, f"wide to_rows_cols kernel != plain at {s}")
        pdatas, pvmask = kernels.from_rows_cols_plain(rows[s:s + size],
                                                      layout)
        err = max([max_abs_err(vmask[:, s // 8:s // 8 + pvmask.shape[1]],
                               pvmask)]
                  + [max_abs_err(bits_view(d[s:s + size]), bits_view(p))
                     for d, p in zip(datas, pdatas)])
        errs["from_rows_cols"] = max(errs["from_rows_cols"], err)
        check(err == 0, f"wide from_rows_cols kernel != plain at {s}")
        del pdatas, pvmask
    check(all(max_abs_err(bits_view(d), bits_view(c.data)) == 0
              for d, c in zip(datas, t.columns))
          and torch.equal(vmask, torch.stack([c.validity
                                              for c in t.columns])),
          "wide K11 of K10's rows != the table")
    emit(phase="row_kernels_edges", cases=cases, wide_rows=N_WIDE,
         wide_blob_bytes=rows.numel(), equal_plain=True,
         roundtrip_bit_exact=True,
         peak_memory_bytes=torch.cuda.max_memory_allocated())


def _serve_requests(rng, count, lo, hi):
    """``count`` requests of SERVE_COLS all-valid INT32 columns, each of a
    row count drawn from [lo, hi]."""
    return [list(rng.integers(-2**31, 2**31 - 1, (SERVE_COLS, int(n)),
                              dtype=np.int32))
            for n in rng.integers(lo, hi + 1, count)]


def _hold_serve_rows(data, answers, what):
    """Each answer of the rows op against convert_to_rows of its own
    columns through the default route (K1)."""
    from spark_rapids_jni_tpu_torch import INT32, Table
    from spark_rapids_jni_tpu_torch.ops import convert_to_rows
    for i, (cols, a) in enumerate(zip(data, answers)):
        [want] = convert_to_rows(Table.from_numpy(cols,
                                                  [INT32] * len(cols)))
        check(a["num_rows"] == len(cols[0])
              and np.array_equal(a["rows"],
                                 want.data.cpu().numpy().reshape(-1)),
              f"serve rows answer {i} != K1's rows: {what}")


def _tick_split(sched, op, data, runs=3) -> dict:
    """The parts of one tick of the ``rows`` group of ``data``, timed inside
    passes of the tick's own steps, with a host-clock stamp at a synchronize
    after each: the host stacking (batch), the one host-to-device copy
    (stage), the op's kernel (plane assembly and K4), the one
    device-to-host copy (fetch) and the slicing of each answer (unbatch).
    Medians over ``runs`` passes, and the median of ``runs`` whole ticks
    (submission excluded)."""
    from spark_rapids_jni_tpu_torch.runtime import shapes, staging
    from spark_rapids_jni_tpu_torch.serve import Client
    payloads, sigs = [], set()
    for cols in data:
        p, sig, _, _ = op.validate({"columns": cols})
        payloads.append(p)
        sigs.add(sig)
    check(len(sigs) == 1, f"tick split over several groups {sigs}")
    sig = sigs.pop()
    kb = shapes.bucket_rows(len(payloads))
    parts, ticks = [], []
    for _ in range(runs):
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        bufs = op.batch(payloads, sig, kb)
        t.append(time.perf_counter())
        staged = staging.stage_arrays(bufs, sched.device)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        outs = op.kernel(sig, kb)(*staged)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        host = staging.fetch_arrays(list(outs))
        t.append(time.perf_counter())
        [op.unbatch(host, i, p) for i, p in enumerate(payloads)]
        t.append(time.perf_counter())
        parts.append([(b - a) * 1e3 for a, b in zip(t, t[1:])])
        del bufs, staged, outs, host
        c = Client(sched, "split")
        futs = [c.to_rows(cols) for cols in data]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sched.tick()
        ticks.append((time.perf_counter() - t0) * 1e3)
        [f.result(timeout=60) for f in futs]
    names = ("batch_ms", "stage_ms", "kernel_ms", "fetch_ms", "unbatch_ms")
    out = {name: statistics.median(v) for name, v in zip(names, zip(*parts))}
    out["parts_total_ms"] = statistics.median(sum(p) for p in parts)
    out["tick_ms"] = statistics.median(ticks)
    out["tick_ms_range"] = [min(ticks), max(ticks)]
    out["runs"] = runs
    return out


def phase_serve_rows(errs, timing):
    """The serving runtime on the card: a Scheduler() and four Clients.
    One tick of 16 rows requests at bucket 65,536 (one K4 launch over
    1,048,576 rows), their round trip through unrows (one K5 launch), a
    mixed tick of two groups (two K4 launches), and a threaded run of four
    clients; every answer against K1's rows of its own columns."""
    from spark_rapids_jni_tpu_torch.ops import kernels
    from spark_rapids_jni_tpu_torch.runtime import shapes
    from spark_rapids_jni_tpu_torch.serve import Client, Scheduler
    from spark_rapids_jni_tpu_torch.serve import ops as serve_ops
    rng = np.random.default_rng(31)
    sched = Scheduler()
    check(sched.device.type == "cuda", f"scheduler on {sched.device}")
    clients = [Client(sched, f"tenant{i}") for i in range(4)]
    total = dict.fromkeys(kernels.launches, 0)

    def tick_path(want):
        served, launches = _read_path(kernels, sched.tick)
        for name, v in launches.items():
            total[name] += v
        check(launches == {**dict.fromkeys(launches, 0), **want},
              f"serve tick launches {launches}, expected {want}")
        return served

    t0 = time.perf_counter()
    data = _serve_requests(rng, SERVE_REQUESTS, *SERVE_ROWS)
    setup_s = time.perf_counter() - t0
    check({shapes.bucket_rows(len(c[0])) for c in data} == {SERVE_ROWS[1]},
          "a serve request outside bucket 65,536")
    futs = [clients[i % 4].to_rows(c) for i, c in enumerate(data)]
    check(tick_path({"planes_to_rows": 1}) == SERVE_REQUESTS,
          "the 16-request tick served another count")
    answers = [f.result(timeout=60) for f in futs]
    _hold_serve_rows(data, answers, "one tick")
    futs = [clients[i % 4].from_rows(a["rows"], SERVE_COLS)
            for i, a in enumerate(answers)]
    tick_path({"rows_to_planes": 1})
    for i, (cols, f) in enumerate(zip(data, futs)):
        back = f.result(timeout=60)["columns"]
        check(all(np.array_equal(a, b) for a, b in zip(back, cols)),
              f"serve round trip {i} changed the columns")
    del answers, futs
    mixed = (_serve_requests(rng, 8, *SERVE_ROWS)
             + _serve_requests(rng, 8, *SERVE_SMALL_ROWS))
    futs = [clients[i % 4].to_rows(c) for i, c in enumerate(mixed)]
    tick_path({"planes_to_rows": 2})
    _hold_serve_rows(mixed, [f.result(timeout=60) for f in futs],
                     "mixed tick")
    del mixed, futs
    split = _tick_split(sched, serve_ops.get("rows"), data)
    busy = profile_breakdown(lambda: (
        [clients[i % 4].to_rows(c) for i, c in enumerate(data)],
        sched.tick()))
    threaded = [_serve_requests(rng, SERVE_THREAD_REQUESTS,
                                *SERVE_THREAD_ROWS)
                for _ in range(len(clients))]
    results = [[] for _ in clients]

    def client_thread(i):
        futs = [clients[i].to_rows(c) for c in threaded[i]]
        results[i].extend(f.result(timeout=120) for f in futs)

    def threaded_run():
        sched.start()
        threads = [threading.Thread(target=client_thread, args=(i,))
                   for i in range(len(clients))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        check(not any(th.is_alive() for th in threads),
              "a serve client thread did not finish")
        sched.close()

    ticks_before = sched.ticks
    _, launches = _read_path(kernels, threaded_run)
    check(launches["planes_to_rows"] >= 1
          and sum(launches.values()) == launches["planes_to_rows"],
          f"threaded serve launches {launches}")
    total["planes_to_rows"] += launches["planes_to_rows"]
    for i in range(len(clients)):
        _hold_serve_rows(threaded[i], results[i], f"thread {i}")
    counters = {name: sched.total(name) for name in sched.counters}
    check(counters["fallbacks"] == 0 and counters["tick_errors"] == 0,
          f"serve counters {counters}")
    emit(phase="serve_rows", columns=SERVE_COLS, requests=SERVE_REQUESTS,
         request_rows=[len(c[0]) for c in data], bucket=SERVE_ROWS[1],
         row_size=serve_ops._rows_layout(SERVE_COLS).fixed_row_size,
         setup_seconds=setup_s,
         tick_split=split, profile_tick=busy,
         threaded={"requests": len(clients) * SERVE_THREAD_REQUESTS,
                   "ticks": sched.ticks - ticks_before,
                   "launches": launches["planes_to_rows"]},
         counters=counters, launches=total, equal_k1=True,
         roundtrip_bit_exact=True)
    return total


# ---------------------------------------------------------------------------
# Query operators (models.pipeline): torch ops, no kernel of their own; the
# grouped query runs K2 and K6 in front of the aggregate
# ---------------------------------------------------------------------------

def _on_cpu(x):
    """A tensor, Column, Table or tuple/list of them moved to the CPU."""
    if isinstance(x, (tuple, list)):
        return type(x)(_on_cpu(v) for v in x)
    return x.to("cpu") if hasattr(x, "to") else x


def _same(got, want, what):
    """Card results equal to CPU results, bit for bit: tensors, columns
    and tables (validity, data under nulls too, string bytes), in tuples
    and lists."""
    from spark_rapids_jni_tpu_torch.table import (
        Column, Table, assert_tables_equivalent, bits_view,
    )
    if isinstance(want, (tuple, list)):
        check(len(got) == len(want), f"{what}: {len(got)} != {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}[{i}]")
    elif isinstance(want, Column):
        _same(Table((got,)), Table((want,)), what)
    elif isinstance(want, Table):
        assert_tables_equivalent(_on_cpu(got), want, check_nulls=False)
    elif isinstance(want, torch.Tensor):
        g = got.cpu()
        check(g.shape == want.shape and g.dtype == want.dtype
              and torch.equal(bits_view(g), bits_view(want)),
              f"{what}: card != CPU")
    else:
        check(got == want, f"{what}: {got} != {want}")


@contextlib.contextmanager
def _pipeline_setting(name, value):
    """``models.pipeline``'s module setting ``name`` at ``value`` for a
    while: ``DENSE_MAX_SLOTS`` 0 forces the sort strategy,
    ``DOMAIN_MIN_ROWS`` 0 lets the domain strategy run at any row count,
    ``SPREAD_SLOTS`` 0 gives a scatter slot one lane."""
    from spark_rapids_jni_tpu_torch.models import pipeline
    saved = getattr(pipeline, name)
    setattr(pipeline, name, value)
    try:
        yield
    finally:
        setattr(pipeline, name, saved)


def phase_query_grouped(batches, dtypes, timing):
    """``bench.py``'s ``query_grouped`` step on each 4M batch of the
    212-column table: ``convert_from_rows_grouped`` (K2), ``pmod(murmur3(
    [col 2, col 4]), 200)`` (K6), then ``hash_aggregate_table(g, [4],
    [COUNT(*), SUM(col 2)], 256, mask=pids < 100)``; each result against
    the port's CPU run on the same key, measure and mask columns."""
    from spark_rapids_jni_tpu_torch import Table
    from spark_rapids_jni_tpu_torch.models import pipeline
    from spark_rapids_jni_tpu_torch.ops import (
        convert_from_rows_grouped, murmur3_hash, pmod,
    )
    from spark_rapids_jni_tpu_torch.ops import kernels
    measures = [(None, "count"), (2, "sum")]

    def step(b):
        g = convert_from_rows_grouped(b, dtypes)
        pids = pmod(murmur3_hash([g.column(2), g.column(4)]),
                    NUM_PARTITIONS)
        return g, pids, pipeline.hash_aggregate_table(
            g, [4], measures, QUERY_GROUPS, mask=pids < 100)

    pipeline.reset_strategies()
    outs, launches = _read_path(kernels, lambda: [step(b) for b in batches])
    strategies = dict(pipeline.strategies)
    check(launches["decode_planes"] == len(batches)
          and launches["murmur3_cols"] == len(batches)
          and sum(launches.values()) == 2 * len(batches),
          f"query_grouped launches {launches}")
    groups = []
    for i, (g, pids, res) in enumerate(outs):
        cpu = Table((g.column(2).to("cpu"), g.column(4).to("cpu")))
        want = pipeline.hash_aggregate_table(
            cpu, [1], [(None, "count"), (0, "sum")], QUERY_GROUPS,
            mask=(pids < 100).cpu())
        _same(res, want, f"query_grouped batch {i}")
        check(int(res[2]) > QUERY_GROUPS and bool(res[1].all()),
              f"batch {i}: {int(res[2])} groups")
        groups.append(int(res[2]))
    b0 = batches[0]
    g0, pids0, _ = outs[0]
    del outs

    def aggregate():
        return pipeline.hash_aggregate_table(g0, [4], measures, QUERY_GROUPS,
                                             mask=pids0 < 100)

    def by_domain():
        # the domain strategy, which the default leaves to larger inputs
        with _pipeline_setting("DOMAIN_MIN_ROWS", 0):
            return aggregate()
    want = _on_cpu(aggregate())
    pipeline.reset_strategies()
    _same(by_domain(), want, "query_grouped by the domain")
    check(dict(pipeline.strategies) == {"domain": 1},
          f"domain not taken: {dict(pipeline.strategies)}")
    del want
    (agg_ms, domain_ms), rounds = alternating_ms([aggregate, by_domain])
    split = {
        "step_ms": median_ms(lambda: step(b0), runs=10),
        "decode_ms": median_ms(
            lambda: convert_from_rows_grouped(b0, dtypes), runs=10),
        "hash_ms": median_ms(lambda: pmod(murmur3_hash(
            [g0.column(2), g0.column(4)]), NUM_PARTITIONS), runs=10),
        "aggregate_ms": agg_ms, "aggregate_domain_ms": domain_ms}
    prof = profile_breakdown(aggregate)
    timing["query_grouped_4m"] = {"batch_rows": b0.num_rows, **split}
    emit(phase="query_grouped_4m", rows=N_4M,
         batch_rows=[b.num_rows for b in batches], launches=launches,
         strategies=strategies, num_groups=groups,
         max_groups=QUERY_GROUPS, equal_cpu=True, ms_per_batch=split,
         aggregate_rounds_ms={"default": rounds[0], "domain": rounds[1]},
         aggregate_profile=prof)
    return launches


def _q6_inputs(gen):
    """TPC-DS SF10 store_sales and item cardinalities, made on the card
    with ``__graft_entry__.entry()``'s distributions: 30 sold dates (the
    month q6 selects), every sale's item among the items, quantity 1..100,
    price uniform in [1, 100), item prices uniform in [1, 80)."""
    n, items = Q6_ROWS, Q6_ITEMS

    def ints(lo, hi, size):
        return torch.randint(lo, hi, (size,), dtype=torch.int32,
                             device=CARD, generator=gen)

    def floats(lo, hi, size):
        return torch.rand(size, device=CARD, generator=gen) * (hi - lo) + lo
    return (ints(0, 30, n), ints(0, items, n), ints(1, 101, n),
            floats(1, 100, n),
            torch.randperm(items, device=CARD, generator=gen)
            .to(torch.int32), floats(1, 80, items))


def phase_flagship_q6():
    """``flagship_query_step`` at SF10: 28,800,991 sales against 102,000
    items, held against a float64 numpy oracle (groups, have and
    num_groups exact, each sum within a relative 1e-3)."""
    from spark_rapids_jni_tpu_torch.models import pipeline
    reset_peak()
    gen = torch.Generator(device=CARD)
    gen.manual_seed(6)
    args = _q6_inputs(gen)
    date, item, qty, price, bkey, bprice = (a.cpu().numpy() for a in args)
    by_key = np.empty(Q6_ITEMS, np.float32)
    by_key[bkey] = bprice
    keep = price > np.float32(1.2) * by_key[item]
    rev = price.astype(np.float64) * qty
    oracle = np.bincount(date[keep], weights=rev[keep], minlength=30)
    dates = np.nonzero(np.bincount(date[keep], minlength=30))[0]
    g = len(dates)

    def q6():
        return pipeline.flagship_query_step(*args)

    def hold(what, fn):
        """One step against the oracle; returns the largest relative error
        of a sum and the strategy the step took."""
        pipeline.reset_strategies()
        gk, sums, have, ng = (x.cpu().numpy() for x in fn())
        check(int(ng) == g and have[:g].all() and not have[g:].any()
              and np.array_equal(gk[:g], dates),
              f"{what} groups {gk[have]} ({int(ng)}) != {dates}")
        rel = np.abs(sums[:g] - oracle[dates]) / np.abs(oracle[dates])
        check(float(rel.max()) <= 1e-3, f"{what} sums off by {rel.max()}")
        return float(rel.max()), dict(pipeline.strategies)

    def by_sort():
        with _pipeline_setting("DENSE_MAX_SLOTS", 0):
            return q6()

    def one_lane():
        with _pipeline_setting("SPREAD_SLOTS", 0):
            return q6()
    err, strategies = hold("q6", q6)
    sort_err, forced = hold("q6 by the sort", by_sort)
    check(forced == {"sort": 1}, f"sort not forced: {forced}")
    (ms, sort_ms), rounds = alternating_ms([q6, by_sort], runs=5)
    one_lane_ms = median_ms(one_lane, runs=5)
    emit(phase="flagship_q6_sf10", rows=Q6_ROWS, items=Q6_ITEMS,
         groups=g, kept_rows=int(keep.sum()), strategies=strategies,
         max_rel_err=err, median_ms=ms, rows_per_s=Q6_ROWS / ms * 1e3,
         sort_ms=sort_ms, sort_max_rel_err=sort_err,
         rounds_ms={"default": rounds[0], "sort": rounds[1]},
         one_lane_ms=one_lane_ms,
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         profile=profile_breakdown(q6))
    return {"median_ms": ms, "sort_ms": sort_ms, "one_lane_ms": one_lane_ms,
            "max_rel_err": err}


def _string_keys(ids, gen_bytes):
    """Dense-padded STRING keys of ``JOIN_STR_W`` bytes, one value an id:
    lengths 0..32 (ids 0, 1, 2 take 0, 1 and 2 bytes, the rest 3 + id % 30),
    the id's three low bytes first (so that every value differs), random
    bytes after, zeros past each length."""
    from spark_rapids_jni_tpu_torch import Column
    lens_of = 3 + torch.arange(JOIN_KEYS, device=CARD) % 30
    lens_of[:3] = torch.arange(3, device=CARD)
    table = gen_bytes.clone()
    ar = torch.arange(JOIN_KEYS, device=CARD)
    for j in range(3):
        table[:, j] = ((ar >> (8 * j)) & 0xFF).to(torch.uint8)
    table.masked_fill_(torch.arange(JOIN_STR_W, device=CARD)
                       >= lens_of[:, None], 0)
    return Column.padded_strings(table[ids], lens_of[ids].to(torch.int32))


def phase_joins():
    """The q72 and q95 join shapes at 4M probe rows against 1M build rows
    over 100,000 keys: ``sort_merge_join_dup``, ``join_semi_mask`` and
    ``sort_merge_join_left``; ``join_inner_table`` and
    ``join_semi_mask_table`` with 25% null keys, INT32 and dense-padded
    STRING keys (0..32 bytes).  Each against the CPU run, and timed."""
    from spark_rapids_jni_tpu_torch import INT32, Column, Table
    from spark_rapids_jni_tpu_torch.models import pipeline as pl
    from spark_rapids_jni_tpu_torch.table import pack_bools
    gen = torch.Generator(device=CARD)
    gen.manual_seed(7)
    reset_peak()
    bk = torch.randint(0, JOIN_KEYS, (JOIN_BUILD,), dtype=torch.int32,
                       device=CARD, generator=gen)
    bp = torch.randint(-10**6, 10**6, (JOIN_BUILD,), dtype=torch.int32,
                       device=CARD, generator=gen)
    pk = torch.randint(0, JOIN_KEYS + JOIN_KEYS // 10, (N_4M,),
                       dtype=torch.int32, device=CARD, generator=gen)
    cbk, cbp, cpk = bk.cpu(), bp.cpu(), pk.cpu()
    out, times = {}, {}

    def run(name, fn, args, cargs):
        got = fn(*args)
        _same(got, fn(*cargs), name)
        times[name] = median_ms(lambda: fn(*args), runs=5)
        return got

    dup = run("sort_merge_join_dup", pl.sort_merge_join_dup,
              (bk, bp, pk, JOIN_CAPACITY), (cbk, cbp, cpk, JOIN_CAPACITY))
    out["dup_total"] = int(dup[3])
    check(not bool(dup[4]), f"dup join overflow at {int(dup[3])}")
    del dup
    semi = run("join_semi_mask", pl.join_semi_mask, (bk, pk), (cbk, cpk))
    out["semi_matched"] = int(semi.sum())
    left = run("sort_merge_join_left", pl.sort_merge_join_left,
               (bk, bp, pk, JOIN_CAPACITY), (cbk, cbp, cpk, JOIN_CAPACITY))
    out["left_total"] = int(left[4])
    del left, semi

    def nulls(n):
        return pack_bools(torch.rand(n, device=CARD, generator=gen) > 0.25)
    byte_table = torch.randint(0, 256, (JOIN_KEYS, JOIN_STR_W),
                               dtype=torch.uint8, device=CARD, generator=gen)
    for kind in ("int32", "string"):
        if kind == "int32":
            bcol = Column(INT32, bk, nulls(JOIN_BUILD))
            pcol = Column(INT32, pk, nulls(N_4M))
        else:
            bcol = _string_keys(bk.long(), byte_table)
            bcol.validity = nulls(JOIN_BUILD)
            pcol = _string_keys(pk.long() % JOIN_KEYS, byte_table)
            pcol.validity = nulls(N_4M)
        build = Table((bcol, Column(INT32, bp, nulls(JOIN_BUILD))))
        probe = Table((pcol,))
        cb, cp = _on_cpu(build), _on_cpu(probe)
        inner = run(f"join_inner_table_{kind}", pl.join_inner_table,
                    (build, 0, 1, probe, 0, JOIN_CAPACITY),
                    (cb, 0, 1, cp, 0, JOIN_CAPACITY))
        check(not bool(inner[5]), f"inner {kind} overflow")
        out[f"inner_{kind}_total"] = int(inner[4])
        del inner
        semi = run(f"join_semi_mask_table_{kind}", pl.join_semi_mask_table,
                   (build, 0, probe, 0), (cb, 0, cp, 0))
        out[f"semi_{kind}_matched"] = int(semi.sum())
        del build, probe, cb, cp, semi
    emit(phase="joins_4m", probe_rows=N_4M, build_rows=JOIN_BUILD,
         keys=JOIN_KEYS, capacity=JOIN_CAPACITY, equal_cpu=True, **out,
         ms=times, peak_memory_bytes=torch.cuda.max_memory_allocated())
    return times


def _edge_tables(rng, n, null_mode):
    """Host-made tables of every fixed-width key type, DATE32 and a padded
    STRING key (values repeating, the types' extremes among them), beside
    INT32 and INT64 measures near their maxima, a float32 measure and a
    decimal128 measure of +-(10^38 - 1) down to 1."""
    from spark_rapids_jni_tpu_torch import Column, Table
    from spark_rapids_jni_tpu_torch.ops.decimal import decimal128_from_ints
    from spark_rapids_jni_tpu_torch.table import dtype_from_name

    def valid():
        if null_mode == "none":
            return None
        return (np.ones(n, bool) if null_mode == "all"
                else rng.random(n) > 0.25)
    cols = []
    for name in EDGE_KEYS:
        d = dtype_from_name(name)
        info = np.iinfo(d.np_dtype)
        small = [0, 1, 2, 3, 5, 7] + ([-1, -5, -9] if info.min else [9, 99])
        pool = np.array([int(info.min), int(info.max)] + small,
                        dtype=object).astype(d.np_dtype)
        if name == "bool8":
            pool = np.array([0, 1], np.uint8)
        v = pool[rng.integers(0, len(pool), n)]
        cols.append(Column.from_numpy(v, d, valid(), device="cpu"))
    strs = [None if s % 11 == 0 else "k" * (s % 7) + chr(0x41 + s % 5)
            for s in range(40)]
    pick = rng.integers(0, len(strs), n)
    sc = Column.strings_padded([strs[i] for i in pick], device="cpu")
    if null_mode != "some":
        sc.validity = None if null_mode == "none" else \
            torch.from_numpy(np.packbits(np.ones(n, bool),
                                         bitorder="little"))
    cols.append(sc)
    meas = [Column.from_numpy(rng.integers(2**30, 2**31 - 1, n)
                              .astype(np.int32), dtype_from_name("int32"),
                              valid(), device="cpu"),
            Column.from_numpy(rng.integers(2**62, 2**63 - 1, n,
                                           dtype=np.int64),
                              dtype_from_name("int64"), valid(),
                              device="cpu"),
            Column.from_numpy(rng.uniform(-1e3, 1e3, n).astype(np.float32),
                              dtype_from_name("float32"), valid(),
                              device="cpu")]
    mags = [10**38 - 1, 10**37, 123456789, 1]
    ints = [int((-1) ** int(s)) * mags[int(m)] for s, m in
            zip(rng.integers(0, 2, n), rng.integers(0, 4, n))]
    v = valid()
    meas.append(decimal128_from_ints(ints, 0, v, device="cpu"))
    return Table(tuple(cols + meas))


def phase_agg_edges():
    """``hash_aggregate_table`` on the card against the CPU, exact except
    the float32 SUM (relative 1e-5 of the group's sum of |values|): every
    fixed-width key type, DATE32 and a padded STRING key under the null
    modes none, all and some; capacities below, at and above the group
    count; an all-dead mask and zero rows; INT32 and INT64 SUM past their
    maxima; decimal128 SUM, MIN, MAX and AVG (quotients past 38 digits
    null); each strategy forced."""
    from spark_rapids_jni_tpu_torch.models import pipeline as pl
    from spark_rapids_jni_tpu_torch.table import slice_table
    rng = np.random.default_rng(8)
    nk = len(EDGE_KEYS) + 1
    light = [(None, "count"), (nk, "sum"), (nk + 1, "sum"), (nk + 1, "max"),
             (nk + 2, "sum")]
    heavy = light + [(nk + 3, op) for op in ("count", "sum", "min", "max",
                                             "avg")]
    cases = 0
    strat = {}
    for mode in ("none", "all", "some"):
        cpu = _edge_tables(rng, EDGE_ROWS, mode)
        card = cpu.to(CARD)
        mask = torch.from_numpy(rng.random(EDGE_ROWS) > 0.1)
        for ki in range(nk):
            measures = heavy if ki == 0 else light
            # the card by the sort, then by the domain wherever the keys'
            # range fits 4M slots
            for dense in (0, 1 << 22):
                want = pl.hash_aggregate_table(cpu, [ki], measures,
                                               EDGE_GROUPS, mask=mask)
                pl.reset_strategies()
                with _pipeline_setting("DENSE_MAX_SLOTS", dense), \
                        _pipeline_setting("DOMAIN_MIN_ROWS", 0):
                    got = pl.hash_aggregate_table(card, [ki], measures,
                                                  EDGE_GROUPS,
                                                  mask=mask.to(CARD))
                for s, c in pl.strategies.items():
                    strat[s] = strat.get(s, 0) + c
                _hold_agg(got, want, measures, nk, f"{mode} key {ki}")
                cases += 1
        if mode == "some":
            ng = int(pl.hash_aggregate_table(
                cpu, [0, nk - 1], light, 4096, mask=mask)[2])
            for mg in (ng - 5, ng, ng + 5):
                _hold_agg(pl.hash_aggregate_table(
                    card, [0, nk - 1], heavy, mg, mask=mask.to(CARD)),
                    pl.hash_aggregate_table(cpu, [0, nk - 1], heavy, mg,
                                            mask=mask),
                    heavy, nk, f"capacity {mg} of {ng}")
                cases += 1
            dead = torch.zeros(EDGE_ROWS, dtype=torch.bool)
            _hold_agg(pl.hash_aggregate_table(card, [0], heavy, 8,
                                              mask=dead.to(CARD)),
                      pl.hash_aggregate_table(cpu, [0], heavy, 8, mask=dead),
                      heavy, nk, "all dead")
            zero = slice_table(cpu, 0, 0)
            _hold_agg(pl.hash_aggregate_table(zero.to(CARD), [0], heavy, 8),
                      pl.hash_aggregate_table(zero, [0], heavy, 8),
                      heavy, nk, "zero rows")
            cases += 2
            res, have, _ = pl.hash_aggregate_table(
                cpu, [0], heavy, EDGE_GROUPS, mask=mask)
            nulls = int((have & ~res.columns[-1].valid_bools()).sum())
            check(nulls > 0, "no decimal128 AVG overflowed to null")
    check(strat.get("domain", 0) > 0 and strat.get("sort", 0) > 0,
          f"strategies {strat}")
    emit(phase="agg_edges", rows=EDGE_ROWS, cases=cases, strategies=strat,
         decimal_avg_null_groups=nulls, equal_cpu=True)


def _hold_agg(got, want, measures, nk, what):
    """An aggregate on the card against its CPU run: everything exact but
    the float32 SUM columns (relative 1e-5 of the group's sum of |v|)."""
    table, have, ng = got
    wt, wh, wng = want
    _same(have, wh, f"{what} have")
    check(int(ng) == int(wng), f"{what} num_groups {int(ng)} != {int(wng)}")
    nkeys = wt.num_columns - len(measures)
    for i, (c, w) in enumerate(zip(table.columns, wt.columns)):
        m = measures[i - nkeys] if i >= nkeys else None
        if m is not None and m[0] == nk + 2 and m[1] == "sum":
            # both sum in float64 in their own order and round to float32:
            # values in [-1e3, 1e3), so 1e-5 of max(|sum|, 1e3) covers the
            # order and the rounding
            _same(c.valid_bools(), w.valid_bools(), f"{what} col {i} valid")
            g, x = c.data.cpu().double(), w.data.double()
            check(bool(((g - x).abs() <= 1e-5 * x.abs().clamp(min=1e3))
                       .all()), f"{what} col {i} float sum")
        else:
            _same(c, w, f"{what} col {i}")


def phase_serve_query():
    """A ``Scheduler()`` on the card serves 16 ``agg`` requests in one
    tick and 16 ``join`` requests in another, each tick twice (the second
    timed: the first loads the ops' kernels); each answer of the second
    equals the direct call on its padded inputs."""
    from spark_rapids_jni_tpu_torch.models import pipeline as pl
    from spark_rapids_jni_tpu_torch.runtime import shapes
    from spark_rapids_jni_tpu_torch.serve import Client, Scheduler
    rng = np.random.default_rng(9)
    sched = Scheduler()

    def padded(a, b):
        out = torch.zeros(b, dtype=torch.int32, device=CARD)
        out[:len(a)] = torch.from_numpy(a).to(CARD)
        return out

    def live(n, b):
        return torch.arange(b, device=CARD) < n
    try:
        aggs = [(rng.integers(0, 300, n).astype(np.int32),
                 rng.integers(-2**31, 2**31 - 1, n).astype(np.int32))
                for n in rng.integers(*SERVE_QUERY_ROWS, SERVE_REQUESTS)]
        # a first tick of the same requests loads the ops' kernels; the
        # second is timed and checked
        agg_tick_ms = []
        for _ in range(2):
            futs = [Client(sched, f"t{i % 4}").aggregate(k, v)
                    for i, (k, v) in enumerate(aggs)]
            t0 = time.perf_counter()
            served = sched.tick()
            agg_tick_ms.append((time.perf_counter() - t0) * 1e3)
            check(served == SERVE_REQUESTS, f"agg tick served {served}")
        for i, ((k, v), f) in enumerate(zip(aggs, futs)):
            r = f.result(timeout=60)
            b = shapes.bucket_rows(len(k))
            d = pl.hash_aggregate_sum(padded(k, b), padded(v, b),
                                      live(len(k), b), pl.MAX_GROUPS)
            for name, x in zip(("group_keys", "sums", "have"), d):
                check(np.array_equal(r[name], x.cpu().numpy()),
                      f"serve agg {i} {name} != direct call")
            check(r["num_groups"] == int(d[3]), f"serve agg {i} groups")
        joins = []
        for m, n in zip(rng.integers(1_000, 4_000, SERVE_REQUESTS),
                        rng.integers(2_000, 8_000, SERVE_REQUESTS)):
            joins.append((rng.permutation(20_000)[:m].astype(np.int32),
                          rng.integers(-999, 999, m).astype(np.int32),
                          rng.integers(0, 20_000, n).astype(np.int32)))
        join_tick_ms = []
        for _ in range(2):
            futs = [Client(sched, f"t{i % 4}").join(*j)
                    for i, j in enumerate(joins)]
            t0 = time.perf_counter()
            sched.tick()
            join_tick_ms.append((time.perf_counter() - t0) * 1e3)
        for i, ((bk, bp, pk), f) in enumerate(zip(joins, futs)):
            r = f.result(timeout=60)
            bm, bn = shapes.bucket_rows(len(bk)), shapes.bucket_rows(len(pk))
            pay, matched = pl.sort_merge_join_live(
                padded(bk, bm), padded(bp, bm), live(len(bk), bm),
                padded(pk, bn))
            check(np.array_equal(r["payload"], pay[:len(pk)].cpu().numpy())
                  and np.array_equal(r["matched"],
                                     matched[:len(pk)].cpu().numpy()),
                  f"serve join {i} != direct call")
    finally:
        sched.close()
    emit(phase="serve_query", requests=SERVE_REQUESTS,
         agg_rows=[int(len(k)) for k, _ in aggs],
         agg_tick_ms=agg_tick_ms[1], agg_first_tick_ms=agg_tick_ms[0],
         join_tick_ms=join_tick_ms[1], join_first_tick_ms=join_tick_ms[0],
         equal_direct=True)


# ---------------------------------------------------------------------------
# Casts and decimal arithmetic (ops.cast_string, ops.decimal): torch ops, no
# kernel of their own; every result against the port's CPU run
# ---------------------------------------------------------------------------

N_CAST = 1 << 20
_COLUMN_FIELDS = ("data", "validity", "chars2d", "lens", "offsets", "chars")


def _string_casts() -> dict:
    """name -> (the ``utils.cast_strings`` kind of its texts, the call)."""
    from spark_rapids_jni_tpu_torch import (
        FLOAT32, FLOAT64, INT8, INT16, INT32, INT64,
    )
    from spark_rapids_jni_tpu_torch.ops import cast_string as cs
    casts = {dt.kind: (dt.kind, lambda c, dt=dt, **k:
                       cs.cast_string_to_int(c, dt, **k))
             for dt in (INT8, INT16, INT32, INT64)}
    for dt in (FLOAT32, FLOAT64):
        casts[dt.kind] = ("float", lambda c, dt=dt, **k:
                          cs.cast_string_to_float(c, dt, **k))
    for s in (2, 18):
        casts[f"decimal_{s}"] = ("decimal", lambda c, s=s, **k:
                                 cs.cast_string_to_decimal128(c, s, **k))
    casts["date"] = ("date", cs.cast_string_to_date)
    casts["timestamp"] = ("timestamp", cs.cast_string_to_timestamp)
    return casts


def _random_bits(n, dtype, gen):
    """``n`` values of an integer ``dtype`` with uniform random bits."""
    size = torch.empty(0, dtype=dtype).element_size()
    return torch.randint(0, 256, (n, size), dtype=torch.uint8, device=CARD,
                         generator=gen).view(dtype).view(n)


def _same_fields(got, want, what):
    """A card column equal to its CPU run in every tensor it holds (data
    under nulls, masks, string bytes, lengths and offsets), bit for bit;
    tuples and error masks too."""
    from spark_rapids_jni_tpu_torch.table import Column
    if isinstance(want, tuple):
        for i, (g, w) in enumerate(zip(got, want)):
            _same_fields(g, w, f"{what}[{i}]")
        return
    if not isinstance(want, Column):
        _same(got, want, what)
        return
    check(got.dtype == want.dtype, f"{what}: {got.dtype} != {want.dtype}")
    for f in _COLUMN_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        check((g is None) == (w is None), f"{what}: {f} present on one side")
        if w is not None:
            _same(g, w, f"{what} {f}")


def _cast_punts(name, col) -> dict:
    """The rows of ``col`` the cast ``name`` sends to the host parse, and
    the host time of their parse (their bytes' copy included, as the cast
    runs it)."""
    from spark_rapids_jni_tpu_torch.ops import cast_string as cs
    if name.startswith("int"):
        size = int(name[3:]) // 8
        punted = cs._cast_int(col, size)[2]
        parse = lambda raw: cs._host_parse_punted(raw, size)  # noqa: E731
    elif name.startswith("float"):
        punted = cs._float_grammar(col, cs.FLOAT_PARSE_WIDTH)[-1]
        parse = cs._host_parse_float
    elif name.startswith("decimal"):
        scale = int(name.split("_")[1])
        punted = cs._cast_decimal(col, scale, cs.DEC_PARSE_WIDTH)[-1]
        parse = lambda raw: cs._host_parse_decimal(raw, scale)  # noqa: E731
    else:
        punted = cs._parse_temporal(col, name == "timestamp")["punted"]
        parse = cs._host_parse_date if name == "date" \
            else cs._host_parse_timestamp
    rows = torch.nonzero(punted & col.valid_bools())[:, 0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for raw in cs._host_rows(col, rows):
        parse(raw)
    return {"punted_rows": len(rows),
            "punt_host_ms": (time.perf_counter() - t0) * 1e3}


def _float_host_ms(col, runs=5) -> float:
    """Median host time of the float cast's numpy conversion
    (``cast_string._float_values``) over this column's windows."""
    from spark_rapids_jni_tpu_torch.ops import cast_string as cs
    width = cs.FLOAT_PARSE_WIDTH
    ch, tlen, valid, cls, suffix, _ = cs._float_grammar(col, width)
    finite = valid & (cls == 0) & col.valid_bools()
    glen = tlen - suffix.to(torch.int32)
    w = torch.where(torch.arange(width, device=ch.device) < glen[:, None],
                    ch, 0)[finite].cpu().numpy()
    args = (finite.cpu().numpy(), valid.cpu().numpy(), cls.cpu().numpy())
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        cs._float_values(w, args[0], args[1].copy(), args[2])
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _timed_call(fn, runs=5) -> dict:
    """A call's CUDA-event median and its ``profile_breakdown`` busy
    share."""
    prof = profile_breakdown(fn)
    return {"ms": median_ms(fn, runs=runs, warmup=1),
            "busy_share": prof["busy_share"], "kernel_ms": prof["kernel_ms"],
            "profile_wall_ms": prof["wall_ms"], "launches": prof["launches"]}


def _no_kernel_launches(kernels, run, what):
    """``run()``'s result, checked to launch no hand-written kernel: these
    paths are torch ops."""
    out, launches = _read_path(kernels, run)
    check(sum(launches.values()) == 0, f"{what} launched {launches}")
    return out


def phase_casts_1m(kernels):
    """Each string cast over 1,048,576 texts of its type made on the card
    (``utils.cast_strings``: about 10% null, 5% invalid, 1% overflowing,
    0.5% past the windows), against the port's CPU run of the same
    column: values or float bits, validity and error masks equal."""
    from spark_rapids_jni_tpu_torch.utils import cast_strings
    reset_peak()
    out = {}
    for i, (name, (kind, fn)) in enumerate(_string_casts().items()):
        col = cast_strings(kind, N_CAST, seed=20 + i, device=CARD)
        got = _no_kernel_launches(kernels, lambda: fn(col), f"cast {name}")
        t0 = time.perf_counter()
        want = fn(col.to("cpu"), device="cpu")
        cpu_s = time.perf_counter() - t0
        _same_fields(got, want, f"casts_1m {name}")
        rec = {**_timed_call(lambda: fn(col)), "cpu_s": cpu_s,
               **_cast_punts(name, col),
               "null_rows": int((~col.valid_bools()).sum()),
               "error_rows": int(got[1].sum()),
               "chars": int(col.offsets[-1])}
        if name.startswith("float"):
            rec["host_ms"] = _float_host_ms(col)
        out[name] = rec
        del col, got, want
    emit(phase="casts_1m", rows=N_CAST, equal_cpu=True, casts=out,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    return out


def _dec_limbs(gen, n, big_share):
    """int32 ``[n, 4]`` decimal128 limbs: values under 10^18 in magnitude,
    ``big_share`` of them within 2^32 of +-(10^38 - 1)."""
    from spark_rapids_jni_tpu_torch.ops import decimal as dec
    small = torch.randint(-10 ** 18, 10 ** 18, (n,), device=CARD,
                          generator=gen)
    limbs = torch.stack([small & 0xFFFFFFFF, (small >> 32) & 0xFFFFFFFF]
                        + [(small >> 63) & 0xFFFFFFFF] * 2, dim=1)
    bound = dec._const_limbs(dec._BOUND_LIMBS, n, CARD)
    near = dec._sub_limbs(bound, torch.stack(
        [torch.randint(0, 1 << 32, (n,), device=CARD, generator=gen)]
        + [torch.zeros(n, dtype=torch.int64, device=CARD)] * 3, dim=1))
    near = torch.where((torch.rand(n, device=CARD, generator=gen) < 0.5)
                       [:, None], dec._neg_limbs(near), near)
    big = torch.rand(n, device=CARD, generator=gen) < big_share
    return dec._data(torch.where(big[:, None], near, limbs))


def phase_to_string_1m(kernels):
    """``cast_int_to_string`` of the four integer types (random bits, the
    minimum and maximum among them), ``cast_date_to_string`` and
    ``cast_timestamp_to_string`` of random days and microseconds (years
    outside 1..9999 among them), ``cast_decimal128_to_string`` at scales
    0, 2, 38 and -3; 1,048,576 rows each, against the CPU run."""
    from spark_rapids_jni_tpu_torch import (
        DATE32, INT8, INT16, INT32, INT64, TIMESTAMP64, Column, decimal128,
    )
    from spark_rapids_jni_tpu_torch.ops import cast_string as cs
    from spark_rapids_jni_tpu_torch.ops import decimal as dec
    from spark_rapids_jni_tpu_torch.table import pack_bools
    gen = torch.Generator(device=CARD)
    gen.manual_seed(30)
    n = N_CAST

    def valid():
        return pack_bools(torch.rand(n, device=CARD, generator=gen) >= 0.1)

    def share(p):
        return torch.rand(n, device=CARD, generator=gen) < p
    cols = {}
    for dt in (INT8, INT16, INT32, INT64):
        info = torch.iinfo(dt.torch_dtype)
        v = _random_bits(n, dt.torch_dtype, gen)
        v[:2] = torch.tensor([info.min, info.max], device=CARD)
        cols[dt.kind] = (Column(dt, v, valid()), cs.cast_int_to_string)
    days = torch.randint(-900_000, 3_100_000, (n,), device=CARD,
                         generator=gen, dtype=torch.int32)
    cols["date"] = (Column(DATE32, days, valid()), cs.cast_date_to_string)
    # years 1..9999, whole seconds or milliseconds on some rows, any bits
    # on a tenth
    micros = torch.randint(-62135596800 * 10 ** 6, 253402300800 * 10 ** 6,
                           (n,), device=CARD, generator=gen)
    micros = torch.where(share(0.3), micros // 10 ** 6 * 10 ** 6, micros)
    micros = torch.where(share(0.3), micros // 1000 * 1000, micros)
    micros = torch.where(share(0.1), _random_bits(n, torch.int64, gen),
                         micros)
    micros[:2] = torch.tensor([-(1 << 63), (1 << 63) - 1], device=CARD)
    cols["timestamp"] = (Column(TIMESTAMP64, micros, valid()),
                         cs.cast_timestamp_to_string)
    limbs = _dec_limbs(gen, n, 0.05)
    for s in (0, 2, 38, -3):
        cols[f"decimal_{s}"] = (Column(decimal128(s), limbs, valid()),
                                lambda c, device=None:
                                dec.cast_decimal128_to_string(c))
    out = {}
    for name, (col, fn) in cols.items():
        got = _no_kernel_launches(kernels, lambda: fn(col),
                                  f"to_string {name}")
        t0 = time.perf_counter()
        want = fn(col.to("cpu"), device="cpu")
        cpu_s = time.perf_counter() - t0
        _same_fields(got, want, f"to_string_1m {name}")
        out[name] = {**_timed_call(lambda: fn(col)), "cpu_s": cpu_s,
                     "null_rows": int((~got.valid_bools()).sum())}
    emit(phase="to_string_1m", rows=n, equal_cpu=True, casts=out)
    return out


def phase_decimal_arith_1m(kernels):
    """``add``, ``sub``, ``mul``, ``rescale`` (+4 and -4) and ``div`` over
    1,048,576 decimal128 rows at scale 2, about 1% of the operands near
    +-(10^38 - 1) so that sums, products and the rescale up overflow, and
    0.5% zero divisors; against the CPU run."""
    from spark_rapids_jni_tpu_torch import Column, decimal128
    from spark_rapids_jni_tpu_torch.ops import decimal as dec
    from spark_rapids_jni_tpu_torch.table import pack_bools
    gen = torch.Generator(device=CARD)
    gen.manual_seed(31)
    n = N_CAST

    def operand():
        return Column(decimal128(2), _dec_limbs(gen, n, 0.01), pack_bools(
            torch.rand(n, device=CARD, generator=gen) >= 0.1))
    a, b = operand(), operand()
    zero = torch.rand(n, device=CARD, generator=gen) < 0.005
    b = Column(b.dtype, torch.where(zero[:, None], 0, b.data), b.validity)
    ops = {"add": lambda x, y: dec.add_decimal128(x, y),
           "sub": lambda x, y: dec.sub_decimal128(x, y),
           "mul": lambda x, y: dec.mul_decimal128(x, y),
           "rescale_up_4": lambda x, y: dec.rescale_decimal128(x, 6),
           "rescale_down_4": lambda x, y: dec.rescale_decimal128(x, -2),
           "div": lambda x, y: dec.div_decimal128(x, y, 6)}
    ca, cb = a.to("cpu"), b.to("cpu")
    out = {}
    for name, fn in ops.items():
        got = _no_kernel_launches(kernels, lambda: fn(a, b),
                                  f"decimal {name}")
        t0 = time.perf_counter()
        want = fn(ca, cb)
        cpu_s = time.perf_counter() - t0
        _same_fields(got, want, f"decimal_arith_1m {name}")
        out[name] = {**_timed_call(lambda: fn(a, b), runs=3),
                     "cpu_s": cpu_s, "overflow_rows": int(got[1].sum())}
    check(all(out[k]["overflow_rows"] > 0 for k in
              ("add", "mul", "rescale_up_4", "div")),
          f"an op without overflow rows: {out}")
    emit(phase="decimal_arith_1m", rows=n, equal_cpu=True, ops=out)
    return out


def _ansi_message(fn, col, **kw):
    """The message ``fn(col, ansi=True)`` raises, or None."""
    try:
        fn(col, ansi=True, **kw)
    except ValueError as e:
        return str(e)
    return None


def phase_cast_edges(kernels):
    """``utils.CAST_EDGE_STRINGS`` through every string cast, on the card
    against the CPU, ``ansi=True`` raising the same message on both; the
    edge values of every integer type, of days and microseconds, and of
    decimal128 at four scales through the casts to string and the
    decimal arithmetic."""
    from spark_rapids_jni_tpu_torch import (
        DATE32, INT8, INT16, INT32, INT64, TIMESTAMP64, Column,
    )
    from spark_rapids_jni_tpu_torch.ops import cast_string as cs
    from spark_rapids_jni_tpu_torch.ops import decimal as dec
    from spark_rapids_jni_tpu_torch.utils import CAST_EDGE_STRINGS
    edges = Column.strings(CAST_EDGE_STRINGS + [None], device="cpu")
    on_card = edges.to(CARD)
    cases = 0
    for name, (_, fn) in _string_casts().items():
        got = _no_kernel_launches(kernels, lambda: fn(on_card),
                                  f"edge {name}")
        _same_fields(got, fn(edges, device="cpu"), f"cast_edges {name}")
        msg = _ansi_message(fn, on_card)
        check(msg is not None and msg.startswith("ANSI cast failure")
              and msg == _ansi_message(fn, edges, device="cpu"),
              f"cast_edges {name} ansi: {msg}")
        cases += 2
    for dt in (INT8, INT16, INT32, INT64):
        info = torch.iinfo(dt.torch_dtype)
        v = torch.tensor([info.min, info.min + 1, -1, 0, 1, 9, 10, -10,
                          info.max - 1, info.max], dtype=dt.torch_dtype)
        col = Column(dt, v)
        got = cs.cast_int_to_string(col.to(CARD))
        _same_fields(got, cs.cast_int_to_string(col, device="cpu"),
                     f"cast_edges {dt.kind} to string")
        check(got.to_pylist() == [str(x) for x in v.tolist()],
              f"cast_edges {dt.kind} digits")
        cases += 1
    days = torch.tensor([-(1 << 31), (1 << 31) - 1, -719163, -719162, -1, 0,
                         2932896, 2932897, 11016, -141427], dtype=torch.int32)
    micros = torch.tensor([-(1 << 63), (1 << 63) - 1, -1, 0, 1, 999_999,
                           -62135596800 * 10 ** 6,
                           -62135596800 * 10 ** 6 - 1,
                           253402300799999999, 253402300800000000,
                           1673766296250000, 86399999999], dtype=torch.int64)
    for col, fn in ((Column(DATE32, days), cs.cast_date_to_string),
                    (Column(TIMESTAMP64, micros),
                     cs.cast_timestamp_to_string)):
        _same_fields(fn(col.to(CARD)), fn(col, device="cpu"),
                     f"cast_edges {col.dtype.kind} to string")
        cases += 1
    bound = 10 ** 38 - 1
    vals = [0, 1, -1, bound, -bound, bound - 1, (1 << 127) - 1, -(1 << 127),
            10 ** 37, -(10 ** 37), 5, -5, 49999, -50000, 12345678901234567890]
    for s in (0, 2, 38, -3):
        col = dec.decimal128_from_ints(vals, s, device="cpu")
        _same_fields(dec.cast_decimal128_to_string(col.to(CARD)),
                     dec.cast_decimal128_to_string(col),
                     f"cast_edges decimal {s} to string")
        cases += 1
    a = dec.decimal128_from_ints(vals, 2, device="cpu")
    b = dec.decimal128_from_ints(vals[::-1], 2, device="cpu")
    for name, fn in (("add", dec.add_decimal128), ("sub", dec.sub_decimal128),
                     ("mul", dec.mul_decimal128),
                     ("div", lambda x, y: dec.div_decimal128(x, y, 6))):
        _same_fields(fn(a.to(CARD), b.to(CARD)), fn(a, b),
                     f"cast_edges decimal {name}")
        cases += 1
    for s in (-40, -39, -4, 0, 4, 38, 39, 41):
        _same_fields(dec.rescale_decimal128(a.to(CARD), s),
                     dec.rescale_decimal128(a, s),
                     f"cast_edges rescale to {s}")
        cases += 1
    emit(phase="cast_edges", strings=len(CAST_EDGE_STRINGS) + 1, cases=cases,
         equal_cpu=True)

def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; "
                 "this script needs a CUDA card")
    from spark_rapids_jni_tpu_torch import (
        BOOL8, FLOAT32, FLOAT64, INT8, INT16, INT32, INT64, UINT8, UINT16,
        UINT32, UINT64, decimal32, decimal64,
    )
    from spark_rapids_jni_tpu_torch.ops import (
        compute_row_layout, convert_from_rows, convert_from_rows_grouped,
        convert_to_rows, convert_to_rows_fixed_width_optimized,
        convert_to_rows_grouped,
    )
    from spark_rapids_jni_tpu_torch.ops import kernels, row_mxu
    from spark_rapids_jni_tpu_torch.table import (
        assert_tables_equivalent, slice_table,
    )
    from spark_rapids_jni_tpu_torch.utils import cycle_dtypes, random_table

    t_start = time.perf_counter()
    _T0.append(t_start)
    smi = nvidia_smi_line()
    emit(phase="device", nvidia_smi=smi,
         kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    t0 = time.perf_counter()
    kernels.build_kernels()
    ptxas = {name: [ln.strip() for ln in kernels.build_log(name).splitlines()
                    if "Used" in ln or "spill" in ln]
             for name in kernels.SOURCES}
    emit(phase="build", seconds=time.perf_counter() - t0, ptxas=ptxas)

    dtypes = cycle_dtypes([INT64, FLOAT64, INT32, FLOAT32, INT16, INT8,
                           BOOL8], 212)
    layout = compute_row_layout(dtypes)
    rs = layout.fixed_row_size
    wd = row_mxu._data_words(layout)
    w = row_mxu._inverse_plan(layout)[0].num_words
    check((rs, wd, w) == (1008, 214, 221), f"layout {(rs, wd, w)}")
    errs = dict.fromkeys(kernels.launches, 0)
    # launches of each kernel on its paths, summed over them
    path_launches = dict.fromkeys(kernels.launches, 0)

    def add_launches(counts):
        for name, v in counts.items():
            path_launches[name] += v

    # -- the row-conversion path, 1M rows: encode then decode
    table = random_table(dtypes, N_1M, seed=0, null_probability=0.25)
    torch.cuda.synchronize()
    kernels.reset_launches()
    batches = convert_to_rows(table)
    decoded = convert_from_rows(batches[0], dtypes)
    torch.cuda.synchronize()
    main_launches = dict(kernels.launches)
    check(main_launches["grouped_encode"] > 0
          and main_launches["decode_planes"] > 0,
          f"a kernel of the row-conversion path never launched: "
          f"{main_launches}")
    add_launches(main_launches)

    blob = batches[0].data
    check(len(batches) == 1 and tuple(blob.shape) == (N_1M, rs),
          f"encode gave {[tuple(b.data.shape) for b in batches]}")
    gc = row_mxu.table_to_grouped(table, layout)
    plain = kernels.grouped_encode_plain(gc.planes, gc.vmask, layout, 0, N_1M)
    errs["grouped_encode"] = max(errs["grouped_encode"],
                                 max_abs_err(blob, plain))
    check(torch.equal(blob, plain), "encode kernel != plain version")
    del plain
    oracle = convert_to_rows_fixed_width_optimized(table)[0].data
    check(torch.equal(blob, oracle), "encode kernel != gather oracle")
    del oracle
    wmap = kernels.encode_word_map(layout)
    emit(phase="encode_1m", rows=N_1M, row_size=rs, batches=len(batches),
         launches=main_launches["grouped_encode"], equal_plain=True,
         equal_oracle=True,
         word_map={"whole": int((wmap >= 0).sum()),
                   "zero": int((wmap == -1).sum()),
                   "mixed": int((wmap == -2).sum())})

    planes_k, vmask_k = kernels.decode_planes(blob, layout)
    planes_p, vmask_p = kernels.decode_planes_plain(blob, layout)
    errs["decode_planes"] = max(max_abs_err(planes_k, planes_p),
                                max_abs_err(vmask_k, vmask_p))
    check(torch.equal(planes_k, planes_p) and torch.equal(vmask_k, vmask_p),
          "decode kernel != plain version")
    check(torch.equal(vmask_k, gc.vmask), "decoded masks != input masks")
    del planes_p, vmask_p
    assert_tables_equivalent(table, decoded, check_nulls=False)
    emit(phase="decode_1m", rows=N_1M,
         launches=main_launches["decode_planes"], equal_plain=True,
         roundtrip_bit_exact=True)

    # -- grouped forms: decode to the backing, encode straight back
    g = convert_from_rows_grouped(batches[0], dtypes)
    check(torch.equal(g.planes[:wd], gc.planes), "grouped planes != pack")
    again = convert_to_rows_grouped(g)
    check(len(again) == 1 and torch.equal(again[0].data, blob),
          "grouped round trip changed the rows")
    emit(phase="grouped_1m", rows=N_1M, bytes_identical=True)
    del g, again, decoded, planes_k, vmask_k

    # -- timing at 1M rows (kernel, plain version, copy anchor)
    enc_bytes = 4 * wd * N_1M + gc.vmask.numel() + N_1M * rs
    dec_bytes = N_1M * rs + 4 * w * N_1M + gc.vmask.numel()
    timing = {}
    for name, fn, plain_fn, nbytes in (
            ("grouped_encode",
             lambda: kernels.grouped_encode(gc.planes, gc.vmask, layout, 0,
                                            N_1M),
             lambda: kernels.grouped_encode_plain(gc.planes, gc.vmask,
                                                  layout, 0, N_1M),
             enc_bytes),
            ("decode_planes",
             lambda: kernels.decode_planes(blob, layout),
             lambda: kernels.decode_planes_plain(blob, layout),
             dec_bytes)):
        timing[name] = {
            "rows": N_1M, "ms": median_ms(fn),
            "plain_ms": median_ms(plain_fn, runs=10),
            "copy_ms": copy_ms(nbytes), "bytes": nbytes,
            "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}
    # the entry points around the kernels: the pack into the backing, and
    # the per-column extraction after the decode
    end_to_end = {
        "table_to_grouped_ms": median_ms(
            lambda: row_mxu.table_to_grouped(table, layout), runs=10),
        "convert_to_rows_ms": median_ms(lambda: convert_to_rows(table),
                                        runs=10),
        "convert_from_rows_ms": median_ms(
            lambda: convert_from_rows(batches[0], dtypes), runs=10)}
    add_launches(phase_pallas_rows_1m(table, dtypes, blob, errs, timing))
    add_launches(phase_row_kernels_1m(table, dtypes, blob, errs, timing))
    phase_xla_rows_1m(table, dtypes, blob, timing)
    del table, batches, blob, gc

    # -- 4M rows: two batches under the grouped policy, each kernel against
    # its plain version at the batch's start and size, round trip exact
    table = random_table(dtypes, N_4M, seed=1, null_probability=0.25)
    batches = convert_to_rows(table)
    sizes = [b.num_rows for b in batches]
    check(sizes == [2_000_896, 1_999_104], f"4M batches {sizes}")
    check(all(b.data.numel() <= (1 << 31) - 1 for b in batches),
          "a batch exceeds 2^31 - 1 bytes")
    gc = row_mxu.table_to_grouped(table, layout)
    start = 0
    for b in batches:
        plain = kernels.grouped_encode_plain(gc.planes, gc.vmask, layout,
                                             start, b.num_rows)
        errs["grouped_encode"] = max(errs["grouped_encode"],
                                     max_abs_err(b.data, plain))
        check(torch.equal(b.data, plain), f"4M encode kernel != plain "
                                          f"version at start {start}")
        del plain
        pk, vk = kernels.decode_planes(b.data, layout)
        pp, vp = kernels.decode_planes_plain(b.data, layout)
        errs["decode_planes"] = max(errs["decode_planes"],
                                    max_abs_err(pk, pp), max_abs_err(vk, vp))
        check(torch.equal(pk, pp) and torch.equal(vk, vp),
              f"4M decode kernel != plain version at start {start}")
        vbytes0 = start // 8
        check(torch.equal(vk, gc.vmask[:, vbytes0:vbytes0 + vk.shape[1]]),
              f"4M decoded masks != input masks at start {start}")
        del pk, vk, pp, vp
        part = convert_from_rows(b, dtypes)
        assert_tables_equivalent(slice_table(table, start, start + b.num_rows),
                                 part, check_nulls=False)
        start += b.num_rows
        del part
    emit(phase="multibatch_4m", rows=N_4M, batch_rows=sizes,
         batch_bytes=[b.data.numel() for b in batches], equal_plain=True,
         roundtrip_bit_exact=True)
    add_launches(phase_pallas_rows_4m(table, dtypes, gc, errs))
    add_launches(phase_row_kernels_4m(table, dtypes, gc, errs))
    del gc

    # -- the hash and bloom paths, and the grouped query over path 1
    add_launches(phase_hash_partition(table, batches, dtypes, errs, timing))
    del table
    add_launches(phase_query_grouped(batches, dtypes, timing))
    del batches, b
    torch.cuda.empty_cache()
    add_launches(phase_hash_keys(errs, timing))
    torch.cuda.empty_cache()
    add_launches(phase_hash_strings(errs, timing))
    torch.cuda.empty_cache()
    add_launches(phase_bloom_probe(errs, timing))
    torch.cuda.empty_cache()
    for name in ("murmur3_cols", "xxhash64_cols", "bloom_might_contain"):
        check(path_launches[name] > 0,
              f"{name} never launched on its paths: {path_launches}")

    # -- dense-padded strings, then the two-stage encode above the cap
    add_launches(phase_strings_1m(errs, timing))
    torch.cuda.empty_cache()
    add_launches(phase_strings_2m(errs))
    torch.cuda.empty_cache()
    add_launches(phase_arrow_strings_1m(errs, timing))
    torch.cuda.empty_cache()
    phase_compact_edges(errs)
    torch.cuda.empty_cache()
    for name in ("compact_encode", "string_gather"):
        check(path_launches[name] > 0,
              f"{name} never launched on its path: {path_launches}")
    add_launches(phase_pack_planes_6m(dtypes, errs, timing))
    torch.cuda.empty_cache()
    check(path_launches["pack_planes"] > 0,
          f"pack_planes never launched on its path: {path_launches}")

    # -- get_json_object over event logs and compact documents
    add_launches(phase_get_json_1m(errs, timing))
    torch.cuda.empty_cache()
    add_launches(phase_get_json_4m_compact(errs, timing))
    torch.cuda.empty_cache()
    phase_gjo_quiet_edges(errs)
    check(path_launches["gjo_scan"] > 0,
          f"gjo_scan never launched on its path: {path_launches}")

    # -- the serving runtime: rows/unrows ticks through K4 and K5
    add_launches(phase_serve_rows(errs, timing))
    torch.cuda.empty_cache()
    for name in ("planes_to_rows", "rows_to_planes"):
        check(path_launches[name] > 0,
              f"{name} never launched on its paths: {path_launches}")

    # -- the query operators: the flagship step at SF10, the q72/q95 joins,
    # the aggregate's edges card against CPU, and the serve agg/join ops
    timing["flagship_q6_sf10"] = phase_flagship_q6()
    torch.cuda.empty_cache()
    timing["joins_4m"] = phase_joins()
    torch.cuda.empty_cache()
    phase_agg_edges()
    phase_serve_query()
    torch.cuda.empty_cache()

    # -- the casts and the decimal arithmetic, card against CPU
    timing["casts_1m"] = phase_casts_1m(kernels)
    torch.cuda.empty_cache()
    timing["to_string_1m"] = phase_to_string_1m(kernels)
    torch.cuda.empty_cache()
    timing["decimal_arith_1m"] = phase_decimal_arith_1m(kernels)
    torch.cuda.empty_cache()
    phase_cast_edges(kernels)

    # -- decimal128 through every fixed-width engine
    add_launches(phase_decimal128_rows_1m(errs))
    torch.cuda.empty_cache()
    for name in ("to_rows_cols", "from_rows_cols"):
        check(path_launches[name] > 0,
              f"{name} never launched on its paths: {path_launches}")

    # -- 64-bit offsets: random planes of N_WIDE rows, so that the index of
    # the last data plane's words (read by the encode) and of the last
    # decoded plane's words (written by the decode) pass 2^31 elements, and
    # the blob passes 2^31 bytes; each kernel against its plain version
    reset_peak()
    gen = torch.Generator(device=CARD)
    gen.manual_seed(2)
    planes = torch.randint(0, 256, (wd, 4 * N_WIDE), dtype=torch.uint8,
                           device=CARD, generator=gen).view(torch.int32)
    vmask = torch.randint(0, 256, (layout.num_columns, N_WIDE // 8),
                          dtype=torch.uint8, device=CARD, generator=gen)
    read_max = (wd - 1) * N_WIDE + N_WIDE - 1
    written_max = (w - 1) * N_WIDE + N_WIDE - 1
    check(min(read_max, written_max, N_WIDE * rs) > (1 << 31),
          "the wide phase does not pass 2^31")
    rows_k = kernels.grouped_encode(planes, vmask, layout, 0, N_WIDE)
    plain = kernels.grouped_encode_plain(planes, vmask, layout, 0, N_WIDE)
    errs["grouped_encode"] = max(errs["grouped_encode"],
                                 max_abs_err(rows_k, plain))
    check(torch.equal(rows_k, plain), "wide encode kernel != plain version")
    del plain
    # K4 over these planes (rows of 856 bytes) and K5 over the encoded
    # rows: 8.8 and 10.3 GB each way, element offsets past 2^31
    _hold_transposes(planes, rows_k, errs, f"{N_WIDE} rows")
    half = N_WIDE // 2 + 3
    err = max_abs_err(kernels.planes_to_rows(planes, half, N_WIDE - half),
                      kernels.planes_to_rows_plain(planes, half,
                                                   N_WIDE - half))
    errs["planes_to_rows"] = max(errs["planes_to_rows"], err)
    check(err == 0, "wide windowed planes_to_rows kernel != plain version")
    del planes
    pk, vk = kernels.decode_planes(rows_k, layout)
    pp, vp = kernels.decode_planes_plain(rows_k, layout)
    errs["decode_planes"] = max(errs["decode_planes"], max_abs_err(pk, pp),
                                max_abs_err(vk, vp))
    check(torch.equal(pk, pp) and torch.equal(vk, vp),
          "wide decode kernel != plain version")
    check(torch.equal(vk, vmask), "wide decoded masks != input masks")
    emit(phase="offsets_64bit", rows=N_WIDE, max_plane_index_read=read_max,
         max_plane_index_written=written_max, blob_bytes=N_WIDE * rs,
         transposed_bytes={"planes_to_rows": 4 * wd * N_WIDE,
                           "rows_to_planes": N_WIDE * rs},
         equal_plain=True,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    del rows_k, pk, vk, pp, vp, vmask
    torch.cuda.empty_cache()
    phase_hash_offsets_64bit(errs)
    torch.cuda.empty_cache()
    phase_gjo_offsets_64bit(errs)
    torch.cuda.empty_cache()

    # -- edges: every fixed type, odd sizes, all null patterns, odd starts
    # and a padded row stride, each kernel against its plain version
    all_fixed = [INT64, FLOAT64, UINT64, INT32, UINT32, FLOAT32, INT16,
                 UINT16, INT8, UINT8, BOOL8, decimal32(2), decimal64(-1)]
    elayout = compute_row_layout(all_fixed)
    cases = 0
    for n in (1, 31, 6 * 1024 + 557):
        for nulls in (None, 0.0, 1.0, 0.25):
            t = random_table(all_fixed, n, seed=n, null_probability=nulls)
            eg = row_mxu.table_to_grouped(t, elayout)
            for s in sorted({0, min(3, n - 1), n // 2}):
                k = kernels.grouped_encode(eg.planes, eg.vmask, elayout, s,
                                           n - s)
                p = kernels.grouped_encode_plain(eg.planes, eg.vmask,
                                                 elayout, s, n - s)
                errs["grouped_encode"] = max(errs["grouped_encode"],
                                             max_abs_err(k, p))
                check(torch.equal(k, p), f"encode n={n} nulls={nulls} "
                                         f"start={s}")
                cases += 1
            rows = kernels.grouped_encode(eg.planes, eg.vmask, elayout, 0, n)
            wide = torch.zeros((n, elayout.fixed_row_size + 24),
                               dtype=torch.uint8, device=CARD)
            wide[:, :elayout.fixed_row_size] = rows
            for r2d in (rows, wide):
                pk, vk = kernels.decode_planes(r2d, elayout)
                pp, vp = kernels.decode_planes_plain(r2d, elayout)
                errs["decode_planes"] = max(errs["decode_planes"],
                                            max_abs_err(pk, pp),
                                            max_abs_err(vk, vp))
                check(torch.equal(pk, pp) and torch.equal(vk, vp),
                      f"decode n={n} nulls={nulls} stride={r2d.shape[1]}")
                cases += 1
            back = row_mxu.GroupedColumns(pk, vk, elayout).to_table()
            assert_tables_equivalent(t, back, check_nulls=False)
    emit(phase="edges", cases=cases, max_abs_err=errs)
    phase_hash_edges(errs)
    phase_pack_edges(errs)
    torch.cuda.empty_cache()
    phase_row_kernels_edges(dtypes, errs)

    for name, _ in KERNELS:
        timing[name]["launches"] = path_launches[name]
    reset_peak()
    emit(phase="timing", runs=TIMED_RUNS, **timing, **end_to_end,
         peak_memory_bytes=_PEAKS[0], seconds=time.perf_counter() - t_start)
    kernel_lines = []
    for name, replaces in KERNELS:
        tm = timing[name]
        kernel_lines.append({
            "name": name, "route": "cuda",
            "source": ("spark_rapids_jni_tpu_torch/csrc/"
                       + kernels.SOURCES[name]),
            "replaces": replaces,
            "tpu_counterpart": not replaces.startswith("none"),
            "launches": path_launches[name],
            "max_abs_err": errs[name], "ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            "bound_by": tm["bound_by"], "library_ms": tm.get("library_ms")})
    print(smi, flush=True)
    emit(kernels=kernel_lines)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})


if __name__ == "__main__":
    main()
