"""PyTorch port, the plans that steer the hash kernels, on the CPU.

``hash_kernels._bloom_route`` picks K8's route from a filter's size, and
``hash_kernels._stage_plan`` fixes how K6 and K7 stage tiles of rows in
shared memory (``csrc/hash_stage.cuh``).  Both are Python, so they are held
here without a card.  A torch replay stages each tile group by group as the
kernels do, in a stage filled with a poison byte: the aligned 16-byte chunks
that hold a part, at the part's region in the stage, and for K6's strings
only the chunks under each valid row's length, in the consumer warps' slots
of an odd number of chunks.  Hashed in the plan's order from the stage, it gives
``xxhash64_cols_plain``'s and ``murmur3_cols_plain``'s bits.
"""

import dataclasses
import functools

import pytest
import torch

from spark_rapids_jni_tpu_torch import (
    BOOL8, DATE32, FLOAT32, FLOAT64, INT8, INT16, INT32, INT64, TIMESTAMP64,
    UINT8, UINT16, UINT32, UINT64, Column, decimal32, decimal64,
)
from spark_rapids_jni_tpu_torch.ops import hash_kernels as hk
from spark_rapids_jni_tpu_torch.table import (
    Table, slice_table, slice_table_dynamic,
)
from spark_rapids_jni_tpu_torch.utils import (
    cycle_dtypes, random_table, strings_with_lengths,
)

HASH_FIXED = [INT64, FLOAT64, UINT64, INT32, UINT32, FLOAT32, INT16, UINT16,
              INT8, UINT8, BOOL8, decimal32(2), decimal64(-1), DATE32,
              TIMESTAMP64]
# Spark's runtime filter: the default (8,388,608 bits), the maximum
# (67,108,864 bits) and SparkBloomFilter.optimal(100_000)'s 729,856 bits
SPARK_DEFAULT_WORDS, SPARK_MAX_WORDS, OPTIMAL_100K_WORDS = (
    131_072, 1_048_576, 11_404)
# the most dynamic shared memory a block of an H100 takes
H100_SMEM_BYTES = 232_448
MM3 = hk._STAGING["murmur3_cols"]
XX = hk._STAGING["xxhash64_cols"]
# what the replay's stage holds before anything is copied in
POISON = 0xA5


# ---------------------------------------------------------------------------
# K8: _bloom_route
# ---------------------------------------------------------------------------

def _check_route(num_words):
    route = hk._bloom_route(num_words)
    assert route in hk._bloom_routes(num_words)
    if route == hk._BLOOM_BLOCK:
        # the whole bitset, and the block's mbarrier, in its shared memory
        assert num_words <= hk._BLOOM_BLOCK_WORDS
        assert 8 * num_words + 16 <= H100_SMEM_BYTES
    else:
        assert route == hk._BLOOM_L2
        assert num_words > hk._BLOOM_BLOCK_WORDS
    return route


def test_bloom_route_one_word_and_spark_filters():
    assert _check_route(1) == hk._BLOOM_BLOCK
    assert _check_route(OPTIMAL_100K_WORDS) == hk._BLOOM_BLOCK
    assert _check_route(SPARK_DEFAULT_WORDS) == hk._BLOOM_L2
    assert _check_route(SPARK_MAX_WORDS) == hk._BLOOM_L2
    # a filter of 2^31 + 64 bits
    assert _check_route((1 << 25) + 1) == hk._BLOOM_L2


def test_bloom_route_threshold():
    """The largest filter the block route takes, and one word more."""
    S = hk._BLOOM_BLOCK_WORDS
    assert _check_route(S) == hk._BLOOM_BLOCK
    assert hk._bloom_routes(S) == [hk._BLOOM_L2, hk._BLOOM_BLOCK]
    assert _check_route(S + 1) == hk._BLOOM_L2
    assert hk._bloom_routes(S + 1) == [hk._BLOOM_L2]


def test_bloom_route_over_filter_sizes():
    for num_words in sorted({1, 2, 63, 64, 65, 1000, 8191, 8192, 8193,
                             *range(16_000, 16_500, 37), 20_000, 131_072,
                             1_048_576}):
        _check_route(num_words)


# ---------------------------------------------------------------------------
# K6 and K7: _stage_plan
# ---------------------------------------------------------------------------

def _block_bytes(col, rows):
    return sum(room for _, room in hk._stage_regions(col, rows).values())


def _staged(col, rows, staging, budget):
    """Whether a column stages at ``rows`` rows a tile."""
    return ((staging.stage_strings or not col.dtype.is_string)
            and _block_bytes(col, rows) <= budget)


def _check_plan(cols, plan, staging, budget=hk._STAGE_BUDGET):
    R = plan.tile_rows
    assert R % 128 == 0 and plan.rows_per_thread in (1, 2)
    assert R // plan.rows_per_thread <= 512           # consumer threads
    strings = any(c.dtype.is_string and (s is not None
                                         or not staging.stage_strings)
                  for c, s in zip(cols, plan.slots))
    assert (R, plan.rows_per_thread) == (
        staging.strings if strings else staging.fixed)
    assert plan.stage_bytes % 16 == 0 and plan.stage_bytes <= budget
    assert 128 + hk._STAGES * plan.stage_bytes <= H100_SMEM_BYTES
    # every column once, in chain order, no group across a launch
    assert plan.groups[0][0] == 0 and plan.groups[-1][1] == len(cols)
    for (a, b), (c, _) in zip(plan.groups, plan.groups[1:]):
        assert a < b == c
    for a, b in plan.groups:
        assert a // hk.MAX_HASH_COLS == (b - 1) // hk.MAX_HASH_COLS
    assert len(plan.slots) == len(cols)
    for a, b in plan.groups:
        used = 0
        for i in range(a, b):
            # read in place exactly where it does not stage
            assert (plan.slots[i] is None) == (
                not _staged(cols[i], R, staging, budget))
            if plan.slots[i] is None:
                continue
            assert plan.slots[i] == used and used % 16 == 0
            used += _block_bytes(cols[i], R)
        assert used <= plan.stage_bytes
    fields = plan.stage_fields(0, len(cols))
    firsts = {a for a, _ in plan.groups}
    for i, f in enumerate(fields):
        assert bool(f & hk._GROUP_START) == (i in firsts)
        slot = f & (hk._GROUP_START - 1)
        assert slot == (0 if plan.slots[i] is None
                        else plan.slots[i] // 16 + 1)


def _strings(n, widths, seed=0, nulls=0.25):
    """One string column per width W, lengths cycling through 0..W."""
    return [strings_with_lengths(
        (torch.arange(n) * 7 % (W + 1)).to(torch.int32), W, seed=seed + W,
        null_probability=nulls) for W in widths]


def test_xx_plan_fixed_keys():
    """8 INT64 keys with masks: tiles of 1024 rows, 8,352 bytes a key, so
    three keys a 32 KiB stage."""
    t = random_table([INT64] * 8, 300, seed=1, null_probability=0.25,
                     device="cpu")
    plan = hk._stage_plan(t.columns, XX)
    _check_plan(t.columns, plan, XX)
    assert (plan.tile_rows, plan.rows_per_thread) == (1024, 2)
    assert plan.groups == ((0, 3), (3, 6), (6, 8))
    assert all(s is not None for s in plan.slots)
    assert plan.stage_bytes == 3 * (8 * 1024 + 16 + 1024 // 8 + 16)


def test_xx_plan_strings_over_the_limit_are_read():
    """Pitches 120 and 124 bytes with a mask: the first fits a 32 KiB stage
    at 256 rows a tile, the second is read from device memory."""
    n = 40
    cols = _strings(n, (120, 124)) + _strings(n, (36,))
    plan = hk._stage_plan(cols, XX)
    _check_plan(cols, plan, XX)
    assert (plan.tile_rows, plan.rows_per_thread) == (256, 1)
    assert plan.slots[0] is not None and plan.slots[1] is None
    assert plan.groups == ((0, 2), (2, 3))
    small = hk._stage_plan(cols, XX, budget=4096)
    _check_plan(cols, small, XX, budget=4096)
    assert small.slots == (None, None, None)


@pytest.mark.parametrize("ncols", [801, 1600])
def test_xx_plan_chains_past_max_columns(ncols):
    n = 16
    t = random_table(cycle_dtypes(HASH_FIXED, ncols - 2), n, seed=ncols,
                     null_probability=0.25, device="cpu")
    cols = list(t.columns[:700]) + _strings(n, (12, 200)) \
        + list(t.columns[700:])
    plan = hk._stage_plan(cols, XX)
    _check_plan(cols, plan, XX)
    starts = [a for a, _ in plan.groups]
    assert 800 in starts and plan.slots[701] is None


def _mm3_plan_case(case):
    """(columns, what K6's plan must give: tile rows, rows a thread,
    groups (None: only that a group starts at column 800), the columns
    read in place)."""
    n = 40
    if case == "int64_keys":
        cols = random_table([INT64] * 8, n, seed=1, device="cpu").columns
        return cols, (1024, 2, ((0, 3), (3, 6), (6, 8)), ())
    if case == "partition_keys":
        cols = random_table([INT32, INT16], n, seed=2,
                            device="cpu").columns
        return cols, (1024, 2, ((0, 2),), ())
    if case == "string_int64":
        cols = _strings(n, (64,)) + list(
            random_table([INT64], n, seed=3, device="cpu").columns)
        return cols, (256, 1, ((0, 2),), (0,))
    if case == "strings_only":
        cols = _strings(n, (0, 4, 120))
        return cols, (256, 1, ((0, 3),), (0, 1, 2))
    ncols = int(case.split("_")[1])
    t = random_table(cycle_dtypes(HASH_FIXED, ncols - 2), n, seed=ncols,
                     null_probability=0.25, device="cpu")
    cols = _strings(n, (12,)) + list(t.columns) + _strings(n, (200,))
    return cols, (256, 1, None, (0, ncols - 1))


@pytest.mark.parametrize("case", ["int64_keys", "partition_keys",
                                  "string_int64", "strings_only",
                                  "chain_801", "chain_1600"])
def test_mm3_plan(case):
    """K6's plan: 1,024-row tiles of two rows a thread over fixed-width
    chains, 256-row tiles of one a thread where there is a string, every
    string read in place, every fixed-width column staged, and chains past
    800 columns with a string in the first and the last launch."""
    cols, (rows, per_thread, groups, in_place) = _mm3_plan_case(case)
    plan = hk._stage_plan(cols, MM3)
    _check_plan(cols, plan, MM3)
    assert (plan.tile_rows, plan.rows_per_thread) == (rows, per_thread)
    if groups is None:
        assert hk.MAX_HASH_COLS in [a for a, _ in plan.groups]
    else:
        assert plan.groups == groups
    assert tuple(i for i, s in enumerate(plan.slots) if s is None) \
        == in_place
    # K6 staged as K7 stages: the same groups over fixed-width columns
    if not any(c.dtype.is_string for c in cols):
        assert plan == hk._stage_plan(cols, XX)


# ---------------------------------------------------------------------------
# The replay: stage each tile as K6 or K7 does, hash it in the plan's order
# ---------------------------------------------------------------------------

def _raw(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes, uint8 [nbytes], in place."""
    return t.reshape(-1).view(torch.uint8)


class _Stage:
    """One stage of the ring: the bytes a group's bulk copies fill, poison
    where nothing was copied."""

    def __init__(self, nbytes):
        self.bytes = torch.full((nbytes,), POISON, dtype=torch.uint8)
        self.owner = torch.full((nbytes,), -1, dtype=torch.int64)

    def copy(self, col_index, region, src: torch.Tensor, start, length):
        """A part of ``length`` bytes from ``src``'s byte ``start``: the
        aligned 16-byte chunks holding it land at ``region`` (offset, room)
        and the part at its offset in its first chunk; returns that
        offset."""
        off, room = region
        addr = src.data_ptr() + start
        chunks = ((addr + length + 15) & ~15) - (addr & ~15)
        assert chunks <= room, (chunks, room)
        lead = off + (addr & 15)
        assert bool((self.owner[off:off + room] == -1).all()), \
            "two parts share stage bytes"
        self.owner[off:off + room] = col_index
        self.bytes[lead:lead + length] = _raw(src)[start:start + length]
        return lead


def _staged_tile(col, i, regions, stage, slot, r0, m):
    """Tile rows [r0, r0 + m) of ``col`` as the consumers read them from
    its block at ``slot`` in ``stage``."""
    def part(name, src, start, length):
        off, room = regions[name]
        return stage.copy(i, (slot + off, room), src, start, length)

    validity = None
    if col.validity is not None:
        at = part("mask", col.validity, r0 // 8, (m + 7) // 8)
        validity = stage.bytes[at:at + (m + 7) // 8].clone()
    if col.dtype.is_string:
        at = part("lens", col.lens, 4 * r0, 4 * m)
        lens = stage.bytes[at:at + 4 * m].clone().view(torch.int32)
        pitch = hk._string_pitch(col)
        W = col.chars2d.shape[1]
        chars = torch.zeros((m, W), dtype=torch.uint8)
        if pitch:
            src = torch.as_strided(col.chars2d, (col.num_rows * pitch,),
                                   (1,))
            at = part("chars", src, r0 * pitch, m * pitch)
            chars = stage.bytes[at:at + m * pitch].reshape(m, pitch)[:, :W]
        return Column.padded_strings(chars.clone(), lens, validity)
    sz = col.dtype.itemsize
    at = part("values", col.data, r0 * sz, m * sz)
    data = stage.bytes[at:at + m * sz].clone().view(col.data.dtype)
    return Column(col.dtype, data, validity)


def _rows(col, r0, m):
    """Rows [r0, r0 + m) of a column read in place (r0 a multiple of 8)."""
    return slice_table_dynamic(Table((col,)), r0, m).columns[0]


# each kernel's running hashes of m rows from a seed, its step over one
# column's fields, and its output
_CHAINS = {
    "xxhash64_cols": (
        lambda m, seed: (torch.zeros(m, dtype=torch.int64),
                         torch.full((m,), seed & hk.M32, dtype=torch.int64)),
        hk._xx_field, hk._xx_long),
    "murmur3_cols": (
        lambda m, seed: torch.full((m,), seed & hk.M32, dtype=torch.int64),
        hk._mm3_field, hk._mm3_int),
}


def _replay(name, cols, seed, plan):
    """Kernel ``name``'s order over ``cols``: tile by tile; in each, group by
    group, each staged column from its stage, the rest in place."""
    start, step, output = _CHAINS[name]
    n, R = cols[0].num_rows, plan.tile_rows
    out = []
    for r0 in range(0, n, R):
        m = min(R, n - r0)
        h = start(m, seed)
        for a, b in plan.groups:
            stage = _Stage(plan.stage_bytes)
            for i in range(a, b):
                col = cols[i]
                if plan.slots[i] is None:
                    tile = _rows(col, r0, m)
                else:
                    tile = _staged_tile(col, i, hk._stage_regions(col, R),
                                        stage, plan.slots[i], r0, m)
                h = step(tile, h)
        out.append(output(h))
    return torch.cat(out)


@functools.lru_cache(maxsize=1)
def _replay_cases():
    # tiles of 1024 rows for fixed-width chains: two of them; of 256 rows
    # with a staged string: three
    n, m = 1100, 600
    t = random_table(HASH_FIXED, n, seed=3, null_probability=0.25,
                     device="cpu")
    strings = _strings(m, (0, 4, 12, 36, 68), seed=5)
    bare = random_table([INT64, INT8, INT16], m, seed=4,
                        null_probability=None, device="cpu").columns
    short = slice_table(t, 0, m).columns
    # views at odd element offsets: values, lengths and chars that start
    # inside a 16-byte chunk (masks repacked); masks that start inside one
    odd = slice_table(Table(tuple(short[:10]) + tuple(strings)), 3,
                      m).columns
    shifted = slice_table_dynamic(Table(t.columns[8:11]), 8, n - 8).columns
    return {
        "fixed": list(t.columns),
        "strings": strings + [short[0]],
        "mixed": [strings[4], *short[:6], strings[2], bare[1], *bare],
        "odd_offsets": list(odd),
        "shifted_masks": list(shifted),
    }


@pytest.mark.parametrize("budget", [hk._STAGE_BUDGET, 4096, 2400])
@pytest.mark.parametrize("case", sorted(_replay_cases()))
def test_replay_of_the_plan_equals_the_plain_version(case, budget):
    """K7: small budgets give many groups and strings read in place."""
    cols = _replay_cases()[case]
    plan = hk._stage_plan(cols, XX, budget=budget)
    _check_plan(cols, plan, XX, budget)
    for seed in (42, 7):
        assert torch.equal(_replay("xxhash64_cols", cols, seed, plan),
                           hk.xxhash64_cols_plain(cols, seed)), (case, seed)


def test_odd_offset_views_start_inside_a_chunk():
    """The replay's views do exercise the misaligned copies."""
    cols = _replay_cases()["odd_offsets"]
    assert any(c.data.data_ptr() % 16 for c in cols
               if not c.dtype.is_string)
    assert any(c.lens.data_ptr() % 16 for c in cols if c.dtype.is_string)
    shifted = _replay_cases()["shifted_masks"]
    assert all(c.validity.data_ptr() % 16 for c in shifted)


# K6's string widths: every length 0..W, 120 past K7's staging limit
MM3_WIDTHS = (0, 4, 12, 36, 68, 120)


@functools.lru_cache(maxsize=1)
def _mm3_replay_cases():
    strings_rows, fixed_rows = MM3.strings[0], MM3.fixed[0]
    n = 2 * strings_rows + 88
    t = random_table(HASH_FIXED, n, seed=6, null_probability=0.25,
                     device="cpu")
    strings = _strings(n, MM3_WIDTHS, seed=7)
    whole = Table(tuple(strings) + tuple(t.columns[:4]))
    cases = {
        "lengths": list(strings) + [t.columns[0]],
        "all_null": _strings(300, (36, 68), seed=8, nulls=1.0) + list(
            random_table([INT64, INT16], 300, seed=8, null_probability=1.0,
                         device="cpu").columns),
        # chars, lengths and values that start inside a 16-byte chunk
        "odd_offsets": list(slice_table(whole, 3, n).columns),
        "fixed": list(random_table(HASH_FIXED, fixed_rows + 1, seed=9,
                                   device="cpu").columns),
    }
    for rows, label in ((strings_rows, "string"), (fixed_rows, "fixed")):
        for d in (-1, 1):
            fixed = list(random_table([INT64, INT32, FLOAT32], rows + d,
                                      seed=11 + d, device="cpu").columns)
            cols = (_strings(rows + d, (36, 64), seed=10 + d) + fixed[:1]
                    if label == "string" else fixed)
            cases[f"{label}_tile_rows_{'minus' if d < 0 else 'plus'}_1"] = \
                cols
    return cases


@pytest.mark.parametrize("route", ["in_place", "whole_tile"])
@pytest.mark.parametrize("budget", [hk._STAGE_BUDGET, 4096])
@pytest.mark.parametrize("case", sorted(_mm3_replay_cases()))
def test_mm3_replay_equals_the_plain_version(case, budget, route):
    """K6 by its plan (strings read in place) and by K7's staging (a
    string's whole tile staged where it fits), from stages that hold poison
    wherever no copy landed: the hash is murmur3_cols_plain's, whatever
    lies past a row's length.  Every length 0..W, all-null tiles, views at
    odd offsets and row counts one off the tiles."""
    cols = _mm3_replay_cases()[case]
    staging = MM3 if route == "in_place" else dataclasses.replace(
        MM3, stage_strings=True)
    plan = hk._stage_plan(cols, staging, budget=budget)
    _check_plan(cols, plan, staging, budget)
    if case == "odd_offsets":
        assert any(c.chars2d.data_ptr() % 16 for c in cols
                   if c.dtype.is_string)
    for seed in (42, 7):
        assert torch.equal(_replay("murmur3_cols", cols, seed, plan),
                           hk.murmur3_cols_plain(cols, seed)), (case, seed)
