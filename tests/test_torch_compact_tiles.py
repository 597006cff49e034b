"""PyTorch port, the tile plans of the compact encode and the string gather,
on the CPU.

``kernels.compact_encode_plan`` and ``kernels.string_gather_plan`` size the
stages of ``csrc/compact_encode.cu`` and ``csrc/string_gather.cu``, and
``_compact_tiles.encode_long_tiles`` / ``gather_long_tiles`` say which
tiles take the long-row route.  All are Python, so they are held here
without a card.
A torch replay walks each kernel's tiles as it does: the producer stages
each part as a bulk copy does, at its region in the stage plus its
address's offset in its first 16-byte chunk, in a stage filled with the
poison byte 0xA5 first (only the part's own bytes are written, so a read
outside them shows); the consumers build the output from the stage alone.
It must give ``compact_encode_plain``'s and ``string_gather_plain``'s
bytes.  No JAX here.
"""

import dataclasses

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu_torch import INT8, INT16, INT64, Column, Table
from spark_rapids_jni_tpu_torch.ops import kernels
from spark_rapids_jni_tpu_torch.ops import row_conversion as prc
from spark_rapids_jni_tpu_torch.ops.row_layout import compute_row_layout
from spark_rapids_jni_tpu_torch.table import pack_bools, slice_table
from spark_rapids_jni_tpu_torch.utils import (
    compact_encode_args, compact_gather_args, random_table,
)
from _compact_tiles import encode_long_tiles, gather_long_tiles

POISON = 0xA5
# the string axis at 1M rows with Arrow strings (PERF.md §4): 25 string
# columns of 0..32 bytes, fixed_end 820, one compact batch
AXIS_ROWS, AXIS_STRIDE, AXIS_COLS = 1_000_000, 824, 25
AXIS_BLOB, AXIS_CHARS = 1_223_467_944, 400_000_000
# a string past any stage's room
LONG_STRING = 100_000


# ---------------------------------------------------------------------------
# The plans
# ---------------------------------------------------------------------------

def _check_ring(plan, ring):
    blocks = ring[0]
    assert 1 <= plan.tile_rows <= kernels.TILE_MAX_ROWS
    assert plan.tile_rows % 8 == 0 or plan.tile_rows < 8
    assert 1 <= plan.consumer_warps <= kernels.TILE_MAX_WARPS
    assert 2 <= plan.stages == ring[1] <= kernels.TILE_MAX_STAGES
    assert plan.chars_bytes % 16 == 0 and plan.image_bytes % 16 == 0
    assert plan.smem_bytes <= kernels.BLOCK_SMEM_MAX
    assert blocks * (plan.smem_bytes + kernels.BLOCK_SMEM_RESERVED) <= \
        kernels.SM_SMEM_BYTES


def _encode_expected(plan, rows, ncols, row, chars):
    """Whether a stage of ``plan`` holds ``rows`` rows of the batch's mean
    sizes times the plan's margin."""
    margin = kernels._TILE_MARGIN
    return (plan.chars_bytes >= margin * rows * chars + 32 * ncols
            and plan.image_bytes >= margin * rows * row + 16)


@pytest.mark.parametrize("ring", [(1, 2), (1, 3), (2, 2), (2, 3)])
def test_encode_plan_at_the_string_axis(ring):
    plan = kernels.compact_encode_plan(AXIS_ROWS, AXIS_STRIDE, AXIS_COLS,
                                       AXIS_BLOB, AXIS_CHARS, ring=ring)
    _check_ring(plan, ring)
    row, chars = AXIS_BLOB / AXIS_ROWS, AXIS_CHARS / AXIS_ROWS
    assert _encode_expected(plan, plan.tile_rows, AXIS_COLS, row, chars)
    slot = kernels._encode_slot(plan.tile_rows, AXIS_COLS, AXIS_STRIDE,
                                plan.chars_bytes)
    assert slot["bytes"] == plan.slot_bytes
    # the most rows: 8 more do not fit the budget
    more = kernels.compact_encode_plan(
        AXIS_ROWS, AXIS_STRIDE, AXIS_COLS, AXIS_BLOB, AXIS_CHARS, ring=ring,
        tile_rows=plan.tile_rows + 8)
    assert not _encode_expected(more, plan.tile_rows + 8, AXIS_COLS, row,
                                chars)
    assert plan.tile_rows == {(1, 2): 48, (1, 3): 32, (2, 2): 24,
                              (2, 3): 16}[ring]


@pytest.mark.parametrize("ring", [(1, 2), (1, 3), (2, 3), (2, 4)])
def test_gather_plan_at_the_string_axis(ring):
    plan = kernels.string_gather_plan(AXIS_ROWS, AXIS_COLS, AXIS_BLOB,
                                      AXIS_CHARS, ring=ring)
    _check_ring(plan, ring)
    assert plan.image_bytes >= kernels._TILE_MARGIN * plan.tile_rows * (
        AXIS_CHARS / AXIS_ROWS)
    per_row = AXIS_CHARS / AXIS_ROWS + 16
    assert plan.chars_bytes >= kernels._TILE_MARGIN * plan.tile_rows * per_row
    slot = kernels._gather_slot(plan.tile_rows, AXIS_COLS, plan.chars_bytes)
    assert slot["bytes"] == plan.slot_bytes
    assert plan.tile_rows == {(1, 2): 112, (1, 3): 80, (2, 3): 40,
                              (2, 4): 24}[ring]


@pytest.mark.parametrize("ncols", [1, 25, 128])
@pytest.mark.parametrize("fixed_end", range(33, 46))
def test_plans_by_fixed_end_and_columns(fixed_end, ncols):
    """Rows of fixed_end 33 to 45 and 1, 25 or 128 string columns of 0..32
    bytes: a stage holds its tile's expected bytes, and the slot's parts
    lie in order, each inside the stage."""
    stride = -(-fixed_end // 8) * 8
    n = 100_000
    chars = 16 * ncols * n
    blob = n * (fixed_end + 16 * ncols + 4)
    for ring in ((1, 2), (2, 2)):
        plan = kernels.compact_encode_plan(n, stride, ncols, blob, chars,
                                           ring=ring)
        _check_ring(plan, ring)
        assert _encode_expected(plan, plan.tile_rows, ncols, blob / n,
                                chars / n)
        slot = kernels._encode_slot(plan.tile_rows, ncols, stride,
                                    plan.chars_bytes)
        assert (slot["rows"] < slot["cols"] < slot["fixed"] < slot["chars"]
                < slot["bytes"] == plan.slot_bytes)
        assert slot["col_room"] % 32 == 16
    plan = kernels.string_gather_plan(n, ncols, blob, chars)
    _check_ring(plan, kernels.GATHER_RING)
    slot = kernels._gather_slot(plan.tile_rows, ncols, plan.chars_bytes)
    assert slot["bases"] < slot["rows"] < slot["cols"] < slot["chars"]
    assert plan.chars_bytes >= kernels._TILE_MARGIN * plan.tile_rows * (
        chars / n + 16)


# ---------------------------------------------------------------------------
# The replays
# ---------------------------------------------------------------------------

def _u8(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).reshape(-1).numpy()


def _chunks(addr: int, length: int) -> int:
    """A bulk copy's bytes: the aligned 16-byte chunks of [addr, +length)."""
    return 0 if length <= 0 else (addr + length + 15) // 16 * 16 - addr // 16 * 16


def _stage(slot: np.ndarray, at: int, t: torch.Tensor, start: int,
           length: int, room: int) -> int:
    """Stage bytes [start, start + length) of ``t``'s storage as a bulk copy
    does at region ``at`` of ``room`` bytes; return the stage offset of the
    part's first byte."""
    addr = t.data_ptr() + start
    place = at + addr % 16
    assert _chunks(addr, length) <= room
    src = _u8(t)
    slot[place:place + length] = src[start:start + length]
    return place


def _i32(slot: np.ndarray, at: int, count: int) -> np.ndarray:
    return slot[at:at + 4 * count].view(np.int32).astype(np.int64)


def _encode_long_row(out, args, r):
    """The long-row route: row r from the inputs themselves."""
    fixed, fe, row_offsets, _, strings = args
    ro = row_offsets.numpy().astype(np.int64)
    size = int(ro[r + 1] - ro[r])
    row = np.empty(size, np.uint8)
    words = min((fe + 3) // 4, size // 4)
    row[:4 * words] = fixed[r].numpy()[:4 * words]
    pos = fe
    for chars, offsets, lo in strings:
        o0, o1 = int(offsets[r]), int(offsets[r + 1])
        ln = max(0, min(o1 - o0, size - pos))
        row[pos:pos + ln] = chars.numpy()[o0 - lo:o0 - lo + ln]
        pos += max(0, ln)
    row[max(min(pos, size), 4 * words):] = 0
    out[ro[r]:ro[r + 1]] = row


def _replay_encode(args, plan):
    """The compact encode by ``plan``, tile by tile as the kernel runs it,
    in numpy: (output, tiles on the long-row route)."""
    fixed, fe, row_offsets, total, strings = args
    n, stride = fixed.shape
    R, k = plan.tile_rows, len(strings)
    L = kernels._encode_slot(R, k, stride, plan.chars_bytes)
    assert L["bytes"] == plan.slot_bytes
    out = np.full(total, POISON, np.uint8)
    longs = encode_long_tiles(plan, fixed, row_offsets,
                                      strings).tolist()
    ro_all = row_offsets.numpy().astype(np.int64)
    for t, r0 in enumerate(range(0, n, R)):
        m = min(R, n - r0)
        ro0, ro1 = int(ro_all[r0]), int(ro_all[r0 + m])
        # the producer: each column's chars, chunks back to back
        spans = [(int(o[r0]) - lo, int(o[r0 + m]) - int(o[r0]))
                 for _, o, lo in strings]
        sizes = [_chunks(c.data_ptr() + a, ln)
                 for (c, _, _), (a, ln) in zip(strings, spans)]
        places = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
        fits = (places[-1] <= plan.chars_bytes
                and ro0 % 16 + ro1 - ro0 <= plan.image_bytes)
        assert longs[t] == (not fits)
        if not fits:
            for r in range(r0, r0 + m):
                _encode_long_row(out, args, r)
            continue
        slot = np.full(plan.slot_bytes, POISON, np.uint8)
        rows_at = _stage(slot, L["rows"], row_offsets, 4 * r0, 4 * (m + 1),
                         L["cols"] - L["rows"])
        fixed_at = _stage(slot, L["fixed"], fixed, r0 * stride, m * stride,
                          L["chars"] - L["fixed"])
        meta = []
        for c, ((chars, offsets, _), (a, ln)) in enumerate(zip(strings,
                                                              spans)):
            at = L["cols"] + c * L["col_room"]
            offs_at = _stage(slot, at, offsets, 4 * r0, 4 * (m + 1),
                             L["col_room"])
            chars_at = L["chars"] + places[c] + (chars.data_ptr() + a) % 16
            if ln > 0:
                chars_at = _stage(slot, L["chars"] + places[c], chars, a, ln,
                                  sizes[c])
            meta.append((chars_at, offs_at))
        # the consumers: rows into the image from the stage alone
        imis = ro0 % 16                 # the output is 16-byte aligned
        image = np.full(plan.image_bytes, POISON, np.uint8)
        ro = _i32(slot, rows_at, m + 1)
        for i in range(m):
            size = int(ro[i + 1] - ro[i])
            row = imis + int(ro[i] - ro[0])
            words = min((fe + 3) // 4, size // 4)
            image[row:row + 4 * words] = \
                slot[fixed_at + i * stride:fixed_at + i * stride + 4 * words]
            pos = fe
            for chars_at, offs_at in meta:
                of = _i32(slot, offs_at, m + 1)
                ln = int(of[i + 1] - of[i])
                put = max(0, min(ln, size - pos))
                src = chars_at + int(of[i] - of[0])
                image[row + pos:row + pos + put] = slot[src:src + put]
                pos += ln
            image[row + max(min(pos, size), 4 * words):row + size] = 0
        # the store: 16-byte words, an 8-byte word at the head or tail
        end = imis + ro1 - ro0
        assert imis in (0, 8) and end % 16 in (0, 8)
        assert end <= plan.image_bytes
        out[ro0:ro1] = image[imis:end]
    return out, sum(longs)


def _replay_gather(args, plan):
    """The string gather by ``plan``, tile by tile as the kernel runs it, in
    numpy: (each column's chars, tiles on the long-row route)."""
    blob, row_offsets, pairs, totals = args
    n, k, R = row_offsets.shape[0] - 1, len(pairs), plan.tile_rows
    L = kernels._gather_slot(R, k, plan.chars_bytes)
    assert L["bytes"] == plan.slot_bytes
    outs = [np.full(t, POISON, np.uint8) for t in totals]
    longs = gather_long_tiles(plan, blob, row_offsets,
                                      pairs).tolist()
    base = blob.data_ptr()
    blob_np = _u8(blob)
    for t, r0 in enumerate(range(0, n, R)):
        m = min(R, n - r0)
        slot = np.full(plan.slot_bytes, POISON, np.uint8)
        # stage A: row offsets, pairs and output offsets
        ro = _i32(slot, _stage(slot, L["rows"], row_offsets, 4 * r0,
                               4 * (m + 1), L["cols"] - L["rows"]), m + 1)
        cols = []
        for c, (off, _, out_off) in enumerate(pairs):
            at = L["cols"] + c * L["col_bytes"]
            o = _i32(slot, _stage(slot, at, off, 4 * r0, 4 * m,
                                  L["out_off"]), m)
            q = _i32(slot, _stage(slot, at + L["out_off"], out_off, 4 * r0,
                                  4 * (m + 1), L["col_bytes"] - L["out_off"]),
                     m + 1)
            cols.append((o, q))
        # stage B: each row's span, from the stage
        spans = []
        for i in range(m):
            live = [(int(o[i]), int(q[i + 1] - q[i])) for o, q in cols
                    if q[i + 1] > q[i]]
            if live:
                lo = min(x for x, _ in live)
                spans.append((int(ro[i]), lo,
                              max(x + ln for x, ln in live) - lo))
            else:
                spans.append((int(ro[i]), 0, 0))
        sizes = [_chunks(base + r + lo, ln) for r, lo, ln in spans]
        places = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
        parts = [(-(-(int(q[0]) % 16 + int(q[m] - q[0])) // 16) * 16
                  if q[m] > q[0] else 0) for _, q in cols]
        image_at = (np.concatenate([[0], np.cumsum(parts)])[:-1]
                    + [int(q[0]) % 16 for _, q in cols]).astype(int)
        fits = (places[-1] <= plan.chars_bytes
                and sum(parts) <= plan.image_bytes)
        assert longs[t] == (not fits)
        if not fits:
            for (o, q), dst in zip(cols, outs):
                for i in range(m):
                    s = int(ro[i] + o[i])
                    dst[q[i]:q[i + 1]] = blob_np[s:s + q[i + 1] - q[i]]
            continue
        bases = np.zeros(m, np.int64)
        for j, (r, lo, ln) in enumerate(spans):
            if ln > 0:
                at = _stage(slot, L["chars"] + places[j], blob, r + lo, ln,
                            sizes[j])
                bases[j] = at - lo
        # the consumers: each row's strings into the columns' parts of the
        # image, then each part to its output as 16-byte words (the outputs
        # 16-byte aligned, so an output offset's residue is its address's)
        image = np.full(plan.image_bytes, POISON, np.uint8)
        for (o, q), at in zip(cols, image_at):
            for i in range(m):
                ln = int(q[i + 1] - q[i])
                src = int(bases[i] + o[i])
                image[at + q[i] - q[0]:at + q[i + 1] - q[0]] = \
                    slot[src:src + ln]
        for (o, q), at, dst in zip(cols, image_at, outs):
            a, e = int(q[0]), int(q[m])
            img = at - a % 16
            for wa in range(a // 16 * 16, e, 16):
                lo, hi = max(a, wa), min(e, wa + 16)
                assert hi - lo == 16 or wa in (a // 16 * 16, (e - 1) // 16 * 16)
                dst[lo:hi] = image[img + lo - a // 16 * 16:img + hi - a // 16 * 16]
    return outs, sum(longs)


def _arrow(lens, seed, lead, nulls=0.25):
    """An Arrow string column of lengths ``lens`` whose chars start at
    ``lead``, on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    n = lens.shape[0]
    offsets = torch.full((n + 1,), lead, dtype=torch.int64)
    offsets[1:] += torch.cumsum(lens.to(torch.int64), 0)
    chars = torch.randint(0, 256, (int(offsets[-1]) + 5,), dtype=torch.uint8,
                          generator=gen)
    valid = pack_bools(torch.rand(n, generator=gen) >= nulls)
    return Column.arrow_strings(offsets.to(torch.int32), chars, valid)


def _table(n, k=3, seed=0, long_row=None):
    """Three Arrow columns of lengths 0..67 at odd char offsets, an INT64,
    an INT16 and k INT8 columns (fixed_end 35 + k), 25% nulls; with
    ``long_row``, that row of the first string holds LONG_STRING bytes."""
    fixed = random_table([INT64, INT16] + [INT8] * k, n, seed=seed,
                         device="cpu")
    strs = []
    for j in range(3):
        lens = (torch.arange(n) * (7 + j) + j + seed) % 68
        if j == 0 and long_row is not None:
            lens[long_row] = LONG_STRING
        strs.append(_arrow(lens, seed + j, 2 * j + 1))
    return Table((strs[0], fixed.columns[0], strs[1], *fixed.columns[1:],
                  strs[2]))


def _args(table):
    layout = compute_row_layout(table.dtypes)
    return prc._compact_batch_inputs(table, layout, 0, table.num_rows,
                                     *prc._compact_plan(table, layout))


def _gather_of(args):
    fixed, fe, row_offsets, _, strings = args
    blob = kernels.compact_encode_plain(*args)
    lens = torch.stack([o[1:] - o[:-1] for _, o, _ in strings], 1)
    return compact_gather_args(blob, row_offsets, fe, lens)


def _hold(args, encode_plan, gather_plan):
    """Both replays against the plain versions; the long tiles of each."""
    want = kernels.compact_encode_plain(*args).numpy()
    got, enc_long = _replay_encode(args, encode_plan)
    assert np.array_equal(got, want)
    gargs = _gather_of(args)
    outs, gat_long = _replay_gather(gargs, gather_plan)
    for a, b in zip(outs, kernels.string_gather_plain(*gargs)):
        assert np.array_equal(a, b.numpy())
    return enc_long, gat_long


def _plans(args, rows, ring=None, gring=None):
    return (kernels.encode_plan(args, tile_rows=rows, ring=ring),
            kernels.gather_plan(_gather_of(args), tile_rows=rows,
                                ring=gring))


@pytest.mark.parametrize("n", [7, 8, 9, 63])
@pytest.mark.parametrize("ring", [(1, 2), (2, 4)])
def test_replays_by_tile_size(n, ring):
    """Tiles of R - 1, R and R + 1 rows (R = 8), and several tiles, at
    lengths 0..67 at odd char offsets, on two rings."""
    args = _args(_table(n, k=n % 8, seed=n))
    enc, gat = _plans(args, 8, ring=ring, gring=ring)
    assert _hold(args, enc, gat) == (0, 0)


@pytest.mark.parametrize("start", [1, 7])
def test_replays_of_a_slice_from_an_odd_row(start):
    """Offsets and fixed sections at odd element offsets, the default
    plans (their tile rows from the batch's sizes)."""
    t = slice_table(_table(301, k=5, seed=3), start, 301)
    args = _args(t)
    plans = (kernels.encode_plan(args), kernels.gather_plan(_gather_of(args)))
    assert _hold(args, *plans) == (0, 0)


def test_replays_with_a_row_past_the_stage():
    """One row of LONG_STRING bytes between short rows: its tile, and only
    it, takes the long-row route in both kernels, mid-batch."""
    n, r = 40, 21
    args = _args(_table(n, k=2, seed=9, long_row=r))
    for rows in (8, 16):
        enc, gat = _plans(args, rows)
        long_tiles = encode_long_tiles(enc, args[0], args[2], args[4])
        assert long_tiles.nonzero().view(-1).tolist() == [r // rows]
        assert gather_long_tiles(
            gat, *_gather_of(args)[:3]).nonzero().view(-1).tolist() == \
            [r // rows]
        assert _hold(args, enc, gat) == (1, 1)


def test_replays_of_empty_and_null_columns():
    """An all-empty string column and an all-null one (zero lengths) beside
    a column with chars."""
    n = 37
    t = _table(n, k=1, seed=4)
    empty = _arrow(torch.zeros(n, dtype=torch.int64), 5, 3)
    nulls = _arrow(torch.zeros(n, dtype=torch.int64), 6, 0, nulls=1.0)
    t = Table((empty, *t.columns, nulls))
    args = _args(t)
    enc, gat = _plans(args, 8)
    assert _hold(args, enc, gat) == (0, 0)
    # no column with chars at all
    args = _args(Table((empty, t.columns[2], nulls)))
    assert kernels.compact_encode_plain(*args).numel() == 37 * 32
    enc, gat = _plans(args, 16)
    assert _hold(args, enc, gat) == (0, 0)


@pytest.mark.parametrize("k,n", [(33, 41), (128, 17)])
def test_replays_of_many_columns(k, n):
    """33 and 128 string columns (128 past what a JCUDF layout holds: the
    kernels take raw arguments), lengths 0..67, chars at every residue mod
    16: tiles of 8 rows on the roomiest ring, and the default plans, whose
    stages at 128 columns hold fewer than 8 rows."""
    gen = torch.Generator().manual_seed(k)
    lens = torch.randint(0, 68, (n, k), generator=gen)
    lens[3] = 0
    args = compact_encode_args(lens, 8 * k + (k + 7) // 8, seed=k)
    assert _hold(args, *_plans(args, 8, gring=(1, 2))) == (0, 0)
    plans = (kernels.encode_plan(args), kernels.gather_plan(_gather_of(args)))
    assert _hold(args, *plans) == (0, 0)
    assert (plans[1].tile_rows < 8) == (k == 128)


def test_tiny_stages_send_tiles_long():
    """A plan whose rooms hold less than a tile: every tile whose chars or
    output pass them takes the long-row route, and the rest the tile
    route, in one batch."""
    args = _args(_table(50, k=0, seed=2))
    enc = dataclasses.replace(kernels.encode_plan(args, tile_rows=8),
                              chars_bytes=352, image_bytes=880)
    slot = kernels._encode_slot(8, 3, args[0].shape[1], 352)
    enc = dataclasses.replace(enc, slot_bytes=slot["bytes"])
    gat = kernels.gather_plan(_gather_of(args), tile_rows=8)
    gslot = kernels._gather_slot(8, 3, 400)
    gat = dataclasses.replace(gat, chars_bytes=400, image_bytes=400,
                              slot_bytes=gslot["bytes"])
    enc_long, gat_long = _hold(args, enc, gat)
    assert 0 < enc_long < 7 and 0 < gat_long < 7
