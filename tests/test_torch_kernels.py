"""PyTorch port, the CUDA kernels against their plain versions.

The tests marked ``gpu`` need a CUDA card and skip without one.  This file
imports neither JAX nor the JAX package, so on a machine with a card and no
JAX it runs alone:

    python -m pytest --noconftest tests/test_torch_kernels.py -m gpu -q
"""

import dataclasses

import pytest
import torch

from spark_rapids_jni_tpu_torch import (
    BOOL8, DATE32, FLOAT32, FLOAT64, INT8, INT16, INT32, INT64, STRING,
    TIMESTAMP64, UINT8, UINT16, UINT32, UINT64, Column, Table, decimal32,
    decimal64, decimal128,
)
from spark_rapids_jni_tpu_torch.ops import get_json as gj
from spark_rapids_jni_tpu_torch.ops import hash_kernels as hk
from spark_rapids_jni_tpu_torch.ops import kernels, row_mxu
from spark_rapids_jni_tpu_torch.ops import row_conversion as prc
from spark_rapids_jni_tpu_torch.ops import row_kernels as prk
from spark_rapids_jni_tpu_torch.ops.row_layout import compute_row_layout
from spark_rapids_jni_tpu_torch.table import (
    assert_tables_equivalent, bits_view, pack_bools, slice_table,
    slice_table_dynamic, valid_bits,
)
from spark_rapids_jni_tpu_torch.utils import (
    compact_encode_args, compact_gather_args, cycle_dtypes, json_boundary_docs, json_event_docs, json_window,
    random_bitset, random_table, special_floats, strings_with_lengths,
)

from _compact_tiles import encode_long_tiles, gather_long_tiles

ALL_FIXED = [INT64, FLOAT64, UINT64, INT32, UINT32, FLOAT32, INT16, UINT16,
             INT8, UINT8, BOOL8, decimal32(2), decimal64(-1)]
WIDE = cycle_dtypes([INT64, FLOAT64, INT32, FLOAT32, INT16, INT8, BOOL8], 212)
SCHEMAS = {"all_fixed": ALL_FIXED, "wide212": WIDE, "one_int8": [INT8],
           "odd_int16": [INT16] * 3, "int64_pair": [INT64, INT64]}
HASH_FIXED = ALL_FIXED + [DATE32, TIMESTAMP64]
BLOOM_TYPES = [INT8, INT16, INT32, DATE32, INT64, TIMESTAMP64]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_pack_planes_plain_batches_on_cpu():
    """K3's plain version at any start is the whole table's planes sliced,
    and the two-stage encode gives K1's rows."""
    layout = compute_row_layout(ALL_FIXED)
    t = random_table(ALL_FIXED, 203, seed=5, null_probability=0.25,
                     device="cpu")
    full = kernels.pack_planes(t, layout, 0, 203)
    for start, size in ((1, 200), (13, 8), (202, 1), (9, 0)):
        assert torch.equal(kernels.pack_planes(t, layout, start, size),
                           full[:, start:start + size])
    gc = row_mxu.table_to_grouped(t, layout)
    assert torch.equal(row_mxu.to_rows_fixed(t, layout),
                       kernels.grouped_encode(gc.planes, gc.vmask, layout, 0,
                                              203))


def test_plain_versions_round_trip_on_cpu():
    """What the card's tests compare against: on the CPU both wrappers are
    their plain versions, and they invert each other."""
    layout = compute_row_layout(ALL_FIXED)
    t = random_table(ALL_FIXED, 203, seed=4, device="cpu")
    gc = row_mxu.table_to_grouped(t, layout)
    rows = kernels.grouped_encode(gc.planes, gc.vmask, layout, 0, 203)
    planes, vmask = kernels.decode_planes(rows, layout)
    wd = row_mxu._data_words(layout)
    assert torch.equal(planes[:wd], gc.planes)
    assert torch.equal(vmask, gc.vmask)


@pytest.mark.gpu
@pytest.mark.parametrize("schema", sorted(SCHEMAS))
@pytest.mark.parametrize("n", [1, 31, 1000, 6 * 1024 + 557])
def test_kernels_match_plain_versions(cuda, schema, n):
    dtypes = SCHEMAS[schema]
    layout = compute_row_layout(dtypes)
    for nulls in (None, 0.0, 1.0, 0.25):
        t = random_table(dtypes, n, seed=n, null_probability=nulls,
                         device=cuda)
        gc = row_mxu.table_to_grouped(t, layout)
        for start in sorted({0, 1, 7, 33, min(5, n - 1), n // 3}):
            if start >= n:
                continue
            k = kernels.grouped_encode(gc.planes, gc.vmask, layout, start,
                                       n - start)
            p = kernels.grouped_encode_plain(gc.planes, gc.vmask, layout,
                                             start, n - start)
            assert torch.equal(k, p), (nulls, start)
        rows = kernels.grouped_encode(gc.planes, gc.vmask, layout, 0, n)
        wide = torch.full((n, layout.fixed_row_size + 40), 0x5A,
                          dtype=torch.uint8, device=cuda)
        wide[:, :layout.fixed_row_size] = rows
        for r2d in (rows, wide):
            pk, vk = kernels.decode_planes(r2d, layout)
            pp, vp = kernels.decode_planes_plain(r2d, layout)
            assert torch.equal(pk, pp) and torch.equal(vk, vp), nulls
        offsets = torch.arange(n + 1, dtype=torch.int32,
                               device=cuda) * layout.fixed_row_size
        back = prc.convert_from_rows(prc.RowsColumn(rows, offsets), dtypes,
                                     device=cuda)
        assert_tables_equivalent(t, back, check_nulls=False)


@pytest.mark.gpu
@pytest.mark.parametrize("schema", ["wide212", "all_fixed", "odd_int16"])
def test_grouped_encode_into_an_8_byte_aligned_out(cuda, schema):
    """K1's C entry point writing a batch into a larger blob at an offset
    that is 8-byte but not 16-byte aligned (its 8-byte stores), at starts
    that are not multiples of 8; the bytes around the batch stay as they
    were."""
    dtypes = SCHEMAS[schema]
    layout = compute_row_layout(dtypes)
    rs = layout.fixed_row_size
    n = 1000
    t = random_table(dtypes, n, seed=9, null_probability=0.25, device=cuda)
    gc = row_mxu.table_to_grouped(t, layout)
    maps = kernels._device_map(kernels._encode_maps, layout, cuda)
    for start in (1, 7, 33):
        size = n - start
        blob = torch.full((size * rs + 64,), 0xA5, dtype=torch.uint8,
                          device=cuda)
        at = 24 - blob.data_ptr() % 16
        kernels.launch("grouped_encode", gc.planes.data_ptr(), n,
                       gc.vmask.data_ptr(), gc.vmask.shape[1],
                       maps.data_ptr(), row_mxu._data_words(layout),
                       layout.num_columns, layout.validity_bytes, rs, start,
                       size, blob.data_ptr() + at, cuda.index or 0,
                       kernels.stream_of(cuda))
        want = kernels.grouped_encode_plain(gc.planes, gc.vmask, layout,
                                            start, size)
        assert torch.equal(blob[at:at + size * rs].view(size, rs), want)
        assert bool((blob[:at] == 0xA5).all())
        assert bool((blob[at + size * rs:] == 0xA5).all())


@pytest.mark.gpu
def test_launches_count_kernel_runs_only(cuda):
    layout = compute_row_layout(ALL_FIXED)
    t = random_table(ALL_FIXED, 100, device=cuda)
    gc = row_mxu.table_to_grouped(t, layout)
    kernels.reset_launches()
    rows = kernels.grouped_encode(gc.planes, gc.vmask, layout, 0, 100)
    kernels.decode_planes(rows, layout)
    kernels.grouped_encode(gc.planes, gc.vmask, layout, 10, 0)
    kernels.grouped_encode_plain(gc.planes, gc.vmask, layout, 0, 100)
    kernels.decode_planes_plain(rows, layout)
    hk.murmur3_cols(t.columns, 42)
    hk.xxhash64_cols(t.columns, 42)
    words = random_bitset(4, 0.5, device=cuda)
    hk.bloom_might_contain(words, t.columns[0], 3)
    planes = kernels.pack_planes(t, layout, 3, 97)
    kernels.pack_planes(t, layout, 100, 0)
    assert torch.equal(planes, kernels.pack_planes_plain(t, layout, 3, 97))
    hk.murmur3_cols_plain(t.columns, 42)
    hk.xxhash64_cols_plain(t.columns, 42)
    hk.bloom_might_contain_plain(words, t.columns[0], 3)
    ch = json_window([b'{"a": 1}'] * 5, 12, device=cuda)
    assert torch.equal(gj.gjo_scan(ch, (b"a",), 1),
                       gj.gjo_scan_plain(ch, (b"a",), 1))
    assert gj.gjo_scan(ch[:0], (b"a",), 1).shape == (6, 0)
    rows4 = kernels.planes_to_rows(planes, 5, 90)
    assert torch.equal(rows4, kernels.planes_to_rows_plain(planes, 5, 90))
    assert torch.equal(kernels.rows_to_planes(rows4),
                       kernels.rows_to_planes_plain(rows4))
    rows10 = kernels.to_rows_cols(t, layout, 3, 97)
    assert torch.equal(rows10, kernels.to_rows_cols_plain(t, layout, 3, 97))
    got, want11 = (kernels.from_rows_cols(rows10, layout),
                   kernels.from_rows_cols_plain(rows10, layout))
    assert torch.equal(got[1], want11[1])
    assert all(torch.equal(bits_view(d), bits_view(p))
               for d, p in zip(got[0], want11[0]))
    st = Table((_arrow_column(torch.arange(100, device=cuda) % 9, 1, 3),
                t.columns[0]))
    slayout = compute_row_layout(st.dtypes)
    args = _compact_args(st, slayout)
    blob = kernels.compact_encode(*args)
    assert torch.equal(blob, kernels.compact_encode_plain(*args))
    gargs = _gather_args(blob, args[2], slayout)
    assert all(torch.equal(a, b) for a, b in zip(
        kernels.string_gather(*gargs), kernels.string_gather_plain(*gargs)))
    want = dict.fromkeys(kernels.launches, 1)
    want["decode_planes"] = 2       # one more in _gather_args
    assert kernels.launches == want
    empty = kernels.decode_planes(rows[:0], layout)
    assert empty[0].shape == (row_mxu._inverse_plan(layout)[0].num_words, 0)
    no_rows = Column(INT64, t.columns[0].data[:0])
    assert hk.murmur3_cols([no_rows], 42).shape == (0,)
    assert hk.xxhash64_cols([no_rows], 42).shape == (0,)
    assert kernels.planes_to_rows(planes, 97, 0).shape == (
        0, 4 * planes.shape[0])
    assert kernels.rows_to_planes(rows4[:0]).shape == (planes.shape[0], 0)
    assert kernels.to_rows_cols(t, layout, 100, 0).shape == (
        0, layout.fixed_row_size)
    assert kernels.from_rows_cols(rows10[:0], layout)[1].shape == (
        layout.num_columns, 0)
    empty_args = _compact_args(slice_table(st, 0, 0), slayout)
    assert kernels.compact_encode(*empty_args).shape == (0,)
    assert [c.shape for c in kernels.string_gather(
        *_gather_args(kernels.compact_encode(*empty_args), empty_args[2],
                      slayout))] == [(0,)]
    assert kernels.launches == want


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 31, 6 * 1024 + 557])
def test_hash_kernels_match_plain_versions(cuda, n):
    strings = [strings_with_lengths(
        (torch.arange(n, device=cuda) % (W + 1)).to(torch.int32), W, seed=W)
        for W in (0, 4, 12, 36, 68)]
    for nulls in (None, 0.0, 1.0, 0.25):
        t = random_table(HASH_FIXED, n, seed=n, null_probability=nulls,
                         device=cuda)
        cases = ([[c] for c in t.columns] + [list(t.columns)]
                 + [[s] for s in strings] + [strings + [t.columns[0]]]
                 + [list(special_floats(n, device=cuda).columns)])
        for seed in (42, 7):
            for cols in cases:
                assert torch.equal(hk.murmur3_cols(cols, seed),
                                   hk.murmur3_cols_plain(cols, seed)), \
                    (nulls, seed, [c.dtype for c in cols])
                assert torch.equal(hk.xxhash64_cols(cols, seed),
                                   hk.xxhash64_cols_plain(cols, seed)), \
                    (nulls, seed, [c.dtype for c in cols])


@pytest.mark.gpu
def test_hash_many_columns_one_launch(cuda):
    """A chain over every column of the 212-column schema and 300 more
    takes one launch."""
    t = random_table(WIDE + cycle_dtypes(HASH_FIXED, 300), 1000, seed=3,
                     null_probability=0.25, device=cuda)
    kernels.reset_launches()
    for fn, plain in ((hk.murmur3_cols, hk.murmur3_cols_plain),
                      (hk.xxhash64_cols, hk.xxhash64_cols_plain)):
        assert torch.equal(fn(t.columns, 42), plain(t.columns, 42))
    assert kernels.launches["murmur3_cols"] == 1
    assert kernels.launches["xxhash64_cols"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("ncols", [801, 1600, 1601])
def test_hash_chains_past_max_columns(cuda, ncols):
    """Past MAX_HASH_COLS columns the kernels chain ceil(ncols / 800)
    launches, each seeded per row by the previous one's hashes, and give
    the plain version's bits: strings and nulls in every chunk."""
    n = 517
    strings = [strings_with_lengths(
        (torch.arange(n, device=cuda) % (W + 1)).to(torch.int32), W, seed=W,
        null_probability=0.25) for W in (4, 36)]
    t = random_table(cycle_dtypes(HASH_FIXED, ncols - 2), n, seed=ncols,
                     null_probability=0.25, device=cuda)
    cols = list(t.columns[:700]) + strings + list(t.columns[700:])
    assert len(cols) == ncols
    for fn, plain in ((hk.murmur3_cols, hk.murmur3_cols_plain),
                      (hk.xxhash64_cols, hk.xxhash64_cols_plain)):
        kernels.reset_launches()
        got = fn(cols, 42)
        assert kernels.launches[fn.__name__] == -(-ncols // hk.MAX_HASH_COLS)
        assert torch.equal(got, plain(cols, 42)), fn.__name__


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 6, 12])
def test_bloom_kernel_matches_plain_version(cuda, k):
    for num_words in (1, 131_072, (1 << 25) + 1):
        words = random_bitset(num_words, 0.5 ** (1 / k), seed=k,
                              device=cuda)
        for n in (1, 31, 6 * 1024 + 557):
            for nulls in (None, 0.0, 1.0, 0.25):
                t = random_table(BLOOM_TYPES, n, seed=n,
                                 null_probability=nulls, device=cuda)
                for col in t.columns:
                    got = hk.bloom_might_contain(words, col, k)
                    assert torch.equal(
                        got, hk.bloom_might_contain_plain(words, col, k)), \
                        (num_words, n, nulls, col.dtype)
                    assert not got[~col.valid_bools()].any()


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 5, 6, 12])
def test_bloom_routes_match_plain_version(cuda, k):
    """Both routes at the sizes of Spark's filters and on both sides of the
    block route's threshold, forced through the private launch, and the
    route the wrapper picks, against the plain version bit for bit."""
    S = hk._BLOOM_BLOCK_WORDS
    for num_words in (1, 11_404, S, S + 1, 1 << 17, 1 << 20):
        words = random_bitset(num_words, 0.5 ** (1 / k), seed=k,
                              device=cuda)
        for n in (1, 31, 6 * 1024 + 557):
            for nulls in (None, 0.25):
                t = random_table(BLOOM_TYPES, n, seed=n,
                                 null_probability=nulls, device=cuda)
                for col in t.columns:
                    plain = hk.bloom_might_contain_plain(words, col, k)
                    assert torch.equal(hk.bloom_might_contain(words, col, k),
                                       plain), (num_words, n, col.dtype)
                    for route in hk._bloom_routes(num_words):
                        got = torch.empty(n, dtype=torch.bool, device=cuda)
                        hk._launch_bloom(words, col, k, route, got)
                        assert torch.equal(got, plain), \
                            (num_words, route, n, nulls, col.dtype)


@pytest.mark.gpu
def test_bloom_block_route_rejects_filters_it_cannot_hold(cuda):
    """A bitset past a block's 227 KB, and an unknown route, raise."""
    words = random_bitset(29_100, 0.5, device=cuda)
    col = random_table([INT64], 100, device=cuda).columns[0]
    out = torch.empty(100, dtype=torch.bool, device=cuda)
    for route in (hk._BLOOM_BLOCK, 2):
        with pytest.raises(RuntimeError, match="bloom_might_contain"):
            hk._launch_bloom(words, col, 3, route, out)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 255, 257, 6 * 1024 + 557])
def test_xxhash64_staging_edges(cuda, n):
    """K7 over column views whose data, lengths, chars or masks start inside
    a 16-byte chunk, row counts off the 256- and 1,024-row tiles, string
    pitches on both sides of the staging limit (120 and 124 bytes with a
    mask at 256 rows a tile and 32 KiB a stage), and plans whose budgets
    stage nothing, give many small groups, or read the wider strings in
    place, bit for bit; K6 beside it."""
    m = n + 11
    t = random_table(HASH_FIXED, m, seed=n, null_probability=0.25,
                     device=cuda)
    strings = [strings_with_lengths(
        (torch.arange(m, device=cuda) * 7 % (W + 1)).to(torch.int32), W,
        seed=W, null_probability=0.25) for W in (0, 12, 68, 120, 124)]
    whole = Table(tuple(t.columns) + tuple(strings))
    odd = slice_table(whole, 3, 3 + n).columns
    shifted = slice_table_dynamic(whole, 8, n).columns
    assert any(c.data.data_ptr() % 16 for c in odd[:11])
    for cols in (odd, shifted, [odd[8], odd[6], odd[-2], odd[-1]]):
        plain = hk.xxhash64_cols_plain(cols, 42)
        assert torch.equal(hk.xxhash64_cols(cols, 42), plain)
        for budget in (64, 2200, 4096):
            got = torch.empty(n, dtype=torch.int64, device=cuda)
            hk._launch_hash("xxhash64_cols", cols, 42, got,
                            hk._stage_plan(cols, hk._STAGING["xxhash64_cols"],
                                           budget=budget))
            assert torch.equal(got, plain), budget
        assert torch.equal(hk.murmur3_cols(cols, 42),
                           hk.murmur3_cols_plain(cols, 42))


# K6's string widths: every length on both sides of each 16-byte boundary
# up to 124 bytes, and pitches on both sides of the whole-tile staging limit
# (120 staged, 124 read in place, at 256 rows a tile and 32 KiB a stage)
MM3_WIDTHS = (0, 4, 16, 32, 36, 64, 68, 120, 124)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 255, 257, 6 * 1024 + 557])
def test_murmur3_string_routes(cuda, n):
    """K6 over strings of every length 0..W, read in place (its plan) and
    staged whole (K7's route), over column views whose values, masks,
    lengths or chars start inside a 16-byte chunk (rows of pitch 36 and 68
    at every offset in their chunk), row counts off the 256- and 1,024-row
    tiles, and plans that stage nothing or give small groups, bit for
    bit."""
    m = n + 11
    t = random_table(HASH_FIXED, m, seed=n, null_probability=0.25,
                     device=cuda)
    strings = [strings_with_lengths(
        (torch.arange(m, device=cuda) * 19 % (W + 1)).to(torch.int32), W,
        seed=W, null_probability=0.25) for W in MM3_WIDTHS]
    whole = Table(tuple(t.columns) + tuple(strings))
    odd = slice_table(whole, 3, 3 + n).columns
    shifted = slice_table_dynamic(whole, 8, n).columns
    assert any(c.chars2d.data_ptr() % 16 for c in odd[-len(strings):])
    mm3 = hk._STAGING["murmur3_cols"]
    whole_tile = dataclasses.replace(mm3, stage_strings=True)
    for cols in (odd, shifted, [odd[8], odd[0], *odd[-3:]], strings):
        if cols is strings:
            cols = list(slice_table(Table(cols), 0, n).columns)
        plain = hk.murmur3_cols_plain(cols, 42)
        assert torch.equal(hk.murmur3_cols(cols, 42), plain)
        assert all(s is None for c, s in
                   zip(cols, hk._stage_plan(cols, mm3).slots)
                   if c.dtype.is_string)
        slots = hk._stage_plan(cols, whole_tile).slots
        assert slots[-2] is not None and slots[-1] is None
        for staging, budget in ((mm3, 64), (mm3, 2200),
                                (whole_tile, hk._STAGE_BUDGET),
                                (whole_tile, 16384)):
            got = torch.empty(n, dtype=torch.int32, device=cuda)
            hk._launch_hash("murmur3_cols", cols, 42, got,
                            hk._stage_plan(cols, staging, budget=budget))
            assert torch.equal(got, plain), (staging, budget)


@pytest.mark.gpu
@pytest.mark.parametrize("ncols", [801, 1600])
def test_murmur3_chains_with_strings_in_the_first_and_last_launch(cuda,
                                                                  ncols):
    """K6 past MAX_HASH_COLS columns with a string first and one last: each
    launch seeded per row by the previous one's hashes."""
    n = 6 * 1024 + 557
    strings = [strings_with_lengths(
        (torch.arange(n, device=cuda) * 19 % (W + 1)).to(torch.int32), W,
        seed=W, null_probability=0.25) for W in (12, 68)]
    t = random_table(cycle_dtypes(HASH_FIXED, ncols - 2), n, seed=ncols,
                     null_probability=0.25, device=cuda)
    cols = [strings[0], *t.columns, strings[1]]
    plan = hk._stage_plan(cols, hk._STAGING["murmur3_cols"])
    assert plan.slots[0] is None and plan.slots[-1] is None
    kernels.reset_launches()
    got = hk.murmur3_cols(cols, 42)
    assert kernels.launches["murmur3_cols"] == -(-ncols // hk.MAX_HASH_COLS)
    assert torch.equal(got, hk.murmur3_cols_plain(cols, 42))


@pytest.mark.gpu
def test_decode_kernel_rejects_unaligned_rows(cuda):
    layout = compute_row_layout([INT32, INT8])
    buf = torch.zeros(8 * 12 + 2, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="4-byte aligned"):
        kernels.decode_planes(buf[2:].view(8, 12), layout)
    with pytest.raises(ValueError, match="4-byte aligned"):
        kernels.decode_planes(buf[:80].view(8, 10), layout)


@pytest.mark.gpu
@pytest.mark.parametrize("schema", sorted(SCHEMAS))
@pytest.mark.parametrize("n", [1, 33, 257, 2125])
def test_pack_kernel_matches_plain_version(cuda, schema, n):
    """K3 against its plain version at odd starts, under every null
    pattern, and the two-stage encode against K1."""
    dtypes = SCHEMAS[schema]
    layout = compute_row_layout(dtypes)
    for nulls in (None, 0.0, 1.0, 0.25):
        t = random_table(dtypes, n, seed=n, null_probability=nulls,
                         device=cuda)
        for start in sorted({0, min(3, n - 1), n // 3, n - 1}):
            for size in {n - start, (n - start) // 2}:
                k = kernels.pack_planes(t, layout, start, size)
                p = kernels.pack_planes_plain(t, layout, start, size)
                assert torch.equal(k, p), (nulls, start, size)
        gc = row_mxu.table_to_grouped(t, layout)
        assert torch.equal(
            row_mxu.to_rows_fixed(t, layout),
            kernels.grouped_encode(gc.planes, gc.vmask, layout, 0, n)), nulls


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 31, 6 * 1024 + 557])
def test_decode_kernel_on_padded_string_rows(cuda, n):
    """K2 over padded string rows (the stride is the padded row size, wider
    than the layout's) against its plain version; the padded round trip on
    the card gives back the table."""
    dtypes = [INT64, STRING, INT16, STRING, INT8, STRING, BOOL8]
    layout = compute_row_layout(dtypes)
    for nulls in (None, 0.0, 1.0, 0.25):
        fixed = random_table([d for d in dtypes if not d.is_string], n,
                             seed=n, null_probability=nulls, device=cuda)
        cols, f = [], iter(fixed.columns)
        for d, W in zip(dtypes, (None, 0, None, 4, None, 32, None)):
            cols.append(next(f) if W is None else strings_with_lengths(
                (torch.arange(n, device=cuda) % (W + 1)).to(torch.int32), W,
                seed=W, null_probability=nulls))
        t = Table(tuple(cols))
        [rows] = prc.convert_to_rows(t, device=cuda)
        assert rows.str_widths == (0, 4, 32)
        r2d = rows.rows2d(rows.row_size)
        assert r2d.shape[1] > layout.fixed_row_size
        pk, vk = kernels.decode_planes(r2d, layout)
        pp, vp = kernels.decode_planes_plain(r2d, layout)
        assert torch.equal(pk, pp) and torch.equal(vk, vp), nulls
        kernels.reset_launches()
        back = prc.convert_from_rows(rows, dtypes, device=cuda)
        assert kernels.launches["decode_planes"] == 1
        assert_tables_equivalent(t, back, check_nulls=False)


# documents beside the event logs: nesting past the depth budget, stray
# closes (the uint8 depth wraps), escaped keys, an 8-segment match and a
# 254-byte key
_GJO_EDGE_DOCS = [
    b'{"a": 1, "z": ' + b"[" * 300 + b"]" * 300 + b"}",
    b"]]" + b'{"a": 5}', b'{"\\u0061": 1, "a": "x\\"y"}', b"",
    b'{"p": {"q": [0, {"r": {"s": [[1, {"t": {"u": 7}}]]}}]}}',
    b'{"' + b"k" * 254 + b'": [1, 2]}',
]
_GJO_PATHS = ["$.a", "$.items[2].sku", "$.p.q[1].r.s[0][1].t",
              "$." + "k" * 254]


def _gjo_docs(n, W, seed):
    """n documents: event logs and the edge documents, then (for W up to
    4096) the documents whose stepped chars sit on K9's 16-char chunk
    boundaries."""
    docs, _ = json_event_docs(n - len(_GJO_EDGE_DOCS), seed=seed,
                              special=0.05, lengths=(min(100, W), W))
    boundary = json_boundary_docs(W) if W <= 4096 else []
    return [b"" if d is None else d.encode() for d in docs] + \
        _GJO_EDGE_DOCS + boundary


@pytest.mark.gpu
@pytest.mark.parametrize("W", [4, 36, 1024, 4096, 40_000])
def test_gjo_scan_matches_plain_version(cuda, W):
    """K9 against its plain version: rows not a multiple of the block, the
    chunk-boundary documents, a window past the JAX package's 32 KiB VMEM
    limit, paths of 1 to 8 segments, a 254-byte key, unaligned pitches,
    zero rows."""
    n = 131 if W > 4096 else 389
    ch = json_window(_gjo_docs(n, W, seed=W), W, device=cuda)
    n = ch.shape[0]
    # the plain version steps through the window with torch ops: past 4096
    # chars it runs on the CPU, where each op costs less
    plain_ch = ch.cpu() if W > 4096 else ch
    for path in _GJO_PATHS[:1] if W > 4096 else _GJO_PATHS:
        segs = tuple(gj._parse_path(path))
        mkl = max((len(s) for s in segs if isinstance(s, bytes)), default=1)
        got = gj.gjo_scan(ch, segs, mkl)
        want = gj.gjo_scan_plain(plain_ch, segs, mkl)
        assert torch.equal(got.cpu(), want.cpu()), path
    if W <= 1024:
        # rows 1 and 4 bytes apart: the kernel loads its chunks byte by
        # byte and word by word
        for extra in (1, 4):
            buf = torch.zeros(n * (W + extra), dtype=torch.uint8,
                              device=cuda)
            odd = buf.view(n, W + extra)[:, :W]
            odd.copy_(ch)
            assert torch.equal(gj.gjo_scan(odd, (b"a",), 1),
                               gj.gjo_scan_plain(odd, (b"a",), 1)), extra
    kernels.reset_launches()
    assert gj.gjo_scan(ch[:0], (b"a",), 1).shape == (6, 0)
    assert kernels.launches["gjo_scan"] == 0


@pytest.mark.gpu
def test_get_json_object_on_the_card_matches_the_cpu(cuda):
    """The whole function on the card (one K9 launch a call, the torch
    tail, the host fixup of flagged rows) equals the CPU run, all-null
    and zero-row columns included."""
    from spark_rapids_jni_tpu_torch import Column
    from spark_rapids_jni_tpu_torch.ops import get_json_object
    docs, _ = json_event_docs(997, seed=11, special=0.05)
    col = Column.strings_padded(docs, pad_to=1024, device="cpu")
    nulls = Column.padded_strings(col.chars2d, col.lens,
                                  torch.zeros_like(col.validity))
    empty = Column.padded_strings(col.chars2d[:0], col.lens[:0])
    for c in (col, nulls, empty):
        for path in ("$.a", "$.user.id", "$.items[2].sku"):
            want = get_json_object(c, path, device="cpu")
            kernels.reset_launches()
            got = get_json_object(c, path, device=cuda)
            assert kernels.launches["gjo_scan"] == (1 if c.num_rows else 0)
            assert torch.equal(got.chars2d.cpu(), want.chars2d), path
            assert torch.equal(got.lens.cpu(), want.lens), path
            assert torch.equal(got.validity.cpu(), want.validity), path


def _random_planes(num_words, n, seed, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(0, 256, (num_words, 4 * n), dtype=torch.uint8,
                         device=device, generator=gen).view(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("num_words", [2, 31, 33, 252])
@pytest.mark.parametrize("n", [1, 37, 6 * 1024 + 557])
def test_word_transposes_match_plain_versions(cuda, num_words, n):
    """K4 over whole and windowed planes and K5 over its rows against their
    plain versions, at one INT32 column's two words, ragged word tiles and
    the 212-column schema's 252; K5 inverts K4."""
    planes = _random_planes(num_words, n, n + num_words, cuda)
    start = min(3, n - 1)
    for s, size in {(0, n), (start, n - start), (n // 3, (n - n // 3) // 2)}:
        assert torch.equal(kernels.planes_to_rows(planes, s, size),
                           kernels.planes_to_rows_plain(planes, s, size))
    rows = kernels.planes_to_rows(planes, 0, n)
    back = kernels.rows_to_planes(rows)
    assert torch.equal(back, kernels.rows_to_planes_plain(rows))
    assert torch.equal(back, planes)


@pytest.mark.gpu
def test_word_transposes_past_2_31_bytes(cuda):
    num_words, n = 64, 8_400_000
    assert 4 * num_words * n > 1 << 31
    planes = _random_planes(num_words, n, 5, cuda)
    rows = kernels.planes_to_rows(planes, 0, n)
    assert torch.equal(rows, kernels.planes_to_rows_plain(planes, 0, n))
    del planes
    back = kernels.rows_to_planes(rows)
    assert torch.equal(back, kernels.rows_to_planes_plain(rows))


@pytest.mark.gpu
def test_unpack_kernel_rejects_unaligned_rows(cuda):
    buf = torch.zeros(1024, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="4-byte aligned"):
        kernels.rows_to_planes(buf[2:98].view(12, 8))
    with pytest.raises(ValueError, match="4 \\* W"):
        kernels.rows_to_planes(buf[:60].view(6, 10))


@pytest.mark.gpu
def test_pallas_route_and_serve_on_the_card_match_the_cpu(cuda):
    """``impl="pallas"`` on the card (one K4 launch to encode, one K5 to
    decode) and the serve ops on the card (one launch a tick) equal the
    CPU runs."""
    import numpy as np
    from spark_rapids_jni_tpu_torch import serve
    t = random_table(WIDE, 3001, seed=3, null_probability=0.25,
                     device="cpu")
    want = prc.convert_to_rows(t, impl="pallas", device="cpu")
    kernels.reset_launches()
    got = prc.convert_to_rows(t, impl="pallas", device=cuda)
    back = prc.convert_from_rows(got[0], WIDE, impl="pallas", device=cuda)
    assert (kernels.launches["planes_to_rows"],
            kernels.launches["rows_to_planes"]) == (1, 1)
    assert torch.equal(got[0].data.cpu(), want[0].data)
    assert_tables_equivalent(t, back.to("cpu"), check_nulls=False)
    rng = np.random.default_rng(0)
    cols = [rng.integers(-2**31, 2**31 - 1, 1000).astype(np.int32)
            for _ in range(212)]
    answers = []
    for device in ("cpu", cuda):
        with serve.Scheduler(device=device) as s:
            c = serve.Client(s, "alice")
            rows = c.to_rows(cols).result(timeout=60)["rows"]
            back = c.from_rows(rows, 212).result(timeout=60)["columns"]
        answers.append((rows, back))
    np.testing.assert_array_equal(answers[0][0], answers[1][0])
    for a, b, orig in zip(answers[0][1], answers[1][1], cols):
        np.testing.assert_array_equal(a, orig)
        np.testing.assert_array_equal(b, orig)


DEC_SCHEMA = [INT8, decimal128(2), INT64, INT16, BOOL8, decimal128(38),
              FLOAT32, UINT8, decimal128(0)]
ROW_SCHEMAS = {**SCHEMAS, "decimal128": DEC_SCHEMA,
               # 1-byte columns at the 1 KB row limit: 910 + 114 bytes
               "int8_910": [INT8] * 910}


def _hold_row_kernels(t, layout, start, size):
    """K10 over rows [start, start + size) of ``t`` and K11 over its rows
    against their plain versions; K11 gives the table's rows back."""
    rows = kernels.to_rows_cols(t, layout, start, size)
    assert torch.equal(rows, kernels.to_rows_cols_plain(t, layout, start,
                                                        size))
    datas, vmask = kernels.from_rows_cols(rows, layout)
    pdatas, pvmask = kernels.from_rows_cols_plain(rows, layout)
    assert torch.equal(vmask, pvmask)
    assert torch.equal(vmask, pack_bools(valid_bits(t.columns, start, size)))
    # by bits: random float bits hold NaNs, which equal nothing
    for c, d, p in zip(t.columns, datas, pdatas):
        assert torch.equal(bits_view(d), bits_view(p))
        assert torch.equal(bits_view(d),
                           bits_view(c.data[start:start + size]))


@pytest.mark.gpu
@pytest.mark.parametrize("schema", sorted(ROW_SCHEMAS))
@pytest.mark.parametrize("n", [1, 31, 33, 1000])
def test_row_kernels_match_plain_versions(cuda, schema, n):
    """K10 and K11 against their plain versions at ragged tiles, every
    null pattern (no masks, all valid, all null, 25% null), the batch at an
    odd start and at one that is not a multiple of 8."""
    dtypes = ROW_SCHEMAS[schema]
    layout = compute_row_layout(dtypes)
    for nulls in (None, 0.0, 1.0, 0.25):
        t = random_table(dtypes, n, seed=n, null_probability=nulls,
                         device=cuda)
        for start in sorted({0, min(3, n - 1), min(13, n - 1)}):
            _hold_row_kernels(t, layout, start, n - start)
    back = prk.from_rows_fixed(prk.to_rows_fixed(t, layout), layout)
    assert_tables_equivalent(t, Table(back), check_nulls=False)


@pytest.mark.gpu
@pytest.mark.parametrize("tile_rows", [32, 64, 480])
def test_row_kernels_tile_sizes(cuda, tile_rows):
    """Any tile of a multiple of 32 rows gives the same rows and columns;
    480 of the decimal128 schema's 104-byte rows take more than 48 KB."""
    layout = compute_row_layout(DEC_SCHEMA)
    t = random_table(DEC_SCHEMA, 6 * 1024 + 557, seed=9, device=cuda)
    want = kernels.to_rows_cols_plain(t, layout, 5, t.num_rows - 5)
    rows = kernels.to_rows_cols(t, layout, 5, t.num_rows - 5, tile_rows)
    assert torch.equal(rows, want)
    datas, vmask = kernels.from_rows_cols(rows, layout, tile_rows)
    pdatas, pvmask = kernels.from_rows_cols_plain(rows, layout)
    assert torch.equal(vmask, pvmask)
    assert all(torch.equal(bits_view(d), bits_view(p))
               for d, p in zip(datas, pdatas))
    with pytest.raises(ValueError, match="multiple of 32"):
        kernels.to_rows_cols(t, layout, 0, 10, 48)


@pytest.mark.gpu
def test_row_kernels_past_2_31_bytes(cuda):
    """K10 and K11 over rows past 2^31 bytes, compared in slices."""
    dtypes = cycle_dtypes([INT64, FLOAT64, INT32, FLOAT32, INT16, INT8,
                           BOOL8], 96)
    layout = compute_row_layout(dtypes)
    n = (1 << 31) // layout.fixed_row_size + 4099
    t = random_table(dtypes, n, seed=11, device=cuda)
    rows = kernels.to_rows_cols(t, layout, 0, n)
    assert rows.numel() > 1 << 31
    step = 1 << 20
    for s in range(0, n, step):
        size = min(step, n - s)
        assert torch.equal(rows[s:s + size],
                           kernels.to_rows_cols_plain(t, layout, s, size))
    datas, vmask = kernels.from_rows_cols(rows, layout)
    for c, d in zip(t.columns, datas):
        assert torch.equal(bits_view(c.data), bits_view(d))
    assert torch.equal(vmask, torch.stack([c.validity for c in t.columns]))


# ---------------------------------------------------------------------------
# The compact rows' ragged copies: compact_encode and string_gather
# ---------------------------------------------------------------------------

def _arrow_column(lens, seed, lead, nulls=0.25):
    """An Arrow string column of int lengths ``lens`` on their device:
    random bytes, the first row's chars ``lead`` bytes into the buffer,
    each row null with ``nulls``."""
    dev = lens.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n = lens.shape[0]
    offsets = torch.full((n + 1,), lead, dtype=torch.int64, device=dev)
    offsets[1:] += torch.cumsum(lens.to(torch.int64), 0)
    chars = torch.randint(0, 256, (int(offsets[-1]) + 5,), dtype=torch.uint8,
                          generator=gen, device=dev)
    validity = pack_bools(torch.rand(n, generator=gen, device=dev) >= nulls)
    return Column.arrow_strings(offsets.to(torch.int32), chars, validity)


def _compact_args(table, layout):
    """The compact encode's arguments for the whole of ``table``."""
    return prc._compact_batch_inputs(table, layout, 0, table.num_rows,
                                     *prc._compact_plan(table, layout))


def _gather_args(blob, row_offsets, layout):
    """The string gather's arguments for compact rows ``blob`` (one K2
    launch)."""
    return prc._compact_decode(blob, row_offsets, layout)[2]


@pytest.mark.gpu
@pytest.mark.parametrize("k,int16", [(k, False) for k in range(12)]
                         + [(3, True)])
def test_compact_kernels_match_plain_versions(cuda, k, int16):
    """The compact encode and the string gather against their plain
    versions, and K2 over the gathered fixed sections: three Arrow columns
    of lengths 0..67 whose chars start at odd offsets, an INT64 (and an
    INT16) and k INT8 columns (fixed_end 33 to 45, and 38: every residue
    mod 8), 1 and 389 rows and a slice from row 1; then the entry points
    on the card against the CPU's."""
    for n in (1, 389):
        fixed = random_table([INT8] * k + [INT64] + [INT16] * int16, n,
                             seed=k, device=cuda)
        strs = [_arrow_column((torch.arange(n, device=cuda) * (7 + j) + j)
                              % 68, seed=j, lead=2 * j + 1)
                for j in range(3)]
        t = Table((strs[0], strs[1], fixed.columns[k], strs[2],
                   *fixed.columns[k + 1:], *fixed.columns[:k]))
        layout = compute_row_layout(t.dtypes)
        for tt in (t, slice_table(t, 1, n)):
            args = _compact_args(tt, layout)
            blob = kernels.compact_encode(*args)
            assert torch.equal(blob, kernels.compact_encode_plain(*args))
            fsec = prc._compact_fixed_sections(blob, args[2], layout)
            pk, vk = kernels.decode_planes(fsec, layout)
            pp, vp = kernels.decode_planes_plain(fsec, layout)
            assert torch.equal(pk, pp) and torch.equal(vk, vp)
            gargs = _gather_args(blob, args[2], layout)
            for a, b in zip(kernels.string_gather(*gargs),
                            kernels.string_gather_plain(*gargs)):
                assert torch.equal(a, b)
            kernels.reset_launches()
            [rows] = prc.convert_to_rows(tt, device=cuda)
            back = prc.convert_from_rows(rows, t.dtypes, device=cuda)
            assert (kernels.launches["compact_encode"],
                    kernels.launches["decode_planes"],
                    kernels.launches["string_gather"]) == \
                ((1, 1, 1) if tt.num_rows else (0, 0, 0))
            [want] = prc.convert_to_rows(tt.to("cpu"), device="cpu")
            assert torch.equal(rows.data.cpu(), want.data)
            assert torch.equal(rows.offsets.cpu(), want.offsets)
            assert_tables_equivalent(tt, back, check_nulls=False)
            for a, b in zip(back.columns, prc.convert_from_rows(
                    want, t.dtypes, device="cpu").columns):
                if a.dtype.is_string:
                    assert torch.equal(a.offsets.cpu(), b.offsets)
                    assert torch.equal(a.chars.cpu(), b.chars)


def _flags(n, plan, dev):
    return torch.zeros(-(-n // plan.tile_rows), dtype=torch.uint8, device=dev)


def _hold_compact_plans(args, gargs, enc_plans, gat_plans):
    """Both compact kernels (either one where the other's arguments are
    None), by the wrappers' plans and by each plan given, byte for byte
    against their plain versions, and the tiles each launch marks long
    against ``_compact_tiles``' copy of the producers' test; returns the
    wrapper's blob and each given plan's long tiles (bool, the encode's
    plans first)."""
    blob, longs = None, []
    if args is not None:
        n, dev = args[0].shape[0], args[0].device
        want = kernels.compact_encode_plain(*args)
        blob = kernels.compact_encode(*args)
        assert torch.equal(blob, want)
        for plan in enc_plans:
            flags = _flags(n, plan, dev)
            assert torch.equal(
                kernels._launch_compact_encode(args, plan, flags), want)
            longs.append(flags.bool())
            assert torch.equal(longs[-1], encode_long_tiles(
                plan, args[0], args[2], args[4]))
        del want
    if gargs is not None:
        n, dev = gargs[1].shape[0] - 1, gargs[0].device
        want = kernels.string_gather_plain(*gargs)
        for i, plan in enumerate([None] + list(gat_plans)):
            if plan is None:
                got = kernels.string_gather(*gargs)
            else:
                flags = _flags(n, plan, dev)
                got = kernels._launch_string_gather(gargs, plan, flags)
                longs.append(flags.bool())
                assert torch.equal(longs[-1],
                                   gather_long_tiles(plan, *gargs[:3]))
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
            del got
    torch.cuda.synchronize()
    return blob, longs


def _tile_table(n, dev, long_row=None):
    """Three Arrow columns of lengths 0..67 at odd char offsets, an INT64
    and an INT8 (fixed_end 34); with ``long_row``, that row of the first
    string holds 100,000 bytes."""
    fixed = random_table([INT64, INT8], n, seed=n, device=dev)
    strs = []
    for j in range(3):
        lens = (torch.arange(n, device=dev) * (7 + j) + j) % 68
        if j == 0 and long_row is not None:
            lens[long_row] = 100_000
        strs.append(_arrow_column(lens, seed=j, lead=2 * j + 1))
    return Table((strs[0], fixed.columns[0], strs[1], fixed.columns[1],
                  strs[2]))


@pytest.mark.gpu
def test_compact_tile_routes_match_plain_versions(cuda):
    """The compact encode and the string gather on their tile route: n = 1,
    R - 1, R, R + 1 (R the wrapper's tile rows) and 6,701 rows and a slice
    from an odd row, by the wrappers' plans and by tiles of 8 and 13 rows
    on other rings; then by the wrappers' plans with every tile sent down
    the long-row route."""
    t = _tile_table(6_701, cuda)
    layout = compute_row_layout(t.dtypes)
    R = kernels.encode_plan(_compact_args(t, layout)).tile_rows
    for tt in [slice_table(t, 0, n) for n in (1, R - 1, R, R + 1, 6_701)] + [
            slice_table(t, 3, 2_000)]:
        args = _compact_args(tt, layout)
        blob = kernels.compact_encode(*args)
        gargs = _gather_args(blob, args[2], layout)
        enc = [kernels.encode_plan(args, tile_rows=r) for r in (8, 13)]
        gat = [kernels.gather_plan(gargs, tile_rows=r, ring=ring)
               for r in (8, 13) for ring in ((2, 3), (1, 4))]
        enc += [kernels.encode_plan(args, tile_rows=r, ring=(2, 3))
                for r in (8, 13)]
        _, longs = _hold_compact_plans(args, gargs, enc, gat)
        assert not any(x.any() for x in longs)
        _, longs = _hold_compact_plans(
            args, gargs, [kernels.encode_plan(args).long_route()],
            [kernels.gather_plan(gargs).long_route()])
        assert all(x.all() for x in longs)


@pytest.mark.gpu
def test_compact_long_row_mid_launch(cuda):
    """A 100,000-byte string in row 150 of 300 short rows: its tile takes
    the long-row route in both kernels, between tiles on the tile route,
    in one launch each; the entry points round-trip the table."""
    t = _tile_table(300, cuda, long_row=150)
    layout = compute_row_layout(t.dtypes)
    args = _compact_args(t, layout)
    blob = kernels.compact_encode(*args)
    gargs = _gather_args(blob, args[2], layout)
    enc = [kernels.encode_plan(args, tile_rows=16), kernels.encode_plan(args)]
    gat = [kernels.gather_plan(gargs, tile_rows=16), kernels.gather_plan(gargs)]
    _, longs = _hold_compact_plans(args, gargs, enc, gat)
    for plan, marked in zip(enc + gat, longs):
        tile = 150 // plan.tile_rows
        assert marked.nonzero().view(-1).tolist() == [tile]
        assert 0 < tile < marked.numel() - 1
    kernels.reset_launches()
    [rows] = prc.convert_to_rows(t, device=cuda)
    back = prc.convert_from_rows(rows, t.dtypes, device=cuda)
    assert (kernels.launches["compact_encode"],
            kernels.launches["string_gather"]) == (1, 1)
    assert torch.equal(rows.data, blob)
    assert_tables_equivalent(t, back, check_nulls=False)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [33, 128])
def test_compact_kernels_many_columns(cuda, k):
    """33 and 128 string columns (128 past a JCUDF layout: raw arguments),
    lengths 0..67, every column's chars starting at another residue mod
    16 (all 16 among them), by the wrappers' plans and tiles of 8 rows,
    whole and from an odd row."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(k)
    lens = torch.randint(0, 68, (997, k), generator=gen, device=cuda)
    fe = 8 * k + (k + 7) // 8
    args = compact_encode_args(lens, fe, seed=k)
    fixed, _, ro, _, strings = args
    odd = (fixed[3:], fe, ro[3:] - ro[3], int(ro[-1] - ro[3]),
           [(c, o[3:], lo) for c, o, lo in strings])
    for a, ln in ((args, lens), (odd, lens[3:])):
        blob = kernels.compact_encode_plain(*a)
        gargs = compact_gather_args(blob, a[2], fe, ln)
        _hold_compact_plans(a, gargs, [kernels.encode_plan(a, tile_rows=8)],
                            [kernels.gather_plan(gargs, tile_rows=8,
                                                 ring=(1, 2))])


@pytest.mark.gpu
def test_compact_kernels_near_2_gib(cuda):
    """One row of 128 string columns of 16,777,200 chars each, a batch of
    2,147,482,640 bytes: the chars' 16-byte chunks (each column's chars at
    4, 8 or 12 past a 16-byte line) add up to 2^31 bytes.  The tile goes
    the long-row route in both kernels, and both give their plain
    versions' bytes."""
    k, fe, length = 128, 1040, 16_777_200
    pool = torch.randint(0, 256, (k * (length + 16) + 16,),
                         dtype=torch.uint8, device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(7))
    strings = []
    for c in range(k):
        at = c * (length + 16) + 4 * (1 + c % 3)
        strings.append((pool[at:at + length],
                        torch.tensor([0, length], dtype=torch.int32,
                                     device=cuda), 0))
    total = fe + k * length
    fixed = torch.randint(0, 256, (1, fe), dtype=torch.uint8, device=cuda)
    ro = torch.tensor([0, total], dtype=torch.int32, device=cuda)
    args = (fixed, fe, ro, total, strings)
    blob, longs = _hold_compact_plans(
        args, None, [kernels.encode_plan(args)], [])
    del pool, strings, args
    gargs = compact_gather_args(blob, ro, fe,
                                torch.full((1, k), length, device=cuda))
    longs += _hold_compact_plans(None, gargs, [],
                                 [kernels.gather_plan(gargs)])[1]
    assert [int(x.sum()) for x in longs] == [1, 1]


@pytest.mark.gpu
def test_compact_batches_and_edges_on_the_card(cuda):
    """Several batches (a size_limit of 32 rows), zero rows, a table of
    strings only with a padded column beside it: blobs and decoded columns
    equal to the CPU run's, one compact encode a batch."""
    lens = torch.arange(203, device=cuda) % 61
    t = Table((_arrow_column(lens, 1, 0), _arrow_column(lens.flip(0), 2, 7),
               strings_with_lengths(lens.to(torch.int32), 60, seed=3)))
    for tt, limit in ((t, 32 * 256), (slice_table(t, 5, 5), 1 << 20)):
        kernels.reset_launches()
        batches = prc.convert_to_rows(tt, size_limit=limit, device=cuda)
        assert kernels.launches["compact_encode"] == (
            len(batches) if tt.num_rows else 0)
        want = prc.convert_to_rows(tt.to("cpu"), size_limit=limit,
                                   device="cpu")
        assert [b.num_rows for b in batches] == [b.num_rows for b in want]
        start = 0
        for g, w in zip(batches, want):
            assert torch.equal(g.data.cpu(), w.data)
            back = prc.convert_from_rows(g, tt.dtypes, device=cuda)
            assert_tables_equivalent(
                slice_table(tt, start, start + g.num_rows), back,
                check_nulls=False)
            start += g.num_rows
    assert len(batches) == 1 and len(want) == 1
