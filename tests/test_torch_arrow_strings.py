"""PyTorch port, Arrow-layout string columns and compact JCUDF rows, held
against the JAX package on the same seeded numpy data: compact blobs and
offsets byte for byte, decoded Arrow columns (offsets, chars, validity),
the plain compact encode and string gather against the JAX package's
``_to_rows_variable_jit`` and ``_gather_all_strings_jit``, the plain decode
kernel over the gathered fixed sections against
``_extract_fixed_variable_jit``, the column helpers (``to_padded``,
``to_arrow``, ``chars_window``, ``slice_table``), the hashes and
``get_json_object`` of Arrow columns; then against the host C++ row engine
(``srj_rows_{encode,decode}_variable``), loaded by path with ctypes.

The JAX compact encode compiles once per content (its char totals are
static), so a handful of small tables are made once and shared; the JAX
calls take ``bucket=None``."""

import ctypes
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import table as jt
from spark_rapids_jni_tpu.ops import get_json as jgj
from spark_rapids_jni_tpu.ops import hashing as jh
from spark_rapids_jni_tpu.ops import row_conversion as jrc
from spark_rapids_jni_tpu.ops.row_layout import (
    compute_row_layout as jax_layout,
)
from spark_rapids_jni_tpu_torch import STRING, interop
from spark_rapids_jni_tpu_torch import table as pt
from spark_rapids_jni_tpu_torch.ops import get_json as pgj
from spark_rapids_jni_tpu_torch.ops import hashing as ph
from spark_rapids_jni_tpu_torch.ops import kernels
from spark_rapids_jni_tpu_torch.ops import row_conversion as prc
from spark_rapids_jni_tpu_torch.ops.row_layout import compute_row_layout
from spark_rapids_jni_tpu_torch.utils import random_table
from tests._torch_port import (
    assert_same_batches, assert_same_columns, both_arrow_string_columns,
    both_string_columns, jax_dtype, numpy_columns, xx_as_int64,
)

CPU = "cpu"
FIXED = ["int64", "int32", "int16", "int8", "bool8", "float64"]
N = 77
NON_ASCII = ["", None, "déf", "日本語", "🙂🙂", "a", "", "ünïcödé…"]
LIBSRJ = (Path(__file__).resolve().parents[1] / "spark_rapids_jni_tpu"
          / "_native" / "libsrj_tpu.so")


def _interleave(fixed, strings):
    """FIXED's columns in both packages with a string column after the
    first, third and fifth: (JAX Table, port Table)."""
    jcols, pcols = [], []
    for i, (name, vals, ok) in enumerate(fixed):
        jcols.append(jt.Column.from_numpy(vals, jax_dtype(name), ok))
        pcols.append(pt.Column.from_numpy(vals, pt.dtype_from_name(name), ok,
                                          device=CPU))
        if i % 2 == 0 and i // 2 < len(strings):
            jcols.append(strings[i // 2][0])
            pcols.append(strings[i // 2][1])
    return jt.Table(tuple(jcols)), pt.Table(tuple(pcols))


def _make_tables():
    rng = np.random.default_rng(12)
    t = {}
    # Arrow strings of lengths 0, 0..5 and 0..40, the last column's offsets
    # starting past other chars
    t["mixed"] = _interleave(
        numpy_columns(rng, FIXED, N),
        [both_arrow_string_columns(rng, N, 0),
         both_arrow_string_columns(rng, N, 5),
         both_arrow_string_columns(rng, N, 40, lead=3)])
    # a padded column beside Arrow ones: the table normalises to Arrow
    t["mixed_padded"] = _interleave(
        numpy_columns(rng, FIXED, 40, "zero"),
        [both_arrow_string_columns(rng, 40, 9),
         both_string_columns(rng, 40, 13),
         both_arrow_string_columns(rng, 40, 67, "none")])
    jcols, pcols = zip(*(both_arrow_string_columns(rng, 50, m)
                         for m in (3, 67)))
    t["strings_only"] = (jt.Table(jcols), pt.Table(pcols))
    vals = np.arange(len(NON_ASCII), dtype=np.int32)
    t["non_ascii"] = (
        jt.Table((jt.Column.from_numpy(vals, jt.INT32),
                  jt.Column.strings(NON_ASCII))),
        pt.Table((pt.Column.from_numpy(vals, pt.INT32, device=CPU),
                  pt.Column.strings(NON_ASCII, device=CPU))))
    t["zero_rows"] = _interleave(
        numpy_columns(rng, FIXED, 0),
        [both_arrow_string_columns(rng, 0, 8)])
    jax_mixed, port_mixed = t["mixed"]
    t["sliced"] = (jt.slice_table(jax_mixed, 5, 61),
                   pt.slice_table(port_mixed, 5, 61))
    return t


TABLES = sorted(["mixed", "mixed_padded", "strings_only", "non_ascii",
                 "zero_rows", "sliced"])


@pytest.fixture(scope="module")
def tables():
    return _make_tables()


@pytest.fixture(scope="module")
def encoded(tables):
    """Each table's compact batches in both packages, and the mixed table
    in several batches (a size_limit of 40 of its longest rows)."""
    out = {}
    for name, (jax_table, port_table) in tables.items():
        out[name] = (prc.convert_to_rows(port_table, device=CPU),
                     jrc.convert_to_rows(jax_table, bucket=None))
    jax_table, port_table = tables["mixed"]
    sizes = prc._row_sizes(port_table, compute_row_layout(port_table.dtypes))
    limit = 40 * int(sizes.max())
    out["multibatch"] = (
        prc.convert_to_rows(port_table, size_limit=limit, device=CPU),
        jrc.convert_to_rows(jax_table, size_limit=limit, bucket=None))
    return out


def _table_of(tables, name):
    return tables["mixed" if name == "multibatch" else name]


@pytest.mark.parametrize("name", TABLES + ["multibatch"])
def test_convert_to_rows_matches_jax(encoded, name):
    got, want = encoded[name]
    assert_same_batches(got, want)
    assert all(not b.is_padded and b.str_widths is None
               and b.data.dim() == 1 for b in got)
    assert (len(got) > 1) == (name == "multibatch")


@pytest.mark.parametrize("name", TABLES + ["multibatch"])
def test_convert_from_rows_matches_jax(tables, encoded, name):
    """Each port batch decodes as the JAX package decodes it; the JAX
    batches carried across decode the same; the batches together give
    back the input."""
    jax_table, port_table = _table_of(tables, name)
    got, want = encoded[name]
    start = 0
    for g, w in zip(got, want):
        mine = prc.convert_from_rows(g, port_table.dtypes, device=CPU)
        theirs = jrc.convert_from_rows(w, jax_table.dtypes, bucket=None)
        assert all(c.offsets is not None and c.chars2d is None
                   for c in mine.columns if c.dtype.is_string)
        assert_same_columns(mine, theirs)
        carried = interop.rows_from_numpy(np.asarray(w.data),
                                          np.asarray(w.offsets), device=CPU)
        assert_same_columns(prc.convert_from_rows(
            carried, port_table.dtypes, device=CPU), theirs)
        part = pt.slice_table(port_table, start, start + g.num_rows)
        pt.assert_tables_equivalent(mine, part, check_nulls=False)
        start += g.num_rows
    assert start == port_table.num_rows


def test_compact_rows_host_of_padded_equals_compact_encode(tables, encoded):
    """The two string forms meet: the padded encode of the mixed table's
    strings, compacted on the host, is the compact encode's blob."""
    _, port_table = tables["mixed"]
    padded = pt.Table(tuple(c.to_padded() for c in port_table.columns))
    rows = prc.convert_to_rows(padded, device=CPU)[0]
    assert rows.is_padded
    compact = prc.compact_rows_host(rows, padded.dtypes, device=CPU)
    got = encoded["mixed"][0][0]
    assert torch.equal(compact.data, got.data)
    assert torch.equal(compact.offsets, got.offsets)


def _jax_batch_inputs(jax_table, port_table):
    """The one batch of each table, as the JAX package's compact encode
    takes it, and the port's inputs of the compact encode kernel."""
    layout = compute_row_layout(port_table.dtypes)
    args = prc._compact_batch_inputs(port_table, layout, 0,
                                     port_table.num_rows,
                                     *prc._compact_plan(port_table, layout))
    row_offsets, total = args[2], args[3]
    scols = [c for c in jax_table.columns if c.dtype.is_string]
    los = tuple(int(np.asarray(c.offsets)[0]) for c in scols)
    totals = tuple(int(np.asarray(c.offsets)[-1]) - lo
                   for c, lo in zip(scols, los))
    slices = jrc._slice_chars_batch_jit([c.chars for c in scols], los,
                                        totals)
    jax_args = (jnp.asarray(row_offsets.numpy()), totals, slices,
                jax_layout(jax_table.dtypes), total)
    return args, jax_args


@pytest.mark.parametrize("name", ["mixed", "strings_only", "sliced"])
def test_plain_compact_encode_matches_jax_jit(tables, name):
    jax_table, port_table = tables[name]
    args, (offsets, totals, slices, layout, total) = _jax_batch_inputs(
        jax_table, port_table)
    want = jrc._to_rows_variable_jit(jax_table, offsets, totals, slices,
                                     layout, total)
    got = kernels.compact_encode_plain(*args)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(kernels.compact_encode(*args), got)


@pytest.mark.parametrize("name", ["mixed", "strings_only", "sliced"])
def test_decode_pieces_match_jax_jit(tables, encoded, name):
    """K2's plain version over the gathered fixed sections gives the
    columns, masks and lengths of ``_extract_fixed_variable_jit``; the
    plain string gather gives the chars and offsets of
    ``_gather_all_strings_jit``."""
    jax_table, port_table = tables[name]
    rows = encoded[name][0][0]
    layout = compute_row_layout(port_table.dtypes)
    jlayout = jax_layout(jax_table.dtypes)
    data, offs = jnp.asarray(rows.data.numpy()), jnp.asarray(
        rows.offsets.numpy())
    jdatas, jmasks, f_words, jlens = jrc._extract_fixed_variable_jit(
        data, offs, jlayout)
    fixed = prc._compact_fixed_sections(rows.data, rows.offsets, layout)
    np.testing.assert_array_equal(
        fixed.numpy(), np.asarray(f_words).astype(np.uint32).view(np.uint8)
        .reshape(fixed.shape))
    datas, masks, gather = prc._compact_decode(rows.data, rows.offsets,
                                               layout)
    lens = [ln for _, ln, _ in gather[2]]
    for i, dt in enumerate(layout.dtypes):
        np.testing.assert_array_equal(masks[i].numpy(),
                                      np.asarray(jmasks[i]))
        if not dt.is_string:
            np.testing.assert_array_equal(
                pt.bits_view(datas[i]).numpy().view(np.uint8),
                np.asarray(jdatas[i]).view(np.uint8))
    for a, b in zip(lens, jlens):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = kernels.string_gather_plain(*gather)
    want = jrc._gather_all_strings_jit(
        data, offs, f_words, tuple(jlayout.variable_starts), jlens,
        tuple(gather[3]))
    for g, (_, _, o), (wc, wo) in zip(got, gather[2], want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wc))
        np.testing.assert_array_equal(o.numpy(), np.asarray(wo))


# ---------------------------------------------------------------------------
# Malformed blobs, width caps, the entry points that took only padded
# strings
# ---------------------------------------------------------------------------

def _pair_at(rows, layout, row, si):
    """A copy of ``rows``' blob and the byte offset of row ``row``'s pair of
    string column ``si``."""
    return (rows.data.clone(),
            int(rows.offsets[row]) + layout.variable_starts[si])


def test_malformed_blobs_raise(tables, encoded):
    """A pair outside its row, a length past the row, row offsets that are
    not multiples of 8 or leave the blob raise ValueError before the
    string gather reads the blob (the JAX package clips such reads)."""
    _, port_table = tables["mixed"]
    rows = encoded["mixed"][0][0]
    layout = compute_row_layout(port_table.dtypes)
    bad = []
    blob, at = _pair_at(rows, layout, 3, 2)
    blob[at:at + 4] = torch.tensor([255, 255, 0, 0], dtype=torch.uint8)
    bad.append(prc.RowsColumn(blob, rows.offsets))
    blob, at = _pair_at(rows, layout, 70, 1)
    blob[at + 4:at + 8] = torch.tensor([0, 1, 0, 0], dtype=torch.uint8)
    bad.append(prc.RowsColumn(blob, rows.offsets))
    offs = rows.offsets.clone()
    offs[5] += 4
    bad.append(prc.RowsColumn(rows.data, offs))
    offs = rows.offsets.clone()
    offs[-1] += 8
    bad.append(prc.RowsColumn(rows.data, offs))
    for b in bad:
        with pytest.raises(ValueError, match="malformed compact rows"):
            prc.convert_from_rows(b, port_table.dtypes, device=CPU)


def test_width_capped_columns_still_raise(tables):
    _, port_table = tables["mixed"]
    arrow = port_table.columns[4]           # lengths 0..5
    with pytest.raises(NotImplementedError, match="queue 1, item 4"):
        arrow.to_padded(width_cap=16)
    padded = arrow.to_padded()
    longer = pt.Column.padded_strings(padded.chars2d, padded.lens + 50,
                                      padded.validity)
    with pytest.raises(ValueError, match="do not fit the padded width"):
        longer.to_arrow()
    with pytest.raises(ValueError, match="pad_to"):
        arrow.to_padded(pad_to=2)


def test_column_forms_match_jax(tables):
    """to_padded, to_arrow and chars_window of Arrow columns, sliced ones
    included (absolute offsets into the parent's chars), as the JAX
    package gives them."""
    for name in ("mixed", "sliced"):
        jax_table, port_table = tables[name]
        for jc, pc in zip(jax_table.columns, port_table.columns):
            if not pc.dtype.is_string:
                continue
            jp, pp = jc.to_padded(), pc.to_padded()
            np.testing.assert_array_equal(pp.chars2d.numpy(),
                                          np.asarray(jp.chars2d))
            np.testing.assert_array_equal(pp.lens.numpy(),
                                          np.asarray(jp.str_lens()))
            for W in (0, 7, 44):
                np.testing.assert_array_equal(
                    pc.chars_window(W).numpy(),
                    np.asarray(jc.chars_window(W)))
            back, jback = pp.to_arrow(), jp.to_arrow()
            np.testing.assert_array_equal(back.offsets.numpy(),
                                          np.asarray(jback.offsets))
            np.testing.assert_array_equal(back.chars.numpy(),
                                          np.asarray(jback.chars))
            pt.assert_tables_equivalent(pt.Table((back,)), pt.Table((pc,)),
                                        check_nulls=False)
    _, port_table = tables["sliced"]
    assert int(port_table.columns[7].offsets[0]) > 3


@pytest.mark.parametrize("start,end", [(0, 77), (3, 29), (8, 16), (5, 5)])
def test_slice_table_arrow_matches_jax(tables, start, end):
    jax_table, port_table = tables["mixed"]
    assert_same_columns(pt.slice_table(port_table, start, end),
                        jt.slice_table(jax_table, start, end))
    if start % 8 == 0:
        dyn = pt.slice_table_dynamic(port_table, start, end - start)
        pt.assert_tables_equivalent(
            dyn, pt.slice_table(port_table, start, end))


@pytest.mark.parametrize("name", ["mixed", "sliced"])
def test_hashes_of_arrow_columns_match_jax(tables, name):
    """murmur3, xxhash64 and hash_partition_ids of the whole table, and of
    the sliced table's Arrow columns, as the JAX package hashes them, and
    as the same strings padded hash in the port."""
    jax_table, port_table = tables[name]
    cols = range(port_table.num_columns)
    if name == "sliced":
        cols = [i for i in cols if port_table.columns[i].dtype.is_string]
    jc = [jax_table.columns[i] for i in cols]
    pc = [port_table.columns[i] for i in cols]
    mm3 = ph.murmur3_hash(pc, device=CPU)
    np.testing.assert_array_equal(
        mm3.numpy(), np.asarray(jh.murmur3_hash(jc, bucket=None)))
    np.testing.assert_array_equal(
        ph.xxhash64(pc, 7, device=CPU).numpy(),
        xx_as_int64(jh.xxhash64(jc, 7, bucket=None)))
    np.testing.assert_array_equal(
        ph.hash_partition_ids(pc, 200, device=CPU).numpy(),
        np.asarray(jh.hash_partition_ids(jc, 200, bucket=None)))
    padded = [c.to_padded() for c in pc]
    assert torch.equal(ph.murmur3_hash(padded, device=CPU), mm3)


def test_get_json_object_on_arrow_matches_jax():
    """An Arrow column and a slice of it (offsets from 12), in the window
    of their longest document or of max_str_len: the JAX package's padded
    answer, the host fixup's rows (a container, a non-ASCII string)
    included."""
    docs = ['{"a": 1, "b": {"c": "x\\\\ny"}}', None, '{"a": [1, 2]}',
            '{"b": 2}', 'not json', '{"a": "日本"}', '', '{"a": {"d": 3}}']
    jcol, pcol = jt.Column.strings(docs), pt.Column.strings(docs, device=CPU)
    sliced = pt.slice_table(pt.Table((pcol,)), 2, 8).columns[0]
    jsliced = jt.slice_table(jt.Table((jcol,)), 2, 8).columns[0]
    # one window for the JAX side (it compiles a program a window); the
    # port's own for the whole column, 40 for the slice
    for jc, pc, width in ((jcol, pcol, None), (jsliced, sliced, 40)):
        got = pgj.get_json_object(pc, "$.a", width, device=CPU)
        want = jgj.get_json_object(jc, "$.a", 40, bucket=None)
        assert got.is_padded
        assert got.to_arrow().chars.numpy().tobytes() == \
            np.asarray(want.to_arrow().chars).tobytes()
        np.testing.assert_array_equal(got.valid_bools().numpy(),
                                      np.asarray(want.valid_bools()))
        np.testing.assert_array_equal(got.lens.numpy(),
                                      np.asarray(want.str_lens()))
    with pytest.raises(ValueError, match="do not fit"):
        pgj.get_json_object(pcol, "$.a", 8, device=CPU)


def test_random_table_arrow_layout():
    """string_layout="arrow" gives the padded table's strings, lengths and
    nulls in Arrow layout."""
    dtypes = [pt.INT32, STRING, STRING]
    padded = random_table(dtypes, 300, seed=3, null_probability=0.2,
                          string_lens=(1, 30), device=CPU)
    arrow = random_table(dtypes, 300, seed=3, null_probability=0.2,
                         string_lens=(1, 30), string_layout="arrow",
                         device=CPU)
    for p, a in zip(padded.columns[1:], arrow.columns[1:]):
        assert not a.is_padded and int(a.offsets[0]) == 0
        assert torch.equal(a.str_lens(), p.lens)
    pt.assert_tables_equivalent(padded, arrow, check_nulls=False)
    with pytest.raises(ValueError, match="string_layout"):
        random_table(dtypes, 3, string_layout="ragged", device=CPU)


def test_interop_carries_arrow_columns(tables):
    jax_table, port_table = tables["sliced"]
    arrays = interop.table_to_numpy_columns(port_table)
    assert arrays[1][1].ndim == 1 and arrays[1][1][0] == 0
    again = interop.table_from_numpy_columns(arrays, CPU)
    assert_same_columns(again, jax_table)
    rows = prc.convert_to_rows(port_table, device=CPU)[0]
    data, offsets, rs, widths = interop.rows_to_numpy(rows)
    assert rs is None and widths is None and data.ndim == 1


# ---------------------------------------------------------------------------
# The host C++ row engine
# ---------------------------------------------------------------------------

@pytest.fixture
def libsrj():
    if not LIBSRJ.exists():
        pytest.skip(f"{LIBSRJ.name} not built")
    lib = ctypes.CDLL(str(LIBSRJ))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.srj_rows_variable_sizes.restype = i64
    lib.srj_rows_variable_sizes.argtypes = [i32, i64, vp, vp, vp, vp]
    lib.srj_rows_encode_variable.restype = ctypes.c_int
    lib.srj_rows_encode_variable.argtypes = [i32, i64, vp, vp, vp, vp, vp,
                                             vp, vp, vp]
    lib.srj_rows_decode_variable.restype = ctypes.c_int
    lib.srj_rows_decode_variable.argtypes = [i32, i64, vp, vp, vp, vp, vp,
                                             vp, vp, vp]
    return lib


def _ptrs(arrays):
    """A C array of the arrays' data pointers (null for None)."""
    return (ctypes.c_void_p * max(len(arrays), 1))(
        *[None if a is None else a.ctypes.data for a in arrays])


def _native_columns(port_table):
    """Each column's host bytes (None for strings), validity, and each
    string column's offsets rebased to 0 and its chars."""
    cols, valid, soffs, schars = [], [], [], []
    for c in interop.table_to_numpy_columns(port_table):
        valid.append(c[-1])
        if c[0] == "string":
            cols.append(None)
            soffs.append(np.ascontiguousarray(c[1]))
            schars.append(np.ascontiguousarray(c[2]))
        else:
            cols.append(np.ascontiguousarray(c[1]).view(np.uint8))
    return cols, valid, soffs, schars


@pytest.mark.parametrize("name", ["mixed", "non_ascii", "sliced"])
def test_compact_rows_match_native_engine(tables, encoded, libsrj, name):
    """The port's compact blob is the host engine's encode of the same
    columns, and the host engine's decode of it gives the port's
    decoded columns."""
    _, port_table = tables[name]
    n = port_table.num_rows
    itemsizes = np.array([d.itemsize for d in port_table.dtypes], np.int32)
    is_string = np.array([d.is_string for d in port_table.dtypes], np.uint8)
    cols, valid, soffs, schars = _native_columns(port_table)
    sizes = np.zeros(n, np.int64)
    total = libsrj.srj_rows_variable_sizes(
        len(itemsizes), n, itemsizes.ctypes.data, is_string.ctypes.data,
        _ptrs(soffs), sizes.ctypes.data)
    row_offsets = np.zeros(n + 1, np.int64)
    np.cumsum(sizes, out=row_offsets[1:])
    want = np.zeros(total, np.uint8)
    assert libsrj.srj_rows_encode_variable(
        len(itemsizes), n, itemsizes.ctypes.data, is_string.ctypes.data,
        _ptrs(cols), _ptrs(valid), _ptrs(soffs), _ptrs(schars),
        row_offsets.ctypes.data, want.ctypes.data) == 0
    rows = encoded[name][0][0]
    np.testing.assert_array_equal(rows.offsets.numpy(), row_offsets)
    np.testing.assert_array_equal(rows.data.numpy(), want)

    dcols = [None if d.is_string else np.zeros(n * d.itemsize, np.uint8)
             for d in port_table.dtypes]
    dvalid = [np.zeros((n + 7) // 8, np.uint8) for _ in port_table.dtypes]
    doffs = [np.zeros(n + 1, np.int32) for _ in soffs]
    args = (len(itemsizes), n, itemsizes.ctypes.data, is_string.ctypes.data,
            want.ctypes.data, row_offsets.ctypes.data)
    assert libsrj.srj_rows_decode_variable(
        *args, _ptrs(dcols), _ptrs(dvalid), _ptrs(doffs), None) == 0
    dchars = [np.zeros(int(o[-1]), np.uint8) for o in doffs]
    assert libsrj.srj_rows_decode_variable(
        *args, None, None, _ptrs(doffs), _ptrs(dchars)) == 0
    mine = interop.table_to_numpy_columns(
        prc.convert_from_rows(rows, port_table.dtypes, device=CPU))
    si = 0
    for i, c in enumerate(mine):
        np.testing.assert_array_equal(
            np.unpackbits(dvalid[i], bitorder="little")[:n],
            np.unpackbits(c[-1], bitorder="little")[:n]
            if c[-1] is not None else np.ones(n, np.uint8))
        if c[0] == "string":
            np.testing.assert_array_equal(doffs[si], c[1])
            np.testing.assert_array_equal(dchars[si], c[2])
            si += 1
        else:
            np.testing.assert_array_equal(dcols[i], c[1].view(np.uint8))
