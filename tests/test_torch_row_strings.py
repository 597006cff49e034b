"""PyTorch port, dense-padded string row conversion, held against the JAX
package's ``ops/row_conversion.py`` on the same seeded numpy data: padded
JCUDF bytes, batch splits and offsets, decoded values, nulls, lengths and
chars, and the compact wire bytes of ``compact_rows_host``; then against
the host C++ row engine (``srj_rows_{encode,decode}_variable``), loaded by
path with ctypes.

The JAX calls take ``bucket=None`` and share a few shapes: each new shape
compiles a program on the CPU."""

import ctypes
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import table as jt
from spark_rapids_jni_tpu.ops import row_conversion as jrc
from spark_rapids_jni_tpu_torch import STRING, interop
from spark_rapids_jni_tpu_torch import table as pt
from spark_rapids_jni_tpu_torch.ops import row_conversion as prc
from spark_rapids_jni_tpu_torch.ops.row_layout import compute_row_layout
from spark_rapids_jni_tpu_torch.utils import random_table
from tests._torch_port import (
    assert_same_batches, assert_same_columns, both_string_columns,
    jax_dtype, numpy_columns,
)

CPU = "cpu"
FIXED = ["int64", "int32", "int16", "int8", "bool8", "float64"]
N = 77
# three string columns of widths 0, 4 and 32 between the fixed ones
WIDTHS = (0, 4, 32)
NON_ASCII = ["", None, "déf", "日本語", "🙂🙂", "a", "", "ünïcödé…"]
LIBSRJ = (Path(__file__).resolve().parents[1] / "spark_rapids_jni_tpu"
          / "_native" / "libsrj_tpu.so")


def _mixed_tables(rng, n, null_mode="some", widths=WIDTHS):
    """The same table in both packages: FIXED, with a padded string column
    of each width after the first, third and fifth fixed column."""
    fixed = numpy_columns(rng, FIXED, n, null_mode)
    strings = [both_string_columns(rng, n, w, null_mode) for w in widths]
    jcols, pcols = [], []
    for i, (name, vals, ok) in enumerate(fixed):
        jcols.append(jt.Column.from_numpy(vals, jax_dtype(name), ok))
        pcols.append(pt.Column.from_numpy(vals, pt.dtype_from_name(name), ok,
                                          device=CPU))
        if i % 2 == 0 and i // 2 < len(strings):
            jcols.append(strings[i // 2][0])
            pcols.append(strings[i // 2][1])
    return jt.Table(tuple(jcols)), pt.Table(tuple(pcols))


def _non_ascii_tables():
    n = len(NON_ASCII)
    vals = np.arange(n, dtype=np.int32)
    return (jt.Table((jt.Column.from_numpy(vals, jt.INT32),
                      jt.Column.strings_padded(NON_ASCII))),
            pt.Table((pt.Column.from_numpy(vals, pt.INT32, device=CPU),
                      pt.Column.strings_padded(NON_ASCII, device=CPU))))


def _encode_both(jax_table, port_table, size_limit=jrc.MAX_BATCH_BYTES):
    got = prc.convert_to_rows(port_table, size_limit=size_limit, device=CPU)
    want = jrc.convert_to_rows(jax_table, size_limit=size_limit,
                               bucket=None)
    assert_same_batches(got, want)
    for g, w in zip(got, want):
        assert g.is_padded and w.is_padded
        assert (g.row_size, g.str_widths) == (w.row_size, w.str_widths)
    return got, want


def _decode_matches_jax(got, want, jax_table, port_table):
    """Each port batch decodes as the JAX package decodes it; each
    package's batches, carried across to the other, decode the same; the
    batches together give back the input, lengths and chars included."""
    dtypes, jdtypes = port_table.dtypes, jax_table.dtypes
    start = 0
    for g, w in zip(got, want):
        mine = prc.convert_from_rows(g, dtypes, device=CPU)
        theirs = jrc.convert_from_rows(w, jdtypes, bucket=None)
        assert_same_columns(mine, theirs)
        carried = interop.rows_from_numpy(np.asarray(w.data),
                                          np.asarray(w.offsets), w.row_size,
                                          w.str_widths, device=CPU)
        assert_same_columns(prc.convert_from_rows(carried, dtypes,
                                                  device=CPU), theirs)
        data, offsets, rs, widths = interop.rows_to_numpy(g)
        back = jrc.convert_from_rows(
            jrc.RowsColumn(jnp.asarray(data), jnp.asarray(offsets), rs,
                           widths), jdtypes, bucket=None)
        assert_same_columns(mine, back)
        part = pt.slice_table(port_table, start, start + g.num_rows)
        pt.assert_tables_equivalent(mine, part, check_nulls=False)
        start += g.num_rows
    assert start == port_table.num_rows


@pytest.mark.parametrize("null_mode", ["some", "zero"])
def test_padded_round_trip_matches_jax(rng, null_mode):
    """Widths 0, 4 and 32; about 25% nulls, then every row null."""
    jax_table, port_table = _mixed_tables(rng, N, null_mode)
    got, want = _encode_both(jax_table, port_table)
    assert len(got) == 1 and got[0].str_widths == WIDTHS
    _decode_matches_jax(got, want, jax_table, port_table)


def test_padded_multi_batch_matches_jax(rng):
    """A size_limit of 32 rows: equal 32-row batches, as the JAX package
    splits them."""
    jax_table, port_table = _mixed_tables(rng, N)
    rs = prc.padded_variable_layout(compute_row_layout(port_table.dtypes),
                                    WIDTHS)[2]
    got, want = _encode_both(jax_table, port_table, size_limit=32 * rs)
    assert [b.num_rows for b in got] == [32, 32, 13]
    _decode_matches_jax(got, want, jax_table, port_table)


def test_padded_zero_rows_matches_jax(rng):
    jax_table, port_table = _mixed_tables(rng, 0)
    got, want = _encode_both(jax_table, port_table)
    assert len(got) == 1 and tuple(got[0].data.shape) == (0, got[0].row_size)
    decoded = prc.convert_from_rows(got[0], port_table.dtypes, device=CPU)
    assert decoded.num_rows == 0
    assert [c.chars2d.shape[1] for c in decoded.columns
            if c.dtype.is_string] == list(WIDTHS)


def test_empty_and_non_ascii_strings_match_jax():
    jax_table, port_table = _non_ascii_tables()
    got, want = _encode_both(jax_table, port_table)
    _decode_matches_jax(got, want, jax_table, port_table)
    decoded = prc.convert_from_rows(got[0], port_table.dtypes, device=CPU)
    chars, lens = decoded.columns[1].chars2d, decoded.columns[1].lens
    texts = [bytes(chars[i, :lens[i]].tolist()).decode("utf-8")
             for i in range(len(NON_ASCII))]
    valid = decoded.columns[1].valid_bools().tolist()
    assert [t if ok else None for t, ok in zip(texts, valid)] == NON_ASCII


def test_padded_slack_is_zeroed(rng):
    """Bytes past each length, in the input's char matrix and in a blob,
    never reach the output."""
    _, port_table = _mixed_tables(rng, N)
    k = 7                                   # the width-32 column
    scol = port_table.columns[k]
    w = scol.chars2d.shape[1]
    slack = torch.arange(w) >= scol.lens[:, None]
    dirty = scol.chars2d.clone()
    dirty[slack] = 0xEE
    cols = list(port_table.columns)
    cols[k] = pt.Column.padded_strings(dirty, scol.lens, scol.validity)
    clean = prc.convert_to_rows(port_table, device=CPU)[0]
    rows = prc.convert_to_rows(pt.Table(cols), device=CPU)[0]
    assert torch.equal(rows.data, clean.data)
    layout = compute_row_layout(port_table.dtypes)
    s = prc.padded_variable_layout(layout, WIDTHS)[0][2]
    blob = rows.data.clone()
    blob[:, s:s + w][slack] = 0xEE
    back = prc.convert_from_rows(prc.RowsColumn(
        blob, rows.offsets, rows.row_size, WIDTHS), port_table.dtypes,
        device=CPU)
    assert torch.equal(back.columns[k].chars2d, scol.chars2d)


@pytest.mark.parametrize("case", ["mixed", "non_ascii"])
def test_compact_rows_host_matches_jax(rng, case):
    if case == "mixed":
        jax_table, port_table = _mixed_tables(rng, N)
    else:
        jax_table, port_table = _non_ascii_tables()
    got, want = _encode_both(jax_table, port_table)
    compact = prc.compact_rows_host(got[0], port_table.dtypes, device=CPU)
    jcompact = jrc.compact_rows_host(want[0], jax_table.dtypes)
    assert not compact.is_padded
    np.testing.assert_array_equal(compact.offsets.numpy(),
                                  np.asarray(jcompact.offsets))
    np.testing.assert_array_equal(compact.data.numpy(),
                                  np.asarray(jcompact.data))
    # the compact blob's rows: the fixed section and then the chars
    layout = compute_row_layout(port_table.dtypes)
    lens = sum(c.lens.to(torch.int64) for c in port_table.columns
               if c.dtype.is_string)
    sizes = (layout.fixed_end + lens + 7) // 8 * 8
    assert torch.equal(compact.offsets[1:].to(torch.int64),
                       torch.cumsum(sizes, 0))
    # a batch that is not padded comes back as it is
    assert prc.compact_rows_host(compact, port_table.dtypes,
                                 device=CPU) is compact


def test_compact_rows_host_refuses_truncated_strings(rng):
    _, port_table = _mixed_tables(rng, N)
    rows = prc.convert_to_rows(port_table, device=CPU)[0]
    layout = compute_row_layout(port_table.dtypes)
    s = layout.variable_starts[1]           # the width-4 column's pair
    data = rows.data.clone()
    data[0, s + 4:s + 8] = torch.tensor([9, 0, 0, 0], dtype=torch.uint8)
    with pytest.raises(ValueError, match="longer than its padded width"):
        prc.compact_rows_host(prc.RowsColumn(data, rows.offsets,
                                             rows.row_size, rows.str_widths),
                              port_table.dtypes, device=CPU)


def test_padded_decode_rejects_wrong_layout(rng):
    _, port_table = _mixed_tables(rng, N)
    rows = prc.convert_to_rows(port_table, device=CPU)[0]
    rs = rows.row_size + 8
    wider = prc.RowsColumn(torch.zeros((N, rs), dtype=torch.uint8),
                           torch.arange(N + 1, dtype=torch.int32) * rs, rs,
                           rows.str_widths)
    fewer = prc.RowsColumn(rows.data, rows.offsets, rows.row_size,
                           rows.str_widths[:2])
    for bad in (wider, fewer):
        with pytest.raises(ValueError, match="not a padded layout"):
            prc.convert_from_rows(bad, port_table.dtypes, device=CPU)


@pytest.mark.parametrize("limit", [8192, 65536, 1 << 20])
def test_plan_variable_batches_matches_jax(limit):
    sizes = np.random.default_rng(limit).integers(8, 200, 1000) // 8 * 8
    assert prc.plan_variable_batches(sizes, limit) == \
        jrc.plan_variable_batches(sizes, limit)


def test_random_table_strings():
    """STRING columns of the generator: lengths uniform in the bounds, the
    width the upper bound rounded up to 4, zeros past each length, and the
    table's null probability."""
    t = random_table([pt.INT32, STRING, STRING], 4000, seed=7,
                     null_probability=0.5, string_lens=(3, 30), device=CPU)
    for c in t.columns[1:]:
        assert c.is_padded and c.chars2d.shape == (4000, 32)
        assert int(c.lens.min()) == 3 and int(c.lens.max()) == 30
        assert not c.chars2d[torch.arange(32) >= c.lens[:, None]].any()
        assert 0.45 < float(c.valid_bools().float().mean()) < 0.55
    assert not torch.equal(t.columns[1].chars2d, t.columns[2].chars2d)
    again = random_table([pt.INT32, STRING, STRING], 4000, seed=7,
                         null_probability=0.5, string_lens=(3, 30),
                         device=CPU)
    pt.assert_tables_equivalent(t, again, check_nulls=False)


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


def _schema(table):
    itemsizes = np.array([d.itemsize for d in table.dtypes], np.int32)
    is_string = np.array([d.is_string for d in table.dtypes], np.uint8)
    return itemsizes, is_string


def _arrow_strings(col):
    """(int32 offsets [n + 1], flat chars) of a padded string column."""
    lens = col.lens.numpy().astype(np.int64)
    offsets = np.zeros(len(lens) + 1, np.int32)
    np.cumsum(lens, out=offsets[1:])
    chars2d = col.chars2d.numpy()
    keep = np.arange(chars2d.shape[1])[None, :] < lens[:, None]
    return offsets, np.ascontiguousarray(chars2d[keep])


def test_compacted_blob_matches_native_encode(rng, libsrj):
    _, port_table = _mixed_tables(rng, N)
    itemsizes, is_string = _schema(port_table)
    cols, valid, soffs, schars = [], [], [], []
    for c in port_table.columns:
        valid.append(None if c.validity is None else c.validity.numpy())
        if c.dtype.is_string:
            cols.append(None)
            o, ch = _arrow_strings(c)
            soffs.append(o)
            schars.append(ch)
        else:
            cols.append(c.to_numpy().view(np.uint8))
    sizes = np.zeros(N, np.int64)
    total = libsrj.srj_rows_variable_sizes(
        len(itemsizes), N, itemsizes.ctypes.data, is_string.ctypes.data,
        _ptrs(soffs), sizes.ctypes.data)
    assert total > 0
    row_offsets = np.zeros(N + 1, np.int64)
    np.cumsum(sizes, out=row_offsets[1:])
    want = np.zeros(total, np.uint8)
    assert libsrj.srj_rows_encode_variable(
        len(itemsizes), N, itemsizes.ctypes.data, is_string.ctypes.data,
        _ptrs(cols), _ptrs(valid), _ptrs(soffs), _ptrs(schars),
        row_offsets.ctypes.data, want.ctypes.data) == 0
    padded = prc.convert_to_rows(port_table, device=CPU)[0]
    compact = prc.compact_rows_host(padded, port_table.dtypes, device=CPU)
    np.testing.assert_array_equal(compact.offsets.numpy(), row_offsets)
    np.testing.assert_array_equal(compact.data.numpy(), want)


def test_native_decode_reads_padded_blob(rng, libsrj):
    _, port_table = _mixed_tables(rng, N)
    rows = prc.convert_to_rows(port_table, device=CPU)[0]
    itemsizes, is_string = _schema(port_table)
    blob = np.ascontiguousarray(rows.data.numpy().reshape(-1))
    row_offsets = np.arange(N + 1, dtype=np.int64) * rows.row_size
    cols = [None if d.is_string else np.zeros(N * d.itemsize, np.uint8)
            for d in port_table.dtypes]
    valid = [np.zeros((N + 7) // 8, np.uint8) for _ in port_table.dtypes]
    strings = [c for c in port_table.columns if c.dtype.is_string]
    soffs = [np.zeros(N + 1, np.int32) for _ in strings]
    args = (len(itemsizes), N, itemsizes.ctypes.data, is_string.ctypes.data,
            blob.ctypes.data, row_offsets.ctypes.data)
    assert libsrj.srj_rows_decode_variable(
        *args, _ptrs(cols), _ptrs(valid), _ptrs(soffs), None) == 0
    chars = [np.zeros(int(o[-1]), np.uint8) for o in soffs]
    assert libsrj.srj_rows_decode_variable(
        *args, None, None, _ptrs(soffs), _ptrs(chars)) == 0
    si = 0
    for i, c in enumerate(port_table.columns):
        np.testing.assert_array_equal(
            np.unpackbits(valid[i], bitorder="little")[:N],
            c.valid_bools().numpy())
        if c.dtype.is_string:
            o, ch = _arrow_strings(c)
            np.testing.assert_array_equal(soffs[si], o)
            np.testing.assert_array_equal(chars[si], ch)
            si += 1
        else:
            np.testing.assert_array_equal(cols[i], c.to_numpy().view(np.uint8))
