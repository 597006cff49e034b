"""PyTorch port, fixed-width JCUDF rows held against the host C++ row engine
(``native/src/c_api.cpp``): the row layout (``srj_row_layout``), the batch
plan (``srj_plan_fixed_batches``) and the row bytes of both directions
(``srj_rows_encode_fixed``, ``srj_rows_decode_fixed``), on the same seeded
numpy columns.  The engine is loaded by path with ctypes."""

import ctypes
from pathlib import Path

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu_torch import table as pt
from spark_rapids_jni_tpu_torch.ops import row_conversion as prc
from spark_rapids_jni_tpu_torch.ops.row_layout import (
    MAX_BATCH_BYTES, compute_row_layout,
)
from tests._torch_port import (
    ALL_FIXED_NAMES, NULL_MODES, WIDE_NAMES, port_table,
)

CPU = "cpu"
LIBSRJ = (Path(__file__).resolve().parents[1] / "spark_rapids_jni_tpu"
          / "_native" / "libsrj_tpu.so")
SCHEMAS = {"all_fixed": ALL_FIXED_NAMES, "wide212": WIDE_NAMES,
           "one_int8": ["int8"], "odd_int16": ["int16"] * 3,
           "int64_pair": ["int64", "int64"]}
# layouts only: string slots beside fixed-width columns
STRING_SCHEMAS = {"strings_mixed": ["int8", "string", "int64", "string",
                                    "int16", "bool8", "string"],
                  "string_only": ["string"]}


@pytest.fixture(scope="module")
def libsrj():
    if not LIBSRJ.exists():
        pytest.skip(f"{LIBSRJ.name} not built")
    lib = ctypes.CDLL(str(LIBSRJ))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.srj_row_layout.restype = ctypes.c_int
    lib.srj_row_layout.argtypes = [i32, vp, vp, vp, vp, vp]
    lib.srj_plan_fixed_batches.restype = i64
    lib.srj_plan_fixed_batches.argtypes = [i64, i32, i64, vp, i64]
    lib.srj_rows_encode_fixed.restype = ctypes.c_int
    lib.srj_rows_encode_fixed.argtypes = [i32, i64, vp, vp, vp, vp, vp]
    lib.srj_rows_decode_fixed.restype = ctypes.c_int
    lib.srj_rows_decode_fixed.argtypes = [i32, i64, vp, vp, vp, vp, vp]
    lib.srj_last_error.restype = ctypes.c_char_p
    return lib


def _schema(dtypes):
    itemsizes = np.array([8 if d.is_string else d.itemsize for d in dtypes],
                         np.int32)
    is_string = np.array([d.is_string for d in dtypes], np.uint8)
    return itemsizes, is_string


def _ptrs(arrays):
    """A C array of the arrays' data pointers (null for None)."""
    return (ctypes.c_void_p * max(len(arrays), 1))(
        *[None if a is None else a.ctypes.data for a in arrays])


def _native_encode(lib, table) -> np.ndarray:
    itemsizes, is_string = _schema(table.dtypes)
    cols = [np.ascontiguousarray(c.to_numpy()) for c in table.columns]
    valid = [None if c.validity is None else c.validity.numpy()
             for c in table.columns]
    layout = compute_row_layout(table.dtypes)
    out = np.full(table.num_rows * layout.fixed_row_size, 0xA5, np.uint8)
    rc = lib.srj_rows_encode_fixed(
        table.num_columns, table.num_rows, itemsizes.ctypes.data,
        is_string.ctypes.data, _ptrs(cols), _ptrs(valid), out.ctypes.data)
    assert rc == 0, lib.srj_last_error()
    return out.reshape(table.num_rows, layout.fixed_row_size)


def _native_decode(lib, rows: np.ndarray, dtypes, n: int):
    """(values, packed validity) per column of ``n`` rows."""
    itemsizes, is_string = _schema(dtypes)
    cols = [np.zeros(n, d.np_dtype) for d in dtypes]
    valid = [np.zeros((n + 7) // 8, np.uint8) for _ in dtypes]
    rows = np.ascontiguousarray(rows, np.uint8)
    rc = lib.srj_rows_decode_fixed(
        len(dtypes), n, itemsizes.ctypes.data, is_string.ctypes.data,
        rows.ctypes.data, _ptrs(cols), _ptrs(valid))
    assert rc == 0, lib.srj_last_error()
    return cols, valid


def _native_plan(lib, nrows, row_size, size_limit):
    bounds = np.zeros(nrows // 32 + 64, np.int64)
    got = lib.srj_plan_fixed_batches(nrows, row_size, size_limit,
                                     bounds.ctypes.data, len(bounds))
    if got < 0:
        return None
    b = [int(x) for x in bounds[:got]]
    return list(zip(b[:-1], b[1:]))


@pytest.mark.parametrize("schema", sorted(SCHEMAS) + sorted(STRING_SCHEMAS))
def test_layout_matches_native(libsrj, schema):
    names = {**SCHEMAS, **STRING_SCHEMAS}[schema]
    dtypes = [pt.dtype_from_name(n) for n in names]
    itemsizes, is_string = _schema(dtypes)
    n = len(dtypes)
    starts, sizes = np.zeros(n, np.int32), np.zeros(n, np.int32)
    meta = np.zeros(3, np.int32)
    assert libsrj.srj_row_layout(n, itemsizes.ctypes.data,
                                 is_string.ctypes.data, starts.ctypes.data,
                                 sizes.ctypes.data, meta.ctypes.data) == 0
    layout = compute_row_layout(dtypes)
    assert layout.col_starts == tuple(starts.tolist())
    assert layout.col_sizes == tuple(sizes.tolist())
    assert (layout.validity_offset, layout.validity_bytes,
            layout.fixed_row_size) == tuple(meta.tolist())


@pytest.mark.parametrize("nrows, row_size, size_limit", [
    (0, 16, MAX_BATCH_BYTES), (1000, 1008, MAX_BATCH_BYTES),
    (5_000_000, 1008, MAX_BATCH_BYTES), (100, 16, 512), (20, 8, 200),
    (4096 + 17, 24, 24 * 1000), (33, 8, 100), (100, 8, 255)])
def test_batch_plan_matches_native(libsrj, nrows, row_size, size_limit):
    """Equal bounds, and the same refusals (a limit that holds no 32-row
    batch: the engine returns -1, the port raises ValueError)."""
    want = _native_plan(libsrj, nrows, row_size, size_limit)
    if want is None:
        with pytest.raises(ValueError, match="32-row-aligned"):
            prc.plan_fixed_batches(nrows, row_size, size_limit)
    else:
        assert prc.plan_fixed_batches(nrows, row_size, size_limit) == want


@pytest.mark.parametrize("null_mode", NULL_MODES)
@pytest.mark.parametrize("schema", sorted(SCHEMAS))
def test_rows_match_native_both_ways(libsrj, schema, null_mode):
    """The port's blob equals the engine's byte for byte; each side decodes
    the other's rows to the same values (bits, under nulls too) and masks."""
    rng = np.random.default_rng(len(schema) * 7 + len(null_mode))
    t = port_table(rng, SCHEMAS[schema], 77, null_mode)
    dtypes = t.dtypes
    want = _native_encode(libsrj, t)
    [rows] = prc.convert_to_rows(t, device=CPU)
    np.testing.assert_array_equal(rows.data.numpy().reshape(want.shape), want)
    vals, valid = _native_decode(libsrj, rows.data.numpy(), dtypes, 77)
    offsets = torch.arange(78, dtype=torch.int32) * want.shape[1]
    back = prc.convert_from_rows(
        prc.RowsColumn(torch.from_numpy(want.copy()), offsets), dtypes,
        device=CPU)
    for i, (c, b, v, m) in enumerate(zip(t.columns, back.columns, vals,
                                         valid)):
        np.testing.assert_array_equal(v.view(np.uint8),
                                      c.to_numpy().view(np.uint8),
                                      err_msg=f"native decode column {i}")
        np.testing.assert_array_equal(b.to_numpy().view(np.uint8),
                                      v.view(np.uint8),
                                      err_msg=f"port decode column {i}")
        mask = np.packbits(c.valid_bools().numpy(), bitorder="little")
        np.testing.assert_array_equal(m, mask, err_msg=f"native mask {i}")
        np.testing.assert_array_equal(
            np.packbits(b.valid_bools().numpy(), bitorder="little"), m,
            err_msg=f"port mask {i}")


@pytest.mark.parametrize("schema", ["all_fixed", "wide212"])
def test_batches_match_native_slices(libsrj, schema):
    """Under a size limit, each port batch is the engine's planned slice of
    the engine's blob; zero rows give one empty batch and an empty blob."""
    rng = np.random.default_rng(3)
    t = port_table(rng, SCHEMAS[schema], 1200)
    rs = compute_row_layout(t.dtypes).fixed_row_size
    limit = rs * 300
    want = _native_encode(libsrj, t)
    plan = _native_plan(libsrj, 1200, rs, limit)
    batches = prc.convert_to_rows(t, size_limit=limit, device=CPU)
    assert [b.num_rows for b in batches] == [e - s for s, e in plan]
    for (s, e), b in zip(plan, batches):
        np.testing.assert_array_equal(b.data.numpy().reshape(e - s, rs),
                                      want[s:e])
    empty = pt.slice_table(t, 0, 0)
    assert _native_encode(libsrj, empty).size == 0
    [rows] = prc.convert_to_rows(empty, device=CPU)
    assert rows.num_rows == 0 and rows.data.numel() == 0
    assert _native_plan(libsrj, 0, rs, limit) == [(0, 0)]
