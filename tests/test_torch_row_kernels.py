"""PyTorch port, the per-column-block row engine (``ops/row_kernels.py``,
K10 and K11 through their plain versions on the CPU), the generic
``impl="xla"`` engine, the shape-bucket pad and unpad helpers and decimal128
columns, held against the JAX package on the same seeded numpy data: its
``row_kernels`` (the Pallas K10/K11 in interpret mode), its ``impl="xla"``
engine, its ``runtime.shapes`` helpers and its decimal128 round trips.  JCUDF
bytes compare exactly, decoded columns by bits and nulls."""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import table as jt
from spark_rapids_jni_tpu.ops import decimal as jdec
from spark_rapids_jni_tpu.ops import row_conversion as jrc
from spark_rapids_jni_tpu.ops import row_kernels as jrk
from spark_rapids_jni_tpu.ops.row_layout import (
    compute_row_layout as jax_layout,
)
from spark_rapids_jni_tpu.runtime import shapes as jshapes
from spark_rapids_jni_tpu_torch import INT8, INT32, Column, Table, interop
from spark_rapids_jni_tpu_torch.ops import decimal as pdec
from spark_rapids_jni_tpu_torch.ops import hashing, kernels
from spark_rapids_jni_tpu_torch.ops import row_conversion as prc
from spark_rapids_jni_tpu_torch.ops import row_kernels as prk
from spark_rapids_jni_tpu_torch.ops.row_layout import compute_row_layout
from spark_rapids_jni_tpu_torch.runtime import shapes
from spark_rapids_jni_tpu_torch.table import (
    assert_tables_equivalent, decimal128, slice_table, slice_table_dynamic,
)
from tests._torch_port import (
    ALL_FIXED_NAMES, assert_same_batches, assert_same_columns,
    both_string_columns, numpy_columns, tables_from_columns,
)

CPU = "cpu"
# 37 rows of six columns: INT64, BOOL8 and two decimal128 among them
SIX = ["int32", "decimal128(scale=2)", "int8", "int64", "bool8",
       "decimal128(scale=0)"]
SHAPES = {"six_37": (SIX, 37), "all_fixed_100": (ALL_FIXED_NAMES, 100)}
# DECIMAL(38) edges of the JAX package's all-engine round trip
DEC_VALUES = [0, 1, -1, 10 ** 38 - 1, -(10 ** 38 - 1), 12345678901234567890]


@pytest.fixture(scope="module")
def inputs():
    """Per shape: (JAX table, port table, JAX layout, port layout), and
    the JAX K10's rows of each, unbucketed: made once, since an
    interpreted kernel call takes about a second."""
    out = {}
    for key, (names, n) in SHAPES.items():
        cols = numpy_columns(np.random.default_rng(n), names, n)
        jtab, ptab = tables_from_columns(cols)
        jl = jax_layout(jtab.dtypes)
        rows = np.asarray(jrk.to_rows_fixed(jtab, jl, interpret=True,
                                            bucket=None))
        out[key] = (jtab, ptab, jl, compute_row_layout(ptab.dtypes), rows)
    return out


@pytest.mark.parametrize("bucket", [None, "auto"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_to_rows_fixed_matches_jax_kernel(inputs, shape, bucket):
    """K10's plain version gives the Pallas K10's bytes, over the table as
    it is and padded to its bucket (64 and 128 rows) and sliced back."""
    jtab, ptab, jl, pl, want = inputs[shape]
    if bucket is not None:
        want = np.asarray(jrk.to_rows_fixed(jtab, jl, interpret=True,
                                            bucket=bucket))
    got = prk.to_rows_fixed(ptab, pl, bucket=bucket, device=CPU)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bucket", [None, "auto"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_from_rows_fixed_matches_jax_kernel(inputs, shape, bucket):
    """K11's plain version decodes the same rows to the Pallas K11's
    columns (values by bits under nulls too, packed masks byte for byte),
    and back to the input table."""
    jtab, ptab, jl, pl, rows = inputs[shape]
    want = jrk.from_rows_fixed(rows, jl, interpret=True, bucket=bucket)
    got = prk.from_rows_fixed(torch.from_numpy(rows.copy()), pl,
                              bucket=bucket, device=CPU)
    assert_same_columns(Table(got), jt.Table(tuple(want)))
    assert_tables_equivalent(ptab, Table(got), check_nulls=False)


def test_to_rows_fixed_batch_matches_jax_kernel(inputs):
    """One batch at start 32, read in place, gives the JAX batch's bytes;
    at an odd start and at one that is not a multiple of 8 it gives the
    whole table's rows there."""
    jtab, ptab, jl, pl, rows = inputs["all_fixed_100"]
    want = np.asarray(jrk.to_rows_fixed_batch(jtab, jl, 32, 64, True))
    got = prk.to_rows_fixed_batch(ptab, pl, 32, 64, device=CPU)
    np.testing.assert_array_equal(got.numpy(), want)
    for start, size in ((1, 61), (13, 87), (99, 1), (50, 0)):
        got = prk.to_rows_fixed_batch(ptab, pl, start, size, device=CPU)
        np.testing.assert_array_equal(got.numpy(), rows[start:start + size])


@pytest.mark.parametrize("kwargs", [{"impl": "xla"}, {"use_pallas": False}])
def test_xla_engine_matches_jax(inputs, kwargs):
    """The generic engine's batches (one, then four under a tight
    size_limit) equal the JAX ``impl="xla"`` engine's bytes and offsets,
    and its decode gives the JAX decode's columns."""
    jtab, ptab, jl, pl, _ = inputs["all_fixed_100"]
    limit = 40 * pl.fixed_row_size
    for size_limit in (prc.MAX_BATCH_BYTES, limit):
        want = jrc.convert_to_rows(jtab, size_limit=size_limit, bucket=None,
                                   **kwargs)
        got = prc.convert_to_rows(ptab, size_limit=size_limit, device=CPU,
                                  **kwargs)
        assert_same_batches(got, want)
    assert [b.num_rows for b in got] == [32, 32, 32, 4]
    back = prc.convert_from_rows(got[1], ptab.dtypes, device=CPU, **kwargs)
    assert_same_columns(back, jrc.convert_from_rows(
        want[1], jtab.dtypes, bucket=None, **kwargs))
    assert_tables_equivalent(slice_table(ptab, 32, 64), back,
                             check_nulls=False)


def test_pad_and_unpad_match_jax():
    """pad_table: a column without a mask gains a prefix mask, one with a
    mask a zero tail, a padded string column zero-length tail rows, the
    data zeros; unpad_column, unpad_array and unpad_result slice back;
    slice_table_dynamic slices masks as bytes, as the JAX helpers do."""
    rng = np.random.default_rng(7)
    cols = numpy_columns(rng, ["int64", "int16"], 13, "none") \
        + numpy_columns(rng, ["decimal128(scale=3)", "bool8"], 13, "some")
    jtab, ptab = tables_from_columns(cols)
    js, ps = both_string_columns(rng, 13, 9)
    jtab = jt.Table(jtab.columns + (js,))
    ptab = Table(ptab.columns + (ps,))
    assert shapes.bucketable(ptab) and jshapes.bucketable(jtab)
    assert shapes.bucket_rows(13) == jshapes.bucket_rows(13) == 16
    got, want = shapes.pad_table(ptab, 16), jshapes.pad_table(jtab, 16)
    assert_same_columns(got, want)
    assert all(c.validity is not None for c in got.columns)
    np.testing.assert_array_equal(
        shapes.prefix_mask(13, 16, CPU).numpy(),
        np.asarray(jshapes.prefix_mask(13, 16)))
    assert_same_columns(
        Table(tuple(shapes.unpad_column(c, 13) for c in got.columns)),
        jt.Table(tuple(jshapes.unpad_column(c, 13) for c in want.columns)))
    rows = torch.arange(32).view(16, 2)
    assert torch.equal(shapes.unpad_array(rows, 13), rows[:13])
    col, arr, other = shapes.unpad_result((got.columns[3], rows, 5), 13)
    assert col.num_rows == 13 and arr.shape == (13, 2) and other == 5
    assert_same_columns(slice_table_dynamic(got, 8, 5),
                        jt.slice_table_dynamic(want, 8, 5))
    with pytest.raises(ValueError, match="multiple of 8"):
        slice_table_dynamic(got, 3, 5)


def test_decimal128_ints_and_alignment():
    """from_ints/to_ints agree with the JAX package's limbs both ways, and
    cross interop as uint32 limbs; a 1-byte column before a decimal128
    forces 15 padding bytes."""
    valid = [1, 1, 0, 1, 1, 1]
    p = pdec.decimal128_from_ints(DEC_VALUES, 2, valid, device=CPU)
    j = jdec.decimal128_from_ints(DEC_VALUES, 2, valid)
    np.testing.assert_array_equal(p.to_numpy(), np.asarray(j.data))
    want = jdec.decimal128_to_ints(j)
    assert pdec.decimal128_to_ints(p) == want
    assert want[2] is None and want[3] == 10 ** 38 - 1
    [(name, limbs, validity)] = interop.table_to_numpy_columns(Table((p,)))
    assert name == "decimal128(scale=2)" and limbs.dtype == np.uint32
    back = interop.table_from_numpy_columns([(name, limbs, validity)],
                                            device=CPU)
    assert pdec.decimal128_to_ints(back.columns[0]) == want
    lay = compute_row_layout([INT8, decimal128(0), INT8])
    assert lay.col_starts == (0, 16, 32) and lay.col_sizes == (1, 16, 1)
    assert lay.col_starts == jax_layout([jt.INT8, jdec.decimal128(0),
                                         jt.INT8]).col_starts


def test_decimal128_row_roundtrip_all_engines():
    """The JAX package's decimal128 table on every engine of the port
    (mxu: K1/K2, pallas: K4/K5, xla, the gather oracle, row_kernels:
    K10/K11, the grouped backing): the JAX ``impl="xla"`` bytes, and the
    values back."""
    jtab = jt.Table((
        jt.Column.from_numpy(np.arange(6, dtype=np.int32), jt.INT32,
                             valid=np.array([1, 1, 0, 1, 1, 1], bool)),
        jdec.decimal128_from_ints(DEC_VALUES, 2),
        jt.Column.from_numpy(np.arange(6, dtype=np.int8), jt.INT8)))
    ptab = Table((
        Column.from_numpy(np.arange(6, dtype=np.int32), INT32,
                          np.array([1, 1, 0, 1, 1, 1], bool), device=CPU),
        pdec.decimal128_from_ints(DEC_VALUES, 2, device=CPU),
        Column.from_numpy(np.arange(6, dtype=np.int8), INT8, device=CPU)))
    [want] = jrc.convert_to_rows(jtab, impl="xla", bucket=None)
    want = np.asarray(want.data).reshape(-1)
    expect = jdec.decimal128_to_ints(jtab.columns[1])
    pl = compute_row_layout(ptab.dtypes)
    for impl in ("mxu", "pallas", "xla"):
        [rows] = prc.convert_to_rows(ptab, impl=impl, device=CPU)
        np.testing.assert_array_equal(rows.data.numpy().reshape(-1), want)
        back = prc.convert_from_rows(rows, ptab.dtypes, impl=impl,
                                     device=CPU)
        assert pdec.decimal128_to_ints(back.columns[1]) == expect, impl
        assert_tables_equivalent(ptab, back)
    [orows] = prc.convert_to_rows_fixed_width_optimized(ptab, device=CPU)
    np.testing.assert_array_equal(orows.data.numpy().reshape(-1), want)
    oback = prc.convert_from_rows_fixed_width_optimized(orows, ptab.dtypes,
                                                        device=CPU)
    assert pdec.decimal128_to_ints(oback.columns[1]) == expect
    krows = prk.to_rows_fixed(ptab, pl, device=CPU)
    np.testing.assert_array_equal(krows.numpy().reshape(-1), want)
    kback = prk.from_rows_fixed(krows, pl, device=CPU)
    assert pdec.decimal128_to_ints(kback[1]) == expect
    gc = prc.convert_from_rows_grouped(orows, ptab.dtypes, device=CPU)
    assert pdec.decimal128_to_ints(gc.column(1)) == expect


def test_decimal128_past_the_cap_and_hashing_raise(monkeypatch):
    """The two-stage encode above the resident-pack cap takes columns of
    1, 2, 4 and 8 bytes only (the JAX pack kernel has no 16-byte class),
    and the port does not hash decimal128 yet: both raise ValueError."""
    ptab = Table((pdec.decimal128_from_ints(DEC_VALUES, 2, device=CPU),))
    monkeypatch.setattr(prc, "_FUSED_PREP_CAP", 0)
    with pytest.raises(ValueError, match="1, 2, 4 and 8 bytes"):
        prc.convert_to_rows(ptab, device=CPU)
    layout = compute_row_layout(ptab.dtypes)
    with pytest.raises(ValueError, match="1, 2, 4 and 8 bytes"):
        kernels.pack_planes(ptab, layout, 0, 6)
    for fn in (hashing.murmur3_hash, hashing.xxhash64):
        with pytest.raises(ValueError, match="queue 1, item 3"):
            fn(ptab, device=CPU)
    with pytest.raises(ValueError, match="queue 1, item 3"):
        hashing.hash_partition_ids(ptab, 200, device=CPU)
