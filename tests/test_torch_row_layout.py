"""PyTorch port, row layout and batch planning, held against the JAX
package (``ops/row_layout.py``, ``row_conversion.plan_fixed_batches``)."""

import pytest

from spark_rapids_jni_tpu.ops import row_conversion as jrc
from spark_rapids_jni_tpu.ops import row_layout as jrl
from spark_rapids_jni_tpu_torch.ops import row_conversion as prc
from spark_rapids_jni_tpu_torch.ops import row_layout as prl
from spark_rapids_jni_tpu_torch.table import dtype_from_name
from tests._torch_port import ALL_FIXED_NAMES, WIDE_NAMES, jax_dtype

SCHEMAS = {
    "all_fixed": ALL_FIXED_NAMES,
    "wide212": WIDE_NAMES,
    "one_int8": ["int8"],
    "odd_int16": ["int16"] * 3,
    "int64_pair": ["int64", "int64"],
    "mixed_order": ["int8", "int64", "int16", "bool8", "float32"],
    "with_string": ["int32", "string", "int8"],
    "nine_cols": ["int8"] * 9,
}

FIELDS = ("col_starts", "col_sizes", "variable_starts", "validity_offset",
          "validity_bytes", "fixed_row_size", "fixed_end", "num_columns",
          "has_strings")


@pytest.mark.parametrize("schema", sorted(SCHEMAS))
def test_compute_row_layout_matches_jax(schema):
    names = SCHEMAS[schema]
    got = prl.compute_row_layout([dtype_from_name(n) for n in names])
    want = jrl.compute_row_layout([jax_dtype(n) for n in names])
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert [repr(d) for d in got.dtypes] == [repr(d) for d in want.dtypes]


def test_wide_schema_shape():
    layout = prl.compute_row_layout([dtype_from_name(n) for n in WIDE_NAMES])
    assert layout.fixed_row_size == 1008
    assert layout.validity_bytes == 27


def test_row_size_limit_matches_jax():
    for compute, dt in ((prl.compute_row_layout, dtype_from_name("float64")),
                        (jrl.compute_row_layout, jax_dtype("float64"))):
        with pytest.raises(ValueError, match="exceeds JCUDF maximum"):
            compute([dt] * 200)
    assert (prl.MAX_ROW_SIZE, prl.MAX_BATCH_BYTES, prl.JCUDF_ROW_ALIGNMENT) \
        == (jrl.MAX_ROW_SIZE, jrl.MAX_BATCH_BYTES, jrl.JCUDF_ROW_ALIGNMENT)


@pytest.mark.parametrize("num_rows,row_size,size_limit", [
    (0, 24, 1 << 20), (1, 24, 1 << 20), (31, 24, 31 * 24), (100, 24, 24 * 32),
    (3149, 24, 24 * 1024), (1_000_000, 1008, jrl.MAX_BATCH_BYTES),
    (4_000_000, 1008, jrl.MAX_BATCH_BYTES), (4_000_000, 1008, 1 << 30),
    (10, 1008, 100)])
def test_plan_fixed_batches_matches_jax(num_rows, row_size, size_limit):
    try:
        want = jrc.plan_fixed_batches(num_rows, row_size, size_limit)
    except ValueError as e:
        with pytest.raises(ValueError, match="cannot hold"):
            prc.plan_fixed_batches(num_rows, row_size, size_limit)
        assert "cannot hold" in str(e)
        return
    assert prc.plan_fixed_batches(num_rows, row_size, size_limit) == want


@pytest.mark.parametrize("num_rows,size_limit,want", [
    (1_000_000, jrl.MAX_BATCH_BYTES, [1_000_000]),
    (4_000_000, jrl.MAX_BATCH_BYTES, [2_000_896, 1_999_104]),
    (4_000_000, 1 << 30, [1_000_448] * 3 + [998_656]),
    (1000, jrl.MAX_BATCH_BYTES, [1000]),
    (0, jrl.MAX_BATCH_BYTES, [0]),
])
def test_plan_grouped_batches_wide_schema(num_rows, size_limit, want):
    """The TPU main path's policy at the benchmark schema's 1008-byte rows:
    equal 1024-row-aligned batches of at most 2^31 - 1 bytes."""
    plan = prc.plan_grouped_batches(num_rows, 1008, size_limit)
    assert [size for _, size in plan] == want
    assert [start for start, _ in plan] == \
        [sum(want[:i]) for i in range(len(want))]
    assert all(size * 1008 <= min(size_limit, jrl.MAX_BATCH_BYTES)
               for _, size in plan)
