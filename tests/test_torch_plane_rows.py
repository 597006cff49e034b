"""PyTorch port, the word-plane row engine (``ops/plane_rows.py``: plane
assembly, the pack K4 and unpack K5, column extraction) and the
``impl="pallas"`` route of row conversion, held against the JAX package's
``pallas_kernels`` row half, run in interpret mode, on the same seeded numpy
data: planes as uint32, JCUDF bytes, batch splits and offsets, decoded
values by bit and nulls."""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.ops import pallas_kernels as jpk
from spark_rapids_jni_tpu.ops import row_conversion as jrc
from spark_rapids_jni_tpu.ops.row_layout import (
    compute_row_layout as jax_layout,
)
from spark_rapids_jni_tpu.table import Table as JaxTable
from spark_rapids_jni_tpu_torch.ops import kernels, plane_rows
from spark_rapids_jni_tpu_torch.ops import row_conversion as prc
from spark_rapids_jni_tpu_torch.ops.row_layout import compute_row_layout
from spark_rapids_jni_tpu_torch.table import (
    Table, assert_tables_equivalent, slice_table,
)
from tests._torch_port import (
    assert_same_batches, assert_same_columns, numpy_columns,
    tables_from_columns,
)

CPU = "cpu"
# the reference benchmark's cycle of seven types (bench.py:53)
CYCLE7 = ["int64", "float64", "int32", "float32", "int16", "int8", "bool8"]
# signed zeros, NaN payloads, infinities, 1.0 and the smallest denormal
F64_SPECIAL = np.array([0x8000000000000000, 0, 0x7FF0000000000001,
                        0xFFF8000000000123, 0x7FF0000000000000,
                        0xFFF0000000000000, 0x3FF0000000000000, 1],
                       np.uint64).view(np.float64)
F32_SPECIAL = np.array([0x80000000, 0, 0x7F800001, 0xFFC00123, 0x7F800000,
                        0xFF800000, 0x3F800000, 1], np.uint32).view(np.float32)


def _tables(n, seed):
    """The seven cycle types with about 25% nulls, the float columns'
    first rows special values: (JAX table, port table, JAX layout, port
    layout)."""
    cols = numpy_columns(np.random.default_rng(seed), CYCLE7, n)
    for name, values, _ in cols:
        special = {"float64": F64_SPECIAL, "float32": F32_SPECIAL}.get(name)
        if special is not None:
            values[:min(n, 8)] = special[:n]
    jt, pt = tables_from_columns(cols)
    return jt, pt, jax_layout(jt.dtypes), compute_row_layout(pt.dtypes)


@pytest.mark.parametrize("n", [1, 37, 300])
def test_word_planes_match_jax(n):
    jt, pt, jl, pl = _tables(n, seed=n)
    got = plane_rows._word_planes_from_table(pt, pl)
    want = np.asarray(jpk._word_planes_from_table(jt, jl))
    assert want.dtype == np.uint32 and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("n", [1, 37, 300])
def test_to_and_from_rows_fixed_match_pallas(n):
    """The plain K4 and K5 on the CPU give the Pallas kernels' bytes and
    columns, and K5 inverts K4."""
    jt, pt, jl, pl = _tables(n, seed=100 + n)
    rows = plane_rows.to_rows_fixed(pt, pl)
    want = np.asarray(jpk.to_rows_fixed(jt, jl, interpret=True))
    np.testing.assert_array_equal(rows.numpy(), want)
    got = Table(tuple(plane_rows.from_rows_fixed(rows, pl)))
    want_cols = jpk.from_rows_fixed(want, jl, interpret=True)
    assert_same_columns(got, JaxTable(tuple(want_cols)))
    assert_tables_equivalent(got, pt, check_nulls=False)
    assert torch.equal(kernels.rows_to_planes(rows),
                       plane_rows._word_planes_from_table(pt, pl))


def test_to_rows_fixed_window_matches_pallas():
    jt, pt, jl, pl = _tables(300, seed=7)
    got = plane_rows.to_rows_fixed(pt, pl, start=32, size=64)
    want = np.asarray(jpk.to_rows_fixed(jt, jl, start=32, size=64,
                                        interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    planes = plane_rows._word_planes_from_table(pt, pl)
    assert torch.equal(kernels.planes_to_rows(planes, 32, 64), got)


def test_convert_pallas_batches_match_jax():
    """A size limit of 64 rows splits 300 rows into equal 64-row batches
    and a 44-row tail, each one pack launch, at the JAX package's
    boundaries and bytes; each batch decodes back through the word-plane
    engine to the table's rows."""
    jt, pt, _, _ = _tables(300, seed=11)
    limit = 64 * compute_row_layout(pt.dtypes).fixed_row_size
    got = prc.convert_to_rows(pt, size_limit=limit, impl="pallas",
                              device=CPU)
    want = jrc.convert_to_rows(jt, size_limit=limit, impl="pallas",
                               bucket=None)
    assert [b.num_rows for b in got] == [64, 64, 64, 64, 44]
    assert_same_batches(got, want)
    assert_same_batches(prc.convert_to_rows(pt, size_limit=limit,
                                            use_pallas=True, device=CPU),
                        want)
    start = 0
    for b in got:
        part = prc.convert_from_rows(b, pt.dtypes, impl="pallas", device=CPU)
        assert_tables_equivalent(
            part, slice_table(pt, start, start + b.num_rows),
            check_nulls=False)
        start += b.num_rows
    assert_same_columns(
        prc.convert_from_rows(got[-1], pt.dtypes, use_pallas=True,
                              device=CPU),
        jrc.convert_from_rows(want[-1], jt.dtypes, impl="pallas",
                              bucket=None))


def test_pallas_route_equals_default_route():
    """One batch under 1 GiB: the word-plane engine's rows equal the
    default route's (K1) byte for byte, and both decodes agree."""
    _, pt, _, _ = _tables(300, seed=13)
    a = prc.convert_to_rows(pt, device=CPU)
    b = prc.convert_to_rows(pt, impl="pallas", device=CPU)
    assert len(a) == len(b) == 1
    assert torch.equal(a[0].data, b[0].data)
    assert torch.equal(a[0].offsets, b[0].offsets)
    assert_tables_equivalent(
        prc.convert_from_rows(b[0], pt.dtypes, impl="pallas", device=CPU),
        prc.convert_from_rows(a[0], pt.dtypes, impl="mxu", device=CPU),
        check_nulls=False)


@pytest.mark.parametrize("kwargs", [{"impl": "xla"}, {"use_pallas": False}])
def test_generic_engine_is_not_ported(kwargs):
    """The generic engine works: both ways of asking for it give the
    default route's rows and decode them back
    (``tests/test_torch_row_kernels.py`` holds it against the JAX
    package).  The name is the one it had while the engine was refused,
    kept so that the test stays the same test."""
    _, pt, _, _ = _tables(8, seed=1)
    got = prc.convert_to_rows(pt, device=CPU, **kwargs)
    rows = prc.convert_to_rows(pt, device=CPU)[0]
    assert len(got) == 1 and torch.equal(got[0].data, rows.data)
    assert_tables_equivalent(
        pt, prc.convert_from_rows(rows, pt.dtypes, device=CPU, **kwargs),
        check_nulls=False)


def test_unknown_impl_raises():
    _, pt, _, _ = _tables(8, seed=2)
    with pytest.raises(ValueError, match="unknown impl"):
        prc.convert_to_rows(pt, impl="triton", device=CPU)
