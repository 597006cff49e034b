"""PyTorch port, the fixed-width row conversion entry points, held against
the JAX package's ``ops/row_conversion.py`` on the same seeded numpy data:
JCUDF bytes, batch splits and offsets, decoded values by bit and nulls."""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.ops import row_conversion as jrc
from spark_rapids_jni_tpu.ops import row_mxu as jmx
from spark_rapids_jni_tpu_torch.ops import kernels
from spark_rapids_jni_tpu_torch.ops import row_conversion as prc
from spark_rapids_jni_tpu_torch.ops import row_mxu as pmx
from spark_rapids_jni_tpu_torch.ops.row_layout import compute_row_layout
from spark_rapids_jni_tpu_torch.table import (
    Column, Table, assert_tables_equivalent, dtype_from_name,
)
from tests._torch_port import (
    ALL_FIXED_NAMES, NULL_MODES, WIDE_NAMES, assert_same_batches,
    assert_same_columns, both_tables, port_table,
)

CPU = "cpu"


def _round_trip_matches_jax(rng, names, n, null_mode="some"):
    jax_table, port_table = both_tables(rng, names, n, null_mode)
    got = prc.convert_to_rows(port_table, device=CPU)
    want = jrc.convert_to_rows(jax_table)
    assert_same_batches(got, want)
    assert len(got) == 1
    dtypes = port_table.dtypes
    decoded = prc.convert_from_rows(got[0], dtypes, device=CPU)
    assert_same_columns(decoded, jrc.convert_from_rows(want[0],
                                                       jax_table.dtypes))
    assert_tables_equivalent(decoded, port_table, check_nulls=False)
    return got


@pytest.mark.parametrize("n", [1, 31, 4096, 6 * 1024 + 557])
def test_all_fixed_types_match_jax(rng, n):
    _round_trip_matches_jax(rng, ALL_FIXED_NAMES, n)


def test_wide_schema_matches_jax(rng):
    got = _round_trip_matches_jax(rng, WIDE_NAMES, 2048)
    assert tuple(got[0].data.shape) == (2048, 1008)


@pytest.mark.parametrize("null_mode", NULL_MODES)
def test_null_patterns_match_jax(rng, null_mode):
    _round_trip_matches_jax(rng, ALL_FIXED_NAMES, 777, null_mode)


def test_multi_batch_matches_jax_grouped(rng):
    """Four batches of 1024/1024/1024/77 rows under the TPU main path's
    policy, as the JAX package's ``convert_to_rows_grouped`` splits them
    (its Pallas encode in interpret mode)."""
    names = ["int64", "int32", "int16", "int8", "bool8"]
    n = 3 * 1024 + 77
    jax_table, port_table = both_tables(rng, names, n)
    rs = compute_row_layout(port_table.dtypes).fixed_row_size
    want = jrc.convert_to_rows_grouped(jmx.table_to_grouped(jax_table),
                                       size_limit=1024 * rs)
    got = prc.convert_to_rows(port_table, size_limit=1024 * rs, device=CPU)
    assert [b.num_rows for b in got] == [1024, 1024, 1024, 77]
    assert_same_batches(got, want)
    gc = pmx.table_to_grouped(port_table)
    assert_same_batches(prc.convert_to_rows_grouped(
        gc, size_limit=1024 * rs, device=CPU), want)
    start = 0
    for b in got:
        part = prc.convert_from_rows(b, port_table.dtypes, device=CPU)
        for i, col in enumerate(part.columns):
            np.testing.assert_array_equal(
                col.to_numpy().view(np.uint8),
                port_table.columns[i].to_numpy()[start:start + b.num_rows]
                .view(np.uint8))
        start += b.num_rows


def test_small_tables_take_the_32_row_policy(rng):
    """Under 1024 rows, and for a limit below 1024 rows, batches follow the
    JAX package's XLA-path policy, which its grouped entry falls back to."""
    names = ["int64", "int32", "int8"]
    jax_table, port_table = both_tables(rng, names, 100)
    rs = compute_row_layout(port_table.dtypes).fixed_row_size
    for limit in (jrc.MAX_BATCH_BYTES, 32 * rs):
        want = jrc.convert_to_rows(jax_table, size_limit=limit)
        assert_same_batches(
            prc.convert_to_rows(port_table, size_limit=limit, device=CPU),
            want)
        assert_same_batches(prc.convert_to_rows_grouped(
            pmx.table_to_grouped(port_table), size_limit=limit, device=CPU),
            want)
    assert [b.num_rows for b in want] == [32, 32, 32, 4]


def test_grouped_forms_match_jax(rng):
    jax_table, port_table = both_tables(rng, ALL_FIXED_NAMES, 1500)
    rows = prc.convert_to_rows(port_table, device=CPU)[0]
    jrows = jrc.convert_to_rows(jax_table)[0]
    got = prc.convert_from_rows_grouped(rows, port_table.dtypes, device=CPU)
    want = jrc.convert_from_rows_grouped(jrows, jax_table.dtypes)
    np.testing.assert_array_equal(got.planes.numpy().view(np.uint32),
                                  np.asarray(want.planes))
    np.testing.assert_array_equal(got.vmask.numpy(), np.asarray(want.vmask))
    again = prc.convert_to_rows_grouped(got, device=CPU)
    assert len(again) == 1 and torch.equal(again[0].data, rows.data)


def test_flat_wire_blob_decodes(rng):
    table = port_table(rng, ALL_FIXED_NAMES, 50)
    rows = prc.convert_to_rows(table, device=CPU)[0]
    flat = prc.RowsColumn(rows.data.reshape(-1), rows.offsets)
    assert flat.row_bytes(3) == rows.data[3].numpy().tobytes()
    assert_tables_equivalent(
        prc.convert_from_rows(flat, table.dtypes, device=CPU),
        table, check_nulls=False)
    short = prc.RowsColumn(rows.data[:49], rows.offsets)
    with pytest.raises(ValueError, match="offsets describe"):
        prc.convert_from_rows(short, table.dtypes, device=CPU)


def test_oracle_matches_jax_oracle(rng):
    jax_table, port_table = both_tables(rng, ALL_FIXED_NAMES, 333)
    rs = compute_row_layout(port_table.dtypes).fixed_row_size
    got = prc.convert_to_rows_fixed_width_optimized(
        port_table, size_limit=128 * rs, device=CPU)
    want = jrc.convert_to_rows_fixed_width_optimized(
        jax_table, size_limit=128 * rs)
    assert [b.num_rows for b in got] == [128, 128, 77]
    assert_same_batches(got, want)
    kernel_rows = prc.convert_to_rows(port_table, device=CPU)[0].data
    assert torch.equal(torch.cat([b.data for b in got]), kernel_rows)
    decoded = prc.convert_from_rows_fixed_width_optimized(
        got[1], port_table.dtypes, device=CPU)
    assert_same_columns(decoded, jrc.convert_from_rows_fixed_width_optimized(
        want[1], jax_table.dtypes))


def test_compact_and_arrow_strings_wait_for_a_later_slice(rng):
    """A batch that is not padded decodes as compact rows: a fixed-width
    blob's 8-byte rows, shorter than the string layout's fixed section,
    raise ValueError; an Arrow-layout string column encodes to compact rows
    that decode back to it; the grouped forms and the gather oracle refuse
    string tables, as the JAX package's do."""
    table = port_table(rng, ["int32"], 4)
    dtypes = [dtype_from_name("int32"), dtype_from_name("string")]
    rows = prc.convert_to_rows(table, device=CPU)[0]
    with pytest.raises(ValueError, match="malformed compact rows"):
        prc.convert_from_rows(rows, dtypes, device=CPU)
    with pytest.raises(ValueError, match="grouped forms"):
        prc.convert_from_rows_grouped(rows, dtypes, device=CPU)
    with pytest.raises(ValueError, match="does not support strings"):
        prc.convert_from_rows_fixed_width_optimized(rows, dtypes, device=CPU)
    arrow = Table(table.columns + (
        Column.strings(["a", None, "bc", ""], device=CPU),))
    [compact] = prc.convert_to_rows(arrow, device=CPU)
    assert not compact.is_padded and compact.str_widths is None
    assert_tables_equivalent(
        arrow, prc.convert_from_rows(compact, dtypes, device=CPU),
        check_nulls=False)
    with pytest.raises(ValueError, match="does not support strings"):
        prc.convert_to_rows_fixed_width_optimized(arrow, device=CPU)
    padded = Column.strings_padded(["a", None, "bc", ""], device=CPU)
    with pytest.raises(ValueError, match="does not support strings"):
        prc.convert_to_rows_fixed_width_optimized(
            Table(table.columns + (padded,)), device=CPU)


def test_capped_route_matches_jax(rng, monkeypatch):
    """Above the resident-pack cap (lowered here) the encode takes the
    two-stage route: one K3 pack a batch, each reading the table in place
    at its start, in the JAX package's 32-row-aligned batches; the bytes
    equal JAX ``convert_to_rows`` with the same size_limit and the port's
    grouped route."""
    names = ["int64", "int32", "int16", "int8", "bool8", "float64"]
    n = 3 * 1024 + 77
    jax_table, table = both_tables(rng, names, n)
    rs = compute_row_layout(table.dtypes).fixed_row_size
    limit = 2000 * rs
    grouped = prc.convert_to_rows(table, size_limit=limit, device=CPU)
    assert [b.num_rows for b in grouped] == [1024] * 3 + [77]
    packs = []
    real_pack = kernels.pack_planes

    def pack(t, layout, start, size):
        assert t.columns[0].data.data_ptr() == \
            table.columns[0].data.data_ptr()
        packs.append((start, size))
        return real_pack(t, layout, start, size)

    monkeypatch.setattr(kernels, "pack_planes", pack)
    monkeypatch.setattr(prc, "_FUSED_PREP_CAP", 1024)
    got = prc.convert_to_rows(table, size_limit=limit, device=CPU)
    assert packs == [(0, 1600), (1600, 1549)]
    # bucket=None: the JAX package's shape buckets, which the port leaves
    # out, would move the batch boundaries of a padded twin
    assert_same_batches(got, jrc.convert_to_rows(jax_table, size_limit=limit,
                                                 bucket=None))
    assert torch.equal(torch.cat([b.data for b in got]),
                       torch.cat([b.data for b in grouped]))
    # at the cap the table keeps the grouped route
    packs.clear()
    prep = sum(c.data.numel() * c.data.element_size()
               for c in table.columns) + len(names) * n // 8
    monkeypatch.setattr(prc, "_FUSED_PREP_CAP", prep)
    again = prc.convert_to_rows(table, size_limit=limit, device=CPU)
    assert packs == [] and len(again) == 4


def test_entry_points_need_cuda_unless_asked_for_cpu(rng, monkeypatch):
    table = port_table(rng, ["int32", "int8"], 8)
    rows = prc.convert_to_rows(table, device=CPU)[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: prc.convert_to_rows(table),
                 lambda: prc.convert_from_rows(rows, table.dtypes),
                 lambda: prc.convert_from_rows_grouped(rows, table.dtypes),
                 lambda: prc.convert_to_rows_fixed_width_optimized(table)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_cpu_runs_launch_no_kernel(rng):
    table = port_table(rng, WIDE_NAMES, 64)
    kernels.reset_launches()
    rows = prc.convert_to_rows(table, device=CPU)
    prc.convert_from_rows(rows[0], table.dtypes, device=CPU)
    assert {"grouped_encode", "decode_planes"} <= set(kernels.launches)
    assert kernels.launches == dict.fromkeys(kernels.launches, 0)
