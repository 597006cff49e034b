"""PyTorch port, word plans, the plane-major backing and the two kernels'
plain versions, held against the JAX package's ``ops/row_mxu.py``.

The K1 and K2 Pallas kernels run once each in interpret mode, and K3 at the
shapes of ``tests/test_row_mxu.py``'s pack test, as that file runs them on
the CPU; every other comparison is against the JAX package's XLA versions.
All comparisons are exact."""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import table as jt
from spark_rapids_jni_tpu.ops import row_layout as jrl
from spark_rapids_jni_tpu.ops import row_mxu as jmx
from spark_rapids_jni_tpu_torch import interop
from spark_rapids_jni_tpu_torch.ops import kernels
from spark_rapids_jni_tpu_torch.ops import row_layout as prl
from spark_rapids_jni_tpu_torch.ops import row_mxu as pmx
from spark_rapids_jni_tpu_torch.table import (
    Column, Table, assert_tables_equivalent, dtype_from_name,
)
from tests._torch_port import (
    ALL_FIXED_NAMES, WIDE_NAMES, assert_same_columns, both_tables, jax_dtype,
    port_table,
)

T = 1024  # the JAX package's encode tile, and FixedEncoder's alignment

SCHEMAS = {
    "all_fixed": ALL_FIXED_NAMES,
    "wide212": WIDE_NAMES,
    "one_int8": ["int8"],
    "odd_int16": ["int16"] * 3,
    "int64_pair": ["int64", "int64"],
    "mixed_order": ["int8", "int64", "int16", "bool8", "float32", "int8"],
}


def _layouts(names):
    return (prl.compute_row_layout([dtype_from_name(n) for n in names]),
            jrl.compute_row_layout([jax_dtype(n) for n in names]))


@pytest.mark.parametrize("schema", sorted(SCHEMAS))
def test_word_plans_match_jax(schema):
    p, j = _layouts(SCHEMAS[schema])
    for port_fn, jax_fn in ((pmx._forward_plan, jmx._forward_plan),
                            (pmx._inverse_plan, jmx._inverse_plan)):
        (gp, gm), (wp, wm) = port_fn(p), jax_fn(j)
        assert _plan_fields(gp) == _plan_fields(wp)
        assert gm.dtype == wm.dtype
        np.testing.assert_array_equal(gm, wm)
    assert pmx._data_words(p) == jmx._data_words(j)


def _plan_fields(plan):
    return (plan.num_words, plan.col_word, plan.col_byte,
            plan.validity_word, plan.validity_byte)


@pytest.mark.parametrize("schema", sorted(SCHEMAS))
def test_kernel_maps_cover_the_plans(schema):
    """Each data byte of the row has exactly one plane source and each
    validity byte its index; the decode map inverts the encode map."""
    layout, _ = _layouts(SCHEMAS[schema])
    enc = kernels.encode_byte_map(layout)
    dec = kernels.decode_word_map(layout)
    vo, vb = layout.validity_offset, layout.validity_bytes
    data_bytes = sum(layout.col_sizes)
    assert (enc >= 0).sum() == data_bytes
    np.testing.assert_array_equal(enc[vo:vo + vb], -2 - np.arange(vb))
    for j in np.nonzero(enc >= 0)[0]:
        assert dec[enc[j]] == j
    assert (dec >= 0).sum() == data_bytes + vb


def test_table_to_grouped_matches_jax(rng):
    jax_table, port_table = both_tables(rng, ALL_FIXED_NAMES, T + 313)
    p, j = _layouts(ALL_FIXED_NAMES)
    want = jmx.table_to_grouped(jax_table, j)
    got = pmx.table_to_grouped(port_table, p)
    planes, vmask = interop.grouped_to_numpy(got)
    np.testing.assert_array_equal(planes, np.asarray(want.planes))
    np.testing.assert_array_equal(vmask, np.asarray(want.vmask))
    assert_same_columns(got.to_table(), want.to_table())


def test_grouped_encode_plain_matches_pallas_k1(rng):
    """K1's plain version against the Pallas ``_grouped_encode_kernel`` in
    interpret mode, fed the JAX package's own backing."""
    jax_table, _ = both_tables(rng, ALL_FIXED_NAMES, T + 313)
    p, j = _layouts(ALL_FIXED_NAMES)
    jgc = jmx.table_to_grouped(jax_table, j)
    want = np.asarray(jmx.to_rows_fixed_grouped(jgc, interpret=True))
    gc = interop.grouped_from_numpy(np.asarray(jgc.planes),
                                    np.asarray(jgc.vmask), ALL_FIXED_NAMES,
                                    "cpu")
    got = kernels.grouped_encode_plain(gc.planes, gc.vmask, p, 0, T + 313)
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version for CPU tensors, and counts nothing
    before = dict(kernels.launches)
    assert torch.equal(kernels.grouped_encode(gc.planes, gc.vmask, p, 0,
                                              T + 313), got)
    assert kernels.launches == before


def test_decode_planes_plain_matches_pallas_k2(rng):
    """K2's plain version against the Pallas ``_fused_decode_kernel`` in
    interpret mode: planes and packed masks, mask bits past n zero."""
    n = T + 313
    jax_table, _ = both_tables(rng, ALL_FIXED_NAMES, n)
    p, j = _layouts(ALL_FIXED_NAMES)
    blob = np.asarray(jmx.to_rows_fixed(jax_table, j, pack="xla"))
    want_planes, want_vmask = jmx._decode_planes_pallas_jit(blob, j, True)
    planes, vmask = kernels.decode_planes_plain(
        torch.from_numpy(np.array(blob)), p)
    np.testing.assert_array_equal(planes.numpy().view(np.uint32),
                                  np.asarray(want_planes))
    np.testing.assert_array_equal(vmask.numpy(), np.asarray(want_vmask))
    assert n % 8 and not (vmask[:, -1] >> (n % 8)).any()


@pytest.mark.parametrize("schema,n", [("all_fixed", 6 * T + 557),
                                      ("odd_int16", 31), ("one_int8", 1)])
def test_decode_planes_plain_matches_xla(rng, schema, n):
    names = SCHEMAS[schema]
    jax_table, _ = both_tables(rng, names, n)
    p, j = _layouts(names)
    blob = jmx.to_rows_fixed(jax_table, j, pack="xla")
    want = jmx.from_rows_fixed_grouped(blob, j, mode="xla")
    got = pmx.from_rows_fixed_grouped(torch.from_numpy(np.asarray(blob)), p)
    planes, vmask = interop.grouped_to_numpy(got)
    np.testing.assert_array_equal(planes, np.asarray(want.planes))
    np.testing.assert_array_equal(vmask, np.asarray(want.vmask))
    assert_same_columns(got.to_table(), want.to_table())
    cols = pmx.from_rows_fixed(torch.from_numpy(np.asarray(blob)), p)
    assert_same_columns(Table(tuple(cols)), jax_table)


def test_decode_planes_plain_wider_row_stride(rng):
    """A row stride past the layout's row size (padded string rows) decodes
    the same planes: the bytes past the fixed section are never read."""
    table = port_table(rng, ALL_FIXED_NAMES, 77)
    p, _ = _layouts(ALL_FIXED_NAMES)
    gc = pmx.table_to_grouped(table, p)
    rows = kernels.grouped_encode_plain(gc.planes, gc.vmask, p, 0, 77)
    wide = torch.full((77, p.fixed_row_size + 24), 0xAB, dtype=torch.uint8)
    wide[:, :p.fixed_row_size] = rows
    a = kernels.decode_planes_plain(rows, p)
    b = kernels.decode_planes_plain(wide, p)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_grouped_encode_plain_any_start(rng):
    """The encode takes any batch start, 8-aligned or not."""
    p, _ = _layouts(WIDE_NAMES)
    gc = pmx.table_to_grouped(port_table(rng, WIDE_NAMES, 300), p)
    full = kernels.grouped_encode_plain(gc.planes, gc.vmask, p, 0, 300)
    for start, size in ((3, 100), (64, 236), (299, 1), (17, 0)):
        part = kernels.grouped_encode_plain(gc.planes, gc.vmask, p, start,
                                            size)
        assert torch.equal(part, full[start:start + size]), (start, size)


def test_fixed_encoder_batches_and_contract(rng):
    n = 2 * T + 50
    jax_table, port_table = both_tables(rng, ["int64", "int16", "int8"], n)
    p, j = _layouts(["int64", "int16", "int8"])
    want = np.asarray(jmx.to_rows_fixed(jax_table, j, pack="xla"))
    enc = pmx.FixedEncoder(port_table, p)
    np.testing.assert_array_equal(enc.encode().numpy(), want)
    np.testing.assert_array_equal(enc.encode(T, T).numpy(), want[T:2 * T])
    np.testing.assert_array_equal(enc.encode(2 * T).numpy(), want[2 * T:])
    with pytest.raises(ValueError, match="aligned"):
        enc.encode(7, 100)
    with pytest.raises(ValueError, match="exceeds"):
        enc.encode(T, 2 * T)
    with pytest.raises(ValueError, match="aligned"):
        pmx.to_rows_fixed_grouped(enc.gc, 8, 16)


def test_grouped_columns_extract_each_column(rng):
    table = port_table(rng, ALL_FIXED_NAMES, 45)
    p, _ = _layouts(ALL_FIXED_NAMES)
    gc = pmx.table_to_grouped(table, p)
    for i, col in enumerate(table.columns):
        got = gc.column(i)
        assert got.dtype == col.dtype and got.data.dtype == col.data.dtype
    assert_tables_equivalent(gc.to_table(), table, check_nulls=False)


def test_kernel_wrappers_reject_bad_inputs(rng):
    p, _ = _layouts(["int32", "int8"])
    gc = pmx.table_to_grouped(port_table(rng, ["int32", "int8"], 40), p)
    with pytest.raises(ValueError, match="planes must be int32"):
        kernels.grouped_encode(gc.planes.view(torch.float32), gc.vmask, p,
                               0, 40)
    with pytest.raises(ValueError, match="vmask must be uint8"):
        kernels.grouped_encode(gc.planes, gc.vmask[:, :2], p, 0, 40)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.grouped_encode(gc.planes[:, ::2], gc.vmask[:, :3], p, 0, 20)
    with pytest.raises(ValueError, match="outside"):
        kernels.grouped_encode(gc.planes, gc.vmask, p, 30, 11)
    rows = kernels.grouped_encode(gc.planes, gc.vmask, p, 0, 40)
    with pytest.raises(ValueError, match="rows must be uint8"):
        kernels.decode_planes(rows.view(torch.int8), p)
    with pytest.raises(ValueError, match="shorter"):
        kernels.decode_planes(rows[:, :4].contiguous(), p)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.decode_planes(rows[::2], p)


# tests/test_row_mxu.py's pack test shapes: (schema, rows)
PACK_SHAPES = [("all_fixed", 1000), ("wide212", 2048 + 77), ("one_int8", 33),
               ("int64_pair", 50), ("odd_int16", 257)]


@pytest.mark.parametrize("schema,n", PACK_SHAPES)
def test_pack_planes_plain_matches_pallas_k3(rng, schema, n):
    """K3's plain version against the Pallas ``_pack_kernel`` in interpret
    mode: every forward plane, the validity quads' pad bytes included; the
    wrapper takes the plain version for CPU tensors and counts nothing."""
    names = SCHEMAS[schema]
    jax_table, table = both_tables(rng, names, n)
    p, j = _layouts(names)
    want = np.asarray(jmx._pack_planes_pallas(
        jax_table, j, jmx._forward_plan(j)[0], interpret=True))
    got = kernels.pack_planes_plain(table, p, 0, n)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    before = dict(kernels.launches)
    assert torch.equal(kernels.pack_planes(table, p, 0, n), got)
    assert kernels.launches == before
    # the data planes are the backing's
    wd = pmx._data_words(p)
    assert torch.equal(got[:wd], pmx.table_to_grouped(table, p).planes)


def test_pack_planes_plain_odd_start_matches_pallas_k3(rng):
    """A batch at an odd start reads each column, its validity bits
    included, in place: equal to the Pallas kernel over the JAX package's
    sliced table."""
    n, start, size = 1000, 3, 611
    jax_table, table = both_tables(rng, ALL_FIXED_NAMES, n)
    p, j = _layouts(ALL_FIXED_NAMES)
    sliced = jt.slice_table(jax_table, start, start + size)
    want = np.asarray(jmx._pack_planes_pallas(
        sliced, j, jmx._forward_plan(j)[0], interpret=True))
    got = kernels.pack_planes_plain(table, p, start, size)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    full = kernels.pack_planes_plain(table, p, 0, n)
    for s, k in ((7, 9), (999, 1), (500, 0)):
        assert torch.equal(kernels.pack_planes_plain(table, p, s, k),
                           full[:, s:s + k]), (s, k)


@pytest.mark.parametrize("schema,n", [("all_fixed", 1000),
                                      ("one_int8", 33)])
def test_to_rows_fixed_matches_jax_two_stage(rng, schema, n):
    """The two-stage encode equals the JAX package's (its pack in interpret
    mode), whole and for one batch, and K1's rows."""
    names = SCHEMAS[schema]
    jax_table, table = both_tables(rng, names, n)
    p, j = _layouts(names)
    want = np.asarray(jmx.to_rows_fixed(jax_table, j,
                                        pack="pallas_interpret"))
    got = pmx.to_rows_fixed(table, p)
    np.testing.assert_array_equal(got.numpy(), want.reshape(n, -1))
    start, size = n // 3 + 1, n // 2
    np.testing.assert_array_equal(
        pmx.to_rows_fixed(table, p, start, size).numpy(),
        want.reshape(n, -1)[start:start + size])
    gc = pmx.table_to_grouped(table, p)
    assert torch.equal(got, kernels.grouped_encode(gc.planes, gc.vmask, p, 0,
                                                   n))


def test_pack_planes_rejects_bad_inputs(rng):
    table = port_table(rng, ["int32", "int8"], 40)
    p, _ = _layouts(["int32", "int8"])
    with pytest.raises(ValueError, match="outside"):
        kernels.pack_planes(table, p, 30, 11)
    with pytest.raises(ValueError, match="types are not the layout"):
        kernels.pack_planes(table, _layouts(["int8", "int32"])[0], 0, 40)
    strings = Table((table.columns[0], Column.strings_padded(
        ["a"] * 40, device="cpu")))
    s_layout = prl.compute_row_layout(strings.dtypes)
    with pytest.raises(ValueError, match="1, 2, 4 and 8 bytes"):
        kernels.pack_planes(strings, s_layout, 0, 40)
    short = Table((table.columns[0], Column(
        table.columns[1].dtype, table.columns[1].data[:39])))
    with pytest.raises(ValueError, match="rows on"):
        kernels.pack_planes(short, p, 0, 39)
