"""PyTorch port, columnar core: packed validity, types, dense-padded string
columns, interop and table helpers held against the JAX package
(``spark_rapids_jni_tpu.table``) on the same seeded numpy data.  All
comparisons are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import table as jt
from spark_rapids_jni_tpu_torch import interop
from spark_rapids_jni_tpu_torch import table as pt
from spark_rapids_jni_tpu_torch.utils import (
    cycle_dtypes, random_bitset, random_strings, random_table,
    special_floats, strings_with_lengths,
)
from tests._torch_port import (
    ALL_FIXED_NAMES, NULL_MODES, assert_same_columns, both_string_columns,
    both_tables, jax_columns, jax_dtype, numpy_columns,
)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 31, 1000])
def test_pack_unpack_bools_match_jax(rng, n):
    valid = rng.random(n) > 0.4
    got = pt.pack_bools(torch.from_numpy(valid))
    want = np.asarray(jt.pack_bools(jnp.asarray(valid)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.packbits(valid, bitorder="little"))
    back = pt.unpack_bools(got, n)
    np.testing.assert_array_equal(back.numpy(), valid)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jt.unpack_bools(jnp.asarray(want), n)))


def test_pack_bools_2d_matches_jax(rng):
    valid = rng.random((5, 37)) > 0.5
    got = pt.pack_bools(torch.from_numpy(valid))
    want = np.asarray(jt.pack_bools_2d(jnp.asarray(valid)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pt.unpack_bools(got, 37).numpy(), valid)


def test_dtype_names_round_trip_with_jax():
    for name in ALL_FIXED_NAMES + ["date32", "timestamp_us", "string"]:
        d = pt.dtype_from_name(name)
        assert repr(d) == repr(jax_dtype(name)) == name
        assert d.itemsize == jax_dtype(name).itemsize
        assert d.np_dtype == jax_dtype(name).np_dtype
        assert torch.empty(0, dtype=d.torch_dtype).element_size() \
            == d.np_dtype.itemsize
    with pytest.raises(ValueError, match="unknown column type"):
        pt.dtype_from_name("int128")


@pytest.mark.parametrize("null_mode", ["none", "some"])
def test_interop_round_trip(rng, null_mode):
    jax_table, port_table = both_tables(rng, ALL_FIXED_NAMES, 37, null_mode)
    assert_same_columns(port_table, jax_table)
    carried = interop.table_from_numpy_columns(jax_columns(jax_table), "cpu")
    assert_same_columns(carried, jax_table)
    for got, (_, want, _) in zip(carried.to_numpy(), jax_columns(jax_table)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    again = interop.table_from_numpy_columns(
        interop.table_to_numpy_columns(carried), "cpu")
    pt.assert_tables_equivalent(carried, again, check_nulls=False)


def test_table_from_numpy_matches_jax(rng):
    cols = numpy_columns(rng, ALL_FIXED_NAMES, 21)
    values = [v for _, v, _ in cols]
    valids = [ok for _, _, ok in cols]
    port = pt.Table.from_numpy(values, [pt.dtype_from_name(n)
                                        for n, _, _ in cols], valids,
                               device="cpu")
    assert_same_columns(port, jt.Table.from_numpy(
        values, [jax_dtype(n) for n, _, _ in cols], valids))


def test_interop_no_x64_plane_pairs(rng):
    """64-bit columns the JAX package keeps as [2, n] uint32 plane pairs
    (its no-x64 form) cross as native 64-bit values."""
    import jax
    vals = np.array([0, -1, 2 ** 63 - 1, -2 ** 63, 123456789123456789],
                    np.int64)
    valid = np.array([1, 1, 0, 1, 1], bool)
    with jax.enable_x64(False):
        col = jt.Column.from_numpy(vals, jt.INT64, valid)
        assert col.data.ndim == 2
        carried = interop.table_from_numpy_columns(
            jax_columns(jt.Table((col,))), "cpu")
    assert carried.columns[0].data.dtype == torch.int64
    np.testing.assert_array_equal(carried.columns[0].to_numpy(), vals)
    np.testing.assert_array_equal(carried.columns[0].valid_bools().numpy(),
                                  valid)


def test_grouped_interop_round_trip(rng):
    planes = rng.integers(0, 2 ** 32, (7, 45), dtype=np.uint32)
    vmask = rng.integers(0, 256, (3, 6), dtype=np.uint8)
    gc = interop.grouped_from_numpy(planes, vmask,
                                    ["int64", "int32", "int16"], "cpu")
    assert gc.planes.dtype == torch.int32 and gc.num_rows == 45
    p, v = interop.grouped_to_numpy(gc)
    np.testing.assert_array_equal(p, planes)
    np.testing.assert_array_equal(v, vmask)


def test_from_packed_numpy_rejects_wrong_mask_length():
    with pytest.raises(ValueError, match="validity"):
        pt.Column.from_packed_numpy(np.zeros(9, np.int32), pt.INT32,
                                    np.zeros(1, np.uint8), device="cpu")


@pytest.mark.parametrize("start,end", [(0, 37), (3, 29), (8, 16), (5, 5)])
def test_slice_table_matches_jax(rng, start, end):
    jax_table, port_table = both_tables(rng, ALL_FIXED_NAMES, 37)
    assert_same_columns(pt.slice_table(port_table, start, end),
                        jt.slice_table(jax_table, start, end))


def test_assert_tables_equivalent_compares_bits(rng):
    _, a = both_tables(rng, ["float64", "int32"], 16)
    pt.assert_tables_equivalent(a, a)
    nan_bits = a.columns[0].data.clone()
    nan_bits.view(torch.int64)[:] = 0x7FF8000000000001
    other = nan_bits.clone()
    other.view(torch.int64)[:] = 0x7FF8000000000002
    all_valid = torch.full((2,), 255, dtype=torch.uint8)
    x = pt.Table((pt.Column(pt.FLOAT64, nan_bits, all_valid),))
    y = pt.Table((pt.Column(pt.FLOAT64, other, all_valid),))
    with pytest.raises(AssertionError, match="column 0 data"):
        pt.assert_tables_equivalent(x, y)
    # data under null rows is ignored unless check_nulls is off
    nulls = torch.zeros(2, dtype=torch.uint8)
    x = pt.Table((pt.Column(pt.FLOAT64, nan_bits, nulls),))
    y = pt.Table((pt.Column(pt.FLOAT64, other, nulls),))
    pt.assert_tables_equivalent(x, y)
    with pytest.raises(AssertionError):
        pt.assert_tables_equivalent(x, y, check_nulls=False)


def test_cuda_is_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        random_table([pt.INT32], 4)
    assert pt.resolve_device("cpu") == torch.device("cpu")


def test_random_table_is_seeded():
    dtypes = cycle_dtypes([pt.INT64, pt.FLOAT32, pt.INT16, pt.BOOL8], 9)
    a = random_table(dtypes, 1000, seed=5, device="cpu")
    b = random_table(dtypes, 1000, seed=5, device="cpu")
    c = random_table(dtypes, 1000, seed=6, device="cpu")
    pt.assert_tables_equivalent(a, b, check_nulls=False)
    with pytest.raises(AssertionError):
        pt.assert_tables_equivalent(a, c, check_nulls=False)
    for col in a.columns:
        assert col.data.dtype == col.dtype.torch_dtype
        null_share = 1 - col.valid_bools().float().mean().item()
        assert 0.15 < null_share < 0.35
    assert set(a.columns[3].data.unique().tolist()) <= {0, 1}
    no_masks = random_table(dtypes, 10, null_probability=None, device="cpu")
    assert all(c.validity is None for c in no_masks.columns)


def test_cycle_dtypes_matches_jax():
    from spark_rapids_jni_tpu.utils import cycle_dtypes as jax_cycle
    names = ["int64", "float64", "int32"]
    got = cycle_dtypes([pt.dtype_from_name(n) for n in names], 8)
    want = jax_cycle([jax_dtype(n) for n in names], 8)
    assert [repr(d) for d in got] == [repr(d) for d in want]


# ---------------------------------------------------------------------------
# Dense-padded string columns
# ---------------------------------------------------------------------------

STRINGS = ["", None, "a", "abcd", "abcde", "déf", "日本語テキスト", None,
           "0123456789abcdef-", "\x7f\x80"]


@pytest.mark.parametrize("pad_to", [None, 40])
def test_strings_padded_matches_jax(pad_to):
    """UTF-8 bytes (0x80 and above included), lengths, width and nulls."""
    port = pt.Column.strings_padded(STRINGS, pad_to, device="cpu")
    want = jt.Column.strings_padded(STRINGS, pad_to)
    assert port.is_padded and want.is_padded
    assert port.chars2d.shape == tuple(want.chars2d.shape)
    assert port.chars2d.shape[1] % 4 == 0
    np.testing.assert_array_equal(port.chars2d.numpy(),
                                  np.asarray(want.chars2d))
    np.testing.assert_array_equal(port.str_lens().numpy(),
                                  np.asarray(want.str_lens()))
    np.testing.assert_array_equal(port.valid_bools().numpy(),
                                  np.asarray(want.valid_bools()))
    with pytest.raises(ValueError, match="pad_to"):
        pt.Column.strings_padded(STRINGS, 3, device="cpu")


@pytest.mark.parametrize("W", [0, 5, 12, 33])
def test_string_windows_and_words_match_jax(rng, W):
    jax_col, port = both_string_columns(rng, 37, W)
    Wp = port.chars2d.shape[1]
    for width in sorted({0, 4, Wp, Wp + 8}):
        got = port.chars_window(width)
        want = np.asarray(jax_col.chars_window(width))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            pt.bytes2d_to_words(got).numpy().view(np.uint32),
            np.asarray(jt.bytes2d_to_words(jnp.asarray(want))))
    with pytest.raises(ValueError, match="multiple of 4"):
        pt.bytes2d_to_words(port.chars2d[:, :3] if W > 3 else
                            torch.zeros((2, 3), dtype=torch.uint8))


@pytest.mark.parametrize("null_mode", NULL_MODES)
def test_string_interop_round_trip(rng, null_mode):
    jax_s, port_s = both_string_columns(rng, 29, 21, null_mode)
    jax_table, port = both_tables(rng, ["int64", "float32"], 29, null_mode)
    jt_all = jt.Table((jax_s, *jax_table.columns))
    pt_all = pt.Table((port_s, *port.columns))
    assert_same_columns(pt_all, jt_all)
    carried = interop.table_from_numpy_columns(jax_columns(jt_all), "cpu")
    assert_same_columns(carried, jt_all)
    again = interop.table_from_numpy_columns(
        interop.table_to_numpy_columns(carried), "cpu")
    pt.assert_tables_equivalent(carried, again, check_nulls=False)


def test_interop_refuses_arrow_strings():
    """A string column crosses as four entries, Arrow layout told apart by
    its one-dimensional offsets; three entries raise."""
    with pytest.raises(ValueError, match="crosses as"):
        interop.table_from_numpy_columns(
            [("string", np.zeros(3, np.uint8), None)], "cpu")
    [c] = interop.table_from_numpy_columns(
        [("string", np.array([0, 2, 2, 5], np.int32),
          np.frombuffer(b"abcde", np.uint8), None)], "cpu").columns
    assert not c.is_padded and c.str_lens().tolist() == [2, 0, 3]
    assert c.chars_window(4).tolist() == [[97, 98, 0, 0], [0] * 4,
                                          [99, 100, 101, 0]]


@pytest.mark.parametrize("start,end", [(0, 37), (3, 29), (8, 16), (5, 5)])
def test_slice_table_strings_match_jax(rng, start, end):
    jax_s, port_s = both_string_columns(rng, 37, 9)
    jax_table, port = both_tables(rng, ["int16"], 37)
    got = pt.slice_table(pt.Table((port_s, *port.columns)), start, end)
    want = jt.slice_table(jt.Table((jax_s, *jax_table.columns)), start, end)
    assert_same_columns(got, want)


def test_assert_tables_equivalent_strings():
    a = pt.Column.strings_padded(["ab", None, "xyz"], device="cpu")
    b = pt.Column.strings_padded(["ab", None, "xyz"], pad_to=16,
                                 device="cpu")
    pt.assert_tables_equivalent(pt.Table((a,)), pt.Table((b,)),
                                check_nulls=False)
    other = pt.Column.strings_padded(["ab", None, "xyw"], device="cpu")
    with pytest.raises(AssertionError, match="column 0 data"):
        pt.assert_tables_equivalent(pt.Table((a,)), pt.Table((other,)))
    # bytes and length under a null row count only without check_nulls
    under = pt.Column.padded_strings(a.chars2d.clone(), a.lens.clone(),
                                     a.validity)
    under.chars2d[1, 0] = 7
    under.lens[1] = 1
    pt.assert_tables_equivalent(pt.Table((a,)), pt.Table((under,)))
    with pytest.raises(AssertionError):
        pt.assert_tables_equivalent(pt.Table((a,)), pt.Table((under,)),
                                    check_nulls=False)


def test_padded_strings_refuses_bad_shapes():
    lens = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="padded strings"):
        pt.Column.padded_strings(torch.zeros((3, 6), dtype=torch.uint8), lens)
    with pytest.raises(ValueError, match="padded strings"):
        pt.Column.padded_strings(torch.zeros((2, 4), dtype=torch.uint8), lens)
    with pytest.raises(ValueError, match="validity"):
        pt.Column.padded_strings(torch.zeros((3, 4), dtype=torch.uint8),
                                 lens, torch.zeros(2, dtype=torch.uint8))
    with pytest.raises(ValueError, match="chars2d"):
        pt.Column.padded_strings(torch.zeros((3, 4), dtype=torch.uint8),
                                 lens).to_numpy()


def test_random_strings_are_seeded():
    a = random_strings(2000, 64, seed=5, device="cpu")
    b = random_strings(2000, 64, seed=5, device="cpu")
    pt.assert_tables_equivalent(pt.Table((a,)), pt.Table((b,)),
                                check_nulls=False)
    assert a.chars2d.shape == (2000, 64)
    assert int(a.lens.min()) == 0 and int(a.lens.max()) == 64
    past = torch.arange(64) >= a.lens[:, None]
    assert not a.chars2d[past].any()
    assert (a.chars2d >= 0x80).any()
    assert 0.15 < 1 - a.valid_bools().float().mean().item() < 0.35
    lens = torch.arange(10, dtype=torch.int32) % 7
    c = strings_with_lengths(lens, 6, null_probability=None)
    assert c.chars2d.shape == (10, 8) and c.validity is None
    assert torch.equal(c.lens, lens)


def test_special_floats_and_bitsets():
    t = special_floats(19, device="cpu")
    f64 = t.columns[0].data.view(torch.int64)
    assert t.columns[0].dtype == pt.FLOAT64 and f64.shape == (19,)
    assert int(f64[0]) == -2 ** 63 and int(f64[8]) == -2 ** 63  # -0.0
    assert torch.isnan(t.columns[1].data).any()
    assert torch.isinf(t.columns[1].data).any()
    words = random_bitset(1000, 0.25, seed=1, device="cpu")
    assert words.dtype == torch.int64 and words.shape == (1000,)
    ones = np.unpackbits(words.numpy().view(np.uint8)).mean()
    assert 0.23 < ones < 0.27
