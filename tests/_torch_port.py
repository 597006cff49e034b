"""Shared helpers of the ``test_torch_*`` suites: the same seeded numpy data
fed to the JAX package and to its PyTorch port, and comparisons by bytes."""

import jax.numpy as jnp
import numpy as np
import torch

from spark_rapids_jni_tpu import table as jt
from spark_rapids_jni_tpu_torch import interop
from spark_rapids_jni_tpu_torch import table as pt

# the reference's fixed-width sweep (tests/test_row_mxu.py ALL_FIXED)
ALL_FIXED_NAMES = ["int64", "float64", "uint64", "int32", "uint32",
                   "float32", "int16", "uint16", "int8", "uint8", "bool8",
                   "decimal32(scale=2)", "decimal64(scale=-1)"]
# the reference benchmark's 212-column schema (bench.py:53)
WIDE_NAMES = [["int64", "float64", "int32", "float32", "int16", "int8",
               "bool8"][i % 7] for i in range(212)]
NULL_MODES = ["none", "all", "zero", "some"]


def jax_dtype(name):
    """The JAX package's DType for a port type name."""
    d = pt.dtype_from_name(name)
    if d.kind == "decimal128":
        from spark_rapids_jni_tpu.ops.decimal import decimal128
        return decimal128(d.scale)
    if d.kind == "decimal32":
        return jt.decimal32(d.scale)
    if d.kind == "decimal64":
        return jt.decimal64(d.scale)
    return getattr(jt, {"timestamp_us": "TIMESTAMP64"}.get(
        d.kind, d.kind.upper()))


def _validity(rng, n, null_mode):
    """Bool validity of a null mode: ``none`` (no mask), ``all`` (all
    valid), ``zero`` (all null) or ``some`` (about 25% null)."""
    if null_mode == "none":
        return None
    if null_mode == "all":
        return np.ones(n, bool)
    if null_mode == "zero":
        return np.zeros(n, bool)
    return rng.random(n) > 0.25


def numpy_columns(rng, names, n, null_mode="some"):
    """(name, values, bool validity or None) per column: uniform random
    bytes (floats take every bit pattern, NaN payloads included), BOOL8 as
    0/1, decimal128 as uint32 ``[n, 4]`` limbs of any 128 bits."""
    cols = []
    for name in names:
        d = pt.dtype_from_name(name)
        raw = rng.integers(0, 256, n * d.itemsize, dtype=np.uint8)
        if d.kind == "bool8":
            raw &= 1
        values = raw.view(d.np_dtype)
        if d.itemsize == 16:
            values = values.reshape(n, 4)
        cols.append((name, values, _validity(rng, n, null_mode)))
    return cols


def both_string_columns(rng, n, W, null_mode="some"):
    """The same dense-padded string column in both packages (JAX Column,
    port Column on the CPU): lengths 0..W in turn from a random start,
    random bytes (0x80 and above included) up to each length, zeros past
    it, width W rounded up to a multiple of 4."""
    Wp = (W + 3) // 4 * 4
    lens = ((np.arange(n) + rng.integers(0, W + 1)) % (W + 1)).astype(np.int32)
    chars = rng.integers(0, 256, (n, Wp), dtype=np.uint8)
    chars[np.arange(Wp)[None, :] >= lens[:, None]] = 0
    valid = _validity(rng, n, null_mode)
    packed = (None if valid is None
              else np.packbits(valid, bitorder="little"))
    offsets = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=offsets[1:])
    jax_col = jt.Column(jt.STRING, jnp.zeros((0,), jnp.uint8),
                        None if packed is None else jnp.asarray(packed),
                        jnp.asarray(offsets), None, jnp.asarray(chars))
    port = pt.Column.padded_strings(
        torch.from_numpy(chars), torch.from_numpy(lens),
        None if packed is None else torch.from_numpy(packed))
    return jax_col, port


def both_arrow_string_columns(rng, n, max_len, null_mode="some", lead=0):
    """The same Arrow-layout string column in both packages (JAX Column,
    port Column on the CPU): lengths uniform in 0..max_len, random bytes
    (0x80 and above included), ``lead`` bytes of other chars before the
    first row's, so that the offsets start at ``lead``."""
    lens = rng.integers(0, max_len + 1, n).astype(np.int64)
    offsets = np.full(n + 1, lead, np.int64)
    offsets[1:] += np.cumsum(lens)
    offsets = offsets.astype(np.int32)
    chars = rng.integers(0, 256, int(offsets[-1]), dtype=np.uint8)
    valid = _validity(rng, n, null_mode)
    packed = (None if valid is None
              else np.packbits(valid, bitorder="little"))
    jax_col = jt.Column(jt.STRING, jnp.zeros((0,), jnp.uint8),
                        None if packed is None else jnp.asarray(packed),
                        jnp.asarray(offsets), jnp.asarray(chars))
    port = pt.Column.arrow_strings(
        torch.from_numpy(offsets), torch.from_numpy(chars),
        None if packed is None else torch.from_numpy(packed))
    return jax_col, port


def both_tables(rng, names, n, null_mode="some"):
    """The same random table in both packages: (JAX Table, port Table on
    the CPU)."""
    return tables_from_columns(numpy_columns(rng, names, n, null_mode))


def tables_from_columns(cols):
    """The table of :func:`numpy_columns`' ``(name, values, validity)``
    tuples in both packages: (JAX Table, port Table on the CPU)."""
    jax_table = jt.Table(tuple(_jax_column(name, v, ok)
                               for name, v, ok in cols))
    port = pt.Table(tuple(
        pt.Column.from_numpy(v, pt.dtype_from_name(name), ok, device="cpu")
        for name, v, ok in cols))
    return jax_table, port


def _jax_column(name, values, valid):
    """A JAX column of host values; decimal128 limbs go in as they are (the
    JAX ``Column.from_numpy`` has no numpy type for them)."""
    d = jax_dtype(name)
    if d.kind != "decimal128":
        return jt.Column.from_numpy(values, d, valid)
    validity = None if valid is None else jt.pack_bools(jnp.asarray(valid))
    return jt.Column(d, jnp.asarray(values, jnp.uint32), validity)


def xx_as_int64(pairs) -> np.ndarray:
    """The JAX package's xxhash64 ``[n, 2]`` uint32 (lo, hi) as the port's
    int64: one little-endian 64-bit word."""
    return np.ascontiguousarray(np.asarray(pairs, np.uint32)).view(np.int64) \
        .reshape(-1)


def port_table(rng, names, n, null_mode="some"):
    """A random port table on the CPU, for tests with no JAX side."""
    return pt.Table(tuple(
        pt.Column.from_numpy(v, pt.dtype_from_name(name), ok, device="cpu")
        for name, v, ok in numpy_columns(rng, names, n, null_mode)))


def jax_columns(table):
    """A JAX table as interop tuples (64-bit plane pairs as native values;
    decimal128 as uint32 ``[n, 4]`` limbs; a padded string column as its
    chars2d and lengths, an Arrow one as its offsets rebased to 0 and its
    own chars)."""
    out = []
    for c in table.columns:
        validity = None if c.validity is None else np.asarray(c.validity)
        if c.dtype.is_string and c.chars2d is None:
            offs = np.asarray(c.offsets).astype(np.int32)
            lo, hi = int(offs[0]), int(offs[-1])
            out.append(("string", offs - lo, np.asarray(c.chars)[lo:hi],
                        validity))
            continue
        if c.dtype.is_string:
            out.append(("string", np.asarray(c.chars2d),
                        np.asarray(c.str_lens()), validity))
            continue
        data = np.asarray(c.data)
        if c.dtype.kind == "decimal128":
            out.append((repr(c.dtype), data.astype(np.uint32), validity))
            continue
        if data.ndim == 2 and c.dtype.itemsize == 8:
            data = jt.pair_to_np64(data, c.dtype.np_dtype)
        out.append((repr(c.dtype), data.view(c.dtype.np_dtype), validity))
    return out


def assert_same_columns(port_table, jax_table):
    """Types, data bytes (under nulls too) and packed validity bytes equal;
    a missing mask equals an all-valid one; string columns in the same
    form, Arrow ones with equal offsets (rebased to 0) and chars."""
    got = interop.table_to_numpy_columns(port_table)
    want = jax_columns(jax_table)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        gn, gd, gv, wn, wd, wv = g[0], g[1], g[-1], w[0], w[1], w[-1]
        assert gn == wn, (i, gn, wn)
        assert gd.dtype == wd.dtype, (i, gd.dtype, wd.dtype)
        np.testing.assert_array_equal(gd.view(np.uint8), wd.view(np.uint8),
                                      err_msg=f"column {i} data")
        if gn == "string":
            np.testing.assert_array_equal(g[2], w[2],
                                          err_msg=f"column {i} lengths")
        n = len(gd) - 1 if gn == "string" and gd.ndim == 1 else len(gd)
        gb = np.unpackbits(gv, bitorder="little")[:n] if gv is not None \
            else np.ones(n, np.uint8)
        wb = np.unpackbits(wv, bitorder="little")[:n] if wv is not None \
            else np.ones(n, np.uint8)
        np.testing.assert_array_equal(gb, wb, err_msg=f"column {i} validity")
        if gv is not None and wv is not None:
            np.testing.assert_array_equal(gv, wv,
                                          err_msg=f"column {i} mask bytes")


def assert_same_batches(port_batches, jax_batches):
    """Row counts, offsets and every row byte equal."""
    assert [b.num_rows for b in port_batches] == \
        [b.num_rows for b in jax_batches]
    for p, j in zip(port_batches, jax_batches):
        np.testing.assert_array_equal(p.offsets.numpy(),
                                      np.asarray(j.offsets))
        np.testing.assert_array_equal(p.data.numpy().reshape(-1),
                                      np.asarray(j.data).reshape(-1))
