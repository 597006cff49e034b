"""PyTorch port, Spark hashing: ``murmur3_hash``, ``xxhash64`` and
``hash_partition_ids`` held against the JAX package
(``spark_rapids_jni_tpu.ops.hashing``), and the plain versions of the hash
kernels against the Pallas kernels in interpret mode, on the same seeded
numpy data.  Hashes are integers: every comparison is exact.

The JAX entry points run their eager chain (``bucket=None``): its answer is
the same as the bucketed program's (the JAX package's own tests hold the two
equal), and on the CPU the jitted string chain takes minutes to compile.

Denormal floats are left out of the data held against the JAX package: XLA
on the CPU compares them equal to 0.0, so the JAX package hashes them as
zero, while Spark (and the port) hash their bits (see
``test_denormals_hash_by_their_bits``)."""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import table as jt
from spark_rapids_jni_tpu.ops import hashing as H
from spark_rapids_jni_tpu.ops import pallas_kernels as pk
from spark_rapids_jni_tpu_torch import table as pt
from spark_rapids_jni_tpu_torch.ops import hash_kernels as hk
from spark_rapids_jni_tpu_torch.ops import hashing as ph
from spark_rapids_jni_tpu_torch.ops import kernels
from spark_rapids_jni_tpu_torch.utils import special_floats
from tests._torch_port import (
    ALL_FIXED_NAMES, NULL_MODES, both_string_columns, jax_dtype,
    numpy_columns, xx_as_int64,
)

N = 203
HASH_NAMES = ALL_FIXED_NAMES + ["date32", "timestamp_us"]


_DENORMAL_EXP = {"float32": (np.uint32, 0x7F800000, 0x00800000),
                 "float64": (np.uint64, 0x7FF0000000000000,
                             0x0010000000000000)}


def both_tables(rng, names, n, null_mode="some"):
    """The same random table in both packages, as ``_torch_port``'s, with
    every denormal float made normal (its lowest exponent bit set)."""
    cols = numpy_columns(rng, names, n, null_mode)
    for name, vals, _ in cols:
        if name in _DENORMAL_EXP:
            ut, exp, low = _DENORMAL_EXP[name]
            bits = vals.view(ut)
            bits[(bits & ut(exp)) == 0] |= ut(low)
    jax_table = jt.Table(tuple(jt.Column.from_numpy(v, jax_dtype(nm), ok)
                               for nm, v, ok in cols))
    port = pt.Table(tuple(
        pt.Column.from_numpy(v, pt.dtype_from_name(nm), ok, device="cpu")
        for nm, v, ok in cols))
    return jax_table, port


def _hold(jax_cols, port_cols, rows=slice(None)):
    """murmur3 (seed 42), xxhash64 (seed 7) and partition ids (200) of the
    port equal the JAX package's, on ``rows``."""
    got = ph.murmur3_hash(port_cols, 42, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy()[rows],
        np.asarray(H.murmur3_hash(jax_cols, 42, bucket=None))[rows])
    got = ph.xxhash64(port_cols, 7, device="cpu")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(
        got.numpy()[rows],
        xx_as_int64(H.xxhash64(jax_cols, 7, bucket=None))[rows])
    got = ph.hash_partition_ids(port_cols, 200, device="cpu")
    np.testing.assert_array_equal(
        got.numpy()[rows],
        np.asarray(H.hash_partition_ids(jax_cols, 200, bucket=None))[rows])


@pytest.mark.parametrize("name", HASH_NAMES)
def test_one_column_matches_jax(rng, name):
    jax_table, port = both_tables(rng, [name], N)
    _hold(jax_table.columns, port.columns)


@pytest.mark.parametrize("name", HASH_NAMES)
def test_normalised_words_match_jax(rng, name):
    """Spark's normalisation of each type, word by word."""
    jax_table, port = both_tables(rng, [name], N)
    got = hk._as_u32_words(port.columns[0])
    want = H._as_u32_words(jax_table.columns[0])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    hi, lo = hk._col_u64_blocks(port.columns[0])
    whi, wlo = H._col_u64_blocks(jax_table.columns[0])
    np.testing.assert_array_equal(hi.numpy(), np.asarray(whi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(wlo))


def test_special_floats_match_jax():
    """Signed zeros, NaN payloads and infinities normalise as Spark does
    (the denormal rows of ``special_floats`` are held apart, below)."""
    port = special_floats(N, device="cpu")
    jax_cols = tuple(jt.Column.from_numpy(c.to_numpy(), getattr(
        jt, c.dtype.kind.upper())) for c in port.columns)
    normal = np.arange(N) % 8 != 7
    _hold(jax_cols, port.columns, normal)
    for c, j in zip(port.columns, jax_cols):
        _hold((j,), (c,), normal)


def test_denormals_hash_by_their_bits():
    """Spark hashes a float by ``floatToIntBits`` (-0.0 as 0), so the
    smallest denormal float hashes as the int 1: Spark's ``hash(1)``.  The
    JAX package on the CPU compares denormals equal to 0.0 and hashes them
    as 0 (a fault recorded in ROADMAP.md, queue 3)."""
    f32 = pt.Column.from_numpy(np.array([1], np.uint32).view(np.float32),
                               pt.FLOAT32, device="cpu")
    f64 = pt.Column.from_numpy(np.array([1], np.uint64).view(np.float64),
                               pt.FLOAT64, device="cpu")
    i64 = pt.Column.from_numpy(np.array([1], np.int64), pt.INT64,
                               device="cpu")
    assert int(ph.murmur3_hash([f32], device="cpu")[0]) == -559580957
    assert torch.equal(ph.murmur3_hash([f64], device="cpu"),
                       ph.murmur3_hash([i64], device="cpu"))
    assert torch.equal(ph.xxhash64([f64], device="cpu"),
                       ph.xxhash64([i64], device="cpu"))
    jax_f32 = jt.Column.from_numpy(f32.to_numpy(), jt.FLOAT32)
    zero = jt.Column.from_numpy(np.zeros(1, np.float32), jt.FLOAT32)
    assert np.asarray(H.murmur3_hash([jax_f32], bucket=None))[0] == \
        np.asarray(H.murmur3_hash([zero], bucket=None))[0]


def _chain(rng, case, null_mode="some"):
    if case == "all_fixed":
        jax_table, port = both_tables(rng, HASH_NAMES, N, null_mode)
        return jax_table.columns, port.columns
    if case == "partition_keys":
        jax_table, port = both_tables(rng, ["int32", "int16"], N, null_mode)
        return jax_table.columns, port.columns
    if case == "strings_every_width":
        pairs = [both_string_columns(rng, N, W, null_mode)
                 for W in (0, 4, 12, 36, 68)]
        jax_table, port = both_tables(rng, ["int64"], N, null_mode)
        return ([j for j, _ in pairs] + list(jax_table.columns),
                [p for _, p in pairs] + list(port.columns))
    jax_s, port_s = both_string_columns(rng, N, 13, null_mode)
    jax_table, port = both_tables(rng, ["float64", "int8"], N, null_mode)
    return [jax_s, *jax_table.columns], [port_s, *port.columns]


@pytest.mark.parametrize("case", ["all_fixed", "partition_keys",
                                  "strings_every_width", "string_chain3"])
def test_chains_match_jax(rng, case):
    """Chains over several columns: every string tail length 0..3 and
    every xxhash64 branch (32-byte chunks, 8-byte stripes, the 4-byte
    block, 1-3 tail bytes) with the widths 0, 4, 12, 36 and 68."""
    _hold(*_chain(rng, case))


@pytest.mark.parametrize("null_mode", NULL_MODES)
def test_null_modes_match_jax(rng, null_mode):
    _hold(*_chain(rng, "string_chain3", null_mode))


@pytest.mark.parametrize("op", ["murmur3", "xxhash64"])
def test_plain_kernels_match_pallas_interpret(rng, op):
    """Each hash kernel's plain version against the Pallas kernel itself,
    run in interpret mode, on [string (W = 12), INT64] (a third column
    makes XLA's CPU compile of the interpreted xxhash64 kernel take
    minutes)."""
    jax_s, port_s = both_string_columns(rng, N, 12)
    jax_table, port = both_tables(rng, ["int64"], N)
    jax_cols = (jax_s, *jax_table.columns)
    port_cols = (port_s, *port.columns)
    if op == "murmur3":
        want = np.asarray(pk.murmur3_cols(jax_cols, 42, W=12,
                                          interpret=True))
        got = hk.murmur3_cols_plain(port_cols, 42).numpy()
    else:
        want = xx_as_int64(pk.xxhash64_cols(jax_cols, 7, W=12,
                                            interpret=True))
        got = hk.xxhash64_cols_plain(port_cols, 7).numpy()
    np.testing.assert_array_equal(got, want)


def test_spark_literal_hash_of_one():
    """Spark's published ``SELECT hash(1)`` (seed 42)."""
    col = pt.Column.from_numpy(np.array([1], np.int32), pt.INT32,
                               device="cpu")
    assert int(ph.murmur3_hash([col], device="cpu")[0]) == -559580957
    assert int(hk.murmur3_cols([col], ph.DEFAULT_SEED)[0]) == -559580957


def test_pmod_matches_jax():
    h = np.array([-7, -1, 0, 1, 199, 200, 2 ** 31 - 1, -2 ** 31], np.int32)
    got = ph.pmod(torch.from_numpy(h), 200)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(H.pmod(h, 200)))
    assert got.min() >= 0 and got.max() < 200


def test_table_and_column_list_hash_alike(rng):
    """A table or its column list; on the CPU no kernel launches."""
    _, port = both_tables(rng, ["int64", "float32"], N)
    kernels.reset_launches()
    assert torch.equal(ph.murmur3_hash(port, device="cpu"),
                       ph.murmur3_hash(port.columns, device="cpu"))
    assert torch.equal(ph.xxhash64(port, device="cpu"),
                       ph.xxhash64(list(port.columns), device="cpu"))
    assert kernels.launches == dict.fromkeys(kernels.launches, 0)


def test_lengths_past_the_width_are_refused():
    col = pt.Column.strings_padded(["abcd", "ef"], device="cpu")
    bad = pt.Column.padded_strings(col.chars2d, torch.tensor(
        [4, 5], dtype=torch.int32))
    with pytest.raises(ValueError, match="padded width"):
        ph.murmur3_hash([bad], device="cpu")
    with pytest.raises(ValueError, match="padded width"):
        ph.xxhash64([bad], device="cpu")


def test_entry_points_need_a_card_unless_asked(monkeypatch, rng):
    _, port = both_tables(rng, ["int32"], 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (ph.murmur3_hash, ph.xxhash64):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(port)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ph.hash_partition_ids(port, 200)
    with pytest.raises(ValueError, match="at least one column"):
        ph.murmur3_hash([], device="cpu")


def test_hash_cols_eligible(rng):
    _, port = both_tables(rng, ["int64", "bool8"], 4)
    _, s = both_string_columns(rng, 4, 5)
    assert hk.hash_cols_eligible(list(port.columns) + [s])
    assert not hk.hash_cols_eligible([])
    mixed = [port.columns[0], pt.Column(pt.INT32, torch.zeros(5, dtype=
                                                               torch.int32))]
    with pytest.raises(ValueError, match="rows"):
        hk.murmur3_cols(mixed, 42)
