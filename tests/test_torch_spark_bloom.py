"""PyTorch port, Spark's bloom filter: ``SparkBloomFilter`` and
``might_contain_device`` held against the JAX package
(``spark_rapids_jni_tpu.ops.spark_bloom``), and the plain bloom probe against
the Pallas kernel in interpret mode, on the same seeded numpy data.  A filter
crosses between the packages as its Spark V1 bytes.  Probe results are
booleans and serialized filters bytes: every comparison is exact."""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import table as jt
from spark_rapids_jni_tpu.ops import hashing as H
from spark_rapids_jni_tpu.ops import pallas_kernels as pk
from spark_rapids_jni_tpu.ops import spark_bloom as SB
from spark_rapids_jni_tpu_torch import table as pt
from spark_rapids_jni_tpu_torch.ops import hash_kernels as hk
from spark_rapids_jni_tpu_torch.ops import spark_bloom as PB
from tests._torch_port import both_tables

N = 257
KINDS = ["int8", "int16", "int32", "date32", "int64", "timestamp_us"]


def _filters(rng, items=300, fpp=0.03):
    """The same filter in both packages after the same puts of INT64
    keys: (JAX filter, port filter, the keys' numpy values)."""
    jax_keys, port_keys = both_tables(rng, ["int64"], items, "none")
    jf = SB.SparkBloomFilter.optimal(items, fpp).put(jax_keys.columns[0])
    pf = PB.SparkBloomFilter.optimal(items, fpp).put(port_keys.columns[0])
    return jf, pf, port_keys.columns[0].to_numpy()


def _probe(rng, kind, keys):
    """The same probe column in both packages: about half its values from
    ``keys`` (cast to the kind), some nulls."""
    jax_t, port_t = both_tables(rng, [kind], N)
    vals = port_t.columns[0].to_numpy().copy()
    take = rng.random(N) < 0.5
    vals[take] = keys[rng.integers(0, len(keys), int(take.sum()))] \
        .astype(vals.dtype)
    valid = port_t.columns[0].valid_bools().numpy()
    jax_col = jt.Column.from_numpy(vals, jax_t.columns[0].dtype, valid)
    port_col = pt.Column.from_numpy(vals, port_t.columns[0].dtype, valid,
                                    device="cpu")
    return jax_col, port_col


@pytest.mark.parametrize("items,fpp", [(1, 0.5), (300, 0.03),
                                       (5000, 0.001)])
def test_serialize_bytes_equal_after_same_puts(rng, items, fpp):
    jf, pf, _ = _filters(rng, items, fpp)
    assert pf.num_hash_functions == jf.num_hash_functions
    assert pf.serialize() == jf.serialize()
    back = PB.SparkBloomFilter.deserialize(jf.serialize())
    np.testing.assert_array_equal(back.words, pf.words)
    other = PB.SparkBloomFilter.deserialize(pf.serialize())
    assert pf.merge(other).serialize() == jf.serialize()


@pytest.mark.parametrize("kind", KINDS)
def test_host_probe_matches_jax(rng, kind):
    jf, pf, keys = _filters(rng)
    jax_col, port_col = _probe(rng, kind, keys)
    np.testing.assert_array_equal(pf.might_contain(port_col),
                                  jf.might_contain(jax_col))


@pytest.mark.parametrize("kind", KINDS)
def test_device_probe_equals_host_probe(rng, kind):
    """The port's device entry point (its plain probe on the CPU) against
    its own host probe, for every long-castable kind."""
    _, pf, keys = _filters(rng)
    _, port_col = _probe(rng, kind, keys)
    got = PB.might_contain_device(pf, port_col, device="cpu")
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), pf.might_contain(port_col))
    assert not got[~port_col.valid_bools()].any()


@pytest.mark.parametrize("kind", ["int16", "int64"])
def test_might_contain_device_matches_jax(rng, kind):
    """The filter crosses as V1 bytes; both device probes agree, and
    every build key probes True."""
    jf, _, keys = _filters(rng)
    pf = PB.SparkBloomFilter.deserialize(jf.serialize())
    jax_col, port_col = _probe(rng, kind, keys)
    got = PB.might_contain_device(pf, port_col, device="cpu").numpy()
    np.testing.assert_array_equal(
        got, np.asarray(SB.might_contain_device(jf, jax_col)))
    build = pt.Column.from_numpy(keys, pt.INT64, device="cpu")
    assert PB.might_contain_device(pf, build, device="cpu").all()


def test_plain_probe_matches_pallas_interpret(rng):
    """The bloom kernel's plain version against the Pallas kernel itself,
    run in interpret mode."""
    jf, pf, keys = _filters(rng)
    jax_col, port_col = _probe(rng, "int64", keys)
    hi, lo = H._col_u64_blocks(jax_col)
    bits32 = pf.words.astype("<u8").view(np.uint32)
    want = np.asarray(pk.bloom_might_contain(
        bits32, lo, hi, jax_col.valid_bools(), jf.num_hash_functions,
        jf.num_bits, interpret=True))
    words = torch.from_numpy(pf.words.view(np.int64))
    got = hk.bloom_might_contain_plain(words, port_col,
                                       pf.num_hash_functions)
    np.testing.assert_array_equal(got.numpy(), want)


def test_optimal_sizing_matches_jax():
    for items, fpp in [(1, 0.5), (10, 0.03), (1000, 0.03),
                       (1_000_000, 0.01)]:
        j = SB.SparkBloomFilter.optimal(items, fpp)
        p = PB.SparkBloomFilter.optimal(items, fpp)
        assert (p.num_hash_functions, len(p.words)) == \
            (j.num_hash_functions, len(j.words))
    with pytest.raises(ValueError, match="fpp"):
        PB.SparkBloomFilter.optimal(10, 1.5)


def test_bad_buffers_and_merges_are_refused():
    f = PB.SparkBloomFilter.optimal(100)
    data = f.serialize()
    with pytest.raises(ValueError, match="truncated"):
        PB.SparkBloomFilter.deserialize(data[:8])
    with pytest.raises(ValueError, match="truncated"):
        PB.SparkBloomFilter.deserialize(data[:-1])
    with pytest.raises(ValueError, match="version"):
        PB.SparkBloomFilter.deserialize(b"\0\0\0\2" + data[4:])
    with pytest.raises(ValueError, match="header"):
        PB.SparkBloomFilter.deserialize(data[:4] + b"\0\0\0\0" + data[8:])
    with pytest.raises(ValueError, match="incompatible"):
        f.merge(PB.SparkBloomFilter.optimal(10_000))


def test_device_probe_refuses_other_kinds(rng, monkeypatch):
    f = PB.SparkBloomFilter.optimal(100)
    _, t = both_tables(rng, ["float64"], 4)
    with pytest.raises(ValueError, match="long-castable"):
        PB.might_contain_device(f, t.columns[0], device="cpu")
    _, t = both_tables(rng, ["int64"], 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PB.might_contain_device(f, t.columns[0])
