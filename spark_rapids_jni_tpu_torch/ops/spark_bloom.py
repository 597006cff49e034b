"""Spark wire-compatible Bloom filter (``BloomFilterImpl`` V1).

The PyTorch counterpart of ``spark_rapids_jni_tpu.ops.spark_bloom``.  Spark's
``BloomFilterAggregate`` builds, and ``BloomFilterMightContain`` probes,
``org.apache.spark.util.sketch.BloomFilterImpl``: k Murmur3_x86_32-derived
bit probes into a long[] bitset, serialized as V1 ``(int version, int
numHashFunctions, int numWords, big-endian long[] words)``.

:class:`SparkBloomFilter` is the port's own numpy copy of the JAX package's:
byte-compatible build (``put``, on the host), host probe, merge and V1
(de)serialization.  Its bit positions come from the bloom kernel's plain
version (:func:`.hash_kernels.bloom_bit_indexes`) on the CPU.
:func:`might_contain_device` probes a column on the device with the bloom
kernel (:mod:`.hash_kernels`).  The JAX package sends
filters of 2^31 bits or more to the host, because its kernel indexes with
int32; the port's kernel takes the bit count as int64, so every filter runs
on the device and gives the host probe's answer.

Spark algorithm (BloomFilterImpl.putLong / mightContainLong):
  h1 = Murmur3_x86_32.hashLong(item, seed=0)
  h2 = Murmur3_x86_32.hashLong(item, seed=h1)
  for i in 1..k: bit = (h1 + i*h2); if bit < 0: bit = ~bit
                 set/test bit % numBits
"""

from __future__ import annotations

import dataclasses
import math
import struct

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.table import Column, resolve_device
from spark_rapids_jni_tpu_torch.ops import hash_kernels

_VERSION_V1 = 1


@dataclasses.dataclass
class SparkBloomFilter:
    """Spark ``BloomFilterImpl``-compatible filter state."""

    num_hash_functions: int
    words: np.ndarray          # uint64 [num_words] bitset

    @property
    def num_bits(self) -> int:
        return len(self.words) * 64

    @staticmethod
    def optimal(expected_items: int, fpp: float = 0.03
                ) -> "SparkBloomFilter":
        """Spark's sizing: optimalNumOfBits / optimalNumOfHashFunctions."""
        if not 0.0 < fpp < 1.0:
            raise ValueError(f"fpp must be in (0, 1), got {fpp}")
        n = max(1, expected_items)
        # k comes from the UN-rounded optimalNumOfBits, exactly as
        # Spark's create() computes it (rounding first would diverge
        # from Spark's k for small n, making partials unmergeable);
        # only the allocation rounds up to whole words
        num_bits = max(1, int(-n * math.log(fpp) / (math.log(2) ** 2)))
        k = max(1, round(num_bits / n * math.log(2)))
        num_words = (num_bits + 63) // 64
        return SparkBloomFilter(k, np.zeros(num_words, np.uint64))

    def put(self, col: Column) -> "SparkBloomFilter":
        """Insert a long column's non-null rows (Spark ``putLong``), on the
        host."""
        vals, valid = _col_longs(col)
        idx = hash_kernels.bloom_bit_indexes(
            vals[valid], self.num_hash_functions, self.num_bits).numpy()
        idx = idx.reshape(-1)
        np.bitwise_or.at(self.words, idx >> 6,
                         np.uint64(1) << (idx & 63).astype(np.uint64))
        return self

    def might_contain(self, col: Column) -> np.ndarray:
        """Per-row probe on the host (Spark ``mightContainLong``); null
        rows False."""
        vals, valid = _col_longs(col)
        idx = hash_kernels.bloom_bit_indexes(
            vals, self.num_hash_functions, self.num_bits).numpy()
        bits = (self.words[idx >> 6]
                >> (idx & 63).astype(np.uint64)) & np.uint64(1)
        return np.all(bits == 1, axis=1) & valid.numpy()

    def merge(self, other: "SparkBloomFilter") -> "SparkBloomFilter":
        """In-place union (Spark ``mergeInPlace``): shapes must match."""
        if (self.num_hash_functions != other.num_hash_functions
                or len(self.words) != len(other.words)):
            raise ValueError("cannot merge incompatible bloom filters")
        self.words |= other.words
        return self

    # -- Spark BloomFilterImpl stream format (V1) -------------------------

    def serialize(self) -> bytes:
        head = struct.pack(">iii", _VERSION_V1, self.num_hash_functions,
                           len(self.words))
        return head + self.words.astype(">u8").tobytes()

    @staticmethod
    def deserialize(data: bytes) -> "SparkBloomFilter":
        if len(data) < 12:
            raise ValueError(
                f"bloom buffer truncated: {len(data)} < 12 header bytes")
        version, k, num_words = struct.unpack_from(">iii", data, 0)
        if version != _VERSION_V1:
            raise ValueError(f"unsupported bloom version {version}")
        if k < 1 or num_words < 1:
            # a hostile header must fail, not yield a filter that
            # matches everything (k<=0) or misreads the buffer
            raise ValueError(
                f"invalid bloom header: numHashFunctions={k}, "
                f"numWords={num_words}")
        expect = 12 + num_words * 8
        if len(data) < expect:
            raise ValueError(
                f"bloom buffer truncated: {len(data)} < {expect} bytes")
        words = np.frombuffer(data, dtype=">u8", count=num_words,
                              offset=12).astype(np.uint64)
        return SparkBloomFilter(k, words)


def might_contain_device(bf: SparkBloomFilter, col: Column, *,
                         device=None) -> torch.Tensor:
    """Per-row probe on ``device`` (default: the CUDA card), the hashes
    fused with the bitset test in one kernel: bool ``[n]`` (null rows
    False), equal to :meth:`SparkBloomFilter.might_contain` for every
    filter size.  Long-castable integer columns only (int8, int16, int32,
    int64, date32, timestamp_us)."""
    if col.dtype.kind not in hash_kernels.BLOOM_KINDS:
        raise ValueError(
            f"bloom device probe takes long-castable integer columns, "
            f"got {col.dtype!r}; use might_contain() for the host path")
    dev = resolve_device(device)
    words = torch.from_numpy(
        np.ascontiguousarray(bf.words, "<u8").view(np.int64)).to(dev)
    return hash_kernels.bloom_might_contain(words, col.to(dev),
                                            bf.num_hash_functions)


def _col_longs(col: Column):
    """A long-castable column's values sign-extended to int64 and its
    validity, both on the CPU (Spark's BloomFilterAggregate casts
    byte/short/int to long)."""
    col = col.to("cpu")
    return hash_kernels._signed_int64(col.data), col.valid_bools()
