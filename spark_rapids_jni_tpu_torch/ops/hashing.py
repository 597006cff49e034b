"""Spark-compatible hashes: murmur3_x86_32 and xxhash64, and Spark's hash
partitioning.

The PyTorch counterpart of ``spark_rapids_jni_tpu.ops.hashing``:

- :func:`murmur3_hash`: Spark's ``Murmur3Hash`` (seed 42), int32 ``[n]``.
- :func:`xxhash64`: Spark's ``XxHash64`` (seed 42), int64 ``[n]``, Spark's
  long.  The JAX package returns the same bits as ``[n, 2]`` uint32
  (lo, hi); here they are one little-endian 64-bit word, because torch has
  almost no uint32 arithmetic: ``port == lo | hi << 32`` as int64.
- :func:`hash_partition_ids`: Spark's ``HashPartitioning``, ``pmod`` of the
  murmur3 hash.

Each chains over the columns: a null field leaves the running hash
unchanged, a fixed-width value hashes its Spark-normalised bytes (the
kernels normalise by type code; the plain versions with
``hash_kernels._as_u32_words`` / ``_col_u64_blocks``), and a string column
hashes its bytes seeded by the running hash.  An Arrow-layout string column
reaches the kernels as its padded window (``Column.chars_window`` of its
longest length rounded up to 4: zeros past each length do not change a
hash), as the JAX package's ``_resolve_str_window`` reads the longest
length once and hashes that window.  The chain runs
as one CUDA kernel (:mod:`.hash_kernels`) on the card, and as the kernel's
plain version when the caller passes ``device="cpu"``.  The JAX package's
shape bucketing, obs spans and metrics, and its ``SRJ_TPU_PALLAS`` engine
choice with its fallback are left out: there is one engine and no
fallback.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from spark_rapids_jni_tpu_torch.table import Column, Table, resolve_device
from spark_rapids_jni_tpu_torch.ops import hash_kernels

DEFAULT_SEED = 42

Columns = Union[Table, Sequence[Column]]


def _columns_on(table_or_cols: Columns, device) -> tuple:
    """The columns on the entry point's device, checked: no decimal128
    column, and every padded string length within its width (one host
    read of the lengths' range, as the JAX package's
    ``_resolve_str_window`` reads them); Arrow-layout string columns as
    padded windows of their longest length rounded up to 4 (one host read
    of every Arrow column's length range)."""
    dev = resolve_device(device)
    cols = (table_or_cols.columns if isinstance(table_or_cols, Table)
            else tuple(table_or_cols))
    if not cols:
        raise ValueError("hashing needs at least one column")
    if any(c.dtype.kind == "decimal128" for c in cols):
        raise ValueError(
            "decimal128 columns are not hashed by the port yet: the JAX "
            "package hashes them on its XLA chain, which waits for "
            "ROADMAP.md queue 1, item 3")
    cols = [c.to(dev) for c in cols]
    arrow = [i for i, c in enumerate(cols)
             if c.dtype.is_string and not c.is_padded]
    ranges = torch.stack([
        torch.stack(torch.aminmax(cols[i].str_lens())) if cols[i].num_rows
        else torch.zeros(2, dtype=torch.int32, device=dev)
        for i in arrow]).tolist() if arrow else []
    for i, (lo, hi) in zip(arrow, ranges):
        if lo < 0:
            raise ValueError("string offsets decrease: a negative length")
        cols[i] = cols[i]._padded_view((hi + 3) // 4 * 4)
    for i, c in enumerate(cols):
        if c.dtype.is_string and c.num_rows and i not in arrow:
            lo, hi = (int(x) for x in torch.aminmax(c.lens))
            if lo < 0 or hi > c.chars2d.shape[1]:
                raise ValueError(
                    f"string lengths in [{lo}, {hi}] do not fit the padded "
                    f"width {c.chars2d.shape[1]}; refusing to hash "
                    f"truncated bytes")
    return tuple(cols)


def murmur3_hash(table_or_cols: Columns, seed: int = DEFAULT_SEED, *,
                 device=None) -> torch.Tensor:
    """Spark ``Murmur3Hash(cols)``: int32 ``[n]``.  Null rows of a column
    leave the running hash unchanged (Spark skips null fields).  Runs on
    ``device`` (default: the CUDA card)."""
    return hash_kernels.murmur3_cols(_columns_on(table_or_cols, device),
                                     seed)


def xxhash64(table_or_cols: Columns, seed: int = DEFAULT_SEED, *,
             device=None) -> torch.Tensor:
    """Spark ``XxHash64(cols)``: int64 ``[n]`` (Spark's long; the JAX
    package's ``[n, 2]`` uint32 ``(lo, hi)`` read as one little-endian
    word), chained per column with null fields skipped."""
    return hash_kernels.xxhash64_cols(_columns_on(table_or_cols, device),
                                      seed)


def pmod(hashes: torch.Tensor, divisor: int) -> torch.Tensor:
    """Spark's positive modulo, used by HashPartitioning."""
    return torch.remainder(hashes, divisor)


def hash_partition_ids(table_or_cols: Columns, num_partitions: int,
                       seed: int = DEFAULT_SEED, *,
                       device=None) -> torch.Tensor:
    """Row -> partition id, int32 ``[n]`` in ``[0, num_partitions)``,
    exactly as Spark's HashPartitioning computes it."""
    return pmod(murmur3_hash(table_or_cols, seed, device=device),
                num_partitions)
