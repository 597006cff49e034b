"""The per-column-block row engine: fixed-width tables to and from JCUDF
rows through K10 and K11.

The PyTorch counterpart of ``spark_rapids_jni_tpu.ops.row_kernels``, the
tiled kernel form of the generic (``impl="xla"``) engine.  The TPU kernels
move one byte block per column through VMEM; their CUDA counterparts
(``kernels.to_rows_cols``, ``kernels.from_rows_cols``) stage a tile of whole
rows in shared memory and read or write every column in place.  Unlike the
JAX package, nothing is cut out of the columns before the encode, and the
decode writes the columns' values and packed masks itself.

- :func:`to_rows_fixed` and :func:`from_rows_fixed` take ``bucket``
  (``runtime.shapes``): the default ``"auto"`` pads the row axis up the
  shape grid (the table with invalid rows, the rows with zero rows that
  decode as all-null), launches over the bucket and slices the result back,
  as the JAX package does; ``None`` launches over the rows as they are.
  The JAX package pads so that ``jit`` keeps one program a bucket; the
  port compiles nothing per shape, so here ``"auto"`` only costs time (the
  pad and the slice take most of the call at 1M rows, ``PERF.md``).
- :func:`to_rows_fixed_batch` encodes one batch of a table's rows and does
  not bucket, as the JAX package's jitted form does not (there ``"auto"``
  resolves to None under the trace).
- ``tile_rows``: rows of the kernels' shared tile, 0 to size it from the
  shared-memory budget (``kernels.tile_rows_for``).  The JAX ``interpret``
  argument has no counterpart: on the CPU the wrappers run their plain
  versions.
"""

from __future__ import annotations

from typing import List

import torch

from spark_rapids_jni_tpu_torch.table import Column, Table, resolve_device
from spark_rapids_jni_tpu_torch.ops import kernels
from spark_rapids_jni_tpu_torch.ops.row_layout import RowLayout
from spark_rapids_jni_tpu_torch.runtime import shapes


def to_rows_fixed(table: Table, layout: RowLayout, tile_rows: int = 0,
                  bucket="auto", device=None) -> torch.Tensor:
    """uint8 ``[n, row_size]`` JCUDF rows of a fixed-width table on
    ``device`` (default: the CUDA card): one K10 launch over the table, or
    over the table padded to its bucket (tail rows invalid, encoded as
    all-null rows and sliced off)."""
    table = table.to(resolve_device(device))
    f = shapes.resolve(bucket)
    n = table.num_rows
    if f is not None and shapes.bucketable(table):
        b = shapes.bucket_rows(n, f)
        rows = kernels.to_rows_cols(shapes.pad_table(table, b), layout, 0, b,
                                    tile_rows)
        return shapes.unpad_array(rows, n)
    return kernels.to_rows_cols(table, layout, 0, n, tile_rows)


def to_rows_fixed_batch(table: Table, layout: RowLayout, start: int,
                        size: int, device=None) -> torch.Tensor:
    """uint8 ``[size, row_size]`` rows of table rows ``[start, start +
    size)``: one K10 launch that reads every column in place at ``start``,
    which may be any row."""
    return kernels.to_rows_cols(table.to(resolve_device(device)), layout,
                                start, size)


def from_rows_fixed(rows2d: torch.Tensor, layout: RowLayout,
                    tile_rows: int = 0, bucket="auto",
                    device=None) -> List[Column]:
    """The columns of uint8 ``[n, row_size]`` JCUDF rows on ``device``: one
    K11 launch over the rows, or over the rows padded with zero rows to
    their bucket, the columns then sliced back to ``n`` rows."""
    rows2d = rows2d.to(resolve_device(device))
    f = shapes.resolve(bucket)
    n = rows2d.shape[0]
    if f is not None:
        padded = shapes.pad_to(rows2d, (shapes.bucket_rows(n, f),
                                        rows2d.shape[1]))
        return [shapes.unpad_column(c, n)
                for c in _columns(padded, layout, tile_rows)]
    return _columns(rows2d, layout, tile_rows)


def _columns(rows2d: torch.Tensor, layout: RowLayout,
             tile_rows: int) -> List[Column]:
    datas, vmask = kernels.from_rows_cols(rows2d, layout, tile_rows)
    return [Column(dt, d, m) for dt, d, m in zip(layout.dtypes, datas,
                                                 vmask)]
