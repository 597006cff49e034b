"""Table <-> JCUDF row-blob conversion, fixed-width tables.

The PyTorch counterpart of ``spark_rapids_jni_tpu.ops.row_conversion``
(reference ``src/main/cpp/src/row_conversion.cu``; public API
``row_conversion.hpp:27-49``).  Every fixed-width encode runs through the
plane-major backing and the encode kernel (``row_mxu.table_to_grouped``,
then ``kernels.grouped_encode`` once per batch); every decode through the
decode kernel (``kernels.decode_planes``).  The JAX package's batching
policy on the TPU main path is kept on every device: batches of at most
2^31 - 1 bytes, equal-sized and aligned to 1024 rows, or, for tables under
1024 rows or a ``size_limit`` below 1024 rows, the 32-row-aligned policy
of its XLA path.

``convert_{to,from}_rows_fixed_width_optimized`` are the independent byte
gather oracle (the reference's legacy path), in plain PyTorch.

String columns are the next slice of the port: a schema holding one raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.table import (
    BITS_DTYPES, Column, DType, Table, bits_view, pack_bools, resolve_device,
)
from spark_rapids_jni_tpu_torch.ops import kernels, row_mxu
from spark_rapids_jni_tpu_torch.ops.row_layout import (
    MAX_BATCH_BYTES, RowLayout, compute_row_layout,
)


# ---------------------------------------------------------------------------
# Output container: the LIST<INT8> column analogue
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RowsColumn:
    """One batch of JCUDF rows: the cudf ``LIST<INT8>`` column the reference
    returns (``row_conversion.cu:1871-1887``): the row bytes plus int32 row
    offsets (``offsets[i]`` .. ``offsets[i+1]`` is row ``i``).  ``data`` is
    uint8 ``[num_rows, row_size]`` as the encode produces it, or a flat
    ``[total_bytes]`` wire blob."""

    data: torch.Tensor
    offsets: torch.Tensor

    @property
    def num_rows(self) -> int:
        return self.offsets.shape[0] - 1

    def rows2d(self, row_size: int) -> torch.Tensor:
        """``[n, row_size]`` view (2-D passthrough; flat blobs reshape)."""
        if self.data.dim() == 2:
            return self.data
        return self.data.view(-1, row_size)

    def row_bytes(self, i: int) -> bytes:
        offs = self.offsets.cpu().numpy()
        flat = self.data.reshape(-1)[int(offs[i]):int(offs[i + 1])]
        return flat.cpu().numpy().tobytes()


def _offsets(num_rows: int, row_size: int, device) -> torch.Tensor:
    return torch.arange(num_rows + 1, dtype=torch.int32,
                        device=device) * row_size


# ---------------------------------------------------------------------------
# Batch planning (host side, mirrors reference build_batches)
# ---------------------------------------------------------------------------

def plan_fixed_batches(num_rows: int, row_size: int,
                       size_limit: int = MAX_BATCH_BYTES
                       ) -> List[Tuple[int, int]]:
    """Split [0, num_rows) into batches of <= size_limit bytes, 32-row aligned
    (reference ``build_batches`` ``row_conversion.cu:1460-1539``)."""
    if num_rows == 0:
        return [(0, 0)]
    max_rows = (size_limit // row_size) // 32 * 32
    if max_rows == 0:
        if num_rows <= 32 and num_rows * row_size <= size_limit:
            max_rows = num_rows
        else:
            raise ValueError(
                f"size_limit {size_limit} cannot hold a 32-row-aligned batch "
                f"of {row_size}-byte rows")
    batches = []
    start = 0
    while start < num_rows:
        end = min(num_rows, start + max_rows)
        batches.append((start, end))
        start = end
    return batches


def plan_grouped_batches(num_rows: int, row_size: int,
                         size_limit: int = MAX_BATCH_BYTES
                         ) -> List[Tuple[int, int]]:
    """(start, size) of each encode batch: the JAX package's TPU main-path
    policy (``convert_to_rows_grouped``).  Equal batches aligned to 1024
    rows, at most ``min(size_limit, 2^31 - 1)`` bytes each; tables under
    1024 rows, or a limit below 1024 rows, take its XLA path's policy:
    equal 32-row-aligned batches of at most ``min(size_limit, 1 GiB)``."""
    align = row_mxu._FUSE_TILE
    chunk = min(size_limit, MAX_BATCH_BYTES)
    per_max = chunk // row_size // align * align
    if num_rows >= align and per_max:
        nb = -(-num_rows * row_size // chunk)
        per = min((-(-num_rows // nb) + align - 1) // align * align, per_max)
    else:
        chunk = min(size_limit, 1 << 30)
        if len(plan_fixed_batches(num_rows, row_size, chunk)) == 1:
            return [(0, num_rows)]
        nb = -(-num_rows * row_size // chunk)
        per = min((-(-num_rows // nb) + 31) // 32 * 32,
                  chunk // row_size // 32 * 32)
    return [(s, min(per, num_rows - s)) for s in range(0, num_rows, per)]


# ---------------------------------------------------------------------------
# Public API: the kernel path
# ---------------------------------------------------------------------------

def _fixed_layout(dtypes: Sequence[DType]) -> RowLayout:
    layout = compute_row_layout(dtypes)
    if layout.has_strings:
        raise NotImplementedError(
            "string columns are not ported yet: variable-width row "
            "conversion is the next slice of the PyTorch port")
    return layout


def convert_to_rows(table: Table, *, size_limit: int = MAX_BATCH_BYTES,
                    device=None) -> List[RowsColumn]:
    """Convert a fixed-width table to JCUDF row batches (reference
    ``convert_to_rows``, ``row_conversion.cu:1902-1960``): one pack into
    the plane-major backing, then one encode kernel per batch.  Runs on
    ``device`` (default: the CUDA card)."""
    dev = resolve_device(device)
    layout = _fixed_layout(table.dtypes)
    gc = row_mxu.table_to_grouped(table.to(dev), layout)
    return _encode_batches(gc, size_limit)


def convert_to_rows_grouped(gc: row_mxu.GroupedColumns, *,
                            size_limit: int = MAX_BATCH_BYTES,
                            device=None) -> List[RowsColumn]:
    """Convert a plane-major backing (``row_mxu.table_to_grouped`` or a
    grouped decode) straight to JCUDF row batches: one encode kernel per
    batch, traffic exactly planes in and rows out."""
    dev = resolve_device(device)
    _fixed_layout(gc.layout.dtypes)
    return _encode_batches(gc.to(dev), size_limit)


def _encode_batches(gc: row_mxu.GroupedColumns,
                    size_limit: int) -> List[RowsColumn]:
    rs = gc.layout.fixed_row_size
    out = []
    for start, size in plan_grouped_batches(gc.num_rows, rs, size_limit):
        rows = kernels.grouped_encode(gc.planes, gc.vmask, gc.layout,
                                      start, size)
        out.append(RowsColumn(rows, _offsets(size, rs, gc.device)))
    return out


def _rows2d_on(rows: RowsColumn, layout: RowLayout, dev) -> torch.Tensor:
    n = rows.num_rows
    if rows.data.numel() != n * layout.fixed_row_size:
        raise ValueError(
            f"row blob holds {rows.data.numel()} bytes but offsets "
            f"describe {n} rows of {layout.fixed_row_size}")
    return rows.rows2d(layout.fixed_row_size).to(dev)


def convert_from_rows(rows: RowsColumn, dtypes: Sequence[DType], *,
                      device=None) -> Table:
    """Convert one batch of fixed-width JCUDF rows back to a table
    (reference ``convert_from_rows``, ``row_conversion.cu:2032-2250``):
    one decode kernel, then one column per field."""
    dev = resolve_device(device)
    layout = _fixed_layout(dtypes)
    return Table(tuple(row_mxu.from_rows_fixed(
        _rows2d_on(rows, layout, dev), layout)))


def convert_from_rows_grouped(rows: RowsColumn, dtypes: Sequence[DType], *,
                              device=None) -> row_mxu.GroupedColumns:
    """Decode one batch of fixed-width JCUDF rows to the plane-major
    backing (``[W, n]`` word planes plus packed validity); consumers
    extract only the columns they touch with ``.column(i)``."""
    dev = resolve_device(device)
    layout = _fixed_layout(dtypes)
    return row_mxu.from_rows_fixed_grouped(_rows2d_on(rows, layout, dev),
                                           layout)


# ---------------------------------------------------------------------------
# Oracle: independent byte-gather implementation (the "legacy path")
# ---------------------------------------------------------------------------

def _oracle_gather_maps(layout: RowLayout) -> Tuple[np.ndarray, np.ndarray]:
    """Static per-row-byte source maps.  ``src[j]`` indexes into the packed
    column-byte matrix for data bytes, ``vsrc[j]`` indexes validity bytes;
    -1 means "not this source" (padding -> zero)."""
    starts_packed = np.cumsum([0] + list(layout.col_sizes))[:-1]
    src = -np.ones(layout.fixed_row_size, dtype=np.int64)
    vsrc = -np.ones(layout.fixed_row_size, dtype=np.int64)
    for i in range(layout.num_columns):
        s, sz = layout.col_starts[i], layout.col_sizes[i]
        src[s:s + sz] = starts_packed[i] + np.arange(sz)
    vsrc[layout.validity_offset:layout.fixed_end] = np.arange(
        layout.validity_bytes)
    return src, vsrc


def _validity_row_bytes(table: Table, layout: RowLayout) -> torch.Tensor:
    """Validity bytes per row, ``[n, validity_bytes]``: byte ``c // 8``,
    bit ``c % 8`` of column ``c``; 1 = valid."""
    n = table.num_rows
    out = torch.zeros((n, layout.validity_bytes), dtype=torch.uint8,
                      device=table.device)
    for c, col in enumerate(table.columns):
        out[:, c // 8] |= col.valid_bools().to(torch.uint8) << (c % 8)
    return out


def _oracle_to_rows(table: Table, layout: RowLayout) -> torch.Tensor:
    n = table.num_rows
    dev = table.device
    packed = torch.cat([bits_view(c.data).view(torch.uint8).view(n, sz)
                        for c, sz in zip(table.columns, layout.col_sizes)],
                       dim=1)
    src, vsrc = (torch.from_numpy(m).to(dev)
                 for m in _oracle_gather_maps(layout))
    data_part = packed[:, src.clamp(min=0)]
    val_part = _validity_row_bytes(table, layout)[:, vsrc.clamp(min=0)]
    zero = torch.zeros((), dtype=torch.uint8, device=dev)
    return torch.where(src >= 0, data_part,
                       torch.where(vsrc >= 0, val_part, zero))


def _oracle_from_rows(rows2d: torch.Tensor, layout: RowLayout) -> Table:
    """Oracle inverse: one slice of the row matrix per column."""
    cols = []
    for i, dt in enumerate(layout.dtypes):
        s, sz = layout.col_starts[i], layout.col_sizes[i]
        data = (rows2d[:, s:s + sz].reshape(-1)
                .view(BITS_DTYPES[sz]).view(dt.torch_dtype))
        vbyte = rows2d[:, layout.validity_offset + i // 8]
        cols.append(Column(dt, data, pack_bools((vbyte >> (i % 8)) & 1)))
    return Table(tuple(cols))


def convert_to_rows_fixed_width_optimized(
        table: Table, *, size_limit: int = MAX_BATCH_BYTES,
        device=None) -> List[RowsColumn]:
    """Oracle path: fixed-width tables only (parity with the reference legacy
    path which rejects strings, ``row_conversion.cu:2019``).  Batches follow
    ``plan_fixed_batches``."""
    dev = resolve_device(device)
    layout = compute_row_layout(table.dtypes)
    if layout.has_strings:
        raise ValueError("fixed-width-optimized path does not support strings")
    rows2d = _oracle_to_rows(table.to(dev), layout)
    rs = layout.fixed_row_size
    return [RowsColumn(rows2d[start:end], _offsets(end - start, rs, dev))
            for start, end in plan_fixed_batches(rows2d.shape[0], rs,
                                                 size_limit)]


def convert_from_rows_fixed_width_optimized(
        rows: RowsColumn, dtypes: Sequence[DType], *, device=None) -> Table:
    dev = resolve_device(device)
    layout = compute_row_layout(dtypes)
    if layout.has_strings:
        raise ValueError("fixed-width-optimized path does not support strings")
    return _oracle_from_rows(rows.rows2d(layout.fixed_row_size).to(dev),
                             layout)
