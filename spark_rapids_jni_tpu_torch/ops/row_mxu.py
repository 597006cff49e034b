"""The plane-major backing of fixed-width JCUDF row conversion.

The PyTorch counterpart of ``spark_rapids_jni_tpu.ops.row_mxu``.  The name is
kept so each function's counterpart is easy to find; nothing here runs on a
matrix unit.  A JCUDF row is a static byte permutation of the table's column
bytes plus the validity bitmask.  The table's plane-major backing
(:class:`GroupedColumns`) holds the columns as an ``int32 [W, n]`` word
matrix, one "plane" row per word (decimal128 columns as four planes, then
64/32-bit columns word-aligned, 16-bit
columns two to a word, 8-bit columns four to a word), plus packed
``uint8 [ncols, ceil(n/8)]`` validity.  The word plans fix that layout per
schema; they live in :mod:`.word_plan` (numpy, exactly as in the JAX
package) and are re-exported here under their JAX names.

The encode (backing to rows) and the decode (rows to backing) run as the
hand-written CUDA kernels in :mod:`.kernels`.  A table too large to pack
whole beside itself is encoded in two stages, batch by batch
(:func:`to_rows_fixed`): the pack kernel writes the batch's forward word
planes, validity quads included, and a static byte map turns them into
rows.  Planes are int32 tensors holding the JAX package's uint32 bits,
because torch implements few operations on ``uint32``;
:mod:`spark_rapids_jni_tpu_torch.interop` converts at the numpy boundary.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from spark_rapids_jni_tpu_torch.table import BITS_DTYPES, Column, Table
from spark_rapids_jni_tpu_torch.ops import kernels
from spark_rapids_jni_tpu_torch.ops.row_layout import (
    RowLayout, compute_row_layout,
)
from spark_rapids_jni_tpu_torch.ops.word_plan import (  # noqa: F401
    WordPlan, _build_word_plan, _data_words, _forward_plan, _inverse_plan,
)

# FixedEncoder / to_rows_fixed_grouped batch starts must be multiples of
# this (the JAX package's encode tile; kept as the API contract, the CUDA
# kernel itself takes any start)
_FUSE_TILE = 1024


# ---------------------------------------------------------------------------
# The plane-major backing
# ---------------------------------------------------------------------------

def extract_plane_column(x: torch.Tensor, plan: WordPlan, layout: RowLayout,
                         i: int) -> torch.Tensor:
    """Column ``i``'s data from word planes ``x`` (int32 ``[W, n]``): a
    plane-row view for 4-byte columns, a copy of the column's bytes
    otherwise (``[n, 4]`` limbs from a decimal128 column's four planes)."""
    dt = layout.dtypes[i]
    sz = layout.col_sizes[i]
    w0 = plan.col_word[i]
    n = x.shape[1]
    if sz == 16:    # decimal128: four planes -> [n, 4] limbs
        return x[w0:w0 + 4].T.contiguous()
    if sz == 8:
        data = x[w0:w0 + 2].T.reshape(-1).view(torch.int64)
    elif sz == 4:
        data = x[w0]
    else:
        b = plan.col_byte[i]
        data = (x[w0].view(torch.uint8).view(n, 4)[:, b:b + sz]
                .reshape(-1).view(BITS_DTYPES[sz]))
    return data.view(dt.torch_dtype)


@dataclasses.dataclass
class GroupedColumns:
    """Dtype-major table backing.

    ``planes``: int32 ``[W, n]`` word planes (64-bit columns as adjacent
    lo/hi planes first, then 4-byte planes, 16-bit halves two per plane,
    bytes four per plane; a decoded backing also carries the rows' validity
    bytes in its last planes); ``vmask``: uint8 ``[ncols, ceil(n/8)]``
    packed validity.
    """

    planes: torch.Tensor
    vmask: torch.Tensor
    layout: RowLayout = None

    @property
    def num_rows(self) -> int:
        return self.planes.shape[1]

    @property
    def device(self) -> torch.device:
        return self.planes.device

    def to(self, device) -> "GroupedColumns":
        return GroupedColumns(self.planes.to(device), self.vmask.to(device),
                              self.layout)

    def column(self, i: int) -> Column:
        """Materialize one column (a plane slice and a byte copy)."""
        plan = _inverse_plan(self.layout)[0]
        data = extract_plane_column(self.planes, plan, self.layout, i)
        return Column(self.layout.dtypes[i], data, self.vmask[i])

    def to_table(self) -> Table:
        return Table(tuple(self.column(i)
                           for i in range(self.layout.num_columns)))


def table_to_grouped(table: Table, layout: RowLayout = None
                     ) -> GroupedColumns:
    """Pack a table into its plane-major backing: ``[Wd, n]`` data planes
    (``kernels.pack_data_words``: plain tensor copies, one per column) and
    ``[ncols, ceil(n/8)]`` packed validity (255 for columns without a
    mask)."""
    if layout is None:
        layout = compute_row_layout(table.dtypes)
    n = table.num_rows
    planes = kernels.pack_data_words(table, layout, _data_words(layout), 0, n)
    nb = (n + 7) // 8
    full = torch.full((nb,), 255, dtype=torch.uint8, device=table.device)
    vmask = torch.stack([c.validity if c.validity is not None else full
                         for c in table.columns])
    return GroupedColumns(planes, vmask, layout)


# ---------------------------------------------------------------------------
# Encode: backing -> rows
# ---------------------------------------------------------------------------

def _check_batch(start: int, size: int, n: int):
    if start % _FUSE_TILE:
        raise ValueError(f"start {start} not {_FUSE_TILE}-aligned")
    if start + size > n:
        raise ValueError(f"batch [{start}, {start + size}) exceeds {n} rows")


class FixedEncoder:
    """Batched encoder over one table: one pack (``table_to_grouped``)
    builds the plane-major backing, then every ``encode(start, size)`` is
    one launch of the encode kernel at that batch (``start`` must be a
    multiple of ``_FUSE_TILE``)."""

    def __init__(self, table: Table, layout: RowLayout):
        self.layout = layout
        self.num_rows = table.num_rows
        self.gc = table_to_grouped(table, layout)

    def encode(self, start: int = 0, size: int = None) -> torch.Tensor:
        return to_rows_fixed_grouped(self.gc, start, size)


def to_rows_fixed_grouped(gc: GroupedColumns, start: int = 0,
                          size: int = None) -> torch.Tensor:
    """Encode rows ``[start, start + size)`` of a backing to uint8
    ``[size, row_size]`` JCUDF rows: one kernel, traffic exactly planes in
    and rows out."""
    n = gc.num_rows
    if size is None:
        size = n - start
    _check_batch(start, size, n)
    return kernels.grouped_encode(gc.planes, gc.vmask, gc.layout, start, size)


def to_rows_fixed(table: Table, layout: RowLayout, start: int = 0,
                  size: int = None) -> torch.Tensor:
    """The two-stage encode of table rows ``[start, start + size)`` to
    uint8 ``[size, row_size]`` JCUDF rows, holding no more than the batch
    beside the table: K3 (``kernels.pack_planes``) packs the batch's
    forward word planes, reading each column in place at ``start``, then
    :func:`forward_planes_to_rows` maps them to rows."""
    if size is None:
        size = table.num_rows - start
    return forward_planes_to_rows(
        kernels.pack_planes(table, layout, start, size), layout)


def forward_planes_to_rows(planes: torch.Tensor,
                           layout: RowLayout) -> torch.Tensor:
    """The second stage of :func:`to_rows_fixed`, the byte map of the
    forward plan (the JAX package's permutation ``dot_general``): each
    data byte of a row is a static gather from its planes' bytes, validity
    byte ``j`` is ``sum(quad_byte(c) << (c % 8))`` over columns ``c`` in
    ``8j .. 8j + 7``, and padding bytes are zero."""
    size = planes.shape[1]
    wd, nc = _data_words(layout), layout.num_columns
    dev = planes.device
    xb = planes.T.contiguous().view(torch.uint8)          # [size, 4 * W]
    idx, has = kernels._index(kernels.encode_byte_map(layout), dev)
    out = xb.index_select(1, idx).masked_fill_(~has, 0)
    vo, vb = layout.validity_offset, layout.validity_bytes
    quads = torch.nn.functional.pad(xb[:, 4 * wd:4 * wd + nc],
                                    (0, 8 * vb - nc)).view(size, vb, 8)
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    out[:, vo:vo + vb] = (quads << shifts).sum(2, dtype=torch.uint8)
    return out


# ---------------------------------------------------------------------------
# Decode: rows -> backing / columns
# ---------------------------------------------------------------------------

def _rows2d(rows: torch.Tensor, layout: RowLayout) -> torch.Tensor:
    """``[n, row_size]`` view of a blob (2-D passthrough; flat blobs
    reshape)."""
    if rows.dim() == 2:
        return rows
    return rows.view(-1, layout.fixed_row_size)


def from_rows_fixed_grouped(rows: torch.Tensor,
                            layout: RowLayout) -> GroupedColumns:
    """Decode JCUDF rows to the plane-major backing ``[W, n]`` (inverse
    plan) plus packed validity; columns are extracted lazily."""
    planes, vmask = kernels.decode_planes(_rows2d(rows, layout), layout)
    return GroupedColumns(planes, vmask, layout)


def from_rows_fixed(rows: torch.Tensor, layout: RowLayout) -> List[Column]:
    """Decode JCUDF rows to one column per field."""
    return list(from_rows_fixed_grouped(rows, layout).to_table().columns)
