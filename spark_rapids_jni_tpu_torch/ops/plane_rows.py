"""The word-plane row engine: fixed-width columns to and from JCUDF rows
through a row's 32-bit word planes.

The PyTorch counterpart of the row half of
``spark_rapids_jni_tpu.ops.pallas_kernels`` (``pallas_kernels.py:205-425``),
the engine ``convert_to_rows``/``convert_from_rows`` take with
``impl="pallas"`` and the serve ``rows``/``unrows`` ops run.

- :func:`_word_planes_from_table` assembles int32 ``[W, n]`` planes, ``W =
  row_size / 4``: plane ``j`` holds bytes ``4j .. 4j + 3`` of every row,
  each column's little-endian bytes at its offset in the row, the validity
  bytes at the validity offset and zeros in the gaps.
  :func:`to_rows_fixed` is that assembly, then the pack kernel
  (``kernels.planes_to_rows``, K4).
- :func:`from_rows_fixed` is the unpack kernel (``kernels.rows_to_planes``,
  K5), then :func:`_cols_from_word_planes`, which cuts every column and its
  packed validity mask out of the planes.

The assembly and the extraction are torch copies through integer views of
the same bytes, never value casts, so that NaN payloads, -0.0 and BOOL8
bytes keep their bits.  Planes are int32 tensors holding the JAX package's
uint32 bits, because torch implements few operations on ``uint32``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from spark_rapids_jni_tpu_torch.table import (
    BITS_DTYPES, Column, Table, bits_view, pack_bools, valid_bits,
)
from spark_rapids_jni_tpu_torch.ops import kernels
from spark_rapids_jni_tpu_torch.ops.row_layout import RowLayout


def _check_fixed(layout: RowLayout):
    if layout.has_strings:
        raise ValueError("the word-plane engine covers fixed-width tables")


def _validity_byte_planes(table: Table, layout: RowLayout, start: int,
                          size: int) -> torch.Tensor:
    """uint8 ``[validity_bytes, size]``: byte ``b`` of rows ``[start, start
    + size)``'s validity, bit ``c % 8`` of byte ``c // 8`` being column
    ``c``'s (1 = valid)."""
    vb = layout.validity_bytes
    bits = torch.nn.functional.pad(valid_bits(table.columns, start, size),
                                   (0, 0, 0, 8 * vb - layout.num_columns))
    shifts = torch.arange(8, dtype=torch.uint8, device=table.device)
    return (bits.view(vb, 8, size) << shifts[:, None]).sum(
        1, dtype=torch.uint8)


def _word_planes_from_table(table: Table, layout: RowLayout, start: int = 0,
                            size: Optional[int] = None) -> torch.Tensor:
    """JCUDF word planes int32 ``[W, size]`` of table rows ``[start, start +
    size)`` (``pallas_kernels._word_planes_from_table``): each column's
    bytes copied into its word (a 64-bit column's lo and hi words into two
    planes, a decimal128 column's limbs into four, narrower columns into
    their bytes of one), the validity bytes
    at the validity offset, zeros elsewhere."""
    _check_fixed(layout)
    if size is None:
        size = table.num_rows - start
    num_words = layout.fixed_row_size // 4
    planes = torch.zeros((num_words, size), dtype=torch.int32,
                         device=table.device)
    plane_bytes = planes.view(torch.uint8).view(num_words, size, 4)
    for col, s, sz in zip(table.columns, layout.col_starts,
                          layout.col_sizes):
        data = bits_view(col.data)[start:start + size]
        w = s // 4
        if sz == 16:        # decimal128 [size, 4] limbs
            planes[w:w + 4] = data.T
        elif sz == 8:
            planes[w:w + 2] = data.view(torch.int32).view(size, 2).T
        elif sz == 4:
            planes[w] = data
        else:
            plane_bytes[w, :, s % 4:s % 4 + sz] = \
                data.view(torch.uint8).view(size, sz)
    if layout.num_columns:
        vo = layout.validity_offset
        for b, byte in enumerate(_validity_byte_planes(table, layout, start,
                                                       size)):
            plane_bytes[(vo + b) // 4, :, (vo + b) % 4] = byte
    return planes


def _cols_from_word_planes(x: torch.Tensor, layout: RowLayout
                           ) -> Tuple[List[torch.Tensor],
                                      List[torch.Tensor]]:
    """Every column's data and packed validity mask from word planes int32
    ``[W, n]`` (``pallas_kernels._cols_from_word_planes``): a 4-byte column
    is a view of its plane, a 64-bit one its lo/hi plane pair transposed
    into native values, a decimal128 one its four planes transposed into
    ``[n, 4]`` limbs, a narrower one a copy of its bytes."""
    _check_fixed(layout)
    n = x.shape[1]
    xb = x.view(torch.uint8).view(x.shape[0], n, 4)
    datas = []
    for dt, s, sz in zip(layout.dtypes, layout.col_starts, layout.col_sizes):
        w = s // 4
        if sz == 16:
            data = x[w:w + 4].T.contiguous()
        elif sz == 8:
            data = torch.stack((x[w], x[w + 1]), 1).view(torch.int64).view(n)
        elif sz == 4:
            data = x[w]
        else:
            data = (xb[w, :, s % 4:s % 4 + sz].contiguous()
                    .view(BITS_DTYPES[sz]).view(n))
        datas.append(data.view(dt.torch_dtype))
    vo, vb = layout.validity_offset, layout.validity_bytes
    vbytes = torch.stack([xb[(vo + b) // 4, :, (vo + b) % 4]
                          for b in range(vb)])
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)
    bits = (vbytes[:, None, :] >> shifts[:, None]) & 1       # [vb, 8, n]
    vmask = pack_bools(bits.view(8 * vb, n)[:layout.num_columns])
    return datas, list(vmask)


def to_rows_fixed(table: Table, layout: RowLayout, start: int = 0,
                  size: Optional[int] = None) -> torch.Tensor:
    """JCUDF rows uint8 ``[size, row_size]`` of table rows ``[start, start
    + size)`` (``pallas_kernels.to_rows_fixed``): the batch's word planes,
    then one pack kernel launch (K4)."""
    if size is None:
        size = table.num_rows - start
    planes = _word_planes_from_table(table, layout, start, size)
    return kernels.planes_to_rows(planes, 0, size)


def from_rows_fixed(rows2d: torch.Tensor, layout: RowLayout) -> List[Column]:
    """Columns of JCUDF rows uint8 ``[n, row_size]``
    (``pallas_kernels.from_rows_fixed``): one unpack kernel launch (K5),
    then each column cut out of the planes."""
    _check_fixed(layout)
    if rows2d.dim() != 2 or rows2d.shape[1] != layout.fixed_row_size:
        raise ValueError(f"rows must be [n, {layout.fixed_row_size}], got "
                         f"{tuple(rows2d.shape)}")
    datas, masks = _cols_from_word_planes(kernels.rows_to_planes(rows2d),
                                          layout)
    return [Column(dt, d, m) for dt, d, m in zip(layout.dtypes, datas,
                                                 masks)]
