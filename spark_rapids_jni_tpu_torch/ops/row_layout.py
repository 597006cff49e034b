"""JCUDF row-layout calculator, copied from the JAX package's ``row_layout``.

The layout contract of the JCUDF row format (reference javadoc
``RowConversion.java:40-99``, ``compute_column_information`` in
``row_conversion.cu:1331-1370``):

- Columns are packed in caller order, C-struct style: each fixed-width column
  is aligned to its own byte size; a string column occupies a uint32
  (offset, length) pair, 8 bytes, 4-byte aligned.
- Validity bytes follow the fixed-width section with no extra alignment:
  one byte per 8 columns, bit ``c % 8`` of byte ``c // 8``; 1 = valid.
- The fixed-width row size is the validity end rounded up to 8 bytes.
- Rows whose fixed-width section exceeds 1KB are rejected (reference
  contract ``RowConversion.java:98-99``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

from spark_rapids_jni_tpu_torch.table import DType

JCUDF_ROW_ALIGNMENT = 8
MAX_ROW_SIZE = 1024  # 1KB contract
MAX_BATCH_BYTES = (1 << 31) - 1  # rows must index with int32 offsets


def _round_up(x: int, align: int) -> int:
    return (x + align - 1) // align * align


@dataclasses.dataclass(frozen=True)
class RowLayout:
    """Static description of one table schema's row layout."""

    dtypes: Tuple[DType, ...]
    col_starts: Tuple[int, ...]       # byte offset of each column in the row
    col_sizes: Tuple[int, ...]        # byte size of each column's row slot
    variable_starts: Tuple[int, ...]  # row offsets of string (off,len) slots
    validity_offset: int              # first validity byte
    validity_bytes: int               # ceil(num_columns / 8)
    fixed_row_size: int               # aligned size of fixed+validity section

    @property
    def num_columns(self) -> int:
        return len(self.dtypes)

    @property
    def num_variable_columns(self) -> int:
        return len(self.variable_starts)

    @property
    def has_strings(self) -> bool:
        return self.num_variable_columns > 0

    @property
    def fixed_end(self) -> int:
        """End of fixed-width data + validity, before 8-byte row rounding."""
        return self.validity_offset + self.validity_bytes


def compute_row_layout(dtypes: Sequence[DType]) -> RowLayout:
    dtypes = tuple(dtypes)
    col_starts = []
    col_sizes = []
    variable_starts = []
    pos = 0
    for dt in dtypes:
        if dt.is_string:
            size, align = 8, 4  # uint32 offset + uint32 length
        else:
            size = dt.itemsize
            align = size
        pos = _round_up(pos, align)
        if dt.is_string:
            variable_starts.append(pos)
        col_starts.append(pos)
        col_sizes.append(size)
        pos += size

    validity_offset = pos
    validity_bytes = (len(dtypes) + 7) // 8
    fixed_row_size = _round_up(validity_offset + validity_bytes,
                               JCUDF_ROW_ALIGNMENT)
    if fixed_row_size > MAX_ROW_SIZE:
        raise ValueError(
            f"row size {fixed_row_size} exceeds JCUDF maximum {MAX_ROW_SIZE}")
    return RowLayout(
        dtypes=dtypes,
        col_starts=tuple(col_starts),
        col_sizes=tuple(col_sizes),
        variable_starts=tuple(variable_starts),
        validity_offset=validity_offset,
        validity_bytes=validity_bytes,
        fixed_row_size=fixed_row_size,
    )
