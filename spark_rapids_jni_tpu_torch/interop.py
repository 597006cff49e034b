"""Carry tables and plane-major backings across from the JAX package, as numpy.

Both packages compute on the same data only if it crosses bit for bit.  The
JAX package's tables are handed over as numpy arrays, one tuple per column:
``(dtype name, values, packed validity or None)`` for a fixed-width column
(a decimal128 column's values are its uint32 ``[n, 4]`` limbs), the name
being ``repr`` of the column type, which both packages print alike.  A
string column crosses as four entries, ``("string", chars2d, lens, packed
validity or None)`` when dense-padded and ``("string", offsets, chars,
packed validity or None)`` in Arrow layout: the second array's ``ndim``
tells them apart (2 for ``chars2d``, 1 for the int32 offsets ``[n + 1]``).
A ``chars2d`` of any width crosses; the port widens it with zero columns to
a multiple of 4.
Arrow offsets leave the port rebased to 0, with only the column's own
chars.  Its ``GroupedColumns`` cross as uint32 planes plus packed masks,
its ``RowsColumn`` batches as their bytes and offsets, with the padded
layout's row size and string widths for a dense-padded batch and neither
for a fixed-width or compact one.  Nothing here imports JAX: the caller
does the ``np.asarray``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.table import (
    Column, DType, Table, dtype_from_name, resolve_device,
)
from spark_rapids_jni_tpu_torch.ops.row_conversion import RowsColumn
from spark_rapids_jni_tpu_torch.ops.row_layout import compute_row_layout
from spark_rapids_jni_tpu_torch.ops.row_mxu import GroupedColumns

ColumnArrays = Union[Tuple[str, np.ndarray, Optional[np.ndarray]],
                     Tuple[str, np.ndarray, np.ndarray, Optional[np.ndarray]]]


def _dtype(d: Union[str, DType]) -> DType:
    return d if isinstance(d, DType) else dtype_from_name(d)


def _column(arrays: ColumnArrays, dev: torch.device) -> Column:
    name = arrays[0]
    if not _dtype(name).is_string:
        _, values, validity = arrays
        return Column.from_packed_numpy(values, _dtype(name), validity, dev)
    if len(arrays) != 4:
        raise ValueError(
            f"a string column crosses as (\"string\", chars2d, lens, "
            f"validity) or (\"string\", offsets, chars, validity), got "
            f"{len(arrays)} entries")
    _, first, second, validity = arrays
    if validity is not None:
        validity = torch.from_numpy(np.array(validity, np.uint8)).to(dev)
    if np.ndim(first) == 1:
        return Column.arrow_strings(
            torch.from_numpy(np.array(first, np.int32)).to(dev),
            torch.from_numpy(np.array(second, np.uint8)).to(dev), validity)
    # the port's padded width is a multiple of 4 (the JAX package's string
    # casts give any width): zero columns widen it
    chars2d = np.array(first, np.uint8)
    chars2d = np.pad(chars2d, ((0, 0), (0, -chars2d.shape[1] % 4)))
    return Column.padded_strings(
        torch.from_numpy(chars2d).to(dev),
        torch.from_numpy(np.array(second, np.int32)).to(dev), validity)


def table_from_numpy_columns(columns: Sequence[ColumnArrays],
                             device=None) -> Table:
    """A port table from per-column tuples: ``(dtype name, values [n],
    packed validity uint8 [ceil(n/8)] or None)``, ``("string", chars2d
    uint8 [n, W], lens int32 [n], packed validity or None)`` or
    ``("string", offsets int32 [n + 1], chars uint8 flat, packed validity
    or None)``."""
    dev = resolve_device(device)
    return Table(tuple(_column(c, dev) for c in columns))


def table_to_numpy_columns(table: Table) -> List[ColumnArrays]:
    """Inverse of :func:`table_from_numpy_columns`."""
    out = []
    for c in table.columns:
        validity = None if c.validity is None else c.validity.cpu().numpy()
        if c.dtype.is_string and c.is_padded:
            out.append((repr(c.dtype), c.chars2d.cpu().numpy(),
                        c.lens.cpu().numpy(), validity))
        elif c.dtype.is_string:
            offs = c.offsets.cpu().numpy()
            lo, hi = int(offs[0]), int(offs[-1])
            out.append((repr(c.dtype), offs - lo,
                        c.chars[lo:hi].cpu().numpy(), validity))
        else:
            out.append((repr(c.dtype), c.to_numpy(), validity))
    return out


def grouped_from_numpy(planes: np.ndarray, vmask: np.ndarray,
                       dtypes: Sequence[Union[str, DType]],
                       device=None) -> GroupedColumns:
    """A port backing from uint32 ``[W, n]`` planes and uint8
    ``[ncols, ceil(n/8)]`` packed masks (the planes become int32 tensors
    with the same bits)."""
    dev = resolve_device(device)
    layout = compute_row_layout([_dtype(d) for d in dtypes])
    p = np.ascontiguousarray(np.asarray(planes, np.uint32)).view(np.int32)
    v = np.ascontiguousarray(np.asarray(vmask, np.uint8))
    return GroupedColumns(torch.from_numpy(p.copy()).to(dev),
                          torch.from_numpy(v.copy()).to(dev), layout)


def grouped_to_numpy(gc: GroupedColumns) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of :func:`grouped_from_numpy`: (uint32 planes, uint8
    masks)."""
    return (gc.planes.cpu().numpy().view(np.uint32),
            gc.vmask.cpu().numpy())


def rows_from_numpy(data: np.ndarray, offsets: np.ndarray,
                    row_size: Optional[int] = None,
                    str_widths: Optional[Sequence[int]] = None,
                    device=None) -> RowsColumn:
    """A port batch from uint8 row bytes (``[n, row_bytes]`` or flat),
    int32 ``[n + 1]`` offsets and, for a dense-padded batch, its row size
    and string widths (a fixed-width or compact batch has neither)."""
    dev = resolve_device(device)
    widths = None if str_widths is None else tuple(int(w) for w in
                                                   str_widths)
    return RowsColumn(
        torch.from_numpy(np.array(data, np.uint8)).to(dev),
        torch.from_numpy(np.array(offsets, np.int32)).to(dev),
        None if row_size is None else int(row_size), widths)


def rows_to_numpy(rows: RowsColumn) -> Tuple[np.ndarray, np.ndarray,
                                             Optional[int],
                                             Optional[Tuple[int, ...]]]:
    """Inverse of :func:`rows_from_numpy`: (bytes, offsets, row size,
    string widths)."""
    return (rows.data.cpu().numpy(), rows.offsets.cpu().numpy(),
            rows.row_size, rows.str_widths)
