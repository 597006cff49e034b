"""Table <-> JCUDF row-blob conversion: fixed-width tables, and string tables
as dense-padded or compact rows.

The PyTorch counterpart of ``spark_rapids_jni_tpu.ops.row_conversion``
(reference ``src/main/cpp/src/row_conversion.cu``; public API
``row_conversion.hpp:27-49``).

- Fixed-width encode, as the JAX package dispatches it on the TPU: a table
  whose resident pack (column bytes plus one bit a field) stays within
  :data:`_FUSED_PREP_CAP` is packed once into its plane-major backing
  (``row_mxu.table_to_grouped``) and encoded by one encode kernel per
  batch (``kernels.grouped_encode``), in equal batches of at most 2^31 - 1
  bytes aligned to 1024 rows (tables under 1024 rows, or a ``size_limit``
  below 1024 rows, take equal 32-row-aligned batches of at most
  ``min(size_limit, 1 GiB)``).  A larger table is encoded batch by batch
  in two stages (``row_mxu.to_rows_fixed``: the pack kernel
  ``kernels.pack_planes``, then the forward byte map), in equal
  32-row-aligned batches of at most ``min(size_limit, 1 GiB)``, so that
  only one batch is held beside the table.
- Fixed-width decode: one decode kernel a batch (``kernels.decode_planes``).
- ``impl="pallas"`` (or ``use_pallas=True``) takes the word-plane engine of
  :mod:`.plane_rows` instead, as the JAX package's ``impl="pallas"`` does:
  the encode assembles each batch's word planes and runs one pack kernel
  launch a batch (``kernels.planes_to_rows``), in the batches of
  :func:`plan_equal_batches` of at most ``min(size_limit, 1 GiB)``; the
  decode runs one unpack kernel launch (``kernels.rows_to_planes``) and cuts
  the columns out of the planes.
- ``impl="xla"`` (or ``use_pallas=False``) takes the generic engine, the
  JAX package's XLA lowering, here the plain PyTorch versions of K10 and
  K11 and no kernel: each batch of the same plan is zeroed rows, each
  column's bytes stored in its slot and the validity bytes
  (``kernels.to_rows_cols_plain``); the decode cuts each column's bytes and
  its validity bits out of the rows (``kernels.from_rows_cols_plain``).
  ``ops.row_kernels`` is this engine's kernel form (K10, K11), as
  ``row_kernels`` is in the JAX package.
- Every fixed-width engine carries decimal128 columns (16-byte slots,
  aligned to 16), except the two-stage encode above the cap, whose pack
  kernel takes columns of 1, 2, 4 and 8 bytes only.
- Dense-padded strings: every row has the same size, the fixed section
  (each string slot's uint32 pair holding its char slot's start and the
  string's length) then one ``W``-byte char slot per string column, slack
  past each length zero, rows rounded to 8 bytes.  The encode is torch
  copies; the decode runs the decode kernel over the rows' fixed section
  (the row stride is the padded row size) and slices the char slots.
  :func:`compact_rows_host` turns a padded batch into the compact JCUDF
  wire bytes on the host.
- Compact rows, the JCUDF wire form (the JAX package's
  ``_to_rows_variable`` and ``_from_rows_variable``): a table with any
  Arrow-layout string column (a mixed table's padded string columns go to
  Arrow first; an all-padded table keeps the padded encode).  Each row is
  its fixed section, the string slots' pairs holding each string's offset
  in the row and its length, then its strings' chars back to back from
  ``fixed_end``, rounded up to 8 bytes.  One host read fetches the row
  sizes and every string column's offsets; the batches are
  :func:`plan_variable_batches`'; each batch is one compact encode kernel
  launch (``kernels.compact_encode``) over its fixed sections, assembled
  with torch copies.  The decode gathers each row's fixed section as
  words, runs the decode kernel over them (row stride ``fe_pad``), checks
  every pair against its row in the one host read of the char totals, and
  copies every string column's chars in one string gather kernel launch
  (``kernels.string_gather``); the decoded columns are Arrow, offsets from
  0.  Width-capped columns are not ported (``ROADMAP.md`` queue 1, item
  4).

``convert_{to,from}_rows_fixed_width_optimized`` are the independent byte
gather oracle (the reference's legacy path), in plain PyTorch.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.table import (
    BITS_DTYPES, Column, DType, Table, bits_view, bytes_to_col, col_to_bytes,
    pack_bools, resolve_device,
)
from spark_rapids_jni_tpu_torch.ops import kernels, plane_rows, row_mxu
from spark_rapids_jni_tpu_torch.runtime import staging
from spark_rapids_jni_tpu_torch.ops.row_layout import (
    JCUDF_ROW_ALIGNMENT, MAX_BATCH_BYTES, RowLayout, compute_row_layout,
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
    ``[total_bytes]`` wire blob.

    ``row_size``/``str_widths`` are set on dense-padded string batches:
    every row takes ``row_size`` bytes, string column ``si`` a fixed
    ``str_widths[si]``-byte char slot that its (offset, length) pair
    addresses, so the blob is self-describing JCUDF with the compact wire
    form's content plus slack in each row.  A compact batch (a string
    table's wire form) has neither, and its ``data`` is flat."""

    data: torch.Tensor
    offsets: torch.Tensor
    row_size: Optional[int] = None
    str_widths: Optional[Tuple[int, ...]] = None

    @property
    def num_rows(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def is_padded(self) -> bool:
        return self.row_size is not None

    def rows2d(self, row_size: int) -> torch.Tensor:
        """``[n, row_size]`` view (2-D passthrough; flat blobs reshape)."""
        if self.data.dim() == 2:
            return self.data
        return self.data.view(-1, row_size)

    def row_bytes(self, i: int) -> bytes:
        offs = self.offsets.cpu().numpy()
        flat = self.data.reshape(-1)[int(offs[i]):int(offs[i + 1])]
        return flat.cpu().numpy().tobytes()


# the most bytes one batch of the JAX package's batch-sliced fixed-width
# encodes holds (its XLA path's transient bound, kept by its two-stage path)
_XLA_CHUNK = 1 << 30
# the largest resident pack (column bytes plus one bit a field) that
# convert_to_rows packs whole into the plane-major backing; above it the
# table is encoded batch by batch in two stages (the JAX package's
# SRJ_FUSED_PREP_CAP default, here a constant)
_FUSED_PREP_CAP = 4 << 30


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


def plan_variable_batches(row_sizes: np.ndarray,
                          size_limit: int = MAX_BATCH_BYTES
                          ) -> List[Tuple[int, int]]:
    """Split rows with per-row sizes into batches of <= size_limit bytes,
    32-row aligned (the JAX package's ``plan_variable_batches``)."""
    n = len(row_sizes)
    if n == 0:
        return [(0, 0)]
    cum = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(row_sizes, out=cum[1:])
    batches = []
    start = 0
    while start < n:
        # largest end with cum[end] - cum[start] <= limit
        end = int(np.searchsorted(cum, cum[start] + size_limit,
                                  side="right")) - 1
        if end < n:
            end = max(start + 32, end // 32 * 32)
        end = min(end, n)
        if end <= start:
            end = min(n, start + 32)
        if cum[end] - cum[start] > size_limit and end - start <= 32:
            raise ValueError("rows too large for a single batch")
        batches.append((start, end))
        start = end
    return batches


def plan_equal_batches(num_rows: int, row_size: int,
                       chunk: int) -> List[Tuple[int, int]]:
    """(start, size) of each batch under the JAX package's policy for its
    batch-sliced encodes (the XLA and two-stage fixed-width paths, the
    padded string path): one batch when ``plan_fixed_batches`` needs one,
    else the fewest equal batches, 32-row aligned, of at most ``chunk``
    bytes."""
    if len(plan_fixed_batches(num_rows, row_size, chunk)) == 1:
        return [(0, num_rows)]
    nb = -(-num_rows * row_size // chunk)
    per = min((-(-num_rows // nb) + 31) // 32 * 32,
              chunk // row_size // 32 * 32)
    return [(s, min(per, num_rows - s)) for s in range(0, num_rows, per)]


def plan_grouped_batches(num_rows: int, row_size: int,
                         size_limit: int = MAX_BATCH_BYTES
                         ) -> List[Tuple[int, int]]:
    """(start, size) of each encode batch: the JAX package's TPU main-path
    policy (``convert_to_rows_grouped``).  Equal batches aligned to 1024
    rows, at most ``min(size_limit, 2^31 - 1)`` bytes each; tables under
    1024 rows, or a limit below 1024 rows, take its XLA path's policy:
    :func:`plan_equal_batches` of at most ``min(size_limit, 1 GiB)``."""
    align = row_mxu._FUSE_TILE
    chunk = min(size_limit, MAX_BATCH_BYTES)
    per_max = chunk // row_size // align * align
    if num_rows < align or not per_max:
        return plan_equal_batches(num_rows, row_size,
                                  min(size_limit, _XLA_CHUNK))
    nb = -(-num_rows * row_size // chunk)
    per = min((-(-num_rows // nb) + align - 1) // align * align, per_max)
    return [(s, min(per, num_rows - s)) for s in range(0, num_rows, per)]


# ---------------------------------------------------------------------------
# Public API: the kernel path
# ---------------------------------------------------------------------------

def _grouped_layout(dtypes: Sequence[DType]) -> RowLayout:
    layout = compute_row_layout(dtypes)
    if layout.has_strings:
        raise ValueError("the grouped forms cover fixed-width tables; "
                         "string tables use convert_to_rows and "
                         "convert_from_rows")
    return layout


def _resolve_impl(impl: Optional[str], use_pallas: Optional[bool]) -> str:
    """The fixed-width engine for explicit arguments, as the JAX package's
    ``_resolve_impl`` picks it: ``"mxu"`` (the default: the plane-major
    backing's kernels), ``"pallas"`` (``use_pallas=True``: the word-plane
    engine) or ``"xla"`` (``use_pallas=False``: the generic torch
    engine).  Its ``SRJ_TPU_PALLAS`` switch is not ported."""
    if impl is None:
        impl = {None: "mxu", True: "pallas", False: "xla"}[use_pallas]
    if impl not in ("mxu", "xla", "pallas"):
        raise ValueError(f"unknown impl {impl!r}; "
                         "expected 'mxu', 'xla' or 'pallas'")
    return impl


def convert_to_rows(table: Table, *, size_limit: int = MAX_BATCH_BYTES,
                    use_pallas: Optional[bool] = None,
                    impl: Optional[str] = None,
                    device=None) -> List[RowsColumn]:
    """Convert a table to JCUDF row batches (reference ``convert_to_rows``,
    ``row_conversion.cu:1902-1960``) on ``device`` (default: the CUDA
    card).  A table with string columns takes the dense-padded encode when
    every string column is padded, else the compact encode; a
    fixed-width one one pack and one encode kernel per batch, or above
    :data:`_FUSED_PREP_CAP` the two-stage encode batch by batch, or with
    ``impl="pallas"`` the word-plane engine, or with ``impl="xla"`` the
    generic engine (see the module docstring)."""
    dev = resolve_device(device)
    layout = compute_row_layout(table.dtypes)
    table = table.to(dev)
    if layout.has_strings:
        if all(c.is_padded for c in _string_cols(table)):
            return _to_rows_variable_padded(table, layout, size_limit)
        return _to_rows_variable(table, layout, size_limit)
    impl = _resolve_impl(impl, use_pallas)
    if impl == "pallas":
        return _to_rows_batched(table, layout, size_limit,
                                plane_rows.to_rows_fixed)
    if impl == "xla":
        return _to_rows_batched(table, layout, size_limit,
                                kernels.to_rows_cols_plain)
    prep_bytes = (sum(c.data.numel() * c.data.element_size()
                      for c in table.columns)
                  + layout.num_columns * table.num_rows // 8)
    if prep_bytes > _FUSED_PREP_CAP:
        return _to_rows_batched(table, layout, size_limit,
                                row_mxu.to_rows_fixed)
    return _encode_batches(row_mxu.table_to_grouped(table, layout),
                           size_limit)


def _to_rows_batched(table: Table, layout: RowLayout, size_limit: int,
                     encode) -> List[RowsColumn]:
    """One ``encode(table, layout, start, size)`` a batch, in the batches
    of :func:`plan_equal_batches` of at most ``min(size_limit, 1 GiB)``:
    the JAX package's policy for its batch-sliced engines (the two-stage
    encode, ``impl="pallas"`` and ``impl="xla"``)."""
    rs = layout.fixed_row_size
    return [RowsColumn(encode(table, layout, start, size),
                       _offsets(size, rs, table.device))
            for start, size in plan_equal_batches(
                table.num_rows, rs, min(size_limit, _XLA_CHUNK))]


def convert_to_rows_grouped(gc: row_mxu.GroupedColumns, *,
                            size_limit: int = MAX_BATCH_BYTES,
                            device=None) -> List[RowsColumn]:
    """Convert a plane-major backing (``row_mxu.table_to_grouped`` or a
    grouped decode) straight to JCUDF row batches: one encode kernel per
    batch, traffic exactly planes in and rows out."""
    dev = resolve_device(device)
    _grouped_layout(gc.layout.dtypes)
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


def _rows2d_on(rows: RowsColumn, row_size: int, dev) -> torch.Tensor:
    n = rows.num_rows
    if rows.data.numel() != n * row_size:
        raise ValueError(
            f"row blob holds {rows.data.numel()} bytes but offsets "
            f"describe {n} rows of {row_size}")
    return rows.rows2d(row_size).to(dev)


def convert_from_rows(rows: RowsColumn, dtypes: Sequence[DType], *,
                      use_pallas: Optional[bool] = None,
                      impl: Optional[str] = None, device=None) -> Table:
    """Convert one batch of JCUDF rows back to a table (reference
    ``convert_from_rows``, ``row_conversion.cu:2032-2250``): one decode
    kernel, then one column per field; a dense-padded string batch's char
    slots are sliced out after it, a compact batch's chars gathered by the
    string gather kernel into Arrow columns.  ``impl="pallas"`` (or
    ``use_pallas=True``) decodes a fixed-width batch through the word-plane
    engine, ``impl="xla"`` (or ``use_pallas=False``) through the generic
    engine."""
    dev = resolve_device(device)
    layout = compute_row_layout(dtypes)
    if layout.has_strings:
        if rows.is_padded:
            return _from_rows_variable_padded(rows, layout, dev)
        return _from_rows_variable(rows, layout, dev)
    rows2d = _rows2d_on(rows, layout.fixed_row_size, dev)
    decode = {"mxu": row_mxu.from_rows_fixed,
              "pallas": plane_rows.from_rows_fixed,
              "xla": _from_rows_plain}[_resolve_impl(impl, use_pallas)]
    return Table(tuple(decode(rows2d, layout)))


def convert_from_rows_grouped(rows: RowsColumn, dtypes: Sequence[DType], *,
                              device=None) -> row_mxu.GroupedColumns:
    """Decode one batch of fixed-width JCUDF rows to the plane-major
    backing (``[W, n]`` word planes plus packed validity); consumers
    extract only the columns they touch with ``.column(i)``."""
    dev = resolve_device(device)
    layout = _grouped_layout(dtypes)
    return row_mxu.from_rows_fixed_grouped(
        _rows2d_on(rows, layout.fixed_row_size, dev), layout)


# ---------------------------------------------------------------------------
# The generic engine (impl="xla")
# ---------------------------------------------------------------------------

def _from_rows_plain(rows2d: torch.Tensor,
                     layout: RowLayout) -> List[Column]:
    """The generic engine's decode: the columns of
    ``kernels.from_rows_cols_plain`` (the JAX package's
    ``_disassemble_fixed_rows``)."""
    datas, vmask = kernels.from_rows_cols_plain(rows2d, layout)
    return [Column(dt, d, m) for dt, d, m in zip(layout.dtypes, datas,
                                                 vmask)]


# ---------------------------------------------------------------------------
# Dense-padded strings
# ---------------------------------------------------------------------------

def _string_cols(table: Table) -> List[Column]:
    return [c for c in table.columns if c.dtype.is_string]


def padded_variable_layout(layout: RowLayout, widths: Sequence[int]):
    """(slot starts, fe_pad, row_size) of padded rows: the fixed section
    padded to a 4-byte word (``fe_pad``), then one ``widths[si]``-byte char
    slot per string column, the row rounded up to 8 bytes."""
    fe_pad = (layout.fixed_end + 3) // 4 * 4
    starts = []
    pos = fe_pad
    for w in widths:
        if w % 4:
            raise ValueError(f"padded char width {w} not a multiple of 4")
        starts.append(pos)
        pos += w
    row_size = (pos + 7) // 8 * 8
    return tuple(starts), fe_pad, row_size


def _assemble_fixed_variable(out: torch.Tensor, table: Table,
                             layout: RowLayout, pair_offsets,
                             start: int, size: int):
    """Write rows ``[start, start + size)``'s fixed sections into ``out``
    (uint8 ``[size, >= fixed_end]``, zeros where nothing is written): each
    fixed-width column's bytes, each string column's uint32 pair (the
    string's offset in the row, its length) and the validity bytes.
    ``pair_offsets[si]`` is string column ``si``'s offset: its char slot's
    start in a padded row, or int32 ``[size]``, one a row, in a compact
    one."""
    si = 0
    for i, col in enumerate(table.columns):
        s, sz = layout.col_starts[i], layout.col_sizes[i]
        # every field is aligned to its size in the row and the row size is
        # a multiple of 8, so each field is one element of a typed view
        if col.dtype.is_string:
            pair = out[:, s:s + 8].view(torch.int32)
            pair[:, 0] = pair_offsets[si]
            pair[:, 1] = col.str_lens()[start:start + size]
            si += 1
        elif sz == 16:      # decimal128 [n, 4] limbs
            out[:, s:s + 16].view(torch.int32).copy_(
                col.data[start:start + size])
        else:
            out[:, s:s + sz].view(BITS_DTYPES[sz])[:, 0] = \
                bits_view(col.data)[start:start + size]
    vo = layout.validity_offset
    out[:, vo:vo + layout.validity_bytes] = _validity_row_bytes(
        table, layout, start, size)


def padded_rows2d(table: Table, layout: RowLayout,
                  slot_starts: Tuple[int, ...], row_size: int,
                  start: int = 0, size: Optional[int] = None
                  ) -> torch.Tensor:
    """uint8 ``[size, row_size]`` dense-padded JCUDF rows of table rows
    ``[start, start + size)``: the fixed section, then each string column's
    chars in its slot with the slack past each length zeroed, so that the
    blob does not depend on what the char matrix holds there.  Torch
    copies into one zeroed buffer, one a column."""
    if size is None:
        size = table.num_rows - start
    out = torch.zeros((size, row_size), dtype=torch.uint8,
                      device=table.device)
    _assemble_fixed_variable(out, table, layout, slot_starts, start, size)
    for s, c in zip(slot_starts, _string_cols(table)):
        w = c.chars2d.shape[1]
        if not w:
            continue
        slot = out[:, s:s + w]
        slot.copy_(c.chars2d[start:start + size])
        slot.masked_fill_(torch.arange(w, device=out.device)
                          >= c.str_lens()[start:start + size, None], 0)
    return out


def _to_rows_variable_padded(table: Table, layout: RowLayout,
                             size_limit: int) -> List[RowsColumn]:
    widths = tuple(c.chars2d.shape[1] for c in _string_cols(table))
    slot_starts, _, row_size = padded_variable_layout(layout, widths)
    # padded rows are uniform: the only bound on a batch is the int32
    # offsets' 2^31 - 1 bytes
    chunk = min(size_limit, MAX_BATCH_BYTES)
    return [RowsColumn(padded_rows2d(table, layout, slot_starts, row_size,
                                     start, size),
                       _offsets(size, row_size, table.device), row_size,
                       widths)
            for start, size in plan_equal_batches(table.num_rows, row_size,
                                                  chunk)]


def _cols_from_planes(planes: torch.Tensor, vmask: torch.Tensor,
                      layout: RowLayout):
    """Every column's data (None for strings), packed validity mask and,
    for each string column, its lengths: from decoded word planes
    ``[W, n]``, where a string slot is an (offset, length) plane pair."""
    plan = row_mxu._inverse_plan(layout)[0]
    masks = [vmask[i] for i in range(layout.num_columns)]
    datas, str_lens = [], []
    for i, dt in enumerate(layout.dtypes):
        if dt.is_string:
            datas.append(None)
            str_lens.append(planes[plan.col_word[i] + 1])  # the hi plane
        else:
            datas.append(row_mxu.extract_plane_column(planes, plan, layout,
                                                      i))
    return datas, masks, str_lens


def padded_cols_from_rows(rows2d: torch.Tensor, layout: RowLayout,
                          str_widths: Tuple[int, ...]):
    """Decode padded rows ``[n, row_size]`` into (datas, masks,
    [(chars2d, lens)]): the decode kernel over the rows' fixed section
    (row stride ``row_size``), then each char slot sliced, its slack
    zeroed (a foreign blob may carry anything past each length)."""
    slot_starts, _, _ = padded_variable_layout(layout, str_widths)
    planes, vmask = kernels.decode_planes(rows2d, layout)
    datas, masks, str_lens = _cols_from_planes(planes, vmask, layout)
    str_parts = []
    for s, w, lens in zip(slot_starts, str_widths, str_lens):
        chars = rows2d[:, s:s + w]
        keep = torch.arange(w, device=rows2d.device) < lens[:, None]
        str_parts.append((torch.where(keep, chars, 0), lens))
    return datas, masks, str_parts


def _from_rows_variable_padded(rows: RowsColumn, layout: RowLayout,
                               dev) -> Table:
    rows2d = _rows2d_on(rows, rows.row_size, dev)
    if (len(rows.str_widths) != layout.num_variable_columns
            or padded_variable_layout(layout, rows.str_widths)[2]
            != rows.row_size):
        raise ValueError(f"row size {rows.row_size} and string widths "
                         f"{rows.str_widths} are not a padded layout of "
                         f"{layout.num_variable_columns} string columns")
    datas, masks, str_parts = padded_cols_from_rows(rows2d, layout,
                                                    rows.str_widths)
    parts = iter(str_parts)
    cols = []
    for i, dt in enumerate(layout.dtypes):
        if dt.is_string:
            chars2d, lens = next(parts)
            cols.append(Column.padded_strings(chars2d, lens, masks[i]))
        else:
            cols.append(Column(dt, datas[i], masks[i]))
    return Table(tuple(cols))


# ---------------------------------------------------------------------------
# Compact rows: tables with Arrow-layout strings
# ---------------------------------------------------------------------------

def _row_sizes(table: Table, layout: RowLayout) -> torch.Tensor:
    """int64 ``[n]``: each compact row's size, ``fixed_end`` plus its
    strings' lengths, rounded up to 8 (the JAX package's
    ``_row_sizes_jit``)."""
    total = sum(c.str_lens().to(torch.int64) for c in _string_cols(table))
    a = JCUDF_ROW_ALIGNMENT
    return (layout.fixed_end + total + a - 1) // a * a


def _compact_plan(table: Table, layout: RowLayout):
    """(row sizes int64 ``[n]``, each string column's offsets int32 ``[n +
    1]``) as numpy, in one read (``staging.fetch_arrays``, as the JAX
    package fetches the two).  The read carries one more flag: whether any
    column's offsets decrease or leave its chars, which raises
    ``ValueError`` (the encode kernel reads the chars the offsets name)."""
    scols = _string_cols(table)
    sizes = _row_sizes(table, layout)
    bad = torch.zeros((), dtype=torch.bool, device=table.device)
    for c in scols:
        o = c.offsets
        bad = bad | (o[0] < 0) | (o[-1] > c.chars.shape[0]) \
            | (o[1:] < o[:-1]).any()
    fetched = staging.fetch_arrays(
        [sizes] + [c.offsets for c in scols] + [bad.view(1)])
    if fetched[-1][0]:
        raise ValueError("string offsets must be nondecreasing and inside "
                         "their chars")
    return fetched[0], fetched[1:-1]


def _compact_batch_inputs(table: Table, layout: RowLayout, start: int,
                          end: int, row_sizes: np.ndarray,
                          col_offsets: np.ndarray):
    """The compact encode kernel's arguments for table rows ``[start,
    end)`` (``kernels.compact_encode``): the fixed sections ``[size,
    fixed_end`` rounded up to 8``]`` (each string's pair holding
    ``fixed_end`` plus the lengths of the row's strings before it; typed
    views of a field need the 8-byte stride), ``fixed_end``, the batch's
    row offsets from 0, its bytes, and each string column's chars sliced
    at the batch's first char, as the JAX package's
    ``_slice_chars_batch_jit`` slices them, with its offsets of the
    batch's rows and that first char ``lo``."""
    dev = table.device
    size = end - start
    offsets = np.zeros(size + 1, np.int64)
    np.cumsum(row_sizes[start:end], out=offsets[1:])
    row_offsets = torch.from_numpy(offsets.astype(np.int32)).to(dev)
    scols = _string_cols(table)
    # each string's offset in its row: fixed_end plus the lengths of the
    # row's strings before it, a running sum over the columns
    within, acc = [], torch.full((size,), layout.fixed_end,
                                 dtype=torch.int32, device=dev)
    for c in scols:
        within.append(acc)
        acc = acc + c.str_lens()[start:end]
    a = JCUDF_ROW_ALIGNMENT
    fixed = torch.zeros((size, (layout.fixed_end + a - 1) // a * a),
                        dtype=torch.uint8, device=dev)
    _assemble_fixed_variable(fixed, table, layout, within, start, size)
    strings = []
    for c, offs in zip(scols, col_offsets):
        lo, hi = int(offs[start]), int(offs[end])
        strings.append((c.chars[lo:hi], c.offsets[start:end + 1], lo))
    return fixed, layout.fixed_end, row_offsets, int(offsets[-1]), strings


def _to_rows_variable(table: Table, layout: RowLayout,
                      size_limit: int) -> List[RowsColumn]:
    """Compact rows of a table with an Arrow-layout string column (the JAX
    package's ``_to_rows_variable``): its padded string columns go to
    Arrow, one host read plans the batches (of at most 2^31 - 1 bytes, the
    int32 offsets' reach), and each batch is one compact encode kernel
    launch."""
    table = Table(tuple(c.to_arrow() for c in table.columns))
    row_sizes, col_offsets = _compact_plan(table, layout)
    out = []
    for start, end in plan_variable_batches(
            row_sizes, min(size_limit, MAX_BATCH_BYTES)):
        args = _compact_batch_inputs(table, layout, start, end, row_sizes,
                                     col_offsets)
        out.append(RowsColumn(kernels.compact_encode(*args), args[2]))
    return out


def _compact_fixed_sections(blob: torch.Tensor, row_offsets: torch.Tensor,
                            layout: RowLayout) -> torch.Tensor:
    """uint8 ``[n, fe_pad]``: each compact row's fixed section, gathered as
    words at ``row_offsets // 4`` (the JAX package's
    ``_extract_fixed_variable_jit``), one index a row into the blob's
    sliding word windows.  A start past the blob is clamped, as the JAX
    gather clips: the rows are checked after the decode
    (:func:`_gather_plan`), before anything else reads the blob."""
    n = row_offsets.shape[0] - 1
    fw = (layout.fixed_end + 3) // 4
    if n == 0 or blob.shape[0] < 4 * fw:
        return torch.zeros((n, 4 * fw), dtype=torch.uint8,
                           device=blob.device)
    words = blob.view(torch.int32)
    starts = (row_offsets[:-1].to(torch.int64) // 4).clamp(
        0, words.shape[0] - fw)
    return words.unfold(0, fw, 1)[starts].view(torch.uint8)


def _gather_plan(blob: torch.Tensor, row_offsets: torch.Tensor,
                 layout: RowLayout, str_offs, str_lens):
    """(each string column's output offsets int32 ``[n + 1]``, from 0, and
    its char total) in one host read (the JAX package's
    ``_str_totals_jit``), which carries one reduction over the rows and
    pairs: row offsets multiples of 8 from 0 or more, each row at least
    ``fixed_end`` bytes, the last inside the blob, each pair inside its
    row.  A blob that fails raises ``ValueError`` before the string gather
    reads it: the JAX package clips such reads instead, and on the card an
    address outside the blob would fault."""
    ro = row_offsets.to(torch.int64)
    sizes = ro[1:] - ro[:-1]
    offs = torch.stack(str_offs).to(torch.int64)           # [k, n]
    lens = torch.stack(str_lens).to(torch.int64)
    bad = ((ro[0] < 0) | (ro[-1] > blob.shape[0]) | (ro % 8 != 0).any()
           | (sizes < layout.fixed_end).any() | (offs < 0).any()
           | (lens < 0).any() | (offs + lens > sizes).any())
    got = torch.cat([lens.sum(1), bad.view(1).to(torch.int64)]).tolist()
    if got[-1]:
        raise ValueError(
            "malformed compact rows: row offsets must be multiples of 8 "
            "inside the blob, each row at least fixed_end bytes, and every "
            "string's (offset, length) pair inside its row")
    zero = torch.zeros(1, dtype=torch.int32, device=blob.device)
    out_offs = [torch.cat([zero, torch.cumsum(ln, 0, dtype=torch.int32)])
                for ln in str_lens]
    return out_offs, got[:-1]


def _compact_decode(blob: torch.Tensor, row_offsets: torch.Tensor,
                    layout: RowLayout):
    """The fixed-width columns of compact rows ``blob`` (flat, 4-byte
    aligned) and the string gather kernel's arguments for its string
    columns: the fixed sections gathered as words, one decode kernel
    launch over them (row stride ``fe_pad``), each string slot's offset
    and length planes, checked against their rows in the char totals'
    host read.  Returns (datas, masks, gather arguments)."""
    fixed = _compact_fixed_sections(blob, row_offsets, layout)
    planes, vmask = kernels.decode_planes(fixed, layout)
    datas, masks, str_lens = _cols_from_planes(planes, vmask, layout)
    plan = row_mxu._inverse_plan(layout)[0]
    str_offs = [planes[plan.col_word[i]]                    # the lo plane
                for i, dt in enumerate(layout.dtypes) if dt.is_string]
    out_offs, totals = _gather_plan(blob, row_offsets, layout, str_offs,
                                    str_lens)
    pairs = list(zip(str_offs, str_lens, out_offs))
    return datas, masks, (blob, row_offsets, pairs, totals)


def _from_rows_variable(rows: RowsColumn, layout: RowLayout,
                        dev) -> Table:
    """Arrow columns of a compact batch (the JAX package's
    ``_from_rows_variable``): :func:`_compact_decode`, then one string
    gather kernel launch for every string column."""
    blob = rows.data.reshape(-1).to(dev)
    if blob.shape[0] % 4:
        raise ValueError(f"a compact blob holds whole 8-byte rows, not "
                         f"{blob.shape[0]} bytes")
    if blob.data_ptr() % 4:
        blob = blob.clone()
    datas, masks, gather = _compact_decode(blob, rows.offsets.to(dev),
                                           layout)
    chars = iter(kernels.string_gather(*gather))
    out_offs = iter(out_off for _, _, out_off in gather[2])
    cols = []
    for i, dt in enumerate(layout.dtypes):
        if dt.is_string:
            cols.append(Column.arrow_strings(next(out_offs), next(chars),
                                             masks[i]))
        else:
            cols.append(Column(dt, datas[i], masks[i]))
    return Table(tuple(cols))


def _ragged_positions(lens: np.ndarray):
    """For per-row lengths, (row index, position in the row) of every
    element of their concatenation (the JAX package's
    ``table.ragged_positions``)."""
    lens = np.asarray(lens, dtype=np.int64)
    rows = np.repeat(np.arange(len(lens), dtype=np.int64), lens)
    starts = np.cumsum(lens) - lens
    intra = np.arange(int(lens.sum()), dtype=np.int64) - \
        np.repeat(starts, lens)
    return rows, intra


def compact_rows_host(rows: RowsColumn, dtypes: Sequence[DType], *,
                      device=None) -> RowsColumn:
    """A dense-padded batch as the exact compact JCUDF wire bytes: each
    row's fixed section, then its strings' chars back to back, the pairs
    pointing at them, each row rounded up to 8 bytes.  Computed in numpy
    on the host, where the ragged form may exist; the flat blob and its
    int32 offsets go to ``device`` (default: the CUDA card).  A batch that
    is not padded comes back as it is."""
    dev = resolve_device(device)
    if not rows.is_padded:
        return rows
    layout = compute_row_layout(dtypes)
    n, rs = rows.num_rows, rows.row_size
    blob = rows.rows2d(rs).cpu().numpy().reshape(n, rs)
    slot_starts, _, _ = padded_variable_layout(layout, rows.str_widths)
    fe = layout.fixed_end
    nvar = len(slot_starts)
    lens = np.zeros((n, nvar), np.int64)
    for si, s in enumerate(layout.variable_starts):
        lens[:, si] = blob[:, s + 4:s + 8].copy().view(np.uint32)[:, 0]
    within = np.cumsum(lens, axis=1) - lens          # exclusive, per row
    row_sizes = (fe + lens.sum(axis=1) + 7) // 8 * 8
    out_offs = np.zeros(n + 1, np.int64)
    np.cumsum(row_sizes, out=out_offs[1:])
    out = np.zeros(int(out_offs[-1]), np.uint8)
    idx = out_offs[:-1, None] + np.arange(fe)[None, :]
    out[idx.reshape(-1)] = blob[:, :fe].reshape(-1)
    # the pairs' offsets, rewritten to the compact positions
    pair_vals = (fe + within).astype(np.uint32)
    for si, s in enumerate(layout.variable_starts):
        pb = pair_vals[:, si:si + 1].copy().view(np.uint8)   # [n, 4] LE
        out[(out_offs[:-1, None] + s + np.arange(4)[None, :]).reshape(-1)] \
            = pb.reshape(-1)
    for si, (s, w) in enumerate(zip(slot_starts, rows.str_widths)):
        ln = lens[:, si]
        if int(ln.max(initial=0)) > w:
            raise ValueError(
                f"string column {si} has rows longer than its padded "
                f"width {w}; refusing to emit truncated wire bytes")
        rows_r, intra = _ragged_positions(ln)
        src = rows_r * rs + s + intra
        dst = out_offs[rows_r] + fe + within[rows_r, si] + intra
        out[dst] = blob.reshape(-1)[src]
    return RowsColumn(torch.from_numpy(out).to(dev),
                      torch.from_numpy(out_offs.astype(np.int32)).to(dev))


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


def _validity_row_bytes(table: Table, layout: RowLayout, start: int = 0,
                        size: Optional[int] = None) -> torch.Tensor:
    """Validity bytes of rows ``[start, start + size)``, ``[size,
    validity_bytes]``: byte ``c // 8``, bit ``c % 8`` of column ``c``; 1 =
    valid."""
    if size is None:
        size = table.num_rows - start
    if not table.columns:
        return torch.zeros((size, 0), dtype=torch.uint8, device=table.device)
    return plane_rows._validity_byte_planes(table, layout, start, size).T


def _oracle_to_rows(table: Table, layout: RowLayout) -> torch.Tensor:
    dev = table.device
    packed = torch.cat([col_to_bytes(c.data) for c in table.columns], dim=1)
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
        data = bytes_to_col(rows2d[:, s:s + sz], dt)
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
