"""Shape buckets: sizes quantized up a geometric grid, so that varying
traffic lands on a bounded set of shapes, and the helpers that pad a table
up to its bucket and slice a result back.

The PyTorch counterpart of ``spark_rapids_jni_tpu.runtime.shapes`` (the
grid :81-146, the pad and unpad helpers :149-286).  The port compiles
nothing per shape, but the serve scheduler's coalescing signatures and slot
counts, the staging blobs' lengths and the row counts the ``bucket="auto"``
entry points launch over (``ops.row_kernels``) come from this grid, so it
is the same grid, read from the same ``SRJ_TPU_SHAPE_BUCKETS`` variable:
pow-2 from :data:`MIN_ROWS` by default.

- :func:`resolve` turns an entry point's ``bucket`` argument (None or
  ``"auto"``) into a factor.  The port always runs eagerly, so ``"auto"``
  is the variable's factor (the JAX package resolves it to None inside a
  jit trace).  Eager code compiles nothing per shape, so in the port the
  pad only costs time.
- :func:`pad_table` / :func:`pad_column` pad the row axis with rows that
  are **invalid**: the padded validity mask is the contract, and it is
  always materialised, also for a column without a mask or a table already
  at its bucket.  :func:`pad_mask` pads a row mask with dead rows.
  :func:`unpad_column`, :func:`unpad_array` and :func:`unpad_result`
  slice results back to the true row count.

Left out: ``note`` and the ``pad_span``/``unpad_span`` spans, which stamp
the padding on the obs spans (``ROADMAP.md`` queue 1, item 13);
``vmem_tile``, a TPU VMEM budget; and, until the hashing and
``get_json_object`` entry points take ``bucket=``, numeric factors and
``pad_column``'s ``width``.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch

from spark_rapids_jni_tpu_torch.table import Column, Table, resolve_device

# smallest row bucket: keeps packed-validity byte counts whole for every
# bucket
MIN_ROWS = 8
# smallest non-zero width bucket; widths stay multiples of 4 so char slots
# keep their uint32-word alignment
MIN_WIDTH = 4

_ENV = "SRJ_TPU_SHAPE_BUCKETS"


def factor() -> Optional[float]:
    """The process-wide geometric bucket factor from
    ``SRJ_TPU_SHAPE_BUCKETS`` (default 2.0 = pow-2 grid), or ``None`` when
    the variable disables bucketing (``0``, ``1``, ``off``, ``none``, or any
    factor <= 1)."""
    raw = os.environ.get(_ENV, "").strip().lower()
    if raw in ("", "auto"):
        return 2.0
    if raw in ("off", "none", "no", "false"):
        return None
    try:
        f = float(raw)
    except ValueError:
        return 2.0
    return f if f > 1.0 else None


def resolve(bucket) -> Optional[float]:
    """An entry point's ``bucket`` argument as a geometric factor, or None
    for no bucketing: ``None`` -> None, ``"auto"`` -> :func:`factor`.  The
    JAX package's numeric factors have no caller in the port yet."""
    if bucket is None:
        return None
    if bucket == "auto":
        return factor()
    raise ValueError(f"bucket must be None or 'auto', got {bucket!r}")


def bucket_rows(n: int, f: Optional[float] = None) -> int:
    """Smallest grid bucket >= ``n``.  The grid is fixed (walked up from
    :data:`MIN_ROWS` by the geometric factor) so every caller lands on the
    same boundaries regardless of its own n."""
    if f is None:
        f = factor() or 2.0
    b = MIN_ROWS
    while b < n:
        b = max(b + 1, int(math.ceil(b * f)))
    return b


def bucket_width(w: int, f: Optional[float] = None) -> int:
    """Width bucket for char windows: like :func:`bucket_rows` but on a
    multiple-of-4 grid from :data:`MIN_WIDTH`; 0 stays 0."""
    if w <= 0:
        return 0
    if f is None:
        f = factor() or 2.0
    b = MIN_WIDTH
    while b < w:
        nxt = (int(math.ceil(b * f)) + 3) // 4 * 4
        b = max(b + 4, nxt)
    return b


def split_bucket(b: int, f: Optional[float] = None) -> int:
    """The grid point a half of a bucket-``b`` batch lands on
    (``bucket_rows`` of ``b // 2``): what the serve scheduler's request-axis
    split re-buckets onto.  At :data:`MIN_ROWS` the grid bottoms out and
    ``split_bucket(b) == b``."""
    return bucket_rows(max(1, int(b) // 2), f)


# ---------------------------------------------------------------------------
# Padding up to a bucket and slicing back
# ---------------------------------------------------------------------------

def prefix_mask(n: int, b: int, device=None) -> torch.Tensor:
    """Packed validity (uint8 ``[ceil(b/8)]``, LSB-first) with rows
    ``[0, n)`` valid and ``[n, b)`` invalid."""
    buf = torch.zeros(((b + 7) // 8,), dtype=torch.uint8,
                      device=resolve_device(device))
    buf[:n // 8] = 0xFF
    if n % 8:
        buf[n // 8] = (1 << (n % 8)) - 1
    return buf


def pad_to(arr: torch.Tensor, shape) -> torch.Tensor:
    """``arr`` zero-padded up to ``shape`` (each dimension >= its own), in
    one new buffer; ``arr`` itself when it already has that shape."""
    shape = tuple(shape)
    if tuple(arr.shape) == shape:
        return arr
    out = torch.zeros(shape, dtype=arr.dtype, device=arr.device)
    out[tuple(slice(0, s) for s in arr.shape)] = arr
    return out


def pad_mask(mask: Optional[torch.Tensor], n: int, b: int,
             device=None) -> torch.Tensor:
    """Row-liveness mask padded to ``b`` rows with a False tail (padded rows
    must not form groups or match joins); ``None`` gives the prefix mask
    of ``n`` live rows."""
    if mask is None:
        return torch.arange(b, device=resolve_device(device)) < n
    return pad_to(mask, (b,))


def _pad_validity(validity: Optional[torch.Tensor], n: int, b: int,
                  device) -> torch.Tensor:
    if validity is None:
        return prefix_mask(n, b, device)
    if validity.shape[0] >= (b + 7) // 8:
        return validity
    # bits past n in the last byte are zero (pack_bools zero-pads), so a
    # zero-byte tail marks every padded row invalid
    return pad_to(validity, ((b + 7) // 8,))


def bucketable(obj) -> bool:
    """True when every column has a paddable form: fixed-width, or a
    dense-padded string column."""
    cols = obj.columns if isinstance(obj, Table) else [obj]
    return all(c.dtype.is_fixed_width or c.is_padded for c in cols)


def pad_column(col: Column, b: int) -> Column:
    """``col`` padded to ``b`` rows whose tail is invalid; the validity is
    materialised even when ``b`` is the column's row count.  A string
    column's tail rows are zero-length."""
    if not bucketable(col):
        raise ValueError("only fixed-width and dense-padded string columns "
                         "pad to a bucket")
    n = col.num_rows
    validity = _pad_validity(col.validity, n, b, col.device)
    if col.dtype.is_string:
        return Column(col.dtype, col.data, validity,
                      pad_to(col.chars2d, (b, col.chars2d.shape[1])),
                      pad_to(col.lens, (b,)))
    return Column(col.dtype, pad_to(col.data, (b,) + col.data.shape[1:]),
                  validity)


def pad_table(table: Table, b: int) -> Table:
    return Table(tuple(pad_column(c, b) for c in table.columns))


def unpad_column(col: Column, n: int) -> Column:
    """A padded result sliced back to ``n`` rows: its mask's first bytes,
    copied, the bits past ``n`` cleared, so that no tail bit survives (the
    bytes ``slice_table`` repacks, without unpacking the mask)."""
    if col.num_rows == n:
        return col
    validity = col.validity
    if validity is not None:
        validity = validity[:(n + 7) // 8].clone()
        if n % 8:
            validity[-1] &= (1 << n % 8) - 1
    if col.dtype.is_string:
        return Column(col.dtype, col.data, validity, col.chars2d[:n],
                      col.lens[:n])
    return Column(col.dtype, col.data[:n], validity)


def unpad_array(arr: torch.Tensor, n: int) -> torch.Tensor:
    """A padded result's leading ``n`` rows."""
    return arr[:n] if arr.shape[0] != n else arr


def unpad_result(out, n: int):
    """An op's result sliced back to ``n`` rows: a Column row-slices, a
    tensor slices its leading axis, a tuple recurses; anything else passes
    through."""
    if isinstance(out, tuple):
        return tuple(unpad_result(o, n) for o in out)
    if isinstance(out, Column):
        return unpad_column(out, n)
    if isinstance(out, torch.Tensor) and out.dim() >= 1:
        return unpad_array(out, n)
    return out
