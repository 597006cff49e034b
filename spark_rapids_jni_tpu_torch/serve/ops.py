"""Coalescable query ops: validate -> group -> mega-batch -> scatter.

The PyTorch counterpart of ``spark_rapids_jni_tpu.serve.ops``.  Each
:class:`ServeOp` adapts one query entry point to the serving loop's
continuous-batching contract:

- ``validate(kwargs)``: canonicalize a submission into host numpy arrays,
  returning ``(payload, sig, rows, nbytes)``.  ``sig`` is the static
  coalescing signature: every row count is bucketed up the
  :mod:`runtime.shapes` grid, so same-bucket requests share a group.
- ``batch(payloads, sig, kb)``: stack K same-signature payloads into padded
  ``[kb, ...]`` host arrays (``kb`` = K bucketed up the same grid; the pad
  requests are zeros).  They ship to the device as ONE blob
  (:func:`runtime.staging.stage_arrays`).
- ``kernel(sig, kb)``: a function on the staged device tensors that serves
  the whole group with one kernel launch.
- ``unbatch(host_outs, slot, payload)``: cut request ``slot``'s result out
  of the fetched outputs, unpadded back to its true rows.

Two ops are ported, the JCUDF row conversion of all-valid INT32 columns:
``rows`` (word-plane assembly, then one pack kernel launch, K4, over every
request's rows) and ``unrows`` (one unpack kernel launch, K5, then the
columns).  Their results are byte-identical to ``convert_to_rows`` and
``convert_from_rows`` of the same columns.  The ``agg`` and ``join`` ops
need the query pipeline (``ROADMAP.md`` queue 1, item 9).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.ops import plane_rows
from spark_rapids_jni_tpu_torch.ops.row_layout import compute_row_layout
from spark_rapids_jni_tpu_torch.runtime import shapes
from spark_rapids_jni_tpu_torch.table import INT32, Column, Table

__all__ = ["ServeOp", "get", "names"]


def _as_i32(name: str, v) -> np.ndarray:
    a = np.asarray(v)
    if a.ndim != 1 or a.size == 0:
        raise ValueError(f"{name} must be a non-empty 1-D array")
    if a.dtype != np.int32:
        if not np.issubdtype(a.dtype, np.integer):
            raise ValueError(f"{name} must be integer, got {a.dtype}")
        a = a.astype(np.int32)
    return np.ascontiguousarray(a)


class ServeOp:
    """Interface of one coalescable op (see module docstring)."""

    name: str = "?"

    def validate(self, kwargs: Dict[str, Any]
                 ) -> Tuple[Dict[str, Any], Tuple, int, int]:
        raise NotImplementedError

    def batch(self, payloads: Sequence[Dict[str, Any]], sig: Tuple,
              kb: int) -> List[np.ndarray]:
        raise NotImplementedError

    def kernel(self, sig: Tuple, kb: int):
        raise NotImplementedError

    def unbatch(self, host_outs: Sequence[np.ndarray], slot: int,
                payload: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# rows: JCUDF fixed-width row conversion (all-valid int32 columns)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _rows_layout(ncols: int):
    layout = compute_row_layout([INT32] * ncols)
    expect = tuple(4 * i for i in range(ncols))
    if layout.col_starts != expect:
        raise AssertionError(
            f"all-int32 layout reordered columns: {layout.col_starts}")
    return layout


def _rows_kernel(ncols: int, b: int, kb: int):
    layout = _rows_layout(ncols)

    def serve_rows(cols: torch.Tensor):         # [kb, ncols, b] int32
        flat = cols.transpose(0, 1).reshape(ncols, kb * b)
        table = Table(tuple(Column(INT32, flat[ci]) for ci in range(ncols)))
        rows = plane_rows.to_rows_fixed(table, layout)
        return (rows.view(kb, b, layout.fixed_row_size),)
    return serve_rows


class _RowsOp(ServeOp):
    """JCUDF row pack for all-valid int32 columns: the fixed-width serving
    slice of ``convert_to_rows``, byte for byte."""

    name = "rows"

    def validate(self, kwargs):
        columns = kwargs.pop("columns")
        if kwargs:
            raise ValueError(f"unknown rows arguments: {sorted(kwargs)}")
        cols = [_as_i32(f"columns[{i}]", c) for i, c in enumerate(columns)]
        if not cols:
            raise ValueError("rows needs at least one column")
        n = cols[0].shape[0]
        if any(c.shape[0] != n for c in cols):
            raise ValueError("ragged columns")
        _rows_layout(len(cols))                 # layout sanity up front
        payload = {"columns": cols, "n": n, "ncols": len(cols)}
        sig = (len(cols), shapes.bucket_rows(n))
        return payload, sig, n, sum(c.nbytes for c in cols)

    def batch(self, payloads, sig, kb):
        ncols, b = sig
        out = np.zeros((kb, ncols, b), np.int32)
        for i, p in enumerate(payloads):
            for ci, c in enumerate(p["columns"]):
                out[i, ci, :p["n"]] = c
        return [out]

    def kernel(self, sig, kb):
        return _rows_kernel(sig[0], sig[1], kb)

    def unbatch(self, host_outs, slot, payload):
        (rows,) = host_outs
        n = payload["n"]
        rs = rows.shape[-1]
        return {"rows": np.ascontiguousarray(rows[slot][:n]).reshape(-1),
                "row_size": rs, "num_rows": n}


# ---------------------------------------------------------------------------
# unrows: JCUDF fixed-width row decode (all-valid int32 columns)
# ---------------------------------------------------------------------------

def _unrows_kernel(ncols: int, b: int, kb: int):
    layout = _rows_layout(ncols)

    def serve_unrows(rows: torch.Tensor):       # [kb, b, rs] uint8
        flat = rows.view(kb * b, layout.fixed_row_size)
        cols = plane_rows.from_rows_fixed(flat, layout)
        data = torch.stack([c.data for c in cols])      # [ncols, kb * b]
        return (data.view(ncols, kb, b).transpose(0, 1).contiguous(),)
    return serve_unrows


class _UnrowsOp(ServeOp):
    """JCUDF row unpack for all-valid int32 columns: the decode twin of
    :class:`_RowsOp`, sharing its layout."""

    name = "unrows"

    def validate(self, kwargs):
        rows = np.asarray(kwargs.pop("rows"))
        ncols = int(kwargs.pop("ncols"))
        if kwargs:
            raise ValueError(f"unknown unrows arguments: {sorted(kwargs)}")
        if rows.dtype != np.uint8:
            raise ValueError(f"rows must be uint8 bytes, got {rows.dtype}")
        rs = _rows_layout(ncols).fixed_row_size
        if rows.ndim == 1:
            if rows.size == 0 or rows.size % rs:
                raise ValueError(
                    f"rows blob of {rows.size} bytes is not a whole "
                    f"number of {rs}-byte rows")
            rows = rows.reshape(-1, rs)
        elif rows.ndim != 2 or rows.shape[1] != rs:
            raise ValueError(
                f"rows must be [n, {rs}] or a flat blob, got {rows.shape}")
        n = rows.shape[0]
        if n == 0:
            raise ValueError("unrows needs at least one row")
        payload = {"rows": np.ascontiguousarray(rows), "n": n,
                   "ncols": ncols}
        sig = (ncols, shapes.bucket_rows(n))
        return payload, sig, n, rows.nbytes

    def batch(self, payloads, sig, kb):
        ncols, b = sig
        rs = _rows_layout(ncols).fixed_row_size
        out = np.zeros((kb, b, rs), np.uint8)
        for i, p in enumerate(payloads):
            out[i, :p["n"]] = p["rows"]
        return [out]

    def kernel(self, sig, kb):
        return _unrows_kernel(sig[0], sig[1], kb)

    def unbatch(self, host_outs, slot, payload):
        (cols,) = host_outs
        n = payload["n"]
        return {"columns": [np.asarray(cols[slot, ci, :n])
                            for ci in range(payload["ncols"])],
                "num_rows": n}


_OPS: Dict[str, ServeOp] = {op.name: op for op in (_RowsOp(), _UnrowsOp())}
# ops of the JAX package that need its query pipeline
_WAITING = ("agg", "join")


def get(name: str) -> ServeOp:
    if name in _WAITING:
        raise NotImplementedError(
            f"the serve op {name!r} needs the query pipeline "
            f"(models/pipeline.py), which waits for ROADMAP.md queue 1, "
            f"item 9")
    try:
        return _OPS[name]
    except KeyError:
        raise ValueError(
            f"unknown serve op {name!r}; available: {sorted(_OPS)}")


def names() -> List[str]:
    return sorted(_OPS)
