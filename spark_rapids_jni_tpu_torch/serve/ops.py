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
  the whole group in one call (one kernel launch for ``rows`` and
  ``unrows``).
- ``unbatch(host_outs, slot, payload)``: cut request ``slot``'s result out
  of the fetched outputs, unpadded back to its true rows.

The ops: ``agg``, group-by-sum of int32 keys and values
(:func:`models.pipeline.hash_aggregate_sum` over each request's rows padded
to its bucket, the pad rows dead); ``join``, the unique-key equi-join
(:func:`models.pipeline.sort_merge_join_live`, the padded build rows dead);
and the JCUDF row conversion of all-valid INT32 columns, ``rows``
(word-plane assembly, then one pack kernel launch, K4, over every request's
rows) and ``unrows`` (one unpack kernel launch, K5, then the columns).  The
``agg`` and ``join`` kernels run request by request over the group's staged
tensors, in torch ops (the JAX package ``vmap``s them into one program).
Every result equals the direct call on the request's padded inputs:
``agg`` and ``join`` are integer-exact, so padding cannot change a value,
and ``rows``/``unrows`` are byte-identical to ``convert_to_rows`` and
``convert_from_rows`` of the same columns.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.models import pipeline
from spark_rapids_jni_tpu_torch.ops import plane_rows
from spark_rapids_jni_tpu_torch.ops.row_layout import compute_row_layout
from spark_rapids_jni_tpu_torch.runtime import shapes
from spark_rapids_jni_tpu_torch.table import INT32, Column, Table

__all__ = ["ServeOp", "get", "names", "DEFAULT_MAX_GROUPS"]

DEFAULT_MAX_GROUPS = pipeline.MAX_GROUPS


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


def _stack_pad(arrs: Sequence[np.ndarray], kb: int, width: int,
               dtype) -> np.ndarray:
    """``[kb, width]``: row i is ``arrs[i]`` zero-padded; rows past
    ``len(arrs)`` are all-zero pad requests."""
    out = np.zeros((kb, width), dtype)
    for i, a in enumerate(arrs):
        out[i, :a.shape[0]] = a
    return out


def _prefix_mask(counts: Sequence[int], kb: int, width: int) -> np.ndarray:
    """``[kb, width]`` bool: the first ``counts[i]`` entries of row i."""
    out = np.zeros((kb, width), np.bool_)
    for i, c in enumerate(counts):
        out[i, :c] = True
    return out


# ---------------------------------------------------------------------------
# agg: group-by-sum (models.pipeline.hash_aggregate_sum)
# ---------------------------------------------------------------------------

def _agg_kernel(max_groups: int):
    def serve_agg(keys, values, mask):       # [kb, b] each
        outs = [pipeline.hash_aggregate_sum(k, v, m, max_groups)
                for k, v, m in zip(keys, values, mask)]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]),
                torch.stack([o[2] for o in outs]),
                torch.stack([o[3] for o in outs]))
    return serve_agg


class _AggOp(ServeOp):
    name = "agg"

    def validate(self, kwargs):
        keys = _as_i32("keys", kwargs.pop("keys"))
        values = _as_i32("values", kwargs.pop("values"))
        max_groups = int(kwargs.pop("max_groups", DEFAULT_MAX_GROUPS))
        if kwargs:
            raise ValueError(f"unknown agg arguments: {sorted(kwargs)}")
        if values.shape != keys.shape:
            raise ValueError("keys/values length mismatch")
        if max_groups < 1:
            raise ValueError(f"max_groups must be positive, got {max_groups}")
        n = keys.shape[0]
        payload = {"keys": keys, "values": values, "n": n,
                   "max_groups": max_groups}
        sig = (shapes.bucket_rows(n), max_groups)
        return payload, sig, n, keys.nbytes + values.nbytes

    def batch(self, payloads, sig, kb):
        b = sig[0]
        return [_stack_pad([p["keys"] for p in payloads], kb, b, np.int32),
                _stack_pad([p["values"] for p in payloads], kb, b, np.int32),
                _prefix_mask([p["n"] for p in payloads], kb, b)]

    def kernel(self, sig, kb):
        return _agg_kernel(sig[1])

    def unbatch(self, host_outs, slot, payload):
        gkeys, sums, have, num_groups = host_outs
        return {"group_keys": np.array(gkeys[slot]),
                "sums": np.array(sums[slot]),
                "have": np.array(have[slot]),
                "num_groups": int(num_groups[slot])}


# ---------------------------------------------------------------------------
# join: unique-key equi-join (models.pipeline.sort_merge_join_live)
# ---------------------------------------------------------------------------

def _join_kernel(build_keys, build_payload, build_live, probe_keys):
    outs = [pipeline.sort_merge_join_live(bk, bp, bl, pk)
            for bk, bp, bl, pk in zip(build_keys, build_payload, build_live,
                                      probe_keys)]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


class _JoinOp(ServeOp):
    name = "join"

    def validate(self, kwargs):
        bk = _as_i32("build_keys", kwargs.pop("build_keys"))
        bp = _as_i32("build_payload", kwargs.pop("build_payload"))
        pk = _as_i32("probe_keys", kwargs.pop("probe_keys"))
        if kwargs:
            raise ValueError(f"unknown join arguments: {sorted(kwargs)}")
        if bp.shape != bk.shape:
            raise ValueError("build_keys/build_payload length mismatch")
        m, n = bk.shape[0], pk.shape[0]
        payload = {"build_keys": bk, "build_payload": bp,
                   "probe_keys": pk, "m": m, "n": n}
        sig = (shapes.bucket_rows(m), shapes.bucket_rows(n))
        return payload, sig, n, bk.nbytes + bp.nbytes + pk.nbytes

    def batch(self, payloads, sig, kb):
        bm, bn = sig
        return [
            _stack_pad([p["build_keys"] for p in payloads], kb, bm,
                       np.int32),
            _stack_pad([p["build_payload"] for p in payloads], kb, bm,
                       np.int32),
            _prefix_mask([p["m"] for p in payloads], kb, bm),
            _stack_pad([p["probe_keys"] for p in payloads], kb, bn,
                       np.int32),
        ]

    def kernel(self, sig, kb):
        return _join_kernel

    def unbatch(self, host_outs, slot, payload):
        pay, matched = host_outs
        n = payload["n"]
        return {"payload": np.array(pay[slot][:n]),
                "matched": np.array(matched[slot][:n])}


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


_OPS: Dict[str, ServeOp] = {op.name: op for op in (
    _AggOp(), _JoinOp(), _RowsOp(), _UnrowsOp())}


def get(name: str) -> ServeOp:
    try:
        return _OPS[name]
    except KeyError:
        raise ValueError(
            f"unknown serve op {name!r}; available: {sorted(_OPS)}")


def names() -> List[str]:
    return sorted(_OPS)
