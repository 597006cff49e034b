"""Columnar containers for fixed-width tables, as PyTorch tensors.

The PyTorch counterpart of ``spark_rapids_jni_tpu.table`` (fixed-width part):

- A :class:`Column` holds ``data``, a 1-D tensor of the column's own torch
  dtype (64-bit columns are native ``int64``/``float64``/``uint64``
  tensors), and an optional packed ``validity`` bitmask.
- Validity is a ``uint8 [ceil(n/8)]`` LSB-first bitmask over rows: byte
  ``r // 8``, bit ``r % 8``; ``1`` means valid.  It is byte-identical to the
  JAX package's mask and to the bit order the JCUDF row format uses.
- Unsigned 16/32/64-bit columns are torch's bit-exact unsigned dtypes.  Torch
  implements few operations on them, so the port only ever creates, views,
  slices and copies them; all arithmetic runs on a same-width signed or
  ``uint8`` view.

Every entry point takes ``device``: ``None`` means the CUDA card, and there
is no silent fallback to the CPU when no card is present.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Devices
# ---------------------------------------------------------------------------

def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Raises when CUDA is asked for (explicitly or by default) and
    no card is present: the CPU runs only when the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev


# ---------------------------------------------------------------------------
# DTypes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DType:
    """Logical column type: ``kind`` names the type, ``itemsize`` is its
    fixed-width byte size (8 for a string's (offset, length) slot), and
    ``scale`` is the decimal scale (kept out of band, as cudf does)."""

    kind: str
    itemsize: int
    scale: int = 0

    @property
    def is_string(self) -> bool:
        return self.kind == "string"

    @property
    def is_fixed_width(self) -> bool:
        return not self.is_string

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(_NP_DTYPES[self.kind])

    @property
    def torch_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.kind]

    def __repr__(self) -> str:
        if self.kind.startswith("decimal"):
            return f"{self.kind}(scale={self.scale})"
        return self.kind


_NP_DTYPES = {
    "int8": np.int8, "int16": np.int16, "int32": np.int32, "int64": np.int64,
    "uint8": np.uint8, "uint16": np.uint16, "uint32": np.uint32,
    "uint64": np.uint64,
    "float32": np.float32, "float64": np.float64,
    "bool8": np.uint8,
    "date32": np.int32, "timestamp_us": np.int64,
    "decimal32": np.int32, "decimal64": np.int64,
    "string": np.uint8,
}

_TORCH_DTYPES = {
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64,
    "uint8": torch.uint8, "uint16": torch.uint16, "uint32": torch.uint32,
    "uint64": torch.uint64,
    "float32": torch.float32, "float64": torch.float64,
    "bool8": torch.uint8,
    "date32": torch.int32, "timestamp_us": torch.int64,
    "decimal32": torch.int32, "decimal64": torch.int64,
    "string": torch.uint8,
}

# by byte width, the type arithmetic, copies and comparisons run in: signed
# (uint8 for bytes), because torch implements few operations on uint16+
BITS_DTYPES = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
               8: torch.int64}

INT8 = DType("int8", 1)
INT16 = DType("int16", 2)
INT32 = DType("int32", 4)
INT64 = DType("int64", 8)
UINT8 = DType("uint8", 1)
UINT16 = DType("uint16", 2)
UINT32 = DType("uint32", 4)
UINT64 = DType("uint64", 8)
FLOAT32 = DType("float32", 4)
FLOAT64 = DType("float64", 8)
BOOL8 = DType("bool8", 1)
STRING = DType("string", 8)
DATE32 = DType("date32", 4)
TIMESTAMP64 = DType("timestamp_us", 8)


def decimal32(scale: int = 0) -> DType:
    return DType("decimal32", 4, scale)


def decimal64(scale: int = 0) -> DType:
    return DType("decimal64", 8, scale)


ALL_FIXED_WIDTH = (INT8, INT16, INT32, INT64, UINT8, UINT16, UINT32, UINT64,
                   FLOAT32, FLOAT64, BOOL8)

_BY_KIND = {d.kind: d for d in ALL_FIXED_WIDTH + (STRING, DATE32,
                                                  TIMESTAMP64)}


def dtype_from_name(name: str) -> DType:
    """Inverse of ``repr(DType)``: ``"int64"``, ``"decimal32(scale=2)"``.
    Both packages print their types the same way, so this carries a
    schema across."""
    m = re.fullmatch(r"(decimal32|decimal64)\(scale=(-?\d+)\)", name)
    if m:
        return (decimal32 if m.group(1) == "decimal32"
                else decimal64)(int(m.group(2)))
    if name not in _BY_KIND:
        raise ValueError(f"unknown column type {name!r}")
    return _BY_KIND[name]


def bits_view(data: torch.Tensor) -> torch.Tensor:
    """The same bytes as the signed integer type of the same width
    (``uint8`` for bytes): the view that comparisons and copies use."""
    return data.view(BITS_DTYPES[data.element_size()])


# ---------------------------------------------------------------------------
# Validity helpers (packed byte bitmask, LSB-first)
# ---------------------------------------------------------------------------

def pack_bools(valid: torch.Tensor) -> torch.Tensor:
    """Pack bool ``[..., n]`` into uint8 ``[..., ceil(n/8)]`` LSB-first
    bitmasks along the last axis (bits past ``n`` are zero)."""
    n = valid.shape[-1]
    nbytes = (n + 7) // 8
    v = valid.to(torch.uint8)
    pad = nbytes * 8 - n
    if pad:
        v = torch.nn.functional.pad(v, (0, pad))
    v = v.reshape(*valid.shape[:-1], nbytes, 8)
    out = v[..., 0].clone()
    for j in range(1, 8):
        out |= v[..., j] << j
    return out


def unpack_bools(mask: torch.Tensor, n: int) -> torch.Tensor:
    """Unpack uint8 LSB-first bitmasks ``[..., nbytes]`` into bool
    ``[..., n]``."""
    shifts = torch.arange(8, dtype=torch.uint8, device=mask.device)
    bits = (mask.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*mask.shape[:-1], -1)[..., :n].to(torch.bool)


# ---------------------------------------------------------------------------
# Column / Table
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Column:
    """One fixed-width column: ``data`` ``[n]`` of ``dtype.torch_dtype`` and
    an optional packed ``validity`` ``uint8 [ceil(n/8)]`` (None: all valid).
    Columns are not modified in place after construction; views of a
    decoded backing share its storage."""

    dtype: DType
    data: torch.Tensor
    validity: Optional[torch.Tensor] = None

    @staticmethod
    def from_numpy(values: np.ndarray, dtype: DType,
                   valid: Optional[np.ndarray] = None,
                   device=None) -> "Column":
        """Build a column from host values; ``valid`` is a bool array
        (None: all valid)."""
        packed = None
        if valid is not None:
            packed = np.packbits(np.asarray(valid, dtype=bool),
                                 bitorder="little")
        return Column.from_packed_numpy(values, dtype, packed, device)

    @staticmethod
    def from_packed_numpy(values: np.ndarray, dtype: DType,
                          validity: Optional[np.ndarray] = None,
                          device=None) -> "Column":
        """Build a column from host values and an already packed LSB-first
        ``uint8 [ceil(n/8)]`` validity mask (None: all valid)."""
        dev = resolve_device(device)
        vals = np.ascontiguousarray(np.asarray(values, dtype=dtype.np_dtype))
        data = torch.from_numpy(vals.view(_BITS_NP[vals.itemsize]).copy())
        data = data.to(dev).view(dtype.torch_dtype)
        if validity is not None:
            validity = np.asarray(validity, dtype=np.uint8)
            if validity.shape != ((len(vals) + 7) // 8,):
                raise ValueError(
                    f"validity holds {validity.shape} bytes for "
                    f"{len(vals)} rows")
            validity = torch.from_numpy(validity.copy()).to(dev)
        return Column(dtype, data, validity)

    @property
    def num_rows(self) -> int:
        return self.data.shape[0]

    @property
    def device(self) -> torch.device:
        return self.data.device

    def valid_bools(self) -> torch.Tensor:
        if self.validity is None:
            return torch.ones(self.num_rows, dtype=torch.bool,
                              device=self.device)
        return unpack_bools(self.validity, self.num_rows)

    def to_numpy(self) -> np.ndarray:
        """Host values in the dtype's numpy type, bit for bit."""
        return bits_view(self.data).cpu().numpy().view(self.dtype.np_dtype)

    def to(self, device) -> "Column":
        return Column(self.dtype, self.data.to(device),
                      None if self.validity is None
                      else self.validity.to(device))


_BITS_NP = {1: np.uint8, 2: np.int16, 4: np.int32, 8: np.int64}


@dataclasses.dataclass
class Table:
    """An ordered set of equal-length columns."""

    columns: tuple

    def __post_init__(self):
        self.columns = tuple(self.columns)

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    @property
    def num_rows(self) -> int:
        return self.columns[0].num_rows if self.columns else 0

    @property
    def dtypes(self) -> tuple:
        return tuple(c.dtype for c in self.columns)

    @property
    def device(self) -> torch.device:
        return self.columns[0].device

    def column(self, i: int) -> Column:
        return self.columns[i]

    def to(self, device) -> "Table":
        return Table(tuple(c.to(device) for c in self.columns))

    def to_numpy(self) -> list:
        """Host values of every column (see :meth:`Column.to_numpy`)."""
        return [c.to_numpy() for c in self.columns]

    @staticmethod
    def from_numpy(arrays: Sequence[np.ndarray], dtypes: Sequence[DType],
                   valids: Optional[Sequence] = None, device=None) -> "Table":
        """Build a table from host numpy columns; ``valids`` holds one bool
        array per column (None: all valid)."""
        valids = list(valids) if valids is not None else [None] * len(arrays)
        return Table(tuple(Column.from_numpy(a, dt, v, device)
                           for a, dt, v in zip(arrays, dtypes, valids)))


def slice_table(table: Table, start: int, end: int) -> Table:
    """Row-slice a table; validity masks are re-packed from ``start``."""
    cols = []
    for c in table.columns:
        validity = None
        if c.validity is not None:
            validity = pack_bools(
                unpack_bools(c.validity, c.num_rows)[start:end])
        cols.append(Column(c.dtype, c.data[start:end], validity))
    return Table(tuple(cols))


def assert_tables_equivalent(a: Table, b: Table, *, check_nulls: bool = True):
    """Test oracle: equal types and validity, and data equal by bits (so
    NaN payloads and signed zeros count).  With ``check_nulls`` (the
    default) data under null rows is ignored, the semantics of
    ``CUDF_TEST_EXPECT_TABLES_EQUIVALENT``; without it every row must
    match."""
    if (a.num_columns, a.num_rows) != (b.num_columns, b.num_rows):
        raise AssertionError(f"shape {(a.num_columns, a.num_rows)} != "
                             f"{(b.num_columns, b.num_rows)}")
    for i, (ca, cb) in enumerate(zip(a.columns, b.columns)):
        if ca.dtype.kind != cb.dtype.kind:
            raise AssertionError(f"column {i} type {ca.dtype} != {cb.dtype}")
        dev = ca.device
        va = ca.valid_bools()
        vb = cb.valid_bools().to(dev)
        if not torch.equal(va, vb):
            raise AssertionError(f"column {i} validity")
        da = bits_view(ca.data)
        db = bits_view(cb.data).to(dev)
        if check_nulls:
            zero = torch.zeros((), dtype=da.dtype, device=dev)
            da = torch.where(va, da, zero)
            db = torch.where(vb, db, zero)
        if not torch.equal(da, db):
            raise AssertionError(f"column {i} data")
