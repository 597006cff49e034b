"""Columnar containers for tables, as PyTorch tensors.

The PyTorch counterpart of ``spark_rapids_jni_tpu.table`` (fixed-width,
dense-padded string and Arrow-layout string columns):

- A :class:`Column` holds ``data``, a 1-D tensor of the column's own torch
  dtype (64-bit columns are native ``int64``/``float64``/``uint64``
  tensors), and an optional packed ``validity`` bitmask.  A decimal128
  column's ``data`` is int32 ``[n, 4]``: four 32-bit limbs a value,
  little-endian, in two's complement, the JAX package's uint32 limbs bit
  for bit.
- A string column's ``data`` is an empty placeholder, as in the JAX package,
  and its strings take one of two forms.  Dense-padded: ``chars2d`` uint8
  ``[n, W]`` (``W`` a multiple of 4, zeros past each length) and int32
  ``lens [n]``.  Arrow layout (the JAX package's default,
  :meth:`Column.strings`): int32 ``offsets [n + 1]`` and flat uint8
  ``chars``, row ``r`` being ``chars[offsets[r]:offsets[r + 1]]``.  A
  sliced Arrow column keeps absolute offsets and shares its parent's
  chars, so every consumer reads from ``offsets[0]`` on.  Width-capped
  padded columns with their host tail are not ported (``ROADMAP.md``
  queue 1, item 4).
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
import math
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
    "decimal128": np.uint32,   # the limb type of [n, 4] values
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
    "decimal128": torch.int32,  # the limb type of [n, 4] values
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


def decimal128(scale: int = 0) -> DType:
    """DECIMAL(38, scale): 16-byte values as int32 ``[n, 4]`` limbs."""
    return DType("decimal128", 16, scale)


ALL_FIXED_WIDTH = (INT8, INT16, INT32, INT64, UINT8, UINT16, UINT32, UINT64,
                   FLOAT32, FLOAT64, BOOL8)

_BY_KIND = {d.kind: d for d in ALL_FIXED_WIDTH + (STRING, DATE32,
                                                  TIMESTAMP64)}
_DECIMALS = {"decimal32": decimal32, "decimal64": decimal64,
             "decimal128": decimal128}


def dtype_from_name(name: str) -> DType:
    """Inverse of ``repr(DType)``: ``"int64"``, ``"decimal32(scale=2)"``.
    Both packages print their types the same way, so this carries a
    schema across."""
    m = re.fullmatch(r"(decimal32|decimal64|decimal128)\(scale=(-?\d+)\)",
                     name)
    if m:
        return _DECIMALS[m.group(1)](int(m.group(2)))
    if name not in _BY_KIND:
        raise ValueError(f"unknown column type {name!r}")
    return _BY_KIND[name]


def bits_view(data: torch.Tensor) -> torch.Tensor:
    """The same bytes as the signed integer type of the same width
    (``uint8`` for bytes): the view that comparisons and copies use."""
    return data.view(BITS_DTYPES[data.element_size()])


def col_to_bytes(data: torch.Tensor) -> torch.Tensor:
    """A fixed-width column's data as its little-endian bytes, uint8
    ``[n, itemsize]`` (a view where the data is contiguous)."""
    per_row = data.element_size() * math.prod(data.shape[1:])
    return bits_view(data).contiguous().view(torch.uint8) \
        .view(data.shape[0], per_row)


def bytes_to_col(b: torch.Tensor, dt: "DType") -> torch.Tensor:
    """Inverse of :func:`col_to_bytes`: uint8 ``[n, itemsize]`` to the
    data of a ``dt`` column (int32 ``[n, 4]`` limbs for decimal128)."""
    b = b.contiguous()
    if dt.itemsize == 16:
        return b.view(torch.int32)
    return b.view(BITS_DTYPES[dt.itemsize]).view(b.shape[0]) \
        .view(dt.torch_dtype)


def bytes2d_to_words(b: torch.Tensor) -> torch.Tensor:
    """uint8 ``[n, W]`` (``W % 4 == 0``) -> int32 ``[n, W // 4]``
    little-endian words: the bits of the JAX package's uint32 words (torch
    has few ``uint32`` operations, so words travel as ``int32``)."""
    if b.shape[1] % 4:
        raise ValueError(f"byte width {b.shape[1]} is not a multiple of 4")
    if b.shape[1] == 0:
        return torch.zeros((b.shape[0], 0), dtype=torch.int32,
                           device=b.device)
    return b.contiguous().view(torch.int32)


def _padded_width(max_len: int, pad_to: Optional[int]) -> int:
    """Padded char-matrix width: caller override or max length, rounded up
    to a multiple of 4 so char slots stay 4-byte word aligned."""
    W = max(max_len, 0) if pad_to is None else int(pad_to)
    if W < max_len:
        raise ValueError(f"pad_to={W} < longest string {max_len}")
    return (W + 3) // 4 * 4


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
    # a contiguous copy whatever the input's strides: the kernels take
    # contiguous masks only
    out = v[..., 0].clone(memory_format=torch.contiguous_format)
    for j in range(1, 8):
        out |= v[..., j] << j
    return out


def unpack_bools(mask: torch.Tensor, n: int) -> torch.Tensor:
    """Unpack uint8 LSB-first bitmasks ``[..., nbytes]`` into bool
    ``[..., n]``."""
    shifts = torch.arange(8, dtype=torch.uint8, device=mask.device)
    bits = (mask.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*mask.shape[:-1], -1)[..., :n].to(torch.bool)


def valid_bits(columns: Sequence["Column"], start: int,
               size: int) -> torch.Tensor:
    """uint8 ``[len(columns), size]``: each column's validity of rows
    ``[start, start + size)`` as 0/1 (1 for a column without a mask),
    unpacking only the mask bytes that hold those rows, for all columns
    at once."""
    dev = columns[0].device
    b0, b1 = start >> 3, (start + size + 7) >> 3
    full = torch.full((b1 - b0,), 255, dtype=torch.uint8, device=dev)
    masks = torch.stack([full if c.validity is None else c.validity[b0:b1]
                         for c in columns])
    lo = start - 8 * b0
    return unpack_bools(masks, 8 * (b1 - b0))[:, lo:lo + size] \
        .to(torch.uint8)


# ---------------------------------------------------------------------------
# Column / Table
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Column:
    """One column and an optional packed ``validity`` ``uint8 [ceil(n/8)]``
    (None: all valid).  Fixed width: ``data`` ``[n]`` of
    ``dtype.torch_dtype`` (int32 ``[n, 4]`` limbs for decimal128).
    String, with ``data`` an empty placeholder: dense-padded, ``chars2d``
    uint8 ``[n, W]`` (``W % 4 == 0``, zeros past each length) and int32
    ``lens [n]``; or Arrow layout, int32 ``offsets [n + 1]`` (absolute
    into ``chars``, nondecreasing) and flat uint8 ``chars``.  Columns are
    not modified in place after construction; views of a decoded backing
    share its storage."""

    dtype: DType
    data: torch.Tensor
    validity: Optional[torch.Tensor] = None
    chars2d: Optional[torch.Tensor] = None
    lens: Optional[torch.Tensor] = None
    offsets: Optional[torch.Tensor] = None
    chars: Optional[torch.Tensor] = None

    @staticmethod
    def from_numpy(values: np.ndarray, dtype: DType,
                   valid: Optional[np.ndarray] = None,
                   device=None) -> "Column":
        """Build a column from host values (uint32 ``[n, 4]`` limbs for
        decimal128); ``valid`` is a bool array (None: all valid)."""
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

    @staticmethod
    def padded_strings(chars2d: torch.Tensor, lens: torch.Tensor,
                       validity: Optional[torch.Tensor] = None) -> "Column":
        """A dense-padded string column from tensors on one device:
        ``chars2d`` uint8 ``[n, W]`` (``W % 4 == 0``, zeros past each
        length), int32 ``lens [n]`` with every length in ``[0, W]``, and
        packed ``validity`` or None.  Shapes and types are checked here;
        the lengths are checked by the consumers that read the chars."""
        n = lens.shape[0] if lens.dim() == 1 else -1
        if (chars2d.dtype != torch.uint8 or chars2d.dim() != 2
                or chars2d.shape[1] % 4 or lens.dtype != torch.int32
                or chars2d.shape[0] != n):
            raise ValueError(
                f"padded strings need uint8 chars2d [n, W % 4 == 0] and "
                f"int32 lens [n], got {chars2d.dtype} "
                f"{tuple(chars2d.shape)} and {lens.dtype} "
                f"{tuple(lens.shape)}")
        if validity is not None and tuple(validity.shape) != ((n + 7) // 8,):
            raise ValueError(f"validity holds {tuple(validity.shape)} bytes "
                             f"for {n} rows")
        return Column(STRING, torch.empty(0, dtype=torch.uint8,
                                          device=chars2d.device),
                      validity, chars2d, lens)

    @staticmethod
    def strings_padded(values: Sequence[Optional[str]],
                       pad_to: Optional[int] = None,
                       device=None) -> "Column":
        """A dense-padded string column from Python strings (None: null),
        UTF-8 encoded; ``W`` is ``pad_to`` or the longest string, rounded
        up to a multiple of 4."""
        dev = resolve_device(device)
        enc = [b"" if s is None else s.encode("utf-8") for s in values]
        lens = np.fromiter(map(len, enc), dtype=np.int32, count=len(enc))
        W = _padded_width(int(lens.max()) if len(lens) else 0, pad_to)
        mat = np.zeros((len(enc), W), np.uint8)
        for i, b in enumerate(enc):
            mat[i, :len(b)] = np.frombuffer(b, np.uint8)
        validity = None
        if any(s is None for s in values):
            validity = torch.from_numpy(np.packbits(
                np.array([s is not None for s in values], bool),
                bitorder="little")).to(dev)
        return Column.padded_strings(torch.from_numpy(mat).to(dev),
                                     torch.from_numpy(lens).to(dev),
                                     validity)

    @staticmethod
    def arrow_strings(offsets: torch.Tensor, chars: torch.Tensor,
                      validity: Optional[torch.Tensor] = None) -> "Column":
        """An Arrow-layout string column from tensors on one device: int32
        ``offsets [n + 1]`` into uint8 ``chars`` and packed ``validity`` or
        None.  Shapes and types are checked here; the offsets are checked
        by the consumers that read the chars."""
        if (offsets.dtype != torch.int32 or offsets.dim() != 1
                or offsets.shape[0] < 1 or chars.dtype != torch.uint8
                or chars.dim() != 1):
            raise ValueError(
                f"Arrow strings need int32 offsets [n + 1] and flat uint8 "
                f"chars, got {offsets.dtype} {tuple(offsets.shape)} and "
                f"{chars.dtype} {tuple(chars.shape)}")
        n = offsets.shape[0] - 1
        if validity is not None and tuple(validity.shape) != ((n + 7) // 8,):
            raise ValueError(f"validity holds {tuple(validity.shape)} bytes "
                             f"for {n} rows")
        return Column(STRING, torch.empty(0, dtype=torch.uint8,
                                          device=chars.device),
                      validity, offsets=offsets, chars=chars)

    @staticmethod
    def strings(values: Sequence[Optional[str]], device=None) -> "Column":
        """An Arrow-layout string column from Python strings (None: null),
        UTF-8 encoded: the JAX package's ``Column.strings``."""
        dev = resolve_device(device)
        vals = ["" if s is None else s for s in values]
        enc = [s.encode("utf-8") for s in vals]
        chars = np.frombuffer(b"".join(enc), dtype=np.uint8)
        offsets = np.zeros(len(enc) + 1, dtype=np.int32)
        np.cumsum(np.fromiter(map(len, enc), dtype=np.int64,
                              count=len(enc)), out=offsets[1:])
        validity = None
        if any(s is None for s in values):
            validity = torch.from_numpy(np.packbits(
                np.array([s is not None for s in values], bool),
                bitorder="little")).to(dev)
        return Column.arrow_strings(torch.from_numpy(offsets).to(dev),
                                    torch.from_numpy(chars.copy()).to(dev),
                                    validity)

    @property
    def num_rows(self) -> int:
        if self.dtype.is_string:
            if self.is_padded:
                return self.lens.shape[0]
            return self.offsets.shape[0] - 1
        return self.data.shape[0]

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def is_padded(self) -> bool:
        """True for dense-padded string columns (``chars2d`` present)."""
        return self.chars2d is not None

    def valid_bools(self) -> torch.Tensor:
        if self.validity is None:
            return torch.ones(self.num_rows, dtype=torch.bool,
                              device=self.device)
        return unpack_bools(self.validity, self.num_rows)

    def str_lens(self) -> torch.Tensor:
        """Per-row string byte lengths, int32 ``[n]``."""
        if self.is_padded:
            return self.lens
        return self.offsets[1:] - self.offsets[:-1]

    def chars_window(self, W: int) -> torch.Tensor:
        """Padded byte window uint8 ``[n, W]`` (zero past the lengths): a
        slice of ``chars2d`` or a zero-padded copy; for an Arrow column, a
        gather of each row's ``W`` bytes from its offset (one index a row,
        into the chars' sliding windows), zeroed past its length."""
        if self.is_padded:
            have = self.chars2d.shape[1]
            if have >= W:
                return self.chars2d[:, :W]
            return torch.nn.functional.pad(self.chars2d, (0, W - have))
        return chars_window_at(self.chars, self.offsets[:-1],
                               self.str_lens(), W)

    def _padded_view(self, W: int) -> "Column":
        """The column as dense-padded strings of width ``W`` (a multiple of
        4; not checked against the lengths)."""
        return Column.padded_strings(self.chars_window(W),
                                     self.str_lens().contiguous(),
                                     self.validity)

    def to_padded(self, pad_to: Optional[int] = None,
                  width_cap=None) -> "Column":
        """Arrow -> dense-padded, as torch ops on the column's device (the
        JAX package's ``to_padded`` runs on the host; the result is the
        same): ``W`` is ``pad_to`` or the longest string, rounded up to a
        multiple of 4.  A padded or fixed-width column comes back as it is.
        ``width_cap`` raises ``NotImplementedError``: width-capped columns
        and their host tails are not ported (``ROADMAP.md`` queue 1, item
        4)."""
        if width_cap is not None:
            raise NotImplementedError(
                "width-capped string columns (width_cap=) are not ported "
                "yet: ROADMAP.md queue 1, item 4")
        if not self.dtype.is_string or self.is_padded:
            return self
        longest = int(self.str_lens().max()) if self.num_rows else 0
        return self._padded_view(_padded_width(longest, pad_to))

    def to_arrow(self) -> "Column":
        """Dense-padded -> Arrow, as torch ops on the column's device: the
        offsets are the lengths' running sum from 0 and the chars each
        row's bytes up to its length.  Lengths outside ``[0, W]`` raise
        ``ValueError`` (a width-capped column's bytes past ``W`` would live
        in a host tail, which the port does not have: ``ROADMAP.md`` queue
        1, item 4)."""
        if not self.dtype.is_string or not self.is_padded:
            return self
        W = self.chars2d.shape[1]
        lens = self.lens
        if self.num_rows:
            lo, hi = (int(x) for x in torch.aminmax(lens))
            if lo < 0 or hi > W:
                raise ValueError(
                    f"string lengths in [{lo}, {hi}] do not fit the padded "
                    f"width {W}; refusing to emit truncated strings")
        offsets = torch.zeros(self.num_rows + 1, dtype=torch.int32,
                              device=lens.device)
        torch.cumsum(lens, 0, out=offsets[1:])
        keep = torch.arange(W, device=lens.device) < lens[:, None]
        return Column.arrow_strings(offsets,
                                    torch.masked_select(self.chars2d, keep),
                                    self.validity)

    def to_numpy(self) -> np.ndarray:
        """Host values in the dtype's numpy type, bit for bit (fixed-width
        columns; a string column's host form is its ``chars2d`` and
        ``lens``)."""
        if self.dtype.is_string:
            raise ValueError("a string column has no values array; use "
                             "chars2d and lens, or offsets and chars")
        return bits_view(self.data).cpu().numpy().view(self.dtype.np_dtype)

    def to_pylist(self) -> list:
        """Per-row host values, None for a null row: Python ints and
        floats (bool for BOOL8, the unscaled int for decimal128), strings
        decoded as UTF-8."""
        n = self.num_rows
        valid = self.valid_bools().cpu().tolist()
        if self.dtype.is_string:
            ch = self.chars_window(_string_width(self)).cpu().numpy()
            lens = self.str_lens().cpu().tolist()
            return [bytes(ch[i, :lens[i]]).decode("utf-8") if valid[i]
                    else None for i in range(n)]
        elif self.dtype.kind == "decimal128":
            vals = []
            for row in self.to_numpy().astype(np.uint64).tolist():
                two = sum(int(x) << (32 * k) for k, x in enumerate(row))
                vals.append(two - (1 << 128) if two >> 127 else two)
        elif self.dtype.kind == "bool8":
            vals = [bool(v) for v in self.to_numpy().tolist()]
        else:
            vals = self.to_numpy().tolist()
        return [v if ok else None for v, ok in zip(vals, valid)]

    def to(self, device) -> "Column":
        def move(t):
            return None if t is None else t.to(device)
        return Column(self.dtype, self.data.to(device), move(self.validity),
                      move(self.chars2d), move(self.lens),
                      move(self.offsets), move(self.chars))


_BITS_NP = {1: np.uint8, 2: np.int16, 4: np.int32, 8: np.int64}


def chars_window_at(chars: torch.Tensor, starts: torch.Tensor,
                    lens: torch.Tensor, W: int) -> torch.Tensor:
    """uint8 ``[n, W]``: the ``W`` bytes of flat ``chars`` from each row's
    start, zeroed past its length (one index a row, into the chars' sliding
    windows; a start past the chars reads zeros)."""
    dev = chars.device
    if W == 0:
        return torch.zeros((starts.shape[0], 0), dtype=torch.uint8,
                           device=dev)
    padded = torch.cat([chars, torch.zeros(W, dtype=torch.uint8,
                                           device=dev)])
    win = padded.unfold(0, W, 1)[starts.to(torch.int64).clamp(
        0, chars.shape[0])]
    win.masked_fill_(torch.arange(W, device=dev) >= lens[:, None], 0)
    return win


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


def _slice_strings(c: Column, validity, start: int, end: int) -> Column:
    """Rows ``[start, end)`` of a string column: views of a padded
    column's rows, or of an Arrow column's offsets (absolute, sharing the
    parent's chars, as in the JAX package)."""
    if c.is_padded:
        return Column(c.dtype, c.data, validity, c.chars2d[start:end],
                      c.lens[start:end])
    return Column(c.dtype, c.data, validity, offsets=c.offsets[start:end + 1],
                  chars=c.chars)


def slice_table(table: Table, start: int, end: int) -> Table:
    """Row-slice a table; validity masks are re-packed from ``start``.
    Arrow string columns keep absolute offsets into their parent's
    chars."""
    cols = []
    for c in table.columns:
        validity = None
        if c.validity is not None:
            validity = pack_bools(
                unpack_bools(c.validity, c.num_rows)[start:end])
        if c.dtype.is_string:
            cols.append(_slice_strings(c, validity, start, end))
        else:
            cols.append(Column(c.dtype, c.data[start:end], validity))
    return Table(tuple(cols))


def slice_table_dynamic(table: Table, start: int, size: int) -> Table:
    """Rows ``[start, start + size)`` of a table as views, no repack: the
    JAX package's ``slice_table_dynamic`` (its traced start serves every
    equal batch from one program).  ``start`` must be a multiple of 8, so
    that a packed mask slices as its bytes; the bits of the last mask byte
    past ``size`` are those of the rows after the slice."""
    if start % 8:
        raise ValueError(f"start {start} is not a multiple of 8: packed "
                         f"masks slice as bytes")
    if not 0 <= start <= start + size <= table.num_rows:
        raise ValueError(f"rows [{start}, {start + size}) outside "
                         f"{table.num_rows}")
    end = start + size
    cols = []
    for c in table.columns:
        validity = None if c.validity is None else \
            c.validity[start // 8:start // 8 + (size + 7) // 8]
        if c.dtype.is_string:
            cols.append(_slice_strings(c, validity, start, end))
        else:
            cols.append(Column(c.dtype, c.data[start:end], validity))
    return Table(tuple(cols))


def _string_bytes(c: Column, W: int) -> torch.Tensor:
    """A string column's chars in a ``[n, W]`` window, zeroed past each
    length, and its lengths as the last entry of each row."""
    ch = c.chars_window(W)
    lens = c.str_lens()
    ch = torch.where(torch.arange(W, device=ch.device) < lens[:, None],
                     ch, torch.zeros((), dtype=torch.uint8, device=ch.device))
    return torch.cat([ch.to(torch.int32), lens[:, None]], dim=1)


def _string_width(c: Column) -> int:
    """The window that holds every string of ``c``: a padded column's
    width, an Arrow column's longest length."""
    if c.is_padded:
        return c.chars2d.shape[1]
    return int(c.str_lens().max()) if c.num_rows else 0


def assert_tables_equivalent(a: Table, b: Table, *, check_nulls: bool = True):
    """Test oracle: equal types and validity, and data equal by bits (so
    NaN payloads and signed zeros count); strings equal in length and in
    their bytes up to it, whatever the padded widths or string forms (a
    padded and an Arrow column of the same strings are equal).  With
    ``check_nulls`` (the default) data under null rows is ignored, the
    semantics of ``CUDF_TEST_EXPECT_TABLES_EQUIVALENT``; without it every
    row must match."""
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
        if ca.dtype.is_string:
            W = max(_string_width(ca), _string_width(cb))
            da = _string_bytes(ca, W)
            db = _string_bytes(cb.to(dev), W)
            va, vb = va[:, None], vb[:, None]
        else:
            da = bits_view(ca.data)
            db = bits_view(cb.data).to(dev)
            if da.dim() == 2:       # decimal128 limbs
                va, vb = va[:, None], vb[:, None]
        if check_nulls:
            zero = torch.zeros((), dtype=da.dtype, device=dev)
            da = torch.where(va, da, zero)
            db = torch.where(vb, db, zero)
        if not torch.equal(da, db):
            raise AssertionError(f"column {i} data")
