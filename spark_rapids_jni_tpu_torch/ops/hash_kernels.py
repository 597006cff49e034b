"""Spark's hash and bloom-probe kernels: their wrappers and plain PyTorch
versions (the CUDA sources build in :mod:`.kernels`).

- :func:`murmur3_cols` (``csrc/murmur3.cu``) replaces the TPU kernel
  ``spark_rapids_jni_tpu/ops/pallas_kernels.py::_mm3_kernel``: Spark's
  murmur3_x86_32 chained over columns, int32 ``[n]``.
- :func:`xxhash64_cols` (``csrc/xxhash64.cu``) replaces
  ``pallas_kernels.py::_xx_kernel``: Spark's xxhash64 chained over
  columns, int64 ``[n]``.
- :func:`bloom_might_contain` (``csrc/bloom_probe.cu``) replaces
  ``pallas_kernels.py::_bloom_kernel``: Spark's ``mightContainLong``, bool
  ``[n]``.

The TPU kernels read one stacked ``[K, n]`` matrix of every column's
normalised words that an XLA pass builds first (``_hash_mats``).  The CUDA
kernels read each column where it lies: the wrapper hands over one
descriptor per column (data, type code, validity; chars, pitch and lengths
for a padded string) in the kernel's parameters, at most
:data:`MAX_HASH_COLS` of them a launch, and the kernel normalises by type
code.  A longer list chains through further launches, each starting every
row from the hash the previous launch wrote: Spark's own chain, so the bits
are those of one launch.

Two plans, computed here in Python so that the CPU tests reach them, steer
the kernels:

- K6 and K7 stage tiles of rows in a ring of shared-memory stages, filled
  while the last stage is hashed (``csrc/hash_stage.cuh``, which both
  include); :func:`_stage_plan` fixes, from a kernel's :class:`_Staging`
  and the columns' shapes, the rows a tile, the column groups (one stage
  each, in chain order), and each column's place in its stage or that it
  is read from device memory: K7 stages a string's whole tile of chars
  where it fits, K6 reads every string in place.
- K8 keeps the filter on chip where it fits: :func:`_bloom_route` picks,
  from the filter's size alone, the block route (the whole bitset in each
  block's shared memory) or the L2 route (the bitset in device memory).

A wrapper runs the plain version only for columns on the CPU; on CUDA it
launches its kernel or raises.  The plain versions follow the JAX package's
chains (``hashing._murmur3_chain``, ``_xx64_chain``,
``pallas_kernels._bloom_body``) step by step.  Torch has no uint32 or uint64
arithmetic, so they carry each 32-bit value in an int64 tensor in
``[0, 2^32)``, each 64-bit value as a ``(hi, lo)`` pair of those, multiply
in 16-bit limbs so that no product leaves int64, and shift right only
values that are not negative.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from spark_rapids_jni_tpu_torch.table import Column, bytes2d_to_words
from spark_rapids_jni_tpu_torch.ops import kernels
from spark_rapids_jni_tpu_torch.ops.kernels import _check

M32 = 0xFFFFFFFF

# csrc/hash_common.cuh's SrjHashType, by column kind
_TYPE_CODES = {
    "int8": 0, "uint8": 1, "bool8": 1, "int16": 2, "uint16": 3,
    "int32": 4, "uint32": 4, "date32": 4, "decimal32": 4, "float32": 5,
    "int64": 6, "uint64": 6, "timestamp_us": 6, "decimal64": 6,
    "float64": 7, "string": 8,
}
# the most columns one hash launch takes (csrc/hash_common.cuh's
# kMaxHashCols: their descriptors fill the kernel's 32 KB parameter space);
# a longer list takes ceil(ncols / MAX_HASH_COLS) chained launches
MAX_HASH_COLS = 800
# the kinds Spark's bloom filter casts to long (the JAX package's
# spark_bloom._DEVICE_KINDS)
BLOOM_KINDS = frozenset(
    {"int8", "int16", "int32", "int64", "date32", "timestamp_us"})


class _ColDesc(ctypes.Structure):
    """csrc/hash_common.cuh's SrjHashCol."""
    _fields_ = [("data", ctypes.c_void_p), ("valid", ctypes.c_void_p),
                ("lens", ctypes.c_void_p), ("pitch", ctypes.c_int64),
                ("type", ctypes.c_int32), ("stage", ctypes.c_int32)]


def hash_cols_eligible(cols) -> bool:
    """True when the hash kernels take these columns: at least one, each a
    fixed-width scalar of at most 8 bytes or a dense-padded string column
    (the JAX package's ``pallas_kernels.hash_cols_eligible``; the port has
    no nested or width-capped columns, and its decimal128 columns are 16
    bytes).  An Arrow-layout column is not: ``hashing`` hands it over as
    its padded window."""
    return bool(cols) and all(
        c.dtype.kind in _TYPE_CODES
        and (c.is_padded if c.dtype.is_string else c.dtype.itemsize <= 8)
        for c in cols)


def _check_cols(cols) -> int:
    """Eligibility, one row count and one device; returns the row count."""
    _check(hash_cols_eligible(cols),
           f"hash kernels take fixed-width and padded string columns, got "
           f"{[c.dtype for c in cols]}")
    n, dev = cols[0].num_rows, cols[0].device
    if any(c.num_rows != n or c.device != dev for c in cols):
        raise ValueError(f"columns of {[c.num_rows for c in cols]} rows on "
                         f"{[str(c.device) for c in cols]}")
    for c in cols:
        if c.validity is not None:
            _check(c.validity.dtype == torch.uint8 and c.validity.dim() == 1
                   and c.validity.shape[0] >= (n + 7) // 8
                   and c.validity.is_contiguous(),
                   f"validity must be contiguous uint8 [>= {(n + 7) // 8}]")
    return n


# ---------------------------------------------------------------------------
# Normalisation (hashing._as_u32_words / _col_u64_blocks), plain
# ---------------------------------------------------------------------------

_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _signed_int64(data: torch.Tensor) -> torch.Tensor:
    """The column's bits read as the signed type of its width, widened to
    int64 (sign-extended)."""
    return data.view(_SIGNED[data.element_size()]).to(torch.int64)


def _canon_float_bits(v: torch.Tensor, sign: int, exp: int, quiet: int
                      ) -> torch.Tensor:
    """-0.0 -> 0 and every NaN -> the canonical quiet NaN, on the bits."""
    mag = v & (sign - 1)
    is_nan = ((v & exp) == exp) & ((mag & ~exp) != 0)
    return torch.where(is_nan, quiet, torch.where(mag == 0, 0, v))


def _as_u32_words(col: Column) -> List[torch.Tensor]:
    """A fixed-width column's Spark-normalised little-endian 32-bit words
    (lo first), each an int64 ``[n]`` in ``[0, 2^32)``: bool8/uint8/uint16
    zero-extend, int8/int16 sign-extend, 4-byte values are their bits,
    8-byte values their (lo, hi) words, and floats map -0.0 to 0 and NaN to
    the canonical quiet NaN."""
    _check(col.dtype.is_fixed_width,
           "string columns hash as byte streams, not as words")
    v = _signed_int64(col.data)
    if col.dtype.itemsize == 8:
        if col.dtype.kind == "float64":
            v = _canon_float_bits(v, 1 << 63, 0x7FF0000000000000,
                                  0x7FF8000000000000)
        return [v & M32, (v >> 32) & M32]
    if col.dtype.kind in ("uint8", "bool8", "uint16"):
        return [v & ((1 << (8 * col.dtype.itemsize)) - 1)]
    v = v & M32
    if col.dtype.kind == "float32":
        v = _canon_float_bits(v, 1 << 31, 0x7F800000, 0x7FC00000)
    return [v]


def _col_u64_blocks(col: Column) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spark XxHash64's one 8-byte block per value, as ``(hi, lo)``: a
    one-word value's word sign-extended."""
    words = _as_u32_words(col)
    if len(words) == 1:
        lo = words[0]
        return torch.where(lo >= 1 << 31, M32, 0), lo
    return words[1], words[0]


# ---------------------------------------------------------------------------
# 32- and 64-bit arithmetic on int64 tensors (plain versions)
# ---------------------------------------------------------------------------

def _mul32_wide(x, y):
    """(hi, lo) of the 64-bit product of two 32-bit values, in 16-bit
    limbs (``hashing._mul64``'s ``mul32_wide``)."""
    xl, xh = x & 0xFFFF, x >> 16
    yl, yh = y & 0xFFFF, y >> 16
    ll, lh, hl, hh = xl * yl, xl * yh, xh * yl, xh * yh
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = (ll & 0xFFFF) | ((mid & 0xFFFF) << 16)
    return (hh + (lh >> 16) + (hl >> 16) + (mid >> 16)) & M32, lo


def _mul32(x, y):
    return _mul32_wide(x, y)[1]


def _rotl32(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def _mm3_mix_h1(h1, k1):
    k1 = _mul32(_rotl32(_mul32(k1, 0xCC9E2D51), 15), 0x1B873593)
    h1 = _rotl32(h1 ^ k1, 13)
    return (h1 * 5 + 0xE6546B64) & M32


def _mm3_fmix(h1, length):
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = _mul32(h1, 0x85EBCA6B)
    h1 = h1 ^ (h1 >> 13)
    h1 = _mul32(h1, 0xC2B2AE35)
    return h1 ^ (h1 >> 16)


def _c64(v: int):
    """A Python constant as a (hi, lo) pair."""
    v &= (1 << 64) - 1
    return v >> 32, v & M32


_XXP1 = 0x9E3779B185EBCA87
_XXP2 = 0xC2B2AE3D27D4EB4F
_XXP3 = 0x165667B19E3779F9
_XXP4 = 0x85EBCA77C2B2AE63
_XXP5 = 0x27D4EB2F165667C5


def _add64(a, b):
    lo = a[1] + b[1]
    return (a[0] + b[0] + (lo >> 32)) & M32, lo & M32


def _mul64(a, b):
    hi, lo = _mul32_wide(a[1], b[1])
    return (hi + _mul32(a[1], b[0]) + _mul32(a[0], b[1])) & M32, lo


def _xor64(a, b):
    return a[0] ^ b[0], a[1] ^ b[1]


def _rotl64(a, r: int):
    hi, lo = a
    if r >= 32:
        hi, lo, r = lo, hi, r - 32
    if r == 0:
        return hi, lo
    return (((hi << r) & M32) | (lo >> (32 - r)),
            ((lo << r) & M32) | (hi >> (32 - r)))


def _shr64(a, r: int):
    hi, lo = a
    if r >= 32:
        return hi * 0, hi >> (r - 32)
    return hi >> r, (lo >> r) | ((hi << (32 - r)) & M32)


def _where64(cond, a, b):
    return torch.where(cond, a[0], b[0]), torch.where(cond, a[1], b[1])


def _xx_round(acc, inp):
    return _mul64(_rotl64(_add64(acc, _mul64(inp, _c64(_XXP2))), 31),
                  _c64(_XXP1))


def _xx_fmix(h):
    h = _mul64(_xor64(h, _shr64(h, 33)), _c64(_XXP2))
    h = _mul64(_xor64(h, _shr64(h, 29)), _c64(_XXP3))
    return _xor64(h, _shr64(h, 32))


def _xx_stripe(h, block, r: int, p_mul: int, p_add: int):
    """``h ^= block; h = rotl(h, r) * p_mul + p_add``."""
    return _add64(_mul64(_rotl64(_xor64(h, block), r), _c64(p_mul)),
                  _c64(p_add))


# ---------------------------------------------------------------------------
# String columns (hashing._mm3_string_col / _xx64_string_col), plain
# ---------------------------------------------------------------------------

def _string_window(col: Column, align: int):
    """(int32 words ``[n, Wp // 4]`` of the chars window widened to a
    multiple of ``align``, uint8 window ``[n, Wp]``, int64 lengths clamped
    to ``[0, W]`` as the kernels clamp them)."""
    W = col.chars2d.shape[1]
    b = col.chars_window((W + align - 1) // align * align)
    return (bytes2d_to_words(b), b,
            col.lens.to(torch.int64).clamp(0, W))


def _gather_col(m: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``m[i, idx[i]]`` (``idx`` clamped into the row), as int64."""
    idx = idx.clamp(0, m.shape[1] - 1)
    return torch.gather(m, 1, idx[:, None])[:, 0].to(torch.int64)


def _mm3_string(col: Column, h: torch.Tensor) -> torch.Tensor:
    words, _, lens = _string_window(col, 4)
    nblocks = lens >> 2
    if words.shape[1]:
        for j in range(words.shape[1]):
            k1 = words[:, j].to(torch.int64) & M32
            h = torch.where(j < nblocks, _mm3_mix_h1(h, k1), h)
        tail = _gather_col(words, nblocks) & M32
        for t in range(3):
            byte = (tail >> (8 * t)) & 0xFF
            # Java's getByte sign-extends
            k1 = torch.where(byte >= 0x80, byte | 0xFFFFFF00, byte)
            h = torch.where(4 * nblocks + t < lens, _mm3_mix_h1(h, k1), h)
    return _mm3_fmix(h, lens)


def _xx_string(col: Column, h):
    words, b, lens = _string_window(col, 8)
    zeros = lens * 0

    def w64(j):
        return (words[:, 2 * j + 1].to(torch.int64) & M32,
                words[:, 2 * j].to(torch.int64) & M32)

    nchunks = lens >> 5
    if words.shape[1] >= 8:
        v = [_add64(h, _c64(_XXP1 + _XXP2)), _add64(h, _c64(_XXP2)), h,
             _add64(h, _c64(-_XXP1))]
        for g in range(words.shape[1] // 8):
            for i in range(4):
                v[i] = _where64(g < nchunks, _xx_round(v[i], w64(4 * g + i)),
                                v[i])
        big = _add64(_add64(_rotl64(v[0], 1), _rotl64(v[1], 7)),
                     _add64(_rotl64(v[2], 12), _rotl64(v[3], 18)))
        for vi in v:
            big = _add64(_mul64(_xor64(big, _xx_round((zeros, zeros), vi)),
                                _c64(_XXP1)), _c64(_XXP4))
        hash_ = _where64(lens >= 32, big, _add64(h, _c64(_XXP5)))
    else:
        hash_ = _add64(h, _c64(_XXP5))
    hash_ = _add64(hash_, (zeros, lens))
    nlongs = lens >> 3
    for j in range(words.shape[1] // 2):
        active = (j >= 4 * nchunks) & (j < nlongs)
        upd = _xx_stripe(hash_, _xx_round((zeros, zeros), w64(j)), 27,
                         _XXP1, _XXP4)
        hash_ = _where64(active, upd, hash_)
    if words.shape[1]:
        has4 = (lens & 7) >= 4
        w32 = _gather_col(words, 2 * nlongs) & M32
        upd = _xx_stripe(hash_, _mul64((zeros, w32), _c64(_XXP1)), 23,
                         _XXP2, _XXP3)
        hash_ = _where64(has4, upd, hash_)
        tail_start = 8 * nlongs + 4 * has4.to(torch.int64)
        for t in range(3):
            byte = _gather_col(b, tail_start + t)
            upd = _mul64(_rotl64(_xor64(hash_, _mul64((zeros, byte),
                                                      _c64(_XXP5))), 11),
                         _c64(_XXP1))
            hash_ = _where64(tail_start + t < lens, upd, hash_)
    return _xx_fmix(hash_)


# ---------------------------------------------------------------------------
# The staging plan of K6 and K7 (csrc/hash_stage.cuh)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Staging:
    """How a hash kernel stages its tiles: (rows a tile, rows a consumer
    thread) for a chain of fixed-width columns and for one with a string
    column, and whether it stages a string's whole tile of chars (the
    producer bulk-copies its rows x pitch bytes) where the string fits a
    stage, or reads every string in place.  A tile's rows are a multiple of
    128, so that its mask bytes and values come in 16-byte multiples."""
    fixed: Tuple[int, int]
    strings: Tuple[int, int]
    stage_strings: bool


# each kernel's staging: one row a thread (more threads) over a chain with
# a string, whose byte loop diverges.  K6 reads strings in place: on the
# card that beat staging them whole and fetching only the 16-byte chunks
# under each row's length (PERF.md).
_STAGING = {
    "murmur3_cols": _Staging(fixed=(1024, 2), strings=(256, 1),
                             stage_strings=False),
    "xxhash64_cols": _Staging(fixed=(1024, 2), strings=(256, 1),
                              stage_strings=True),
}
# the stages of a block's ring (hash_stage.cuh's kStages) and the most bytes
# a group's stage holds
_STAGES = 3
_STAGE_BUDGET = 32 << 10
# SrjHashCol::stage: set where a column starts a group; below it the
# column's offset in its stage in 16-byte units plus one (0: not staged)
_GROUP_START = 1 << 24


def _region(nbytes: int) -> int:
    """The room of a staged part of ``nbytes`` bytes: whole 16-byte chunks
    and one more, since a bulk copy moves the aligned chunks that hold the
    part, which may start inside its first chunk."""
    return -(-nbytes // 16) * 16 + 16


def _stage_regions(col: Column, rows: int) -> Dict[str, Tuple[int, int]]:
    """(offset, room) of each part of a column's staged block for a tile
    of ``rows`` rows: ``values`` (fixed width) or ``lens`` and ``chars`` (a
    string; no chars at a zero width), then ``mask`` where the column has
    one.  ``csrc/hash_stage.cuh`` lays the block out the same way
    (``stage_chars_off``, ``stage_mask_off``)."""
    if col.dtype.is_string:
        parts = [("lens", 4 * rows)]
        if _string_pitch(col):
            parts.append(("chars", rows * _string_pitch(col)))
    else:
        parts = [("values", rows * col.dtype.itemsize)]
    if col.validity is not None:
        parts.append(("mask", rows // 8))
    regions, off = {}, 0
    for name, nbytes in parts:
        regions[name] = (off, _region(nbytes))
        off += _region(nbytes)
    return regions


def _block_bytes(col: Column, rows: int) -> int:
    return sum(room for _, room in _stage_regions(col, rows).values())


@dataclasses.dataclass(frozen=True)
class _StagePlan:
    """What K6 or K7 follows over a list of columns.  ``tile_rows`` rows a
    tile, ``rows_per_thread`` of them a consumer thread; ``groups``: [start,
    stop) column ranges in chain order, each hashed from one stage of at
    most ``stage_bytes`` bytes, a new one at every launch of
    :data:`MAX_HASH_COLS` columns; ``slots``: each column's byte offset in
    its group's stage, None where the kernel reads it from device
    memory."""
    tile_rows: int
    rows_per_thread: int
    stage_bytes: int
    groups: Tuple[Tuple[int, int], ...]
    slots: Tuple[Optional[int], ...]

    def stage_fields(self, start: int, stop: int) -> List[int]:
        """The SrjHashCol::stage values of columns [start, stop)."""
        firsts = {g for g, _ in self.groups}
        return [(0 if self.slots[i] is None else self.slots[i] // 16 + 1)
                | (_GROUP_START if i in firsts else 0)
                for i in range(start, stop)]


def _stage_plan(cols: Sequence[Column], staging: _Staging,
                budget: int = _STAGE_BUDGET) -> _StagePlan:
    """A hash kernel's plan over ``cols`` from its ``staging`` and the
    columns' shapes alone: the ``strings`` tiles where a string column
    stages (or, where the staging reads strings in place, where there is a
    string column), else the ``fixed`` ones; the columns packed in chain
    order into groups whose staged blocks fit ``budget`` bytes; every
    fixed-width column staged whose block fits it, and every string whose
    block (its ``tile_rows x pitch`` chars) does where the staging stages
    strings.  Any other column is read from device memory in its place in
    the chain."""
    def staged(col, rows):
        return ((staging.stage_strings or not col.dtype.is_string)
                and _block_bytes(col, rows) <= budget)

    rows, per_thread = staging.strings
    if not any(c.dtype.is_string
               and (staged(c, rows) or not staging.stage_strings)
               for c in cols):
        rows, per_thread = staging.fixed
    groups, slots = [], []
    first, used, stage_bytes = 0, 0, 0
    for i, col in enumerate(cols):
        need = _block_bytes(col, rows)
        here = staged(col, rows)
        if i and (i % MAX_HASH_COLS == 0 or here and used + need > budget):
            groups.append((first, i))
            first, used = i, 0
        slots.append(used if here else None)
        if here:
            used += need
            stage_bytes = max(stage_bytes, used)
    groups.append((first, len(cols)))
    return _StagePlan(rows, per_thread, stage_bytes, tuple(groups),
                      tuple(slots))


# ---------------------------------------------------------------------------
# K6: murmur3_cols
# ---------------------------------------------------------------------------

def murmur3_cols_plain(cols: Sequence[Column], seed: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`murmur3_cols`: the JAX package's
    ``hashing._murmur3_chain``."""
    n = _check_cols(cols)
    h = torch.full((n,), seed & M32, dtype=torch.int64,
                   device=cols[0].device)
    for col in cols:
        h = _mm3_field(col, h)
    return _mm3_int(h)


def _mm3_field(col: Column, h: torch.Tensor) -> torch.Tensor:
    """The running hashes ``h`` (one a row, in ``[0, 2^32)``) after one
    column's fields: a null field leaves its row's hash as it is."""
    if col.dtype.is_string:
        hc = _mm3_string(col, h)
    else:
        words = _as_u32_words(col)
        hc = h
        for w in words:
            hc = _mm3_mix_h1(hc, w)
        hc = _mm3_fmix(hc, 4 * len(words))
    return torch.where(col.valid_bools(), hc, h) \
        if col.validity is not None else hc


def _mm3_int(h: torch.Tensor) -> torch.Tensor:
    """Hashes in ``[0, 2^32)`` as Spark's int (int32)."""
    return (h - ((h >> 31) << 32)).to(torch.int32)


def _string_pitch(col: Column) -> int:
    """A padded string column's row pitch in bytes as the kernels read it:
    its chars' row stride, 0 at a zero width (no chars to read)."""
    return col.chars2d.stride(0) if col.chars2d.shape[1] else 0


def _descriptors(cols: Sequence[Column]) -> ctypes.Array:
    """One SrjHashCol per column, which the C entry point copies into the
    kernel's parameter space."""
    descs = (_ColDesc * len(cols))()
    for d, c in zip(descs, cols):
        d.type = _TYPE_CODES[c.dtype.kind]
        d.valid = None if c.validity is None else c.validity.data_ptr()
        if c.dtype.is_string:
            ch = c.chars2d
            _check(c.lens.is_contiguous(), "lengths must be contiguous")
            if ch.shape[1]:
                _check(ch.stride(1) == 1 and ch.stride(0) % 4 == 0
                       and ch.data_ptr() % 4 == 0,
                       "padded chars must be 4-byte aligned rows of "
                       "contiguous bytes")
                d.data, d.pitch = ch.data_ptr(), _string_pitch(c)
            d.lens = c.lens.data_ptr()
        else:
            _check(c.data.is_contiguous(), "column data must be contiguous")
            d.data = c.data.data_ptr()
    return descs


def _launch_hash(name: str, cols: Sequence[Column], seed: int,
                 out: torch.Tensor, plan: "_StagePlan"):
    """Launch kernel ``name`` (K6 or K7) over ``cols`` by ``plan`` in chunks
    of :data:`MAX_HASH_COLS` columns: the first from ``seed``, each later
    one from the hashes in ``out``, which it overwrites.  The plan reaches
    the kernel in the descriptors' stage fields and in its tile rows, rows
    a thread and stage bytes."""
    dev = out.device
    for i in range(0, len(cols), MAX_HASH_COLS):
        chunk = cols[i:i + MAX_HASH_COLS]
        descs = _descriptors(chunk)
        for d, field in zip(descs, plan.stage_fields(i, i + len(chunk))):
            d.stage = field
        kernels.launch(name, ctypes.addressof(descs), len(chunk),
                       out.shape[0], seed, None if i == 0 else out.data_ptr(),
                       out.data_ptr(), plan.tile_rows, plan.rows_per_thread,
                       plan.stage_bytes, dev.index, kernels.stream_of(dev))


def _kernel_device(cols: Sequence[Column]) -> torch.device:
    dev = cols[0].device
    _check(dev.type == "cuda", f"no kernel for device {dev}")
    return dev


def murmur3_cols(cols: Sequence[Column], seed: int) -> torch.Tensor:
    """K6: Spark's murmur3_x86_32 chained over ``cols`` (fixed-width and
    dense-padded string columns, one device), int32 ``[n]``.  A null field
    leaves the running hash unchanged; ``seed`` is taken modulo 2^32.  On
    the card it launches ``ceil(len(cols) / MAX_HASH_COLS)`` times (once up
    to 800 columns), each launch counted."""
    cols = tuple(cols)
    n = _check_cols(cols)
    if cols[0].device.type == "cpu":
        return murmur3_cols_plain(cols, seed)
    out = torch.empty(n, dtype=torch.int32, device=_kernel_device(cols))
    if n:
        _launch_hash("murmur3_cols", cols, seed & M32, out,
                     _stage_plan(cols, _STAGING["murmur3_cols"]))
    return out


# ---------------------------------------------------------------------------
# K7: xxhash64_cols
# ---------------------------------------------------------------------------

def xxhash64_cols_plain(cols: Sequence[Column], seed: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`xxhash64_cols`: the JAX package's
    ``hashing._xx64_chain``."""
    n = _check_cols(cols)
    zeros = torch.zeros(n, dtype=torch.int64, device=cols[0].device)
    h = (zeros, zeros + (seed & M32))
    for col in cols:
        h = _xx_field(col, h)
    return _xx_long(h)


def _xx_field(col: Column, h):
    """The running hashes ``h`` (``(hi, lo)``, one a row) after one
    column's fields: a null field leaves its row's hash as it is."""
    if col.dtype.is_string:
        hc = _xx_string(col, h)
    else:
        zeros = h[0] * 0
        hc = _add64(_add64(h, _c64(_XXP5)), _c64(8))
        hc = _xx_stripe(hc, _xx_round((zeros, zeros), _col_u64_blocks(col)),
                        27, _XXP1, _XXP4)
        hc = _xx_fmix(hc)
    if col.validity is not None:
        hc = _where64(col.valid_bools(), hc, h)
    return hc


def _xx_long(h) -> torch.Tensor:
    """A ``(hi, lo)`` hash as Spark's long (int64)."""
    hi = h[0] - ((h[0] >> 31) << 32)                  # as int32
    return hi * (1 << 32) + h[1]


def xxhash64_cols(cols: Sequence[Column], seed: int) -> torch.Tensor:
    """K7: Spark's xxhash64 chained over ``cols``, int64 ``[n]``: Spark's
    long, whose bits are the JAX package's ``[n, 2]`` uint32 (lo, hi) pair
    read as one little-endian 64-bit word.  ``seed`` is taken modulo 2^32
    and zero-extended, as in the JAX package.  On the card it launches
    ``ceil(len(cols) / MAX_HASH_COLS)`` times, each launch counted."""
    cols = tuple(cols)
    n = _check_cols(cols)
    if cols[0].device.type == "cpu":
        return xxhash64_cols_plain(cols, seed)
    out = torch.empty(n, dtype=torch.int64, device=_kernel_device(cols))
    if n:
        _launch_hash("xxhash64_cols", cols, seed & M32, out,
                     _stage_plan(cols, _STAGING["xxhash64_cols"]))
    return out


# ---------------------------------------------------------------------------
# K8: bloom_might_contain
# ---------------------------------------------------------------------------

# K8's routes (csrc/bloom_probe.cu's route argument), and the largest
# filter, in long words, that the block route takes: 128 KiB of the 227 KB
# a block's shared memory can have, the largest size at which it was
# measured faster than the L2 route (PERF.md)
_BLOOM_L2, _BLOOM_BLOCK = 0, 1
_BLOOM_BLOCK_WORDS = 1 << 14


def _bloom_route(num_words: int) -> int:
    """K8's route for a filter of ``num_words`` long words, from its size
    alone: the block route (the whole bitset in each block's shared
    memory) up to :data:`_BLOOM_BLOCK_WORDS`, which holds Spark's filters
    of up to about 143,700 expected items at its default 3% false positive
    rate, else the L2 route (the bitset in device memory)."""
    return _BLOOM_BLOCK if num_words <= _BLOOM_BLOCK_WORDS else _BLOOM_L2


def _bloom_routes(num_words: int) -> List[int]:
    """Every route K8 can take a filter of ``num_words`` long words by, to
    time and check them beside each other: the L2 route, and the block
    route where it fits."""
    return [_BLOOM_L2] + [_BLOOM_BLOCK] * (num_words <= _BLOOM_BLOCK_WORDS)


def _check_bloom(words: torch.Tensor, col: Column, k: int):
    _check(words.dtype == torch.int64 and words.dim() == 1
           and words.shape[0] >= 1 and words.is_contiguous(),
           f"the bitset must be contiguous int64 [>= 1], got {words.dtype} "
           f"{tuple(words.shape)}")
    _check(col.dtype.kind in BLOOM_KINDS and col.data.is_contiguous(),
           f"the bloom probe takes contiguous long-castable integer "
           f"columns, got {col.dtype!r}")
    _check(k >= 1, f"k must be >= 1, got {k}")
    _check(words.device == col.device,
           f"bitset on {words.device}, column on {col.device}")
    _check_cols((col,))


def _hash_long(lo, hi, seed):
    return _mm3_fmix(_mm3_mix_h1(_mm3_mix_h1(seed, lo), hi), 8)


def bloom_bit_indexes(values: torch.Tensor, k: int,
                      num_bits: int) -> torch.Tensor:
    """Spark's ``k`` bit positions for each long of ``values`` (int64
    ``[n]``) in a filter of ``num_bits`` bits, int64 ``[n, k]``: ``h1 =
    hashLong(v, 0)``, ``h2 = hashLong(v, h1)`` and, for i in 1..k, the
    int32 ``h1 + i * h2``, complemented if negative, modulo ``num_bits``.
    The host filter (:mod:`.spark_bloom`) builds and probes with it too."""
    lo, hi = values & M32, (values >> 32) & M32
    h1 = _hash_long(lo, hi, lo * 0)
    h2 = _hash_long(lo, hi, h1)
    i = torch.arange(1, k + 1, dtype=torch.int64, device=values.device)
    c = (h1[:, None] + i * h2[:, None]) & M32
    c = torch.where(c >= 1 << 31, c - (1 << 32), c)     # as int32
    return torch.where(c < 0, ~c, c) % num_bits


def bloom_might_contain_plain(words: torch.Tensor, col: Column,
                              k: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`bloom_might_contain`: the JAX
    package's ``pallas_kernels._bloom_body`` with a 64-bit modulus."""
    _check_bloom(words, col, k)
    idx = bloom_bit_indexes(_signed_int64(col.data), k, 64 * words.shape[0])
    # an arithmetic shift keeps the low bits, so & 1 is the bit
    bits = (words[idx >> 6] >> (idx & 63)) & 1
    return (bits == 1).all(dim=1) & col.valid_bools()


def bloom_might_contain(words: torch.Tensor, col: Column,
                        k: int) -> torch.Tensor:
    """K8: Spark's ``mightContainLong`` of each row of ``col`` (an integer
    column Spark casts to long) against a filter with ``k`` hash functions
    and the long[] bitset ``words`` (int64 ``[num_words]``, ``num_bits`` =
    64 * num_words, any size), bool ``[n]``; null rows give False."""
    _check_bloom(words, col, k)
    if col.device.type == "cpu":
        return bloom_might_contain_plain(words, col, k)
    out = torch.empty(col.num_rows, dtype=torch.bool,
                      device=_kernel_device((col,)))
    if col.num_rows:
        _launch_bloom(words, col, k, _bloom_route(words.shape[0]), out)
    return out


def _launch_bloom(words: torch.Tensor, col: Column, k: int, route: int,
                  out: torch.Tensor):
    """Launch K8 by ``route`` into ``out`` (bool ``[n]``, n > 0)."""
    dev = out.device
    kernels.launch(
        "bloom_might_contain", words.data_ptr(), 64 * words.shape[0], k,
        col.data.data_ptr(), col.dtype.itemsize,
        None if col.validity is None else col.validity.data_ptr(),
        col.num_rows, out.data_ptr(), route, dev.index,
        kernels.stream_of(dev))
