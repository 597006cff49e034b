"""The build of every hand-written CUDA kernel of the port, and the
row-conversion kernels' wrappers and plain PyTorch versions.

- :func:`grouped_encode` (``csrc/row_encode.cu``) replaces the TPU kernel
  ``spark_rapids_jni_tpu/ops/row_mxu.py::_grouped_encode_kernel``: the
  plane-major backing to JCUDF rows.
- :func:`decode_planes` (``csrc/row_decode.cu``) replaces
  ``row_mxu.py::_fused_decode_kernel``: JCUDF rows to word planes and packed
  validity.
- :func:`pack_planes` (``csrc/pack_planes.cu``) replaces
  ``row_mxu.py::_pack_kernel``: a batch of a table's columns to its forward
  word planes, validity quads included (the first stage of the two-stage
  encode, ``row_mxu.to_rows_fixed``).
- :func:`planes_to_rows` (``csrc/planes_to_rows.cu``) replaces
  ``pallas_kernels.py::_pack_kernel`` and :func:`rows_to_planes`
  (``csrc/rows_to_planes.cu``) its ``_unpack_kernel``: the word transposes
  between a row's 32-bit word planes and its bytes, under the word-plane
  engine (:mod:`.plane_rows`).
- :func:`to_rows_cols` (``csrc/to_rows_cols.cu``) replaces
  ``row_kernels.py::_to_rows_kernel`` and :func:`from_rows_cols`
  (``csrc/from_rows_cols.cu``) its ``_from_rows_kernel``: a batch of a
  table's columns, each read in place, to JCUDF rows through a shared-memory
  tile of whole rows, and back to columns and packed masks, under the
  per-column-block engine (:mod:`.row_kernels`).
- The hash and bloom-probe kernels (``csrc/murmur3.cu``,
  ``csrc/xxhash64.cu``, ``csrc/bloom_probe.cu``) build here too; their
  wrappers and plain versions are in :mod:`.hash_kernels`.  So does the
  get_json path automaton (``csrc/gjo_scan.cu``), whose wrapper and plain
  version are in :mod:`.get_json`.
- :func:`compact_encode` (``csrc/compact_encode.cu``) and
  :func:`string_gather` (``csrc/string_gather.cu``) replace no TPU kernel:
  the ragged copies of the compact JCUDF rows (the JAX package's XLA
  ``_to_rows_variable_jit`` and ``_gather_one_string``), every string
  column in one launch, tiles of rows moved through a ring of shared-memory
  stages by bulk copies by the plans :func:`compact_encode_plan` and
  :func:`string_gather_plan`.

A wrapper runs the plain version only for tensors on the CPU.  For CUDA
tensors it launches its kernel or raises; there is no fallback.  Each launch
adds one to ``launches[name]``.

The kernels build at first use: one ``nvcc`` per source, all started
together, into ``build/torch_kernels/`` at the repository root, as shared
libraries with a plain C interface loaded with ``ctypes``.  A library's file
name carries a hash of its sources and flags, so an edit rebuilds it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.table import (
    Table, bits_view, bytes_to_col, col_to_bytes, pack_bools, valid_bits,
)
from spark_rapids_jni_tpu_torch.ops import word_plan
from spark_rapids_jni_tpu_torch.ops.row_layout import RowLayout

# launches of each kernel since the last reset_launches()
launches = {"grouped_encode": 0, "decode_planes": 0, "pack_planes": 0,
            "murmur3_cols": 0, "xxhash64_cols": 0, "bloom_might_contain": 0,
            "gjo_scan": 0, "planes_to_rows": 0, "rows_to_planes": 0,
            "to_rows_cols": 0, "from_rows_cols": 0, "compact_encode": 0,
            "string_gather": 0}


def reset_launches():
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = {"grouped_encode": "row_encode.cu", "decode_planes": "row_decode.cu",
           "pack_planes": "pack_planes.cu", "murmur3_cols": "murmur3.cu",
           "xxhash64_cols": "xxhash64.cu",
           "bloom_might_contain": "bloom_probe.cu", "gjo_scan": "gjo_scan.cu",
           "planes_to_rows": "planes_to_rows.cu",
           "rows_to_planes": "rows_to_planes.cu",
           "to_rows_cols": "to_rows_cols.cu",
           "from_rows_cols": "from_rows_cols.cu",
           "compact_encode": "compact_encode.cu",
           "string_gather": "string_gather.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA "
                           "toolkit's bin directory on PATH")
    return found


def _library_path(name: str) -> Path:
    src = CSRC / SOURCES[name]
    digest = hashlib.sha256()
    for part in (src, *sorted(CSRC.glob("*.cuh"))):
        digest.update(part.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# each kernel's C entry point and its argument types
_ENTRY = {
    "grouped_encode": ("srj_grouped_encode", [
        _VP, _I64, _VP, _I64, _VP, _I32, _I32, _I32, _I32, _I64, _I64, _VP,
        _I32, _VP]),
    "decode_planes": ("srj_decode_planes", [
        _VP, _I64, _I32, _VP, _I32, _I32, _I32, _I64, _VP, _VP, _I64, _I32,
        _VP]),
    "pack_planes": ("srj_pack_planes", [_VP, _I64, _I64, _VP, _I32, _VP]),
    "murmur3_cols": ("srj_murmur3_cols", [
        _VP, _I32, _I64, ctypes.c_uint32, _VP, _VP, _I32, _I32, _I32, _I32,
        _VP]),
    "xxhash64_cols": ("srj_xxhash64_cols", [
        _VP, _I32, _I64, ctypes.c_uint64, _VP, _VP, _I32, _I32, _I32, _I32,
        _VP]),
    "bloom_might_contain": ("srj_bloom_might_contain", [
        _VP, _I64, _I32, _VP, _I32, _VP, _I64, _VP, _I32, _I32, _VP]),
    "gjo_scan": ("srj_gjo_scan", [
        _VP, _I64, _I64, _I32, _VP, _I32, _VP, _I32, _VP, _I32, _VP]),
    "planes_to_rows": ("srj_planes_to_rows", [
        _VP, _I64, _I32, _I64, _I64, _VP, _I32, _VP]),
    "rows_to_planes": ("srj_rows_to_planes", [_VP, _I64, _I32, _VP, _I32,
                                              _VP]),
    "to_rows_cols": ("srj_to_rows_cols", [_VP, _I64, _I64, _I32, _VP, _I32,
                                          _VP]),
    "from_rows_cols": ("srj_from_rows_cols", [_VP, _VP, _I64, _I32, _VP,
                                              _I64, _I32, _VP]),
    "compact_encode": ("srj_compact_encode", [
        _VP, _VP, _I32, _I32, _VP, _I64, _VP, _I32, _I32, _I32, _I32, _I32,
        _VP, _I32, _VP]),
    "string_gather": ("srj_string_gather", [
        _VP, _VP, _VP, _I64, _I32, _I32, _I32, _I32, _I32, _VP, _I32, _VP]),
}


def _declare(name: str, lib: ctypes.CDLL):
    entry, argtypes = _ENTRY[name]
    getattr(lib, entry).argtypes = argtypes
    getattr(lib, entry).restype = _I32
    lib.srj_cuda_error_string.argtypes = [_I32]
    lib.srj_cuda_error_string.restype = ctypes.c_char_p


def build_kernels() -> Dict[str, ctypes.CDLL]:
    """Build (where not built yet) and load every kernel library.  Each
    source compiles in its own ``nvcc`` process, all started together;
    ``nvcc``'s output, register and shared-memory use included, is kept
    beside each library as ``<name>.log``."""
    missing = [name for name in SOURCES if name not in _libs]
    if not missing:
        return _libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in missing:
        so = _library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, so))
    failures = []
    for name, proc, tmp, so in jobs:
        out, _ = proc.communicate()
        so.with_suffix(".log").write_text(out)
        if proc.returncode:
            failures.append(f"{SOURCES[name]}:\n{out}")
        else:
            os.replace(tmp, so)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    for name in missing:
        lib = ctypes.CDLL(str(_library_path(name)))
        _declare(name, lib)
        _libs[name] = lib
    return _libs


def build_log(name: str) -> str:
    """``nvcc``'s output for kernel ``name`` (after :func:`build_kernels`)."""
    return _library_path(name).with_suffix(".log").read_text()


def stream_of(device: torch.device) -> int:
    """The handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def launch(name: str, *args):
    """Call kernel ``name``'s C entry point (its library built at first
    use), raise on a non-zero ``cudaError_t`` and count the launch."""
    lib = build_kernels()[name]
    _raise_on(getattr(lib, _ENTRY[name][0])(*args), lib, name)
    launches[name] += 1


def _raise_on(rc: int, lib: ctypes.CDLL, name: str):
    if rc:
        msg = lib.srj_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


# ---------------------------------------------------------------------------
# Static maps, built once per layout from the word plans
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def encode_byte_map(layout: RowLayout) -> np.ndarray:
    """int16 ``[row_size]``: for each row byte, its plane byte ``4 * word +
    byte`` (>= 0), zero padding (-1) or validity byte ``v`` (``-2 - v``),
    from the forward plan."""
    _, p = word_plan._forward_plan(layout)
    wd = word_plan._data_words(layout)
    rs = layout.fixed_row_size
    src, dst = np.nonzero(p.view(np.uint8)[:wd].reshape(4 * wd, rs))
    if len(np.unique(dst)) != len(dst):
        raise AssertionError("forward plan maps two plane bytes to one row "
                             "byte")
    m = np.full(rs, -1, np.int16)
    m[dst] = src
    vo, vb = layout.validity_offset, layout.validity_bytes
    m[vo:vo + vb] = -2 - np.arange(vb)
    return m


@functools.lru_cache(maxsize=64)
def encode_word_map(layout: RowLayout) -> np.ndarray:
    """int16 ``[row_size // 4]``: for each 4-byte row word, the plane word
    ``w`` it copies whole, bytes 0 to 3 in order (>= 0), zero (-1), or mixed
    (-2): its bytes come one by one from :func:`encode_byte_map` (plane
    bytes, validity bytes or zero)."""
    m = encode_byte_map(layout).reshape(-1, 4).astype(np.int32)
    whole = (m[:, 0] % 4 == 0) & (m == m[:, :1] + np.arange(4)).all(1)
    whole &= m[:, 0] >= 0
    out = np.full(len(m), -2, np.int16)
    out[whole] = m[whole, 0] // 4
    out[(m == -1).all(1)] = -1
    return out


@functools.lru_cache(maxsize=64)
def _encode_maps(layout: RowLayout) -> np.ndarray:
    """K1's maps, int16 ``[row_size + row_size // 4]``: the byte map with
    each validity byte ``v`` as byte ``4 * Wd + v`` of the kernel's tile row
    (where it puts them), then :func:`encode_word_map`."""
    b = encode_byte_map(layout).copy()
    val = b <= -2
    b[val] = 4 * word_plan._data_words(layout) + (-2 - b[val])
    return np.concatenate([b, encode_word_map(layout)])


@functools.lru_cache(maxsize=64)
def decode_word_map(layout: RowLayout) -> np.ndarray:
    """int16 ``[4 * W]``: for byte ``k`` of plane word ``w`` (index
    ``4 * w + k``), its source row byte or -1, from the inverse plan."""
    _, p = word_plan._inverse_plan(layout)
    rs, w, _ = p.shape
    src, dst = np.nonzero(p.reshape(rs, 4 * w))
    if len(np.unique(dst)) != len(dst):
        raise AssertionError("inverse plan maps two row bytes to one plane "
                             "byte")
    m = np.full(4 * w, -1, np.int16)
    m[dst] = src
    return m


@functools.lru_cache(maxsize=64)
def _device_map(build, layout: RowLayout,
                device: torch.device) -> torch.Tensor:
    return torch.from_numpy(build(layout)).to(device)


def _index(m: np.ndarray, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(clamped int64 gather index, mask of the entries with a source)."""
    t = torch.from_numpy(m.astype(np.int64)).to(device)
    return t.clamp(min=0), t >= 0


# ---------------------------------------------------------------------------
# K1: grouped_encode
# ---------------------------------------------------------------------------

def _check_encode(planes, vmask, layout, start, size):
    wd = word_plan._data_words(layout)
    _check(planes.dtype == torch.int32 and planes.dim() == 2
           and planes.shape[0] >= wd,
           f"planes must be int32 [>= {wd}, n], got {planes.dtype} "
           f"{tuple(planes.shape)}")
    n = planes.shape[1]
    shape = (layout.num_columns, (n + 7) // 8)
    _check(vmask.dtype == torch.uint8 and tuple(vmask.shape) == shape,
           f"vmask must be uint8 {shape}, got {vmask.dtype} "
           f"{tuple(vmask.shape)}")
    _check(planes.is_contiguous() and vmask.is_contiguous(),
           "planes and vmask must be contiguous")
    _check(planes.device == vmask.device,
           f"planes on {planes.device}, vmask on {vmask.device}")
    _check(0 <= start and 0 <= size and start + size <= n,
           f"batch [{start}, {start + size}) outside {n} rows")


def grouped_encode_plain(planes: torch.Tensor, vmask: torch.Tensor,
                         layout: RowLayout, start: int,
                         size: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`grouped_encode`: a byte gather from
    the ``[size, 4 * Wd]`` byte view of the batch's data planes, then the
    validity bytes from the mask bits."""
    _check_encode(planes, vmask, layout, start, size)
    dev = planes.device
    wd = word_plan._data_words(layout)
    idx, has = _index(encode_byte_map(layout), dev)
    data = torch.empty((size, wd), dtype=torch.int32, device=dev)
    data.copy_(planes[:wd, start:start + size].T)
    data = data.view(torch.uint8)
    out = data.index_select(1, idx)
    out[:, ~has] = 0
    rows = torch.arange(start, start + size, device=dev)
    bits = (vmask[:, rows >> 3] >> (rows & 7).to(torch.uint8)) & 1
    vo, vb = layout.validity_offset, layout.validity_bytes
    bits = torch.nn.functional.pad(bits, (0, 0, 0, 8 * vb - bits.shape[0]))
    bits = bits.view(vb, 8, size)
    vbytes = bits[:, 0].clone()
    for j in range(1, 8):
        vbytes |= bits[:, j] << j
    out[:, vo:vo + vb] = vbytes.T
    return out


def grouped_encode(planes: torch.Tensor, vmask: torch.Tensor,
                   layout: RowLayout, start: int, size: int) -> torch.Tensor:
    """K1: JCUDF rows ``uint8 [size, row_size]`` of table rows
    ``[start, start + size)`` of a plane-major backing (``planes`` int32
    ``[W_in >= Wd, n]``, ``vmask`` uint8 ``[ncols, ceil(n/8)]``).  Any
    ``start`` is accepted."""
    _check_encode(planes, vmask, layout, start, size)
    if planes.device.type == "cpu":
        return grouped_encode_plain(planes, vmask, layout, start, size)
    _check(planes.device.type == "cuda",
           f"no kernel for device {planes.device}")
    rs = layout.fixed_row_size
    out = torch.empty((size, rs), dtype=torch.uint8, device=planes.device)
    if size:
        maps = _device_map(_encode_maps, layout, planes.device)
        launch("grouped_encode",
               planes.data_ptr(), planes.shape[1], vmask.data_ptr(),
               vmask.shape[1], maps.data_ptr(),
               word_plan._data_words(layout), layout.num_columns,
               layout.validity_bytes, rs, start, size, out.data_ptr(),
               planes.device.index, stream_of(planes.device))
    return out


# ---------------------------------------------------------------------------
# K2: decode_planes
# ---------------------------------------------------------------------------

def _decode_load_bytes(layout: RowLayout) -> int:
    """Bytes of each row the decode reads: through the last byte the word
    map names (the validity bytes), rounded up to a 4-byte word."""
    return (int(decode_word_map(layout).max()) + 1 + 3) // 4 * 4


def _check_decode(rows2d, layout):
    _check(rows2d.dtype == torch.uint8 and rows2d.dim() == 2,
           f"rows must be uint8 [n, row_stride], got {rows2d.dtype} "
           f"{tuple(rows2d.shape)}")
    _check(rows2d.is_contiguous(), "rows must be contiguous")
    _check(rows2d.shape[1] >= _decode_load_bytes(layout),
           f"row stride {rows2d.shape[1]} is shorter than the layout's "
           f"{layout.fixed_end} fixed bytes")


def decode_planes_plain(rows2d: torch.Tensor, layout: RowLayout
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`decode_planes`: a byte gather of the
    rows' plane bytes, viewed as words and transposed, and the packed
    masks from the rows' validity bytes."""
    _check_decode(rows2d, layout)
    idx, has = _index(decode_word_map(layout), rows2d.device)
    g = rows2d.index_select(1, idx)
    g[:, ~has] = 0
    planes = torch.empty((g.shape[1] // 4, g.shape[0]), dtype=torch.int32,
                         device=rows2d.device)
    planes.copy_(g.view(torch.int32).T)
    vo, vb = layout.validity_offset, layout.validity_bytes
    shifts = torch.arange(8, dtype=torch.uint8, device=rows2d.device)
    bits = (rows2d[:, vo:vo + vb].unsqueeze(-1) >> shifts) & 1
    bits = bits.reshape(rows2d.shape[0], 8 * vb)[:, :layout.num_columns]
    return planes, pack_bools(bits.T)


def decode_planes(rows2d: torch.Tensor, layout: RowLayout
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: decode ``rows2d`` (uint8 ``[n, row_stride]``; the stride may
    exceed the layout's row size, as padded string rows do) to int32
    ``[W, n]`` inverse-plan word planes and uint8 ``[ncols, ceil(n/8)]``
    packed validity whose bits past ``n`` are zero."""
    _check_decode(rows2d, layout)
    if rows2d.device.type == "cpu":
        return decode_planes_plain(rows2d, layout)
    _check(rows2d.device.type == "cuda",
           f"no kernel for device {rows2d.device}")
    stride = rows2d.shape[1]
    _check(stride % 4 == 0 and rows2d.data_ptr() % 4 == 0,
           "the decode kernel reads 4-byte words: row stride and start "
           "must be 4-byte aligned")
    n = rows2d.shape[0]
    num_words = word_plan._inverse_plan(layout)[0].num_words
    dev = rows2d.device
    planes = torch.empty((num_words, n), dtype=torch.int32, device=dev)
    vmask = torch.empty((layout.num_columns, (n + 7) // 8),
                        dtype=torch.uint8, device=dev)
    if n:
        word_map = _device_map(decode_word_map, layout, dev)
        launch("decode_planes",
               rows2d.data_ptr(), stride, _decode_load_bytes(layout),
               word_map.data_ptr(), num_words, layout.num_columns,
               layout.validity_offset, n, planes.data_ptr(),
               vmask.data_ptr(), vmask.shape[1], dev.index, stream_of(dev))
    return planes, vmask


# ---------------------------------------------------------------------------
# K3: pack_planes
# ---------------------------------------------------------------------------

# the most columns one launch takes (csrc/pack_planes.cu's kMaxPackCols)
MAX_PACK_COLS = 1024


class _PackCols(ctypes.Structure):
    """csrc/pack_planes.cu's SrjPackCols."""
    _fields_ = [("data", ctypes.c_void_p * MAX_PACK_COLS),
                ("valid", ctypes.c_void_p * MAX_PACK_COLS),
                ("n8", ctypes.c_int32), ("n4", ctypes.c_int32),
                ("n2", ctypes.c_int32), ("n1", ctypes.c_int32)]


def _check_pack(table: Table, layout: RowLayout, start: int, size: int):
    _check(tuple(table.dtypes) == layout.dtypes,
           "the table's types are not the layout's")
    _check(0 < layout.num_columns <= MAX_PACK_COLS,
           f"the pack takes 1 to {MAX_PACK_COLS} columns, got "
           f"{layout.num_columns}")
    if not all(dt.is_fixed_width and dt.itemsize in (1, 2, 4, 8)
               for dt in layout.dtypes):
        raise ValueError(f"the pack takes columns of 1, 2, 4 and 8 bytes, "
                         f"got {list(layout.dtypes)}")
    n, dev = table.num_rows, table.device
    # the messages are built only on failure: built for every column on
    # every call they cost time quadratic in the column count
    if any(c.num_rows != n or c.device != dev for c in table.columns):
        raise ValueError(f"columns of {[c.num_rows for c in table.columns]} "
                         f"rows on {[str(c.device) for c in table.columns]}")
    if not all(c.data.is_contiguous()
               and c.data.data_ptr() % c.data.element_size() == 0
               for c in table.columns):
        raise ValueError("column data must be contiguous and aligned to "
                         "its element size")
    if not all(v is None or (v.dtype == torch.uint8 and v.dim() == 1
                             and v.shape[0] >= (n + 7) // 8
                             and v.is_contiguous())
               for v in (c.validity for c in table.columns)):
        raise ValueError(f"validity must be contiguous uint8 "
                         f"[>= {(n + 7) // 8}]")
    _check(0 <= start and 0 <= size and start + size <= n,
           f"batch [{start}, {start + size}) outside {n} rows")


def pack_data_words(table: Table, layout: RowLayout, num_words: int,
                    start: int, size: int) -> torch.Tensor:
    """int32 ``[num_words, size]``: the forward plan's data words of table
    rows ``[start, start + size)`` in its first planes, zeros in the rest.
    Plain tensor copies, one per column: word-sized columns copy into whole
    planes, narrower ones into their bytes of a plane (a 64-bit column's
    planes are its little-endian lo and hi words, a decimal128 column's its
    four limbs)."""
    plan = word_plan._forward_plan(layout)[0]
    planes = torch.zeros((num_words, size), dtype=torch.int32,
                         device=table.device)
    plane_bytes = planes.view(torch.uint8).view(num_words, size, 4)
    for i, col in enumerate(table.columns):
        sz = layout.col_sizes[i]
        w, b = plan.col_word[i], plan.col_byte[i]
        data = bits_view(col.data)[start:start + size]
        if sz == 16:        # decimal128 [size, 4] limbs: four planes
            planes[w:w + 4] = data.T
        elif sz == 8:
            planes[w:w + 2] = data.view(torch.int32).view(size, 2).T
        elif sz == 4:
            planes[w] = data
        else:
            plane_bytes[w, :, b:b + sz] = data.view(torch.uint8).view(size,
                                                                      sz)
    return planes


def pack_planes_plain(table: Table, layout: RowLayout, start: int,
                      size: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`pack_planes`, the JAX package's
    ``row_mxu._pack_planes``: the data words (:func:`pack_data_words`),
    then each column's validity as a 0/1 byte of its quad."""
    _check_pack(table, layout, start, size)
    plan = word_plan._forward_plan(layout)[0]
    planes = pack_data_words(table, layout, plan.num_words, start, size)
    # column c's 0/1 byte is byte c % 4 of the c // 4-th validity word
    nc, vw0 = layout.num_columns, plan.validity_word[0]
    nq = plan.num_words - vw0
    quads = torch.nn.functional.pad(valid_bits(table.columns, start, size),
                                    (0, 0, 0, 4 * nq - nc))
    planes[vw0:].view(torch.uint8).view(nq, size, 4).copy_(
        quads.view(nq, 4, size).permute(0, 2, 1))
    return planes


def _pack_cols(table: Table, layout: RowLayout) -> _PackCols:
    cols = _PackCols()
    by_size = {sz: [c for c, s in zip(table.columns, layout.col_sizes)
                    if s == sz] for sz in (8, 4, 2, 1)}
    cols.n8, cols.n4, cols.n2, cols.n1 = (len(by_size[sz])
                                          for sz in (8, 4, 2, 1))
    data, valid = cols.data, cols.valid     # views of the structure
    for k, c in enumerate(by_size[8] + by_size[4] + by_size[2]
                          + by_size[1]):
        data[k] = c.data.data_ptr()
    for k, c in enumerate(table.columns):
        valid[k] = None if c.validity is None else c.validity.data_ptr()
    return cols


def pack_planes(table: Table, layout: RowLayout, start: int,
                size: int) -> torch.Tensor:
    """K3: the forward word planes, int32 ``[W, size]``, of table rows
    ``[start, start + size)`` (``row_mxu._forward_plan``): 8-byte columns
    as lo/hi plane pairs, then 4-byte columns, 2-byte columns two to a
    word and 1-byte columns four to a word, each in table order, then the
    validity quads (one 0/1 byte per column, four to a word, pad bytes
    zero).  Each column is read in place at ``start``, which may be any
    row; columns of 1, 2, 4 and 8 bytes only."""
    _check_pack(table, layout, start, size)
    dev = table.device
    if dev.type == "cpu":
        return pack_planes_plain(table, layout, start, size)
    _check(dev.type == "cuda", f"no kernel for device {dev}")
    num_words = word_plan._forward_plan(layout)[0].num_words
    out = torch.empty((num_words, size), dtype=torch.int32, device=dev)
    if size:
        cols = _pack_cols(table, layout)
        launch("pack_planes", ctypes.addressof(cols), start, size,
               out.data_ptr(), dev.index, stream_of(dev))
    return out


# ---------------------------------------------------------------------------
# K4: planes_to_rows, K5: rows_to_planes
# ---------------------------------------------------------------------------

def _check_tiles(num_words: int, n: int):
    """The transposes launch one block per 32 x 32 tile of words, on a
    one-dimensional grid of at most 2^31 - 1 blocks
    (``csrc/word_transpose.cuh``)."""
    tiles = -(-num_words // 32) * -(-n // 32)
    _check(tiles < 1 << 31, f"{n} rows of {num_words} words take {tiles} "
                            f"tiles, over the grid's 2^31 - 1")


def _check_planes(planes: torch.Tensor, start: int, size: int):
    _check(planes.dtype == torch.int32 and planes.dim() == 2
           and planes.shape[0] > 0,
           f"planes must be int32 [W >= 1, n], got {planes.dtype} "
           f"{tuple(planes.shape)}")
    _check(planes.is_contiguous(), "planes must be contiguous")
    _check(0 <= start and 0 <= size and start + size <= planes.shape[1],
           f"window [{start}, {start + size}) outside {planes.shape[1]} "
           f"rows")
    _check_tiles(planes.shape[0], size)


def planes_to_rows_plain(planes: torch.Tensor, start: int,
                         size: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`planes_to_rows`: the window's
    transpose, copied, as bytes."""
    _check_planes(planes, start, size)
    return planes[:, start:start + size].t().contiguous().view(torch.uint8)


def planes_to_rows(planes: torch.Tensor, start: int,
                   size: int) -> torch.Tensor:
    """K4: rows uint8 ``[size, 4 * W]`` of columns ``[start, start +
    size)`` of int32 word planes ``[W, n]``: byte ``4j + t`` of row ``r``
    is byte ``t`` of ``planes[j, start + r]``."""
    _check_planes(planes, start, size)
    dev = planes.device
    if dev.type == "cpu":
        return planes_to_rows_plain(planes, start, size)
    _check(dev.type == "cuda", f"no kernel for device {dev}")
    num_words = planes.shape[0]
    out = torch.empty((size, 4 * num_words), dtype=torch.uint8, device=dev)
    if size:
        launch("planes_to_rows", planes.data_ptr(), planes.shape[1],
               num_words, start, size, out.data_ptr(), dev.index,
               stream_of(dev))
    return out


def _check_rows(rows2d: torch.Tensor):
    _check(rows2d.dtype == torch.uint8 and rows2d.dim() == 2
           and rows2d.shape[1] % 4 == 0 and rows2d.shape[1] > 0,
           f"rows must be uint8 [n, 4 * W] with W >= 1, got "
           f"{rows2d.dtype} {tuple(rows2d.shape)}")
    _check(rows2d.is_contiguous() and rows2d.data_ptr() % 4 == 0,
           "rows must be contiguous and 4-byte aligned")
    _check_tiles(rows2d.shape[1] // 4, rows2d.shape[0])


def rows_to_planes_plain(rows2d: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`rows_to_planes`: the rows' words,
    transposed and copied."""
    _check_rows(rows2d)
    return rows2d.view(torch.int32).t().contiguous()


def rows_to_planes(rows2d: torch.Tensor) -> torch.Tensor:
    """K5: int32 word planes ``[W, n]`` of rows uint8 ``[n, 4 * W]``:
    ``planes[j, r]`` is bytes ``4j .. 4j + 3`` of row ``r``, the inverse of
    :func:`planes_to_rows`."""
    _check_rows(rows2d)
    dev = rows2d.device
    if dev.type == "cpu":
        return rows_to_planes_plain(rows2d)
    _check(dev.type == "cuda", f"no kernel for device {dev}")
    n, num_words = rows2d.shape[0], rows2d.shape[1] // 4
    out = torch.empty((num_words, n), dtype=torch.int32, device=dev)
    if n:
        launch("rows_to_planes", rows2d.data_ptr(), n, num_words,
               out.data_ptr(), dev.index, stream_of(dev))
    return out


# ---------------------------------------------------------------------------
# K10: to_rows_cols, K11: from_rows_cols
# ---------------------------------------------------------------------------

# the most columns one launch takes (csrc/row_cols.cuh's kMaxRowCols)
MAX_ROW_COLS = 1024
# a tile's shared memory: the default budget, and the most a block can have
DEFAULT_TILE_BYTES = 48 << 10
MAX_TILE_BYTES = 232448


class _RowCols(ctypes.Structure):
    """csrc/row_cols.cuh's SrjRowCols."""
    _fields_ = [("data", ctypes.c_void_p * MAX_ROW_COLS),
                ("valid", ctypes.c_void_p * MAX_ROW_COLS),
                ("start", ctypes.c_uint16 * MAX_ROW_COLS),
                ("size", ctypes.c_uint8 * MAX_ROW_COLS),
                ("ncols", ctypes.c_int32), ("row_size", ctypes.c_int32),
                ("validity_offset", ctypes.c_int32)]


def tile_rows_for(layout: RowLayout, tile_rows: int = 0) -> int:
    """Rows of K10's and K11's shared tile: ``tile_rows`` if positive (a
    multiple of 32 whose tile fits a block's shared memory), else as many
    as fit :data:`DEFAULT_TILE_BYTES`, rounded down to 32, from 32 to
    256."""
    # a row of the tile is one word more than the row, an odd number of
    # words (row_cols.cuh)
    pitch = layout.fixed_row_size + 4
    if tile_rows <= 0:
        return max(32, min(256, DEFAULT_TILE_BYTES // pitch) // 32 * 32)
    _check(tile_rows % 32 == 0 and tile_rows * pitch <= MAX_TILE_BYTES,
           f"tile_rows {tile_rows} is not a multiple of 32 whose tile of "
           f"{pitch}-byte rows fits {MAX_TILE_BYTES} bytes")
    return tile_rows


def _check_row_layout(layout: RowLayout):
    _check(0 < layout.num_columns <= MAX_ROW_COLS and not layout.has_strings,
           f"the row kernels take 1 to {MAX_ROW_COLS} fixed-width columns, "
           f"got {list(layout.dtypes)}")


def _check_to_rows(table: Table, layout: RowLayout, start: int, size: int):
    _check_row_layout(layout)
    _check(tuple(table.dtypes) == layout.dtypes,
           "the table's types are not the layout's")
    n, dev = table.num_rows, table.device
    nb = (n + 7) // 8
    # one pass over the columns, the message built only on failure: this
    # runs before every launch, and its host time shows in the launch's
    for c in table.columns:
        d, v = c.data, c.validity
        if not (d.shape[0] == n and d.device == dev and d.is_contiguous()
                and d.data_ptr() % min(c.dtype.itemsize, 16) == 0
                and (v is None or (v.dtype == torch.uint8 and v.dim() == 1
                                   and v.shape[0] >= nb and v.device == dev
                                   and v.is_contiguous()))):
            raise ValueError(
                f"columns must hold {n} rows on {dev}, their data "
                f"contiguous and aligned to its value size, their validity "
                f"contiguous uint8 [>= {nb}]; got {c.dtype} "
                f"{tuple(d.shape)} on {d.device}, validity "
                f"{None if v is None else (v.dtype, tuple(v.shape))}")
    _check(0 <= start and 0 <= size and start + size <= n,
           f"batch [{start}, {start + size}) outside {n} rows")


def _row_cols(layout: RowLayout, datas, valids=()) -> _RowCols:
    cols = _RowCols()
    nc = layout.num_columns
    cols.data[:nc] = [d.data_ptr() for d in datas]
    cols.valid[:len(valids)] = [None if v is None else v.data_ptr()
                                for v in valids]
    cols.start[:nc] = layout.col_starts
    cols.size[:nc] = layout.col_sizes
    cols.ncols, cols.row_size = nc, layout.fixed_row_size
    cols.validity_offset = layout.validity_offset
    return cols


def to_rows_cols_plain(table: Table, layout: RowLayout, start: int,
                       size: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`to_rows_cols`, the function of the
    JAX package's ``_to_rows_kernel``: zeroed rows, each column's bytes
    through a byte view into its slot, then the validity bytes."""
    _check_to_rows(table, layout, start, size)
    out = torch.zeros((size, layout.fixed_row_size), dtype=torch.uint8,
                      device=table.device)
    for c, s, sz in zip(table.columns, layout.col_starts, layout.col_sizes):
        out[:, s:s + sz] = col_to_bytes(c.data[start:start + size])
    vo, vb = layout.validity_offset, layout.validity_bytes
    bits = torch.nn.functional.pad(valid_bits(table.columns, start, size),
                                   (0, 0, 0, 8 * vb - layout.num_columns))
    shifts = torch.arange(8, dtype=torch.uint8, device=table.device)
    out[:, vo:vo + vb] = (bits.view(vb, 8, size) << shifts[:, None]).sum(
        1, dtype=torch.uint8).T
    return out


def to_rows_cols(table: Table, layout: RowLayout, start: int, size: int,
                 tile_rows: int = 0) -> torch.Tensor:
    """K10: JCUDF rows uint8 ``[size, row_size]`` of table rows ``[start,
    start + size)``, each column read in place at ``start`` (any row), a
    column without a mask valid throughout.  ``tile_rows``: rows of the
    shared tile, 0 for :func:`tile_rows_for`'s."""
    _check_to_rows(table, layout, start, size)
    dev = table.device
    if dev.type == "cpu":
        return to_rows_cols_plain(table, layout, start, size)
    _check(dev.type == "cuda", f"no kernel for device {dev}")
    tile = tile_rows_for(layout, tile_rows)
    out = torch.empty((size, layout.fixed_row_size), dtype=torch.uint8,
                      device=dev)
    if size:
        cols = _row_cols(layout, [c.data for c in table.columns],
                         [c.validity for c in table.columns])
        launch("to_rows_cols", ctypes.addressof(cols), start, size, tile,
               out.data_ptr(), dev.index, stream_of(dev))
    return out


def _check_from_rows(rows2d: torch.Tensor, layout: RowLayout):
    _check_row_layout(layout)
    rs = layout.fixed_row_size
    _check(rows2d.dtype == torch.uint8 and rows2d.dim() == 2
           and rows2d.shape[1] == rs,
           f"rows must be uint8 [n, {rs}], got {rows2d.dtype} "
           f"{tuple(rows2d.shape)}")
    _check(rows2d.is_contiguous() and rows2d.data_ptr() % 8 == 0,
           "rows must be contiguous and 8-byte aligned")


def from_rows_cols_plain(rows2d: torch.Tensor, layout: RowLayout):
    """Plain PyTorch version of :func:`from_rows_cols`, the function of the
    JAX package's ``_from_rows_kernel`` and its wrapper: each column's slot
    bytes as its values, the validity bytes' bits packed per column."""
    _check_from_rows(rows2d, layout)
    datas = [bytes_to_col(rows2d[:, s:s + sz], dt) for dt, s, sz in
             zip(layout.dtypes, layout.col_starts, layout.col_sizes)]
    n = rows2d.shape[0]
    vo, vb = layout.validity_offset, layout.validity_bytes
    shifts = torch.arange(8, dtype=torch.uint8, device=rows2d.device)
    bits = (rows2d[:, vo:vo + vb].unsqueeze(-1) >> shifts) & 1
    return datas, pack_bools(bits.reshape(n, 8 * vb)[:, :layout.num_columns]
                             .T)


def _column_buffers(layout: RowLayout, n: int, dev) -> list:
    """Every column's ``n`` values, as views of one allocation (one
    allocation and one split, where a tensor a column costs milliseconds
    of host time at 212 columns).  The columns lie widest first, so each
    view starts aligned to its value size; they share the allocation, as
    the columns of a decoded backing share its planes."""
    order = sorted(range(layout.num_columns),
                   key=lambda i: -layout.col_sizes[i])
    sizes = [n * layout.col_sizes[i] for i in order]
    parts = torch.split(torch.empty(sum(sizes), dtype=torch.uint8,
                                    device=dev), sizes)
    datas = [None] * layout.num_columns
    for i, part in zip(order, parts):
        dt = layout.dtypes[i]
        datas[i] = (part.view(torch.int32).view(n, 4) if dt.itemsize == 16
                    else part.view(dt.torch_dtype))
    return datas


def from_rows_cols(rows2d: torch.Tensor, layout: RowLayout,
                   tile_rows: int = 0):
    """K11: the columns of JCUDF rows uint8 ``[n, row_size]``: each
    column's values (``[n]`` of its type, int32 ``[n, 4]`` for decimal128)
    and uint8 ``[ncols, ceil(n/8)]`` packed masks whose bits past ``n`` are
    zero.  ``tile_rows`` as for :func:`to_rows_cols`."""
    _check_from_rows(rows2d, layout)
    dev = rows2d.device
    if dev.type == "cpu":
        return from_rows_cols_plain(rows2d, layout)
    _check(dev.type == "cuda", f"no kernel for device {dev}")
    tile = tile_rows_for(layout, tile_rows)
    n = rows2d.shape[0]
    datas = _column_buffers(layout, n, dev)
    vmask = torch.empty((layout.num_columns, (n + 7) // 8),
                        dtype=torch.uint8, device=dev)
    if n:
        cols = _row_cols(layout, datas)
        launch("from_rows_cols", ctypes.addressof(cols), rows2d.data_ptr(),
               n, tile, vmask.data_ptr(), vmask.shape[1], dev.index,
               stream_of(dev))
    return datas, vmask


# ---------------------------------------------------------------------------
# The compact JCUDF rows' ragged copies (no TPU kernel): compact_encode and
# string_gather
# ---------------------------------------------------------------------------

# the most string columns one launch takes (csrc/ragged_copy.cuh's
# kMaxStrCols): a 1 KB fixed section holds at most 128 eight-byte pairs
MAX_STR_COLS = 128


class _CompactStr(ctypes.Structure):
    """csrc/compact_encode.cu's SrjCompactStr."""
    _fields_ = [("chars", ctypes.c_void_p), ("offsets", ctypes.c_void_p),
                ("lo", ctypes.c_int64)]


class _CompactCols(ctypes.Structure):
    """csrc/compact_encode.cu's SrjCompactCols."""
    _fields_ = [("col", _CompactStr * MAX_STR_COLS), ("ncols", ctypes.c_int32)]


class _GatherStr(ctypes.Structure):
    """csrc/string_gather.cu's SrjGatherStr."""
    _fields_ = [("str_off", ctypes.c_void_p), ("out_off", ctypes.c_void_p),
                ("out", ctypes.c_void_p)]


class _GatherCols(ctypes.Structure):
    """csrc/string_gather.cu's SrjGatherCols."""
    _fields_ = [("col", _GatherStr * MAX_STR_COLS), ("ncols", ctypes.c_int32)]



# ---------------------------------------------------------------------------
# The tile plans of the compact encode and the string gather
# ---------------------------------------------------------------------------

# csrc/ragged_copy.cuh's ring: the most rows a tile, consumer warps a
# block and stages; the bytes before the stages (the mbarriers) and a
# stage's header
TILE_MAX_ROWS, TILE_MAX_WARPS, TILE_MAX_STAGES = 128, 16, 4
_TILE_BAR_BYTES, _SLOT_HEADER = 128, 16
# an H100's shared memory: an SM's 228 KB, of which each block reserves
# 1 KB and takes at most 227 KB
SM_SMEM_BYTES, BLOCK_SMEM_RESERVED, BLOCK_SMEM_MAX = 233_472, 1_024, 232_448
# a stage is sized for its tile's expected bytes times this, so that tiles
# of rows a little longer than the batch's mean still fit
_TILE_MARGIN = 1.25
# each kernel's ring: (blocks an SM, stages a block), the fastest of those
# chip_smoke.py times at the string axis (PERF.md)
ENCODE_RING = (1, 2)
GATHER_RING = (2, 3)
# consumer warps an SM (csrc/compact_encode.cu and string_gather.cu take
# about 56 registers a thread: 36 warps an SM), shared by its blocks
_SM_CONSUMER_WARPS = 32


def _round16(nbytes) -> int:
    return -(-int(nbytes) // 16) * 16


def _room(nbytes: int) -> int:
    """The room of a staged part of ``nbytes`` bytes: whole 16-byte chunks
    and one more, since its aligned chunks may start inside the first
    (``ragged_copy.cuh``'s ``stage_room``)."""
    return _round16(nbytes) + 16


def _encode_slot(tile_rows: int, ncols: int, stride: int,
                 chars_bytes: int = 0) -> Dict[str, int]:
    """Where an encode stage's parts start, in bytes from the stage's start,
    and its ``bytes``: ``ragged_copy.cuh``'s ``encode_slot`` (the block's
    one image of a tile's output follows the stages)."""
    rows = _SLOT_HEADER + _round16(8 * ncols)
    col_room = _room(4 * (tile_rows + 1))
    col_room += 16 if col_room % 32 == 0 else 0
    cols = rows + _room(4 * (tile_rows + 1))
    fixed = cols + ncols * col_room
    chars = fixed + _room(tile_rows * stride)
    return {"rows": rows, "cols": cols, "col_room": col_room,
            "fixed": fixed, "chars": chars, "bytes": chars + chars_bytes}


def _gather_slot(tile_rows: int, ncols: int,
                 chars_bytes: int = 0) -> Dict[str, int]:
    """Where a gather stage's parts start and its ``bytes``:
    ``ragged_copy.cuh``'s ``gather_slot`` (a column's block holds its pair
    offsets, then its output offsets at ``out_off``; the block's one image
    of a tile's output follows the stages)."""
    places = _SLOT_HEADER + _round16(8 * ncols)
    bases = places + _round16(4 * ncols)
    spans = bases + _round16(4 * tile_rows)
    rows = spans + _round16(8 * tile_rows)
    cols = rows + _room(4 * (tile_rows + 1))
    col_bytes = _room(4 * tile_rows) + _room(4 * (tile_rows + 1))
    chars = cols + ncols * col_bytes
    return {"places": places, "bases": bases, "spans": spans, "rows": rows,
            "cols": cols, "col_bytes": col_bytes,
            "out_off": _room(4 * tile_rows), "chars": chars,
            "bytes": chars + chars_bytes}


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """How the compact encode or the string gather walks a batch: tiles of
    ``tile_rows`` rows, ``consumer_warps`` consumer warps beside the
    producer warp of a block, a ring of ``stages`` stages of
    ``slot_bytes`` each, with room for ``chars_bytes`` of chars, and one
    image of ``image_bytes`` for a tile's output.  A tile whose bytes pass
    a room takes the long-row route."""
    tile_rows: int
    consumer_warps: int
    stages: int
    chars_bytes: int
    image_bytes: int
    slot_bytes: int

    @property
    def smem_bytes(self) -> int:
        """Shared memory a block takes: the mbarriers, the stages, the
        image."""
        return (_TILE_BAR_BYTES + self.stages * self.slot_bytes
                + self.image_bytes)

    def long_route(self) -> "TilePlan":
        """This plan with a 16-byte image, its room given to the chars: the
        same shared memory, and every tile of more than 16 output bytes on
        the long-row route (to time that route)."""
        spare = (self.image_bytes - 16) // self.stages // 16 * 16
        return dataclasses.replace(self, chars_bytes=self.chars_bytes + spare,
                                   image_bytes=16,
                                   slot_bytes=self.slot_bytes + spare)


def _block_budget(blocks_per_sm: int) -> int:
    """The bytes of a block's stages (and image) when ``blocks_per_sm``
    blocks share an SM's shared memory."""
    block = min(BLOCK_SMEM_MAX, SM_SMEM_BYTES // blocks_per_sm
                - BLOCK_SMEM_RESERVED)
    return (block - _TILE_BAR_BYTES) // 16 * 16


def _consumer_warps(rows: int, blocks: int) -> int:
    """Consumer warps a block: at most :data:`TILE_MAX_WARPS`, one a row, and
    the SM's :data:`_SM_CONSUMER_WARPS` shared by its blocks."""
    return max(1, min(TILE_MAX_WARPS, rows, _SM_CONSUMER_WARPS // blocks))


def _sized(need, stages: int, budget: int, tile_rows) -> Tuple[int, ...]:
    """(rows, a stage's parts of fixed size, its chars room, the image
    room) of a ring of ``stages`` stages and one image in ``budget`` bytes,
    ``need(rows)`` giving a stage's parts of fixed size and the chars and
    image that rows of the batch's mean size need.  The rows are
    ``tile_rows`` where given, else the most whose stages and image fit: a
    multiple of 8 up to :data:`TILE_MAX_ROWS`, or fewer than 8 where no
    multiple fits, and 1 where nothing does (its tiles then take the
    long-row route whenever they pass the rooms).  The rest of the budget
    goes to the two rooms in proportion."""
    def fits(rows):
        fixed, c, i = need(rows)
        return stages * (fixed + c) + i <= budget

    if tile_rows is None:
        counts = list(range(1, 8)) + list(range(8, TILE_MAX_ROWS + 1, 8))
        tile_rows = max([r for r in counts if fits(r)], default=1)
    fixed, c, i = need(tile_rows)
    room = budget - stages * fixed
    _check(room >= 16 * (stages + 1),
           f"no room for chars and an image in {budget} bytes at "
           f"{tile_rows} rows and {stages} stages")
    chars_bytes = max(16, room * c // (stages * c + i) // 16 * 16)
    return (tile_rows, fixed, chars_bytes,
            (room - stages * chars_bytes) // 16 * 16)


def compact_encode_plan(n: int, stride: int, ncols: int, total_bytes: int,
                        char_bytes: int, *, ring=None,
                        tile_rows=None) -> TilePlan:
    """The compact encode's plan for a batch of ``n`` rows of
    ``total_bytes``, fixed sections at ``stride``, ``ncols`` string columns
    of ``char_bytes`` chars in all, on the ring ``(blocks an SM, stages a
    block)`` (:data:`ENCODE_RING`).  A stage holds the tile's parts
    of fixed size (``_encode_slot``) and room for its chars (each column's
    range widened to its 16-byte chunks), and the block one image of a
    tile's output, both sized from the batch's mean row times
    :data:`_TILE_MARGIN` (:func:`_sized`)."""
    blocks, stages = ring or ENCODE_RING
    row, chars = total_bytes / max(n, 1), char_bytes / max(n, 1)

    def need(rows):
        return (_encode_slot(rows, ncols, stride)["chars"],
                _round16(_TILE_MARGIN * rows * chars + 32 * ncols),
                _round16(_TILE_MARGIN * rows * row + 16))

    rows, fixed, chars_bytes, image_bytes = _sized(
        need, stages, _block_budget(blocks), tile_rows)
    return TilePlan(rows, _consumer_warps(rows, blocks), stages, chars_bytes,
                    image_bytes, fixed + chars_bytes)


def string_gather_plan(n: int, ncols: int, blob_bytes: int, char_bytes: int,
                       *, ring=None, tile_rows=None) -> TilePlan:
    """The string gather's plan for a batch of ``n`` rows in ``blob_bytes``
    with ``ncols`` string columns of ``char_bytes`` chars in all, on the
    ring ``(blocks an SM, stages a block)`` (:data:`GATHER_RING`).  A stage
    holds the tile's pairs and offsets (``_gather_slot``) and room for its
    chars, each row's span (its chars, widened to 16-byte chunks: 16 bytes
    more a row on the mean); the block one image of a tile's output (each
    column's part from its address's offset in a 16-byte word), both
    sized from the batch's mean row times :data:`_TILE_MARGIN`
    (:func:`_sized`)."""
    blocks, stages = ring or GATHER_RING
    per_row = (char_bytes + 16 * n) / max(n, 1)
    out_row = char_bytes / max(n, 1)

    def need(rows):
        return (_gather_slot(rows, ncols)["chars"],
                _round16(_TILE_MARGIN * rows * per_row + 16),
                _round16(_TILE_MARGIN * rows * out_row + 32 * ncols))

    rows, fixed, chars_bytes, image_bytes = _sized(
        need, stages, _block_budget(blocks), tile_rows)
    return TilePlan(rows, _consumer_warps(rows, blocks), stages, chars_bytes,
                    image_bytes, fixed + chars_bytes)


def _is_vector(t: torch.Tensor, dtype, length: int, dev) -> bool:
    return (t.dtype == dtype and t.dim() == 1 and t.shape[0] == length
            and t.is_contiguous() and t.device == dev)


def _check_compact_encode(fixed, fixed_end, row_offsets, total_bytes,
                          strings):
    _check(fixed.dtype == torch.uint8 and fixed.dim() == 2
           and fixed.is_contiguous() and fixed.shape[1] % 4 == 0
           and 0 < fixed_end <= fixed.shape[1],
           f"fixed sections must be contiguous uint8 [n, stride] with the "
           f"stride a multiple of 4 and at least fixed_end {fixed_end}, got "
           f"{fixed.dtype} {tuple(fixed.shape)}")
    n = fixed.shape[0]
    dev = fixed.device
    _check(_is_vector(row_offsets, torch.int32, n + 1, dev),
           f"row offsets must be contiguous int32 [{n + 1}] on {dev}")
    _check(total_bytes >= 0 and total_bytes % 8 == 0,
           f"a batch of compact rows holds a multiple of 8 bytes, not "
           f"{total_bytes}")
    _check(len(strings) <= MAX_STR_COLS,
           f"one launch takes at most {MAX_STR_COLS} string columns, got "
           f"{len(strings)}")
    for chars, offsets, lo in strings:
        if not (chars.dtype == torch.uint8 and chars.dim() == 1
                and chars.is_contiguous() and chars.device == dev
                and _is_vector(offsets, torch.int32, n + 1, dev)
                and lo >= 0):
            raise ValueError(
                f"each string column needs contiguous uint8 chars and int32 "
                f"offsets [{n + 1}] on {dev} and lo >= 0, got "
                f"{chars.dtype} {tuple(chars.shape)}, {offsets.dtype} "
                f"{tuple(offsets.shape)}, lo {lo}")


def compact_encode_plain(fixed: torch.Tensor, fixed_end: int,
                         row_offsets: torch.Tensor, total_bytes: int,
                         strings) -> torch.Tensor:
    """Plain PyTorch version of :func:`compact_encode`, the JAX package's
    ``_to_rows_variable_jit`` in torch: zeroed rows, the fixed sections'
    words (``fixed_end`` rounded up to 4) scattered at ``row_offsets //
    4``, then each string column's chars scattered byte by byte
    (``repeat_interleave`` of the rows, an int64 index a char)."""
    _check_compact_encode(fixed, fixed_end, row_offsets, total_bytes,
                          strings)
    n = fixed.shape[0]
    dev = fixed.device
    out = torch.zeros(total_bytes, dtype=torch.uint8, device=dev)
    if n == 0:
        return out
    ro = row_offsets.to(torch.int64)
    fw = (fixed_end + 3) // 4
    idx = (ro[:-1] // 4)[:, None] + torch.arange(fw, device=dev)
    out.view(torch.int32)[idx] = fixed.view(torch.int32)[:, :fw]
    if not strings:
        return out
    lens = torch.stack([o[1:] - o[:-1] for _, o, _ in strings],
                       1).to(torch.int64)                      # [n, k]
    within = fixed_end + torch.cumsum(lens, 1) - lens
    for k, (chars, offsets, lo) in enumerate(strings):
        ln = lens[:, k]
        total = int(ln.sum())
        if not total:
            continue
        rows = torch.repeat_interleave(torch.arange(n, device=dev), ln,
                                       output_size=total)
        intra = torch.arange(total, device=dev) - \
            (torch.cumsum(ln, 0) - ln)[rows]
        dst = ro[rows] + within[rows, k] + intra
        src = (offsets[:-1].to(torch.int64) - lo)[rows] + intra
        out[dst] = chars[src]
    return out


def compact_encode(fixed: torch.Tensor, fixed_end: int,
                   row_offsets: torch.Tensor, total_bytes: int,
                   strings) -> torch.Tensor:
    """The compact encode kernel: uint8 ``[total_bytes]`` compact JCUDF rows,
    row ``r`` at ``row_offsets[r]`` (int32 ``[n + 1]``, from 0, multiples
    of 8, ``row_offsets[n] == total_bytes``): its fixed section (``fixed``
    uint8 ``[n, stride]``, the stride a multiple of 4, zeros from
    ``fixed_end`` to it rounded up to 4), then each string
    column's chars back to back from ``fixed_end``, then zeros to the row's
    end.  ``strings`` holds one ``(chars, offsets, lo)`` a string column:
    its chars from absolute offset ``lo`` on, and its absolute int32
    offsets ``[n + 1]`` of the batch's rows; the caller guarantees every
    row's chars inside ``chars`` and each row's size (the JCUDF row
    sizes).  On the card it runs by :func:`encode_plan` of its
    arguments."""
    _check_compact_encode(fixed, fixed_end, row_offsets, total_bytes,
                          strings)
    dev = fixed.device
    if dev.type == "cpu":
        return compact_encode_plain(fixed, fixed_end, row_offsets,
                                    total_bytes, strings)
    _check(dev.type == "cuda", f"no kernel for device {dev}")
    args = (fixed, fixed_end, row_offsets, total_bytes, strings)
    return _launch_compact_encode(args, encode_plan(args))


def encode_plan(args, **kw) -> TilePlan:
    """:func:`compact_encode_plan` of the compact encode's arguments
    ``args`` (keywords passed on)."""
    fixed, _, _, total_bytes, strings = args
    return compact_encode_plan(fixed.shape[0], fixed.shape[1], len(strings),
                               total_bytes,
                               sum(c.numel() for c, _, _ in strings), **kw)


def _long_tiles_ptr(long_tiles, n: int, plan: TilePlan, dev):
    """The address of ``long_tiles`` (None: no record), checked as uint8
    zeros ``[tiles]`` of ``plan`` on ``dev``."""
    if long_tiles is None:
        return None
    tiles = -(-n // plan.tile_rows)
    _check(_is_vector(long_tiles, torch.uint8, tiles, dev),
           f"long_tiles must be contiguous uint8 [{tiles}] on {dev}")
    return long_tiles.data_ptr()


def _launch_compact_encode(args, plan: TilePlan,
                           long_tiles=None) -> torch.Tensor:
    """The compact encode kernel over ``args`` (:func:`compact_encode`'s,
    on one card) by ``plan``: its output.  Where ``long_tiles`` (uint8
    zeros, one a tile) is given, the kernel sets the tiles that took the
    long-row route to 1 in it."""
    fixed, fixed_end, row_offsets, total_bytes, strings = args
    dev = fixed.device
    _check(fixed.data_ptr() % 4 == 0, "the fixed sections must be 4-byte "
                                      "aligned")
    n, stride = fixed.shape
    flags = _long_tiles_ptr(long_tiles, n, plan, dev)
    out = torch.empty(total_bytes, dtype=torch.uint8, device=dev)
    if n:
        cols = _CompactCols()
        cols.ncols = len(strings)
        for d, (chars, offsets, lo) in zip(cols.col, strings):
            d.chars, d.offsets, d.lo = chars.data_ptr(), offsets.data_ptr(), lo
        launch("compact_encode", ctypes.addressof(cols), fixed.data_ptr(),
               stride, fixed_end, row_offsets.data_ptr(), n, out.data_ptr(),
               plan.tile_rows, plan.consumer_warps, plan.stages,
               plan.chars_bytes, plan.image_bytes, flags, dev.index,
               stream_of(dev))
    return out


def _check_gather(blob, row_offsets, pairs, totals):
    _check(blob.dtype == torch.uint8 and blob.dim() == 1
           and blob.is_contiguous(),
           f"the blob must be contiguous flat uint8, got {blob.dtype} "
           f"{tuple(blob.shape)}")
    dev = blob.device
    _check(row_offsets.dim() == 1 and row_offsets.shape[0] >= 1
           and _is_vector(row_offsets, torch.int32, row_offsets.shape[0],
                          dev),
           f"row offsets must be contiguous int32 [n + 1] on {dev}")
    n = row_offsets.shape[0] - 1
    _check(len(pairs) == len(totals) <= MAX_STR_COLS,
           f"{len(pairs)} string columns and {len(totals)} totals; one "
           f"launch takes at most {MAX_STR_COLS}")
    for (off, ln, out_off), total in zip(pairs, totals):
        if not (_is_vector(off, torch.int32, n, dev)
                and _is_vector(ln, torch.int32, n, dev)
                and _is_vector(out_off, torch.int32, n + 1, dev)
                and total >= 0):
            raise ValueError(
                f"each string column needs contiguous int32 offsets and "
                f"lengths [{n}] and output offsets [{n + 1}] on {dev}, and "
                f"a total >= 0")


def string_gather_plain(blob: torch.Tensor, row_offsets: torch.Tensor,
                        pairs, totals) -> List[torch.Tensor]:
    """Plain PyTorch version of :func:`string_gather`, the JAX package's
    ``_gather_one_string`` in torch: for each column, the rows repeated by
    their lengths (``repeat_interleave``), an int64 source index a char, one
    byte gather."""
    _check_gather(blob, row_offsets, pairs, totals)
    dev = blob.device
    n = row_offsets.shape[0] - 1
    ro = row_offsets.to(torch.int64)
    out = []
    for (off, ln, out_off), total in zip(pairs, totals):
        if not total:
            out.append(torch.empty(0, dtype=torch.uint8, device=dev))
            continue
        rows = torch.repeat_interleave(torch.arange(n, device=dev),
                                       ln.to(torch.int64), output_size=total)
        intra = torch.arange(total, device=dev) - \
            out_off[:-1].to(torch.int64)[rows]
        out.append(blob[ro[rows] + off.to(torch.int64)[rows] + intra])
    return out


def string_gather(blob: torch.Tensor, row_offsets: torch.Tensor, pairs,
                  totals) -> List[torch.Tensor]:
    """The string gather kernel: for each string column, uint8 ``[total]``
    chars, row ``r``'s ``str_len[r]`` bytes from ``blob[row_offsets[r] +
    str_off[r]:]`` at ``out_off[r]``.  ``pairs`` holds one ``(str_off,
    str_len, out_off)`` a column (int32 ``[n]``, ``[n]``, ``[n + 1]``, the
    output offsets the lengths' exclusive sum: the kernel reads each length
    as ``out_off[r + 1] - out_off[r]``), ``totals`` each column's
    ``out_off[n]``.  The caller guarantees every pair inside its row and the
    blob (``row_conversion`` checks them before it calls).  On the card it
    runs by :func:`gather_plan` of its arguments."""
    _check_gather(blob, row_offsets, pairs, totals)
    dev = blob.device
    if dev.type == "cpu":
        return string_gather_plain(blob, row_offsets, pairs, totals)
    _check(dev.type == "cuda", f"no kernel for device {dev}")
    args = (blob, row_offsets, pairs, totals)
    return _launch_string_gather(args, gather_plan(args))


def gather_plan(args, **kw) -> TilePlan:
    """:func:`string_gather_plan` of the string gather's arguments ``args``
    (keywords passed on)."""
    blob, row_offsets, pairs, totals = args
    return string_gather_plan(row_offsets.shape[0] - 1, max(len(pairs), 1),
                              blob.shape[0], sum(totals), **kw)


def _launch_string_gather(args, plan: TilePlan,
                          long_tiles=None) -> List[torch.Tensor]:
    """The string gather kernel over ``args`` (:func:`string_gather`'s, on
    one card) by ``plan``: each column's chars.  ``long_tiles`` as in
    :func:`_launch_compact_encode`."""
    blob, row_offsets, pairs, totals = args
    dev = blob.device
    out = [torch.empty(t, dtype=torch.uint8, device=dev) for t in totals]
    n = row_offsets.shape[0] - 1
    flags = _long_tiles_ptr(long_tiles, n, plan, dev)
    if n and pairs:
        cols = _GatherCols()
        cols.ncols = len(pairs)
        for d, (off, _, out_off), chars in zip(cols.col, pairs, out):
            d.str_off, d.out_off = off.data_ptr(), out_off.data_ptr()
            d.out = chars.data_ptr()
        launch("string_gather", ctypes.addressof(cols), blob.data_ptr(),
               row_offsets.data_ptr(), n, plan.tile_rows,
               plan.consumer_warps, plan.stages, plan.chars_bytes,
               plan.image_bytes, flags, dev.index, stream_of(dev))
    return out
