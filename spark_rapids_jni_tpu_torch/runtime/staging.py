"""Coalesced host <-> device staging: one transfer for a group of buffers,
not one per buffer.

The PyTorch counterpart of ``stage_arrays`` (:157) and ``fetch_arrays``
(:218) of ``spark_rapids_jni_tpu.runtime.staging``:

- :func:`stage_arrays` packs host numpy buffers into ONE host blob, each
  buffer at an 8-byte-aligned offset, the blob's length on the
  :mod:`.shapes` grid (so the blobs come in a bounded set of sizes, which
  PyTorch's caching allocators then reuse).  On a card the blob is pinned
  and goes across in ONE asynchronous host-to-device copy; typed views of
  the device blob give back the buffers.
- :func:`fetch_arrays` packs device tensors into ONE device blob (a
  ``torch.cat`` of their bytes), makes ONE device-to-host copy into pinned
  memory, waits for it, and gives back numpy views of the host blob.

The ``Prefetcher``, the host arena and ``fetch_table`` wait for a later
slice (``ROADMAP.md`` queue 1, item 8).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.runtime import shapes

# every buffer starts on an 8-byte boundary inside the blob, so that a typed
# view of it reads whole elements of any staged type (itemsize <= 8)
_ALIGN = 8

_TORCH_OF_NUMPY = {
    np.dtype(np.bool_): torch.bool, np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
}
_NUMPY_OF_TORCH = {t: n for n, t in _TORCH_OF_NUMPY.items()}


def _blob_len(payload: int) -> int:
    """Blob byte length on the geometric grid (pow-2 by default)."""
    return shapes.bucket_rows(payload)


def _offsets(bufs: Sequence[np.ndarray]):
    """(aligned start of each buffer, payload bytes)."""
    offs, off = [], 0
    for b in bufs:
        off = -(-off // _ALIGN) * _ALIGN
        offs.append(off)
        off += b.nbytes
    return offs, off


def stage_arrays(bufs: Sequence[np.ndarray],
                 device: torch.device) -> List[torch.Tensor]:
    """Host numpy buffers as tensors on ``device``, through ONE blob and,
    on a card, ONE host-to-device copy.  The copy is asynchronous on the
    current stream: the pinned blob comes from PyTorch's caching host
    allocator, which records the copy on it, so the blob is not reused
    before the copy has read it even once this function has dropped it."""
    device = torch.device(device)
    bufs = [np.ascontiguousarray(b) for b in bufs]
    for b in bufs:
        if b.dtype not in _TORCH_OF_NUMPY:
            raise ValueError(f"cannot stage a {b.dtype} buffer")
    offs, payload = _offsets(bufs)
    total = _blob_len(payload)
    host = torch.empty(total, dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    blob = host.numpy()
    for b, off in zip(bufs, offs):
        blob[off:off + b.nbytes] = b.reshape(-1).view(np.uint8)
    blob[payload:] = 0
    dev_blob = host.to(device, non_blocking=True)
    return [dev_blob[off:off + b.nbytes].view(_TORCH_OF_NUMPY[b.dtype])
            .view(b.shape) for b, off in zip(bufs, offs)]


def fetch_arrays(arrays: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Tensors as host numpy arrays, through ONE device-side byte pack and
    ONE device-to-host copy (into pinned memory on a card), waited for
    before numpy reads it.  The arrays are views of the host blob."""
    if not arrays:
        return []
    dev = arrays[0].device
    for a in arrays:
        if a.device != dev or a.dtype not in _NUMPY_OF_TORCH:
            raise ValueError(f"cannot fetch a {a.dtype} tensor on "
                             f"{a.device} with tensors on {dev}")
    pieces = [a.reshape(-1).view(torch.uint8) for a in arrays if a.numel()]
    blob = (torch.cat(pieces) if pieces
            else torch.empty(0, dtype=torch.uint8, device=dev))
    if dev.type == "cuda":
        host = torch.empty(blob.numel(), dtype=torch.uint8, pin_memory=True)
        host.copy_(blob, non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
    else:
        host = blob
    flat = host.numpy()
    outs, off = [], 0
    for a in arrays:
        dt = _NUMPY_OF_TORCH[a.dtype]
        nb = a.numel() * dt.itemsize
        outs.append(flat[off:off + nb].view(dt).reshape(tuple(a.shape)))
        off += nb
    return outs
