"""The shape-bucket grid: sizes quantized up a geometric grid, so that
varying traffic lands on a bounded set of shapes.

The PyTorch counterpart of the grid in ``spark_rapids_jni_tpu.runtime.shapes``
(``bucket_rows`` :96, ``bucket_width`` :108, ``split_bucket``).  The port
compiles nothing per shape, but the serve scheduler's coalescing signatures
and slot counts and the staging blobs' lengths come from this grid, so it is
the same grid, read from the same ``SRJ_TPU_SHAPE_BUCKETS`` variable: pow-2
from :data:`MIN_ROWS` by default.  The pad and unpad helpers wait for a
later slice (``ROADMAP.md`` queue 1, item 8).
"""

from __future__ import annotations

import math
import os
from typing import Optional

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
