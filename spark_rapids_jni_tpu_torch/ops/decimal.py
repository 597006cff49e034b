"""decimal128 columns: DECIMAL(38, s) values to and from Python ints.

The PyTorch counterpart of the constructors of
``spark_rapids_jni_tpu.ops.decimal`` (``decimal128``,
``decimal128_from_ints``, ``decimal128_to_ints``).  A value is four 32-bit
limbs, little-endian, in two's complement: int32 ``[n, 4]`` here, the JAX
package's uint32 ``[n, 4]`` bit for bit.  The checked arithmetic of that
module waits for a later slice (``ROADMAP.md`` queue 1, item 7).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from spark_rapids_jni_tpu_torch.table import Column, decimal128

__all__ = ["decimal128", "decimal128_from_ints", "decimal128_to_ints"]


def decimal128_from_ints(unscaled: Sequence[int], scale: int = 0,
                         valid=None, device=None) -> Column:
    """A decimal128 column from Python unscaled ints (taken mod 2^128);
    ``valid`` is a bool sequence (None: all valid)."""
    two = [v & ((1 << 128) - 1) for v in unscaled]
    limbs = np.array([[(t >> (32 * k)) & 0xFFFFFFFF for k in range(4)]
                      for t in two], np.uint32).reshape(len(two), 4)
    return Column.from_numpy(limbs, decimal128(scale), valid, device)


def decimal128_to_ints(col: Column) -> List[Optional[int]]:
    """Unscaled Python ints, None for a null row."""
    limbs = col.to_numpy()
    valid = col.valid_bools().cpu().numpy()
    out = []
    for row, ok in zip(limbs, valid):
        if not ok:
            out.append(None)
            continue
        two = sum(int(x) << (32 * k) for k, x in enumerate(row))
        out.append(two - (1 << 128) if two >> 127 else two)
    return out
