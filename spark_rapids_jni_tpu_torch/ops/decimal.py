"""decimal128 columns: DECIMAL(38, s) values to and from Python ints, and
Spark's decimal division.

The PyTorch counterpart of the constructors of
``spark_rapids_jni_tpu.ops.decimal`` (``decimal128``,
``decimal128_from_ints``, ``decimal128_to_ints``) and of its
``div_decimal128`` with the limb helpers that calls.  A value is four
32-bit limbs, little-endian, in two's complement: int32 ``[n, 4]`` here, the
JAX package's uint32 ``[n, 4]`` bit for bit.  The limb arithmetic holds
each 32-bit limb as a non-negative int64 (``[n, L]``), so that carries and
borrows are plain comparisons.  The rest of the checked arithmetic (add,
subtract, rescale, strings) waits for a later slice (``ROADMAP.md`` queue
1, item 7).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.table import Column, decimal128, pack_bools

__all__ = ["decimal128", "decimal128_from_ints", "decimal128_to_ints",
           "div_decimal128"]

MAX_PRECISION = 38
# 10^38 - 1, the +/- bound of DECIMAL(38) magnitudes, as 4 LE 32-bit limbs
_BOUND = 10 ** 38 - 1
_BOUND_LIMBS = tuple((_BOUND >> (32 * k)) & 0xFFFFFFFF for k in range(4))
_M32 = 0xFFFFFFFF


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


# ---------------------------------------------------------------------------
# limb primitives (int64 [n, L], each entry a 32-bit limb in [0, 2^32))
# ---------------------------------------------------------------------------

def _add_limbs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two's-complement add over matching limb counts (mod 2^(32L))."""
    outs = []
    carry = torch.zeros_like(a[:, 0])
    for k in range(a.shape[1]):
        s = a[:, k] + b[:, k] + carry
        outs.append(s & _M32)
        carry = s >> 32
    return torch.stack(outs, dim=1)


def _neg_limbs(a: torch.Tensor) -> torch.Tensor:
    one = torch.zeros_like(a)
    one[:, 0] = 1
    return _add_limbs(a ^ _M32, one)


def _is_negative(a: torch.Tensor) -> torch.Tensor:
    return (a[:, -1] >> 31) == 1


def _abs_limbs(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    neg = _is_negative(a)
    return torch.where(neg[:, None], _neg_limbs(a), a), neg


def _gt_limbs_const(a: torch.Tensor, bound: Tuple[int, ...]) -> torch.Tensor:
    """Unsigned a > bound, comparing from the most significant limb."""
    gt = torch.zeros_like(a[:, 0], dtype=torch.bool)
    decided = torch.zeros_like(gt)
    for k in range(a.shape[1] - 1, -1, -1):
        bk = bound[k] if k < len(bound) else 0
        gt = gt | (~decided & (a[:, k] > bk))
        decided = decided | (a[:, k] != bk)
    return gt


def _sub_limbs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a - b over matching limb counts (mod 2^(32L))."""
    outs = []
    borrow = torch.zeros_like(a[:, 0])
    for k in range(a.shape[1]):
        d = a[:, k] - b[:, k] - borrow
        outs.append(d & _M32)
        borrow = (d < 0).to(torch.int64)
    return torch.stack(outs, dim=1)


def _geq_limbs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a >= b (same limb count), most significant limb first."""
    ge = torch.ones_like(a[:, 0], dtype=torch.bool)
    decided = torch.zeros_like(ge)
    for k in range(a.shape[1] - 1, -1, -1):
        differ = a[:, k] != b[:, k]
        ge = torch.where(~decided & differ, a[:, k] > b[:, k], ge)
        decided = decided | differ
    return ge


def _divmod_limbs(num: torch.Tensor, den: torch.Tensor,
                  num_bits: Optional[int] = None):
    """Unsigned long division ``[n, Ln] // [n, Ld]``: restoring binary
    division, most significant bit first, ``num_bits`` steps of tensor ops
    over every row.  A zero divisor is undefined (every trial subtraction
    succeeds): callers substitute a nonzero one first, as
    :func:`div_decimal128` does.  Returns ``(quot [n, Ln], rem [n,
    Ld])``."""
    n, Ln = num.shape
    Ld = den.shape[1]
    bits = num_bits if num_bits is not None else 32 * Ln
    den_ext = torch.cat([den, torch.zeros_like(den[:, :1])], dim=1)
    q = torch.zeros_like(num)
    rem = torch.zeros_like(den_ext)
    for i in range(bits - 1, -1, -1):
        limb, sh = i // 32, i % 32
        bit = (num[:, limb] >> sh) & 1
        # rem = (rem << 1) | bit
        up = rem >> 31
        rem = (rem << 1) & _M32
        rem[:, 1:] |= up[:, :-1]
        rem[:, 0] |= bit
        ge = _geq_limbs(rem, den_ext)
        rem = torch.where(ge[:, None], _sub_limbs(rem, den_ext), rem)
        q[:, limb] |= ge.to(torch.int64) << sh
    return q, rem[:, :Ld]


def _pow10_limbs(k: int, L: int) -> Tuple[int, ...]:
    v = 10 ** k
    return tuple((v >> (32 * j)) & _M32 for j in range(L))


def _const_limbs(limbs: Tuple[int, ...], n: int, device) -> torch.Tensor:
    return torch.tensor(limbs, dtype=torch.int64,
                        device=device).expand(n, len(limbs))


def _mul_limbs_wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned ``[n, 4] x [n, 4]`` -> the exact ``[n, 8]`` product, from
    16-bit half-limb products (each exact in int64) summed into 16
    half-limb columns and carried."""
    av = [h for k in range(4) for h in (a[:, k] & 0xFFFF, a[:, k] >> 16)]
    bv = [h for k in range(4) for h in (b[:, k] & 0xFFFF, b[:, k] >> 16)]
    halves = [torch.zeros_like(a[:, 0]) for _ in range(17)]
    for i in range(8):
        for j in range(8):
            p = av[i] * bv[j]
            halves[i + j] = halves[i + j] + (p & 0xFFFF)
            halves[i + j + 1] = halves[i + j + 1] + (p >> 16)
    out, carry = [], 0
    for h in halves[:16]:
        t = h + carry
        out.append(t & 0xFFFF)
        carry = t >> 16
    return torch.stack([out[2 * k] | (out[2 * k + 1] << 16)
                        for k in range(8)], dim=1)


def _limbs(col: Column) -> torch.Tensor:
    """A decimal128 column's limbs as int64 ``[n, 4]`` in ``[0, 2^32)``."""
    return col.data.to(torch.int64) & _M32


def div_decimal128(a: Column, b: Column, result_scale: int = 6):
    """Checked ``a / b`` with Spark's divide semantics: the quotient exact
    at ``result_scale``, rounded HALF_UP on the magnitude.  Division by
    zero and a magnitude past 38 digits set the overflow mask and null the
    row (the caller raises under ANSI).  Needs ``result_scale - a.scale +
    b.scale`` in ``[0, 38]``.  Returns ``(quotient column, overflow
    mask)``."""
    if a.dtype.kind != "decimal128" or b.dtype.kind != "decimal128":
        raise ValueError("decimal128 operands required")
    e = result_scale - a.dtype.scale + b.dtype.scale
    if not 0 <= e <= MAX_PRECISION:
        raise ValueError(
            f"unsupported scale shift {e} (result_scale {result_scale} "
            f"with operand scales {a.dtype.scale}, {b.dtype.scale})")
    n = a.data.shape[0]
    dev = a.data.device
    aa, na = _abs_limbs(_limbs(a))
    bb, nb = _abs_limbs(_limbs(b))
    div_zero = (bb == 0).all(dim=1)
    # numerator = |a| * 10^e exactly (<= 10^76 < 2^256)
    num8 = _mul_limbs_wide(aa, _const_limbs(_pow10_limbs(e, 4), n, dev))
    one4 = _const_limbs((1, 0, 0, 0), n, dev)
    safe_den = torch.where(div_zero[:, None], one4, bb)
    q8, rem = _divmod_limbs(num8, safe_den, num_bits=256)
    # HALF_UP: away from zero when 2 * rem >= divisor
    zero1 = torch.zeros_like(rem[:, :1])
    rem5 = torch.cat([rem, zero1], dim=1)
    round_up = _geq_limbs(_add_limbs(rem5, rem5),
                          torch.cat([safe_den, zero1], dim=1))
    one8 = _const_limbs((1,) + (0,) * 7, n, dev)
    q8 = torch.where(round_up[:, None], _add_limbs(q8, one8), q8)
    overflow = div_zero | (q8[:, 4:] != 0).any(dim=1) \
        | _gt_limbs_const(q8[:, :4], _BOUND_LIMBS)
    neg = na != nb
    signed = torch.where(neg[:, None], _neg_limbs(q8[:, :4]), q8[:, :4])
    both = a.valid_bools() & b.valid_bools()
    return (Column(decimal128(result_scale), signed.to(torch.int32),
                   pack_bools(both & ~overflow)),
            overflow & both)
