"""decimal128 columns: DECIMAL(38, s) values to and from Python ints, and
Spark's checked decimal arithmetic and rendering.

The PyTorch counterpart of ``spark_rapids_jni_tpu.ops.decimal``: the
constructors (``decimal128``, ``decimal128_from_ints``,
``decimal128_to_ints``), the checked add, subtract, multiply, divide and
rescale, each returning the result column and a per-row overflow mask
(overflow rows are null; an ANSI caller raises on the mask), and
``CAST(decimal AS STRING)``.  A value is four 32-bit limbs, little-endian,
in two's complement: int32 ``[n, 4]`` here, the JAX package's uint32 ``[n,
4]`` bit for bit.  The limb arithmetic holds each 32-bit limb as a
non-negative int64 (``[n, L]``), so that carries and borrows are plain
comparisons.  Every function runs on the device its columns are on.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.table import (
    STRING, Column, decimal128, pack_bools,
)

__all__ = ["add_decimal128", "cast_decimal128_to_string", "decimal128",
           "decimal128_from_ints", "decimal128_to_ints",
           "decimal128_to_strings", "div_decimal128", "mul_decimal128",
           "rescale_decimal128", "sub_decimal128"]

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


def _div_pow10(num: torch.Tensor, k, k_max: int) -> torch.Tensor:
    """Unsigned ``num // 10^k`` over ``[n, L]`` limbs, exact: short
    divisions by at most ``10^9`` each (a remainder under ``2^30`` and a
    limb make under ``2^62``), ``k`` an int or an int ``[n]`` tensor in
    ``[0, k_max]``.  The quotient :func:`_divmod_limbs` gives for a power of
    ten, in ``ceil(k_max / 9) * L`` steps instead of a step a bit."""
    if isinstance(k, torch.Tensor):
        k = k.to(torch.int64)
        p10 = torch.tensor([10 ** e for e in range(10)], dtype=torch.int64,
                           device=k.device)
    for done in range(0, k_max, 9):
        if isinstance(k, torch.Tensor):
            d = p10[(k - done).clamp(0, 9)]
        else:
            d = 10 ** min(max(k - done, 0), 9)
        rem = torch.zeros_like(num[:, 0])
        outs = []
        for j in range(num.shape[1] - 1, -1, -1):
            cur = (rem << 32) | num[:, j]
            q = cur // d
            rem = cur - q * d
            outs.append(q)
        num = torch.stack(outs[::-1], dim=1)
    return num


def _limbs(col: Column) -> torch.Tensor:
    """A decimal128 column's limbs as int64 ``[n, 4]`` in ``[0, 2^32)``."""
    return col.data.to(torch.int64) & _M32


def _data(limbs: torch.Tensor) -> torch.Tensor:
    """int64 limbs in ``[0, 2^32)`` as a decimal128 column's int32 data,
    the same bits."""
    return ((limbs ^ 0x80000000) - 0x80000000).to(torch.int32)


def _check_scales(a: Column, b: Column) -> int:
    if a.dtype.kind != "decimal128" or b.dtype.kind != "decimal128":
        raise ValueError("decimal128 operands required")
    if a.dtype.scale != b.dtype.scale:
        raise ValueError("operands must share a scale (rescale upstream)")
    return a.dtype.scale


def add_decimal128(a: Column, b: Column):
    """Checked ``a + b`` at their common scale.  Returns ``(sum column,
    overflow mask)``; overflow rows (a wrapped sum, or a magnitude past 38
    digits) are null."""
    scale = _check_scales(a, b)
    la, lb = _limbs(a), _limbs(b)
    s = _add_limbs(la, lb)
    na, nb, ns = _is_negative(la), _is_negative(lb), _is_negative(s)
    mag, _ = _abs_limbs(s)
    overflow = ((na == nb) & (na != ns)) | _gt_limbs_const(mag, _BOUND_LIMBS)
    both = a.valid_bools() & b.valid_bools()
    return (Column(decimal128(scale), _data(s), pack_bools(both & ~overflow)),
            overflow & both)


def sub_decimal128(a: Column, b: Column):
    """Checked ``a - b``: ``a + (-b)``, as :func:`add_decimal128`."""
    _check_scales(a, b)
    return add_decimal128(a, Column(b.dtype, _data(_neg_limbs(_limbs(b))),
                                    b.validity))


def rescale_decimal128(col: Column, new_scale: int):
    """The column at ``new_scale``, Spark's ``changePrecision``: scaling up
    multiplies the unscaled value by ``10^d`` (overflow-checked), scaling
    down divides it by ``10^d`` rounding HALF_UP on the magnitude.  Returns
    ``(column, overflow mask)``; overflow rows are null."""
    if col.dtype.kind != "decimal128":
        raise ValueError("decimal128 operand required")
    n = col.data.shape[0]
    d = new_scale - col.dtype.scale
    if d == 0:
        return (Column(decimal128(new_scale), col.data, col.validity),
                torch.zeros(n, dtype=torch.bool, device=col.device))
    mag, neg = _abs_limbs(_limbs(col))
    if d > MAX_PRECISION:
        res = torch.zeros_like(mag)
        overflow = (mag != 0).any(dim=1)
    elif d > 0:
        wide = _mul_limbs_wide(mag, _const_limbs(_pow10_limbs(d, 4), n,
                                                 col.device))
        res = wide[:, :4]
        overflow = (wide[:, 4:] != 0).any(dim=1) \
            | _gt_limbs_const(res, _BOUND_LIMBS)
    elif -d > MAX_PRECISION:
        # a magnitude under 10^38 is under half of 10^k: it rounds to zero
        res = torch.zeros_like(mag)
        overflow = torch.zeros(n, dtype=torch.bool, device=col.device)
    else:
        # HALF_UP: (m + 10^k / 2) // 10^k over five limbs
        k = -d
        half = 5 * 10 ** (k - 1)
        num5 = _add_limbs(torch.cat([mag, torch.zeros_like(mag[:, :1])],
                                    dim=1),
                          _const_limbs(tuple((half >> (32 * j)) & _M32
                                             for j in range(5)), n,
                                       col.device))
        res = _div_pow10(num5, k, k)[:, :4]
        overflow = torch.zeros(n, dtype=torch.bool, device=col.device)
    signed = torch.where(neg[:, None], _neg_limbs(res), res)
    valid = col.valid_bools()
    return (Column(decimal128(new_scale), _data(signed),
                   pack_bools(valid & ~overflow)), overflow & valid)


def mul_decimal128(a: Column, b: Column):
    """Checked ``a * b``: the exact 256-bit product at scale ``sa + sb``
    (rescaling to an output type is a separate step).  Returns ``(product
    column, overflow mask)``; a magnitude past 38 digits overflows."""
    if a.dtype.kind != "decimal128" or b.dtype.kind != "decimal128":
        raise ValueError("decimal128 operands required")
    aa, na = _abs_limbs(_limbs(a))
    bb, nb = _abs_limbs(_limbs(b))
    wide = _mul_limbs_wide(aa, bb)
    lo = wide[:, :4]
    overflow = (wide[:, 4:] != 0).any(dim=1) | _gt_limbs_const(lo,
                                                                _BOUND_LIMBS)
    signed = torch.where((na != nb)[:, None], _neg_limbs(lo), lo)
    both = a.valid_bools() & b.valid_bools()
    return (Column(decimal128(a.dtype.scale + b.dtype.scale), _data(signed),
                   pack_bools(both & ~overflow)), overflow & both)


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
    return (Column(decimal128(result_scale), _data(signed),
                   pack_bools(both & ~overflow)),
            overflow & both)


def decimal128_to_strings(col: Column) -> List[Optional[str]]:
    """Fixed-point strings at the column's scale on the host (Spark's
    ``Decimal.toString``), None for a null row."""
    scale = col.dtype.scale
    out = []
    for v in decimal128_to_ints(col):
        if v is None:
            out.append(None)
            continue
        sign = "-" if v < 0 else ""
        m = abs(v)
        if scale <= 0:
            out.append(sign + str(m * 10 ** (-scale)))
            continue
        s = str(m).rjust(scale + 1, "0")
        out.append(f"{sign}{s[:-scale]}.{s[-scale:]}")
    return out


# 2^128 - 1 has 39 decimal digits
_DEC_MAX_DIGITS = 39


def _dec128_digits(data: torch.Tensor):
    """int64 ``[n, 4]`` limbs -> (digits int64 ``[n, 39]`` of the
    magnitude, most significant first; digit count, at least 1;
    negative): five short divisions by ``10^9``, each remainder split into
    its nine digits."""
    mag, neg = _abs_limbs(data)
    chunks = []
    for _ in range(5):
        rem = torch.zeros_like(mag[:, 0])
        outs = []
        for j in range(3, -1, -1):
            cur = (rem << 32) | mag[:, j]
            q = cur // 10 ** 9
            rem = cur - q * 10 ** 9
            outs.append(q)
        mag = torch.stack(outs[::-1], dim=1)
        chunks.append(rem)
    p10 = torch.tensor([10 ** e for e in range(8, -1, -1)],
                       dtype=torch.int64, device=data.device)
    digits = torch.cat([(c[:, None] // p10) % 10 for c in chunks[::-1]],
                       dim=1)[:, 45 - _DEC_MAX_DIGITS:]
    nz = digits != 0
    ndig = torch.where(nz.any(dim=1),
                       _DEC_MAX_DIGITS - nz.to(torch.uint8).argmax(dim=1),
                       1)
    return digits, ndig, neg


def _dec128_format(digits, ndig, neg, scale: int, trail_zeros: int):
    """Fixed-point rendering at ``scale`` >= 0 (exactly ``scale`` fraction
    digits, at least one integer digit), ``trail_zeros`` zeros appended for
    a negative scale (the unscaled value times ``10^k`` written exactly, no
    128-bit multiply).  Returns (chars uint8 ``[n, 42 + trail_zeros]``,
    lengths int64)."""
    MD = _DEC_MAX_DIGITS
    dev = digits.device
    is_zero = (ndig == 1) & (digits[:, MD - 1] == 0)
    tz = torch.where(is_zero, 0, trail_zeros)       # 0 * 10^k is "0"
    ndig = ndig + tz
    eff = ndig.clamp(min=scale + 1)                  # zero-padded to scale+1
    int_len = eff - scale
    W = MD + 3 + trail_zeros                         # sign, dot, zeros
    base = neg.to(torch.int64)
    pos = torch.arange(W, device=dev)[None, :]
    idx = pos - base[:, None]
    in_int = (idx >= 0) & (idx < int_len[:, None])
    dot_at = (idx == int_len[:, None]) & (scale > 0)
    fidx = idx - int_len[:, None] - 1
    in_frac = (fidx >= 0) & (fidx < scale) & (scale > 0)
    # logical digit p of [0, eff) is digits column MD - eff + p (+ tz)
    p = torch.where(in_int, idx, int_len[:, None] + fidx)
    k = MD - eff[:, None] + p + tz[:, None]
    dig = torch.gather(digits, 1, k.clamp(0, MD - 1))
    dig = torch.where((k >= 0) & (k < MD), dig, 0) + ord("0")
    mat = torch.where(in_int | in_frac, dig,
                      torch.where(dot_at, ord("."), 0))
    mat = torch.where((pos == 0) & neg[:, None], ord("-"), mat)
    length = base + int_len + (1 + scale if scale > 0 else 0)
    mat = torch.where(pos < length[:, None], mat, 0)
    return mat.to(torch.uint8), length


def _padded_string_result(mat: torch.Tensor, lens: torch.Tensor,
                         valid: torch.Tensor, validity) -> Column:
    """A dense-padded STRING result shaped like the JAX package's: chars
    zeroed under null rows, lengths zero there, offsets their running sum
    from 0, and ``validity`` as given; the char matrix is widened with
    zero columns to a multiple of 4 bytes, the port's padded width."""
    W = mat.shape[1]
    mat = torch.where(valid[:, None], mat, 0)
    mat = torch.nn.functional.pad(mat, (0, -W % 4))
    lens = torch.where(valid, lens, 0).to(torch.int32)
    offsets = torch.zeros(lens.shape[0] + 1, dtype=torch.int32,
                          device=lens.device)
    torch.cumsum(lens, 0, out=offsets[1:])
    return Column(STRING, torch.empty(0, dtype=torch.uint8,
                                      device=mat.device),
                  validity, mat, lens, offsets)


def cast_decimal128_to_string(col: Column) -> Column:
    """``CAST(decimal128 AS STRING)`` on the column's device: Spark's
    ``Decimal.toString`` at the column's scale (``1.20`` keeps its trailing
    zero, at least one integer digit; a negative scale writes the digits
    and ``-scale`` zeros).  The result is dense-padded."""
    if col.dtype.kind != "decimal128":
        raise ValueError("cast_decimal128_to_string needs decimal128")
    scale = col.dtype.scale
    digits, ndig, neg = _dec128_digits(_limbs(col))
    mat, lens = _dec128_format(digits, ndig, neg, max(scale, 0),
                               -scale if scale < 0 else 0)
    return _padded_string_result(mat, lens, col.valid_bools(), col.validity)
