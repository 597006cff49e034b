"""Spark's ``CAST`` between strings and numbers, dates and timestamps.

The PyTorch counterpart of ``spark_rapids_jni_tpu.ops.cast_string``, with
its results bit for bit (values, validity, error masks, string bytes):

- string -> INT8/16/32/64, FLOAT32/64, DECIMAL(38, s), DATE, TIMESTAMP:
  leading and trailing ASCII <= 0x20 trimmed (``UTF8String.trimAll``), the
  body parsed with Spark's grammar; invalid or overflowing rows are null,
  and the returned error mask marks the non-null inputs that became null.
  With ``ansi=True`` a marked row raises ``ValueError`` (Spark's ANSI
  ``CAST`` exception).
- INT8/16/32/64 -> string (Arrow layout), DATE and TIMESTAMP -> string
  (dense-padded; years outside 1..9999 are null).

Each string's bytes are read through fixed windows: its first and last
``TRIM_WIDTH`` bytes measure the whitespace, and the first bytes of the
trimmed body (``PARSE_WIDTH`` and the like) are parsed as ``[n, W]``
tensors on the column's device.  A row the windows cannot decide (more
whitespace than a trim window, a body longer than its parse window, a hex
float literal) is punted to an exact host parse of its bytes, as the JAX
package does; one scalar read tells whether any row punted.  The float cast
checks the grammar on the device and converts the valid windows on the host
in one numpy ``astype`` (the JAX package's own host boundary), then moves
the result back to the column's device.

Every entry point takes ``device``: ``None`` means the CUDA card, and with
no card the call raises unless the caller names the CPU.  The JAX
package's shape-bucket wrapper and its spans are not ported
(``ROADMAP.md`` queue 1, items 8 and 13).
"""

from __future__ import annotations

import re
import struct
from fractions import Fraction
from typing import Callable, List, Tuple

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.ops.decimal import (
    _BOUND_LIMBS, _add_limbs, _data, _div_pow10, _gt_limbs_const,
    _mul_limbs_wide, _neg_limbs, _padded_string_result, _pow10_limbs,
    decimal128,
)
from spark_rapids_jni_tpu_torch.table import (
    DATE32, STRING, TIMESTAMP64, Column, DType, chars_window_at, pack_bools,
    resolve_device,
)

__all__ = ["cast_date_to_string", "cast_int_to_string", "cast_string_to_date",
           "cast_string_to_decimal128", "cast_string_to_float",
           "cast_string_to_int", "cast_string_to_timestamp",
           "cast_timestamp_to_string"]

# the whitespace windows at each end, and the integer body's window (a
# body past it, such as 14 leading zeros on a 19-digit value, punts)
PARSE_WIDTH = 32
TRIM_WIDTH = 32

_INT_BOUNDS = {  # byte width -> positive-magnitude bound 2**(bits-1) - 1
    1: (1 << 7) - 1,
    2: (1 << 15) - 1,
    4: (1 << 31) - 1,
    8: (1 << 63) - 1,
}
_I32 = torch.int32


def _limb_const(value: int) -> Tuple[int, int, int, int]:
    return tuple((value >> (16 * k)) & 0xFFFF for k in range(4))


def _pos(width: int, device) -> torch.Tensor:
    return torch.arange(width, dtype=_I32, device=device)[None, :]


def _col(t: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """``t[r, j[r]]`` for every row ``r``."""
    return torch.gather(t, 1, j.to(torch.int64)[:, None])[:, 0]


def _leading_true(mask: torch.Tensor) -> torch.Tensor:
    """int32 ``[n]``: the run of True at the start of each row."""
    off = ~mask
    return torch.where(off.any(dim=1), off.to(torch.uint8).argmax(dim=1),
                       mask.shape[1]).to(_I32)


# ---------------------------------------------------------------------------
# the shared windows: whitespace trim, then the trimmed body
# ---------------------------------------------------------------------------

def _trim_bounds(col: Column, width: int):
    """Leading and trailing whitespace runs (ASCII <= 0x20) measured in
    head and tail windows of ``width`` bytes.  Returns (lead, trail,
    bounded): ``bounded`` is False where a run fills its whole window with
    string left over, so that its true length is unknown."""
    starts, ends = col.offsets[:-1], col.offsets[1:]
    lens = ends - starts
    pos = _pos(width, lens.device)
    head = chars_window_at(col.chars, starts, lens, width)
    lead = _leading_true((head <= 0x20) & (pos < lens[:, None]))
    tail_len = lens.clamp(max=width)
    tail = chars_window_at(col.chars, torch.maximum(ends - width, starts),
                           tail_len, width)
    # slots past a short string's end count as whitespace, so that the run
    # reaches its chars; the pad is taken back out
    tail_ws = torch.where(pos < tail_len[:, None], tail <= 0x20, True)
    trail = (_leading_true(tail_ws.flip(1)) - (width - tail_len)).clamp(min=0)
    bounded = ~(((lead == width) | (trail == width)) & (lens > width))
    # overlapping windows count the whitespace of a short all-whitespace
    # string twice: clamped, the body is empty
    return lead, torch.minimum(trail, lens - torch.minimum(lead, lens)), \
        bounded


def _trimmed(col: Column, width: int):
    """The trimmed body's first ``width`` bytes (uint8 ``[n, width]``, zero
    past its length), its length, and whether the trim was bounded."""
    lead, trail, bounded = _trim_bounds(col, TRIM_WIDTH)
    tlen = (col.str_lens() - lead - trail).clamp(min=0)
    ch = chars_window_at(col.chars, col.offsets[:-1] + lead, tlen, width)
    return ch, tlen, bounded


def _arrow_on(col: Column, device, name: str) -> Column:
    """A string column in Arrow layout on the resolved device (a
    dense-padded one converted there)."""
    if not col.dtype.is_string:
        raise ValueError(f"{name} needs a string column")
    return col.to(resolve_device(device)).to_arrow()


def _host_rows(col: Column, rows: torch.Tensor) -> List[bytes]:
    """The bytes of the given rows of an Arrow column, in one copy to the
    host."""
    starts = col.offsets[rows].to(torch.int64)
    lens = col.offsets[rows + 1].to(torch.int64) - starts
    lens_h = lens.cpu().numpy()
    total = int(lens_h.sum())
    rep = torch.repeat_interleave(torch.arange(len(rows), device=rows.device),
                                  lens, output_size=total)
    first = torch.cumsum(lens, 0) - lens
    idx = starts[rep] + torch.arange(total, device=rows.device) - first[rep]
    flat = col.chars[idx].cpu().numpy().tobytes()
    out, at = [], 0
    for ln in lens_h.tolist():
        out.append(flat[at:at + ln])
        at += ln
    return out


def _patch_punts(col: Column, punted: torch.Tensor, data: torch.Tensor,
                 ok: torch.Tensor, host_fn: Callable):
    """The exact host parse of each punted row patched into ``data`` and
    ``ok`` (``host_fn`` gives the row's value, or None for null); one
    scalar read when no row punted."""
    if not bool(punted.any()):
        return data, ok
    rows = torch.nonzero(punted)[:, 0]
    vals = [host_fn(raw) for raw in _host_rows(col, rows)]
    good = [v is not None for v in vals]
    data, ok = data.clone(), ok.clone()
    ok[rows] = torch.tensor(good, device=ok.device)
    keep = rows[torch.tensor(good, device=rows.device)]
    if len(keep):
        new = [v for v in vals if v is not None]
        if data.dim() == 2:         # decimal128: four 32-bit limbs
            two = [v & ((1 << 128) - 1) for v in new]
            new = [[(t >> (32 * k)) & 0xFFFFFFFF for k in range(4)]
                   for t in two]
            data[keep] = _data(torch.tensor(new, dtype=torch.int64,
                                            device=data.device))
        else:
            data[keep] = torch.tensor(new, dtype=data.dtype,
                                      device=data.device)
    return data, ok


def _ansi_check(error: torch.Tensor, what: str = "value(s)"):
    if bool(error.any()):
        raise ValueError(
            f"ANSI cast failure: {int(error.sum())} invalid {what}, "
            f"first at row {int(error.to(torch.uint8).argmax())}")


# ---------------------------------------------------------------------------
# string -> int
# ---------------------------------------------------------------------------

def _parse_int_magnitude(ch: torch.Tensor, tlen: torch.Tensor):
    """Sign, digits and one dot from the trimmed window.  Returns (the
    integer part's magnitude as four 16-bit limbs, int64 ``[n, 4]``;
    negative; valid; overflow past 64 bits)."""
    n, width = ch.shape
    pos = _pos(width, ch.device)
    in_str = pos < tlen[:, None]
    first = ch[:, 0]
    has_sign = (first == ord("+")) | (first == ord("-"))
    negative = first == ord("-")
    start = has_sign.to(_I32)
    is_digit = (ch >= ord("0")) & (ch <= ord("9")) & in_str
    is_dot = (ch == ord(".")) & in_str
    body = pos >= start[:, None]
    dot_pos = torch.where(is_dot, pos, width).amin(dim=1)
    int_part = body & (pos < dot_pos[:, None]) & in_str
    frac_part = body & (pos > dot_pos[:, None]) & in_str
    # the body is digits and at most one dot, a digit somewhere, the
    # fraction all digits, and it fits the window
    valid = torch.where(int_part | frac_part, is_digit, True).all(dim=1) \
        & (is_dot.sum(dim=1) <= 1) & is_digit.any(dim=1) & (tlen > start) \
        & (tlen <= width)
    digits = ch.to(torch.int64) - ord("0")
    limbs = [torch.zeros(n, dtype=torch.int64, device=ch.device)
             for _ in range(4)]
    overflow = torch.zeros(n, dtype=torch.bool, device=ch.device)
    for j in range(width):
        use = int_part[:, j] & is_digit[:, j]
        carry = torch.where(use, digits[:, j], 0)
        mul = torch.where(use, 10, 1)
        for k in range(4):
            t = limbs[k] * mul + carry
            limbs[k] = t & 0xFFFF
            carry = t >> 16
        overflow = overflow | (carry != 0)
    return torch.stack(limbs, dim=1), negative, valid, overflow


def _magnitude_gt(limbs: torch.Tensor, bound: int) -> torch.Tensor:
    """The 16-bit-limb magnitude > ``bound``, exactly."""
    bl = _limb_const(bound)
    gt = torch.zeros_like(limbs[:, 0], dtype=torch.bool)
    eq = torch.ones_like(gt)
    for k in (3, 2, 1, 0):
        gt = gt | (eq & (limbs[:, k] > bl[k]))
        eq = eq & (limbs[:, k] == bl[k])
    return gt


def _cast_int(col: Column, itemsize: int):
    """The device pass of :func:`cast_string_to_int`: (data, ok, punted)."""
    ch, tlen, bounded = _trimmed(col, PARSE_WIDTH)
    limbs, negative, valid, overflow = _parse_int_magnitude(ch, tlen)
    punted = ~bounded | (tlen > PARSE_WIDTH)
    bound = _INT_BOUNDS[itemsize]
    overflow = overflow | torch.where(negative,
                                      _magnitude_gt(limbs, bound + 1),
                                      _magnitude_gt(limbs, bound))
    ok = valid & bounded & ~overflow
    # the 64-bit two's complement from the limbs, as two 32-bit halves
    lo = limbs[:, 0] | (limbs[:, 1] << 16)
    hi = limbs[:, 2] | (limbs[:, 3] << 16)
    neg_lo = (-lo) & 0xFFFFFFFF
    neg_hi = ((hi ^ 0xFFFFFFFF) + (lo == 0).to(torch.int64)) & 0xFFFFFFFF
    lo = torch.where(negative, neg_lo, lo)
    hi = torch.where(negative, neg_hi, hi)
    if itemsize == 8:
        data = ((hi ^ 0x80000000) - 0x80000000) * (1 << 32) + lo
    else:
        bits = 8 * itemsize
        sign = 1 << (bits - 1)
        data = (((lo & ((1 << bits) - 1)) ^ sign) - sign).to(
            getattr(torch, f"int{bits}"))
    return data, ok, punted


def _trim_bytes(raw: bytes) -> bytes:
    """``raw`` without its leading and trailing ASCII <= 0x20."""
    i, j = 0, len(raw)
    while i < j and raw[i] <= 0x20:
        i += 1
    while j > i and raw[j - 1] <= 0x20:
        j -= 1
    return raw[i:j]


def _host_parse_punted(raw: bytes, itemsize: int):
    """Spark's integer cast of a punted row's bytes, unbounded (the grammar
    of :func:`_parse_int_magnitude`): the value, or None for null."""
    body = _trim_bytes(raw)
    if not body:
        return None
    neg = body[:1] == b"-"
    if body[:1] in (b"+", b"-"):
        body = body[1:]
    dot = body.find(b".")
    if dot >= 0:
        ipart, frac = body[:dot], body[dot + 1:]
        if b"." in frac:
            return None
    else:
        ipart, frac = body, b""
    if (ipart and not ipart.isdigit()) or (frac and not frac.isdigit()):
        return None
    if not (ipart + frac):
        return None
    mag = int(ipart) if ipart else 0
    bound = _INT_BOUNDS[itemsize]
    if mag > (bound + 1 if neg else bound):
        return None
    return -mag if neg else mag


def cast_string_to_int(col: Column, dtype: DType, *, ansi: bool = False,
                       device=None) -> Tuple[Column, torch.Tensor]:
    """``CAST(string AS <int type>)``: an optional sign, digits and an
    optional fraction of digits, which truncates (``'1.9'`` is 1,
    ``'1.x'`` null).  Returns ``(column, error mask)``."""
    col = _arrow_on(col, device, "cast_string_to_int")
    if dtype.kind not in ("int8", "int16", "int32", "int64"):
        raise ValueError(f"unsupported target dtype {dtype}")
    data, ok, punted = _cast_int(col, dtype.itemsize)
    in_valid = col.valid_bools()
    data, ok = _patch_punts(
        col, punted & in_valid, data, ok,
        lambda raw: _host_parse_punted(raw, dtype.itemsize))
    error = in_valid & ~ok
    if ansi:
        _ansi_check(error)
    return Column(dtype, data, pack_bools(in_valid & ok)), error


# ---------------------------------------------------------------------------
# string -> float
# ---------------------------------------------------------------------------

FLOAT_PARSE_WIDTH = 32


def _float_grammar(col: Column, width: int):
    """The device pass of :func:`cast_string_to_float`: Spark's float
    grammar ``[sign] (digits[.digits] | .digits) [eE[sign]digits] [fFdD]``
    over the trimmed window, and its special literals by Spark's two
    stages: Java's ``Float.parseFloat`` (case-sensitive ``[+-]?NaN`` and
    ``[+-]?Infinity``), then ``processFloatingPointSpecialLiterals`` on the
    lowercased trim (inf and infinity in any case with an optional sign,
    nan in any case only unsigned).  Hex literals (``0x1p3``) punt.
    Returns (window, trimmed length, valid, special class: 0 finite, 1
    inf, 2 -inf, 3 nan; f/d suffix, punted)."""
    ch, tlen, bounded = _trimmed(col, width)
    n = ch.shape[0]
    dev = ch.device
    pos = _pos(width, dev)
    is_alpha = ((ch >= ord("A")) & (ch <= ord("Z"))) \
        | ((ch >= ord("a")) & (ch <= ord("z")))
    low = torch.where(is_alpha, ch | 0x20, ch)
    none = torch.zeros(n, dtype=torch.bool, device=dev)

    def lit(s, start, mat=low):
        m = ~none
        for j, c in enumerate(s):
            m = m & (mat[:, start + j] == ord(c)) if start + j < width \
                else none
        return m

    first = ch[:, 0]
    has_sign = (first == ord("+")) | (first == ord("-"))
    negative = first == ord("-")
    s0 = has_sign.to(_I32)
    body_len = tlen - s0
    inf3, inf8 = none, none
    nan3 = lit("nan", 0) & (body_len == 3) & ~has_sign
    for st in (0, 1):
        sel = s0 == st
        inf3 = inf3 | (sel & lit("inf", st) & (body_len == 3))
        inf8 = inf8 | (sel & lit("infinity", st) & (body_len == 8))
        nan3 = nan3 | (sel & lit("NaN", st, ch) & (body_len == 3))
    is_inf = inf3 | inf8
    special_cls = torch.where(nan3, 3, torch.where(
        is_inf & negative, 2, torch.where(is_inf, 1, 0))).to(torch.int8)

    # the grammar of finite rows
    is_digit = (ch >= ord("0")) & (ch <= ord("9"))
    last_ch = _col(ch, (tlen - 1).clamp(0, width - 1)) | 0x20
    has_suffix = ((last_ch == ord("f")) | (last_ch == ord("d"))) & (tlen > 0)
    glen = tlen - has_suffix.to(_I32)
    in_g = pos < glen[:, None]
    is_e = ((ch | 0x20) == ord("e")) & in_g
    e_pos = torch.where(is_e, pos, width).amin(dim=1)
    has_e = e_pos < glen
    is_dot = (ch == ord(".")) & in_g
    dot_pos = torch.where(is_dot, pos, width).amin(dim=1)
    mant_end = torch.where(has_e, e_pos, glen)
    mant = (pos >= s0[:, None]) & (pos < mant_end[:, None]) & in_g
    mant_ok = torch.where(mant, is_digit | is_dot, True).all(dim=1)
    one_dot = is_dot.sum(dim=1) <= 1
    dot_in_mant = (dot_pos >= width) | (dot_pos < mant_end)
    mant_digits = (mant & is_digit).sum(dim=1)
    es = e_pos + 1
    e_first = _col(ch, es.clamp(0, width - 1))
    e_sign = (e_first == ord("+")) | (e_first == ord("-"))
    exp_start = es + e_sign.to(_I32)
    exp_region = (pos >= exp_start[:, None]) & in_g
    exp_ok = torch.where(
        has_e,
        torch.where(exp_region, is_digit, True).all(dim=1)
        & (glen > exp_start), True)
    finite_ok = mant_ok & one_dot & dot_in_mant & (mant_digits > 0) \
        & exp_ok & (glen > s0)
    # Java's parseFloat takes hex literals (0x1.8p1): the host values them
    is_hex = (_col(ch, s0.clamp(0, width - 1)) == ord("0")) \
        & ((_col(ch, (s0 + 1).clamp(0, width - 1)) | 0x20) == ord("x")) \
        & (body_len > 2)
    punted = ~bounded | (tlen > width) | is_hex
    valid = torch.where(special_cls > 0, True, finite_ok) & ~punted
    return ch, tlen, valid, special_cls, has_suffix, punted


def _float_values(w: np.ndarray, finite: np.ndarray, valid: np.ndarray,
                  cls: np.ndarray) -> np.ndarray:
    """The host conversion: float64 values of the ``finite`` rows'
    windows ``w`` (``[finite rows, W]``, zero past each row's grammar) in
    one numpy ``astype``, and the special literals; ``valid`` loses a row
    that numpy cannot read."""
    vals = np.zeros(len(finite), np.float64)
    if finite.any():
        try:
            with np.errstate(over="ignore"):      # Java's parse: +-inf
                vals[finite] = w.view(f"S{w.shape[1]}").reshape(-1) \
                    .astype(np.float64)
        except ValueError:
            # a row that slipped the grammar: row by row
            for i, r in enumerate(np.nonzero(finite)[0]):
                try:
                    vals[r] = float(bytes(w[i]).rstrip(b"\0"))
                except ValueError:
                    valid[r] = False
    vals[cls == 1] = np.inf
    vals[cls == 2] = -np.inf
    vals[cls == 3] = np.nan
    return vals


def _float32_nearest(out: np.ndarray, hazard_rows, raws: List[bytes]):
    """Java's ``Float.parseFloat`` for the rows whose float64 value lies
    within one float64 ulp of a float32 rounding midpoint: the float32
    nearest to the exact decimal (or hex) value, ties to even."""
    cu = np.nextafter(out, np.float32(np.inf))
    cd = np.nextafter(out, np.float32(-np.inf))
    for r, raw in zip(hazard_rows, raws):
        txt = _trim_bytes(raw).decode("ascii", "replace")
        if txt[-1:] in "fFdD":
            txt = txt[:-1]
        try:
            f = _exact_fraction(txt)
        except (ValueError, ZeroDivisionError):
            continue
        best, best_d, best_even = None, None, False
        for cand in (cd[r], out[r], cu[r]):
            if not np.isfinite(cand):
                continue
            d = abs(f - Fraction(float(cand)))
            even = struct.unpack("<I", np.float32(cand).tobytes())[0] & 1 == 0
            if best is None or d < best_d \
                    or (d == best_d and even and not best_even):
                best, best_d, best_even = cand, d, even
        out[r] = best


def _float32_of(vals: np.ndarray, fin: np.ndarray, col: Column):
    """float64 values rounded to float32 as Java's ``Float.parseFloat``
    rounds the text: the float64 value went through one rounding already,
    so where it lies within an ulp of a float32 midpoint the exact value of
    the row's text is rounded instead."""
    out = vals.astype(np.float32)
    fin = np.isfinite(vals) & fin
    o64 = out.astype(np.float64)
    mid_hi = (o64 + np.nextafter(out, np.float32(np.inf))
              .astype(np.float64)) / 2
    mid_lo = (o64 + np.nextafter(out, np.float32(-np.inf))
              .astype(np.float64)) / 2
    ulp = np.spacing(np.abs(vals))
    hazard = fin & np.isfinite(o64) \
        & ((np.abs(vals - mid_hi) <= ulp) | (np.abs(vals - mid_lo) <= ulp))
    if hazard.any():
        rows = np.nonzero(hazard)[0]
        _float32_nearest(out, rows, _host_rows(
            col, torch.from_numpy(rows).to(col.device)))
    return out


def cast_string_to_float(col: Column, dtype: DType, *, ansi: bool = False,
                         device=None) -> Tuple[Column, torch.Tensor]:
    """``CAST(string AS FLOAT/DOUBLE)``: the grammar and special literals
    of :func:`_float_grammar`, checked on the device; the values converted
    on the host (exact strtod, one numpy call), punted rows parsed there
    row by row, FLOAT32 rounded as ``Float.parseFloat`` does.  Returns
    ``(column, error mask)`` on the column's device."""
    col = _arrow_on(col, device, "cast_string_to_float")
    if dtype.kind not in ("float32", "float64"):
        raise ValueError(f"unsupported target dtype {dtype}")
    width = FLOAT_PARSE_WIDTH
    ch, tlen, valid, cls, has_suffix, punted = _float_grammar(col, width)
    in_valid = col.valid_bools()
    finite = valid & (cls == 0) & in_valid
    # zero the bytes past the grammar (the f/d suffix) of the finite rows
    glen = tlen - has_suffix.to(_I32)
    w = torch.where(_pos(width, ch.device) < glen[:, None], ch, 0)[finite]
    finite_np = finite.cpu().numpy()
    valid_np = valid.cpu().numpy().copy()
    cls_np = cls.cpu().numpy()
    in_valid_np = in_valid.cpu().numpy()
    vals = _float_values(w.cpu().numpy(), finite_np, valid_np, cls_np)
    live = punted & in_valid
    if bool(live.any()):
        rows = torch.nonzero(live)[:, 0]
        for r, raw in zip(rows.tolist(), _host_rows(col, rows)):
            v = _host_parse_float(raw)
            valid_np[r] = v is not None
            if v is not None:
                vals[r] = v
    error = in_valid_np & ~valid_np
    if ansi:
        _ansi_check(torch.from_numpy(error))
    if dtype.kind == "float32":
        with np.errstate(over="ignore", invalid="ignore"):
            vals = _float32_of(vals, valid_np & in_valid_np & (cls_np == 0),
                               col)
    dev = col.device
    result_valid = torch.from_numpy(in_valid_np & valid_np).to(dev)
    return (Column(dtype, torch.from_numpy(vals).to(dev),
                   pack_bools(result_valid)),
            torch.from_numpy(error).to(dev))


# Java's hex float literal (Double.parseDouble's grammar): a binary exponent
# is required, and at least one hex digit (the group test below); the one
# pattern serves the parse and the float32 rounding
_JAVA_HEX_RE = re.compile(
    r"([+-]?)0[xX]([0-9a-fA-F]*)\.?([0-9a-fA-F]*)[pP]([+-]?\d+)")


def _java_hex_match(txt: str):
    m = _JAVA_HEX_RE.fullmatch(txt)
    if m and (m.group(2) or m.group(3)):
        return m
    return None


def _exact_fraction(txt: str) -> Fraction:
    """The exact rational value of a decimal or Java hex float literal."""
    m = _java_hex_match(txt)
    if m:
        sign, whole, frac, exp = m.groups()
        v = Fraction(int((whole or "0") + frac, 16), 16 ** len(frac)) \
            * Fraction(2) ** int(exp)
        return -v if sign == "-" else v
    return Fraction(txt)


def _host_parse_float(raw: bytes):
    """The float cast of a punted row's bytes: the value, or None."""
    body = _trim_bytes(raw)
    if not body:
        return None
    low = body.lower()
    sign = -1.0 if low[:1] == b"-" else 1.0
    stripped = low[1:] if low[:1] in (b"+", b"-") else low
    if stripped in (b"inf", b"infinity"):
        return sign * float("inf")
    # nan: any case only unsigned; a signed one needs parseFloat's 'NaN'
    if low == b"nan" or (
            body[1:] if body[:1] in (b"+", b"-") else body) == b"NaN":
        return float("nan")
    if stripped[-1:] in (b"f", b"d"):
        body = body[:-1]
    try:
        txt = body.decode("ascii")
    except UnicodeDecodeError:
        return None
    if _java_hex_match(txt):
        try:
            return float.fromhex(txt)
        except OverflowError:
            # Java overflows to a signed infinity where fromhex raises
            return float("-inf") if txt[:1] == "-" else float("inf")
    if not re.fullmatch(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?", txt):
        return None
    return float(txt)


# ---------------------------------------------------------------------------
# string -> decimal128
# ---------------------------------------------------------------------------

DEC_PARSE_WIDTH = 48  # 38 digits, a sign, a dot and an exponent fit


def _decimal_tables(device):
    """Per-shift constants: ``10^s`` as four limbs for ``s`` in [0, 38] and
    ``10^s / 2`` (the HALF_UP addend) as five for ``s`` in [0, 40]."""
    p4 = torch.tensor([_pow10_limbs(s, 4) for s in range(39)],
                      dtype=torch.int64, device=device)
    halves = [0] + [5 * 10 ** (s - 1) for s in range(1, 41)]
    h5 = torch.tensor([[(h >> (32 * j)) & 0xFFFFFFFF for j in range(5)]
                       for h in halves], dtype=torch.int64, device=device)
    return p4, h5


def _cast_decimal(col: Column, scale: int, width: int):
    """The device pass of :func:`cast_string_to_decimal128`: grammar
    ``[sign] (digits[.digits] | .digits) [eE[sign]digits]``, every mantissa
    digit accumulated into 128 bits exactly, then the value shifted to
    ``scale`` (multiplied, or divided rounding HALF_UP).  Returns (the
    magnitude's limbs int64 ``[n, 4]``, negative, valid, overflow,
    punted)."""
    ch, tlen, bounded = _trimmed(col, width)
    n = ch.shape[0]
    dev = ch.device
    pos = _pos(width, dev)
    in_str = pos < tlen[:, None]
    first = ch[:, 0]
    has_sign = (first == ord("+")) | (first == ord("-"))
    negative = first == ord("-")
    s0 = has_sign.to(_I32)
    is_digit = (ch >= ord("0")) & (ch <= ord("9"))
    is_e = ((ch | 0x20) == ord("e")) & in_str
    e_pos = torch.where(is_e, pos, width).amin(dim=1)
    has_e = e_pos < tlen
    glen = torch.where(has_e, e_pos, tlen)
    is_dot = (ch == ord(".")) & in_str & (pos < glen[:, None])
    dot_pos = torch.where(is_dot, pos, width).amin(dim=1)
    mant = (pos >= s0[:, None]) & (pos < glen[:, None])
    mant_ok = torch.where(mant, is_digit | (pos == dot_pos[:, None]),
                          True).all(dim=1)
    one_dot = is_dot.sum(dim=1) <= 1
    mant_digit = mant & is_digit
    es = e_pos + 1
    e_first = _col(ch, es.clamp(0, width - 1))
    e_neg = e_first == ord("-")
    exp_start = es + (e_neg | (e_first == ord("+"))).to(_I32)
    exp_region = (pos >= exp_start[:, None]) & in_str
    exp_ok = torch.where(
        has_e,
        torch.where(exp_region, is_digit, True).all(dim=1)
        & (tlen > exp_start), True)
    dig = ch.to(_I32) - ord("0")
    exp_mag = torch.zeros(n, dtype=_I32, device=dev)
    for j in range(width):
        # the exponent's magnitude, capped: past +-64 the range checks
        # decide
        exp_mag = torch.where(exp_region[:, j] & is_digit[:, j],
                              (exp_mag * 10 + dig[:, j]).clamp(max=1 << 20),
                              exp_mag)
    exp_val = torch.where(has_e, torch.where(e_neg, -exp_mag, exp_mag), 0)
    frac_len = torch.where(dot_pos < glen, glen - dot_pos - 1, 0)
    punted = ~bounded | (tlen > width)
    valid = mant_ok & one_dot & (mant_digit.sum(dim=1) > 0) & exp_ok \
        & (glen > s0) & ~punted

    # every mantissa digit (integer and fraction) into four 32-bit limbs
    limbs = [torch.zeros(n, dtype=torch.int64, device=dev)
             for _ in range(4)]
    acc_ovf = torch.zeros(n, dtype=torch.bool, device=dev)
    dig64 = dig.to(torch.int64)
    for j in range(width):
        use = mant_digit[:, j]
        carry = torch.where(use, dig64[:, j], 0)
        mul = torch.where(use, 10, 1)
        for k in range(4):
            t = limbs[k] * mul + carry
            limbs[k] = t & 0xFFFFFFFF
            carry = t >> 32
        acc_ovf = acc_ovf | (carry != 0)
    mag = torch.stack(limbs, dim=1)

    # shift = scale - frac_len + exp: multiply by 10^shift, or divide by
    # 10^-shift HALF_UP; both powers are looked up a row
    shift = scale - frac_len + exp_val
    ovf = acc_ovf | ((shift > 38) & (mag != 0).any(dim=1))
    p4, h5 = _decimal_tables(dev)
    wide = _mul_limbs_wide(mag, p4[shift.clamp(0, 38).to(torch.int64)])
    ovf = ovf | ((shift > 0) & (wide[:, 4:] != 0).any(dim=1))
    down = (-shift).clamp(0, 40).to(torch.int64)
    num5 = _add_limbs(torch.cat([mag, torch.zeros_like(mag[:, :1])], dim=1),
                      h5[down])
    div_res = _div_pow10(num5, down, 40)[:, :4]
    result = torch.where((shift >= 0)[:, None], wide[:, :4], div_res)
    result = torch.where((shift < -39)[:, None], 0, result)
    ovf = ovf | _gt_limbs_const(result, _BOUND_LIMBS)
    return result, negative, valid, ovf, punted


def cast_string_to_decimal128(col: Column, scale: int, *,
                              ansi: bool = False, device=None
                              ) -> Tuple[Column, torch.Tensor]:
    """``CAST(string AS DECIMAL(38, scale))``: the float grammar (sign,
    digits, optional fraction, optional exponent), the value rescaled to
    ``scale`` rounding HALF_UP; past 38 digits null.  Returns ``(column,
    error mask)``."""
    col = _arrow_on(col, device, "cast_string_to_decimal128")
    mag, negative, valid, ovf, punted = _cast_decimal(col, scale,
                                                      DEC_PARSE_WIDTH)
    signed = _data(torch.where(negative[:, None], _neg_limbs(mag), mag))
    in_valid = col.valid_bools()
    signed, ok = _patch_punts(col, punted & in_valid, signed, valid & ~ovf,
                              lambda raw: _host_parse_decimal(raw, scale))
    error = in_valid & ~ok
    if ansi:
        _ansi_check(error)
    return Column(decimal128(scale), signed, pack_bools(in_valid & ok)), error


def _host_parse_decimal(raw: bytes, scale: int):
    """The decimal cast of a punted row's bytes, in Python ints."""
    try:
        txt = _trim_bytes(raw).decode("ascii")
    except UnicodeDecodeError:
        return None
    m = re.fullmatch(r"([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d+))?", txt)
    if not m or not (m.group(2) or m.group(3)):
        return None
    sign = -1 if m.group(1) == "-" else 1
    ipart = m.group(2) or "0"
    frac = m.group(3) or ""
    exp = int(m.group(4) or 0)
    unscaled = int(ipart + frac) if (ipart + frac) else 0
    shift = scale - len(frac) + exp
    if shift >= 0:
        v = unscaled * 10 ** shift
    else:
        d = 10 ** (-shift)
        q, r = divmod(unscaled, d)
        v = q + (1 if 2 * r >= d else 0)
    if v > 10 ** 38 - 1:
        return None
    return sign * v


# ---------------------------------------------------------------------------
# int -> string
# ---------------------------------------------------------------------------

MAX_INT64_DIGITS = 20


def _int_digits(v: torch.Tensor):
    """int64 ``[n]`` -> (digits int64 ``[n, 20]`` of ``|v|``, most
    significant first; digit count, at least 1; negative).  The digits come
    from the two halves of a truncating division by ``10^10``, each under
    ``10^10`` in magnitude, so that ``|INT64_MIN|`` is never formed."""
    neg = v < 0
    hi = torch.div(v, 10 ** 10, rounding_mode="trunc")
    lo = v - hi * 10 ** 10
    p10 = torch.tensor([10 ** e for e in range(9, -1, -1)],
                       dtype=torch.int64, device=v.device)
    digits = torch.cat([(hi.abs()[:, None] // p10) % 10,
                        (lo.abs()[:, None] // p10) % 10], dim=1)
    nz = digits != 0
    ndig = torch.where(nz.any(dim=1),
                       MAX_INT64_DIGITS - nz.to(torch.uint8).argmax(dim=1),
                       1)
    return digits, ndig, neg


def cast_int_to_string(col: Column, *, device=None) -> Column:
    """``CAST(<int> AS STRING)``: decimal digits, ``-`` for a negative
    value, as an Arrow-layout column (every row rendered, the validity
    kept).  The offsets take one host read of the total."""
    if col.dtype.kind not in ("int8", "int16", "int32", "int64"):
        raise ValueError("cast_int_to_string needs a signed integer column")
    col = col.to(resolve_device(device))
    dev = col.device
    n = col.num_rows
    digits, ndig, neg = _int_digits(col.data.to(torch.int64))
    lens = ndig + neg.to(torch.int64)
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(lens, 0, out=offsets[1:])
    total = int(offsets[-1])
    if total >= 1 << 31:
        raise ValueError(f"{total} chars do not fit int32 offsets")
    # each char: the sign or a digit of its row
    rows = torch.repeat_interleave(torch.arange(n, device=dev), lens,
                                   output_size=total)
    intra = torch.arange(total, device=dev) - offsets[rows]
    sign_slot = neg[rows] & (intra == 0)
    at = (MAX_INT64_DIGITS - ndig[rows] + intra
          - neg[rows].to(torch.int64)).clamp(0, MAX_INT64_DIGITS - 1)
    chars = torch.where(sign_slot, ord("-"),
                        digits[rows, at] + ord("0")).to(torch.uint8)
    return Column(STRING, torch.empty(0, dtype=torch.uint8, device=dev),
                  col.validity, offsets=offsets.to(torch.int32), chars=chars)


# ---------------------------------------------------------------------------
# string -> date / timestamp
# ---------------------------------------------------------------------------
#
# Spark's temporal grammar (Cast.stringToDate / stringToTimestamp, UTC
# session zone):
#   date:      [+-]y{1,7} | yyyy-[m]m | yyyy-[m]m-[d]d, anything after a 'T'
#              or ' ' that follows a full date ignored
#   timestamp: the date forms, optionally followed by
#              [T| ][h]h:[m]m:[s]s[.f{1,6}][Z|UTC|[+-][h]h[:[m]m]]
# Region-id zones parse as invalid.  The field arithmetic is int32, as in
# the JAX package.

TEMPORAL_PARSE_WIDTH = 40


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(_I32)


def _field_value(ch, dig, s, e):
    """The digits in ``[s, e)`` of each row as an int32 value (0 when
    empty; positions past the eighth from the end weigh 10^7), whether they
    are all digits, and their length."""
    pos = _pos(ch.shape[1], ch.device)
    in_f = (pos >= s[:, None]) & (pos < e[:, None])
    is_digit = (ch >= ord("0")) & (ch <= ord("9"))
    ok = torch.where(in_f, is_digit, True).all(dim=1)
    p10 = torch.tensor([10 ** k for k in range(8)], dtype=_I32,
                       device=ch.device)
    expo = (e[:, None] - 1 - pos).clamp(0, 7).to(torch.int64)
    val = torch.where(in_f & is_digit, dig * p10[expo], 0).sum(
        dim=1, dtype=torch.int64)
    return _wrap32(val), ok, e - s


def _next_sep(mask, start):
    """int32: the first position >= ``start`` where ``mask`` holds (the
    width when none)."""
    W = mask.shape[1]
    pos = _pos(W, mask.device)
    return torch.where(mask & (pos >= start[:, None]), pos, W).amin(dim=1)


def _days_from_civil(y, m, d):
    """Proleptic-Gregorian days since 1970-01-01 (Hinnant), int32 in and
    out; floor division, so the era needs no truncation compensation."""
    y = y - (m <= 2).to(_I32)
    era = y // 400
    yoe = y - era * 400
    mp = (m + 9) % 12
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _is_leap(y):
    return ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)


def _days_in_month(y, m):
    base = torch.tensor([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                        dtype=_I32, device=y.device)
    dim = base[(m - 1).clamp(0, 11).to(torch.int64)]
    return torch.where((m == 2) & _is_leap(y), 29, dim).to(_I32)


def _parse_temporal(col: Column, want_time: bool) -> dict:
    """The fields of the date and time grammar from the trimmed window,
    each int32 or bool ``[n]``, with their validity."""
    width = TEMPORAL_PARSE_WIDTH
    ch, tlen, bounded = _trimmed(col, width)
    n = ch.shape[0]
    dev = ch.device
    pos = _pos(width, dev)
    in_str = pos < tlen[:, None]
    dig = torch.where((ch >= ord("0")) & (ch <= ord("9")),
                      ch.to(_I32) - ord("0"), 0).to(_I32)
    punted = ~bounded | (tlen > width)
    zero = torch.zeros(n, dtype=_I32, device=dev)

    first = ch[:, 0]
    has_sign = (first == ord("+")) | (first == ord("-"))
    neg_year = first == ord("-")
    s0 = has_sign.to(_I32)
    dash = (ch == ord("-")) & in_str
    # year [s0, dash1), month (dash1, dash2), day (dash2, date end)
    d1 = _next_sep(dash, s0 + 1)
    t_at = _next_sep(((ch == ord("T")) | (ch == ord(" "))) & in_str, s0)
    end = torch.minimum(tlen, t_at)
    year, y_ok, y_len = _field_value(ch, dig, s0, torch.minimum(d1, end))
    year = torch.where(neg_year, -year, year)
    have_month = d1 < end
    d2 = _next_sep(dash, d1 + 1)
    month, m_ok, m_len = _field_value(ch, dig, d1 + 1, torch.minimum(d2, end))
    have_day = d2 < end
    day, dd_ok, d_len = _field_value(ch, dig, d2 + 1, end)
    month_f = torch.where(have_month, month, 1).to(_I32)
    day_f = torch.where(have_day, day, 1).to(_I32)
    date_ok = y_ok & (y_len >= 1) & (y_len <= 7) \
        & torch.where(have_month, m_ok & (m_len >= 1) & (m_len <= 2), True) \
        & torch.where(have_day, dd_ok & (d_len >= 1) & (d_len <= 2), True) \
        & (~have_day | have_month) \
        & (month_f >= 1) & (month_f <= 12) \
        & (day_f >= 1) & (day_f <= _days_in_month(year, month_f)) \
        & ~(~have_month & has_sign & (y_len == 0))
    # a 'T' or ' ' only after a whole y-m-d date
    has_t = t_at < tlen
    date_ok = date_ok & (~has_t | (have_month & have_day))
    # the int32 day range (Spark's DATE cannot hold more either)
    date_ok = date_ok & (year >= -5_000_000) & (year <= 5_000_000)
    out = dict(year=year, month=month_f, day=day_f, date_ok=date_ok,
               punted=punted, tlen=tlen, hour=zero, minute=zero, sec=zero,
               micros=zero, tz_min=zero,
               time_ok=torch.ones(n, dtype=torch.bool, device=dev))
    if not want_time:
        return out

    colon = (ch == ord(":")) & in_str
    ts = t_at + 1
    has_time = has_t & (ts < tlen)
    # a zone may follow any time prefix (Spark fills missing minutes and
    # seconds with zero), so it is searched from the time's start
    tz_at = _next_sep(((ch == ord("+")) | (ch == ord("-"))
                       | (ch == ord("Z")) | (ch == ord("U"))) & in_str, ts)
    t_end = torch.minimum(tz_at, tlen)
    c1 = _next_sep(colon, ts)
    hour, h_ok, h_len = _field_value(ch, dig, ts, torch.minimum(c1, t_end))
    have_min = c1 < t_end
    c2 = _next_sep(colon, c1 + 1)
    minute, mi_ok, mi_len = _field_value(ch, dig, c1 + 1,
                                         torch.minimum(c2, t_end))
    have_sec = c2 < t_end
    dot_at = _next_sep((ch == ord(".")) & in_str, c2 + 1)
    sec, s_ok, s_len = _field_value(ch, dig, c2 + 1,
                                    torch.minimum(dot_at, t_end))
    frac, f_ok, f_len = _field_value(ch, dig, dot_at + 1, t_end)
    has_frac = dot_at < t_end
    p10 = torch.tensor([10 ** k for k in range(8)], dtype=_I32, device=dev)
    micros = frac * p10[(6 - f_len).clamp(0, 7).to(torch.int64)]

    # the zone: Z | UTC | [+-][h]h[:[m]m]
    has_tz = tz_at < tlen
    tzc = _col(ch, tz_at.clamp(0, width - 1))
    is_z = tzc == ord("Z")
    u_ok = torch.ones(n, dtype=torch.bool, device=dev)
    for j, c in enumerate("UTC"):
        u_ok = u_ok & (_col(ch, (tz_at + j).clamp(0, width - 1)) == ord(c))
    is_utc = (tzc == ord("U")) & u_ok & (tlen == tz_at + 3)
    tz_sign = torch.where(tzc == ord("-"), -1, 1).to(_I32)
    is_off = (tzc == ord("+")) | (tzc == ord("-"))
    tc = _next_sep(colon, tz_at + 1)
    tzh, tzh_ok, tzh_len = _field_value(ch, dig, tz_at + 1,
                                        torch.minimum(tc, tlen))
    has_tzmin = tc < tlen
    tzmin, tzmin_ok, tzmin_len = _field_value(ch, dig, tc + 1, tlen)
    tzmin_eff = torch.where(has_tzmin, tzmin, 0).to(_I32)
    tz_ok = torch.where(
        is_z, tlen == tz_at + 1,
        torch.where(is_utc, True, torch.where(
            is_off,
            tzh_ok & (tzh_len >= 1) & (tzh_len <= 2)
            # ZoneOffset caps at +-18:00 exactly
            & (tzh * 60 + tzmin_eff <= 18 * 60)
            & torch.where(has_tzmin, tzmin_ok & (tzmin_len == 2)
                          & (tzmin <= 59), True),
            ~has_tz)))
    tz_min_total = torch.where(is_off, tz_sign * (tzh * 60 + tzmin_eff),
                               0).to(_I32)
    time_ok = torch.where(
        has_time,
        h_ok & (h_len >= 1) & (h_len <= 2) & (hour <= 23)
        & torch.where(have_min, mi_ok & (mi_len >= 1) & (mi_len <= 2)
                      & (minute <= 59), True)
        # a fraction needs a seconds field
        & torch.where(have_sec, s_ok & (s_len >= 1) & (s_len <= 2)
                      & (sec <= 59), ~has_frac)
        & (have_min | ~have_sec)
        & torch.where(has_frac, f_ok & (f_len >= 1) & (f_len <= 6), True)
        & tz_ok,
        # a date-only timestamp: nothing, or a bare 'T', after the date
        ~has_t | (t_at + 1 >= tlen))

    def when(cond, x):
        return torch.where(cond, x, 0).to(_I32)
    out.update(hour=when(has_time, hour),
               minute=when(has_time & have_min, minute),
               sec=when(has_time & have_sec, sec),
               micros=when(has_time & has_frac, micros),
               tz_min=when(has_time, tz_min_total), time_ok=time_ok)
    return out


def cast_string_to_date(col: Column, *, ansi: bool = False, device=None
                        ) -> Tuple[Column, torch.Tensor]:
    """``CAST(string AS DATE)``: int32 days since the epoch.  Returns
    ``(column, error mask)``."""
    col = _arrow_on(col, device, "cast_string_to_date")
    f = _parse_temporal(col, False)
    ok = f["date_ok"] & ~f["punted"] & (f["tlen"] > 0)
    days = _days_from_civil(f["year"], f["month"], f["day"])
    in_valid = col.valid_bools()
    days, ok = _patch_punts(col, f["punted"] & in_valid, days, ok,
                            _host_parse_date)
    error = in_valid & ~ok
    if ansi:
        _ansi_check(error, "date(s)")
    return Column(DATE32, days, pack_bools(in_valid & ok)), error


# the int64 microsecond range's edges in whole seconds
_MAX_S, _MIN_S = 9223372036854, -9223372036855


def cast_string_to_timestamp(col: Column, *, ansi: bool = False,
                             device=None) -> Tuple[Column, torch.Tensor]:
    """``CAST(string AS TIMESTAMP)``, UTC session zone: int64 microseconds
    since the epoch; offset zones (``Z``, ``UTC``, ``+hh:mm``) apply,
    region ids are invalid.  An instant past the int64 microsecond range
    is null, never wrapped.  Returns ``(column, error mask)``."""
    col = _arrow_on(col, device, "cast_string_to_timestamp")
    f = _parse_temporal(col, True)
    ok = f["date_ok"] & f["time_ok"] & ~f["punted"] & (f["tlen"] > 0)
    days = _days_from_civil(f["year"], f["month"], f["day"])
    secs_of_day = f["hour"] * 3600 + f["minute"] * 60 + f["sec"] \
        - f["tz_min"] * 60
    # exact: the date's +-5M-year bound keeps |total_s| under 2^48; the
    # range test runs before the multiply, which wraps only on rows it
    # nulls
    total_s = days.to(torch.int64) * 86400 + secs_of_day.to(torch.int64)
    us = f["micros"]
    ok = ok & ((total_s <= _MAX_S - 1) | ((total_s <= _MAX_S) & (us <= 775807))) \
        & ((total_s >= _MIN_S + 1) | ((total_s >= _MIN_S) & (us >= 224192)))
    data = total_s * 1_000_000 + us.to(torch.int64)
    in_valid = col.valid_bools()
    data, ok = _patch_punts(col, f["punted"] & in_valid, data, ok,
                            _host_parse_timestamp)
    error = in_valid & ~ok
    if ansi:
        _ansi_check(error, "timestamp(s)")
    return Column(TIMESTAMP64, data, pack_bools(in_valid & ok)), error


def _host_parse_date(raw: bytes):
    """The date cast of a punted row's bytes, unbounded."""
    try:
        t = _trim_bytes(raw).decode("ascii")
    except UnicodeDecodeError:
        return None
    m = re.fullmatch(
        r"([+-]?\d{1,7})(?:-(\d{1,2})(?:-(\d{1,2})([T ].*)?)?)?", t)
    if not m:
        return None
    y = int(m.group(1))
    mo = int(m.group(2) or 1)
    d = int(m.group(3) or 1)
    if not (1 <= mo <= 12) or abs(y) > 5_000_000:
        return None
    base = [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]
    leap = (y % 4 == 0 and y % 100 != 0) or y % 400 == 0
    dim = 29 if (mo == 2 and leap) else base[mo - 1]
    if not 1 <= d <= dim:
        return None
    yy = y - (mo <= 2)
    era = yy // 400
    yoe = yy - era * 400
    mp = (mo + 9) % 12
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _host_parse_timestamp(raw: bytes):
    """The timestamp cast of a punted row's bytes, unbounded."""
    try:
        t = _trim_bytes(raw).decode("ascii")
    except UnicodeDecodeError:
        return None
    m = re.fullmatch(
        r"([+-]?\d{1,7})-(\d{1,2})-(\d{1,2})"
        r"(?:[T ](?:(\d{1,2})(?::(\d{1,2})(?::(\d{1,2})"
        r"(?:\.(\d{1,6}))?)?)?"
        r"(Z|UTC|[+-]\d{1,2}(?::\d{2})?)?)?)?", t)
    if not m:
        # year and year-month forms are timestamps too, but unlike the
        # date cast nothing after the date may be ignored
        m2 = re.fullmatch(r"([+-]?\d{1,7})(?:-(\d{1,2}))?", t)
        if not m2:
            return None
        days = _host_parse_date(
            f"{m2.group(1)}-{m2.group(2) or 1}-1".encode())
        return None if days is None else _ts_in_i64(
            days * 86400 * 1_000_000)
    days = _host_parse_date(f"{m.group(1)}-{m.group(2)}-{m.group(3)}"
                            .encode())
    if days is None:
        return None
    h = int(m.group(4) or 0)
    mi = int(m.group(5) or 0)
    sec = int(m.group(6) or 0)
    frac = m.group(7) or ""
    us = int(frac.ljust(6, "0")) if frac else 0
    if h > 23 or mi > 59 or sec > 59:
        return None
    off_min = 0
    tz = m.group(8)
    if tz and tz not in ("Z", "UTC"):
        sign = -1 if tz[0] == "-" else 1
        hh, _, mm = tz[1:].partition(":")
        off_min = sign * (int(hh) * 60 + int(mm or 0))
        if abs(off_min) > 18 * 60:
            return None
    secs = days * 86400 + h * 3600 + mi * 60 + sec - off_min * 60
    return _ts_in_i64(secs * 1_000_000 + us)


def _ts_in_i64(micros):
    """None past the int64 microsecond range (Spark's ``instantToMicros``
    overflows there)."""
    return micros if -(1 << 63) <= micros < (1 << 63) else None


# ---------------------------------------------------------------------------
# date / timestamp -> string
# ---------------------------------------------------------------------------

def _civil_from_days(days: torch.Tensor):
    """Days since 1970-01-01 (int64) -> (year, month, day), the inverse of
    :func:`_days_from_civil`, in floor division."""
    z = days + 719468
    era = z // 146097
    doe = z - era * 146097                                # [0, 146096]
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)       # [0, 365]
    mp = (5 * doy + 2) // 153                             # [0, 11]
    d = doy - (153 * mp + 2) // 5 + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    return torch.where(m <= 2, y + 1, y), m, d


def _digit_cols(value: torch.Tensor, nd: int) -> List[torch.Tensor]:
    """``value`` (>= 0 where it is read) as ``nd`` zero-padded ASCII
    digits, one ``[n]`` tensor a column."""
    return [value // 10 ** (nd - 1 - j) % 10 + ord("0") for j in range(nd)]


def _chars(cols: List, n: int, device) -> torch.Tensor:
    """uint8 ``[n, len(cols)]`` from columns of tensors and single chars."""
    return torch.stack([c if isinstance(c, torch.Tensor)
                        else torch.full((n,), ord(c), dtype=torch.int64,
                                        device=device)
                        for c in cols], dim=1).to(torch.uint8)


def cast_date_to_string(col: Column, *, device=None) -> Column:
    """``CAST(DATE AS STRING)``: ``yyyy-MM-dd``, dense-padded; years
    outside 1..9999 are null (Spark widens the format there)."""
    if col.dtype.kind != "date32":
        raise ValueError("cast_date_to_string needs a date32 column")
    col = col.to(resolve_device(device))
    n = col.num_rows
    y, m, d = _civil_from_days(col.data.to(torch.int64))
    mat = _chars(_digit_cols(y, 4) + ["-"] + _digit_cols(m, 2) + ["-"]
                 + _digit_cols(d, 2), n, col.device)
    valid = col.valid_bools() & (y >= 1) & (y <= 9999)
    return _padded_string_result(mat, torch.full_like(y, 10), valid,
                                pack_bools(valid))


def cast_timestamp_to_string(col: Column, *, device=None) -> Column:
    """``CAST(TIMESTAMP AS STRING)``, UTC: ``yyyy-MM-dd HH:mm:ss[.ffffff]``
    with the fraction's trailing zeros trimmed, dense-padded; years outside
    1..9999 are null.  Rendered with int64 tensor ops on the column's
    device."""
    if col.dtype.kind != "timestamp_us":
        raise ValueError(
            "cast_timestamp_to_string needs a timestamp_us column")
    col = col.to(resolve_device(device))
    n = col.num_rows
    micros = col.data
    days = micros // 86_400_000_000                      # floor: negatives
    us = micros % 86_400_000_000
    y, m, d = _civil_from_days(days)
    sec, usec = us // 1_000_000, us % 1_000_000
    hh, mi, ss = sec // 3600, sec % 3600 // 60, sec % 60
    mat = _chars(_digit_cols(y, 4) + ["-"] + _digit_cols(m, 2) + ["-"]
                 + _digit_cols(d, 2) + [" "] + _digit_cols(hh, 2) + [":"]
                 + _digit_cols(mi, 2) + [":"] + _digit_cols(ss, 2) + ["."]
                 + _digit_cols(usec, 6), n, col.device)
    # the fraction's digits without its trailing zeros; no dot when zero
    frac_digits = torch.full_like(usec, 6)
    u = usec
    for _ in range(6):
        trim = (frac_digits > 0) & (u % 10 == 0)
        u = torch.where(trim, u // 10, u)
        frac_digits = frac_digits - trim.to(torch.int64)
    in_range = (y >= 1) & (y <= 9999)
    lens = torch.where(in_range, torch.where(usec == 0, 19, 20 + frac_digits),
                       0)
    mat = torch.where(torch.arange(26, device=col.device) < lens[:, None],
                      mat, 0).to(torch.uint8)
    valid = col.valid_bools() & in_range
    return _padded_string_result(mat, lens, valid, pack_bools(valid))
