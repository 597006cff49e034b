"""PyTorch port, Spark's casts (``ops/cast_string.py``) and decimal128
arithmetic (``ops/decimal.py``), held against the JAX package on the same
seeded inputs, on the CPU.

Values (float bits, NaN as NaN), data under null rows, validity, error
masks, string bytes, lengths and offsets must be equal bit for bit:
tolerance zero.  Each JAX call compiles its programs once a shape, so the
JAX side runs once a module on one shared input of a few hundred rows (the
edge strings of ``utils.CAST_EDGE_STRINGS`` and strings made with numpy
from a seed), at ``bucket=None``, and on two decimal scales; wider sweeps
hold the port alone against Python oracles (``int``, ``decimal.Decimal``
with ``ROUND_HALF_UP``, ``datetime``)."""

import datetime
import decimal as pydecimal
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_jni_tpu import table as jt
from spark_rapids_jni_tpu.ops import cast_string as jcs
from spark_rapids_jni_tpu.ops import decimal as jdec
from spark_rapids_jni_tpu_torch import interop
from spark_rapids_jni_tpu_torch import table as pt
from spark_rapids_jni_tpu_torch.ops import cast_string as pcs
from spark_rapids_jni_tpu_torch.ops import decimal as pdec
from spark_rapids_jni_tpu_torch.utils import (
    CAST_EDGE_STRINGS, CAST_KINDS, cast_strings,
)

from _torch_port import assert_same_columns, jax_columns

INT_KINDS = ["int8", "int16", "int32", "int64"]
# the two scales held against the JAX package (each a few seconds of XLA
# compiles); the oracle sweep takes more
JAX_SCALES = [2, 38]
ORACLE_SCALES = [0, 2, 6, 38, -3]
BOUND = 10 ** 38 - 1
_WS = " \t\n"


def _digits(rng, k):
    return "".join(rng.choice(list("0123456789"), k)) if k else ""


def numpy_strings(seed: int, n: int) -> list:
    """``n`` casts' texts from numpy's generator: integers and decimals
    (sign, digits, fraction, exponent, f/d suffix), dates and timestamps
    (partial forms, fractions, zones), whitespace around; every seventh
    row None."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = i % 4
        if kind == 0:
            s = rng.choice(["", "-", "+"]) + _digits(rng, rng.integers(0, 22))
            if rng.random() < 0.3:
                s += "." + _digits(rng, rng.integers(0, 4))
        elif kind == 1:
            s = rng.choice(["", "-"]) + _digits(rng, rng.integers(0, 12))
            s += "." + _digits(rng, rng.integers(0, 8))
            if rng.random() < 0.5:
                s += rng.choice(["e", "E"]) + rng.choice(["", "-", "+"]) \
                    + _digits(rng, rng.integers(0, 3))
            s += rng.choice(["", "", "f", "d"])
        else:
            y, m, d = (rng.integers(0, 10000), rng.integers(0, 14),
                       rng.integers(0, 33))
            s = f"{y:04d}-{m:02d}-{d:02d}"
            if kind == 3:
                s += rng.choice([" ", "T"]) + ":".join(
                    f"{v:02d}" for v in rng.integers(0, 61, 3))
                if rng.random() < 0.5:
                    s += "." + _digits(rng, rng.integers(1, 8))
                s += rng.choice(["", "Z", "+05:30", "-8", "UTC", " PST"])
        pad = ["".join(rng.choice(list(_WS), rng.integers(0, 3)))
               for _ in range(2)]
        out.append(None if i % 7 == 3 else pad[0] + s + pad[1])
    return out


STRINGS = CAST_EDGE_STRINGS + numpy_strings(7, 160)


def _cross(jax_col):
    """The port's copy of a JAX column, through ``interop``, on the CPU."""
    return interop.table_from_numpy_columns(
        jax_columns(jt.Table((jax_col,))), device="cpu").columns[0]


@pytest.fixture(scope="module")
def strings():
    """The shared input: (JAX column, the port's copy of it)."""
    j = jt.Column.strings(STRINGS)
    return j, _cross(j)


def _same(port_col, port_err, jax_col, jax_err):
    """Equal data bytes (under nulls too), validity and error masks."""
    assert_same_columns(pt.Table((port_col,)), jt.Table((jax_col,)))
    np.testing.assert_array_equal(port_err.numpy(), np.asarray(jax_err))


def _same_padded(port_col, jax_col):
    """A dense-padded string result equal to the JAX package's: its chars
    up to the JAX width (zeros past it), lengths, offsets and validity; the
    JAX column read back through ``interop`` equal to the port's."""
    jm = np.asarray(jax_col.chars2d)
    pm = port_col.chars2d.numpy()
    W = jm.shape[1]
    np.testing.assert_array_equal(pm[:, :W], jm)
    assert not pm[:, W:].any() and pm.shape[1] % 4 == 0
    np.testing.assert_array_equal(port_col.lens.numpy(),
                                  np.asarray(jax_col.str_lens()))
    np.testing.assert_array_equal(port_col.offsets.numpy(),
                                  np.asarray(jax_col.offsets))
    assert (port_col.validity is None) == (jax_col.validity is None)
    if jax_col.validity is not None:
        np.testing.assert_array_equal(port_col.validity.numpy(),
                                      np.asarray(jax_col.validity))
    pt.assert_tables_equivalent(pt.Table((port_col,)),
                                pt.Table((_cross(jax_col),)),
                                check_nulls=False)


def _jax_dtype(name):
    return getattr(jt, name.upper())


# ---------------------------------------------------------------------------
# string -> X against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", INT_KINDS)
def test_string_to_int_matches_jax(strings, kind):
    j, p = strings
    jo, je = jcs.cast_string_to_int(j, _jax_dtype(kind), bucket=None)
    po, pe = pcs.cast_string_to_int(p, pt.dtype_from_name(kind),
                                    device="cpu")
    _same(po, pe, jo, je)
    # INT64_MIN and the first values past each bound
    got = dict(zip(STRINGS, po.to_pylist()))
    assert got["-9223372036854775808"] == (-(1 << 63) if kind == "int64"
                                           else None)
    assert got["9223372036854775808"] is None


@pytest.mark.parametrize("kind", ["float32", "float64"])
def test_string_to_float_matches_jax(strings, kind):
    j, p = strings
    jo, je = jcs.cast_string_to_float(j, _jax_dtype(kind), bucket=None)
    po, pe = pcs.cast_string_to_float(p, pt.dtype_from_name(kind),
                                      device="cpu")
    _same(po, pe, jo, je)


def test_float32_double_rounding_row():
    """The row whose float64 value lands on a float32 midpoint rounds as
    ``Float.parseFloat`` rounds its text, through the exact fraction."""
    s = ["0x1.0000010000000000001p0", "1.00000005960464477539062500001"]
    po, _ = pcs.cast_string_to_float(pt.Column.strings(s, device="cpu"),
                                     pt.FLOAT32, device="cpu")
    want = np.float32(1.0) + np.float32(2.0) ** -23
    assert (po.data.numpy() == want).all()


@pytest.mark.parametrize("scale", JAX_SCALES)
def test_string_to_decimal_matches_jax(strings, scale):
    j, p = strings
    jo, je = jcs.cast_string_to_decimal128(j, scale, bucket=None)
    po, pe = pcs.cast_string_to_decimal128(p, scale, device="cpu")
    _same(po, pe, jo, je)


def test_string_to_date_matches_jax(strings):
    j, p = strings
    jo, je = jcs.cast_string_to_date(j, bucket=None)
    po, pe = pcs.cast_string_to_date(p, device="cpu")
    _same(po, pe, jo, je)


def test_string_to_timestamp_matches_jax(strings):
    """The int64 microsecond range's edges included: one microsecond past
    either end is null, never wrapped."""
    j, p = strings
    jo, je = jcs.cast_string_to_timestamp(j, bucket=None)
    po, pe = pcs.cast_string_to_timestamp(p, device="cpu")
    _same(po, pe, jo, je)
    got = dict(zip(STRINGS, po.to_pylist()))
    assert got["+294247-01-10T04:00:54.775807"] == (1 << 63) - 1
    assert got["-290308-12-21T19:59:05.224192"] == -(1 << 63)
    assert got["+294247-01-10T04:00:54.775808"] is None
    assert got["-290308-12-21T19:59:05.224191"] is None


ANSI_CASES = {
    "int32": (lambda c, **k: jcs.cast_string_to_int(c, jt.INT32, **k),
              lambda c, **k: pcs.cast_string_to_int(c, pt.INT32, **k)),
    "float64": (lambda c, **k: jcs.cast_string_to_float(c, jt.FLOAT64, **k),
                lambda c, **k: pcs.cast_string_to_float(c, pt.FLOAT64,
                                                        **k)),
    "decimal": (lambda c, **k: jcs.cast_string_to_decimal128(c, 2, **k),
                lambda c, **k: pcs.cast_string_to_decimal128(c, 2, **k)),
    "date": (jcs.cast_string_to_date, pcs.cast_string_to_date),
    "timestamp": (jcs.cast_string_to_timestamp,
                  pcs.cast_string_to_timestamp),
}


@pytest.mark.parametrize("cast", sorted(ANSI_CASES))
def test_ansi_raises_as_jax(strings, cast):
    """``ansi=True`` raises the JAX package's message on the shared rows,
    and raises on none of the rows the cast accepts."""
    jfn, pfn = ANSI_CASES[cast]
    j, p = strings
    with pytest.raises(ValueError) as jerr:
        jfn(j, ansi=True, bucket=None)
    with pytest.raises(ValueError) as perr:
        pfn(p, ansi=True, device="cpu")
    assert str(perr.value) == str(jerr.value)
    assert str(perr.value).startswith("ANSI cast failure")
    _, err = pfn(p, device="cpu")
    good = [s for s, e in zip(STRINGS, err.tolist()) if not e]
    pfn(pt.Column.strings(good, device="cpu"), ansi=True, device="cpu")


# ---------------------------------------------------------------------------
# X -> string against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", INT_KINDS)
def test_int_to_string_matches_jax(kind):
    dt = pt.dtype_from_name(kind)
    info = np.iinfo(dt.np_dtype)
    rng = np.random.default_rng(3)
    v = rng.integers(info.min, info.max, 200, dtype=dt.np_dtype,
                     endpoint=True)
    v[:5] = [info.min, info.max, 0, -1, info.min + 1]
    valid = rng.random(200) > 0.2
    valid[:2] = True
    j = jt.Column.from_numpy(v, _jax_dtype(kind), valid)
    p = _cross(j)
    jo = jcs.cast_int_to_string(j, bucket=None)
    po = pcs.cast_int_to_string(p, device="cpu")
    assert_same_columns(pt.Table((po,)), jt.Table((jo,)))
    assert po.to_pylist()[:2] == [str(info.min), str(info.max)]


def test_date_to_string_matches_jax():
    rng = np.random.default_rng(4)
    days = rng.integers(-900_000, 3_100_000, 300).astype(np.int32)
    days[:6] = [-(1 << 31), (1 << 31) - 1, -719162, 2932896, -719163,
                2932897]
    j = jt.Column.from_numpy(days, jt.DATE32, rng.random(300) > 0.2)
    _same_padded(pcs.cast_date_to_string(_cross(j), device="cpu"),
                 jcs.cast_date_to_string(j, bucket=None))


def test_timestamp_to_string_matches_jax():
    rng = np.random.default_rng(5)
    micros = rng.integers(-62135596800 * 10 ** 6, 253402300800 * 10 ** 6,
                          300)
    micros[::3] = micros[::3] // 1000 * 1000
    micros[::5] = micros[::5] // 10 ** 6 * 10 ** 6
    micros[:6] = [-(1 << 63), (1 << 63) - 1, 0, -1,
                  -62135596800 * 10 ** 6, 253402300799999999]
    j = jt.Column.from_numpy(micros, jt.TIMESTAMP64, rng.random(300) > 0.2)
    _same_padded(pcs.cast_timestamp_to_string(_cross(j), device="cpu"),
                 jcs.cast_timestamp_to_string(j, bucket=None))


# ---------------------------------------------------------------------------
# decimal128 against the JAX package
# ---------------------------------------------------------------------------

def _unscaled(seed, n):
    """Unscaled values: mostly under 10^18, some near +-(10^38 - 1) so that
    sums, products and rescales overflow, and the edges."""
    rng = np.random.default_rng(seed)
    vals = [int(x) for x in rng.integers(-10 ** 18, 10 ** 18, n)]
    for i in range(0, n, 11):
        vals[i] = BOUND - int(rng.integers(0, 1000))
    for i in range(5, n, 13):
        vals[i] = -BOUND + int(rng.integers(0, 1000))
    for i in range(7, n, 17):
        vals[i] = 0
    vals[:6] = [0, 1, -1, BOUND, -BOUND, 12345678901234567890]
    return vals


def _limbs(vals):
    return np.array([[((v % (1 << 128)) >> (32 * k)) & 0xFFFFFFFF
                      for k in range(4)] for v in vals], np.uint32)


def _dec_pair(vals, scale, seed):
    """(JAX column, the port's copy) of unscaled values, about 20% null."""
    valid = np.random.default_rng(seed).random(len(vals)) > 0.2
    j = jt.Column(jdec.decimal128(scale), jnp.asarray(_limbs(vals)),
                  jt.pack_bools(jnp.asarray(valid)))
    return j, _cross(j)


@pytest.fixture(scope="module")
def dec_operands():
    return (_dec_pair(_unscaled(1, 240), 2, 2),
            _dec_pair(_unscaled(3, 240), 2, 4))


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_decimal_arith_matches_jax(dec_operands, op):
    (ja, pa), (jb, pb) = dec_operands
    jc, jm = getattr(jdec, f"{op}_decimal128")(ja, jb)
    pc, pm = getattr(pdec, f"{op}_decimal128")(pa, pb)
    _same(pc, pm, jc, jm)


@pytest.mark.parametrize("new_scale", [-41, -36, -2, 0, 1, 6, 40, 41])
def test_rescale_matches_jax(dec_operands, new_scale):
    (ja, pa), _ = dec_operands
    jc, jm = jdec.rescale_decimal128(ja, new_scale)
    pc, pm = pdec.rescale_decimal128(pa, new_scale)
    _same(pc, pm, jc, jm)
    assert pc.dtype.scale == new_scale


def test_decimal128_to_strings_matches_jax(dec_operands):
    (ja, pa), _ = dec_operands
    assert pdec.decimal128_to_strings(pa) == jdec.decimal128_to_strings(ja)


@pytest.mark.parametrize("scale", [0, 2, 38, -3])
def test_cast_decimal128_to_string_matches_jax(scale):
    ja, pa = _dec_pair(_unscaled(6, 200), scale, 7)
    _same_padded(pdec.cast_decimal128_to_string(pa),
                 jdec.cast_decimal128_to_string(ja))


# ---------------------------------------------------------------------------
# the port alone against Python oracles (no JAX compiles)
# ---------------------------------------------------------------------------

def _trim(s):
    i, j = 0, len(s)
    while i < j and ord(s[i]) <= 0x20:
        i += 1
    while j > i and ord(s[j - 1]) <= 0x20:
        j -= 1
    return s[i:j]


def _int_oracle(s, bits):
    m = re.fullmatch(r"([+-]?)(\d*)(?:\.(\d*))?", _trim(s))
    if m is None or not (m.group(2) or m.group(3)):
        return None
    v = int(m.group(2) or 0) * (-1 if m.group(1) == "-" else 1)
    return v if -(1 << (bits - 1)) <= v < (1 << (bits - 1)) else None


def _decimal_oracle(s, scale):
    """Spark's decimal cast, less what the JAX package does not do: a
    mantissa whose digits (integer and fraction together) reach 2^128 is
    null even where its value at ``scale`` fits (``ROADMAP.md`` §3)."""
    t = _trim(s)
    m = re.fullmatch(r"[+-]?(\d*)(?:\.(\d*))?(?:[eE][+-]?\d+)?", t)
    if m is None or not (m.group(1) or m.group(2)):
        return None
    # the device parse's rows (the rest punt to an exact host parse)
    on_device = len(s) - len(s.lstrip()) < pcs.TRIM_WIDTH \
        and len(t) <= pcs.DEC_PARSE_WIDTH
    if on_device and int(m.group(1) + (m.group(2) or "") or "0") >> 128:
        return None
    ctx = pydecimal.Context(prec=400)
    q = ctx.create_decimal(t).quantize(pydecimal.Decimal(1).scaleb(-scale),
                                       rounding=pydecimal.ROUND_HALF_UP,
                                       context=ctx)
    v = int(q.scaleb(scale, context=ctx))
    return v if abs(v) <= BOUND else None


def _sweep(seed, n):
    """Random numeric texts: digits, signs, dots, exponents, whitespace,
    and a share of longer bodies that punt."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = rng.choice(["", "-", "+"]) + _digits(rng, rng.integers(0, 24))
        if rng.random() < 0.4:
            s += "." + _digits(rng, rng.integers(0, 20))
        out.append(" " * int(rng.choice([0, 1, 40])) + s
                   + rng.choice(["", " ", "\t"]))
    return out


@pytest.mark.parametrize("kind", INT_KINDS)
def test_string_to_int_oracle(kind):
    texts = _sweep(11, 600)
    out, err = pcs.cast_string_to_int(pt.Column.strings(texts, device="cpu"),
                                      pt.dtype_from_name(kind), device="cpu")
    want = [_int_oracle(s, int(kind[3:])) for s in texts]
    assert out.to_pylist() == want
    assert err.tolist() == [w is None for w in want]


@pytest.mark.parametrize("scale", ORACLE_SCALES)
def test_string_to_decimal_oracle(scale):
    texts = _sweep(12, 400)
    rng = np.random.default_rng(13)
    texts += [_digits(rng, rng.integers(1, 20)) + "." + _digits(rng, 3)
              + "e" + str(rng.integers(-45, 45)) for _ in range(200)]
    out, err = pcs.cast_string_to_decimal128(
        pt.Column.strings(texts, device="cpu"), scale, device="cpu")
    want = [_decimal_oracle(s, scale) for s in texts]
    assert out.to_pylist() == want
    assert err.tolist() == [w is None for w in want]


def _date_texts(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        y, m, d = (int(rng.integers(1, 10000)), int(rng.integers(0, 14)),
                   int(rng.integers(0, 33)))
        s = f"{y:04d}-{m:02d}-{d:02d}"
        if rng.random() < 0.5:
            s += rng.choice([" ", "T"]) + ":".join(
                f"{v:02d}" for v in rng.integers(0, 62, 3))
            if rng.random() < 0.5:
                s += "." + _digits(rng, rng.integers(1, 8))
            s += rng.choice(["", "Z", "+05:30", "-08:00", "UTC", "+19:00"])
        out.append(" " * int(rng.choice([0, 2, 40])) + s)
    return out


def _date_oracle(s):
    m = re.fullmatch(r"(\d{4})-(\d{2})-(\d{2})([T ].*)?", _trim(s))
    if m is None:
        return None
    try:
        d = datetime.date(*(int(g) for g in m.groups()[:3]))
    except ValueError:
        return None
    return (d - datetime.date(1970, 1, 1)).days


def _ts_oracle(s):
    m = re.fullmatch(r"(\d{4})-(\d{2})-(\d{2})(?:[T ](\d{2}):(\d{2}):(\d{2})"
                     r"(?:\.(\d{1,6}))?(Z|UTC|[+-]\d{2}:\d{2})?)?", _trim(s))
    if m is None:
        return None
    try:
        dt = datetime.datetime(*(int(g or 0) for g in m.groups()[:6]),
                               tzinfo=datetime.timezone.utc)
    except ValueError:
        return None
    zone = m.group(8)
    if zone and zone[0] in "+-":
        off = (int(zone[1:3]) * 60 + int(zone[4:])) * (1 if zone[0] == "+"
                                                        else -1)
        if abs(off) > 18 * 60:
            return None
        dt -= datetime.timedelta(minutes=off)
    epoch = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
    frac = (m.group(7) or "").ljust(6, "0")
    return (dt - epoch) // datetime.timedelta(microseconds=1) + int(frac)


def test_string_to_date_oracle():
    texts = _date_texts(14, 600)
    out, err = pcs.cast_string_to_date(pt.Column.strings(texts, device="cpu"),
                                       device="cpu")
    want = [_date_oracle(s) for s in texts]
    assert out.to_pylist() == want
    assert err.tolist() == [w is None for w in want]


def test_string_to_timestamp_oracle():
    texts = _date_texts(15, 600)
    out, err = pcs.cast_string_to_timestamp(
        pt.Column.strings(texts, device="cpu"), device="cpu")
    want = [_ts_oracle(s) for s in texts]
    assert out.to_pylist() == want
    assert err.tolist() == [w is None for w in want]


def test_to_string_oracles():
    """Integers as ``str``, dates and timestamps as ``datetime`` renders
    them (the fraction's trailing zeros trimmed), decimals as
    ``decimal.Decimal`` does at their scale."""
    rng = np.random.default_rng(16)
    v = rng.integers(-(1 << 63), (1 << 63) - 1, 500, endpoint=True)
    v[:2] = [-(1 << 63), (1 << 63) - 1]
    col = pt.Column.from_numpy(v, pt.INT64, device="cpu")
    assert pcs.cast_int_to_string(col, device="cpu").to_pylist() == \
        [str(x) for x in v.tolist()]
    days = rng.integers(-800_000, 3_000_000, 500).astype(np.int32)
    got = pcs.cast_date_to_string(pt.Column.from_numpy(
        days, pt.DATE32, device="cpu"), device="cpu").to_pylist()
    epoch = datetime.date(1970, 1, 1)
    for d, g in zip(days.tolist(), got):
        y = (epoch.toordinal() + d)
        want = datetime.date.fromordinal(y).isoformat() \
            if 1 <= y <= datetime.date.max.toordinal() else None
        assert g == want
    micros = rng.integers(-62135596800 * 10 ** 6, 253402300800 * 10 ** 6,
                          500)
    micros[::2] = micros[::2] // 10 ** 4 * 10 ** 4
    got = pcs.cast_timestamp_to_string(pt.Column.from_numpy(
        micros, pt.TIMESTAMP64, device="cpu"), device="cpu").to_pylist()
    for us, g in zip(micros.tolist(), got):
        dt = datetime.datetime(1970, 1, 1) + datetime.timedelta(
            microseconds=us)
        frac = f"{dt.microsecond:06d}".rstrip("0")
        assert g == f"{dt.year:04d}-{dt:%m-%d %H:%M:%S}" \
            + ("." + frac if frac else "")
    vals = _unscaled(17, 300)
    for scale in ORACLE_SCALES:
        col = pdec.decimal128_from_ints(vals, scale, device="cpu")
        want = [format(pydecimal.Decimal(f"{x}E-{scale}"), "f")
                if scale > 0 else str(x * 10 ** -scale) for x in vals]
        assert pdec.cast_decimal128_to_string(col).to_pylist() == want


def test_decimal_arith_oracle():
    """add, sub, mul and rescale against Python ints: Spark's overflow
    past 38 digits, HALF_UP on the magnitude."""
    a, b = _unscaled(18, 300), _unscaled(19, 300)[::-1]
    ca = pdec.decimal128_from_ints(a, 3, device="cpu")
    cb = pdec.decimal128_from_ints(b, 3, device="cpu")

    def check(res, want, overflows=True):
        col, ovf = res
        want = [w if abs(w) <= BOUND else None for w in want]
        assert col.to_pylist() == want
        assert ovf.tolist() == [w is None for w in want]
        assert (None in want) == overflows
    check(pdec.add_decimal128(ca, cb), [x + y for x, y in zip(a, b)])
    check(pdec.sub_decimal128(ca, cb), [x - y for x, y in zip(a, b)])
    check(pdec.mul_decimal128(ca, cb), [x * y for x, y in zip(a, b)])
    for d in (-38, -5, 4):
        want = []
        for x in a:
            if d >= 0:
                want.append(x * 10 ** d)
            else:
                q, r = divmod(abs(x), 10 ** -d)
                want.append((q + (2 * r >= 10 ** -d)) * (1 if x >= 0
                                                         else -1))
        check(pdec.rescale_decimal128(ca, 3 + d), want, overflows=d > 0)


def test_padded_input_equals_arrow():
    """A dense-padded string column casts as its Arrow form does."""
    arrow = pt.Column.strings(STRINGS[:120], device="cpu")
    padded = arrow.to_padded()
    for fn in (lambda c: pcs.cast_string_to_int(c, pt.INT64, device="cpu"),
               lambda c: pcs.cast_string_to_decimal128(c, 4, device="cpu"),
               lambda c: pcs.cast_string_to_timestamp(c, device="cpu")):
        (a, ea), (p, ep) = fn(arrow), fn(padded)
        pt.assert_tables_equivalent(pt.Table((a,)), pt.Table((p,)),
                                    check_nulls=False)
        assert torch.equal(ea, ep)


@pytest.mark.parametrize("kind", CAST_KINDS)
def test_cast_strings_mix(kind):
    """The device generator's columns: seeded, about 10% null, and the mix
    the card's phase needs: invalid or overflowing rows, and rows that
    punt to the host parse."""
    col = cast_strings(kind, 4000, seed=3, device="cpu")
    again = cast_strings(kind, 4000, seed=3, device="cpu")
    assert torch.equal(col.offsets, again.offsets)
    assert torch.equal(col.chars, again.chars)
    assert 0.07 < 1 - float(col.valid_bools().float().mean()) < 0.13
    if kind.startswith("int"):
        _, err = pcs.cast_string_to_int(col, pt.dtype_from_name(kind),
                                         device="cpu")
        ch, tlen, bounded = pcs._trimmed(col, pcs.PARSE_WIDTH)
        punts = ~bounded | (tlen > pcs.PARSE_WIDTH)
    elif kind == "float":
        _, err = pcs.cast_string_to_float(col, pt.FLOAT64, device="cpu")
        punts = pcs._float_grammar(col, pcs.FLOAT_PARSE_WIDTH)[-1]
    elif kind == "decimal":
        _, err = pcs.cast_string_to_decimal128(col, 2, device="cpu")
        punts = pcs._cast_decimal(col, 2, pcs.DEC_PARSE_WIDTH)[-1]
    else:
        fn = pcs.cast_string_to_date if kind == "date" \
            else pcs.cast_string_to_timestamp
        _, err = fn(col, device="cpu")
        punts = pcs._parse_temporal(col, kind == "timestamp")["punted"]
    assert 0.03 < float(err.float().mean()) < 0.12
    assert 0.002 < float(punts.float().mean()) < 0.02


ENTRY_POINTS = {
    "int": lambda c, **k: pcs.cast_string_to_int(c, pt.INT32, **k),
    "float": lambda c, **k: pcs.cast_string_to_float(c, pt.FLOAT32, **k),
    "decimal": lambda c, **k: pcs.cast_string_to_decimal128(c, 2, **k),
    "date": pcs.cast_string_to_date,
    "timestamp": pcs.cast_string_to_timestamp,
    "int_to_string": pcs.cast_int_to_string,
    "date_to_string": pcs.cast_date_to_string,
    "timestamp_to_string": pcs.cast_timestamp_to_string,
}
_INPUTS = {"int_to_string": pt.INT64, "date_to_string": pt.DATE32,
           "timestamp_to_string": pt.TIMESTAMP64}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_need_a_card_or_the_cpu(name):
    """Without a card a cast raises unless the caller names the CPU; it
    never carries on on the CPU by itself."""
    dt = _INPUTS.get(name)
    col = pt.Column.strings(["1", None], device="cpu") if dt is None else \
        pt.Column.from_numpy(np.array([1, 2], dt.np_dtype), dt, device="cpu")
    ENTRY_POINTS[name](col, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[name](col)
