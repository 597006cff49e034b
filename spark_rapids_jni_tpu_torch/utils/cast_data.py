"""Seeded string columns for Spark's casts, made on the device, and a fixed
list of their edge strings.

:func:`cast_strings` draws each row from weighted templates of the target
type's text: digits, signs, fractions, exponents, f/d suffixes, special and
hex literals, partial dates, separators, fractions of seconds and zones,
with about 5% invalid rows, about 1% overflowing ones, and about 0.5% whose
whitespace or body outruns the casts' fixed windows, so that they take the
host parse.  A template is text with fields in braces: ``{D3}`` three
random digits, ``{N1}`` a nonzero digit, ``{H2}`` two hex digits, ``{W1}``
a whitespace char, and runs that render one random value each, zero
padded: ``{Y4}`` a year 1..9999, ``{M2}`` a month, ``{A2}`` a day 1..28,
``{B2}`` a day 29..31, ``{h2}`` an hour, ``{m2}`` a minute, ``{s2}`` a second,
``{z2}`` a zone hour 0..14, ``{w2}`` a zone minute (0, 30 or 45).  Every
row may also get up to two whitespace chars on each side.

:data:`CAST_EDGE_STRINGS` holds a few hundred fixed strings at the edges of
every cast (bounds of each integer type, float and decimal extremes,
special literals, calendar edges, the int64 microsecond range, window
overflows), for tests and for the card's check against the CPU.
"""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple

import torch

from spark_rapids_jni_tpu_torch.table import Column, pack_bools, resolve_device

# whitespace a trim removes (ASCII <= 0x20)
_WS = b" \t\n\r\x0b\x0c"
_HEX = b"0123456789abcdefABCDEF"
# per-position kinds, then run fields (code >= _FIELD0)
_LIT, _DIG, _NZ, _HEXD, _WSP = range(5)
_FIELD0 = 8
_FIELDS = {  # run field -> (least, greatest value, or a set of values)
    "Y": (1, 9999), "M": (1, 12), "A": (1, 28), "B": (29, 31),
    "h": (0, 23), "m": (0, 59), "s": (0, 59), "z": (0, 14),
    "w": (0, 30, 45),
}
_PER_POS = {"D": _DIG, "N": _NZ, "H": _HEXD, "W": _WSP}
_TOKEN = re.compile(r"\{([A-Za-z])(\d+)\}")


def _ints(kind: str) -> List[Tuple[str, float]]:
    bits = int(kind[3:])
    hi = (1 << (bits - 1)) - 1
    D = len(str(hi))
    valid = []
    for k in range(1, D):
        body = "{N1}" + (f"{{D{k - 1}}}" if k > 1 else "")
        for sign in ("", "-", "+"):
            valid.append((sign + body, 3.0 if sign != "+" else 0.5))
        valid.append(("-" + body + ".{D2}", 1.0))
        valid.append((body + ".{D1}", 1.0))
    edges = [(str(hi), 0.3), (str(-hi - 1), 0.3), ("0", 0.3), ("-0", 0.1),
             (".5", 0.1), ("7.", 0.1), ("0" * 31 + "1", 0.1)]
    over = [("{N1}" + f"{{D{D}}}", 0.5), ("-{N1}" + f"{{D{D}}}", 0.5),
            (str(hi + 1), 0.1), (str(-hi - 2), 0.1)]
    bad = ["{D3}x", "x{D2}", "{D2}.{D1}.{D1}", "--{D2}", "", "-", "+", ".",
           "{D2}e{D1}", "{D1} {D1}", "abc", "{D1}.x", "+.", "1,5", "0x1F"]
    return _weigh(valid, 93.5) + _weigh(edges, 1.0) + _weigh(over, 1.0) \
        + _weigh([(b, 1.0) for b in bad], 5.0) \
        + [("0" * 34 + "{N1}{D2}", 0.25)]


def _floats() -> List[Tuple[str, float]]:
    valid = []
    for k in range(0, 9, 2):
        lead = "{N1}" + (f"{{D{k}}}" if k else "")
        for frac in ("", ".{D1}", ".{D3}", ".{D6}"):
            for sign in ("", "-"):
                valid.append((sign + lead + frac, 2.0))
        for exp in ("e{D1}", "E-{D2}", "e+{D2}", "e3{D2}", "e-3{D2}"):
            valid.append((lead + ".{D2}" + exp, 1.0))
        for suffix in ("f", "d", "F", "D"):
            valid.append((lead + ".{D2}" + suffix, 0.5))
    valid += [(".{D3}", 1.0), ("-.{D2}", 1.0), ("{D2}.", 1.0),
              ("{N1}.{D9}{D9}{D9}", 1.0), ("0.0", 0.5), ("-0.0", 0.5)]
    specials = ["Infinity", "-Infinity", "+Infinity", "inf", "-INF", "+inF",
                "NaN", "+NaN", "-NaN", "nan", "NAN", "infinity"]
    hexes = ["0x1.{H3}p{D1}", "-0x{H2}p-{D2}", "0X1P3", "0x1p1f", "0x.8p1",
             "0x1.8p1", "0x{H1}.{H2}p+{D1}d"]
    bad = ["1e", "e5", "1.2.3", "--1", "1,5", "abc", "", ".", "1e+-3",
           "+nan", "-nAn", "NaNf", "0xp1", "0x1.8", "{D2}x", "- 1", "1f5"]
    return _weigh(valid, 90.5) + _weigh([(s, 1.0) for s in specials], 2.5) \
        + _weigh([(s, 1.0) for s in hexes], 0.5) \
        + _weigh([(b, 1.0) for b in bad], 5.0) \
        + [("{N1}" + "{D9}" * 4 + "{D3}", 0.25),
           ("1e39", 0.25), ("-{N1}e4{D2}", 0.25)]


def _decimals() -> List[Tuple[str, float]]:
    valid = []
    for k in (0, 1, 3, 6, 9, 12, 15):
        lead = "{N1}" + (f"{{D{k}}}" if k else "")
        for frac in ("", ".{D1}", ".{D2}", ".{D5}"):
            for sign in ("", "-", "+"):
                valid.append((sign + lead + frac, 2.0 if sign != "+" else
                              0.3))
        for exp in ("e{D1}", "E-{D1}", "e+1{D1}"):
            valid.append((lead + ".{D3}" + exp, 1.0))
    valid += [(".{D4}", 1.0), ("-.{D3}", 1.0), ("{D3}.", 1.0),
              ("0.00{D3}5", 1.0), ("{N1}{D9}{D9}", 1.0)]
    over = [("{N1}{D9}{D9}{D9}{D9}{D2}", 0.5),
            ("-{N1}{D9}{D9}{D9}{D9}{D2}", 0.3), ("1e39", 0.2)]
    bad = ["", "abc", "1.2.3", "--1", "1e", "12x", "e5", ".", "-", "1e+",
           "{D2}.{D2}e", "+-1", "0x10"]
    return _weigh(valid, 93.5) + _weigh(over, 1.0) \
        + _weigh([(b, 1.0) for b in bad], 5.0) \
        + [("0" * 46 + "{N1}.{D2}", 0.25)]


_DATE = "{Y4}-{M2}-{A2}"


def _dates() -> List[Tuple[str, float]]:
    valid = [(_DATE, 40.0), ("{Y4}-{M1}-{A1}", 6.0), ("{Y4}-{M2}", 4.0),
             ("{Y4}", 3.0), ("+" + _DATE, 2.0), ("-" + _DATE, 2.0),
             (_DATE + "T{h2}:{m2}:{s2}", 8.0), (_DATE + " {D3}", 4.0),
             (_DATE + "T", 2.0), ("{Y4}-{M2}-{B2}", 4.0), ("{Y4}-02-29", 1.0),
             ("+{N1}{D4}-{M2}-{A2}", 2.0), ("{Y1}-{M1}-{A1}", 2.0),
             ("-{D6}", 1.0), ("{D7}-{M2}", 1.0), ("0001-01-01", 0.5),
             ("9999-12-31", 0.5), ("1970-01-01", 0.5)]
    over = [("+{N1}{D6}-{M2}-{A2}", 0.6), ("-{N1}{D6}", 0.4)]
    bad = ["", "abc", "{Y4}-1{D1}-{A2}x", "{Y4}/{M2}/{A2}", "{Y4}-",
           "{Y4}--{M2}", "{Y4}-{M2}-{A2}x", "{Y4}-00-{A2}", "{Y4}-{M2}-00",
           "12:30:00", "{D2}a{D1}", "{Y4}-{D3}-{A2}"]
    return _weigh(valid, 93.5) + _weigh(over, 1.0) \
        + _weigh([(b, 1.0) for b in bad], 5.0) \
        + [(_DATE + "T" + "{D9}" * 5, 0.25)]


def _timestamps() -> List[Tuple[str, float]]:
    hms = "{h2}:{m2}:{s2}"
    zones = [("", 6.0), ("Z", 1.0), ("UTC", 1.0), ("+{z2}:{w2}", 1.5),
             ("-{z2}:{w2}", 1.5), ("-{z1}", 0.5), ("+{z2}", 0.5)]
    fracs = [("", 3.0)] + [("." + "{D%d}" % k, 1.0) for k in range(1, 7)]
    valid = []
    for sep in (" ", "T"):
        for frac, wf in fracs:
            for zone, wz in zones:
                valid.append((_DATE + sep + hms + frac + zone, wf * wz))
    valid += [(_DATE, 6.0), ("{Y4}-{M2}", 2.0), ("{Y4}", 1.0),
              (_DATE + " {h2}:{m2}", 3.0), (_DATE + "T{h2}", 2.0),
              (_DATE + " {h1}:{m1}:{s1}", 2.0), (_DATE + "T", 1.0),
              (_DATE + " {h2}+{z2}:{w2}", 1.0),
              ("{Y4}-{M2}-{B2} " + hms, 4.0),
              ("+2{N1}{D4}-{M2}-{A2}T" + hms, 1.0),
              ("-2{N1}{D4}-{M2}-{A2}T" + hms, 1.0)]
    over = [("+29{N1}{D3}-{M2}-{A2}T" + hms, 0.5),
            ("-29{N1}{D3}-{M2}-{A2}", 0.3), ("{N1}{D6}-01-01", 0.2)]
    bad = ["", "bad", _DATE + " 2{N1}:00:00", _DATE + " {h2}:6{D1}:00",
           _DATE + " " + hms + ".{D7}", _DATE + " " + hms + " PST",
           _DATE + "T" + hms + "America/Los_Angeles",
           _DATE + " " + hms + "+19:00", _DATE + " " + hms + "+{z2}:{D1}",
           _DATE + " {h2}:{m2}:", _DATE + "x" + hms, _DATE + " " + hms + "Zx"]
    return _weigh(valid, 93.5) + _weigh(over, 1.0) \
        + _weigh([(b, 1.0) for b in bad], 5.0) \
        + [(_DATE + " " + hms + ".{D6}+{z2}:{w2}" + " " * 40, 0.25)]


def _weigh(items: Sequence[Tuple[str, float]],
           share: float) -> List[Tuple[str, float]]:
    """The templates with their weights scaled to sum to ``share``."""
    total = sum(w for _, w in items)
    return [(t, w * share / total) for t, w in items]


CAST_KINDS = ("int8", "int16", "int32", "int64", "float", "decimal", "date",
              "timestamp")


def _templates(kind: str) -> List[Tuple[str, float]]:
    if kind.startswith("int"):
        return _ints(kind)
    return {"float": _floats, "decimal": _decimals, "date": _dates,
            "timestamp": _timestamps}[kind]()


def _compile(templates: Sequence[str]):
    """Each template as three rows (literal byte, kind code, digit
    exponent) padded to one width, and its length."""
    rows = []
    for t in templates:
        cells = []                       # (literal, code, exponent)
        at = 0
        for m in _TOKEN.finditer(t):
            cells += [(ch, _LIT, 0) for ch in t[at:m.start()].encode()]
            name, w = m.group(1), int(m.group(2))
            if name in _PER_POS:
                cells += [(0, _PER_POS[name], 0)] * w
            else:
                code = _FIELD0 + list(_FIELDS).index(name)
                cells += [(0, code, w - 1 - j) for j in range(w)]
            at = m.end()
        cells += [(ch, _LIT, 0) for ch in t[at:].encode()]
        rows.append(cells)
    W = max(1, max(len(r) for r in rows))
    table = torch.tensor([r + [(0, _LIT, 0)] * (W - len(r)) for r in rows],
                         dtype=torch.int64).permute(0, 2, 1)
    lens = torch.tensor([len(r) for r in rows], dtype=torch.int64)
    return table, lens


def cast_strings(kind: str, num_rows: int, *, seed: int = 0,
                 device=None) -> Column:
    """An Arrow-layout string column of ``num_rows`` texts of ``kind`` (one
    of :data:`CAST_KINDS`: an integer type, ``float``, ``decimal``,
    ``date`` or ``timestamp``), drawn on the device from one seed; each row
    null with probability 0.1."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n = num_rows
    spec = _templates(kind)
    table, tlens = _compile([t for t, _ in spec])
    table, tlens = table.to(dev), tlens.to(dev)
    weights = torch.tensor([w for _, w in spec], dtype=torch.float64,
                           device=dev)
    tid = torch.multinomial(weights, n, replacement=True, generator=gen)
    lit, code, expo = table[tid, 0], table[tid, 1], table[tid, 2]
    W = lit.shape[1]

    def draw(hi, shape=(n, W)):
        return torch.randint(0, hi, shape, generator=gen, device=dev)
    ws = torch.tensor(list(_WS), dtype=torch.int64, device=dev)
    hexd = torch.tensor(list(_HEX), dtype=torch.int64, device=dev)
    fields = []
    for rng in _FIELDS.values():
        if len(rng) == 2:
            fields.append(rng[0] + draw(rng[1] - rng[0] + 1, (n,)))
        else:
            fields.append(torch.tensor(rng, device=dev)[draw(len(rng),
                                                              (n,))])
    values = torch.stack(fields, dim=1)
    p10 = torch.tensor([10 ** e for e in range(8)], device=dev)
    field = torch.gather(values, 1, (code - _FIELD0).clamp(min=0))
    core = torch.where(code == _DIG, ord("0") + draw(10), lit)
    core = torch.where(code == _NZ, ord("1") + draw(9), core)
    core = torch.where(code == _HEXD, hexd[draw(len(_HEX))], core)
    core = torch.where(code == _WSP, ws[draw(len(_WS))], core)
    core = torch.where(code >= _FIELD0, ord("0") + field // p10[expo] % 10,
                       core)
    clen = tlens[tid]
    # up to two whitespace chars on each side (none on most rows), and
    # forty before the text on a quarter percent of them (a long body on
    # another quarter percent: the two ways a row punts)
    u = torch.rand(n, generator=gen, device=dev)
    lead = torch.where(u < 0.8, 0, draw(3, (n,)))
    lead = torch.where(u > 0.9975, 40, lead)
    trail = torch.where(torch.rand(n, generator=gen, device=dev) < 0.8, 0,
                        draw(3, (n,)))
    lens = lead + clen + trail
    Wt = (W + 44 + 3) // 4 * 4
    pos = torch.arange(Wt, device=dev)[None, :]
    src = (pos - lead[:, None]).clamp(0, W - 1)
    body = torch.gather(core, 1, src)
    in_body = (pos >= lead[:, None]) & (pos < (lead + clen)[:, None])
    mat = torch.where(in_body, body, ws[draw(len(_WS), (n, Wt))])
    mat = torch.where(pos < lens[:, None], mat, 0).to(torch.uint8)
    valid = torch.rand(n, generator=gen, device=dev) >= 0.1
    return Column.padded_strings(mat, lens.to(torch.int32),
                                 pack_bools(valid)).to_arrow()


_I64_MAX = (1 << 63) - 1

CAST_EDGE_STRINGS = [
    # integers: signs, whitespace, fractions that truncate, the bounds of
    # every width and one past them, bodies around the parse window
    "123", "-45", "+7", "  +12 ", "  42  ", "1.9", "-1.9", "1.x", "0", "-0",
    "", "   ", ".", "1.", ".5", "-.5", "+.", "-", "+", "--1", "1.2.3",
    "abc", "12a", "a12", "1 2", "\t-8\n", "1.999999",
    "127", "128", "-128", "-129", "32767", "32768", "-32768", "-32769",
    "2147483647", "2147483648", "-2147483648", "-2147483649",
    str(_I64_MAX), str(_I64_MAX + 1), str(-_I64_MAX - 1), str(-_I64_MAX - 2),
    "00000000000000000000123", "9" * 33, "1" + "0" * 32,
    "0" * 31 + "9", "0" * 33 + "9", "0" * 40 + "123",
    "999999999999999999999999999999",
    "123" + " " * 30, " " * 30 + "-77" + " " * 30, "\t" * 32 + "5",
    "5" + " " * 33, " " * 40, " " * 40 + "2147483648", " " * 40 + "12.75",
    " " * 40 + "1.x", " " * 40 + "-9223372036854775808",
    " " * 40 + "9223372036854775807",
    # floats: grammar, suffixes, special literals by Spark's two stages,
    # hex literals, float32 rounding across a midpoint, over- and underflow
    "1.5", "-2.25", "+3", "5.", "1e3", "1E-2", "2.5e+10", "  7.125  ",
    "1.7976931348623157e308", "1.8e308", "4.9e-324", "2e-330",
    "123456789.123456789", "1.5f", "2.5D", "3d", "1e39", "-1e39", "3.4e38",
    "3.4028235e38", "3.4028236e38", "1.4e-45", "7e-46",
    "inf", "-inf", "+inf", "Infinity", "-INFINITY", "NaN", "nan", "nAn",
    "+nan", "+NAN", "-nan", "+NaN", "-NaN", "NaNf", "Infinityf",
    "0x1p1", "0x1.8p1", "-0x1.8p-2", "0X1P3", "0x1p1f", "  0x1p1  ",
    "0x1f", "0xp1", "0x1.8", "0x1p1024", "-0x1p1024", "0x1p-1080",
    "0x1.0000010000000000001p0", "0x.8p1", "0x10", "1e", "e5", "++1",
    "1,5", "1e+-3", "9" * 50, "1." + "0" * 60 + "5",
    "1.00000005960464477539062500001", "1.000000059604644775390625",
    "16777217", "16777217.000000000000000000001", "0.1f", "1e-45f",
    # decimals: HALF_UP at every scale, 38 digits and one more, exponents
    "123.45", "-123.45", "0.005", "-0.005", "1.005", "2.675", "+7.1",
    "1e2", "1.5e3", "-2.5e-3", "123e-2", "99999999999999999999999999999999"
    "999999", "-99999999999999999999999999999999999999",
    "1" + "0" * 38, "0.00000000000000000000000000000000000001",
    "0.000000000000000000000000000000000000005", "12x", "9" * 60,
    "0" * 45 + "7.25", "1e-39", "5e-39", "1e38", "1e37", "0.5", "-0.5",
    "1.23456789012345678901234567890123456789",
    "12345678901234567890.123456789012345678",
    # dates: forms, leap days, signs, calendar and range edges
    "2023-01-15", "1970-01-01", "1969-12-31", "2000-02-29", "1900-02-28",
    "2023-1-5", "2023-12", "2023", "+2023", "-0044", "0001-01-01",
    "9999-12-31", "  2016-07-07  ", "2023-01-15T12:34:56", "2023-01-15 x",
    "2023-01-15Tanything", "2023-02-29", "2020-02-30", "2023-13-01",
    "2023-00-10", "2023-01-32", "2023-01-00", "1900-02-29", "2023-",
    "2023--05", "20a3", "12:30:00", "2023-01-15x", "+2023-05-01",
    "-0044-03-15", "+9999999", "+10000-01-01", "-10000-12-31",
    "+5000000-12-31", "-5000000-01-01", "+5000001-01-01",
    "2023-01-15T" + "y" * 45, " " * 40 + "2016-07-07",
    # timestamps: separators, partial times, fractions, zones, region ids,
    # and the int64 microsecond range at both ends
    "2023-01-15 12:34:56", "2023-01-15T12:34:56", "2023-01-15 00:00:00.5",
    "2023-01-15 23:59:59.999999", "2023-01-15 12:34:56Z",
    "2023-01-15 12:34:56UTC", "2023-01-15 12:34:56+05:30",
    "2023-01-15 12:34:56-08:00", "2023-01-15 12:34:56+5",
    "1969-12-31 23:59:59.123", "1970-01-01 00:00:00", "  2016-07-07 7:3:1  ",
    "2023-01-15 24:00:00", "2023-01-15 12:60:00", "2023-01-15 12:34:61",
    "2023-01-15 12:34:56.1234567", "2023-01-15 12:34", "2023-01-15 12",
    "2023-01-15 12:34:56 PST", "2023-01-15T12:34:56America/New_York",
    "bad", "2023-01-15 12:34:56+18:30", "2023-01-15 12:34:56+18:00",
    "2023-01-15 12+05:30", "2020-01-01T00:00:00.123456+14:00",
    "2023-01-15T" + "x" * 45, " " * 40 + "2023-01-15 06:07:08",
    "+294247-01-10T04:00:54.775807", "+294247-01-10T04:00:54.775808",
    "-290308-12-21T19:59:05.224192", "-290308-12-21T19:59:05.224191",
    "290000-01-01", "-290000-01-01", "+294248-01-01", "-290309-01-01",
    "2999999-01-01", "-2999999-06-15",
    " " * 64 + "+294247-01-10T04:00:54.775807" + " " * 64,
    " " * 64 + "+294247-01-10T04:00:54.775808" + " " * 64,
    "2023-01-15 12:34:56.", "2023-01-15 12:34:.5", "2023-01-15T",
    "2023-01-15 12:34:56Zx", "2023-01-15 12:34:56+05:3",
    "2023-01-15 12:34:56-18:00", "2023-01-15 12:34:56+1:30",
]
