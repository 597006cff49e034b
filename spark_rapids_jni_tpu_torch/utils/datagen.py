"""Seeded random tables (fixed-width columns, and string columns dense-padded
or in Arrow layout), made
on the device, the edge data the hash kernels are checked on (special
floats, random bloom bitsets), and event-log JSON documents for
``get_json_object`` (:func:`json_event_docs`, made on the host), with
documents built on the get_json kernel's chunk boundaries
(:func:`json_boundary_docs`) and their char window (:func:`json_window`).

The schema helper ``cycle_dtypes`` follows the reference benchmark datagen
(``generate_input.hpp:445-452``).  Values are uniform random bytes, so float
columns hold every bit pattern, NaN payloads included (compare them by
bits); BOOL8 columns hold 0 or 1; decimal128 columns hold any 128 bits,
not only DECIMAL(38) magnitudes; string bytes take all 256 values, not
only UTF-8.  Everything is drawn from one
``torch.Generator`` on the target device, so a 1M-row table needs no host
round trip.  Torch's generators give other numbers than ``jax.random``:
tests that hold the port against the JAX package make their inputs with
numpy instead.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.table import (
    BITS_DTYPES, FLOAT32, FLOAT64, Column, DType, Table, _padded_width,
    pack_bools, resolve_device,
)


def cycle_dtypes(dtypes: Sequence[DType], num_cols: int) -> list:
    """Repeat the dtype list until ``num_cols`` columns (reference
    ``cycle_dtypes``)."""
    return [dtypes[i % len(dtypes)] for i in range(num_cols)]


def random_table(dtypes: Sequence[DType], num_rows: int, *, seed: int = 0,
                 null_probability: Optional[float] = 0.25,
                 string_lens: Tuple[int, int] = (0, 32),
                 string_layout: str = "padded",
                 device=None) -> Table:
    """A table of ``num_rows`` random rows.  Each row of each column is
    null with ``null_probability``; ``None`` gives columns without a
    validity mask.  A ``STRING`` column has lengths uniform in
    ``string_lens`` (the bounds included; the reference ``data_profile``'s
    default 0..32) and is dense-padded (:func:`strings_with_lengths`,
    width the upper bound rounded up to 4) or, with ``string_layout=
    "arrow"``, the same strings in Arrow layout (the JAX package's
    ``DataProfile.string_layout``)."""
    if string_layout not in ("padded", "arrow"):
        raise ValueError(f"string_layout {string_layout!r} is not 'padded' "
                         f"or 'arrow'")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    masks = None
    if null_probability is not None:
        valid = torch.rand((len(dtypes), num_rows), generator=gen,
                           device=dev) >= null_probability
        masks = pack_bools(valid)
    cols = []
    for i, dt in enumerate(dtypes):
        mask = None if masks is None else masks[i]
        if dt.is_string:
            lo, hi = string_lens
            lens = torch.randint(lo, hi + 1, (num_rows,), dtype=torch.int32,
                                 generator=gen, device=dev)
            c = strings_with_lengths(lens, hi, seed=seed + 1 + i,
                                     null_probability=None)
            c = Column.padded_strings(c.chars2d, c.lens, mask)
            cols.append(c.to_arrow() if string_layout == "arrow" else c)
            continue
        raw = torch.randint(0, 256, (num_rows * dt.itemsize,),
                            dtype=torch.uint8, generator=gen, device=dev)
        if dt.kind == "bool8":
            raw &= 1
        if dt.itemsize == 16:        # decimal128: [n, 4] limbs
            data = raw.view(torch.int32).view(num_rows, 4)
        else:
            data = raw.view(BITS_DTYPES[dt.itemsize]).view(dt.torch_dtype)
        cols.append(Column(dt, data, mask))
    return Table(tuple(cols))


def strings_with_lengths(lens: torch.Tensor, max_len: int, *, seed: int = 0,
                         null_probability: Optional[float] = 0.25
                         ) -> Column:
    """A dense-padded string column with the int32 lengths ``lens`` (each
    in ``[0, max_len]``), on their device: random bytes (``0x80`` and above
    included) up to each length and zeros past it, ``W`` = ``max_len``
    rounded up to a multiple of 4.  Each row is null with
    ``null_probability``; ``None`` gives no validity mask."""
    dev = lens.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n, W = lens.shape[0], _padded_width(max_len, None)
    chars = torch.randint(0, 256, (n, W), dtype=torch.uint8, generator=gen,
                          device=dev)
    chars.masked_fill_(torch.arange(W, device=dev) >= lens[:, None], 0)
    validity = None
    if null_probability is not None:
        validity = pack_bools(torch.rand(n, generator=gen, device=dev)
                              >= null_probability)
    return Column.padded_strings(chars, lens, validity)


def random_strings(num_rows: int, max_len: int, *, seed: int = 0,
                   null_probability: Optional[float] = 0.25,
                   device=None) -> Column:
    """A dense-padded string column of ``num_rows`` random rows, lengths
    uniform in ``[0, max_len]`` (see :func:`strings_with_lengths`)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    lens = torch.randint(0, max_len + 1, (num_rows,), dtype=torch.int32,
                         generator=gen, device=dev)
    return strings_with_lengths(lens, max_len, seed=seed + 1,
                                null_probability=null_probability)


def compact_encode_args(lens: torch.Tensor, fixed_end: int, *,
                        seed: int = 0) -> tuple:
    """The compact encode's arguments (``kernels.compact_encode``) for rows
    whose string columns have the int lengths ``lens [n, k]`` (any ``k`` up
    to the kernel's 128, past what a JCUDF layout holds), on their device:
    random fixed sections of ``fixed_end`` bytes at a stride of
    ``fixed_end`` rounded up to 8 (zeros past ``fixed_end``), row offsets of
    the rows' sizes (``fixed_end`` plus their lengths, rounded up to 8),
    and column ``c``'s random chars from offset ``(5 c + 1) % 16`` of its
    buffer, so that 16 columns start at every residue mod 16."""
    dev = lens.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n, k = lens.shape
    lens = lens.to(torch.int64)
    stride = -(-fixed_end // 8) * 8
    fixed = torch.randint(0, 256, (n, stride), dtype=torch.uint8,
                          generator=gen, device=dev)
    fixed[:, fixed_end:] = 0
    sizes = (fixed_end + lens.sum(1) + 7) // 8 * 8
    row_offsets = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    row_offsets[1:] = torch.cumsum(sizes, 0)
    strings = []
    for c in range(k):
        lead = (5 * c + 1) % 16
        offsets = torch.full((n + 1,), lead, dtype=torch.int64, device=dev)
        offsets[1:] += torch.cumsum(lens[:, c], 0)
        chars = torch.randint(0, 256, (int(offsets[-1]) + 3,),
                              dtype=torch.uint8, generator=gen, device=dev)
        strings.append((chars, offsets.to(torch.int32), 0))
    return (fixed, fixed_end, row_offsets.to(torch.int32),
            int(row_offsets[-1]), strings)


def compact_gather_args(blob: torch.Tensor, row_offsets: torch.Tensor,
                        fixed_end: int, lens: torch.Tensor) -> tuple:
    """The string gather's arguments (``kernels.string_gather``) for the
    rows :func:`compact_encode_args` makes from ``lens [n, k]``, encoded
    into ``blob``: each string at ``fixed_end`` plus the lengths before it
    in its row, and each column's output offsets the lengths' running
    sum."""
    lens = lens.to(torch.int64)
    offs = fixed_end + torch.cumsum(lens, 1) - lens
    pairs, totals = [], []
    for c in range(lens.shape[1]):
        out_off = torch.zeros(lens.shape[0] + 1, dtype=torch.int64,
                              device=lens.device)
        out_off[1:] = torch.cumsum(lens[:, c], 0)
        pairs.append((offs[:, c].to(torch.int32).contiguous(),
                      lens[:, c].to(torch.int32).contiguous(),
                      out_off.to(torch.int32)))
        totals.append(int(out_off[-1]))
    return blob, row_offsets, pairs, totals


# float bits the hashes normalise: signed zeros, NaN payloads (quiet and
# signalling, either sign), infinities, a normal value and a denormal
_F64_SPECIAL = [0x8000000000000000, 0x0, 0x7FF0000000000001,
                0xFFF8000000000123, 0x7FF0000000000000, 0xFFF0000000000000,
                0x3FF0000000000000, 0x0000000000000001]
_F32_SPECIAL = [0x80000000, 0x0, 0x7F800001, 0xFFC00123, 0x7F800000,
                0xFF800000, 0x3F800000, 0x00000001]


def special_floats(num_rows: int, *, device=None) -> Table:
    """A FLOAT64 and a FLOAT32 column cycling through signed zeros, NaN
    payloads, infinities, 1.0 and the smallest denormal, without nulls."""
    dev = resolve_device(device)
    cols = []
    for dt, bits in ((FLOAT64, _F64_SPECIAL), (FLOAT32, _F32_SPECIAL)):
        top = 1 << (8 * dt.itemsize)
        vals = [b - top if b >= top >> 1 else b for b in bits]
        t = torch.tensor(vals, dtype=BITS_DTYPES[dt.itemsize], device=dev)
        t = t.repeat(num_rows // len(vals) + 1)[:num_rows]
        cols.append(Column(dt, t.view(dt.torch_dtype)))
    return Table(tuple(cols))


def random_bitset(num_words: int, density: float, *, seed: int = 0,
                  device=None) -> torch.Tensor:
    """int64 ``[num_words]``: a long[] bitset whose bits are set with
    probability ``density`` each, as a bloom probe's test filter."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    bits = torch.rand((num_words * 8, 8), generator=gen,
                      device=dev) < density
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    return (bits.to(torch.uint8) << shifts).sum(1).to(torch.uint8) \
        .view(torch.int64)


# kinds of json_event_docs' documents
EVENT_PLAIN, EVENT_ESCAPED, EVENT_CONTAINER, EVENT_MALFORMED, EVENT_NULL = \
    range(5)
_EVENTS = ("page_view", "click", "add_to_cart", "purchase", "search")
_NAMES = ("ana", "bo", "chen", "dana", "émile", "farah", "gus", "hiro")


def json_event_docs(num_rows: int, *, seed: int = 0, special: float = 0.01,
                    lengths: Tuple[int, int] = (100, 1000)):
    """``num_rows`` event-log JSON documents of a clickstream shape, and
    their kinds (int8 numpy, ``EVENT_*``): an object with a number ``a``, a
    ``user`` object (string ``id``, a name, a tag array), 0 to 5 ``items``
    objects (``sku``, ``qty``, ``price_cents``) and a filler ``note`` that
    takes each document to a length uniform in ``lengths`` where its fields
    leave room.  Each of four special kinds takes a ``special`` share of the
    rows: the values at ``$.a``, ``$.user.id`` and ``$.items[2].sku`` are
    strings with escapes (``EVENT_ESCAPED``) or containers
    (``EVENT_CONTAINER``), the keys are unquoted (``EVENT_MALFORMED``, as a
    JavaScript literal), or the row is null (None, ``EVENT_NULL``).
    Numbers are integers and no key repeats, so ``json.loads`` reads every
    well-formed document as Spark does."""
    rng = np.random.default_rng(seed)
    u = rng.random(num_rows)
    kinds = np.where(u < 4 * special, (u // special).astype(np.int8) + 1,
                     EVENT_PLAIN).astype(np.int8)
    target = rng.integers(lengths[0], lengths[1] + 1, num_rows)
    nums = rng.integers(0, 1 << 31, (num_rows, 4))
    nitems = rng.integers(0, 6, num_rows)
    docs = []
    for i in range(num_rows):
        kind = kinds[i]
        if kind == EVENT_NULL:
            docs.append(None)
            continue
        x, y, z, w = (int(v) for v in nums[i])
        k = int(nitems[i])
        if kind == EVENT_ESCAPED:
            a, uid = f'"line\\n{x % 997} \\"q\\""', f'"u\\t{y}"'
            sku2, k = f'"S\\\\{z % 9973}"', max(k, 3)
        elif kind == EVENT_CONTAINER:
            a, uid = f'{{"x": [{x % 7}, {y % 5}], "y": "z"}}', f'[{y % 9}, 2]'
            sku2, k = f'{{"k": {z % 11}}}', max(k, 3)
        else:
            a, uid, sku2 = str(x % 100_000), f'"u-{y}"', None
        skus = [sku2 if j == 2 and sku2 else f'"SKU-{z + j}"'
                for j in range(k)]
        items = ", ".join(
            f'{{"sku": {sku}, "qty": {1 + (w + j) % 9}, '
            f'"price_cents": {(w >> 3) % 99_999}}}'
            for j, sku in enumerate(skus))
        doc = (f'{{"a": {a}, "event": "{_EVENTS[x % 5]}", "ts": {w}, '
               f'"user": {{"id": {uid}, "name": "{_NAMES[y % 8]}", '
               f'"tags": ["t{z % 13}", "t{w % 17}"]}}, "items": [{items}], '
               f'"note": "')
        fill = int(target[i]) - len(doc.encode()) - 3
        doc += "n" * max(fill, 0) + '"}'
        if kind == EVENT_MALFORMED:
            doc = re.sub(r'"(\w+)":', r"\1:", doc)
        docs.append(doc)
    return docs, kinds


# the first key of each path the boundary documents serve, with a value
# under which that path goes on: $.a, $.user.id, $.items[2].sku,
# $.p.q[1].r.s[0][1].t and a 254-byte key
_BOUNDARY_VALUES = (
    (b"a", b"12"), (b"user", b'{"id": "u-7"}'),
    (b"items", b'[{"sku": "s0"}, {"sku": "s1"}, {"sku": "s2"}]'),
    (b"p", b'{"q": [0, {"r": {"s": [[1, {"t": 7}]]}}]}'),
    (b"k" * 254, b"[1, 2]"),
)


def json_boundary_docs(width: int) -> list:
    """JSON documents (bytes) built so that the chars the get_json
    automaton must step sit on the 16-char chunk boundaries of its kernel
    (K9), for a window of ``width`` chars (cut there): for every boundary
    ``b`` in 16, 32, ``width - 16`` and ``width`` (and the char just before
    and after it), a string's closing ``"``, a ``\\`` escape, a key's
    opening ``"`` (of each path's first key, so that the paths descend past
    it) and a value's opening ``"``; runs of 1 to 4 backslashes across a
    boundary, each before a ``"`` and before another char; ``{`` and an
    index frontier's commas before spaces across a boundary; a char that
    is not a key's quote where a key is expected; windows cut inside a
    string, a key, after a colon (or with the colon just before a boundary
    and zeros after it) and inside a scalar; 300 opens before the zeros;
    NUL bytes in a string and in a key."""
    docs = []
    spots = sorted({p for b in (16, 32, width - 16, width)
                    for p in (b - 1, b, b + 1) if 0 < p < width})

    def pad(head: bytes, at: int, fill: bytes = b" ") -> bytes:
        # head, then fill up to position `at` (where the next byte lands)
        return head + fill * (at - len(head))

    for p in spots:
        if p >= 8:
            # a string value's closing quote, and a backslash, at p
            docs.append(pad(b'{"a": "', p, b"n") + b'", "b": 1}')
            docs.append(pad(b'{"a": "', p, b"n") + b'\\"q", "a": 2}')
            docs.append(pad(b'{"n": "', p, b"n") + b'\\\\", "a": 3}')
            # a value's opening quote at p
            docs.append(pad(b'{"a":', p) + b'"v", "b": 1}')
        if p >= 9:
            # a key's opening quote at p, for each path's first key
            for key, value in _BOUNDARY_VALUES:
                docs.append(pad(b'{"x": 0,', p) + b'"' + key + b'": '
                            + value + b"}")
        # the colon at p - 1, then the zeros (a value pending at the end)
        if p >= 5:
            docs.append(pad(b'{"a"', p - 1) + b":")
            docs.append(pad(b'{"items": [0, 1,', p))
        # { at p - 1 (a key expected) and spaces to the next boundary; a
        # char at p that is no key's quote, after a { or a comma (it
        # clears the expected key)
        if p >= 2:
            docs.append(pad(b"{", p - 1, b" ") + b"{" + b" " * 20
                        + b'"a": 5}')
            docs.append(pad(b"{", p) + b'z"a": 5}')
        if p >= 9:
            docs.append(pad(b'{"x": 0,', p) + b'z "a": 6}')
        # an index frontier's second comma at p - 1, spaces after it
        if p >= 14:
            docs.append(pad(b'{"items": [0,', p - 1) + b"," + b" " * 20
                        + b'{"sku": "s"}]}')
    for b in (16, 32, width - 16):
        for run in range(1, 5):
            for first in range(b - run, b + 1):
                if first < 8:
                    continue
                head = pad(b'{"a": "', first, b"n") + b"\\" * run
                docs.append(head + b'", "a": 4}')
                docs.append(head + b'n", "a": 5}')
    # windows cut inside a string, a key, after a colon, inside a scalar
    docs += [b'{"a": "' + b"n" * width, b'{"x": 1, "' + b"a" * width,
             pad(b'{"x": 1,', width - 4) + b'"a":',
             pad(b'{"x": 1,', width - 3) + b'"a":',
             b'{"a": ' + b"1" * width, b'{"a": -' + b"9" * width]
    # 300 opens, then the zeros; NUL bytes in a string and in a key
    docs += [b"[" * 300, b'{"a": ' + b"[" * 300,
             b'{"a": 1, "z": ' + b"{" * 300,
             b'{"a": "x\x00y", "b": 1}',
             pad(b'{"n": "', 14, b"n") + b"\x00" * 20 + b'", "a": 6}',
             b'{"a\x00": 1, "a": 7}']
    return [d[:width] for d in docs]


def json_window(docs: Sequence[bytes], width: int, *,
                device=None) -> torch.Tensor:
    """uint8 ``[len(docs), width]`` on ``device``: each document's bytes cut
    at ``width``, zeros after them."""
    mat = np.zeros((len(docs), width), np.uint8)
    for i, d in enumerate(docs):
        d = d[:width]
        mat[i, :len(d)] = np.frombuffer(d, np.uint8)
    return torch.from_numpy(mat).to(resolve_device(device))
