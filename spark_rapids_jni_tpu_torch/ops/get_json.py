"""``get_json_object``: JSON path extraction over string columns.

The PyTorch counterpart of the non-wildcard route of
``spark_rapids_jni_tpu.ops.get_json`` (Spark's ``GetJsonObject``) for
object-key and array-subscript paths (``$.k1.k2``, ``$.a[0].b``,
``$[1][2]``):

- :func:`gjo_scan` (K9, ``csrc/gjo_scan.cu``) replaces the TPU kernel
  ``spark_rapids_jni_tpu/ops/pallas_kernels.py::_gjo_scan_kernel``: the
  path automaton over every row's padded char window, one thread a row,
  int32 ``[6, n]`` of (start, end, found, capturing, bad, deep); it skips
  the runs of chars that leave the automaton's carry as it is.  Its
  plain version :func:`gjo_scan_plain` is the JAX package's
  ``_automaton_pieces`` step (:func:`_plain_step`) run over the window
  position by position (``_scan_automaton``), with torch ops on ``[n]``
  vectors; :func:`gjo_scan_walk` replays the kernel's walk beside it
  (which chars it skips, :func:`_quiet_chars`).
- The tail after the scan (value extraction, the punt classes, the
  assembly) is torch glue, as it is XLA in the JAX package.
- The host fixup is part of the function, as in the JAX package: rows whose
  value is a string with escapes (decoded), a container (Spark's compact
  rendering) or whose document nests past the automaton's uint8 depth
  budget are re-extracted on the host with Python's ``json``.  The device
  assembly nulls them; one host read of whether any row needs it gates the
  fixup, which copies only those rows' chars to the host and their results
  back.

Semantics (Spark's): the result is the raw JSON text of the value (objects
and arrays in compact form, numbers as written, literals), or the content
of a string value (quotes stripped, escapes decoded); a missing path,
invalid JSON or a traversal through a non-container gives null; null input
rows give null.  Duplicate keys bind to the first.

An Arrow-layout column is scanned through its padded window, as in the JAX
package: ``max_str_len`` or its longest length (one host read), rounded up
to 4.  Wildcard (``[*]``) paths wait for a later slice of the port and raise
``NotImplementedError``; the JAX package's shape buckets, memo caches, obs
spans and Pallas/XLA engine choice with its fallback are left out.
"""

from __future__ import annotations

import functools
import json
import re
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.table import (
    Column, pack_bools, resolve_device,
)
from spark_rapids_jni_tpu_torch.ops import kernels
from spark_rapids_jni_tpu_torch.ops.kernels import _check

WILDCARD = object()   # the [*] path segment

# the longest path the automaton takes: its segment index is a uint8 (the
# JAX package's u8(L - 1) fails past it)
MAX_SEGMENTS = 256
# int64 elements of one row chunk's gather index in the value extraction
_GATHER_ELEMS = 1 << 26


def _parse_path(path: str):
    """``$.a[0].b`` -> [b"a", 0, b"b"]: bytes for object keys, int for
    array subscripts (``$[1].x`` and chained ``[i][j]`` work too), the
    ``WILDCARD`` sentinel for ``[*]``."""
    if not path.startswith("$"):
        raise ValueError(f"JSON path must start with '$': {path!r}")
    rest = path[1:]
    if not rest:
        raise ValueError("the identity path '$' is not supported")
    segs: List = []
    pos = 0
    tok = re.compile(r"\.([^.\[\]]+)|\[(\d+)\]|\[(\*)\]")
    while pos < len(rest):
        m = tok.match(rest, pos)
        if not m:
            raise ValueError(f"unsupported JSON path syntax at "
                             f"{rest[pos:]!r} in {path!r} "
                             "(keys, [integer] and [*] only)")
        if m.group(1) is not None:
            segs.append(m.group(1).encode("utf-8"))
        elif m.group(2) is not None:
            segs.append(int(m.group(2)))
        else:
            segs.append(WILDCARD)
        pos = m.end()
    if not segs:
        raise ValueError(f"empty JSON path: {path!r}")
    return segs


# ---------------------------------------------------------------------------
# K9: the path automaton
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def _segment_tables(segs: Tuple, max_key_len: int):
    """The path's static tables (``_automaton_pieces``): key bytes uint8
    ``[L, max_key_len]`` and int32 ``[3, L]`` of key lengths, subscript
    flags and subscripts (a key level's subscript is 0, a subscript level's
    key is empty)."""
    if max_key_len >= 255:
        raise ValueError(
            "JSON path keys longer than 254 bytes are not supported by "
            "the device automaton")
    L = len(segs)
    if not 1 <= L <= MAX_SEGMENTS or max_key_len < 1:
        raise ValueError(f"the automaton takes 1 to {MAX_SEGMENTS} path "
                         f"segments and max_key_len >= 1, got {L} and "
                         f"{max_key_len}")
    seg_bytes = np.zeros((L, max_key_len), np.uint8)
    tab = np.zeros((3, L), np.int32)
    for i, s in enumerate(segs):
        if isinstance(s, int) and not isinstance(s, bool):
            tab[1, i] = 1
            tab[2, i] = s
        elif isinstance(s, bytes) and len(s) <= max_key_len:
            seg_bytes[i, :len(s)] = np.frombuffer(s, np.uint8)
            tab[0, i] = len(s)
        else:
            raise ValueError(f"path segment {s!r} is neither an int nor a "
                             f"key of at most {max_key_len} bytes")
    return seg_bytes, tab


def _check_chars(ch: torch.Tensor):
    _check(ch.dtype == torch.uint8 and ch.dim() == 2,
           f"chars must be uint8 [n, W], got {ch.dtype} {tuple(ch.shape)}")
    _check(ch.shape[1] < 1 << 31, f"window {ch.shape[1]} passes int32")


class _PathTables(NamedTuple):
    """The path's tables on one device, as the plain step reads them."""
    keys: torch.Tensor     # uint8 [L, max_key_len]
    lens: torch.Tensor     # uint8 [L]
    isidx: torch.Tensor    # bool [L]
    tgt: torch.Tensor      # int32 [L]
    last: int              # L - 1
    max_key_len: int


class _Carry(NamedTuple):
    """The automaton's carry over ``[n]`` rows, every field in its JAX type
    (``_automaton_pieces``' make_carry0): bools, uint8 depth, matched,
    key_pos and cap_depth (they wrap), int32 elem_count, start and end."""
    in_str: torch.Tensor
    esc: torch.Tensor
    in_key: torch.Tensor
    key_ok: torch.Tensor
    await_colon: torch.Tensor
    capturing: torch.Tensor
    elem_pending: torch.Tensor
    found: torch.Tensor
    bad: torch.Tensor
    pending: torch.Tensor
    cap_is_str: torch.Tensor
    expect_key: torch.Tensor
    deep: torch.Tensor
    depth: torch.Tensor
    matched: torch.Tensor
    key_pos: torch.Tensor
    cap_depth: torch.Tensor
    elem_count: torch.Tensor
    start: torch.Tensor
    end: torch.Tensor


def _plain_tables(segs: Tuple, max_key_len: int, dev) -> _PathTables:
    seg_bytes, tab = _segment_tables(segs, max_key_len)
    return _PathTables(torch.from_numpy(seg_bytes).to(dev),
                       torch.from_numpy(tab[0].astype(np.uint8)).to(dev),
                       torch.from_numpy(tab[1] != 0).to(dev),
                       torch.from_numpy(tab[2]).to(dev), len(segs) - 1,
                       max_key_len)


def _plain_carry0(n: int, dev) -> _Carry:
    zb = torch.zeros(n, dtype=torch.bool, device=dev)
    z8 = torch.zeros(n, dtype=torch.uint8, device=dev)
    zi = torch.zeros(n, dtype=torch.int32, device=dev)
    return _Carry(in_str=zb, esc=zb, in_key=zb, key_ok=~zb, await_colon=zb,
                  capturing=zb, elem_pending=zb, found=zb, bad=zb,
                  pending=zb, cap_is_str=zb, expect_key=zb, deep=zb,
                  depth=z8, matched=z8, key_pos=z8, cap_depth=z8,
                  elem_count=zi, start=zi - 1, end=zi - 1)


def _plain_step(c: _Carry, x: torch.Tensor, pos: int,
                t: _PathTables) -> _Carry:
    """One step of ``_automaton_pieces`` over ``[n]`` rows: the carry after
    char ``x`` (uint8 ``[n]``) at window position ``pos``."""
    n = x.shape[0]
    dev = x.device
    last = t.last
    z8 = torch.zeros(n, dtype=torch.uint8, device=dev)
    zi = torch.zeros(n, dtype=torch.int32, device=dev)

    def seg(m):    # the index of segment min(m, L - 1)
        return m.clamp(max=last).long()

    in_str, esc, in_key, key_ok = c.in_str, c.esc, c.in_key, c.key_ok
    await_colon, capturing, elem_pending = (c.await_colon, c.capturing,
                                            c.elem_pending)
    found, bad, pending, cap_is_str = c.found, c.bad, c.pending, c.cap_is_str
    expect_key, deep, depth, matched = (c.expect_key, c.deep, c.depth,
                                        c.matched)
    key_pos, cap_depth, elem_count = c.key_pos, c.cap_depth, c.elem_count
    start, end = c.start, c.end

    is_q = x == ord('"')
    is_bs = x == ord("\\")
    is_ws = (x == 32) | (x == 9) | (x == 10) | (x == 13)
    is_open = (x == ord("{")) | (x == ord("["))
    is_close = (x == ord("}")) | (x == ord("]"))
    is_colon = x == ord(":")
    is_comma = x == ord(",")

    eff_q = is_q & ~esc
    new_in_str = in_str ^ eff_q
    new_esc = in_str & ~esc & is_bs
    outside = ~in_str
    opens = outside & is_open
    new_deep = deep | (opens & (depth >= 250))
    new_depth = (depth + (opens & (depth < 250)).to(torch.uint8)
                 - (outside & is_close).to(torch.uint8))
    at_frontier = depth == matched + 1

    # key scanning at the frontier
    key_opening = (outside & eff_q & expect_key & ~in_key & ~await_colon
                   & ~capturing & ~found & at_frontier)
    key_char = in_key & in_str & ~eff_q
    seg_idx = seg(matched)
    expect = t.keys[seg_idx, key_pos.clamp(max=t.max_key_len - 1).long()]
    this_len = t.lens[seg_idx]
    ok_char = key_char & (key_pos < this_len) & (x == expect) & ~esc
    new_key_ok = key_ok & (~key_char | ok_char)
    new_key_pos = torch.where(key_char, key_pos + 1, key_pos)
    key_closing = in_key & eff_q & in_str
    full_match = key_closing & new_key_ok & (new_key_pos == this_len)
    new_await = torch.where(key_closing, full_match, await_colon)
    new_in_key = (in_key | key_opening) & ~key_closing
    new_key_pos = torch.where(key_opening, z8, new_key_pos)
    new_key_ok = new_key_ok | key_opening

    # value entry after a matched key's colon
    saw_colon = await_colon & outside & is_colon
    new_await = new_await & ~saw_colon
    new_pending = pending | saw_colon
    key_value_starts = new_pending & ~is_ws & ~saw_colon

    # element entry at an index segment's frontier array
    fr_is_idx = t.isidx[seg_idx]
    live = ~capturing & ~found
    elem_value_starts = (elem_pending & fr_is_idx & outside & ~is_ws
                         & ~is_comma & ~is_close & at_frontier & live)
    value_starts = key_value_starts | elem_value_starts

    is_last = matched == last
    next_is_idx = t.isidx[seg(matched + 1)]
    expected_open = torch.where(next_is_idx, ord("["), ord("{")) \
        .to(torch.uint8)
    descend = value_starts & ~is_last & (x == expected_open) & live
    deadend = value_starts & ~is_last & (x != expected_open) & live
    start_cap = value_starts & is_last & live
    new_matched = matched + descend.to(torch.uint8)
    exhausted = (outside & is_close & ~capturing & (matched > 0)
                 & (new_depth == matched) & ~found)
    new_pending = new_pending & ~(value_starts | deadend)
    new_bad = bad | deadend | exhausted

    # the element counter: commas at the frontier array's depth
    elem_comma = outside & is_comma & fr_is_idx & at_frontier & live
    new_count = elem_count + elem_comma.to(torch.int32)
    new_elem_pending = torch.where(
        elem_comma, new_count == t.tgt[seg_idx],
        elem_pending & ~elem_value_starts)

    # key position for the (possibly new) frontier
    new_frontier = new_matched + 1
    new_seg = seg(new_matched)
    new_fr_idx = t.isidx[new_seg]
    opens_frontier = (outside & (x == ord("{"))
                      & (new_depth == new_frontier) & ~new_fr_idx)
    comma_frontier = (outside & is_comma & (depth == new_frontier)
                      & ~capturing & ~new_fr_idx)
    clears_key_pos = ~is_ws & outside & ~eff_q & ~is_open & ~is_comma
    new_expect_key = (opens_frontier | comma_frontier
                      | (expect_key & ~(key_opening | clears_key_pos)))

    # entering the frontier array arms the element counter
    arr_open = (outside & (x == ord("[")) & new_fr_idx
                & (new_depth == new_frontier) & live)
    new_count = torch.where(arr_open, zi, new_count)
    new_elem_pending = torch.where(arr_open, t.tgt[new_seg] == 0,
                                   new_elem_pending)

    # capture start and end
    new_start = torch.where(start_cap, zi + pos, start)
    new_cap_depth = torch.where(start_cap, depth, cap_depth)
    new_cap_is_str = torch.where(start_cap, is_q, cap_is_str)
    new_capturing = capturing | start_cap
    started = new_capturing & (new_start >= 0) & ~found
    cont_end = (started & outside & is_close
                & (new_depth == new_cap_depth) & (pos > new_start))
    scalar_term = (started & ~new_cap_is_str & outside
                   & (is_comma | is_close) & (depth == new_cap_depth)
                   & (pos > new_start))
    str_end = (started & new_cap_is_str & eff_q & in_str
               & (pos > new_start))
    ends_now = cont_end | scalar_term | str_end
    end_pos = (zi + pos + 1) - (scalar_term & ~cont_end
                                & ~str_end).to(torch.int32)
    return _Carry(
        in_str=new_in_str, esc=new_esc, in_key=new_in_key, key_ok=new_key_ok,
        await_colon=new_await, capturing=new_capturing & ~ends_now,
        elem_pending=new_elem_pending, found=found | ends_now, bad=new_bad,
        pending=new_pending, cap_is_str=new_cap_is_str,
        expect_key=new_expect_key, deep=new_deep, depth=new_depth,
        matched=new_matched, key_pos=new_key_pos, cap_depth=new_cap_depth,
        elem_count=new_count, start=new_start,
        end=torch.where(ends_now, end_pos, end))


def gjo_scan_plain(ch: torch.Tensor, segs, max_key_len: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`gjo_scan`: the JAX package's
    ``_automaton_pieces`` step (:func:`_plain_step`) over the window, one
    position at a time, every carry in its JAX type (uint8 depth, matched,
    key_pos and cap_depth wrap; elem_count, start and end are int32)."""
    _check_chars(ch)
    segs = tuple(segs)
    t = _plain_tables(segs, max_key_len, ch.device)
    n, W = ch.shape
    c = _plain_carry0(n, ch.device)
    chT = ch.T.contiguous()
    for pos in range(W):
        c = _plain_step(c, chT[pos], pos, t)
    return torch.stack([c.start, c.end, c.found.to(torch.int32),
                        c.capturing.to(torch.int32), c.bad.to(torch.int32),
                        c.deep.to(torch.int32)])


# K9 loads its rows in chunks of this many chars and skips quiet runs inside
# a chunk (csrc/gjo_scan.cu)
GJO_CHUNK = 16


def _quiet_chars(c: _Carry, x: torch.Tensor, t: _PathTables) -> torch.Tensor:
    """bool ``[n]``: whether K9 skips char ``x`` under carry ``c``, a torch
    mirror of the kernel's ``quiet_in_string``, ``quiet_settled`` and
    ``chunk_stops``: in a string with no escape, key or pending value
    pending, any char but ``"`` and ``\\``; settled outside a string (no
    escape, pending value or expected key, and not an element pending at an
    index segment's frontier), any char but ``"`` ``,`` ``:`` and those
    with ``(x | 0x26) == 0x7F`` (``[ ] { }`` and ``Y _ y`` DEL).  Chars in
    a window's last ``W % 16`` are stepped whatever this says."""
    in_string = c.in_str & ~c.esc & ~c.in_key & ~c.pending
    cur_idx = t.isidx[c.matched.clamp(max=t.last).long()]
    elem_frontier = c.elem_pending & cur_idx & (c.depth == c.matched + 1)
    settled = (~c.in_str & ~c.esc & ~c.pending & ~c.expect_key
               & ~elem_frontier)
    quote = x == ord('"')
    str_stop = quote | (x == ord("\\"))
    out_stop = (quote | (x == ord(",")) | (x == ord(":"))
                | ((x | 0x26) == 0x7F))
    return (in_string & ~str_stop) | (settled & ~out_stop)


def gjo_scan_walk(ch: torch.Tensor, segs, max_key_len: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`gjo_scan_plain` with K9's walk replayed beside it, with torch
    ops over the plain carry: the plain version's int32 ``[6, n]``, then
    per row the chars the kernel skips and the iterations of its loop
    (int64 ``[n]`` each).  An iteration steps one char, or skips a quiet run
    to its chunk's end; so the iterations are the stepped chars plus the
    chunks whose last char is skipped."""
    _check_chars(ch)
    segs = tuple(segs)
    t = _plain_tables(segs, max_key_len, ch.device)
    n, W = ch.shape
    whole = W - W % GJO_CHUNK
    c = _plain_carry0(n, ch.device)
    chT = ch.T.contiguous()
    skipped = torch.zeros(n, dtype=torch.int64, device=ch.device)
    ends_quiet = torch.zeros_like(skipped)
    for pos in range(W):
        x = chT[pos]
        if pos < whole:
            quiet = _quiet_chars(c, x, t)
            skipped += quiet
            if pos % GJO_CHUNK == GJO_CHUNK - 1:
                ends_quiet += quiet
        c = _plain_step(c, x, pos, t)
    fields = torch.stack([c.start, c.end, c.found.to(torch.int32),
                          c.capturing.to(torch.int32), c.bad.to(torch.int32),
                          c.deep.to(torch.int32)])
    return fields, skipped, W - skipped + ends_quiet


@functools.lru_cache(maxsize=64)
def _device_tables(segs: Tuple, max_key_len: int, device: torch.device):
    """The path's tables on ``device``, made once per path (a copy to the
    card per call would put host time into the kernel's time)."""
    seg_bytes, tab = _segment_tables(segs, max_key_len)
    return (torch.from_numpy(seg_bytes).to(device),
            torch.from_numpy(tab).to(device))


def gjo_scan(ch: torch.Tensor, segs, max_key_len: int) -> torch.Tensor:
    """K9: the get_json path automaton over ``ch`` (uint8 ``[n, W]``, rows
    of contiguous bytes, any ``W`` below 2^31) for the path ``segs`` (bytes
    keys of at most ``max_key_len`` < 255 bytes and int subscripts, 1 to
    256 of them).  Returns int32 ``[6, n]``: per row the capture's start
    and end (-1 when none), then found, capturing, bad and deep as 0/1.
    With zero rows nothing launches."""
    _check_chars(ch)
    segs = tuple(segs)
    _segment_tables(segs, max_key_len)
    if ch.device.type == "cpu":
        return gjo_scan_plain(ch, segs, max_key_len)
    _check(ch.device.type == "cuda", f"no kernel for device {ch.device}")
    n, W = ch.shape
    _check(W <= 1 or ch.stride(1) == 1,
           "the scan reads rows of contiguous bytes")
    dev = ch.device
    out = torch.empty((6, n), dtype=torch.int32, device=dev)
    if n:
        keys, tab = _device_tables(segs, max_key_len, dev)
        kernels.launch("gjo_scan", ch.data_ptr(), ch.stride(0), n, W,
                       keys.data_ptr(), max_key_len, tab.data_ptr(),
                       len(segs), out.data_ptr(), dev.index,
                       kernels.stream_of(dev))
    return out


# ---------------------------------------------------------------------------
# After the scan: value extraction, punt classes, assembly (torch glue)
# ---------------------------------------------------------------------------

def _at(b: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    return torch.gather(b, 1, pos.long()[:, None])[:, 0].to(torch.int32)


def _finish_rows(ch, st, in_valid, out_chars):
    """The JAX package's ``_extract_value`` and ``_gjo_finish`` over one row
    chunk: writes the assembled chars (punted rows nulled) into
    ``out_chars`` and returns (lengths int32, strict validity, needs_host).
    The left-justified value window is one gather by ``start + arange(W)``
    (the JAX package's barrel shifter)."""
    W = ch.shape[1]
    start, end = st[0], st[1]
    # a capture still open at the window's end is truncated JSON: null
    found = (st[2] == 1) & (st[3] == 0)
    ok = found & (st[4] == 0) & (start >= 0) & (end > start)
    first = _at(ch, start.clamp(0, W - 1))
    is_strval = ok & (first == ord('"'))
    vstart = torch.where(is_strval, start + 1, start)
    vend = torch.where(is_strval, end - 1, end)
    out_len = (vend - vstart).clamp(0, W)
    iota = torch.arange(W, device=ch.device)
    idx = (vstart.clamp(0, W - 1).long()[:, None] + iota).clamp_(max=W - 1)
    vals = torch.gather(ch, 1, idx)
    del idx
    zero = torch.zeros((), dtype=torch.uint8, device=ch.device)
    mask = iota < out_len[:, None]
    vals = torch.where(mask, vals, zero)
    # scalars: trim the whitespace picked up before the terminator
    ws = (vals == 32) | (vals == 9) | (vals == 10) | (vals == 13)
    last_nonws = torch.where(mask & ~ws, iota + 1, 0).amax(1)
    out_len = torch.where(is_strval, out_len, last_nonws.to(torch.int32))
    mask = iota < out_len[:, None]
    vals = torch.where(mask, vals, zero)
    valid = in_valid & ok
    # punt classes: string values with escapes, containers, deep documents
    has_bs = (mask & (vals == ord("\\"))).any(1) & is_strval & valid
    is_container = valid & ((first == ord("{")) | (first == ord("[")))
    needs_host = has_bs | is_container | ((st[5] != 0) & in_valid)
    strict = valid & ~needs_host
    out_chars.copy_(torch.where(strict[:, None], vals, zero))
    return torch.where(strict, out_len, 0).to(torch.int32), strict, needs_host


def _gjo_finish(ch: torch.Tensor, in_valid: torch.Tensor, st: torch.Tensor):
    """(chars uint8 [n, W], lengths int32 [n], strict validity bool [n],
    needs_host bool [n]) in row chunks whose gather index stays under
    ``_GATHER_ELEMS`` elements."""
    n, W = ch.shape
    dev = ch.device
    chars = torch.zeros((n, W), dtype=torch.uint8, device=dev)
    if n == 0 or W == 0:    # nothing can be captured in an empty window
        false = torch.zeros(n, dtype=torch.bool, device=dev)
        return chars, torch.zeros(n, dtype=torch.int32, device=dev), false, \
            false
    step = max(1, _GATHER_ELEMS // W)
    parts = [_finish_rows(ch[r:r + step], st[:, r:r + step],
                          in_valid[r:r + step], chars[r:r + step])
             for r in range(0, n, step)]
    lens, strict, needs_host = (torch.cat(p) for p in zip(*parts))
    return chars, lens, strict, needs_host


# ---------------------------------------------------------------------------
# The host fixup (the JAX package's _host_fixup and its helpers)
# ---------------------------------------------------------------------------

class _RawNum(str):
    """A number token carried as its RAW source text: Spark's Jackson copy
    preserves '1.50'/'1e2' verbatim, where json.loads+dumps would normalise
    them."""


def _spark_decoder() -> json.JSONDecoder:
    """Streaming-compatible decoder: the FIRST occurrence wins for duplicate
    keys, and number tokens keep their raw text (``_RawNum``), matching the
    device automaton."""
    def _first_wins(pairs):
        d = {}
        for k, v in pairs:
            if k not in d:
                d[k] = v
        return d

    return json.JSONDecoder(object_pairs_hook=_first_wins,
                            parse_float=_RawNum, parse_int=_RawNum,
                            parse_constant=_RawNum)


def _render_json(obj) -> str:
    """Spark-compact rendering with raw number tokens preserved."""
    if isinstance(obj, _RawNum):
        return str(obj)
    if isinstance(obj, str):
        return json.dumps(obj, ensure_ascii=False)
    if obj is None:
        return "null"
    if obj is True:
        return "true"
    if obj is False:
        return "false"
    if isinstance(obj, list):
        return "[" + ",".join(_render_json(v) for v in obj) + "]"
    if isinstance(obj, dict):
        return "{" + ",".join(
            json.dumps(k, ensure_ascii=False) + ":" + _render_json(v)
            for k, v in obj.items()) + "}"
    return json.dumps(obj, separators=(",", ":"), ensure_ascii=False)


def _walk_path(obj, segs):
    """The value at ``segs`` (str keys, int subscripts) under ``obj``;
    ``KeyError`` when the path is missing."""
    for s in segs:
        if not (isinstance(obj, list) and isinstance(s, int) and s < len(obj)
                or isinstance(obj, dict) and isinstance(s, str) and s in obj):
            raise KeyError(s)
        obj = obj[s]
    return obj


def _host_fixup(chars, lens, strict, src: Column, segs, rows):
    """Exact host re-extraction of ``rows`` (int64, on the device), which
    arrive nulled from the device assembly: the source text of those rows
    only is copied to the host, decoded with Python's ``json``, walked and
    rendered; each success is copied back and re-validated.  Returns the
    chars matrix, widened (to a multiple of 4) when a value outgrows it;
    ``lens`` and ``strict`` are patched in place."""
    keys = [s.decode() if isinstance(s, bytes) else s for s in segs]
    sub = src.chars2d[rows].cpu().numpy()
    sub_lens = src.lens[rows].cpu().numpy()
    decoder = _spark_decoder()
    patches = {}
    for i in range(len(sub)):
        text = bytes(sub[i, :sub_lens[i]]).decode("utf-8", "replace")
        try:
            # prefix-tolerant: a valid JSON prefix with a malformed tail
            # still extracts (raw_decode stops at the first whole value)
            obj = _walk_path(decoder.raw_decode(text.lstrip())[0], keys)
        except (ValueError, KeyError, RecursionError):
            continue     # malformed, missing or too deep: stays null
        text = str(obj) if isinstance(obj, str) else _render_json(obj)
        patches[i] = text.encode("utf-8")
    if not patches:
        return chars
    need = max(len(b) for b in patches.values())
    if need > chars.shape[1]:
        grow = (need + 3) // 4 * 4 - chars.shape[1]
        chars = torch.nn.functional.pad(chars, (0, grow))
    block = np.zeros((len(patches), chars.shape[1]), np.uint8)
    for j, b in enumerate(patches.values()):
        block[j, :len(b)] = np.frombuffer(b, np.uint8)
    dev = chars.device
    at = rows[torch.tensor(list(patches), dtype=torch.int64, device=dev)]
    chars[at] = torch.from_numpy(block).to(dev)
    lens[at] = torch.tensor([len(b) for b in patches.values()],
                            dtype=torch.int32, device=dev)
    strict[at] = True
    return chars


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def get_json_object(col: Column, path: str, max_str_len=None, *,
                    device=None) -> Column:
    """Spark ``get_json_object(json, path)`` for object-key and ``[i]``
    array-subscript paths over a STRING column, dense-padded or in Arrow
    layout (scanned in a window of ``max_str_len`` or its longest length,
    rounded up to 4), on ``device`` (default: the CUDA card).  Returns a
    dense-padded STRING column, whatever the input's form, as the JAX
    package does: chars
    ``[n, W']`` (``W'`` the input's width, or wider when a host-rendered
    container outgrows it; zeros past each length), int32 lengths and a
    packed validity mask; null where the path is missing, the JSON is
    malformed along the scan, or the input is null.

    One K9 launch scans the column; one host read of the punt flags gates
    the host fixup of the rows that need it.  ``[*]`` paths raise
    ``NotImplementedError`` (a later slice); a non-string column, a bad
    path, a key longer than 254 bytes and a document longer than its
    window raise ``ValueError``, as in the JAX package."""
    if not col.dtype.is_string:
        raise ValueError("get_json_object needs a string column")
    segs = tuple(_parse_path(path))
    if any(s is WILDCARD for s in segs):
        raise NotImplementedError(
            "wildcard ([*]) JSON paths wait for a later slice of the port "
            "(the get_json wildcard routes)")
    mkl = max((len(s) for s in segs if isinstance(s, bytes)), default=1)
    dev = resolve_device(device)
    col = col.to(dev)
    if not col.is_padded:
        if max_str_len is None:
            max_str_len = int(col.str_lens().max()) if col.num_rows else 0
        col = col._padded_view((int(max_str_len) + 3) // 4 * 4)
    ch = col.chars2d
    W = ch.shape[1]
    st = gjo_scan(ch, segs, mkl)
    chars, lens, strict, needs_host = _gjo_finish(ch, col.valid_bools(), st)
    # the one host read: whether any row punts, and whether any length
    # leaves the window (the JAX package refuses such columns)
    any_punt, bad_len = (bool(v) for v in torch.stack([
        needs_host.any(),
        ((col.lens < 0) | (col.lens > W)).any()]).tolist())
    if bad_len:
        raise ValueError(f"string lengths do not fit the padded width {W}; "
                         f"get_json_object would scan truncated documents")
    if any_punt:
        rows = torch.nonzero(needs_host)[:, 0]
        chars = _host_fixup(chars, lens, strict, col, segs, rows)
    return Column.padded_strings(chars, lens, pack_bools(strict))
