"""Columnar query operators: the PyTorch counterpart of the single-chip
operators of ``spark_rapids_jni_tpu.models.pipeline``.

- :func:`project` / :func:`filter_mask`: elementwise expressions; filters
  give selection masks, not shorter tables.
- :func:`hash_aggregate_sum`, :func:`hash_aggregate_multi`,
  :func:`hash_aggregate_sum_multi`: exact group-by over raw key and value
  tensors, the output padded to a static ``max_groups``.
- :func:`sort_merge_join` and its live, duplicate-key, left-outer and
  semi forms over raw key tensors; :func:`sort_order` for ORDER BY.
- :func:`flagship_query_step`: join items, filter, project revenue,
  group-by date and sum (the chain the JAX package's ``flagship_plan``
  describes; its plan IR is not ported).
- :func:`hash_aggregate_table`, :func:`join_semi_mask_table`,
  :func:`join_inner_table` and the string joins: the same operators over
  ``Table`` or ``GroupedColumns`` sources with Spark's null semantics
  (null keys group together and never join; COUNT(col) and SUM, MIN, MAX,
  AVG skip nulls, and a group without a non-null value gives NULL).
- :func:`merge_aggregate_partials` / :func:`merge_aggregate_table_partials`:
  the host-side final merge of partial aggregates.

The JAX package computes all of this in XLA, with no Pallas kernel, so
these are torch ops (sorts, ``searchsorted``, ``index_add_``,
``scatter_reduce_``, cumulative sums), and no kernel of the port is
launched here.  Every function runs on the device its inputs lie on and
moves nothing to another device; the only host reads are the domain
strategy's (one read of the keys' ranges) and the merges.

**Group order.**  Groups come out in ascending order of their composite key
as the JAX package sorts it: per key, its null flag first, then its value;
keys of 16 bits or fewer as ``(null << bits) | unsigned bits``, so that a
signed INT8 or INT16 key orders 0..max, then min..-1, then null.  Groups past
``max_groups`` are dropped in that order, and ``num_groups`` counts every
distinct live key.  Every key is turned into order words: int64 tensors
whose lexicographic order is the key's (:func:`_order_word`).  Two
strategies compute the groups, and each gives the same result:

- the sort (:func:`_hash_aggregate_nulls`): a stable lexicographic sort of
  the words, packed into int64 chunks where their widths allow and sorted
  from the minor chunk to the major one, each row's group being the rank
  of its key among the distinct live keys;
- the domain (:func:`_hash_aggregate_domain`): from
  :data:`DOMAIN_MIN_ROWS` rows on, when every key is one integer word and
  the keys' ranges over the live rows, read once on the host, span at most
  :data:`DENSE_MAX_SLOTS` slots, each row's group is its slot in that
  mixed-radix domain, and the live slots are ranked by a cumulative sum.
  The JAX package's static packed domain and its adaptive range both fall
  under it.

Setting :data:`DENSE_MAX_SLOTS` to 0 forces the sort, and
:data:`DOMAIN_MIN_ROWS` to 0 lets the domain run at any row count.  The
measures are reduced the same way whatever the strategy
(:func:`_reduce_measures`).
Integer SUM wraps at the measure's width, as in the JAX package (an INT32
SUM stays INT32), decimal128 SUM modulo 2^128.  Float SUM accumulates in
float64 and is rounded to the measure's type: with atomic ``index_add_`` on
the card its order is not fixed from run to run.

Floating-point keys raise ``ValueError`` in every group-by and ORDER BY, as
they do in the JAX package (its sentinel is the key type's integer maximum).

**Counterparts of the JAX package's helpers.**  Its ``_hash_aggregate_domain``
with ``_domain_aggregate_core`` and its ``_hash_aggregate_adaptive`` are
this module's :func:`_hash_aggregate_domain` (the range read on the host
covers both the packed keys' static domain and the adaptive range); the
measure tail its strategies share is :func:`_reduce_measures`.  Its
``_fill_forward_segmented`` has none: :func:`_string_join_fill` takes each
key run's last valid build row with one scatter-max over the runs that
:func:`_dense_join_ids` numbers (string keys also reach the table joins
that way).  Its ``_join_tables_bucketable`` is :func:`_pad_join_sides`.
64-bit keys and measures are native int64 here, so its plane-pair paths
(the pair ids of ``_dense_join_ids``, the 32768-row chunks of
``_segment_sum_words``) have no counterpart.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.ops.decimal import div_decimal128
from spark_rapids_jni_tpu_torch.runtime import shapes
from spark_rapids_jni_tpu_torch.table import (
    BITS_DTYPES, FLOAT32, INT32, Column, Table, bits_view, decimal128,
    pack_bools,
)

__all__ = [
    "MAX_GROUPS", "filter_mask", "flagship_query_step",
    "hash_aggregate_multi", "hash_aggregate_sum", "hash_aggregate_sum_multi",
    "hash_aggregate_table", "join_inner_table", "join_semi_mask",
    "join_semi_mask_strings", "join_semi_mask_table",
    "merge_aggregate_partials", "merge_aggregate_table_partials", "project",
    "sort_merge_join", "sort_merge_join_dup", "sort_merge_join_left",
    "sort_merge_join_live", "sort_merge_join_strings", "sort_order",
]

MAX_GROUPS = 128

# the domain strategy is tried from this many rows on: below, the sort it
# saves is short and its host read of the keys' ranges waits for the card
# (chip_smoke.py on an H100: at query_grouped_4m's 2M rows the two tie, at
# flagship_q6_sf10's 28.8M the domain is a third faster; PERF.md section 6)
DOMAIN_MIN_ROWS = 1 << 23
# widest key domain the domain strategy allocates slots for
DENSE_MAX_SLOTS = 1 << 20

# aggregates run by each strategy ("domain", "sort"), for diagnostics, as
# ops.kernels.launches counts the kernels
strategies: collections.Counter = collections.Counter()

_AGG_OPS = ("sum", "count", "min", "max", "avg")
_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1


def reset_strategies() -> None:
    strategies.clear()


# ---------------------------------------------------------------------------
# Expression operators
# ---------------------------------------------------------------------------

def project(table: Table, exprs: Sequence[Callable], dtypes) -> Table:
    """Evaluate elementwise expressions over columns: each expr receives the
    tuple of column data tensors and returns a new data tensor."""
    datas = tuple(c.data for c in table.columns)
    return Table(tuple(Column(dt, expr(*datas))
                       for expr, dt in zip(exprs, dtypes)))


def filter_mask(table: Table, pred: Callable,
                cols: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Boolean selection mask from a predicate over column data tensors.

    ``cols`` names the columns the predicate references: their nulls filter
    a row (Spark's null semantics), nulls in other columns do not.  ``None``
    treats every column as referenced."""
    m = pred(*(c.data for c in table.columns))
    for i in range(table.num_columns) if cols is None else cols:
        c = table.columns[i]
        if c.validity is not None:
            m = m & c.valid_bools()
    return m


# ---------------------------------------------------------------------------
# Order words: int64 tensors whose lexicographic order is the keys'
# ---------------------------------------------------------------------------

def _order_word(x: torch.Tensor):
    """An integer tensor as ``(word, bits)``: int64 ``word`` in the key's
    order, in ``[0, 2^bits)`` for ``bits`` < 64 and in signed int64 order
    for ``bits`` == 64 (unsigned 64-bit keys with their top bit flipped)."""
    dt = x.dtype
    if dt == torch.bool or dt.is_floating_point or dt.is_complex:
        raise ValueError(
            f"{dt} keys cannot be grouped, sorted or joined here: the "
            f"key order is over integer types, as in the JAX package")
    bits = 8 * x.element_size()
    if dt in (torch.int8, torch.int16, torch.int32):
        return x.to(torch.int64) + (1 << (bits - 1)), bits
    if dt == torch.int64:
        return x, 64
    if dt == torch.uint64:
        return x.view(torch.int64) ^ _I64_MIN, 64
    # uint8, uint16, uint32: zero-extended
    return bits_view(x).to(torch.int64) & ((1 << bits) - 1), bits


def _from_order_word(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`_order_word` into ``dtype``."""
    bits = 8 * torch.empty((), dtype=dtype).element_size()
    if dtype in (torch.int8, torch.int16, torch.int32):
        return (w - (1 << (bits - 1))).to(dtype)
    if dtype == torch.int64:
        return w
    if dtype == torch.uint64:
        return (w ^ _I64_MIN).view(torch.uint64)
    return w.to(BITS_DTYPES[bits // 8]).view(dtype)


def _chunks(words):
    """Pack order words (major first) into int64 chunks of at most 63 bits
    each, in the same lexicographic order; a 64-bit word is a chunk of its
    own."""
    chunks, cur, cur_bits = [], None, 0
    for w, bits in words:
        if bits >= 64 or cur is None or cur_bits + bits > 63:
            if cur is not None:
                chunks.append(cur)
            cur, cur_bits = w, bits
            if bits >= 64:
                chunks.append(cur)
                cur, cur_bits = None, 0
            continue
        cur = (cur << bits) | w
        cur_bits += bits
    if cur is not None:
        chunks.append(cur)
    return chunks


def _lexsort(words):
    """Stable lexicographic order of rows over order words (major first):
    chained stable sorts from the minor chunk to the major one.  Returns
    the permutation and the chunks in sorted order."""
    chunks = _chunks(words)
    perm = None
    for c in reversed(chunks):
        idx = torch.sort(c if perm is None else c[perm], stable=True).indices
        perm = idx if perm is None else perm[idx]
    return perm, [c[perm] for c in chunks]


def _run_starts(sorted_chunks, n: int, device) -> torch.Tensor:
    """bool ``[n]``: the first row of each run of equal keys."""
    is_new = torch.ones(n, dtype=torch.bool, device=device)
    if n > 1:
        changed = torch.zeros(n - 1, dtype=torch.bool, device=device)
        for c in sorted_chunks:
            changed |= c[1:] != c[:-1]
        is_new[1:] = changed
    return is_new


def _sortable(x: torch.Tensor):
    """A key tensor that ``torch.sort``/``searchsorted`` order as the key
    type orders (signed integers and floats as they are, 16 to 64-bit
    unsigned ones as order words), and the value of its type's maximum
    there (the sentinel the JAX package parks dead rows at)."""
    if x.dtype in (torch.uint16, torch.uint32, torch.uint64):
        w, bits = _order_word(x)
        return w, (_I64_MAX if bits == 64 else (1 << bits) - 1)
    if x.dtype.is_floating_point:
        return x, None
    return x, torch.iinfo(x.dtype).max


def _common_sortable(a: torch.Tensor, b: torch.Tensor):
    """:func:`_sortable` of a build and a probe key tensor in one type."""
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    (ka, big), (kb, _) = _sortable(a), _sortable(b)
    return ka, kb, big


def _integer_keys(big) -> None:
    """Joins that park rows at a key sentinel take integer keys only."""
    if big is None:
        raise ValueError("floating-point keys have no sentinel to park null "
                         "or dead rows at, as in the JAX package")


def _max_bits(dtype: torch.dtype) -> int:
    """The maximum of an integer type, in its :func:`bits_view` type."""
    if dtype in (torch.uint16, torch.uint32, torch.uint64):
        return -1
    return torch.iinfo(dtype).max


def _keep(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``x`` where ``keep``, zero elsewhere (rows of ``[G, 4]`` decimal128
    limbs), by its bits: torch has few operations on unsigned types."""
    b = bits_view(x)
    k = keep if b.dim() == 1 else keep[:, None]
    return torch.where(k, b, torch.zeros((), dtype=b.dtype,
                                         device=b.device)).view(x.dtype)


def _gather(x: torch.Tensor, idx: torch.Tensor, keep: torch.Tensor):
    """``x[idx]`` where ``keep``, zero elsewhere, in ``x``'s type."""
    if x.shape[0] == 0:
        return torch.zeros((idx.shape[0],) + tuple(x.shape[1:]),
                           dtype=x.dtype, device=x.device)
    return _keep(bits_view(x)[idx].view(x.dtype), keep)


# ---------------------------------------------------------------------------
# Aggregate: groups, then measures
# ---------------------------------------------------------------------------

# the most scatter slots, lanes included, that _Slots spreads a slot's rows
# over on the card (4 MiB of int64); PERF.md section 6 gives the q6 step's
# time at this setting and at one lane (chip_smoke.py)
SPREAD_SLOTS = 1 << 19


class _Slots:
    """Scatter targets: row ``i`` into slot ``rows[i]`` of ``nb``.  On the
    card, atomic adds into a few hot slots serialise (every row of a
    30-group aggregate hits one of 30 addresses), so each slot is spread
    over lanes by row index and the lanes are folded after each scatter:
    the most lanes, a power of two, that keep slots times lanes within
    :data:`SPREAD_SLOTS` and lanes within the rows.  The CPU's scatters
    take no atomics, so it takes one lane."""

    def __init__(self, rows: torch.Tensor, nb: int):
        n, lanes = rows.shape[0], 1
        while (rows.device.type == "cuda" and 2 * lanes <= n
               and nb * lanes * 2 <= SPREAD_SLOTS):
            lanes *= 2
        self.rows, self.nb, self.lanes = rows, nb, lanes
        self.idx = rows if lanes == 1 else rows * lanes + (
            torch.arange(n, device=rows.device) & (lanes - 1))

    def add(self, x: torch.Tensor) -> torch.Tensor:
        """Per-slot sums of ``x`` (``[n]`` or ``[n, k]``)."""
        tail = tuple(x.shape[1:])
        out = torch.zeros((self.nb * self.lanes,) + tail, dtype=x.dtype,
                          device=x.device)
        out.index_add_(0, self.idx, x)
        return out.view((self.nb, self.lanes) + tail).sum(1)

    def reduce(self, x: torch.Tensor, red: str, ident) -> torch.Tensor:
        """Per-slot ``amin`` or ``amax`` of ``x``, ``ident`` where empty."""
        out = torch.full((self.nb * self.lanes,), ident, dtype=x.dtype,
                         device=x.device)
        out.scatter_reduce_(0, self.idx, x, red)
        out = out.view(self.nb, self.lanes)
        return out.amin(1) if red == "amin" else out.amax(1)


def _minmax_identity(op: str, dtype: torch.dtype):
    """The op's identity: rows outside a MIN/MAX carry it so that they
    cannot win the reduction."""
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _hash_aggregate_nulls(words, live: torch.Tensor, max_groups: int):
    """The sort strategy: each row's output slot (its group's rank among
    the distinct live keys, ``max_groups`` for a dead row or a group past
    the capacity) and the number of distinct live keys.  Dead rows sort
    last under a leading dead bit."""
    n = live.shape[0]
    perm, sc = _lexsort([((~live).to(torch.int64), 1)] + list(words))
    is_new = _run_starts(sc, n, live.device)
    seg = torch.cumsum(is_new, 0) - 1
    gid = torch.empty_like(seg)
    gid[perm] = seg
    num_groups = (is_new & live[perm]).sum()
    out_row = torch.where(live & (gid < max_groups), gid, max_groups)
    return out_row, num_groups


def _hash_aggregate_domain(dkeys, live: torch.Tensor, max_groups: int):
    """The domain strategy over single-word keys ``dkeys`` (``(word,
    validity or None)`` each; a key with validity gets a null slot after
    its values): the same ``(out_row, num_groups)`` as the sort, or None
    when the keys' ranges over the live rows (one host read) span more
    than :data:`DENSE_MAX_SLOTS` slots or no row is live."""
    stats = []
    for w, kv in dkeys:
        sel = live if kv is None else live & kv
        stats.append(torch.where(sel, w, _I64_MAX).min())
        stats.append(torch.where(sel, w, _I64_MIN).max())
    stats.append(live.any().to(torch.int64))
    vals = torch.stack(stats).tolist()
    if not vals[-1]:
        return None
    lows, radii, D = [], [], 1
    for j, (_, kv) in enumerate(dkeys):
        lo, hi = vals[2 * j], vals[2 * j + 1]
        span = hi - lo + 1 if hi >= lo else 0
        lows.append(lo if span else 0)
        radii.append(span + (kv is not None))
        D *= radii[-1]
        if D > DENSE_MAX_SLOTS:
            return None
    gid = torch.zeros_like(live, dtype=torch.int64)
    for (w, kv), lo, radix in zip(dkeys, lows, radii):
        comp = w - lo
        if kv is not None:
            comp = torch.where(kv, comp, radix - 1)
        gid = gid * radix + comp
    gid = torch.where(live, gid, 0)
    slot_live = _Slots(gid, D).add(live.to(torch.int64)) > 0
    pos = torch.cumsum(slot_live, 0) - 1
    out_slot = torch.where(slot_live & (pos < max_groups), pos, max_groups)
    out_row = torch.where(live, out_slot[gid], max_groups)
    return out_row, slot_live.sum()


def _aggregate(words, dkeys, measures, live: torch.Tensor,
               max_groups: int):
    """Group the live rows by the keys' order ``words`` (``dkeys``: their
    single-word form for the domain strategy, or None) and reduce
    ``measures``.  Returns ``(rep, have, num_groups, outs, metas)``:
    ``rep[g]`` is a row of group ``g`` (its first), ``have[g]`` flags the
    slots that hold a group, ``metas`` the groups with a non-null value of
    each measure (None for COUNT)."""
    n = live.shape[0]
    dev = live.device
    nb = max_groups + 1
    res = None
    if n and n >= DOMAIN_MIN_ROWS and dkeys is not None:
        res = _hash_aggregate_domain(dkeys, live, max_groups)
        if res is not None:
            strategies["domain"] += 1
    if res is None and n:
        res = _hash_aggregate_nulls(words, live, max_groups)
        strategies["sort"] += 1
    if res is None:
        out_row = torch.zeros(0, dtype=torch.int64, device=dev)
        num_groups = torch.zeros((), dtype=torch.int64, device=dev)
    else:
        out_row, num_groups = res
    slots = _Slots(out_row, nb)
    star = slots.add(live.to(torch.int64))[:max_groups]
    have = star > 0
    rep = slots.reduce(torch.arange(n, device=dev), "amin", n)
    rep = rep[:max_groups].clamp(max=max(n - 1, 0))
    outs, metas = _reduce_measures(measures, live, slots, max_groups, star)
    return rep, have, num_groups, outs, metas


def _reduce_measures(measures, live, slots: _Slots, max_groups: int, star):
    """Each ``(values, op, validity or None)`` measure reduced into the
    output slots (slot ``max_groups`` gathers what is dropped)."""
    outs, metas = [], []
    for v, op, vvalid in measures:
        if op == "count" and vvalid is None:     # COUNT(*)
            outs.append(star.to(torch.int32))
            metas.append(None)
            continue
        mv = live if vvalid is None else live & vvalid
        nn = slots.add(mv.to(torch.int64))[:max_groups]
        if op == "count":
            outs.append(nn.to(torch.int32))
            metas.append(None)
            continue
        ok = nn > 0
        if v.dim() == 2:                         # decimal128 limbs
            w = (_segment_sum_words(v, mv, slots) if op == "sum"
                 else _segment_minmax_words(v, mv, slots, op))
            outs.append(_keep(w[:max_groups], ok))
        elif op in ("sum", "avg"):
            s = _segment_sum(v, mv, slots)[:max_groups]
            if op == "avg":
                s = _as_float32(s) / nn.clamp(min=1).to(torch.float32)
            outs.append(s)
        else:
            outs.append(_keep(_segment_minmax(v, mv, slots, op)
                              [:max_groups], ok))
        metas.append(ok)
    return outs, metas


def _segment_sum(v, mv, slots: _Slots) -> torch.Tensor:
    """Per-slot sum of ``v`` over the rows ``mv``: integers wrap at their
    width (summed as int64, then truncated), floats accumulate in float64
    and round to their type."""
    if v.dtype.is_floating_point:
        return slots.add(torch.where(mv, v, 0).to(torch.float64)) \
            .to(v.dtype)
    b = bits_view(v)
    x = torch.where(mv, b, 0).to(torch.int64)
    return slots.add(x).to(b.dtype).view(v.dtype)


def _as_float32(s: torch.Tensor) -> torch.Tensor:
    """A sum as float32, unsigned types by their unsigned value."""
    if s.dtype in (torch.uint16, torch.uint32):
        return _order_word(s)[0].to(torch.float32)
    if s.dtype == torch.uint64:
        x = s.view(torch.int64)
        return (x.to(torch.float64)
                + torch.where(x < 0, 2.0 ** 64, 0.0)).to(torch.float32)
    return s.to(torch.float32)


def _segment_minmax(v, mv, slots: _Slots, op: str) -> torch.Tensor:
    """Per-slot MIN or MAX of ``v`` over the rows ``mv`` (the identity in
    slots without one)."""
    red = "amin" if op == "min" else "amax"
    if v.dtype.is_floating_point:
        ident = _minmax_identity(op, v.dtype)
        return slots.reduce(torch.where(mv, v, ident), red, ident)
    w, _ = _order_word(v)
    ident = _minmax_identity(op, torch.int64)
    return _from_order_word(slots.reduce(torch.where(mv, w, ident), red,
                                         ident), v.dtype)


def _segment_sum_words(limbs, mv, slots: _Slots) -> torch.Tensor:
    """Per-slot sum of decimal128 values (int32 ``[n, 4]`` limbs) modulo
    2^128: the values split into 16-bit limbs, summed as int64 (no overflow
    below 2^47 rows), then carried.  Returns int32 ``[nb, 4]``."""
    u = limbs.to(torch.int64) & 0xFFFFFFFF
    halves = torch.stack([u & 0xFFFF, u >> 16], dim=2).reshape(-1, 8)
    s = slots.add(torch.where(mv[:, None], halves, 0))
    out, carry = [], 0
    for j in range(8):
        t = s[:, j] + carry
        out.append(t & 0xFFFF)
        carry = t >> 16
    return torch.stack([out[2 * k] | (out[2 * k + 1] << 16)
                        for k in range(4)], dim=1).to(torch.int32)


def _segment_minmax_words(limbs, mv, slots: _Slots, op: str):
    """Per-slot MIN or MAX of decimal128 values: a cascade from the signed
    top limb down, each level reducing among the rows still tied with the
    slot's result on every higher limb.  Garbage in slots without a value
    (the caller masks them)."""
    red = "amin" if op == "min" else "amax"
    ident = _minmax_identity(op, torch.int64)
    tied = mv
    outs = [None] * 4
    for j in reversed(range(4)):
        key = limbs[:, j].to(torch.int64)
        if j != 3:
            key = key & 0xFFFFFFFF
        k = torch.where(tied, key, ident)
        m = slots.reduce(k, red, ident)
        outs[j] = m
        if j:
            tied = tied & (k == m[slots.rows])
    return torch.stack(outs, dim=1).to(torch.int32)


def hash_aggregate_sum(keys: torch.Tensor, values: torch.Tensor,
                       mask: torch.Tensor, max_groups: int):
    """Exact group-by-sum with static output capacity.

    Returns ``(group_keys[max_groups], sums[max_groups], have,
    num_groups)``.  Rows with ``mask`` False are excluded.  ``num_groups``
    is the number of distinct live keys: past ``max_groups``, the groups
    last in key order were dropped and the caller must re-run with a larger
    capacity."""
    w = _order_word(keys)
    rep, have, ng, outs, _ = _aggregate(
        [w], [(w[0], None)], [(values, "sum", None)], mask, max_groups)
    return _gather(keys, rep, have), outs[0], have, ng


def hash_aggregate_multi(keys: Sequence[torch.Tensor], measures: Sequence,
                         mask: torch.Tensor, max_groups: int):
    """Multi-key group-by with mixed measures: ``measures`` holds
    ``(values, op)`` with op in ``sum``, ``count``, ``min``, ``max``,
    ``avg`` (count ignores its values; avg divides as float32).  Same
    capacity contract as :func:`hash_aggregate_sum`.  Returns
    ``(group_keys list, outs list, have, num_groups)``."""
    for _, op in measures:
        if op not in _AGG_OPS:
            raise ValueError(f"unknown aggregate op {op!r}")
    words = [_order_word(k) for k in keys]
    rep, have, ng, outs, _ = _aggregate(
        words, [(w, None) for w, _ in words],
        [(v, op, None) for v, op in measures], mask, max_groups)
    return [_gather(k, rep, have) for k in keys], outs, have, ng


def hash_aggregate_sum_multi(keys: Sequence[torch.Tensor],
                             values: Sequence[torch.Tensor],
                             mask: torch.Tensor, max_groups: int):
    """Multi-key, multi-measure group-by-sum (the TPC-DS q72 aggregate
    shape): :func:`hash_aggregate_multi` with every measure summed."""
    return hash_aggregate_multi(keys, [(v, "sum") for v in values], mask,
                                max_groups)


def _lexsort_live_last(keys, mask: torch.Tensor, descending=None):
    """Stable lexicographic order over integer key tensors (first key
    major), rows with ``mask`` False last under each key type's maximum;
    ``descending[i]`` reverses key ``i`` by ``~k``.  As in the JAX package,
    a live key equal to that sentinel ties with the masked rows, which
    keep their row order among them.  Returns ``(order, sorted transformed
    keys, sorted live)``."""
    desc = descending or [False] * len(keys)
    ks, words = [], []
    for k, d in zip(keys, desc):
        _order_word(k)                       # integer keys only
        b = bits_view(k)
        if d:
            b = ~b
        t = torch.where(mask, b, _max_bits(k.dtype)).view(k.dtype)
        ks.append(t)
        words.append(_order_word(t))
    order, _ = _lexsort(words)
    return (order, [bits_view(k)[order].view(k.dtype) for k in ks],
            mask[order])


def sort_order(keys: Sequence[torch.Tensor],
               mask: Optional[torch.Tensor] = None,
               descending: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """Row order of a multi-key ORDER BY: stable lexicographic sort over
    integer key tensors (first key major), rows with ``mask`` False last;
    ``descending[i]`` flips key ``i``.  Returns int64 ``[n]`` gather
    indices (see :func:`_lexsort_live_last` for the tie at the extreme
    key value)."""
    n = keys[0].shape[0]
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=keys[0].device)
    if descending is not None and len(descending) != len(keys):
        raise ValueError("descending flags must match the key count")
    return _lexsort_live_last(list(keys), mask, descending)[0]


# ---------------------------------------------------------------------------
# Joins over raw key tensors (build sorted once, probe by binary search)
# ---------------------------------------------------------------------------

def _sort_build(build_keys, probe_keys, *payloads):
    """Build keys sorted (stable) with their payloads, and the probe keys
    in the same comparable type."""
    bk, pk, _ = _common_sortable(build_keys, probe_keys)
    bks, perm = torch.sort(bk, stable=True)
    return bks, pk, [p[perm] for p in payloads]


def sort_merge_join(build_keys: torch.Tensor, build_payload: torch.Tensor,
                    probe_keys: torch.Tensor):
    """Equi-join probe rows against a unique-key build side: returns
    ``(payload_for_probe, matched)``.  An unmatched probe row carries the
    payload at its insertion point (clamped to the last build row), as in
    the JAX package."""
    nb = build_keys.shape[0]
    if nb == 0:
        return (torch.zeros(probe_keys.shape, dtype=build_payload.dtype,
                            device=probe_keys.device),
                torch.zeros(probe_keys.shape, dtype=torch.bool,
                            device=probe_keys.device))
    bks, pk, (bps,) = _sort_build(build_keys, probe_keys, build_payload)
    pos = torch.searchsorted(bks, pk).clamp(max=nb - 1)
    return bps[pos], bks[pos] == pk


def sort_merge_join_live(build_keys: torch.Tensor,
                         build_payload: torch.Tensor,
                         build_live: torch.Tensor,
                         probe_keys: torch.Tensor):
    """:func:`sort_merge_join` with build-side liveness (the serving layer
    pads build sides; dead pad rows must not match): dead build rows park
    under the key type's maximum, liveness gates ``matched``, and unmatched
    payload slots are zero."""
    nb = build_keys.shape[0]
    if nb == 0:
        return sort_merge_join(build_keys, build_payload, probe_keys)
    bk, pk, big = _common_sortable(build_keys, probe_keys)
    _integer_keys(big)
    k = torch.where(build_live, bk, big)
    bks, perm = torch.sort(k, stable=True)
    bps, bl = build_payload[perm], build_live[perm]
    pos = torch.searchsorted(bks, pk).clamp(max=nb - 1)
    matched = (bks[pos] == pk) & bl[pos]
    pay = bps[pos]
    return torch.where(matched, pay, torch.zeros((), dtype=pay.dtype,
                                                 device=pay.device)), matched


def _expand_matches(lo, counts, matches, n_probe: int, capacity: int,
                    payloads, nb: int):
    """Slots ``[0, capacity)`` of a join's output: each probe row ``i``
    owns ``counts[i]`` consecutive slots, the first ``matches[i]`` of them
    matched to build rows ``lo[i]``, ``lo[i] + 1``, ...  Returns
    ``(probe_idx, payloads gathered (zero where unmatched), valid, matched,
    total, overflow)``."""
    dev = counts.device
    starts = torch.cumsum(counts, 0) - counts
    total = counts.sum()
    slots = torch.arange(capacity, dtype=torch.int64, device=dev)
    probe_idx = (torch.searchsorted(starts, slots, right=True) - 1) \
        .clamp(0, n_probe - 1)
    within = slots - starts[probe_idx]
    valid = (slots < total) & (within < counts[probe_idx])
    matched = valid & (within < matches[probe_idx])
    bidx = (lo[probe_idx] + within).clamp(0, nb - 1)
    return (probe_idx, [_gather(p, bidx, matched) for p in payloads], valid,
            matched, total, total > capacity)


def _empty_join(capacity: int, payload_dtype, device):
    z = torch.zeros(capacity, dtype=torch.int64, device=device)
    f = torch.zeros(capacity, dtype=torch.bool, device=device)
    return (z, torch.zeros(capacity, dtype=payload_dtype, device=device), f,
            torch.zeros((), dtype=torch.int64, device=device),
            torch.zeros((), dtype=torch.bool, device=device))


def sort_merge_join_dup(build_keys: torch.Tensor, build_payload: torch.Tensor,
                        probe_keys: torch.Tensor, capacity: int):
    """Inner equi-join against a build side with duplicate keys: one output
    slot per (probe row, matching build row), in a ``capacity``-slot buffer.
    Returns ``(probe_idx, payload, slot_valid, total_matches, overflow)``;
    with ``overflow`` True the caller must retry with more capacity."""
    nb, npk = build_keys.shape[0], probe_keys.shape[0]
    if nb == 0 or npk == 0:
        return _empty_join(capacity, build_payload.dtype, probe_keys.device)
    bks, pk, (bps,) = _sort_build(build_keys, probe_keys, build_payload)
    lo = torch.searchsorted(bks, pk)
    counts = torch.searchsorted(bks, pk, right=True) - lo
    probe_idx, (payload,), valid, _, total, ovf = _expand_matches(
        lo, counts, counts, npk, capacity, [bps], nb)
    return probe_idx, payload, valid, total, ovf


def join_semi_mask(build_keys: torch.Tensor,
                   probe_keys: torch.Tensor) -> torch.Tensor:
    """Left-semi existence mask: True where a probe key appears in the
    build side (duplicates allowed); the left-anti mask is its negation."""
    if build_keys.shape[0] == 0:
        return torch.zeros(probe_keys.shape, dtype=torch.bool,
                           device=probe_keys.device)
    bks, pk, _ = _sort_build(build_keys, probe_keys)
    return torch.searchsorted(bks, pk, right=True) > \
        torch.searchsorted(bks, pk)


def sort_merge_join_left(build_keys: torch.Tensor,
                         build_payload: torch.Tensor,
                         probe_keys: torch.Tensor, capacity: int):
    """Left outer equi-join against a build side with duplicate keys: every
    probe row emits at least one slot; an unmatched one emits one slot with
    ``matched`` False and a zero payload.  Returns ``(probe_idx, payload,
    slot_valid, matched, total_rows, overflow)``."""
    npk, nb = probe_keys.shape[0], build_keys.shape[0]
    dev = probe_keys.device
    if npk == 0:
        z, p, f, t, o = _empty_join(capacity, build_payload.dtype, dev)
        return z, p, f, f.clone(), t, o
    if nb == 0:
        slots = torch.arange(capacity, dtype=torch.int64, device=dev)
        return (slots.clamp(max=npk - 1),
                torch.zeros(capacity, dtype=build_payload.dtype, device=dev),
                slots < npk, torch.zeros(capacity, dtype=torch.bool,
                                         device=dev),
                torch.full((), npk, dtype=torch.int64, device=dev),
                torch.full((), npk > capacity, dtype=torch.bool, device=dev))
    bks, pk, (bps,) = _sort_build(build_keys, probe_keys, build_payload)
    lo = torch.searchsorted(bks, pk)
    matches = torch.searchsorted(bks, pk, right=True) - lo
    probe_idx, (payload,), valid, matched, total, ovf = _expand_matches(
        lo, matches.clamp(min=1), matches, npk, capacity, [bps], nb)
    return probe_idx, payload, valid, matched, total, ovf


# ---------------------------------------------------------------------------
# The flagship step
# ---------------------------------------------------------------------------

def flagship_query_step(sold_date, item_key, quantity, price,
                        build_item_key, build_item_price):
    """A TPC-DS-q6-shaped step over store_sales-like tensors: join the
    items (:func:`sort_merge_join`), keep ``price > 1.2 * item_price``
    (float32), project ``revenue = price * float32(quantity)`` and sum it
    by ``sold_date`` (:func:`hash_aggregate_sum`, :data:`MAX_GROUPS`).
    int32 / float32 tensors; returns ``(gkeys, sums, have, num_groups)``."""
    item_price, matched = sort_merge_join(build_item_key, build_item_price,
                                          item_key)
    mask = matched & (price > 1.2 * item_price)
    revenue = price * quantity.to(torch.float32)
    return hash_aggregate_sum(sold_date, revenue, mask, MAX_GROUPS)


# ---------------------------------------------------------------------------
# Host merges of partial aggregates
# ---------------------------------------------------------------------------

def _check_merge_ops(ops: Sequence[str]) -> None:
    for op in ops:
        if op == "avg":
            raise ValueError(
                "avg partials do not merge; aggregate sum and count "
                "partials and divide after merging")
        if op not in _AGG_OPS:
            raise ValueError(f"unknown aggregate op {op!r}")


def _merge_one(acc, vals, ops: Sequence[str]) -> None:
    """Accumulate one group's measure values into ``acc`` in place (Python
    scalars, arbitrary precision; None skips, Spark's null semantics)."""
    for i, op in enumerate(ops):
        v = vals[i]
        if v is None:
            continue
        if acc[i] is None:
            acc[i] = v
        elif op in ("sum", "count"):
            acc[i] = acc[i] + v
        elif op == "min":
            acc[i] = min(acc[i], v)
        else:
            acc[i] = max(acc[i], v)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def merge_aggregate_partials(partials, ops: Sequence[str]):
    """Combine partial aggregates into final groups (the final phase of
    Spark's partial/final aggregation), on the host: ``partials`` holds
    ``(gkeys list, outs list, have)`` triples as the aggregates return them
    (leading axes are flattened); ``ops`` the measure ops (avg partials do
    not merge: carry sum and count).  Values merge as Python scalars, so
    int32 sums do not wrap.  Returns ``{keys tuple: [merged measures]}``."""
    _check_merge_ops(ops)
    out = {}
    for gkeys, outs, have in partials:
        hv = _host(have).reshape(-1)
        gk = [_host(k).reshape(-1) for k in gkeys]
        ms = [_host(m).reshape(-1) for m in outs]
        for j in np.nonzero(hv)[0]:
            key = tuple(int(k[j]) for k in gk)
            vals = [m[j].item() for m in ms]
            if key not in out:
                out[key] = list(vals)
                continue
            _merge_one(out[key], vals, ops)
    return out


def merge_aggregate_table_partials(results, num_keys: int,
                                   ops: Sequence[str]):
    """Combine result tables of :func:`hash_aggregate_table` into final
    groups with Spark null semantics, on the host: keys are tuples with
    None for null keys; SUM/MIN/MAX of an all-null group stay None.
    ``results``: ``(result_table, have)`` pairs whose columns are
    ``num_keys`` keys then one per op.  Returns ``{key tuple: [merged
    measure values]}``."""
    _check_merge_ops(ops)
    out: Dict = {}
    for table, have in results:
        hv = _host(have).reshape(-1)
        cols = [c.to_pylist() for c in table.columns]
        for j in np.nonzero(hv)[0]:
            key = tuple(col[j] for col in cols[:num_keys])
            vals = [cols[num_keys + i][j] for i in range(len(ops))]
            if key not in out:
                out[key] = list(vals)
                continue
            _merge_one(out[key], vals, ops)
    return out


# ---------------------------------------------------------------------------
# Table / GroupedColumns group-by with Spark null semantics
# ---------------------------------------------------------------------------

def _source_column(source, i: int) -> Column:
    return source.column(i)


def _string_key_words(c: Column, what: str, width: int = 0):
    """A dense-padded string column as order words: its chars as 32-bit
    big-endian words (byte order is the words' unsigned order), then its
    length, which tells "a" from "a\\x00".  ``width`` pads the chars wider
    first, so that two columns get the same words.  Returns (words,
    padded width).  An Arrow-layout column raises ``ValueError``, as in
    the JAX package: ``to_padded()`` it first."""
    if not c.is_padded:
        raise ValueError(
            f"string {what} keys need dense-padded columns "
            f"(Column.to_padded)")
    b = c.chars2d
    target = -(-max(width, b.shape[1]) // 4) * 4
    if b.shape[1] < target:
        b = torch.nn.functional.pad(b, (0, target - b.shape[1]))
    q = b.to(torch.int64).view(b.shape[0], target // 4, 4)
    be = (q[:, :, 0] << 24) | (q[:, :, 1] << 16) | (q[:, :, 2] << 8) \
        | q[:, :, 3]
    words = [(be[:, j], 32) for j in range(target // 4)]
    words.append(_order_word(c.lens))
    return words, target


def _key_subarrays(c: Column, kv: torch.Tensor):
    """A key column's order words (its null flag first, the value zeroed
    under null) and its single-word form for the domain strategy (None for
    a string).  Keys of 16 bits or fewer pack as ``(null << bits) |
    unsigned bits``, one word."""
    null = (~kv).to(torch.int64)
    if c.dtype.is_string:
        words, _ = _string_key_words(c, "group-by")
        return [(null, 1)] + [(torch.where(kv, w, 0), bits)
                              for w, bits in words], None
    if c.data.dim() != 1:
        raise ValueError(f"{c.dtype} keys cannot be grouped")
    bits = 8 * c.data.element_size()
    if bits <= 16 and not c.data.dtype.is_floating_point:
        u = bits_view(c.data).to(torch.int64) & ((1 << bits) - 1)
        packed = torch.where(kv, u, 1 << bits)
        return [(packed, bits + 1)], (packed, None)
    w, wbits = _order_word(c.data)
    zero = _order_word(torch.zeros((), dtype=c.data.dtype,
                                   device=c.device))[0]
    return [(null, 1), (torch.where(kv, w, zero), wbits)], (w, kv)


def _key_column(c: Column, kv, rep, have) -> Column:
    """The result's key column: each group's key from its first row, null
    for the null-key group, zero in empty slots."""
    n = c.num_rows
    valid = have & kv[rep] if n else have
    if c.dtype.is_string:
        if n:
            chars = torch.where(valid[:, None], c.chars2d[rep], 0)
            lens = torch.where(valid, c.lens[rep], 0)
        else:
            chars = torch.zeros((have.shape[0], c.chars2d.shape[1]),
                                dtype=torch.uint8, device=have.device)
            lens = torch.zeros(have.shape[0], dtype=torch.int32,
                               device=have.device)
        return Column.padded_strings(chars, lens, pack_bools(valid))
    return Column(c.dtype, _gather(c.data, rep, valid), pack_bools(valid))


def _hash_aggregate_body(source, mask, key_idxs, measures,
                         max_groups: int):
    """The group-by of :func:`hash_aggregate_table` (see there)."""
    n = source.num_rows
    live = (torch.ones(n, dtype=torch.bool, device=source.device)
            if mask is None else mask)
    key_cols = [_source_column(source, i) for i in key_idxs]
    key_valid = [c.valid_bools() for c in key_cols]
    words, dkeys = [], []
    for c, kv in zip(key_cols, key_valid):
        w, d = _key_subarrays(c, kv)
        words.extend(w)
        dkeys.append(d)
    if any(d is None for d in dkeys):
        dkeys = None

    mcore = []
    davg = set()       # positions where a decimal128 AVG expanded into
    #                    (sum, count)
    mcols = []
    for idx, op in measures:
        if op not in _AGG_OPS:
            raise ValueError(f"unknown aggregate op {op!r}")
        if idx is None:                         # COUNT(*)
            mcols.append(None)
            mcore.append((None, "count", None))
            continue
        c = _source_column(source, idx)
        mcols.append(c)
        cv = c.valid_bools()
        if op == "count":
            mcore.append((None, "count", cv))
        elif c.dtype.is_string:
            raise ValueError(f"{op} of a string column")
        elif op == "avg" and c.dtype.kind == "decimal128":
            davg.add(len(mcore))
            mcore.append((c.data, "sum", cv))
            mcore.append((None, "count", cv))
        else:
            mcore.append((c.data, op, cv))

    rep, have, num_groups, outs, metas = _aggregate(
        words, dkeys, mcore, live, max_groups)

    out_cols = [_key_column(c, kv, rep, have)
                for c, kv in zip(key_cols, key_valid)]
    oi = 0
    for (idx, op), c in zip(measures, mcols):
        out, meta = outs[oi], metas[oi]
        if oi in davg:
            # Spark's decimal AVG: the exact sum over the count, HALF_UP, at
            # the input scale + 4 (capped at 38); a quotient past 38 digits
            # is null (non-ANSI)
            cnt = outs[oi + 1]
            oi += 2
            s = c.dtype.scale
            sum_col = Column(decimal128(s), out, pack_bools(have & meta))
            cnt_limbs = torch.zeros((cnt.shape[0], 4), dtype=torch.int32,
                                    device=cnt.device)
            cnt_limbs[:, 0] = cnt
            q, _ = div_decimal128(
                sum_col, Column(decimal128(0), cnt_limbs, pack_bools(have)),
                result_scale=min(s + 4, 38))
            out_cols.append(q)
            continue
        oi += 1
        if op == "count":
            out_cols.append(Column(INT32, out, pack_bools(have)))
            continue
        dt = FLOAT32 if op == "avg" else c.dtype
        out_cols.append(Column(dt, out, pack_bools(have & meta)))
    return Table(tuple(out_cols)), have, num_groups


def hash_aggregate_table(source, key_idxs: Sequence[int],
                         measures: Sequence, max_groups: int,
                         mask: Optional[torch.Tensor] = None,
                         bucket=None):
    """Group-by over a ``Table`` or ``GroupedColumns`` with Spark null
    semantics.

    ``measures``: ``(column index or None, op)`` pairs, None meaning
    COUNT(*); ops ``sum``, ``count``, ``min``, ``max``, ``avg`` over every
    fixed-width type, decimal128 included (its AVG divides HALF_UP at the
    input scale + 4; other AVGs are float32).  Returns ``(result_table,
    have, num_groups)``: the key columns then one column per measure, with
    validity (null-key groups show null keys; SUM/MIN/MAX/AVG of a group
    without a non-null value are null, COUNT never is); ``have`` flags the
    slots that hold a group; ``num_groups`` counts every distinct live key
    (see :func:`hash_aggregate_sum`).  Dense-padded string keys group by
    their bytes and length.

    ``bucket="auto"`` pads a ``Table`` source up the shape grid
    (``runtime.shapes.pad_table``, the padded rows dead) and gives the same
    result; the default ``None`` runs on the rows as they are."""
    n = source.num_rows
    f = shapes.resolve(bucket)
    if (f is not None and isinstance(source, Table) and n > 0
            and shapes.bucketable(source)):
        b = shapes.bucket_rows(n, f)
        source = shapes.pad_table(source, b)
        mask = shapes.pad_mask(mask, n, b, source.device)
    return _hash_aggregate_body(source, mask, list(key_idxs),
                                [(i, op) for i, op in measures],
                                max_groups)


# ---------------------------------------------------------------------------
# String joins
# ---------------------------------------------------------------------------

def _dense_join_ids(build_c: Column, probe_c: Column):
    """Equality- and order-preserving int64 ids for two string key columns:
    both sides' order words (at one width) in one lexicographic sort, each
    run of equal keys numbered.  The ids feed the integer join bodies
    unchanged; validity is not read."""
    nb = build_c.num_rows
    n = nb + probe_c.num_rows
    dev = build_c.device
    if n == 0:
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        return z, z
    W = max(build_c.chars2d.shape[1] if build_c.is_padded else 0,
            probe_c.chars2d.shape[1] if probe_c.is_padded else 0)
    bw, _ = _string_key_words(build_c, "join", W)
    pw, _ = _string_key_words(probe_c, "join", W)
    words = [(torch.cat([b, p]), bits) for (b, bits), (p, _) in zip(bw, pw)]
    perm, sc = _lexsort(words)
    run = torch.cumsum(_run_starts(sc, n, dev), 0) - 1
    ids = torch.empty_like(run)
    ids[perm] = run
    return ids[:nb], ids[nb:]


def _string_join_fill(build: Column, probe: Column, build_payloads):
    """Shared core of the string joins: per probe row, ``matched`` (its
    valid key equals a valid build key), the payloads of the last valid
    build row with that key (zero where unmatched), and ``ambiguous`` (a
    valid build key value repeats)."""
    nb, npr = build.num_rows, probe.num_rows
    dev = probe.device
    if nb == 0 or npr == 0:
        return (torch.zeros(npr, dtype=torch.bool, device=dev),
                [torch.zeros(npr, dtype=p.dtype, device=dev)
                 for p in build_payloads],
                torch.zeros((), dtype=torch.bool, device=dev))
    bid, pid = _dense_join_ids(build, probe)
    bv = build.valid_bools()
    last = torch.full((nb + npr,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, bid, torch.where(
        bv, torch.arange(nb, device=dev), -1), "amax")
    cnt = torch.zeros(nb + npr, dtype=torch.int64, device=dev)
    cnt.index_add_(0, bid, bv.to(torch.int64))
    rep = last[pid]
    matched = probe.valid_bools() & (rep >= 0)
    pays = [_gather(p, rep.clamp(min=0), matched) for p in build_payloads]
    return matched, pays, (cnt > 1).any()


def join_semi_mask_strings(build: Column, probe: Column) -> torch.Tensor:
    """Left-semi existence mask for dense-padded STRING keys with Spark
    null semantics (null keys never match); duplicate build keys are
    fine."""
    return _string_join_fill(build, probe, [])[0]


def sort_merge_join_strings(build: Column, build_payloads, probe: Column):
    """Equi-join probe rows against a STRING build side with unique valid
    keys: returns ``(payloads list, matched, ambiguous)``.  Unmatched and
    null rows carry zero payloads; ``ambiguous`` (a bool tensor) is True
    when a valid build key value repeats, which the caller must check."""
    matched, pays, ambiguous = _string_join_fill(build, probe,
                                                 list(build_payloads))
    return pays, matched, ambiguous


# ---------------------------------------------------------------------------
# Table joins with null-key exclusion
# ---------------------------------------------------------------------------

def _join_keys_pair(build, build_key: int, probe, probe_key: int):
    """``(bk, bv, pk, pv)``: the join's key tensors and validity; string
    keys (dense-padded) become joint ids (:func:`_dense_join_ids`)."""
    bc = _source_column(build, build_key)
    pc = _source_column(probe, probe_key)
    for c in (bc, pc):
        if c.dtype.kind == "decimal128":
            raise NotImplementedError(
                "decimal128 join keys: cast keys upstream")
    if bc.dtype.is_string != pc.dtype.is_string:
        raise ValueError(
            "join key type mismatch: one side is a string and the other is "
            "not; cast keys to a common type upstream as Spark's planner "
            "does")
    if bc.dtype.is_string:
        bk, pk = _dense_join_ids(bc, pc)
    else:
        bk, pk = bc.data, pc.data
    return bk, bc.valid_bools(), pk, pc.valid_bools()


def _pad_join_sides(build, probe, bucket):
    """Both sides padded up the shape grid (padded rows invalid) when
    ``bucket`` asks for it and both are paddable tables."""
    f = shapes.resolve(bucket)
    if (f is not None and isinstance(build, Table)
            and isinstance(probe, Table) and build.num_rows > 0
            and probe.num_rows > 0 and shapes.bucketable(build)
            and shapes.bucketable(probe)):
        build = shapes.pad_table(build, shapes.bucket_rows(build.num_rows, f))
        probe = shapes.pad_table(probe, shapes.bucket_rows(probe.num_rows, f))
    return build, probe


def join_semi_mask_table(build, build_key: int, probe, probe_key: int,
                         bucket=None) -> torch.Tensor:
    """Left-semi existence mask with Spark null semantics: null probe keys
    never match, null build keys match nothing.  ``bucket="auto"`` pads
    both sides up the shape grid first; the mask is sliced back."""
    n = probe.num_rows
    build, probe = _pad_join_sides(build, probe, bucket)
    return shapes.unpad_array(
        _join_semi_mask_core(build, build_key, probe, probe_key), n)


def _join_semi_mask_core(build, build_key, probe, probe_key):
    bk, bv, pk, pv = _join_keys_pair(build, build_key, probe, probe_key)
    if bk.shape[0] == 0:
        return torch.zeros_like(pv)
    # null build rows park at the sentinel and hits are bounded by the
    # count of real rows, so a live probe equal to it cannot false-match
    k, p, big = _common_sortable(bk, pk)
    _integer_keys(big)
    bks = torch.sort(torch.where(bv, k, big)).values
    n_real = bv.sum()
    lo = torch.searchsorted(bks, p)
    hi = torch.searchsorted(bks, p, right=True)
    return pv & (torch.minimum(hi, n_real) > lo)


def join_inner_table(build, build_key: int, build_payload: int, probe,
                     probe_key: int, capacity: int, bucket=None):
    """Inner join (duplicate build keys allowed) with null-key exclusion on
    both sides.  Returns ``(probe_idx, payload, payload_valid, slot_valid,
    total, overflow)``: :func:`sort_merge_join_dup`'s outputs plus the
    gathered payload's own validity (a matched row with a null payload
    stays, with ``payload_valid`` False).  ``bucket="auto"`` pads both
    sides first; ``probe_idx`` stays within the true probe rows."""
    n = probe.num_rows
    build, probe = _pad_join_sides(build, probe, bucket)
    out = _join_inner_core(build, build_key, build_payload, probe,
                           probe_key, capacity)
    probe_idx, payload, payload_valid, slot_valid, total, ovf = out
    if n:
        probe_idx = probe_idx.clamp(max=n - 1)
    return probe_idx, payload, payload_valid, slot_valid, total, ovf


def _join_inner_core(build, build_key, build_payload, probe, probe_key,
                     capacity):
    bk, bv, pk, pv = _join_keys_pair(build, build_key, probe, probe_key)
    bpc = _source_column(build, build_payload)
    nb, npk = bk.shape[0], pk.shape[0]
    if nb == 0 or npk == 0:
        z, p, f, t, o = _empty_join(capacity, bpc.data.dtype, pv.device)
        return z, p, f, f.clone(), t, o
    # null build rows park at the key sentinel, after every real row of
    # that key value (invalidity is the minor sort key), so the window
    # [lo, lo + count) bounded by the real rows covers real rows only
    k, p, big = _common_sortable(bk, pk)
    _integer_keys(big)
    ks = torch.where(bv, k, big)
    perm, _ = _lexsort([_order_word(ks), ((~bv).to(torch.int64), 1)])
    bks = ks[perm]
    lo = torch.searchsorted(bks, p)
    hi = torch.minimum(torch.searchsorted(bks, p, right=True), bv.sum())
    counts = torch.where(pv, (hi - lo).clamp(min=0), 0)
    probe_idx, (payload, pvalid), valid, _, total, ovf = _expand_matches(
        lo, counts, counts, npk, capacity,
        [bpc.data[perm], bpc.valid_bools()[perm]], nb)
    return probe_idx, payload, pvalid, valid, total, ovf
