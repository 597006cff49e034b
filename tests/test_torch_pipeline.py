"""PyTorch port, the query operators (``models/pipeline.py``) and decimal
division (``ops/decimal.py``), held against the JAX package on the same
seeded numpy inputs, on the CPU.

Keys, group order, ``have``, ``num_groups``, validity, counts, integer and
decimal128 results, MIN and MAX must be equal bit for bit (data under nulls
included).  Float32 SUM and AVG may differ by the order of their additions:
they must agree within ``FLOAT_RTOL`` of the group's sum of absolute values
(the port accumulates in float64, the JAX package in float32).  The JAX side
runs eagerly at ``bucket=None`` (about a second a call), so each JAX result
is computed once a module and shared by the cases that read it."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_jni_tpu import table as jt
from spark_rapids_jni_tpu.models import pipeline as jpl
from spark_rapids_jni_tpu.ops import decimal as jdec
from spark_rapids_jni_tpu.ops import row_layout as jrl
from spark_rapids_jni_tpu.ops import row_mxu as jmx
from spark_rapids_jni_tpu_torch import interop
from spark_rapids_jni_tpu_torch import table as pt
from spark_rapids_jni_tpu_torch.models import pipeline as pl
from spark_rapids_jni_tpu_torch.ops import decimal as pdec
from spark_rapids_jni_tpu_torch.ops import row_layout as prl
from spark_rapids_jni_tpu_torch.ops import row_mxu as pmx

from _torch_port import (
    ALL_FIXED_NAMES, NULL_MODES, assert_same_columns, both_string_columns,
    jax_columns, numpy_columns, tables_from_columns,
)

# float32 SUM and AVG: |port - jax| <= FLOAT_RTOL * sum of the group's |values|
FLOAT_RTOL = 1e-5
N = 300
# the capacity most cases share (JAX compiles its ops once a shape)
MG = 8
KEY_NAMES = [n for n in ALL_FIXED_NAMES if "float" not in n] + ["date32"]
MEASURE_NAMES = ["int32", "int64", "float32", "decimal128(scale=3)"]
OPS = ("count", "sum", "min", "max", "avg")
# DENSE_MAX_SLOTS values that force each strategy: 0 the sort, FORCE_DOMAIN
# the domain wherever the keys' range fits it (4M slots)
FORCE_DOMAIN = 1 << 22


def _force(monkeypatch, dense):
    """The aggregate's strategy forced by ``dense`` (the domain allowed at
    any row count, as it is not by default at these sizes)."""
    monkeypatch.setattr(pl, "DENSE_MAX_SLOTS", dense)
    monkeypatch.setattr(pl, "DOMAIN_MIN_ROWS", 0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _eq(got, want, what=""):
    g, w = np.atleast_1d(_np(got)), np.atleast_1d(_np(want))
    assert g.shape == w.shape, (what, g.shape, w.shape)
    np.testing.assert_array_equal(g.view(np.uint8) if g.dtype != bool else g,
                                  w.view(np.uint8) if w.dtype != bool else w,
                                  err_msg=what)


def _close(got, want, scale, what=""):
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert g.shape == w.shape, what
    assert np.all(np.abs(g - w) <= FLOAT_RTOL * np.maximum(scale, 1e-30)), \
        (what, g, w)


def _pool(rng, values, n):
    """Key values repeating: ``n`` draws from twelve of ``values`` (the
    first two among them), so that groups hold several rows."""
    v = np.asarray(values)
    pick = np.concatenate([v[:2], v[-2:], v[rng.integers(0, len(v), 8)]])
    return pick[rng.integers(0, len(pick), n)]


def _key_column(rng, name, n, null_mode, extremes=True):
    (_, v, ok), = numpy_columns(rng, [name], n, null_mode)
    info = np.iinfo(v.dtype) if v.dtype.kind in "iu" else None
    if info is not None and extremes:
        v[:2] = [info.min, info.max]
    elif info is not None:
        v = (v % 1000).astype(v.dtype)
    return name, _pool(rng, v, n).astype(v.dtype), ok


def _measure_columns(rng, n, null_mode):
    """int32 and int64 near their limits (sums wrap), float32 in [-1e3,
    1e3), decimal128 from +-(10^38 - 1) down to small values."""
    cols = numpy_columns(rng, MEASURE_NAMES, n, null_mode)
    out = []
    for name, v, ok in cols:
        if name == "float32":
            v = rng.uniform(-1e3, 1e3, n).astype(np.float32)
        elif name.startswith("decimal128"):
            mags = [10 ** 38 - 1, 10 ** 20 + 7, 12345, 1, 0]
            ints = [(-1) ** int(rng.integers(2)) * mags[int(rng.integers(5))]
                    for _ in range(n)]
            v = _limbs(ints)
        out.append((name, v, ok))
    return out


def _limbs(ints):
    two = [v & ((1 << 128) - 1) for v in ints]
    return np.array([[(t >> (32 * k)) & 0xFFFFFFFF for k in range(4)]
                     for t in two], np.uint32).reshape(len(ints), 4)


def _float_scale(values, valid, live, gkeys_rows):
    """Per group: the sum of |values| over its live valid rows."""
    return np.array([np.abs(values[r & live & valid]).sum()
                     for r in gkeys_rows])


def _assert_result(res, jres, float_cols=(), scales=None):
    """A port aggregate result ``(table, have, num_groups)`` against the
    JAX one: every column exact, except ``float_cols`` within the float
    tolerance of ``scales[i]``."""
    table, have, ng = res
    jtable, jhave, jng = jres
    _eq(have, jhave, "have")
    assert int(ng) == int(jng)
    exact = [i for i in range(table.num_columns) if i not in float_cols]
    assert_same_columns(pt.Table([table.columns[i] for i in exact]),
                        jt.Table(tuple(jtable.columns[i] for i in exact)))
    for i in float_cols:
        got, want = table.columns[i], jtable.columns[i]
        _eq(got.valid_bools(), want.valid_bools(), f"column {i} validity")
        _close(got.data, want.data, scales[i], f"column {i}")


# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------

def test_project_and_filter_mask():
    rng = np.random.default_rng(1)
    cols = numpy_columns(rng, ["int32", "int32", "int32"], 64, "some")
    for _, v, _ in cols:
        v %= 1000
    jtab, ptab = tables_from_columns(cols)
    jp = jpl.project(jtab, [lambda a, b, c: a + b, lambda a, b, c: c * 2],
                     [jt.INT32, jt.INT32])
    pp = pl.project(ptab, [lambda a, b, c: a + b, lambda a, b, c: c * 2],
                    [pt.INT32, pt.INT32])
    for g, w in zip(pp.columns, jp.columns):
        _eq(g.data, w.data)
    for refs in (None, [0], [0, 1]):
        _eq(pl.filter_mask(ptab, lambda a, b, c: a > b, refs),
            jpl.filter_mask(jtab, lambda a, b, c: a > b, refs), str(refs))


# ---------------------------------------------------------------------------
# Raw-array aggregates and ORDER BY
# ---------------------------------------------------------------------------

def _raw_sum_case(name):
    rng = np.random.default_rng(2)
    imax = np.iinfo(np.int32).max
    if name == "overflow":
        keys = rng.permutation(N).astype(np.int32)
        return keys, np.full(N, 3, np.int32), np.ones(N, bool), MG
    if name == "int32_max_key":
        # live keys equal to the dead rows' sentinel, dead rows among them
        keys = rng.integers(-5, 5, N).astype(np.int32)
        keys[::7] = imax
        return keys, np.arange(N, dtype=np.int32), rng.random(N) > 0.3, MG
    if name == "wrap":
        keys = rng.integers(-3, 3, N).astype(np.int32)
        vals = rng.integers(2 ** 30, 2 ** 31 - 1, N).astype(np.int32)
        return keys, vals, rng.random(N) > 0.2, MG
    if name == "all_dead":
        return (rng.integers(0, 9, N).astype(np.int32),
                np.ones(N, np.int32), np.zeros(N, bool), MG)
    keys = rng.integers(-50, 50, N).astype(np.int32)       # float values
    return keys, rng.uniform(-10, 10, N).astype(np.float32), \
        rng.random(N) > 0.3, 64


@pytest.mark.parametrize("case", ["overflow", "int32_max_key", "wrap",
                                  "all_dead", "float"])
@pytest.mark.parametrize("dense", [0, FORCE_DOMAIN])
def test_hash_aggregate_sum_matches_jax(case, dense, monkeypatch):
    keys, vals, mask, mg = _raw_sum_case(case)
    _force(monkeypatch, dense)
    pl.reset_strategies()
    got = pl.hash_aggregate_sum(_t(keys), _t(vals), _t(mask), mg)
    # the domain where it was forced and the keys' range fits it
    domain = dense and case in ("overflow", "wrap", "float")
    assert dict(pl.strategies) == {"domain" if domain else "sort": 1}
    want = jpl.hash_aggregate_sum(jnp.asarray(keys), jnp.asarray(vals),
                                  jnp.asarray(mask), mg)
    _eq(got[0], want[0], "keys")
    _eq(got[2], want[2], "have")
    assert int(got[3]) == int(want[3])
    if vals.dtype == np.float32:
        scale = np.array([np.abs(vals[(keys == k) & mask]).sum()
                          for k in _np(want[0])])
        _close(got[1], want[1], scale, "sums")
    else:
        _eq(got[1], want[1], "sums")


@pytest.fixture(scope="module")
def multi_case():
    rng = np.random.default_rng(3)
    n = 200
    k1 = rng.integers(-2, 3, n).astype(np.int32)
    k2 = rng.integers(0, 4, n).astype(np.int16)
    k3 = np.array([0, 1, 0xFFFFFFFF], np.uint32)[rng.integers(0, 3, n)]
    v = rng.integers(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32)
    f = rng.uniform(-5, 5, n).astype(np.float32)
    mask = rng.random(n) > 0.25
    measures = [(v, "sum"), (v, "count"), (v, "min"), (v, "max"),
                (v, "avg"), (f, "sum"), (f, "min")]
    want = jpl.hash_aggregate_multi(
        [jnp.asarray(k) for k in (k1, k2, k3)],
        [(jnp.asarray(x), op) for x, op in measures], jnp.asarray(mask), 32)
    return (k1, k2, k3), measures, mask, want


@pytest.mark.parametrize("dense", [0, FORCE_DOMAIN])
def test_hash_aggregate_multi_matches_jax(multi_case, dense, monkeypatch):
    keys, measures, mask, (wk, wouts, whave, wng) = multi_case
    _force(monkeypatch, dense)
    gk, outs, have, ng = pl.hash_aggregate_multi(
        [_t(k) for k in keys], [(_t(x), op) for x, op in measures],
        _t(mask), 32)
    for g, w in zip(gk, wk):
        _eq(g.view(torch.int32) if g.dtype == torch.uint32 else g,
            np.asarray(w).view(np.int32) if np.asarray(w).dtype == np.uint32
            else w, "keys")
    _eq(have, whave)
    assert int(ng) == int(wng)
    rows = [(keys[0] == a) & (keys[1] == b) & (keys[2] == c) & mask
            for a, b, c in zip(*(np.asarray(w) for w in wk))]
    for i, ((x, op), g, w) in enumerate(zip(measures, outs, wouts)):
        if op == "sum" and x.dtype == np.float32:
            _close(g, w, [np.abs(x[r]).sum() for r in rows], f"measure {i}")
        else:
            _eq(g, w, f"measure {i} {op}")


def test_hash_aggregate_sum_multi_is_multi_of_sums(multi_case):
    keys, measures, mask, _ = multi_case
    vals = [_t(measures[0][0]), _t(measures[0][0] // 7)]
    a = pl.hash_aggregate_sum_multi([_t(k) for k in keys], vals, _t(mask), 8)
    b = pl.hash_aggregate_multi([_t(k) for k in keys],
                                [(v, "sum") for v in vals], _t(mask), 8)
    for x, y in zip(a[0] + a[1] + [a[2], a[3]], b[0] + b[1] + [b[2], b[3]]):
        assert torch.equal(x, y)


def test_aggregate_rejects_float_keys_and_unknown_ops():
    keys = np.array([0.0, -0.0, np.nan, 1.0, np.nan], np.float32)
    vals = np.ones(5, np.int32)
    mask = np.ones(5, bool)
    with pytest.raises(ValueError):
        jpl.hash_aggregate_sum(jnp.asarray(keys), jnp.asarray(vals),
                               jnp.asarray(mask), 4)
    with pytest.raises(ValueError):
        pl.hash_aggregate_sum(_t(keys), _t(vals), _t(mask), 4)
    with pytest.raises(ValueError):
        pl.sort_order([_t(keys)])
    with pytest.raises(ValueError):
        pl.hash_aggregate_multi([_t(vals)], [(_t(vals), "median")],
                                _t(mask), 4)


@pytest.mark.parametrize("desc", [None, [False, True], [True, True]])
def test_sort_order_matches_jax(desc):
    rng = np.random.default_rng(4)
    n = 120
    imax = np.iinfo(np.int32).max
    k1 = rng.choice(np.array([imax, -5, 0, 3, -2 ** 31], np.int32), n)
    k2 = rng.integers(0, 3, n).astype(np.uint16)
    mask = rng.random(n) > 0.3
    for m in (None, mask):
        want = jpl.sort_order([jnp.asarray(k1), jnp.asarray(k2)],
                              None if m is None else jnp.asarray(m), desc)
        got = pl.sort_order([_t(k1), _t(k2)], None if m is None else _t(m),
                            desc)
        _eq(got, np.asarray(want).astype(np.int64), f"{desc} {m is None}")


# ---------------------------------------------------------------------------
# Raw-array joins
# ---------------------------------------------------------------------------

def _join_sides(case):
    rng = np.random.default_rng(5)
    if case == "unique":
        bk = rng.permutation(100)[:60].astype(np.int32)
        pk = rng.integers(-10, 110, 150).astype(np.int32)
    elif case == "dups":
        bk = rng.integers(0, 20, 60).astype(np.int32)
        pk = rng.integers(-2, 22, 150).astype(np.int32)
    elif case == "empty_build":
        bk = np.zeros(0, np.int32)
        pk = rng.integers(0, 9, 20).astype(np.int32)
    elif case == "empty_probe":
        bk = rng.integers(0, 9, 20).astype(np.int32)
        pk = np.zeros(0, np.int32)
    else:                                   # extreme keys, uint32
        bk = np.array([0, 0xFFFFFFFF, 7, 0xFFFFFFFF, 3], np.uint32)
        pk = np.array([0xFFFFFFFF, 7, 8, 0, 3, 3], np.uint32)
    bp = rng.integers(-1000, 1000, len(bk)).astype(np.int32)
    return bk, bp, pk


JOIN_CASES = ["unique", "dups", "empty_build", "empty_probe", "uint32"]


@pytest.mark.parametrize("case", JOIN_CASES)
def test_sort_merge_join_matches_jax(case):
    bk, bp, pk = _join_sides(case)
    if case == "unique":
        pay, m = pl.sort_merge_join(_t(bk), _t(bp), _t(pk))
        wpay, wm = jpl.sort_merge_join(*(jnp.asarray(a)
                                         for a in (bk, bp, pk)))
        _eq(m, wm, "matched")
        _eq(pay, wpay, "payload, unmatched garbage included")
    live = np.arange(len(bk)) % 4 != 3
    if case == "uint32":
        live[-2] = False
    if len(bk) and case != "dups":
        pay, m = pl.sort_merge_join_live(_t(bk), _t(bp), _t(live), _t(pk))
        wpay, wm = jpl.sort_merge_join_live(
            *(jnp.asarray(a) for a in (bk, bp, live, pk)))
        _eq(m, wm, "live matched")
        _eq(pay, wpay, "live payload")
    _eq(pl.join_semi_mask(_t(bk), _t(pk)),
        jpl.join_semi_mask(jnp.asarray(bk), jnp.asarray(pk)), "semi")
    for cap in (75, 454):        # below and above the matches of "dups"
        got = pl.sort_merge_join_dup(_t(bk), _t(bp), _t(pk), cap)
        want = jpl.sort_merge_join_dup(jnp.asarray(bk), jnp.asarray(bp),
                                       jnp.asarray(pk), cap)
        for g, w, what in zip(got, want, ("pidx", "pay", "valid", "total",
                                          "overflow")):
            _eq(g, np.asarray(w).astype(_np(g).dtype), f"dup {what} {cap}")
        got = pl.sort_merge_join_left(_t(bk), _t(bp), _t(pk), cap)
        want = jpl.sort_merge_join_left(jnp.asarray(bk), jnp.asarray(bp),
                                        jnp.asarray(pk), cap)
        for g, w, what in zip(got, want, ("pidx", "pay", "valid",
                                          "matched", "total", "overflow")):
            _eq(g, np.asarray(w).astype(_np(g).dtype), f"left {what} {cap}")


# ---------------------------------------------------------------------------
# The flagship step
# ---------------------------------------------------------------------------

def test_flagship_query_step_matches_jax_and_numpy():
    rng = np.random.default_rng(42)
    n, nitems = 2000, 64
    args = (rng.integers(0, 30, n).astype(np.int32),
            rng.integers(0, nitems + 8, n).astype(np.int32),
            rng.integers(1, 10, n).astype(np.int32),
            rng.uniform(1, 100, n).astype(np.float32),
            rng.permutation(nitems).astype(np.int32),
            rng.uniform(1, 80, nitems).astype(np.float32))
    gk, sums, have, ng = pl.flagship_query_step(*(_t(a) for a in args))
    wk, ws, wh, wng = jpl.flagship_query_step(*(jnp.asarray(a)
                                                for a in args))
    _eq(gk, wk, "keys")
    _eq(have, wh, "have")
    assert int(ng) == int(wng)
    date, item, qty, price, bkey, bprice = args
    lut = dict(zip(bkey.tolist(), bprice.tolist()))
    ip = np.array([lut.get(i, np.inf) for i in item.tolist()], np.float32)
    keep = price > np.float32(1.2) * ip
    rev = price * qty.astype(np.float32)
    scale = np.array([np.abs(rev[keep & (date == k)]).sum()
                      for k in _np(gk)])
    _close(sums, ws, scale, "sums")
    oracle = np.array([rev[keep & (date == k)].astype(np.float64).sum()
                       for k in _np(gk)])
    _close(sums, np.where(_np(have), oracle, 0), scale, "float64 oracle")


# ---------------------------------------------------------------------------
# Table group-by with Spark null semantics
# ---------------------------------------------------------------------------

def _table_measures(nk):
    """COUNT(*), then every op over each measure column after ``nk``
    key columns."""
    return [(None, "count")] + [(nk + j, op) for j in range(4) for op in OPS]


def _group_rows(cols, key_pos, jres, n):
    """Rows of each result group (by the JAX result's keys), for the float
    tolerance."""
    jtable, jhave, _ = jres
    out = []
    for g in range(len(np.asarray(jhave))):
        r = np.ones(n, bool)
        for ki, pos in enumerate(key_pos):
            name, v, ok = cols[pos]
            kc = jtable.columns[ki]
            kv = bool(np.asarray(kc.valid_bools())[g])
            valid = np.ones(n, bool) if ok is None else ok
            if name == "string":
                r &= ~valid if not kv else valid & _string_eq(v, kc, g)
            elif not kv:
                r &= ~valid
            else:
                want = np.asarray(kc.data)[g]
                r &= valid & (v == want)
        out.append(r & bool(np.asarray(jhave)[g]))
    return out


def _string_eq(v, kc, g):
    chars, lens = v
    w = np.asarray(kc.chars2d)[g]
    ln = int(np.asarray(kc.str_lens())[g])
    W = max(chars.shape[1], w.shape[0])
    a = np.zeros((len(lens), W), np.uint8)
    a[:, :chars.shape[1]] = chars
    b = np.zeros(W, np.uint8)
    b[:w.shape[0]] = w
    return (lens == ln) & (a == b).all(axis=1)


@pytest.fixture(scope="module")
def key_sweep():
    """One table of a key column per type (null mode "some", values
    repeating, the type's extremes among them) and the measure columns,
    with a row mask; JAX results per key, computed on first use."""
    rng = np.random.default_rng(6)
    cols = [_key_column(rng, name, N, "some") for name in KEY_NAMES]
    cols += _measure_columns(rng, N, "some")
    jtab, ptab = tables_from_columns(cols)
    mask = rng.random(N) > 0.1
    return cols, jtab, ptab, mask, {}


def _jax_agg(cache, key, jtab, key_idxs, measures, mg, mask):
    if key not in cache:
        cache[key] = jpl.hash_aggregate_table(
            jtab, key_idxs, measures, mg,
            mask=None if mask is None else jnp.asarray(mask), bucket=None)
    return cache[key]


def _hold_all_ways(ptab, key_idxs, measures, mg, mask, jres, fc, scales,
                   monkeypatch):
    """The port's result by each strategy and with ``bucket="auto"``, each
    against the JAX result."""
    for dense in (0, FORCE_DOMAIN):
        _force(monkeypatch, dense)
        for bucket in (None, "auto"):
            res = pl.hash_aggregate_table(
                ptab, key_idxs, measures, mg,
                mask=None if mask is None else _t(mask), bucket=bucket)
            _assert_result(res, jres, fc, scales)


@pytest.mark.parametrize("key", KEY_NAMES)
def test_hash_aggregate_table_key_types(key_sweep, key, monkeypatch):
    cols, jtab, ptab, mask, cache = key_sweep
    ki = KEY_NAMES.index(key)
    nk = len(KEY_NAMES)
    measures = [(None, "count"), (nk, "sum"), (nk, "min"), (nk + 2, "avg")]
    # fewer slots than groups (but for BOOL8's three: 0, 1, null): the
    # truncation follows the group order
    mg = MG
    jres = _jax_agg(cache, key, jtab, [ki], measures, mg, mask)
    assert int(jres[2]) > mg or key == "bool8"
    fc = [4]
    scales = {4: _float_scale(cols[nk + 2][1], cols[nk + 2][2], mask,
                              _group_rows(cols, [ki], jres, N))}
    _hold_all_ways(ptab, [ki], measures, mg, mask, jres, fc, scales,
                   monkeypatch)


def test_hash_aggregate_table_multi_key_capacity(key_sweep, monkeypatch):
    """Three keys (INT8 packed, UINT32, INT64) at capacities below, at and
    above the group count, against the JAX result at a capacity above it
    cut to each (a group's slot and values do not depend on the
    capacity)."""
    cols, jtab, ptab, mask, cache = key_sweep
    idx = [KEY_NAMES.index(k) for k in ("int8", "uint32", "int64")]
    measures = [(None, "count"), (len(KEY_NAMES) + 1, "max")]
    full = _jax_agg(cache, "multi", jtab, idx, measures, 512, mask)
    ng = int(full[2])
    assert 10 < ng < 500
    for mg in (ng - 7, ng, ng + 9):
        cut = jt.Table(tuple(_cut(c, mg) for c in full[0].columns))
        jres = (cut, np.asarray(full[1])[:mg], full[2])
        _hold_all_ways(ptab, idx, measures, mg, mask, jres, [], {},
                       monkeypatch)


def _cut(c, g):
    """A JAX result column's first ``g`` slots."""
    valid = jt.pack_bools(c.valid_bools()[:g])
    return jt.Column(c.dtype, c.data[:g], valid)


@pytest.fixture(scope="module")
def measure_sweep():
    """An INT32 key with nulls and every measure column under each null
    mode; one JAX call over every op of every column."""
    rng = np.random.default_rng(7)
    cols = [_key_column(rng, "int32", N, "some", extremes=False)]
    for mode in ("none", "zero", "some"):
        cols += _measure_columns(rng, N, mode)
    jtab, ptab = tables_from_columns(cols)
    mask = rng.random(N) > 0.1
    measures = [(None, "count")] + [(1 + j, op) for j in range(12)
                                    for op in OPS]
    jres = jpl.hash_aggregate_table(jtab, [0], measures, MG,
                                    mask=jnp.asarray(mask), bucket=None)
    return cols, ptab, mask, measures, jres


@pytest.mark.parametrize("col", range(12))
def test_hash_aggregate_table_measures(measure_sweep, col, monkeypatch):
    cols, ptab, mask, measures, jres = measure_sweep
    name, v, ok = cols[1 + col]
    pos = [i for i, (c, _) in enumerate(measures) if c == 1 + col]
    sub = [(None, "count")] + [measures[i] for i in pos]
    jtable, jhave, jng = jres
    jsub = (jt.Table((jtable.columns[0], jtable.columns[1])
                     + tuple(jtable.columns[1 + i] for i in pos)),
            jhave, jng)
    fc, scales = [], {}
    if name == "float32":
        rows = _group_rows(cols, [0], jres, N)
        s = _float_scale(v, np.ones(N, bool) if ok is None else ok, mask,
                         rows)
        fc = [2 + j for j, i in enumerate(pos)
              if measures[i][1] in ("sum", "avg")]
        scales = {c: s for c in fc}
    _hold_all_ways(ptab, [0], sub, MG, mask, jsub, fc, scales, monkeypatch)


@pytest.mark.parametrize("mode", [m for m in NULL_MODES if m != "some"])
@pytest.mark.parametrize("key", ["int32", "int16", "string"])
def test_hash_aggregate_table_null_modes(key, mode, monkeypatch):
    """The null modes the key sweep (mode "some") leaves, on a 32-bit, a
    packed 16-bit and a STRING key."""
    rng = np.random.default_rng(8)
    if key == "string":
        jcol, pcol = both_string_columns(rng, N, 6, mode)
        lens = np.asarray(jcol.str_lens())
        chars = np.asarray(jcol.chars2d)
        pick = rng.integers(0, 9, N)         # repeat nine strings
        chars, lens = chars[pick], lens[pick]
        jcol, pcol = _string_pair(chars, lens, np.asarray(
            jcol.validity) if jcol.validity is not None else None)
        key_col = ("string", (chars, lens), None if jcol.validity is None
                   else np.unpackbits(np.asarray(jcol.validity),
                                      bitorder="little")[:N].astype(bool))
        mcols = _measure_columns(rng, N, "some")
        jm, pm = tables_from_columns(mcols)
        jtab = jt.Table((jcol,) + jm.columns)
        ptab = pt.Table((pcol,) + pm.columns)
        cols = [key_col] + mcols
    else:
        cols = [_key_column(rng, key, N, mode)] + _measure_columns(
            rng, N, "some")
        jtab, ptab = tables_from_columns(cols)
    measures = [(None, "count"), (1, "count"), (1, "sum"), (3, "max"),
                (3, "avg"), (4, "sum")]
    for mask in [None if mode == "none" else rng.random(N) > 0.5]:
        jres = jpl.hash_aggregate_table(
            jtab, [0], measures, MG,
            mask=None if mask is None else jnp.asarray(mask), bucket=None)
        live = np.ones(N, bool) if mask is None else mask
        rows = _group_rows(cols, [0], jres, N)
        s = _float_scale(cols[3][1], cols[3][2], live, rows)
        _hold_all_ways(ptab, [0], measures, MG, mask, jres, [5],
                       {5: s}, monkeypatch)


def _string_pair(chars, lens, packed):
    jcol = jt.Column(jt.STRING, jnp.zeros((0,), jnp.uint8),
                     None if packed is None else jnp.asarray(packed),
                     jnp.asarray(np.concatenate([[0], np.cumsum(lens)])
                                 .astype(np.int32)), None,
                     jnp.asarray(chars))
    pcol = pt.Column.padded_strings(
        _t(chars), _t(lens.astype(np.int32)),
        None if packed is None else _t(packed))
    return jcol, pcol


def test_hash_aggregate_table_string_and_int_keys(monkeypatch):
    """A STRING key (lengths 0..11, random bytes, zeros past each length)
    beside an INT16 key, and a DATE32 one."""
    rng = np.random.default_rng(9)
    jcol, _ = both_string_columns(rng, N, 11, "some")
    pick = rng.integers(0, 12, N)
    chars = np.asarray(jcol.chars2d)[pick]
    lens = np.asarray(jcol.str_lens())[pick]
    valid = rng.random(N) > 0.2
    packed = np.packbits(valid, bitorder="little")
    js, ps = _string_pair(chars, lens, packed)
    other = [_key_column(rng, "int16", N, "some"),
             _key_column(rng, "date32", N, "some")]
    jo, po = tables_from_columns(other + _measure_columns(rng, N, "some"))
    jtab = jt.Table((js,) + jo.columns)
    ptab = pt.Table((ps,) + po.columns)
    measures = [(None, "count"), (3, "sum"), (6, "min")]
    for key_idxs in ([0, 1], [2, 0]):
        jres = jpl.hash_aggregate_table(jtab, key_idxs, measures, 40,
                                        bucket=None)
        _hold_all_ways(ptab, key_idxs, measures, 40, None, jres, [], {},
                       monkeypatch)
    arrow = pt.Table((ps.to_arrow(),) + po.columns)
    with pytest.raises(ValueError, match="dense-padded"):
        pl.hash_aggregate_table(arrow, [0], measures, 8)


def test_hash_aggregate_table_from_grouped_columns(monkeypatch):
    rng = np.random.default_rng(10)
    names = ["int16", "int32", "int64", "float32", "int8"]
    cols = numpy_columns(rng, names, N, "some")
    cols[0] = _key_column(rng, "int16", N, "some")
    cols[3] = ("float32", rng.uniform(-9, 9, N).astype(np.float32),
               cols[3][2])
    jtab, ptab = tables_from_columns(cols)
    jgc = jmx.table_to_grouped(jtab, jrl.compute_row_layout(jtab.dtypes))
    pgc = interop.grouped_from_numpy(np.asarray(jgc.planes),
                                     np.asarray(jgc.vmask), names,
                                     device="cpu")
    mask = rng.random(N) > 0.2
    measures = [(None, "count"), (1, "sum"), (2, "max"), (2, "avg"),
                (3, "sum"), (4, "min")]
    jres = jpl.hash_aggregate_table(jgc, [0], measures, 8,
                                    mask=jnp.asarray(mask), bucket=None)
    rows = _group_rows(cols, [0], jres, N)
    s = _float_scale(cols[3][1], cols[3][2], mask, rows)
    for src in (pgc, ptab, pmx.table_to_grouped(
            ptab, prl.compute_row_layout(ptab.dtypes))):
        for dense in (0, FORCE_DOMAIN):
            _force(monkeypatch, dense)
            _assert_result(pl.hash_aggregate_table(src, [0], measures, 8,
                                                   mask=_t(mask)),
                           jres, [5], {5: s})


def test_hash_aggregate_table_edges():
    """Zero rows, an all-dead mask, and float keys refused as the JAX
    package refuses them."""
    rng = np.random.default_rng(11)
    cols = [_key_column(rng, "int32", N, "some")] + _measure_columns(
        rng, N, "some")
    jtab, ptab = tables_from_columns(cols)
    measures = _table_measures(1)
    dead = np.zeros(N, bool)
    jres = jpl.hash_aggregate_table(jtab, [0], measures, MG,
                                    mask=jnp.asarray(dead), bucket=None)
    _assert_result(pl.hash_aggregate_table(ptab, [0], measures, MG,
                                           mask=_t(dead)),
                   jres, [], {})
    # zero rows (without the decimal128 measures: at zero rows the JAX
    # package gives COUNT of a decimal128 column [G, 4] limbs)
    z = [(n, v[:0], None if ok is None else ok[:0]) for n, v, ok in cols]
    jz, pz = tables_from_columns(z)
    jres = jpl.hash_aggregate_table(jz, [0], measures[:16], MG, bucket=None)
    _assert_result(pl.hash_aggregate_table(pz, [0], measures[:16], MG),
                   jres, [], {})
    fl = numpy_columns(rng, ["float32", "float64"], 10, "some")
    jf, pf = tables_from_columns(fl)
    for i in (0, 1):
        with pytest.raises(ValueError):
            jpl.hash_aggregate_table(jf, [i], [(None, "count")], 4,
                                     bucket=None)
        with pytest.raises(ValueError):
            pl.hash_aggregate_table(pf, [i], [(None, "count")], 4)


# ---------------------------------------------------------------------------
# decimal128 division
# ---------------------------------------------------------------------------

def _div_case():
    big = 10 ** 38 - 1
    a = [big, -big, 25, -25, 15, -15, 1, 7, 0, big, 5, -(2 ** 100) - 3,
         10 ** 19 + 1, 3]
    b = [1, 1, 10, 10, 10, 10, 2, 0, 3, -big, 0, 7, -(10 ** 18), 4]
    va = [True] * len(a)
    va[3] = False
    return a, b, va


@pytest.mark.parametrize("shift", [0, 1, 4, 17, 37, 38])
def test_div_decimal128_matches_jax(shift):
    a, b, va = _div_case()
    got, gov = pdec.div_decimal128(
        pdec.decimal128_from_ints(a, 2, va, device="cpu"),
        pdec.decimal128_from_ints(b, 1, device="cpu"), shift + 1)
    want, wov = jdec.div_decimal128(jdec.decimal128_from_ints(a, 2, va),
                                    jdec.decimal128_from_ints(b, 1),
                                    shift + 1)
    assert_same_columns(pt.Table([got]), jt.Table((want,)))
    _eq(gov, wov, "overflow")


def test_div_decimal128_every_shift_against_python():
    """HALF_UP quotients at every scale shift 0..38 against Python ints."""
    a, b, va = _div_case()
    ca = pdec.decimal128_from_ints(a, 0, va, device="cpu")
    for e in range(39):
        q, ov = pdec.div_decimal128(ca, pdec.decimal128_from_ints(
            b, 0, device="cpu"), e)
        for x, y, ok, got, o in zip(a, b, va, pdec.decimal128_to_ints(q),
                                    ov.tolist()):
            if not ok:
                assert got is None and not o
                continue
            if y == 0:
                assert got is None and o
                continue
            num, den = abs(x) * 10 ** e, abs(y)
            mag = (2 * num + den) // (2 * den)
            if mag > 10 ** 38 - 1:
                assert got is None and o
            else:
                assert got == (mag if (x < 0) == (y < 0) else -mag), (x, y, e)
    with pytest.raises(ValueError):
        pdec.div_decimal128(ca, ca, 39)


# ---------------------------------------------------------------------------
# String and table joins
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def string_sides():
    rng = np.random.default_rng(12)
    jb, _ = both_string_columns(rng, 40, 9, "some")
    bchars = np.array(jb.chars2d)
    blens = np.array(jb.str_lens())
    # make the valid build keys unique: a row index in the first bytes
    bchars[:, 0] = np.arange(40)
    blens = np.maximum(blens, 1).astype(np.int32)
    bvalid = rng.random(40) > 0.2
    pick = rng.integers(0, 50, 90)
    pchars = np.zeros((90, 12), np.uint8)
    plens = np.zeros(90, np.int32)
    hit = pick < 40
    pchars[hit, :bchars.shape[1]] = bchars[pick[hit]]
    plens[hit] = blens[pick[hit]]
    pchars[~hit, 0] = 200
    plens[~hit] = 1
    pvalid = rng.random(90) > 0.2
    build = _string_pair(bchars, blens, np.packbits(bvalid,
                                                    bitorder="little"))
    probe = _string_pair(pchars, plens, np.packbits(pvalid,
                                                    bitorder="little"))
    pay = rng.integers(-99, 99, 40).astype(np.int32)
    return build, probe, pay


def test_string_joins_match_jax(string_sides):
    (jb, pb), (jp, pp), pay = string_sides
    _eq(pl.join_semi_mask_strings(pb, pp),
        jpl.join_semi_mask_strings(jb, jp), "semi")
    got, m, amb = pl.sort_merge_join_strings(pb, [_t(pay)], pp)
    want, wm, wamb = jpl.sort_merge_join_strings(jb, [jnp.asarray(pay)], jp)
    _eq(m, wm, "matched")
    _eq(got[0], want[0], "payload")
    assert bool(amb) == bool(wamb) is False
    dup = pt.Column.padded_strings(torch.cat([pb.chars2d, pb.chars2d[:3]]),
                                   torch.cat([pb.lens, pb.lens[:3]]))
    assert bool(pl.sort_merge_join_strings(dup, [], pp)[2])
    with pytest.raises(ValueError, match="dense-padded"):
        pl.join_semi_mask_strings(pb.to_arrow(), pp)


@pytest.fixture(scope="module")
def join_tables():
    """INT32 and INT64 keys with 25% nulls, duplicate build keys, the
    types' maxima among the keys, a nullable payload."""
    rng = np.random.default_rng(13)
    out = {}
    for name in ("int32", "int64"):
        dt = np.dtype(name)
        top = np.iinfo(dt).max
        bk = rng.integers(0, 30, 60).astype(dt)
        bk[:3] = top
        pk = rng.integers(-2, 33, 100).astype(dt)
        pk[:2] = top
        build = [(name, bk, rng.random(60) > 0.25),
                 ("int32", rng.integers(-9, 9, 60).astype(np.int32),
                  rng.random(60) > 0.2)]
        probe = [(name, pk, rng.random(100) > 0.25)]
        out[name] = (tables_from_columns(build), tables_from_columns(probe))
    return out


@pytest.mark.parametrize("key", ["int32", "int64"])
def test_table_joins_match_jax(join_tables, key):
    (jb, pb), (jp, pp) = join_tables[key]
    want = jpl.join_semi_mask_table(jb, 0, jp, 0, bucket=None)
    for bucket in (None, "auto"):
        _eq(pl.join_semi_mask_table(pb, 0, pp, 0, bucket=bucket), want,
            "semi")
    for cap in (50, 400):
        want = jpl.join_inner_table(jb, 0, 1, jp, 0, cap, bucket=None)
        for bucket in (None, "auto"):
            got = pl.join_inner_table(pb, 0, 1, pp, 0, cap, bucket=bucket)
            for g, w, what in zip(got, want, ("pidx", "pay", "pay_valid",
                                              "valid", "total", "ovf")):
                _eq(g, np.asarray(w).astype(_np(g).dtype), f"{what} {cap}")


def test_table_joins_on_string_keys(string_sides):
    """String keys in the table joins: the semi mask equals the JAX string
    semi join's, the inner join equals a Python oracle."""
    (jb, pb), (jp, pp), pay = string_sides
    pv = torch.from_numpy(pay)
    build = pt.Table((pb, pt.Column(pt.INT32, pv)))
    probe = pt.Table((pp,))
    _eq(pl.join_semi_mask_table(build, 0, probe, 0),
        jpl.join_semi_mask_strings(jb, jp), "semi")
    pidx, payload, pvalid, valid, total, ovf = pl.join_inner_table(
        build, 0, 1, probe, 0, 120)

    def keys(c):
        v = c.valid_bools().tolist()
        return [bytes(c.chars2d[i, :int(c.lens[i])].tolist()) if v[i]
                else None for i in range(c.num_rows)]
    bkeys, pkeys = keys(pb), keys(pp)
    want = [(i, int(pay[j])) for i, k in enumerate(pkeys) if k is not None
            for j, b in enumerate(bkeys) if b == k]
    got = list(zip(pidx[valid].tolist(), payload[valid].tolist()))
    assert got == want and int(total) == len(want) and not bool(ovf)
    assert bool(pvalid[valid].all())


# ---------------------------------------------------------------------------
# Host merges
# ---------------------------------------------------------------------------

def test_merges_match_jax():
    rng = np.random.default_rng(14)
    parts_j, parts_p, tparts_j, tparts_p = [], [], [], []
    for s in range(2):
        k = rng.integers(0, 6, 80).astype(np.int32)
        v = rng.integers(2 ** 29, 2 ** 30, 80).astype(np.int32)
        m = rng.random(80) > 0.3
        jk, jouts, jh, _ = jpl.hash_aggregate_multi(
            [jnp.asarray(k)], [(jnp.asarray(v), "sum"),
                               (jnp.asarray(v), "min")], jnp.asarray(m), 8)
        pk, pouts, ph, _ = pl.hash_aggregate_multi(
            [_t(k)], [(_t(v), "sum"), (_t(v), "min")], _t(m), 8)
        parts_j.append((jk, jouts, jh))
        parts_p.append((pk, pouts, ph))
        cols = [_key_column(rng, "int32", 80, "some"),
                ("int64", rng.integers(0, 9, 80).astype(np.int64),
                 rng.random(80) > 0.5)]
        jt_, pt_ = tables_from_columns(cols)
        meas = [(None, "count"), (1, "sum"), (1, "max")]
        jr = jpl.hash_aggregate_table(jt_, [0], meas, 8, bucket=None)
        pr = pl.hash_aggregate_table(pt_, [0], meas, 8)
        tparts_j.append((jr[0], jr[1]))
        tparts_p.append((pr[0], pr[1]))
    ops = ["sum", "min"]
    assert pl.merge_aggregate_partials(parts_p, ops) == \
        jpl.merge_aggregate_partials(parts_j, ops)
    tops = ["count", "sum", "max"]
    assert pl.merge_aggregate_table_partials(tparts_p, 1, tops) == \
        jpl.merge_aggregate_table_partials(tparts_j, 1, tops)
    with pytest.raises(ValueError, match="avg"):
        pl.merge_aggregate_partials(parts_p, ["avg", "sum"])


def test_to_pylist_reads_every_type():
    d = pdec.decimal128_from_ints([-(10 ** 38 - 1), 5, 7], 2,
                                  [True, False, True], device="cpu")
    assert d.to_pylist() == [-(10 ** 38 - 1), None, 7]
    s = pt.Column.strings_padded(["ab", None, "é"], device="cpu")
    assert s.to_pylist() == ["ab", None, "é"]
    assert s.to_arrow().to_pylist() == ["ab", None, "é"]
    b = pt.Column.from_numpy(np.array([1, 0], np.uint8), pt.BOOL8,
                             device="cpu")
    assert b.to_pylist() == [True, False]
    u = pt.Column.from_numpy(np.array([2 ** 64 - 1], np.uint64), pt.UINT64,
                             device="cpu")
    assert u.to_pylist() == [2 ** 64 - 1]
    jcols = jax_columns(jt.Table((jt.Column.from_numpy(
        np.array([1.5, -2.0], np.float32), jt.FLOAT32),)))
    f = interop.table_from_numpy_columns(jcols, device="cpu").columns[0]
    assert f.to_pylist() == [1.5, -2.0]
