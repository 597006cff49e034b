"""PyTorch port, ``get_json_object``'s single-path route held against the JAX
package's ``ops/get_json.py`` on the same documents: K9's plain version
(``gjo_scan_plain``) against ``_scan_automaton``, all six fields exactly,
and ``get_json_object`` against JAX ``get_json_object(..., bucket=None)``,
chars bytes, lengths and validity exactly; then values against the Python
oracle of ``tests/test_get_json.py``, and the refusals.

Every JAX call shares one column (one window) and six paths: each path
compiles two small programs on the CPU, the scan and the whole function."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import table as jt
from spark_rapids_jni_tpu.ops import get_json as jgj
from spark_rapids_jni_tpu_torch import INT32, interop
from spark_rapids_jni_tpu_torch import table as pt
from spark_rapids_jni_tpu_torch.ops import get_json as pgj
from spark_rapids_jni_tpu_torch.ops import get_json_object
from spark_rapids_jni_tpu_torch.utils import json_event_docs
from tests.test_get_json import oracle

CPU = "cpu"
FIELDS = ("start", "end", "found", "capturing", "bad", "deep")
# the JAX package's GJ_PATHS (tests/test_pallas_kernels.py) and two more
# subscript paths
PATHS = ["$.a", "$.b.c", "$.a[1]", "$[1][1]", "$.a[1].b", "$.b.c[2].d"]
DOCS = [
    # tests/test_pallas_kernels.py's GJ_DOCS
    '{"a": [1, 2, 3], "b": {"c": [{"d": 4}, {"d": 5}, {"d": 6}]}}',
    '{"b": {"c": "str"}, "a": []}',
    '{"a": [true, null], "b": {"c": {"x": 1}}}',
    "",
    '{"a": "unterminated',
    '{"b": {"c": "esc\\"aped"}}',
    '[1, 2]',
    '{"aa": 1, "a": [10, 20, 30, 40]}',
    # nesting past the automaton's uint8 depth budget (deep: host fixup)
    '{"a": 1, "z": ' + "[" * 260 + "]" * 260 + '}',
    '{"b": {"c": ' + "[" * 255 + "1" + "]" * 255 + '}}',
    # stray closes at depth 0: the uint8 depth wraps to 255
    ']{"a": 5}',
    '}}{"a": 6, "b": {"c": 7}}',
    # escaped keys: an escaped key never matches a literal path key
    '{"\\u0061": 1, "a": 2}',
    '{"a\\"b": 1, "a": 3}',
    # flat and nested keys
    '{"a": 1, "b": "two", "c": true}',
    '{"a": -2.5, "b": {"c": false}}',
    '{"a": null, "b": {"c": 1.50}}',
    '{"b": {"c": {"d": [1, 2]}}}',
    # subscripts
    '[[1, 2], [3, {"x": [4]}]]',
    '[0, [10, 11, 12]]',
    '{"a": [{"b": 1}, {"b": "x\\ty"}, {"b": 3}]}',
    '{"a": [0, {"b": [1, {"c": 2}]}]}',
    '{"a": [[1], [2, 3]], "b": {"c": [0, 1, {"d": "e"}]}}',
    # containers: Spark's compact rendering, on the host
    '{"a": {"x": 1, "y": [1, 2, 3]}, "b": 2}',
    '{"a": [1, {"z": 3}], "b": "s"}',
    '{"a": { "k" : [ 1.50 , 1e2 ] }}',
    # escaped strings: decoded on the host
    '{"a": "has \\"quotes\\" inside", "b": {"c": "tab\\tchar"}}',
    '{"a": "unicode \\u00e9", "b": 5}',
    '{"a": "backslash \\\\ end"}',
    # tricky strings
    '{"a": "brace } and ] inside", "b": 2}',
    '{"a": "comma, colon: here", "b": {"c": "[1, 2]"}}',
    # key lookalikes and a key as a value
    '{"x": {"a": "inner"}, "a": "outer"}',
    '{"a": "first", "x": {"a": "inner"}}',
    '{"k": "a", "a": 9}',
    '{"k": "a:1"}',
    '{"a": {"x": 1}, "b": {"c": 2}}',
    # duplicate keys: the first wins
    '{"a": 1, "a": 2}',
    '{"b": {"c": 1}, "b": {"c": 2}}',
    # truncated JSON
    '{"a": 12',
    '{"a": [1, 2',
    '{"b": {"c": "x"',
    '{"a": {"k": 1',
    # whitespace
    '{ "a" : 7 }',
    '{"b":1,"a":8}',
    '{\n  "a"\t: "sp"  }',
    '  {"a":\r\n[ 1 ,2 ]}',
    # non-ASCII
    '{"a": "日本語", "b": {"c": "🙂"}}',
    # a container whose rendering outgrows the window: each invalid UTF-8
    # byte decodes to U+FFFD, 3 bytes
    b'{"a": ["' + b"\xff" * 200 + b'"]}',
    # nulls
    None,
    None,
]


def _both_columns(docs, W=None):
    """The same dense-padded string column in both packages, from Python
    strings or bytes (None: null)."""
    enc = [None if d is None else d if isinstance(d, bytes) else d.encode()
           for d in docs]
    n = len(enc)
    lens = np.array([0 if b is None else len(b) for b in enc], np.int32)
    if W is None:
        W = (int(lens.max()) + 3) // 4 * 4
    chars = np.zeros((n, W), np.uint8)
    for i, b in enumerate(enc):
        if b:
            chars[i, :len(b)] = np.frombuffer(b, np.uint8)
    packed = np.packbits([b is not None for b in enc], bitorder="little")
    offsets = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=offsets[1:])
    jax_col = jt.Column(jt.STRING, jnp.zeros((0,), jnp.uint8),
                        jnp.asarray(packed), jnp.asarray(offsets), None,
                        jnp.asarray(chars))
    port = pt.Column.padded_strings(torch.from_numpy(chars),
                                    torch.from_numpy(lens),
                                    torch.from_numpy(packed))
    return jax_col, port


@pytest.fixture(scope="module")
def columns():
    return _both_columns(DOCS)


def _segs(path):
    segs = tuple(pgj._parse_path(path))
    assert segs == tuple(jgj._parse_path(path))
    return segs, max((len(s) for s in segs if isinstance(s, bytes)),
                     default=1)


def _assert_same_result(got, want):
    """Chars bytes, lengths and packed validity bytes equal."""
    n = got.num_rows
    np.testing.assert_array_equal(got.chars2d.numpy(),
                                  np.asarray(want.chars2d))
    np.testing.assert_array_equal(got.lens.numpy(),
                                  np.asarray(want.str_lens()))
    np.testing.assert_array_equal(got.validity.numpy(),
                                  np.asarray(want.validity))
    assert got.validity.shape == ((n + 7) // 8,)


@pytest.mark.parametrize("path", PATHS)
def test_scan_plain_matches_jax_scan(columns, path):
    """K9's plain version equals the JAX package's lax.scan chain in all
    six fields on every row, deep and wrapped-depth rows included."""
    jax_col, port = columns
    segs, mkl = _segs(path)
    want = jgj._scan_automaton(jax_col.chars2d, segs, mkl)
    got = pgj.gjo_scan(port.chars2d, segs, mkl)
    assert got.dtype == torch.int32 and got.shape == (6, len(DOCS))
    for i, f in enumerate(FIELDS):
        np.testing.assert_array_equal(
            got[i].numpy(), np.asarray(want[f]).astype(np.int32),
            err_msg=f"{path} {f}")
    deep = got[5].numpy().astype(bool)
    assert deep[8] and deep[9] and deep[10] and not deep[0]


@pytest.mark.parametrize("path", PATHS)
def test_get_json_object_matches_jax(columns, path):
    jax_col, port = columns
    want = jgj.get_json_object(jax_col, path, bucket=None)
    got = get_json_object(port, path, device=CPU)
    _assert_same_result(got, want)


def test_results_punt_widen_and_decode(columns):
    """What the path ``$.a`` exercises: deep rows, containers and escaped
    strings come from the host (the rendering past the window widens the
    matrix), and the values are Spark's."""
    _, port = columns
    got = get_json_object(port, "$.a", device=CPU)
    assert got.chars2d.shape[1] > port.chars2d.shape[1]
    vals = _pylist(got)
    assert vals[8] == "1" and vals[9] is None
    assert vals[23] == '{"x":1,"y":[1,2,3]}'
    assert vals[25] == '{"k":[1.50,1e2]}'
    assert vals[26] == 'has "quotes" inside'
    assert vals[27] == "unicode é"
    assert vals[36] == "1"
    assert vals[38] is None and vals[39] is None
    assert vals[42] == "7" and vals[44] == "sp"
    assert vals[45] == "[1,2]" and vals[46] == "日本語"
    assert vals[47] == "[" + '"' + "�" * 200 + '"]'
    assert vals[-1] is None and vals[3] is None


def test_all_null_column_matches_jax(columns):
    W = columns[1].chars2d.shape[1]
    jax_col, port = _both_columns([None] * len(DOCS), W=W)
    want = jgj.get_json_object(jax_col, "$.a", bucket=None)
    got = get_json_object(port, "$.a", device=CPU)
    _assert_same_result(got, want)
    assert not got.valid_bools().any()


def test_carried_across_from_jax_arrays(columns):
    """A column made by ``interop`` from the JAX package's padded arrays
    gives the same answer as one made by ``Column.strings_padded``."""
    jax_col = jt.Column.strings_padded(
        [d if d is None or isinstance(d, str) else None for d in DOCS])
    [carried] = interop.table_from_numpy_columns(
        [("string", np.asarray(jax_col.chars2d),
          np.asarray(jax_col.str_lens()),
          np.asarray(jax_col.validity))], device=CPU).columns
    direct = pt.Column.strings_padded(
        [d if d is None or isinstance(d, str) else None for d in DOCS],
        device=CPU)
    a = get_json_object(carried, "$.a[1].b", device=CPU)
    b = get_json_object(direct, "$.a[1].b", device=CPU)
    assert torch.equal(a.chars2d, b.chars2d)
    assert torch.equal(a.lens, b.lens)
    assert torch.equal(a.validity, b.validity)


# ---------------------------------------------------------------------------
# Values against the Python oracle (no JAX)
# ---------------------------------------------------------------------------

def _pylist(col):
    valid = col.valid_bools().tolist()
    mat, lens = col.chars2d.numpy(), col.lens.tolist()
    return [bytes(mat[i, :lens[i]]).decode() if valid[i] else None
            for i in range(col.num_rows)]


ORACLE_CASES = [
    (['{"a": 1, "b": "two", "c": true}', '{"a": -2.5, "b": "", "c": false}',
      '{"b": "x"}', '{"a": null}'], ["$.a", "$.b", "$.c"]),
    (['{"a": 1}', 'not json at all', '', '{"x": {"a": 5}}', None], ["$.a"]),
    (['{"a": {"b": {"c": 42}}}', '{"a": {"b": {"c": "deep"}}}',
      '{"a": {"b": 7}}', '{"a": 1}'], ["$.a.b.c", "$.a.b"]),
    (['{"a": "has \\"quotes\\" inside", "b": 1}',
      '{"a": "brace } and ] inside", "b": 2}',
      '{"a": "comma, colon: here", "b": 3}',
      '{"a": "backslash \\\\ end", "b": 4}',
      '{"a": "unicode \\u00e9", "b": 5}'], ["$.a", "$.b"]),
    (['{"x": {"a": "inner"}, "a": "outer"}',
      '{"a": "first", "x": {"a": "inner"}}'], ["$.a"]),
    (['{"k": "a", "a": 9}', '{"k": "a:1"}'], ["$.a"]),
    (['{ "a" : 7 }', '{"b":1,"a":8}', '{"a":9}', '{\n  "a"\t: "sp"  }'],
     ["$.a"]),
    ([None, '{"a": 1}', None], ["$.a"]),
]


@pytest.mark.parametrize("case", range(len(ORACLE_CASES)))
def test_values_match_python_oracle(case):
    docs, paths = ORACLE_CASES[case]
    col = pt.Column.strings_padded(docs, device=CPU)
    for path in paths:
        assert _pylist(get_json_object(col, path, device=CPU)) == \
            oracle(docs, path), path


def test_containers_match_python_json():
    import json
    docs = ['{"a": {"x": 1, "y": [1,2,3]}, "b": 2}',
            '{"a": [1, {"z": 3}], "b": "s"}']
    got = _pylist(get_json_object(pt.Column.strings_padded(docs, device=CPU),
                                  "$.a", device=CPU))
    assert [json.loads(g) for g in got] == [json.loads(d)["a"] for d in docs]


def _walk_oracle(doc, segs):
    """Python ``json`` over a document with no duplicate keys and integer
    numbers: Spark's answer at ``segs``."""
    import json
    if doc is None:
        return None
    try:
        obj = json.loads(doc)
    except ValueError:
        return None
    for s in segs:
        if isinstance(s, int):
            if not isinstance(obj, list) or s >= len(obj):
                return None
        elif not isinstance(obj, dict) or s.decode() not in obj:
            return None
        obj = obj[s if isinstance(s, int) else s.decode()]
    if isinstance(obj, str):
        return obj
    return json.dumps(obj, separators=(",", ":"), ensure_ascii=False)


def test_event_docs_match_python_oracle():
    """The event-log documents of the card's smoke run, every special kind
    included, against Python's ``json`` at its three paths."""
    docs, kinds = json_event_docs(400, seed=5, special=0.05,
                                  lengths=(100, 300))
    assert set(kinds.tolist()) == set(range(5))
    col = pt.Column.strings_padded(docs, device=CPU)
    for path in ("$.a", "$.user.id", "$.items[2].sku"):
        segs = pgj._parse_path(path)
        got = _pylist(get_json_object(col, path, device=CPU))
        assert got == [_walk_oracle(d, segs) for d in docs], path


def test_zero_rows_and_empty_window():
    """Zero rows give an empty column; a window of width 0 (every document
    empty) gives all nulls."""
    empty = pt.Column.padded_strings(torch.zeros((0, 8), dtype=torch.uint8),
                                     torch.zeros(0, dtype=torch.int32))
    out = get_json_object(empty, "$.a", device=CPU)
    assert out.num_rows == 0 and out.chars2d.shape == (0, 8)
    blank = pt.Column.strings_padded(["", "", None], device=CPU)
    assert blank.chars2d.shape == (3, 0)
    out = get_json_object(blank, "$.a[0]", device=CPU)
    assert _pylist(out) == [None, None, None]
    assert pgj.gjo_scan(blank.chars2d, (b"a",), 1)[:2].tolist() == \
        [[-1] * 3, [-1] * 3]


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["$.a[*]", "$[*].b", "$.a[*][1]"])
def test_wildcards_wait_for_a_later_slice(path):
    col = pt.Column.strings_padded(['{"a": [1]}'], device=CPU)
    with pytest.raises(NotImplementedError, match="wildcard"):
        get_json_object(col, path, device=CPU)


def test_arrow_columns_wait_for_a_later_slice():
    """An Arrow column gives the padded column's answer (the JAX package's,
    tests/test_torch_arrow_strings.py); a string column crosses from the
    JAX package as four entries, and three raise."""
    docs = ['{"a": 1}', None, '{"a": [1, {"b": "x"}]}', '{"b": 3}', ""]
    arrow = pt.Column.strings(docs, device=CPU)
    padded = pt.Column.strings_padded(docs, device=CPU)
    got = get_json_object(arrow, "$.a", device=CPU)
    want = get_json_object(padded, "$.a", device=CPU)
    assert got.is_padded
    pt.assert_tables_equivalent(pt.Table((got,)), pt.Table((want,)))
    with pytest.raises(ValueError, match="crosses as"):
        interop.table_from_numpy_columns(
            [("string", np.zeros(3, np.int32), None)], device=CPU)


def _jax_error(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("path", ["a.b", "$", "$.a[x]", "$..a", "$.a.",
                                  "$a"])
def test_bad_paths_raise_as_in_jax(path):
    want = _jax_error(lambda: jgj._parse_path(path))
    col = pt.Column.strings_padded(['{"a": 1}'], device=CPU)
    with pytest.raises(ValueError) as info:
        get_json_object(col, path, device=CPU)
    assert str(info.value) == want


def test_non_string_and_long_keys_raise_as_in_jax():
    ints = pt.Column.from_numpy(np.arange(3, dtype=np.int32), INT32,
                                device=CPU)
    want = _jax_error(lambda: jgj.get_json_object(
        jt.Column.from_numpy(np.arange(3, dtype=np.int32), jt.INT32),
        "$.a"))
    with pytest.raises(ValueError) as info:
        get_json_object(ints, "$.a", device=CPU)
    assert str(info.value) == want
    key = "k" * 255
    want = _jax_error(lambda: jgj._automaton_pieces((key.encode(),), 255))
    col = pt.Column.strings_padded(['{"a": 1}'], device=CPU)
    with pytest.raises(ValueError) as info:
        get_json_object(col, "$." + key, device=CPU)
    assert str(info.value) == want
    # 254 bytes are taken
    assert _pylist(get_json_object(
        pt.Column.strings_padded(['{"%s": 4}' % ("k" * 254)], device=CPU),
        "$." + "k" * 254, device=CPU)) == ["4"]


def test_scan_checks_its_inputs():
    ch = torch.zeros((2, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="uint8"):
        pgj.gjo_scan(ch.to(torch.int32), (b"a",), 1)
    with pytest.raises(ValueError, match="1 to 256"):
        pgj.gjo_scan(ch, tuple([0] * 257), 1)
    with pytest.raises(ValueError, match="254"):
        pgj.gjo_scan(ch, (b"a",), 255)
    with pytest.raises(ValueError, match="neither"):
        pgj.gjo_scan(ch, (b"abc",), 2)
    # 256 segments are taken; an odd window is scanned byte by byte
    odd = torch.from_numpy(np.frombuffer(b'[[1, 2]]', np.uint8).copy()
                           ).view(1, 8)[:, :7]
    assert pgj.gjo_scan(odd, (0, 1), 1)[:3, 0].tolist() == [5, 6, 1]
    assert pgj.gjo_scan(ch, tuple([0] * 256), 1).shape == (6, 2)


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    col = pt.Column.strings_padded(['{"a": 1}'], device=CPU)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_json_object(col, "$.a")
