"""PyTorch port, the premise of K9's design on the CPU: the chars the kernel
skips leave the get_json automaton's carry as it is.

``get_json._quiet_chars`` mirrors the kernel's quiet test
(``csrc/gjo_scan.cu``: ``quiet_in_string``, ``quiet_settled`` and
``chunk_stops``).  Over event-log documents, the edge documents of
``tests/test_torch_kernels.py`` and the chunk-boundary documents
(``utils.json_boundary_docs``), wherever the mirror calls a char quiet,
the plain step (``get_json._plain_step``, the body of ``gjo_scan_plain``)
must leave every field of the carry as it was; so must it over every
16-char chunk the mirror calls quiet as a whole.  Then the walk's counts
(``gjo_scan_walk``) on a document whose walk is known.
"""

import pytest
import torch

from spark_rapids_jni_tpu_torch.ops import get_json as gj
from spark_rapids_jni_tpu_torch.utils import (
    json_boundary_docs, json_event_docs, json_window,
)
from tests.test_torch_kernels import _GJO_EDGE_DOCS

# chip_smoke.py's three paths and the edge paths of test_torch_kernels.py
PATHS = ["$.a", "$.user.id", "$.items[2].sku", "$.p.q[1].r.s[0][1].t",
         "$." + "k" * 254]


def _window(W, events):
    docs, _ = json_event_docs(events, seed=W, special=0.05,
                              lengths=(min(100, W), W))
    docs = [b"" if d is None else d.encode() for d in docs]
    return json_window(docs + _GJO_EDGE_DOCS + json_boundary_docs(W), W,
                       device="cpu")


def _segs(path):
    segs = tuple(gj._parse_path(path))
    return segs, max((len(s) for s in segs if isinstance(s, bytes)),
                     default=1)


@pytest.mark.parametrize("W,path", [(1024, p) for p in PATHS]
                         + [(36, "$.a"), (4096, "$.items[2].sku")])
def test_quiet_chars_leave_the_carry(W, path):
    ch = _window(W, 40 if W > 1024 else 120)
    segs, mkl = _segs(path)
    t = gj._plain_tables(segs, mkl, ch.device)
    n = ch.shape[0]
    whole = W - W % gj.GJO_CHUNK
    c = gj._plain_carry0(n, ch.device)
    chT = ch.T.contiguous()
    chunk_start, chunk_quiet = c, None
    skipped = 0
    for pos in range(W):
        x = chT[pos]
        quiet = gj._quiet_chars(c, x, t)
        nxt = gj._plain_step(c, x, pos, t)
        if pos < whole:
            skipped += int(quiet.sum())
            for name, before, after in zip(gj._Carry._fields, c, nxt):
                changed = (before != after) & quiet
                assert not bool(changed.any()), (
                    f"{path} W={W} pos {pos}: {name} changes in rows "
                    f"{changed.nonzero()[:5, 0].tolist()}")
            # a chunk the mirror calls quiet from its first char to its last
            if pos % gj.GJO_CHUNK == 0:
                chunk_start, chunk_quiet = c, quiet
            else:
                chunk_quiet = chunk_quiet & quiet
            if pos % gj.GJO_CHUNK == gj.GJO_CHUNK - 1:
                for before, after in zip(chunk_start, nxt):
                    assert not bool(((before != after) & chunk_quiet).any())
        c = nxt
    # the premise: most of an event-log window is quiet
    if W == 1024 and path == "$.a":
        assert skipped > 0.6 * n * whole


def test_walk_counts_a_known_document():
    """``{"a": 1}`` and zeros in a 40-char window: the eight chars of the
    document are stepped (the space after the colon too: a value is
    pending), the zeros of the two chunks after it are skipped, the last
    W % 16 = 8 chars are stepped; a row of zeros is quiet from its first
    char.  Iterations: one a stepped char, one a chunk that ends quiet.
    Beside the walk, the plain version's fields."""
    ch = json_window([b'{"a": 1}', b""], 40, device="cpu")
    fields, skipped, iterations = gj.gjo_scan_walk(ch, (b"a",), 1)
    assert skipped.tolist() == [24, 32]
    assert iterations.tolist() == [8 + 2 + 8, 2 + 8]
    assert torch.equal(fields, gj.gjo_scan_plain(ch, (b"a",), 1))
    assert torch.equal(fields[:3], torch.tensor([[6, -1], [7, -1], [1, 0]],
                                                dtype=torch.int32))
