"""PyTorch port, K1's word map on the CPU.

``kernels.encode_word_map`` sorts each 4-byte word of a JCUDF row into a
whole plane word, zero, or a mixed word assembled byte by byte;
``kernels._encode_maps`` is what the kernel (``csrc/row_encode.cu``)
receives: the byte map with the validity bytes placed after the data words
of its tile row, then the word map.  A torch replay of the kernel's
assembly from those maps must give ``grouped_encode_plain``'s rows for
every schema of ``tests/test_torch_kernels.py``'s ``ROW_SCHEMAS``
(decimal128 and 910 INT8 columns included), at batch starts that are not
multiples of 8 or 32."""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu_torch.ops import kernels, row_mxu, word_plan
from spark_rapids_jni_tpu_torch.ops.row_layout import compute_row_layout
from spark_rapids_jni_tpu_torch.utils import random_table
from tests.test_torch_kernels import ROW_SCHEMAS


def _replay(planes, vmask, layout, start, size):
    """The kernel's rows, in torch: the tile row (data words, then the
    validity bytes from the mask bits), then each row word by the maps."""
    wd = word_plan._data_words(layout)
    rs, vb = layout.fixed_row_size, layout.validity_bytes
    maps = torch.from_numpy(kernels._encode_maps(layout).astype(np.int64))
    bmap, wmap = maps[:rs], maps[rs:]
    rows = torch.arange(start, start + size)
    bits = (vmask[:, rows >> 3] >> (rows & 7).to(torch.uint8)) & 1
    valid = torch.zeros((size, 8 * vb), dtype=torch.uint8)
    valid[:, :layout.num_columns] = bits.T
    valid = (valid.view(size, vb, 8).to(torch.int32)
             << torch.arange(8, dtype=torch.int32)).sum(2).to(torch.uint8)
    words = torch.empty((size, wd), dtype=torch.int32)
    words.copy_(planes[:wd, start:start + size].T)
    tile = torch.cat([words.view(torch.uint8), valid], 1)
    out = torch.zeros((size, rs // 4), dtype=torch.int32)
    whole = wmap >= 0
    out[:, whole] = words[:, wmap[whole]]
    for j in (wmap == -2).nonzero()[:, 0].tolist():
        e = bmap[4 * j:4 * j + 4]
        b = torch.where(e >= 0, tile[:, e.clamp(min=0)], 0).to(torch.int32)
        out[:, j] = (b << torch.tensor([0, 8, 16, 24])).sum(1).to(
            torch.int32)
    return out.view(torch.uint8)


@pytest.mark.parametrize("schema", sorted(ROW_SCHEMAS))
def test_word_map_replay_gives_the_plain_rows(schema):
    dtypes = ROW_SCHEMAS[schema]
    layout = compute_row_layout(dtypes)
    n = 203
    t = random_table(dtypes, n, seed=3, null_probability=0.25, device="cpu")
    gc = row_mxu.table_to_grouped(t, layout)
    for start in (0, 1, 7, 33):
        want = kernels.grouped_encode_plain(gc.planes, gc.vmask, layout,
                                            start, n - start)
        got = _replay(gc.planes, gc.vmask, layout, start, n - start)
        assert torch.equal(got, want), (schema, start)


def test_word_map_classes_at_the_212_column_schema():
    """184 whole plane words, 31 zero words and 37 mixed of 252; a whole
    word's four bytes are one plane word's, in order."""
    layout = compute_row_layout(ROW_SCHEMAS["wide212"])
    wm = kernels.encode_word_map(layout)
    assert len(wm) == 252
    assert [(wm >= 0).sum(), (wm == -1).sum(), (wm == -2).sum()] == \
        [184, 31, 37]
    bm = kernels.encode_byte_map(layout).reshape(-1, 4)
    w = wm[wm >= 0].astype(np.int32)
    assert (bm[wm >= 0] == 4 * w[:, None] + np.arange(4)).all()
    assert (bm[wm == -1] == -1).all()
