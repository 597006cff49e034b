"""Word plans: how a fixed-width schema's columns map into the plane-major
word matrix, for the encode (forward plan) and the decode (inverse plan).

The counterpart of the plan part of ``spark_rapids_jni_tpu.ops.row_mxu``
(``WordPlan``, ``_build_word_plan``, ``_forward_plan``, ``_inverse_plan``,
``_data_words``), numpy exactly as there.  It sits apart from
:mod:`.row_mxu` so that the kernel layer (:mod:`.kernels`), which builds its
static byte maps from these plans, and the backing layer (:mod:`.row_mxu`),
which calls the kernels, form a one-way chain; :mod:`.row_mxu` re-exports
every name here.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np

from spark_rapids_jni_tpu_torch.ops.row_layout import RowLayout


@dataclasses.dataclass(frozen=True)
class WordPlan:
    """Static layout of the packed word matrix for one schema.

    ``col_word``/``col_byte`` give, per column, the (word, byte-within-word)
    coordinate of the column's first byte.  ``num_words`` is W.
    ``validity_word``/``validity_byte`` locate the validity section: in the
    *forward* plan one 0/1 byte per column; in the *inverse* plan the packed
    validity bytes of the row themselves.
    """

    num_words: int
    col_word: Tuple[int, ...]
    col_byte: Tuple[int, ...]
    validity_word: Tuple[int, ...]
    validity_byte: Tuple[int, ...]


def _build_word_plan(layout: RowLayout, validity_units: int) -> WordPlan:
    """Allocate word slots: 8/4-byte columns word-aligned, 2-byte columns
    packed two per word, 1-byte columns four per word, then
    ``validity_units`` extra bytes packed four per word."""
    col_word = [0] * layout.num_columns
    col_byte = [0] * layout.num_columns
    w = 0
    # widest first, each size class as one contiguous plane block
    for i in range(layout.num_columns):
        if layout.col_sizes[i] == 16:
            col_word[i], col_byte[i] = w, 0
            w += 4
    for i in range(layout.num_columns):
        if layout.col_sizes[i] == 8:
            col_word[i], col_byte[i] = w, 0
            w += 2
    for i in range(layout.num_columns):
        if layout.col_sizes[i] == 4:
            col_word[i], col_byte[i] = w, 0
            w += 1
    half = 0
    for i in range(layout.num_columns):
        if layout.col_sizes[i] == 2:
            col_word[i], col_byte[i] = w, 2 * (half & 1)
            half += 1
            if half & 1 == 0:
                w += 1
    if half & 1:
        w += 1
    quad = 0
    for i in range(layout.num_columns):
        if layout.col_sizes[i] == 1:
            col_word[i], col_byte[i] = w, quad & 3
            quad += 1
            if quad & 3 == 0:
                w += 1
    if quad & 3:
        w += 1
    vw, vb = [], []
    for j in range(validity_units):
        vw.append(w + j // 4)
        vb.append(j % 4)
    w += (validity_units + 3) // 4
    return WordPlan(w, tuple(col_word), tuple(col_byte), tuple(vw),
                    tuple(vb))


@functools.lru_cache(maxsize=64)
def _forward_plan(layout: RowLayout):
    """Forward (encode) plan and its ``[W, 4, row_size]`` int8 byte map:
    1 where a plane byte lands in the row, ``1 << (c % 8)`` where column
    ``c``'s 0/1 validity byte lands in its validity byte."""
    plan = _build_word_plan(layout, layout.num_columns)
    p = np.zeros((plan.num_words, 4, layout.fixed_row_size), dtype=np.uint8)
    for i in range(layout.num_columns):
        s, sz = layout.col_starts[i], layout.col_sizes[i]
        for b in range(sz):
            w = plan.col_word[i] + (plan.col_byte[i] + b) // 4
            k = (plan.col_byte[i] + b) % 4
            p[w, k, s + b] = 1
    for c in range(layout.num_columns):
        p[plan.validity_word[c], plan.validity_byte[c],
          layout.validity_offset + c // 8] = np.uint8(1 << (c % 8))
    return plan, p.view(np.int8)


@functools.lru_cache(maxsize=64)
def _inverse_plan(layout: RowLayout):
    """Inverse (decode) plan and its ``[row_size, W, 4]`` int8 byte map."""
    plan = _build_word_plan(layout, layout.validity_bytes)
    p = np.zeros((layout.fixed_row_size, plan.num_words, 4), dtype=np.int8)
    for i in range(layout.num_columns):
        s, sz = layout.col_starts[i], layout.col_sizes[i]
        for b in range(sz):
            w = plan.col_word[i] + (plan.col_byte[i] + b) // 4
            k = (plan.col_byte[i] + b) % 4
            p[s + b, w, k] = 1
    for j in range(layout.validity_bytes):
        p[layout.validity_offset + j, plan.validity_word[j],
          plan.validity_byte[j]] = 1
    return plan, p


def _data_words(layout: RowLayout) -> int:
    """Word count of the data section (the forward and inverse plans lay
    data words out identically; only the trailing validity words differ)."""
    plan = _forward_plan(layout)[0]
    return plan.num_words - (layout.num_columns + 3) // 4
