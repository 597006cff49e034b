"""PyTorch port, Spark's casts and decimal128 arithmetic on the card against
the same calls on the CPU.

The tests marked ``gpu`` need a CUDA card and skip without one.  This file
imports neither JAX nor the JAX package, so on a machine with a card and no
JAX it runs alone:

    python -m pytest --noconftest tests/test_torch_cast_card.py -m gpu -q
"""

import pytest
import torch

from spark_rapids_jni_tpu_torch import (
    DATE32, FLOAT32, FLOAT64, INT8, INT16, INT32, INT64, TIMESTAMP64, Column,
    Table,
)
from spark_rapids_jni_tpu_torch.ops import cast_string as pcs
from spark_rapids_jni_tpu_torch.ops import decimal as pdec
from spark_rapids_jni_tpu_torch.table import assert_tables_equivalent
from spark_rapids_jni_tpu_torch.utils import CAST_EDGE_STRINGS, cast_strings

STRING_CASTS = {
    "int8": lambda c, **k: pcs.cast_string_to_int(c, INT8, **k),
    "int16": lambda c, **k: pcs.cast_string_to_int(c, INT16, **k),
    "int32": lambda c, **k: pcs.cast_string_to_int(c, INT32, **k),
    "int64": lambda c, **k: pcs.cast_string_to_int(c, INT64, **k),
    "float32": lambda c, **k: pcs.cast_string_to_float(c, FLOAT32, **k),
    "float64": lambda c, **k: pcs.cast_string_to_float(c, FLOAT64, **k),
    "decimal2": lambda c, **k: pcs.cast_string_to_decimal128(c, 2, **k),
    "decimal18": lambda c, **k: pcs.cast_string_to_decimal128(c, 18, **k),
    "date": pcs.cast_string_to_date,
    "timestamp": pcs.cast_string_to_timestamp,
}
_SOURCE = {"int8": "int8", "int16": "int16", "int32": "int32",
           "int64": "int64", "float32": "float", "float64": "float",
           "decimal2": "decimal", "decimal18": "decimal", "date": "date",
           "timestamp": "timestamp"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _same(got, want):
    """Card columns equal to CPU columns bit for bit, data under nulls
    included; error masks equal."""
    (gc, ge), (wc, we) = got, want
    assert_tables_equivalent(Table((gc.to("cpu"),)), Table((wc,)),
                             check_nulls=False)
    assert torch.equal(ge.cpu(), we)


def test_string_casts_on_cpu():
    """What the card's tests compare against: every cast runs on the CPU
    over the edge strings and a generated mix."""
    edges = Column.strings(CAST_EDGE_STRINGS, device="cpu")
    for name, fn in STRING_CASTS.items():
        for col in (edges, cast_strings(_SOURCE[name], 500, seed=1,
                                        device="cpu")):
            out, err = fn(col, device="cpu")
            assert out.num_rows == col.num_rows == err.shape[0]


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(STRING_CASTS))
def test_string_cast_card_equals_cpu(cuda, name):
    fn = STRING_CASTS[name]
    for col in (Column.strings(CAST_EDGE_STRINGS, device="cpu"),
                cast_strings(_SOURCE[name], 70_000, seed=2, device="cpu")):
        _same(fn(col.to(cuda)), fn(col, device="cpu"))
        with pytest.raises(ValueError, match="ANSI cast failure"):
            fn(col.to(cuda), ansi=True)


@pytest.mark.gpu
def test_to_string_card_equals_cpu(cuda):
    gen = torch.Generator().manual_seed(3)
    for dt in (INT8, INT16, INT32, INT64):
        info = torch.iinfo(dt.torch_dtype)
        v = torch.randint(info.min, info.max, (50_000,), generator=gen,
                          dtype=dt.torch_dtype)
        v[:2] = torch.tensor([info.min, info.max])
        col = Column(dt, v)
        assert_tables_equivalent(
            Table((pcs.cast_int_to_string(col.to(cuda)).to("cpu"),)),
            Table((pcs.cast_int_to_string(col, device="cpu"),)),
            check_nulls=False)
    days = torch.randint(-900_000, 3_100_000, (50_000,), generator=gen,
                         dtype=torch.int32)
    micros = torch.randint(-(1 << 63), (1 << 63) - 1, (50_000,),
                           generator=gen, dtype=torch.int64)
    for col, fn in ((Column(DATE32, days), pcs.cast_date_to_string),
                    (Column(TIMESTAMP64, micros),
                     pcs.cast_timestamp_to_string)):
        got, want = fn(col.to(cuda)), fn(col, device="cpu")
        for f in ("chars2d", "lens", "offsets", "validity"):
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


@pytest.mark.gpu
def test_decimal_card_equals_cpu(cuda):
    gen = torch.Generator().manual_seed(4)
    limbs = torch.randint(-(1 << 31), 1 << 31, (2, 50_000, 4), generator=gen,
                          dtype=torch.int64).to(torch.int32)
    # about a tenth of the rows small, so that sums and products fit
    limbs[:, ::10, 1:] = 0
    a = Column(pdec.decimal128(2), limbs[0].contiguous())
    b = Column(pdec.decimal128(2), limbs[1].contiguous())
    for fn in (pdec.add_decimal128, pdec.sub_decimal128,
               pdec.mul_decimal128, pdec.div_decimal128):
        _same(fn(a.to(cuda), b.to(cuda)), fn(a, b))
    for s in (-40, -4, 0, 6, 40):
        _same(pdec.rescale_decimal128(a.to(cuda), s),
              pdec.rescale_decimal128(a, s))
    for s in (0, 2, 38, -3):
        col = Column(pdec.decimal128(s), a.data)
        got = pdec.cast_decimal128_to_string(col.to(cuda))
        want = pdec.cast_decimal128_to_string(col)
        for f in ("chars2d", "lens", "offsets"):
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
