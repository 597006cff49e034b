"""Seeded random fixed-width tables, made on the device.

The schema helper ``cycle_dtypes`` follows the reference benchmark datagen
(``generate_input.hpp:445-452``).  Values are uniform random bytes, so float
columns hold every bit pattern, NaN payloads included (compare them by
bits); BOOL8 columns hold 0 or 1.  Everything is drawn from one
``torch.Generator`` on the target device, so a 1M-row table needs no host
round trip.  Torch's generators give other numbers than ``jax.random``:
tests that hold the port against the JAX package make their inputs with
numpy instead.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from spark_rapids_jni_tpu_torch.table import (
    BITS_DTYPES, Column, DType, Table, pack_bools, resolve_device,
)


def cycle_dtypes(dtypes: Sequence[DType], num_cols: int) -> list:
    """Repeat the dtype list until ``num_cols`` columns (reference
    ``cycle_dtypes``)."""
    return [dtypes[i % len(dtypes)] for i in range(num_cols)]


def random_table(dtypes: Sequence[DType], num_rows: int, *, seed: int = 0,
                 null_probability: Optional[float] = 0.25,
                 device=None) -> Table:
    """A fixed-width table of ``num_rows`` random rows.  Each row of each
    column is null with ``null_probability``; ``None`` gives columns
    without a validity mask."""
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
        raw = torch.randint(0, 256, (num_rows * dt.itemsize,),
                            dtype=torch.uint8, generator=gen, device=dev)
        if dt.kind == "bool8":
            raw &= 1
        data = raw.view(BITS_DTYPES[dt.itemsize]).view(dt.torch_dtype)
        cols.append(Column(dt, data, None if masks is None else masks[i]))
    return Table(tuple(cols))
