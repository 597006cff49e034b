"""Utilities of the PyTorch port."""

from spark_rapids_jni_tpu_torch.utils.datagen import (  # noqa: F401
    cycle_dtypes, random_bitset, random_strings, random_table,
    special_floats, strings_with_lengths,
)
