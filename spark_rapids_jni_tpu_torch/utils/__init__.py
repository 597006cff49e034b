"""Utilities of the PyTorch port."""

from spark_rapids_jni_tpu_torch.utils.datagen import (  # noqa: F401
    compact_encode_args, compact_gather_args, cycle_dtypes,
    json_boundary_docs, json_event_docs, json_window,
    random_bitset, random_strings, random_table, special_floats,
    strings_with_lengths,
)
from spark_rapids_jni_tpu_torch.utils.cast_data import (  # noqa: F401
    CAST_EDGE_STRINGS, CAST_KINDS, cast_strings,
)
