"""Ops of the PyTorch port: row conversion (fixed-width tables, and string
tables as dense-padded or compact rows; ``impl="pallas"`` takes the
word-plane engine of
:mod:`.plane_rows`, ``impl="xla"`` the generic engine; :mod:`.row_kernels`
is the per-column-block engine), decimal128 columns and Spark's checked
decimal arithmetic (:mod:`.decimal`), Spark's ``CAST`` between strings and
integers, floats, decimals, dates and timestamps (:mod:`.cast_string`),
Spark hashing and hash partitioning, the Spark bloom
filter, and ``get_json_object`` (key and subscript paths over string
columns).  The serving runtime over the row ops is
``spark_rapids_jni_tpu_torch.serve``; its grid and staging are
``spark_rapids_jni_tpu_torch.runtime``."""

from spark_rapids_jni_tpu_torch.ops.row_layout import (  # noqa: F401
    JCUDF_ROW_ALIGNMENT, MAX_BATCH_BYTES, MAX_ROW_SIZE, RowLayout,
    compute_row_layout,
)
from spark_rapids_jni_tpu_torch.ops.row_conversion import (  # noqa: F401
    RowsColumn,
    compact_rows_host,
    convert_from_rows,
    convert_from_rows_fixed_width_optimized,
    convert_from_rows_grouped,
    convert_to_rows,
    convert_to_rows_fixed_width_optimized,
    convert_to_rows_grouped,
    padded_variable_layout,
    plan_equal_batches,
    plan_fixed_batches,
    plan_grouped_batches,
    plan_variable_batches,
)
from spark_rapids_jni_tpu_torch.ops.hashing import (  # noqa: F401
    DEFAULT_SEED, hash_partition_ids, murmur3_hash, pmod, xxhash64,
)
from spark_rapids_jni_tpu_torch.ops.spark_bloom import (  # noqa: F401
    SparkBloomFilter, might_contain_device,
)
from spark_rapids_jni_tpu_torch.ops.get_json import (  # noqa: F401
    get_json_object,
)
from spark_rapids_jni_tpu_torch.ops.cast_string import (  # noqa: F401
    cast_date_to_string,
    cast_int_to_string,
    cast_string_to_date,
    cast_string_to_decimal128,
    cast_string_to_float,
    cast_string_to_int,
    cast_string_to_timestamp,
    cast_timestamp_to_string,
)
from spark_rapids_jni_tpu_torch.ops.decimal import (  # noqa: F401
    add_decimal128, cast_decimal128_to_string, decimal128,
    decimal128_from_ints, decimal128_to_ints,
    decimal128_to_strings, div_decimal128, mul_decimal128,
    rescale_decimal128, sub_decimal128,
)
