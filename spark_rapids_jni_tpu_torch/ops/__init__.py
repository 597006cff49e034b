"""Ops of the PyTorch port: row conversion (fixed-width tables, and string
tables as dense-padded or compact rows; ``impl="pallas"`` takes the
word-plane engine of
:mod:`.plane_rows`, ``impl="xla"`` the generic engine; :mod:`.row_kernels`
is the per-column-block engine), decimal128 columns (:mod:`.decimal`),
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
