"""spark_rapids_jni_tpu_torch: PyTorch and CUDA port of spark_rapids_jni_tpu.

It runs on one NVIDIA Hopper card (sm_90a).  The JAX package beside it is
the reference; this package imports neither JAX nor that package.

- ``table``: ``Column``/``Table`` containers as torch tensors, fixed-width
  (decimal128 included) and string columns, dense-padded or in Arrow
  layout; ``ops.decimal``
  builds decimal128 columns from Python ints and reads them back, and
  holds Spark's checked decimal add, subtract, multiply, divide, rescale
  and ``CAST(decimal AS STRING)``.
- ``ops.cast_string``: Spark's ``CAST`` between strings and integers,
  floats, decimals, dates and timestamps (float and double to string wait
  for a later slice).
- ``ops.row_conversion``: JCUDF row-format <-> column conversion, the
  flagship op (reference ``src/main/cpp/src/row_conversion.cu``), for
  fixed-width tables, dense-padded string tables and compact rows of
  tables with Arrow-layout strings, and ``compact_rows_host``;
  ``impl="pallas"`` takes the word-plane engine of ``ops.plane_rows``,
  ``impl="xla"`` the generic torch engine; ``ops.row_kernels`` is the
  per-column-block engine (``to_rows_fixed``/``from_rows_fixed``, with
  shape-bucket padding).
- ``ops.row_mxu``: word plans, the plane-major table backing and the
  two-stage encode of tables too large to pack whole.
- ``ops.hashing``: Spark's murmur3 and xxhash64 over columns, and hash
  partitioning (``hash_partition_ids``).
- ``ops.spark_bloom``: Spark's wire-compatible bloom filter and its probe
  on the device (``might_contain_device``).
- ``ops.get_json``: Spark's ``get_json_object`` for object-key and
  ``[i]`` subscript paths over string columns (wildcards wait for a later
  slice).
- ``ops.kernels``: the build of the hand-written CUDA kernels (``csrc/``)
  and the row-conversion kernels' wrappers and plain versions, the compact
  rows' encode and string gather among them;
  ``ops.hash_kernels``: those of the hash and bloom kernels; the JSON path
  automaton's are in ``ops.get_json``.
- ``serve``: the multi-tenant serving runtime (a continuous-batching
  ``Scheduler`` and per-tenant ``Client``s) with the ``rows`` and
  ``unrows`` ops.
- ``runtime``: the shape-bucket grid and its pad and unpad helpers,
  coalesced host <-> device staging
  and the failure taxonomy the serving runtime uses.
- ``utils.datagen``: seeded random tables (fixed-width columns, and
  string columns padded or in Arrow layout), made on the device;
  ``utils.cast_data``: seeded texts for the casts, and their edge strings.
- ``interop``: tables, backings and row batches to and from numpy, to hold
  the port against the JAX package on the same data.

Entry points run on the CUDA card unless the caller passes ``device="cpu"``.
"""

from spark_rapids_jni_tpu_torch.table import (  # noqa: F401
    ALL_FIXED_WIDTH, BOOL8, DATE32, FLOAT32, FLOAT64, INT8, INT16, INT32,
    INT64, STRING, TIMESTAMP64, UINT8, UINT16, UINT32, UINT64, Column, DType,
    Table, decimal32, decimal64, decimal128,
)
