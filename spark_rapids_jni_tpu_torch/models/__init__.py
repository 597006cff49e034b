"""Columnar query operators: the single-chip operators of the JAX package's
``models`` (the distributed steps wait for the port's mesh layer,
``ROADMAP.md`` queue 1, item 11)."""

from spark_rapids_jni_tpu_torch.models.pipeline import (  # noqa: F401
    MAX_GROUPS, filter_mask, flagship_query_step, hash_aggregate_multi,
    hash_aggregate_sum, hash_aggregate_sum_multi, hash_aggregate_table,
    join_inner_table, join_semi_mask, join_semi_mask_strings,
    join_semi_mask_table, merge_aggregate_partials,
    merge_aggregate_table_partials, project, sort_merge_join,
    sort_merge_join_dup, sort_merge_join_left, sort_merge_join_live,
    sort_merge_join_strings, sort_order,
)
