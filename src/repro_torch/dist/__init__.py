"""repro_torch.dist — the distributed-execution substrate (port of
``repro.dist``).

* ``sharding``    — mesh partitioning rules for params / optimizer state /
                    KV caches, and the placement of SEINE indexes on a
                    mesh;
* ``partition``   — the term-range partitioned index (PartitionedIndex)
                    and the stage-4 merger that builds it;
* ``live``        — the mutable serving index (LiveIndex);
* ``compression`` — int8 / top-k gradient compression with error
                    feedback;
* ``fault``       — heartbeats, straggler detection, cooperative
                    preemption, elastic mesh re-planning;
* ``sp_decode``   — sequence-parallel decode attention via log-sum-exp
                    merge;
* ``collective``  — the mesh paths' collectives, with launch counts.
"""
from .compression import (compress_with_feedback, dequantize_int8,
                          init_error_feedback, quantize_int8, topk_densify,
                          topk_sparsify)
from .fault import (Heartbeat, PreemptionGuard, StragglerMonitor,
                    plan_elastic_mesh)
from .live import LiveIndex, LiveView, live_index
from .partition import (PartitionedIndex, merged_term_counts,
                        partitioned_from_runs)
from .sharding import (data_axes, fit_spec, gnn_param_rules, index_shardings,
                       lm_cache_spec, lm_param_rules, lm_param_rules_fsdp,
                       opt_state_shardings, partition_index,
                       partitioned_index_shardings, plan_posting_ranges,
                       plan_term_ranges, recsys_param_rules, shard_index,
                       shard_partitioned_index, tree_shardings)
from .sp_decode import (combine_decode_stats, local_decode_stats,
                        sp_decode_attention)

__all__ = [
    "compress_with_feedback", "dequantize_int8", "init_error_feedback",
    "quantize_int8", "topk_densify", "topk_sparsify",
    "Heartbeat", "PreemptionGuard", "StragglerMonitor", "plan_elastic_mesh",
    "LiveIndex", "LiveView", "live_index",
    "PartitionedIndex", "merged_term_counts", "partitioned_from_runs",
    "data_axes", "fit_spec", "gnn_param_rules", "index_shardings",
    "lm_cache_spec", "lm_param_rules", "lm_param_rules_fsdp",
    "opt_state_shardings", "partition_index",
    "partitioned_index_shardings", "plan_posting_ranges",
    "plan_term_ranges",
    "recsys_param_rules", "shard_index", "shard_partitioned_index",
    "tree_shardings",
    "combine_decode_stats", "local_decode_stats", "sp_decode_attention",
]
