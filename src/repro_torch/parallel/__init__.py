from . import comm
from .context import (Rules, current_rules, data_mean, data_sum,
                      shard_activation, use_rules)
from .rules import (batch_specs, mesh_shape, param_specs, ring_axis_for,
                    spec_bytes_per_device, zero1_specs)
from .steps import (GraphStep, Placement, ShardedStep, TrainGraphStep,
                    axis_names, batch_pspecs, build_paged_serve_step,
                    build_prefill_step, build_serve_step, build_train_step,
                    cache_pspecs, gather_tree, layer_cache_specs,
                    make_shardings, paged_cache_pspecs, paged_layer_specs,
                    reshard_cache, shard_batch, shard_tree)

__all__ = ["Rules", "current_rules", "use_rules", "shard_activation",
           "data_sum", "data_mean", "comm", "ring_axis_for",
           "param_specs", "batch_specs", "zero1_specs",
           "spec_bytes_per_device", "mesh_shape",
           "axis_names", "make_shardings", "cache_pspecs", "batch_pspecs",
           "paged_cache_pspecs", "build_train_step", "build_prefill_step",
           "build_serve_step", "build_paged_serve_step", "GraphStep",
           "TrainGraphStep", "ShardedStep", "Placement", "shard_tree",
           "gather_tree", "shard_batch", "layer_cache_specs",
           "paged_layer_specs", "reshard_cache"]
