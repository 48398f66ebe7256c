"""Distribution: partition rules for the (pod, data, model) mesh, as
DTensor placements (port of ``repro/sharding``)."""
from repro_torch.sharding.rules import (
    axis_sizes,
    batch_axes,
    batch_spec,
    data_shardings,
    distribute_model,
    dp_axes,
    placements,
    replicated,
    spec_for_cache,
    spec_for_param,
    tree_cache_shardings,
    tree_cache_specs,
    tree_param_specs,
    tree_shardings,
)

__all__ = [
    "axis_sizes", "batch_axes", "batch_spec", "data_shardings",
    "distribute_model", "dp_axes", "placements", "replicated",
    "spec_for_cache", "spec_for_param", "tree_cache_shardings",
    "tree_cache_specs", "tree_param_specs", "tree_shardings",
]
