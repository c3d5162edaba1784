"""Logical-axis layout rules, the ambient mesh and the training layouts
(``sharding``), and pipeline parallelism (``pipeline``)."""
from repro_torch.parallel.pipeline import pipeline_apply  # noqa: F401
from repro_torch.parallel.sharding import (  # noqa: F401
    PARAM_AXES,
    Placement,
    axis_rules,
    batch_sum,
    constrain_like_params,
    current_mesh,
    current_rules,
    gather_tensor,
    logical_spec,
    make_rules,
    make_serve_rules,
    param_shardings,
    param_specs,
    shard_tensor,
    sum_over,
    use_mesh,
)
