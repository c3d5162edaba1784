"""Logical-axis layout rules, the ambient mesh, the training layouts and
the 'model' split of training (``sharding``), and pipeline parallelism
(``pipeline``)."""
from repro_torch.parallel.pipeline import pipeline_apply  # noqa: F401
from repro_torch.parallel.sharding import (  # noqa: F401
    MODEL_SPLIT,
    PARAM_AXES,
    ModelPart,
    Placement,
    axis_rules,
    batch_sum,
    constrain_like_params,
    copy_to_model,
    current_mesh,
    current_rules,
    gather_tensor,
    logical_spec,
    make_rules,
    make_serve_rules,
    model_part,
    model_slices,
    model_split_dims,
    param_shardings,
    param_specs,
    reduce_from_model,
    shard_tensor,
    sum_over,
    use_mesh,
)
