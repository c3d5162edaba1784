"""Logical-axis layout rules and the ambient mesh (``sharding``)."""
from repro_torch.parallel.sharding import (  # noqa: F401
    axis_rules,
    current_mesh,
    current_rules,
    logical_spec,
    make_rules,
    make_serve_rules,
    use_mesh,
)
