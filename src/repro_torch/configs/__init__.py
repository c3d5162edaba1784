from repro_torch.configs.base import (  # noqa: F401
    ALL_SHAPES,
    AttnCfg,
    BlockCfg,
    MLPCfg,
    MambaCfg,
    ModelCfg,
    MoECfg,
    SHAPES_BY_NAME,
    ShapeCfg,
    Stage,
    XLSTMCfg,
    active_param_count,
    param_count,
)
from repro_torch.configs.registry import (  # noqa: F401
    ARCH_NAMES,
    all_cells,
    get_config,
    input_specs,
    skip_reason,
)
