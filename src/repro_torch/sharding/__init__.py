"""Distribution contexts, placement rules and the model axis's
collectives over ``torch.distributed``."""
from repro_torch.sharding.ctx import CPU_CTX, CohortCtx, ShardCtx  # noqa: F401
from repro_torch.sharding.rules import (  # noqa: F401
    cache_specs, cohort_mesh, expert_slice, head_layout, head_plan,
    moe_spec, param_specs, stacked_client_spec, tp_slice)
