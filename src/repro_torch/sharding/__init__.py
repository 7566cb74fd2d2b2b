"""Distribution contexts and placement rules over ``torch.distributed``."""
from repro_torch.sharding.ctx import CPU_CTX, CohortCtx, ShardCtx  # noqa: F401
from repro_torch.sharding.rules import (  # noqa: F401
    cohort_mesh, expert_slice, moe_spec, stacked_client_spec)
