"""FedADP core: the paper's contribution as composable PyTorch modules."""
from repro_torch.core.aggregation import (  # noqa: F401
    AGG_MODES, COVERAGE_POLICIES, client_weights, coverage_and_filler,
    coverage_mask, loosen, multiplicity, stack_trees, subset_weights)
from repro_torch.core.family import VGGFamily  # noqa: F401
from repro_torch.core.netchange import (  # noqa: F401
    KeyedCache, NARROW_MODES, round_embed_seed)
from repro_torch.core.plane import (  # noqa: F401
    PlaneSpec, pack, pack_stacked, pack_trees, ragged_leaf_error,
    requantize, unpack, unpack_stacked)
