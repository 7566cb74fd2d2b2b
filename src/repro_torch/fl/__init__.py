from repro_torch.fl.engine import UnifiedEngine, client_embedding  # noqa: F401
from repro_torch.fl.strategy import (  # noqa: F401
    ClusteredStrategy, FedADPStrategy, FlexiFedStrategy, StandaloneStrategy,
    Strategy, make_strategy)
from repro_torch.fl.backends import (  # noqa: F401
    LoopBackend, UnifiedBackend, unified_eligible,
    unified_ineligible_reason)
from repro_torch.fl.federation import (  # noqa: F401
    Federation, Participation, checkpoint_path, load_round_checkpoint,
    restore_sampler_rngs, save_round_checkpoint, wire_checkpoint_path)
from repro_torch.fl.simulator import FLRunConfig, Simulator  # noqa: F401
from repro_torch.fl.unified import UnifiedFedADP  # noqa: F401
