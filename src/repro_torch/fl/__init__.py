from repro_torch.fl.backends import (  # noqa: F401
    UnifiedBackend, unified_ineligible_reason)
from repro_torch.fl.engine import UnifiedEngine  # noqa: F401
from repro_torch.fl.federation import Federation, Participation  # noqa: F401
from repro_torch.fl.simulator import FLRunConfig, Simulator  # noqa: F401
from repro_torch.fl.strategy import (  # noqa: F401
    FedADPStrategy, make_strategy)
