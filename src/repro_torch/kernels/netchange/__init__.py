"""NetChange To-Wider: the hand-written CUDA gather (``widen.py``), its
plain version (``ref.py``) and the entry points (``ops.py``)."""
from repro_torch.kernels.netchange import ops, ref  # noqa: F401
