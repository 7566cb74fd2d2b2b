"""Flash attention: hand-written CUDA forward/backward kernels
(``flash.py``), their plain versions (``ref.py``) and the autograd
binding (``ops.py``)."""
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
