"""Sliding-window serving attention: hand-written CUDA decode and prefill
kernels (``swa.py``), their plain versions (``ref.py``) and the entry
points (``ops.py``)."""
from repro_torch.kernels.swa_attention import ops, ref  # noqa: F401
