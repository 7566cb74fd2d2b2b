"""FedADP in PyTorch for NVIDIA Hopper — the port of the JAX package
``repro``, module for module. Plain tensor code is PyTorch; the TPU's
Pallas kernels become hand-written CUDA kernels (``kernels/``)."""


def not_ported(what: str, queue_item: str) -> NotImplementedError:
    """The error for a feature of the JAX package this port does not have
    yet, naming where ROADMAP.md queues it."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet — ROADMAP.md queue 1, "
        f"{queue_item}")
