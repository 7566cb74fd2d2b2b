from repro_torch.kernels.fedavg import ops, ref  # noqa: F401
