from repro_torch.optim.optimizers import Optimizer, sgd  # noqa: F401
