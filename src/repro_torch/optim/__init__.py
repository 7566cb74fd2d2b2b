from repro_torch.optim.optimizers import Optimizer, adamw, sgd  # noqa: F401
from repro_torch.optim.schedules import constant, cosine_with_warmup  # noqa: F401,E501
