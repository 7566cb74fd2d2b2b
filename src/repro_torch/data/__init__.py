from repro_torch.data.federated import (  # noqa: F401
    ClientSampler, dirichlet_partition, iid_partition)
from repro_torch.data.pipeline import LMPipeline  # noqa: F401
from repro_torch.data.synthetic import (  # noqa: F401
    EASY, HARD, HARDEST, MEDIUM, TABLE1_TASKS, ImageTaskSpec,
    image_classification, lm_sequences)
