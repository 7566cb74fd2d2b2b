from repro_torch.checkpoint.store import (  # noqa: F401
    load_plane, load_pytree, save_plane, save_pytree)
