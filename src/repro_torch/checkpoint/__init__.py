from repro_torch.checkpoint.ckpt import (
    save_pytree, load_pytree, CheckpointManager,
)

__all__ = ["save_pytree", "load_pytree", "CheckpointManager"]
