from repro_torch.optim.optim import (
    Optimizer, momentum_sgd, adamw, sgd, apply_updates,
    cosine_schedule, constant_schedule, warmup_cosine,
)

__all__ = [
    "Optimizer", "momentum_sgd", "adamw", "sgd", "apply_updates",
    "cosine_schedule", "constant_schedule", "warmup_cosine",
]
