from .optimizers import (  # noqa: F401
    AdamWConfig,
    Optimizer,
    OptState,
    SGDConfig,
    cosine_schedule,
    make_adamw,
    make_sgd,
)
