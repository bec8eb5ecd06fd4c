from repro_torch.optim.optimizers import (  # noqa: F401
    adamw, sgd, Optimizer, cosine_schedule, constant_schedule,
    clip_by_global_norm)
