from repro_torch.optim.adamw import adamw, clip_by_global_norm, global_norm  # noqa: F401
from repro_torch.optim.schedules import constant, cosine, linear_warmup  # noqa: F401
