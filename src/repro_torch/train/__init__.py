from repro_torch.train.step import TrainConfig, make_train_step, split_train  # noqa: F401
from repro_torch.train.loop import TrainLoop  # noqa: F401
