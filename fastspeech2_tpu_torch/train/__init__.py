"""Training: dropout seed schedule, Noam-Adam, the accumulate-clip-update
train step, checkpointing, metrics and the loop."""

from fastspeech2_tpu_torch.train.optimizer import NoamAdam, noam_lr  # noqa: F401
from fastspeech2_tpu_torch.train.step import TrainState, make_train_step  # noqa: F401
