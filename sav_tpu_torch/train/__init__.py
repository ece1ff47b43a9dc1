"""Training: optimizer and schedules, train/eval steps, the Trainer and
its CLI (``python -m sav_tpu_torch.train``)."""

from sav_tpu_torch.train.loop import MetricLogger, TrainConfig, Trainer  # noqa: F401
from sav_tpu_torch.train.state import (TrainState, build_optimizer,  # noqa: F401
                                       warmup_cosine_schedule,
                                       warmup_stable_decay_schedule)
from sav_tpu_torch.train.steps import (blended_targets, eval_step,  # noqa: F401
                                       train_step)
