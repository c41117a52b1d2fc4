from repro_torch.training.optimizer import adamw_init, adamw_update, OptimizerConfig  # noqa: F401
from repro_torch.training.schedule import make_schedule, ScheduleConfig  # noqa: F401
