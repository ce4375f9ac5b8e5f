"""AdamW and the learning-rate schedule, ported from ``repro.optim``."""

from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.schedules import warmup_cosine  # noqa: F401
