from repro_torch.optim.api import Optimizer, make_optimizer  # noqa: F401
from repro_torch.optim.schedules import warmup_constant  # noqa: F401
