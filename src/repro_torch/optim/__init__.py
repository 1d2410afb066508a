"""Optimiser of the port (counterpart of ``repro.optim``): AdamW with the
JAX package's global-norm clip and decoupled decay, and its schedules."""

from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    adamw_init,
    adamw_update,
    global_norm,
)
from repro_torch.optim.schedule import (  # noqa: F401
    cosine_schedule,
    linear_warmup,
)
