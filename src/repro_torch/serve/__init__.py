"""Serving package.  Primary entry point: :class:`ProtocolService` —
streaming protocol sessions over the fault-tolerant session pool, on the
pool's device.  The token-decode engine over ``repro_torch.models`` sits
beside it under its own names.
"""

from repro_torch.serve.service import ProtocolService  # noqa: F401
from repro_torch.engine.session_pool import PoolConfig  # noqa: F401
from repro_torch.engine.faults import FAULT_FREE, FaultSchedule  # noqa: F401
from repro_torch.serve.engine import (  # noqa: F401
    ServeConfig,
    ServingEngine,
    TokenServingEngine,
    make_serve_step,
)
