"""Serving package: the token-decode engine over ``repro_torch.models``.

The JAX package's protocol service (``ProtocolService`` over the session
pool) waits for ROADMAP Queue 1 item 10 and is not exported here.
"""

from repro_torch.serve.engine import (  # noqa: F401
    ServeConfig,
    ServingEngine,
    TokenServingEngine,
    make_serve_step,
)
