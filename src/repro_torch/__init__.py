"""PyTorch/CUDA port of the distributed-classifier protocols (``repro``).

The JAX package ``repro`` stays the reference; this package mirrors its
module layout and names so each counterpart is easy to find, imports
``torch`` and ``numpy`` only, and runs its hot scans as hand-written CUDA
kernels for Hopper (``repro_torch.kernels``).  Entry points take
``device=`` (default ``"cuda"``) and raise when no card is present; pass
``device="cpu"`` to run the plain PyTorch versions on the host.

Ported so far: the two-way MEDIAN / k-party sweep
(``engine.run_sweep`` → ``engine.median.run_instances`` → ``run_hot`` →
``hotloop.run_hot`` → ``median.step``) and its B=1 public delegations.
"""
