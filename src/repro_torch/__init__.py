"""PyTorch/CUDA port of the distributed-classifier protocols (``repro``).

The JAX package ``repro`` stays the reference; this package mirrors its
module layout and names so each counterpart is easy to find, imports
``torch`` and ``numpy`` only, and runs its hot scans as hand-written CUDA
kernels for Hopper (``repro_torch.kernels``).  Entry points take
``device=`` (default ``"cuda"``) and raise when no card is present; pass
``device="cpu"`` to run the plain PyTorch versions on the host.

Ported so far: the two-way protocol sweep for both support selectors,
``engine.run_sweep`` → ``engine.median.run_instances`` /
``engine.maxmarg.run_instances`` → ``run_hot`` → ``hotloop.run_hot`` → the
selector's ``step``, with the batched max-margin solver
(``core.classifiers``); the one-way family (``engine.oneway``: RANDOM
ε-net sampling with JAX's Threefry draws, ``core.prng``, and the §7
baselines); the bulk scans over sweep state (``engine.dataplane.ranges`` /
``uncertain``); the B=1 public delegations (``core.protocols.two_way``
/ ``kparty`` / ``one_way`` / ``baselines``); and the token-model stack's
dense and encoder-decoder families (``models``, ``configs``,
``data.pipeline``, ``serve.TokenServingEngine``), whose cache-less
attention calls run the flash-attention kernel under
``models.layers.set_attention_impl("kernel")``, for every configuration
of the repo; and training (``optim``, ``train``, ``launch.train``), with
gradients through the WKV and selective-scan kernels.
"""
