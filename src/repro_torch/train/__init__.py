"""Training of the port (counterpart of ``repro.train``): the train step
and ``Trainer`` (:mod:`.trainer`), checkpoints in the JAX package's format
(:mod:`.checkpoint`)."""

from repro_torch.train.checkpoint import (  # noqa: F401
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.train.trainer import (  # noqa: F401
    TrainConfig,
    Trainer,
    make_train_step,
)
