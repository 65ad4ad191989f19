"""Training: the step and the host loop (the port of ``repro/train``,
single card; the sharded engine, the supervisor and fault injection come
with later slices)."""
from repro_torch.train.train_step import (TrainState, init_train_state,  # noqa: F401
                                          loss_and_grads, make_train_setup,
                                          make_train_step)
from repro_torch.train.trainer import Trainer, TrainerHooks  # noqa: F401
