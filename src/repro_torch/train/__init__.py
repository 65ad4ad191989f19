"""Training on one device (the port of ``repro/train``): the step, the
host loop with checkpoints and telemetry, fault injection and the
self-healing supervisor. The sharded engine comes with sharded training
(ROADMAP.md Queue 1 #4)."""
from repro_torch.train.train_step import (TrainState, init_train_state,  # noqa: F401
                                          loss_and_grads, make_train_setup,
                                          make_train_step)
from repro_torch.train.trainer import Trainer, TrainerHooks  # noqa: F401
from repro_torch.train.supervisor import TrainSupervisor, TrainingAborted  # noqa: F401
from repro_torch.train.faults import (FaultPlan, FaultSpec,  # noqa: F401
                                      FaultyCheckpointManager, SimulatedCrash)
