"""Training (the port of ``repro/train``): the sharded engine on the data
axes, the step, the host loop with checkpoints and telemetry, fault
injection and the self-healing supervisor."""
from repro_torch.train.train_step import (TrainState, init_train_state,  # noqa: F401
                                          loss_and_grads, make_train_setup,
                                          make_train_step)
from repro_torch.train.trainer import Trainer, TrainerHooks  # noqa: F401
from repro_torch.train.supervisor import TrainSupervisor, TrainingAborted  # noqa: F401
from repro_torch.train.faults import (FaultPlan, FaultSpec,  # noqa: F401
                                      FaultyCheckpointManager, SimulatedCrash)
from repro_torch.train.engine import TrainEngine, make_engine  # noqa: F401
