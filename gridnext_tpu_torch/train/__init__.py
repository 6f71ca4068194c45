"""Training of the port: the spotwise and gridwise trainers, their Adam,
checkpoints, preemption and the background checkpoint writer."""

from gridnext_tpu_torch.train.async_ckpt import AsyncCheckpointWriter
from gridnext_tpu_torch.train.loops import (OptimizerSpec, TrainState, create_train_state,
                                            load_checkpoint, load_f_params, make_adam,
                                            make_gridwise_optimizer, make_steps,
                                            masked_cross_entropy, restore_train_state,
                                            save_checkpoint, train_gridwise,
                                            train_spotwise)
from gridnext_tpu_torch.train.preempt import (TrainingPreempted,
                                              install_preemption_handler)

__all__ = ["AsyncCheckpointWriter", "OptimizerSpec", "TrainState", "TrainingPreempted",
           "create_train_state", "install_preemption_handler", "load_checkpoint",
           "load_f_params", "make_adam", "make_gridwise_optimizer", "make_steps",
           "masked_cross_entropy", "restore_train_state", "save_checkpoint",
           "train_gridwise", "train_spotwise"]
